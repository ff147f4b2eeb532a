"""Quantization config and wire-byte accounting for FLoCoRA messages.

The paper's scheme (§IV): per-channel affine (asymmetric) round-to-
nearest quantization, 2/4/8-bit unsigned levels, fp32 scale and zero-
point sidecars; norm layers are never quantized. The fused quantizer
itself is the ``quant_pack_rows`` kernel (``kernels/``), reached through
the flat-tree codec (``core/flat.py``) and the per-leaf codec
(``core/messages.py``). ``pack_levels``/``unpack_levels`` are the byte-
level wire packing the per-leaf codec deserializes with.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """bits: 2, 4, 8 or None (None = fp32 passthrough, the paper's "FP"
    rows). ``per_stack=True`` gives separate qparams per leading-stack
    slice; False (default) matches the paper: channel = last axis, all
    other dims flattened. The symmetric quantizer of the JAX package is
    not ported."""
    bits: Optional[int] = None
    symmetric: bool = False
    per_stack: bool = False

    def __post_init__(self):
        if self.bits not in (None, 2, 4, 8):
            raise ValueError(f"bits must be None, 2, 4 or 8, got {self.bits}")
        if self.symmetric:
            raise NotImplementedError(
                "symmetric quantization is not ported to repro_torch")

    @property
    def enabled(self) -> bool:
        return self.bits is not None

    @property
    def qmax(self) -> int:
        if self.bits is None:
            raise ValueError("quantization is disabled")
        return (1 << self.bits) - 1


FP_BYTES = 4  # paper communicates fp32


def quantized_tensor_bytes(shape: tuple[int, ...], bits: int,
                           channel_axis: int = 0) -> int:
    """Wire bytes for one quantized tensor: packed payload (ceil per
    tensor) + per-channel fp32 scale and zero-point."""
    n = int(np.prod(shape))
    channels = shape[channel_axis]
    return (n * bits + 7) // 8 + channels * 2 * FP_BYTES


def fp_tensor_bytes(shape: tuple[int, ...]) -> int:
    return int(np.prod(shape)) * FP_BYTES


def tcc_bytes(message_bytes: int, rounds: int) -> int:
    """Paper Eq. 2 on a message size: 2 * R * message_bytes. The
    tree-level form is ``core.messages.tcc_bytes``."""
    return 2 * rounds * message_bytes


# ---------------------------------------------------------------------------
# Bit packing (wire format)
# ---------------------------------------------------------------------------

def pack_levels(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint8 levels (< 2^bits) into a flat uint8 tensor,
    little-endian within each byte. Pads the flattened tail with
    zeros."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    flat = q.reshape(-1).to(torch.uint8)
    if bits == 8:
        return flat
    per = 8 // bits
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % per))
    grp = flat.reshape(-1, per).to(torch.int64)
    shifts = torch.arange(per, dtype=torch.int64, device=q.device) * bits
    return torch.sum(grp << shifts, dim=1).to(torch.uint8)


def unpack_levels(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_levels`; returns the first ``n`` levels as
    uint8."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    packed = torch.as_tensor(packed)
    if bits == 8:
        return packed.reshape(-1)[:n].to(torch.uint8)
    per = 8 // bits
    shifts = torch.arange(per, dtype=torch.int64,
                          device=packed.device) * bits
    lv = (packed.reshape(-1).to(torch.int64)[:, None] >> shifts) \
        & ((1 << bits) - 1)
    return lv.reshape(-1)[:n].to(torch.uint8)
