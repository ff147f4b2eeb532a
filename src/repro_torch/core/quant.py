"""Quantization config and wire-byte accounting for FLoCoRA messages.

The paper's scheme (§IV): per-channel affine (asymmetric) round-to-
nearest quantization, 2/4/8-bit unsigned levels, fp32 scale and zero-
point sidecars; norm layers are never quantized. The fused quantizer
itself is the ``quant_pack_rows`` kernel (``kernels/``), reached through
the flat-tree codec (``core/flat.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


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
