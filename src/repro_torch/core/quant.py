"""Quantization config, the reference quantizer and wire-byte
accounting for FLoCoRA messages.

The paper's scheme (§IV): per-channel affine (asymmetric) round-to-
nearest quantization, 2/4/8-bit unsigned levels, fp32 scale and zero-
point sidecars; norm layers are never quantized. ``affine_qparams``,
``quantize``, ``dequantize`` and ``quant_dequant`` are the fp-simulation
view (unpacked levels), the numerical reference that ``encode``/
``decode`` and ``fedavg_quantized`` use. The fused quantizer on the wire
is the ``quant_pack_rows`` kernel (``kernels/``), reached through the
flat-tree codec (``core/flat.py``) and the per-leaf codec
(``core/messages.py``); like the JAX package's, the wire pack is always
asymmetric and ignores ``symmetric``. ``pack_levels``/``unpack_levels``
are the byte-level wire packing the per-leaf codec deserializes with.
``DPConfig``, ``dp_privatize`` and ``gaussian_epsilon`` are the uplink's
differential privacy (clip and noise before quantization) and its
accountant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.utils.device import upload
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """bits: 2, 4, 8 or None (None = fp32 passthrough, the paper's "FP"
    rows). ``per_stack=True`` gives separate qparams per leading-stack
    slice; False (default) matches the paper: channel = last axis, all
    other dims flattened. ``symmetric`` (beyond the paper: zero-point
    fixed at the middle level) selects the reference quantizer's variant
    in :func:`quant_dequant`; the wire pack ignores it, as in the JAX
    package."""
    bits: Optional[int] = None
    symmetric: bool = False
    per_stack: bool = False

    def __post_init__(self):
        if self.bits not in (None, 2, 4, 8):
            raise ValueError(f"bits must be None, 2, 4 or 8, got {self.bits}")

    @property
    def enabled(self) -> bool:
        return self.bits is not None

    @property
    def qmax(self) -> int:
        if self.bits is None:
            raise ValueError("quantization is disabled")
        return (1 << self.bits) - 1


def _moveaxis_flat(x: torch.Tensor, axis: int) -> torch.Tensor:
    """(..., C, ...) -> (C, rest) with the channel first."""
    x = torch.movedim(x, axis, 0)
    return x.reshape(x.shape[0], -1)


def affine_qparams(x: torch.Tensor, bits: int, channel_axis: int = 0,
                   symmetric: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (scale, zero_point); the zero point is an integer
    level held in fp32.

    Asymmetric: levels q in [0, 2^bits - 1], x ~= scale * (q - zp), the
    range widened to hold 0; a degenerate channel (max == min) gets
    scale = 1. Symmetric (restricted range): levels [0, qmax - 1]
    centred on zp = (qmax - 1) // 2 with scale = 2*amax / (qmax - 1), so
    0 and both extremes +-amax are exact. Divisions are true fp32
    divisions, as in the JAX package's reference (the kernels multiply
    by a reciprocal instead)."""
    qmax = (1 << bits) - 1
    xf = _moveaxis_flat(x.to(torch.float32), channel_axis)
    xmin = torch.amin(xf, dim=1)
    xmax = torch.amax(xf, dim=1)
    if symmetric:
        amax = torch.maximum(torch.abs(xmin), torch.abs(xmax))
        scale = torch.where(amax > 0, (2.0 * amax) / (qmax - 1),
                            torch.ones_like(amax))
        zp = torch.full_like(scale, float((qmax - 1) // 2))
        return scale, zp
    xmin = torch.clamp(xmin, max=0.0)
    xmax = torch.clamp(xmax, min=0.0)
    rng = xmax - xmin
    scale = torch.where(rng > 0, rng / qmax, torch.ones_like(rng))
    zp = torch.clamp(torch.round(-xmin / scale), 0, qmax)
    return scale, zp


def _per_channel(v: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


def quantize(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
             bits: int, channel_axis: int = 0) -> torch.Tensor:
    """fp -> unsigned levels (uint8), round to nearest even."""
    qmax = (1 << bits) - 1
    s = _per_channel(scale, x.ndim, channel_axis)
    z = _per_channel(zp, x.ndim, channel_axis)
    q = torch.round(x.to(torch.float32) / s) + z
    return torch.clamp(q, 0, qmax).to(torch.uint8)


def dequantize(q: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               channel_axis: int = 0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    s = _per_channel(scale, q.ndim, channel_axis)
    z = _per_channel(zp, q.ndim, channel_axis)
    return ((q.to(torch.float32) - z) * s).to(dtype)


def quant_dequant(x: torch.Tensor, cfg: QuantConfig,
                  channel_axis: int = 0) -> torch.Tensor:
    """Round to nearest and back: what the receiving end sees. The
    tensor itself when quantization is off."""
    if not cfg.enabled:
        return x
    scale, zp = affine_qparams(x, cfg.bits, channel_axis, cfg.symmetric)
    q = quantize(x, scale, zp, cfg.bits, channel_axis)
    return dequantize(q, scale, zp, channel_axis, x.dtype)


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


# ---------------------------------------------------------------------------
# Differential privacy: clip + Gaussian noise BEFORE quantization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DPConfig:
    """DP-FedAvg uplink privatization: the client's update DELTA is
    clipped to ``clip_norm`` in global L2 norm, then Gaussian noise of
    std ``noise_multiplier * clip_norm`` is added, BEFORE quantization
    (quantization is post-processing and cannot weaken the guarantee).
    ``delta`` is the accountant's failure probability
    (:func:`gaussian_epsilon`)."""
    clip_norm: float = 1.0
    noise_multiplier: float = 0.0
    delta: float = 1e-5

    def __post_init__(self):
        if self.clip_norm <= 0:
            raise ValueError("clip_norm must be positive")
        if self.noise_multiplier < 0:
            raise ValueError("noise_multiplier must be >= 0")
        if not 0.0 < self.delta < 1.0:
            raise ValueError("delta must be in (0, 1)")


def global_l2_norm(tree) -> torch.Tensor:
    """Global L2 norm across every leaf of a tree (an fp32 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


# rng key domain for DP noise draws (disjoint from the trace and engine
# tags), as in the JAX package
TAG_DP = 0xD9


def dp_privatize(tree, cfg: DPConfig, *, seed: int, key: tuple):
    """Clip ``tree`` to ``cfg.clip_norm`` (global L2) and add Gaussian
    noise of std ``noise_multiplier * clip_norm`` per coordinate.

    The noise is a pure function of ``(seed, *key)``: numpy's
    ``default_rng([seed, TAG_DP, *key])`` draws it leaf by leaf in the
    tree's flatten order, the JAX package's draws one for one. The draws
    of all leaves go to the tree's device in one copy."""
    leaves, treedef = tree_flatten(tree)
    factor = torch.clamp(cfg.clip_norm / torch.clamp(
        global_l2_norm(tree), min=1e-12), max=1.0)
    clipped = [(x.to(torch.float32) * factor).to(x.dtype) for x in leaves]
    if cfg.noise_multiplier <= 0.0:
        return tree_unflatten(treedef, clipped)
    rng = np.random.default_rng([seed, TAG_DP, *[int(k) for k in key]])
    sigma = cfg.noise_multiplier * cfg.clip_norm
    draws = [rng.normal(scale=sigma, size=tuple(x.shape)).astype(np.float32)
             for x in clipped]
    noise = upload(torch.from_numpy(np.concatenate(
        [d.reshape(-1) for d in draws])), clipped[0].device)
    out, off = [], 0
    for x in clipped:
        n = x.numel()
        out.append((x.to(torch.float32)
                    + noise[off: off + n].reshape(x.shape)).to(x.dtype))
        off += n
    return tree_unflatten(treedef, out)


def gaussian_epsilon(noise_multiplier: float, steps: int,
                     delta: float = 1e-5) -> float:
    """(eps, delta)-DP spent after ``steps`` Gaussian-mechanism releases
    at noise std ``noise_multiplier`` x sensitivity, by Renyi-DP
    composition (Mironov 2017) minimized over an alpha grid:

        eps = min_alpha [ T * alpha / (2 sigma^2) + ln(1/delta)/(alpha-1) ]

    Without subsampling amplification this is a conservative bound.
    ``inf`` when ``noise_multiplier == 0``. Pure numpy, the JAX
    package's arithmetic exactly."""
    if steps <= 0:
        return 0.0
    if noise_multiplier <= 0:
        return float("inf")
    sigma2 = noise_multiplier ** 2
    alphas = np.concatenate([np.linspace(1.01, 64.0, 512),
                             np.linspace(65.0, 1024.0, 192)])
    eps = steps * alphas / (2.0 * sigma2) \
        + np.log(1.0 / delta) / (alphas - 1.0)
    return float(eps.min())
