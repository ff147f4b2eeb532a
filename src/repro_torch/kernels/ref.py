"""Plain PyTorch versions of the CUDA kernels (the correctness contracts).

Each function here repeats its kernel's arithmetic with tensor ops, on
any device. The CPU tests hold these against the JAX package, and
``chip_smoke.py`` holds each kernel against its plain version on the
card. The wrappers in ``ops.py`` call them only for CPU tensors.

Layouts (channel-FIRST 2D views; callers reshape):
  quant_pack:  x (C, N) -> packed (C, N*bits/32) uint32, scale (C,), zp (C,)
  dequant_agg: packed (K, C, Nw) uint32, scale/zp (K, C), weights (K,)
               -> out (C, N) fp32 = sum_k w_k * dequant_k
  multi_lora_matmul:   x (M, K), w (K, N), A (E, K, R), B (E, R, N),
               ids (M,) -> y (M, N) = x@w + s * (x @ A[ids]) @ B[ids]
  multi_lora_matmul_q: the same with A and B as packed wire rows,
               aq (E, R, KW) / bq (E, N, RW) uint32 + (E, R) / (E, N)
               fp32 scale and zp sidecars

Packed words are ``torch.uint32`` tensors. PyTorch implements no
arithmetic on that type, so packing and unpacking compute in int64 and
only the stored words are uint32.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_DTYPE = torch.uint32
# the fp32 sentinel the reference masks invalid columns with
BIG = float(np.float32(3.4e38))


def inv_qmax(bits: int) -> float:
    """f32(1/qmax), the constant the reference multiplies the range by
    (a reciprocal multiply, not a division by qmax)."""
    return float(np.float32(1.0 / ((1 << bits) - 1)))


def _as_words(word64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 words, bit for bit."""
    signed = torch.where(word64 >= 2 ** 31, word64 - 2 ** 32, word64)
    return signed.to(torch.int32).view(WORD_DTYPE)


def words_numpy(words: torch.Tensor) -> np.ndarray:
    """uint32 words (any device, any strides) -> host numpy uint32, bit
    for bit. The copy goes through an int32 view: PyTorch's CUDA copy
    kernels do not all take uint32."""
    return words.view(torch.int32).cpu().numpy().view(np.uint32)


def pack_words(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """levels (C, N) integers -> (C, N*bits/32) uint32, little-endian."""
    per = 32 // bits
    c, n = levels.shape
    if n % per:
        raise ValueError(f"N={n} is not a multiple of {per} levels")
    grp = levels.to(torch.int64).reshape(c, n // per, per)
    shifts = torch.arange(per, dtype=torch.int64,
                          device=levels.device) * bits
    return _as_words(torch.sum(grp << shifts, dim=-1))


def unpack_words(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., Nw) uint32 -> (..., Nw*32/bits) int64 levels."""
    per = 32 // bits
    mask = (1 << bits) - 1
    shifts = torch.arange(per, dtype=torch.int64,
                          device=packed.device) * bits
    w = packed.to(torch.int64)
    lv = (w[..., None] >> shifts) & mask
    return lv.reshape(*packed.shape[:-1], packed.shape[-1] * per)


def _positive_zero(zp: torch.Tensor) -> torch.Tensor:
    """zp is clipped to [0, qmax], so a zero may carry a minus sign
    (round(-0.0 / scale) = -0.0, and ``clamp`` keeps it). The reference
    emits +0.0, and the wire carries the sign bit."""
    return torch.where(zp > 0, zp, torch.zeros_like(zp))


def _qparams(xmin: torch.Tensor, xmax: torch.Tensor, bits: int):
    qmax = (1 << bits) - 1
    rng = xmax - xmin
    # an fp32 tensor times a Python float multiplies in fp32, and the
    # constant is exactly an fp32 value
    scale = torch.where(rng > 0, rng * inv_qmax(bits), torch.ones_like(rng))
    zp = torch.clamp(torch.round(-xmin / scale), 0, qmax)
    return scale, _positive_zero(zp)


def quant_pack_rows_ref(x2d: torch.Tensor, n_valid: torch.Tensor,
                        bits: int):
    """Ragged-row quantize + pack (the twin of ``ops._quant_pack_rows_jnp``
    in the JAX package). Row ``c`` is quantized over its first
    ``n_valid[c]`` columns; levels past that are 0. Returns (packed (C,
    N*bits/32) uint32, scale (C,) fp32, zp (C,) fp32)."""
    qmax = (1 << bits) - 1
    x = x2d.to(torch.float32)
    col = torch.arange(x.shape[1], device=x.device)[None, :]
    valid = col < n_valid.to(x.device, torch.int64)[:, None]
    xmin = torch.clamp(torch.amin(torch.where(valid, x, BIG), dim=1),
                       max=0.0)
    xmax = torch.clamp(torch.amax(torch.where(valid, x, -BIG), dim=1),
                       min=0.0)
    scale, zp = _qparams(xmin, xmax, bits)
    q = torch.round(x / scale[:, None]) + zp[:, None]
    q = torch.where(valid, torch.clamp(q, 0, qmax), torch.zeros_like(q))
    return pack_words(q.to(torch.int64), bits), scale, zp


def quant_pack_ref(x: torch.Tensor, bits: int):
    """x (C, N) fp32, every column valid. Returns (packed, scale, zp)."""
    nv = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                    device=x.device)
    return quant_pack_rows_ref(x, nv, bits)


def dequant_agg_rows_ref(packed: torch.Tensor, scale: torch.Tensor,
                         zp: torch.Tensor, weights: torch.Tensor,
                         n_valid: torch.Tensor, bits: int) -> torch.Tensor:
    """Flat-tree cohort aggregate: packed (K, C, Nw), sidecars (K, C),
    per-row lengths (C,) -> (C, N) fp32.

    Clients fold in strict k order, ``acc += w_k * ((lv - zp_k) *
    scale_k)``, as the reference's ``_seq_fold`` does; ``zp`` counts as
    0 where ``scale`` is 0 (phantom rows); columns past a row's length
    are exact zeros."""
    k, c, nw = packed.shape
    n = nw * (32 // bits)
    w = weights.to(torch.float32)
    zpz = torch.where(scale > 0, zp, torch.zeros_like(zp))
    acc = torch.zeros((c, n), dtype=torch.float32, device=packed.device)
    for i in range(k):
        lv = unpack_words(packed[i], bits).to(torch.float32)
        acc = acc + w[i] * ((lv - zpz[i][:, None]) * scale[i][:, None])
    col = torch.arange(n, device=packed.device)[None, :]
    valid = col < n_valid.to(packed.device, torch.int64)[:, None]
    return torch.where(valid, acc, torch.zeros_like(acc))


def dequant_agg_ref(packed: torch.Tensor, scale: torch.Tensor,
                    zp: torch.Tensor, weights: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """packed (K, C, Nw); scale/zp (K, C); weights (K,) -> (C, N) fp32,
    every column valid."""
    c = packed.shape[1]
    n = packed.shape[2] * (32 // bits)
    nv = torch.full((c,), n, dtype=torch.int32, device=packed.device)
    return dequant_agg_rows_ref(packed, scale, zp, weights, nv, bits)


def _take(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``t[ids]`` along the slot dim. PyTorch has no CUDA gather for
    uint32, so words are gathered through an int32 view, bit for bit."""
    if t.dtype == WORD_DTYPE:
        return t.view(torch.int32)[ids].view(WORD_DTYPE)
    return t[ids]


def multi_lora_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                          a_stack: torch.Tensor, b_stack: torch.Tensor,
                          ids: torch.Tensor, s: float) -> torch.Tensor:
    """Multi-adapter ``y[m] = x[m]@w + s*(x[m]@A[ids[m]])@B[ids[m]]``
    over fp slabs (the twin of ``_multi_lora_matmul_jnp`` in the JAX
    package): gather, two batched contractions, fp32 throughout."""
    ids = ids.to(x.device, torch.int64)
    acc = x.to(torch.float32) @ w.to(torch.float32)
    am = a_stack[ids].to(torch.float32)                   # (M, K, R)
    bm = b_stack[ids].to(torch.float32)                   # (M, R, N)
    h = torch.einsum("mk,mkr->mr", x.to(torch.float32), am)
    y = torch.einsum("mr,mrn->mn", h, bm)
    return acc + s * y


def multi_lora_matmul_q_ref(x: torch.Tensor, w: torch.Tensor,
                            aq: torch.Tensor, a_scale: torch.Tensor,
                            a_zp: torch.Tensor, bq: torch.Tensor,
                            b_scale: torch.Tensor, b_zp: torch.Tensor,
                            ids: torch.Tensor, s: float,
                            bits: int) -> torch.Tensor:
    """The fused wire-format serving matmul (the twin of
    ``_multi_lora_matmul_q_jnp``): gather packed words by row id,
    unpack, keep the first K (A) and R (B) levels of each row, dequant
    as ``(lv - zp) * scale``, then the same contractions as
    :func:`multi_lora_matmul_ref`. The slice comes BEFORE the dequant:
    a zero level past the valid ones dequantizes to ``-zp*scale``, not
    0."""
    k = x.shape[1]
    r = a_scale.shape[1]
    ids = ids.to(x.device, torch.int64)
    xf = x.to(torch.float32)
    acc = xf @ w.to(torch.float32)
    la = unpack_words(_take(aq, ids), bits)[..., :k].to(torch.float32)
    adeq = (la - a_zp[ids][..., None]) * a_scale[ids][..., None]
    lb = unpack_words(_take(bq, ids), bits)[..., :r].to(torch.float32)
    bdeq = (lb - b_zp[ids][..., None]) * b_scale[ids][..., None]
    h = torch.einsum("mk,mrk->mr", xf, adeq)              # (M, R)
    y = torch.einsum("mr,mnr->mn", h, bdeq)               # (M, N)
    return acc + s * y
