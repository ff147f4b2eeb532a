"""Public wrappers for the CUDA kernels.

A wrapper given CUDA tensors checks them, allocates the outputs with
``torch.empty`` and launches its kernel on the current stream; a failed
build or launch raises. Given CPU tensors, it computes the kernel's plain
version (``ref.py``) instead. There is no other route: a CUDA tensor
never reaches the plain version here.

Each kernel wrapper counts its launches in a plain integer attribute
(``quant_pack_rows.launches``, ``dequant_agg_rows.launches``,
``multi_lora_matmul.launches``, ``multi_lora_matmul_packed.launches``),
added to only where the kernel is launched, so a run can show that it
went through the kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import LIBRARY, check
from repro_torch.utils.device import upload


def lane_levels(bits: int) -> int:
    """Column alignment in LEVELS: 32/bits levels per uint32 word x 128
    lanes. It fixes the flat layout's ``n_max`` and so the shapes of the
    packed buffers, which must match the JAX package's."""
    return (32 // bits) * 128


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _require(t: torch.Tensor, name: str, dtype, shape: tuple,
             device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _rows(n_valid, c: int, device) -> torch.Tensor:
    nv = torch.as_tensor(n_valid, dtype=torch.int32).to(device).contiguous()
    if tuple(nv.shape) != (c,):
        raise ValueError(f"n_valid has shape {tuple(nv.shape)}, expected "
                         f"({c},)")
    return nv


def quant_pack_rows(x2d: torch.Tensor, n_valid, bits: int):
    """Ragged-row quantize + pack for the flat-tree codec: ``x2d`` (C, N)
    fp32 with N a multiple of 32/bits; ``n_valid`` (C,) per-row true
    lengths. ONE launch packs the whole message. Returns (packed (C,
    N*bits/32) uint32, scale (C,) fp32, zp (C,) fp32)."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    c, n = x2d.shape
    per = 32 // bits
    if n % per:
        raise ValueError(f"N={n} is not a multiple of {per}")
    nv = _rows(n_valid, c, x2d.device)
    if _device_kind(x2d) == "cpu":
        return ref.quant_pack_rows_ref(x2d, nv, bits)
    dev = x2d.device
    _require(x2d, "x2d", torch.float32, (c, n), dev)
    _aligned(x2d, "x2d")
    packed = torch.empty((c, n // per), dtype=ref.WORD_DTYPE, device=dev)
    scale = torch.empty((c,), dtype=torch.float32, device=dev)
    zp = torch.empty((c,), dtype=torch.float32, device=dev)
    fn = LIBRARY.fn("quant_pack", "quant_pack_rows_launch")
    with torch.cuda.device(dev):
        err = fn(x2d.data_ptr(), nv.data_ptr(), packed.data_ptr(),
                 scale.data_ptr(), zp.data_ptr(), c, n, bits,
                 ref.inv_qmax(bits), _stream(dev))
    check(err, "quant_pack_rows")
    quant_pack_rows.launches += 1
    return packed, scale, zp


quant_pack_rows.launches = 0


def quant_pack(x2d: torch.Tensor, bits: int):
    """Per-tensor quantize + pack: x2d (C, N) channel-first fp32 view of
    one message tensor. Columns pad to the lane multiple; returns
    (packed (C, N_pad*bits/32), scale (C,), zp (C,)). Launches through
    :func:`quant_pack_rows`."""
    c, n = x2d.shape
    lane = lane_levels(bits)
    xp = torch.nn.functional.pad(x2d.to(torch.float32),
                                 (0, (-n) % lane)).contiguous()
    nv = torch.full((c,), n, dtype=torch.int32, device=x2d.device)
    return quant_pack_rows(xp, nv, bits)


def dequant_agg_rows(packed: torch.Tensor, scale: torch.Tensor,
                     zp: torch.Tensor, weights, n_valid, bits: int,
                     block_k: int | None = None,
                     whole_k: bool = False) -> torch.Tensor:
    """Flat-tree cohort aggregate: packed (K, C, Nw) uint32, sidecars
    (K, C) fp32, weights (K,), per-row lengths (C,) -> (C, N) fp32. ONE
    launch unpacks, dequantizes and reduces the whole K-client set; row
    tails come back as exact zeros.

    ``block_k`` and ``whole_k`` name the reference's two TPU programs
    (K-tiled and whole-K). Here one kernel folds the clients in strict k
    order inside each thread, so every value gives bit-identical output;
    they are checked and otherwise have no effect."""
    if block_k is not None and int(block_k) < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    k, c, nw = packed.shape
    dev = packed.device
    w = torch.as_tensor(weights, dtype=torch.float32).to(dev).contiguous()
    nv = _rows(n_valid, c, dev)
    if _device_kind(packed) == "cpu":
        return ref.dequant_agg_rows_ref(packed, scale, zp, w, nv, bits)
    _require(packed, "packed", ref.WORD_DTYPE, (k, c, nw), dev)
    _require(scale, "scale", torch.float32, (k, c), dev)
    _require(zp, "zp", torch.float32, (k, c), dev)
    _require(w, "weights", torch.float32, (k,), dev)
    out = torch.empty((c, nw * (32 // bits)), dtype=torch.float32,
                      device=dev)
    _aligned(out, "out")
    fn = LIBRARY.fn("dequant_agg", "dequant_agg_rows_launch")
    with torch.cuda.device(dev):
        err = fn(packed.data_ptr(), scale.data_ptr(), zp.data_ptr(),
                 w.data_ptr(), nv.data_ptr(), out.data_ptr(), k, c, nw,
                 bits, _stream(dev))
    check(err, "dequant_agg_rows")
    dequant_agg_rows.launches += 1
    return out


dequant_agg_rows.launches = 0


# the serving kernels' split-K depth at most (kMaxSplits in
# csrc/multi_lora_matmul.cu): the partial-product scratch holds this many
# (M, N) planes
SPLIT_K_MAX = 8


def _serving_scratch(m: int, n: int, r: int, device):
    """(h (M, R), partials (SPLIT_K_MAX, M, N)) fp32 scratch."""
    return (torch.empty((m, r), dtype=torch.float32, device=device),
            torch.empty((SPLIT_K_MAX, m, n), dtype=torch.float32,
                        device=device))


def _ids(ids, m: int, e: int, device) -> torch.Tensor:
    """Per-row adapter slots, checked on the host (every id in [0, E))
    and then uploaded as int32 without stalling the stream. The engine
    passes a Python list, so the check costs no device round trip; a
    CUDA tensor is copied back."""
    host = torch.as_tensor(ids).detach().cpu()
    if host.dtype.is_floating_point or host.dtype == torch.bool:
        raise ValueError(f"ids must be integers, got {host.dtype}")
    host = host.to(torch.int64)
    if tuple(host.shape) != (m,):
        raise ValueError(f"ids has shape {tuple(host.shape)}, expected "
                         f"({m},)")
    if m and (int(host.min()) < 0 or int(host.max()) >= e):
        raise ValueError(f"ids must lie in [0, {e}): got "
                         f"[{int(host.min())}, {int(host.max())}]")
    return upload(host.to(torch.int32), device)


def multi_lora_matmul(x: torch.Tensor, w: torch.Tensor,
                      a_stack: torch.Tensor, b_stack: torch.Tensor, ids,
                      s: float) -> torch.Tensor:
    """Batched multi-adapter ``y[m] = x[m]@w + s*(x[m]@A[ids[m]])@B[ids[m]]``
    over fp slabs (the dequant-then-matmul baseline's second step):
    x (M, K), w (K, N), a_stack (E, K, R), b_stack (E, R, N) fp32, ids
    (M,) slots -> (M, N) fp32. One launch (counted once) enqueues the
    h = x@A[ids] kernel, the split-K tile kernel and the epilogue, with
    their scratch allocated here. No padding of M or R is needed: the
    kernels mask their ragged edges."""
    m, k = x.shape
    n = w.shape[1]
    e, _, r = a_stack.shape
    dev = x.device
    idt = _ids(ids, m, e, dev)
    if _device_kind(x) == "cpu":
        return ref.multi_lora_matmul_ref(x, w, a_stack, b_stack, idt, s)
    _require(x, "x", torch.float32, (m, k), dev)
    _require(w, "w", torch.float32, (k, n), dev)
    _require(a_stack, "a_stack", torch.float32, (e, k, r), dev)
    _require(b_stack, "b_stack", torch.float32, (e, r, n), dev)
    h, part = _serving_scratch(m, n, r, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = LIBRARY.fn("multi_lora_matmul", "multi_lora_matmul_launch")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(), a_stack.data_ptr(),
                 b_stack.data_ptr(), idt.data_ptr(), h.data_ptr(),
                 part.data_ptr(), out.data_ptr(), m, k, n, r, float(s),
                 _stream(dev))
    check(err, "multi_lora_matmul")
    multi_lora_matmul.launches += 1
    return out


multi_lora_matmul.launches = 0


def multi_lora_matmul_packed(x: torch.Tensor, w: torch.Tensor,
                             aq: torch.Tensor, a_scale: torch.Tensor,
                             a_zp: torch.Tensor, bq: torch.Tensor,
                             b_scale: torch.Tensor, b_zp: torch.Tensor,
                             ids, s: float, bits: int) -> torch.Tensor:
    """The FUSED wire-format serving matmul: gather each row's packed
    adapter words, unpack + dequant inside the product. One launch
    (counted once) enqueues the h kernel, the split-K tile kernel and
    the epilogue.
    Slab layout (channel-first wire rows, compact words): aq (E, R, KW)
    uint32 with (E, R) fp32 scale/zp; bq (E, N, RW) uint32 with (E, N)
    scale/zp; KW*32/bits >= K and RW*32/bits >= R. Rank-bucket padding
    rides rows with scale = zp = 0. x (M, K), w (K, N) fp32 ->
    (M, N) fp32."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    m, k = x.shape
    n = w.shape[1]
    e, r, kw = aq.shape
    rw = bq.shape[2]
    per = 32 // bits
    if kw * per < k or rw * per < r:
        raise ValueError(f"packed rows too short: KW={kw}, RW={rw} hold "
                         f"{kw * per} and {rw * per} levels at {bits} bits "
                         f"for K={k}, R={r}")
    dev = x.device
    idt = _ids(ids, m, e, dev)
    if _device_kind(x) == "cpu":
        return ref.multi_lora_matmul_q_ref(x, w, aq, a_scale, a_zp, bq,
                                           b_scale, b_zp, idt, s, bits)
    _require(x, "x", torch.float32, (m, k), dev)
    _require(w, "w", torch.float32, (k, n), dev)
    _require(aq, "aq", ref.WORD_DTYPE, (e, r, kw), dev)
    _require(a_scale, "a_scale", torch.float32, (e, r), dev)
    _require(a_zp, "a_zp", torch.float32, (e, r), dev)
    _require(bq, "bq", ref.WORD_DTYPE, (e, n, rw), dev)
    _require(b_scale, "b_scale", torch.float32, (e, n), dev)
    _require(b_zp, "b_zp", torch.float32, (e, n), dev)
    h, part = _serving_scratch(m, n, r, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = LIBRARY.fn("multi_lora_matmul", "multi_lora_matmul_q_launch")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(), aq.data_ptr(),
                 a_scale.data_ptr(), a_zp.data_ptr(), bq.data_ptr(),
                 b_scale.data_ptr(), b_zp.data_ptr(), idt.data_ptr(),
                 h.data_ptr(), part.data_ptr(), out.data_ptr(), m, k, n, r,
                 kw, rw, bits, float(s), _stream(dev))
    check(err, "multi_lora_matmul_packed")
    multi_lora_matmul_packed.launches += 1
    return out


multi_lora_matmul_packed.launches = 0


_COUNTED = (quant_pack_rows, dequant_agg_rows, multi_lora_matmul,
            multi_lora_matmul_packed)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _COUNTED}


# ---------------------------------------------------------------------------
# Channel-first 2D views (the codec's last-axis-channel convention)
# ---------------------------------------------------------------------------

def to_channel_first_2d(x: torch.Tensor, per_stack: bool = False
                        ) -> torch.Tensor:
    """(..., C) -> (C, prod(...)): the channel-first 2D view matching the
    per-channel qparam groups. ``per_stack`` keeps a leading stack dim's
    slices as separate qparam rows ((s*C, n) for an (s, n, C) tensor)."""
    if per_stack and x.ndim >= 3:
        s = int(np.prod(tuple(x.shape[:-2])))
        x3 = x.reshape(s, x.shape[-2], x.shape[-1]).transpose(-1, -2)
        return x3.reshape(s * x.shape[-1], x.shape[-2])
    return torch.movedim(x, -1, 0).reshape(x.shape[-1], -1)


def from_channel_first_2d(x2d: torch.Tensor, shape: tuple,
                          per_stack: bool = False) -> torch.Tensor:
    """Inverse of :func:`to_channel_first_2d` for a target ``shape``."""
    shape = tuple(shape)
    if per_stack and len(shape) >= 3:
        s = int(np.prod(shape[:-2]))
        x3 = x2d.reshape(s, shape[-1], shape[-2])
        return x3.transpose(-1, -2).reshape(shape)
    x = x2d.reshape((shape[-1],) + shape[:-1])
    return torch.movedim(x, 0, -1)
