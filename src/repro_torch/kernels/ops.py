"""Public wrappers for the CUDA kernels.

A wrapper given CUDA tensors checks them, allocates the outputs with
``torch.empty`` and launches its kernel on the current stream; a failed
build or launch raises. Given CPU tensors, it computes the kernel's plain
version (``ref.py``) instead. There is no other route: a CUDA tensor
never reaches the plain version here.

Each kernel wrapper counts its launches in a plain integer attribute
(``quant_pack_rows.launches``, ``dequant_agg_rows.launches``,
``dequant_agg.launches``, ``multi_lora_matmul.launches``,
``multi_lora_matmul_packed.launches``, ``lora_matmul.launches``), added
to only where the kernel is launched, so a run can show that it went
through the kernels. ``lora_matmul.paths`` counts its calls by the path
they took on the card (``lora_plan``).
"""
from __future__ import annotations

from typing import NamedTuple

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
    lengths. ONE launch packs the whole message, a 128-thread block per
    row; each row's levels past ``n_valid`` are never read and its words
    there are stored as zeros. Returns (packed (C, N*bits/32) uint32,
    scale (C,) fp32, zp (C,) fp32), bit-exact against
    ``ref.quant_pack_rows_ref``."""
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
    # host weights reach the card without a blocking copy (the streaming
    # fold calls this once an arrival, behind queued kernels)
    w = upload(torch.as_tensor(weights, dtype=torch.float32),
               dev).contiguous()
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


# -- mesh-sharded cohort reduction (the scale-out layer) --------------------

CLIENT_AXIS = "clients"


def pad_clients(packed: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                weights, multiple: int) -> tuple:
    """(packed, scale, zp, fp32 weights) with the K client dim padded to a
    multiple of ``multiple`` by phantom clients: zero words, zero scale
    and zp, zero weight, so each adds an exact zero."""
    w = torch.as_tensor(weights, dtype=torch.float32).to(packed.device)
    pad = (-packed.shape[0]) % multiple
    if not pad:
        return packed, scale, zp, w

    def padk(t):
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    # the words pad as int32: PyTorch's CUDA kernels do not all take uint32
    return (padk(packed.view(torch.int32)).view(ref.WORD_DTYPE), padk(scale),
            padk(zp), padk(w))


def dequant_agg_rows_sharded(packed: torch.Tensor, scale: torch.Tensor,
                             zp: torch.Tensor, weights, n_valid, bits: int,
                             mesh=None, axis: str = CLIENT_AXIS
                             ) -> torch.Tensor:
    """:func:`dequant_agg_rows` with the K client dim sharded over
    ``axis`` of ``mesh`` (default: ``launch.mesh.make_client_mesh()`` on
    the card). Every rank holds the whole (K, C, Nw) stacks, as the JAX
    package's global arrays; it folds its block of K / (axis size)
    clients through ONE ``dequant_agg_rows`` launch, and ONE
    ``all_reduce(SUM)`` over the axis' group combines the partial sums
    (the reference's ``psum``), so the reduction's bandwidth scales with
    the ranks. K pads to a multiple of the axis size with zero-weight
    phantom clients (exact-zero contributions); no client is dropped.
    Returns the (C, N) fp32 sum on every rank."""
    from repro_torch.utils import comm
    if mesh is None:
        from repro_torch.launch.mesh import make_client_mesh
        mesh = make_client_mesh()
    n_sh = mesh.size(list(mesh.mesh_dim_names).index(axis))
    packed, scale, zp, w = pad_clients(packed, scale, zp, weights, n_sh)
    kb = packed.shape[0] // n_sh
    r = mesh.get_local_rank(axis)
    blk = slice(r * kb, (r + 1) * kb)
    part = dequant_agg_rows(packed[blk].contiguous(),
                            scale[blk].contiguous(), zp[blk].contiguous(),
                            w[blk].contiguous(), n_valid, bits)
    return comm.all_reduce(part, mesh, axis)


# csrc/dequant_agg.cu, the grouped per-leaf fold: threads a block, packed
# words a thread (one 16-byte load), and the int64 words of the largest
# table it takes in its kernel parameters (a larger one is uploaded)
AGG_THREADS = 64
AGG_WORDS = 4
AGG_INLINE_WORDS = 1024


def _client_row(payload: torch.Tensor, scale: torch.Tensor,
                zp: torch.Tensor, c: int, nw: int, dev) -> tuple:
    """One client's (words, row stride in words, scale, zp) addresses for
    the descriptor table, after checking what the kernel reads: a (C, nw)
    uint32 view with unit column stride, (C,) contiguous fp32 sidecars,
    all on ``dev``. One pass of cheap checks: this runs K times a leaf."""
    st = payload.stride()
    if not (payload.dtype == ref.WORD_DTYPE and payload.device == dev
            and payload.shape == (c, nw) and st[1] == 1
            and scale.dtype == zp.dtype == torch.float32
            and scale.device == zp.device == dev
            and scale.shape == zp.shape == (c,)
            and scale.is_contiguous() and zp.is_contiguous()):
        raise ValueError(
            f"a client needs a ({c}, {nw}) uint32 payload view with unit "
            f"column stride and ({c},) contiguous fp32 scale and zp on "
            f"{dev}; got {payload.dtype} {tuple(payload.shape)} strides "
            f"{st} on {payload.device}, {scale.dtype} "
            f"{tuple(scale.shape)} on {scale.device}, {zp.dtype} "
            f"{tuple(zp.shape)} on {zp.device}")
    return payload.data_ptr(), st[0], scale.data_ptr(), zp.data_ptr()


def _launch_leaves(heads: list, clients: list, w: torch.Tensor, k: int,
                   bits: int, dev) -> None:
    """ONE launch of the grouped fold. ``heads`` holds a leaf's (C, words
    a row, valid levels, n_valid vector address or 0, output address,
    output row stride, 16-byte loads allowed); ``clients`` its K rows of
    :func:`_client_row`, leaf by leaf. The int64 table the kernel reads:
    L + 1 block starts, 8 fields a leaf (its head, with a flags word: 1 =
    16-byte loads, 2 = float4 stores), 4 a (leaf, client). Up to
    ``AGG_INLINE_WORDS`` it rides in the launch's parameters (no copy on
    the stream); a larger one goes to the card in one non-blocking
    pinned copy first."""
    per = 32 // bits
    starts = [0]
    for c, _, _, _, _, n_out, _ in heads:
        words_out = -(-n_out // per)            # words a row that are stored
        groups = -(-words_out // AGG_WORDS)     # threads a row
        starts.append(starts[-1] + -(-(c * groups) // AGG_THREADS))
    if starts[-1] == 0:
        return
    n_leaves = len(heads)
    flags = [int(vec) | 2 * int(n_out % 4 == 0 and out % 16 == 0)
             for _, _, _, _, out, n_out, vec in heads]
    table = np.concatenate([
        np.asarray(starts, np.int64),
        np.asarray([h[:6] + (f, 0) for h, f in zip(heads, flags)],
                   np.int64).reshape(-1),
        np.asarray(clients, np.int64).reshape(-1)])
    inline = table.size <= AGG_INLINE_WORDS
    dt = None if inline else upload(torch.from_numpy(table), dev)
    fn = LIBRARY.fn("dequant_agg", "dequant_agg_leaves_launch")
    with torch.cuda.device(dev):
        err = fn(table.ctypes.data if inline else dt.data_ptr(), table.size,
                 int(not inline), w.data_ptr(), n_leaves, k, starts[-1], bits,
                 _stream(dev))
    check(err, "dequant_agg")
    dequant_agg.launches += 1


def _vec_loads(rows: list) -> bool:
    """Every client's words start on 16 bytes and its row stride is a
    multiple of 4 words: whole 16-byte loads."""
    return all(p % 16 == 0 and st % AGG_WORDS == 0 for p, st, _, _ in rows)


def dequant_agg(packed: torch.Tensor, scale: torch.Tensor,
                zp: torch.Tensor, weights, bits: int,
                n_valid=None) -> torch.Tensor:
    """Per-leaf cohort aggregate (one packed leaf of K clients): packed
    (K, C, Nw) uint32, sidecars (K, C) fp32, weights (K,) -> (C, N)
    fp32 in ONE launch: the grouped kernel of :func:`dequant_agg_leaves`
    with one leaf, writing every one of the N columns. ``n_valid`` (a
    scalar, a (C,) vector or None = N) masks each row's tail to exact
    +0.0. zp counts as 0 wherever scale <= 0, as the JAX wrapper's
    ``where`` makes it; the kernel applies that in registers, the plain
    version with ``torch.where``. Clients fold in the reference kernel's
    order, which differs from :func:`dequant_agg_rows`'
    (``ref.dequant_agg_ref``)."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    k, c, nw = packed.shape
    n = nw * (32 // bits)
    dev = packed.device
    w = torch.as_tensor(weights, dtype=torch.float32).to(dev).contiguous()
    if n_valid is None or isinstance(n_valid, (int, np.integer)):
        # one length for every row rides in the table: no vector to fill
        # (a launch) or copy (a blocking host copy per call would make the
        # host wait for every queued kernel)
        nv_all, nv = n if n_valid is None else int(n_valid), None
    else:
        nv = torch.as_tensor(n_valid, dtype=torch.int32)
        nv = nv.expand(c).contiguous() if nv.ndim == 0 else nv
        nv_all, nv = 0, _rows(upload(nv, dev), c, dev)
    if _device_kind(packed) == "cpu":
        return ref.dequant_agg_ref(packed, scale, zp, w, bits,
                                   nv_all if nv is None else nv)
    _require(packed, "packed", ref.WORD_DTYPE, (k, c, nw), dev)
    _require(scale, "scale", torch.float32, (k, c), dev)
    _require(zp, "zp", torch.float32, (k, c), dev)
    _require(w, "weights", torch.float32, (k,), dev)
    out = torch.empty((c, n), dtype=torch.float32, device=dev)
    # client i's rows lie at fixed offsets of the three stacks
    p0, s0, z0 = packed.data_ptr(), scale.data_ptr(), zp.data_ptr()
    rows = [(p0 + 4 * i * c * nw, nw, s0 + 4 * i * c, z0 + 4 * i * c)
            for i in range(k)]
    _launch_leaves([(c, nw, nv_all, 0 if nv is None else nv.data_ptr(),
                     out.data_ptr(), n, _vec_loads(rows))], rows, w, k,
                   bits, dev)
    return out


dequant_agg.launches = 0


def dequant_agg_leaves(leaves, weights, bits: int) -> list:
    """A round's per-leaf aggregate in ONE launch: ``leaves`` is a list
    of ``(clients, n)``, ``clients`` the K clients' ``(payload, scale,
    zp)`` of one packed leaf (payload a (C, Nw) uint32 view with any row
    stride, such as a row slice of a flat buffer; scale and zp (C,)
    fp32) and ``n`` its valid levels a row; weights (K,). Returns each
    leaf's compact (C, n) fp32 fold, the columns past ``n`` never
    computed or stored, bit-identical to ``dequant_agg(stacked, n)[:,
    :n]``. On the card the outputs are views into one fp32 buffer, the
    words are read where they lie (no stack), and the launch counts once
    on ``dequant_agg.launches``; CPU tensors take
    ``ref.dequant_agg_leaves_ref``."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    per = 32 // bits
    leaves = [(list(cl), int(n)) for cl, n in leaves]
    if not leaves:
        return []
    first = leaves[0][0][0][0]
    dev = first.device
    w = torch.as_tensor(weights, dtype=torch.float32).to(dev).contiguous()
    k = w.shape[0]
    for cl, n in leaves:
        if len(cl) != k or k < 1:
            raise ValueError(f"every leaf needs one (payload, scale, zp) "
                             f"per weight: {len(cl)} clients, {k} weights")
        if not 0 <= n <= cl[0][0].shape[1] * per:
            raise ValueError(f"n={n} levels do not fit {cl[0][0].shape[1]} "
                             f"words at {bits} bits")
    if _device_kind(first) == "cpu":
        return ref.dequant_agg_leaves_ref(leaves, w, bits)
    _require(w, "weights", torch.float32, (k,), dev)
    # each output starts on 16 bytes: whole float4 stores where n % 4 == 0
    sizes = [cl[0][1].shape[0] * n for cl, n in leaves]
    offs = np.concatenate([[0], np.cumsum([-(-s // 4) * 4 for s in sizes])])
    buf = torch.empty((int(offs[-1]),), dtype=torch.float32, device=dev)
    outs, heads, rows = [], [], []
    for (cl, n), off, size in zip(leaves, offs, sizes):
        c, nw = cl[0][1].shape[0], cl[0][0].shape[1]
        out = buf[int(off): int(off) + size].view(c, n)
        mine = [_client_row(p, s, z, c, nw, dev) for p, s, z in cl]
        heads.append((c, nw, n, 0, out.data_ptr(), n, _vec_loads(mine)))
        rows += mine
        outs.append(out)
    _launch_leaves(heads, rows, w, k, bits, dev)
    return outs


# the largest adapter rank the wgmma path holds (one m64nRP accumulator);
# larger ranks take the masked path, whose kernels walk r in 64-wide tiles
LORA_RANK_MAX = 128
# csrc/lora_matmul.cu: the TMA path's tile (two consumer warpgroups of 64
# rows by 80 columns), the masked path's square tile and K slab depth, the
# most K splits of its h kernel (one thread-block cluster), and the SMs of
# an H100 SXM that a wave fills
LORA_WG_TILE = (128, 80)
LORA_TILE = 64
LORA_H_SPLITS_MAX = 8
LORA_SMS = 132


class LoraPlan(NamedTuple):
    """How :func:`lora_matmul` runs on the card: ``path`` "wgmma" (one
    kernel: TMA loads into a ring, wgmma on two warpgroups, h in the
    mainloop) or "masked" (h's split-K kernel, then a WMMA tile that reads
    ragged edges itself, and the path of every r > ``LORA_RANK_MAX``),
    its (rows, columns) ``tile``, the GEMM's
    ``blocks`` and ``waves`` on ``LORA_SMS`` SMs, and the masked path's
    ``h_splits`` K chunks of ``h_k_chunk`` for h."""
    path: str
    tile: tuple
    blocks: int
    waves: int
    h_splits: int
    h_k_chunk: int


def lora_h_splits(k: int) -> tuple[int, int]:
    """(splits, k_chunk) of h = x@a: K cut into at most
    ``LORA_H_SPLITS_MAX`` chunks of whole 64-deep slabs, summed across
    one cluster in split order; no chunk is empty."""
    slabs = -(-k // LORA_TILE)
    want = max(1, min(slabs, LORA_H_SPLITS_MAX))
    k_chunk = -(-slabs // want) * LORA_TILE
    return -(-k // k_chunk), k_chunk


def lora_plan(m: int, k: int, n: int, r: int,
              aligned: bool = True) -> LoraPlan:
    """The path and tiling of :func:`lora_matmul` on the card, from the
    shapes and whether every operand starts on a 16-byte boundary, and
    nothing else. TMA needs 16-byte row strides: K, N and r multiples
    of 8 (bf16) and aligned bases take the wgmma path, up to
    ``LORA_RANK_MAX``; any other shape takes the masked path, still a
    kernel on the card."""
    tma = aligned and k % 8 == 0 and n % 8 == 0 and r % 8 == 0 \
        and r <= LORA_RANK_MAX
    tile = LORA_WG_TILE if tma else (LORA_TILE, LORA_TILE)
    blocks = -(-m // tile[0]) * -(-n // tile[1])
    splits, k_chunk = lora_h_splits(k)
    return LoraPlan("wgmma" if tma else "masked", tile, blocks,
                    -(-blocks // LORA_SMS), splits, k_chunk)


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, s: float) -> torch.Tensor:
    """Single-adapter ``y = x@w + s*(x@a)@b``: x (M, K), w (K, N),
    a (K, r), b (r, N) bf16 -> (M, N) bf16, every product accumulated in
    fp32, h = x@a summed over all of K and rounded to bf16 once, and the
    low-rank term added as ``acc + s*low``. Any M, K, N and r >= 1;
    nothing is padded. One launch, counted once. :func:`lora_plan` picks
    the path: on the wgmma path ONE kernel computes x@W and x@a in its
    mainloop (TMA loads into a shared-memory ring, wgmma on two
    warpgroups) and bf16(h)@b from registers in its epilogue; the masked
    path, for shapes TMA cannot read and for r > ``LORA_RANK_MAX``,
    enqueues h's split-K kernel (h (M, r) allocated here, each element
    rounded to bf16 once) and a WMMA tile kernel that adds h@b over
    64-deep rank slabs into one fp32 accumulator before y's single bf16
    rounding. ``lora_matmul.paths`` counts the calls of each path."""
    m, k = x.shape
    n = w.shape[1]
    r = a.shape[1]
    if r < 1:
        raise ValueError(f"rank must be at least 1, got {r}")
    dev = x.device
    if _device_kind(x) == "cpu":
        return ref.lora_matmul_ref(x, w, a, b, s)
    bf = torch.bfloat16
    _require(x, "x", bf, (m, k), dev)
    _require(w, "w", bf, (k, n), dev)
    _require(a, "a", bf, (k, r), dev)
    _require(b, "b", bf, (r, n), dev)
    plan = lora_plan(m, k, n, r, all(t.data_ptr() % 16 == 0
                                     for t in (x, w, a, b)))
    # the masked path's h kernel writes bf16(x@a) here; the wgmma path
    # keeps h in registers
    h = torch.empty((m, r), dtype=bf, device=dev) \
        if plan.path == "masked" else None
    out = torch.empty((m, n), dtype=bf, device=dev)
    fn = LIBRARY.fn("lora_matmul", "lora_matmul_launch")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                 None if h is None else h.data_ptr(), out.data_ptr(), m, k,
                 n, r, plan.h_splits, plan.h_k_chunk,
                 int(plan.path == "wgmma"), float(s), _stream(dev))
    check(err, "lora_matmul")
    lora_matmul.launches += 1
    lora_matmul.paths[plan.path] += 1
    return out


lora_matmul.launches = 0
lora_matmul.paths = {"wgmma": 0, "masked": 0}


# csrc/multi_lora_matmul.cu: the h = x@A[ids] blocks the serving kernels'
# first kernel aims for (two per SM of an H100), at most this many k
# chunks (the product kernel sums a row's chunks in order), and the
# chunks' granularity (32 levels: whole packed words at every bit width)
SERVE_H_BLOCKS = 264
SERVE_H_SPLITS_MAX = 8
SERVE_H_CHUNK = 32


def serving_h_splits(m: int, k: int) -> tuple[int, int]:
    """(splits, k_chunk) of the serving kernels' h kernel: enough k chunks
    (at most ``SERVE_H_SPLITS_MAX``) that the M x splits blocks number
    about ``SERVE_H_BLOCKS``, each chunk a whole number of
    ``SERVE_H_CHUNK`` levels. A function of the shapes only, so the
    result is deterministic."""
    q = SERVE_H_CHUNK
    want = max(1, min(-(-k // q), SERVE_H_SPLITS_MAX,
                      -(-SERVE_H_BLOCKS // max(m, 1))))
    k_chunk = -(-(-(-k // want)) // q) * q
    return -(-k // k_chunk), k_chunk


def serving_row_tile(m: int) -> int:
    """The 8-row MMA tiles in the product kernel's row tile: the least
    power of two with 8 * tiles >= M, from 1 to 8 (64 rows; more rows
    take several row tiles)."""
    tiles = 1
    while tiles < 8 and 8 * tiles < m:
        tiles *= 2
    return tiles


def _serving_scratch(m: int, k: int, r: int, device):
    """The serving kernels' scratch and launch shapes: (hpart (splits, M,
    R) fp32 for h's k chunks, xfrag (x's bf16 MMA fragments: the padded
    row tiles by K padded to 32, in 32-bit words), splits, k_chunk, row
    tile)."""
    if r < 1:
        raise ValueError(f"rank must be at least 1, got {r}")
    splits, k_chunk = serving_h_splits(m, k)
    mt = serving_row_tile(m)
    rows = -(-max(m, 1) // (8 * mt)) * 8 * mt
    return (torch.empty((splits, m, r), dtype=torch.float32, device=device),
            torch.empty((rows * -(-k // 32) * 32,), dtype=torch.int32,
                        device=device),
            splits, k_chunk, mt)


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
    (M,) slots -> (M, N) fp32. One launch (counted once) enqueues two
    kernels: the first computes h = x@A[ids] in k chunks and splits x
    into bf16 hi/lo MMA fragments; the second computes x@W as a
    three-pass split-bf16 product on the tensor cores (fp32-accurate),
    reduces its k splits inside a thread-block cluster and adds the
    adapter term in its epilogue, walking R in chunks of at most 128.
    Their scratch is allocated here. No padding of M or R is needed: the
    kernels mask their ragged edges; any R >= 1."""
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
    hpart, xfrag, splits, k_chunk, mt = _serving_scratch(m, k, r, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = LIBRARY.fn("multi_lora_matmul", "multi_lora_matmul_launch")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(), a_stack.data_ptr(),
                 b_stack.data_ptr(), idt.data_ptr(), hpart.data_ptr(),
                 xfrag.data_ptr(), out.data_ptr(), m, k, n, r, splits,
                 k_chunk, mt, float(s), _stream(dev))
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
    adapter words, unpack + dequant inside the kernels. One launch
    (counted once) enqueues the prep kernel and the product kernel (see
    :func:`multi_lora_matmul`).
    Slab layout (channel-first wire rows, compact words): aq (E, R, KW)
    uint32 with (E, R) fp32 scale/zp; bq (E, N, RW) uint32 with (E, N)
    scale/zp; KW*32/bits >= K and RW*32/bits >= R. Rank-bucket padding
    rides rows with scale = zp = 0. x (M, K), w (K, N) fp32 ->
    (M, N) fp32; any R >= 1."""
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
    hpart, xfrag, splits, k_chunk, mt = _serving_scratch(m, k, r, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = LIBRARY.fn("multi_lora_matmul", "multi_lora_matmul_q_launch")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(), aq.data_ptr(),
                 a_scale.data_ptr(), a_zp.data_ptr(), bq.data_ptr(),
                 b_scale.data_ptr(), b_zp.data_ptr(), idt.data_ptr(),
                 hpart.data_ptr(), xfrag.data_ptr(), out.data_ptr(), m, k, n,
                 r, kw, rw, bits, splits, k_chunk, mt, float(s),
                 _stream(dev))
    check(err, "multi_lora_matmul_packed")
    multi_lora_matmul_packed.launches += 1
    return out


multi_lora_matmul_packed.launches = 0


_COUNTED = (quant_pack_rows, dequant_agg_rows, dequant_agg,
            multi_lora_matmul, multi_lora_matmul_packed, lora_matmul)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
    lora_matmul.paths = dict.fromkeys(lora_matmul.paths, 0)


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
