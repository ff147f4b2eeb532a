"""The paper's technique AT SCALE: a multi-pod FL server round over
``torch.distributed`` (the JAX package's ``launch/fl_round.py``).

Hierarchical aggregation on the (pod, data, model) mesh
(``launch/mesh.py``):

  stage 1 (in a pod): each pod holds its cohort's client adapter trees
    stacked (P, Kp, ...), P over 'pod' and Kp over 'data'. Every client
    tree is RTN round-tripped (``messages.roundtrip``, the uplink view)
    and n_k-weighted-averaged with ``wn = w / max(wsum, 1e-8)``: each
    rank sums its block of clients and ONE ``all_reduce`` over the pod's
    'data' group adds the blocks. With one pod the round returns this
    partial aggregate.

  stage 2 (across pods, :func:`exchange_pods`): each pod QUANTIZES its
    partial with the shared wire codec (``messages.pack_message``: one
    B1 ``quant_pack`` launch a leaf on the card) and the pods exchange
    the packed payload and its fp32 sidecars with ``all_gather`` over
    the 'pod' group, so FLoCoRA-compressed traffic is all that crosses
    the slow links between pods (4x less than fp32 at int8, 16x at
    int2). Every rank unpacks each pod's message and weights it by
    ``pod_w = wsum / sum(wsum)``.

Layout. The 'model' axis splits every leaf's LAST axis, its channels
(the rows of the flat wire layout), in DTensor's ``Shard`` chunks: a
rank quantizes, packs and holds whole channels, so each channel's scale
and zero-point are computed on one rank and no value depends on the
'model' axis' size. 1-D leaves (fp32 on the wire) split the same way.
The JAX package lets XLA place the leaves' dims on 'model' by their
logical annotations instead; the values are the same.

The wire payload. A pod's message crosses as ONE int32 word buffer (the
compact packed bytes of every leaf: each leaf's levels back to back,
packed by ``quant.pack_levels`` with no row or lane padding, the bytes
``PackedLeaf.to_wire`` serializes; the whole zero-padded to a word, since
gloo takes no uint32) and ONE fp32 buffer (leaf by leaf, a packed
leaf's scales and zero points, a 1-D leaf's values). Its bytes are the
codec's ``message_wire_bytes`` of the rank's share, the payload rounded
up to a word. Quantization off (``bits=None``), the partial crosses as fp32.

``staleness_half_life`` gives the async engine's multi-pod flush: the
weights are discounted by ``2^(-staleness / half_life)`` before stage
1; the exchange is the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.registry import ArchEntry
from repro_torch.core import messages, quant
from repro_torch.core.flat import ShapeDtype
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.utils import comm
from repro_torch.utils.sharding import logical_to_spec, mesh_axis_size, \
    placement_leaves
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

POD, DATA, MODEL = "pod", "data", "model"


def _chunk(n: int, parts: int, i: int) -> tuple[int, int]:
    """[lo, hi) of part ``i`` of ``n`` in DTensor's ``Shard`` layout
    (``torch.chunk``: parts of ceil(n / parts), the last ones short or
    empty)."""
    size = -(-n // parts)
    lo = min(i * size, n)
    return lo, min(lo + size, n)


def _coord(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _contiguous_stride(shape: tuple) -> tuple:
    st, acc = [], 1
    for d in reversed(shape):
        st.append(acc)
        acc *= d
    return tuple(reversed(st))


# ---------------------------------------------------------------------------
# The wire payload
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Slot:
    """One leaf of a pod's message: its (local) shape, and for a packed
    leaf its channels, levels a channel and payload bytes."""
    shape: tuple
    packed: bool
    channels: int = 0
    n: int = 0
    nbytes: int = 0


def pack_pod_message(leaves: list, bits: int) -> tuple:
    """A pod's partial (a list of fp32 leaves) -> (words int32, floats
    fp32, slots): ``messages.pack_message`` packs every quantizable leaf
    (one ``quant_pack`` launch a leaf); each packed leaf's payload is
    compacted into the word buffer, and its sidecars, or a 1-D leaf's
    values, go into the fp32 buffer, leaf by leaf."""
    nonempty = [x for x in leaves if x.numel()]
    msg = iter(messages.pack_message(nonempty, QuantConfig(bits=bits)))
    streams, floats, slots = [], [], []
    for x in leaves:
        shape = tuple(x.shape)
        if not x.numel():
            slots.append(_Slot(shape, messages.quantizable(x)))
            continue
        m = next(msg)
        if messages.is_packed_leaf(m):
            # only the words that hold valid levels: a row pads to the
            # kernel's lane multiple, 64x the valid levels at int2 for
            # a channel of 32
            n = m.n_per_channel
            s = quant.pack_levels(kref.unpack_words(
                m.payload[:, : -(-n * bits // 32)], bits)[:, :n], bits)
            streams.append(s)
            floats += [m.scale, m.zp]
            slots.append(_Slot(shape, True, m.channels, n, s.numel()))
        else:
            floats.append(m.reshape(-1).to(torch.float32))
            slots.append(_Slot(shape, False))
    dev = leaves[0].device
    u8 = torch.cat(streams) if streams else torch.zeros(
        (0,), dtype=torch.uint8, device=dev)
    u8 = torch.nn.functional.pad(u8, (0, (-u8.numel()) % 4))
    fl = torch.cat(floats) if floats else torch.zeros((0,), device=dev)
    return u8.view(torch.int32), fl, slots


def unpack_pod_message(words: torch.Tensor, floats: torch.Tensor,
                       slots: list, bits: int) -> list:
    """Inverse of :func:`pack_pod_message`: the fp32 leaves a pod sent,
    dequantized as ``messages.unpack_message`` does."""
    u8 = words.contiguous().view(torch.uint8)
    out, ob, of = [], 0, 0
    for s in slots:
        if s.packed and s.channels:
            lv = quant.unpack_levels(u8[ob: ob + s.nbytes], bits,
                                     s.channels * s.n).reshape(s.channels,
                                                               s.n)
            scale = floats[of: of + s.channels]
            zp = floats[of + s.channels: of + 2 * s.channels]
            ob, of = ob + s.nbytes, of + 2 * s.channels
            x2d = (lv.to(torch.float32) - zp[:, None]) * scale[:, None]
            out.append(kops.from_channel_first_2d(x2d, s.shape))
        else:
            n = int(np.prod(s.shape))
            out.append(floats[of: of + n].reshape(s.shape))
            of += n
    return out


def exchange_pods(partial: Any, wsum: torch.Tensor, mesh,
                  bits: Optional[int], axis: str = POD) -> tuple:
    """Stage 2 on its own: this rank's share of its pod's partial (a
    tree of fp32 tensors) is packed (``bits``; None sends fp32),
    all-gathered over ``mesh``'s ``axis`` group as int32 words and fp32
    sidecars, unpacked pod by pod and weighted by ``wsum / sum(wsum)``
    (``wsum``: (P,) the pods' weight sums). Returns (the fp32 aggregate
    tree, {"words": (P, Nw) int32 or None, "floats": (P, Nf) fp32}, the
    buffers as gathered)."""
    leaves, treedef = tree_flatten(partial)
    if bits:
        words, floats, slots = pack_pod_message(leaves, bits)
        gw = comm.all_gather(words, mesh, axis)
        gf = comm.all_gather(floats, mesh, axis)
        decs = [unpack_pod_message(gw[p], gf[p], slots, bits)
                for p in range(gw.shape[0])]
    else:
        gw = None
        gf = comm.all_gather(torch.cat(
            [x.reshape(-1).to(torch.float32) for x in leaves]), mesh, axis)
        sizes = [x.numel() for x in leaves]
        decs = [[c.reshape(x.shape) for c, x in zip(
            torch.split(gf[p], sizes), leaves)] for p in range(gf.shape[0])]
    pod_w = wsum.to(torch.float32) / torch.sum(wsum.to(torch.float32))
    out = []
    for i in range(len(leaves)):
        acc = decs[0][i].to(torch.float32) * pod_w[0]
        for p in range(1, len(decs)):
            acc = acc + decs[p][i].to(torch.float32) * pod_w[p]
        out.append(acc)
    return tree_unflatten(treedef, out), {"words": gw, "floats": gf}


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------

def _pod_partial(leaves: list, wn: torch.Tensor, p: int, k0: int,
                 qcfg: QuantConfig, mesh, reduce_data: bool) -> list:
    """Stage 1: sum_k wn[p, k0 + j] * roundtrip(client j) over this
    rank's block of clients (fp32), then the pod's 'data' blocks added
    by one ``all_reduce``."""
    acc = [torch.zeros(tuple(x.shape[2:]), dtype=torch.float32,
                       device=x.device) for x in leaves]
    live = [i for i, x in enumerate(leaves) if x[0, 0].numel()]
    for j in range(leaves[0].shape[1]):
        recon = messages.roundtrip([leaves[i][0, j] for i in live], qcfg)
        for i, r in zip(live, recon):
            acc[i].add_(r.to(torch.float32) * wn[p, k0 + j])
    if reduce_data:
        flat = torch.cat([a.reshape(-1) for a in acc])
        comm.all_reduce(flat, mesh, DATA)
        acc = [c.reshape(a.shape) for c, a in zip(
            torch.split(flat, [a.numel() for a in acc]), acc)]
    return acc


def build_fl_round(entry: ArchEntry, mesh=None, *, clients_per_pod: int = 16,
                   bits: Optional[int] = 8,
                   staleness_half_life: Optional[float] = None) -> dict:
    """The round on ``mesh`` (default: ``make_production_mesh(
    multi_pod=True)`` on the card) for ``entry``'s full config, LM or
    enc-dec. Returns {"fn", "args", "in_placements", "out_placements",
    "cfg", "mesh"}: ``fn(stacked_clients, weights[, staleness])`` takes
    the stacked train trees (P, Kp, *leaf) and the (P, Kp) weights (and
    staleness), as DTensors or as this rank's local shards, and returns
    the aggregated train tree as DTensors (fp32, replicated over 'pod'
    and 'data', channels split over 'model'); ``args`` holds their
    global shapes (``ShapeDtype``) and ``in_placements`` their
    placements."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import lm as LM
    if mesh is None:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=True)
    cfg = entry.full()
    mod = ED if entry.kind == "encdec" else LM
    train_shapes = mod.init(0, cfg, device="meta")["train"]
    n_pods = mesh_axis_size(mesh, POD)
    kp = clients_per_pod
    qcfg = QuantConfig(bits=bits) if bits else QuantConfig()
    # Kp shards over 'data' where it divides (the reference's best-effort
    # rule), else every data rank reduces the whole pod
    kp_spec = logical_to_spec(("__pod", "__kp"), (n_pods, kp), mesh,
                              {"__pod": POD, "__kp": DATA})
    kp_sharded = kp_spec[1] == DATA
    names = tuple(mesh.mesh_dim_names)

    def client_pl(x):
        nd = x.ndim + 2
        return tuple(Shard(0) if ax == POD
                     else Shard(1) if ax == DATA and kp_sharded
                     else Shard(nd - 1) if ax == MODEL
                     else Replicate() for ax in names)

    def out_pl(x):
        return tuple(Shard(x.ndim - 1) if ax == MODEL else Replicate()
                     for ax in names)

    stacked = tree_map(lambda x: ShapeDtype((n_pods, kp) + tuple(x.shape),
                                            x.dtype), train_shapes)
    sh_clients = tree_map(client_pl, train_shapes)
    sh_out = tree_map(out_pl, train_shapes)
    w_spec = ShapeDtype((n_pods, kp), torch.float32)
    sh_w = tuple(Replicate() for _ in names)
    shapes, treedef = tree_flatten(train_shapes)
    p = _coord(mesh, POD)
    k0 = _coord(mesh, DATA) * (kp // mesh_axis_size(mesh, DATA)) \
        if kp_sharded else 0
    reduce_data = kp_sharded and mesh_axis_size(mesh, DATA) > 1

    out_pls = placement_leaves(sh_out)

    def _round_core(stacked_clients: Any, weights) -> Any:
        leaves = [_local(x) for x in tree_flatten(stacked_clients)[0]]
        w = _local(weights).to(torch.float32)
        wsum = torch.sum(w, dim=1, keepdim=True)
        wn = w / torch.clamp(wsum, min=1e-8)
        part = _pod_partial(leaves, wn, p, k0, qcfg, mesh, reduce_data)
        if n_pods > 1:
            part = tree_flatten(exchange_pods(
                tree_unflatten(treedef, part), wsum[:, 0], mesh, bits)[0])[0]
        return tree_unflatten(treedef, [
            DTensor.from_local(x, mesh, list(pl), run_check=False,
                               shape=tuple(s.shape),
                               stride=_contiguous_stride(tuple(s.shape)))
            for x, pl, s in zip(part, out_pls, shapes)])

    out = {"in_placements": (sh_clients, sh_w), "out_placements": sh_out,
           "cfg": cfg, "mesh": mesh}
    if staleness_half_life is None:
        return {**out, "fn": _round_core, "args": (stacked, w_spec)}

    hl = float(staleness_half_life)

    def fl_round_async(stacked_clients: Any, weights, staleness) -> Any:
        # FedBuff discount w = n_k * 2^(-s/hl) ahead of the in-pod
        # reduction; the quantized cross-pod exchange is unchanged
        w = _local(weights).to(torch.float32)
        s = _local(staleness).to(torch.float32)
        return _round_core(stacked_clients, w * torch.exp2(-s / hl))

    return {**out, "fn": fl_round_async,
            "args": (stacked, w_spec, w_spec),
            "in_placements": (sh_clients, sh_w, sh_w)}


def local_shard(full: torch.Tensor, pl: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under placements ``pl`` (DTensor's
    ``Shard`` chunks, taken in mesh-dim order)."""
    x = full
    for ax, p in zip(mesh.mesh_dim_names, pl):
        if isinstance(p, Shard):
            lo, hi = _chunk(x.shape[p.dim], mesh.size(
                list(mesh.mesh_dim_names).index(ax)), _coord(mesh, ax))
            x = x.narrow(p.dim, lo, hi - lo)
    return x
