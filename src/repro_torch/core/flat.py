"""Flat-tree wire codec: ONE kernel launch per message.

Every quantizable leaf of a message tree (ndim >= 2) takes a row range of
one ragged ``(C_total, N_max)`` fp32 buffer: its channel-first 2D view,
zero-padded past its own length ``n_valid``. ONE ``quant_pack_rows``
launch packs the whole message into ``(C_total, Nw_max)`` uint32 words
with fp32 ``scale``/``zp`` sidecars, and ONE ``dequant_agg_rows`` launch
reduces a K-client cohort. 1-D leaves travel fp32 beside the buffer.
The streaming fold (``fold_flat``, ``flat_mean_from_sum``) adds one
arriving message at a time into a running fp32 sum: one K = 1
``dequant_agg_rows`` launch an arrival (FedBuff's O(1)-memory flush,
``core/aggregation.StreamingFlatAccumulator``).

The row map (:class:`TreeLayout`) and the wire form are the JAX package's
(``repro/core/flat.py``): the same leaf order, buffer shapes and
byte-identical wire buffers, so a message packed by either package
decodes in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import _path_str, tree_flatten_with_path, \
    tree_leaves, tree_unflatten


# ---------------------------------------------------------------------------
# Host-side word/bit ops (no device pass)
# ---------------------------------------------------------------------------

def strip_row_padding(words: np.ndarray, bits: int,
                      n_valid: int) -> np.ndarray:
    """(C, Nw) uint32 kernel-layout words -> the exact wire payload:
    the first ``n_valid`` levels of every row packed contiguously
    little-endian, ``ceil(C * n_valid * bits / 8)`` uint8 bytes.

    The input may be WIDER than the row needs (a flat-buffer slice
    carries the layout-wide ``Nw_max``); only the compact word width is
    touched, and when each row's payload is byte-aligned the wire bytes
    are a direct byte view of the words."""
    nbits = n_valid * bits
    nww = (nbits + 31) // 32
    w = np.ascontiguousarray(np.asarray(words, dtype="<u4")[:, :nww])
    u8 = w.view(np.uint8).reshape(w.shape[0], -1)
    if nbits % 8 == 0:
        return u8[:, : nbits // 8].reshape(-1).copy()
    b = np.unpackbits(u8, axis=1, bitorder="little")[:, :nbits]
    return np.packbits(b.reshape(-1), bitorder="little")


def rows_from_wire(payload_u8: np.ndarray, bits: int, channels: int,
                   n_valid: int, nw: int) -> np.ndarray:
    """Inverse of :func:`strip_row_padding`: wire bytes -> (channels, nw)
    uint32 kernel-layout words with the canonical zero tail."""
    nbits = n_valid * bits
    if nbits % 8 == 0:
        u8 = np.zeros((channels, nw * 4), np.uint8)
        u8[:, : nbits // 8] = np.asarray(
            payload_u8, np.uint8)[: channels * (nbits // 8)].reshape(
                channels, nbits // 8)
        return u8.view("<u4").reshape(channels, nw)
    b = np.unpackbits(np.asarray(payload_u8, np.uint8),
                      bitorder="little")[: channels * nbits]
    full = np.zeros((channels, nw * 32), np.uint8)
    full[:, :nbits] = b.reshape(channels, nbits)
    by = np.packbits(full, axis=1, bitorder="little")
    return np.ascontiguousarray(by).view("<u4").reshape(channels, nw)


# ---------------------------------------------------------------------------
# Static layout
# ---------------------------------------------------------------------------

def _dtype_str(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape/dtype stand-in for a leaf (shape walks never touch data)."""
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static row-map entry for one leaf of the message tree."""
    path: str                 # flatten-order path string (wire entry name)
    shape: tuple              # original tensor shape
    dtype_str: str            # original dtype name, e.g. "float32"
    quantized: bool           # >= 2-D leaves quantize; vectors travel fp
    row_start: int = 0        # first row in the flat buffer
    rows: int = 0             # channel count C_i
    n_valid: int = 0          # true levels per row

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_str)


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """Row map of a whole message tree inside one flat packed buffer.
    Value-equal layouts describe the same tree signature."""
    treedef: Any              # repro_torch.utils.tree treedef
    leaves: tuple             # tuple[LeafSpec, ...] in flatten order
    bits: int
    per_stack: bool
    c_total: int              # total channel rows across quantized leaves
    n_max: int                # padded column count (lane multiple)

    @property
    def nw_max(self) -> int:
        return self.n_max * self.bits // 32

    def leaf_nw(self, spec: LeafSpec) -> int:
        """spec's own lane-padded word count (what a per-leaf
        ``PackedLeaf`` for this leaf would hold)."""
        lane = kops.lane_levels(self.bits)
        n_pad = ((spec.n_valid + lane - 1) // lane) * lane
        return n_pad * self.bits // 32

    def n_valid_vec(self) -> np.ndarray:
        nv = np.zeros((self.c_total,), np.int32)
        for s in self.leaves:
            if s.quantized:
                nv[s.row_start: s.row_start + s.rows] = s.n_valid
        return nv


def _channels_of(shape: tuple, per_stack: bool) -> int:
    if per_stack and len(shape) >= 3:
        return int(np.prod(shape[:-2])) * shape[-1]
    return shape[-1]


def layout_for(tree: Any, bits: int,
               per_stack: bool = False) -> Optional[TreeLayout]:
    """The flat layout of ``tree``'s message, or None when the tree has
    no quantizable leaf. A function of the tree's structure, leaf shapes
    and dtypes, ``bits`` and ``per_stack`` only."""
    flat, treedef = tree_flatten_with_path(tree)
    specs, row, n_big = [], 0, 0
    for path, x in flat:
        shape = tuple(int(d) for d in x.shape)
        dts = _dtype_str(x.dtype)
        if len(shape) < 2:        # paper rule: vectors travel fp32
            specs.append(LeafSpec(_path_str(path), shape, dts, False))
            continue
        c = _channels_of(shape, per_stack)
        n = int(np.prod(shape)) // c
        specs.append(LeafSpec(_path_str(path), shape, dts, True,
                              row_start=row, rows=c, n_valid=n))
        row += c
        n_big = max(n_big, n)
    if row == 0:
        return None
    lane = kops.lane_levels(bits)
    n_max = ((n_big + lane - 1) // lane) * lane
    return TreeLayout(treedef, tuple(specs), bits, per_stack, row, n_max)


# ---------------------------------------------------------------------------
# The wire leaf
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlatPackedMessage:
    """A whole quantized message as ONE flat packed buffer.

    ``payload`` is the ``(C_total, Nw_max)`` uint32 word buffer (rows =
    every quantizable leaf's channels, stacked in flatten order, each
    row zero past its leaf's true length); ``scale``/``zp`` are the fp32
    sidecars of length ``C_total``; ``fp_leaves`` carries the 1-D leaves
    in flatten order. ``layout`` is the static row map."""
    payload: torch.Tensor     # (C_total, Nw_max) uint32
    scale: torch.Tensor       # (C_total,) fp32
    zp: torch.Tensor          # (C_total,) fp32
    fp_leaves: tuple          # fp passthrough leaves, flatten order
    layout: TreeLayout

    @property
    def bits(self) -> int:
        return self.layout.bits

    @property
    def per_stack(self) -> bool:
        return self.layout.per_stack

    def shape_tree(self) -> Any:
        """Shape/dtype-only view with the ORIGINAL tree structure."""
        return tree_unflatten(self.layout.treedef,
                              [ShapeDtype(s.shape, s.dtype)
                               for s in self.layout.leaves])

    def replace_dtypes(self, like: Any) -> "FlatPackedMessage":
        """Advertise ``like``'s leaf dtypes: error feedback packs an
        fp32-compensated tree, but the wire must carry the adapters' own
        dtypes, or the aggregated global tree silently becomes fp32."""
        dts = [_dtype_str(x.dtype) for x in tree_leaves(like)]
        specs = tuple(dataclasses.replace(s, dtype_str=d)
                      for s, d in zip(self.layout.leaves, dts))
        layout = dataclasses.replace(self.layout, leaves=specs)
        fp = tuple(x.to(getattr(torch, d)) for x, d in zip(
            self.fp_leaves, [d for s, d in zip(self.layout.leaves, dts)
                             if not s.quantized]))
        return FlatPackedMessage(self.payload, self.scale, self.zp, fp,
                                 layout)

    # -- decode -------------------------------------------------------------
    def unpack(self) -> Any:
        """-> fp tree (original structure and dtypes): the whole buffer
        dequantizes at once, then each leaf's rows slice off."""
        lo = self.layout
        lv = kref.unpack_words(self.payload, lo.bits).to(torch.float32)
        x = (lv - self.zp[:, None]) * self.scale[:, None]
        out, fpi = [], 0
        for spec in lo.leaves:
            if spec.quantized:
                r0, r1 = spec.row_start, spec.row_start + spec.rows
                out.append(kops.from_channel_first_2d(
                    x[r0:r1, : spec.n_valid], spec.shape,
                    lo.per_stack).to(spec.dtype))
            else:
                out.append(self.fp_leaves[fpi])
                fpi += 1
        return tree_unflatten(lo.treedef, out)

    def as_tree(self) -> Any:
        """-> the equivalent per-leaf ``PackedLeaf`` tree: row and column
        slices of the flat buffer, bit-identical payloads."""
        from repro_torch.core.messages import PackedLeaf
        lo = self.layout
        out, fpi = [], 0
        for spec in lo.leaves:
            if spec.quantized:
                r0, r1 = spec.row_start, spec.row_start + spec.rows
                out.append(PackedLeaf(
                    self.payload[r0:r1, : lo.leaf_nw(spec)],
                    self.scale[r0:r1], self.zp[r0:r1], spec.shape,
                    spec.dtype, lo.bits, lo.per_stack))
            else:
                out.append(self.fp_leaves[fpi])
                fpi += 1
        return tree_unflatten(lo.treedef, out)

    # -- serialization (the actual bytes on the wire) -----------------------
    def to_wire_entries(self) -> list:
        """[(path, buffers)] in flatten order, from ONE device->host
        transfer of the word buffer; byte-identical to the JAX
        package's."""
        lo = self.layout
        words = self.payload.cpu().numpy()
        scale = self.scale.cpu().numpy().astype(np.float32)
        zp = self.zp.cpu().numpy().astype(np.float32)
        out, fpi = [], 0
        for spec in lo.leaves:
            if spec.quantized:
                r0, r1 = spec.row_start, spec.row_start + spec.rows
                out.append((spec.path, {
                    "payload": strip_row_padding(words[r0:r1], lo.bits,
                                                 spec.n_valid),
                    "scale": scale[r0:r1], "zp": zp[r0:r1]}))
            else:
                leaf = self.fp_leaves[fpi]
                out.append((spec.path, {"payload": leaf.detach().to(
                    torch.float32).cpu().numpy()}))
                fpi += 1
        return out

    @classmethod
    def from_wire_entries(cls, entries: list, layout: TreeLayout,
                          device="cuda") -> "FlatPackedMessage":
        """Rebuild the flat kernel-layout buffer on ``device`` from
        serialized wire buffers (inverse of :meth:`to_wire_entries`)."""
        dev = resolve_device(device)
        bufs = dict(entries)
        payload = np.zeros((layout.c_total, layout.nw_max), np.uint32)
        scale = np.zeros((layout.c_total,), np.float32)
        zp = np.zeros((layout.c_total,), np.float32)
        fp = []
        for spec in layout.leaves:
            b = bufs[spec.path]
            if spec.quantized:
                r0, r1 = spec.row_start, spec.row_start + spec.rows
                payload[r0:r1] = rows_from_wire(
                    b["payload"], layout.bits, spec.rows, spec.n_valid,
                    layout.nw_max)
                scale[r0:r1] = np.asarray(b["scale"], np.float32)
                zp[r0:r1] = np.asarray(b["zp"], np.float32)
            else:
                fp.append(torch.from_numpy(
                    np.array(b["payload"], np.float32)).reshape(
                        spec.shape).to(device=dev, dtype=spec.dtype))
        return cls(torch.from_numpy(payload).to(dev),
                   torch.from_numpy(scale).to(dev),
                   torch.from_numpy(zp).to(dev), tuple(fp), layout)

    def wire_bytes(self) -> int:
        """Real serialized size (measured from the buffers)."""
        return sum(b.nbytes for _, bufs in self.to_wire_entries()
                   for b in bufs.values())


def is_flat_message(t: Any) -> bool:
    return isinstance(t, FlatPackedMessage)


# ---------------------------------------------------------------------------
# Codec entry points
# ---------------------------------------------------------------------------

def pack_flat(tree: Any, bits: int, per_stack: bool = False) -> Any:
    """Trainable tree -> :class:`FlatPackedMessage` in ONE
    ``quant_pack_rows`` launch over the rectangular (C_total, N_max)
    buffer (the tree itself when nothing is quantizable)."""
    layout = layout_for(tree, bits, per_stack)
    if layout is None:
        return tree
    leaves = tree_leaves(tree)
    flat = flat_rows(leaves, layout)
    nv = torch.from_numpy(layout.n_valid_vec()).to(flat.device)
    payload, scale, zp = kops.quant_pack_rows(flat, nv, bits)
    fp = tuple(x.detach() for x, s in zip(leaves, layout.leaves)
               if not s.quantized)
    return FlatPackedMessage(payload, scale, zp, fp, layout)


def flat_rows(leaves: list, layout: TreeLayout) -> torch.Tensor:
    """The rectangular (C_total, N_max) fp32 buffer ``quant_pack_rows``
    packs: each quantizable leaf's channel-first rows, zero past the
    leaf's length."""
    flat = torch.zeros((layout.c_total, layout.n_max), dtype=torch.float32,
                       device=leaves[0].device)
    with torch.no_grad():
        for x, spec in zip(leaves, layout.leaves):
            if spec.quantized:
                flat[spec.row_start: spec.row_start + spec.rows,
                     : spec.n_valid] = kops.to_channel_first_2d(
                         x, layout.per_stack)
    return flat


def fedavg_packed_flat(msgs: list, weights) -> Any:
    """Weighted mean over K flat messages sharing one layout: unpack +
    dequant + reduce of the WHOLE cohort in ONE ``dequant_agg_rows``
    launch; the 1-D leaves take the plain weighted mean."""
    lo = msgs[0].layout
    dev = msgs[0].payload.device
    w = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    w = w / torch.sum(w)
    agg = kops.dequant_agg_rows(
        torch.stack([m.payload for m in msgs]),
        torch.stack([m.scale for m in msgs]),
        torch.stack([m.zp for m in msgs]), w,
        torch.from_numpy(lo.n_valid_vec()).to(dev), lo.bits)
    out, fpi = [], 0
    for spec in lo.leaves:
        if spec.quantized:
            r0, r1 = spec.row_start, spec.row_start + spec.rows
            out.append(kops.from_channel_first_2d(
                agg[r0:r1, : spec.n_valid], spec.shape,
                lo.per_stack).to(spec.dtype))
        else:
            x = torch.stack([m.fp_leaves[fpi].to(torch.float32)
                             for m in msgs])
            wr = w.reshape((-1,) + (1,) * (x.ndim - 1))
            out.append(torch.sum(x * wr, dim=0).to(spec.dtype))
            fpi += 1
    return tree_unflatten(lo.treedef, out)


def fedavg_packed_flat_sharded(msgs: list, weights, mesh=None,
                               axis: str = kops.CLIENT_AXIS) -> Any:
    """:func:`fedavg_packed_flat` with the client dim sharded over
    ``axis`` of ``mesh`` (default: ``launch.mesh.make_client_mesh()`` on
    the card): the weights are normalised first, each rank reduces its
    block of clients in ONE ``dequant_agg_rows`` launch and ONE
    ``all_reduce`` combines the partials
    (``kernels.ops.dequant_agg_rows_sharded``); the 1-D leaves take the
    plain weighted sum. A weighted sum in another association order:
    fp32-tolerance equal to the one-rank path."""
    lo = msgs[0].layout
    dev = msgs[0].payload.device
    w = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    wn = w / torch.sum(w)
    agg = kops.dequant_agg_rows_sharded(
        torch.stack([m.payload for m in msgs]),
        torch.stack([m.scale for m in msgs]),
        torch.stack([m.zp for m in msgs]), wn,
        torch.from_numpy(lo.n_valid_vec()).to(dev), lo.bits, mesh,
        axis=axis)
    fp_sums = tuple(
        torch.tensordot(wn, torch.stack(
            [m.fp_leaves[i].to(torch.float32) for m in msgs]), dims=1)
        for i in range(len(msgs[0].fp_leaves)))
    return flat_mean_from_sum(agg, fp_sums, 1.0, lo)


# ---------------------------------------------------------------------------
# Streaming fold (O(1)-memory FedBuff arrivals)
# ---------------------------------------------------------------------------

def fold_flat(acc: torch.Tensor, fp_accs: tuple, msg: FlatPackedMessage,
              w: float, n_valid: torch.Tensor) -> tuple:
    """Fold ONE client's flat message into the running fp32 sum (the JAX
    package's ``_fold_flat_impl``): a fresh ``(C_total, N_max)``
    ``w * dequant(payload)`` from one K = 1 ``dequant_agg_rows`` launch,
    then ``acc + contrib``; each fp passthrough leaf's sum gains
    ``w * leaf``. ``w`` is rounded to fp32 first, as the reference's
    traced weight is; ``n_valid`` is the layout's per-row lengths on the
    accumulator's device. Returns (acc, fp_accs), new tensors: the
    inputs are not written."""
    wf = float(np.float32(w))
    contrib = kops.dequant_agg_rows(
        msg.payload[None], msg.scale[None], msg.zp[None],
        torch.tensor([wf], dtype=torch.float32), n_valid, msg.layout.bits)
    fp_out = tuple(a + wf * x.to(torch.float32)
                   for a, x in zip(fp_accs, msg.fp_leaves))
    return acc + contrib, fp_out


def flat_mean_from_sum(acc: torch.Tensor, fp_accs: tuple, inv_w: float,
                       layout: TreeLayout) -> Any:
    """Running weighted sum -> the aggregated fp tree (the JAX package's
    ``_flat_mean_from_sum_impl``): each leaf's rows sliced off the flat
    accumulator and scaled by ``1/total_weight`` (rounded to fp32),
    shape and dtype restored. O(message), however many clients
    folded."""
    inv = float(np.float32(inv_w))
    out, fpi = [], 0
    for spec in layout.leaves:
        if spec.quantized:
            r0, r1 = spec.row_start, spec.row_start + spec.rows
            out.append(kops.from_channel_first_2d(
                acc[r0:r1, : spec.n_valid] * inv, spec.shape,
                layout.per_stack).to(spec.dtype))
        else:
            out.append((fp_accs[fpi] * inv).to(spec.dtype))
            fpi += 1
    return tree_unflatten(layout.treedef, out)
