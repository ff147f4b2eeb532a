"""FLoCoRA message codec: trainable tree <-> quantized wire message.

Quantization rules (paper §IV): tensors with ndim >= 2 are quantized per
output channel = last axis; 1-D tensors (norm scales and biases) travel
fp32; scale and zero-point travel as fp32 sidecars.

``encode``/``decode``/``roundtrip`` are the fp-simulation view
(unpacked uint8 levels, the reference quantizer of ``core/quant.py``):
the numerical oracle for the paper's pipeline (``fedavg_quantized``).

Two packed codecs, both byte-identical on the wire to the JAX package's:

  * the FLAT-TREE codec (``core/flat.py``, ``flat=True``): the whole
    message packs as one :class:`~repro_torch.core.flat.FlatPackedMessage`
    in one kernel launch;
  * the PER-LEAF codec (``flat=False``): each quantizable leaf becomes a
    :class:`PackedLeaf` (uint32 words in the kernel layout + fp32
    sidecars), packed by one ``quant_pack`` launch per leaf.

Both serialize to the same named buffers.

The sparse wire (``density < 1``, FLASC-style, ``core/sparse.py``): each
quantizable leaf becomes a :class:`~repro_torch.core.sparse.SparseLeaf`,
its per-tensor magnitude top-k indices and the survivors quantized per
tensor; one ``quant_pack_rows`` launch packs all of a message's
survivors. Every accounting and serialization helper here takes both
leaf kinds; ``density`` of None or 1.0 is the dense path, byte for byte.

``message_wire_bytes`` is the static accounting; ``packed_wire_bytes``
measures the serialized buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import flat as flatcodec
from repro_torch.core import lora, quant, sparse
from repro_torch.core.flat import FlatPackedMessage, is_flat_message
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sparse import SparseLeaf, is_sparse_leaf
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_with_names, tree_flatten, \
    tree_leaves, tree_map, tree_unflatten


CHANNEL_AXIS = -1   # output channel == last axis in this codebase's layouts


@dataclasses.dataclass
class EncodedLeaf:
    """One quantized leaf of the fp-simulation view: its unpacked
    levels (packing is wire-only), the fp32 sidecars and the leaf's own
    dtype. ``encode`` returns the same fields as a
    ``{"q", "scale", "zp"}`` dict, as the JAX package's does."""
    q: torch.Tensor           # uint8 levels
    scale: torch.Tensor
    zp: torch.Tensor
    dtype: Any


def _sparse_on(density: Optional[float]) -> bool:
    return density is not None and density < 1.0


# ---------------------------------------------------------------------------
# fp-simulation codec (unpacked levels; the numerical reference)
# ---------------------------------------------------------------------------

def _encode_leaf(x: torch.Tensor, bits: int, per_stack: bool) -> dict:
    def enc2d(t):
        s, z = quant.affine_qparams(t, bits, channel_axis=t.ndim - 1)
        return quant.quantize(t, s, z, bits, channel_axis=t.ndim - 1), s, z

    if per_stack and x.ndim >= 3:
        # per-(stack, channel) qparams: the JAX package vmaps over the
        # leading stack dim
        q, s, z = (torch.stack(v) for v in zip(*[enc2d(t) for t in x]))
    else:
        q, s, z = enc2d(x)
    return {"q": q, "scale": s, "zp": z}


def _decode_leaf(enc: dict, ndim: int, dtype,
                 per_stack: bool) -> torch.Tensor:
    def dec2d(q, s, z):
        return quant.dequantize(q, s, z, channel_axis=q.ndim - 1,
                                dtype=dtype)

    if per_stack and ndim >= 3:
        return torch.stack([dec2d(*qsz) for qsz in zip(
            enc["q"], enc["scale"], enc["zp"])])
    return dec2d(enc["q"], enc["scale"], enc["zp"])


def _map_like(fn, like: Any, msg: Any) -> Any:
    """``fn(like_leaf, msg_node)`` over ``like``'s structure, where a
    quantized leaf's node in ``msg`` is its ``{"q", "scale", "zp"}``
    dict."""
    if isinstance(like, dict):
        return {k: _map_like(fn, like[k], msg[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_map_like(fn, a, b) for a, b in zip(like, msg))
    if like is None:
        return None
    return fn(like, msg)


def encode(tree: Any, cfg: QuantConfig) -> Any:
    """Trainable tree -> message tree: each quantizable leaf becomes
    ``{"q": uint8 levels, "scale", "zp"}``; vectors pass through."""
    if not cfg.enabled:
        return tree

    def enc(x):
        if not quantizable(x):
            return x
        return _encode_leaf(x, cfg.bits, cfg.per_stack)

    return tree_map(enc, tree)


def decode(msg: Any, cfg: QuantConfig, like: Any) -> Any:
    """Message tree -> fp tree with the dtypes and structure of
    ``like``."""
    if not cfg.enabled:
        return msg

    def dec(ref, m):
        if not quantizable(ref):
            return m
        return _decode_leaf(m, ref.ndim, ref.dtype, cfg.per_stack)

    return _map_like(dec, like, msg)


def roundtrip(tree: Any, cfg: QuantConfig) -> Any:
    """Quantize + dequantize: what the receiver reconstructs."""
    if not cfg.enabled:
        return tree
    return decode(encode(tree, cfg), cfg, tree)


# ---------------------------------------------------------------------------
# Wire-byte accounting (static; shapes only)
# ---------------------------------------------------------------------------

def leaf_wire_bytes(shape: tuple[int, ...], bits: Optional[int],
                    per_stack: bool = False) -> int:
    n = int(np.prod(shape))
    if bits is None or len(shape) < 2:
        return n * quant.FP_BYTES
    if per_stack and len(shape) >= 3:
        channels = int(np.prod(shape[:-2])) * shape[-1]
    else:
        channels = shape[-1]          # paper rule: channel = last axis
    return (n * bits + 7) // 8 + channels * 2 * quant.FP_BYTES


def message_wire_bytes(tree: Any, cfg: QuantConfig,
                       density: Optional[float] = None) -> int:
    """Bytes for one direction of one round (paper's message size).
    ``density < 1`` sizes the quantizable leaves as sparse leaves
    (``sparse.sparse_leaf_wire_bytes``); 1-D leaves always travel dense
    fp32, as ``pack_message`` sends them."""
    bits = cfg.bits if cfg.enabled else None
    return sum(sparse.sparse_leaf_wire_bytes(tuple(x.shape), bits, density)
               if _sparse_on(density) and quantizable(x)
               else leaf_wire_bytes(tuple(x.shape), bits, cfg.per_stack)
               for x in tree_leaves(tree))


def tcc_bytes(tree: Any, cfg: QuantConfig, rounds: int) -> int:
    """Paper Eq. 2: 2 * R * message_bytes."""
    return 2 * rounds * message_wire_bytes(tree, cfg)


def quantizable(x) -> bool:
    """Paper rule: >=2-D tensors are quantized; vectors stay fp."""
    return len(tuple(x.shape)) >= 2


# ---------------------------------------------------------------------------
# Per-leaf packed wire codec
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedLeaf:
    """One quantized tensor in wire form.

    ``payload`` uses the kernel layout: one row of little-endian uint32
    words per channel, columns padded to the kernel lane multiple
    (32/bits * 128 levels). The valid levels are the first
    ``n_per_channel`` of each row; ``to_wire`` strips the padding so the
    serialized payload is exactly ``ceil(numel * bits / 8)`` bytes. A
    PackedLeaf is ONE leaf of a message tree: its wire entry is named by
    its path."""
    payload: torch.Tensor     # (channels, Nw) uint32 words
    scale: torch.Tensor       # (channels,) fp32 sidecar
    zp: torch.Tensor          # (channels,) fp32 sidecar
    shape: tuple              # original tensor shape
    dtype: torch.dtype        # original dtype
    bits: int
    per_stack: bool = False   # per-(stack, channel) qparams

    @property
    def channels(self) -> int:
        if self.per_stack and len(self.shape) >= 3:
            return int(np.prod(self.shape[:-2])) * self.shape[-1]
        return self.shape[-1]

    @property
    def n_per_channel(self) -> int:
        return int(np.prod(self.shape)) // self.channels

    def to_wire(self) -> dict[str, np.ndarray]:
        """Host-side buffers as sent: the valid levels of every channel
        packed contiguously (no lane or word padding) + fp32 sidecars,
        so ``sum(buf.nbytes) == leaf_wire_bytes``."""
        words = kref.words_numpy(self.payload)
        return {"payload": flatcodec.strip_row_padding(
                    words, self.bits, self.n_per_channel),
                "scale": self.scale.cpu().numpy().astype(np.float32),
                "zp": self.zp.cpu().numpy().astype(np.float32)}

    @classmethod
    def from_wire(cls, buffers: dict, shape: tuple, dtype, bits: int,
                  per_stack: bool = False, device="cuda") -> "PackedLeaf":
        """Rebuild the kernel-layout leaf on ``device`` from serialized
        wire buffers."""
        dev = resolve_device(device)
        n = int(np.prod(shape))
        leaf = cls(None, None, None, tuple(shape), dtype, bits, per_stack)
        lv = quant.unpack_levels(torch.from_numpy(
            np.array(buffers["payload"], np.uint8)), bits, n)
        lv = lv.reshape(leaf.channels, leaf.n_per_channel)
        leaf.payload = _pack_rows(lv, bits).to(dev)
        leaf.scale = torch.from_numpy(
            np.array(buffers["scale"], np.float32)).to(dev)
        leaf.zp = torch.from_numpy(
            np.array(buffers["zp"], np.float32)).to(dev)
        return leaf

    def wire_bytes(self) -> int:
        """Real serialized size (measured from the buffers)."""
        return sum(b.nbytes for b in self.to_wire().values())


def _pack_rows(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """(C, n) levels -> (C, Nw) uint32 kernel-layout words."""
    pad = (-levels.shape[1]) % kops.lane_levels(bits)
    lv = torch.nn.functional.pad(levels.to(torch.int64), (0, pad))
    return kref.pack_words(lv, bits)


def is_packed_leaf(t: Any) -> bool:
    return isinstance(t, PackedLeaf)


def is_wire_leaf(t: Any) -> bool:
    """True for a wire-form leaf: a dense packed leaf, a sparse top-k
    leaf or a whole flat-tree message."""
    return isinstance(t, (PackedLeaf, SparseLeaf, FlatPackedMessage))


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------

def pack_message(tree: Any, cfg: QuantConfig, *,
                 density: Optional[float] = None,
                 flat: bool = False) -> Any:
    """Trainable tree -> wire message with real packed payloads.

    ``flat=True`` packs the whole message as one
    :class:`FlatPackedMessage` in a single kernel launch; ``flat=False``
    makes each quantizable leaf a :class:`PackedLeaf` (one
    ``quant_pack`` launch per leaf) and passes 1-D leaves through in
    fp32. Quantization off returns the tree itself.

    ``density < 1`` selects the sparse wire instead (over ``flat``):
    each quantizable leaf becomes a :class:`SparseLeaf`, its top-k
    survivors quantized per tensor (fp32 survivors when quantization is
    off), all of the message's in ONE ``quant_pack_rows`` launch."""
    sparse_on = _sparse_on(density)
    if not cfg.enabled and not sparse_on:
        return tree
    if sparse_on:
        leaves, treedef = tree_flatten(tree)
        pos = [i for i, x in enumerate(leaves) if quantizable(x)]
        out = list(leaves)
        for i, leaf in zip(pos, sparse.sparsify_leaves(
                [leaves[i] for i in pos], density,
                cfg.bits if cfg.enabled else None)):
            out[i] = leaf
        return tree_unflatten(treedef, out)
    if flat:
        return flatcodec.pack_flat(tree, cfg.bits, cfg.per_stack)

    def pk(x):
        if not quantizable(x):
            return x
        x2d = kops.to_channel_first_2d(x.detach(), cfg.per_stack)
        payload, scale, zp = kops.quant_pack(x2d, cfg.bits)
        return PackedLeaf(payload, scale, zp, tuple(x.shape), x.dtype,
                          cfg.bits, cfg.per_stack)

    return tree_map(pk, tree)


def unpack_message(msg: Any) -> Any:
    """Wire message -> fp tree (shape and dtype recorded in each leaf);
    a flat-tree message decodes in one pass, sparse leaves densify (zeros
    at the dropped positions), an fp tree passes through."""
    if is_flat_message(msg):
        return msg.unpack()

    def up(t):
        if is_flat_message(t):     # nested flat messages decode too
            return t.unpack()
        if is_sparse_leaf(t):
            return t.densify()
        if not is_packed_leaf(t):
            return t
        lv = kref.unpack_words(t.payload, t.bits)[:, :t.n_per_channel]
        x2d = (lv.to(torch.float32) - t.zp[:, None]) * t.scale[:, None]
        return kops.from_channel_first_2d(
            x2d, t.shape, t.per_stack).to(t.dtype)

    return tree_map(up, msg)


# ---------------------------------------------------------------------------
# Wire header: a fixed 20-byte header (5 x uint32: magic, version, rank,
# bits, density in parts per million) leads every serialized message. It
# is transport framing and not part of message_wire_bytes /
# packed_wire_bytes, which reproduce the paper's payload accounting.
# ---------------------------------------------------------------------------

WIRE_MAGIC = 0x464C4F43          # "FLOC"
WIRE_VERSION = 3                 # v3: + density field (sparse-delta wire)
HEADER_KEY = "__header__"
HEADER_BYTES = 20
DENSITY_ONE = 1_000_000          # density is carried in parts-per-million


def message_rank(msg: Any) -> int:
    """Max adapter rank of a (fp or packed) message; 0 if it carries no
    LoRA pairs (shape-only)."""
    r = lora.tree_max_rank(msg)
    return 0 if r is None else int(r)


def message_density(msg: Any) -> float:
    """Density a wire message advertises: its sparse leaves' configured
    density, 1.0 for a dense (packed or fp) message."""
    for leaf in tree_leaves(msg):
        if is_sparse_leaf(leaf):
            return float(leaf.density)
    return 1.0


def wire_header(rank: int, bits: Optional[int],
                density: float = 1.0) -> np.ndarray:
    """The leading uint32[5] buffer of a serialized message."""
    return np.asarray([WIRE_MAGIC, WIRE_VERSION, rank, bits or 0,
                       int(round(density * DENSITY_ONE))], np.uint32)


def parse_wire_header(buf: np.ndarray) -> dict:
    """Validate + decode the header -> {'version', 'rank', 'bits',
    'density'}. Accepts the 16-byte v2 form (density 1.0)."""
    h = np.asarray(buf, np.uint32).reshape(-1)
    if h.shape[0] not in (4, 5) or int(h[0]) != WIRE_MAGIC:
        raise ValueError("not a FLoCoRA wire message (bad magic)")
    if int(h[1]) > WIRE_VERSION:
        raise ValueError(f"wire version {int(h[1])} is newer than this "
                         f"codec (v{WIRE_VERSION})")
    bits = int(h[3])
    density = int(h[4]) / DENSITY_ONE if h.shape[0] == 5 else 1.0
    return {"version": int(h[1]), "rank": int(h[2]),
            "bits": bits if bits else None, "density": density}


def message_to_wire(msg: Any, include_header: bool = True
                    ) -> list[tuple[str, dict]]:
    """Serialize a message to named host buffers: the header entry
    (``HEADER_KEY``, unless ``include_header=False``), then one entry per
    leaf in flatten order."""
    out = []
    if is_flat_message(msg):
        if include_header:
            out.append((HEADER_KEY, {"header": wire_header(
                message_rank(msg), msg.bits)}))
        out.extend(msg.to_wire_entries())
        return out
    named = flatten_with_names(msg)
    if include_header:
        bits = next((leaf.bits for _, leaf in named
                     if is_wire_leaf(leaf) and leaf.bits is not None), None)
        out.append((HEADER_KEY, {"header": wire_header(
            message_rank(msg), bits, message_density(msg))}))
    for name, leaf in named:
        if is_packed_leaf(leaf) or is_sparse_leaf(leaf):
            out.append((name, leaf.to_wire()))
        else:
            out.append((name, {"payload": leaf.detach().to(
                torch.float32).cpu().numpy()}))
    return out


def message_from_wire(entries: list[tuple[str, dict]], like: Any,
                      device="cuda") -> Any:
    """Rebuild a wire message on ``device`` from ``message_to_wire``
    buffers. ``like`` is a template message with the same structure
    (its static layout or leaf shapes and dtypes are used, its data
    ignored). The header entry is validated and discarded."""
    dev = resolve_device(device)
    bufs = dict(entries)
    if HEADER_KEY in bufs:
        parse_wire_header(bufs[HEADER_KEY]["header"])
    if is_flat_message(like):
        return FlatPackedMessage.from_wire_entries(
            [(n, b) for n, b in entries if n != HEADER_KEY], like.layout,
            device=dev)
    _, treedef = tree_flatten(like)
    leaves = []
    for name, leaf in flatten_with_names(like):
        b = bufs[name]
        if is_packed_leaf(leaf):
            leaves.append(PackedLeaf.from_wire(
                b, leaf.shape, leaf.dtype, leaf.bits, leaf.per_stack,
                device=dev))
        elif is_sparse_leaf(leaf):
            leaves.append(SparseLeaf.from_wire(
                b, leaf.shape, leaf.dtype, leaf.bits, leaf.density,
                device=dev))
        else:
            leaves.append(torch.from_numpy(np.array(
                b["payload"], np.float32)).reshape(tuple(leaf.shape)).to(
                    device=dev, dtype=leaf.dtype))
    return tree_unflatten(treedef, leaves)


def packed_wire_bytes(msg: Any) -> int:
    """Payload bytes on the wire, MEASURED from the serialized buffers
    (the cross-check for ``message_wire_bytes``). Excludes the header."""
    return sum(sum(b.nbytes for b in bufs.values())
               for name, bufs in message_to_wire(msg)
               if name != HEADER_KEY)
