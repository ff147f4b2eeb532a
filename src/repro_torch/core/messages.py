"""FLoCoRA message codec: trainable tree <-> quantized wire message.

Quantization rules (paper §IV): tensors with ndim >= 2 are quantized per
output channel = last axis; 1-D tensors (norm scales and biases) travel
fp32; scale and zero-point travel as fp32 sidecars.

The port carries the FLAT-TREE codec (``core/flat.py``): the whole
message packs as one :class:`~repro_torch.core.flat.FlatPackedMessage`
in one kernel launch and serializes to the same named buffers, byte for
byte, as the JAX package. The per-leaf ``PackedLeaf`` codec and the
sparse wire are not ported.

``message_wire_bytes`` is the static accounting; ``packed_wire_bytes``
measures the serialized buffers.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import flat as flatcodec
from repro_torch.core import lora, quant
from repro_torch.core.flat import FlatPackedMessage, is_flat_message
from repro_torch.core.quant import QuantConfig
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_with_names, tree_flatten, \
    tree_leaves, tree_unflatten


def _dense_only(density: Optional[float]) -> None:
    if density is not None and density < 1.0:
        raise NotImplementedError("the sparse wire is not ported")


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
    """Bytes for one direction of one round (paper's message size)."""
    _dense_only(density)
    bits = cfg.bits if cfg.enabled else None
    return sum(leaf_wire_bytes(tuple(x.shape), bits, cfg.per_stack)
               for x in tree_leaves(tree))


def tcc_bytes(tree: Any, cfg: QuantConfig, rounds: int) -> int:
    """Paper Eq. 2: 2 * R * message_bytes."""
    return 2 * rounds * message_wire_bytes(tree, cfg)


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------

def pack_message(tree: Any, cfg: QuantConfig, *,
                 density: Optional[float] = None,
                 flat: bool = False) -> Any:
    """Trainable tree -> wire message. ``flat=True`` packs the whole
    message as one :class:`FlatPackedMessage` in a single kernel launch;
    quantization off returns the tree itself. ``flat=False`` (the JAX
    package's per-leaf codec) and ``density < 1`` are not ported."""
    _dense_only(density)
    if not cfg.enabled:
        return tree
    if not flat:
        raise NotImplementedError(
            "the per-leaf PackedLeaf codec is not ported; pass flat=True")
    return flatcodec.pack_flat(tree, cfg.bits, cfg.per_stack)


def unpack_message(msg: Any) -> Any:
    """Wire message -> fp tree; an fp tree passes through."""
    if is_flat_message(msg):
        return msg.unpack()
    return msg


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
    if include_header:
        out.append((HEADER_KEY, {"header": wire_header(
            message_rank(msg), None)}))
    for name, leaf in flatten_with_names(msg):
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
    names = flatten_with_names(like)
    _, treedef = tree_flatten(like)
    leaves = [torch.from_numpy(np.array(bufs[n]["payload"], np.float32))
              .reshape(tuple(leaf.shape)).to(device=dev, dtype=leaf.dtype)
              for n, leaf in names]
    return tree_unflatten(treedef, leaves)


def packed_wire_bytes(msg: Any) -> int:
    """Payload bytes on the wire, MEASURED from the serialized buffers
    (the cross-check for ``message_wire_bytes``). Excludes the header."""
    return sum(sum(b.nbytes for b in bufs.values())
               for name, bufs in message_to_wire(msg)
               if name != HEADER_KEY)
