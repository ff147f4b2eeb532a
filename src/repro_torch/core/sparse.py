"""FLASC-style sparse-delta wire format: top-k over the packed codec.

"Federated LoRA with Sparse Communication" (Kuo et al. 2024): top-k
sparsified adapter deltas compose with affine quantization; the
surviving values still quantize to 2/4/8-bit levels and only the
surviving positions travel. The pieces, as in the JAX package's
``repro/core/sparse.py``:

  * :class:`SparsityConfig`: density (fraction of entries kept per
    tensor), optional round-wise annealing, and the FLASC EF-required
    flag;
  * :func:`sparsify_leaves`: per-tensor magnitude top-k of a message's
    tensors, the survivors quantized PER TENSOR by the same affine
    quantizer as the dense codec: ONE ``quant_pack_rows`` launch packs
    every tensor's survivors, one ragged row each (``n_valid = k``);
  * :class:`SparseLeaf`: the wire form, sorted flat indices (or an n-bit
    occupancy bitmap, whichever is smaller) + the quantized value row +
    fp32 sidecars; ``to_wire``/``from_wire`` serialize to exactly
    :func:`sparse_leaf_wire_bytes` bytes, byte-identical to the JAX
    package's.

Selection matches ``jax.lax.top_k``, which breaks ties by the LOWER
index (``torch.topk`` does not): a stable descending sort of |x|, its
first k, re-sorted ascending. Exact zeros are common in adapters
(conv-LoRA ``a`` starts at zero), so ties at the k-th magnitude are
real.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.flat import strip_row_padding
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.utils.device import resolve_device, upload


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Top-k sparsification of the client UPLINK.

    ``density`` is the fraction of entries kept per (>= 2-D) message
    tensor; 1-D leaves always travel dense. With ``anneal_every > 0`` the
    density is multiplied by ``anneal_factor`` every ``anneal_every``
    rounds (floored at ``min_density``). ``density == 1.0`` without
    annealing is the dense wire, byte for byte.

    ``require_ef`` (default True) makes ``FLoCoRAConfig`` refuse to run
    without error feedback: FLASC keeps accuracy only when each round's
    dropped mass enters the client's EF residual."""
    density: float = 1.0
    anneal_every: int = 0
    anneal_factor: float = 0.5
    min_density: float = 0.01
    require_ef: bool = True

    def __post_init__(self):
        if not 0.0 < self.density <= 1.0:
            raise ValueError(f"density must be in (0, 1]: {self.density}")
        if self.anneal_every < 0:
            raise ValueError("anneal_every must be >= 0")
        if not 0.0 < self.anneal_factor <= 1.0:
            raise ValueError("anneal_factor must be in (0, 1]")
        if not 0.0 < self.min_density <= 1.0:
            raise ValueError("min_density must be in (0, 1]")

    @property
    def enabled(self) -> bool:
        """True when any round's uplink can actually be sparse."""
        return self.density < 1.0 or self.anneal_every > 0

    def density_at(self, rnd: int) -> float:
        """Uplink density at round ``rnd``. The ``min_density`` floor
        binds annealed shrinkage only: a base density below it is kept
        (effective floor ``min(min_density, density)``)."""
        d = self.density
        if self.anneal_every > 0:
            d = max(min(self.min_density, d),
                    d * self.anneal_factor ** (rnd // self.anneal_every))
        return d


def keep_count(n: int, density: float) -> int:
    """Survivors of a ``density`` top-k over ``n`` entries (>= 1)."""
    return max(1, int(np.ceil(density * n)))


def sparse_leaf_wire_bytes(shape: tuple[int, ...], bits: Optional[int],
                           density: float) -> int:
    """Static wire accounting for one sparse leaf: min(4k index bytes,
    ceil(n/8) bitmap bytes), then ceil(k*bits/8) value bytes + one fp32
    (scale, zp) pair, or 4k bytes of fp32 values when ``bits`` is
    None."""
    n = int(np.prod(shape))
    k = keep_count(n, density)
    idx_bytes = min(4 * k, (n + 7) // 8)
    if bits is None:
        return idx_bytes + k * quant.FP_BYTES
    return idx_bytes + (k * bits + 7) // 8 + 2 * quant.FP_BYTES


@dataclasses.dataclass
class SparseLeaf:
    """One top-k-sparsified tensor in wire form.

    ``idx`` holds the k surviving FLAT indices into ``shape``, ascending
    (so the bitmap and the index encodings agree on value order);
    ``payload`` is the survivors' quantized word row in the
    ``quant_pack`` layout ((1, Nw) uint32, k levels padded to the lane
    multiple) or, when ``bits`` is None, the fp32 values (k,). ``shape``
    is the ORIGINAL tensor shape, so shape-only walks (adapter-pair and
    rank detection in ``core/lora.py``) work on sparse trees."""
    idx: torch.Tensor                 # (k,) int32, ascending flat indices
    payload: torch.Tensor             # (1, Nw) uint32 words | (k,) fp32
    scale: Optional[torch.Tensor]     # (1,) fp32, None when bits is None
    zp: Optional[torch.Tensor]        # (1,) fp32, None when bits is None
    shape: tuple                      # original tensor shape
    dtype: torch.dtype                # original dtype
    bits: Optional[int]               # None = fp32 survivors
    density: float = 1.0              # configured density (header)

    @property
    def k(self) -> int:
        return int(self.idx.shape[0])

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    def values(self) -> torch.Tensor:
        """The k surviving values, dequantized to fp32."""
        if self.bits is None:
            return self.payload.to(torch.float32)
        lv = kref.unpack_words(self.payload, self.bits)[:, : self.k]
        return ((lv.to(torch.float32) - self.zp[:, None])
                * self.scale[:, None]).reshape(-1)

    def densify(self) -> torch.Tensor:
        """Scatter the survivors into a dense tensor (zeros elsewhere)."""
        dense = torch.zeros((self.n,), dtype=torch.float32,
                            device=self.idx.device)
        dense[self.idx.to(torch.int64)] = self.values()
        return dense.reshape(self.shape).to(self.dtype)

    # -- serialization (the actual bytes on the wire) -----------------------
    def _use_bitmap(self) -> bool:
        """The bitmap wins once density crosses 1/32 (4k > n/8 bytes)."""
        return 4 * self.k > (self.n + 7) // 8

    def to_wire(self) -> dict[str, np.ndarray]:
        """Host-side buffers as sent; ``sum(nbytes)`` equals
        :func:`sparse_leaf_wire_bytes` for this leaf's shape and
        density."""
        idx = self.idx.cpu().numpy()
        if self._use_bitmap():
            mask = np.zeros(self.n, np.bool_)
            mask[idx] = True
            out = {"bitmap": np.packbits(mask)}
        else:
            out = {"idx": idx.astype(np.uint32)}
        if self.bits is None:
            out["values"] = self.payload.detach().cpu().numpy().astype(
                np.float32)
            return out
        out["payload"] = strip_row_padding(kref.words_numpy(self.payload),
                                           self.bits, self.k)
        out["scale"] = self.scale.cpu().numpy().astype(np.float32)
        out["zp"] = self.zp.cpu().numpy().astype(np.float32)
        return out

    @classmethod
    def from_wire(cls, buffers: dict, shape: tuple, dtype,
                  bits: Optional[int], density: float = 1.0,
                  device="cuda") -> "SparseLeaf":
        """Rebuild the kernel-layout leaf on ``device`` from serialized
        wire buffers (either encoding of the indices)."""
        dev = resolve_device(device)
        n = int(np.prod(shape))
        if "bitmap" in buffers:
            mask = np.unpackbits(np.asarray(buffers["bitmap"], np.uint8))[:n]
            idx = np.flatnonzero(mask)
        else:
            idx = np.asarray(buffers["idx"], np.int64)
        idx_t = torch.from_numpy(idx.astype(np.int32)).to(dev)
        k = int(idx.shape[0])
        if bits is None:
            vals = torch.from_numpy(np.array(buffers["values"], np.float32))
            return cls(idx_t, vals.to(dev), None, None, tuple(shape), dtype,
                       None, density)
        lv = quant.unpack_levels(torch.from_numpy(
            np.array(buffers["payload"], np.uint8)), bits, k)
        # the kernel layout bit for bit: zero levels up to the lane
        # multiple, as quant_pack emits them
        lv = torch.nn.functional.pad(lv.to(torch.int64),
                                     (0, (-k) % kops.lane_levels(bits)))
        payload = kref.pack_words(lv.reshape(1, -1), bits).to(dev)
        return cls(idx_t, payload,
                   torch.from_numpy(np.array(buffers["scale"],
                                             np.float32)).to(dev),
                   torch.from_numpy(np.array(buffers["zp"],
                                             np.float32)).to(dev),
                   tuple(shape), dtype, bits, density)

    def wire_bytes(self) -> int:
        """Real serialized size (measured from the buffers)."""
        return sum(b.nbytes for b in self.to_wire().values())


def is_sparse_leaf(t: Any) -> bool:
    return isinstance(t, SparseLeaf)


def _top_k_rows(xs: list, ks: list, k_dev: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor magnitude top-k of every tensor in ``xs`` at once
    (``k_dev``: ``ks`` on the tensors' device). Returns (idx (L, k_max)
    int64, vals (L, k_max) fp32): row l's first ``ks[l]`` entries are
    its survivors' flat indices, ascending, and their values. Ties go to the lower index, as ``jax.lax.top_k``
    breaks them: a stable descending sort of |x| (rows padded with -1,
    below every magnitude), its first k, re-sorted ascending (past k
    padded with n_max, above every index)."""
    flats = [x.detach().reshape(-1).to(torch.float32) for x in xs]
    vals = torch.nn.utils.rnn.pad_sequence(flats, batch_first=True)
    mags = torch.nn.utils.rnn.pad_sequence(
        [f.abs() for f in flats], batch_first=True, padding_value=-1.0)
    n_max, k_max = mags.shape[1], max(ks)
    order = torch.sort(mags, dim=1, descending=True,
                       stable=True).indices[:, :k_max]
    keep = torch.arange(k_max, device=order.device)[None, :] \
        < k_dev[:, None]
    idx = torch.sort(torch.where(keep, order, n_max), dim=1).values
    return idx, torch.gather(vals, 1, torch.where(keep, idx, 0))


def sparsify_leaves(xs: list, density: float, bits: Optional[int]) -> list:
    """Per-tensor magnitude top-k of each tensor in ``xs`` ->
    :class:`SparseLeaf` list. Keeps ``keep_count(n, density)`` entries
    a tensor; with ``bits`` set the survivors of ALL the tensors quantize
    in ONE ``quant_pack_rows`` launch, a ragged row each with
    per-row (per-tensor) qparams. Each leaf's words are bit-identical to
    packing its row alone (the JAX package's ``quant_pack`` of the
    (1, k) survivors)."""
    if not xs:
        return []
    ks = [keep_count(x.numel(), density) for x in xs]
    k_dev = upload(torch.tensor(ks, dtype=torch.int32), xs[0].device)
    idx, vals = _top_k_rows(xs, ks, k_dev)
    idx = idx.to(torch.int32)
    if bits is None:
        return [SparseLeaf(idx[l, :k], vals[l, :k], None, None,
                           tuple(x.shape), x.dtype, None, density)
                for l, (x, k) in enumerate(zip(xs, ks))]
    lane = kops.lane_levels(bits)
    width = -(-max(ks) // lane) * lane
    rows = torch.nn.functional.pad(vals, (0, width - vals.shape[1]))
    packed, scale, zp = kops.quant_pack_rows(rows.contiguous(), k_dev, bits)
    per = 32 // bits
    return [SparseLeaf(idx[l, :k], packed[l: l + 1, : -(-k // lane) * lane
                                          // per],
                       scale[l: l + 1], zp[l: l + 1], tuple(x.shape),
                       x.dtype, bits, density)
            for l, (x, k) in enumerate(zip(xs, ks))]


def sparsify_leaf(x: torch.Tensor, density: float,
                  bits: Optional[int]) -> SparseLeaf:
    """One tensor's :func:`sparsify_leaves`."""
    return sparsify_leaves([x], density, bits)[0]
