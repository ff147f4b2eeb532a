"""Wire-format adapter cache for the multi-tenant serving engine.

A serving node hosts ONE frozen base and thousands of per-client
adapters. The cache stores each client's adapters EXACTLY as they
arrived on the wire: compact uint32 packed rows + fp32 scale/zp sidecars
(the ``quant_pack`` / flat-codec channel-first layout), as host numpy at
rest. Dequant happens inside the fused serving kernel
(``kernels.ops.multi_lora_matmul_packed``); the cache never holds an
fp32 adapter tree.

Three pieces:

  * :class:`PackedPair` — one adapter pair of one client in compact
    wire rows (host numpy; the at-rest form);
  * :class:`AdapterCache` — LRU or clock (second-chance) eviction keyed
    by client id, capacity in wire bytes (``message_wire_bytes``
    accounting), hit/miss/eviction counters;
  * :meth:`AdapterCache.stage` — the host -> device staging path: groups
    the requested clients by pow2 RANK BUCKET, builds each bucket's
    per-layer stacked slabs on the host and uploads each buffer ONCE to
    an explicit device, slots padded to pow2 so decode shapes are
    stable across batch compositions.

Rank-bucket padding is exact: a rank-r adapter in a rank-rb bucket pads
its A rows with scale=0 sidecars (dequant -> exact 0, so the extra
h-lanes are zero) and its B words with zero words (their dequant value
is multiplied by those zero h-lanes).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import lora, messages
from repro_torch.core.flat import is_flat_message
from repro_torch.core.quant import QuantConfig
from repro_torch.fl.client import pow2_pad
from repro_torch.kernels import ref as kref
from repro_torch.obs import metrics as obsm
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PackedPair:
    """One dense LoRA pair in compact wire rows (channel-first):
    ``aq`` (r, KW) uint32 — A's r channel rows of d_in levels;
    ``bq`` (d_out, RW) uint32 — B's d_out channel rows of r levels;
    fp32 scale/zp sidecars per channel row. KW = ceil(d_in/per),
    RW = ceil(r/per); word tails past the valid levels are zero (the
    codec's packing contract, which bucket padding relies on)."""
    aq: np.ndarray
    a_scale: np.ndarray
    a_zp: np.ndarray
    bq: np.ndarray
    b_scale: np.ndarray
    b_zp: np.ndarray
    d_in: int
    d_out: int
    rank: int
    bits: int

    def dequant(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """-> fp32 (a (d_in, r), b (r, d_out)) on ``device``, the
        ``unpack_message`` formula. ORACLE/TEST use only: the serving
        path never calls this (dequant lives inside the fused kernel)."""
        dev = resolve_device(device)

        def deq(words, scale, zp, n):
            lv = kref.unpack_words(torch.from_numpy(words).to(dev),
                                   self.bits)[:, :n].to(torch.float32)
            return (lv - torch.from_numpy(zp).to(dev)[:, None]) \
                * torch.from_numpy(scale).to(dev)[:, None]

        a2d = deq(self.aq, self.a_scale, self.a_zp, self.d_in)
        b2d = deq(self.bq, self.b_scale, self.b_zp, self.rank)
        return a2d.T, b2d.T


@dataclasses.dataclass
class CacheEntry:
    cid: int
    rank: int
    nbytes: int
    pairs: tuple[PackedPair, ...]
    ref: bool = True              # clock second-chance bit


class StagedLayer(NamedTuple):
    """One layer of one rank bucket's device-resident adapter slab."""
    aq: torch.Tensor        # (E, rb, KW) uint32
    a_scale: torch.Tensor   # (E, rb) fp32
    a_zp: torch.Tensor
    bq: torch.Tensor        # (E, d_out, RWb) uint32
    b_scale: torch.Tensor   # (E, d_out) fp32
    b_zp: torch.Tensor


@dataclasses.dataclass
class StagedBucket:
    rank: int                     # pow2 bucket rank rb
    slots: dict[int, int]         # cid -> slot index in the slab
    layers: tuple[StagedLayer, ...]
    n_slots: int                  # pow2-padded E dim


def _host(t) -> np.ndarray:
    if t.dtype == kref.WORD_DTYPE:
        return kref.words_numpy(t)
    return t.detach().cpu().numpy()


def extract_pairs(msg: Any, bits: int) -> tuple[int, tuple[PackedPair, ...]]:
    """Wire message (PackedLeaf tree or flat-tree message) -> compact
    host-side pairs in walk order. Payload bits are copied verbatim
    (the compact word slice of the lane-padded kernel rows, cut before
    the device-to-host copy); nothing is dequantized. Returns (adapter
    rank, pairs)."""
    if is_flat_message(msg):
        msg = msg.as_tree()
    found: list[dict] = []
    lora._walk_pairs(msg, lambda p: (found.append(p), p)[1])
    if not found:
        raise ValueError("message carries no adapter pairs")
    per = 32 // bits
    pairs = []
    for p in found:
        a, b = p["a"], p["b"]
        if lora.adapter_kind(a, b) != "dense":
            raise ValueError("the serving cache handles dense adapter "
                             f"pairs; got a{tuple(a.shape)} "
                             f"b{tuple(b.shape)}")
        if not (messages.is_packed_leaf(a) and messages.is_packed_leaf(b)):
            raise ValueError("adapters must arrive in wire form "
                             "(pack_message) — the cache stores packed "
                             "payloads only, never fp32")
        d_in, r = a.shape
        d_out = b.shape[1]
        kw = -(-d_in // per)
        rw = -(-r // per)
        pairs.append(PackedPair(
            aq=np.ascontiguousarray(_host(a.payload[:, :kw])),
            a_scale=_host(a.scale).astype(np.float32),
            a_zp=_host(a.zp).astype(np.float32),
            bq=np.ascontiguousarray(_host(b.payload[:, :rw])),
            b_scale=_host(b.scale).astype(np.float32),
            b_zp=_host(b.zp).astype(np.float32),
            d_in=d_in, d_out=d_out, rank=r, bits=bits))
    ranks = {p.rank for p in pairs}
    if len(ranks) != 1:
        raise ValueError(f"mixed ranks within one message: {ranks}")
    return ranks.pop(), tuple(pairs)


def wire_bytes_of(msg: Any, qcfg: QuantConfig) -> int:
    """Static ``message_wire_bytes`` accounting for a WIRE message,
    walked by the original fp shapes (shape-only, no payload touch; a
    ``PackedLeaf`` carries its tensor's shape)."""
    if is_flat_message(msg):
        return messages.message_wire_bytes(msg.shape_tree(), qcfg)
    return messages.message_wire_bytes(msg, qcfg)


class AdapterCache:
    """LRU / clock adapter cache keyed by client id, wire-format at
    rest on the host, capacity in wire bytes. ``lookup`` counts
    hits/misses (call it at request ADMISSION, one count per request);
    ``peek`` is the uncounted read the decode loop uses. ``device`` is
    where :meth:`stage` uploads slabs (default: the card)."""

    def __init__(self, capacity_bytes: int, qcfg: QuantConfig,
                 policy: str = "lru",
                 registry: Optional[obsm.MetricsRegistry] = None,
                 device="cuda"):
        if policy not in ("lru", "clock"):
            raise ValueError(f"unknown eviction policy: {policy!r}")
        if not qcfg.enabled:
            raise ValueError("the serving cache stores the packed wire "
                             "form — quantization must be on")
        self.capacity_bytes = int(capacity_bytes)
        self.qcfg = qcfg
        self.policy = policy
        self.device = device
        self.registry = obsm.get_registry(registry)
        self._entries: "collections.OrderedDict[int, CacheEntry]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._bytes_memo: dict[int, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # monotonically bumped on put/evict; stale staged slabs key off it
        self.version = 0
        # in-flight refcounts: pinned entries are never evicted
        self._pins: collections.Counter = collections.Counter()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, cid: int) -> bool:
        return cid in self._entries

    @property
    def nbytes(self) -> int:
        return self._bytes

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> dict:
        return {"entries": len(self._entries), "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "hit_rate": self.hit_rate}

    # -- reads --------------------------------------------------------------

    def lookup(self, cid: int) -> Optional[CacheEntry]:
        e = self._entries.get(cid)
        if e is None:
            self.misses += 1
            self.registry.inc("serve.cache.misses", policy=self.policy)
            return None
        self.hits += 1
        self.registry.inc("serve.cache.hits", policy=self.policy)
        self._touch(e)
        return e

    def peek(self, cid: int) -> Optional[CacheEntry]:
        return self._entries.get(cid)

    def _touch(self, e: CacheEntry) -> None:
        if self.policy == "lru":
            self._entries.move_to_end(e.cid)
        else:
            e.ref = True

    # -- pinning ------------------------------------------------------------

    def pin(self, cid: int) -> None:
        """Refcounted eviction shield for an in-flight request's
        adapter; pair every pin with an unpin at request completion."""
        if cid not in self._entries:
            raise KeyError(f"cannot pin uncached client {cid}")
        self._pins[cid] += 1
        self.registry.inc("serve.cache.pins")
        self.registry.set("serve.cache.pinned", len(self._pins))

    def unpin(self, cid: int) -> None:
        self._pins[cid] -= 1
        if self._pins[cid] <= 0:
            del self._pins[cid]
        self.registry.inc("serve.cache.unpins")
        self.registry.set("serve.cache.pinned", len(self._pins))

    def _pinned(self, cid: int) -> bool:
        return self._pins.get(cid, 0) > 0

    # -- writes -------------------------------------------------------------

    def put(self, cid: int, msg: Any) -> CacheEntry:
        """Insert/replace one client's WIRE message; evicts until the
        byte budget holds."""
        rank, pairs = extract_pairs(msg, self.qcfg.bits)
        if rank not in self._bytes_memo:
            self._bytes_memo[rank] = wire_bytes_of(msg, self.qcfg)
        nbytes = self._bytes_memo[rank]
        if cid in self._entries:
            self._bytes -= self._entries.pop(cid).nbytes
        e = CacheEntry(cid=cid, rank=rank, nbytes=nbytes, pairs=pairs)
        self._entries[cid] = e
        self._bytes += nbytes
        self.version += 1
        self.registry.inc("serve.cache.puts", rank=rank)
        self.registry.inc("serve.cache.put_bytes", nbytes, rank=rank)
        while self._bytes > self.capacity_bytes and len(self._entries) > 1:
            if not self._evict_one(keep=cid):
                break       # everything pinned: run over budget briefly
        self._gauges()
        return e

    def _evict_one(self, keep: int) -> bool:
        """Evict one entry, never ``keep`` or a pinned cid. Returns
        False when no entry is evictable."""
        def skip(c):
            return c == keep or self._pinned(c)

        if all(skip(c) for c in self._entries):
            return False
        if self.policy == "lru":
            victim = next(c for c in self._entries if not skip(c))
        else:
            # clock / second-chance: sweep in insertion order, clearing
            # ref bits until an unreferenced evictable entry comes up
            victim = None
            while victim is None:
                cid, e = next(iter(self._entries.items()))
                if not skip(cid) and not e.ref:
                    victim = cid
                else:
                    e.ref = False
                    self._entries.move_to_end(cid)
        self._bytes -= self._entries.pop(victim).nbytes
        self.evictions += 1
        self.version += 1
        self.registry.inc("serve.cache.evictions", policy=self.policy)
        return True

    def _gauges(self) -> None:
        self.registry.set("serve.cache.bytes", self._bytes)
        self.registry.set("serve.cache.entries", len(self._entries))

    # -- host -> device staging --------------------------------------------

    def stage(self, cids: Sequence[int], min_slots: int = 1,
              device=None) -> dict[int, StagedBucket]:
        """Stage the given clients' adapters for a decode micro-batch:
        group by pow2 rank bucket, build each bucket's per-layer stacked
        slabs on the host, and upload each buffer ONCE to ``device``
        (default: the cache's). Slots pad to pow2, and to at least
        ``min_slots``, so the slab E dim is stable across batch
        compositions; padded slots are all-zero and never referenced."""
        dev = resolve_device(self.device if device is None else device)
        buckets: dict[int, list[CacheEntry]] = {}
        for cid in dict.fromkeys(cids):         # de-dupe, keep order
            e = self._entries.get(cid)
            if e is None:
                raise KeyError(f"client {cid} is not cached — admit() "
                               "before staging")
            buckets.setdefault(pow2_pad(e.rank), []).append(e)
        return {rb: self._stage_bucket(rb, entries, min_slots, dev)
                for rb, entries in sorted(buckets.items())}

    def _stage_bucket(self, rb: int, entries: list[CacheEntry],
                      min_slots: int, dev: torch.device) -> StagedBucket:
        per = 32 // self.qcfg.bits
        n_slots = max(pow2_pad(len(entries)), pow2_pad(max(min_slots, 1)))
        rwb = -(-rb // per)
        layers = []
        for li in range(len(entries[0].pairs)):
            p0 = entries[0].pairs[li]
            kw = p0.aq.shape[1]
            aq = np.zeros((n_slots, rb, kw), np.uint32)
            a_s = np.zeros((n_slots, rb), np.float32)
            a_z = np.zeros((n_slots, rb), np.float32)
            bq = np.zeros((n_slots, p0.d_out, rwb), np.uint32)
            b_s = np.zeros((n_slots, p0.d_out), np.float32)
            b_z = np.zeros((n_slots, p0.d_out), np.float32)
            for slot, e in enumerate(entries):
                p = e.pairs[li]
                aq[slot, :p.rank, :] = p.aq
                a_s[slot, :p.rank] = p.a_scale
                a_z[slot, :p.rank] = p.a_zp
                bq[slot, :, :p.bq.shape[1]] = p.bq
                b_s[slot] = p.b_scale
                b_z[slot] = p.b_zp
            layers.append(StagedLayer(*(torch.from_numpy(a).to(dev)
                                        for a in (aq, a_s, a_z, bq, b_s,
                                                  b_z))))
        return StagedBucket(rank=rb,
                            slots={e.cid: i for i, e in enumerate(entries)},
                            layers=tuple(layers), n_slots=n_slots)
