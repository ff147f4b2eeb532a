"""Multi-tenant adapter serving engine: the FLoCoRA read path.

One frozen base (a chain of linear layers), thousands of per-client
adapters at rest in the wire-format :class:`~repro_torch.serve.cache.
AdapterCache`. A decode micro-batch carries a PER-ROW client id; the
engine groups rows by pow2 rank bucket, stages each bucket's adapters
as packed slabs on the engine's device, and runs each bucket through
the layer chain:

  * ``path='fused'`` (production): one ``multi_lora_matmul_packed``
    launch per layer — gather packed words by row id, dequant INSIDE the
    product. An uplinked adapter serves without ever materializing an
    fp32 adapter tree.
  * ``path='dequant'`` (the baseline): dequantize the staged slab to
    fp32 stacks with plain tensor ops, then one ``multi_lora_matmul``
    launch per layer over the fp stacks.
  * :meth:`AdapterServingEngine.oracle_step` (numerics oracle): per-row
    ``dense_merge`` of the dequantized pair into the base.

Cache lookups are counted at ADMISSION (:meth:`admit`, one per request,
optionally fetching a miss from the adapter store); the per-token
:meth:`step` reads the cache uncounted. Batch rows pad to pow2 (min 8)
and slabs pad slots to pow2, as in the JAX package, so the kernels see
the same shapes and a steady-state step builds no program
(``strict_compiles`` enforces it).

:func:`generate` is the single-tenant LM prefill+decode loop that
``launch/serve.py`` drives (the adapters applied beside the frozen
base, as in the JAX package).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import lora
from repro_torch.core.quant import QuantConfig
from repro_torch.fl.client import pow2_pad
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import lm as LM
from repro_torch.obs import trace as obst
from repro_torch.obs.compile import CompileWatchdog
from repro_torch.serve.cache import AdapterCache, StagedBucket, StagedLayer
from repro_torch.utils.device import resolve_device, upload

PATHS = ("fused", "dequant")


def _fused_chain(x: torch.Tensor, ids: list, weights, layers, s: float,
                 bits: int) -> torch.Tensor:
    """One bucket's whole layer chain: every layer is one fused
    gather+dequant+matmul launch over the packed slab."""
    for w, lyr in zip(weights, layers):
        x = kops.multi_lora_matmul_packed(
            x, w, lyr.aq, lyr.a_scale, lyr.a_zp, lyr.bq, lyr.b_scale,
            lyr.b_zp, ids, s, bits)
    return x


def _dequant_stacks(lyr: StagedLayer, bits: int, k: int, r: int):
    """Baseline step 1: materialize the staged slab as fp32 adapter
    stacks (E, K, R) / (E, R, N) — the cost the fused path avoids."""
    la = kref.unpack_words(lyr.aq, bits)[..., :k].to(torch.float32)
    adeq = (la - lyr.a_zp[..., None]) * lyr.a_scale[..., None]
    lb = kref.unpack_words(lyr.bq, bits)[..., :r].to(torch.float32)
    bdeq = (lb - lyr.b_zp[..., None]) * lyr.b_scale[..., None]
    return (adeq.transpose(1, 2).contiguous(),
            bdeq.transpose(1, 2).contiguous())


class AdapterServingEngine:
    """Serve ``weights`` (a chain of (d_in, d_out) frozen linears) with
    per-request adapters from ``cache`` on ``device`` (default: the
    card; raises without one). ``fetch(cid) -> wire message`` resolves
    admission misses from the adapter store; without it a miss raises.
    ``strict_compiles``: once a step shape (batch rows x per-bucket
    split x slab slots x path) has run, re-running it must build no
    program; a build raises ``obs.CompileBudgetExceeded``."""

    def __init__(self, weights: Sequence, scale: float,
                 qcfg: QuantConfig, cache: AdapterCache,
                 fetch: Optional[Callable[[int], Any]] = None,
                 path: str = "fused", slab_slots: int = 8,
                 strict_compiles: bool = False,
                 tracer: Optional[obst.Tracer] = None, device="cuda"):
        if path not in PATHS:
            raise ValueError(f"path must be one of {PATHS}: {path!r}")
        self.device = resolve_device(device)
        self.weights = tuple(
            torch.as_tensor(w).to(device=self.device,
                                  dtype=torch.float32).contiguous()
            for w in weights)
        self.scale = float(scale)
        self.qcfg = qcfg
        self.cache = cache
        self.fetch = fetch
        self.path = path
        # slab slot floor: buckets pad to >= this many slots so the
        # kernels' E dim is stable across batch compositions
        self.slab_slots = int(slab_slots)
        # staged slabs memo: bucket rank -> (cache version, StagedBucket);
        # restages only when the working set changes
        self._staged: dict[int, tuple[int, StagedBucket]] = {}
        self.strict_compiles = bool(strict_compiles)
        self._warm_shapes: set[tuple] = set()
        self.tracer = obst.get_tracer(tracer)

    # -- admission (counted cache traffic) ----------------------------------

    def admit(self, cids: Sequence[int]) -> int:
        """One COUNTED cache lookup per request; misses fetch from the
        store and land in the cache in wire form. Returns #misses."""
        misses = 0
        for cid in cids:
            if self.cache.lookup(cid) is None:
                misses += 1
                if self.fetch is None:
                    raise KeyError(f"client {cid} not cached and no "
                                   "fetch callback configured")
                self.cache.put(cid, self.fetch(cid))
        return misses

    # -- decode -------------------------------------------------------------

    def step(self, x, cids: Sequence[int]) -> torch.Tensor:
        """One decode micro-batch: x (B, d_in), cids length B. Rows
        group by rank bucket; each bucket runs the layer chain over its
        staged slab. Returns (B, d_out) fp32 on the engine's device."""
        cids = [int(c) for c in cids]
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        if x.shape[0] != len(cids):
            raise ValueError(f"{x.shape[0]} rows vs {len(cids)} cids")
        groups: dict[int, list[int]] = {}
        for row, cid in enumerate(cids):
            e = self.cache.peek(cid)
            if e is None:
                raise KeyError(f"client {cid} not cached — admit() first")
            groups.setdefault(pow2_pad(e.rank), []).append(row)
        # staging first (slab growth or a restage may build programs: it
        # is not steady state); the compute below is watchdogged by shape
        staged_by = {rb: self._staged_for(rb, [cids[r] for r in rows])
                     for rb, rows in sorted(groups.items())}
        shape_key = (x.shape[0], self.path, tuple(
            (rb, len(rows), staged_by[rb].n_slots)
            for rb, rows in sorted(groups.items())))
        with self.tracer.span("serve/step", batch=len(cids),
                              buckets=len(groups), path=self.path):
            if self.strict_compiles and shape_key in self._warm_shapes:
                with CompileWatchdog(0, label="steady-state decode "
                                              f"{shape_key}"):
                    y = self._compute(x, cids, groups, staged_by)
            else:
                y = self._compute(x, cids, groups, staged_by)
                self._warm_shapes.add(shape_key)
        return y

    def _compute(self, x: torch.Tensor, cids: list[int],
                 groups: dict[int, list[int]],
                 staged_by: dict[int, StagedBucket]) -> torch.Tensor:
        n_out = self.weights[-1].shape[1]
        y = torch.zeros((len(cids), n_out), dtype=torch.float32,
                        device=self.device)
        for rb, rows in sorted(groups.items()):
            staged = staged_by[rb]
            idx = upload(torch.tensor(rows), self.device)
            y[idx] = self._bucket_step(
                x[idx], staged, [staged.slots[cids[r]] for r in rows])
        return y

    def _staged_for(self, rb: int, bucket_cids: list[int]) -> StagedBucket:
        """Working-set staging: the bucket's slab ACCUMULATES the
        clients it has served, so steady-state batches over resident
        adapters reuse the device slab with zero restaging. A cache
        write (put/evict bumps ``version``) or an unstaged client
        rebuilds the slab from the still-cached working set plus the
        new arrivals; the slot count only pow2-grows."""
        need = set(bucket_cids)
        cur = self._staged.get(rb)
        if cur is not None and cur[0] == self.cache.version \
                and need <= cur[1].slots.keys():
            return cur[1]
        keep = [] if cur is None else [
            c for c in cur[1].slots
            if (e := self.cache.peek(c)) is not None
            and pow2_pad(e.rank) == rb]
        kept = set(keep)
        cids = keep + [c for c in bucket_cids if c not in kept]
        staged = self.cache.stage(cids, min_slots=self.slab_slots,
                                  device=self.device)[rb]
        self._staged[rb] = (self.cache.version, staged)
        return staged

    def _bucket_step(self, xb: torch.Tensor, staged: StagedBucket,
                     slots: list[int]) -> torch.Tensor:
        m = xb.shape[0]
        mp = max(8, pow2_pad(m))
        xp = torch.nn.functional.pad(xb, (0, 0, 0, mp - m)) \
            if mp != m else xb.contiguous()
        ids = slots + [0] * (mp - m)        # padded rows read slot 0
        bits = self.qcfg.bits
        if self.path == "fused":
            yp = _fused_chain(xp, ids, self.weights, staged.layers,
                              self.scale, bits)
        else:
            yp = xp
            for w, lyr in zip(self.weights, staged.layers):
                a_stack, b_stack = _dequant_stacks(
                    lyr, bits, w.shape[0], staged.rank)
                yp = kops.multi_lora_matmul(yp, w, a_stack, b_stack, ids,
                                            self.scale)
        return yp[:m]

    # -- numerics oracle ----------------------------------------------------

    def oracle_step(self, x, cids: Sequence[int]) -> torch.Tensor:
        """Per-row merged-dense serving (``dense_merge`` of the
        DEQUANTIZED pair into the base) — the slow exact reference the
        fused path is validated against. Test/debug only."""
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        ys = []
        for row, cid in enumerate(cids):
            e = self.cache.peek(int(cid))
            if e is None:
                raise KeyError(f"client {cid} not cached")
            xv = x[row]
            for w, pair in zip(self.weights, e.pairs):
                a, b = pair.dequant(self.device)
                xv = xv @ lora.dense_merge(w, a, b, self.scale)
            ys.append(xv)
        return torch.stack(ys)


# ---------------------------------------------------------------------------
# Single-tenant LM serving loop
# ---------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(frozen: Any, train: Any, cfg: Any, prompt, gen: int, *,
             temperature: float = 0.0, seed: int = 0,
             max_seq: Optional[int] = None, device="cuda"
             ) -> tuple[torch.Tensor, dict[str, float]]:
    """Prefill + autoregressive decode for a decoder LM whose parameters
    lie on ``device`` (default: the card; raises without one): greedy
    argmax, or categorical at ``temperature > 0`` from a
    ``torch.Generator`` seeded with ``seed`` (its draws are not the JAX
    package's ``jax.random`` draws).

    Returns (tokens (B, gen) int32: the prefill-argmax token plus
    ``gen - 1`` decode steps, and wall timings {'prefill_s',
    'decode_s', 'decode_steps'}, the card synchronized before each
    clock is read)."""
    dev = resolve_device(device)
    have = LM.param_device(frozen)
    if have.type != dev.type:
        raise ValueError(f"the parameters lie on {have}, not on {dev}")
    prompt = torch.as_tensor(prompt, device=have)
    if max_seq is None:
        # the reference's default, which counts a prefix-LM's prefix
        # although generate passes none (text only)
        max_seq = prompt.shape[1] + gen + (
            cfg.prefix_len if getattr(cfg, "prefix_lm", False) else 0)
    rng = torch.Generator(device=have).manual_seed(int(seed))
    with torch.no_grad():
        _sync(have)
        t0 = time.perf_counter()
        logits, caches, pos = LM.prefill(frozen, train, cfg, prompt,
                                         max_seq=max_seq)
        _sync(have)
        prefill_s = time.perf_counter() - t0

        tok = torch.argmax(logits, -1)[:, None]
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, caches = LM.decode_step(frozen, train, cfg, tok, caches,
                                            pos)
            if temperature > 0:
                probs = torch.softmax(logits[:, 0] / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=rng)
            else:
                tok = torch.argmax(logits[:, 0], -1)[:, None]
            pos += 1
            out.append(tok)
        _sync(have)
        decode_s = time.perf_counter() - t0
    return torch.cat(out, dim=1).to(torch.int32), {
        "prefill_s": prefill_s, "decode_s": decode_s,
        "decode_steps": gen - 1}
