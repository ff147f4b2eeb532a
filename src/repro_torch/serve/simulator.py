"""Continuous-batching request simulator for the multi-tenant engine.

Drives :class:`~repro_torch.serve.engine.AdapterServingEngine` with a
Poisson arrival trace over a Zipf-popular fleet of clients: requests are
admitted (one COUNTED cache lookup each; misses pay a fetch delay drawn
from :class:`~repro_torch.fl.traces.LognormalLatency`), then decode in
micro-batches grouped by rank bucket inside the engine. The virtual
clock advances by the MEASURED wall time of each engine step, taken
after ``torch.cuda.synchronize()`` on a CUDA engine (compute cost is
real, network cost is modeled), so the reported requests/sec,
tokens/sec and p50/p99 request latencies are measured numbers for the
chosen serving path.

Determinism: every draw is a pure function of ``(seed, TAG, ...)`` via
``np.random.default_rng([seed, TAG, ...])``, the JAX package's keys, so
both packages replay the same arrivals, clients, fetch delays, inputs,
weights and adapters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import messages
from repro_torch.core.quant import QuantConfig
from repro_torch.fl.traces import LognormalLatency
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.serve.cache import wire_bytes_of
from repro_torch.serve.engine import AdapterServingEngine
from repro_torch.utils.device import resolve_device, upload

# rng stream tags (the JAX package's): arrivals/popularity/inputs of
# the serving trace, and fetch delays / the synthetic store
TAG_ARRIVAL = 0xA7
TAG_FETCH = 0xA8

# a serving-node fetch is a datacenter RPC, not an edge training round:
# sub-ms median service time + wire transfer at NIC-ish rates
FETCH_LATENCY = LognormalLatency(compute_median_s=5e-4, compute_sigma=0.3,
                                 network_mbps=1000.0, network_sigma=0.2,
                                 rank_exp=0.0)


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """A simulated serving workload.

    ``zipf_a`` shapes client popularity (p ~ (i+1)^-a); ``rate_rps`` is
    the Poisson arrival rate; ``gen_tokens`` decode steps per request;
    ``max_active`` caps concurrently-admitted (adapter-pinned)
    requests — arrivals beyond it queue unadmitted."""
    n_requests: int = 64
    rate_rps: float = 500.0
    gen_tokens: int = 8
    max_batch: int = 8
    max_active: int = 32
    zipf_a: float = 1.1
    seed: int = 0


@dataclasses.dataclass
class AdapterStore:
    """The serving node's upstream adapter registry (the FL server):
    per-client wire messages, fetched on cache miss."""
    msgs: dict[int, object]
    ranks: dict[int, int]
    qcfg: QuantConfig
    fetches: int = 0

    def fetch(self, cid: int):
        self.fetches += 1
        return self.msgs[cid]

    def rank_of(self, cid: int) -> int:
        return self.ranks[cid]

    def bytes_of(self, cid: int) -> int:
        return wire_bytes_of(self.msgs[cid], self.qcfg)

    @property
    def cids(self) -> list[int]:
        return sorted(self.msgs)


def make_store(n_clients: int, d_model: int, n_layers: int = 2,
               ranks: Sequence[int] = (4, 8), bits: int = 4,
               seed: int = 0, device="cuda"
               ) -> tuple[list[torch.Tensor], AdapterStore]:
    """Synthesize a fleet's uplinked adapters on ``device``: ``n_clients``
    wire messages over a shared ``n_layers``-deep chain of (d, d) frozen
    linears, rank tiered round-robin over ``ranks``, packed with the
    real codec — even cids flat-tree, odd cids per-leaf. The numpy draws
    are the JAX package's, so weights and adapters are bit-identical to
    its store. Returns (frozen weights, store)."""
    dev = resolve_device(device)
    qcfg = QuantConfig(bits=bits)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    rng = np.random.default_rng([seed, TAG_FETCH, 0xF])
    weights = [put(rng.standard_normal((d_model, d_model)) * 0.05)
               for _ in range(n_layers)]
    msgs, rmap = {}, {}
    for cid in range(n_clients):
        r = int(ranks[cid % len(ranks)])
        crng = np.random.default_rng([seed, TAG_FETCH, cid])
        tree = {"layers": [
            {"a": put(crng.standard_normal((d_model, r)) * 0.1),
             "b": put(crng.standard_normal((r, d_model)) * 0.1)}
            for _ in range(n_layers)]}
        msgs[cid] = messages.pack_message(tree, qcfg, flat=(cid % 2 == 0))
        rmap[cid] = r
    return weights, AdapterStore(msgs=msgs, ranks=rmap, qcfg=qcfg)


@dataclasses.dataclass
class _Req:
    idx: int
    cid: int
    t_arrive: float
    ready: float = 0.0          # admission + (miss ? fetch delay : 0)
    left: int = 0
    t_done: Optional[float] = None


def _draw_requests(store: AdapterStore, wl: WorkloadConfig) -> list[_Req]:
    rng = np.random.default_rng([wl.seed, TAG_ARRIVAL])
    gaps = rng.exponential(1.0 / wl.rate_rps, wl.n_requests)
    t = np.cumsum(gaps)
    cids = store.cids
    p = (np.arange(len(cids)) + 1.0) ** -wl.zipf_a
    p /= p.sum()
    picks = rng.choice(len(cids), size=wl.n_requests, p=p)
    return [_Req(idx=i, cid=int(cids[picks[i]]), t_arrive=float(t[i]),
                 left=wl.gen_tokens) for i in range(wl.n_requests)]


def _timed_step(engine: AdapterServingEngine, rows: torch.Tensor,
                cids: list[int]) -> float:
    """Wall seconds of one engine step, to the end of its device work."""
    t0 = time.perf_counter()
    engine.step(rows, cids)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return time.perf_counter() - t0


def simulate(engine: AdapterServingEngine, store: AdapterStore,
             wl: WorkloadConfig, warmup: bool = True,
             registry: Optional[obsm.MetricsRegistry] = None,
             tracer: Optional[obst.Tracer] = None) -> dict:
    """Run the workload through the engine; returns measured stats.

    Admission and queue-depth telemetry rides the obs registry
    (``serve.sim.*``), and each decode step plus each request's
    admit->done lifetime lands on the tracer as a VIRTUAL-TIME span."""
    reg = obsm.get_registry(registry)
    tr = obst.get_tracer(tracer)
    if engine.fetch is None:
        engine.fetch = store.fetch
    d_in = int(engine.weights[0].shape[0])
    reqs = _draw_requests(store, wl)
    xrng = np.random.default_rng([wl.seed, TAG_ARRIVAL, 1])
    xs_host = (xrng.standard_normal((wl.n_requests, d_in)) * 0.5
               ).astype(np.float32)
    # inputs live on the engine's device from the start (set-up, not
    # step time); each step gathers its rows there
    xs = torch.from_numpy(xs_host).to(engine.device)

    if warmup:
        # run every steady-state step shape once before the timed loop:
        # each rank tier alone and every (batch size, per-bucket split) a
        # mixed micro-batch can produce, so the first simulated path
        # does not pay one-time costs (kernel build and load, allocator
        # growth) that the second would not
        seen: dict[int, int] = {}
        for cid in store.cids:
            seen.setdefault(store.rank_of(cid), cid)
        tiers = list(seen.values())
        engine.admit(tiers)
        mmax = min(wl.max_batch, wl.n_requests)
        for m in range(1, mmax + 1):
            comps = [[t] * m for t in tiers]
            comps += [[tiers[0]] * m1 + [t] * (m - m1)
                      for t in tiers[1:] for m1 in range(1, m)]
            for comp in comps:
                engine.step(xs[:m], comp)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        c = engine.cache
        c.hits = c.misses = c.evictions = 0
        store.fetches = 0

    clock = 0.0
    pending = list(reqs)        # arrival order (t is already sorted)
    admitted: list[_Req] = []
    done: list[_Req] = []
    steps = 0
    while len(done) < wl.n_requests:
        # admit arrived requests up to the active cap (counted lookup;
        # a miss's modeled fetch delay gates that request's readiness,
        # not the node)
        while pending and pending[0].t_arrive <= clock \
                and len(admitted) < wl.max_active:
            r = pending.pop(0)
            missed = engine.admit([r.cid])
            reg.inc("serve.sim.admissions", hit=not missed)
            if missed:
                frng = np.random.default_rng(
                    [wl.seed, TAG_FETCH, r.cid, r.idx])
                fetch_s = FETCH_LATENCY.sample(
                    frng, store.rank_of(r.cid), store.bytes_of(r.cid))
                r.ready = clock + fetch_s
                reg.inc("serve.sim.fetch_bytes", store.bytes_of(r.cid))
                tr.event("serve/fetch", ts=clock, dur=fetch_s,
                         track="serve/fetch", cid=r.cid)
            else:
                r.ready = clock
            engine.cache.pin(r.cid)     # in-flight: evictable at done
            admitted.append(r)
        n_waiting = sum(1 for p in pending if p.t_arrive <= clock)
        reg.observe("serve.sim.queue_depth", n_waiting)
        reg.observe("serve.sim.active", len(admitted))
        runnable = [r for r in admitted if r.ready <= clock][:wl.max_batch]
        if not runnable:
            # idle: fast-forward the clock to the next event (the next
            # arrival only counts if there is room to admit it)
            nxt = [r.ready for r in admitted]
            if pending and len(admitted) < wl.max_active:
                nxt.append(pending[0].t_arrive)
            clock = max(clock, min(nxt))
            continue
        rows = xs[upload(torch.tensor([r.idx for r in runnable]),
                         engine.device)]
        dt = _timed_step(engine, rows, [r.cid for r in runnable])
        tr.event("serve/decode_step", ts=clock, dur=dt,
                 track="serve/steps", rows=len(runnable),
                 path=engine.path)
        clock += dt
        steps += 1
        reg.observe("serve.sim.batch_rows", len(runnable))
        for r in runnable:
            r.left -= 1
            if r.left == 0:
                r.t_done = clock
                engine.cache.unpin(r.cid)
                admitted.remove(r)
                done.append(r)
                reg.inc("serve.sim.requests_done")
                tr.event("serve/request", ts=r.t_arrive,
                         dur=r.t_done - r.t_arrive,
                         track="serve/requests", cid=r.cid)

    lat_ms = np.asarray(
        sorted(1e3 * (r.t_done - r.t_arrive) for r in done))
    span = max(max(r.t_done for r in done), 1e-9)
    st = engine.cache.stats()
    return {
        "path": engine.path,
        "requests": wl.n_requests,
        "steps": steps,
        "wall_s": span,
        "requests_per_s": wl.n_requests / span,
        "tokens_per_s": wl.n_requests * wl.gen_tokens / span,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "hit_rate": st["hit_rate"],
        "hits": st["hits"],
        "misses": st["misses"],
        "evictions": st["evictions"],
        "cache_bytes": st["bytes"],
        "cache_entries": st["entries"],
        "store_fetches": store.fetches,
    }
