"""Event-driven ASYNCHRONOUS federation: staleness-aware FedBuff over the
packed wire (Nguyen et al. '22 buffered asynchronous aggregation composed
with FLoCoRA's quantized low-rank messages), ported from the JAX
package's ``repro/fl/async_engine.py``.

Round lockstep gives way to a VIRTUAL-CLOCK discrete-event simulation:

  * DISPATCH — the server samples an idle client, broadcasts the current
    global adapters truncated to the client's rank
    (``flocora.broadcast``; one pack a (version, rank), shared by every
    record dispatched from it) and schedules the update's arrival with a
    :class:`~repro_torch.fl.traces.FleetTrace`. A churned dispatch
    (``trace.churned``) never trains: its downlink is wasted and the
    server notices at the deadline a live client would have hit;
  * ARRIVAL — the client's packed uplink (``flocora.client_uplink``)
    enters the :class:`~repro_torch.core.aggregation.FedBuffAggregator`
    with weight ``n_k * 2^(-staleness / half_life)``, staleness being
    the versions the server advanced since the dispatch;
  * FLUSH — every ``buffer_size`` arrivals the buffer reduces (one
    ``dequant_agg_rows`` launch a rank bucket, or with ``streaming_agg``
    one K = 1 launch an arrival at add time) into ``mean_u``, and the
    global tree moves by the mean DELTA:
    ``g + server_lr * (mean_u - mean_start)``, ``mean_start`` being the
    same discounted mean over the broadcasts the clients started from.

MICRO-BATCHED TRAINING: pending arrivals within ``microbatch_window``
virtual seconds of the earliest one are grouped BY RANK and each group
trains as one vmapped program (``make_staggered_cohort_trainer``: a
start tree a client), its client dim padded to a power of two.

DETERMINISM AND RESUME: every stochastic choice (client sampling
``TAG_SAMPLE``, batch shuffle ``TAG_BATCH``, the trace's latency and
churn, DP noise) comes from a generator keyed by the simulation's ids,
so the sequence of events is a pure function of the config and equals
the JAX engine's event for event. Checkpoints align to flush boundaries
and hold the whole engine state (clock, version, event heap, in-flight
starts and computed uplinks, byte counters, history) in the JAX
package's format and key names, so a run resumes from a checkpoint of
either package.

Trees are never updated in place: start trees, memoized broadcasts and
the global tree may be one object (an fp wire broadcasts the global tree
itself), and every update builds new tensors.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.core import flocora, lora
from repro_torch.core.aggregation import FedBuffAggregator
from repro_torch.core.flat import FlatPackedMessage
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.messages import PackedLeaf, is_wire_leaf
from repro_torch.core.quant import gaussian_epsilon
from repro_torch.core.sparse import SparseLeaf
from repro_torch.fl.client import ClientConfig, cohort_steps, \
    make_staggered_cohort_trainer, natural_steps, pad_cohort_batches, \
    pow2_pad, stack_local_batches
from repro_torch.fl.server import WireAccounting
from repro_torch.fl.traces import FleetTrace
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_bytes, tree_map, tree_to

# rng key domains (traces.py owns TAG_LATENCY = 0xA1, TAG_CHURN = 0xA2)
TAG_SAMPLE = 0xB1     # which idle client to dispatch
TAG_BATCH = 0xB2      # a dispatched client's local batch shuffle


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Engine knobs for the asynchronous FedBuff loop.
    ``strict_compiles`` hands the aggregator's streaming accumulators a
    zero-budget compile watchdog on every fold after the first."""
    total_arrivals: int = 200    # stop after this many buffered arrivals
    concurrency: int = 8         # clients kept in flight
    buffer_size: int = 10        # FedBuff K: flush every K arrivals
    streaming_agg: bool = False  # fold flat arrivals at add time
    half_life: float = 4.0       # staleness discount half-life (versions)
    server_lr: float = 1.0       # scale on the applied mean flush delta
    microbatch_window: float = 0.0  # virtual-seconds arrival grouping
    strict_compiles: bool = False
    seed: int = 0
    eval_every: int = 5          # eval_fn every N flushes
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10   # checkpoint every N flushes

    def __post_init__(self):
        if min(self.total_arrivals, self.concurrency, self.buffer_size,
               self.eval_every, self.checkpoint_every) < 1:
            raise ValueError("total_arrivals/concurrency/buffer_size/"
                             "eval_every/checkpoint_every must be >= 1")
        if self.half_life <= 0:
            raise ValueError("half_life must be > 0")
        if self.server_lr <= 0:
            raise ValueError("server_lr must be > 0")
        if self.microbatch_window < 0:
            raise ValueError("microbatch_window must be >= 0")


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-not-yet-buffered client update."""
    cid: int
    rank: int
    version: int          # global version the client trained from
    dispatch_idx: int     # global dispatch counter (rng/trace key)
    t_dispatch: float
    t_arrival: float
    n_k: int              # client sample count (aggregation weight)
    start: Any            # broadcast fp tree at `rank` (None if dropped)
    msg: Any = None       # computed packed uplink (micro-batch cache)
    loss: float = float("nan")
    dropped: bool = False  # churned: never trains, never buffers
    down: int = 0         # downlink bytes spent at dispatch


def time_to_target(history: list[dict], key: str, target: float,
                   mode: str = "min") -> Optional[dict]:
    """Bytes AND virtual seconds to a target metric: the first history
    record whose ``key`` reaches ``target`` (``mode='min'``: <=, for
    losses; ``'max'``: >=, for accuracies). Returns {'version',
    't_virtual', 'tcc_bytes'} or None if never reached."""
    for h in history:
        if key not in h:
            continue
        hit = h[key] <= target if mode == "min" else h[key] >= target
        if hit:
            return {"version": h["version"], "t_virtual": h["t_virtual"],
                    "tcc_bytes": h["tcc_bytes"]}
    return None


# the tensors of each wire leaf, in the JAX package's pytree child order:
# a checkpoint names them "[<flat index i>]" below the leaf's path there
_WIRE_CHILDREN = {FlatPackedMessage: ("payload", "scale", "zp", "fp_leaves"),
                  PackedLeaf: ("payload", "scale", "zp"),
                  SparseLeaf: ("idx", "payload", "scale", "zp")}


def _child_key(i: int) -> str:
    return f"[<flat index {i}>]"


def message_arrays(msg: Any) -> Any:
    """A wire message as the tree of its tensors that the JAX package's
    checkpoint flattens it to: each wire leaf becomes a dict of its
    children keyed ``[<flat index i>]`` (so a flat message's keys are
    ``[<flat index 0>]`` ... ``[<flat index 3>]/0``, ...)."""
    def conv(x):
        if is_wire_leaf(x):
            names = _WIRE_CHILDREN[type(x)]
            return {_child_key(i): getattr(x, n)
                    for i, n in enumerate(names)}
        return x
    if is_wire_leaf(msg):
        return conv(msg)
    return tree_map(conv, msg)


def message_from_arrays(template: Any, arrays: Any) -> Any:
    """Inverse of :func:`message_arrays`: ``template``'s wire leaves with
    their tensors taken from ``arrays``."""
    if is_wire_leaf(template):
        names = _WIRE_CHILDREN[type(template)]
        fields = {n: arrays[_child_key(i)] for i, n in enumerate(names)}
        if "fp_leaves" in fields:
            fields["fp_leaves"] = tuple(fields["fp_leaves"])
        return dataclasses.replace(template, **fields)
    if isinstance(template, dict):
        return {k: message_from_arrays(v, arrays[k])
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [message_from_arrays(t, a) for t, a in zip(template, arrays)]
        return type(template)(out) if isinstance(template, tuple) else out
    return arrays


class AsyncFLServer:
    """Virtual-clock asynchronous FL server (see module docstring).

    The sync :class:`~repro_torch.fl.server.FLServer`'s model, loss,
    data and eval contract: ``client_data`` is a list of per-client
    numpy dicts or a lazy ``Population``; ``trace`` supplies the fleet
    timing model (default ``FleetTrace(seed=acfg.seed)``) and
    ``aggregator`` (a ``FedBuffAggregator``, default-constructed when
    omitted) the buffered rule. ``trainer`` may share a staggered-cohort
    trainer across engines. The model moves to ``device``, which
    defaults to the card."""

    def __init__(self, model: dict, loss_fn: Callable,
                 client_data: list[dict], acfg: AsyncConfig,
                 ccfg: ClientConfig, fcfg: FLoCoRAConfig,
                 trace: Optional[FleetTrace] = None,
                 eval_fn: Optional[Callable] = None,
                 aggregator: Optional[FedBuffAggregator] = None,
                 trainer: Optional[Callable] = None,
                 registry: Optional[obsm.MetricsRegistry] = None,
                 tracer: Optional[obst.Tracer] = None, device="cuda"):
        self.device = resolve_device(device)
        self.frozen = tree_to(model["frozen"], self.device)
        self.global_train = tree_to(model["train"], self.device)
        self.loss_fn = loss_fn
        self.client_data = client_data
        self.acfg, self.ccfg, self.fcfg = acfg, ccfg, fcfg
        self.trace = trace if trace is not None \
            else FleetTrace(seed=acfg.seed)
        self.eval_fn = eval_fn
        # spans land on the VIRTUAL clock
        self.registry = obsm.get_registry(registry)
        self.tracer = obst.get_tracer(tracer).with_clock(
            lambda: self.clock)
        if fcfg.error_feedback:
            # an EF residual assumes the next encode of the same client
            # compensates the previous one; staleness breaks that
            raise ValueError("error feedback is not supported by the "
                             "async engine")
        sched = fcfg.rank_schedule
        if sched is not None and sched.n_clients != len(client_data):
            raise ValueError(
                f"rank_schedule covers {sched.n_clients} clients, fleet "
                f"has {len(client_data)}")
        # lazy Population fleets carry their own rank tiers; an explicit
        # RankSchedule overrides
        self._pop = client_data \
            if hasattr(client_data, "sample_cid") else None
        if self._pop is not None and sched is None \
                and self._pop.max_rank > fcfg.rank:
            raise ValueError(
                f"population max tier rank {self._pop.max_rank} "
                f"exceeds the server rank {fcfg.rank}")
        if aggregator is None:
            aggregator = FedBuffAggregator()
        if not isinstance(aggregator, FedBuffAggregator):
            raise ValueError(
                f"async engine requires a FedBuffAggregator, got "
                f"{type(aggregator).__name__}")
        if aggregator.r_target is not None \
                and aggregator.r_target != fcfg.rank:
            # the delta flush applies at the global tree's rank
            raise ValueError(
                f"async aggregator r_target={aggregator.r_target} must "
                f"match the server rank {fcfg.rank}")
        fields: dict[str, Any] = {"pending": list(aggregator.pending),
                                  "streams": dict(aggregator.streams)}
        if acfg.streaming_agg:
            fields["streaming"] = True
        if acfg.strict_compiles:
            fields["strict_compiles"] = True
        if aggregator.half_life is None:
            fields["half_life"] = acfg.half_life
        if aggregator.r_target is None:
            fields["r_target"] = fcfg.rank
        self.aggregator = dataclasses.replace(aggregator, **fields)
        self.trainer = trainer if trainer is not None \
            else make_staggered_cohort_trainer(loss_fn, ccfg)
        # fixed schedule length across the fleet: only (rank, pow2 K)
        # change the trainer's shapes
        self.schedule_steps = client_data.schedule_steps(ccfg) \
            if self._pop is not None else cohort_steps(client_data, ccfg)
        hetero = self._pop is not None and sched is None \
            and self._pop.mixed_ranks
        self.wire = WireAccounting(fcfg, registry=self.registry,
                                   hetero=hetero)
        # -- simulation state (everything below round-trips checkpoints)
        self.clock = 0.0
        self.version = 0
        self.n_dispatched = 0
        self.n_arrived = 0
        self.n_churned = 0
        self._wasted_cum = 0
        self.n_flushes = 0
        self.inflight: dict[int, _InFlight] = {}   # dispatch_idx -> rec
        self.heap: list[tuple[float, int]] = []    # (t_arrival, idx)
        self._bcast_memo: dict[int, Any] = {}      # rank -> start tree
        self.history: list[dict] = []
        self._down_cum = 0
        self._up_cum = 0
        self._flush_stats: list[tuple[float, int, int]] = []
        self._flush_starts: list[Any] = []   # broadcast refs, || pending
        # streaming mode: running discounted-weight sum of the resized
        # start trees (mean_start's numerator)
        self._start_sum: Any = None
        self._start_weight: float = 0.0
        self.initial_model_bytes = tree_bytes(self.frozen)
        self.program_keys: set[tuple[int, int]] = set()  # (rank, padK)
        self.ckpt = CheckpointManager(acfg.checkpoint_dir) \
            if acfg.checkpoint_dir else None

    # -- deterministic keyed randomness -------------------------------------
    def _rng(self, *key: int) -> np.random.Generator:
        """A fresh generator keyed by (seed, *key): resumed runs replay
        without serializing any RNG stream."""
        return np.random.default_rng([self.acfg.seed, *key])

    def _rank_for(self, cid: int) -> int:
        sched = self.fcfg.rank_schedule
        if sched is not None:
            return sched.rank_for(cid, self.version)   # versions anneal
        if self._pop is not None:
            return self._pop.rank_for(cid)             # device tier
        return self.fcfg.rank

    @property
    def tcc_bytes(self) -> int:
        """Shared-once initial model + every measured down/uplink."""
        return self.initial_model_bytes + self._down_cum + self._up_cum

    # -- dispatch -----------------------------------------------------------
    def _sample_cid(self, idx: int, busy: set) -> Optional[int]:
        """One dispatch candidate: a Population rejection-samples
        against the busy set; an eager fleet draws from its free list."""
        if self._pop is not None:
            return self._pop.sample_cid(self._rng(TAG_SAMPLE, idx), busy)
        free = [c for c in range(len(self.client_data)) if c not in busy]
        if not free:
            return None
        return int(free[self._rng(TAG_SAMPLE, idx).integers(len(free))])

    def _dispatch_one(self) -> bool:
        """Sample an idle client, broadcast, schedule its arrival (or a
        churned dispatch's deadline)."""
        busy = {f.cid for f in self.inflight.values()}
        idx = self.n_dispatched
        cid = self._sample_cid(idx, busy)
        if cid is None:
            return False
        rank = self._rank_for(cid)
        dropped = self.trace.churned(cid, idx)
        start = None
        if not dropped:
            start = self._bcast_memo.get(rank)
            if start is None:
                # one pack+unpack per (version, rank): the memo clears at
                # every flush and start trees are never written, so the
                # in-flight records share them
                start = flocora.broadcast(self.global_train, self.fcfg,
                                          rank=self.wire.bcast_rank(rank))
                self._bcast_memo[rank] = start
        down = self.wire.downlink_bytes(self.global_train, rank)
        self._down_cum += down
        self.wire.record_down(rank, down)
        # symmetric message sizes: the round trip is 2x the downlink
        t_arr = self.trace.arrival(cid, idx, rank, 2 * down, self.clock)
        if dropped or self._pop is None:
            # a dropped dispatch never trains, so its shard is never made
            n_k = 0 if dropped else \
                len(next(iter(self.client_data[cid].values())))
        else:
            n_k = self._pop.shard_size
        self.inflight[idx] = _InFlight(cid, rank, self.version, idx,
                                       self.clock, t_arr, n_k, start,
                                       dropped=dropped, down=down)
        heapq.heappush(self.heap, (t_arr, idx))
        self.n_dispatched += 1
        self.registry.set("fl.inflight", len(self.inflight))
        return True

    def _expected_arrivals(self) -> int:
        """Arrivals buffered plus live dispatches in flight: the dispatch
        guard, so churn pulls in extra dispatches."""
        return self.n_arrived + sum(1 for r in self.inflight.values()
                                    if not r.dropped)

    def _fill_pipeline(self) -> None:
        while (len(self.inflight) < self.acfg.concurrency
               and self._expected_arrivals() < self.acfg.total_arrivals):
            if not self._dispatch_one():
                break

    # -- micro-batched local training ---------------------------------------
    def _compute_microbatch(self) -> None:
        """Train every not-yet-computed in-flight update arriving within
        ``microbatch_window`` of the earliest pending event, one
        staggered-cohort call a rank."""
        t0 = self.heap[0][0]
        horizon = t0 + self.acfg.microbatch_window
        by_rank: dict[int, list[int]] = {}
        for t, idx in self.heap:
            rec = self.inflight[idx]
            if t <= horizon and rec.msg is None and not rec.dropped:
                by_rank.setdefault(rec.rank, []).append(idx)
        for rank in sorted(by_rank):
            idxs = sorted(by_rank[rank],
                          key=lambda i: (self.inflight[i].t_arrival, i))
            self._train_group(rank, idxs)

    def _train_group(self, rank: int, idxs: list[int]) -> None:
        recs = [self.inflight[i] for i in idxs]
        datas = [self.client_data[r.cid] for r in recs]
        per = [stack_local_batches(self._rng(TAG_BATCH, r.cid,
                                             r.dispatch_idx),
                                   d, self.ccfg, steps=self.schedule_steps)
               for r, d in zip(recs, datas)]
        batches = {k: np.stack([p[k] for p in per]) for k in per[0]}
        n_steps = np.asarray(
            [min(natural_steps(d, self.ccfg), self.schedule_steps)
             for d in datas], np.int32)
        k_pad = pow2_pad(len(recs))
        batches, n_steps = pad_cohort_batches(batches, n_steps, k_pad)
        starts = tree_map(
            lambda *xs: torch.stack(xs, dim=0),
            *([r.start for r in recs]
              + [recs[0].start] * (k_pad - len(recs))))
        self.program_keys.add((rank, k_pad))
        trained, losses = self.trainer(
            self.frozen, starts,
            {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
             for k, v in batches.items()},
            torch.from_numpy(n_steps).to(self.device))
        losses = losses.cpu().numpy()
        for k, rec in enumerate(recs):
            t_k = tree_map(lambda x: x[k], trained)
            # density keys off the DISPATCH version; DP noise is keyed by
            # the dispatch ids, so resume replays it bit for bit
            rec.msg, _ = flocora.client_uplink(
                t_k, self.fcfg, rnd=rec.version, start=rec.start,
                dp_key=(rec.version, rec.cid, rec.dispatch_idx),
                dp_seed=self.acfg.seed)
            rec.loss = float(losses[k])

    # -- the event loop -----------------------------------------------------
    def step(self) -> Optional[dict]:
        """Process ONE event (an arrival, or a churned dispatch's
        deadline); returns the flush record when an arrival filled the
        buffer, else None."""
        if not self.heap:
            self._fill_pipeline()
            if not self.heap:
                raise RuntimeError("no events left "
                                   f"({self.n_arrived} arrivals done)")
        head = self.inflight[self.heap[0][1]]
        if head.msg is None and not head.dropped:
            self._compute_microbatch()
        t_arr, idx = heapq.heappop(self.heap)
        rec = self.inflight.pop(idx)
        self.clock = max(self.clock, t_arr)
        if rec.dropped:
            # CHURN: the update never arrives; the downlink was wasted
            # and a replacement dispatches
            self.n_churned += 1
            self._wasted_cum += rec.down
            self.wire.record_wasted(rec.rank, rec.down, reason="churned")
            self.registry.inc("fl.clients_churned")
            self.registry.set("fl.inflight", len(self.inflight))
            self._fill_pipeline()
            return None
        staleness = self.version - rec.version
        density = self.fcfg.uplink_density(rec.version)
        up = self.wire.uplink_bytes(rec.rank, rec.msg, density) or 0
        self._up_cum += up
        self.wire.record_up(rec.rank, up, density)
        self.n_arrived += 1
        self.tracer.event("fl/inflight", ts=rec.t_dispatch,
                          dur=t_arr - rec.t_dispatch, track="fl/async",
                          cid=rec.cid, rank=rec.rank,
                          version=rec.version, staleness=staleness)
        self.registry.observe("fl.staleness", staleness)
        self.registry.set("fl.inflight", len(self.inflight))
        self.aggregator.add(rec.msg, rec.n_k, staleness)
        self.registry.observe("fl.buffer_occupancy",
                              self.aggregator.buffered)
        if self.acfg.streaming_agg:
            self._fold_start(
                rec.start,
                self.aggregator.discounted_weight(rec.n_k, staleness))
        else:
            self._flush_starts.append(rec.start)
        self._flush_stats.append((rec.loss, staleness, rec.rank))
        out = None
        if self.aggregator.buffered >= self.acfg.buffer_size:
            out = self._flush()
        if self._expected_arrivals() < self.acfg.total_arrivals:
            self._dispatch_one()       # keep the pipeline full
        return out

    def _target_rank(self) -> int:
        return self.aggregator.r_target or self.fcfg.rank

    def _fold_start(self, start: Any, w: float) -> None:
        """Streaming twin of ``_flush_starts``: fold one arrival's
        broadcast into the running discounted-weight start sum (new
        tensors; the start tree is shared and never written)."""
        s = lora.resize_tree_rank(start, self._target_rank())
        if self._start_sum is None:
            self._start_sum = tree_map(lambda x: w * x.to(torch.float32), s)
        else:
            self._start_sum = tree_map(
                lambda a, x: a + w * x.to(torch.float32),
                self._start_sum, s)
        self._start_weight += float(w)

    def _apply_mean(self, mean_u: Any, mean_start: Any) -> None:
        """g <- g + server_lr * (mean_u - mean_start), into new tensors:
        the old global tree may be an in-flight client's start."""
        lr = self.acfg.server_lr
        self.global_train = tree_map(
            lambda g, mu, ms: (g.to(torch.float32)
                               + lr * (mu.to(torch.float32) - ms)
                               ).to(g.dtype),
            self.global_train, mean_u, mean_start)

    def _apply_delta(self, mean_u: Any, weights: list[float]) -> None:
        w = np.asarray(weights, np.float32)
        wn = w / max(float(w.sum()), 1e-8)
        starts = [lora.resize_tree_rank(s, self._target_rank())
                  for s in self._flush_starts]
        mean_start = tree_map(
            lambda *xs: sum(float(a) * x.to(torch.float32)
                            for a, x in zip(wn, xs)), *starts)
        self._apply_mean(mean_u, mean_start)

    def _apply_delta_streaming(self, mean_u: Any) -> None:
        """O(1) flush apply: mean_start = start_sum / start_weight."""
        if self._start_weight <= 0.0:
            raise ValueError("streaming flush with zero accumulated "
                             "start weight")
        inv = 1.0 / self._start_weight
        mean_start = tree_map(lambda a: a * inv, self._start_sum)
        self._start_sum, self._start_weight = None, 0.0
        self._apply_mean(mean_u, mean_start)

    def _flush(self) -> dict:
        losses = [l for l, _, _ in self._flush_stats]
        stales = [s for _, s, _ in self._flush_stats]
        ranks: dict[str, int] = {}
        for _, _, r in self._flush_stats:
            ranks[str(r)] = ranks.get(str(r), 0) + 1
        n_buf = self.aggregator.buffered
        weights = [wt for _, wt in self.aggregator.pending]
        with self.tracer.span("fl/flush", track="fl/async",
                              version=self.version, n_flushed=n_buf):
            mean_u = self.aggregator.flush()
            if self.acfg.streaming_agg:
                self._apply_delta_streaming(mean_u)
            else:
                self._apply_delta(mean_u, weights)
        self._flush_starts = []
        self._bcast_memo = {}          # broadcasts of the old version
        density = self.fcfg.uplink_density(self.version)
        self.version += 1
        self.n_flushes += 1
        self.registry.inc("fl.flushes")
        rec = {"version": self.version, "t_virtual": self.clock,
               "n_arrived": self.n_arrived, "n_flushed": n_buf,
               "n_churned": self.n_churned,
               "client_loss": float(np.mean(losses)),
               "staleness_mean": float(np.mean(stales)),
               "staleness_max": int(max(stales)),
               "flush_ranks": ranks,
               "down_bytes": self._down_cum, "up_bytes": self._up_cum,
               "tcc_bytes": self.tcc_bytes,
               "wasted_bytes": self._wasted_cum,
               "uplink_density": density}
        if self.fcfg.dp is not None:
            # one Gaussian release of the aggregate a flush
            eps = gaussian_epsilon(self.fcfg.dp.noise_multiplier,
                                   self.version, self.fcfg.dp.delta)
            rec["dp_epsilon"] = eps
            self.registry.set("fl.dp_epsilon", eps)
        self._flush_stats = []
        if self.eval_fn and self.n_flushes % self.acfg.eval_every == 0:
            rec.update({k: float(v) for k, v in
                        self.eval_fn(self.frozen,
                                     self.global_train).items()})
        self.history.append(rec)
        if self.ckpt and self.n_flushes % self.acfg.checkpoint_every == 0:
            self.save()
        return rec

    def run(self) -> list[dict]:
        """Drive the event loop to ``total_arrivals`` buffered arrivals
        (from restored state after ``try_resume``), with a final partial
        flush so the history covers every update."""
        self._fill_pipeline()
        while self.n_arrived < self.acfg.total_arrivals:
            self.step()
        if self.aggregator.buffered:
            self._flush()
        return self.history

    # -- checkpoint/resume (full simulator state) ---------------------------
    def _start_template(self, rank: int) -> Any:
        """Zeros shaped as a rank-``rank`` broadcast tree, on the CPU."""
        tree = self.global_train
        if self.wire.bcast_rank(rank) is not None:
            tree = lora.resize_tree_rank(tree, rank, method="slice")
        return tree_map(lambda x: torch.zeros(tuple(x.shape),
                                              dtype=x.dtype), tree)

    def _msg_template(self, rank: int, version: int = 0) -> Any:
        """A rank-``rank`` uplink dispatched at ``version`` (sparse
        payload shapes anneal between versions), packed on the CPU."""
        return flocora.client_uplink(self._start_template(rank), self.fcfg,
                                     rnd=version)[0]

    def save(self) -> None:
        if self.ckpt is None:
            return
        # checkpoints align to flush boundaries: the buffer, the stream
        # accumulators and the start sum are empty by construction
        assert (not self.aggregator.pending and not self._flush_starts
                and self.aggregator.buffered == 0
                and self._start_sum is None), \
            "async checkpoint must align to a flush boundary"
        trees: dict[str, Any] = {"train": self.global_train}
        meta_if: dict[str, dict] = {}
        for idx, rec in self.inflight.items():
            if rec.start is not None:
                trees[f"inflight_{idx}"] = rec.start
            if rec.msg is not None:
                # computed uplinks ride along, so a resumed run never
                # recomputes them under another micro-batch grouping
                trees[f"msg_{idx}"] = message_arrays(rec.msg)
            meta_if[str(idx)] = {
                "cid": rec.cid, "rank": rec.rank, "version": rec.version,
                "t_dispatch": rec.t_dispatch, "t_arrival": rec.t_arrival,
                "n_k": rec.n_k, "has_msg": rec.msg is not None,
                "loss": rec.loss, "dropped": rec.dropped,
                "down": rec.down}
        self.ckpt.save(self.n_flushes, trees, metadata={
            "clock": self.clock, "version": self.version,
            "n_dispatched": self.n_dispatched,
            "n_arrived": self.n_arrived, "n_flushes": self.n_flushes,
            "n_churned": self.n_churned, "wasted_cum": self._wasted_cum,
            "down_cum": self._down_cum, "up_cum": self._up_cum,
            "heap": sorted(self.heap), "inflight": meta_if,
            "history": self.history})

    def try_resume(self) -> bool:
        """Continue from the newest checkpoint (of either package), if
        there is one; its trees land on this engine's device."""
        if self.ckpt is None:
            return False
        step = latest_step(self.ckpt.directory)
        if step is None:
            return False
        # pass 1: the manifest gives the in-flight trees' ranks, from
        # which pass 2's templates are built
        _, man = restore(self.ckpt.directory, step,
                         {"train": self.global_train})
        meta = man["metadata"]
        like: dict[str, Any] = {"train": self.global_train}
        msg_like: dict[str, Any] = {}
        for s, m in meta["inflight"].items():
            if not m.get("dropped", False):
                like[f"inflight_{s}"] = self._start_template(m["rank"])
            if m["has_msg"]:
                msg_like[s] = self._msg_template(m["rank"], m["version"])
                like[f"msg_{s}"] = message_arrays(msg_like[s])
        trees, _ = restore(self.ckpt.directory, step, like,
                           device=self.device)
        self.global_train = trees["train"]
        self.clock = meta["clock"]
        self.version = meta["version"]
        self.n_dispatched = meta["n_dispatched"]
        self.n_arrived = meta["n_arrived"]
        self.n_flushes = meta["n_flushes"]
        self.n_churned = meta.get("n_churned", 0)
        self._wasted_cum = meta.get("wasted_cum", 0)
        self._down_cum = meta["down_cum"]
        self._up_cum = meta["up_cum"]
        self.history = list(meta["history"])
        self._flush_stats = []
        self._start_sum, self._start_weight = None, 0.0
        for st in self.aggregator.streams.values():
            st.reset()      # checkpoint boundary == empty accumulators
        self.inflight = {}
        for s, m in meta["inflight"].items():
            idx = int(s)
            msg = None
            if m["has_msg"]:
                msg = message_from_arrays(msg_like[s], trees[f"msg_{s}"])
            self.inflight[idx] = _InFlight(
                m["cid"], m["rank"], m["version"], idx, m["t_dispatch"],
                m["t_arrival"], m["n_k"], trees.get(f"inflight_{s}"),
                msg=msg, loss=m["loss"], dropped=m.get("dropped", False),
                down=m.get("down", 0))
        self.heap = [tuple(e) for e in meta["heap"]]
        heapq.heapify(self.heap)
        return True
