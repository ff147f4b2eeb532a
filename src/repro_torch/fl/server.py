"""FL server orchestration: the synchronous FLoCoRA round (paper Fig. 1).

One round samples K' = oversample*K clients, broadcasts the packed global
adapters, trains the survivors locally, packs every uplink, keeps the
first K arrivals (simulated latency order) and FedAvg-reduces their
packed messages: in one fused kernel launch on the flat wire, in one
launch per packed leaf on the per-leaf wire. Client dropout is keyed by
(seed, round, cid). Wire bytes are MEASURED from the serialized
messages, and each transfer is also counted in the ``obs`` registry
(``wire.down_bytes``, ``wire.up_bytes``, ``wire.wasted_bytes``) with
the round's phases as tracer spans (``fl/broadcast``,
``fl/client_train``, ``fl/pack``, ``fl/uplink``, ``fl/aggregate``).

With error feedback on (``FLoCoRAConfig(error_feedback=True)``) each
client's residual rides into its uplink; residuals commit only for the
kept clients, and a straggler's discarded message folds back into its
residual. ``ServerConfig(checkpoint_dir=...)`` saves (round, global
adapters, TCC, sampler RNG state) atomically every ``checkpoint_every``
rounds in the JAX package's format; ``try_resume`` continues the exact
run. As in the JAX package, EF residuals are not checkpointed.

The engine's numpy RNG stream is consumed exactly as the JAX package's
(``repro/fl/server.py``) consumes it: ``rng.choice`` for the cohort, one
``rng.exponential`` per survivor for its latency, then
``stack_cohort_batches``. Both packages therefore sample the same
cohorts and batches from one seed.

RANK-BUCKETED ENGINE: the survivors group by adapter rank and each
bucket trains as ONE vmapped program (``fl/client.make_cohort_trainer``)
from the broadcast truncated to the bucket's rank; with a
``RankSchedule`` the bucket's client dim pads to a power of two. A
uniform fleet is one bucket at the server rank. The buckets gather their
batches from the sampler stream in ascending rank order, after the
latency draws: that order is the parity contract with the JAX package.
Mixed cohorts aggregate per rank bucket (``fedavg_hetero``), sparse
uplinks by scatter-add; with ``FLoCoRAConfig.dp`` each uplink's delta
against its broadcast is clipped and noised, keyed (round, cid), and the
record carries the ``dp_epsilon`` spent so far. ``eval_fn(frozen,
train) -> dict`` is called on the new global adapters every
``eval_every`` rounds and merged into the round's record, as in the JAX
package.

DEADLINE COHORTS: with a ``FleetTrace`` (``trace=``) the straggler
order comes from the trace's arrival times, keyed (seed, cid, round) and
drawn at each client's rank and measured round-trip bytes, instead of
the sampler stream's exponentials (which are then not drawn, as in the
JAX package). LAZY FLEETS: ``client_data`` may be a
``fl/population.Population``; its device tiers give each client's rank
(a ``RankSchedule`` overrides), broadcasts truncate per rank, and its
``schedule_steps`` fixes the cohort schedule without a fleet scan.
``FedBuffAggregator`` (with ``rank_staleness``: the arrival order within
a rank bucket discounts) takes the configured
``ServerConfig.fedbuff_half_life`` when it sets none.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import flocora, messages
from repro_torch.core.aggregation import Aggregator, \
    ErrorFeedbackFedAvg, FedAvgAggregator, FedBuffAggregator, \
    ef_fold_dropped
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.quant import gaussian_epsilon
from repro_torch.fl.client import ClientConfig, cohort_steps, \
    make_cohort_trainer, pad_cohort_batches, pow2_pad, stack_cohort_batches
from repro_torch.fl.traces import FleetTrace
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_bytes, tree_map, tree_to

# rng key domain for client dropout draws: keyed by (seed, round, cid), as
# in the JAX package (traces.py owns 0xA1/0xA2)
TAG_FAILURE = 0xA3


@dataclasses.dataclass
class ServerConfig:
    rounds: int = 100
    n_clients: int = 100
    clients_per_round: int = 10
    oversample: float = 1.0        # straggler mitigation: dispatch K'=o*K
    p_client_failure: float = 0.0  # simulated client dropout
    seed: int = 0
    eval_every: int = 5
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    # FedBuff staleness half-life (staleness: the arrival rank within a
    # rank bucket in sync rounds, the version lag in the async engine),
    # given to a FedBuffAggregator that sets none
    fedbuff_half_life: float = 4.0


class WireAccounting:
    """Measured wire-byte cache, shared by the sync (:class:`FLServer`)
    and async (``fl/async_engine.AsyncFLServer``) engines. Message size
    is fixed by (rank, uplink density), so ONE measured emission per key
    is exact for the run.

    ``record_down``/``record_up``/``record_wasted`` also count each
    actual transfer in the obs registry (``wire.down_bytes`` /
    ``wire.up_bytes`` / ``wire.wasted_bytes`` by rank, density and
    reason), so the registry's view matches the TCC accounting.
    ``hetero=True`` truncates broadcasts per rank without a
    ``RankSchedule`` (a lazy Population carries its own rank tiers)."""

    def __init__(self, fcfg: FLoCoRAConfig,
                 registry: Optional[obsm.MetricsRegistry] = None,
                 hetero: bool = False):
        self.fcfg = fcfg
        self.registry = obsm.get_registry(registry)
        self.hetero = hetero
        self.down: dict[int, int] = {}
        self.up: dict[tuple[int, Optional[float]], int] = {}
        self.wasted = 0          # bytes of transfers that never
        #                          contributed (dropped, straggled or
        #                          churned)

    def bcast_rank(self, rank: int) -> Optional[int]:
        """The rank a broadcast is truncated to; None (no resize walk)
        keeps a uniform fleet's broadcast the classic one."""
        if self.hetero or self.fcfg.rank_schedule is not None:
            return rank
        return None

    def downlink_bytes(self, global_train: Any, rank: int) -> int:
        got = self.down.get(rank)
        if got is None:
            msg = flocora.server_downlink(global_train, self.fcfg,
                                          self.bcast_rank(rank))
            got = messages.packed_wire_bytes(msg)
            self.down[rank] = got
        return got

    def uplink_bytes(self, rank: int, msg: Any = None,
                     density: Optional[float] = None) -> Optional[int]:
        """None when no uplink was emitted at this (rank, density) yet."""
        got = self.up.get((rank, density))
        if got is None and msg is not None:
            got = messages.packed_wire_bytes(msg)
            self.up[(rank, density)] = got
        return got

    # -- labeled transfer counters (one call per actual transfer) -----------
    def record_down(self, rank: int, nbytes: int) -> None:
        self.registry.inc("wire.down_bytes", nbytes, rank=rank)
        self.registry.inc("wire.downlinks", rank=rank)

    def record_up(self, rank: int, nbytes: int,
                  density: Optional[float] = None) -> None:
        self.registry.inc("wire.up_bytes", nbytes, rank=rank,
                          density=density)
        self.registry.inc("wire.uplinks", rank=rank, density=density)

    def record_wasted(self, rank: int, nbytes: int,
                      reason: str = "straggled") -> None:
        """Bytes that were transferred but never reached the global
        model: a dropped or churned client's downlink, a straggler's
        round trip. Already counted in down/up bytes; this is the waste
        view."""
        self.wasted += nbytes
        self.registry.inc("wire.wasted_bytes", nbytes, rank=rank,
                          reason=reason)


class FLServer:
    """Simulates the paper's FL loop over a model given as
    ``{"frozen": tree, "train": tree}`` of tensors; ``loss_fn(frozen,
    train, batch) -> (loss, metrics)``; ``client_data`` is a list of
    per-client dict datasets (numpy) or a lazy ``Population``;
    ``eval_fn(frozen, train) -> metrics dict``. The model moves to
    ``device``, which defaults to the card. ``aggregator`` defaults to
    FedAvg, or its error-feedback variant when ``fcfg.error_feedback``
    is set (a given one must agree with that flag; with a mixed
    ``fcfg.rank_schedule`` it must have a rank-bucketed path, a
    ``FedAvgAggregator`` such as ``SVDRecombinationAggregator`` or a
    ``FedBuffAggregator``, whose ``r_target`` is at least the schedule's
    max rank). ``trace`` (a ``FleetTrace``) orders deadline cohorts.
    ``registry``/``tracer`` default to the process-global obs instances
    (off until ``obs.enable()``).

    ``run_round`` is the RANK-BUCKETED ENGINE: one vmapped cohort call
    a rank bucket, from the broadcast truncated to that rank (one bucket
    at the server rank in a uniform fleet)."""

    def __init__(self, model: dict, loss_fn: Callable,
                 client_data: list[dict], scfg: ServerConfig,
                 ccfg: ClientConfig, fcfg: FLoCoRAConfig,
                 eval_fn: Optional[Callable] = None,
                 aggregator: Optional[Aggregator] = None,
                 trace: Optional[FleetTrace] = None,
                 registry: Optional[obsm.MetricsRegistry] = None,
                 tracer: Optional[obst.Tracer] = None, device="cuda"):
        self.device = resolve_device(device)
        self.frozen = tree_to(model["frozen"], self.device)
        self.global_train = tree_to(model["train"], self.device)
        self.loss_fn = loss_fn
        self.client_data = client_data
        self.scfg, self.ccfg, self.fcfg = scfg, ccfg, fcfg
        self.eval_fn = eval_fn
        self.trace = trace
        self.rng = np.random.default_rng(scfg.seed)
        self.round = 0
        self.history: list[dict] = []
        self.trainer = make_cohort_trainer(loss_fn, ccfg)
        # fixed schedule length across ALL clients (smaller clients are
        # masked, not over-trained); a lazy Population knows its own in
        # O(1), an eager fleet is scanned
        self.cohort_schedule_steps = client_data.schedule_steps(ccfg) \
            if hasattr(client_data, "schedule_steps") \
            else cohort_steps(client_data, ccfg)
        self.registry = obsm.get_registry(registry)
        self.tracer = obst.get_tracer(tracer)
        self.rank_schedule = fcfg.rank_schedule
        # a lazy Population's device tiers give the ranks; a RankSchedule
        # overrides them
        self._pop_ranks = None
        if self.rank_schedule is None and hasattr(client_data, "rank_for"):
            if client_data.max_rank > fcfg.rank:
                raise ValueError(
                    f"population max tier rank {client_data.max_rank} "
                    f"exceeds the server rank {fcfg.rank}")
            self._pop_ranks = client_data
        if self.rank_schedule is not None \
                and self.rank_schedule.n_clients != scfg.n_clients:
            raise ValueError(
                f"rank_schedule covers {self.rank_schedule.n_clients} "
                f"clients, server has {scfg.n_clients}")
        # EF engages when the uplink is lossy: quantized and/or sparse (a
        # sparse fp wire still drops mass to compensate)
        ef_wanted = fcfg.error_feedback and (fcfg.qcfg.enabled
                                             or fcfg.sparsity_active)
        if aggregator is None:
            aggregator = ErrorFeedbackFedAvg(fcfg.qcfg, fcfg.rank) \
                if ef_wanted else FedAvgAggregator(fcfg.qcfg, fcfg.rank)
        elif ef_wanted != isinstance(aggregator, ErrorFeedbackFedAvg):
            # the uplink encode (fcfg.error_feedback) and the residual
            # store (the aggregator's type) must agree, or EF silently
            # degrades to plain rounding or keeps dead residuals
            raise ValueError(
                "error_feedback={} (quant {}) requires {} aggregator, got "
                "{}".format(fcfg.error_feedback,
                            "on" if fcfg.qcfg.enabled else "off",
                            "an ErrorFeedbackFedAvg" if ef_wanted
                            else "a non-EF",
                            type(aggregator).__name__))
        if isinstance(aggregator, FedBuffAggregator) \
                and aggregator.half_life is None:
            # the half-life is a config field: thread it on a copy, so
            # the caller's instance (and its buffer) is not shared
            aggregator = dataclasses.replace(
                aggregator, half_life=scfg.fedbuff_half_life,
                pending=list(aggregator.pending))
        sched = fcfg.rank_schedule
        if sched is not None:
            mixed = (len(set(sched.client_ranks)) > 1
                     or sched.max_rank != fcfg.rank
                     or sched.anneal_every > 0)
            if mixed and not isinstance(
                    aggregator, (FedAvgAggregator, FedBuffAggregator)):
                # only an aggregator with a rank-bucketed path may see a
                # mixed-rank cohort: fail here, not with a shape error
                # mid-round
                raise ValueError(
                    f"{type(aggregator).__name__} has no rank-bucketed "
                    "aggregation path for mixed-rank cohorts; use "
                    "FedAvgAggregator (or a subclass such as "
                    "SVDRecombinationAggregator) or FedBuffAggregator")
            explicit = getattr(aggregator, "r_target", None)
            if explicit is not None and explicit < sched.max_rank:
                # a target below a scheduled rank would let the global
                # tree's shape float with each round's cohort
                raise ValueError(
                    f"aggregator r_target={explicit} is below the rank "
                    f"schedule's max rank {sched.max_rank}")
        if getattr(aggregator, "r_target", 0) is None:
            # pin the global tree's rank on a copy, so the caller's
            # instance (its residuals and served ranks) is not shared
            fields: dict[str, Any] = {"r_target": fcfg.rank}
            if hasattr(aggregator, "residuals"):
                fields["residuals"] = dict(aggregator.residuals)
            if hasattr(aggregator, "served_ranks"):
                fields["served_ranks"] = dict(aggregator.served_ranks)
            if hasattr(aggregator, "pending"):
                fields["pending"] = list(aggregator.pending)
            aggregator = dataclasses.replace(aggregator, **fields)
        self.aggregator = aggregator
        self.ckpt = CheckpointManager(scfg.checkpoint_dir) \
            if scfg.checkpoint_dir else None
        hetero = self._pop_ranks is not None and self._pop_ranks.mixed_ranks
        self.wire = WireAccounting(fcfg, registry=self.registry,
                                   hetero=hetero)
        self.initial_model_bytes = tree_bytes(self.frozen)
        self._tcc_cum = self.initial_model_bytes

    @property
    def round_bytes_per_client(self) -> int:
        """2x the MEASURED one-way message size at the server rank."""
        return 2 * self._downlink_bytes(self.fcfg.rank)

    def _rank_for(self, cid: int, rnd: int) -> int:
        if self.rank_schedule is not None:
            return self.rank_schedule.rank_for(cid, rnd)
        if self._pop_ranks is not None:
            return self._pop_ranks.rank_for(cid)
        return self.fcfg.rank

    def _dp_epsilon(self) -> Optional[float]:
        """The (eps, delta) spent after this many rounds (one Gaussian
        release per round, conservative RDP composition); None without
        DP."""
        dp = self.fcfg.dp
        if dp is None:
            return None
        return gaussian_epsilon(dp.noise_multiplier, self.round, dp.delta)

    def _client_failed(self, rnd: int, cid: int) -> bool:
        """Keyed dropout draw, a pure function of (seed, round, cid)."""
        p = self.scfg.p_client_failure
        if p <= 0.0:
            return False
        rng = np.random.default_rng(
            [self.scfg.seed, TAG_FAILURE, rnd, cid])
        return bool(rng.random() < p)

    def _downlink_bytes(self, rank: int) -> int:
        return self.wire.downlink_bytes(self.global_train, rank)

    def _uplink_bytes(self, rank: int, msg: Any = None,
                      density: Optional[float] = None) -> int:
        got = self.wire.uplink_bytes(rank, msg, density)
        if got is None:               # no uplink emitted yet at this rank
            return self._downlink_bytes(rank)
        return got

    def _batches_to_device(self, batches: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batches.items()}

    # -- fault tolerance ----------------------------------------------------
    def save(self) -> None:
        """Checkpoint (round, global adapters, TCC so far, the sampler's
        bit-generator state) in the JAX package's format."""
        if self.ckpt is None:
            return
        self.ckpt.save(self.round, {"train": self.global_train},
                       metadata={"round": self.round,
                                 "tcc_bytes": self._tcc_cum,
                                 "rng_state": self.rng.bit_generator.state})

    def try_resume(self) -> bool:
        """Continue from the newest checkpoint, if there is one; the
        global adapters land on this server's device."""
        if self.ckpt is None:
            return False
        got = self.ckpt.restore_latest({"train": self.global_train},
                                       device=self.device)
        if got is None:
            return False
        _, trees, man = got
        self.global_train = trees["train"]
        self.round = man["metadata"]["round"]
        # manifests from before measured TCC: rebuild per Eq. 2
        self._tcc_cum = man["metadata"].get(
            "tcc_bytes",
            self.initial_model_bytes
            + self.round * self.scfg.clients_per_round
            * self.round_bytes_per_client)
        st = man["metadata"].get("rng_state")
        if isinstance(st, str):
            # older manifests stored repr(state): a plain dict literal
            st = ast.literal_eval(st)
        if st:
            self.rng.bit_generator.state = st
        return True

    def _maybe_save(self) -> None:
        if self.ckpt and self.round % self.scfg.checkpoint_every == 0:
            self.save()

    # -- one round (paper Fig. 1) --------------------------------------------
    def run_round(self) -> dict:
        scfg, fcfg = self.scfg, self.fcfg
        rnd = self.round                      # schedules are 0-based
        k_target = scfg.clients_per_round
        k_dispatch = max(k_target, int(round(scfg.oversample * k_target)))
        sampled = self.rng.choice(scfg.n_clients, size=k_dispatch,
                                  replace=False)
        rank_of = {int(cid): self._rank_for(int(cid), rnd)
                   for cid in sampled}
        density = fcfg.uplink_density(rnd)
        self.registry.inc("fl.rounds")
        # (1) broadcast precedes failure: every dispatched client spends
        # its downlink, at its own rank
        down_bytes = 0
        for r in rank_of.values():
            b = self._downlink_bytes(r)
            down_bytes += b
            self.wire.record_down(r, b)
        survivors = [cid for cid in (int(c) for c in sampled)
                     if not self._client_failed(rnd, cid)]
        self.registry.inc("fl.clients_dropped", k_dispatch - len(survivors))
        self.registry.observe("fl.cohort_size", len(survivors))
        wasted_bytes = 0
        for cid in (int(c) for c in sampled):
            if cid not in survivors:
                b = self._downlink_bytes(rank_of[cid])
                wasted_bytes += b
                self.wire.record_wasted(rank_of[cid], b, reason="dropped")
        if not survivors:
            self.round += 1
            self._tcc_cum += down_bytes
            rec = {"round": self.round, "n_agg": 0,
                   "n_dropped": k_dispatch, "n_straggled": 0,
                   "client_loss": float("nan"), "cohort_ranks": {},
                   "down_bytes": down_bytes, "up_bytes": 0,
                   "round_bytes": down_bytes, "tcc_bytes": self._tcc_cum,
                   "wasted_bytes": wasted_bytes,
                   "uplink_density": density}
            if fcfg.dp is not None:
                rec["dp_epsilon"] = self._dp_epsilon()
            self.history.append(rec)
            self._maybe_save()
            return rec

        # (2)+(3) the rank-bucketed engine: the survivors group by rank
        # and each bucket trains as ONE vmapped program from the
        # broadcast truncated to its rank; then every client packs its
        # uplink at its own rank
        buckets: dict[int, list[int]] = {}
        for cid in survivors:
            buckets.setdefault(rank_of[cid], []).append(cid)
        if self.trace is not None:
            # DEADLINE COHORTS: arrival order from the fleet trace at the
            # client's rank and measured round-trip bytes, keyed (seed,
            # cid, round); the sampler stream is not drawn
            latency = {cid: self.trace.arrival(
                cid, rnd, rank_of[cid],
                2 * self._downlink_bytes(rank_of[cid]), 0.0)
                for cid in survivors}
        else:
            # the reference draws one latency per survivor from the
            # sampler stream BEFORE the buckets gather their batches, in
            # ascending rank order; the order is the parity contract
            latency = {cid: self.rng.exponential(1.0) for cid in survivors}
        ef = isinstance(self.aggregator, ErrorFeedbackFedAvg)
        results = []
        for r in sorted(buckets):
            cids = buckets[r]
            with self.tracer.span("fl/broadcast", track="fl/round",
                                  round=rnd, rank=r, clients=len(cids)):
                g_bcast = flocora.broadcast(self.global_train, fcfg,
                                            rank=self.wire.bcast_rank(r))
                datas = [self.client_data[cid] for cid in cids]
                batches, n_steps = stack_cohort_batches(
                    self.rng, datas, self.ccfg,
                    steps=self.cohort_schedule_steps)
                if self.rank_schedule is not None:
                    # pow2-padded buckets bound the distinct shapes of a
                    # mixed fleet; a uniform fleet keeps exactly K
                    batches, n_steps = pad_cohort_batches(
                        batches, n_steps, pow2_pad(len(cids)))
                batches = self._batches_to_device(batches)
            with self.tracer.span("fl/client_train", track="fl/round",
                                  round=rnd, rank=r, clients=len(cids)):
                trained, losses = self.trainer(
                    self.frozen, g_bcast, batches,
                    torch.from_numpy(n_steps).to(self.device))
                losses = losses.cpu().numpy()
            with self.tracer.span("fl/pack", track="fl/round", round=rnd,
                                  rank=r, clients=len(cids)):
                for k, cid in enumerate(cids):
                    t_k = tree_map(lambda x: x[k], trained)
                    res = self.aggregator.residual(cid, t_k) if ef else None
                    # start/dp_key engage only with fcfg.dp: the delta
                    # against the broadcast is clipped and noised, keyed
                    # (round, cid), before quantization
                    msg, res = flocora.client_uplink(
                        t_k, fcfg, res, rnd=rnd, start=g_bcast,
                        dp_key=(rnd, cid), dp_seed=scfg.seed)
                    n_i = len(next(iter(datas[k].values())))
                    results.append((latency[cid], n_i, msg,
                                    float(losses[k]), r, cid, res))

        # every survivor transmitted its uplink (stragglers included)
        with self.tracer.span("fl/uplink", track="fl/round", round=rnd,
                              clients=len(results)):
            up_bytes = 0
            for r_i in results:
                b = self._uplink_bytes(r_i[4], r_i[2], density)
                up_bytes += b
                self.wire.record_up(r_i[4], b, density)
        # straggler policy: first K arrivals win; a straggler's whole
        # round trip was wasted
        results.sort(key=lambda r: r[0])
        kept = results[:k_target]
        self.registry.inc("fl.clients_straggled", len(results) - len(kept))
        for r_i in results[k_target:]:
            b = self._downlink_bytes(r_i[4]) \
                + self._uplink_bytes(r_i[4], density=density)
            wasted_bytes += b
            self.wire.record_wasted(r_i[4], b, reason="straggled")
        if ef:
            # residuals commit AFTER the straggler cut: a kept client's
            # residual presumes delivery; a straggler's message was
            # discarded, so its reconstruction folds back into the
            # residual and the next uplink re-ships the lost mass
            for rec_i in kept:
                self.aggregator.store_residual(rec_i[5], rec_i[6])
            for rec_i in results[k_target:]:
                self.aggregator.store_residual(
                    rec_i[5], ef_fold_dropped(rec_i[6], rec_i[2]))
        weights = torch.tensor([float(r[1]) for r in kept],
                               dtype=torch.float32)
        # (4) FedAvg over the packed messages on the fused kernels, per
        # rank bucket when the cohort is mixed
        with self.tracer.span("fl/aggregate", track="fl/round", round=rnd,
                              n_agg=len(kept)):
            self.global_train = self.aggregator.aggregate(
                [r[2] for r in kept], weights)
        self.round += 1

        self._tcc_cum += down_bytes + up_bytes
        kept_ranks: dict[int, int] = {}
        for r in kept:
            kept_ranks[r[4]] = kept_ranks.get(r[4], 0) + 1
        rec = {"round": self.round, "n_agg": len(kept),
               "n_dropped": k_dispatch - len(results),
               "n_straggled": len(results) - len(kept),
               "client_loss": float(np.mean([r[3] for r in kept])),
               "cohort_ranks": kept_ranks,
               "down_bytes": down_bytes, "up_bytes": up_bytes,
               "round_bytes": down_bytes + up_bytes,
               "tcc_bytes": self._tcc_cum,
               "wasted_bytes": wasted_bytes,
               "uplink_density": density}
        if fcfg.dp is not None:
            rec["dp_epsilon"] = self._dp_epsilon()
            self.registry.set("fl.dp_epsilon", rec["dp_epsilon"])
        if fcfg.qcfg.enabled or density is not None:
            rec["up_bytes_measured"] = self._uplink_bytes(
                max(kept_ranks, key=kept_ranks.get), density=density)
            rec["up_bytes_by_rank"] = {
                r: b for (r, d), b in self.wire.up.items() if d == density}
        if self.eval_fn and self.round % self.scfg.eval_every == 0:
            rec.update(self.eval_fn(self.frozen, self.global_train))
        self.history.append(rec)
        self._maybe_save()
        return rec

    def run(self, rounds: Optional[int] = None) -> list[dict]:
        for _ in range(rounds or self.scfg.rounds):
            self.run_round()
        return self.history
