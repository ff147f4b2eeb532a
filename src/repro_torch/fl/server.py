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

Local training runs the cohort as ONE vmapped program
(``fl/client.make_cohort_trainer``). ``eval_fn(frozen, train) -> dict``
is called on the new global adapters every ``eval_every`` rounds and
merged into the round's record, as in the JAX package.

Not ported (each raises at construction): a FleetTrace, a lazy
Population, and the FLoCoRAConfig options listed in
``core/flocora.py``.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import flocora, messages
from repro_torch.core.aggregation import ErrorFeedbackFedAvg, \
    FedAvgAggregator, ef_fold_dropped
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.fl.client import ClientConfig, cohort_steps, \
    make_cohort_trainer, stack_cohort_batches
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_bytes, tree_map, tree_to

# rng key domain for client dropout draws: keyed by (seed, round, cid), as
# in the JAX package
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


class WireAccounting:
    """Measured wire-byte cache. Message size is fixed by (rank, uplink
    density), so ONE measured emission per key is exact for the run.

    ``record_down``/``record_up``/``record_wasted`` also count each
    actual transfer in the obs registry (``wire.down_bytes`` /
    ``wire.up_bytes`` / ``wire.wasted_bytes`` by rank, density and
    reason), so the registry's view matches the TCC accounting."""

    def __init__(self, fcfg: FLoCoRAConfig,
                 registry: Optional[obsm.MetricsRegistry] = None):
        self.fcfg = fcfg
        self.registry = obsm.get_registry(registry)
        self.down: dict[int, int] = {}
        self.up: dict[tuple[int, Optional[float]], int] = {}
        self.wasted = 0          # bytes of transfers that never
        #                          contributed (dropped or straggled)

    def downlink_bytes(self, global_train: Any, rank: int) -> int:
        got = self.down.get(rank)
        if got is None:
            msg = flocora.server_downlink(global_train, self.fcfg)
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
        model: a dropped client's downlink, a straggler's round trip.
        Already counted in down/up bytes; this is the waste view."""
        self.wasted += nbytes
        self.registry.inc("wire.wasted_bytes", nbytes, rank=rank,
                          reason=reason)


class FLServer:
    """Simulates the paper's FL loop over a model given as
    ``{"frozen": tree, "train": tree}`` of tensors; ``loss_fn(frozen,
    train, batch) -> (loss, metrics)``; ``client_data`` is a list of
    per-client dict datasets (numpy); ``eval_fn(frozen, train) ->
    metrics dict``. The model moves to ``device``,
    which defaults to the card. ``aggregator`` defaults to FedAvg, or its
    error-feedback variant when ``fcfg.error_feedback`` is set (a given
    one must agree with that flag). ``registry``/``tracer`` default to
    the process-global obs instances (off until ``obs.enable()``)."""

    def __init__(self, model: dict, loss_fn: Callable,
                 client_data: list[dict], scfg: ServerConfig,
                 ccfg: ClientConfig, fcfg: FLoCoRAConfig,
                 eval_fn: Optional[Callable] = None,
                 aggregator: Optional[FedAvgAggregator] = None,
                 trace: Optional[Any] = None,
                 registry: Optional[obsm.MetricsRegistry] = None,
                 tracer: Optional[obst.Tracer] = None, device="cuda"):
        if trace is not None:
            raise NotImplementedError("FleetTrace deadline cohorts are not "
                                      "ported to repro_torch")
        if hasattr(client_data, "rank_for") \
                or hasattr(client_data, "schedule_steps"):
            raise NotImplementedError("lazy Population fleets are not "
                                      "ported to repro_torch")
        self.device = resolve_device(device)
        self.frozen = tree_to(model["frozen"], self.device)
        self.global_train = tree_to(model["train"], self.device)
        self.loss_fn = loss_fn
        self.client_data = client_data
        self.scfg, self.ccfg, self.fcfg = scfg, ccfg, fcfg
        self.eval_fn = eval_fn
        self.rng = np.random.default_rng(scfg.seed)
        self.round = 0
        self.history: list[dict] = []
        self.trainer = make_cohort_trainer(loss_fn, ccfg)
        # fixed schedule length across ALL clients (smaller clients are
        # masked, not over-trained)
        self.cohort_schedule_steps = cohort_steps(client_data, ccfg)
        self.registry = obsm.get_registry(registry)
        self.tracer = obst.get_tracer(tracer)
        # EF engages when the uplink is lossy (quantized)
        ef_wanted = fcfg.error_feedback and fcfg.qcfg.enabled
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
        if aggregator.r_target is None:
            # pin the global tree's rank on a copy, so the caller's
            # instance (and its residual store) is not shared
            fields: dict[str, Any] = {"r_target": fcfg.rank}
            if isinstance(aggregator, ErrorFeedbackFedAvg):
                fields["residuals"] = dict(aggregator.residuals)
            aggregator = dataclasses.replace(aggregator, **fields)
        self.aggregator = aggregator
        self.ckpt = CheckpointManager(scfg.checkpoint_dir) \
            if scfg.checkpoint_dir else None
        self.wire = WireAccounting(fcfg, registry=self.registry)
        self.initial_model_bytes = tree_bytes(self.frozen)
        self._tcc_cum = self.initial_model_bytes

    @property
    def round_bytes_per_client(self) -> int:
        """2x the MEASURED one-way message size at the server rank."""
        return 2 * self._downlink_bytes(self.fcfg.rank)

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
        rnd = self.round
        rank = fcfg.rank
        k_target = scfg.clients_per_round
        k_dispatch = max(k_target, int(round(scfg.oversample * k_target)))
        sampled = self.rng.choice(scfg.n_clients, size=k_dispatch,
                                  replace=False)
        density = fcfg.uplink_density(rnd)
        self.registry.inc("fl.rounds")
        # (1) broadcast precedes failure: every dispatched client spends
        # its downlink
        down_bytes = 0
        for _ in range(k_dispatch):
            b = self._downlink_bytes(rank)
            down_bytes += b
            self.wire.record_down(rank, b)
        survivors = [cid for cid in (int(c) for c in sampled)
                     if not self._client_failed(rnd, cid)]
        self.registry.inc("fl.clients_dropped", k_dispatch - len(survivors))
        self.registry.observe("fl.cohort_size", len(survivors))
        wasted_bytes = 0
        for cid in (int(c) for c in sampled):
            if cid not in survivors:
                b = self._downlink_bytes(rank)
                wasted_bytes += b
                self.wire.record_wasted(rank, b, reason="dropped")
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
            self.history.append(rec)
            self._maybe_save()
            return rec

        # the reference draws one latency per survivor from the sampler
        # stream BEFORE gathering batches; the order is the parity
        # contract
        latency = {cid: self.rng.exponential(1.0) for cid in survivors}
        ef = isinstance(self.aggregator, ErrorFeedbackFedAvg)
        # (2) local training on the broadcast, (3) packed uplinks
        with self.tracer.span("fl/broadcast", track="fl/round", round=rnd,
                              rank=rank, clients=len(survivors)):
            g_bcast = flocora.broadcast(self.global_train, fcfg)
            datas = [self.client_data[cid] for cid in survivors]
            batches, n_steps = stack_cohort_batches(
                self.rng, datas, self.ccfg,
                steps=self.cohort_schedule_steps)
            batches = self._batches_to_device(batches)
        with self.tracer.span("fl/client_train", track="fl/round",
                              round=rnd, rank=rank, clients=len(survivors)):
            trained, losses = self.trainer(
                self.frozen, g_bcast, batches,
                torch.from_numpy(n_steps).to(self.device))
            losses = losses.cpu().numpy()
        results = []
        with self.tracer.span("fl/pack", track="fl/round", round=rnd,
                              rank=rank, clients=len(survivors)):
            for k, cid in enumerate(survivors):
                t_k = tree_map(lambda x: x[k], trained)
                res = self.aggregator.residual(cid, t_k) if ef else None
                msg, res = flocora.client_uplink(t_k, fcfg, res, rnd=rnd)
                n_i = len(next(iter(datas[k].values())))
                results.append((latency[cid], n_i, msg, float(losses[k]),
                                rank, cid, res))

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
        # (4) FedAvg over the packed messages on the fused kernels
        with self.tracer.span("fl/aggregate", track="fl/round", round=rnd,
                              n_agg=len(kept)):
            self.global_train = self.aggregator.aggregate(
                [r[2] for r in kept], weights)
        self.round += 1

        self._tcc_cum += down_bytes + up_bytes
        rec = {"round": self.round, "n_agg": len(kept),
               "n_dropped": k_dispatch - len(results),
               "n_straggled": len(results) - len(kept),
               "client_loss": float(np.mean([r[3] for r in kept])),
               "cohort_ranks": {rank: len(kept)},
               "down_bytes": down_bytes, "up_bytes": up_bytes,
               "round_bytes": down_bytes + up_bytes,
               "tcc_bytes": self._tcc_cum,
               "wasted_bytes": wasted_bytes,
               "uplink_density": density}
        if fcfg.qcfg.enabled:
            rec["up_bytes_measured"] = self._uplink_bytes(rank,
                                                          density=density)
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
