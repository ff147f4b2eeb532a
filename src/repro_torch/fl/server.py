"""FL server orchestration: the synchronous FLoCoRA round (paper Fig. 1).

One round samples K' = oversample*K clients, broadcasts the packed global
adapters, trains the survivors locally, packs every uplink, keeps the
first K arrivals (simulated latency order) and FedAvg-reduces their
packed messages in one fused kernel launch. Client dropout is keyed by
(seed, round, cid). Wire bytes are MEASURED from the serialized
messages.

The engine's numpy RNG stream is consumed exactly as the JAX package's
(``repro/fl/server.py``) consumes it: ``rng.choice`` for the cohort, one
``rng.exponential`` per survivor for its latency, then
``stack_cohort_batches``. Both packages therefore sample the same
cohorts and batches from one seed.

Not ported (each raises at construction): a FleetTrace, a lazy
Population, checkpointing, and the FLoCoRAConfig options listed in
``core/flocora.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import flocora, messages
from repro_torch.core.aggregation import FedAvgAggregator
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.fl.client import ClientConfig, cohort_steps, \
    make_cohort_trainer, stack_cohort_batches
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_bytes, tree_to

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
    checkpoint_dir: Optional[str] = None

    def __post_init__(self):
        if self.checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpointing is not ported to repro_torch")


class WireAccounting:
    """Measured wire-byte cache. Message size is fixed by (rank, uplink
    density), so ONE measured emission per key is exact for the run."""

    def __init__(self, fcfg: FLoCoRAConfig):
        self.fcfg = fcfg
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


class FLServer:
    """Simulates the paper's FL loop over a model given as
    ``{"frozen": tree, "train": tree}`` of tensors; ``loss_fn(frozen,
    train, batch) -> (loss, metrics)``; ``client_data`` is a list of
    per-client dict datasets (numpy). The model moves to ``device``,
    which defaults to the card."""

    def __init__(self, model: dict, loss_fn: Callable,
                 client_data: list[dict], scfg: ServerConfig,
                 ccfg: ClientConfig, fcfg: FLoCoRAConfig,
                 trace: Optional[Any] = None, device="cuda"):
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
        self.rng = np.random.default_rng(scfg.seed)
        self.round = 0
        self.history: list[dict] = []
        self.trainer = make_cohort_trainer(loss_fn, ccfg)
        # fixed schedule length across ALL clients (smaller clients are
        # masked, not over-trained)
        self.cohort_schedule_steps = cohort_steps(client_data, ccfg)
        self.aggregator = FedAvgAggregator(fcfg.qcfg, fcfg.rank)
        self.wire = WireAccounting(fcfg)
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
        # (1) broadcast precedes failure: every dispatched client spends
        # its downlink
        down_bytes = k_dispatch * self._downlink_bytes(rank)
        survivors = [cid for cid in (int(c) for c in sampled)
                     if not self._client_failed(rnd, cid)]
        wasted_bytes = (k_dispatch - len(survivors)) \
            * self._downlink_bytes(rank)
        if not survivors:
            self.wire.wasted += wasted_bytes
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
            return rec

        # the reference draws one latency per survivor from the sampler
        # stream BEFORE gathering batches; the order is the parity
        # contract
        latency = {cid: self.rng.exponential(1.0) for cid in survivors}
        # (2) local training on the broadcast, (3) packed uplinks
        g_bcast = flocora.broadcast(self.global_train, fcfg)
        datas = [self.client_data[cid] for cid in survivors]
        batches, n_steps = stack_cohort_batches(
            self.rng, datas, self.ccfg, steps=self.cohort_schedule_steps)
        trained, losses = self.trainer(self.frozen, g_bcast,
                                       self._batches_to_device(batches),
                                       n_steps)
        losses = losses.cpu().numpy()
        results = []
        for k, cid in enumerate(survivors):
            msg, _ = flocora.client_uplink(trained[k], fcfg, rnd=rnd)
            n_i = len(next(iter(datas[k].values())))
            results.append((latency[cid], n_i, msg, float(losses[k]),
                            rank, cid))

        # every survivor transmitted its uplink (stragglers included)
        up_bytes = sum(self._uplink_bytes(r_i[4], r_i[2], density)
                       for r_i in results)
        # straggler policy: first K arrivals win
        results.sort(key=lambda r: r[0])
        kept = results[:k_target]
        wasted_bytes += (len(results) - len(kept)) * (
            self._downlink_bytes(rank)
            + self._uplink_bytes(rank, density=density))
        self.wire.wasted += wasted_bytes
        weights = torch.tensor([float(r[1]) for r in kept],
                               dtype=torch.float32)
        # (4) FedAvg over the packed messages: one fused kernel launch
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
        self.history.append(rec)
        return rec

    def run(self, rounds: Optional[int] = None) -> list[dict]:
        for _ in range(rounds or self.scfg.rounds):
            self.run_round()
        return self.history
