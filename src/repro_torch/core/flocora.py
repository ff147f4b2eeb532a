"""FLoCoRA high-level API (paper §III, Fig. 1).

One communication round:
  (1) server broadcasts the global adapter tree     (quantized)
  (2) each sampled client k trains locally
  (3) client uploads its adapter tree                (quantized)
  (4) server FedAvg-aggregates: sum_k (n_k/n) * adapters_k

The base model is exchanged once and never updated. Orchestration
(sampling, stragglers, faults) lives in ``repro_torch.fl``.

The paper's setting is one rank for every client and a dense uplink, on
either wire: the flat tree (default) or the per-leaf oracle. Beyond the
paper, as in the JAX package: error feedback on the uplink; a
``RankSchedule`` of per-client ranks (the server holds the global
adapters at ``rank`` and truncates each broadcast to the receiving
client's rank); FLASC-style sparse uplinks (``SparsityConfig``); and
differential privacy on the uplink (``DPConfig``: the update delta
clipped and noised before quantization).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core import aggregation, lora, messages
from repro_torch.core.quant import DPConfig, QuantConfig, dp_privatize
from repro_torch.core.sparse import SparsityConfig
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class RankSchedule:
    """Per-client LoRA rank profile with optional round-wise annealing.

    ``client_ranks[cid]`` is client cid's base adapter rank. With
    ``anneal_every > 0`` every client's rank is multiplied by
    ``anneal_factor`` each ``anneal_every`` rounds (floored at
    ``min_rank``). The server holds the global adapters at its own
    rank; broadcasts truncate (slice) and uplinks arrive at each
    client's rank. The alpha/r scale is the server config's, shared by
    all clients, so mixed-rank products stay comparable."""
    client_ranks: tuple[int, ...]
    anneal_every: int = 0
    anneal_factor: float = 0.5
    min_rank: int = 2

    def __post_init__(self):
        if not self.client_ranks:
            raise ValueError("RankSchedule needs at least one client rank")
        if any(r < 1 for r in self.client_ranks):
            raise ValueError(f"ranks must be >= 1: {self.client_ranks}")
        if self.anneal_every < 0:
            raise ValueError("anneal_every must be >= 0")
        if not 0.0 < self.anneal_factor <= 1.0:
            raise ValueError("anneal_factor must be in (0, 1]")
        if self.min_rank < 1:
            raise ValueError("min_rank must be >= 1 (rank-0 adapters "
                             "cannot be packed)")

    @classmethod
    def uniform(cls, rank: int, n_clients: int, **kw) -> "RankSchedule":
        return cls(client_ranks=(rank,) * n_clients, **kw)

    @classmethod
    def tiered(cls, tiers: tuple[int, ...], n_clients: int,
               **kw) -> "RankSchedule":
        """Round-robin assignment of rank tiers over client ids."""
        return cls(client_ranks=tuple(tiers[i % len(tiers)]
                                      for i in range(n_clients)), **kw)

    @property
    def n_clients(self) -> int:
        return len(self.client_ranks)

    @property
    def max_rank(self) -> int:
        return max(self.client_ranks)

    def rank_for(self, cid: int, rnd: int = 0) -> int:
        """Client cid's rank at round ``rnd``. The ``min_rank`` floor
        binds annealed shrinkage only (effective floor ``min(min_rank,
        base)``), so an annealed rank never exceeds the base rank."""
        r = self.client_ranks[cid]
        if self.anneal_every > 0:
            r = max(min(self.min_rank, r),
                    int(r * self.anneal_factor ** (rnd // self.anneal_every)))
        return r

    def ranks_at(self, rnd: int) -> tuple[int, ...]:
        return tuple(self.rank_for(c, rnd)
                     for c in range(len(self.client_ranks)))


@dataclasses.dataclass(frozen=True)
class FLoCoRAConfig:
    rank: int = 32
    alpha: float = 512.0            # paper default: alpha = 16 * r
    quant_bits: Optional[int] = None  # None | 8 | 4 | 2
    error_feedback: bool = False    # EF on the client uplink
    head_mode: str = "dense"        # 'dense' (paper) | 'lora' | 'frozen'
    # per-client rank profile (None = every client trains at ``rank``)
    rank_schedule: Optional[RankSchedule] = None
    # top-k sparsification of the client UPLINK (None = dense wire);
    # downlinks always travel dense
    sparsity: Optional[SparsityConfig] = None
    # flat-tree wire codec: one fused kernel launch per message; False
    # selects the per-leaf codec (one launch per packed leaf), with
    # byte-identical wire payloads
    flat_wire: bool = True
    # DP on the uplink: clip the update delta and add Gaussian noise
    # before quantization (None = no DP)
    dp: Optional[DPConfig] = None

    def __post_init__(self):
        if self.dp is not None and self.dp.noise_multiplier > 0 \
                and self.error_feedback:
            raise ValueError(
                "dp noise and error_feedback are incompatible: the EF "
                "residual would accumulate (and compensate away) the DP "
                "noise across rounds, voiding the privacy guarantee")
        if self.rank_schedule is not None \
                and self.rank_schedule.max_rank > self.rank:
            raise ValueError(
                f"rank_schedule max rank {self.rank_schedule.max_rank} "
                f"exceeds the server rank {self.rank}")
        if self.sparsity is not None and self.sparsity.enabled \
                and self.sparsity.require_ef and not self.error_feedback:
            raise ValueError(
                "SparsityConfig(require_ef=True) needs error_feedback=True:"
                " FLASC keeps accuracy only when the dropped mass rides the"
                " EF residual; set require_ef=False to run sparse without"
                " EF (and accept the bias)")

    @property
    def qcfg(self) -> QuantConfig:
        return QuantConfig(bits=self.quant_bits)

    @property
    def sparsity_active(self) -> bool:
        """True when any round's uplink can be sparse."""
        return self.sparsity is not None and self.sparsity.enabled

    def uplink_density(self, rnd: int = 0) -> Optional[float]:
        """Round ``rnd``'s uplink density; None = dense wire."""
        if not self.sparsity_active:
            return None
        return self.sparsity.density_at(rnd)

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def server_downlink(global_trainable: Any, cfg: FLoCoRAConfig,
                    rank: Optional[int] = None) -> Any:
    """Step (1), wire form: the packed message the server broadcasts (the
    fp tree when quantization is off). ``rank`` resizes the global
    adapters to the receiving client's rank first (slice truncation:
    after an SVD recombination the components are energy-ordered, and a
    fresh zero-product adapter keeps its down factor)."""
    if rank is not None:
        global_trainable = lora.resize_tree_rank(global_trainable, rank,
                                                 method="slice")
    if not cfg.qcfg.enabled:
        return global_trainable
    return messages.pack_message(global_trainable, cfg.qcfg,
                                 flat=cfg.flat_wire)


def broadcast(global_trainable: Any, cfg: FLoCoRAConfig,
              rank: Optional[int] = None) -> Any:
    """Step (1): what clients reconstruct from the server message."""
    return messages.unpack_message(
        server_downlink(global_trainable, cfg, rank))


def client_uplink(trainable: Any, cfg: FLoCoRAConfig,
                  ef_residual: Optional[Any] = None,
                  rnd: int = 0, start: Optional[Any] = None,
                  dp_key: Optional[tuple] = None,
                  dp_seed: int = 0) -> tuple[Any, Optional[Any]]:
    """Step (3): one client's WIRE message: packed when quantization is
    on, sparse top-k when a ``sparsity`` profile is set (``rnd`` resolves
    the annealed density), the fp tree otherwise.

    With ``cfg.dp`` set, the update DELTA (``trainable - start``;
    ``start=None`` takes the base as zero) is clipped and noised BEFORE
    quantization and the wire carries ``start + privatized delta``.
    ``dp_key`` keys the noise draw (default ``(rnd,)``), ``dp_seed`` is
    the engine's seed.

    With error feedback on, the client sends Q(x + e) and keeps
    e' = (x + e) - deq(message), the top-k-dropped mass included; pass
    its stored residual (None starts from zeros). Returns (message,
    residual)."""
    if cfg.dp is not None:
        key = dp_key if dp_key is not None else (rnd,)
        if start is not None:
            delta = tree_map(lambda t, s: t - s, trainable, start)
            priv = dp_privatize(delta, cfg.dp, seed=dp_seed, key=key)
            trainable = tree_map(lambda s, p: s + p, start, priv)
        else:
            trainable = dp_privatize(trainable, cfg.dp, seed=dp_seed,
                                     key=key)
    density = cfg.uplink_density(rnd)
    wire_on = cfg.qcfg.enabled or (density is not None and density < 1.0)
    if cfg.error_feedback and wire_on:
        if ef_residual is None:
            ef_residual = aggregation.ef_init(trainable)
        return aggregation.ef_encode_packed(trainable, ef_residual,
                                            cfg.qcfg, density=density,
                                            flat=cfg.flat_wire)
    if not wire_on:
        return trainable, ef_residual
    return messages.pack_message(trainable, cfg.qcfg, density=density,
                                 flat=cfg.flat_wire), ef_residual


def server_round(stacked_client_trainables: Any, weights,
                 cfg: FLoCoRAConfig) -> Any:
    """Steps (3) + (4) in fp simulation: each raw client tree of the
    stacked (K, ...) leaves goes through the quantize/dequantize round
    trip, then FedAvg."""
    return aggregation.fedavg_quantized(stacked_client_trainables, weights,
                                        cfg.qcfg)


def client_wire_bytes(trainable: Any, cfg: FLoCoRAConfig,
                      rank: Optional[int] = None,
                      density: Optional[float] = None) -> int:
    """One direction of one round for a client at ``rank`` (static
    accounting over the resized adapter shapes); ``density`` selects the
    sparse-uplink accounting (None = dense)."""
    if rank is not None:
        trainable = lora.resize_tree_rank(trainable, rank, method="slice")
    return messages.message_wire_bytes(trainable, cfg.qcfg, density)


def round_wire_bytes(trainable: Any, cfg: FLoCoRAConfig,
                     rank: Optional[int] = None, rnd: int = 0) -> dict:
    """Per-round, PER-CLIENT message accounting. The two directions are
    equal on a dense wire; with a sparsity profile the uplink shrinks to
    the round's density (downlinks always travel dense)."""
    down = client_wire_bytes(trainable, cfg, rank)
    up = client_wire_bytes(trainable, cfg, rank,
                           density=cfg.uplink_density(rnd))
    return {"down_bytes": down, "up_bytes": up, "round_bytes": down + up}


def tcc(trainable: Any, cfg: FLoCoRAConfig, rounds: int) -> int:
    """Paper Eq. 2: total communication cost for one client, R rounds."""
    return messages.tcc_bytes(trainable, cfg.qcfg, rounds)


def fleet_tcc_bytes(trainable: Any, cfg: FLoCoRAConfig, rounds: int) -> int:
    """Fleet-level TCC: every client's uplinks and downlinks summed over
    every round of the schedule. Without a rank or sparsity profile it
    is Eq. 2; with one, sparse uplinks and dense downlinks are sized
    apart, round by round, so annealing is honored."""
    sched = cfg.rank_schedule
    if sched is None and not cfg.sparsity_active:
        return messages.tcc_bytes(trainable, cfg.qcfg, rounds)
    cache: dict[tuple, int] = {}

    def sized(r: Optional[int], density: Optional[float]) -> int:
        if (r, density) not in cache:
            cache[(r, density)] = client_wire_bytes(trainable, cfg, r,
                                                    density)
        return cache[(r, density)]

    total = 0
    for rnd in range(rounds):
        density = cfg.uplink_density(rnd)
        ranks = sched.ranks_at(rnd) if sched is not None else (None,)
        for r in ranks:
            total += sized(r, None) + sized(r, density)
    return total
