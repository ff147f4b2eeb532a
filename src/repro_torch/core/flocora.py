"""FLoCoRA high-level API (paper §III, Fig. 1).

One communication round:
  (1) server broadcasts the global adapter tree     (quantized)
  (2) each sampled client k trains locally
  (3) client uploads its adapter tree                (quantized)
  (4) server FedAvg-aggregates: sum_k (n_k/n) * adapters_k

The base model is exchanged once and never updated. Orchestration
(sampling, stragglers, faults) lives in ``repro_torch.fl``.

The port carries the paper's uniform setting: one rank for every client,
a dense uplink, the flat-tree wire. Error feedback, sparse uplinks,
differential privacy, rank schedules and the per-leaf wire are options
of the JAX package that are not ported; setting one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core import messages
from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class FLoCoRAConfig:
    rank: int = 32
    alpha: float = 512.0            # paper default: alpha = 16 * r
    quant_bits: Optional[int] = None  # None | 8 | 4 | 2
    error_feedback: bool = False
    rank_schedule: Any = None
    sparsity: Any = None
    flat_wire: bool = True
    dp: Any = None

    def __post_init__(self):
        unported = {"error_feedback": self.error_feedback,
                    "rank_schedule": self.rank_schedule is not None,
                    "sparsity": self.sparsity is not None,
                    "flat_wire=False": not self.flat_wire,
                    "dp": self.dp is not None}
        got = [k for k, on in unported.items() if on]
        if got:
            raise NotImplementedError(
                f"FLoCoRAConfig options not ported to repro_torch: {got}")

    @property
    def qcfg(self) -> QuantConfig:
        return QuantConfig(bits=self.quant_bits)

    def uplink_density(self, rnd: int = 0) -> Optional[float]:
        """Round ``rnd``'s uplink density; None = dense wire."""
        return None

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _uniform(rank: Optional[int]) -> None:
    if rank is not None:
        raise NotImplementedError(
            "per-client rank truncation is not ported (rank must be None)")


def server_downlink(global_trainable: Any, cfg: FLoCoRAConfig,
                    rank: Optional[int] = None) -> Any:
    """Step (1), wire form: the packed message the server broadcasts (the
    fp tree when quantization is off)."""
    _uniform(rank)
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
                  rnd: int = 0) -> tuple[Any, None]:
    """Step (3): one client's WIRE message (the packed flat message when
    quantization is on, the fp tree otherwise). Returns (message, None):
    the second slot is the JAX package's error-feedback residual, which
    the port does not carry."""
    if not cfg.qcfg.enabled:
        return trainable, None
    return messages.pack_message(trainable, cfg.qcfg,
                                 density=cfg.uplink_density(rnd),
                                 flat=cfg.flat_wire), None


def client_wire_bytes(trainable: Any, cfg: FLoCoRAConfig,
                      rank: Optional[int] = None,
                      density: Optional[float] = None) -> int:
    """One direction of one round (static accounting over the adapter
    shapes)."""
    _uniform(rank)
    return messages.message_wire_bytes(trainable, cfg.qcfg, density)


def round_wire_bytes(trainable: Any, cfg: FLoCoRAConfig,
                     rank: Optional[int] = None, rnd: int = 0) -> dict:
    """Per-round, PER-CLIENT message accounting (both directions are
    equal on the dense wire)."""
    down = client_wire_bytes(trainable, cfg, rank)
    up = client_wire_bytes(trainable, cfg, rank,
                           density=cfg.uplink_density(rnd))
    return {"down_bytes": down, "up_bytes": up, "round_bytes": down + up}


def tcc(trainable: Any, cfg: FLoCoRAConfig, rounds: int) -> int:
    """Paper Eq. 2: total communication cost for one client, R rounds."""
    return messages.tcc_bytes(trainable, cfg.qcfg, rounds)
