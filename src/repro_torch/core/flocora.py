"""FLoCoRA high-level API (paper §III, Fig. 1).

One communication round:
  (1) server broadcasts the global adapter tree     (quantized)
  (2) each sampled client k trains locally
  (3) client uploads its adapter tree                (quantized)
  (4) server FedAvg-aggregates: sum_k (n_k/n) * adapters_k

The base model is exchanged once and never updated. Orchestration
(sampling, stragglers, faults) lives in ``repro_torch.fl``.

The port carries the paper's uniform setting (one rank for every
client, a dense uplink) on either wire, the flat tree (default) or the
per-leaf oracle, with optional error feedback on the uplink. Sparse
uplinks, differential privacy and rank schedules are options of the JAX
package that are not ported; setting one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core import aggregation, messages
from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class FLoCoRAConfig:
    rank: int = 32
    alpha: float = 512.0            # paper default: alpha = 16 * r
    quant_bits: Optional[int] = None  # None | 8 | 4 | 2
    error_feedback: bool = False    # EF on the client uplink
    head_mode: str = "dense"        # 'dense' (paper) | 'lora' | 'frozen'
    rank_schedule: Any = None
    sparsity: Any = None
    # flat-tree wire codec: one fused kernel launch per message; False
    # selects the per-leaf codec (one launch per packed leaf), with
    # byte-identical wire payloads
    flat_wire: bool = True
    dp: Any = None

    def __post_init__(self):
        unported = {"rank_schedule": self.rank_schedule is not None,
                    "sparsity": self.sparsity is not None,
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
                  ef_residual: Optional[Any] = None,
                  rnd: int = 0) -> tuple[Any, Optional[Any]]:
    """Step (3): one client's WIRE message (packed when quantization is
    on, the fp tree otherwise). With error feedback on, the client sends
    Q(x + e) and keeps e' = (x + e) - deq(message); pass its stored
    residual (None starts from zeros). Returns (message, residual)."""
    density = cfg.uplink_density(rnd)
    if cfg.error_feedback and cfg.qcfg.enabled:
        if ef_residual is None:
            ef_residual = aggregation.ef_init(trainable)
        return aggregation.ef_encode_packed(trainable, ef_residual,
                                            cfg.qcfg, density=density,
                                            flat=cfg.flat_wire)
    if not cfg.qcfg.enabled:
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


def fleet_tcc_bytes(trainable: Any, cfg: FLoCoRAConfig, rounds: int) -> int:
    """Fleet-level TCC. In the uniform setting (no rank schedule, a
    dense uplink; the only one ported) it is Eq. 2."""
    return messages.tcc_bytes(trainable, cfg.qcfg, rounds)
