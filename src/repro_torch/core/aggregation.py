"""Server-side aggregation for FLoCoRA (paper Eq. 1).

FLoCoRA is aggregation-agnostic (paper §III): clients exchange adapter
parameter trees, so any parameter-averaging rule applies unchanged.
Ported here:

  * ``fedavg`` — the n_k/n weighted mean of fp trees;
  * ``fedavg_packed`` — the wire-true path for flat packed messages: the
    whole K-client cohort unpacks, dequantizes and reduces in ONE
    ``dequant_agg_rows`` launch (``core/flat.py``);
  * ``FedAvgAggregator`` — the strategy ``FLServer`` calls, for a
    uniform-rank cohort.

Heterogeneous-rank, FedBuff, SVD recombination and error feedback are
not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import flat as flatcodec
from repro_torch.core import lora
from repro_torch.core.flat import is_flat_message
from repro_torch.core.quant import QuantConfig
from repro_torch.utils.tree import tree_map


def stack_trees(trees: list[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def fedavg(stacked: Any, weights) -> Any:
    """Weighted mean over the leading client axis."""
    def mean(x):
        w = torch.as_tensor(weights, dtype=torch.float32).to(x.device)
        w = w / torch.sum(w)
        wr = w.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.sum(x.to(torch.float32) * wr, dim=0).to(x.dtype)

    return tree_map(mean, stacked)


def fedavg_packed(msgs: list[Any], weights) -> Any:
    """Weighted mean over K flat packed messages sharing one layout, in
    one fused kernel launch. Per-leaf and sparse messages are not
    ported."""
    if not (msgs and all(is_flat_message(m) for m in msgs)
            and len({m.layout for m in msgs}) == 1):
        raise NotImplementedError(
            "only flat messages of one layout aggregate in repro_torch")
    return flatcodec.fedavg_packed_flat(msgs, weights)


@dataclasses.dataclass
class FedAvgAggregator:
    """Paper Eq. 1 over a uniform-rank cohort. Packed inputs run on the
    fused ``dequant_agg_rows`` kernel after a bit-width check against
    ``qcfg``; fp inputs take ``fedavg`` over the stacked trees. A cohort
    whose ranks differ from each other or from ``r_target`` raises: the
    rank-bucketed path is not ported."""
    qcfg: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    r_target: Optional[int] = None

    def aggregate(self, msgs: list[Any], weights) -> Any:
        m0 = msgs[0]
        if is_flat_message(m0) and self.qcfg.enabled \
                and m0.bits != self.qcfg.bits:
            raise ValueError(f"aggregator configured for {self.qcfg.bits}-"
                             f"bit messages, got {m0.bits}-bit payload")
        ranks = {r for m in msgs if (r := lora.tree_max_rank(m)) is not None}
        if len(ranks) > 1 or (ranks and self.r_target is not None
                              and ranks != {self.r_target}):
            raise NotImplementedError(
                f"mixed-rank cohorts (ranks {sorted(ranks)}, target "
                f"{self.r_target}) are not ported")
        if any(is_flat_message(m) for m in msgs):
            return fedavg_packed(msgs, weights)
        return fedavg(stack_trees(msgs), weights)
