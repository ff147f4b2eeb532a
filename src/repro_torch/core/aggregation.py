"""Server-side aggregation for FLoCoRA (paper Eq. 1).

FLoCoRA is aggregation-agnostic (paper §III): clients exchange adapter
parameter trees, so any parameter-averaging rule applies unchanged.
Ported here:

  * ``fedavg`` — the n_k/n weighted mean of fp trees;
  * ``fedavg_quantized`` — the fp reference for the paper's pipeline:
    each client tree goes through the quantize/dequantize round trip
    before the weighted mean;
  * ``fedavg_packed`` — the wire-true path: flat messages reduce the
    whole K-client cohort in ONE ``dequant_agg_rows`` launch
    (``core/flat.py``); per-leaf messages reduce every packed leaf in ONE
    grouped ``dequant_agg`` launch;
  * error feedback — ``ef_init``/``ef_encode``/``ef_encode_packed``/
    ``ef_fold_dropped`` and ``ErrorFeedbackFedAvg``, which keeps each
    client's residual (EF21-style memory) as host numpy;
  * ``FedAvgAggregator`` — the strategy ``FLServer`` calls, for a
    uniform-rank cohort.

Heterogeneous-rank, FedBuff, SVD recombination and sparse leaves are not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import flat as flatcodec
from repro_torch.core import lora, messages
from repro_torch.core.flat import is_flat_message
from repro_torch.core.messages import is_packed_leaf, is_wire_leaf
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


def stack_trees(trees: list[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def _normalized(weights, device) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32).to(device)
    return w / torch.sum(w)


def _weighted_mean(xs: list, w: torch.Tensor) -> torch.Tensor:
    x = torch.stack([v.to(torch.float32) for v in xs])
    wr = w.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.sum(x * wr, dim=0).to(xs[0].dtype)


def fedavg(stacked: Any, weights) -> Any:
    """Weighted mean over the leading client axis."""
    def mean(x):
        w = _normalized(weights, x.device)
        wr = w.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.sum(x.to(torch.float32) * wr, dim=0).to(x.dtype)

    return tree_map(mean, stacked)


def fedavg_quantized(stacked: Any, weights, qcfg: QuantConfig) -> Any:
    """The paper's pipeline in fp simulation: every client tree of the
    stacked (K, ...) leaves goes through the round trip (per-client
    qparams, as on the wire), then the weighted mean."""
    if qcfg.enabled:
        k = len(weights)
        stacked = stack_trees([messages.roundtrip(
            tree_map(lambda x, i=i: x[i], stacked), qcfg) for i in range(k)])
    return fedavg(stacked, weights)


def _agg_packed(columns: list, w: torch.Tensor) -> list:
    """Every packed leaf position of K per-leaf messages (``columns``: the
    K leaves at each position) in ONE grouped ``dequant_agg`` launch a
    bit width, reading the payloads where they lie (no stack) and
    computing only each leaf's valid columns. Returns each packed
    position's fold in its leaf's shape and dtype, None elsewhere."""
    out = [None] * len(columns)
    packed = [i for i, col in enumerate(columns) if is_packed_leaf(col[0])]
    for bits in sorted({columns[i][0].bits for i in packed}):
        idx = [i for i in packed if columns[i][0].bits == bits]
        folds = kops.dequant_agg_leaves(
            [([(m.payload, m.scale, m.zp) for m in columns[i]],
              columns[i][0].n_per_channel) for i in idx], w, bits)
        for i, fold in zip(idx, folds):
            l0 = columns[i][0]
            out[i] = kops.from_channel_first_2d(
                fold, l0.shape, l0.per_stack).to(l0.dtype)
    return out


def fedavg_packed(msgs: list[Any], weights) -> Any:
    """Weighted mean over K packed wire messages, fused.

    Flat messages of one layout reduce the whole cohort in ONE
    ``dequant_agg_rows`` launch. Otherwise (per-leaf messages, or a
    buffer mixing flat and per-leaf ones: flat messages re-expose their
    per-leaf tree through ``as_tree``, bit-identical payload slices)
    every packed leaf's K payloads reduce in ONE grouped ``dequant_agg``
    launch with normalized weights, never materializing the K fp32
    trees, and fp leaves take the plain weighted mean. Sparse leaves are
    not ported."""
    if msgs and all(is_flat_message(m) for m in msgs) \
            and len({m.layout for m in msgs}) == 1:
        return flatcodec.fedavg_packed_flat(msgs, weights)
    msgs = [m.as_tree() if is_flat_message(m) else m for m in msgs]
    flats = [tree_flatten(m) for m in msgs]
    treedef = flats[0][1]
    if any(td != treedef for _, td in flats):
        raise ValueError("fedavg_packed over messages of different "
                         "structure")
    columns = [list(col) for col in zip(*(leaves for leaves, _ in flats))]
    l0 = columns[0][0]
    dev = l0.payload.device if is_packed_leaf(l0) else l0.device
    w = _normalized(weights, dev)
    return tree_unflatten(treedef, [
        _weighted_mean(col, w) if fold is None else fold
        for fold, col in zip(_agg_packed(columns, w), columns)])


def message_is_packed(msg: Any) -> bool:
    """True if any leaf of ``msg`` is in wire form (a whole flat message
    counts as one leaf)."""
    return any(is_wire_leaf(x) for x in tree_leaves(msg))


# ---------------------------------------------------------------------------
# Error feedback (EF memory on the sender)
# ---------------------------------------------------------------------------

def ef_init(like: Any) -> Any:
    return tree_map(lambda x: torch.zeros(tuple(x.shape),
                                          dtype=torch.float32,
                                          device=x.device), like)


def _to_device(res: Any, like: Any) -> Any:
    """A residual (host numpy or tensors) as fp32 tensors on ``like``'s
    leaves' devices."""
    return tree_map(lambda e, x: torch.as_tensor(e, dtype=torch.float32)
                    .to(x.device), res, like)


def ef_encode(tree: Any, residual: Any, qcfg: QuantConfig
              ) -> tuple[Any, Any]:
    """Send Q(x + e); keep e' = (x + e) - Q(x + e). Returns (the
    reconstruction the receiver sees, the new residual), in the fp
    simulation view."""
    if not qcfg.enabled:
        return tree, residual
    comp = tree_map(lambda x, e: x.to(torch.float32) + e, tree,
                    _to_device(residual, tree))
    recon = messages.roundtrip(comp, qcfg)
    new_res = tree_map(lambda c, r: c - r.to(torch.float32), comp, recon)
    recon = tree_map(lambda r, x: r.to(x.dtype), recon, tree)
    return recon, new_res


def ef_encode_packed(tree: Any, residual: Any, qcfg: QuantConfig,
                     density: Optional[float] = None,
                     flat: bool = False) -> tuple[Any, Any]:
    """Wire-true EF uplink: pack Q(x + e), keep e' = (x + e) - deq(msg).

    Returns (packed wire message, new residual): the client computes its
    residual from the same packed payload the server dequantizes, so the
    compensation is exact with respect to the wire. The message carries
    the ORIGINAL adapter dtypes (the compensated tree is fp32) on both
    wires. The sparse wire (``density < 1``) is not ported."""
    if density is not None and density < 1.0:
        raise NotImplementedError("the sparse wire is not ported")
    if not qcfg.enabled:
        return tree, residual
    comp = tree_map(lambda x, e: x.detach().to(torch.float32) + e, tree,
                    _to_device(residual, tree))
    msg = messages.pack_message(comp, qcfg, flat=flat)
    recon = messages.unpack_message(msg)
    new_res = tree_map(lambda c, r: c - r.to(torch.float32), comp, recon)
    if is_flat_message(msg):
        return msg.replace_dtypes(tree), new_res

    def redtype(m, x):
        if is_wire_leaf(m):
            return dataclasses.replace(m, dtype=x.dtype)
        return m.to(x.dtype)

    return tree_map(redtype, msg, tree), new_res


def ef_fold_dropped(residual: Any, msg: Any) -> Any:
    """Fold an UNDELIVERED uplink back into its sender's EF residual.

    After ``ef_encode_packed`` the residual ``e' = (x + e) - deq(msg)``
    presumes delivery; when the server discards the message (a
    straggler), the right memory is the whole compensated signal
    ``e' + deq(msg)``, so the client's next uplink re-ships the lost
    mass."""
    recon = messages.unpack_message(msg)
    return tree_map(lambda e, m: torch.as_tensor(e).to(m.device)
                    + m.to(torch.float32), residual, recon)


# ---------------------------------------------------------------------------
# Aggregator strategies
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FedAvgAggregator:
    """Paper Eq. 1 over a uniform-rank cohort. Packed inputs run on the
    fused kernels after a bit-width check against ``qcfg``; fp inputs
    take ``fedavg`` over the stacked trees. A cohort whose ranks differ
    from each other or from ``r_target`` raises: the rank-bucketed path
    is not ported."""
    qcfg: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    r_target: Optional[int] = None

    def _check_bits(self, msg: Any) -> None:
        if not self.qcfg.enabled:
            return
        for leaf in tree_leaves(msg):
            if is_wire_leaf(leaf) and leaf.bits != self.qcfg.bits:
                raise ValueError(f"aggregator configured for {self.qcfg.bits}"
                                 f"-bit messages, got {leaf.bits}-bit "
                                 "payload")

    def aggregate(self, msgs: list[Any], weights) -> Any:
        self._check_bits(msgs[0])
        ranks = {r for m in msgs if (r := lora.tree_max_rank(m)) is not None}
        if len(ranks) > 1 or (ranks and self.r_target is not None
                              and ranks != {self.r_target}):
            raise NotImplementedError(
                f"mixed-rank cohorts (ranks {sorted(ranks)}, target "
                f"{self.r_target}) are not ported")
        if any(message_is_packed(m) for m in msgs):
            return fedavg_packed(msgs, weights)
        return fedavg(stack_trees(msgs), weights)


@dataclasses.dataclass
class ErrorFeedbackFedAvg(FedAvgAggregator):
    """EF-compensated FedAvg: owns the per-client residual memory; the
    uplink encode routes through ``ef_encode_packed`` so each client
    sends Q(x + e) and the quantizer becomes unbiased in time."""
    residuals: dict = dataclasses.field(default_factory=dict)

    def residual(self, cid: int, like: Any) -> Any:
        """Client ``cid``'s residual as fp32 tensors on ``like``'s
        devices; zeros for a new client or one whose adapter shapes
        changed."""
        res = self.residuals.get(int(cid))
        if res is None:
            return ef_init(like)
        like_leaves, res_leaves = tree_leaves(like), tree_leaves(res)
        if len(res_leaves) != len(like_leaves) or any(
                tuple(np.shape(a)) != tuple(b.shape)
                for a, b in zip(res_leaves, like_leaves)):
            return ef_init(like)
        return _to_device(res, like)

    def store_residual(self, cid: int, res: Any) -> None:
        # host numpy: one fp32 adapter tree per client ever sampled must
        # not accumulate in device memory
        self.residuals[int(cid)] = tree_map(
            lambda e: e.detach().cpu().numpy(), res)
