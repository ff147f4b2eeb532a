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
    grouped ``dequant_agg`` launch; sparse (top-k) leaves scatter-add
    their dequantized survivors into one dense fp32 accumulator a leaf;
  * ``fedavg_hetero`` — zero-pad FedAvg over a mixed-rank cohort, one
    ``fedavg_packed`` per rank bucket;
  * error feedback — ``ef_init``/``ef_encode``/``ef_encode_packed``/
    ``ef_fold_dropped`` and ``ErrorFeedbackFedAvg``, which keeps each
    client's residual (EF21-style memory) as host numpy;
  * ``FedAvgAggregator`` — the strategy ``FLServer`` calls, rank-bucketed
    when the cohort's ranks are mixed, and
    ``SVDRecombinationAggregator``, FLoRIST-style recombination of the
    adapter products;
  * FedBuff (Nguyen et al. '22, buffered asynchronous aggregation with
    a staleness discount ``w = n_k * 2^(-staleness / half_life)``):
    ``fedbuff_init``/``fedbuff_add``/``fedbuff_flush`` (the incremental
    fp reference), ``FedBuffAggregator`` (the rank-bucketed buffered
    rule both engines call) and ``StreamingFlatAccumulator`` (each flat
    arrival folded at add time, one K = 1 ``dequant_agg_rows`` launch,
    so a flush costs O(message) whatever the buffer size).

Every strategy follows the :class:`Aggregator` protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import flat as flatcodec
from repro_torch.core import lora, messages
from repro_torch.core.flat import is_flat_message
from repro_torch.core.messages import is_packed_leaf, is_wire_leaf
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sparse import is_sparse_leaf
from repro_torch.kernels import ops as kops
from repro_torch.obs.compile import CompileWatchdog
from repro_torch.utils.device import resolve_device, upload
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
    packed = [i for i, col in enumerate(columns)
              if is_packed_leaf(col[0]) and not _has_sparse(col)]
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


def _has_sparse(col: list) -> bool:
    return any(is_sparse_leaf(m) for m in col)


def _scatter_mean(col: list, w: torch.Tensor) -> torch.Tensor:
    """One position holding sparse leaves (and possibly dense ones: a
    buffer may span a density-annealing boundary): the sparse clients'
    pre-weighted survivors scatter-add into one dense fp32 accumulator,
    one client at a time in message order, then dense leaves add in full.
    A client's indices are unique, so each ``index_add_`` is free of
    collisions: the sum is deterministic on the card, in the order of a
    sequential scatter over the concatenated updates."""
    l0 = next(m for m in col if is_sparse_leaf(m))
    acc = torch.zeros((l0.n,), dtype=torch.float32, device=l0.idx.device)
    for i, m in enumerate(col):
        if is_sparse_leaf(m):
            acc.index_add_(0, m.idx, w[i] * m.values())
    for i, m in enumerate(col):
        if not is_sparse_leaf(m):
            acc = acc + w[i] * messages.unpack_message(m).to(
                torch.float32).reshape(-1)
    return acc.reshape(l0.shape).to(l0.dtype)


def fedavg_packed(msgs: list[Any], weights) -> Any:
    """Weighted mean over K packed wire messages, fused.

    Flat messages of one layout reduce the whole cohort in ONE
    ``dequant_agg_rows`` launch. Otherwise (per-leaf messages, or a
    buffer mixing flat and per-leaf ones: flat messages re-expose their
    per-leaf tree through ``as_tree``, bit-identical payload slices)
    every packed leaf's K payloads reduce in ONE grouped ``dequant_agg``
    launch with normalized weights, never materializing the K fp32
    trees, and fp leaves take the plain weighted mean. A position holding
    sparse leaves scatter-adds them (``_scatter_mean``)."""
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
    dev = (l0.payload if is_wire_leaf(l0) else l0).device
    w = _normalized(weights, dev)
    return tree_unflatten(treedef, [
        _scatter_mean(col, w) if _has_sparse(col)
        else _weighted_mean(col, w) if fold is None else fold
        for fold, col in zip(_agg_packed(columns, w), columns)])


def message_is_packed(msg: Any) -> bool:
    """True if any leaf of ``msg`` is in wire form (packed or sparse; a
    whole flat message counts as one leaf)."""
    return any(is_wire_leaf(x) for x in tree_leaves(msg))


# ---------------------------------------------------------------------------
# Heterogeneous-rank aggregation (HetLoRA zero-pad / FLoRIST SVD)
# ---------------------------------------------------------------------------

def bucket_by_rank(msgs: list[Any]) -> dict[int, list[int]]:
    """Message indices grouped by adapter rank (shape-inspected, so
    packed, sparse and fp messages bucket alike), ascending rank;
    messages without adapters land in bucket 0."""
    buckets: dict[int, list[int]] = {}
    for i, m in enumerate(msgs):
        r = lora.tree_max_rank(m)
        buckets.setdefault(0 if r is None else int(r), []).append(i)
    return dict(sorted(buckets.items()))


def fedavg_hetero(msgs: list[Any], weights, r_target: int) -> Any:
    """Zero-pad-to-max FedAvg over MIXED-rank client messages: each rank
    bucket (uniform shapes) aggregates in one ``fedavg_packed`` (one
    fused launch on the flat wire), its mean is zero-padded to
    ``r_target``, and the bucket means combine with their weight-mass
    fractions. Padding is linear, so this equals padding every client
    first and one global FedAvg."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    total = torch.sum(w)
    fracs, means = [], []
    for r, idxs in bucket_by_rank(msgs).items():
        bmsgs = [msgs[i] for i in idxs]
        bw = w[idxs]
        # any wire-form message routes the bucket through the wire path
        # (fedavg_packed also takes fp trees leaf by leaf)
        if any(message_is_packed(m) for m in bmsgs):
            mean_b = fedavg_packed(bmsgs, bw)
        else:
            mean_b = fedavg(stack_trees(bmsgs), bw)
        if r:
            mean_b = lora.resize_tree_rank(mean_b, r_target, method="slice")
        fracs.append(torch.sum(bw) / total)
        means.append(mean_b)
    if len(means) == 1:
        return means[0]

    def combine(*leaves):
        acc = sum(f * x.to(torch.float32) for f, x in zip(fracs, leaves))
        return acc.to(leaves[0].dtype)

    return tree_map(combine, *means)


# ---------------------------------------------------------------------------
# FedBuff: the incremental fp reference of the buffered rule (one add an
# arrival); the engines' path is FedBuffAggregator's rank-bucketed
# add/flush, which defers the reduce to one fused pass over the buffer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FedBuffState:
    buffer: Any               # running weighted sum of updates
    weight: torch.Tensor      # running sum of weights (fp32, 0-d)
    count: torch.Tensor       # updates buffered so far (int32, 0-d)


def fedbuff_init(like: Any) -> FedBuffState:
    dev = tree_leaves(like)[0].device
    return FedBuffState(
        buffer=tree_map(lambda x: torch.zeros(tuple(x.shape),
                                              dtype=torch.float32,
                                              device=x.device), like),
        weight=torch.zeros((), dtype=torch.float32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev))


def fedbuff_add(state: FedBuffState, update: Any, n_k, staleness,
                half_life: float) -> FedBuffState:
    """Add one async update with the staleness-discounted weight
    ``w = n_k * 2^(-staleness / half_life)`` (fp32, as the reference
    computes it): an update's influence halves for every ``half_life``
    versions the server advanced while the client trained. Returns a
    new state; ``state`` is not written."""
    dev = state.weight.device
    w = torch.as_tensor(n_k, dtype=torch.float32).to(dev) * torch.exp2(
        -torch.as_tensor(staleness, dtype=torch.float32).to(dev)
        / half_life)
    buf = tree_map(lambda b, u: b + w * u.to(torch.float32),
                   state.buffer, update)
    return FedBuffState(buf, state.weight + w, state.count + 1)


def fedbuff_flush(state: FedBuffState, like: Any) -> tuple[Any, FedBuffState]:
    """The aggregated tree and a fresh state. Zero accumulated weight
    (an empty buffer, or one discounted to nothing) raises."""
    if float(state.weight) <= 0.0:
        raise ValueError("FedBuff flush with zero accumulated weight "
                         f"(count={int(state.count)})")
    agg = tree_map(lambda b, x: (b / state.weight).to(x.dtype),
                   state.buffer, like)
    return agg, fedbuff_init(like)


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
    the ORIGINAL adapter dtypes (the compensated tree is fp32) on every
    wire. On the sparse wire (``density < 1``) the reconstruction is zero
    at the dropped positions, so e' absorbs the whole dropped mass on top
    of the survivors' quantization error (the FLASC rule)."""
    sparse_on = density is not None and density < 1.0
    if not qcfg.enabled and not sparse_on:
        return tree, residual
    comp = tree_map(lambda x, e: x.detach().to(torch.float32) + e, tree,
                    _to_device(residual, tree))
    msg = messages.pack_message(comp, qcfg, density=density, flat=flat)
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

@runtime_checkable
class Aggregator(Protocol):
    """Server-side aggregation rule over one round's client messages:
    ``msgs`` are K packed wire messages or fp trees, ``weights`` their
    n_k sample counts."""

    def aggregate(self, msgs: list[Any], weights) -> Any:
        ...


@dataclasses.dataclass
class FedAvgAggregator:
    """Paper Eq. 1, generalized to heterogeneous ranks. Packed inputs
    run on the fused kernels after a bit-width check against ``qcfg``,
    per rank bucket when the cohort is mixed (``fedavg_hetero``); fp
    inputs take ``fedavg`` over the stacked trees. ``r_target`` is the
    LOWER bound of the aggregated tree's rank (zero-pad: a larger client
    rank pads to that rank, never truncates); None pads to the round's
    max client rank. ``FLServer`` pins it to the server rank."""
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

    def _round_rank(self, msgs: list[Any]) -> tuple[Optional[int], bool]:
        """(target rank, heterogeneous?) for this round's messages."""
        ranks = {r for m in msgs if (r := lora.tree_max_rank(m)) is not None}
        if not ranks:
            return None, False
        target = max(self.r_target or 0, max(ranks))
        return target, (len(ranks) > 1 or ranks != {target})

    def aggregate(self, msgs: list[Any], weights) -> Any:
        self._check_bits(msgs[0])
        target, hetero = self._round_rank(msgs)
        if hetero:
            return fedavg_hetero(msgs, weights, target)
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


@dataclasses.dataclass
class SVDRecombinationAggregator(FedAvgAggregator):
    """FLoRIST-style server recombination for (mixed-rank) LoRA fleets.

    Non-adapter leaves take the rank-bucketed FedAvg result. Each adapter
    pair is recombined from the PRODUCT side: the weighted mean delta
    ``sum_k w_k * down_k @ up_k`` (rank-free, so clients of any rank mix
    exactly) is thin-SVD'd, the singular values thresholded at
    ``energy`` of the cumulative mass pick the SERVED rank (at most the
    round's max client rank), and the balanced factors are zero-padded
    back to the global tree's rank. ``served_ranks`` records {adapter
    path: served rank} of the last round. The factors may differ from
    the JAX package's in sign and order; products and ranks do not."""
    energy: float = 0.99
    served_ranks: dict = dataclasses.field(default_factory=dict)

    def aggregate(self, msgs: list[Any], weights) -> Any:
        # the base pass also averages the adapter leaves recombined
        # below: it supplies the other leaves and each pair's template
        base = super().aggregate(msgs, weights)
        ranks = [lora.tree_max_rank(m) for m in msgs]
        if all(r is None for r in ranks):
            return base
        cap = max(r for r in ranks if r is not None)
        # dequantize ONLY the adapter pairs (the recombination's inputs)
        trees = [m.as_tree() if is_flat_message(m) else m for m in msgs]
        trees = [lora._walk_pairs(m, messages.unpack_message)
                 if message_is_packed(m) else m for m in trees]
        w = torch.as_tensor(weights, dtype=torch.float32)
        w = w / torch.sum(w)
        self.served_ranks = {}

        def recombine(path: str, node: Any, clients: list[Any]) -> Any:
            if isinstance(node, dict):
                if lora.is_adapter_pair(node):
                    return self._recombine_pair(path, node, clients, w, cap)
                return {k: recombine(f"{path}/{k}", v,
                                     [c[k] for c in clients])
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                out = [recombine(f"{path}/{i}", v, [c[i] for c in clients])
                       for i, v in enumerate(node)]
                return type(node)(out) if isinstance(node, tuple) else out
            return node

        return recombine("", base, trees)

    def _recombine_pair(self, path: str, base_pair: dict,
                        client_pairs: list[dict], w: torch.Tensor,
                        cap: int) -> dict:
        delta = None
        for wk, pair in zip(w, client_pairs):
            down, up, _ = lora._dense_factors(pair)
            d = wk * (down.to(torch.float32) @ up.to(torch.float32))
            delta = d if delta is None else delta + d
        u, s, vh = torch.linalg.svd(delta, full_matrices=False)
        r_served = min(lora.svd_energy_rank(s, self.energy), cap)
        self.served_ranks[path.lstrip("/")] = r_served
        root = torch.sqrt(s[..., :r_served])
        down_s = u[..., :, :r_served] * root[..., None, :]
        up_s = root[..., :, None] * vh[..., :r_served, :]
        _, _, kind = lora._dense_factors(base_pair)
        served = lora._rebuild_pair(down_s, up_s, kind, base_pair)
        return lora.pad_adapter(served, lora.adapter_rank(base_pair))


@dataclasses.dataclass
class StreamingFlatAccumulator:
    """O(1)-memory streaming aggregation of flat wire messages.

    Each arriving :class:`~repro_torch.core.flat.FlatPackedMessage` folds
    into a running fp32 sum at ARRIVAL time (``flat.fold_flat``: one K = 1
    ``dequant_agg_rows`` launch over the ``(C_total, N_max)``
    accumulator), and the flush is an O(message) normalize
    (``flat.flat_mean_from_sum``). One accumulator a layout, never the
    K-message buffer; weight and count stay on the host. The
    accumulators live on the messages' device. ``strict_compiles``
    wraps every fold after the first (per reset cycle) in a zero-budget
    ``CompileWatchdog``: a fold that builds a program raises
    ``CompileBudgetExceeded``."""
    layout: Any               # flat.TreeLayout (one accumulator each)
    acc: torch.Tensor         # (C_total, N_max) fp32 running sum
    fp_acc: tuple             # fp32 running sums of fp passthrough leaves
    weight: float = 0.0       # accumulated (discounted) weight
    count: int = 0            # messages folded since the last reset
    strict_compiles: bool = False
    n_valid: Optional[torch.Tensor] = None   # per-row lengths, on device

    def __post_init__(self):
        if self.n_valid is None:
            self.n_valid = upload(
                torch.from_numpy(self.layout.n_valid_vec()),
                self.acc.device)

    @classmethod
    def for_layout(cls, layout: Any, strict_compiles: bool = False,
                   device="cuda") -> "StreamingFlatAccumulator":
        dev = resolve_device(device)
        acc = torch.zeros((layout.c_total, layout.n_max),
                          dtype=torch.float32, device=dev)
        fp = tuple(torch.zeros(s.shape, dtype=torch.float32, device=dev)
                   for s in layout.leaves if not s.quantized)
        return cls(layout, acc, fp, strict_compiles=strict_compiles)

    def fold(self, msg: Any, w: float) -> None:
        if msg.layout != self.layout:
            raise ValueError("flat message layout does not match the "
                             "streaming accumulator's")
        if self.strict_compiles and self.count > 0:
            with CompileWatchdog(0, label="streaming flat fold "
                                          f"#{self.count}"):
                self._fold(msg, w)
        else:
            self._fold(msg, w)
        self.weight += float(w)
        self.count += 1

    def _fold(self, msg: Any, w: float) -> None:
        self.acc, self.fp_acc = flatcodec.fold_flat(
            self.acc, self.fp_acc, msg, float(w), self.n_valid)

    def mean(self) -> Any:
        """The aggregated fp tree (original structure and dtypes)."""
        if self.count == 0:
            raise ValueError("streaming flush with an empty accumulator")
        if self.weight <= 0.0:
            raise ValueError("streaming flush with zero accumulated "
                             f"weight (count={self.count})")
        return flatcodec.flat_mean_from_sum(self.acc, self.fp_acc,
                                            1.0 / self.weight, self.layout)

    def reset(self) -> None:
        self.acc = torch.zeros_like(self.acc)
        self.fp_acc = tuple(torch.zeros_like(x) for x in self.fp_acc)
        self.weight = 0.0
        self.count = 0

    def shape_tree(self) -> Any:
        """Shape/dtype view with the original tree structure (rank
        detection without touching the accumulator)."""
        return tree_unflatten(self.layout.treedef,
                              [flatcodec.ShapeDtype(s.shape, s.dtype)
                               for s in self.layout.leaves])

    # -- checkpointable state (host arrays; the caller rebuilds layout) -----
    def state(self) -> dict:
        return {"acc": self.acc.cpu().numpy(),
                "fp_acc": [x.cpu().numpy() for x in self.fp_acc],
                "weight": float(self.weight), "count": int(self.count)}

    @classmethod
    def from_state(cls, layout: Any, state: dict,
                   device="cuda") -> "StreamingFlatAccumulator":
        dev = resolve_device(device)
        return cls(layout,
                   torch.as_tensor(state["acc"], dtype=torch.float32).to(dev),
                   tuple(torch.as_tensor(x, dtype=torch.float32).to(dev)
                         for x in state["fp_acc"]),
                   float(state["weight"]), int(state["count"]))


FEDBUFF_HALF_LIFE = 4.0   # fallback when no engine config threads one


@dataclasses.dataclass
class FedBuffAggregator:
    """Buffered aggregation with staleness discounting (Nguyen et al.
    '22): ``w = n_k * 2^(-staleness / half_life)``, an update's influence
    halving for every ``half_life`` global versions of server lag.
    ``half_life=None`` defers to the engine config
    (``ServerConfig.fedbuff_half_life`` / ``AsyncConfig.half_life``);
    both engines thread it at construction.

    Two interfaces over one rule, both RANK-BUCKETED (packed buckets
    aggregate on the fused kernels and zero-pad to ``r_target``):

      * ``aggregate(msgs, weights)`` — the sync round's: with
        ``rank_staleness`` the arrival order WITHIN each rank bucket
        plays the staleness role;
      * ``add(msg, n_k, staleness)`` / ``flush()`` — the async engine's:
        messages buffer with their discounted weights and one flush
        reduces the buffer in one rank-bucketed pass (one
        ``dequant_agg_rows`` launch a bucket on the flat wire).

    With ``streaming=True`` flat messages never buffer: each ``add``
    folds the arrival into a :class:`StreamingFlatAccumulator` (one a
    layout; layouts double as rank buckets) and ``flush`` normalizes in
    O(message). Other messages (sparse uplinks, fp trees) still buffer
    in ``pending``; a mixed flush combines stream and bucket means by
    weight-mass fraction, as ``fedavg_hetero`` does, streams in ascending
    rank (so a resumed run sums them in the same order).
    ``strict_compiles`` passes to the stream accumulators: every fold
    after a stream's first runs under a zero-budget compile watchdog."""
    half_life: Optional[float] = None
    rank_staleness: bool = False   # sync rounds: discount late arrivals
    r_target: Optional[int] = None  # zero-pad target (engines pin this)
    pending: list = dataclasses.field(default_factory=list)
    streaming: bool = False        # fold flat arrivals at add time
    streams: dict = dataclasses.field(default_factory=dict)
    strict_compiles: bool = False

    def resolved_half_life(self) -> float:
        return FEDBUFF_HALF_LIFE if self.half_life is None \
            else float(self.half_life)

    def discounted_weight(self, n_k: float, staleness: float) -> float:
        """w = n_k * 2^(-staleness / half_life), in Python floats."""
        return float(n_k) * 2.0 ** (-float(staleness)
                                    / self.resolved_half_life())

    def _combine(self, msgs: list[Any], w: np.ndarray) -> Any:
        """Rank-bucketed discounted-weight mean over messages."""
        ranks = {r for m in msgs
                 if (r := lora.tree_max_rank(m)) is not None}
        if ranks:
            target = max(self.r_target or 0, max(ranks))
            if len(ranks) > 1 or ranks != {target}:
                return fedavg_hetero(msgs, w, target)
        # ANY wire-form message selects the wire path (a buffer spanning
        # a density-annealing boundary can hold an fp tree first)
        if any(message_is_packed(m) for m in msgs):
            return fedavg_packed(msgs, w)
        return fedavg(stack_trees(msgs), w)

    def aggregate(self, msgs: list[Any], weights) -> Any:
        stale = np.zeros(len(msgs), np.float32)
        if self.rank_staleness:
            for idxs in bucket_by_rank(msgs).values():
                for pos, i in enumerate(idxs):
                    stale[i] = float(pos)
        w = np.asarray(weights, np.float32) \
            * np.exp2(-stale / self.resolved_half_life())
        return self._combine(msgs, w)

    # -- the async engine's buffered interface -------------------------------
    @property
    def buffered(self) -> int:
        """Arrivals absorbed since the last flush (pending + streamed)."""
        return len(self.pending) + sum(s.count
                                       for s in self.streams.values())

    @property
    def buffered_weight(self) -> float:
        """Total discounted weight absorbed since the last flush."""
        return (sum(wt for _, wt in self.pending)
                + sum(s.weight for s in self.streams.values()))

    def add(self, msg: Any, n_k: float, staleness: float) -> int:
        """Absorb one arrived (packed or fp) message with its discounted
        weight; returns the buffer's fill. Streaming mode folds a flat
        message at once; everything else buffers for the flush."""
        w = self.discounted_weight(n_k, staleness)
        if self.streaming and is_flat_message(msg):
            st = self.streams.get(msg.layout)
            if st is None:
                st = StreamingFlatAccumulator.for_layout(
                    msg.layout, strict_compiles=self.strict_compiles,
                    device=msg.payload.device)
                self.streams[msg.layout] = st
            st.fold(msg, w)
        else:
            self.pending.append((msg, w))
        return self.buffered

    def flush(self) -> Any:
        """Aggregate and clear the buffer: pending messages reduce in one
        rank-bucketed pass, stream accumulators normalize; the parts'
        means zero-pad to the target rank and combine with their
        weight-mass fractions."""
        if self.buffered == 0:
            raise ValueError("FedBuff flush with an empty buffer")
        parts: list[tuple[int, float, Any]] = []   # (rank, mass, mean)
        # streams in ascending rank, not in the order they were created:
        # a resumed run creates them anew in another order, and the
        # parts' fp32 sum below must not depend on it (the JAX package
        # sums in creation order, which a resume does not reproduce)
        streams = [(lora.tree_max_rank(st.shape_tree()) or 0, st)
                   for st in self.streams.values() if st.count]
        for r, st in sorted(streams, key=lambda p: p[0]):
            parts.append((int(r), st.weight, st.mean()))
            st.reset()
        msgs = [m for m, _ in self.pending]
        wts = [wt for _, wt in self.pending]
        self.pending = []
        for r, idxs in bucket_by_rank(msgs).items():
            bmsgs = [msgs[i] for i in idxs]
            bw = torch.tensor([wts[i] for i in idxs], dtype=torch.float32)
            if any(message_is_packed(m) for m in bmsgs):
                mean_b = fedavg_packed(bmsgs, bw)
            else:
                mean_b = fedavg(stack_trees(bmsgs), bw)
            parts.append((r, float(sum(wts[i] for i in idxs)), mean_b))
        total = sum(mass for _, mass, _ in parts)
        if total <= 0.0:
            raise ValueError("FedBuff flush with zero accumulated "
                             f"weight ({self.buffered} buffered)")
        ranks = {r for r, _, _ in parts if r}
        target = max(self.r_target or 0, max(ranks)) if ranks else 0
        means = [lora.resize_tree_rank(m, target, method="slice")
                 if r and r != target else m for r, _, m in parts]
        if len(means) == 1:
            return means[0]
        fracs = [mass / total for _, mass, _ in parts]

        def combine(*leaves):
            acc = sum(f * x.to(torch.float32) for f, x in zip(fracs, leaves))
            return acc.to(leaves[0].dtype)

        return tree_map(combine, *means)
