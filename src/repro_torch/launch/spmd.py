"""Local-block execution of a sharded step (``launch/steps.py``).

A sharded step's arguments are DTensors over a ``DeviceMesh`` with the
JAX package's shardings: parameters, optimizer state and caches stay
sharded at rest. Its computation runs on plain local tensors, each rank
on its block of the batch, rather than through DTensor's
operator-by-operator sharding propagation (whose strategy search takes
minutes an op on a three-axis mesh). :class:`LocalStep` is what the
model code reaches through ``utils/pcontext.py`` while it runs:

  * ``params``: a layer's parameters, all-gathered at use
    (``DTensor.redistribute`` to replicated) inside the layer, so that a
    recomputed layer gathers them again and only one layer's full
    parameters are alive at a time (ZeRO-3). Their gradients come back as
    a sum over the ranks that split the batch (``grad_placements``
    ``Partial``), which the redistribute's backward reduce-scatters onto
    the owners' shards.
  * ``layer_cache`` / ``seq_block``: a decode layer's KV or latent cache
    stays this rank's block of the sequence (the reference's split-KV
    decode): the new slot is written by the rank that holds it, and the
    attention's softmax max and sum and its output are summed over the
    ranks that hold the other blocks (``layers.softmax_blocks``). A
    Mamba layer's SSM state stays its block of heads where they split
    (below); its conv cache (split over channels that are not laid out
    by heads) is gathered and written back after the layer.
  * ``batch_sum``, ``token_sum``, ``token_total``: the sums over the
    batch that the reference computes over all tokens (the loss, the MoE
    aux loss).
  * tensor parallelism of the dense MLPs over ``model`` where nothing
    else splits the work over it (a prefill's or a decode's rows, a train
    step's that ``model`` does not divide, without ``seq_parallel``):
    each rank keeps its ``model`` block of the MLP's weights (``wi`` /
    ``wg`` by columns, ``wo`` by rows, as the reference shards them),
    runs its share of the hidden units and adds the partial outputs
    over ``model`` (Megatron's column/row split: ``tp_enter`` is the
    identity with an all-reduce backward, ``tp_exit`` an all-reduce
    with the identity backward).
  * the attention heads over ``model`` (the reference's ``heads`` and
    ``kv_chunks`` rules) where it splits neither the rows nor the
    queries: a prefill, a train step whose rows it does not divide
    without ``seq_parallel``, and under ``seq_parallel`` a
    sliding-window layer, which runs on the whole sequence; never a
    decode step (split-KV). The count must divide ``model`` (the
    configs pad their heads to). Each rank keeps its block of ``wq``
    (and ``bq``) by columns and ``wo`` by rows, MLA's ``q_b``, ``k_b``,
    ``v_b`` by columns, and computes ``wk`` / ``wv`` whole (their
    ``kv_proj`` weights are replicated; a prefill's cache needs every kv
    head); the keys and values, repeated to every query head, keep the
    block's (``narrow_heads``, the local ``heads`` constraint); the
    partial outputs of ``wo`` add over ``model`` in fp32, under
    ``seq_parallel`` reduce-scattered onto the sequence block. An
    adapter factor or norm whole on ``model`` gets a ``Partial``
    gradient over it.
  * a Mamba mixer's heads and inner channels over ``model`` (the
    reference's ``ssm_heads`` and ``ssm_inner`` rules) where it splits
    no rows: a prefill, a decode step (a state has no sequence to
    split), a train step whose rows it does not divide, and under
    ``seq_parallel`` a Mamba layer, which runs on the whole sequence.
    The count must divide ``model``. Rank ``j`` holds heads ``[j H/m,
    (j + 1) H/m)``, head ``h`` channels ``[h P, (h + 1) P)`` of
    ``d_inner``: ``wz`` / ``wx`` (and the adapters' ``b``) by columns,
    ``wo`` by rows, the gated norm's scale by channels (their
    ``ssm_inner`` blocks at rest); ``wb`` / ``wc`` / ``wdt``, the conv
    (whose channels at rest are not laid out by heads) and ``A_log`` /
    ``D`` / ``dt_bias`` whole, taken at the block, their gradients
    summed over ``model``. The gated norm's mean square is the blocks'
    sums of squares summed over ``model`` (:meth:`LocalStep.ssm_sum`);
    ``wo``'s partial outputs add over it in fp32 (under
    ``seq_parallel`` reduce-scattered onto the sequence block), as the
    attention's do.
  * the vocab over ``model`` (the ``vocab`` rule) where the tokens that
    reach the head are split over neither the rows nor the sequence: a
    prefill's last position, a decode step, a train step whose rows it
    does not divide, without ``seq_parallel``. The count must divide
    ``model`` (else the placement at rest is whole and so is the head).
    The embedding keeps its rows' block (a masked lookup summed over
    ``model``: one block gives each token its row, so the sum is the
    whole lookup exactly); the head its columns' (``b`` by columns,
    ``a`` whole); the cross-entropy takes each chunk's max, sum of
    exponentials and label logit over the blocks
    (``layers.chunked_xent``); the served logits are gathered.
  * the MoE experts over ``model`` (the ``expert`` rule), whatever
    splits the rows; a sharded step refuses a MoE whose experts
    ``model`` does not divide (every config's do). Each rank keeps its
    block of the banks and computes those experts' rows of the
    dispatch chunks that its batch block holds tokens of, the capacity
    rows split over the chunk's holders where a chunk spans several
    batch blocks and they divide them (over a mesh of its own, made
    when the step is built: :func:`holder_mesh`); the tokens' kept
    pairs reach their experts' owners by an all-to-all over ``model``
    and come back by another (:class:`ExpertSplit`,
    ``moe._dispatch_split``). A prefill's, a decode's or a
    sequence-parallel layer's tokens no longer run whole on every
    ``model`` rank: ``model`` shares them where it divides them.
  * sequence parallelism (``seq_axes``, a plan's ``seq_parallel``): the
    residual stream holds this rank's block of the sequence over
    ``model``, each token-wise layer (norms, projections, MLPs, the
    loss) runs on the block, attention gathers the keys and values of
    the whole sequence (``seq_gather``, whose backward reduce-scatters)
    for the block's queries at their positions; a sliding-window or
    Mamba layer gathers its input and runs its head block on the whole
    sequence (above); a layer without a split form (a window or Mamba
    layer whose heads do not divide ``model``) gathers its input, runs
    on the whole sequence and keeps its block of the output. A MoE
    layer runs on the block: its chunks' order is the whole
    (micro)batch's, and each rank finds its tokens' places in it
    (:func:`_token_ids`).

The reference reaches the Mamba and vocab splits through its weight
shardings alone, with no constraint; here they are the blocks a rank
keeps. What its rules leave whole (``wk`` / ``wv``, Mamba's B, C, dt
and the chunks' C·B scores) every ``model`` rank computes whole, as
there.

Every collective is a ``torch.distributed._functional_collectives`` call
(DTensor's own or this module's autograd Functions, each with its
adjoint as its backward) over one named mesh axis, which
``utils/comm.py`` ``record_funcol`` counts.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.utils.tree import tree_leaves, tree_map

# the subtrees of a parameter tree stacked over layers (gathered layer by
# layer), and zamba2's shared attention (gathered at each invocation, as
# the invoking layer's own: its head block where the heads split); every
# other subtree is gathered once at the start of a step
AT_USE = ("groups", "enc", "dec", "shared_attn")
# a layer's attention subtrees (self and cross) and a MoE's expert banks
HEAD_TREES = ("attn", "cross")
BANKS = ("wi", "wg", "wo")
# the subtrees whose vocab dim the ``vocab`` rule splits
VOCAB_TREES = ("embed", "head")


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def block_index(mesh, axes) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim split over
    ``axes`` in mesh order (DTensor's layout: the first axis outermost)."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, n = 0, 1
    for ax in mesh.mesh_dim_names:
        if ax in axes:
            idx = idx * sizes[ax] + coord[ax]
            n *= sizes[ax]
    return idx, n


def split_axes(mesh, rows: int, candidates, greedy: bool = True
               ) -> tuple[str, ...]:
    """The axes of ``candidates`` (in mesh order) that split ``rows``.
    ``greedy``: each kept while the product of the kept sizes divides it
    (the reference's best-effort rule, which its caches' batch dim
    follows); else the subset with the largest product that divides it
    (16 rows over (pod 2, data 16) take ``data``, not ``pod``)."""
    sizes = axis_sizes(mesh)
    names = [ax for ax in mesh.mesh_dim_names if ax in candidates]
    if greedy:
        kept, prod = [], 1
        for ax in names:
            if rows % (prod * sizes[ax]) == 0:
                kept.append(ax)
                prod *= sizes[ax]
        return tuple(kept)
    best, best_n = (), 1
    for mask in range(1 << len(names)):
        sub = tuple(ax for i, ax in enumerate(names) if mask >> i & 1)
        n = math.prod(sizes[ax] for ax in sub)
        if rows % n == 0 and n > best_n:
            best, best_n = sub, n
    return best


def placements_for(mesh, dims: dict) -> tuple:
    """``dims``: {mesh axis: tensor dim} -> placements, one a mesh dim."""
    return tuple(Shard(dims[ax]) if ax in dims else Replicate()
                 for ax in mesh.mesh_dim_names)


def local_block(full: torch.Tensor, pl: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under placements ``pl`` (DTensor's
    even ``Shard`` chunks, taken in mesh-dim order): a view."""
    x = full
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if x.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not split evenly over {n} ranks")
            c = x.shape[p.dim] // n
            x = x.narrow(p.dim, coord[i] * c, c)
    return x


def _wait(t):
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _dim(mesh, ax: str) -> tuple:
    return (mesh, mesh.mesh_dim_names.index(ax))


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for ax in axes:
        x = _wait(funcol.all_reduce(x, "sum", _dim(mesh, ax)))
    return x


def max_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    x = x.contiguous()
    for ax in axes:
        x = _wait(funcol.all_reduce(x, "max", _dim(mesh, ax)))
    return x


def cat_last_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The last dim of every rank's block over ``axes`` concatenated, in
    block order (no gradient)."""
    for ax in axes:
        x = _wait(funcol.all_gather_tensor(x.contiguous(), x.ndim - 1,
                                           _dim(mesh, ax)))
    return x


def gather_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """(number of blocks, *x.shape): ``x`` of every rank's block over
    ``axes``, in block order."""
    x = x[None]
    # the innermost axis first: block j of an outer axis then holds the
    # inner blocks j * inner + 0, 1, ...
    for ax in reversed([a for a in mesh.mesh_dim_names if a in axes]):
        x = _wait(funcol.all_gather_tensor(x.contiguous(), 0,
                                           _dim(mesh, ax)))
    return x


class _TpEnter(torch.autograd.Function):
    """The identity; its gradient is summed over the tensor-parallel
    axes (each rank's share of the MLP gives a part of it)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return sum_over(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _TpExit(torch.autograd.Function):
    """The sum of the ranks' partial outputs (in fp32); its gradient is
    the identity (every rank holds the whole output)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return sum_over(x.to(torch.float32).contiguous(), mesh,
                        axes).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumOver(torch.autograd.Function):
    """SUM over mesh axes; its gradient is the same sum (every rank's
    loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return sum_over(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g.contiguous(), ctx.mesh, ctx.axes), None, None



class _AllToAll(torch.autograd.Function):
    """Block ``j`` of dim 0 to rank ``j`` of the axis, and block ``j`` of
    the result from rank ``j``; its adjoint is the same exchange."""

    @staticmethod
    def forward(ctx, x, mesh, ax):
        ctx.mesh, ctx.ax = mesh, ax
        return _a2a(x, mesh, ax)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.mesh, ctx.ax), None, None


def _a2a(x: torch.Tensor, mesh, ax: str) -> torch.Tensor:
    return _wait(funcol.all_to_all_single(x.contiguous(), None, None,
                                          _dim(mesh, ax)))


class _ReduceScatter(torch.autograd.Function):
    """The SUM over the axis, each rank keeping its block of dim
    ``dim``; its adjoint is the all-gather of that dim."""

    @staticmethod
    def forward(ctx, x, mesh, ax, dim):
        ctx.mesh, ctx.ax, ctx.dim = mesh, ax, dim
        return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum",
                                                  dim, _dim(mesh, ax)))

    @staticmethod
    def backward(ctx, g):
        return _wait(funcol.all_gather_tensor(
            g.contiguous(), ctx.dim, _dim(ctx.mesh, ctx.ax))), None, None, \
            None


class _RepSlice(torch.autograd.Function):
    """This rank's block of dim 0 of a tensor that every rank of the axis
    holds whole (and of which each needs the whole gradient): the
    gradients of the blocks are gathered."""

    @staticmethod
    def forward(ctx, x, mesh, ax, index, n):
        ctx.mesh, ctx.ax = mesh, ax
        c = x.shape[0] // n
        return x.narrow(0, index * c, c)

    @staticmethod
    def backward(ctx, g):
        return _wait(funcol.all_gather_tensor(
            g.contiguous(), 0, _dim(ctx.mesh, ctx.ax))), None, None, None, \
            None


class _RepGather(torch.autograd.Function):
    """The blocks of dim 0 of every rank of the axis, concatenated; each
    rank then holds the whole and its whole gradient, of which it keeps
    its block's."""

    @staticmethod
    def forward(ctx, x, mesh, ax, index):
        ctx.index, ctx.c = index, x.shape[0]
        return _wait(funcol.all_gather_tensor(x.contiguous(), 0,
                                              _dim(mesh, ax)))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.c, ctx.c), None, None, None


def _layer_placements(pl: tuple) -> tuple:
    """Placements of one layer of a tensor stacked over layers (dim 0,
    never sharded)."""
    out = []
    for p in pl:
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("a layer stack sharded over its layers")
            out.append(Shard(p.dim - 1))
        else:
            out.append(p)
    return tuple(out)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def as_dtensor(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


# decode caches whose dim 1 (after the layer axis) is the sequence
SEQ_CACHES = ("k", "v", "ckv", "kr")


class SeqBlock:
    """A rank's block of a decode cache's sequence: its first slot
    ``offset``, the slots over all blocks ``total``, and reductions over
    the ``axes`` that split it."""

    def __init__(self, mesh, axes, offset: int, total: int):
        self.mesh, self.axes = mesh, tuple(axes)
        self.offset, self.total = offset, total

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return sum_over(x.contiguous(), self.mesh, self.axes)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return max_over(x, self.mesh, self.axes)


class LocalStep:
    """What a sharded step's model code needs from the other ranks (see
    the module docstring); installed with ``pcontext.use_local``.
    ``axes``: the mesh axes that split the step's batch rows."""

    def __init__(self, mesh, axes=(), seq_axes=(), seq_len: int = 0,
                 heads: bool = True, log: Optional[dict] = None,
                 holders: Optional[dict] = None):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.seq_axes = tuple(seq_axes)
        self.index, self.n_rows = block_index(mesh, self.axes)
        self.seq_index, self.seq_n = block_index(mesh, self.seq_axes)
        self.sum_axes = tuple(ax for ax in mesh.mesh_dim_names
                              if ax in self.axes + self.seq_axes)
        self.n = self.n_rows * self.seq_n
        self.grad_placements = tuple(
            Partial() if ax in self.sum_axes else Replicate()
            for ax in mesh.mesh_dim_names)
        sizes = axis_sizes(mesh)
        names = tuple(mesh.mesh_dim_names)
        # tensor parallelism where model would otherwise repeat the work
        self.tp_axes = tuple(
            ax for ax in names if ax == "model"
            and ax not in self.sum_axes and sizes[ax] > 1)
        # the attention heads over model where it splits no rows (not in
        # a decode step); under sequence parallelism only in a layer that
        # runs on the whole sequence (:meth:`head_block`)
        self.head_axes = ("model",) if heads and "model" in names \
            and "model" not in self.axes else ()
        # a Mamba mixer's heads over model where it splits no rows (a
        # decode step too: its state has no sequence); under sequence
        # parallelism in the layer, which runs on the whole sequence
        self.ssm_axes = ("model",) if "model" in names \
            and "model" not in self.axes else ()
        # the vocab over model where the tokens that reach the head are
        # split over neither the rows nor the sequence (:meth:`top`)
        self.vocab_axes = ("model",) if "model" in names \
            and "model" not in self.axes and not self.seq_axes else ()
        self._vocab: dict = {}      # "embed" / "head" -> (first, rows)
        # the MoE experts over model wherever their count divides it
        self.expert_axes = ("model",) if "model" in names else ()
        # {batch blocks a dispatch chunk spans: the mesh of its holders}
        # (:func:`holder_mesh`, made when the step is built)
        self.holders = dict(holders or {})
        self.msz = sizes.get("model", 1)
        self.model_index = dict(zip(names, mesh.get_coordinate())).get(
            "model", 0)
        self._whole = 0
        self._seq_len = seq_len
        self._block = seq_len // self.seq_n    # a block's positions
        self._heads: Optional[tuple] = None    # (heads, offset, count)
        self.replicated = tuple(Replicate() for _ in names)
        self.blocks: dict = {}      # id of a cache block -> (it, SeqBlock)
        self.experts: dict = {}     # (spec, b, s) -> ExpertSplit
        # what the step split: head, Mamba head, vocab and expert blocks
        # (a record for the caller, filled as the layers run)
        self.log = log if log is not None else {}

    # -- parameters --------------------------------------------------------
    def gather(self, t: Any) -> Any:
        if not isinstance(t, DTensor):
            return t
        full = t.redistribute(self.mesh, self.replicated)
        if t.requires_grad:
            return full.to_local(grad_placements=self.grad_placements)
        return full.to_local()

    def params(self, tree: Any, heads: Optional[int] = None) -> Any:
        """``tree`` gathered; a layer's dense MLP (its ``mlp`` subtree)
        keeps its ``model`` blocks where the step runs it tensor-parallel
        (:meth:`tp_gather`), its attention (``attn``, ``cross``) or its
        Mamba mixer (``mix``) where its ``heads`` split over ``model``
        (:meth:`head_block`, :meth:`ssm_block`), and a MoE's expert
        banks their block of experts where ``model`` splits them (the
        ``expert`` rule)."""
        if not isinstance(tree, dict):
            return tree_map(self.gather, tree)
        out = {}
        for k, v in tree.items():
            if k == "mlp" and self.tp_axes and self._tp_mlp(v):
                out[k] = tree_map(self.tp_gather, v)
            elif k in HEAD_TREES and heads is not None \
                    and self.head_block(heads) is not None:
                out[k] = tree_map(self.model_gather, v)
            elif k == "mix" and heads is not None \
                    and self.ssm_block(heads) is not None:
                # a Mamba mixer's head block: its ``ssm_inner`` leaves
                # keep their blocks; the conv, whose channels at rest
                # are not laid out by heads, comes whole
                out[k] = {n: tree_map(self.model_whole if n == "conv"
                                      else self.model_gather, w)
                          for n, w in v.items()}
            elif k == "moe" and self._expert_banks(v):
                out[k] = {b: tree_map(self.model_gather, w) if b in BANKS
                          else self.params(w) for b, w in v.items()}
            else:
                out[k] = self.params(v)
        return out

    def _expert_banks(self, moe) -> bool:
        """Whether a MoE subtree's banks are split over ``model`` by
        their expert dim at rest."""
        if not isinstance(moe, dict) or "wi" not in moe \
                or not self.expert_axes:
            return False
        mi = self.mesh.mesh_dim_names.index("model")
        return all(isinstance(t, DTensor) and t.placements[mi] == Shard(0)
                   for t in tree_leaves(moe["wi"]))

    def _tp_mlp(self, mlp) -> bool:
        """Whether an MLP subtree's ``wi`` (the frozen weight, or the
        adapter's ``b`` in the trained tree: both end in ``d_ff``) is
        split by columns over the tensor-parallel axes at rest."""
        if not isinstance(mlp, dict) or "wi" not in mlp:
            return False
        w = next((mlp["wi"][k] for k in ("w", "w_q8", "b")
                  if k in mlp["wi"]), None)
        if not isinstance(w, DTensor):
            return False
        last = w.ndim - 1
        return all(isinstance(p, Shard) and p.dim == last
                   for ax, p in zip(self.mesh.mesh_dim_names, w.placements)
                   if ax in self.tp_axes)

    def tp_gather(self, t: Any) -> Any:
        return self.block_gather(t, self.tp_axes)

    def model_gather(self, t: Any) -> Any:
        return self.block_gather(t, ("model",))

    def model_whole(self, t: Any) -> Any:
        """``t`` whole, used by every ``model`` rank for its block."""
        return self.block_gather(t, ("model",), keep=False)

    def block_gather(self, t: Any, axes: tuple, keep: bool = True) -> Any:
        """``t`` gathered over every axis but ``axes``, where it keeps its
        block (everywhere, without ``keep``); a leaf whole on those axes
        is used by every rank for its part of the output, so its
        gradient adds over them."""
        if not isinstance(t, DTensor):
            return t
        keep = tuple(p if keep and ax in axes and isinstance(p, Shard)
                     else Replicate()
                     for ax, p in zip(self.mesh.mesh_dim_names,
                                      t.placements))
        local = t.redistribute(self.mesh, keep)
        if not t.requires_grad:
            return local.to_local()
        grad = tuple(
            k if isinstance(k, Shard) else
            Partial() if ax in self.sum_axes + tuple(axes) else
            Replicate()
            for ax, k in zip(self.mesh.mesh_dim_names, keep))
        return local.to_local(grad_placements=grad)

    def tp_enter(self, x: torch.Tensor) -> torch.Tensor:
        return _TpEnter.apply(x, self.mesh, self.tp_axes)

    def tp_exit(self, x: torch.Tensor) -> torch.Tensor:
        return _TpExit.apply(x, self.mesh, self.tp_axes)

    def top(self, tree: dict) -> dict:
        """``tree`` with every subtree but those gathered at use (the
        layer stacks, a shared attention) gathered; the
        embedding and the head keep their ``model`` blocks of the vocab
        where it splits over ``model`` (the ``vocab`` rule: the
        embedding's rows, the head's columns, the adapter's ``b`` by
        columns and its ``a`` whole)."""
        out = {}
        for k, v in tree.items():
            if k in AT_USE:
                out[k] = v
            elif k in VOCAB_TREES and self._vocab_split(k, v):
                out[k] = tree_map(self.model_gather, v)
            else:
                out[k] = self.params(v)
        return out

    def _vocab_split(self, k: str, tree: dict) -> bool:
        """Whether an embedding's or a head's vocab dim (the embedding's
        rows, the head's last dim) is split over ``model`` at rest and
        the step keeps the blocks; records the block."""
        if not self.vocab_axes or not isinstance(tree, dict):
            return False
        mi = self.mesh.mesh_dim_names.index("model")
        n = None
        for nm in ("w", "w_q8", "b"):
            t = tree.get(nm)
            if not isinstance(t, DTensor):
                continue
            dim = 0 if k == "embed" else t.ndim - 1
            if t.placements[mi] != Shard(dim):
                return False
            n = t.shape[dim]
        if n is None:
            return False
        c = n // self.msz
        self._vocab[k] = (self.model_index * c, c)
        self.log.setdefault("vocab", set()).add((k, n, *self._vocab[k]))
        return True

    def vocab_block(self, kind: str) -> Optional[tuple[int, int]]:
        """(first row, rows) of this rank's block of the vocab of the
        embedding (``kind`` "embed") or the head ("head") where
        :meth:`top` kept it, else None."""
        return self._vocab.get(kind)

    def vocab_enter(self, x: torch.Tensor) -> torch.Tensor:
        """The head's input, whose gradient adds over the vocab blocks."""
        return _TpEnter.apply(x, self.mesh, self.vocab_axes)

    def vocab_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the vocab blocks (in fp32) of a quantity every
        rank then holds whole: the identity backward."""
        return _TpExit.apply(x, self.mesh, self.vocab_axes)

    def vocab_max(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the vocab blocks (no gradient)."""
        return max_over(x.detach(), self.mesh, self.vocab_axes)

    def vocab_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The vocab blocks of the last dim gathered, in vocab order."""
        return cat_last_over(x, self.mesh, self.vocab_axes)

    # -- attention heads -----------------------------------------------------
    def head_block(self, h: int) -> Optional[tuple[int, int]]:
        """(first head, heads) of this rank's block of an attention's ``h``
        (padded) query heads where they split over ``model`` (the
        reference's ``heads`` rule: ``model`` divides them and splits
        nothing else here), else None. Remembers ``h`` for
        :meth:`narrow_heads`."""
        if not self.head_axes or h % self.msz \
                or (self.seq_axes and not self._whole):
            self._heads = None
            return None
        c = h // self.msz
        self._heads = (h, self.model_index * c, c)
        self.log.setdefault("heads", set()).add(self._heads)
        return self._heads[1:]

    def narrow_heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of dim ``dim`` where it holds every head of
        the attention that last asked for its block (keys and values
        after the GQA repeat); else ``x``."""
        if self._heads is None or x.shape[dim] != self._heads[0]:
            return x
        return x.narrow(dim, self._heads[1], self._heads[2])

    def heads_enter(self, x: torch.Tensor,
                    axes: Optional[tuple] = None) -> torch.Tensor:
        """An attention's input (a Mamba mixer's, with ``axes`` its
        :attr:`ssm_axes`), whose gradient adds over the ranks' head
        blocks; under sequence parallelism the whole-sequence input is
        already a gather whose backward sums."""
        if self.seq_axes:
            return x
        return _TpEnter.apply(x, self.mesh, self.head_axes if axes is None
                              else axes)

    def heads_exit(self, y: torch.Tensor,
                   axes: Optional[tuple] = None) -> torch.Tensor:
        """The sum of the head blocks' partial outputs (the row-parallel
        ``wo``, in fp32); under sequence parallelism reduce-scattered
        onto this rank's block of the sequence."""
        if self.seq_axes:
            return _ReduceScatter.apply(y.to(torch.float32), self.mesh,
                                        "model", 1).to(y.dtype)
        return _TpExit.apply(y, self.mesh, self.head_axes if axes is None
                             else axes)

    # -- Mamba heads ---------------------------------------------------------
    def _ssm_split(self, h: int) -> bool:
        return bool(self.ssm_axes) and h % self.msz == 0 \
            and not (self.seq_axes and not self._whole)

    def ssm_block(self, h: int) -> Optional[tuple[int, int]]:
        """(first head, heads) of this rank's block of a Mamba mixer's
        ``h`` heads where they split over ``model`` (the reference's
        ``ssm_heads`` / ``ssm_inner`` rules: ``model`` divides them and
        splits no rows, nor here the sequence), else None."""
        if not self._ssm_split(h):
            return None
        c = h // self.msz
        blk = (h, self.model_index * c, c)
        self.log.setdefault("ssm_heads", set()).add(blk)
        return blk[1:]

    def ssm_enter(self, x: torch.Tensor) -> torch.Tensor:
        return self.heads_enter(x, self.ssm_axes)

    def ssm_exit(self, y: torch.Tensor) -> torch.Tensor:
        return self.heads_exit(y, self.ssm_axes)

    def ssm_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the head blocks of a quantity each block gives a
        part of and uses whole (the gated norm's sum of squares): its
        gradient is the same sum."""
        return _SumOver.apply(x, self.mesh, self.ssm_axes)

    def ssm_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The head blocks' channels of the last dim gathered, in order
        (a decode cache's conv inputs; no gradient)."""
        return cat_last_over(x, self.mesh, self.ssm_axes)

    # -- MoE experts ---------------------------------------------------------
    def check_experts(self, n_experts: int) -> None:
        """Refuse a MoE of ``n_experts`` that ``model`` cannot split."""
        if not self.expert_axes or n_experts % self.msz:
            raise ValueError(
                f"a sharded MoE needs a model axis that divides its "
                f"{n_experts} experts; the mesh has "
                f"{dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))}")

    def expert_split(self, spec, b: int, s: int) -> "ExpertSplit":
        """The dispatch of a MoE layer over ``b`` x ``s`` local tokens
        split over the mesh: its experts over ``model``."""
        self.check_experts(spec.n_experts)
        key = (spec, b, s, self.seq_split())
        if key not in self.experts:
            self.experts[key] = ExpertSplit(self, spec, b, s)
        return self.experts[key]

    def token_ids(self, t: int) -> torch.Tensor:
        """The places of this rank's ``t`` local tokens in its step's
        (micro)batch, row-major over (rows, sequence)."""
        return torch.as_tensor(_token_ids(self, None, t))

    # -- batch -------------------------------------------------------------
    def batch_block(self, t: DTensor, dim: int) -> torch.Tensor:
        """This rank's rows (dim ``dim`` split over ``axes``) of a batch
        leaf, redistributed from its placements at rest."""
        target = placements_for(self.mesh, {ax: dim for ax in self.axes})
        return t.redistribute(self.mesh, target).to_local()

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sum_axes:
            return x
        return _SumOver.apply(x, self.mesh, self.sum_axes)

    def _token_axes(self) -> tuple:
        """The axes that split a MoE layer's tokens: the rows', and the
        sequence's where the layer runs on a sequence block."""
        return self.sum_axes if self.seq_split() else self.axes

    def token_sum(self, x: torch.Tensor) -> torch.Tensor:
        axes = self._token_axes()
        if not axes:
            return x
        return _SumOver.apply(x, self.mesh, axes)

    def token_total(self, t: int) -> int:
        return t * (self.n if self.seq_split() else self.n_rows)

    # -- sequence parallelism -----------------------------------------------
    def seq_split(self) -> bool:
        return bool(self.seq_axes) and not self._whole

    def seq_offset(self) -> int:
        return self._block * self.seq_index if self.seq_split() else 0

    def seq_slice(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        if not self.seq_split():
            return x
        c = x.shape[dim] // self.seq_n
        return x.narrow(dim, self.seq_index * c, c)

    def seq_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        if not self.seq_split():
            return x
        for ax in reversed(self.seq_axes):
            x = _wait(funcol.all_gather_tensor_autograd(
                x.contiguous(), dim, _dim(self.mesh, ax)))
        return x

    @contextlib.contextmanager
    def whole_seq(self):
        self._whole += 1
        try:
            yield
        finally:
            self._whole -= 1

    # -- caches ------------------------------------------------------------
    def seq_block(self, t) -> Optional[SeqBlock]:
        got = self.blocks.get(id(t))
        return got[1] if got is not None and got[0] is t else None

    def layer_cache(self, tree: dict, i: int):
        """Layer ``i`` of each stacked cache leaf: a KV or latent cache
        as this rank's block (registered for :meth:`seq_block`), a Mamba
        state (``ssm``: (B, H, P, N)) as its block of heads where they
        split (:meth:`ssm_block`), any other gathered to hold every
        head and channel of this rank's batch rows; and a function that
        writes the gathered ones back into this rank's shards."""
        out, backs = {}, []
        for k, v in tree.items():
            if not isinstance(v, DTensor):
                out[k] = v[i]
                continue
            local = v.to_local()[i]
            pl = _layer_placements(v.placements)
            if k in SEQ_CACHES:
                axes = [ax for ax, p in zip(self.mesh.mesh_dim_names, pl)
                        if isinstance(p, Shard) and p.dim == 1]
                if any(isinstance(p, Shard) and p.dim > 1 for p in pl):
                    raise ValueError(f"cache {k!r} split past its sequence")
                out[k] = local
                if axes:
                    idx, n = block_index(self.mesh, axes)
                    s_ = local.shape[1]
                    self.blocks[id(local)] = (local, SeqBlock(
                        self.mesh, axes, idx * s_, n * s_))
                continue
            heads = k == "ssm" and self._ssm_split(v.shape[2])
            keep = tuple(p if isinstance(p, Shard) and p.dim == 0
                         else Shard(1) if heads and ax in self.ssm_axes
                         else Replicate()
                         for ax, p in zip(self.mesh.mesh_dim_names, pl))
            if keep == pl:
                out[k] = local
                continue
            shape = tuple(v.shape[1:])
            full = as_dtensor(local, self.mesh, pl, shape).redistribute(
                self.mesh, keep).to_local()
            out[k] = full
            backs.append((local, full, pl, keep, shape))

        def put_back():
            for local, full, pl, keep, shape in backs:
                local.copy_(as_dtensor(full, self.mesh, keep, shape)
                            .redistribute(self.mesh, pl).to_local())
        return out, put_back


# ---------------------------------------------------------------------------
# the MoE dispatch over the mesh
# ---------------------------------------------------------------------------

def _token_ids(step: LocalStep, coord: Optional[dict], t: int,
               share: int = 1) -> np.ndarray:
    """The places, in the step's (micro)batch of tokens (row-major over
    rows and sequence), of the ``t`` local tokens of the rank at mesh
    coordinates ``coord`` (this rank's where None); with ``share`` > 1
    only its part of them, one of ``share`` by its ``model``
    coordinate."""
    mesh = step.mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    coord = coord or dict(zip(names, mesh.get_coordinate()))

    def block(axes):
        idx = 0
        for ax in names:
            if ax in axes:
                idx = idx * sizes[ax] + coord[ax]
        return idx

    seq = step.seq_split()
    s = step._block if seq else None
    l = np.arange(t, dtype=np.int64)
    if s is None:
        ids = block(step.axes) * t + l
    else:
        ids = ((block(step.axes) * (t // s) + l // s) * step._seq_len
               + block(step.seq_axes) * s + l % s)
    if share > 1:
        c = t // share
        ids = ids[coord["model"] * c:(coord["model"] + 1) * c]
    return ids


class Chunk(NamedTuple):
    """A dispatch chunk as one rank of :class:`ExpertSplit` sees it."""
    lo: int                 # this rank's tokens [lo, hi) in it (its share)
    hi: int
    own_p: np.ndarray       # (chunk,): the group member holding each token
    own_l: np.ndarray       # (chunk,): the token's place in the member's
    at: np.ndarray          # (hi - lo,): this rank's tokens' places in it
    most: int               # the most tokens a member holds in it


def chunk_span(spec, total: int, n_bb: int) -> int:
    """The batch blocks that hold one dispatch chunk of a MoE layer over
    ``total`` tokens (``moe.n_chunks_for``, in row-major order) split
    into ``n_bb`` equal batch blocks: 1 where each block holds whole
    chunks, the run of blocks a chunk covers where that run divides
    them, else every block."""
    from repro_torch.models.moe import n_chunks_for
    tc = total // n_chunks_for(spec, total)
    tb = total // n_bb
    if tb % tc == 0:
        return 1
    if tc % tb == 0 and n_bb % (tc // tb) == 0:
        return tc // tb
    return n_bb


def holder_mesh(mesh, batch_axes, span: int):
    """A mesh over the same ranks whose ``holders`` axis is each run of
    ``span`` batch blocks (over ``batch_axes``, in their order) that
    hold one dispatch chunk, between the ``runs`` of them and ``model``
    (the other axes first). Its process groups are made here: every
    rank calls this, in the same order, when a step is built."""
    from torch.distributed.device_mesh import DeviceMesh
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    other = [ax for ax in names if ax not in batch_axes and ax != "model"]
    tail = ["model"] if "model" in names else []
    order = other + [ax for ax in names if ax in batch_axes] + tail
    n_bb = math.prod(sizes[ax] for ax in batch_axes)
    ranks = mesh.mesh.permute([names.index(ax) for ax in order]).reshape(
        *(sizes[ax] for ax in other), n_bb // span, span,
        *(sizes[ax] for ax in tail))
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=(
        *other, "runs", "holders", *tail))


class ExpertSplit:
    """A MoE layer's dispatch over the mesh (expert parallelism, the
    reference's ``expert`` and ``tokens`` rules): the static layout of a
    layer called on ``b`` x ``s`` local tokens, and the exchanges of
    ``moe._dispatch_split``.

    * Experts: rank ``j`` of ``model`` holds experts ``[j E/m, (j + 1)
      E/m)`` of every bank (``LocalStep.params``) and computes those rows
      of each dispatch chunk's (E, C, d) buffer, for every token of the
      chunk.
    * Tokens: the step's rows split them over the batch axes (and
      ``model``, where it splits the rows), a sequence-parallel layer's
      blocks over ``model``; where ``model`` splits neither and divides
      the rank's tokens, each ``model`` rank dispatches its share of them
      (the ``tokens`` rule) and the outputs are gathered after. The
      router runs on every local token (its gradient stays whole).
    * A chunk (``moe.n_chunks_for`` over the (micro)batch's tokens, in
      their row-major order, as the one-card step cuts them) is
      dispatched only by the ranks of the batch blocks that hold its
      tokens (:func:`chunk_span`): within one batch block (``local``);
      by a run of them, over the ``holders`` axis of the mesh that the
      step was built with (:func:`holder_mesh`); else by every batch
      block. Across blocks the partial buffers add over them, the
      capacity rows split over the ``holders`` (or ``data``) axis where
      it divides them (a reduce-scatter; else an all-reduce).
    * ``mode``: ``"a2a"`` where ``model`` splits the tokens (each kept
      pair's row goes to its expert's owner by an all-to-all over
      ``model`` and comes back by another), ``"rep"`` where every
      ``model`` rank holds the same tokens (each fills its own experts'
      rows; the pairs' rows add over ``model``, one rank holding each).

    Every rank computes each of its chunks' dispatch order from the
    expert ids of all the chunk's tokens (gathered over ``group``), so
    which pairs a capacity drops is the one-card step's."""

    def __init__(self, step: LocalStep, spec, b: int, s: int):
        from repro_torch.models.moe import n_chunks_for
        mesh = step.mesh
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        sizes = axis_sizes(mesh)
        t = b * s
        seq = step.seq_split()
        self.msz = sizes["model"]
        self.j = dict(zip(names, mesh.get_coordinate()))["model"]
        self.eb = spec.n_experts // self.msz
        split = "model" in step.axes or (seq and "model" in step.seq_axes)
        # model shares the rank's tokens (the tokens rule); at one model
        # rank too, whose share is every token
        self.shared = not split and t % self.msz == 0
        self.share = self.msz if self.shared else 1
        self.mode = "a2a" if split or self.shared else "rep"
        total = step.token_total(t)
        n_chunks = n_chunks_for(spec, total)
        tc = total // n_chunks
        batch_axes = tuple(ax for ax in names
                           if ax in step.axes and ax != "model")
        n_bb = math.prod(sizes[ax] for ax in batch_axes)
        span = chunk_span(spec, total, n_bb)
        self.local = span == 1
        # the mesh whose axes ``da`` reach the other holders of a chunk
        hm = step.holders.get(span) if 1 < span < n_bb else None
        self.gmesh = mesh if hm is None else hm
        self.da = () if self.local else ("holders",) if hm is not None \
            else batch_axes
        gnames = tuple(self.gmesh.mesh_dim_names)
        self.group = tuple(ax for ax in gnames if ax in self.da
                           or (ax == "model" and self.mode == "a2a"))
        self.m_group = self.msz if self.mode == "a2a" else 1
        gsizes = axis_sizes(self.gmesh)
        self.n_members = math.prod(gsizes[ax] for ax in self.group)
        # each member's mesh coordinates, in the group's gather order
        where = {int(r): dict(zip(names, i))
                 for i, r in np.ndenumerate(mesh.mesh.cpu().numpy())}
        gcoord = dict(zip(gnames, self.gmesh.get_coordinate()))
        granks = self.gmesh.mesh.cpu().numpy()
        ids, me = [], 0
        for p in range(self.n_members):
            c, rem = dict(gcoord), p
            for ax in reversed(self.group):
                c[ax], rem = rem % gsizes[ax], rem // gsizes[ax]
            if c == gcoord:
                me = p
            rank = int(granks[tuple(c[ax] for ax in gnames)])
            ids.append(_token_ids(step, where[rank], t, self.share))
        self.ids = np.stack(ids)            # (members, tokens a member)
        self.me = me
        # the chunks the group holds (each whole): this rank's
        self.chunks: list[Chunk] = []
        for c in range(n_chunks):
            inside = (self.ids >= c * tc) & (self.ids < (c + 1) * tc)
            held = int(inside.sum())
            if held == 0:
                continue
            if held != tc:
                raise ValueError(f"MoE chunk {c} of {tc} tokens is not "
                                 f"held by the ranks of {self.group}")
            own_p = np.empty(tc, dtype=np.int64)
            own_l = np.empty(tc, dtype=np.int64)
            p_, l_ = np.nonzero(inside)
            own_p[self.ids[p_, l_] - c * tc] = p_
            own_l[self.ids[p_, l_] - c * tc] = l_
            mine = np.nonzero(inside[me])[0]
            lo, hi = (int(mine[0]), int(mine[-1]) + 1) if len(mine) \
                else (0, 0)
            self.chunks.append(Chunk(lo, hi, own_p, own_l,
                                     self.ids[me, lo:hi] - c * tc,
                                     int(inside.sum(1).max())))
        # the axis of ``da`` that splits the capacity rows
        self.cap_ax = "holders" if hm is not None else \
            "data" if "data" in self.da and sizes["data"] > 1 else None
        self.dsz = gsizes.get(self.cap_ax, 1)
        self.i = gcoord.get(self.cap_ax, 0)
        self._dev: dict = {}
        self.log = step.log
        self.log.setdefault("experts", set()).add(
            (self.j * self.eb, self.eb, self.mode, len(self.chunks)))

    def tensors(self, ch: Chunk, dev) -> tuple:
        """(own_p, own_l, at) of a chunk on ``dev`` (copied once)."""
        key = (id(ch), str(dev))
        if key not in self._dev:
            self._dev[key] = tuple(torch.as_tensor(a, device=dev)
                                   for a in (ch.own_p, ch.own_l, ch.at))
        return self._dev[key]

    def c_block(self, cap: int) -> tuple[int, int]:
        """(first row, rows) of this rank's capacity block of a chunk's
        buffer of ``cap`` rows an expert: split over the chunk's
        ``holders`` (or ``data``) where its tokens span them and they
        divide the rows."""
        blk = (0, cap)
        if self.cap_ax is not None and cap % self.dsz == 0:
            c = cap // self.dsz
            blk = (self.i * c, c)
        self.log.setdefault("capacity", set()).add(blk + (cap,))
        return blk

    def mine(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of its local tokens (dim 0)."""
        if not self.shared:
            return x
        return _RepSlice.apply(x, self.mesh, "model", self.j, self.share)

    def whole(self, y: torch.Tensor) -> torch.Tensor:
        """The shares' outputs gathered back into the local tokens'."""
        if not self.shared:
            return y
        return _RepGather.apply(y, self.mesh, "model", self.j)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(members, *x.shape): ``x`` of every member of the group."""
        if not self.group:
            return x[None]
        g = gather_over(x, self.gmesh, self.group)
        return g.reshape(self.n_members, *x.shape)

    def a2a(self, x: torch.Tensor) -> torch.Tensor:
        return _AllToAll.apply(x, self.mesh, "model")

    def rep_enter(self, x: torch.Tensor) -> torch.Tensor:
        return _TpEnter.apply(x, self.mesh, ("model",))

    def rep_exit(self, x: torch.Tensor) -> torch.Tensor:
        return _TpExit.apply(x, self.mesh, ("model",))

    def reduce(self, buf: torch.Tensor, cap: int) -> torch.Tensor:
        """A chunk's partial (E/m, cap, d) buffer summed over the batch
        blocks that hold the chunk (each row filled on one rank), kept
        as this rank's capacity block."""
        for ax in self.da:
            if ax == self.cap_ax and self.c_block(cap)[1] < cap:
                buf = _ReduceScatter.apply(buf, self.gmesh, ax, 1)
            else:
                buf = _SumOver.apply(buf, self.gmesh, (ax,))
        return buf

    def unreduce(self, out: torch.Tensor, cap: int) -> torch.Tensor:
        """The capacity blocks' outputs gathered back (the adjoint of
        :meth:`reduce`'s reduce-scatter)."""
        if self.c_block(cap)[1] < cap:
            out = _wait(funcol.all_gather_tensor_autograd(
                out.contiguous(), 1, _dim(self.gmesh, self.cap_ax)))
        return out
