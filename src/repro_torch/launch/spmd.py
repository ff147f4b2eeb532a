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
    Mamba layer's state (split over heads or channels) is gathered and
    written back after the layer.
  * ``batch_sum``, ``token_sum``, ``token_block``, ``pair_offsets``: the
    sums over the batch that the reference computes over all tokens (the
    loss, the MoE aux loss and dispatch).
  * tensor parallelism of the dense MLPs over ``model`` where nothing
    else splits the work over it (a prefill's or a decode's rows, a train
    step's that ``model`` does not divide, without ``seq_parallel``):
    each rank keeps its ``model`` block of the MLP's weights (``wi`` /
    ``wg`` by columns, ``wo`` by rows, as the reference shards them),
    runs its share of the hidden units and adds the partial outputs
    over ``model`` (Megatron's column/row split: ``tp_enter`` is the
    identity with an all-reduce backward, ``tp_exit`` an all-reduce
    with the identity backward).
  * sequence parallelism (``seq_axes``, a plan's ``seq_parallel``): the
    residual stream holds this rank's block of the sequence over
    ``model``, each token-wise layer (norms, projections, MLPs, the
    loss) runs on the block, attention gathers the keys and values of
    the whole sequence (``seq_gather``, whose backward reduce-scatters)
    for the block's queries at their positions; a layer without such a
    form (sliding-window attention, Mamba) gathers its input, runs on
    the whole sequence and keeps its block of the output, and so does a
    MoE feed-forward (its dispatch order runs over whole rows).

Every collective is a ``torch.distributed._functional_collectives`` call
(DTensor's own or this module's) over one named mesh axis, which
``utils/comm.py`` ``record_funcol`` counts.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.utils.tree import tree_map

# the subtrees of a parameter tree stacked over layers (gathered layer by
# layer); every other subtree is gathered once at the start of a step
LAYER_STACKS = ("groups", "enc", "dec")


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
        x = x.contiguous()
        for ax in self.axes:
            x = _wait(funcol.all_reduce(x, "max", _dim(self.mesh, ax)))
        return x


class LocalStep:
    """What a sharded step's model code needs from the other ranks (see
    the module docstring); installed with ``pcontext.use_local``.
    ``axes``: the mesh axes that split the step's batch rows."""

    def __init__(self, mesh, axes=(), seq_axes=(), seq_len: int = 0):
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
        # tensor parallelism where model would otherwise repeat the work
        self.tp_axes = tuple(
            ax for ax in mesh.mesh_dim_names if ax == "model"
            and ax not in self.sum_axes and axis_sizes(mesh)[ax] > 1)
        self._whole = 0
        self._block = seq_len // self.seq_n    # a block's positions
        self.replicated = tuple(Replicate() for _ in mesh.mesh_dim_names)
        self.blocks: dict = {}      # id of a cache block -> (it, SeqBlock)

    # -- parameters --------------------------------------------------------
    def gather(self, t: Any) -> Any:
        if not isinstance(t, DTensor):
            return t
        full = t.redistribute(self.mesh, self.replicated)
        if t.requires_grad:
            return full.to_local(grad_placements=self.grad_placements)
        return full.to_local()

    def params(self, tree: Any) -> Any:
        """``tree`` gathered; a layer's dense MLP (its ``mlp`` subtree)
        keeps its ``model`` blocks where the step runs it tensor-parallel
        (:meth:`tp_gather`)."""
        if isinstance(tree, dict) and self.tp_axes \
                and self._tp_mlp(tree.get("mlp")):
            return {k: tree_map(self.tp_gather, v) if k == "mlp"
                    else self.params(v) for k, v in tree.items()}
        return tree_map(self.gather, tree)

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
        """``t`` gathered over every axis but the tensor-parallel ones,
        where it keeps its block; a leaf whole on those axes is used by
        every rank for its part of the output, so its gradient adds
        over them."""
        if not isinstance(t, DTensor):
            return t
        keep = tuple(p if ax in self.tp_axes and isinstance(p, Shard)
                     else Replicate()
                     for ax, p in zip(self.mesh.mesh_dim_names,
                                      t.placements))
        local = t.redistribute(self.mesh, keep)
        if not t.requires_grad:
            return local.to_local()
        grad = tuple(
            k if isinstance(k, Shard) else
            Partial() if ax in self.sum_axes + self.tp_axes else
            Replicate()
            for ax, k in zip(self.mesh.mesh_dim_names, keep))
        return local.to_local(grad_placements=grad)

    def tp_enter(self, x: torch.Tensor) -> torch.Tensor:
        return _TpEnter.apply(x, self.mesh, self.tp_axes)

    def tp_exit(self, x: torch.Tensor) -> torch.Tensor:
        return _TpExit.apply(x, self.mesh, self.tp_axes)

    def top(self, tree: dict) -> dict:
        """``tree`` with every subtree but the layer stacks gathered."""
        return {k: v if k in LAYER_STACKS else self.params(v)
                for k, v in tree.items()}

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

    def token_sum(self, x: torch.Tensor) -> torch.Tensor:
        if not self.axes:
            return x
        return _SumOver.apply(x, self.mesh, self.axes)

    def token_block(self, t: int) -> tuple[int, int]:
        return self.index * t, self.n_rows * t

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

    def pair_offsets(self, counts: torch.Tensor, t: int,
                     chunk: int) -> torch.Tensor:
        per = chunk // t                  # ranks that share a chunk
        every = gather_over(counts, self.mesh, self.axes)   # (n_rows, E)
        first = self.index - self.index % per
        return every[first:self.index].sum(0)

    # -- caches ------------------------------------------------------------
    def seq_block(self, t) -> Optional[SeqBlock]:
        got = self.blocks.get(id(t))
        return got[1] if got is not None and got[0] is t else None

    def layer_cache(self, tree: dict, i: int):
        """Layer ``i`` of each stacked cache leaf: a KV or latent cache
        as this rank's block (registered for :meth:`seq_block`), any
        other gathered to hold every head and channel of this rank's
        batch rows; and a function that writes the gathered ones back
        into this rank's shards."""
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
            keep = tuple(p if isinstance(p, Shard) and p.dim == 0
                         else Replicate() for p in pl)
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
