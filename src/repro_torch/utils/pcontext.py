"""Step-time sharding context, the JAX package's ``utils/pcontext.py``.

The model code is mesh-agnostic; a sharded step (``launch/steps.py``)
installs a context around its call. Without one every function here is
a no-op, so unit tests and the one-card path are untouched.

``use(fn)`` / ``constrain(x, kind)`` are the reference's: layers call
``constrain`` at the points where the reference's partitioner is known
to drop shardings (gather/scatter outputs, cache writes), with the same
kinds. ``launch.steps.make_constrain`` builds the callback; on a
DTensor it is a ``redistribute`` to the kind's placements.

Kinds (see launch.steps.make_constrain):
  residual    (B, S, D)      batch x [seq-parallel] x -
  heads       (B, S, H, Dh)  batch x - x model x -
  kv_chunks   (N, B, C, H, D) - x batch x - x model x -
  tokens      (T, D)         batch x -
  expert      (E, C, D)      model x - x -
  cache4      (B, S, Hkv, D) batch x model-on-seq x - x -
  cache3      (B, S, C)      batch x model-on-seq x -
  cache_stack (L, B, S, ...) - x batch x model-on-seq x ...

The port's sharded step computes on each rank's local blocks (plain
tensors) rather than through DTensor's operator-by-operator sharding
propagation. ``use_local(ctx)`` installs the object that supplies what
such a computation needs from the other ranks; the model code reaches
it through the functions below, each the identity without it:

  params(tree, heads)    a layer's parameters as full local tensors
                         (all-gathered at use; their gradients reduce
                         back to the owners' shards), but for the blocks
                         a split keeps: the dense MLP's (tensor
                         parallelism), the attention's or the Mamba
                         mixer's where its ``heads`` split, the MoE
                         banks' where the experts split;
  head_block(h)          (first head, heads) of this rank's block of an
                         attention's query heads where they split over
                         ``model`` (column-parallel q, row-parallel
                         ``wo``), else None; heads_enter(x) /
                         heads_exit(y) the input whose gradient adds
                         over the blocks and the blocks' partial outputs
                         summed (under sequence parallelism
                         reduce-scattered onto the sequence block);
  ssm_block(h)           (first head, heads) of this rank's block of a
                         Mamba mixer's heads where they split over
                         ``model`` (``wz`` / ``wx`` / the norm by
                         channels, ``wo`` by rows, the per-head leaves
                         and the state by heads), else None;
                         ssm_enter(x) / ssm_exit(y) as heads_enter /
                         heads_exit; ssm_sum(x) the gated norm's sum of
                         squares over the blocks (its gradient the same
                         sum); ssm_gather(x) the blocks' channels of a
                         conv cache gathered;
  vocab_block(kind)      (first row, rows) of this rank's block of the
                         vocab of the embedding or the head where it
                         splits over ``model``, else None;
                         vocab_enter(x) the head's input (its gradient
                         summed over the blocks), vocab_sum(x) /
                         vocab_max(x) a sum (identity backward) / max
                         over the blocks, vocab_gather(x) the logits'
                         blocks gathered;
  expert_split(spec, b, s)
                         a MoE dispatch split over the mesh (experts
                         over ``model``, each kept pair's row sent to its
                         expert's owner; a sharded step's only
                         dispatch), else None; token_ids(t) the places
                         of the local tokens in the batch;
  layer_cache(tree, i)   layer ``i`` of a stacked cache tree as local
                         tensors, and a function that writes the updated
                         layer back into this rank's shards: a KV or
                         latent cache keeps this rank's block of the
                         sequence (split-KV decode), a Mamba state its
                         block of heads where they split, any other
                         cache is gathered whole;
  seq_block(t)           for such a block, its place in the whole
                         sequence and the sums and maxima over the ranks
                         that hold the other blocks (None for a whole
                         cache);
  batch_sum(x)           ``x`` summed over the ranks that split the
                         step's tokens, rows and (sequence parallelism)
                         sequence (autograd-aware): the loss;
  token_sum(x)           the same over the ranks that split a MoE
                         layer's tokens (its rows: under sequence
                         parallelism the layer sees whole rows);
  tp_enter(x), tp_exit(x)
                         a dense MLP run tensor-parallel (its weights
                         this rank's ``model`` blocks): the input's
                         gradient and the partial outputs summed over
                         ``model``;
  seq_offset(), seq_slice(x), seq_gather(x)
                         sequence parallelism (the reference's
                         ``seq_parallel`` residual constraint): the
                         residual stream holds this rank's block of the
                         sequence; the first position of the block, the
                         block of a whole-sequence tensor, and the whole
                         sequence of a block (an all-gather whose
                         gradient reduce-scatters); ``whole_seq()``
                         opens a region where a layer without a
                         sequence-parallel form runs on the whole
                         sequence (these three are then the identity);
  token_total(t)         the tokens of a MoE layer over all the ranks
                         that split them, of which this rank holds
                         ``t`` (its aux loss is over all of them).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

_current: Optional[Callable] = None
_local: Optional[Any] = None


@contextlib.contextmanager
def use(fn: Callable):
    global _current
    prev = _current
    _current = fn
    try:
        yield
    finally:
        _current = prev


def constrain(x, kind: str):
    if _current is None:
        return x
    return _current(x, kind)


@contextlib.contextmanager
def use_local(ctx: Any):
    global _local
    prev = _local
    _local = ctx
    try:
        yield
    finally:
        _local = prev


def params(tree: Any, heads: Optional[int] = None) -> Any:
    """``heads``: the (padded) query heads of the layer's attention,
    which keeps this rank's head block where they split."""
    return tree if _local is None else _local.params(tree, heads)


def local():
    """The installed local-block context (None without one)."""
    return _local


def head_block(h: int) -> Optional[tuple[int, int]]:
    """(first head, heads) of this rank's block of an attention's ``h``
    query heads where they split over ``model``; None (every head)
    without a split."""
    return None if _local is None else _local.head_block(h)


def heads_enter(x):
    return x if _local is None else _local.heads_enter(x)


def heads_exit(y):
    return y if _local is None else _local.heads_exit(y)


def ssm_block(h: int) -> Optional[tuple[int, int]]:
    """(first head, heads) of this rank's block of a Mamba mixer's ``h``
    heads where they split over ``model``; None (every head) without a
    split."""
    return None if _local is None else _local.ssm_block(h)


def ssm_enter(x):
    return x if _local is None else _local.ssm_enter(x)


def ssm_exit(y):
    return y if _local is None else _local.ssm_exit(y)


def ssm_sum(x):
    return x if _local is None else _local.ssm_sum(x)


def ssm_gather(x):
    return x if _local is None else _local.ssm_gather(x)


def vocab_block(kind: str) -> Optional[tuple[int, int]]:
    """(first row, rows) of this rank's block of the vocab of the
    embedding (``kind`` "embed") or the head ("head"); None (the whole
    vocab) without a split."""
    return None if _local is None else _local.vocab_block(kind)


def vocab_enter(x):
    return x if _local is None else _local.vocab_enter(x)


def vocab_sum(x):
    return x if _local is None else _local.vocab_sum(x)


def vocab_max(x):
    return x if _local is None else _local.vocab_max(x)


def vocab_gather(x):
    """A head's logits (..., V/m) of a vocab block gathered whole."""
    if _local is None or _local.vocab_block("head") is None:
        return x
    return _local.vocab_gather(x)


def expert_split(spec, b: int, s: int):
    """A MoE layer's dispatch split over the mesh (``launch/spmd.py``
    ``ExpertSplit``) for ``b`` x ``s`` local tokens; None without one."""
    return None if _local is None else _local.expert_split(spec, b, s)


def token_ids(t: int):
    """The places of the ``t`` local tokens in the step's (micro)batch
    (``arange(t)`` without a context)."""
    import torch
    return torch.arange(t) if _local is None else _local.token_ids(t)


def layer_cache(tree: dict, i: int) -> tuple[dict, Callable[[], None]]:
    if _local is None:
        return {k: v[i] for k, v in tree.items()}, lambda: None
    return _local.layer_cache(tree, i)


def seq_block(t):
    return None if _local is None else _local.seq_block(t)


def write_slot(cache, slot: int, value) -> None:
    """``cache[:, slot] = value`` of a decode cache, or of its block:
    only the rank whose block holds the slot writes it."""
    blk = seq_block(cache)
    if blk is not None:
        slot -= blk.offset
        if not 0 <= slot < cache.shape[1]:
            return
    cache[:, slot] = value


def batch_sum(x):
    return x if _local is None else _local.batch_sum(x)


def token_sum(x):
    return x if _local is None else _local.token_sum(x)


def tp_enter(x):
    return x if _local is None else _local.tp_enter(x)


def tp_exit(x):
    return x if _local is None else _local.tp_exit(x)


def seq_split() -> bool:
    """Whether the residual stream holds a block of the sequence."""
    return False if _local is None else _local.seq_split()


def seq_offset() -> int:
    return 0 if _local is None else _local.seq_offset()


def seq_slice(x, dim: int = 1):
    return x if _local is None else _local.seq_slice(x, dim)


def seq_gather(x, dim: int = 1):
    return x if _local is None else _local.seq_gather(x, dim)


@contextlib.contextmanager
def whole_seq():
    """A region that runs on the whole sequence (see the module
    docstring); a no-op without a context."""
    if _local is None:
        yield
        return
    with _local.whole_seq():
        yield


def token_total(t: int) -> int:
    return t if _local is None else _local.token_total(t)
