"""Step programs per (arch x shape) cell: the JAX package's
``launch/steps.py``, on one card or sharded over a ``DeviceMesh``.

``build_cell`` returns the step function ``fn`` and its arguments
``args`` (``fn(*args)`` runs one step): on the ``meta`` device shapes
only, which is what the dry run traces (``launch/dryrun_lib.py``); on a
real device the parameters drawn from seed 0 (random weights), a random
batch from seed 1 and zero caches.

  * train: ``loss_fn`` of the arch's model, its gradient on the trained
    tree (the adapters and norms), one AdamW step (weight decay 0, lr
    3e-4). With ``plan.microbatch`` M > 1 the batch is reshaped to (M,
    B/M, ...) (microbatch j holds rows j*(B/M) to (j+1)*(B/M) - 1, as
    the reference's reshape) and the fp32 gradients are summed over the
    microbatches and divided by M; the loss is their mean.
  * prefill: ``LM.prefill`` over the prompt (after a prefix-LM's
    ``prefix_embed``), or the enc-dec model's ``encode`` then
    ``cross_cache``.
  * decode: one ``decode_step`` at position ``seq - 1``, the caches of
    ``seq`` slots full, written in place.

Plans: ``microbatch`` scales activation memory down by M;
``seq_parallel`` is the reference's Megatron-SP residual constraint
(``P(batch, 'model', None)``); ``rules`` override the logical sharding
rules; ``quantize_base`` runs ``core.lora.quantize_frozen_tree`` on the
frozen tree (the int8 base); ``cfg_updates`` are ``dataclasses.replace``
overrides of the config. The reference's ``kv_cache_dtype`` is read by
none of its step builders, and the caches stay bf16 (ROADMAP C).

With a ``mesh`` (``launch/mesh.py``) every argument is a DTensor with
the reference's sharding: the parameters' and caches' placements from
the models' ``*_logical`` trees (``utils/sharding.tree_shardings``), the
batch's from :func:`_batch_sharding`, the optimizer state's from
:func:`_opt_shardings`; ``in_placements`` holds them, ``out_placements``
the outputs' (None where the reference leaves them to the compiler), and
``donate`` the argument indices whose buffers the step writes its
outputs into: ``(1, 2)`` train (the trained tree and the optimizer
state), ``(3,)`` decode (the caches), ``()`` prefill. A train or
decode step's outputs at those indices ARE the arguments (the same
local storage), so no two copies are alive at the peak.

The step computes on each rank's local blocks (``launch/spmd.py``): the
batch rows split over the batch axes (and, for train, over ``model``
where it divides them too), each layer's parameters all-gathered at use
with their gradients reduce-scattered back, the loss and the MoE's
token statistics summed over the batch ranks, a decode cache kept as
this rank's block of the sequence (split-KV), ``seq_parallel`` as the
sequence over ``model``, and where ``model`` is otherwise idle the
dense MLPs split over it by hidden units. What else splits over
``model``:

  * the attention heads (the reference's ``heads`` and ``kv_chunks``
    rules), where ``model`` divides them and splits neither the rows
    nor the queries: every prefill, a train step whose rows it does not
    divide (without ``seq_parallel``), and under ``seq_parallel`` the
    sliding-window layers, which run on the whole sequence; a decode
    step never (it has no ``heads`` constraint in the reference);
  * a Mamba mixer's heads and inner channels (the ``ssm_heads`` and
    ``ssm_inner`` rules), where ``model`` divides the heads and splits
    no rows: every prefill and decode step, a train step whose rows it
    does not divide, and under ``seq_parallel`` the Mamba layers, which
    run on the whole sequence;
  * the vocab of the embedding, the head and its cross-entropy (the
    ``vocab`` rule), where ``model`` divides it and splits neither the
    rows nor the sequence: every prefill and decode step and a train
    step whose rows it does not divide, without ``seq_parallel``;
  * the MoE experts (the ``expert`` rule), in every step (a sharded
    step refuses a MoE whose experts ``model`` does not divide; every
    config's do): a rank's block of the banks, each dispatch chunk
    dispatched by the batch blocks that hold its tokens only (over a
    mesh of its holders, :func:`_holders`, where a chunk spans some of
    them), its capacity rows split over them where they divide them,
    the tokens over the batch axes and ``model`` (the ``tokens`` rule:
    ``model`` shares a rank's tokens where it splits neither rows nor
    sequence and divides them).

The cell records them as ``head_axes``, ``ssm_axes``, ``vocab_axes``
and ``expert_axes`` beside ``tp_axes``. The reference's
``with_sharding_constraint`` points are ``utils/pcontext.constrain``
calls; :func:`make_constrain` is their
callback on DTensors (a ``redistribute`` to the kind's placements), and
on a rank's local blocks the step's own callback
(:func:`_local_constrain`) narrows a tensor of every head to the
rank's head block (``heads``, ``kv_chunks``) and a prefill's caches to
this rank's sequence block over ``model`` (``cache_stack``).

``kv_seq`` (split-KV decode): the reference maps it to ``("model",
"data")``, against the mesh order (pod, data, model) in which DTensor
lays out a dim split over several axes. The decode's rules here are
``("data", "model")``: where the batch does not take ``data`` (batch 1
decode, ``long_500k``) each rank holds a sequence block of the
reference's size, and only the order of the blocks across ranks
differs (block ``data * 16 + model`` here, ``model * 16 + data`` in the
reference).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.registry import SHAPES, ArchEntry, input_specs
from repro_torch.core.lora import quantize_frozen_logical, \
    quantize_frozen_tree
from repro_torch.launch import spmd
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.optim import adamw
from repro_torch.utils import pcontext
from repro_torch.utils.device import resolve_device
from repro_torch.utils.sharding import DEFAULT_RULES, \
    map_logical, placement_leaves, placements, tree_shardings
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

LR = 3e-4


@dataclasses.dataclass(frozen=True)
class CellPlan:
    microbatch: int = 1
    seq_parallel: bool = False
    rules: Optional[dict] = None       # sharding-rule overrides (perf iter)
    quantize_base: bool = False        # int8 frozen base (beyond paper)
    cfg_updates: Optional[dict] = None  # dataclasses.replace overrides


# default memory plans per (arch, shape); anything absent -> CellPlan()
DEFAULT_PLANS: dict[tuple[str, str], CellPlan] = {
    ("nemotron-4-340b", "train_4k"): CellPlan(microbatch=8,
                                              seq_parallel=True),
    ("qwen1.5-110b", "train_4k"): CellPlan(microbatch=8, seq_parallel=True),
    ("llama4-maverick-400b-a17b", "train_4k"): CellPlan(microbatch=16,
                                                        seq_parallel=True),
    ("deepseek-v2-236b", "train_4k"): CellPlan(microbatch=16,
                                               seq_parallel=True),
    ("minitron-4b", "train_4k"): CellPlan(microbatch=4),
    ("gemma3-4b", "train_4k"): CellPlan(microbatch=4),
    ("paligemma-3b", "train_4k"): CellPlan(microbatch=4),
    ("zamba2-2.7b", "train_4k"): CellPlan(microbatch=4),
    ("mamba2-370m", "train_4k"): CellPlan(microbatch=4),
    ("seamless-m4t-medium", "train_4k"): CellPlan(microbatch=8),
    ("nemotron-4-340b", "prefill_32k"): CellPlan(seq_parallel=True),
    ("qwen1.5-110b", "prefill_32k"): CellPlan(seq_parallel=True),
}


def plan_for(arch: str, shape: str) -> CellPlan:
    return DEFAULT_PLANS.get((arch, shape), CellPlan())


def _model(entry: ArchEntry):
    return ED if entry.kind == "encdec" else LM


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def _size(mesh, axes) -> int:
    sizes = spmd.axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _one(spec: Optional[tuple]) -> Optional[tuple]:
    """A spec with each one-axis tuple entry as the axis' name (as a
    ``PartitionSpec`` keeps it)."""
    if spec is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def constraint_spec(mesh, plan: CellPlan, shape, kind: str
                    ) -> Optional[tuple]:
    """The reference's ``make_constrain`` rule for a tensor of ``shape``:
    its spec (one entry a dim: None, a mesh axis or a tuple of them), or
    None where the rule leaves the tensor as it is. Every rule is
    best-effort: a dim that the target axis size does not divide stays
    unsharded."""
    return _one(_rule(mesh, plan, shape, kind))


def _rule(mesh, plan: CellPlan, shape, kind: str) -> Optional[tuple]:
    names = tuple(mesh.mesh_dim_names)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    bsz = _size(mesh, batch_axes)
    msz = _size(mesh, ("model",))
    sp = plan.seq_parallel and "model" in names
    nd = len(shape)

    def div(n, size):
        return size > 1 and n % size == 0

    if kind == "residual" and nd == 3:
        if not div(shape[0], bsz):
            return None
        seq = "model" if (sp and div(shape[1], msz)) else None
        return (batch_axes, seq, None)
    if kind == "heads" and nd == 4:
        if not div(shape[0], bsz):
            return None
        hd = "model" if div(shape[2], msz) else None
        return (batch_axes, None, hd, None)
    if kind == "kv_chunks" and nd == 5:
        if not div(shape[1], bsz):
            return None
        hd = "model" if div(shape[3], msz) else None
        return (None, batch_axes, None, hd, None)
    if kind == "tokens" and nd == 2:
        # token rows shard over batch AND model axes (1M-token MoE
        # dispatch buffers must not hold 16-way-only shards)
        if div(shape[0], bsz * msz):
            return (batch_axes + ("model",), None)
        if div(shape[0], bsz):
            return (batch_axes, None)
        return None
    if kind == "expert" and nd == 3:
        if not div(shape[0], msz):
            return None
        cap = "data" if div(shape[1], _size(mesh, ("data",))) else None
        return ("model", cap, None)
    if kind in ("cache4", "cache3") and nd == (4 if kind == "cache4" else 3):
        b = batch_axes if div(shape[0], bsz) else ()
        seq = "model" if div(shape[1], msz) else None
        if not b and seq is None:
            return None
        return (b or None, seq) + (None,) * (nd - 2)
    if kind == "cache_stack" and nd >= 3:
        # (layers, B, S, ...) preallocated prefill cache
        b = batch_axes if div(shape[1], bsz) else ()
        seq = "model" if div(shape[2], msz) else None
        if not b and seq is None:
            return None
        return (None, b or None, seq) + (None,) * (nd - 3)
    return None


def make_constrain(mesh, plan: CellPlan) -> Callable:
    """Kind-dispatching sharding constraint (see ``utils.pcontext``): a
    DTensor is redistributed to the kind's placements
    (:func:`constraint_spec`); anything else is returned as it is."""
    def constrain(x, kind: str = "residual"):
        if not isinstance(x, DTensor):
            return x
        spec = constraint_spec(mesh, plan, tuple(x.shape), kind)
        if spec is None:
            return x
        return x.redistribute(mesh, placements(spec, mesh))

    return constrain


def _local_constrain(mesh, plan: CellPlan, step: str) -> Callable:
    """A sharded step's callback on its local blocks. ``heads`` (B, S,
    H, Dh) and ``kv_chunks`` (N, B, C, H, D): a tensor that holds every
    head of the attention being run (keys and values after the GQA
    repeat) keeps this rank's block of them where the heads split over
    ``model`` (``spmd.LocalStep.head_block``; the queries are already
    the block, from ``wq``'s columns). A prefill's cache stack (and a
    layer's cache written into it) keeps this rank's block of the
    sequence dim where the reference shards it over ``model``. The rows
    are already this rank's (the batch split); ``tokens`` and ``expert``
    are laid out by the MoE dispatch itself (``spmd.ExpertSplit``: each
    rank dispatches its tokens into its block of experts and capacity
    rows), and every other kind is left as it is."""
    cache = step == "prefill" and "model" in mesh.mesh_dim_names
    idx, n = spmd.block_index(mesh, ("model",))

    def heads(x, dim):
        ctx = pcontext.local()
        return x if ctx is None else ctx.narrow_heads(x, dim)

    def constrain(x, kind: str = "residual"):
        if kind == "heads" and x.ndim == 4:
            return heads(x, 2)
        if kind == "kv_chunks" and x.ndim == 5:
            return heads(x, 3)
        if kind != "cache_stack" or not cache or \
                not _cache_seq_split(mesh, plan, x.shape):
            return x
        c = x.shape[2] // n
        return x.narrow(2, idx * c, c)

    return constrain


def _cache_seq_split(mesh, plan: CellPlan, shape) -> bool:
    """Whether the reference's ``cache_stack`` rule splits dim 2 of a
    (layers, B, S, ...) cache of ``shape`` over ``model``."""
    if len(shape) < 3:
        return False
    spec = constraint_spec(mesh, plan, (1, 1) + tuple(shape[2:]),
                           "cache_stack")
    return spec is not None and spec[2] == "model"


def _batch_sharding(mesh, spec_tree: Any) -> Any:
    """Shard leading batch dim of every batch leaf over (pod, data);
    leaves whose batch dim is indivisible stay replicated."""
    batch_axes = tuple(a for a in ("pod", "data")
                       if a in mesh.mesh_dim_names)
    bsz = _size(mesh, batch_axes)

    def one(x):
        # microbatched leaves are (M, B, ...): shard dim 1, else dim 0
        if x.ndim >= 2 and x.shape[0] < x.shape[1] \
                and x.shape[1] % bsz == 0 and x.shape[0] <= 64:
            return placements((None, batch_axes), mesh)
        if x.shape[0] % bsz == 0:
            return placements((batch_axes,), mesh)
        return placements((), mesh)

    return tree_map(one, spec_tree)


def _opt_shardings(mesh, sh_train: Any) -> dict:
    return {"mu": sh_train, "nu": sh_train,
            "count": placements((), mesh)}


def _decode_rules(plan: CellPlan) -> dict:
    rules = dict(DEFAULT_RULES)
    # split-KV decode; the reference's ("model", "data") in mesh order
    # (module docstring)
    rules["kv_seq"] = ("data", "model")
    if plan.rules:
        rules.update(plan.rules)
    return rules


def _stacked(logical: dict) -> dict:
    return map_logical(lambda t: ("layers",) + t, logical)


def cache_logical(entry: ArchEntry, cfg) -> dict:
    """The decode cell's cache annotations, keyed as its arguments: an
    LM's ``caches``, the enc-dec model's ``self_caches`` and
    ``cross_caches`` (the reference inlines the latter)."""
    if entry.kind == "encdec":
        return {"self_caches": _stacked(A.gqa_cache_logical()),
                "cross_caches": {
                    "k": ("layers", "batch", "kv_seq", None, None),
                    "v": ("layers", "batch", "kv_seq", None, None)}}
    return {"caches": LM.cache_logical(cfg)}


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------

def _materialize(spec: torch.Tensor, dev: torch.device,
                 gen: torch.Generator, vocab: int) -> torch.Tensor:
    """A random tensor of ``spec``'s shape and dtype: tokens uniform in
    [0, vocab), embeddings standard normal."""
    if spec.dtype.is_floating_point:
        return torch.randn(spec.shape, generator=gen, device=dev).to(
            spec.dtype)
    return torch.randint(0, vocab, spec.shape, generator=gen, device=dev,
                         dtype=spec.dtype)


def _distribute(tree: Any, pls: Any, mesh) -> Any:
    """Every leaf of ``tree`` as a DTensor with its placements. A real
    tensor holds the same full value on every rank (drawn from one
    seed), so each rank keeps its block without communicating; a
    ``meta`` leaf becomes a block of its local shape (nothing is
    drawn)."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for t, pl in zip(leaves, placement_leaves(pls)):
        local = spmd.local_block(t, pl, mesh)
        if t.device.type == "meta":
            local = torch.empty(local.shape, dtype=t.dtype, device="meta")
        else:
            local = local.contiguous()
        out.append(spmd.as_dtensor(local, mesh, pl, tuple(t.shape)))
    return tree_unflatten(treedef, out)


def build_cell(entry: ArchEntry, shape_name: str, mesh=None,
               plan: Optional[CellPlan] = None, cfg_override: Any = None,
               device="cuda", batch: Optional[int] = None) -> dict:
    """{'fn', 'args', 'cfg', 'plan', 'step', 'batch', 'seq'} for one
    cell, and with a ``mesh`` also 'in_placements', 'out_placements',
    'donate', 'mesh', and the axes the step splits its rows over
    ('batch_axes'), its sequence over ('seq_axes', sequence parallelism),
    its dense MLPs' hidden units over ('tp_axes'), its attention heads
    over ('head_axes'), its Mamba heads over ('ssm_axes'), its vocab
    over ('vocab_axes') and its MoE experts over ('expert_axes'), with
    'split_log' (:func:`_split_axes`). ``batch``
    replaces the shape's batch size (a cut to fit one card; a multiple of
    the plan's microbatch count)."""
    plan = plan or plan_for(entry.arch_id, shape_name)
    cfg = cfg_override or entry.full()
    if plan.cfg_updates:
        cfg = dataclasses.replace(cfg, **plan.cfg_updates)
    info = dict(SHAPES[shape_name])
    if batch is not None:
        info["batch"] = int(batch)
    dev = resolve_device(device)
    mod = _model(entry)
    params = mod.init(0, cfg, device=dev)
    frozen, train = params["frozen"], params["train"]
    if plan.quantize_base:
        frozen = quantize_frozen_tree(frozen)
    specs = input_specs(entry, cfg, shape_name, info["batch"])
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(1)
        specs["batch"] = tree_map(
            lambda s: _materialize(s, dev, gen, cfg.vocab), specs["batch"])
        specs = {k: v if k == "batch" else tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev), v)
            for k, v in specs.items()}
    step = info["step"]
    out = {"cfg": cfg, "plan": plan, "step": step, "batch": info["batch"],
           "seq": info["seq"]}
    if mesh is not None:
        out.update(_build_sharded(entry, mod, cfg, plan, mesh, frozen, train,
                                  specs, step, info["seq"]))
        return out
    if step == "train":
        fn, args = _build_train(mod, cfg, plan, frozen, train, specs)
    elif step == "prefill":
        fn, args = _build_prefill(entry, cfg, frozen, train, specs)
    else:
        fn, args = _build_decode(entry, cfg, frozen, train, specs,
                                 info["seq"])
    out.update(fn=fn, args=args)
    return out


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def _micro_reshape(batch: Any, m: int) -> Any:
    def one(x):
        if x.shape[0] % m:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"the {m} microbatches")
        return x.reshape(m, x.shape[0] // m, *x.shape[1:])
    return tree_map(one, batch)


def _build_train(mod, cfg, plan: CellPlan, frozen, train, specs):
    opt = adamw(weight_decay=0.0)
    m = plan.microbatch
    batch = _micro_reshape(specs["batch"], m) if m > 1 else specs["batch"]

    def train_step(frozen, train, opt_state, batch):
        leaves, treedef = tree_flatten(train)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        tr = tree_unflatten(treedef, leaves)

        def one_micro(mb):
            loss, _ = mod.loss_fn(frozen, tr, cfg, mb)
            return loss, torch.autograd.grad(loss, leaves)

        if m == 1:
            loss, grads = one_micro(batch)
        else:
            grads = [torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for t in leaves]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for j in range(m):
                l, g = one_micro(tree_map(lambda x: x[j], batch))
                grads = [a + b.to(torch.float32) for a, b in zip(grads, g)]
                lsum = lsum + l.detach()
            grads = [g / m for g in grads]
            loss = lsum / m
        with torch.no_grad():
            new_train, opt_state = opt.update(
                tree_unflatten(treedef, list(grads)), opt_state,
                tree_unflatten(treedef, [t.detach() for t in leaves]), LR)
        return new_train, opt_state, {"loss": loss.detach()}

    return train_step, (frozen, train, opt.init(train), batch)


def _build_prefill(entry, cfg, frozen, train, specs):
    if entry.kind == "encdec":
        @torch.no_grad()
        def prefill_step(frozen, train, batch):
            memory = ED.encode(frozen, train, cfg, batch["src_embed"])
            return ED.cross_cache(frozen, train, cfg, memory)
    else:
        @torch.no_grad()
        def prefill_step(frozen, train, batch):
            return LM.prefill(frozen, train, cfg, batch["tokens"],
                              batch.get("prefix_embed"))
    return prefill_step, (frozen, train, specs["batch"])


def _build_decode(entry, cfg, frozen, train, specs, seq: int):
    pos = seq - 1
    if entry.kind == "encdec":
        @torch.no_grad()
        def decode_step(frozen, train, batch, self_caches, cross_caches):
            return ED.decode_step(frozen, train, cfg, batch["token"],
                                  self_caches, cross_caches, pos)
        return decode_step, (frozen, train, specs["batch"],
                             specs["self_caches"], specs["cross_caches"])

    @torch.no_grad()
    def decode_step(frozen, train, batch, caches):
        return LM.decode_step(frozen, train, cfg, batch["token"], caches,
                              pos)
    return decode_step, (frozen, train, specs["batch"], specs["caches"])


# ---------------------------------------------------------------------------
# sharded over a mesh
# ---------------------------------------------------------------------------

def _build_sharded(entry, mod, cfg, plan: CellPlan, mesh, frozen, train,
                   specs, step: str, seq: int) -> dict:
    rules = dict(DEFAULT_RULES)
    if plan.rules:
        rules.update(plan.rules)
    logical = mod.logical(cfg)
    if plan.quantize_base:
        logical = {"frozen": quantize_frozen_logical(logical["frozen"]),
                   "train": logical["train"]}
    sh_frozen = tree_shardings(logical["frozen"], frozen, mesh, rules)
    sh_train = tree_shardings(logical["train"], train, mesh, rules)
    frozen_d = _distribute(frozen, sh_frozen, mesh)
    train_d = _distribute(train, sh_train, mesh)
    m = plan.microbatch if step == "train" else 1
    batch = _micro_reshape(specs["batch"], m) if m > 1 else specs["batch"]
    sh_batch = _batch_sharding(mesh, batch)
    batch_d = _distribute(batch, sh_batch, mesh)
    rows = next(iter(tree_flatten(batch)[0])).shape[1 if m > 1 else 0]
    row_dim = 1 if m > 1 else 0
    names = tuple(mesh.mesh_dim_names)
    local_c = _local_constrain(mesh, plan, step)

    sp = _seq_parallel(entry, cfg, plan, mesh, batch, step)
    log: dict = {}
    if step == "train":
        # the rows over every axis that divides them (model too), or
        # under sequence parallelism over the batch axes, the sequence
        # over model
        axes = spmd.split_axes(mesh, rows, ("pod", "data") if sp else names,
                               greedy=False)
        opt = adamw(weight_decay=0.0)
        sh_opt = _opt_shardings(mesh, sh_train)
        opt_d = _distribute(opt.init(train), sh_opt, mesh)
        fn = _sharded_train(mod, cfg, mesh, axes, m, row_dim, opt, local_c,
                            sp=sp, log=log,
                            holders=_holders(cfg, mesh, axes, batch, step))
        return {"fn": fn, "args": (frozen_d, train_d, opt_d, batch_d),
                "in_placements": (sh_frozen, sh_train, sh_opt, sh_batch),
                "out_placements": (sh_train, sh_opt, None),
                "donate": (1, 2), "mesh": mesh, "batch_axes": axes,
                "seq_axes": sp[0] if sp else (),
                **_split_axes(entry, cfg, spmd.LocalStep(mesh, axes, *sp),
                              sp, log)}

    if step == "prefill":
        axes = spmd.split_axes(mesh, rows, ("pod", "data"), greedy=False)
        fn = _sharded_prefill(entry, cfg, plan, mesh, axes, local_c, sp=sp,
                              log=log,
                              holders=_holders(cfg, mesh, axes, batch, step))
        return {"fn": fn, "args": (frozen_d, train_d, batch_d),
                "in_placements": (sh_frozen, sh_train, sh_batch),
                "out_placements": None, "donate": (), "mesh": mesh,
                "batch_axes": axes, "seq_axes": sp[0] if sp else (),
                **_split_axes(entry, cfg, spmd.LocalStep(mesh, axes, *sp),
                              sp, log)}

    # the caches' batch dim follows the reference's greedy rule
    axes = spmd.split_axes(mesh, rows, ("pod", "data"))
    drules = _decode_rules(plan)
    cl = cache_logical(entry, cfg)
    sh_caches = {k: tree_shardings(cl[k], specs[k], mesh, drules)
                 for k in cl}
    caches_d = {k: _distribute(specs[k], sh_caches[k], mesh) for k in cl}
    fn = _sharded_decode(entry, cfg, mesh, axes, seq - 1, log=log,
                         holders=_holders(cfg, mesh, axes, batch, step))
    names_c = list(cl)
    return {"fn": fn, "args": (frozen_d, train_d, batch_d,
                               *(caches_d[k] for k in names_c)),
            "in_placements": (sh_frozen, sh_train, sh_batch,
                              *(sh_caches[k] for k in names_c)),
            "out_placements": None, "donate": (3,), "mesh": mesh,
            "batch_axes": axes, "seq_axes": (),
            **_split_axes(entry, cfg, spmd.LocalStep(mesh, axes,
                                                     heads=False), (), log)}


def _split_axes(entry, cfg, ctx: spmd.LocalStep, sp: tuple,
                log: dict) -> dict:
    """The cell's record of what splits over ``model`` besides rows and
    sequence: the dense MLPs' hidden units (``tp_axes``), the attention
    heads of some layer (``head_axes``: under sequence parallelism only
    a sliding-window layer's), the Mamba mixers' heads (``ssm_axes``),
    the vocab of the embedding, the head and the loss (``vocab_axes``),
    the MoE experts (``expert_axes``), and ``split_log``, which the step
    fills as it runs (the head, Mamba head, vocab, expert and capacity
    blocks it used)."""
    heads, ssm, experts = set(), False, False
    if entry.kind == "encdec":
        heads.add(cfg.gqa.hq)
    else:
        for g in LM.resolve_groups(cfg):
            for spec in g.pattern:
                if spec.mixer == "mamba":
                    ssm = cfg.mamba.n_heads % ctx.msz == 0
                elif not sp or spec.window:
                    heads.add(LM._n_heads(cfg, spec))
                experts = experts or spec.ffn == "moe"
    head_axes = ctx.head_axes if any(
        h % ctx.msz == 0 for h in heads) else ()
    if experts:
        ctx.check_experts(cfg.moe.n_experts)
    expert_axes = ctx.expert_axes if experts else ()
    return {"tp_axes": ctx.tp_axes, "head_axes": head_axes,
            "ssm_axes": ctx.ssm_axes if ssm else (),
            "vocab_axes": ctx.vocab_axes if cfg.vocab % ctx.msz == 0
            else (),
            "expert_axes": expert_axes, "split_log": log}


def _holders(cfg, mesh, axes: tuple, batch: Any, step: str) -> dict:
    """{batch blocks: the mesh of their ``holders`` axis} for a MoE
    model's dispatch chunks that span a run of the step's batch blocks
    but not all of them (``spmd.chunk_span``): the process groups are
    made here, once, on every rank in the same order, not in the step's
    call."""
    moe = getattr(cfg, "moe", None)
    batch_axes = tuple(ax for ax in axes if ax != "model")
    if moe is None or not batch_axes:
        return {}
    tok = batch["tokens"] if "tokens" in batch else batch["token"]
    # a MoE layer's call: the (micro)batch's rows over its positions
    total = tok.shape[-2] * (tok.shape[-1] - (step == "train"))
    n_bb = _size(mesh, batch_axes)
    span = spmd.chunk_span(moe, total, n_bb)
    if not 1 < span < n_bb:
        return {}
    return {span: spmd.holder_mesh(mesh, batch_axes, span)}


def _seq_parallel(entry, cfg, plan: CellPlan, mesh, batch, step: str
                  ) -> tuple:
    """(('model',), the residual stream's length) where the step runs
    sequence-parallel (``launch/spmd.py``): the plan asks for it, the
    step is a decoder LM's train or prefill without a prefix, and
    ``model`` splits the sequence evenly; else ()."""
    msz = _size(mesh, ("model",))
    if not plan.seq_parallel or msz <= 1 or step == "decode" \
            or entry.kind == "encdec" or getattr(cfg, "prefix_lm", False):
        return ()
    n = batch["tokens"].shape[-1] - (1 if step == "train" else 0)
    return (("model",), n) if n % msz == 0 else ()


def _local_batch(ctx: spmd.LocalStep, batch: Any, row_dim: int) -> Any:
    return tree_map(lambda t: ctx.batch_block(t, row_dim), batch)


def _sharded_train(mod, cfg, mesh, axes, m: int, row_dim: int, opt,
                   local_c, lr: float = LR, sp: tuple = (),
                   log: Optional[dict] = None,
                   holders: Optional[dict] = None):
    def train_step(frozen, train, opt_state, batch):
        ctx = spmd.LocalStep(mesh, axes, *sp, log=log, holders=holders)
        leaves, treedef = tree_flatten(train)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        tr = tree_unflatten(treedef, leaves)
        local = _local_batch(ctx, batch, row_dim)
        grads = [torch.zeros(t.to_local().shape, dtype=torch.float32,
                             device=t.device) for t in leaves]
        lsum = 0.0
        with pcontext.use(local_c), pcontext.use_local(ctx):
            for j in range(m):
                mb = tree_map(lambda x: x[j], local) if m > 1 else local
                loss, _ = mod.loss_fn(ctx.top(frozen), ctx.top(tr), cfg, mb,
                                      lambda x: local_c(x, "residual"))
                # every rank's loss is the global one, and the gradients
                # add over the ranks that split the tokens
                g = torch.autograd.grad(loss / ctx.n, leaves)
                grads = [a + b.to_local().to(torch.float32)
                         for a, b in zip(grads, g)]
                lsum = lsum + loss.detach()
        grads = [g / m for g in grads]
        loss = lsum / m
        with torch.no_grad():
            loc = lambda t: t.to_local()        # noqa: E731
            new_train, new_opt = opt.update(
                tree_unflatten(treedef, grads), tree_map(loc, opt_state),
                tree_map(loc, train), lr)
            # donation: the outputs are written into the argument buffers
            for dst, src in ((train, new_train), (opt_state, new_opt)):
                for d, s_ in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
                    d.to_local().copy_(s_)
        return train, opt_state, {"loss": loss}

    return train_step


def _out_dtensor(local: torch.Tensor, mesh, dims: dict, shape) -> DTensor:
    return spmd.as_dtensor(local, mesh, spmd.placements_for(mesh, dims),
                           shape)


def _sharded_prefill(entry, cfg, plan, mesh, axes, local_c, sp: tuple = (),
                     log: Optional[dict] = None,
                     holders: Optional[dict] = None):

    def rows_out(local, rows_dim, total_rows):
        shape = list(local.shape)
        shape[rows_dim] = total_rows
        return _out_dtensor(local, mesh, {a: rows_dim for a in axes}, shape)

    @torch.no_grad()
    def prefill_step(frozen, train, batch):
        ctx = spmd.LocalStep(mesh, axes, *sp, log=log, holders=holders)
        local = _local_batch(ctx, batch, 0)
        with pcontext.use(local_c), pcontext.use_local(ctx):
            fz, tr = ctx.top(frozen), ctx.top(train)
            if entry.kind == "encdec":
                memory = ED.encode(fz, tr, cfg, local["src_embed"],
                                   lambda x: local_c(x, "residual"))
                cross = ED.cross_cache(fz, tr, cfg, memory)
                cross = tree_map(lambda c: pcontext.constrain(c, "cache4")
                                 if c.ndim == 5 else c, cross)
                b = next(iter(batch.values())).shape[0]
                return tree_map(lambda c: rows_out(c, 1, b), cross)
            logits, caches, pos = LM.prefill(
                fz, tr, cfg, local["tokens"], local.get("prefix_embed"),
                constrain=lambda x: local_c(x, "residual"))
        b = batch["tokens"].shape[0]
        # the caches' whole shapes: rows over the batch axes, the
        # sequence (dim 2) over model where this rank kept its block
        whole = LM.cache_init(cfg, b, pos, device="meta")

        def cache_out(c, w):
            dims = {a: 1 for a in axes}
            if _cache_seq_split(mesh, plan, w.shape):
                dims["model"] = 2
            return _out_dtensor(c, mesh, dims, w.shape)

        return rows_out(logits, 0, b), tree_map(cache_out, caches,
                                                 whole), pos

    return prefill_step


def _sharded_decode(entry, cfg, mesh, axes, pos: int,
                    log: Optional[dict] = None,
                    holders: Optional[dict] = None):
    @torch.no_grad()
    def decode_step(frozen, train, batch, *caches):
        # decode splits no heads (the reference has no heads constraint
        # there); its KV cache is split by sequence (split-KV)
        ctx = spmd.LocalStep(mesh, axes, heads=False, log=log,
                             holders=holders)
        local = _local_batch(ctx, batch, 0)
        with pcontext.use(lambda x, kind="residual": x), \
                pcontext.use_local(ctx):
            fz, tr = ctx.top(frozen), ctx.top(train)
            if entry.kind == "encdec":
                logits, _ = ED.decode_step(fz, tr, cfg, local["token"],
                                           caches[0], caches[1], pos)
            else:
                logits, _ = LM.decode_step(fz, tr, cfg, local["token"],
                                           caches[0], pos)
        shape = (batch["token"].shape[0], *logits.shape[1:])
        logits = _out_dtensor(logits, mesh, {a: 0 for a in axes}, shape)
        return logits, caches[0]        # the model's (logits, caches)

    return decode_step
