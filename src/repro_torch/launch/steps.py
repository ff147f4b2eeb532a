"""Step programs per (arch x shape) cell, on one card: the JAX package's
``launch/steps.py`` without its shardings (ROADMAP A8b).

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
``quantize_base`` runs ``core.lora.quantize_frozen_tree`` on the frozen
tree (the int8 base); ``cfg_updates`` are ``dataclasses.replace``
overrides of the config. The reference's ``seq_parallel`` and ``rules``
(sharding constraints), ``make_constrain``, the batch, optimizer and
cache shardings and donation are the LM step's side of distribution,
which waits for ROADMAP A8b; the logical sharding rules and the models'
annotations they would read are ported (``utils/sharding.py``, the
models' ``logical``), as is the FL side (``launch/fl_round.py``,
``launch/mesh.py``). Its ``kv_cache_dtype`` is read by none of its step
builders, and the caches stay bf16 (ROADMAP C).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.registry import SHAPES, ArchEntry, input_specs
from repro_torch.core.lora import quantize_frozen_tree
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.optim import adamw
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

LR = 3e-4


@dataclasses.dataclass(frozen=True)
class CellPlan:
    microbatch: int = 1
    quantize_base: bool = False        # int8 frozen base (beyond paper)
    cfg_updates: Optional[dict] = None  # dataclasses.replace overrides


# default memory plans per (arch, shape); anything absent -> CellPlan()
DEFAULT_PLANS: dict[tuple[str, str], CellPlan] = {
    ("nemotron-4-340b", "train_4k"): CellPlan(microbatch=8),
    ("qwen1.5-110b", "train_4k"): CellPlan(microbatch=8),
    ("llama4-maverick-400b-a17b", "train_4k"): CellPlan(microbatch=16),
    ("deepseek-v2-236b", "train_4k"): CellPlan(microbatch=16),
    ("minitron-4b", "train_4k"): CellPlan(microbatch=4),
    ("gemma3-4b", "train_4k"): CellPlan(microbatch=4),
    ("paligemma-3b", "train_4k"): CellPlan(microbatch=4),
    ("zamba2-2.7b", "train_4k"): CellPlan(microbatch=4),
    ("mamba2-370m", "train_4k"): CellPlan(microbatch=4),
    ("seamless-m4t-medium", "train_4k"): CellPlan(microbatch=8),
}


def plan_for(arch: str, shape: str) -> CellPlan:
    return DEFAULT_PLANS.get((arch, shape), CellPlan())


def _model(entry: ArchEntry):
    return ED if entry.kind == "encdec" else LM


def _materialize(spec: torch.Tensor, dev: torch.device,
                 gen: torch.Generator, vocab: int) -> torch.Tensor:
    """A random tensor of ``spec``'s shape and dtype: tokens uniform in
    [0, vocab), embeddings standard normal."""
    if spec.dtype.is_floating_point:
        return torch.randn(spec.shape, generator=gen, device=dev).to(
            spec.dtype)
    return torch.randint(0, vocab, spec.shape, generator=gen, device=dev,
                         dtype=spec.dtype)


def build_cell(entry: ArchEntry, shape_name: str,
               plan: Optional[CellPlan] = None, cfg_override: Any = None,
               device="cuda", batch: Optional[int] = None) -> dict:
    """{'fn', 'args', 'cfg', 'plan', 'step', 'batch', 'seq'} for one
    cell. ``batch`` replaces the shape's batch size (a cut to fit one
    card; a multiple of the plan's microbatch count)."""
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
    if step == "train":
        fn, args = _build_train(mod, cfg, plan, frozen, train, specs)
    elif step == "prefill":
        fn, args = _build_prefill(entry, cfg, frozen, train, specs)
    else:
        fn, args = _build_decode(entry, cfg, frozen, train, specs,
                                 info["seq"])
    return {"fn": fn, "args": args, "cfg": cfg, "plan": plan, "step": step,
            "batch": info["batch"], "seq": info["seq"]}


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
