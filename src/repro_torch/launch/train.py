"""Training entry point for the LM zoo: the JAX package's ``launch/train.py``
on one card. Initializes an ``--arch`` from seed 0 (random weights),
runs FLoCoRA train steps (the frozen base, AdamW on the adapters and
norms) on Markov-chain token batches, checkpoints every
``--checkpoint-every`` steps and resumes from the newest checkpoint in
``--checkpoint-dir``.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch paligemma-3b --smoke --steps 20 [--device cuda]

A prefix-LM (paligemma-3b) also draws ``cfg.prefix_len`` random patch
embeddings a row, and the enc-dec model (seamless-m4t-medium) random
frame embeddings of ``--seq`` frames and ``--seq`` + 1 target tokens:
the frontends are stubs, as in the reference. As in the reference, every
run draws its batches from ``np.random.default_rng(0)`` anew, so a
resumed run's first step takes the first batch, not the one the
interrupted run would have drawn next.

Runs on the card unless ``--device cpu`` is given; without a card the
default raises.

``--mesh host|single|multi`` runs the step sharded over a
``DeviceMesh`` (``launch/mesh.py``): the parameters and the optimizer
state are DTensors with the reference's shardings, every rank draws the
same batch and keeps its block, and the step is ``launch/steps.py``'s
sharded train step (``launch/spmd.py``). ``host`` is the 1-rank (1, 1)
mesh: without a process group this starts a one-rank group itself
(NCCL on the card, gloo on the CPU). ``single`` (16, 16) and ``multi``
(2, 16, 16) need a process group of 256 or 512 ranks, started by the
launcher (``torch.distributed.init_process_group``, e.g. from
``torchrun``'s environment); any other world size raises. Under
``--mesh`` the run checkpoints and resumes as the one-card run does:
every rank gathers the trees and rank 0 writes the file (so a run over
several hosts needs ``--checkpoint-dir`` on a shared filesystem), and
every rank reads it back onto its own blocks. The file holds global
values, so it resumes on any mesh, on one card and in the JAX package,
and the one-card run's file or the JAX package's resumes here.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \
        --smoke --steps 3 --mesh host --checkpoint-dir DIR --device cpu

A step's checkpoint keeps the step's loss in its manifest's metadata
(``{"loss": ...}``).
"""
from __future__ import annotations

import argparse
import socket
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.synthetic import markov_lm_batch
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.optim import adamw
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_flatten, tree_size, tree_unflatten


def _bf16(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(a).to(device=dev, dtype=torch.bfloat16)


def draw_batch(rng: np.random.Generator, cfg: Any, kind: str, batch: int,
               seq: int, device) -> dict:
    """One batch, drawn from ``rng`` in the reference's order: an enc-dec
    model's frame embeddings (batch, seq, d) then its target tokens
    (batch, seq + 1); a decoder LM's tokens (batch, seq + 1), then a
    prefix-LM's patch embeddings (batch, cfg.prefix_len, d). Embeddings
    are bf16."""
    if kind == "encdec":
        src = rng.normal(size=(batch, seq, cfg.d_model))
        return {"src_embed": _bf16(src, device),
                "tgt_tokens": torch.from_numpy(markov_lm_batch(
                    rng, cfg.vocab, batch, seq)["tokens"]).to(device)}
    out = {"tokens": torch.from_numpy(markov_lm_batch(
        rng, cfg.vocab, batch, seq)["tokens"]).to(device)}
    if cfg.prefix_lm:
        out["prefix_embed"] = _bf16(rng.normal(
            size=(batch, cfg.prefix_len, cfg.d_model)), device)
    return out


def train_step(frozen: dict, train: Any, opt_state: dict, cfg: Any,
               kind: str, batch: dict, lr: float
               ) -> tuple[Any, dict, torch.Tensor]:
    """One step: the model's ``loss_fn``, its gradient on the trained
    tree, one AdamW update. Returns (train, opt_state, loss)."""
    mod = ED if kind == "encdec" else LM
    leaves, treedef = tree_flatten(train)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss, _ = mod.loss_fn(frozen, tree_unflatten(treedef, leaves), cfg,
                          batch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        train, opt_state = adamw().update(
            tree_unflatten(treedef, list(grads)), opt_state,
            tree_unflatten(treedef, [t.detach() for t in leaves]), lr)
    return train, opt_state, loss.detach()


def train_loop(frozen: dict, train: Any, cfg: Any, kind: str,
               args: argparse.Namespace, rng: np.random.Generator) -> dict:
    """Steps ``start + 1 .. args.steps`` from ``train`` (or from the
    newest checkpoint in ``args.checkpoint_dir``, which sets ``start``),
    a batch of ``args.batch`` x ``args.seq`` from ``rng`` each, saving
    {'train', 'opt'} every ``args.checkpoint_every`` steps. Returns
    {'train', 'opt', 'losses', 'start'}."""
    dev = LM.param_device(frozen)
    opt_state = adamw().init(train)
    ckpt = CheckpointManager(args.checkpoint_dir) \
        if args.checkpoint_dir else None
    start = 0
    if ckpt:
        got = ckpt.restore_latest({"train": train, "opt": opt_state})
        if got:
            start, trees, _ = got
            train, opt_state = trees["train"], trees["opt"]
            print(f"resumed from step {start}")
    losses = []
    for step in range(start, args.steps):
        batch = draw_batch(rng, cfg, kind, args.batch, args.seq, dev)
        t0 = time.time()
        train, opt_state, loss = train_step(frozen, train, opt_state, cfg,
                                            kind, batch, args.lr)
        losses.append(float(loss))
        print(f"step {step + 1}: loss={losses[-1]:.4f} "
              f"({time.time() - t0:.2f}s)", flush=True)
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, {"train": train, "opt": opt_state},
                      metadata={"loss": losses[-1]})
    print("done")
    return {"train": train, "opt": opt_state, "losses": losses,
            "start": start}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    choices=["host", "single", "multi"],
                    help="run the step sharded over this mesh")
    return ap.parse_args(argv)


MESH_RANKS = {"host": 1, "single": 256, "multi": 512}


def make_mesh(name: str, dev: torch.device):
    """The ``--mesh`` mesh over the process group that exists (for
    ``host`` and no group: a one-rank group on a free local port).
    Raises where the group's size is not the mesh's."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    want = MESH_RANKS[name]
    if not dist.is_initialized():
        if name != "host":
            raise RuntimeError(
                f"--mesh {name} needs a process group of {want} ranks: "
                "start it with torch.distributed.init_process_group")
        with socket.socket() as s_:
            s_.bind(("localhost", 0))
            port = s_.getsockname()[1]
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    got = dist.get_world_size()
    if got != want:
        raise RuntimeError(f"--mesh {name} is a mesh of {want} ranks; the "
                           f"process group has {got}")
    if name == "host":
        return make_host_mesh(device=dev)
    return make_production_mesh(multi_pod=name == "multi", device=dev)


def sharded_step(cfg: Any, kind: str, args: argparse.Namespace, mesh):
    """The sharded train step over ``mesh`` (``launch/steps.py``, one
    microbatch of ``args.batch`` rows, learning rate ``args.lr``):
    ``step(frozen, train, opt_state, batch)`` with DTensor trees and a
    batch as ``draw_batch`` gives it. It writes the new ``train`` and
    ``opt_state`` into their argument buffers and returns (train,
    opt_state, loss)."""
    from repro_torch.launch import spmd
    from repro_torch.launch import steps as S
    mod = ED if kind == "encdec" else LM
    axes = spmd.split_axes(mesh, args.batch, mesh.mesh_dim_names,
                           greedy=False)
    fn = S._sharded_train(mod, cfg, mesh, axes, 1, 0, adamw(),
                          S._local_constrain(mesh, S.CellPlan(), "train"),
                          lr=args.lr)

    def step(frozen, train, opt_state, batch):
        batch = S._distribute(batch, S._batch_sharding(mesh, batch), mesh)
        train, opt_state, m = fn(frozen, train, opt_state, batch)
        return train, opt_state, m["loss"]

    return step


def sharded_loop(frozen: dict, train: Any, cfg: Any, entry,
                 args: argparse.Namespace, rng: np.random.Generator,
                 mesh) -> dict:
    """``train_loop`` over ``mesh``: steps ``start + 1 .. args.steps``,
    each the sharded train step, from ``train`` or from the newest
    checkpoint in ``args.checkpoint_dir`` restored onto the run's own
    placements. Every rank calls it. Returns {'train', 'opt', 'losses',
    'start'}, the trees as DTensors."""
    from repro_torch.launch import steps as S
    from repro_torch.utils.sharding import tree_shardings
    mod = ED if entry.kind == "encdec" else LM
    logical = mod.logical(cfg)
    frozen = S._distribute(frozen, tree_shardings(
        logical["frozen"], frozen, mesh), mesh)
    sh_train = tree_shardings(logical["train"], train, mesh)
    shardings = {"train": (mesh, sh_train),
                 "opt": (mesh, S._opt_shardings(mesh, sh_train))}
    opt_state = adamw().init(train)
    ckpt = CheckpointManager(args.checkpoint_dir) \
        if args.checkpoint_dir else None
    got = ckpt.restore_latest({"train": train, "opt": opt_state},
                              shardings) if ckpt else None
    start = 0
    if got:
        start, trees, _ = got
        train, opt_state = trees["train"], trees["opt"]
        print(f"resumed from step {start}")
    else:
        train = S._distribute(train, sh_train, mesh)
        opt_state = S._distribute(opt_state, shardings["opt"][1], mesh)
    step_fn = sharded_step(cfg, entry.kind, args, mesh)
    dev = LM.param_device(frozen)
    losses = []
    for step in range(start, args.steps):
        batch = draw_batch(rng, cfg, entry.kind, args.batch, args.seq, dev)
        t0 = time.time()
        train, opt_state, loss = step_fn(frozen, train, opt_state, batch)
        losses.append(float(loss))
        print(f"step {step + 1}: loss={losses[-1]:.4f} "
              f"({time.time() - t0:.2f}s)", flush=True)
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, {"train": train, "opt": opt_state},
                      metadata={"loss": losses[-1]})
    print("done")
    return {"train": train, "opt": opt_state, "losses": losses,
            "start": start}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    entry = registry.get(args.arch)
    cfg = entry.smoke() if args.smoke else entry.full()
    mod = ED if entry.kind == "encdec" else LM
    params = mod.init(0, cfg, device=dev)
    frozen, train = params["frozen"], params["train"]
    print(f"{cfg.name}: total={tree_size(frozen) + tree_size(train):,} "
          f"trainable={tree_size(train):,}")
    if args.mesh:
        own = not dist.is_initialized()
        try:
            return sharded_loop(frozen, train, cfg, entry, args,
                                np.random.default_rng(0),
                                make_mesh(args.mesh, dev))
        finally:
            if own and dist.is_initialized():
                dist.destroy_process_group()
    return train_loop(frozen, train, cfg, entry.kind, args,
                      np.random.default_rng(0))


if __name__ == "__main__":
    main()
