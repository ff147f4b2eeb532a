"""Client-side local training (paper §IV setup).

Defaults match the paper: SGD momentum 0.9, lr 0.01, batch 32, 5 local
epochs. ``make_cohort_trainer`` runs K clients' local runs over stacked
(K, steps, B, ...) batches, one client after another. Each local run has
a fixed-length schedule with a per-client active step count: steps past
``n_steps`` leave params, momentum and loss untouched (here they are not
computed at all, which gives the same result), and the loss is
``sum / max(n_steps, 1)``, as in the JAX package's masked run.

Batches are gathered host-side with numpy (``stack_cohort_batches``),
consuming the engine's RNG stream exactly as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.optim import sgd
from repro_torch.utils.device import fp32_precision
from repro_torch.utils.tree import tree_flatten, tree_unflatten


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    local_epochs: int = 5
    batch_size: int = 32
    lr: float = 0.01
    momentum: float = 0.9
    fedprox_mu: float = 0.0

    def __post_init__(self):
        if self.fedprox_mu != 0.0:
            raise NotImplementedError("FedProx is not ported to repro_torch")


def _masked_local_run(loss_fn: Callable, cfg: ClientConfig):
    """``run(frozen, train0, batches, n_steps) -> (train, mean_loss)``
    for one client; ``batches`` leaves have leading (steps, B) dims."""
    opt = sgd(momentum=cfg.momentum)

    def run(frozen, train0, batches, n_steps: int):
        n_steps = int(n_steps)
        leaves0, treedef = tree_flatten(train0)
        train = [p.detach() for p in leaves0]
        opt_state = opt.init(tree_unflatten(treedef, train))
        total = torch.zeros((), dtype=torch.float32,
                            device=leaves0[0].device)
        with fp32_precision():
            for t in range(n_steps):
                batch = {k: v[t] for k, v in batches.items()}
                params = [p.detach().requires_grad_(True) for p in train]
                loss, _ = loss_fn(frozen, tree_unflatten(treedef, params),
                                  batch)
                grads = torch.autograd.grad(loss, params)
                with torch.no_grad():
                    new, opt_state = opt.update(
                        tree_unflatten(treedef, list(grads)), opt_state,
                        tree_unflatten(treedef, [p.detach()
                                                 for p in params]),
                        cfg.lr)
                train = tree_flatten(new)[0]
                total = total + loss.detach()
        return tree_unflatten(treedef, train), total / max(n_steps, 1)

    return run


def make_cohort_trainer(loss_fn: Callable, cfg: ClientConfig):
    """``run(frozen, train0, batches, n_steps) -> (trained, losses)``:
    batches have leading (K, steps, B) dims, ``n_steps`` is the (K,)
    per-client active step count, ``trained`` is a list of K trees and
    ``losses`` a (K,) tensor. ``frozen``/``train0`` are shared by the
    cohort."""
    run1 = _masked_local_run(loss_fn, cfg)

    def run(frozen, train0, batches, n_steps):
        trained, losses = [], []
        for k in range(len(n_steps)):
            t, loss = run1(frozen, train0,
                           {key: v[k] for key, v in batches.items()},
                           int(n_steps[k]))
            trained.append(t)
            losses.append(loss)
        return trained, torch.stack(losses)

    return run


def stack_local_batches(rng: np.random.Generator, data: dict,
                        cfg: ClientConfig,
                        steps: Optional[int] = None) -> dict:
    """Host-side: pack a client's dataset into (steps, B, ...) batches,
    reshuffling each local epoch (with wraparound padding). ``steps``
    overrides the natural step count."""
    n = len(next(iter(data.values())))
    per_epoch = max(1, n // cfg.batch_size)
    total = per_epoch * cfg.local_epochs if steps is None else steps
    idx_all = []
    got = 0
    while got < total:
        idx = rng.permutation(n)
        take = per_epoch * cfg.batch_size
        if take > n:
            idx = np.concatenate([idx, rng.integers(0, n, take - n)])
        idx_all.append(idx[:take].reshape(per_epoch, cfg.batch_size))
        got += per_epoch
    idx_all = np.concatenate(idx_all, axis=0)[:total]
    return {k: v[idx_all] for k, v in data.items()}


def natural_steps(data: dict, cfg: ClientConfig) -> int:
    """One client's paper-faithful local schedule length."""
    n = len(next(iter(data.values())))
    return max(1, n // cfg.batch_size) * cfg.local_epochs


def cohort_steps(datas: list[dict], cfg: ClientConfig) -> int:
    """Fixed schedule length for a cohort: the largest client's natural
    schedule (smaller clients are masked past their own count)."""
    return max(natural_steps(d, cfg) for d in datas)


def pow2_pad(k: int) -> int:
    """Next power of two >= k."""
    p = 1
    while p < k:
        p *= 2
    return p


def pad_cohort_batches(batches: dict, n_steps: np.ndarray, k_pad: int
                       ) -> tuple[dict, np.ndarray]:
    """Pad the leading client dim of a stacked cohort to ``k_pad`` by
    repeating client 0's batches with ``n_steps = 0``."""
    k = int(n_steps.shape[0])
    if k_pad <= k:
        return batches, n_steps
    reps = k_pad - k
    out = {key: np.concatenate([v, np.repeat(v[:1], reps, axis=0)],
                               axis=0)
           for key, v in batches.items()}
    return out, np.concatenate([n_steps,
                                np.zeros(reps, np.int32)]).astype(np.int32)


def stack_cohort_batches(rng: np.random.Generator, datas: list[dict],
                         cfg: ClientConfig,
                         steps: Optional[int] = None
                         ) -> tuple[dict, np.ndarray]:
    """Host-side: gather K clients' local schedules into one
    (K, steps, B, ...) stack. Returns (stacked batches, (K,) int32
    per-client active step counts)."""
    if steps is None:
        steps = cohort_steps(datas, cfg)
    n_steps = np.asarray([min(natural_steps(d, cfg), steps)
                          for d in datas], np.int32)
    per = [stack_local_batches(rng, d, cfg, steps=steps) for d in datas]
    return ({k: np.stack([p[k] for p in per], axis=0) for k in per[0]},
            n_steps)
