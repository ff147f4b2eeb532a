"""Client-side local training (paper §IV setup).

Defaults match the paper: SGD momentum 0.9, lr 0.01, batch 32, 5 local
epochs. Three engines over one local-step body, as in the JAX package:

  * ``make_local_trainer``: one client per call, over its natural
    schedule (the sequential baseline);
  * ``make_cohort_trainer``: the COHORT ENGINE, ``torch.func.vmap`` of
    one client's masked run over stacked (K, steps, B, ...) batches, so
    each operation of a step carries the K clients at once (per-client
    adapters become grouped convolutions). Every client computes the
    cohort's whole schedule; steps past its own ``n_steps`` leave its
    params, momenta and loss untouched (``torch.where``), and the loss
    is ``sum / max(n_steps, 1)``;
  * ``make_staggered_cohort_trainer``: the same with a per-client start
    tree (asynchronous arrivals trained from different global versions).

``fedprox_mu`` adds the FedProx proximal term
``0.5 * mu * sum ||train - train0||^2`` to every client's loss.

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
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    local_epochs: int = 5
    batch_size: int = 32
    lr: float = 0.01
    momentum: float = 0.9
    fedprox_mu: float = 0.0


def _local_step(loss_fn: Callable, cfg: ClientConfig):
    """``step(frozen, train0, train, opt_state, batch) -> (train,
    opt_state, loss)``: one SGD step on one client, functional, so it
    runs under ``torch.func.vmap``."""
    opt = sgd(momentum=cfg.momentum)

    def objective(train, frozen, train0, batch):
        loss, metrics = loss_fn(frozen, train, batch)
        if cfg.fedprox_mu > 0.0:
            prox = sum(torch.sum(torch.square(
                a.to(torch.float32) - b.to(torch.float32)))
                for a, b in zip(tree_leaves(train), tree_leaves(train0)))
            loss = loss + 0.5 * cfg.fedprox_mu * prox
        return loss, metrics

    grad_and_loss = torch.func.grad_and_value(objective, has_aux=True)

    def step(frozen, train0, train, opt_state, batch):
        grads, (loss, _) = grad_and_loss(train, frozen, train0, batch)
        train, opt_state = opt.update(grads, opt_state, train, cfg.lr)
        return train, opt_state, loss

    return opt, step


def _n_steps(batches: dict) -> int:
    return int(next(iter(batches.values())).shape[0])


def _local_run(loss_fn: Callable, cfg: ClientConfig):
    """``run(frozen, train0, batches) -> (train, mean_loss)`` for one
    client; ``batches`` leaves have leading (steps, B) dims, every step
    trained."""
    opt, step = _local_step(loss_fn, cfg)

    def run(frozen, train0, batches):
        train, opt_state = train0, opt.init(train0)
        losses = []
        with fp32_precision():
            for t in range(_n_steps(batches)):
                train, opt_state, loss = step(
                    frozen, train0, train, opt_state,
                    {k: v[t] for k, v in batches.items()})
                losses.append(loss)
        return train, torch.mean(torch.stack(losses))

    return run


def make_local_trainer(loss_fn: Callable, cfg: ClientConfig):
    """``loss_fn(frozen, train, batch) -> (loss, metrics)``. Returns
    ``run(frozen, train0, batches) -> (train, mean_loss)``: one client
    a call (the sequential baseline)."""
    return _local_run(loss_fn, cfg)


def _masked_local_run(loss_fn: Callable, cfg: ClientConfig):
    """One client's run over a FIXED-length schedule with an active step
    count ``n_steps`` (a 0-d int tensor): every step is computed, and
    steps past ``n_steps`` keep params, momenta and loss as they were.
    No value is read on the host, so the run can be vmapped."""
    opt, step = _local_step(loss_fn, cfg)

    def run(frozen, train0, batches, n_steps):
        train, opt_state = train0, opt.init(train0)
        total = 0.0
        keep = lambda active, new, old: tree_map(
            lambda a, b: torch.where(active, a, b), new, old)
        with fp32_precision():
            for t in range(_n_steps(batches)):
                train2, opt2, loss = step(
                    frozen, train0, train, opt_state,
                    {k: v[t] for k, v in batches.items()})
                active = t < n_steps
                train = keep(active, train2, train)
                opt_state = keep(active, opt2, opt_state)
                total = total + torch.where(active, loss, 0.0)
        return train, total / torch.clamp(n_steps, min=1)

    return run


def make_cohort_trainer(loss_fn: Callable, cfg: ClientConfig):
    """The vmapped cohort engine. Returns ``run(frozen, train0, batches,
    n_steps) -> (trained, losses)``: batches have leading (K, steps, B)
    dims, ``n_steps`` is the (K,) int tensor of per-client active step
    counts (masked no-ops beyond it), ``trained`` leaves carry a leading
    K dim and ``losses`` is (K,). ``frozen``/``train0`` are shared by
    the cohort."""
    return torch.func.vmap(_masked_local_run(loss_fn, cfg),
                           in_dims=(None, None, 0, 0))


def make_staggered_cohort_trainer(loss_fn: Callable, cfg: ClientConfig):
    """Like ``make_cohort_trainer``, but ``train0`` carries a leading K
    dim: each client starts from its OWN adapter tree (asynchronous
    arrivals trained from different global versions)."""
    return torch.func.vmap(_masked_local_run(loss_fn, cfg),
                           in_dims=(None, 0, 0, 0))


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
