"""Hand-written optimizers over parameter trees.

Interface as in the JAX package: ``opt.init(params) -> state``;
``opt.update(grads, state, params, lr) -> (new_params, new_state)``,
functional (new tensors, nothing updated in place), so an update runs
under ``torch.func.vmap`` and ``torch.func.grad``. Optimizer state
exists only for the trainable tree.

``torch.optim`` is not used: the cohort engine must leave parameters
and momenta untouched on a masked step, and each update must be the
reference's exactly (``sgd``: decay added to the gradient, then
``mu = m*mu + g``, the Nesterov direction ``m*mu + g``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.
    Returns (clipped grads, the norm before clipping)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def sgd(momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params, lr):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        if momentum == 0.0:
            new_params = tree_map(
                lambda p, g: (p.to(torch.float32)
                              - lr * g.to(torch.float32)).to(p.dtype),
                params, grads)
            return new_params, state
        mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                      state["mu"], grads)
        step_dir = tree_map(
            lambda m, g: momentum * m + g.to(torch.float32), mu, grads) \
            if nesterov else mu
        new_params = tree_map(
            lambda p, d: (p.to(torch.float32) - lr * d).to(p.dtype),
            params, step_dir)
        return new_params, {"mu": mu}

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return {"mu": tree_map(z, params), "nu": tree_map(z, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.to(torch.float32)), state["nu"], grads)
        bc1 = 1 - b1 ** c.to(torch.float32)
        bc2 = 1 - b2 ** c.to(torch.float32)

        def upd(p, m, v):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "count": c}

    return Optimizer(init, update)
