"""Hand-written optimizers over parameter trees.

Interface as in the JAX package: ``opt.init(params) -> state``;
``opt.update(grads, state, params, lr) -> (new_params, new_state)``,
functional (new tensors, nothing updated in place). Optimizer state
exists only for the trainable tree.

``torch.optim.SGD`` is not used: the cohort trainer must be able to
leave parameters and momenta untouched on a masked step, and the update
must be the reference's ``mu = m*mu + g; p -= lr*mu`` exactly.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def sgd(momentum: float = 0.9) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params, lr):
        if momentum == 0.0:
            new_params = tree_map(
                lambda p, g: (p.to(torch.float32)
                              - lr * g.to(torch.float32)).to(p.dtype),
                params, grads)
            return new_params, state
        mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                      state["mu"], grads)
        new_params = tree_map(
            lambda p, d: (p.to(torch.float32) - lr * d).to(p.dtype),
            params, mu)
        return new_params, {"mu": mu}

    return Optimizer(init, update)
