"""Carry parameter trees between the JAX package and the port.

``jax.random`` initialization (``repro/models/resnet.py``,
``repro/core/lora.py``) cannot be reproduced with torch generators, so a
run that must match the JAX package initializes there and carries the
tree across as numpy arrays (``jax.device_get(model)``). Both packages
use the same tree structure (nested dicts and lists, HWIO kernels), so
the conversion is leaf by leaf.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # ml_dtypes bf16: no numpy twin
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Any, device="cuda") -> Any:
    """A tree of numpy arrays (as ``jax.device_get`` returns it) -> the
    same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_to_torch(x, dev), tree)

