"""Fault-tolerant checkpointing.

The format is the JAX package's (``repro/checkpoint/checkpoint.py``), so
a checkpoint written by either package restores in the other: one
``ckpt_<step:08d>.npz`` holding every leaf keyed ``group::path`` (the
path from ``flatten_with_names``, JAX's flatten order), plus a JSON
manifest ``ckpt_<step:08d>.json`` with the step, the group names and the
caller's metadata. Writes are ATOMIC: each file goes to a ``tmp.*`` file
in the directory, is fsynced and only then renamed into place, so a
killed process never leaves a half-written checkpoint visible.

Leaves are stored on the host as numpy. A bf16 leaf, which numpy cannot
hold, is stored as its exact fp32 value and cast back on restore. The
JAX package stores a bf16 leaf as its ``ml_dtypes`` bits, which numpy
reads back as a 2-byte void type: restore takes those bits as bf16.
``CheckpointManager`` adds retention (``keep_n``) and resume from the
newest complete step.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_names, tree_flatten, \
    tree_unflatten


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(leaf)


def _write_atomic(directory: str, path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, prefix="tmp.")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save(directory: str, step: int, trees: dict[str, Any],
         metadata: Optional[dict] = None) -> str:
    """Write ``trees`` ({'train': tree, ...}) at ``step``; returns the
    checkpoint's path without extension. The payload lands before the
    manifest, and a step counts as complete once both exist."""
    os.makedirs(directory, exist_ok=True)
    payload = {f"{group}::{name}": _host(leaf)
               for group, tree in trees.items()
               for name, leaf in flatten_with_names(tree)}
    base = os.path.join(directory, f"ckpt_{step:08d}")
    _write_atomic(directory, base + ".npz",
                  lambda f: np.savez(f, **payload))
    man = {"step": step, "groups": sorted(trees.keys()),
           "metadata": metadata or {}}
    _write_atomic(directory, base + ".json",
                  lambda f: f.write(json.dumps(man).encode()))
    return base


def latest_step(directory: str) -> Optional[int]:
    """The newest step with both its payload and its manifest, or
    None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for fn in os.listdir(directory):
        if fn.startswith("ckpt_") and fn.endswith(".json"):
            base = fn[:-5]
            if os.path.exists(os.path.join(directory, base + ".npz")):
                steps.append(int(base.split("_")[1]))
    return max(steps) if steps else None


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bf16 leaf of the JAX package (ml_dtypes bits)
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(directory: str, step: int, like: dict[str, Any],
            device=None) -> tuple[dict[str, Any], dict]:
    """Restore trees with the structure of ``like`` (values replaced).
    Each tensor leaf comes back with its ``like`` leaf's dtype, on
    ``device`` if given, else on the ``like`` leaf's own device."""
    base = os.path.join(directory, f"ckpt_{step:08d}")
    with open(base + ".json") as f:
        man = json.load(f)
    with np.load(base + ".npz") as data:
        out = {}
        for group, tree in like.items():
            leaves = []
            for name, ref in flatten_with_names(tree):
                arr = data[f"{group}::{name}"]
                if isinstance(ref, torch.Tensor):
                    leaves.append(_tensor(arr).to(
                        device=ref.device if device is None else device,
                        dtype=ref.dtype))
                else:
                    leaves.append(np.asarray(arr, dtype=getattr(
                        ref, "dtype", None)))
            out[group] = tree_unflatten(tree_flatten(tree)[1], leaves)
    return out, man


class CheckpointManager:
    """Saves with retention of the newest ``keep_n`` steps (0 keeps all)
    and restores the newest complete one."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n

    def save(self, step: int, trees: dict, metadata: Optional[dict] = None):
        save(self.directory, step, trees, metadata)
        self._gc()

    def restore_latest(self, like: dict, device=None):
        """(step, trees, manifest) of the newest step, or None."""
        step = latest_step(self.directory)
        if step is None:
            return None
        trees, man = restore(self.directory, step, like, device)
        return step, trees, man

    def _gc(self):
        steps = sorted(
            int(fn[5:-5]) for fn in os.listdir(self.directory)
            if fn.startswith("ckpt_") and fn.endswith(".json"))
        for s in steps[: -self.keep_n] if self.keep_n else []:
            for ext in (".npz", ".json"):
                p = os.path.join(self.directory, f"ckpt_{s:08d}{ext}")
                if os.path.exists(p):
                    os.remove(p)
