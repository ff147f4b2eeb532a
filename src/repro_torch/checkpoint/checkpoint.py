"""Fault-tolerant checkpointing.

The format is the JAX package's (``repro/checkpoint/checkpoint.py``), so
a checkpoint written by either package restores in the other: one
``ckpt_<step:08d>.npz`` holding every leaf keyed ``group::path`` (the
path from ``flatten_with_names``, JAX's flatten order), plus a JSON
manifest ``ckpt_<step:08d>.json`` with the step, the group names and the
caller's metadata. Writes are ATOMIC: each file goes to a ``tmp.*`` file
in the directory, is fsynced and only then renamed into place, so a
killed process never leaves a half-written checkpoint visible.

Leaves are stored on the host as numpy, each as its global value. A
bf16 leaf, which numpy cannot hold, is stored as its exact fp32 value
and cast back on restore. The JAX package stores a bf16 leaf as its
``ml_dtypes`` bits, which numpy reads back as a 2-byte void type:
restore takes those bits as bf16. ``CheckpointManager`` adds retention
(``keep_n``) and resume from the newest complete step.

Sharded trees. A tree that holds a DTensor leaf is saved collectively:
every rank of the process group calls ``save`` with the same trees, each
leaf's global value is gathered (``full_tensor``) in one order on every
rank, global rank 0 alone writes the files (and prunes old steps), and
a barrier after the manifest holds every rank until the step is
complete. The directory must then be one that every rank reads: a
shared filesystem where the ranks span hosts. ``restore(...,
shardings=)`` (or a DTensor ``like`` leaf) brings a leaf back as a
DTensor: each rank reads the file on the host and moves only its own
block to the device, with no communication. The file does not depend on
the mesh it was written from, so it restores onto any mesh, onto one
card and in the JAX package alike.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch import spmd
from repro_torch.utils.sharding import placement_leaves
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


def _sharded(trees: dict[str, Any]) -> bool:
    """Whether ``trees`` holds a DTensor leaf, which makes ``save`` a
    collective of the whole process group. Raises for a DTensor whose
    mesh does not span the group (its other ranks would not call)."""
    meshes = [leaf.device_mesh for tree in trees.values()
              for leaf in tree_flatten(tree)[0]
              if isinstance(leaf, DTensor)]
    for mesh in meshes:
        if mesh.size() != dist.get_world_size():
            raise ValueError(
                f"a DTensor leaf on a mesh of {mesh.size()} ranks; save "
                f"gathers over the whole group of "
                f"{dist.get_world_size()}")
    return bool(meshes)


def _writes(sharded: bool) -> bool:
    return not sharded or dist.get_rank() == 0


def save(directory: str, step: int, trees: dict[str, Any],
         metadata: Optional[dict] = None) -> str:
    """Write ``trees`` ({'train': tree, ...}) at ``step``; returns the
    checkpoint's path without extension. The payload lands before the
    manifest, and a step counts as complete once both exist. Trees with
    a DTensor leaf: a collective call, rank 0 writes (module
    docstring)."""
    sharded = _sharded(trees)
    writes = _writes(sharded)
    payload = {}
    # every rank gathers the leaves in this one order
    for group in sorted(trees):
        for name, leaf in flatten_with_names(trees[group]):
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()   # a collective over its mesh
            if writes:
                payload[f"{group}::{name}"] = _host(leaf)
    base = os.path.join(directory, f"ckpt_{step:08d}")
    if writes:
        os.makedirs(directory, exist_ok=True)
        _write_atomic(directory, base + ".npz",
                      lambda f: np.savez(f, **payload))
        man = {"step": step, "groups": sorted(trees.keys()),
               "metadata": metadata or {}}
        _write_atomic(directory, base + ".json",
                      lambda f: f.write(json.dumps(man).encode()))
    if sharded:
        dist.barrier()
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


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _block(full: torch.Tensor, mesh, pl: tuple, dtype,
           dev: torch.device) -> DTensor:
    """This rank's block of the host tensor ``full`` as a DTensor: only
    the block is cast and moved to ``dev``."""
    local = spmd.local_block(full, pl, mesh)
    out = torch.empty(local.shape, dtype=dtype, device=dev)
    out.copy_(local)
    return spmd.as_dtensor(out, mesh, pl, tuple(full.shape))


def restore(directory: str, step: int, like: dict[str, Any],
            shardings: Optional[dict[str, Any]] = None,
            device=None) -> tuple[dict[str, Any], dict]:
    """Restore trees with the structure of ``like`` (values replaced).
    Each tensor leaf comes back with its ``like`` leaf's dtype.

    ``shardings``: {group: (mesh, placements tree)}, the tree as
    ``utils/sharding.tree_shardings`` gives it. That group's leaves come
    back as DTensors on ``mesh`` with those placements; a ``like`` leaf
    that is a DTensor comes back on its own mesh and placements. Either
    way each rank moves only its block to the mesh's device. Every
    other tensor leaf lands on ``device`` if given, else on its ``like``
    leaf's device."""
    base = os.path.join(directory, f"ckpt_{step:08d}")
    with open(base + ".json") as f:
        man = json.load(f)
    shardings = shardings or {}
    with np.load(base + ".npz") as data:
        out = {}
        for group, tree in like.items():
            named = flatten_with_names(tree)
            if group in shardings:
                mesh, pls = shardings[group]
                pls = placement_leaves(pls)
                if len(pls) != len(named):
                    raise ValueError(f"{len(pls)} placements for the "
                                     f"{len(named)} leaves of {group!r}")
                where = [(mesh, pl) for pl in pls]
            else:
                where = [(ref.device_mesh, tuple(ref.placements))
                         if isinstance(ref, DTensor) else None
                         for _, ref in named]
            leaves = []
            for (name, ref), at in zip(named, where):
                arr = data[f"{group}::{name}"]
                if at is not None:
                    full = _tensor(arr)
                    dtype = ref.dtype if isinstance(ref, torch.Tensor) \
                        else full.dtype
                    leaves.append(_block(full, at[0], at[1], dtype,
                                         _mesh_device(at[0])))
                elif isinstance(ref, torch.Tensor):
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
        """``save`` at ``step``, then prune; with DTensor leaves a
        collective call, and rank 0 alone prunes."""
        save(self.directory, step, trees, metadata)
        if _writes(_sharded(trees)):
            self._gc()

    def restore_latest(self, like: dict, shardings=None, device=None):
        """(step, trees, manifest) of the newest step, or None
        (``restore``'s ``shardings`` and ``device``)."""
        step = latest_step(self.directory)
        if step is None:
            return None
        trees, man = restore(self.directory, step, like, shardings, device)
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
