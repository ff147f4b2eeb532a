"""Pytree utilities over nested dicts, lists and tuples of tensors.

Params in the port are plain nested dicts of tensors, as in the JAX
package. The flatten order is JAX's: dict keys are SORTED and lists and
tuples are walked by index (``torch.utils._pytree`` keeps dict insertion
order instead). The wire entry names and the flat codec's row layout
(``core/flat.py``) are built from this order, so it must match the JAX
package leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

LEAF = "*"


def tree_flatten_with_path(tree: Any) -> tuple[list[tuple[tuple, Any]], Any]:
    """-> ([(path, leaf), ...] in JAX order, treedef). A path is a tuple
    of dict keys and sequence indices; the treedef is hashable."""
    out: list[tuple[tuple, Any]] = []

    def rec(node, path):
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys,
                    tuple(rec(node[k], path + (k,)) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node),
                    tuple(rec(v, path + (i,)) for i, v in enumerate(node)))
        if node is None:
            return ("none",)
        out.append((path, node))
        return LEAF

    treedef = rec(tree, ())
    return out, treedef


def tree_flatten(tree: Any) -> tuple[list[Any], Any]:
    flat, treedef = tree_flatten_with_path(tree)
    return [x for _, x in flat], treedef


def tree_leaves(tree: Any) -> list[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)

    def rec(d):
        if d == LEAF:
            return next(it)
        if d[0] == "dict":
            return {k: rec(c) for k, c in zip(d[1], d[2])}
        if d[0] == "list":
            return [rec(c) for c in d[2]]
        if d[0] == "tuple":
            return tuple(rec(c) for c in d[2])
        return None

    out = rec(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, td in others:
        if td != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(
        leaves, *[o[0] for o in others])])


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def flatten_with_names(tree: Any) -> list[tuple[str, Any]]:
    """Flatten into [(path_string, leaf), ...] in JAX order."""
    flat, _ = tree_flatten_with_path(tree)
    return [(_path_str(path), leaf) for path, leaf in flat]


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(tree))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_bytes(tree: Any) -> int:
    """Total bytes across all leaves (by dtype itemsize)."""
    return sum(int(np.prod(tuple(x.shape))) * _itemsize(x.dtype)
               for x in tree_leaves(tree))


def tree_to(tree: Any, device) -> Any:
    """Every tensor leaf moved to ``device`` (numpy leaves become
    tensors)."""
    return tree_map(lambda x: torch.as_tensor(x).to(device), tree)
