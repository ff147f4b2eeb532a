"""Logical-axis sharding rules over a ``torch.distributed`` device mesh.

Every param leaf in the model zoo is annotated with a tuple of *logical*
axis names (one per dim, ``None`` for unsharded): the models'
``*_logical`` functions. A rules table maps logical names to mesh axes.
``logical_to_spec`` resolves an annotation into a spec, the JAX
package's ``PartitionSpec`` as a plain tuple: one entry per dim, each
``None``, a mesh axis name or a tuple of them. It drops any mapping
whose mesh-axis size does not divide the dim (best-effort sharding:
indivisible dims fall back to replication rather than erroring, which
matters for LoRA adapters whose rank dim is tiny). The rules and the
resolution are the JAX package's (``repro/utils/sharding.py``), entry for
entry.

``placements`` turns a spec into DTensor placements, one a mesh dim
(``Shard(dim)`` or ``Replicate()``). A dim sharded over several mesh
axes is laid out in mesh-dim order by DTensor, and in the order the
spec lists them by the JAX package; a spec whose axes run against the
mesh order is refused rather than laid out differently.

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``torch.distributed.device_mesh.DeviceMesh``); nothing in this module
communicates.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
from torch.distributed.tensor import Placement, Replicate, Shard

# Default logical->physical rules for the (data, model) production mesh.
# 'fsdp' shards weights over the data axis (ZeRO-3 style); 'tensor' is TP.
DEFAULT_RULES: dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),      # global batch over pod x data
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv": None,
    # weights
    "embed": "model",              # d_model dim of weight matrices (TP)
    "vocab": "model",
    "mlp": "model",                # d_ff dim (TP)
    "heads": "model",              # attention head dim products
    "kv_heads": None,
    "qkv": "model",
    "expert": "model",             # MoE expert axis (EP)
    "fsdp": "data",                # the dim chosen for ZeRO-3 sharding
    "layers": None,                # scan axis, never sharded
    "lora_rank": None,             # rank r is tiny -> replicated
    "conv_in": None,
    "conv_out": "model",
    "kv_lora": None,
    "ssm_state": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "kv_proj": None,            # kv heads are few; replicate projections
    "kv_seq": ("model", "data"),  # split-KV decode over chips
    "mlp_nosplit": None,        # per-expert ff dim (expert axis is EP)
    # fleet-scale cohort reduction: the flat wire buffer's K client dim
    # shards over the 1-D client mesh (launch.mesh.make_client_mesh /
    # kernels.ops.dequant_agg_rows_sharded)
    "clients": "clients",
}


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def is_logical_leaf(x: Any) -> bool:
    """A logical annotation: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def logical_to_spec(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[dict] = None,
) -> tuple:
    """Resolve logical axis names into a spec for ``mesh``.

    Drops assignments where the mesh axis size does not divide the dim,
    and never assigns the same mesh axis twice (first dim wins)."""
    rules = dict(DEFAULT_RULES if rules is None else rules)
    axis_sizes = _axis_sizes(mesh)
    used: set[str] = set()
    out: list = []
    for name, dim in zip(logical, shape):
        phys = rules.get(name) if name is not None else None
        if phys is None:
            out.append(None)
            continue
        cand = (phys,) if isinstance(phys, str) else tuple(phys)
        # keep only axes that exist in this mesh, are unused, and divide dim
        kept = []
        prod = 1
        for ax in cand:
            if ax not in axis_sizes or ax in used:
                continue
            if dim % (prod * axis_sizes[ax]) == 0:
                kept.append(ax)
                prod *= axis_sizes[ax]
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
            used.add(kept[0])
        else:
            out.append(tuple(kept))
            used.update(kept)
    return tuple(out)


def placements(spec: Sequence, mesh) -> tuple:
    """A spec -> DTensor placements for ``mesh``, one a mesh dim:
    ``Shard(d)`` for the mesh axis that dim ``d`` names, ``Replicate()``
    for a mesh axis no dim names. Raises ``ValueError`` for an axis that
    is not in the mesh or named twice, and for a dim split over several
    axes in an order other than the mesh's."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {ax!r}, "
                                 f"not in the mesh's {tuple(names)}")
        idx = [names.index(ax) for ax in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {tuple(spec)} splits dim {d} over {axes}, against "
                f"the mesh's axis order {tuple(names)}: DTensor would lay "
                f"it out in mesh order")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(spec)} names mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def map_logical(fn, logical_tree: Any, *trees: Any) -> Any:
    """``fn(annotation, *leaves)`` over a logical annotation tree and
    trees of the same structure (dicts, lists, tuples that are not
    annotations)."""
    if is_logical_leaf(logical_tree):
        return fn(logical_tree, *trees)
    if isinstance(logical_tree, dict):
        if any(set(t) != set(logical_tree) for t in trees):
            raise ValueError("trees of different structure")
        return {k: map_logical(fn, v, *(t[k] for t in trees))
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, (list, tuple)):
        if any(len(t) != len(logical_tree) for t in trees):
            raise ValueError("trees of different structure")
        return type(logical_tree)(
            map_logical(fn, v, *(t[i] for t in trees))
            for i, v in enumerate(logical_tree))
    raise TypeError(f"not a logical annotation tree node: {logical_tree!r}")


def tree_shardings(logical_tree: Any, shape_tree: Any, mesh,
                   rules: Optional[dict] = None) -> Any:
    """A tree of logical annotations + a matching tree of shapes -> a
    tree of DTensor placements (the JAX package's tree of
    ``NamedSharding``s)."""
    return map_logical(
        lambda lg, x: placements(
            logical_to_spec(lg, tuple(x.shape), mesh, rules), mesh),
        logical_tree, shape_tree)


def placement_leaves(tree: Any) -> list:
    """The placement tuples of a tree of them (dicts, lists), in the
    port's flatten order (``utils/tree.py``: dict keys sorted), which
    ``tree_flatten`` would split apart."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in placement_leaves(tree[k])]
    if isinstance(tree, list) or (isinstance(tree, tuple) and not all(
            isinstance(e, Placement) for e in tree)):
        return [p for v in tree for p in placement_leaves(v)]
    return [tree]


def mesh_axis_size(mesh, name: str) -> int:
    return _axis_sizes(mesh).get(name, 1)


def num_chips(mesh) -> int:
    return int(np.prod(tuple(mesh.shape)))
