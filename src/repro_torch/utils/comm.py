"""The port's collectives, in one place that records them.

Every collective of the scale-out layer (``kernels/ops.py``
``dequant_agg_rows_sharded``, ``launch/fl_round.py``) goes through
:func:`all_reduce` or :func:`all_gather` here, over one named axis of a
``DeviceMesh``. Inside :func:`record_collectives` each call appends one
record of what this rank hands to it: the kind, the mesh axis, the
group's size, the dtype and the bytes. ``roofline/analysis.py``
``collective_terms`` turns the records into wire bytes and time; this
takes the place of the JAX package's reading of the compiled HLO
(``repro/roofline/analysis.py`` ``collective_bytes``).

Works on any backend: NCCL on the card, gloo on the CPU, and torch's
``fake`` backend, on which the calls move nothing and the records still
count (the dry run's 512-rank mesh in one process).

A sharded LM step (``launch/steps.py``, ``launch/spmd.py``) issues its
collectives through ``torch.distributed._functional_collectives``,
DTensor's ``redistribute`` included; inside :func:`record_funcol` each
such op is recorded the same way, its mesh axis found from its group.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

_LOGS: list = []


@contextlib.contextmanager
def record_collectives():
    """Collect a record of every collective this process issues inside
    the block into the yielded list (nested blocks each get every
    record)."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _note(kind: str, t: torch.Tensor, axis: str, size: int) -> None:
    rec = {"kind": kind, "axis": axis, "group_size": size,
           "dtype": str(t.dtype).replace("torch.", ""),
           "bytes": t.numel() * t.element_size()}
    for log in _LOGS:
        log.append(rec)


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """In-place SUM of ``t`` over the ranks of ``mesh``'s ``axis``."""
    group = mesh.get_group(axis)
    _note("all-reduce", t, axis, dist.get_world_size(group))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` of every rank of ``mesh``'s ``axis``, stacked in the axis'
    rank order: (axis size, *t.shape). The outputs start as zeros, so a
    backend that moves nothing (``fake``) leaves finite values."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    _note("all-gather", t, axis, n)
    outs = [torch.zeros_like(t) for _ in range(n)]
    dist.all_gather(outs, t.contiguous(), group=group)
    return torch.stack(outs)


# functional collective -> (record kind, index of its group-name argument)
_FUNCOL = {"all_gather_into_tensor": ("all-gather", 2),
           "reduce_scatter_tensor": ("reduce-scatter", 3),
           "all_reduce": ("all-reduce", 2),
           "all_to_all_single": ("all-to-all", 3)}


class _FuncolRecorder(TorchDispatchMode):
    def __init__(self, mesh):
        super().__init__()
        self.axes = {}
        for i, name in enumerate(mesh.mesh_dim_names):
            g = mesh.get_group(i)
            self.axes[g.group_name] = (name, dist.get_world_size(g))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "_c10d_functional" and name in _FUNCOL:
            kind, gi = _FUNCOL[name]
            axis, size = self.axes.get(args[gi], (str(args[gi]), 0))
            if size == 0:
                size = dist.get_world_size(
                    dist.distributed_c10d._resolve_process_group(args[gi]))
            _note(kind, args[0], axis, size)
        return func(*args, **kwargs)


@contextlib.contextmanager
def record_funcol(mesh):
    """Inside the block, also record every functional collective this
    process issues (see the module docstring) over ``mesh``'s groups;
    use inside :func:`record_collectives`."""
    with _FuncolRecorder(mesh):
        yield
