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
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

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
