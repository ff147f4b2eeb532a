"""Production meshes over ``torch.distributed``, defined as FUNCTIONS:
importing this module touches no device and no process group.

Single pod:  (data=16, model=16)            = 256 cards
Multi-pod:   (pod=2, data=16, model=16)     = 512 cards; the 'pod' axis
crosses the slow links between pods, and FLoCoRA's quantized adapter
exchange is the only traffic that ever crosses it
(``launch/fl_round.py``).

Each function builds a ``DeviceMesh`` (``init_device_mesh``) over the
process group that exists: the caller starts it with
``torch.distributed.init_process_group`` (NCCL on the card, gloo on the
CPU), with a world size equal to the mesh's size. The device type is
``cuda`` unless the caller asks for ``cpu``; a missing card raises.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.utils.device import resolve_device


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group before building a mesh")


def _mesh(shape: tuple, axes: tuple, device):
    dev = resolve_device(device)
    _require_group()
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(device="cuda"):
    """1-rank (data, model) mesh for smoke tests and one-card runs (the
    elastic lower bound)."""
    return _mesh((1, 1), ("data", "model"), device)


def make_client_mesh(device="cuda"):
    """1-D mesh over the ``clients`` axis for fleet-scale cohort
    reduction, spanning the whole process group: the flat wire buffer's
    K client dim shards across it and each rank folds its block through
    the dequant-agg kernel (``kernels.ops.dequant_agg_rows_sharded`` /
    ``core.flat.fedavg_packed_flat_sharded``). A mesh over a subset of
    the ranks is built with ``DeviceMesh.from_group`` on a
    ``dist.new_group``."""
    resolve_device(device)
    _require_group()
    return _mesh((dist.get_world_size(),), ("clients",), device)
