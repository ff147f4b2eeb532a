"""Dry-run core: trace one (arch x shape) cell's step on one card, count
its operations, bytes and memory (``roofline.op_cost.analyze_step``),
and keep the record as JSON: the JAX package's ``launch/dryrun_lib.py``
for one H100 without shardings.

On ``meta`` tensors (the default) nothing is allocated and no card is
needed, so a cell too large for one card still gets its record, with
``fits_one_card`` false. A record holds the JAX package's fields where
they mean the same thing (``memory``, ``roofline``,
``model_flops_global``, ``useful_flops_ratio``, ``params_total``,
``params_active``, ``plan``), ``chips`` 1 and ``mesh`` "h100x1", and
``trace_s`` (the trace's wall time on the host) in place of ``lower_s``
and ``compile_s``.

``run_cell(..., multi_pod=False | True)`` traces the cell's sharded
step (``launch/steps.py`` with a mesh) on the (16, 16) or (2, 16, 16)
production mesh in ONE process over torch's ``fake`` process-group
backend, as rank 0 on ``meta`` tensors: each rank's arguments are drawn
at their local shapes only, the counts are rank 0's (per chip), and
``utils/comm.py`` records the collectives the step issues (DTensor's
redistributes and the step's own sums and gathers), whose wire bytes
and time ``roofline.analysis.collective_terms`` gives. Such a record
has ``mesh`` "pod16x16" or "pod2x16x16" and ``chips`` 256 or 512.

``run_fl_round`` counts the multi-pod FL round's collectives
(``launch/fl_round.py``) on the (2, 16, 16) production mesh in ONE
process: torch's ``fake`` process-group backend stands in for the other
511 ranks, rank 0 runs its own share of the round on the host (the
fake collectives move nothing), and ``utils/comm.py`` records the bytes
it hands to each collective; nothing runs on a card."""
from __future__ import annotations

import json
import os
import time
import traceback
from typing import Any, Optional

import numpy as np

from repro_torch.configs import registry
from repro_torch.launch import steps as steps_lib
from repro_torch.roofline.analysis import HW, collective_bytes, \
    collective_terms, model_flops, roofline_terms
from repro_torch.roofline.op_cost import analyze_step
from repro_torch.utils.tree import tree_size

RESULTS_DIR = os.environ.get("DRYRUN_RESULTS", "results/dryrun_torch")
MESH = "h100x1"


def _active_params(entry, cfg) -> tuple[int, int]:
    """(total_params, active_params_per_token): active discounts the MoE
    experts to top_k (the reference's count: the MoE block's frozen
    values over n_experts make one expert) and subtracts the embedding
    gather."""
    from repro_torch.models import moe as MOE
    mod = steps_lib._model(entry)
    p = mod.init(0, cfg, device="meta")
    total = tree_size(p["frozen"]) + tree_size(p["train"])
    active = total - cfg.vocab * cfg.d_model   # the gather is no matmul
    moe = getattr(cfg, "moe", None)
    if moe is not None:
        n_moe_layers = cfg.n_layers // getattr(cfg, "moe_every", 1)
        per_expert = tree_size(MOE.moe_init(
            None, moe, "lora", cfg.lora, device="meta")[0]) // moe.n_experts
        active -= n_moe_layers * per_expert * (moe.n_experts - moe.top_k)
    return total, active


def run_cell(arch: str, shape: str, *,
             plan: Optional[steps_lib.CellPlan] = None,
             tag: str = "baseline", save: bool = True, device="meta",
             batch: Optional[int] = None,
             multi_pod: Optional[bool] = None) -> dict:
    """Trace one cell on ``device`` and return (and with ``save`` keep)
    its record. ``batch`` replaces the shape's batch size (a cut).
    ``multi_pod`` False or True traces the cell's sharded step on the
    production mesh over the ``fake`` backend (module docstring; this
    process must have no process group)."""
    if multi_pod is not None:
        return _run_mesh_cell(arch, shape, multi_pod, plan=plan, tag=tag,
                              save=save, batch=batch)
    entry = registry.get(arch)
    cell_info = [c for c in registry.cells()
                 if c["arch"] == arch and c["shape"] == shape][0]
    rec: dict[str, Any] = {"arch": arch, "shape": shape, "mesh": MESH,
                           "tag": tag, "step": cell_info["step"],
                           "device": str(device)}
    if cell_info["skip"]:
        rec.update({"status": "skipped",
                    "skip_reason": cell_info["skip_reason"]})
        if save:
            _append(rec)
        return rec

    plan = plan or steps_lib.plan_for(arch, shape)
    t0 = time.time()
    try:
        built = steps_lib.build_cell(entry, shape, plan=plan, device=device,
                                     batch=batch)
        cost = analyze_step(built["fn"], *built["args"])
        _record(rec, entry, built, cost, time.time() - t0, 1)
        rec["plan"] = {"microbatch": plan.microbatch,
                       "quantize_base": plan.quantize_base,
                       "cfg_updates": plan.cfg_updates}
    except Exception as e:  # record failures: they are actionable bugs
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    if save:
        _append(rec)
    return rec


def _record(rec: dict, entry, built: dict, cost: dict, trace_s: float,
            chips: int) -> None:
    """A traced step's fields of ``rec``: the per-chip counts of
    ``analyze_step``'s ``cost`` and their roofline terms, the model's
    useful FLOPs over all ``chips``."""
    del cost["out"]
    total, active = _active_params(entry, built["cfg"])
    b, s = built["batch"], built["seq"]
    tokens = b if rec["step"] == "decode" else b * s
    mf = model_flops(active, tokens, rec["step"] == "train")
    flops = cost["flops"] * chips
    rec.update({
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "chips": chips,
        "batch": b,
        "memory": {"argument_bytes": cost["argument_bytes"],
                   "output_bytes": cost["output_bytes"],
                   "peak_bytes": cost["peak_bytes"]},
        "fits_one_card": cost["peak_bytes"] <= HW["hbm_bytes"],
        "roofline": roofline_terms(cost),
        "n_ops": cost["n_ops"],
        "model_flops_global": mf,
        "hlo_flops_global": flops,
        "useful_flops_ratio": mf / flops if flops else None,
        "params_total": total,
        "params_active": active,
    })


def _run_mesh_cell(arch: str, shape: str, multi_pod: bool, *, plan, tag,
                   save, batch) -> dict:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.utils import comm

    entry = registry.get(arch)
    cell_info = [c for c in registry.cells()
                 if c["arch"] == arch and c["shape"] == shape][0]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "tag": tag, "step": cell_info["step"],
                           "device": "meta"}
    if cell_info["skip"]:
        rec.update({"status": "skipped",
                    "skip_reason": cell_info["skip_reason"]})
        if save:
            _append(rec)
        return rec
    plan = plan or steps_lib.plan_for(arch, shape)
    t0 = time.time()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = int(np.prod(tuple(mesh.shape)))
        built = steps_lib.build_cell(entry, shape, mesh, plan=plan,
                                     device="meta", batch=batch)
        with comm.record_collectives() as log, comm.record_funcol(mesh):
            cost = analyze_step(built["fn"], *built["args"])
        _record(rec, entry, built, cost, time.time() - t0, chips)
        coll = collective_bytes(log)
        rec["roofline"].update(collective_terms(log))
        rec.update({
            "collectives": {k: coll[k] for k in (
                "all-gather", "all-reduce", "reduce-scatter",
                "all-to-all")},
            "collective_total": coll["total"],
            "collective_by_axis": coll["by_axis"],
            "batch_axes": list(built["batch_axes"]),
            "seq_axes": list(built["seq_axes"]),
            "tp_axes": list(built["tp_axes"]),
            "head_axes": list(built["head_axes"]),
            "ssm_axes": list(built["ssm_axes"]),
            "vocab_axes": list(built["vocab_axes"]),
            "expert_axes": list(built["expert_axes"]),
            "plan": {"microbatch": plan.microbatch,
                     "seq_parallel": plan.seq_parallel,
                     "rules": plan.rules,
                     "quantize_base": plan.quantize_base,
                     "cfg_updates": plan.cfg_updates},
        })
    except Exception as e:  # record failures: they are actionable bugs
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    finally:
        dist.destroy_process_group()
    if save:
        _append(rec)
    return rec


def run_fl_round(arch: str, *, bits, multi_pod: bool = True,
                 clients_per_pod: int = 16, tag: str = "fl_round",
                 save: bool = True) -> dict:
    """Run rank 0's share of the hierarchical multi-pod FL round on the
    production mesh over the ``fake`` backend (this process must have no
    process group; it opens one and closes it) and record the wire bytes
    per chip of its collectives: the paper's compression as the traffic
    between pods. Inputs are drawn from seed 0 on the host."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.core import messages
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch import fl_round
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.utils import comm
    from repro_torch.utils.sharding import placement_leaves
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    entry = registry.get(arch)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict[str, Any] = {"arch": arch, "shape": f"fl_round_b{bits}",
                           "mesh": mesh_name, "tag": tag,
                           "step": "fl_round", "bits": bits,
                           "clients_per_pod": clients_per_pod}
    t0 = time.time()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        built = fl_round.build_fl_round(
            entry, mesh, clients_per_pod=clients_per_pod, bits=bits)
        gen = torch.Generator().manual_seed(0)
        full, treedef = tree_flatten(built["args"][0])
        pls = placement_leaves(built["in_placements"][0])
        local = []
        for s, pl in zip(full, pls):
            # this rank's block, drawn at its own shape (no full tensor)
            shape = fl_round.local_shard(
                torch.empty(s.shape, device="meta"), pl, mesh).shape
            local.append(0.02 * torch.randn(shape, generator=gen))
        weights = torch.ones(built["args"][1].shape)
        with comm.record_collectives() as log:
            built["fn"](tree_unflatten(treedef, local), weights)
        coll = collective_bytes(log)
        cross = sum(r["bytes"] for r in log if r["axis"] == "pod")
        share = [x[0, 0] for x in local]
        qcfg = QuantConfig(bits=bits) if bits else QuantConfig()
        rec.update({
            "status": "ok",
            "run_s": round(time.time() - t0, 1),
            "chips": int(np.prod(tuple(mesh.shape))),
            "collectives": {k: coll[k] for k in ("all-gather",
                                                 "all-reduce")},
            "collective_total": coll["total"],
            "collective_by_axis": coll["by_axis"],
            "cross_pod_bytes_per_chip": cross,
            "cross_pod_wire_bytes_per_chip": coll["by_axis"].get("pod",
                                                                 0.0),
            "message_wire_bytes_per_chip": messages.message_wire_bytes(
                share, qcfg),
            "roofline": collective_terms(log),
            "records": log,
        })
    except Exception as e:  # record failures: they are actionable bugs
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    finally:
        dist.destroy_process_group()
    if save:
        _append(rec)
    return rec


def _append(rec: dict) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    key = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['tag']}"
    with open(os.path.join(RESULTS_DIR, key + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def load_all(results_dir: Optional[str] = None) -> list[dict]:
    d = results_dir or RESULTS_DIR
    if not os.path.isdir(d):
        return []
    out = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            with open(os.path.join(d, fn)) as f:
                out.append(json.load(f))
    return out
