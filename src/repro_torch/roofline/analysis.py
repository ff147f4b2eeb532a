"""Roofline terms of one step on one NVIDIA H100, from the operations and
bytes that ``roofline.op_cost.analyze_step`` counts (no hardware needed:
the step may run on ``meta`` tensors), and the collective terms of a
program over a mesh from the records of ``utils/comm.py`` (the multi-pod
FL round, ``launch/dryrun_lib.py`` ``run_fl_round``, and an LM step
sharded over a mesh, ``run_cell(..., multi_pod=...)``).

Terms, in seconds:
  t_compute      = FLOPs / peak bf16 FLOP/s
  t_memory       = least bytes / HBM bandwidth: the step's arguments
                   read once and its new outputs written once
  t_memory_eager = eager bytes / HBM bandwidth: every aten op reading its
                   operands from and writing its results to memory
  t_collective   = collective wire bytes per chip / NVLink bandwidth,
                   from the records of ``utils/comm.py``
                   (:func:`collective_terms`; 0 for a step on one card)

The roofline is max(t_compute, t_memory), the least time the card could
take for the step; ``dominant`` names its larger term. The eager-traffic
bound max(t_compute, t_memory_eager) is what the port's unfused program
would take at the HBM's rate, and ``dominant_eager`` names its larger
term. A MoE step's least bytes read every expert's bank.

The JAX package counts the dots and the fusion-boundary bytes of XLA's
compiled HLO (``repro/roofline/hlo_cost.py``). FLOPs are comparable op
for op and keep its key ``hlo_flops_per_chip``. The port has no
fusion-boundary count: ``hlo_bytes_per_chip`` is None, and the two byte
counts have keys of their own (``min_bytes_per_chip``,
``eager_bytes_per_chip``), so that a report reading both kinds of record
never compares unlike bytes under one key.

Hardware: NVIDIA's data sheet for the H100 SXM (dense, without
sparsity), the card the port runs on (``NVIDIA H100 80GB HBM3,
700.00 W`` as ``nvidia-smi`` prints its name and power limit); a card
set below 700 W runs slower under load. NVLink: 900 GB/s to the other
cards of a host, 450 GB/s each way.
"""
from __future__ import annotations

HW = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops": 989e12,        # bf16 / fp16 tensor cores
    "peak_flops_fp32": 67e12,    # fp32 outside the tensor cores
    "hbm_bw": 3.35e12,           # bytes/s
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,          # bytes/s each way
}


def _larger(t_compute: float, t_memory: float) -> str:
    return "compute" if t_compute >= t_memory else "memory"


def roofline_terms(cost: dict) -> dict:
    """cost: ``op_cost.analyze_step``'s record of the step on one card
    ('flops', 'bytes', 'argument_bytes', 'output_bytes')."""
    flops = float(cost["flops"])
    eager = float(cost["bytes"])
    least = float(cost["argument_bytes"] + cost["output_bytes"])
    t_compute = flops / HW["peak_flops"]
    t_memory = least / HW["hbm_bw"]
    t_eager = eager / HW["hbm_bw"]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_memory_eager_s": t_eager, "t_collective_s": 0.0,
            "dominant": _larger(t_compute, t_memory),
            "dominant_eager": _larger(t_compute, t_eager),
            "hlo_flops_per_chip": flops, "hlo_bytes_per_chip": None,
            "min_bytes_per_chip": least, "eager_bytes_per_chip": eager,
            "collective_wire_bytes_per_chip": 0.0, "n_collectives": 0}


def collective_bytes(records: list) -> dict:
    """Wire bytes per chip by collective kind, from ``utils/comm.py``'s
    records (what this rank handed to each call), with the JAX package's
    per-kind rule (``repro/roofline/analysis.py`` ``collective_bytes``):
    an all-gather sends its input to each other rank of its group,
    ``bytes * (g - 1)``; a ring all-reduce ``2 * bytes * (g - 1) / g``;
    a reduce-scatter or an all-to-all of a ``bytes`` input
    ``bytes * (g - 1) / g``. A one-rank group moves nothing and is not
    counted. ``by_axis`` splits the total by mesh axis (``pod``: the
    traffic between pods)."""
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "total": 0.0, "n_ops": 0, "by_axis": {}}
    for r in records:
        g = r["group_size"]
        if g <= 1:
            continue
        if r["kind"] == "all-gather":
            wire = float(r["bytes"] * (g - 1))
        elif r["kind"] == "all-reduce":
            wire = 2.0 * r["bytes"] * (g - 1) / g
        else:
            wire = float(r["bytes"]) * (g - 1) / g
        out[r["kind"]] += wire
        out["total"] += wire
        out["n_ops"] += 1
        out["by_axis"][r["axis"]] = out["by_axis"].get(r["axis"], 0.0) + wire
    return out


def collective_terms(records: list) -> dict:
    """The roofline's collective terms from ``utils/comm.py``'s records:
    ``collective_wire_bytes_per_chip``, ``n_collectives`` and
    ``t_collective_s`` over NVLink's bandwidth each way."""
    coll = collective_bytes(records)
    return {"collective_wire_bytes_per_chip": coll["total"],
            "n_collectives": coll["n_ops"],
            "t_collective_s": coll["total"] / HW["nvlink_bw"]}


def model_flops(n_params_active: int, tokens: int, train: bool = True
                ) -> float:
    """6*N*D for a train step (forward and backward); 2*N*D for an
    inference forward."""
    return (6.0 if train else 2.0) * n_params_active * tokens
