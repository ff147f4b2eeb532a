"""Dry run of the LM cells on one H100: trace every (arch x shape) cell's
step (``launch/steps.py``), record its operations, bytes, memory and
roofline terms (``launch/dryrun_lib.py``) under ``results/dryrun_torch/``
(``DRYRUN_RESULTS`` overrides), and print one line a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID]
        [--shape NAME] [--tag TAG] [--microbatch M] [--list]
        [--device meta|cuda] [--mesh single|multi|both]
        [--seq-parallel | --no-seq-parallel]

On ``meta`` (the default) nothing is allocated and no card is needed: a
full-size cell traces on the host in seconds to minutes. ``--device
cuda`` runs the step on the card (it must fit).

``--mesh`` traces each cell's sharded step instead, on the (16, 16)
single-pod mesh, the (2, 16, 16) multi-pod mesh or both, as rank 0 of
256 or 512 in one process over torch's ``fake`` backend on ``meta``
(``dryrun_lib.run_cell(..., multi_pod=...)``): the record's counts are
per chip and its collectives are the step's. ``--seq-parallel`` /
``--no-seq-parallel`` override the plan's ``seq_parallel``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-round
        [--bits 8] [--arch ID]

counts the multi-pod FL round's collectives on the (2, 16, 16) mesh in
one process over torch's ``fake`` backend (``dryrun_lib.run_fl_round``;
minitron-4b at bits None/8/4/2 by default) and prints its bytes between
pods per chip.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.configs import registry


def summary(rec: dict) -> str:
    """One line of a record: its status, and for a traced cell the
    FLOPs, the least and the eager bytes, argument and peak memory, the
    roofline terms (``tm`` from the least bytes, ``tme`` from the eager
    bytes), the dominant term of each bound, the useful-FLOPs ratio,
    whether it fits one card and the trace time."""
    head = f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: {rec['status']}"
    if rec["status"] == "skipped":
        return f"{head} ({rec['skip_reason']})"
    if rec["status"] == "error":
        return f"{head} {rec['error'][:200]}"
    m, t = rec["memory"], rec["roofline"]
    if rec.get("chips", 1) > 1:
        head += (f" chips={rec['chips']} coll={rec['collective_total']:.6e}"
                 f"B/chip n_coll={t['n_collectives']} "
                 f"tcoll={t['t_collective_s']:.4e}s "
                 f"a2a={rec['collectives']['all-to-all']:.6e}B "
                 f"rs={rec['collectives']['reduce-scatter']:.6e}B "
                 + " ".join(f"{k}={','.join(rec[k + '_axes']) or '-'}"
                            for k in ("batch", "seq", "tp", "head", "ssm",
                                      "vocab", "expert")))
    return (f"{head} batch={rec['batch']} "
            f"flops={t['hlo_flops_per_chip']:.6e} "
            f"min_bytes={t['min_bytes_per_chip']:.6e} "
            f"eager_bytes={t['eager_bytes_per_chip']:.6e} "
            f"arg={m['argument_bytes'] / 1e9:.3f}GB "
            f"peak={m['peak_bytes'] / 1e9:.3f}GB "
            f"tc={t['t_compute_s']:.4e}s tm={t['t_memory_s']:.4e}s "
            f"tme={t['t_memory_eager_s']:.4e}s "
            f"dominant={t['dominant']}/{t['dominant_eager']} "
            f"useful={rec['useful_flops_ratio']:.4f} "
            f"fits={rec['fits_one_card']} ops={rec['n_ops']} "
            f"trace={rec['trace_s']}s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Dry run on one H100: trace every (arch x shape) "
                    "cell; record FLOPs, bytes, memory and the roofline.")
    p.add_argument("--arch", default=None, help="arch id (default: all)")
    p.add_argument("--shape", default=None,
                   choices=[None, *registry.SHAPES], help="shape cell")
    p.add_argument("--tag", default="baseline")
    p.add_argument("--microbatch", type=int, default=None)
    p.add_argument("--list", action="store_true", help="list cells")
    p.add_argument("--device", default="meta", choices=["meta", "cuda"])
    p.add_argument("--mesh", default=None,
                   choices=["single", "multi", "both"],
                   help="trace the sharded step on the production mesh")
    p.add_argument("--seq-parallel", dest="sp", action="store_true",
                   default=None)
    p.add_argument("--no-seq-parallel", dest="sp", action="store_false")
    p.add_argument("--fl-round", action="store_true",
                   help="count the multi-pod FL round's collectives "
                        "instead")
    p.add_argument("--bits", type=int, default=None, choices=[2, 4, 8])
    args = p.parse_args(argv)

    if args.list:
        for c in registry.cells():
            print(c)
        return 0

    from repro_torch.launch import dryrun_lib, steps as steps_lib

    if args.fl_round:
        failures = 0
        for bits in ([args.bits] if args.bits else [None, 8, 4, 2]):
            for arch in ([args.arch] if args.arch else ["minitron-4b"]):
                rec = dryrun_lib.run_fl_round(
                    arch, bits=bits, tag=args.tag
                    if args.tag != "baseline" else "fl_round")
                print(f"[fl_round b={bits}] {arch}: {rec['status']} "
                      + (f"cross_pod={rec['cross_pod_wire_bytes_per_chip']:.6e}"
                         f"B/chip total={rec['collective_total']:.6e}B/chip"
                         f" n={rec['roofline']['n_collectives']} "
                         f"t_coll={rec['roofline']['t_collective_s']:.4e}s"
                         if rec["status"] == "ok"
                         else rec.get("error", "")[:200]), flush=True)
                failures += rec["status"] == "error"
        return 1 if failures else 0

    cells = [c for c in registry.cells()
             if (args.arch is None or c["arch"] == args.arch)
             and (args.shape is None or c["shape"] == args.shape)]
    meshes = {None: [None], "single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for c in cells:
        plan = None
        if args.microbatch is not None or args.sp is not None:
            base = steps_lib.plan_for(c["arch"], c["shape"])
            plan = dataclasses.replace(
                base, microbatch=args.microbatch or base.microbatch,
                seq_parallel=base.seq_parallel if args.sp is None
                else args.sp)
        for mp in meshes:
            rec = dryrun_lib.run_cell(c["arch"], c["shape"], plan=plan,
                                      tag=args.tag, device=args.device,
                                      multi_pod=mp)
            failures += rec["status"] == "error"
            print(summary(rec), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
