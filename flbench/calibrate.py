"""The readings that the limits of ``correct`` are set from, on the card.

    python3 flbench/calibrate.py --workload resnet8-flocora-k10 \\
        --seeds 11 12 13 --control 21 22 23 --half-batch 31 32 33 \\
        --uplink 41 42 43 --out calibrate.jsonl

For each seed it runs the cell's set-up and checked rounds as a
benchmark run does and prints one JSON line of the compared numbers:

* ``--seeds``: the program as it is (the lower readings);
* ``--control``: the control, the reference computed in TF32 (the
  precision below the configuration's fp32 with TF32 off) put in the
  program's place;
* ``--half-batch``: the program with each local step's loss taken over
  the first half of its batch only;
* ``--uplink``: the program with one level (or, on an fp32 wire, one
  value) of each uplink altered where it is produced;
* ``--frozen-norms``: the program with every GroupNorm scale and shift
  left as the broadcast had it;
* ``--one-client``: the program with the first client's trained state
  left as the broadcast had it;
* ``--witness``: the program, the reference and the reference run in
  float64 on the same inputs, compared pairwise (``numbers``: the
  program against the reference, as ``--seeds``; ``vs_fp64``: the
  program against the float64 run; ``fp32_vs_fp64``: the reference
  against the float64 run), to show how far fp32 round-off alone takes
  two sound runs apart; ``clients`` gives, for each client of the first
  cohort, its id, active steps and median leaf's gap in each pair.

A state left unchanged reads about 1 on ``aggregate`` (the stale global
against the FedAvg of the round's uplinks) and needs no run. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flbench import bench, cells, judge  # noqa: E402
from flbench.reference import fl as ref_fl  # noqa: E402
from flbench.reference import model as ref_model  # noqa: E402


def as_program(ref: list, start: dict, bits) -> list:
    """Reference rounds in the form ``capture.Capture`` records."""
    flat = lambda tree: {p: ref_model.get(tree, p).detach().cpu()
                         for p in ref_model.leaf_paths(tree)}
    host = lambda msg: {p: {k: v.detach().cpu() for k, v in m.items()}
                        for p, m in msg.items()}
    return [{"n_steps": r["n_steps"], "losses": r["losses"],
             "trained": [flat(t) for t in r["trained"]],
             "early": {e: {"losses": v["losses"],
                           "trained": [flat(t) for t in v["trained"]]}
                       for e, v in r["early"].items()},
             "bcast": flat(r["bcast"]), "msgs": [host(m) for m in r["msgs"]],
             "global": flat(r["global"]),
             "up_bytes": ref_fl.wire_bytes(start, bits)}
            for r in ref if "trained" in r]


@contextlib.contextmanager
def trainer_fault(change):
    """The server's cohort trainer with ``change(trained, start)`` applied
    to what it returns."""
    from repro_torch.fl import server
    orig = server.make_cohort_trainer

    def make(loss_fn, cfg):
        run = orig(loss_fn, cfg)

        def faulty(frozen, start, batches, n_steps):
            trained, losses = run(frozen, start, batches, n_steps)
            change(trained, start)
            return trained, losses
        return faulty

    server.make_cohort_trainer = make
    try:
        yield
    finally:
        server.make_cohort_trainer = orig


def _reset(trained, start, paths, clients=slice(None)) -> None:
    with torch.no_grad():
        for path in paths:
            ref_model.get(trained, path)[clients] = ref_model.get(start,
                                                                  path)


def frozen_norms():
    return trainer_fault(lambda trained, start: _reset(
        trained, start, [p for p in ref_model.leaf_paths(start)
                         if p[-1] in ("scale", "bias")]))


def one_client():
    return trainer_fault(lambda trained, start: _reset(
        trained, start, ref_model.leaf_paths(start), 0))


@contextlib.contextmanager
def half_batch():
    from repro_torch.models import resnet
    orig = resnet.loss_fn

    def loss_fn(frozen, train, cfg, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return orig(frozen, train, cfg, half)

    resnet.loss_fn = loss_fn
    try:
        yield
    finally:
        resnet.loss_fn = orig


@contextlib.contextmanager
def altered_uplink():
    from repro_torch.core import flocora
    orig = flocora.client_uplink

    def client_uplink(trainable, cfg, *a, **kw):
        msg, res = orig(trainable, cfg, *a, **kw)
        if hasattr(msg, "payload"):
            msg.payload.view(torch.int32)[0, 0] ^= 1
        else:
            leaf = ref_model.get(msg, ref_model.leaf_paths(msg)[0])
            leaf.view(-1)[0] += 1e-3
        return msg, res

    flocora.client_uplink = client_uplink
    try:
        yield
    finally:
        flocora.client_uplink = orig


FAULTS = {"half_batch": half_batch, "uplink": altered_uplink,
          "frozen_norms": frozen_norms, "one_client": one_client}


def one(cell: dict, seed: int, kind: str, dev) -> dict:
    t0 = time.perf_counter()
    fault = FAULTS.get(kind, contextlib.nullcontext)
    with fault():
        run = bench.prepare(cell, seed, dev)
        if kind == "control":
            run.pop("server")
            port = as_program(bench.reference_rounds(cell, run, seed, dev,
                                                     "tf32"),
                              run["start"]["train"],
                              cell["traffic"]["quant_bits"])
        else:
            port, _ = bench.checked_rounds(cell, run)
            run.pop("server")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = bench.reference_rounds(cell, run, seed, dev)
    rec = {"kind": kind, "seed": seed,
           "numbers": bench.numbers(cell, run, port, ref[:len(port)]),
           "program_s": t1 - t0, "reference_s": time.perf_counter() - t1}
    if kind == "witness":
        t2 = time.perf_counter()
        wide = bench.reference_rounds(cell, run, seed, dev, "fp64")
        rec["fp64_s"] = time.perf_counter() - t2
        rec["vs_fp64"] = bench.numbers(cell, run, port, wide[:len(port)])
        bits = cell["traffic"]["quant_bits"]
        ref32 = as_program(ref, run["start"]["train"], bits)
        rec["fp32_vs_fp64"] = bench.numbers(cell, run, ref32,
                                            wide[:len(port)])
        rec["clients"] = client_look(port[0], ref32[0], ref[0], wide[0],
                                     run["start"]["train"])
    return rec


def client_look(port: dict, ref32: dict, ref: dict, wide: dict,
                start: dict) -> list[dict]:
    """Each first-round client's median leaf gap: the program against the
    fp32 reference and against the float64 run, and the one reference
    against the other."""
    paths = ref_model.leaf_paths(start)
    med = lambda p, r: [float(np.median(c)) if c else math.nan
                        for c in judge.client_gaps(p, r, paths)]
    return [{"client": c, "steps": n, "program_vs_fp32": a,
             "fp32_vs_fp64": b, "program_vs_fp64": d}
            for c, n, a, b, d in zip(ref["cohort"], ref["n_steps"],
                                     med(port, ref), med(ref32, wide),
                                     med(port, wide))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    kinds = (("program", "seeds"), ("control", "control"),
             ("half_batch", "half-batch"), ("uplink", "uplink"),
             ("frozen_norms", "frozen-norms"), ("one_client", "one-client"),
             ("witness", "witness"))
    for _, flag in kinds:
        ap.add_argument("--" + flag, type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    for kind, flag in kinds:
        for seed in getattr(args, flag.replace("-", "_")):
            rec = one(cell, seed, kind, dev)
            rec["workload"] = args.workload
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
