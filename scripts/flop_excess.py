"""Where a step's FLOPs go in the port, on meta tensors: by phase
(forward; recompute, the model code ``torch.utils.checkpoint`` runs again
in the backward pass; backward, autograd's derivative formulas) and by
the line of ``repro_torch`` that issued them, and how many of them no
output of the step reads (``analyze_step(..., sites=True)``), by site.

    PYTHONPATH=src python scripts/flop_excess.py --arch gemma3-4b \\
        [--shape train_4k] [--batch B] [--top 12]

Traces the arch's full config at the cell's published shapes (``--batch``
cuts the batch): a full-size trace, for a host with minutes to spare, not
for the tests.
"""
from __future__ import annotations

import argparse
import collections
import time

from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.roofline.op_cost import analyze_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    t0 = time.time()
    b = steps.build_cell(registry.get(args.arch), args.shape,
                         batch=args.batch, device="meta")
    r = analyze_step(b["fn"], *b["args"], sites=True)
    total = r["flops"]
    phases = collections.Counter()
    for (phase, _), f in r["by_site"].items():
        phases[phase] += f
    dead = total - r["needed_flops"]
    print(f"{args.arch} {args.shape} batch {b['batch']} microbatch "
          f"{b['plan'].microbatch}: {total:.6e} FLOPs, needed "
          f"{r['needed_flops']:.6e}, dead {dead:.6e} "
          f"({100 * dead / total:.2f}%); traced in {time.time() - t0:.1f} s")
    for phase, f in phases.most_common():
        print(f"  {phase:9s} {f:.6e} ({100 * f / total:.2f}%)")
    print("  by site (phase, line):")
    for (phase, site), f in sorted(r["by_site"].items(),
                                   key=lambda kv: -kv[1])[:args.top]:
        print(f"    {phase:9s} {site:52s} {f:.6e} "
              f"({100 * f / total:.2f}%)")
    print("  dead by site:")
    for (phase, site), f in sorted(r["dead_by_site"].items(),
                                   key=lambda kv: -kv[1])[:args.top]:
        print(f"    {phase:9s} {site:52s} {f:.6e} "
              f"({100 * f / total:.2f}%)")
    return r


if __name__ == "__main__":
    main()
