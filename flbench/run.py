"""The benchmark of the PyTorch and CUDA port of FLoCoRA: one run of one
cell on the card.

    python3 flbench/run.py --workload resnet8-flocora-k10 --seed 7 \\
        --seconds 20 --trace 0

Prints each number that ``correct`` compares beside its limit as the
last lines of standard error, and one JSON object as the last line of
standard output: ``correct``, ``attempted`` (rounds run), ``failed``
(rounds whose loss was not finite), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last the ``checks``. Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result
and exits with 2; it never falls back to the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "flbench_cache"


def _environment() -> None:
    """Every cache inside the checkout, at fixed paths; the repository's
    sources importable."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    try:
        import torch
        from flbench import bench, cells
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"flbench: cannot import the port or its harness: {e}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flbench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"flbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"flbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    bench.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
