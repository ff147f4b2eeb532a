"""Perf iteration driver: named variants of a cell's plan, each a
hypothesis -> change pair, traced by the dry run and recorded under the
variant's tag beside the baseline: the JAX package's
``launch/perf_iter.py`` on one H100.

    PYTHONPATH=src python -m repro_torch.launch.perf_iter \\
        --cell gemma3-4b:decode_32k --variant int8_base [--device meta]
        [--mesh single|multi]

``--variant list`` prints the cell's variants. ``sp_on`` / ``sp_off``
turn the plan's sequence parallelism on or off. ``--mesh`` traces the
variant's sharded step on the (16, 16) or (2, 16, 16) production mesh
over torch's ``fake`` backend (``dryrun_lib.run_cell(...,
multi_pod=...)``); without it the step is traced for one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def variants_for(arch: str, shape: str) -> dict:
    from repro_torch.launch.steps import CellPlan, plan_for
    from repro_torch.models.moe import MoESpec
    base = plan_for(arch, shape)
    v: dict[str, CellPlan] = {}

    def p(**kw):
        return dataclasses.replace(base, **kw)

    # universal levers
    v["int8_base"] = p(quantize_base=True)
    v["xent2048"] = p(cfg_updates={"xent_chunk": 2048})
    v["kvchunk4096"] = p(cfg_updates={"kv_chunk": 4096})
    v["no_remat"] = p(cfg_updates={"remat": False})
    if base.microbatch > 1:
        v["micro_half"] = p(microbatch=base.microbatch // 2)
        v["micro_half_int8"] = p(microbatch=base.microbatch // 2,
                                 quantize_base=True)
    v["int8_xent2048"] = p(quantize_base=True,
                           cfg_updates={"xent_chunk": 2048})
    v["combo_min"] = p(quantize_base=True, microbatch=2,
                       cfg_updates={"xent_chunk": 2048})
    v["combo_nem"] = p(quantize_base=True, microbatch=8,
                       cfg_updates={"xent_chunk": 256, "kv_chunk": 512})
    v["combo_nem2"] = p(quantize_base=True, microbatch=4,
                        cfg_updates={"xent_chunk": 256})
    if not base.seq_parallel:
        v["sp_on"] = p(seq_parallel=True)
    else:
        v["sp_off"] = p(seq_parallel=False)

    if arch == "deepseek-v2-236b":
        moe = MoESpec(d_model=5120, d_ff=1536, n_experts=160, top_k=6,
                      n_shared=2, mlp_kind="swiglu", capacity_factor=1.0)
        v["cap1.0"] = p(cfg_updates={"moe": moe})
        v["cap1.0_int8"] = p(quantize_base=True, cfg_updates={"moe": moe})
    if arch == "llama4-maverick-400b-a17b":
        moe = MoESpec(d_model=5120, d_ff=8192, n_experts=128, top_k=1,
                      n_shared=1, mlp_kind="swiglu", capacity_factor=1.0)
        v["cap1.0"] = p(cfg_updates={"moe": moe})
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", required=True,
                    help="variant name or 'list'")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"])
    ap.add_argument("--mesh", default=None, choices=["single", "multi"],
                    help="trace the sharded step on the production mesh")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    vs = variants_for(arch, shape)
    if args.variant == "list":
        print("\n".join(vs))
        return 0
    from repro_torch.launch import dryrun_lib
    rec = dryrun_lib.run_cell(
        arch, shape, plan=vs[args.variant], tag=args.variant,
        device=args.device,
        multi_pod=None if args.mesh is None else args.mesh == "multi")
    if rec["status"] != "ok":
        print(rec.get("error", rec["status"]))
        return 1
    t = rec["roofline"]
    print(f"{arch} x {shape} [{args.variant}]: "
          f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
          f"tc={t['t_compute_s']:.3e} tm={t['t_memory_s']:.3e} "
          f"tme={t['t_memory_eager_s']:.3e} "
          f"tcoll={t['t_collective_s']:.3e} dom={t['dominant']} "
          f"chips={rec['chips']} "
          f"useful={rec['useful_flops_ratio']:.3f}"
          + "".join(f" {k}={','.join(rec[k + '_axes']) or '-'}"
                    for k in ("head", "ssm", "vocab", "expert")
                    if k + "_axes" in rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
