"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--profile]

Phases, each of which raises on failure (the script then exits nonzero):
  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once;
  2. hold each kernel against its plain PyTorch version on the card:
     ``quant_pack_rows`` bit-exact (words, scale and zp bits) at bits
     {2, 4, 8} on the main-path (1610, 2560) buffer and ragged cases;
     ``dequant_agg_rows`` within rtol=atol=1e-5 at K in {1, 5, 64} on
     (K, 1610, 640), and bit-identical across block_k;
     ``multi_lora_matmul_packed`` at bits {2, 4, 8} and
     ``multi_lora_matmul`` within rtol=atol=1e-4 at m in {1, 8, 32, 64},
     d in {256, 2560}, R in {4, 8}, E=512, plus K=2559, N=2555, R=6,
     each call repeated and bit-identical; their SASS holds tensor-core
     MMA instructions (``cuobjdump -sass``, where the toolkit has it);
     ``dequant_agg`` (the per-leaf fold) BIT-identical at bits {2, 4, 8},
     K in {1, 5, 64} on the 18 per-leaf shapes of ResNet-8 r=32 and a
     C = 37 leaf, with a scalar and a vector n_valid; ``lora_matmul``
     within 8e-3 * max|y| at tests/test_kernels.py's four shapes,
     kernel_bench's (256, 512, 512, r=32), a ragged (100, 300, 200, r=6)
     and the full-width (512, 2560, 2560, r=32);
  3. drive the FL round: the synchronous FLoCoRA round of
     ``examples/quickstart.py`` ``run_uniform`` (ResNet-8, r=32, alpha=512,
     int8 flat wire, 20 clients with LDA 0.5 over 2000 synthetic images,
     K=5, batch 32, lr 0.01, 1 local epoch) through ``FLServer`` on the
     card, with the kernels' launch counts read around it, then replay
     round 1 on the CPU (plain versions) and compare. Then the same
     setting's other options, each with the counts set to 0 around it:
     the per-leaf wire (``flat_wire=False``, 2 rounds: the flat run's
     bytes, 18 ``dequant_agg`` launches and no ``dequant_agg_rows`` a
     round, the flat run's round-1 uplinks aggregated both ways within
     1e-6 * max|x|); error feedback (int4, oversample 1.4: 7 dispatched,
     5 kept, 2 rounds, round 1 replayed on the CPU); resume (1 round
     checkpointed, a fresh server resumes and runs round 2 beside an
     uninterrupted run, both with cuDNN's deterministic algorithms); and
     ``lora_matmul``'s entry point, which no
     round calls, as a 2-layer bf16 chain at gemma3-4b's width;
  4. drive the serving path: ``benchmarks/round_throughput.py`` run_serve's
     1024-client int4 store (ranks 4 and 8, 2 layers, seed 0) at
     d = 2560 (gemma3-4b's hidden width), an m = 64 step on the fused and
     dequant engines (E = 512 slots) checked against the dense-merge
     oracle with their launch counts, steady step times, and the
     continuous-batching simulator on both paths plus the clock-policy
     churn run at capacity/16;
  5. time each kernel with CUDA events at its path's shapes beside its
     plain version and its bound (``dequant_agg`` at the largest per-leaf
     shape and summed over a round's 18 leaves; ``lora_matmul`` at
     (512, 2560, 2560, r=32) beside ``torch.matmul(x, W)`` in bf16; the
     serving kernels at m in {8, 32, 64}, warm and cold (rotating through
     4 distinct (x, W) sets, more than the L2 holds), beside
     ``torch.matmul(x, W)`` in fp32 and ``torch.sum(W)`` timed the same
     ways).
The line before the last is one JSON object with the kernels' numbers;
the last is ``{"ok": true, "device": {...}}``. ``--profile`` adds one
round under ``torch.profiler`` and prints the device time by kernel.

Imports nothing of JAX. Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 2
# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s fp32 outside the tensor cores,
# 989 TFLOP/s dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
SOURCES = {"quant_pack_rows": ("src/repro_torch/kernels/csrc/quant_pack.cu",
                               "src/repro/kernels/quant_pack.py:67"),
           "dequant_agg_rows": ("src/repro_torch/kernels/csrc/dequant_agg.cu",
                                "src/repro/kernels/dequant_agg.py:159"),
           "multi_lora_matmul_packed": (
               "src/repro_torch/kernels/csrc/multi_lora_matmul.cu",
               "src/repro/kernels/lora_matmul.py:185"),
           "multi_lora_matmul": (
               "src/repro_torch/kernels/csrc/multi_lora_matmul.cu",
               "src/repro/kernels/lora_matmul.py:119"),
           "dequant_agg": ("src/repro_torch/kernels/csrc/dequant_agg.cu",
                           "src/repro/kernels/dequant_agg.py:231"),
           "lora_matmul": ("src/repro_torch/kernels/csrc/lora_matmul.cu",
                           "src/repro/kernels/lora_matmul.py:65")}
# single-adapter LoRA at gemma3-4b's d_model and LoRA rank
# (src/repro/configs/gemma3_4b.py: rank 32, alpha 512)
LORA = dict(m=512, d=2560, r=32, s=512.0 / 32)
LORA_TOL = 8e-3
# B6's checked shapes (m, k, n, r): tests/test_kernels.py's four,
# benchmarks/kernel_bench.py's, a ragged one, the full width
LORA_SHAPES = [(128, 256, 192, 8), (64, 128, 128, 32), (256, 512, 256, 128),
               (8, 128, 128, 4), (256, 512, 512, 32), (100, 300, 200, 6),
               (512, 2560, 2560, 32)]
LEAF_TOL = 1e-6
# the serving path: benchmarks/round_throughput.py run_serve at the
# hidden width of gemma3-4b (src/repro/configs/gemma3_4b.py d_model)
SERVE = dict(n_clients=1024, d_model=2560, n_layers=2, ranks=(4, 8), bits=4,
             seed=0)
SERVE_SCALE = 0.5
SERVE_TOL = 1e-4
# the serving kernels' timed row counts: the simulator's batch (8), a
# rank bucket of the m = 64 step (32) and the whole step (64); cold
# timing rotates through this many distinct (x, W) sets (3 x 26.2 MB of
# W exceeds the 50 MB L2)
SERVE_TIMED_M = (8, 32, 64)
SERVE_COLD_SETS = 4


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """(device ms, call ms) per call. Device time: a ~100 ms sleep kernel
    goes first, so the host has queued all ``iters`` calls before the
    start event fires and the events time the device's work back to
    back. Call time: the same loop without the sleep, so the host's
    per-call cost (Python, checks, allocation, launch) shows when it
    exceeds the device's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for sleep in (True, False):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if sleep:
            torch.cuda._sleep(200_000_000)
        host = time.perf_counter()
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        host = time.perf_counter() - host
        torch.cuda.synchronize()
        if sleep and host > 0.08:
            raise RuntimeError(f"host queued {iters} calls in {host:.3f} s,"
                               " longer than the sleep: fewer iterations")
        out.append(t0.elapsed_time(t1) / iters)
    return out[0], out[1]


def ptxas_summary(log: str) -> list:
    """One line per kernel function of an ``nvcc -Xptxas -v`` log: its
    name (with the serving kernels' source, row tile MT and VEC read off
    the mangled name), registers, spill stores/loads and static shared
    memory."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        got = re.search(r"Compiling entry function '(\S+)'", line)
        if got:
            name = got.group(1)
            # the mangled name's length-prefixed identifiers (a length
            # may follow other digits)
            idents = [name[d.end():d.end() + int(d.group()[i:])]
                      for d in re.finditer(r"\d+", name)
                      for i in range(len(d.group()))]
            kern = [i for i in idents if i.endswith("_kernel")
                    and i.isidentifier()]
            label = kern[-1] if kern else name[:40]
            if "FpSource" in name:
                label += " fp"
            bits = re.search(r"PackedSourceILi(\d)E", name)
            if bits:
                label += f" int{bits.group(1)}"
            tile = re.search(r"Li(\d)ELb([01])E", name)
            if tile:
                label += f" MT={tile.group(1)} VEC={tile.group(2)}"
            cur = {"label": label, "spill": "?", "regs": "?", "smem": "0"}
            rows.append(cur)
            continue
        if cur is None:
            continue
        got = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if got:
            cur["spill"] = f"{got.group(1)}/{got.group(2)} B"
        got = re.search(r"Used (\d+) registers", line)
        if got:
            cur["regs"] = got.group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = smem.group(1) if smem else "0"
    return [f"{r['label']}: {r['regs']} registers, spill stores/loads "
            f"{r['spill']}, static smem {r['smem']} B" for r in rows]


def sass_mma_counts(source: str) -> dict:
    """{kernel function: (HMMA, HGMMA) instruction counts} in the SASS of
    ``source``'s built library, read with ``cuobjdump -sass``; {} when the
    toolkit has no cuobjdump."""
    import os
    import re
    import shutil
    from repro_torch.kernels.build import LIBRARY, _lib_path
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(_lib_path(
        source, LIBRARY.build_dir))], capture_output=True, text=True,
        check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        got = re.search(r"Function : (\S+)", line)
        if got:
            fn = got.group(1)
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += bool(re.search(r"\bHMMA\b", line))
            counts[fn][1] += bool(re.search(r"\bHGMMA\b", line))
    return {f: tuple(c) for f, c in counts.items()}


def check_serving_sass() -> None:
    """Every instance of the serving product kernel holds tensor-core
    MMA instructions (the split-bf16 base product)."""
    counts = sass_mma_counts("multi_lora_matmul")
    if not counts:
        print("sass multi_lora_matmul: cuobjdump not found, not checked")
        return
    prod = {f: c for f, c in counts.items() if "lora_product_kernel" in f}
    other = {f: c for f, c in counts.items() if f not in prod}
    hmma = sorted(c[0] for c in prod.values())
    print(f"sass multi_lora_matmul: {len(prod)} lora_product_kernel "
          f"instances, HMMA per instance {hmma[0]}..{hmma[-1]}, HGMMA "
          f"{sum(c[1] for c in prod.values())}; other kernels' HMMA "
          f"{sum(c[0] for c in other.values())} ({len(other)} kernels)")
    if not prod or hmma[0] == 0:
        raise AssertionError("a serving product kernel has no tensor-core "
                             "MMA in its SASS")


def _bound_ms(nbytes: float, flops: float,
              peak: float = FP32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _f32_bits(t):
    import torch
    return t.contiguous().view(torch.int32)


def check_quant_pack(main_layouts, dev) -> float:
    """Kernel vs plain, bit for bit. Returns the max abs difference over
    levels, scale and zp (0.0 when bit-exact)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    cases = []
    for bits, (flat, nv) in main_layouts.items():
        cases.append((f"main bits={bits}", flat, nv, bits))
    rng = np.random.default_rng(7)
    for bits in (2, 4, 8):
        per = 32 // bits
        c, n = 37, 128 * per * 2
        x = rng.normal(size=(c, n)) * rng.uniform(1e-3, 10.0, size=(c, 1))
        x[0] = 0.0                                   # all-zero row
        x[1] = np.abs(x[1])                          # xmin = 0
        x[2] = -np.abs(x[2])
        nv = rng.integers(0, n + 1, size=c)
        nv[:6] = [n, n, n, 0, 1, per + 1]
        cases.append((f"ragged bits={bits}",
                      torch.tensor(x, dtype=torch.float32, device=dev),
                      torch.tensor(nv, dtype=torch.int32, device=dev), bits))
    worst = 0.0
    for name, x, nv, bits in cases:
        got = kops.quant_pack_rows(x, nv, bits)
        want = kref.quant_pack_rows_ref(x, nv, bits)
        torch.cuda.synchronize()
        same = (torch.equal(got[0], want[0])
                and torch.equal(_f32_bits(got[1]), _f32_bits(want[1]))
                and torch.equal(_f32_bits(got[2]), _f32_bits(want[2])))
        err = max(
            float((kref.unpack_words(got[0], bits)
                   - kref.unpack_words(want[0], bits)).abs().max()),
            float((got[1] - want[1]).abs().max()),
            float((got[2] - want[2]).abs().max()))
        print(f"check quant_pack_rows {name} {tuple(x.shape)}: "
              f"bit-exact={same} max_abs_err={err}")
        if not same:
            raise AssertionError(f"quant_pack_rows {name} differs from its "
                                 "plain version")
        worst = max(worst, err)
    return worst


def check_dequant_agg(nv, nw: int, dev) -> float:
    """Kernel vs plain within rtol=atol=1e-5, and the kernel bit-identical
    to itself across block_k. Returns the max abs difference."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(11)
    c = nv.shape[0]
    worst = 0.0
    for k in (1, 5, 64):
        words = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(k, c, nw), dtype=np.uint32)).to(dev)
        scale = torch.from_numpy(rng.uniform(
            1e-4, 1e-2, size=(k, c)).astype(np.float32)).to(dev)
        scale[:, -3:] = 0.0                      # phantom rows
        zp = torch.from_numpy(rng.integers(
            0, 256, size=(k, c)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.uniform(1, 100, size=k).astype(
            np.float32)).to(dev)
        w = w / w.sum()
        got = kops.dequant_agg_rows(words, scale, zp, w, nv, 8)
        want = kref.dequant_agg_rows_ref(words, scale, zp, w, nv, 8)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        close = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
        same = True
        for bk in sorted({1, 2, 4, k}):
            again = kops.dequant_agg_rows(words, scale, zp, w, nv, 8,
                                          block_k=bk)
            same &= torch.equal(_f32_bits(again), _f32_bits(got))
        same &= torch.equal(_f32_bits(kops.dequant_agg_rows(
            words, scale, zp, w, nv, 8, whole_k=True)), _f32_bits(got))
        torch.cuda.synchronize()
        print(f"check dequant_agg_rows K={k} {tuple(words.shape)}: "
              f"max_abs_err={err} within_1e-5={close} "
              f"block_k_bit_identical={same}")
        if not (close and same):
            raise AssertionError(f"dequant_agg_rows K={k} failed its check")
        worst = max(worst, err)
    return worst


def leaf_shapes(tree, bits: int) -> list:
    """(C, Nw, n_valid) of each packed leaf of ``tree`` on the per-leaf
    wire at ``bits``, in flatten order."""
    from repro_torch.core import flat as flatcodec
    lo = flatcodec.layout_for(tree, bits)
    return [(sp.rows, lo.leaf_nw(sp), sp.n_valid) for sp in lo.leaves
            if sp.quantized]


def check_leaf_agg(tree, dev) -> float:
    """``dequant_agg`` (B3) against its plain version, bit for bit, at
    bits {2, 4, 8} and K in {1, 5, 64} on every per-leaf shape of the
    main path's tree plus a C = 37 leaf, with the leaf's own scalar
    n_valid and a random (C,) vector; random words, two scale = 0 rows,
    a -0.0 weight. Returns the max abs difference (0.0 when
    bit-identical)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(13)
    worst, calls = 0.0, 0
    for bits in (2, 4, 8):
        shapes = leaf_shapes(tree, bits) + [(37, 128, 300 * 8 // bits)]
        for k in (1, 5, 64):
            for c, nw, nv in shapes:
                n = nw * (32 // bits)
                words = torch.from_numpy(rng.integers(
                    0, 1 << 32, size=(k, c, nw), dtype=np.uint32)).to(dev)
                scale = torch.from_numpy(rng.uniform(
                    1e-4, 1e-2, size=(k, c)).astype(np.float32)).to(dev)
                scale[:, :2] = 0.0
                zp = torch.from_numpy(rng.integers(
                    0, 1 << bits, size=(k, c)).astype(np.float32)).to(dev)
                w = torch.from_numpy(rng.uniform(
                    0.05, 1.0, size=k).astype(np.float32)).to(dev)
                w[0] = -0.0
                vec = torch.from_numpy(rng.integers(
                    0, n + 1, size=c).astype(np.int32)).to(dev)
                for n_valid in (nv, vec):
                    got = kops.dequant_agg(words, scale, zp, w, bits, n_valid)
                    want = kref.dequant_agg_ref(words, scale, zp, w, bits,
                                                n_valid)
                    torch.cuda.synchronize()
                    calls += 1
                    if not torch.equal(_f32_bits(got), _f32_bits(want)):
                        raise AssertionError(
                            f"dequant_agg bits={bits} K={k} C={c} Nw={nw} "
                            "differs from its plain version: max_abs_err "
                            f"{float((got - want).abs().max())}")
                    worst = max(worst, float((got - want).abs().max()))
        print(f"check dequant_agg bits={bits}: K in (1, 5, 64) x "
              f"{len(shapes)} leaves (C, Nw) {sorted({s[:2] for s in shapes})}"
              " x scalar/vector n_valid: bit-identical")
    print(f"check dequant_agg: {calls} calls bit-identical")
    return worst


def _bf16_inputs(m: int, k: int, n: int, r: int, seed: int, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def bf(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(torch.bfloat16).to(dev)

    return bf((m, k), 0.5), bf((k, n), 0.1), bf((k, r), 0.1), bf((r, n), 0.1)


def check_lora_matmul(dev) -> float:
    """``lora_matmul`` (B6) against its plain version within
    8e-3 * max|y| at ``LORA_SHAPES``. Returns the max abs difference."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    worst = 0.0
    for i, (m, k, n, r) in enumerate(LORA_SHAPES):
        x, w, a, b = _bf16_inputs(m, k, n, r, 100 + i, dev)
        got = kops.lora_matmul(x, w, a, b, 2.0).to(torch.float32)
        want = kref.lora_matmul_ref(x, w, a, b, 2.0).to(torch.float32)
        torch.cuda.synchronize()
        err, ymax = float((got - want).abs().max()), float(want.abs().max())
        print(f"check lora_matmul (M, K, N, r)={(m, k, n, r)}: max_abs_err "
              f"{err:.4g}, max|y| {ymax:.4g}, tol {LORA_TOL * ymax:.4g}")
        if not err <= LORA_TOL * ymax:
            raise AssertionError(f"lora_matmul {(m, k, n, r)} differs from "
                                 "its plain version")
        worst = max(worst, err)
    return worst


def _serving_slabs(rng, e: int, k: int, n: int, r: int, bits: int, dev):
    """Random packed serving slabs on the card: words of random bits
    (their tails past K and R hold nonzero levels, which the kernel must
    not read), dequantized values within about +-0.2, and a quarter of
    the slots rank-padded (A rows past r - r/4 with scale = zp = 0 and
    zero words)."""
    import numpy as np
    import torch
    per = 32 // bits
    qmax = (1 << bits) - 1
    kw, rw = -(-k // per), -(-r // per)

    def side(shape):
        sc = rng.uniform(0.5, 1.5, size=shape) * 0.4 / qmax
        zp = rng.integers(0, qmax + 1, size=shape)
        return (torch.from_numpy(sc.astype(np.float32)).to(dev),
                torch.from_numpy(zp.astype(np.float32)).to(dev))

    def words(shape):
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)

    pad = slice(0, e // 4)
    cut = r - max(r // 4, 1)
    aq, bq = words((e, r, kw)), words((e, n, rw))
    aq[pad, cut:] = 0
    aq, bq = torch.from_numpy(aq).to(dev), torch.from_numpy(bq).to(dev)
    a_s, a_z = side((e, r))
    b_s, b_z = side((e, n))
    a_s[pad, cut:] = 0.0
    a_z[pad, cut:] = 0.0
    return aq, a_s, a_z, bq, b_s, b_z


def check_serving_kernels(dev) -> tuple[float, float]:
    """``multi_lora_matmul_packed`` (B4) and ``multi_lora_matmul`` (B5)
    against their plain versions on the card within rtol = atol = 1e-4:
    m in {1, 8, 32, 64}, d in {256, 2560}, R in {4, 8}, E = 512, bits
    {2, 4, 8}, plus a ragged K = 2559, N = 2555 with R = 6; a second call
    on the same inputs must give the same bits. Returns the max abs
    differences (B4, B5)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(5)
    e = 512
    shapes = [(d, d, r) for d in (256, 2560) for r in (4, 8)]
    shapes.append((2559, 2555, 6))
    worst = [0.0, 0.0]

    def held(fn, want, i, what):
        got = fn()
        again = fn()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL))
        if not torch.equal(_f32_bits(got), _f32_bits(again)):
            raise AssertionError(f"{what}: two calls on the same inputs "
                                 "differ")
        if not ok:
            raise AssertionError(f"{what}: max_abs_err {err}")
        worst[i] = max(worst[i], err)
        return err

    for k, n, r in shapes:
        w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(
            np.float32)).to(dev)
        xs = torch.from_numpy((rng.standard_normal((64, k)) * 0.5).astype(
            np.float32)).to(dev)
        ms = (1, 8, 32, 64) if (k, n) != (2559, 2555) else (32, 64)
        for bits in (2, 4, 8):
            slab = _serving_slabs(rng, e, k, n, r, bits, dev)
            line = []
            for m in ms:
                ids = rng.integers(0, e, m)
                x = xs[:m].contiguous()
                want = kref.multi_lora_matmul_q_ref(
                    x, w, *slab, torch.from_numpy(ids).to(dev), SERVE_SCALE,
                    bits)
                err = held(lambda: kops.multi_lora_matmul_packed(
                    x, w, *slab, ids.tolist(), SERVE_SCALE, bits), want, 0,
                    f"multi_lora_matmul_packed bits={bits} m={m} K={k} "
                    f"N={n} R={r}")
                line.append(f"m={m} {err:.3g}")
            print(f"check multi_lora_matmul_packed bits={bits} K={k} N={n} "
                  f"R={r} E={e}: max_abs_err " + ", ".join(line)
                  + "; repeat bit-identical")
        a = torch.from_numpy((rng.standard_normal((e, k, r)) * 0.1).astype(
            np.float32)).to(dev)
        b = torch.from_numpy((rng.standard_normal((e, r, n)) * 0.1).astype(
            np.float32)).to(dev)
        line = []
        for m in ms:
            ids = rng.integers(0, e, m)
            x = xs[:m].contiguous()
            want = kref.multi_lora_matmul_ref(
                x, w, a, b, torch.from_numpy(ids).to(dev), SERVE_SCALE)
            err = held(lambda: kops.multi_lora_matmul(
                x, w, a, b, ids.tolist(), SERVE_SCALE), want, 1,
                f"multi_lora_matmul m={m} K={k} N={n} R={r}")
            line.append(f"m={m} {err:.3g}")
        print(f"check multi_lora_matmul K={k} N={n} R={r} E={e}: "
              "max_abs_err " + ", ".join(line) + "; repeat bit-identical")
    return worst[0], worst[1]


def _counted(fn):
    """(fn's result, the kernels' launch counts during it): the counts
    are set to 0 just before and read just after."""
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    out = fn()
    return out, kops.launch_counts()


def _add_counts(total: dict, counts: dict) -> None:
    for key, v in counts.items():
        total[key] = total.get(key, 0) + v


def serving_phase(dev) -> dict:
    """The multi-tenant serving path on the card at d = 2560: the
    1024-client store, an m = 64 step on both paths checked against the
    dense-merge oracle and each other with its launch counts, steady
    step times, and the simulator runs of run_serve. Returns what the
    timing phase and the JSON line need."""
    import numpy as np
    import torch
    from repro_torch import serve
    from repro_torch.serve.engine import _dequant_stacks

    t0 = time.perf_counter()
    weights, store = serve.make_store(**SERVE, device=dev)
    torch.cuda.synchronize()
    total = sum(store.bytes_of(c) for c in store.cids)
    print(f"serve store: {SERVE['n_clients']} clients d={SERVE['d_model']} "
          f"layers={SERVE['n_layers']} ranks={SERVE['ranks']} "
          f"int{SERVE['bits']}: {total} wire bytes "
          f"({time.perf_counter() - t0:.1f} s)")
    cache = serve.AdapterCache(capacity_bytes=2 * total, qcfg=store.qcfg,
                               device=dev)
    engines = {p: serve.AdapterServingEngine(
        weights, SERVE_SCALE, store.qcfg, cache, fetch=store.fetch, path=p,
        slab_slots=512, device=dev) for p in ("fused", "dequant")}
    t0 = time.perf_counter()
    engines["fused"].admit(list(range(SERVE["n_clients"])))
    print(f"serve admit {SERVE['n_clients']} clients: "
          f"{time.perf_counter() - t0:.1f} s, cache {cache.stats()}")
    rng = np.random.default_rng(0)
    m = 64
    cids = [int(c) for c in rng.integers(0, SERVE["n_clients"], m)]
    x = torch.from_numpy((rng.standard_normal((m, SERVE["d_model"])) * 0.5
                          ).astype(np.float32)).to(dev)
    buckets = len({store.rank_of(c) for c in cids})
    want_launches = SERVE["n_layers"] * buckets
    launches: dict = {}

    y, counts = _counted(lambda: engines["fused"].step(x, cids))
    _add_counts(launches, counts)
    if counts["multi_lora_matmul_packed"] != want_launches \
            or counts["multi_lora_matmul"] != 0:
        raise AssertionError(f"fused step launch counts {counts}, expected "
                             f"{want_launches} multi_lora_matmul_packed")
    yd, counts = _counted(lambda: engines["dequant"].step(x, cids))
    _add_counts(launches, counts)
    if counts["multi_lora_matmul"] != want_launches \
            or counts["multi_lora_matmul_packed"] != 0:
        raise AssertionError(f"dequant step launch counts {counts}, "
                             f"expected {want_launches} multi_lora_matmul")
    y_or = engines["fused"].oracle_step(x, cids)
    torch.cuda.synchronize()
    if tuple(y.shape) != (m, SERVE["d_model"]) \
            or not bool(torch.isfinite(y).all()):
        raise AssertionError("fused step output is not finite or lost its "
                             "shape")
    ymax = float(y_or.abs().max())
    err_or = float((y - y_or).abs().max())
    err_fd = float((y - yd).abs().max())
    print(f"serve step m={m} ({buckets} rank buckets): fused vs oracle "
          f"max_abs {err_or:.4g}, fused vs dequant {err_fd:.4g}, max|y| "
          f"{ymax:.4g}, tol {SERVE_TOL * ymax:.4g}; launches fused "
          f"{want_launches} multi_lora_matmul_packed, dequant "
          f"{want_launches} multi_lora_matmul")
    if err_or > SERVE_TOL * ymax or err_fd > SERVE_TOL * ymax:
        raise AssertionError("serving step disagrees with the oracle or "
                             "the dequant path")

    step_ms = {}
    for p, eng in engines.items():
        ts = []
        for _ in range(20):
            t1 = time.perf_counter()
            eng.step(x, cids)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t1)
        step_ms[p] = 1e3 * float(np.median(ts))
        print(f"serve steady step {p} m={m} E=512: median "
              f"{step_ms[p]:.3f} ms over 20 (min {1e3 * min(ts):.3f} ms), "
              f"{m / step_ms[p] * 1e3:.0f} rows/s")

    sims = {}
    wl = serve.WorkloadConfig(n_requests=192, rate_rps=2000.0, gen_tokens=8,
                              max_batch=8, zipf_a=1.1, seed=0)
    for p in ("fused", "dequant"):
        c = serve.AdapterCache(capacity_bytes=2 * total, qcfg=store.qcfg,
                               device=dev)
        eng = serve.AdapterServingEngine(weights, SERVE_SCALE, store.qcfg, c,
                                         fetch=store.fetch, path=p,
                                         slab_slots=128, device=dev)
        sims[p], counts = _counted(lambda: serve.simulate(eng, store, wl))
        _add_counts(launches, counts)
    c = serve.AdapterCache(capacity_bytes=total // 16, qcfg=store.qcfg,
                           policy="clock", device=dev)
    eng = serve.AdapterServingEngine(weights, SERVE_SCALE, store.qcfg, c,
                                     fetch=store.fetch, device=dev)
    sims["churn"], counts = _counted(lambda: serve.simulate(
        eng, store, serve.WorkloadConfig(n_requests=192, rate_rps=2000.0,
                                         gen_tokens=4, max_batch=8,
                                         zipf_a=1.0, seed=1)))
    _add_counts(launches, counts)
    for name, rep in sims.items():
        print(f"serve sim {name}: " + json.dumps(
            {k: rep[k] for k in ("path", "requests", "steps", "wall_s",
                                 "requests_per_s", "tokens_per_s", "p50_ms",
                                 "p99_ms", "hit_rate", "hits", "misses",
                                 "evictions", "cache_entries",
                                 "store_fetches")}))
        if rep["requests"] != 192 or rep["hits"] + rep["misses"] != 192:
            raise AssertionError(f"serve sim {name} did not complete every "
                                 "request")
    if sims["churn"]["evictions"] <= 0:
        raise AssertionError("the capacity/16 churn run evicted nothing")
    print(f"serving path launches: {launches}")
    for key in ("multi_lora_matmul_packed", "multi_lora_matmul"):
        if launches[key] <= 0:
            raise AssertionError(f"{key} was not launched on the serving "
                                 "path")

    # the timing inputs: the staged rank-8 slab (E = 512) of the fused
    # engine, 64 rows over its staged slots, and its fp stacks
    staged = engines["fused"]._staged[8][1]
    lyr = staged.layers[0]
    slots = sorted(staged.slots.values())
    ids = [int(i) for i in rng.choice(slots, m)]
    a_stack, b_stack = _dequant_stacks(lyr, SERVE["bits"], SERVE["d_model"],
                                       staged.rank)
    return {"launches": launches, "x": x, "w": weights[0], "layer": lyr,
            "ids": ids, "stacks": (a_stack, b_stack), "rank": staged.rank,
            "n_slots": staged.n_slots, "step_ms": step_ms}


def _rotating(calls):
    """A function that runs ``calls[i % len(calls)]`` on its i-th call."""
    state = [0]

    def fn():
        calls[state[0] % len(calls)]()
        state[0] += 1
    return fn


def time_serving_kernels(sv: dict, dev) -> dict:
    """B4 and B5 with CUDA events at m in ``SERVE_TIMED_M`` (d = 2560,
    E = 512, rank-8 bucket, int4), each warm (one (x, W) set, W held in
    L2) and cold (rotating through ``SERVE_COLD_SETS`` distinct (x, W)
    sets, more bytes than the 50 MB L2 holds), beside torch.matmul(x, W)
    in fp32 (TF32 off) and torch.sum(W) (a plain streaming read of W)
    timed the same ways, the plain versions and the bounds; then where
    the device time goes (prep and product kernels) at m = 64 and m = 8.
    Returns the m = 64 cold figures for the JSON line."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    x64, w0, lyr, ids64 = sv["x"], sv["w"], sv["layer"], sv["ids"]
    a_stack, b_stack = sv["stacks"]
    bits, s = SERVE["bits"], SERVE_SCALE
    k, n = w0.shape
    r = sv["rank"]
    rng = np.random.default_rng(17)
    sets = [(x64, w0)] + [
        (torch.from_numpy((rng.standard_normal(x64.shape) * 0.5).astype(
            np.float32)).to(dev),
         torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(
             np.float32)).to(dev)) for _ in range(SERVE_COLD_SETS - 1)]
    kw, rw = lyr.aq.shape[2], lyr.bq.shape[2]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for m in SERVE_TIMED_M:
            ids = ids64[:m]
            ids_t = torch.tensor(ids, device=dev)
            xw = [(x[:m].contiguous(), w) for x, w in sets]
            fns = {
                "multi_lora_matmul_packed": lambda x, w: \
                    kops.multi_lora_matmul_packed(x, w, *lyr, ids, s, bits),
                "multi_lora_matmul": lambda x, w: kops.multi_lora_matmul(
                    x, w, a_stack, b_stack, ids, s),
                "matmul": lambda x, w: torch.matmul(x, w),
                "read_w": lambda x, w: torch.sum(w)}
            t = {}
            for name, f in fns.items():
                warm = _time_ms(lambda f=f: f(*xw[0]), 200)
                cold = _time_ms(_rotating(
                    [lambda f=f, a=a: f(*a) for a in xw]), 200)
                t[name] = {"warm": warm, "cold": cold}
            x = xw[0][0]
            t["multi_lora_matmul_packed"]["plain"] = _time_ms(
                lambda: kref.multi_lora_matmul_q_ref(x, w0, *lyr, ids_t, s,
                                                     bits), 20)
            t["multi_lora_matmul"]["plain"] = _time_ms(
                lambda: kref.multi_lora_matmul_ref(x, w0, a_stack, b_stack,
                                                   ids_t, s), 20)
            # what the function must move: x, W and the output once, ids,
            # and each DISTINCT gathered slot's adapter once (words and
            # sidecars, or fp stacks). Operations: the base product as
            # the split-bf16 kernel computes it (3 tensor-core passes),
            # h, y and B4's dequant in fp32; the old figure counted the
            # base product as fp32 FMA on the CUDA cores
            distinct = len(set(ids))
            common = 4 * (m * k + k * n + m * n + m)
            q_bytes = common + distinct * 4 * (r * kw + 2 * r + n * rw
                                               + 2 * n)
            f_bytes = common + distinct * 4 * (k * r + r * n)
            lora_ops = 2 * m * r * k + 2 * m * n * r + 2 * m * n
            tc_ms = 3 * 2 * m * k * n / BF16_FLOPS * 1e3
            for name, nbytes, extra in (
                    ("multi_lora_matmul_packed", q_bytes,
                     2 * m * r * k + 2 * m * n * r),
                    ("multi_lora_matmul", f_bytes, 0)):
                ops_ms = tc_ms + (lora_ops + extra) / FP32_FLOPS * 1e3
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                t[name]["bound"] = (bytes_ms, "bytes") if bytes_ms >= ops_ms \
                    else (ops_ms, "operations")
                t[name]["fp32_fma_bound"] = _bound_ms(
                    nbytes, 2 * m * k * n + lora_ops + extra)
                t[name]["bytes"] = nbytes
            t["matmul"]["bound"] = _bound_ms(4 * (m * k + k * n + m * n),
                                             2 * m * k * n)
            for name in ("multi_lora_matmul_packed", "multi_lora_matmul"):
                v = t[name]
                print(f"{name} m={m} K={k} N={n} R={r} E={sv['n_slots']} "
                      f"({distinct} distinct slots): kernel cold "
                      f"{v['cold'][0] * 1e3:.2f} us, warm "
                      f"{v['warm'][0] * 1e3:.2f} us on the device "
                      f"({v['cold'][1] * 1e3:.2f} us a call from Python); "
                      f"plain {v['plain'][0] * 1e3:.2f} us; bound "
                      f"{v['bound'][0] * 1e3:.2f} us by {v['bound'][1]} "
                      f"({v['bytes']} B; split-bf16 tensor-core product "
                      f"{tc_ms * 1e3:.2f} us); as fp32 FMA the bound "
                      f"would be {v['fp32_fma_bound'][0] * 1e3:.2f} us by "
                      f"{v['fp32_fma_bound'][1]}")
            v = t["matmul"]
            print(f"torch.matmul(x, W) alone, fp32, TF32 off, ({m}, {k}) x "
                  f"({k}, {n}): cold {v['cold'][0] * 1e3:.2f} us, warm "
                  f"{v['warm'][0] * 1e3:.2f} us on the device (bound "
                  f"{v['bound'][0] * 1e3:.2f} us by {v['bound'][1]})")
            out[m] = t
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    v = out[SERVE_TIMED_M[-1]]["read_w"]
    print(f"torch.sum(W), a plain streaming read of W ({4 * k * n} B): cold "
          f"{v['cold'][0] * 1e3:.2f} us "
          f"({4 * k * n / v['cold'][0] / 1e9:.2f} TB/s), warm "
          f"{v['warm'][0] * 1e3:.2f} us")
    for m in (64, 8):
        x = sets[0][0][:m].contiguous()
        ids = ids64[:m]
        for name, f in (
                ("multi_lora_matmul_packed", lambda: \
                    kops.multi_lora_matmul_packed(x, w0, *lyr, ids, s,
                                                  bits)),
                ("multi_lora_matmul", lambda: kops.multi_lora_matmul(
                    x, w0, a_stack, b_stack, ids, s))):
            split = kernel_split(f, 20)
            print(f"{name} m={m} device time by kernel (torch.profiler, 20 "
                  "warm calls): " + ", ".join(
                      f"{nm[:48]} {us:.2f} us" for nm, us in split))
    t64 = out[64]
    return {name: (t64[name]["cold"], t64[name]["plain"], t64[name]["bound"])
            for name in ("multi_lora_matmul_packed", "multi_lora_matmul")}


def quickstart_data():
    """examples/quickstart.py run_uniform: 20 non-IID (LDA 0.5) clients
    over 2000 synthetic 32x32x3 images."""
    import numpy as np
    from repro_torch.data import SyntheticVision, lda_partition
    rng = np.random.default_rng(0)
    sv = SyntheticVision(seed=0)
    y = rng.integers(0, 10, 2000)
    x = sv.sample(rng, y)
    parts = lda_partition(y, 20, alpha=0.5)
    return [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]


def make_server(model, data, device, fl=None, server=None):
    """The quickstart round's FLServer; ``fl``/``server`` override
    FLoCoRAConfig / ServerConfig fields (the options' phases)."""
    from repro_torch.core.flocora import FLoCoRAConfig
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.fl import ClientConfig, FLServer, ServerConfig
    from repro_torch.models import resnet
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    return FLServer(
        model, lambda f, t, b: resnet.loss_fn(f, t, cfg, b), data,
        ServerConfig(n_clients=20, clients_per_round=5, **(server or {})),
        ClientConfig(local_epochs=1, batch_size=32, lr=0.01),
        FLoCoRAConfig(rank=32, alpha=512.0, **{"quant_bits": 8, **(fl or {})}),
        device=device)


def hold_trees(tree_a, tree_b, bits: int, what: str) -> float:
    """Trees of two runs of one round: each quantized leaf within 4
    quantization steps of its range at ``bits``, 1-D leaves within
    1e-4 + 1e-3 of their magnitude. A round's ~10 SGD steps amplify
    summation-order differences in the adapters: on the CPU alone, 1
    thread against 8 moves the ``a`` factors by up to 0.6 of an int8
    step. Returns the largest difference."""
    import numpy as np
    from repro_torch.utils.tree import flatten_with_names
    worst = 0.0
    for (name, a), (_, b) in zip(flatten_with_names(tree_a),
                                 flatten_with_names(tree_b)):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        if a.ndim >= 2:
            tol = 4 * (max(a.max(), 0.0) - min(a.min(), 0.0)) \
                / ((1 << bits) - 1)
        else:
            tol = 1e-4 + 1e-3 * np.abs(a).max()
        d = float(np.abs(a - b).max())
        worst = max(worst, d)
        if d > tol:
            raise AssertionError(f"{what} {name}: max diff {d} > {tol}")
    return worst


BYTE_KEYS = ("down_bytes", "up_bytes", "up_bytes_measured", "n_agg",
             "n_straggled", "tcc_bytes", "wasted_bytes")


def compare_with_cpu(rec_gpu: dict, tree_gpu, model_cpu, data, fl=None,
                     server=None) -> None:
    """Replay round 1 on the CPU (the kernels' plain versions, CPU convs)
    with the same options and hold the card's round to it: the same
    cohort and bytes, loss within rtol 1e-3, trees as ``hold_trees``."""
    t0 = time.perf_counter()
    srv = make_server(model_cpu, data, "cpu", fl, server)
    rec = srv.run_round()
    for key in BYTE_KEYS:
        if rec[key] != rec_gpu[key]:
            raise AssertionError(f"cpu replay {key}: {rec[key]} != "
                                 f"{rec_gpu[key]}")
    if not math.isclose(rec["client_loss"], rec_gpu["client_loss"],
                        rel_tol=1e-3):
        raise AssertionError(f"cpu replay loss {rec['client_loss']} != "
                             f"{rec_gpu['client_loss']}")
    bits = srv.fcfg.quant_bits
    worst = hold_trees(srv.global_train, tree_gpu, bits, "cpu replay")
    print(f"cpu replay of round 1 {fl or {}} {server or {}}: loss "
          f"{rec['client_loss']:.6f} vs card {rec_gpu['client_loss']:.6f}, "
          f"bytes identical, max adapter diff {worst:.3g} "
          f"({time.perf_counter() - t0:.1f} s)")


def run_rounds(server, rounds: int, label: str) -> tuple:
    """Drive ``rounds`` rounds with every launch count set to 0 just
    before and read just after each. Returns (records, per-round counts,
    round-1 tree copy, wall seconds per round)."""
    import torch
    from repro_torch.utils.tree import tree_map
    recs, counts, walls, tree1 = [], [], [], None
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec, c = _counted(server.run_round)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        recs.append(rec)
        counts.append(c)
        print(f"{label} round {rec['round']}: {walls[-1]:.3f} s {rec}; "
              f"launches {c}")
        if not math.isfinite(rec["client_loss"]):
            raise AssertionError(f"{label} round {rec['round']} loss is not "
                                 "finite")
        if rec["round"] == 1:
            tree1 = tree_map(lambda x: x.clone(), server.global_train)
    return recs, counts, tree1, walls


def leaf_round_phase(data, flat_recs, flat_server, captured, dev) -> dict:
    """The per-leaf wire (``flat_wire=False``) on the card, 2 rounds, and
    the flat run's round-1 uplinks aggregated both ways. Returns what the
    timing phase and the JSON line need."""
    import torch
    from repro_torch.core import aggregation
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import resnet
    from repro_torch.utils.tree import flatten_with_names
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    server = make_server(resnet.init(0, cfg, device=dev), data, dev,
                         fl={"flat_wire": False})
    n_leaves = len(leaf_shapes(server.global_train, 8))
    recs, counts, _, walls = run_rounds(server, ROUNDS, "per-leaf")
    k = server.scfg.clients_per_round
    for rec, frec, c in zip(recs, flat_recs, counts):
        for key in BYTE_KEYS:
            if rec[key] != frec[key]:
                raise AssertionError(f"per-leaf round {rec['round']} {key}:"
                                     f" {rec[key]} != flat {frec[key]}")
        if c["dequant_agg"] != n_leaves or c["dequant_agg_rows"] != 0 \
                or c["quant_pack_rows"] < n_leaves * (k + 1):
            raise AssertionError(f"per-leaf round launch counts {c}")
    # the flat run's round-1 uplinks, both folds
    msgs, w = captured["msgs"], captured["weights"]
    (flat_out, c_flat) = _counted(lambda: aggregation.fedavg_packed(msgs, w))
    leaf_msgs = [m.as_tree() for m in msgs]
    (leaf_out, c_leaf) = _counted(
        lambda: aggregation.fedavg_packed(leaf_msgs, w))
    torch.cuda.synchronize()
    if c_flat["dequant_agg_rows"] != 1 or c_leaf["dequant_agg"] != n_leaves:
        raise AssertionError(f"aggregate launch counts {c_flat} {c_leaf}")
    worst = 0.0
    for (name, a), (_, b) in zip(flatten_with_names(flat_out),
                                 flatten_with_names(leaf_out)):
        d, xmax = float((a - b).abs().max()), float(a.abs().max())
        worst = max(worst, d / max(xmax, 1e-30))
        if d > LEAF_TOL * xmax:
            raise AssertionError(f"per-leaf vs flat fold {name}: {d} > "
                                 f"{LEAF_TOL} * {xmax}")
    print(f"round-1 uplinks aggregated per leaf ({n_leaves} dequant_agg "
          f"launches) vs flat (1 dequant_agg_rows): worst diff "
          f"{worst:.3g} of max|x| (tol {LEAF_TOL})")
    diff = hold_trees(flat_server.global_train, server.global_train, 8,
                      "per-leaf vs flat run")
    print(f"per-leaf run vs flat run after {ROUNDS} rounds: max diff "
          f"{diff:.3g}; round walls {[round(t, 4) for t in walls]} s")
    launches = {}
    for c in counts:
        _add_counts(launches, c)
    # the timing inputs: each packed leaf's K stacked payloads, as
    # fedavg_packed hands them to dequant_agg
    nw = torch.as_tensor(w, dtype=torch.float32).to(dev)
    nw = nw / nw.sum()
    per_msg = [[x for _, x in flatten_with_names(m) if hasattr(x, "payload")]
               for m in leaf_msgs]
    per_leaf = [(torch.stack([g.payload for g in group]),
                 torch.stack([g.scale for g in group]),
                 torch.stack([g.zp for g in group]), nw, group[0].bits,
                 group[0].n_per_channel) for group in zip(*per_msg)]
    return {"launches": launches, "walls": walls, "inputs": per_leaf}


def ef_phase(data, model_cpu, dev) -> dict:
    """Error feedback on the card: int4, oversample 1.4 (7 dispatched, 5
    kept, so the straggler fold runs), 2 rounds, round 1 replayed on the
    CPU."""
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import resnet
    fl = {"quant_bits": 4, "error_feedback": True}
    sv = {"oversample": 1.4}
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    server = make_server(resnet.init(0, cfg, device=dev), data, dev, fl, sv)
    recs, counts, tree1, walls = run_rounds(server, ROUNDS, "ef")
    for rec, c in zip(recs, counts):
        if rec["n_agg"] + rec["n_straggled"] != 7 or rec["n_agg"] != 5:
            raise AssertionError(f"ef round {rec['round']}: {rec}")
        if c["quant_pack_rows"] < 8 or c["dequant_agg_rows"] != 1:
            raise AssertionError(f"ef round launch counts {c}")
    stored = len(server.aggregator.residuals)
    if stored < 7:
        raise AssertionError(f"ef residuals stored for {stored} clients")
    print(f"ef: residuals stored for {stored} clients (kept and folded "
          f"stragglers); round walls {[round(t, 4) for t in walls]} s")
    compare_with_cpu(recs[0], tree1, model_cpu, data, fl, sv)
    launches = {}
    for c in counts:
        _add_counts(launches, c)
    return {"launches": launches, "walls": walls}


def resume_phase(data, dev) -> dict:
    """Kill/resume on the card with cuDNN's deterministic algorithms: an
    uninterrupted 2-round run; a run checkpointed every round into a
    directory under build/ that stops after round 1; a FRESH FLServer
    (the same frozen base, its adapters zeroed) that resumes it and runs
    round 2. Held to the uninterrupted run: the same cohort (the
    sampler's state), the same bytes, loss and trees within the CPU
    replay's tolerance; whether they came out bit-identical is printed."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import resnet
    from repro_torch.utils.tree import flatten_with_names, tree_map
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=ROOT / "build")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        whole = make_server(resnet.init(0, cfg, device=dev), data, dev)
        want, _, _, _ = run_rounds(whole, 2, "resume: uninterrupted")
        sv = {"checkpoint_dir": d, "checkpoint_every": 1}
        first = make_server(resnet.init(0, cfg, device=dev), data, dev,
                            server=sv)
        run_rounds(first, 1, "resume: killed after")
        del first
        model = resnet.init(0, cfg, device=dev)
        model["train"] = tree_map(torch.zeros_like, model["train"])
        again = make_server(model, data, dev, server=sv)
        if not again.try_resume() or again.round != 1:
            raise AssertionError("the fresh server did not resume round 1")
        recs, counts, _, _ = run_rounds(again, 1, "resume: resumed")
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(d, ignore_errors=True)
    rec, want = recs[0], want[1]
    for key in BYTE_KEYS + ("round",):
        if rec[key] != want[key]:
            raise AssertionError(f"resumed round 2 {key}: {rec[key]} != "
                                 f"uninterrupted {want[key]}")
    if again.rng.bit_generator.state != whole.rng.bit_generator.state:
        raise AssertionError("resumed run sampled another cohort")
    if not math.isclose(rec["client_loss"], want["client_loss"],
                        rel_tol=1e-3):
        raise AssertionError(f"resumed loss {rec['client_loss']} != "
                             f"{want['client_loss']}")
    diff = hold_trees(whole.global_train, again.global_train, 8,
                      "resumed vs uninterrupted")
    exact = rec["client_loss"] == want["client_loss"] and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_names(whole.global_train),
            flatten_with_names(again.global_train)))
    print(f"resume: round 2 after a restart vs the uninterrupted run: same "
          f"cohort and bytes, loss {rec['client_loss']:.7f} vs "
          f"{want['client_loss']:.7f}, max tree diff {diff:.3g}, "
          f"bit-identical={exact} (cudnn.deterministic=True in this phase)")
    return {"launches": counts[0], "max_diff": diff, "bit_identical": exact}


def lora_chain_phase(dev) -> dict:
    """``lora_matmul``'s entry point as a user calls it: no round of the
    JAX package reaches its TPU kernel (only tests and kernel_bench do),
    so this drives a 2-layer bf16 chain y = lora(gelu(lora(x))) at
    gemma3-4b's width (m = 512 rows, d = 2560, r = 32, s = alpha/r = 16),
    weights random from seed 0, and holds it to the plain versions'
    chain. Returns the launch counts and the first layer's operands."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    m, d, r, s = LORA["m"], LORA["d"], LORA["r"], LORA["s"]
    layers = [_bf16_inputs(m, d, d, r, 200 + i, dev) for i in range(2)]
    x = layers[0][0]

    def chain(fn):
        h = x
        for i, (_, w, a, b) in enumerate(layers):
            h = fn(h, w, a, b, s)
            if i == 0:
                h = torch.nn.functional.gelu(h)
        return h

    y, counts = _counted(lambda: chain(kops.lora_matmul))
    want = chain(kref.lora_matmul_ref).to(torch.float32)
    torch.cuda.synchronize()
    y = y.to(torch.float32)
    err, ymax = float((y - want).abs().max()), float(want.abs().max())
    print(f"lora_matmul chain (2 layers, m={m}, d={d}, r={r}, s={s}): "
          f"launches {counts['lora_matmul']}, max_abs_err {err:.4g} vs the "
          f"plain chain, max|y| {ymax:.4g}")
    if counts["lora_matmul"] != 2 or not bool(torch.isfinite(y).all()) \
            or err > 2 * LORA_TOL * ymax:
        raise AssertionError("the lora_matmul chain failed its check")
    return {"launches": counts, "operands": layers[0]}


def kernel_split(fn, calls: int) -> list:
    """[(kernel name, device us a call)] of ``calls`` calls of ``fn``
    under torch.profiler, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sorted(((e.key, e.self_device_time_total / calls) for e in ev),
                  key=lambda t: -t[1])


def time_leaf_and_lora(leaf: dict, chain: dict, dev) -> dict:
    """B3 at the largest per-leaf shape and summed over a round's leaves,
    and B6 at the full width, beside their plain versions and bounds;
    ``torch.matmul(x, W)`` in bf16 as context for B6."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    inputs = leaf["inputs"]

    def leaf_cost(pk, sc, zp, w, bits, nv):
        # bytes the function must move: the words that hold a valid
        # level, the sidecars and weights once, the whole fp32 output;
        # 4 operations per valid level and client
        k, c, nw = pk.shape
        words = k * c * -(-nv * bits // 32)
        return (4 * words + 8 * k * c + 4 * k + 4 * c * nw * (32 // bits),
                4 * k * c * nv)

    big = max(inputs, key=lambda t: t[0].numel())
    bk, bc, bnw = big[0].shape

    def one():
        kops.dequant_agg(*big[:5], big[5])

    def plain_one():
        kref.dequant_agg_ref(*big[:5], big[5])

    def all_leaves():
        for t in inputs:
            kops.dequant_agg(*t[:5], t[5])

    t_one = _time_ms(one, 200)
    t_one_p = _time_ms(plain_one, 10)
    t_all = _time_ms(all_leaves, 20)
    # a round of the plain version is ~1,200 small launches, more than
    # the launch queue holds behind the sleep kernel: sum its leaves
    per_leaf_p = [_time_ms(lambda t=t: kref.dequant_agg_ref(*t[:5], t[5]),
                           5) for t in inputs]
    t_all_p = (sum(t[0] for t in per_leaf_p), sum(t[1] for t in per_leaf_p))
    b_one = _bound_ms(*leaf_cost(*big))
    costs = [leaf_cost(*t) for t in inputs]
    b_all = _bound_ms(sum(c[0] for c in costs), sum(c[1] for c in costs))
    print(f"dequant_agg largest leaf (K, C, Nw)=({bk}, {bc}, {bnw}) int8: "
          f"kernel {t_one[0] * 1e3:.2f} us on the device ({t_one[1] * 1e3:.2f}"
          f" us a call), plain {t_one_p[0] * 1e3:.2f} us, bound "
          f"{b_one[0] * 1e3:.3f} us by {b_one[1]} "
          f"({leaf_cost(*big)[0]} B)")
    print(f"dequant_agg a round ({len(inputs)} leaves, K={bk}): kernels "
          f"{t_all[0] * 1e3:.2f} us on the device ({t_all[1] * 1e3:.2f} us "
          f"of calls), plain {t_all_p[0] * 1e3:.2f} us, bound "
          f"{b_all[0] * 1e3:.3f} us by {b_all[1]} "
          f"({sum(c[0] for c in costs)} B)")

    x, w, a, b = chain["operands"]
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    s = LORA["s"]
    t_l = _time_ms(lambda: kops.lora_matmul(x, w, a, b, s), 100)
    t_lp = _time_ms(lambda: kref.lora_matmul_ref(x, w, a, b, s), 20)
    t_mm = _time_ms(lambda: torch.matmul(x, w), 200)
    l_bytes = 2 * (m * k + k * n + k * r + r * n + m * n)
    l_flops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n + 2 * m * n
    b_l = _bound_ms(l_bytes, l_flops, BF16_FLOPS)
    print(f"lora_matmul (M, K, N, r)=({m}, {k}, {n}, {r}) bf16: kernel "
          f"{t_l[0] * 1e3:.2f} us on the device ({t_l[1] * 1e3:.2f} us a "
          f"call), plain {t_lp[0] * 1e3:.2f} us, bound {b_l[0] * 1e3:.2f} us "
          f"by {b_l[1]} ({l_flops / 1e9:.3f} GFLOP, {l_bytes} B); "
          f"torch.matmul(x, W) bf16 alone {t_mm[0] * 1e3:.2f} us")
    split = kernel_split(lambda: kops.lora_matmul(x, w, a, b, s), 20)
    print("lora_matmul device time by kernel (torch.profiler, 20 calls): "
          + ", ".join(f"{name[:40]} {us:.2f} us" for name, us in split))
    return {"dequant_agg": (t_one, t_one_p, b_one),
            "dequant_agg_round": (t_all, t_all_p, b_all),
            "lora_matmul": (t_l, t_lp, b_l), "matmul_bf16": t_mm}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="run one more round under torch.profiler")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import flat as flatcodec
    from repro_torch.core import messages
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.build import LIBRARY
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import resnet
    from repro_torch.utils.tree import tree_leaves, tree_map

    dev = torch.device("cuda")
    card = _card_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(card)

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = LIBRARY.build()
    for name, info in built.items():
        print(f"built {name} in {info['seconds']:.1f} s")
        for line in ptxas_summary(info["log"]):
            print(f"  ptxas {name}: {line}")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({len(built)} sources compiled)")
    check_serving_sass()

    # 2. kernels vs plain versions at the main path's shapes --------------
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    model_cpu = resnet.init(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    # a client's update: every adapter moved off its init (``a`` is zero)
    update = tree_map(
        lambda p: (p + 0.02 * torch.randn(p.shape, generator=gen)).to(dev),
        model_cpu["train"])
    main_layouts = {}
    for bits in (2, 4, 8):
        lo = flatcodec.layout_for(update, bits)
        main_layouts[bits] = (
            flatcodec.flat_rows(tree_leaves(update), lo),
            torch.from_numpy(lo.n_valid_vec()).to(dev))
    lo8 = flatcodec.layout_for(update, 8)
    print(f"main-path layout int8: C_total={lo8.c_total} N_max={lo8.n_max} "
          f"Nw_max={lo8.nw_max} valid levels={int(lo8.n_valid_vec().sum())}")
    err_q = check_quant_pack(main_layouts, dev)
    torch.cuda.synchronize()
    err_d = check_dequant_agg(main_layouts[8][1], lo8.nw_max, dev)
    torch.cuda.synchronize()
    err_mq, err_mf = check_serving_kernels(dev)
    t0 = time.perf_counter()
    err_b3 = check_leaf_agg(update, dev)
    err_b6 = check_lora_matmul(dev)
    print(f"per-leaf and lora_matmul checks: "
          f"{time.perf_counter() - t0:.1f} s")

    # 3. the FL round on the card ----------------------------------------
    data = quickstart_data()
    server = make_server(resnet.init(0, cfg, device="cuda"), data, "cuda")
    static = messages.message_wire_bytes(server.global_train,
                                         QuantConfig(bits=8))
    # keep round 1's uplinks: the per-leaf phase aggregates them both ways
    captured = {}
    flat_aggregate = server.aggregator.aggregate

    def recording_aggregate(msgs, weights):
        if not captured:
            captured.update(msgs=list(msgs), weights=weights.clone())
        return flat_aggregate(msgs, weights)

    server.aggregator.aggregate = recording_aggregate
    kops.reset_launch_counts()
    round_s = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        rec = server.run_round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        print(f"round {rec['round']}: {round_s[-1]:.3f} s {rec}")
        if rec["round"] == 1:
            rec1, tree1 = rec, tree_map(lambda x: x.clone(),
                                        server.global_train)
    launches = kops.launch_counts()
    print(f"main path launches: {launches}")
    k = server.scfg.clients_per_round
    for rec in server.history:
        if rec["up_bytes_measured"] != 277_816 or static != 277_816:
            raise AssertionError(f"uplink bytes {rec['up_bytes_measured']}"
                                 f" (static {static}) != 277816")
        if not math.isfinite(rec["client_loss"]):
            raise AssertionError(f"round {rec['round']} loss is not finite")
    if launches["quant_pack_rows"] < ROUNDS * (k + 1) \
            or launches["dequant_agg_rows"] != ROUNDS:
        raise AssertionError(f"main path launch counts {launches}")
    for leaf, init in zip(tree_leaves(server.global_train),
                          tree_leaves(model_cpu["train"])):
        if leaf.shape != init.shape or not bool(torch.isfinite(leaf).all()):
            raise AssertionError("global adapters are not finite or lost "
                                 "their shape")
    compare_with_cpu(rec1, tree1, model_cpu, data)

    # 3b. the round's options, and lora_matmul's entry point --------------
    t0 = time.perf_counter()
    leaf = leaf_round_phase(data, server.history, server, captured, dev)
    ef = ef_phase(data, model_cpu, dev)
    resumed = resume_phase(data, dev)
    chain = lora_chain_phase(dev)
    print(f"options phases: {time.perf_counter() - t0:.1f} s; launches: "
          f"per-leaf {leaf['launches']}, ef {ef['launches']}, resume "
          f"{resumed['launches']}, lora chain {chain['launches']}")
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.run_round()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = prof.key_averages()
        kernels = sorted((e for e in ev if e.device_type.name == "CUDA"),
                         key=lambda e: -e.self_device_time_total)
        dev_us = sum(e.self_device_time_total for e in kernels)
        print(f"profiled round: wall {wall * 1e3:.1f} ms, device busy "
              f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}%), "
              f"{sum(e.count for e in kernels)} kernel launches")
        for e in kernels[:15]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:90]}")

    # 4. the serving path on the card --------------------------------------
    t0 = time.perf_counter()
    sv = serving_phase(dev)
    print(f"serving phase: {time.perf_counter() - t0:.1f} s")

    # 5. times at the paths' shapes ---------------------------------------
    flat, nv = main_layouts[8]
    c, n = flat.shape
    nw = n // 4
    nvv = nv.cpu().numpy().astype(np.int64)
    t_q = _time_ms(lambda: kops.quant_pack_rows(flat, nv, 8), 200)
    t_qp = _time_ms(lambda: kref.quant_pack_rows_ref(flat, nv, 8), 10)
    # bytes the function must move: the valid levels in, every word and
    # the sidecars out (the kernel never reads a column past n_valid)
    q_bytes = 4 * nvv.sum() + 4 * c + 4 * c * nw + 8 * c
    q_bound = _bound_ms(q_bytes, 9 * nvv.sum())
    msgs = [flatcodec.pack_flat(tree_map(
        lambda p: (p + 0.02 * torch.randn(p.shape, generator=gen).to(dev)),
        update), 8) for _ in range(k)]
    pk = torch.stack([m.payload for m in msgs])
    sc = torch.stack([m.scale for m in msgs])
    zp = torch.stack([m.zp for m in msgs])
    w = torch.full((k,), 1.0 / k, device=dev)
    t_d = _time_ms(lambda: kops.dequant_agg_rows(pk, sc, zp, w, nv, 8), 200)
    t_dp = _time_ms(lambda: kref.dequant_agg_rows_ref(pk, sc, zp, w, nv, 8),
                    10)
    words_read = int(((nvv + 3) // 4).sum())
    d_bytes = 4 * k * words_read + 8 * k * c + 4 * k + 4 * c + 4 * c * n
    d_bound = _bound_ms(d_bytes, 4 * k * nvv.sum())
    for name, shape, t, tp, bound, nbytes in (
            ("quant_pack_rows int8", tuple(flat.shape), t_q, t_qp, q_bound,
             q_bytes),
            (f"dequant_agg_rows K={k}", tuple(pk.shape), t_d, t_dp, d_bound,
             d_bytes)):
        print(f"{name} {shape}: kernel {t[0] * 1e3:.2f} us on the device "
              f"({t[1] * 1e3:.2f} us a call from Python), plain "
              f"{tp[0] * 1e3:.2f} us ({tp[1] * 1e3:.2f} us a call), bound "
              f"{bound[0] * 1e3:.2f} us ({nbytes} B)")
    print(f"round wall times (s): flat {[round(s, 4) for s in round_s]}, "
          f"per-leaf {[round(s, 4) for s in leaf['walls']]}, ef "
          f"{[round(s, 4) for s in ef['walls']]}")
    t_serve = time_serving_kernels(sv, dev)
    t_leaf = time_leaf_and_lora(leaf, chain, dev)

    rows = []
    for name, t, tp, bound, err, n_launch in (
            ("quant_pack_rows", t_q, t_qp, q_bound, err_q,
             launches["quant_pack_rows"]),
            ("dequant_agg_rows", t_d, t_dp, d_bound, err_d,
             launches["dequant_agg_rows"]),
            ("multi_lora_matmul_packed",
             *t_serve["multi_lora_matmul_packed"], err_mq,
             sv["launches"]["multi_lora_matmul_packed"]),
            ("multi_lora_matmul", *t_serve["multi_lora_matmul"], err_mf,
             sv["launches"]["multi_lora_matmul"]),
            ("dequant_agg", *t_leaf["dequant_agg"], err_b3,
             leaf["launches"]["dequant_agg"]),
            ("lora_matmul", *t_leaf["lora_matmul"], err_b6,
             chain["launches"]["lora_matmul"])):
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n_launch,
                     "max_abs_err": err, "ms": t[0], "plain_ms": tp[0],
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": None})
    missing = [r["name"] for r in rows if r["launches"] <= 0]
    if missing:
        raise AssertionError(f"not launched on their paths: {missing}")
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
