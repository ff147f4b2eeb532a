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
     ``multi_lora_matmul`` within rtol=atol=1e-4 at m in {1, 8, 64},
     d in {256, 2560}, R in {4, 8}, E=512, plus K=2559, N=2555, R=6;
  3. drive the FL round: the synchronous FLoCoRA round of
     ``examples/quickstart.py`` ``run_uniform`` (ResNet-8, r=32, alpha=512,
     int8 flat wire, 20 clients with LDA 0.5 over 2000 synthetic images,
     K=5, batch 32, lr 0.01, 1 local epoch) through ``FLServer`` on the
     card, with the kernels' launch counts read around it, then replay
     round 1 on the CPU (plain versions) and compare;
  4. drive the serving path: ``benchmarks/round_throughput.py`` run_serve's
     1024-client int4 store (ranks 4 and 8, 2 layers, seed 0) at
     d = 2560 (gemma3-4b's hidden width), an m = 64 step on the fused and
     dequant engines (E = 512 slots) checked against the dense-merge
     oracle with their launch counts, steady step times, and the
     continuous-batching simulator on both paths plus the clock-policy
     churn run at capacity/16;
  5. time each kernel with CUDA events at its path's shapes beside its
     plain version and its bound.
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
# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SOURCES = {"quant_pack_rows": ("src/repro_torch/kernels/csrc/quant_pack.cu",
                               "src/repro/kernels/quant_pack.py:67"),
           "dequant_agg_rows": ("src/repro_torch/kernels/csrc/dequant_agg.cu",
                                "src/repro/kernels/dequant_agg.py:159"),
           "multi_lora_matmul_packed": (
               "src/repro_torch/kernels/csrc/multi_lora_matmul.cu",
               "src/repro/kernels/lora_matmul.py:185"),
           "multi_lora_matmul": (
               "src/repro_torch/kernels/csrc/multi_lora_matmul.cu",
               "src/repro/kernels/lora_matmul.py:119")}
# the serving path: benchmarks/round_throughput.py run_serve at the
# hidden width of gemma3-4b (src/repro/configs/gemma3_4b.py d_model)
SERVE = dict(n_clients=1024, d_model=2560, n_layers=2, ranks=(4, 8), bits=4,
             seed=0)
SERVE_SCALE = 0.5
SERVE_TOL = 1e-4


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


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
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
    m in {1, 8, 64}, d in {256, 2560}, R in {4, 8}, E = 512, bits
    {2, 4, 8}, plus a ragged K = 2559, N = 2555 with R = 6. Returns the
    max abs differences (B4, B5)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(5)
    e = 512
    shapes = [(d, d, r) for d in (256, 2560) for r in (4, 8)]
    shapes.append((2559, 2555, 6))
    worst = [0.0, 0.0]

    def held(got, want, i):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL))
        worst[i] = max(worst[i], err)
        return err, ok

    for k, n, r in shapes:
        w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(
            np.float32)).to(dev)
        xs = torch.from_numpy((rng.standard_normal((64, k)) * 0.5).astype(
            np.float32)).to(dev)
        ms = (1, 8, 64) if (k, n) != (2559, 2555) else (64,)
        for bits in (2, 4, 8):
            slab = _serving_slabs(rng, e, k, n, r, bits, dev)
            line = []
            for m in ms:
                ids = rng.integers(0, e, m)
                x = xs[:m].contiguous()
                got = kops.multi_lora_matmul_packed(x, w, *slab, ids.tolist(),
                                                    SERVE_SCALE, bits)
                want = kref.multi_lora_matmul_q_ref(
                    x, w, *slab, torch.from_numpy(ids).to(dev), SERVE_SCALE,
                    bits)
                err, ok = held(got, want, 0)
                line.append(f"m={m} {err:.3g}")
                if not ok:
                    raise AssertionError(
                        f"multi_lora_matmul_packed bits={bits} m={m} K={k} "
                        f"N={n} R={r}: max_abs_err {err}")
            print(f"check multi_lora_matmul_packed bits={bits} K={k} N={n} "
                  f"R={r} E={e}: max_abs_err " + ", ".join(line))
        a = torch.from_numpy((rng.standard_normal((e, k, r)) * 0.1).astype(
            np.float32)).to(dev)
        b = torch.from_numpy((rng.standard_normal((e, r, n)) * 0.1).astype(
            np.float32)).to(dev)
        line = []
        for m in ms:
            ids = rng.integers(0, e, m)
            x = xs[:m].contiguous()
            got = kops.multi_lora_matmul(x, w, a, b, ids.tolist(), SERVE_SCALE)
            want = kref.multi_lora_matmul_ref(
                x, w, a, b, torch.from_numpy(ids).to(dev), SERVE_SCALE)
            err, ok = held(got, want, 1)
            line.append(f"m={m} {err:.3g}")
            if not ok:
                raise AssertionError(f"multi_lora_matmul m={m} K={k} N={n} "
                                     f"R={r}: max_abs_err {err}")
        print(f"check multi_lora_matmul K={k} N={n} R={r} E={e}: "
              "max_abs_err " + ", ".join(line))
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


def time_serving_kernels(sv: dict, dev) -> dict:
    """B4 and B5 with CUDA events at (m = 64, d = 2560, E = 512, rank-8
    bucket, int4) beside their plain versions, their bounds, and
    torch.matmul(x, W) alone (TF32 off) as context for the base
    product."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    x, w, lyr, ids = sv["x"], sv["w"], sv["layer"], sv["ids"]
    a_stack, b_stack = sv["stacks"]
    bits, s = SERVE["bits"], SERVE_SCALE
    m, k = x.shape
    n, r = w.shape[1], sv["rank"]
    ids_t = torch.tensor(ids, device=dev)
    t_q = _time_ms(lambda: kops.multi_lora_matmul_packed(
        x, w, *lyr, ids, s, bits), 200)
    t_qp = _time_ms(lambda: kref.multi_lora_matmul_q_ref(
        x, w, *lyr, ids_t, s, bits), 20)
    t_f = _time_ms(lambda: kops.multi_lora_matmul(
        x, w, a_stack, b_stack, ids, s), 200)
    t_fp = _time_ms(lambda: kref.multi_lora_matmul_ref(
        x, w, a_stack, b_stack, ids_t, s), 20)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_mm = _time_ms(lambda: torch.matmul(x, w), 200)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # what the function must move: x, W and the output once, ids, and
    # each DISTINCT gathered slot's adapter once (words and sidecars, or
    # fp stacks); fp32 operations: the base product, h, y, and for B4
    # the dequant (a subtract and a multiply per level used)
    distinct = len(set(ids))
    kw, rw = lyr.aq.shape[2], lyr.bq.shape[2]
    common = 4 * (m * k + k * n + m * n + m)
    q_bytes = common + distinct * 4 * (r * kw + 2 * r + n * rw + 2 * n)
    f_bytes = common + distinct * 4 * (k * r + r * n)
    base = 2 * m * k * n + 2 * m * r * k + 2 * m * n * r + 2 * m * n
    q_bound = _bound_ms(q_bytes, base + 2 * m * r * k + 2 * m * n * r)
    f_bound = _bound_ms(f_bytes, base)
    mm_bound = _bound_ms(4 * (m * k + k * n + m * n), 2 * m * k * n)
    for name, t, tp, bound, nbytes in (
            ("multi_lora_matmul_packed", t_q, t_qp, q_bound, q_bytes),
            ("multi_lora_matmul", t_f, t_fp, f_bound, f_bytes)):
        print(f"{name} m={m} K={k} N={n} R={r} E={sv['n_slots']} "
              f"({distinct} distinct slots): kernel {t[0] * 1e3:.2f} us on "
              f"the device ({t[1] * 1e3:.2f} us a call from Python), plain "
              f"{tp[0] * 1e3:.2f} us ({tp[1] * 1e3:.2f} us a call), bound "
              f"{bound[0] * 1e3:.2f} us by {bound[1]} ({nbytes} B)")
    print(f"torch.matmul(x, W) alone, TF32 off, ({m}, {k}) x ({k}, {n}): "
          f"{t_mm[0] * 1e3:.2f} us on the device (bound "
          f"{mm_bound[0] * 1e3:.2f} us by {mm_bound[1]})")
    return {"multi_lora_matmul_packed": (t_q, t_qp, q_bound),
            "multi_lora_matmul": (t_f, t_fp, f_bound), "matmul": t_mm}


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


def make_server(model, data, device):
    from repro_torch.core.flocora import FLoCoRAConfig
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.fl import ClientConfig, FLServer, ServerConfig
    from repro_torch.models import resnet
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    return FLServer(
        model, lambda f, t, b: resnet.loss_fn(f, t, cfg, b), data,
        ServerConfig(n_clients=20, clients_per_round=5),
        ClientConfig(local_epochs=1, batch_size=32, lr=0.01),
        FLoCoRAConfig(rank=32, alpha=512.0, quant_bits=8), device=device)


def compare_with_cpu(rec_gpu: dict, tree_gpu, model_cpu, data) -> None:
    """Replay round 1 on the CPU (the kernels' plain versions, CPU convs)
    and hold the card's round to it: same cohort and bytes, loss within
    rtol 1e-3, 1-D leaves within 1e-4 + 1e-3 of their magnitude, and each
    quantized leaf within 4 int8 steps of its range. A round's ~10 SGD
    steps amplify summation-order differences in the adapters: on the CPU
    alone, 1 thread against 8 moves the ``a`` factors by up to 0.6 of a
    step."""
    import numpy as np
    from repro_torch.utils.tree import flatten_with_names
    t0 = time.perf_counter()
    srv = make_server(model_cpu, data, "cpu")
    rec = srv.run_round()
    for key in ("down_bytes", "up_bytes", "up_bytes_measured", "n_agg",
                "tcc_bytes"):
        if rec[key] != rec_gpu[key]:
            raise AssertionError(f"cpu replay {key}: {rec[key]} != "
                                 f"{rec_gpu[key]}")
    if not math.isclose(rec["client_loss"], rec_gpu["client_loss"],
                        rel_tol=1e-3):
        raise AssertionError(f"cpu replay loss {rec['client_loss']} != "
                             f"{rec_gpu['client_loss']}")
    worst = 0.0
    for (name, a), (_, b) in zip(flatten_with_names(srv.global_train),
                                 flatten_with_names(tree_gpu)):
        a, b = a.numpy(), b.cpu().numpy()
        if a.ndim >= 2:
            tol = 4 * (max(a.max(), 0.0) - min(a.min(), 0.0)) / 255.0
        else:
            tol = 1e-4 + 1e-3 * np.abs(a).max()
        d = float(np.abs(a - b).max())
        worst = max(worst, d)
        if d > tol:
            raise AssertionError(f"cpu replay {name}: max diff {d} > {tol}")
    print(f"cpu replay of round 1: loss {rec['client_loss']:.6f} vs card "
          f"{rec_gpu['client_loss']:.6f}, bytes identical, max adapter "
          f"diff {worst:.3g} ({time.perf_counter() - t0:.1f} s)")


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
        ptxas = [ln for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built {name} in {info['seconds']:.1f} s: " + " | ".join(
            ln.strip() for ln in ptxas))
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({len(built)} sources compiled)")

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

    # 3. the FL round on the card ----------------------------------------
    data = quickstart_data()
    server = make_server(resnet.init(0, cfg, device="cuda"), data, "cuda")
    static = messages.message_wire_bytes(server.global_train,
                                         QuantConfig(bits=8))
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
    print(f"round wall times (s): {[round(s, 4) for s in round_s]}")
    t_serve = time_serving_kernels(sv, dev)

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
             sv["launches"]["multi_lora_matmul"])):
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n_launch,
                     "max_abs_err": err, "ms": t[0], "plain_ms": tp[0],
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": None})
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
