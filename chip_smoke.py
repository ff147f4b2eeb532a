"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--profile]

Phases, each of which raises on failure (the script then exits nonzero):
  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once;
  2. hold each kernel against its plain PyTorch version on the card:
     ``quant_pack_rows`` bit-exact (words, scale and zp bits) at bits
     {2, 4, 8} on the main-path (1610, 2560) buffer, at bits {4, 8} on
     Table IV's ResNet-18 r=64 buffer (6026, 4608 / 5120), and ragged
     cases; ``dequant_agg_rows`` within rtol=atol=1e-5 at K in {1, 5,
     64} on (K, 1610, 640) and at K = 4 on ResNet-18's (4, 6026, 1152 /
     640), and bit-identical across block_k;
     ``multi_lora_matmul_packed`` at bits {2, 4, 8} and
     ``multi_lora_matmul`` within rtol=atol=1e-4 at m in {1, 8, 32, 64},
     d in {256, 2560}, R in {4, 8}, E=512, plus K=2559, N=2555, R=6,
     and R in {136, 160} at d = 2560 (E = 64), each call repeated and
     bit-identical; their SASS holds tensor-core MMA instructions
     (``cuobjdump -sass``, where the toolkit has it); ``dequant_agg``
     (the per-leaf fold, one leaf a call) BIT-identical at bits {2, 4,
     8}, K in {1, 5, 64} on the 18 per-leaf shapes of ResNet-8 r=32 and a
     C = 37 leaf, with a scalar and a vector n_valid; its grouped form
     ``dequant_agg_leaves`` BIT-identical over all 18 leaves in ONE call
     at bits {2, 4, 8} and K in {1, 5, 20, 64} (the table in the kernel's
     parameters up to K = 11, uploaded at K = 20 and 64), on strided
     ``as_tree`` row slices of random flat buffers; ``lora_matmul``
     within 8e-3 * max|y| at ``LORA_SHAPES`` (tests/test_kernels.py's
     four shapes, kernel_bench's (256, 512, 512, r=32), a ragged (100,
     300, 200, r=6), the full width (512, 2560, 2560, r=32), M = 130,
     r = 128 at full width, K = 2600, r = 160 at full width and
     (256, 512, 256, r=256)), each call repeated bit-identical
     and on the path ``ops.lora_plan`` names (wgmma at full width, the
     masked WMMA tile for the ragged shape and ranks past 128); its SASS
     holds HGMMA and UTMALDG in every TMA-path instance;
     ``quant_pack_rows`` also on rows of every length in
     ``QUANT_ROW_LEVELS``;
  3. drive the FL round: the synchronous FLoCoRA round of
     ``examples/quickstart.py`` ``run_uniform`` (ResNet-8, r=32, alpha=512,
     int8 flat wire, 20 clients with LDA 0.5 over 2000 synthetic images,
     K=5, batch 32, lr 0.01, 1 local epoch) through ``FLServer`` on the
     card, with the kernels' launch counts read around it, then replay
     round 1 on the CPU (plain versions) and compare. Then the same
     setting's other options, each with the counts set to 0 around it:
     the per-leaf wire (``flat_wire=False``, 2 rounds: the flat run's
     bytes, ONE grouped ``dequant_agg`` launch and no
     ``dequant_agg_rows`` a round, the flat run's round-1 uplinks
     aggregated both ways within 1e-6 * max|x|); error feedback (int4, oversample 1.4: 7 dispatched,
     5 kept, 2 rounds, round 1 replayed on the CPU); resume (1 round
     checkpointed, a fresh server resumes and runs round 2 beside an
     uninterrupted run, both with cuDNN's deterministic algorithms);
     ``lora_matmul``'s entry point, which no
     round calls, as a 2-layer bf16 chain at gemma3-4b's width; the
     vmapped cohort engine against ``make_local_trainer`` client by
     client (two servers, 3 rounds each, round 1's trained trees and
     every round's global trees held to each other); FedProx (mu =
     0.01, 2 rounds, round 1 replayed on the CPU) and the staggered
     engine (4 clients from 4 start trees, each held to
     ``make_local_trainer`` from its own start); then the quickstart's
     other synchronous modes, each 2 rounds with round 1 replayed on the
     CPU: ``run_sparse`` (int4, EF, top-k density 0.1: every uplink
     55,419 B and every downlink 150,744 B, every uplink's sparse pack
     bit-exact against the plain version, the scatter-add aggregate
     bit-identical over two calls), ``run_hetero`` (10 clients in rank
     tiers {4, 8, 16}, server r=16, K=6: tier bytes 57,400 / 88,888 /
     151,864 B, one B2 launch a rank bucket and B2 held to its plain
     version at each bucket's layout, then a round on the SVD
     recombination with its served ranks and adapter products held to
     the CPU's recombination of the same uplinks) and
     ``run_uniform(dp_noise=0.3)`` (uplinks 277,816 B, dp_epsilon
     21.559841619903807 / 33.736868528818945 after rounds 1 / 2, every
     privatized delta held to the CPU's with the same noise); then the
     event-driven FedBuff engine and the fleet, each with the counts set
     to 0 around it: ``run_async`` (12 clients in tiers {4, 8, 16},
     server r=16, 90 arrivals in 15 flushes of 6, the run_async trace:
     tier bytes measured, TCC, every B1 pack bit-exact against the plain
     version and counted from the engine's state, one B2 launch a rank
     bucket a flush, flush 1 replayed by a CPU engine with its event
     fields exactly equal), the million-client fleet
     (``round_throughput.py`` run_fleet's operating point at ResNet-8's
     width: a lazy ``Population`` of the default tiers, vision shards
     behind a 256-client LRU, streaming FedBuff with buffers of 10, 200
     arrivals: churn and wasted bytes recomputed from the trace, one K=1
     B2 launch an arrival, each streamed mean against the batched flush
     of its arrivals, kill/resume from the oldest checkpoint bit-identical
     under cuDNN's deterministic algorithms, the K=1 fold timed at the
     r=16 layout) and deadline cohorts in ``FLServer`` (the quickstart
     fleet with the run_async trace at oversample 1.5, 2 rounds, round 1
     replayed on the CPU with the same stragglers and wasted bytes, then
     a mixed-rank round on ``FedBuffAggregator(rank_staleness=True)``
     replayed on the CPU); then the paper's Table
     IV training row (``benchmarks/table4_comparison.py --train`` (64,
     8) through ``fl_experiment``'s settings: ResNet-18, r=64,
     alpha=1024, int8, 20 clients with LDA 1.0 over 2000 synthetic
     images, K=4, eval every 2 rounds on 1000 held-out images), 4 of
     its 12 rounds: every uplink 2,379,064 B, test_acc in rounds 2 and
     4, one B1 launch a message and one B2 launch a round, round 1
     replayed on the CPU;
  4. drive the serving path: ``benchmarks/round_throughput.py`` run_serve's
     1024-client int4 store (ranks 4 and 8, 2 layers, seed 0) at
     d = 2560 (gemma3-4b's hidden width), an m = 64 step on the fused and
     dequant engines (E = 512 slots) checked against the dense-merge
     oracle with their launch counts, steady step times, and the
     continuous-batching simulator on both paths plus the clock-policy
     churn run at capacity/16;
 4b. drive the dense decoder LM, which launches none of the six kernels:
     gemma3-4b's published config (34 layers, d_model 2560, vocab
     262,144, window 1,024) with random weights from seed 0, through
     ``LM.init`` and ``serve.generate`` at batch 2 (a 1,536-token prompt
     and 32 new tokens, twice; a 16-token prompt and 16), its decode
     logits held to the teacher-forced forward within ``LM_CONSIST_REL``
     of max|logit|, one adapter backward at 1 x 2,048 tokens (cold and
     warm: finite loss, every adapter's gradient finite and nonzero, none
     on the frozen tree), with the prefill and decode times against
     their bounds and the peak memory; its width at depth 6 from one
     tree on the card and the CPU (logits within ``LM_CARD_CPU_REL`` of
     max|logit|, greedy tokens); ``examples/train_lm_federated.py
     --full``'s loop (lm-110m, int8, 2 rounds x 8 clients x 8 steps: the
     packed message's bytes equal to the static count, each round's mean
     client loss finite, client 0's first step replayed on the CPU); and
     ``strict_compiles`` on a serving engine and a streaming fold (0
     program builds). It prints ``obs.run_meta()`` and frees the model
     before phase 4c;
 4c. drive the MLA and MoE archs, which launch none of the six kernels
     either (the reference computes MLA and MoE with einsums outside any
     Pallas kernel): deepseek-v2-236b (MLA, 160 experts top-6 + 2
     shared) cut to 4 layers and llama4-maverick-400b-a17b (128 experts
     top-1 + 1 shared, MoE every other layer) cut to 2, at their
     published widths with random weights from seed 0, each through
     ``LM.init`` and ``serve.generate`` at batch 2 (a 1,024-token prompt
     and 16 new tokens, twice, equal), a prefill/decode replay whose
     routes give the prefill's dropped (token, slot) pairs, the replay
     at the no-drop capacity (factor E/k) on the teacher-forced
     forward's routes within ``LM_CONSIST_REL`` of max|logit| (its own
     routes parting only at near ties, ``ROUTE_TIE``), one prefill and
     one decode step profiled, one adapter backward at 1 x 1,024
     (finite loss, every adapter's and router's gradient finite and
     nonzero, none on the frozen tree), with the times against their
     bounds and the peak memory; then deepseek-v2's width at depth 1
     from one tree on the card and the CPU: one MoE layer's routes
     (equal) and output, ``mla_apply`` and ``mla_decode``, and the
     logits over 1 x 64 tokens (the CPU on the card's routes), each
     within ``LM_CARD_CPU_REL`` of its max. It frees the models before
     phase 5;
  5. time each kernel with CUDA events at its path's shapes beside its
     plain version and its bound (B1 and B2, and the ``flat_rows``
     staging before B1, at ResNet-8's and ResNet-18's layouts;
     ``dequant_agg``: the per-leaf round's
     one grouped launch over the flat run's round-1 uplinks as the path
     calls it, beside the 18-call form the path made before (a stack of
     the K payloads and one launch a leaf, with and without the stacks),
     the whole per-leaf ``fedavg_packed`` by CUDA events and by host wall
     time, the bounds with the padded and the compact output, and the
     round at K = 20, whose table is uploaded;
     ``lora_matmul`` at
     (512, 2560, 2560, r=32), warm and cold (rotating through 4 distinct
     operand sets), beside ``torch.matmul(x, W)`` in bf16 and the library
     composition ``torch.addmm(x@W, x@a, b, alpha=s)`` timed the same
     ways, with its device time by kernel, and warm at the other ranks
     of ``LORA_TIMED_RANKS`` (160 and 256 on the masked path); the
     serving kernels at m in {8, 32, 64}, warm and cold (rotating through
     4 distinct (x, W) sets, more than the L2 holds), beside
     ``torch.matmul(x, W)`` in fp32 and ``torch.sum(W)`` timed the same
     ways, and warm at R = 160, m = 64).
The line before the last is one JSON object with the kernels' numbers;
the last is ``{"ok": true, "device": {...}}``. ``--profile`` adds one
quickstart round (the vmapped cohort engine, and the per-client one),
one round of each of the sparse, mixed-rank and DP modes, and the LM's
prefill, decode step, adapter backward and an lm-110m local step under
``torch.profiler`` and prints each one's launch count, busy share and
device time by kernel.

Imports nothing of JAX. Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
# benchmarks/kernel_bench.py's, a ragged one, the full width, an M that
# is not a multiple of the 128-row tile, r = 128 at full width, an
# aligned K that is not a multiple of the 64-deep stage, and ranks past
# 128 (the masked path) at full width and at a small width
LORA_SHAPES = [(128, 256, 192, 8), (64, 128, 128, 32), (256, 512, 256, 128),
               (8, 128, 128, 4), (256, 512, 512, 32), (100, 300, 200, 6),
               (512, 2560, 2560, 32), (130, 2560, 2560, 32),
               (512, 2560, 2560, 128), (256, 2600, 512, 32),
               (512, 2560, 2560, 160), (256, 512, 256, 256)]
# B6 timed cold rotates through this many distinct operand sets (4 x
# 15.7 MB exceeds the 50 MB L2)
LORA_COLD_SETS = 4
# B6's other timed ranks at the full width (warm); 160 and 256 take the
# masked path
LORA_TIMED_RANKS = (8, 16, 64, 128, 160, 256)
# B1's checked row lengths: the main path's (ResNet-8 r=32 flat layout:
# 32, 576, 1152, 27, 64, 2304, 128, 256 levels), and 0, 1, 31, 33, 2560
QUANT_ROW_LEVELS = (32, 576, 1152, 27, 64, 2304, 128, 256, 0, 1, 31, 33,
                    2560)
LEAF_TOL = 1e-6
# rounds of each engine in the vmapped-vs-per-client phase
ENGINE_ROUNDS = 3
# the paper's Table IV training row (ResNet-18, r=64, alpha=16r, int8):
# benchmarks/table4_comparison.py --train through
# benchmarks/common.py fl_experiment, cut from 12 rounds to 4; its
# uplink (paper: 2.4 MB) as the JAX package's message_wire_bytes counts
# it
TABLE4 = dict(rank=64, alpha=1024.0, rounds=4, up_bytes=2_379_064)
# the quickstart's other synchronous modes (examples/quickstart.py
# run_sparse, run_hetero, run_uniform(dp_noise=0.3)) and the bytes and
# epsilons the JAX package gives them
SPARSE = dict(density=0.1, up_bytes=55_419, down_bytes=150_744)
HETERO = dict(tiers=(4, 8, 16), n_clients=10, k=6, rank=16, alpha=256.0,
              tier_bytes={4: 57_400, 8: 88_888, 16: 151_864})
DP = dict(clip_norm=1.0, noise_multiplier=0.3, up_bytes=277_816,
          epsilon=(21.559841619903807, 33.736868528818945))
# examples/quickstart.py run_async (server r = 16, tiers as HETERO's) and
# benchmarks/round_throughput.py run_fleet's operating point
ASYNC = dict(n_clients=12, acfg=dict(
    total_arrivals=90, concurrency=6, buffer_size=6, half_life=4.0,
    microbatch_window=60.0, seed=0))
FLEET = dict(n_clients=1_000_000, shard_size=64, cache=256, acfg=dict(
    total_arrivals=200, concurrency=64, buffer_size=10, streaming_agg=True,
    microbatch_window=1200.0, seed=0, checkpoint_every=5))
B2_TOL = 1e-5
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
# the serving kernels past rank 128: checked and timed (warm, m = 64) at
# d = 2560 with this rank and this many slots
SERVE_HIGH_RANK = 160
SERVE_HIGH_RANK_SLOTS = 64
# ... and checked at this rank too: four whole 32-rank chunks, then a
# partial one
SERVE_PARTIAL_CHUNK_RANK = 136
# the dense decoder LM: gemma3-4b's published config (34 layers, d_model
# 2560, vocab 262,144; src/repro/configs/gemma3_4b.py full()), random
# weights from seed 0. A 1,536-token prompt is past the 1,024 window (a
# shorter prompt with max_seq past the window cannot build the ring cache
# in either package); 32 new tokens wrap the decode slots past it.
LM_FULL = dict(arch="gemma3-4b", batch=2, prompt=1536, gen=32,
               short_prompt=16, short_gen=16, train_seq=2048, seed=0)
# its frozen values (embedding, head, 34 layers' linears), all bf16
LM_FULL_FROZEN = 4_907_335_680
# decode logits against the teacher-forced forward over the same tokens,
# as a share of max|logit|: bf16 residual stream and bf16 linears in
# both, fp32 attention products, different attention cores (the blocked
# band / chunked softmax against the one-row decode softmax over the
# cache); each bf16 rounding flip is 2^-8 of its value and they add up
# over 34 layers. tests/test_consistency.py holds 5e-2 absolute on
# logits of max ~4 (1.3e-2 relative) at 2-7 layers.
LM_CONSIST_REL = 5e-2
# gemma3-4b's width at depth 6 (one 5 local : 1 global group), card
# against the CPU from one tree: prompt 16, 8 new tokens. Both run the
# same torch code in bf16 with fp32 accumulation; cuBLAS and the CPU's
# GEMMs sum in other orders, so bf16 results part by an ulp here and
# there (2^-8 of a value), which 6 layers carry into the logits.
LM_DEPTH6 = dict(n_layers=6, prompt=16, gen=8)
LM_CARD_CPU_REL = 2e-2
# examples/train_lm_federated.py --full (lm-110m: 12 L x 768, vocab
# 32,768, r = 16, alpha = 256, int8): 2 rounds x 8 clients x 8 local
# steps of batch 8 x 128 tokens
LM_FED = dict(rounds=2, clients=8, local_steps=8, batch=8, seq=128)
# client 0's first local step on the card against its CPU replay: the
# loss relative, the adapter update (trained - broadcast) in relative L2
# a leaf (tests/test_torch_lm.py's bf16 tolerances for the loss and
# the gradients)
LM_FED_LOSS_REL = 2e-3
LM_FED_UPDATE_L2 = 6e-2
# the MLA and MoE archs at their published widths (src/repro/configs/
# deepseek_v2_236b.py and llama4_maverick_400b.py full()), random weights
# from seed 0, depth cut to fit one 80 GB card: deepseek-v2 to 4 of its
# 60 MLA + MoE layers (160 experts top-6 + 2 shared), llama4-maverick to
# 2 of its 48 (one dense layer, one MoE layer of 128 experts top-1 + 1
# shared). generate at batch 2, a 1,024-token prompt and 16 new tokens;
# one adapter backward at 1 x 1,024 tokens.
LM_MOE = dict(batch=2, prompt=1024, gen=16, train_seq=1024, seed=0,
              depth={"deepseek-v2-236b": 4, "llama4-maverick-400b-a17b": 2})
# their frozen values at those depths (embedding, head, layers), all bf16
LM_MOE_FROZEN = {"deepseek-v2-236b": 16_933_715_968,
                 "llama4-maverick-400b-a17b": 18_573_557_760}
# a route may part from the one it is held to (the teacher-forced
# forward's, the CPU's) only at a near tie: the expert it took and the
# one it is held to within this share of each other's probability (the
# bf16 drift between the two runs' router inputs moves them by as much)
ROUTE_TIE = LM_CONSIST_REL
# deepseek-v2's width at depth 1, card against CPU from one tree: one
# MoE layer's moe_apply and one MLA layer's mla_apply / mla_decode on
# the same bf16 input, and the whole model's logits, over 1 x 64 tokens
LM_MOE_CPU = dict(arch="deepseek-v2-236b", n_layers=1, tokens=64)


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
    exceeds the device's. The garbage collector is off while the loops
    run: a full collection would stall the host past the sleep."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    collecting = gc.isenabled()
    gc.disable()
    try:
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
                raise RuntimeError(f"host queued {iters} calls in "
                                   f"{host:.3f} s, longer than the sleep: "
                                   "fewer iterations")
            out.append(t0.elapsed_time(t1) / iters)
    finally:
        if collecting:
            gc.enable()
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
    """{kernel function: (HMMA, HGMMA, UTMALDG) instruction counts} in
    the SASS of ``source``'s built library, read with ``cuobjdump -sass``;
    {} when the toolkit has no cuobjdump."""
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
            counts[fn] = [0, 0, 0]
        elif fn is not None:
            counts[fn][0] += bool(re.search(r"\bHMMA\b", line))
            counts[fn][1] += bool(re.search(r"\bHGMMA\b", line))
            counts[fn][2] += bool(re.search(r"\bUTMALDG\b", line))
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


def check_lora_sass() -> None:
    """Every instance of B6's TMA-path kernel (one a padded rank) holds
    wgmma (HGMMA) and TMA loads (UTMALDG); the masked path's h kernel and
    tile hold mma.sync (HMMA)."""
    counts = sass_mma_counts("lora_matmul")
    if not counts:
        print("sass lora_matmul: cuobjdump not found, not checked")
        return
    for f, c in sorted(counts.items()):
        print(f"sass lora_matmul {f}: HMMA {c[0]}, HGMMA {c[1]}, "
              f"UTMALDG {c[2]}")
    wg = [c for f, c in counts.items() if "lora_wgmma_kernel" in f]
    rest = [c for f, c in counts.items()
            if "lora_h_kernel" in f or "lora_tile_kernel" in f]
    if not wg or min(min(c[1], c[2]) for c in wg) == 0:
        raise AssertionError("an instance of lora_wgmma_kernel lacks HGMMA "
                             "or UTMALDG in its SASS")
    if len(rest) < 2 or min(c[0] for c in rest) == 0:
        raise AssertionError("lora_h_kernel or lora_tile_kernel lacks HMMA")


def _bound_ms(nbytes: float, flops: float,
              peak: float = FP32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _f32_bits(t):
    import torch
    return t.contiguous().view(torch.int32)


def pack_diff(got, want, bits: int) -> tuple[bool, float]:
    """Two packs (words, scale, zp), on any devices: whether they are
    bit-identical, and the max abs difference over the unpacked levels,
    scale and zp (0.0 when bit-exact)."""
    import torch
    from repro_torch.kernels import ref as kref
    got = [_f32_bits(t).cpu() for t in got]       # the bits, on the CPU
    want = [_f32_bits(t).cpu() for t in want]
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(float((kref.unpack_words(got[0], bits)
                     - kref.unpack_words(want[0], bits)).abs().max()),
              *(float((g.view(torch.float32) - w.view(torch.float32))
                      .abs().max()) for g, w in zip(got[1:], want[1:])))
    return same, err


def check_quant_pack(layouts, dev) -> float:
    """Kernel vs plain, bit for bit, on ``layouts`` ({label: (flat, nv,
    bits)}, the paths' buffers) and ragged cases. Returns the max abs
    difference over levels, scale and zp (0.0 when bit-exact)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    cases = [(label, flat, nv, bits)
             for label, (flat, nv, bits) in layouts.items()]
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
        # every checked row length, three rows each, in a buffer as wide
        # as the flat layout makes one for 2560 levels
        lane = kops.lane_levels(bits)
        n = -(-max(QUANT_ROW_LEVELS) // lane) * lane
        nv = np.repeat(np.array(QUANT_ROW_LEVELS), 3)
        x = rng.normal(size=(nv.size, n)) * rng.uniform(
            1e-3, 10.0, size=(nv.size, 1))
        x[np.arange(n)[None, :] >= nv[:, None]] = 7.0   # never read
        x[1::3] = np.abs(x[1::3])
        cases.append((f"row lengths bits={bits}",
                      torch.tensor(x, dtype=torch.float32, device=dev),
                      torch.tensor(nv, dtype=torch.int32, device=dev), bits))
    worst = 0.0
    for name, x, nv, bits in cases:
        got = kops.quant_pack_rows(x, nv, bits)
        want = kref.quant_pack_rows_ref(x, nv, bits)
        torch.cuda.synchronize()
        same, err = pack_diff(got, want, bits)
        print(f"check quant_pack_rows {name} {tuple(x.shape)}: "
              f"bit-exact={same} max_abs_err={err}")
        if not same:
            raise AssertionError(f"quant_pack_rows {name} differs from its "
                                 "plain version")
        worst = max(worst, err)
    return worst


def check_dequant_agg(nv, nw: int, dev, bits: int = 8, ks=(1, 5, 64),
                      label: str = "resnet8") -> float:
    """Kernel vs plain within rtol=atol=1e-5 at each K of ``ks``, and the
    kernel bit-identical to itself across block_k. Returns the max abs
    difference."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(11)
    c = nv.shape[0]
    worst = 0.0
    for k in ks:
        words = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(k, c, nw), dtype=np.uint32)).to(dev)
        scale = torch.from_numpy(rng.uniform(
            1e-4, 1e-2, size=(k, c)).astype(np.float32)).to(dev)
        scale[:, -3:] = 0.0                      # phantom rows
        zp = torch.from_numpy(rng.integers(
            0, 1 << bits, size=(k, c)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.uniform(1, 100, size=k).astype(
            np.float32)).to(dev)
        w = w / w.sum()
        got = kops.dequant_agg_rows(words, scale, zp, w, nv, bits)
        want = kref.dequant_agg_rows_ref(words, scale, zp, w, nv, bits)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        close = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
        same = True
        for bk in sorted({1, 2, 4, k}):
            again = kops.dequant_agg_rows(words, scale, zp, w, nv, bits,
                                          block_k=bk)
            same &= torch.equal(_f32_bits(again), _f32_bits(got))
        same &= torch.equal(_f32_bits(kops.dequant_agg_rows(
            words, scale, zp, w, nv, bits, whole_k=True)), _f32_bits(got))
        torch.cuda.synchronize()
        print(f"check dequant_agg_rows {label} bits={bits} K={k} "
              f"{tuple(words.shape)}: "
              f"max_abs_err={err} within_1e-5={close} "
              f"block_k_bit_identical={same}")
        if not (close and same):
            raise AssertionError(f"dequant_agg_rows {label} bits={bits} "
                                 f"K={k} failed its check")
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


def random_leaf_cohort(tree, bits: int, k: int, rng, dev) -> tuple:
    """K clients' random flat buffers in the per-leaf layout of ``tree``
    (``FlatPackedMessage.as_tree``: each leaf's rows a strided slice, the
    words past its valid levels random too, so a read of them shows),
    the last client's every fifth row at scale = 0 with a nonzero zp.
    Returns (the packed leaves' (clients, n) as ``dequant_agg_leaves``
    takes them, weights with a -0.0)."""
    import numpy as np
    import torch
    from repro_torch.core import flat as flatcodec
    from repro_torch.utils.tree import tree_flatten, tree_leaves
    lo = flatcodec.layout_for(tree, bits)
    fp = tuple(x for x, sp in zip(tree_leaves(tree), lo.leaves)
               if not sp.quantized)
    words = rng.integers(0, 1 << 32, size=(k, lo.c_total, lo.nw_max),
                         dtype=np.uint32)
    scale = rng.uniform(1e-4, 1e-2, size=(k, lo.c_total)).astype(np.float32)
    zp = rng.integers(0, 1 << bits, size=(k, lo.c_total)).astype(np.float32)
    scale[-1, ::5] = 0.0
    zp[-1, ::5] = 3.0
    trees = [tree_flatten(flatcodec.FlatPackedMessage(
        torch.from_numpy(words[i]).to(dev), torch.from_numpy(scale[i]).to(dev),
        torch.from_numpy(zp[i]).to(dev), fp, lo).as_tree())[0]
        for i in range(k)]
    leaves = [([(m.payload, m.scale, m.zp) for m in col],
               col[0].n_per_channel)
              for col in zip(*trees) if hasattr(col[0], "payload")]
    w = torch.from_numpy(rng.uniform(0.05, 1.0, size=k).astype(
        np.float32)).to(dev)
    w[0] = -0.0
    return leaves, w


def check_leaf_agg_grouped(tree, dev) -> float:
    """The grouped ``dequant_agg_leaves`` (B3 as the per-leaf round calls
    it): all of the main path's 18 packed leaves in ONE launch, bit for
    bit against its plain version, at bits {2, 4, 8} and K in {1, 5, 20,
    64} on strided ``as_tree`` slices of random flat buffers: tables of
    235 and 523 int64 words ride in the kernel's parameters, K = 20's
    1,603 and K = 64's 4,771 are uploaded. Returns the max abs difference
    (0.0 when bit-identical)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    rng = np.random.default_rng(19)
    worst = 0.0
    for bits in (2, 4, 8):
        for k in (1, 5, 20, 64):
            leaves, w = random_leaf_cohort(tree, bits, k, rng, dev)
            before = kops.dequant_agg.launches
            got = kops.dequant_agg_leaves(leaves, w, bits)
            launched = kops.dequant_agg.launches - before
            want = kref.dequant_agg_leaves_ref(leaves, w, bits)
            torch.cuda.synchronize()
            strided = sum(cl[0][0].stride(0) != cl[0][0].shape[1]
                          for cl, _ in leaves)
            for (cl, n), g, v in zip(leaves, got, want):
                if not torch.equal(_f32_bits(g), _f32_bits(v)):
                    raise AssertionError(
                        f"dequant_agg_leaves bits={bits} K={k} leaf "
                        f"(C, n)=({cl[0][1].shape[0]}, {n}) differs from "
                        "its plain version: max_abs_err "
                        f"{float((g - v).abs().max())}")
                worst = max(worst, float((g - v).abs().max()))
            if launched != 1:
                raise AssertionError(f"dequant_agg_leaves made {launched} "
                                     "launches, expected 1")
            print(f"check dequant_agg_leaves bits={bits} K={k}: "
                  f"{len(leaves)} leaves ({strided} strided views) in 1 "
                  "launch, bit-identical")
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
    8e-3 * max|y| at ``LORA_SHAPES``, a second call bit-identical to the
    first, and each call on the path ``ops.lora_plan`` names (counted by
    the wrapper): the wgmma path wherever TMA can read the operands,
    the full width included, the masked path for the ragged shape.
    Returns the max abs difference."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    worst = 0.0
    for i, (m, k, n, r) in enumerate(LORA_SHAPES):
        x, w, a, b = _bf16_inputs(m, k, n, r, 100 + i, dev)
        before = dict(kops.lora_matmul.paths)
        got = kops.lora_matmul(x, w, a, b, 2.0)
        again = kops.lora_matmul(x, w, a, b, 2.0)
        want = kref.lora_matmul_ref(x, w, a, b, 2.0).to(torch.float32)
        torch.cuda.synchronize()
        took = [p for p, c in kops.lora_matmul.paths.items()
                if c != before[p]]
        plan = kops.lora_plan(m, k, n, r)
        same = torch.equal(got.view(torch.int16), again.view(torch.int16))
        got = got.to(torch.float32)
        err, ymax = float((got - want).abs().max()), float(want.abs().max())
        how = "h in the mainloop" if plan.path == "wgmma" else \
            f"h in {plan.h_splits} K splits"
        print(f"check lora_matmul (M, K, N, r)={(m, k, n, r)}: path {took} "
              f"(tile {plan.tile}, {plan.blocks} blocks, {how}), "
              f"max_abs_err {err:.4g}, max|y| "
              f"{ymax:.4g}, tol {LORA_TOL * ymax:.4g}, repeat "
              f"bit-identical={same}")
        if took != [plan.path] or kops.lora_matmul.paths[plan.path] \
                != before[plan.path] + 2:
            raise AssertionError(f"lora_matmul {(m, k, n, r)} took {took}, "
                                 f"planned {plan.path}")
        if not err <= LORA_TOL * ymax:
            raise AssertionError(f"lora_matmul {(m, k, n, r)} differs from "
                                 "its plain version")
        if not same:
            raise AssertionError(f"lora_matmul {(m, k, n, r)}: two calls on "
                                 "the same inputs differ")
        worst = max(worst, err)
    if kops.lora_plan(LORA["m"], LORA["d"], LORA["d"], LORA["r"]).path \
            != "wgmma" or kops.lora_plan(100, 300, 200, 6).path != "masked":
        raise AssertionError("the full width must take the wgmma path and "
                             "(100, 300, 200, 6) the masked path")
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
    {2, 4, 8}, plus a ragged K = 2559, N = 2555 with R = 6 and R in
    {136, 160} at d = 2560 (E = 64: h walked in rank chunks, the last
    one partial at 136); a second call on the
    same inputs must give the same bits. Returns the max abs differences
    (B4, B5)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(5)
    shapes = [(d, d, r, 512) for d in (256, 2560) for r in (4, 8)]
    shapes += [(2559, 2555, 6, 512),
               (2560, 2560, SERVE_PARTIAL_CHUNK_RANK, SERVE_HIGH_RANK_SLOTS),
               (2560, 2560, SERVE_HIGH_RANK, SERVE_HIGH_RANK_SLOTS)]
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

    for k, n, r, e in shapes:
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
    time_serving_high_rank(sv, out, dev)
    t64 = out[64]
    return {name: (t64[name]["cold"], t64[name]["plain"], t64[name]["bound"])
            for name in ("multi_lora_matmul_packed", "multi_lora_matmul")}


def time_serving_high_rank(sv: dict, timed: dict, dev) -> None:
    """B4 and B5 warm at m = 64, d = 2560 past rank 128
    (``SERVE_HIGH_RANK`` over ``SERVE_HIGH_RANK_SLOTS`` random int4
    slots: h walked in rank chunks, one block an SM), beside the
    rank-8 bucket's warm times from ``time_serving_kernels``."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    rng = np.random.default_rng(23)
    x, w = sv["x"], sv["w"]
    k, n = w.shape
    r, e, bits = SERVE_HIGH_RANK, SERVE_HIGH_RANK_SLOTS, SERVE["bits"]
    slab = _serving_slabs(rng, e, k, n, r, bits, dev)
    a = torch.from_numpy((rng.standard_normal((e, k, r)) * 0.1).astype(
        np.float32)).to(dev)
    b = torch.from_numpy((rng.standard_normal((e, r, n)) * 0.1).astype(
        np.float32)).to(dev)
    ids = [int(i) for i in rng.integers(0, e, x.shape[0])]
    for name, f in (
            ("multi_lora_matmul_packed", lambda: kops.multi_lora_matmul_packed(
                x, w, *slab, ids, SERVE_SCALE, bits)),
            ("multi_lora_matmul", lambda: kops.multi_lora_matmul(
                x, w, a, b, ids, SERVE_SCALE))):
        t = _time_ms(f, 50)
        base = timed[64][name]["warm"][0]
        split = kernel_split(f, 10)
        print(f"{name} m={x.shape[0]} K={k} N={n} R={r} E={e} warm: "
              f"{t[0] * 1e3:.2f} us on the device ({t[1] * 1e3:.2f} us a "
              f"call from Python); R={sv['rank']} warm {base * 1e3:.2f} us "
              f"({t[0] / base:.2f}x); by kernel (torch.profiler, 10 calls): "
              + ", ".join(f"{nm[:48]} {us:.2f} us" for nm, us in split))


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


def make_server(model, data, device, fl=None, server=None, client=None,
                trace=None):
    """The quickstart round's FLServer; ``fl``/``server``/``client``
    override FLoCoRAConfig / ServerConfig / ClientConfig fields (the
    options' phases); ``trace`` orders deadline cohorts."""
    from repro_torch.core.flocora import FLoCoRAConfig
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.fl import ClientConfig, FLServer, ServerConfig
    from repro_torch.models import resnet
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    return FLServer(
        model, lambda f, t, b: resnet.loss_fn(f, t, cfg, b), data,
        ServerConfig(n_clients=20, clients_per_round=5, **(server or {})),
        ClientConfig(local_epochs=1, batch_size=32, lr=0.01,
                     **(client or {})),
        FLoCoRAConfig(rank=32, alpha=512.0, **{"quant_bits": 8, **(fl or {})}),
        trace=trace, device=device)


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


def compare_with_cpu(rec_gpu: dict, tree_gpu, srv, what: str,
                     keys: tuple = (), trees: bool = True) -> dict:
    """Replay round 1 on the CPU with ``srv`` (a fresh server of the same
    run on the CPU: the kernels' plain versions, CPU convs) and hold the
    card's round to it: the same cohort and bytes (and ``keys``), loss
    within rtol 1e-3, trees as ``hold_trees`` unless ``trees`` is False.
    Returns the CPU's record."""
    t0 = time.perf_counter()
    rec = srv.run_round()
    for key in BYTE_KEYS + tuple(keys):
        if rec[key] != rec_gpu[key]:
            raise AssertionError(f"cpu replay {key}: {rec[key]} != "
                                 f"{rec_gpu[key]}")
    if not math.isclose(rec["client_loss"], rec_gpu["client_loss"],
                        rel_tol=1e-3):
        raise AssertionError(f"cpu replay loss {rec['client_loss']} != "
                             f"{rec_gpu['client_loss']}")
    worst = hold_trees(srv.global_train, tree_gpu, srv.fcfg.quant_bits,
                       "cpu replay") if trees else float("nan")
    print(f"cpu replay of round 1 ({what}): loss "
          f"{rec['client_loss']:.6f} vs card {rec_gpu['client_loss']:.6f}, "
          f"bytes{' and ' + ', '.join(keys) if keys else ''} identical, "
          f"max adapter diff {worst:.3g} "
          f"({time.perf_counter() - t0:.1f} s)")
    return rec


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
        if c["dequant_agg"] != 1 or c["dequant_agg_rows"] != 0 \
                or c["quant_pack_rows"] < n_leaves * (k + 1):
            raise AssertionError(f"per-leaf round launch counts {c}")
    # the flat run's round-1 uplinks, both folds
    msgs, w = captured[0][0]
    (flat_out, c_flat) = _counted(lambda: aggregation.fedavg_packed(msgs, w))
    leaf_msgs = [m.as_tree() for m in msgs]
    (leaf_out, c_leaf) = _counted(
        lambda: aggregation.fedavg_packed(leaf_msgs, w))
    torch.cuda.synchronize()
    if c_flat["dequant_agg_rows"] != 1 or c_leaf["dequant_agg"] != 1:
        raise AssertionError(f"aggregate launch counts {c_flat} {c_leaf}")
    worst = 0.0
    for (name, a), (_, b) in zip(flatten_with_names(flat_out),
                                 flatten_with_names(leaf_out)):
        d, xmax = float((a - b).abs().max()), float(a.abs().max())
        worst = max(worst, d / max(xmax, 1e-30))
        if d > LEAF_TOL * xmax:
            raise AssertionError(f"per-leaf vs flat fold {name}: {d} > "
                                 f"{LEAF_TOL} * {xmax}")
    print(f"round-1 uplinks aggregated per leaf ({n_leaves} leaves in 1 "
          f"dequant_agg launch) vs flat (1 dequant_agg_rows): worst diff "
          f"{worst:.3g} of max|x| (tol {LEAF_TOL})")
    diff = hold_trees(flat_server.global_train, server.global_train, 8,
                      "per-leaf vs flat run")
    print(f"per-leaf run vs flat run after {ROUNDS} rounds: max diff "
          f"{diff:.3g}; round walls {[round(t, 4) for t in walls]} s")
    launches = {}
    for c in counts:
        _add_counts(launches, c)
    # the timing inputs: the round-1 uplinks as per-leaf messages (strided
    # as_tree views of the flat buffers), their weights on the card, and
    # each packed leaf's K clients as fedavg_packed hands them to
    # dequant_agg_leaves
    nw = torch.as_tensor(w, dtype=torch.float32).to(dev)
    per_msg = [[x for _, x in flatten_with_names(m) if hasattr(x, "payload")]
               for m in leaf_msgs]
    groups = [[(g.payload, g.scale, g.zp) for g in group]
              for group in zip(*per_msg)]
    ns = [group[0].n_per_channel for group in zip(*per_msg)]
    return {"launches": launches, "walls": walls, "msgs": leaf_msgs,
            "weights": nw, "leaves": list(zip(groups, ns)),
            "bits": per_msg[0][0].bits}


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
    compare_with_cpu(recs[0], tree1,
                     make_server(model_cpu, data, "cpu", fl, sv),
                     f"ef {fl} {sv}")
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


def _stack_trees(trees):
    import torch
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def per_client_trainer(loss_fn, ccfg):
    """The cohort trained client by client through ``make_local_trainer``
    (each over its own natural steps) and stacked as the vmapped engine
    returns it: the sequential baseline, the structure the port's round
    had before its engine was vmapped."""
    import torch
    from repro_torch.fl import make_local_trainer
    run = make_local_trainer(loss_fn, ccfg)

    def trainer(frozen, train0, batches, n_steps):
        outs = [run(frozen, train0,
                    {key: v[k, :n] for key, v in batches.items()})
                for k, n in enumerate(n_steps.tolist())]
        return (_stack_trees([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    return trainer


def engine_phase(data, dev) -> dict:
    """The vmapped cohort engine against the per-client baseline on the
    card: two quickstart servers from one init and seed, one training
    through ``make_cohort_trainer``, the other client by client through
    ``make_local_trainer``, ``ENGINE_ROUNDS`` rounds each. Round 1 starts
    both from the same broadcast and batches: each client's trained tree
    is held to its twin by ``hold_trees`` and its loss within rtol 1e-3;
    every round's bytes are equal and the global trees held the same
    way. Returns both engines' round walls."""
    import torch
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import resnet
    from repro_torch.utils.tree import tree_map
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    runs = {}
    for name in ("vmapped", "per-client"):
        srv = make_server(resnet.init(0, cfg, device=dev), data, dev)
        train = srv.trainer if name == "vmapped" \
            else per_client_trainer(srv.loss_fn, srv.ccfg)
        first = []

        def recording(*args, train=train, first=first):
            out = train(*args)
            if not first:
                first.append((tree_map(torch.clone, out[0]), out[1].clone()))
            return out

        srv.trainer = recording
        recs, _, _, walls = run_rounds(srv, ENGINE_ROUNDS, f"engine {name}")
        runs[name] = (recs, first[0], walls, srv)
    (v_recs, (v_tr, v_loss), v_walls, v_srv), \
        (p_recs, (p_tr, p_loss), p_walls, p_srv) = \
        runs["vmapped"], runs["per-client"]
    worst = 0.0
    for k in range(v_loss.shape[0]):
        worst = max(worst, hold_trees(
            tree_map(lambda x: x[k], p_tr), tree_map(lambda x: x[k], v_tr),
            8, f"engine round 1 client {k}"))
    if not torch.allclose(v_loss, p_loss, rtol=1e-3, atol=0.0):
        raise AssertionError(f"engine losses {v_loss} != {p_loss}")
    for a, b in zip(v_recs, p_recs):
        for key in BYTE_KEYS:
            if a[key] != b[key]:
                raise AssertionError(f"engine round {a['round']} {key}: "
                                     f"{a[key]} != {b[key]}")
    glob = hold_trees(p_srv.global_train, v_srv.global_train, 8,
                      "engine global trees")
    print(f"engine: round 1's {v_loss.shape[0]} clients, vmapped vs "
          f"make_local_trainer from the same broadcast and batches: max "
          f"tree diff {worst:.3g}, losses {v_loss.tolist()} vs "
          f"{p_loss.tolist()}; global trees after {ENGINE_ROUNDS} rounds "
          f"max diff {glob:.3g}; round walls (s) vmapped "
          f"{[round(t, 4) for t in v_walls]}, per-client "
          f"{[round(t, 4) for t in p_walls]}")
    return {"vmapped": v_walls, "per-client": p_walls,
            "per-client server": p_srv}


def fedprox_phase(data, model_cpu, dev) -> dict:
    """FedProx (mu = 0.01) on the card: 2 quickstart rounds with round 1
    replayed on the CPU; then the staggered engine trains 4 clients,
    each from its own start tree (the global adapters moved by
    0.01 * k * noise), with FedProx pulling each to its own start, and
    each client is held to ``make_local_trainer`` from that start."""
    import numpy as np
    import torch
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.fl import make_local_trainer, \
        make_staggered_cohort_trainer, stack_cohort_batches
    from repro_torch.models import resnet
    from repro_torch.utils.tree import tree_map
    client = {"fedprox_mu": 0.01}
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    server = make_server(resnet.init(0, cfg, device=dev), data, dev,
                         client=client)
    recs, counts, tree1, walls = run_rounds(server, ROUNDS, "fedprox")
    k = server.scfg.clients_per_round
    for c in counts:
        if c["quant_pack_rows"] < k + 1 or c["dequant_agg_rows"] != 1:
            raise AssertionError(f"fedprox round launch counts {c}")
    compare_with_cpu(recs[0], tree1,
                     make_server(model_cpu, data, "cpu", client=client),
                     f"fedprox {client}")
    ccfg = server.ccfg
    batches, n_steps = stack_cohort_batches(np.random.default_rng(1),
                                            data[:4], ccfg)
    bd = {key: torch.from_numpy(v).to(dev) for key, v in batches.items()}
    gen = torch.Generator().manual_seed(2)
    starts = [tree_map(lambda p, i=i: p + 0.01 * i * torch.randn(
        p.shape, generator=gen).to(dev), server.global_train)
        for i in range(4)]
    t0 = time.perf_counter()
    trained, losses = make_staggered_cohort_trainer(server.loss_fn, ccfg)(
        server.frozen, _stack_trees(starts), bd,
        torch.from_numpy(n_steps).to(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    local = make_local_trainer(server.loss_fn, ccfg)
    worst = 0.0
    for i, n in enumerate(n_steps.tolist()):
        t_i, l_i = local(server.frozen, starts[i],
                         {key: v[i, :n] for key, v in bd.items()})
        worst = max(worst, hold_trees(t_i, tree_map(lambda x: x[i],
                                                    trained),
                                      8, f"staggered client {i}"))
        if not math.isclose(float(l_i), float(losses[i]), rel_tol=1e-3):
            raise AssertionError(f"staggered client {i} loss "
                                 f"{float(losses[i])} != {float(l_i)}")
    print(f"staggered engine (FedProx mu=0.01, 4 clients from 4 start "
          f"trees, n_steps {n_steps.tolist()}): {wall:.3f} s, each client "
          f"vs make_local_trainer from its own start: max tree diff "
          f"{worst:.3g}; fedprox round walls {[round(t, 4) for t in walls]}"
          f" s")
    launches = {}
    for c in counts:
        _add_counts(launches, c)
    return {"launches": launches, "walls": walls}


@contextlib.contextmanager
def recorded(owner, name: str, keep=None):
    """``owner.name`` (a module's function or an object's method) wrapped
    for the duration: each call's (args, kwargs, result) is appended to
    the list yielded (only the calls ``keep(args, kwargs)`` accepts, when
    given)."""
    calls, real = [], getattr(owner, name)
    own = name in vars(owner)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        if keep is None or keep(args, kwargs):
            calls.append((args, kwargs, out))
        return out

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        if own:
            setattr(owner, name, real)
        else:
            delattr(owner, name)


def to_cpu_messages(msgs) -> list:
    """Wire messages moved to the CPU through their serialized form (a
    round trip of the exact bytes)."""
    from repro_torch.core import messages
    return [messages.message_from_wire(messages.message_to_wire(m), m,
                                       device="cpu") for m in msgs]


def sparse_phase(data, model_cpu, dev) -> dict:
    """``examples/quickstart.py`` run_sparse on the card: the quickstart's
    fleet at int4 with error feedback and top-k uplinks at density 0.1,
    2 rounds. Checks every uplink's measured and static bytes (55,419 B
    against 150,744 B dense int4) and every downlink's, the launches (one
    B1 pack a message, no B2 or B3: the sparse aggregate is a
    scatter-add), every uplink's sparse pack bit-exact against the plain
    version on the CPU (indices, words, scale, zp), the round-1 scatter-add
    aggregate bit-identical over two calls and within 1e-6 * max|x| of
    the CPU's, and round 1 against its CPU replay."""
    import torch
    from repro_torch.core import aggregation, messages
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.sparse import SparsityConfig, is_sparse_leaf
    from repro_torch.models import resnet
    from repro_torch.utils.tree import flatten_with_names, tree_to
    density = SPARSE["density"]
    fl = {"quant_bits": 4, "error_feedback": True,
          "sparsity": SparsityConfig(density=density)}
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    server = make_server(resnet.init(0, cfg, device=dev), data, dev, fl)
    static = messages.message_wire_bytes(server.global_train,
                                         QuantConfig(bits=4), density)
    with recorded(server.aggregator, "aggregate") as captured, \
            recorded(messages, "pack_message",
                     lambda a, kw: (kw.get("density") or 1.0) < 1.0) as packs:
        recs, counts, tree1, walls = run_rounds(server, ROUNDS, "sparse")
    k = server.scfg.clients_per_round
    for rec, c in zip(recs, counts):
        if (rec["up_bytes_measured"], static, rec["up_bytes"],
                rec["down_bytes"], rec["uplink_density"]) != (
                SPARSE["up_bytes"], SPARSE["up_bytes"],
                k * SPARSE["up_bytes"], k * SPARSE["down_bytes"], density):
            raise AssertionError(f"sparse round {rec['round']} bytes: {rec}"
                                 f" (static {static})")
        # one pack a message (the broadcast, K uplinks, round 1's
        # measured downlink); the aggregate is a scatter-add
        packs_want = k + 1 + (rec["round"] == 1)
        if c["quant_pack_rows"] != packs_want or c["dequant_agg_rows"] \
                or c["dequant_agg"]:
            raise AssertionError(f"sparse round {rec['round']} launch "
                                 f"counts {c}, want {packs_want} packs")
    # every uplink's pack against the plain version on the same input
    n_leaves, err_b1 = 0, 0.0
    for args, kw, got in packs:
        want = messages.pack_message(tree_to(args[0], "cpu"), args[1], **kw)
        for (name, g), (_, w) in zip(flatten_with_names(got),
                                     flatten_with_names(want)):
            if not is_sparse_leaf(w):
                continue
            n_leaves += 1
            same, err = pack_diff((g.payload, g.scale, g.zp),
                                  (w.payload, w.scale, w.zp), w.bits)
            err_b1 = max(err_b1, err)
            if not (same and torch.equal(g.idx.cpu(), w.idx)):
                raise AssertionError(f"sparse pack {name} differs from its "
                                     "plain version")
    if len(packs) != ROUNDS * k or n_leaves != 18 * len(packs):
        raise AssertionError(f"sparse packs checked: {len(packs)} messages,"
                             f" {n_leaves} leaves")
    # the scatter-add aggregate: repeatable, and the CPU's
    msgs, w = captured[0][0]
    first = aggregation.fedavg_packed(msgs, w)
    again = aggregation.fedavg_packed(msgs, w)
    cpu = aggregation.fedavg_packed(to_cpu_messages(msgs), w.cpu())
    worst = 0.0
    for (name, a), (_, b), (_, x) in zip(flatten_with_names(first),
                                         flatten_with_names(again),
                                         flatten_with_names(cpu)):
        if not torch.equal(_f32_bits(a), _f32_bits(b)):
            raise AssertionError(f"sparse aggregate {name} differs between "
                                 "two calls")
        d = float((a.cpu() - x).abs().max())
        worst = max(worst, d / max(float(x.abs().max()), 1e-30))
        if d > LEAF_TOL * float(x.abs().max()):
            raise AssertionError(f"sparse aggregate {name} vs the CPU: {d}")
    compare_with_cpu(recs[0], tree1, make_server(model_cpu, data, "cpu", fl),
                     f"sparse {SPARSE}", keys=("uplink_density",))
    launches = {}
    for c in counts:
        _add_counts(launches, c)
    print(f"sparse phase: uplink {static} B a message (dense int4 "
          f"{SPARSE['down_bytes']}), downlink {SPARSE['down_bytes']} B; "
          f"{len(packs)} uplinks' sparse packs ({n_leaves} leaves) "
          f"bit-exact vs plain; round-1 scatter-add aggregate bit-identical"
          f" over two calls, {worst:.3g} of max|x| from the CPU's; round-2 "
          f"wall {walls[-1]:.4f} s; launches {launches}")
    time_sparse(packs[0][0][0], msgs, w, dev)
    return {"launches": launches, "walls": walls, "err_b1": err_b1,
            "server": server}


def _host_ms(fn, iters: int) -> tuple[float, float]:
    """(host ms, wall ms) a call of ``fn`` run ``iters`` times back to
    back after a synchronize: the host's time to enqueue the calls, and
    the time until the card has finished them. For calls whose host cost
    exceeds their device time (``_time_ms``'s sleep would not cover
    them)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return host * 1e3 / iters, wall * 1e3 / iters


def time_sparse(tree, msgs, w, dev) -> None:
    """The sparse path's costs: one uplink's whole sparse pack (the
    top-k selection, the staging and its one B1 launch) and the round's
    scatter-add aggregate, each as host time and wall time a call
    (``_host_ms``: both are host-bound), and B1 alone at the pack's
    ragged layout beside its plain version and its bound (valid levels
    in, words and sidecars out)."""
    import torch
    from repro_torch.core import aggregation, messages, sparse
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.utils.tree import tree_leaves
    q = QuantConfig(bits=4)
    density = SPARSE["density"]
    pack = _host_ms(lambda: messages.pack_message(tree, q, density=density),
                    iters=20)
    wd = w.to(dev)
    agg = _host_ms(lambda: aggregation.fedavg_packed(msgs, wd), iters=10)
    xs = [x for x in tree_leaves(tree) if x.ndim >= 2]
    ks = [sparse.keep_count(x.numel(), density) for x in xs]
    nv = torch.tensor(ks, dtype=torch.int32, device=dev)
    _, vals = sparse._top_k_rows(xs, ks, nv)
    lane = kops.lane_levels(4)
    rows = torch.nn.functional.pad(
        vals, (0, -(-max(ks) // lane) * lane - vals.shape[1])).contiguous()
    b1 = _time_ms(lambda: kops.quant_pack_rows(rows, nv, 4), iters=200)
    plain = _time_ms(lambda: kref.quant_pack_rows_ref(rows, nv, 4), iters=20)
    nbytes = 4 * sum(ks) + rows.numel() // 2 + 8 * len(ks)
    bound = _bound_ms(nbytes, 0.0)
    print(f"sparse timing: one uplink's pack {pack[0]:.3f} ms of host a call"
          f" ({pack[1]:.3f} ms a call to its end); the round's scatter-add "
          f"aggregate (K={len(msgs)}) {agg[0]:.3f} ms of host a call "
          f"({agg[1]:.3f} ms to its end); B1 alone at "
          f"{tuple(rows.shape)} int4 ({sum(ks)} valid levels) "
          f"{b1[0] * 1e3:.2f} us, plain {plain[0] * 1e3:.2f} us, bound "
          f"{bound[0] * 1e3:.3f} us ({nbytes} B, {bound[1]})")


def hetero_data():
    """examples/quickstart.py run_hetero: 10 non-IID (LDA 0.5) clients
    over 1000 synthetic 32x32x3 images."""
    import numpy as np
    from repro_torch.data import SyntheticVision, lda_partition
    rng = np.random.default_rng(0)
    sv = SyntheticVision(seed=0)
    y = rng.integers(0, 10, 1000)
    x = sv.sample(rng, y)
    parts = lda_partition(y, 10, alpha=0.5)
    return [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]


def hetero_cfg():
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import resnet
    return resnet.ResNetConfig(arch="resnet8", lora=LoRAConfig(
        rank=HETERO["rank"], alpha=HETERO["alpha"]))


def make_hetero_server(model, data, device, aggregator=None):
    """run_hetero's FLServer: ResNet-8 at server rank 16 (alpha 256),
    int8, ``RankSchedule.tiered((4, 8, 16), 10)``, K = 6 a round, batch
    32, lr 0.01, 1 local epoch."""
    from repro_torch.core.flocora import FLoCoRAConfig, RankSchedule
    from repro_torch.fl import ClientConfig, FLServer, ServerConfig
    from repro_torch.models import resnet
    cfg = hetero_cfg()
    return FLServer(
        model, lambda f, t, b: resnet.loss_fn(f, t, cfg, b), data,
        ServerConfig(n_clients=HETERO["n_clients"],
                     clients_per_round=HETERO["k"]),
        ClientConfig(local_epochs=1, batch_size=32, lr=0.01),
        FLoCoRAConfig(rank=HETERO["rank"], alpha=HETERO["alpha"],
                      quant_bits=8, rank_schedule=RankSchedule.tiered(
                          HETERO["tiers"], HETERO["n_clients"])),
        aggregator=aggregator, device=device)


def adapter_products(tree) -> list:
    """down @ up (fp32) of every adapter pair of ``tree``, walk order."""
    import torch
    from repro_torch.core import lora
    out = []

    def product(pair):
        down, up, _ = lora._dense_factors(pair)
        out.append(down.to(torch.float32) @ up.to(torch.float32))
        return pair

    lora._walk_pairs(tree, product)
    return out


def check_bucket_folds(captured, dev, label: str = "hetero round") -> float:
    """B2 at each rank bucket's flat layout, on the rounds' (or flushes')
    own uplinks: the kernel within rtol = atol = 1e-5 of its plain
    version. Returns the max abs difference."""
    import torch
    from repro_torch.core import aggregation
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    worst = 0.0
    for rnd, ((msgs, w), _, _) in enumerate(captured, 1):
        for r, idx in aggregation.bucket_by_rank(msgs).items():
            ms = [msgs[i] for i in idx]
            lo = ms[0].layout
            bw = w[idx].to(dev)
            bw = bw / torch.sum(bw)
            args = (torch.stack([m.payload for m in ms]),
                    torch.stack([m.scale for m in ms]),
                    torch.stack([m.zp for m in ms]), bw,
                    torch.from_numpy(lo.n_valid_vec()).to(dev), lo.bits)
            got = kops.dequant_agg_rows(*args)
            want = kref.dequant_agg_rows_ref(*args)
            err = float((got - want).abs().max())
            print(f"check dequant_agg_rows {label} {rnd} bucket r={r}"
                  f" K={len(ms)} {tuple(args[0].shape)}: max_abs_err={err}")
            if not torch.allclose(got, want, rtol=B2_TOL, atol=B2_TOL):
                raise AssertionError(f"dequant_agg_rows at the r={r} "
                                     "bucket's layout failed its check")
            worst = max(worst, err)
    return worst


def hetero_phase(dev) -> dict:
    """``examples/quickstart.py`` run_hetero on the card: 10 clients in
    rank tiers {4, 8, 16}, server rank 16, int8, K = 6, 2 rounds on the
    rank-bucketed engine. Checks the tiers' one-way bytes (57,400 /
    88,888 / 151,864 B) statically and as measured, ONE B2 launch a rank
    bucket and one B1 launch a flat pack (a broadcast a bucket, K
    uplinks, a downlink measured for each rank seen the first time),
    every pack bit-exact against the plain version on the CPU at its
    rank's layout, B2 at each bucket's layout against its plain version,
    round 1 against its CPU replay (cohort ranks included). Then one round
    with ``SVDRecombinationAggregator``: replayed on the CPU (bytes,
    cohort ranks, loss: the served factors may differ in sign, so the
    trees are held by their products below), and the card's
    recombination of that round's uplinks against the CPU's of the same
    uplinks: the same served ranks, adapter products within 1e-4 *
    max|p|."""
    import torch
    from repro_torch.core import flocora, messages
    from repro_torch.core.aggregation import SVDRecombinationAggregator
    from repro_torch.core.flat import FlatPackedMessage
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import resnet
    from repro_torch.utils.tree import tree_to
    data, cfg = hetero_data(), hetero_cfg()
    server = make_hetero_server(resnet.init(0, cfg, device=dev), data, dev)
    tiers = {r: flocora.client_wire_bytes(server.global_train, server.fcfg,
                                          r) for r in HETERO["tiers"]}
    if tiers != HETERO["tier_bytes"]:
        raise AssertionError(f"tier bytes {tiers} != {HETERO['tier_bytes']}")
    with recorded(server.aggregator, "aggregate") as captured, \
            recorded(messages, "pack_message") as packs:
        recs, counts, tree1, walls = run_rounds(server, ROUNDS, "hetero")
    k = server.scfg.clients_per_round
    seen = set()
    for rec, c in zip(recs, counts):
        ranks = set(rec["cohort_ranks"])
        if any(HETERO["tier_bytes"][r] != b
               for r, b in rec["up_bytes_by_rank"].items()):
            raise AssertionError(f"hetero measured bytes by rank "
                                 f"{rec['up_bytes_by_rank']}")
        # a broadcast a bucket and K uplinks, plus a downlink measured
        # once for each rank seen the first time
        packs_want = len(ranks) + k + len(ranks - seen)
        seen |= ranks
        if c["dequant_agg_rows"] != len(ranks) or c["dequant_agg"] \
                or c["quant_pack_rows"] != packs_want:
            raise AssertionError(f"hetero round {rec['round']} launch counts"
                                 f" {c}, want {len(ranks)} folds and "
                                 f"{packs_want} packs")
    # every pack against the plain version on the same tree
    err_b1, layouts = 0.0, set()
    for args, kw, got in packs:
        want = messages.pack_message(tree_to(args[0], "cpu"), args[1], **kw)
        if not isinstance(got, FlatPackedMessage):
            raise AssertionError(f"hetero pack is a {type(got).__name__}")
        lo = got.layout
        same, err = pack_diff((got.payload, got.scale, got.zp),
                              (want.payload, want.scale, want.zp), lo.bits)
        err_b1 = max(err_b1, err)
        if not same or lo != want.layout:
            raise AssertionError(f"hetero pack at {lo.c_total} rows differs "
                                 "from its plain version")
        layouts.add((lo.c_total, lo.nw_max))
    if len(packs) != sum(c["quant_pack_rows"] for c in counts) \
            or len(layouts) != len(HETERO["tiers"]):
        raise AssertionError(f"hetero packs checked: {len(packs)} at "
                             f"layouts {sorted(layouts)}")
    err_b2 = check_bucket_folds(captured, dev)
    compare_with_cpu(recs[0], tree1, make_hetero_server(
        resnet.init(0, cfg, device="cpu"), data, "cpu"), "hetero",
        keys=("cohort_ranks", "up_bytes_by_rank"))
    # one more round, served by the SVD recombination
    svd = make_hetero_server(resnet.init(0, cfg, device=dev), data, dev,
                             SVDRecombinationAggregator(QuantConfig(bits=8)))
    with recorded(svd.aggregator, "aggregate") as svd_in:
        recs_s, counts_s, tree_s, walls_s = run_rounds(svd, 1, "hetero svd")
    cpu_svd = make_hetero_server(
        resnet.init(0, cfg, device="cpu"), data, "cpu",
        SVDRecombinationAggregator(QuantConfig(bits=8)))
    compare_with_cpu(recs_s[0], tree_s, cpu_svd, "hetero svd",
                     keys=("cohort_ranks",), trees=False)
    msgs, w = svd_in[0][0]
    ref = SVDRecombinationAggregator(QuantConfig(bits=8), HETERO["rank"])
    want = ref.aggregate(to_cpu_messages(msgs), w.cpu())
    served = svd.aggregator.served_ranks
    if served != ref.served_ranks or not served:
        raise AssertionError(f"served ranks on the card {served} != the "
                             f"CPU's {ref.served_ranks}")
    worst = 0.0
    for p, q in zip(adapter_products(tree_s), adapter_products(want)):
        d, pmax = float((p.cpu() - q).abs().max()), float(q.abs().max())
        worst = max(worst, d / max(pmax, 1e-30))
        if d > 1e-4 * pmax:
            raise AssertionError(f"svd recombination product: {d} > 1e-4 "
                                 f"* {pmax}")
    torch.cuda.synchronize()
    launches = {}
    for c in counts + counts_s:
        _add_counts(launches, c)
    print(f"hetero phase: tier bytes {tiers}; cohort ranks "
          f"{[r['cohort_ranks'] for r in recs]}; {len(packs)} flat packs "
          f"bit-exact vs plain at layouts (rows, words) {sorted(layouts)}"
          f" (max {err_b1:.3g}); one B2 launch a bucket, "
          f"B2 at each bucket's layout within {B2_TOL} (max {err_b2:.3g});"
          f" svd round served ranks {served} (the CPU replay's "
          f"{cpu_svd.aggregator.served_ranks}), products within "
          f"{worst:.3g} of max|p| of the CPU's recombination; round-2 wall "
          f"{walls[-1]:.4f} s (svd round {walls_s[0]:.4f} s); launches "
          f"{launches}")
    return {"launches": launches, "walls": walls, "err_b1": err_b1,
            "err_b2": err_b2, "server": server}


def dp_phase(data, model_cpu, dev) -> dict:
    """``examples/quickstart.py`` run_uniform(dp_noise=0.3) on the card:
    the quickstart at int8 with each uplink's delta clipped to L2 norm 1
    and noised at 0.3 before quantization, 2 rounds. Checks the uplinks
    (277,816 B), dp_epsilon after rounds 1 and 2 equal to the JAX
    package's values, one B1 launch a message and one B2 a round, every
    privatized delta within 1e-6 * max|x| of ``dp_privatize`` replayed
    on the CPU from the same delta and key (the same noise), and round 1
    against its CPU replay."""
    from repro_torch.core import flocora, quant
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import resnet
    from repro_torch.utils.tree import flatten_with_names, tree_leaves, \
        tree_to
    fl = {"dp": quant.DPConfig(clip_norm=DP["clip_norm"],
                               noise_multiplier=DP["noise_multiplier"])}
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    server = make_server(resnet.init(0, cfg, device=dev), data, dev, fl)
    with recorded(flocora, "dp_privatize") as calls:
        recs, counts, tree1, walls = run_rounds(server, ROUNDS, "dp")
    k = server.scfg.clients_per_round
    for rec, c, eps in zip(recs, counts, DP["epsilon"]):
        if rec["dp_epsilon"] != eps \
                or rec["up_bytes_measured"] != DP["up_bytes"]:
            raise AssertionError(f"dp round {rec['round']}: {rec}")
        packs = k + 1 + (rec["round"] == 1)
        if c["quant_pack_rows"] != packs or c["dequant_agg_rows"] != 1:
            raise AssertionError(f"dp round {rec['round']} launch counts "
                                 f"{c}, want {packs} packs")
    worst = 0.0
    for args, kw, got in calls:
        want = quant.dp_privatize(tree_to(args[0], "cpu"), args[1], **kw)
        for (name, g), (_, x) in zip(flatten_with_names(got),
                                     flatten_with_names(want)):
            d, xmax = float((g.cpu() - x).abs().max()), float(x.abs().max())
            worst = max(worst, d / max(xmax, 1e-30))
            if d > LEAF_TOL * xmax:
                raise AssertionError(f"privatized delta {name} key "
                                     f"{kw['key']}: {d} > {LEAF_TOL} * {xmax}")
    if len(calls) != ROUNDS * k:
        raise AssertionError(f"{len(calls)} privatized uplinks checked")
    compare_with_cpu(recs[0], tree1, make_server(model_cpu, data, "cpu", fl),
                     "dp", keys=("dp_epsilon",))
    args, kw, _ = calls[0]
    t_dp = _host_ms(lambda: quant.dp_privatize(*args, **kw), iters=10)
    print(f"dp timing: one uplink's privatization (clip, "
          f"{sum(x.numel() for x in tree_leaves(args[0]))} normals drawn in "
          f"numpy, one upload) {t_dp[0]:.3f} ms of host a call "
          f"({t_dp[1]:.3f} ms a call to its end)")
    launches = {}
    for c in counts:
        _add_counts(launches, c)
    print(f"dp phase: uplink {recs[0]['up_bytes_measured']} B, dp_epsilon "
          f"{[rec['dp_epsilon'] for rec in recs]}; {len(calls)} privatized "
          f"deltas within {worst:.3g} of max|x| of the CPU's (same noise); "
          f"round-2 wall {walls[-1]:.4f} s; launches {launches}")
    return {"launches": launches, "walls": walls, "server": server}


def async_data():
    """examples/quickstart.py run_async: 12 non-IID (LDA 0.5) clients
    over 1000 synthetic 32x32x3 images."""
    import numpy as np
    from repro_torch.data import SyntheticVision, lda_partition
    rng = np.random.default_rng(0)
    sv = SyntheticVision(seed=0)
    y = rng.integers(0, 10, 1000)
    x = sv.sample(rng, y)
    parts = lda_partition(y, ASYNC["n_clients"], alpha=0.5)
    return [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]


def async_trace():
    """run_async's fleet timing: ~45 s median compute, a jittery 20 Mb/s
    link, each client available 80% of a 10-minute cycle."""
    from repro_torch.fl import AvailabilityWindows, FleetTrace, \
        LognormalLatency
    return FleetTrace(seed=0, latency=LognormalLatency(
        compute_median_s=45.0, network_mbps=20.0),
        availability=AvailabilityWindows(period_s=600.0, duty=0.8))


def make_async_server(data, device, acfg=None, fcfg=None, trace=None):
    """run_async's AsyncFLServer: ResNet-8 at server rank 16 (alpha 256),
    int8, ``RankSchedule.tiered((4, 8, 16), 12)``, batch 32, lr 0.01, 1
    local epoch; ``acfg``/``fcfg``/``trace`` override (the fleet)."""
    from repro_torch.core.flocora import FLoCoRAConfig, RankSchedule
    from repro_torch.fl import AsyncConfig, AsyncFLServer, ClientConfig
    from repro_torch.models import resnet
    cfg = hetero_cfg()
    return AsyncFLServer(
        resnet.init(0, cfg, device="cpu"),
        lambda f, t, b: resnet.loss_fn(f, t, cfg, b), data,
        acfg or AsyncConfig(**ASYNC["acfg"]),
        ClientConfig(local_epochs=1, batch_size=32, lr=0.01),
        fcfg or FLoCoRAConfig(
            rank=HETERO["rank"], alpha=HETERO["alpha"], quant_bits=8,
            rank_schedule=RankSchedule.tiered(HETERO["tiers"],
                                              ASYNC["n_clients"])),
        trace=trace or async_trace(), device=device)


@contextlib.contextmanager
def engine_probes(srv):
    """Wrap an async engine's flush, the aggregator's add and flush, the
    broadcasts and every ``pack_message`` for the duration. Yields a
    dict: ``packs`` ((args, kwargs, message) a pack), ``bcasts`` (a
    broadcast each), ``adds`` ((msg, n_k, staleness) an arrival),
    ``flushes`` a dict each: the pending (msgs, weights) and ranks, the
    streamed or batched mean, the B2 launches inside (read as a
    difference: the counts are not reset), the flush's wall ms (queued
    work finished first), and after
    flush 1 a copy of the global tree (``tree1``)."""
    import torch
    from repro_torch.core import aggregation, flocora, messages
    from repro_torch.kernels import ops as kops
    from repro_torch.utils.tree import tree_map
    agg = srv.aggregator
    probe = {"adds": [], "flushes": [], "tree1": None}
    real_add, real_agg_flush, real_flush = agg.add, agg.flush, srv._flush

    def add(msg, n_k, staleness):
        probe["adds"].append((msg, n_k, staleness))
        return real_add(msg, n_k, staleness)

    def agg_flush():
        pend = list(agg.pending)
        ranks = set(aggregation.bucket_by_rank([m for m, _ in pend]))
        b2 = kops.dequant_agg_rows.launches
        out = real_agg_flush()
        probe["flushes"].append({
            "pending": pend, "ranks": ranks, "mean": out,
            "b2": kops.dequant_agg_rows.launches - b2})
        return out

    def flush():
        torch.cuda.synchronize()     # time the flush's own work alone
        t0 = time.perf_counter()
        out = real_flush()
        torch.cuda.synchronize()
        probe["flushes"][-1]["wall_ms"] = (time.perf_counter() - t0) * 1e3
        if srv.n_flushes == 1:
            probe["tree1"] = tree_map(lambda x: x.clone(), srv.global_train)
        return out

    agg.add, agg.flush, srv._flush = add, agg_flush, flush
    try:
        with recorded(messages, "pack_message") as packs, \
                recorded(flocora, "broadcast") as bcasts:
            probe["packs"], probe["bcasts"] = packs, bcasts
            yield probe
    finally:
        for owner, name in ((agg, "add"), (agg, "flush"), (srv, "_flush")):
            delattr(owner, name)


def expected_packs(srv, probe) -> int:
    """B1 launches an async run must have made, from the engine's own
    state: a broadcast a (version, rank) memo miss, a downlink measured
    once a rank, an uplink a trained client (arrived, or computed and
    still in flight)."""
    trained = srv.n_arrived + sum(1 for r in srv.inflight.values()
                                  if r.msg is not None)
    return len(probe["bcasts"]) + len(srv.wire.down) + trained


def check_packs(packs, what: str) -> tuple:
    """Every flat pack of a run against ``pack_message`` on the CPU on the
    same tree: bit-exact words, scale and zp. Returns (max error, set of
    (rows, words) layouts)."""
    from repro_torch.core import messages
    from repro_torch.core.flat import FlatPackedMessage
    from repro_torch.utils.tree import tree_to
    err_b1, layouts = 0.0, set()
    for args, kw, got in packs:
        want = messages.pack_message(tree_to(args[0], "cpu"), args[1], **kw)
        if not isinstance(got, FlatPackedMessage):
            raise AssertionError(f"{what} pack is a {type(got).__name__}")
        lo = got.layout
        same, err = pack_diff((got.payload, got.scale, got.zp),
                              (want.payload, want.scale, want.zp), lo.bits)
        err_b1 = max(err_b1, err)
        if not same or lo != want.layout:
            raise AssertionError(f"{what} pack at {lo.c_total} rows differs "
                                 "from its plain version")
        layouts.add((lo.c_total, lo.nw_max))
    return err_b1, layouts


EVENT_KEYS = ("version", "t_virtual", "n_arrived", "n_flushed", "n_churned",
              "staleness_mean", "staleness_max", "flush_ranks", "down_bytes",
              "up_bytes", "tcc_bytes", "wasted_bytes", "uplink_density")


def async_phase(dev) -> dict:
    """``examples/quickstart.py`` run_async on the card: 12 clients in rank
    tiers {4, 8, 16} (server r = 16, int8) through the event-driven
    FedBuff engine, 90 arrivals, concurrency 6, buffers of 6 (15 flushes),
    the run_async trace. Checks the tiers' one-way bytes statically and
    as measured, TCC = initial model + down + up, every B1 pack (the
    broadcasts, the measured downlinks, the uplinks: counted from the
    engine's own state) bit-exact against the plain version on the CPU,
    each flush's B2 launches (one a rank bucket) and B2 held to its plain
    version on each flush's buckets, the compile bound on the program
    keys, and flush 1 replayed by a CPU engine: event fields exactly
    equal, loss within rtol 1e-3, trees within 4 int8 steps."""
    import numpy as np
    import torch
    from repro_torch.core import flocora
    from repro_torch.kernels import ops as kops
    from repro_torch.utils.tree import tree_bytes
    data = async_data()
    srv = make_async_server(data, dev)
    tiers = {r: flocora.client_wire_bytes(srv.global_train, srv.fcfg, r)
             for r in HETERO["tiers"]}
    if tiers != HETERO["tier_bytes"]:
        raise AssertionError(f"async tier bytes {tiers}")
    with engine_probes(srv) as probe:
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kops.launch_counts()
    acfg = srv.acfg
    last = hist[-1]
    want_flushes = acfg.total_arrivals // acfg.buffer_size
    if len(hist) != want_flushes or last["n_arrived"] != acfg.total_arrivals:
        raise AssertionError(f"async: {len(hist)} flushes, last {last}")
    if srv.wire.down != HETERO["tier_bytes"] or {
            r: b for (r, _), b in srv.wire.up.items()} != \
            HETERO["tier_bytes"]:
        raise AssertionError(f"async measured bytes down {srv.wire.down} "
                             f"up {srv.wire.up}")
    if last["tcc_bytes"] != tree_bytes(srv.frozen) + last["down_bytes"] \
            + last["up_bytes"] or srv.tcc_bytes != last["tcc_bytes"]:
        raise AssertionError(f"async tcc {last}")
    packs_want = expected_packs(srv, probe)
    if launches["quant_pack_rows"] != packs_want \
            or len(probe["packs"]) != packs_want:
        raise AssertionError(f"async B1 launches {launches}, "
                             f"{len(probe['packs'])} packs, want "
                             f"{packs_want}")
    for i, f in enumerate(probe["flushes"], 1):
        if f["b2"] != len(f["ranks"]):
            raise AssertionError(f"async flush {i}: {f['b2']} B2 launches "
                                 f"for rank buckets {sorted(f['ranks'])}")
    if launches["dequant_agg_rows"] != sum(f["b2"]
                                           for f in probe["flushes"]):
        raise AssertionError(f"async B2 launches {launches}")
    bound = len(HETERO["tiers"]) * (int(math.log2(acfg.concurrency)) + 1)
    if len(srv.program_keys) > bound:
        raise AssertionError(f"async program keys {srv.program_keys} > "
                             f"{bound}")
    err_b1, layouts = check_packs(probe["packs"], "async")
    err_b2 = check_bucket_folds(
        [(([m for m, _ in f["pending"]],
           torch.tensor([w for _, w in f["pending"]])), None, None)
         for f in probe["flushes"]], dev, "async flush")
    # flush 1 replayed on the CPU
    t1 = time.perf_counter()
    cpu = make_async_server(data, "cpu")
    cpu._fill_pipeline()
    rec = None
    while rec is None:
        rec = cpu.step()
    for key in EVENT_KEYS:
        if rec[key] != hist[0][key]:
            raise AssertionError(f"async cpu replay {key}: {rec[key]} != "
                                 f"{hist[0][key]}")
    if not math.isclose(rec["client_loss"], hist[0]["client_loss"],
                        rel_tol=1e-3):
        raise AssertionError(f"async cpu replay loss {rec['client_loss']} "
                             f"!= {hist[0]['client_loss']}")
    diff = hold_trees(cpu.global_train, probe["tree1"], 8,
                      "async cpu replay")
    flush_ms = [f["wall_ms"] for f in probe["flushes"]]
    print(f"async phase: tier bytes {tiers}; {len(hist)} flushes, virtual "
          f"{last['t_virtual']:.1f} s, tcc {last['tcc_bytes']} B, loss "
          f"{hist[0]['client_loss']:.5f} -> {last['client_loss']:.5f}; run "
          f"wall {wall:.3f} s ({acfg.total_arrivals / wall:.2f} arrivals/s),"
          f" flush {np.median(flush_ms):.3f} ms wall median "
          f"({min(flush_ms):.3f}-{max(flush_ms):.3f}); program keys "
          f"{len(srv.program_keys)} <= {bound}; {len(probe['packs'])} packs "
          f"({len(probe['bcasts'])} broadcasts) bit-exact vs plain at "
          f"layouts {sorted(layouts)} (max {err_b1:.3g}); one B2 launch a "
          f"rank bucket, within {B2_TOL} of plain (max {err_b2:.3g}); cpu "
          f"replay of flush 1: events equal, loss {rec['client_loss']:.6f}"
          f" vs {hist[0]['client_loss']:.6f}, max adapter diff {diff:.3g} "
          f"({time.perf_counter() - t1:.1f} s); launches {launches}")
    return {"launches": launches, "wall": wall, "err_b1": err_b1,
            "err_b2": err_b2, "flush_ms": flush_ms}


def make_fleet(dev, ckpt_dir):
    """benchmarks/round_throughput.py run_fleet's operating point at
    ResNet-8's width: a 1M-client ``Population`` of the default tiers
    (70% rank-4 phones that churn and are diurnal, 25% rank-8 laptops,
    5% rank-16 workstations) with 64-image ``client_shard`` vision
    shards behind a 256-client LRU, ``PopulationTrace``; server r = 16,
    int8, streaming FedBuff, buffers of 10, 64 in flight."""
    from repro_torch.core.flocora import FLoCoRAConfig
    from repro_torch.fl import AsyncConfig, Population, PopulationTrace, \
        default_tiers
    pop = Population(FLEET["n_clients"], default_tiers(), seed=0,
                     shard_size=FLEET["shard_size"],
                     cache_clients=FLEET["cache"])
    acfg = AsyncConfig(**FLEET["acfg"], checkpoint_dir=ckpt_dir)
    fcfg = FLoCoRAConfig(rank=HETERO["rank"], alpha=HETERO["alpha"],
                         quant_bits=8)
    return pop, make_async_server(pop, dev, acfg, fcfg,
                                  PopulationTrace(seed=0, population=pop))


def fleet_phase(dev) -> dict:
    """The million-client fleet on the card (see ``make_fleet``), 200
    arrivals, checkpointed every 5 flushes, under cuDNN's deterministic
    algorithms. Checks peak resident shards <= 256, churn (n_churned > 0
    and wasted bytes = the churned dispatches' downlinks, recomputed from
    the trace's draws), exactly one B2 (K = 1) launch an arrival, B1
    counted from the engine's state and bit-exact against its plain
    version, each flush's streamed mean within 1e-6 * max|x| of a
    batched ``FedBuffAggregator`` flush of the same arrivals and weights,
    and kill/resume: a fresh engine resumed from the oldest checkpoint
    replays the rest of the history and the final tree bit for bit.
    Times the K = 1 fold at the rank-16 layout."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import flat as flatcodec
    from repro_torch.core.aggregation import FedBuffAggregator
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.utils.tree import flatten_with_names
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="fleet_smoke_", dir=ROOT / "build")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pop, srv = make_fleet(dev, str(Path(d) / "a"))
        churn_draws = []
        real_churned = srv.trace.churned

        def churned(cid, idx):
            out = real_churned(cid, idx)
            churn_draws.append((cid, idx, out))
            return out

        # the trace is a frozen dataclass: record its churn draws on this
        # instance alone
        object.__setattr__(srv.trace, "churned", churned)
        with engine_probes(srv) as probe:
            kops.reset_launch_counts()
            t0 = time.perf_counter()
            hist = srv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kops.launch_counts()
        acfg = srv.acfg
        if pop.peak_resident > FLEET["cache"]:
            raise AssertionError(f"fleet peak resident {pop.peak_resident}")
        dropped = [(c, i) for c, i, out in churn_draws
                   if out and i not in srv.inflight]
        wasted = sum(srv.wire.down[pop.rank_for(c)] for c, _ in dropped)
        if srv.n_churned <= 0 or srv.n_churned != len(dropped) \
                or hist[-1]["wasted_bytes"] != wasted \
                or hist[-1]["n_churned"] != srv.n_churned:
            raise AssertionError(f"fleet churn: {srv.n_churned} churned, "
                                 f"{len(dropped)} drawn, wasted "
                                 f"{hist[-1]['wasted_bytes']} vs {wasted}")
        if launches["dequant_agg_rows"] != acfg.total_arrivals \
                or len(probe["adds"]) != acfg.total_arrivals \
                or any(f["b2"] for f in probe["flushes"]):
            raise AssertionError(f"fleet B2 launches {launches}: want one "
                                 f"an arrival, none at a flush")
        packs_want = expected_packs(srv, probe)
        if launches["quant_pack_rows"] != packs_want:
            raise AssertionError(f"fleet B1 launches {launches}, want "
                                 f"{packs_want}")
        err_b1, layouts = check_packs(probe["packs"], "fleet")
        # each streamed mean against the batched flush of its arrivals
        worst, start = 0.0, 0
        for f in probe["flushes"]:
            batch = FedBuffAggregator(half_life=acfg.half_life,
                                      r_target=HETERO["rank"])
            take = probe["adds"][start:start + acfg.buffer_size]
            start += acfg.buffer_size
            for msg, n_k, s in take:
                batch.add(msg, n_k, s)
            want = batch.flush()
            for (name, x), (_, y) in zip(flatten_with_names(f["mean"]),
                                         flatten_with_names(want)):
                dx, ymax = float((x - y).abs().max()), float(y.abs().max())
                worst = max(worst, dx / max(ymax, 1e-30))
                if dx > LEAF_TOL * ymax:
                    raise AssertionError(f"fleet streamed mean {name}: "
                                         f"{dx} > {LEAF_TOL} * {ymax}")
        # kill/resume from the oldest checkpoint
        a, b = Path(d) / "a", Path(d) / "b"
        steps = sorted(int(p.name[5:-5]) for p in a.glob("ckpt_*.json"))
        b.mkdir()
        for ext in (".npz", ".json"):
            shutil.copy(a / f"ckpt_{steps[0]:08d}{ext}", b)
        _, again = make_fleet(dev, str(b))
        if not again.try_resume() or again.n_flushes != steps[0]:
            raise AssertionError("the fleet did not resume its oldest "
                                 f"checkpoint ({steps})")
        t1 = time.perf_counter()
        hist_b = again.run()
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t1
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(d, ignore_errors=True)
    if hist_b != hist:
        i, ra, rb = next((i, ra, rb) for i, (ra, rb) in enumerate(
            zip(hist, hist_b)) if ra != rb) if len(hist) == len(hist_b) \
            else (len(hist), hist[-1], hist_b[-1])
        raise AssertionError(
            f"resumed fleet history differs at flush {i + 1} of "
            f"{len(hist)} / {len(hist_b)}: keys "
            f"{sorted(k for k in ra if ra.get(k) != rb.get(k))}: {ra} vs "
            f"{rb}")
    for (name, x), (_, y) in zip(flatten_with_names(srv.global_train),
                                 flatten_with_names(again.global_train)):
        if not torch.equal(_f32_bits(x), _f32_bits(y)):
            raise AssertionError(f"resumed fleet tree {name} differs")
    flush_ms = [f["wall_ms"] for f in probe["flushes"]]
    print(f"fleet phase: {pop.n_clients} clients, {len(hist)} flushes, "
          f"virtual {hist[-1]['t_virtual']:.1f} s, loss "
          f"{hist[0]['client_loss']:.5f} -> {hist[-1]['client_loss']:.5f}, "
          f"tcc {hist[-1]['tcc_bytes']} B; peak resident "
          f"{pop.peak_resident} <= {FLEET['cache']}; {srv.n_dispatched} "
          f"dispatched, {srv.n_churned} churned, wasted "
          f"{hist[-1]['wasted_bytes']} B (recomputed); run wall {wall:.3f} s"
          f" ({acfg.total_arrivals / wall:.2f} arrivals/s); streaming flush"
          f" {np.median(flush_ms):.3f} ms wall median "
          f"({min(flush_ms):.3f}-{max(flush_ms):.3f}); program keys "
          f"{sorted(srv.program_keys)}; {len(probe['packs'])} packs "
          f"bit-exact vs plain at layouts {sorted(layouts)} (max "
          f"{err_b1:.3g}); B2 one K=1 launch an arrival "
          f"({launches['dequant_agg_rows']}); streamed means within "
          f"{worst:.3g} of max|x| of the batched flushes; resumed from "
          f"flush {steps[0]} of {steps}: {len(hist_b) - steps[0]} more "
          f"flushes bit-identical in {resume_wall:.3f} s; launches "
          f"{launches}")
    # the K = 1 fold at the rank-16 layout, and its plain version
    msg = next(m for m, _, _ in probe["adds"]
               if m.layout.c_total == max(l[0] for l in layouts))
    lo = msg.layout
    nv = torch.from_numpy(lo.n_valid_vec()).to(dev)
    w1 = torch.ones((1,), dtype=torch.float32, device=dev)
    args = (msg.payload[None], msg.scale[None], msg.zp[None], w1, nv,
            lo.bits)
    err_b2 = float((kops.dequant_agg_rows(*args)
                    - kref.dequant_agg_rows_ref(*args)).abs().max())
    if err_b2 > B2_TOL:
        raise AssertionError(f"fleet fold B2 error {err_b2}")
    acc = torch.zeros((lo.c_total, lo.n_max), dtype=torch.float32,
                      device=dev)
    t_k1 = _time_ms(lambda: kops.dequant_agg_rows(*args), 200)
    t_plain = _time_ms(lambda: kref.dequant_agg_rows_ref(*args), 20)
    fp_acc = tuple(torch.zeros_like(x, dtype=torch.float32)
                   for x in msg.fp_leaves)

    def fold_on_device():
        # fold_flat's device work with its weight already on the card: a
        # queued fold_flat's pinned weight upload cannot reuse its host
        # block behind _time_ms's sleep, and waits on a new allocation
        contrib = kops.dequant_agg_rows(*args)
        return acc + contrib, tuple(a + x.to(torch.float32) for a, x in
                                    zip(fp_acc, msg.fp_leaves))

    t_fold = _time_ms(fold_on_device, 20)     # ~1 ms of host a call
    t_fold_host = _host_ms(
        lambda: flatcodec.fold_flat(acc, fp_acc, msg, 1.0, nv), 100)
    per = 32 // lo.bits
    words = int(sum(-(-int(v) // per) for v in lo.n_valid_vec()))
    nbytes = words * 4 + 2 * lo.c_total * 4 + 4 + lo.c_total * 4 \
        + lo.c_total * lo.n_max * 4
    bound = _bound_ms(nbytes, 0.0)
    print(f"fleet fold at the r={HETERO['rank']} layout ({lo.c_total} rows "
          f"x {lo.nw_max} words, {lo.n_max} levels; {words} words hold a "
          f"valid level): B2 K=1 "
          f"{t_k1[0] * 1e3:.2f} us on the device ({t_k1[1] * 1e3:.2f} us a "
          f"call), the fold's device work (B2, the accumulator and fp "
          f"adds) {t_fold[0] * 1e3:.2f} us ({t_fold[1] * 1e3:.2f} us a "
          f"call), fold_flat itself {t_fold_host[0] * 1e3:.2f} us of host "
          f"a call ({t_fold_host[1] * 1e3:.2f} us to its end), plain "
          f"{t_plain[0] * 1e3:.2f}"
          f" us; bound {bound[0] * 1e3:.3f} us ({bound[1]}, {nbytes} B); "
          f"max_abs_err {err_b2}")
    return {"launches": launches, "wall": wall, "err_b1": err_b1,
            "err_b2": err_b2, "fold": (t_k1, t_plain, bound)}


def deadline_phase(data, model_cpu, dev) -> dict:
    """Deadline cohorts in the synchronous FLServer on the card: the
    quickstart fleet with ``trace=`` the run_async trace and oversample
    1.5 (8 dispatched, 5 kept), 2 rounds; round 1 replayed on the CPU
    (n_straggled and wasted bytes exactly equal, loss within rtol 1e-3,
    trees within 4 int8 steps); one B2 launch a round. Then one round of
    the mixed-rank fleet on ``FedBuffAggregator(rank_staleness=True)``
    (one B2 launch a rank bucket), held to its CPU replay."""
    from repro_torch.core.aggregation import FedBuffAggregator
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import resnet
    sv = {"oversample": 1.5}
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    server = make_server(resnet.init(0, cfg, device=dev), data, dev,
                         server=sv, trace=async_trace())
    recs, counts, tree1, walls = run_rounds(server, ROUNDS, "deadline")
    k = server.scfg.clients_per_round
    for rec, c in zip(recs, counts):
        want = 1 + 8 + (rec["round"] == 1)
        if rec["n_straggled"] != 3 or rec["wasted_bytes"] <= 0 \
                or c["quant_pack_rows"] != want \
                or c["dequant_agg_rows"] != 1:
            raise AssertionError(f"deadline round {rec['round']}: {rec}, "
                                 f"launches {c}")
    compare_with_cpu(recs[0], tree1, make_server(
        model_cpu, data, "cpu", server=sv, trace=async_trace()),
        "deadline cohorts")
    data_h, cfg = hetero_data(), hetero_cfg()
    fb = make_hetero_server(resnet.init(0, cfg, device=dev), data_h, dev,
                            FedBuffAggregator(rank_staleness=True))
    recs_f, counts_f, tree_f, walls_f = run_rounds(fb, 1, "fedbuff sync")
    if counts_f[0]["dequant_agg_rows"] != len(recs_f[0]["cohort_ranks"]):
        raise AssertionError(f"fedbuff sync launches {counts_f[0]}")
    compare_with_cpu(recs_f[0], tree_f, make_hetero_server(
        resnet.init(0, cfg, device="cpu"), data_h, "cpu",
        FedBuffAggregator(rank_staleness=True)), "fedbuff sync",
        keys=("cohort_ranks", "up_bytes_by_rank"))
    launches = {}
    for c in counts + counts_f:
        _add_counts(launches, c)
    print(f"deadline phase: {k} kept of 8 a round, stragglers "
          f"{[r['n_straggled'] for r in recs]}, wasted "
          f"{[r['wasted_bytes'] for r in recs]} B; fedbuff sync round "
          f"cohort ranks {recs_f[0]['cohort_ranks']}; round-2 wall "
          f"{walls[-1]:.4f} s, fedbuff round {walls_f[0]:.4f} s; launches "
          f"{launches}")
    return {"launches": launches, "walls": walls}


def table4_data():
    """benchmarks/common.py fl_experiment at table4_comparison.py's
    --train settings: 2000 synthetic 32x32x3 images over 20 clients (LDA
    1.0, partition seed 0), then 1000 held-out test images drawn after
    them from the same rng."""
    import numpy as np
    from repro_torch.data import SyntheticVision, lda_partition
    rng = np.random.default_rng(0)
    sv = SyntheticVision(seed=0)
    y = rng.integers(0, 10, 2000)
    x = sv.sample(rng, y).astype(np.float32)
    parts = lda_partition(y, 20, alpha=1.0, seed=0)
    data = [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]
    yt = rng.integers(0, 10, 1000)
    return data, sv.sample(rng, yt), yt


def table4_cfg():
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import resnet
    return resnet.ResNetConfig(arch="resnet18", lora=LoRAConfig(
        rank=TABLE4["rank"], alpha=TABLE4["alpha"]))


def make_table4_server(model, data, device, eval_fn=None):
    """fl_experiment's FLServer for Table IV's (r=64, int8) row: K=4 a
    round, batch 32, lr 0.01, momentum 0.9, 1 local epoch, seed 0,
    eval every 2 rounds."""
    from repro_torch.core.flocora import FLoCoRAConfig
    from repro_torch.fl import ClientConfig, FLServer, ServerConfig
    from repro_torch.models import resnet
    cfg = table4_cfg()
    return FLServer(
        model, lambda f, t, b: resnet.loss_fn(f, t, cfg, b), data,
        ServerConfig(rounds=TABLE4["rounds"], n_clients=20,
                     clients_per_round=4, seed=0, eval_every=2),
        ClientConfig(local_epochs=1, batch_size=32, lr=0.01, momentum=0.9),
        FLoCoRAConfig(rank=TABLE4["rank"], alpha=TABLE4["alpha"],
                      quant_bits=8),
        eval_fn, device=device)


def table4_phase(dev) -> dict:
    """The paper's Table IV training run (ResNet-18, r=64, alpha=1024,
    int8 flat wire) on the card at full width, TABLE4["rounds"] rounds of
    the table's 12, with fl_experiment's test accuracy every 2 rounds.
    Checks each uplink's measured bytes against the static accounting
    and 2,379,064 B, test_acc in exactly the even rounds and finite, one
    B1 launch a message and one B2 launch a round, and round 1 against
    its CPU replay."""
    import torch
    from repro_torch.core import messages
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import resnet
    data, xt, yt = table4_data()
    cfg = table4_cfg()
    xt_dev = torch.from_numpy(xt).to(dev)

    def eval_fn(frozen, train):
        with torch.no_grad():
            pred = torch.argmax(resnet.apply(frozen, train, cfg, xt_dev), -1)
        return {"test_acc": float((pred.cpu().numpy() == yt).mean())}

    server = make_table4_server(resnet.init(0, cfg, device=dev), data, dev,
                                eval_fn)
    static = messages.message_wire_bytes(server.global_train,
                                         QuantConfig(bits=8))
    recs, counts, tree1, walls = run_rounds(server, TABLE4["rounds"],
                                            "table4")
    k = server.scfg.clients_per_round
    for rec, c in zip(recs, counts):
        if rec["up_bytes_measured"] != TABLE4["up_bytes"] \
                or static != TABLE4["up_bytes"]:
            raise AssertionError(f"table4 uplink bytes "
                                 f"{rec['up_bytes_measured']} (static "
                                 f"{static}) != {TABLE4['up_bytes']}")
        evaluated = rec["round"] % 2 == 0
        if ("test_acc" in rec) != evaluated or (
                evaluated and not math.isfinite(rec["test_acc"])):
            raise AssertionError(f"table4 round {rec['round']} eval: {rec}")
        # one pack a message: the broadcast and K uplinks, plus round 1's
        # measured downlink; one reduce a round
        packs = k + 1 + (rec["round"] == 1)
        if c["quant_pack_rows"] != packs or c["dequant_agg_rows"] != 1:
            raise AssertionError(f"table4 round {rec['round']} launch "
                                 f"counts {c}, want {packs} packs")
    compare_with_cpu(recs[0], tree1, make_table4_server(
        resnet.init(0, cfg, device="cpu"), data, "cpu"), "table4")
    accs = {rec["round"]: rec["test_acc"] for rec in recs
            if "test_acc" in rec}
    print(f"table4 (ResNet-18 r=64 int8, {TABLE4['rounds']} of 12 rounds): "
          f"uplink {static} B a message, test_acc by round {accs}, round "
          f"walls (s) {[round(t, 4) for t in walls]}")
    launches = {}
    for c in counts:
        _add_counts(launches, c)
    return {"launches": launches, "walls": walls, "accs": accs, "k": k}


def time_flat_kernels(update, k: int, dev, label: str) -> dict:
    """B1 and B2 at ``update``'s int8 flat layout (B2 over K packed
    messages), beside their plain versions and bounds, and the fp32
    staging (``flat_rows``) each message builds before B1. Returns
    {kernel: ((ms, call ms), (plain ms, plain call ms), (bound ms, by))}."""
    import numpy as np
    import torch
    from repro_torch.core import flat as flatcodec
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.utils.tree import tree_leaves, tree_map
    lo = flatcodec.layout_for(update, 8)
    leaves = tree_leaves(update)
    flat = flatcodec.flat_rows(leaves, lo)
    nv = torch.from_numpy(lo.n_valid_vec()).to(dev)
    c, n = flat.shape
    nw = n // 4
    nvv = lo.n_valid_vec().astype(np.int64)
    t_s = _time_ms(lambda: flatcodec.flat_rows(leaves, lo), 20)
    # the staging reads each valid value once and writes the whole buffer
    s_bytes = 4 * nvv.sum() + 4 * c * n
    s_bound = _bound_ms(s_bytes, 0)
    t_q = _time_ms(lambda: kops.quant_pack_rows(flat, nv, 8), 200)
    t_qp = _time_ms(lambda: kref.quant_pack_rows_ref(flat, nv, 8), 10)
    # bytes the function must move: the valid levels in, every word and
    # the sidecars out (the kernel never reads a column past n_valid)
    q_bytes = 4 * nvv.sum() + 4 * c + 4 * c * nw + 8 * c
    q_bound = _bound_ms(q_bytes, 9 * nvv.sum())
    gen = torch.Generator().manual_seed(3)
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
    print(f"flat_rows staging {label} int8 {(c, n)}: {t_s[0] * 1e3:.2f} us "
          f"on the device ({t_s[1] * 1e3:.2f} us a call from Python), "
          f"bound {s_bound[0] * 1e3:.2f} us ({s_bytes} B), "
          f"{s_bound[0] / t_s[0]:.1%} of the bound")
    for name, shape, t, tp, bound, nbytes in (
            ("quant_pack_rows int8", tuple(flat.shape), t_q, t_qp, q_bound,
             q_bytes),
            (f"dequant_agg_rows K={k}", tuple(pk.shape), t_d, t_dp, d_bound,
             d_bytes)):
        print(f"{name} {label} {shape}: kernel {t[0] * 1e3:.2f} us on the "
              f"device ({t[1] * 1e3:.2f} us a call from Python), plain "
              f"{tp[0] * 1e3:.2f} us ({tp[1] * 1e3:.2f} us a call), bound "
              f"{bound[0] * 1e3:.2f} us ({nbytes} B), "
              f"{bound[0] / t[0]:.1%} of the bound")
    return {"quant_pack_rows": (t_q, t_qp, q_bound),
            "dequant_agg_rows": (t_d, t_dp, d_bound)}


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


def profile_call(fn, label: str, top: int = 15) -> None:
    """One call of ``fn`` under torch.profiler: its wall time, device
    busy share, kernel launches and the ``top`` kernels with the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type.name == "CUDA"),
                     key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled {label}: wall {wall * 1e3:.1f} ms, device "
          f"busy {dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}%), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def profile_round(server, label: str) -> None:
    """One more round of ``server`` under torch.profiler."""
    profile_call(server.run_round, f"round ({label})")


def profile_lm(dev) -> None:
    """The LM's calls under torch.profiler, each after a warm call:
    gemma3-4b full's prefill of 2 x 1,536 tokens, one decode step and
    one adapter backward at 1 x 2,048 tokens, then an lm-110m local
    step (8 x 128 tokens)."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import lm_federated as fed
    from repro_torch.models import lm as LM
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    c = LM_FULL
    cfg = registry.get(c["arch"]).full()
    p = LM.init(torch.Generator(device=dev).manual_seed(c["seed"]), cfg,
                device=dev)
    rng = np.random.default_rng(c["seed"])
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (c["batch"], c["prompt"]))).to(dev)
    with torch.no_grad():
        def prefill():
            return LM.prefill(p["frozen"], p["train"], cfg, prompt,
                              max_seq=c["prompt"] + c["gen"])
        logits, caches, pos = prefill()
        tok = torch.argmax(logits, -1)[:, None]
        LM.decode_step(p["frozen"], p["train"], cfg, tok, caches, pos)
        profile_call(prefill, f"lm prefill 2 x {c['prompt']}", top=8)
        profile_call(lambda: LM.decode_step(p["frozen"], p["train"], cfg,
                                            tok, caches, pos + 1),
                     "lm decode step", top=8)
    leaves, treedef = tree_flatten(_move_b(p["train"], 1, dev))
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, c["train_seq"] + 1))).to(dev)}

    def backward():
        ls = [t.detach().requires_grad_(True) for t in leaves]
        loss, _ = LM.loss_fn(p["frozen"], tree_unflatten(treedef, ls), cfg,
                             batch)
        torch.autograd.grad(loss, ls)

    backward()
    profile_call(backward, f"lm adapter backward 1 x {c['train_seq']}",
                 top=8)
    del p, caches, leaves
    _free_cuda()
    cfg = fed.make_cfg(True)
    p = LM.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    toks = torch.from_numpy(fed.client_tokens(
        np.random.default_rng(0), cfg, 0, 1, LM_FED["batch"],
        LM_FED["seq"])).to(dev)
    step = fed.make_local_train(p["frozen"], cfg)
    step(p["train"], toks)
    profile_call(lambda: step(p["train"], toks), "lm-110m local step",
                 top=8)
    del p
    _free_cuda()


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
    """B3 as the per-leaf round calls it (one grouped launch over the
    flat run's round-1 uplinks, read where they lie) beside the 18-call
    form the round made before (a stack of the K payloads and one launch
    a leaf writing the padded width), the whole per-leaf
    ``fedavg_packed`` by CUDA events and by host wall time, and both
    bounds; B6 at the full width warm and cold, beside its plain version
    and bound, ``torch.matmul(x, W)`` in bf16 and the three-call library
    composition as context, timed the same two ways. The JSON line takes
    the grouped B3 call and B6 cold."""
    import numpy as np
    import torch
    from repro_torch.core import aggregation
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    leaves, w, bits = leaf["leaves"], leaf["weights"], leaf["bits"]
    wn = w / w.sum()
    per = 32 // bits
    k = len(leaves[0][0])

    def stacked(clients):
        return [torch.stack([c[i] for c in clients]) for i in range(3)]

    pre = [stacked(cl) for cl, _ in leaves]

    def grouped():
        kops.dequant_agg_leaves(leaves, wn, bits)

    def per_leaf_calls():
        for t in pre:
            kops.dequant_agg(*t, wn, bits)

    def per_leaf_with_stacks():
        for cl, n in leaves:
            kops.dequant_agg(*stacked(cl), wn, bits)[:, :n]

    t_grp = _time_ms(grouped, 50)
    # a round of the 18-call form is 18 launches (72 with the stacks):
    # few iterations, so all of them fit the launch queue behind the sleep
    t_18 = _time_ms(per_leaf_calls, 5)
    t_18s = _time_ms(per_leaf_with_stacks, 5)
    # the same round at K = 20 (the K = 5 clients four times): its
    # 1,603-word table goes through pinned memory, and queued behind the
    # sleep no pinned block frees, so each call allocates one: few
    # iterations
    leaves20 = [(cl * 4, n) for cl, n in leaves]
    w20 = wn.repeat(4) / 4
    t_grp20 = _time_ms(lambda: kops.dequant_agg_leaves(leaves20, w20, bits),
                       5)
    # a round of the plain version is ~1,200 small launches, more than the
    # launch queue holds behind the sleep kernel: sum its leaves
    per_leaf_p = [_time_ms(lambda lf=lf: kref.dequant_agg_leaves_ref(
        [lf], wn, bits), 5) for lf in leaves]
    t_grp_p = (sum(t[0] for t in per_leaf_p), sum(t[1] for t in per_leaf_p))
    t_fed = _time_ms(lambda: aggregation.fedavg_packed(leaf["msgs"], w), 10)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        aggregation.fedavg_packed(leaf["msgs"], w)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # bytes the function must move: the words that hold a valid level
    # (K clients), the sidecars and weights once, and the output: the
    # compact (C, n) blocks the round keeps, or (the old count) the whole
    # lane-padded (C, Nw*32/bits) rows the 18-call form wrote; 4
    # operations per valid level and client
    words = sum(cl[0][1].shape[0] * -(-n // per) for cl, n in leaves)
    side = sum(8 * k * cl[0][1].shape[0] for cl, _ in leaves) + 4 * k
    levels = sum(cl[0][1].shape[0] * n for cl, n in leaves)
    padded = sum(cl[0][1].shape[0] * cl[0][0].shape[1] * per
                 for cl, _ in leaves)
    compact_bytes = 4 * k * words + side + 4 * levels
    padded_bytes = 4 * k * words + side + 4 * padded
    b_grp = _bound_ms(compact_bytes, 4 * k * levels)
    b_old = _bound_ms(padded_bytes, 4 * k * levels)
    print(f"dequant_agg a per-leaf round ({len(leaves)} leaves, K={k}, "
          f"int{bits}), grouped: 1 launch {t_grp[0] * 1e3:.2f} us on the "
          f"device ({t_grp[1] * 1e3:.2f} us a call from Python), plain "
          f"{t_grp_p[0] * 1e3:.2f} us; bound {b_grp[0] * 1e3:.3f} us by "
          f"{b_grp[1]} ({compact_bytes} B, compact output), "
          f"{b_grp[0] / t_grp[0]:.1%} of it")
    # at K = 20 the words are read four times as often, and each client
    # has its sidecars and weight
    bytes20 = 4 * (4 * k) * words + 4 * side + 4 * levels
    b_grp20 = _bound_ms(bytes20, 4 * (4 * k) * levels)
    print(f"dequant_agg the same round at K={4 * k} (its table uploaded): "
          f"1 launch {t_grp20[0] * 1e3:.2f} us on the device "
          f"({t_grp20[1] * 1e3:.2f} us a call from Python); bound "
          f"{b_grp20[0] * 1e3:.3f} us by {b_grp20[1]} ({bytes20} B)")
    split = kernel_split(grouped, 20)
    print("dequant_agg grouped call by kernel (torch.profiler, 20 calls): "
          + ", ".join(f"{nm[:48]} {us:.2f} us" for nm, us in split))
    print(f"dequant_agg the 18-call form (one launch a leaf, padded rows "
          f"written): kernels alone {t_18[0] * 1e3:.2f} us on the device "
          f"({t_18[1] * 1e3:.2f} us of calls), with the stacks "
          f"{t_18s[0] * 1e3:.2f} us ({t_18s[1] * 1e3:.2f} us of calls); "
          f"bound {b_old[0] * 1e3:.3f} us by {b_old[1]} ({padded_bytes} B, "
          f"padded output)")
    print(f"fedavg_packed per-leaf round (the whole call): "
          f"{t_fed[0] * 1e3:.2f} us on the device by CUDA events, "
          f"{t_fed[1] * 1e3:.2f} us a call queued from Python; host wall "
          f"with a synchronize median {1e3 * float(np.median(walls)):.3f} ms"
          f" over 20 (min {1e3 * min(walls):.3f} ms)")

    x, w, a, b = chain["operands"]
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    s = LORA["s"]
    # warm: one operand set, resident in L2; cold: rotating through
    # LORA_COLD_SETS distinct sets, more than the L2 holds
    sets = [(x, w, a, b)] + [_bf16_inputs(m, k, n, r, 300 + i, dev)
                             for i in range(LORA_COLD_SETS - 1)]
    fns = {"lora_matmul": lambda x, w, a, b: kops.lora_matmul(x, w, a, b, s),
           "matmul": lambda x, w, a, b: torch.matmul(x, w),
           "library composition": lambda x, w, a, b: torch.addmm(
               torch.matmul(x, w), torch.matmul(x, a), b, alpha=s)}
    t = {name: {"warm": _time_ms(lambda f=f: f(*sets[0]), 100),
                "cold": _time_ms(_rotating([lambda f=f, o=o: f(*o)
                                            for o in sets]), 100)}
         for name, f in fns.items()}
    t_lp = _time_ms(lambda: kref.lora_matmul_ref(x, w, a, b, s), 20)
    l_bytes = 2 * (m * k + k * n + k * r + r * n + m * n)
    l_flops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n + 2 * m * n
    b_l = _bound_ms(l_bytes, l_flops, BF16_FLOPS)
    v = t["lora_matmul"]
    print(f"lora_matmul (M, K, N, r)=({m}, {k}, {n}, {r}) bf16, path "
          f"{kops.lora_plan(m, k, n, r).path}: kernel cold "
          f"{v['cold'][0] * 1e3:.2f} us, warm {v['warm'][0] * 1e3:.2f} us on "
          f"the device ({v['cold'][1] * 1e3:.2f} us a call from Python), "
          f"plain {t_lp[0] * 1e3:.2f} us, bound {b_l[0] * 1e3:.2f} us by "
          f"{b_l[1]} ({l_flops / 1e9:.3f} GFLOP, {l_bytes} B): "
          f"{b_l[0] / v['cold'][0]:.1%} of the bound cold, "
          f"{b_l[0] / v['warm'][0]:.1%} warm")
    for name in ("matmul", "library composition"):
        u = t[name]
        what = "torch.matmul(x, W) bf16 alone" if name == "matmul" else \
            "library composition torch.addmm(torch.matmul(x, W), " \
            "torch.matmul(x, a), b, alpha=s) (three calls, context)"
        print(f"{what}: cold {u['cold'][0] * 1e3:.2f} us, warm "
              f"{u['warm'][0] * 1e3:.2f} us on the device; lora_matmul / "
              f"this: cold {v['cold'][0] / u['cold'][0]:.2f}x, warm "
              f"{v['warm'][0] / u['warm'][0]:.2f}x")
    split = kernel_split(lambda: kops.lora_matmul(x, w, a, b, s), 20)
    print("lora_matmul device time by kernel (torch.profiler, 20 warm "
          "calls): " + ", ".join(f"{name[:40]} {us:.2f} us"
                                 for name, us in split))
    # other adapter ranks at the full width, warm: the TMA path pads r to
    # 32, 64 or 128 and fills the padding with zeros
    for rr in LORA_TIMED_RANKS:
        o = _bf16_inputs(m, k, n, rr, 400 + rr, dev)
        t_r = _time_ms(lambda o=o: kops.lora_matmul(*o, s), 100)
        print(f"lora_matmul (M, K, N, r)=({m}, {k}, {n}, {rr}) warm: "
              f"{t_r[0] * 1e3:.2f} us on the device, path "
              f"{kops.lora_plan(m, k, n, rr).path}")
    return {"dequant_agg": (t_grp, t_grp_p, b_grp),
            "lora_matmul": (t["lora_matmul"]["cold"], t_lp, b_l)}


def _free_cuda() -> None:
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in fp64 on the CPU."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _move_b(train, seed: int, dev):
    """The adapters' ``b`` factors moved off their zero init (so every
    adapter takes a gradient), drawn on the CPU from ``seed``."""
    import torch
    from repro_torch.utils.tree import flatten_with_names, tree_flatten, \
        tree_unflatten
    gen = torch.Generator().manual_seed(seed)
    names = [n for n, _ in flatten_with_names(train)]
    leaves, treedef = tree_flatten(train)
    out = [t + (0.01 * torch.randn(t.shape, generator=gen)).to(dev)
           if n.endswith("/b") else t for n, t in zip(names, leaves)]
    return tree_unflatten(treedef, out)


def _serve_logits(LM, frozen, train, cfg, prompt, toks):
    """Prefill + decode steps teacher-forced with ``toks``: the logits
    (B, len(toks), V) of every generated position."""
    import torch
    with torch.no_grad():
        lp, caches, pos = LM.prefill(frozen, train, cfg, prompt,
                                     max_seq=prompt.shape[1] + toks.shape[1])
        out = [lp]
        for i in range(toks.shape[1] - 1):
            ld, caches = LM.decode_step(frozen, train, cfg, toks[:, i:i + 1],
                                        caches, pos + i)
            out.append(ld[:, 0])
    return torch.stack(out, dim=1)


def lm_bounds(cfg, params, batch: int, prompt: int, gen: int) -> dict:
    """The least times of this run's prefill and decode step on the card
    (``_bound_ms`` of the bytes each must move and the bf16 products it
    must compute). Prefill: every linear of every layer over the prompt
    tokens, the head for the last token, and the attention products a
    causal (global) or W-window (local) query needs, the 8 real heads
    only; the weights read once. A decode step: the frozen layers and the
    head, the adapters and the whole KV caches read once."""
    from repro_torch.models import lm as LM
    from repro_torch.utils.tree import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def numel(tree):
        return sum(t.numel() for t in tree_leaves(tree))

    frozen, train = params["frozen"], params["train"]
    layer_w = numel(frozen["groups"])
    head_w = numel(frozen["head"])
    adapters = numel(train)
    h, dh, t = cfg.n_heads, cfg.head_dim, batch * prompt
    attn = 0.0
    for g in LM.resolve_groups(cfg):
        for spec in g.pattern:
            keys = prompt / 2 if spec.window is None \
                else min(spec.window, prompt)
            attn += g.repeats * 4.0 * batch * h * dh * prompt * keys
    pf_flops = 2.0 * t * (layer_w + adapters) + 2.0 * batch * head_w + attn
    pf_bytes = (nbytes(frozen["groups"]) + nbytes(frozen["head"])
                + nbytes(train) + t * cfg.d_model * 2)
    s_max = prompt + gen
    kv = 0
    for g in LM.resolve_groups(cfg):
        for spec in g.pattern:
            slots = min(spec.window, s_max) if spec.window else s_max
            kv += g.repeats * 2 * batch * slots * cfg.n_kv_heads * dh * 2
    dec_bytes = nbytes(frozen["groups"]) + nbytes(frozen["head"]) \
        + nbytes(train) + kv
    dec_flops = 2.0 * batch * (layer_w + head_w + adapters)
    return {"prefill": _bound_ms(pf_bytes, pf_flops, BF16_FLOPS),
            "decode": _bound_ms(dec_bytes, dec_flops, BF16_FLOPS),
            "prefill_tflop": pf_flops / 1e12, "decode_gb": dec_bytes / 1e9,
            "frozen_values": numel(frozen)}


def lm_full_phase(dev) -> dict:
    """gemma3-4b's full published config on the card: init from a seeded
    generator, ``generate`` at batch 2 (a 1,536-token prompt, 32 new
    tokens; twice, cold and warm) and at a 16-token prompt, the decode
    logits against the teacher-forced forward, one ``loss_fn`` +
    backward on the adapters at 1 x 2,048 tokens; times and peak
    memory. Frees the model before it returns."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm as LM
    from repro_torch.serve import generate
    from repro_torch.utils.tree import flatten_with_names, tree_leaves

    c = LM_FULL
    cfg = registry.get(c["arch"]).full()
    _free_cuda()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.init(torch.Generator(device=dev).manual_seed(c["seed"]), cfg,
                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frozen, train = params["frozen"], params["train"]
    bounds = lm_bounds(cfg, params, c["batch"], c["prompt"], c["gen"])
    if bounds["frozen_values"] != LM_FULL_FROZEN or any(
            t.dtype != torch.bfloat16 for t in tree_leaves(frozen)):
        raise AssertionError(f"gemma3-4b frozen tree: "
                             f"{bounds['frozen_values']} values")
    rng = np.random.default_rng(c["seed"])
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (c["batch"], c["prompt"]))).to(dev)
    (toks0, cold), (toks, timing) = (
        generate(frozen, train, cfg, prompt, c["gen"], device=dev)
        for _ in range(2))
    same = bool(torch.equal(toks0, toks))
    logits = _serve_logits(LM, frozen, train, cfg, prompt, toks)
    if not torch.equal(torch.argmax(logits, -1).to(torch.int32), toks):
        raise AssertionError("generate's greedy tokens are not the argmax "
                             "of the replayed prefill/decode logits")
    with torch.no_grad():
        seq = torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
        h, _ = LM.forward(frozen, train, cfg, seq)
        fwd = LM._head_logits(frozen, train, cfg, h[:, c["prompt"] - 1:])
        del h
    scale = float(fwd.abs().max())
    err = float((logits - fwd).abs().max())
    agree = float((torch.argmax(fwd, -1).to(torch.int32) == toks)
                  .float().mean())
    if not (math.isfinite(err) and err <= LM_CONSIST_REL * scale):
        raise AssertionError(f"gemma3-4b decode vs forward logits: max err "
                             f"{err} > {LM_CONSIST_REL} x {scale}")
    short = torch.from_numpy(rng.integers(
        0, cfg.vocab, (c["batch"], c["short_prompt"]))).to(dev)
    stoks, stiming = generate(frozen, train, cfg, short, c["short_gen"],
                              device=dev)
    if stoks.shape != (c["batch"], c["short_gen"]) or \
            int(stoks.min()) < 0 or int(stoks.max()) >= cfg.vocab:
        raise AssertionError(f"short generate gave {stoks.shape}")
    serve_peak = torch.cuda.max_memory_allocated()
    del logits, fwd
    # one adapter backward at 1 x 2,048 tokens
    moved = _move_b(train, 1, dev)
    leaves = {n: t.detach().requires_grad_(True)
              for n, t in flatten_with_names(moved)}
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    _, treedef = tree_flatten(moved)
    tr = tree_unflatten(treedef, list(leaves.values()))
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, c["train_seq"] + 1))).to(dev)}
    train_s = []
    for _ in range(2):                 # cold (first shapes), then warm
        for t in leaves.values():
            t.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = LM.loss_fn(frozen, tr, cfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t0)
    bad = [n for n, t in leaves.items() if t.grad is None
           or not bool(torch.isfinite(t.grad).all())
           or float(t.grad.abs().max()) == 0.0]
    if not math.isfinite(float(loss.detach())) or bad:
        raise AssertionError(f"gemma3-4b backward: loss {float(loss)}, "
                             f"bad adapter grads {bad[:5]}")
    if any(t.requires_grad or t.grad is not None
           for t in tree_leaves(frozen)):
        raise AssertionError("a frozen gemma3-4b leaf took a gradient")
    peak = torch.cuda.max_memory_allocated()
    out = {"init_s": init_s, "prefill_s": timing["prefill_s"],
           "prefill_cold_s": cold["prefill_s"],
           "decode_cold_ms": 1e3 * cold["decode_s"] / cold["decode_steps"],
           "decode_ms": 1e3 * timing["decode_s"] / timing["decode_steps"],
           "short_prefill_s": stiming["prefill_s"],
           "short_decode_ms": 1e3 * stiming["decode_s"]
           / stiming["decode_steps"],
           "train_s": train_s, "loss": float(loss.detach()), "err": err,
           "scale": scale, "agree": agree, "repeat_equal": same,
           "peak_gb": (peak - base_mem) / 1e9,
           "serve_peak_gb": (serve_peak - base_mem) / 1e9,
           "bounds": bounds, "adapters": len(leaves)}
    del params, frozen, train, moved, leaves, tr, loss
    _free_cuda()
    return out


def lm_depth6_phase(dev) -> dict:
    """gemma3-4b's width at depth 6 (one 5 local : 1 global group) on the
    card and on the CPU from one tree (drawn on the card, adapters moved
    off init, copied): prefill logits, every decode step's logits
    (teacher-forced with the card's greedy tokens) and the greedy tokens
    of ``generate`` held card against CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm as LM
    from repro_torch.serve import generate
    from repro_torch.utils.tree import tree_to

    c = LM_DEPTH6
    cfg = dataclasses.replace(registry.get(LM_FULL["arch"]).full(),
                              n_layers=c["n_layers"])
    params = LM.init(torch.Generator(device=dev).manual_seed(1), cfg,
                     device=dev)
    frozen, train = params["frozen"], _move_b(params["train"], 2, dev)
    fz_cpu, tr_cpu = tree_to(frozen, "cpu"), tree_to(train, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (LM_FULL["batch"], c["prompt"])))
    toks, _ = generate(frozen, train, cfg, prompt.to(dev), c["gen"],
                       device=dev)
    t0 = time.perf_counter()
    toks_cpu, _ = generate(fz_cpu, tr_cpu, cfg, prompt, c["gen"],
                           device="cpu")
    lg_cpu = _serve_logits(LM, fz_cpu, tr_cpu, cfg, prompt, toks.cpu())
    cpu_s = time.perf_counter() - t0
    lg = _serve_logits(LM, frozen, train, cfg, prompt.to(dev), toks).cpu()
    scale = float(lg_cpu.abs().max())
    err_prefill = float((lg[:, 0] - lg_cpu[:, 0]).abs().max())
    err = float((lg - lg_cpu).abs().max())
    if not (math.isfinite(err) and err <= LM_CARD_CPU_REL * scale):
        raise AssertionError(f"depth-6 logits card vs CPU: max err {err} > "
                             f"{LM_CARD_CPU_REL} x {scale}")
    # greedy tokens: equal, except past a near tie of the CPU's logits
    same = bool(torch.equal(toks.cpu(), toks_cpu))
    for row in range(toks.shape[0]):
        diff = torch.nonzero(toks[row].cpu() != toks_cpu[row])
        if diff.numel():
            i = int(diff[0, 0])
            lgr = _serve_logits(LM, fz_cpu, tr_cpu, cfg, prompt[row:row + 1],
                                toks_cpu[row:row + 1])[0, i]
            gap = float(lgr[toks_cpu[row, i]] - lgr[toks[row, i].cpu()])
            if gap > 2 * LM_CARD_CPU_REL * scale:
                raise AssertionError(f"depth-6 greedy tokens part at row "
                                     f"{row} step {i} with a logit gap "
                                     f"{gap}")
    del params, frozen, train, fz_cpu, tr_cpu
    _free_cuda()
    return {"err_prefill": err_prefill, "err": err, "scale": scale,
            "tokens_equal": same, "cpu_s": cpu_s}


def lm_fed_phase(dev) -> dict:
    """examples/train_lm_federated.py --full on the card (lm-110m, int8,
    ``LM_FED``), the packed message's bytes against the static count,
    each round's mean client loss, and client 0's first local step
    replayed on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import messages
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch import lm_federated as fed
    from repro_torch.models import lm as LM
    from repro_torch.utils.tree import flatten_with_names, tree_map, tree_to

    c = LM_FED
    cfg = fed.make_cfg(True)
    params = LM.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    frozen, train = params["frozen"], params["train"]
    q = QuantConfig(bits=8)
    static = messages.message_wire_bytes(train, q)
    measured = {flat: messages.packed_wire_bytes(
        messages.pack_message(train, q, flat=flat)) for flat in (True, False)}
    if set(measured.values()) != {static}:
        raise AssertionError(f"lm-110m message bytes {measured} != static "
                             f"{static}")
    t0 = time.perf_counter()
    res = fed.run(frozen, train, cfg, c["rounds"], c["clients"],
                  c["local_steps"], c["batch"], c["seq"],
                  log=lambda line: print(f"lm-110m {line}"))
    wall = time.perf_counter() - t0
    losses = [r["mean_loss"] for r in res["rounds"]]
    round_s = [r["wall_s"] for r in res["rounds"]]
    if res["msg_bytes"] != static or not all(map(math.isfinite, losses)):
        raise AssertionError(f"lm-110m rounds: {losses}, "
                             f"{res['msg_bytes']} B")
    # client 0's first local step (round 1's broadcast, its first batch):
    # the run's loss, and the card's update against the CPU's
    bcast = messages.roundtrip(train, q)
    toks = fed.client_tokens(np.random.default_rng(0), cfg, 0, 1,
                             c["batch"], c["seq"])
    step = fed.make_local_train(frozen, cfg)
    got, got_loss = step(bcast, torch.from_numpy(toks).to(dev))
    fz_cpu, bc_cpu = tree_to(frozen, "cpu"), tree_to(bcast, "cpu")
    t0 = time.perf_counter()
    want, want_loss = fed.make_local_train(fz_cpu, cfg)(
        bc_cpu, torch.from_numpy(toks))
    cpu_s = time.perf_counter() - t0
    run_loss = float(res["rounds"][0]["client_losses"][0][0])
    loss_err = abs(run_loss - float(want_loss[0])) / abs(float(want_loss[0]))
    if loss_err > LM_FED_LOSS_REL or float(got_loss[0]) != run_loss:
        raise AssertionError(f"lm-110m client 0 step 1 loss: run "
                             f"{run_loss}, replay {float(got_loss[0])}, "
                             f"CPU {float(want_loss[0])}")
    upd = {}
    for (name, g), (_, w), (_, b) in zip(
            flatten_with_names(got), flatten_with_names(want),
            flatten_with_names(bc_cpu)):
        upd[name] = _rel_l2(g.cpu() - b, w - b)
    worst = max(upd.values())
    if worst > LM_FED_UPDATE_L2:
        raise AssertionError(f"lm-110m client 0 step 1 update, card vs "
                             f"CPU: {worst} relative L2 "
                             f"({max(upd, key=upd.get)})")
    del params, frozen, train, res, fz_cpu, bc_cpu
    _free_cuda()
    return {"msg_bytes": static, "losses": losses, "wall": wall,
            "round_s": round_s, "loss_err": loss_err, "update_l2": worst,
            "cpu_step_s": cpu_s}


def telemetry_phase(dev) -> dict:
    """``strict_compiles`` on the card: a serving engine at d = 2560
    (the first step of a shape may load the kernels; three steady steps
    must build nothing) and a streaming fold (every fold after the first
    under the zero-budget watchdog). Returns the builds counted."""
    import numpy as np
    import torch
    from repro_torch import serve
    from repro_torch.core import messages
    from repro_torch.core.aggregation import StreamingFlatAccumulator
    from repro_torch.core.quant import QuantConfig
    from repro_torch.obs.compile import compile_count, count_compiles

    weights, store = serve.make_store(64, d_model=SERVE["d_model"],
                                      n_layers=2, ranks=SERVE["ranks"],
                                      bits=SERVE["bits"], device=dev)
    cache = serve.AdapterCache(1 << 30, store.qcfg, device=dev)
    eng = serve.AdapterServingEngine(weights, SERVE_SCALE, store.qcfg, cache,
                                     fetch=lambda cid: store.msgs[cid],
                                     strict_compiles=True, device=dev)
    cids = list(range(8))
    eng.admit(cids)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, SERVE["d_model"])).astype(np.float32)).to(dev)
    first = eng.step(x, cids)
    with count_compiles() as steady:
        for _ in range(3):
            y = eng.step(x, cids)
    torch.cuda.synchronize()
    if steady.count != 0 or not torch.equal(y, first):
        raise AssertionError(f"strict serving steps built {steady.count} "
                             "programs or changed their result")
    gen = torch.Generator().manual_seed(3)
    trees = [{"blk": {"a": torch.randn((640, 16), generator=gen),
                      "b": torch.randn((16, 640), generator=gen)},
              "n": torch.zeros(640)} for _ in range(4)]
    msgs = [messages.pack_message({k: (v.to(dev) if k == "n" else
                                       {n: t.to(dev) for n, t in v.items()})
                                   for k, v in t.items()},
                                  QuantConfig(bits=8), flat=True)
            for t in trees]
    st = StreamingFlatAccumulator.for_layout(msgs[0].layout,
                                             strict_compiles=True,
                                             device=dev)
    st.fold(msgs[0], 1.0)
    with count_compiles() as folds:
        for m in msgs[1:]:
            st.fold(m, 1.0)
    torch.cuda.synchronize()
    if folds.count != 0 or not bool(torch.isfinite(st.acc).all()):
        raise AssertionError(f"strict streaming folds built {folds.count} "
                             "programs")
    return {"serve_builds": steady.count, "fold_builds": folds.count,
            "total_builds": compile_count()}


def lm_phase(dev, card: str) -> dict:
    """Phase 4b: the dense decoder LM at gemma3-4b's full width and depth,
    its width at depth 6 card against CPU, the federated lm-110m rounds,
    and the compile watchdog on the card. Prints each measurement with
    the card's name and power limit."""
    from repro_torch.obs.meta import run_meta
    print(f"run meta: {json.dumps(run_meta())}")
    t0 = time.perf_counter()
    full = lm_full_phase(dev)
    b = full["bounds"]
    print(f"lm gemma3-4b full (34 layers, d 2560, vocab 262144; {card}): "
          f"init {full['init_s']:.2f} s; prefill 2 x {LM_FULL['prompt']} "
          f"tokens {1e3 * full['prefill_s']:.1f} ms warm / "
          f"{1e3 * full['prefill_cold_s']:.1f} ms cold (bound "
          f"{b['prefill'][0]:.2f} ms by {b['prefill'][1]}, "
          f"{b['prefill_tflop']:.2f} TFLOP); decode "
          f"{full['decode_ms']:.3f} ms a step warm / "
          f"{full['decode_cold_ms']:.3f} cold over "
          f"{LM_FULL['gen'] - 1} steps (bound {b['decode'][0]:.3f} ms by "
          f"{b['decode'][1]}, {b['decode_gb']:.3f} GB); "
          f"{LM_FULL['short_prompt']}-token prompt: prefill "
          f"{1e3 * full['short_prefill_s']:.1f} ms, decode "
          f"{full['short_decode_ms']:.3f} ms a step; loss+backward 1 x "
          f"{LM_FULL['train_seq']} {1e3 * full['train_s'][1]:.1f} ms warm / "
          f"{1e3 * full['train_s'][0]:.1f} cold (loss "
          f"{full['loss']:.4f}, {full['adapters']} adapter leaves); peak "
          f"memory {full['peak_gb']:.2f} GB ({full['serve_peak_gb']:.2f} "
          f"serving); decode vs forward max err {full['err']:.4g} of "
          f"max|logit| {full['scale']:.4g} (tolerance {LM_CONSIST_REL}), "
          f"argmax agreement {full['agree']:.4f}, repeat generate equal "
          f"{full['repeat_equal']}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    d6 = lm_depth6_phase(dev)
    print(f"lm gemma3-4b width depth 6, card vs CPU: prefill max err "
          f"{d6['err_prefill']:.4g}, all steps {d6['err']:.4g} of "
          f"max|logit| {d6['scale']:.4g} (tolerance {LM_CARD_CPU_REL}), "
          f"greedy tokens equal {d6['tokens_equal']}; CPU side "
          f"{d6['cpu_s']:.1f} s; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fed = lm_fed_phase(dev)
    print(f"lm-110m federated ({card}): message {fed['msg_bytes']} B "
          f"(packed flat and per-leaf = static); mean client loss by round "
          f"{[round(x, 4) for x in fed['losses']]}; round walls (s) "
          f"{[round(x, 3) for x in fed['round_s']]}; client 0 step 1 vs "
          f"CPU: loss {fed['loss_err']:.3g} relative, update "
          f"{fed['update_l2']:.3g} relative L2 (CPU step "
          f"{fed['cpu_step_s']:.1f} s); {time.perf_counter() - t0:.1f} s")
    tel = telemetry_phase(dev)
    print(f"telemetry: strict_compiles serving steps {tel['serve_builds']} "
          f"builds, streaming folds {tel['fold_builds']} builds; "
          f"{tel['total_builds']} program builds in the process")
    return {"full": full, "depth6": d6, "fed": fed, "telemetry": tel}


class RecordedRoutes:
    """While open, every routing call of the port's MoE layers
    (``moe.route``) also keeps its top-k ids, call by call."""

    def __init__(self):
        self.idx: list = []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route
        moe.route = self.route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def route(self, tr, spec, xt):
        out = self.orig(tr, spec, xt)
        self.idx.append(out[1].detach().clone())
        return out


class ForcedRoutes(RecordedRoutes):
    """Teacher-forced routes: the n-th routing call takes the top-k ids
    ``want[n]`` (with its own gates at those experts) and keeps how its
    own top-k compares: the share of equal (token, slot) routes, and the
    largest relative probability gap between its own choice and the
    forced one where they part."""

    def __init__(self, want):
        super().__init__()
        self.want = list(want)
        self.agree: list = []
        self.gaps: list = []

    def route(self, tr, spec, xt):
        import torch
        gates, idx, probs = self.orig(tr, spec, xt)
        want = self.want.pop(0).to(idx.device)
        p = probs.detach()
        own = p.gather(1, idx)
        ref = torch.sort(p.gather(1, want), dim=1, descending=True).values
        self.agree.append(float((idx == want).float().mean()))
        self.gaps.append(float(((own - ref) / own).abs().max()))
        g = probs.gather(1, want)
        return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want, \
            probs

    def check(self, what: str) -> None:
        bad = [(i, a, g) for i, (a, g) in enumerate(zip(self.agree,
                                                        self.gaps))
               if a < 1.0 and g > ROUTE_TIE]
        if bad or self.want:
            raise AssertionError(f"{what}: routes part past a near tie "
                                 f"(call, agreement, gap) {bad[:4]}, "
                                 f"{len(self.want)} forced routes unused")


def moe_layers(LM, cfg) -> int:
    return sum(g.repeats * sum(s.ffn == "moe" for s in g.pattern)
               for g in LM.resolve_groups(cfg))


def no_drop(cfg):
    """``cfg`` at a MoE capacity no token drops at (factor E/k)."""
    import dataclasses
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def dropped_pairs(spec, idx) -> tuple[int, int]:
    """(routed (token, slot) pairs past their expert's capacity, experts
    that took a pair) of one routing call's ids (T, k)."""
    from repro_torch.models import moe
    counts = moe.expert_counts(idx.reshape(-1), spec.n_experts)
    cap = moe._cap(spec, idx.shape[0])
    return int((counts - cap).clamp(min=0).sum()), int((counts > 0).sum())


def moe_bounds(cfg, params, batch: int, prompt: int, gen: int,
               prefill_idx: list, decode_idx: list, kept: int) -> dict:
    """The least times of this run's prefill and decode step, as
    ``lm_bounds`` counts them, with the experts' work as this run's data
    needs it. Prefill: the non-expert linears over every prompt token,
    each KEPT (token, slot) pair through its expert's three products and
    adapters, the attention products of the real heads over the causal
    half, the head for the last tokens; every weight read once. Decode:
    every frozen and adapter value read once (the static-capacity design
    reads every expert's bank a step) and the caches; beside it the
    bound had a step read only the banks of the experts its tokens took
    (``routed``)."""
    from repro_torch.models import lm as LM
    from repro_torch.utils.tree import flatten_with_names, tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    frozen, train = params["frozen"], params["train"]
    bank_vals, bank_bytes, other = 0, 0, 0
    for name, t in flatten_with_names(frozen["groups"]):
        if "/moe/w" in name and "/moe/shared" not in name:
            bank_vals += t.numel()
            bank_bytes += t.numel() * t.element_size()
        else:
            other += t.numel()
    ad_bank, ad_other = 0, 0
    for name, t in flatten_with_names(train["groups"]):
        if "/moe/w" in name:
            ad_bank += t.numel()
        else:
            ad_other += t.numel()
    n_moe = moe_layers(LM, cfg)
    e = cfg.moe.n_experts
    per_pair = (bank_vals + ad_bank) / max(n_moe, 1) / e
    t = batch * prompt
    attn = 0.0
    for g in LM.resolve_groups(cfg):
        for spec in g.pattern:
            if spec.mixer == "mla":
                width = cfg.mla.qk_dim + cfg.mla.v_head_dim
                heads = cfg.mla.n_heads
            else:
                width, heads = 2 * cfg.head_dim, cfg.n_heads
            attn += g.repeats * 2.0 * batch * heads * width * prompt \
                * prompt / 2
    head_w = sum(x.numel() for x in tree_leaves(frozen["head"]))
    pf_flops = 2.0 * t * (other + ad_other) + 2.0 * kept * per_pair \
        + 2.0 * batch * head_w + attn
    weights = nbytes(frozen["groups"]) + nbytes(frozen["head"]) \
        + nbytes(train)
    pf_bytes = weights + t * cfg.d_model * 2
    caches = nbytes(LM.cache_init(cfg, batch, prompt + gen, device="meta"))
    dec_bytes = weights + caches
    per_expert_bytes = bank_bytes / max(n_moe, 1) / e
    took = sum(int(len(set(i.reshape(-1).tolist()))) for i in decode_idx)
    routed_bytes = weights - bank_bytes + took * per_expert_bytes + caches
    dec_flops = 2.0 * batch * (other + ad_other + head_w) \
        + 2.0 * batch * cfg.moe.top_k * n_moe * per_pair
    return {"prefill": _bound_ms(pf_bytes, pf_flops, BF16_FLOPS),
            "decode": _bound_ms(dec_bytes, dec_flops, BF16_FLOPS),
            "decode_routed": _bound_ms(routed_bytes, dec_flops, BF16_FLOPS),
            "prefill_tflop": pf_flops / 1e12, "decode_gb": dec_bytes / 1e9,
            "routed_gb": routed_bytes / 1e9, "experts_took": took,
            "frozen_values": sum(x.numel() for x in tree_leaves(frozen))}


def lm_moe_arch(arch: str, dev) -> dict:
    """One MLA/MoE arch at its published width and ``LM_MOE``'s depth:
    init from a seeded CUDA generator, ``generate`` twice (equal tokens),
    the greedy tokens the argmax of a prefill/decode replay whose routes
    give the prefill's dropped pairs, the replay at the no-drop capacity
    against the teacher-forced forward (on the forward's routes), one
    prefill and one decode step profiled, and one adapter backward; the
    times beside their bounds, the peak memory. Frees the model."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm as LM
    from repro_torch.serve import generate
    from repro_torch.utils.tree import flatten_with_names, tree_flatten, \
        tree_leaves, tree_unflatten

    c = LM_MOE
    cfg = dataclasses.replace(registry.get(arch).full(),
                              n_layers=c["depth"][arch])
    n_moe = moe_layers(LM, cfg)
    _free_cuda()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.init(torch.Generator(device=dev).manual_seed(c["seed"]), cfg,
                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    frozen, train = params["frozen"], params["train"]
    n_frozen = sum(t.numel() for t in tree_leaves(frozen))
    if n_frozen != LM_MOE_FROZEN[arch] or any(
            t.dtype != torch.bfloat16 for t in tree_leaves(frozen)):
        raise AssertionError(f"{arch} frozen tree: {n_frozen} values")
    rng = np.random.default_rng(c["seed"])
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (c["batch"], c["prompt"]))).to(dev)
    (toks0, cold), (toks, timing) = (
        generate(frozen, train, cfg, prompt, c["gen"], device=dev)
        for _ in range(2))
    same = bool(torch.equal(toks0, toks))
    with RecordedRoutes() as rec:
        logits = _serve_logits(LM, frozen, train, cfg, prompt, toks)
    if not same or not torch.equal(torch.argmax(logits, -1).to(torch.int32),
                                   toks):
        raise AssertionError(f"{arch}: generate repeated {same}, greedy "
                             "tokens not the argmax of the replay")
    if len(rec.idx) != c["gen"] * n_moe:
        raise AssertionError(f"{arch}: {len(rec.idx)} routing calls")
    drops = [dropped_pairs(cfg.moe, i) for i in rec.idx[:n_moe]]
    kept = sum(i.numel() for i in rec.idx[:n_moe]) - sum(d for d, _ in drops)
    bounds = moe_bounds(cfg, params, c["batch"], c["prompt"], c["gen"],
                        rec.idx[:n_moe], rec.idx[n_moe:2 * n_moe], kept)
    del logits
    # decode against the teacher-forced forward, both at the no-drop
    # capacity, the replay on the forward's routes
    nd = no_drop(cfg)
    with torch.no_grad(), RecordedRoutes() as fwd_rec:
        seq = torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
        h, _ = LM.forward(frozen, train, nd, seq)
        fwd = LM._head_logits(frozen, train, nd, h[:, c["prompt"] - 1:])
        del h
    want = []
    for step in range(c["gen"]):
        for layer in range(n_moe):
            r = fwd_rec.idx[layer].reshape(c["batch"], seq.shape[1], -1)
            want.append((r[:, :c["prompt"]] if step == 0 else
                         r[:, c["prompt"] + step - 1]).reshape(
                             -1, r.shape[-1]))
    with ForcedRoutes(want) as forced:
        replay = _serve_logits(LM, frozen, train, nd, prompt, toks)
    forced.check(f"{arch} decode vs forward")
    scale = float(fwd.abs().max())
    err = float((replay - fwd).abs().max())
    if not (math.isfinite(err) and err <= LM_CONSIST_REL * scale):
        raise AssertionError(f"{arch} decode vs forward logits: max err "
                             f"{err} > {LM_CONSIST_REL} x {scale}")
    del replay, fwd
    # one prefill and one decode step under the profiler
    with torch.no_grad():
        def prefill():
            return LM.prefill(frozen, train, cfg, prompt,
                              max_seq=c["prompt"] + c["gen"])
        lp, caches, pos = prefill()
        tok = torch.argmax(lp, -1)[:, None]
        LM.decode_step(frozen, train, cfg, tok, caches, pos)
        profile_call(prefill, f"{arch} prefill {c['batch']} x "
                     f"{c['prompt']}", top=8)
        profile_call(lambda: LM.decode_step(frozen, train, cfg, tok, caches,
                                            pos + 1),
                     f"{arch} decode step", top=8)
        del lp, caches
    serve_peak = torch.cuda.max_memory_allocated()
    # one adapter backward at 1 x 1,024 tokens
    moved = _move_b(train, 1, dev)
    names = [n for n, _ in flatten_with_names(moved)]
    leaves, treedef = tree_flatten(moved)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, c["train_seq"] + 1))).to(dev)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, metrics = LM.loss_fn(frozen, tree_unflatten(treedef, leaves), cfg,
                               batch)
    loss.backward()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    bad = [n for n, t in zip(names, leaves) if t.grad is None
           or not bool(torch.isfinite(t.grad).all())
           or float(t.grad.abs().max()) == 0.0]
    routers = sum(t.shape[0] for n, t in zip(names, leaves)
                  if n.endswith("router/w"))      # stacked: (repeats, d, E)
    if not math.isfinite(float(loss.detach())) or bad or routers != n_moe:
        raise AssertionError(f"{arch} backward: loss {float(loss.detach())}"
                             f", bad grads {bad[:5]}, {routers} routers")
    if any(t.requires_grad or t.grad is not None
           for t in tree_leaves(frozen)):
        raise AssertionError(f"a frozen {arch} leaf took a gradient")
    peak = torch.cuda.max_memory_allocated()
    out = {"init_s": init_s, "prefill_s": timing["prefill_s"],
           "prefill_cold_s": cold["prefill_s"],
           "decode_ms": 1e3 * timing["decode_s"] / timing["decode_steps"],
           "decode_cold_ms": 1e3 * cold["decode_s"] / cold["decode_steps"],
           "train_s": train_s, "loss": float(loss.detach()),
           "aux": float(metrics["aux"].detach()), "err": err,
           "scale": scale,
           "agree": min(forced.agree), "gap": max(forced.gaps),
           "dropped": sum(d for d, _ in drops),
           "pairs": sum(i.numel() for i in rec.idx[:n_moe]),
           "experts": [x for _, x in drops], "bounds": bounds,
           "peak_gb": (peak - base_mem) / 1e9,
           "init_peak_gb": (init_peak - base_mem) / 1e9,
           "serve_peak_gb": (serve_peak - base_mem) / 1e9,
           "frozen_gb": 2 * n_frozen / 1e9, "adapters": len(leaves),
           "n_layers": cfg.n_layers}
    del params, frozen, train, moved, leaves, loss
    _free_cuda()
    return out


def lm_moe_card_cpu(dev) -> dict:
    """deepseek-v2's width at depth 1 on the card and on the CPU from one
    tree (drawn on the card, adapters moved off init, copied), on the
    same bf16 inputs: (a) layer 0's ``moe_apply`` (routes equal, output),
    (b) its ``mla_apply`` over 1 x 64 tokens and ``mla_decode`` of token
    64 on a latent cache of the first 63, (c) the whole model's logits
    over 1 x 64 tokens, the CPU on the card's routes, with the route
    agreement."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    from repro_torch.utils.tree import tree_map, tree_to

    c = LM_MOE_CPU
    cfg = dataclasses.replace(registry.get(c["arch"]).full(),
                              n_layers=c["n_layers"])
    params = LM.init(torch.Generator(device=dev).manual_seed(1), cfg,
                     device=dev)
    frozen, train = params["frozen"], _move_b(params["train"], 2, dev)
    t0 = time.perf_counter()
    fz_cpu, tr_cpu = tree_to(frozen, "cpu"), tree_to(train, "cpu")
    copy_s = time.perf_counter() - t0
    fz0 = tree_map(lambda t: t[0], frozen["groups"][0][0])
    tr0 = tree_map(lambda t: t[0], train["groups"][0][0])
    fz0c = tree_map(lambda t: t[0], fz_cpu["groups"][0][0])
    tr0c = tree_map(lambda t: t[0], tr_cpu["groups"][0][0])
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(
        (1, c["tokens"], cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    sc = cfg.lora.scale
    out = {"copy_s": copy_s}
    t0 = time.perf_counter()
    # (a) the MoE layer
    with torch.no_grad():
        g_c, i_c, _ = MOE.route(tr0c["moe"], cfg.moe, x[0])
        g_g, i_g, _ = MOE.route(tr0["moe"], cfg.moe, x[0].to(dev))
        y_c, aux_c = MOE.moe_apply(fz0c["moe"], tr0c["moe"], cfg.moe, x, sc)
        y_g, aux_g = MOE.moe_apply(fz0["moe"], tr0["moe"], cfg.moe,
                                   x.to(dev), sc)
    if not torch.equal(i_c, i_g.cpu()):
        raise AssertionError("deepseek MoE layer routes card vs CPU: "
                             f"{float((i_c == i_g.cpu()).float().mean())}")
    out["moe"] = (float((y_g.cpu().float() - y_c.float()).abs().max()),
                  float(y_c.float().abs().max()))
    out["aux"] = (float(aux_g), float(aux_c))
    # (b) the MLA layer
    pos = torch.arange(c["tokens"])[None]
    rope_c = LM._rope_for(cfg, LM.resolve_groups(cfg)[0].pattern[0], pos)
    rope_g = tuple(r.to(dev) for r in rope_c)
    with torch.no_grad():
        mla = []
        for fza, tra, xx, rope in ((fz0c, tr0c, x, rope_c),
                                   (fz0, tr0, x.to(dev), rope_g)):
            y = A.mla_apply(fza["attn"], tra["attn"], cfg.mla, xx, sc, rope)
            ckv, kr = A._mla_latent(fza["attn"], tra["attn"], cfg.mla,
                                    xx[:, :-1], sc,
                                    tuple(r[:, :-1] for r in rope))
            cache = A.mla_cache_init(cfg.mla, 1, c["tokens"],
                                     device=xx.device)
            cache["ckv"][:, :-1] = ckv.to(torch.bfloat16)
            cache["kr"][:, :-1] = kr.to(torch.bfloat16)
            yd, cache = A.mla_decode(fza["attn"], tra["attn"], cfg.mla,
                                     xx[:, -1:], cache, c["tokens"] - 1, sc,
                                     tuple(r[:, -1:] for r in rope))
            mla.append((y.cpu().float(), yd.cpu().float(),
                        cache["ckv"].cpu().float()))
    (ya_c, yd_c, ck_c), (ya_g, yd_g, ck_g) = mla
    out["mla_apply"] = (float((ya_g - ya_c).abs().max()),
                        float(ya_c.abs().max()))
    out["mla_decode"] = (float((yd_g - yd_c).abs().max()),
                         float(yd_c.abs().max()))
    out["mla_cache"] = (float((ck_g - ck_c).abs().max()),
                        float(ck_c.abs().max()))
    # decode against apply at the last token, on each side
    out["decode_vs_apply"] = float((yd_c[:, 0] - ya_c[:, -1]).abs().max())
    # (c) the whole model at depth 1
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, c["tokens"])))
    with torch.no_grad():
        with RecordedRoutes() as rec:
            h, _ = LM.forward(frozen, train, cfg, toks.to(dev))
            lg_g = LM._head_logits(frozen, train, cfg, h).cpu()
        with ForcedRoutes([i.cpu() for i in rec.idx]) as forced:
            h, _ = LM.forward(fz_cpu, tr_cpu, cfg, toks)
            lg_c = LM._head_logits(fz_cpu, tr_cpu, cfg, h)
    forced.check("deepseek depth 1 card vs CPU")
    out["logits"] = (float((lg_g - lg_c).abs().max()),
                     float(lg_c.abs().max()))
    out["route_agree"], out["route_gap"] = forced.agree, forced.gaps
    out["cpu_s"] = time.perf_counter() - t0
    for what in ("moe", "mla_apply", "mla_decode", "mla_cache", "logits"):
        err, scale = out[what]
        if not (math.isfinite(err) and err <= LM_CARD_CPU_REL * scale):
            raise AssertionError(f"deepseek depth 1 {what} card vs CPU: "
                                 f"{err} > {LM_CARD_CPU_REL} x {scale}")
    del params, frozen, train, fz_cpu, tr_cpu, fz0, tr0
    _free_cuda()
    return out


def lm_moe_phase(dev, card: str) -> dict:
    """Phase 4c: deepseek-v2-236b and llama4-maverick-400b-a17b at their
    published widths and cut depths, and deepseek-v2's width at depth 1
    card against CPU. Launches none of the six kernels: MLA and MoE are
    plain PyTorch products, as the JAX package computes them with einsums
    outside any Pallas kernel."""
    out = {}
    for arch in LM_MOE["depth"]:
        t0 = time.perf_counter()
        r = lm_moe_arch(arch, dev)
        out[arch] = r
        b = r["bounds"]
        print(f"lm {arch} full width, depth {r['n_layers']} ({card}): "
              f"frozen {r['frozen_gb']:.2f} GB bf16, init {r['init_s']:.2f} "
              f"s (peak {r['init_peak_gb']:.2f} GB); prefill "
              f"{LM_MOE['batch']} x {LM_MOE['prompt']} "
              f"{1e3 * r['prefill_s']:.1f} ms warm / "
              f"{1e3 * r['prefill_cold_s']:.1f} cold (bound "
              f"{b['prefill'][0]:.2f} ms by {b['prefill'][1]}, "
              f"{b['prefill_tflop']:.2f} TFLOP); decode "
              f"{r['decode_ms']:.3f} ms a step warm / "
              f"{r['decode_cold_ms']:.3f} cold over {LM_MOE['gen'] - 1} "
              f"steps (bound {b['decode'][0]:.3f} ms by {b['decode'][1]}, "
              f"{b['decode_gb']:.3f} GB, every bank; "
              f"{b['decode_routed'][0]:.3f} ms, {b['routed_gb']:.3f} GB, "
              f"the {b['experts_took']} experts a step took); prefill "
              f"dropped {r['dropped']} of {r['pairs']} (token, slot) "
              f"pairs, experts taking pairs by layer {r['experts']}; "
              f"loss+backward 1 x {LM_MOE['train_seq']} "
              f"{1e3 * r['train_s']:.1f} ms (loss {r['loss']:.4f}, aux "
              f"{r['aux']:.4f}, {r['adapters']} trained leaves); peak "
              f"memory {r['peak_gb']:.2f} GB ({r['serve_peak_gb']:.2f} "
              f"serving); decode vs forward (no-drop capacity, forward's "
              f"routes) max err {r['err']:.4g} of max|logit| "
              f"{r['scale']:.4g} (tolerance {LM_CONSIST_REL}), own routes "
              f"agreeing {r['agree']:.4f} at worst, largest gap "
              f"{r['gap']:.3g}; repeat generate equal; "
              f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cc = lm_moe_card_cpu(dev)
    out["card_cpu"] = cc
    print(f"lm deepseek-v2 width depth 1, card vs CPU ({card}): moe_apply "
          f"routes equal, max err {cc['moe'][0]:.4g} of {cc['moe'][1]:.4g}, "
          f"aux {cc['aux'][0]:.6g} / {cc['aux'][1]:.6g}; mla_apply "
          f"{cc['mla_apply'][0]:.4g} of {cc['mla_apply'][1]:.4g}; "
          f"mla_decode {cc['mla_decode'][0]:.4g} of "
          f"{cc['mla_decode'][1]:.4g} (latent cache {cc['mla_cache'][0]:.4g}"
          f" of {cc['mla_cache'][1]:.4g}; decode vs apply on the CPU "
          f"{cc['decode_vs_apply']:.4g}); logits {cc['logits'][0]:.4g} of "
          f"max|logit| {cc['logits'][1]:.4g} (tolerance {LM_CARD_CPU_REL}), "
          f"CPU's own routes agreeing {cc['route_agree']}, gaps "
          f"{[round(g, 4) for g in cc['route_gap']]}; copy "
          f"{cc['copy_s']:.1f} s, CPU side {cc['cpu_s']:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s")
    return out


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
    from repro_torch.core import flat as flatcodec
    from repro_torch.core import messages
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ops as kops
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
    check_lora_sass()

    # 2. kernels vs plain versions at the main path's shapes --------------
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    model_cpu = resnet.init(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    # a client's update: every adapter moved off its init (``a`` is zero)
    update = tree_map(
        lambda p: (p + 0.02 * torch.randn(p.shape, generator=gen)).to(dev),
        model_cpu["train"])
    update18 = tree_map(
        lambda p: (p + 0.02 * torch.randn(p.shape, generator=gen)).to(dev),
        resnet.init(0, table4_cfg(), device="cpu")["train"])
    layouts, n_valid = {}, {}
    for label, tree, all_bits in (("resnet8", update, (2, 4, 8)),
                                  ("resnet18", update18, (4, 8))):
        for bits in all_bits:
            lo = flatcodec.layout_for(tree, bits)
            nv = torch.from_numpy(lo.n_valid_vec()).to(dev)
            layouts[f"{label} bits={bits}"] = (
                flatcodec.flat_rows(tree_leaves(tree), lo), nv, bits)
            n_valid[(label, bits)] = (nv, lo.nw_max)
            print(f"{label} layout bits={bits}: C_total={lo.c_total} "
                  f"N_max={lo.n_max} Nw_max={lo.nw_max} valid levels="
                  f"{int(lo.n_valid_vec().sum())}")
    err_q = check_quant_pack(layouts, dev)
    torch.cuda.synchronize()
    err_d = check_dequant_agg(*n_valid[("resnet8", 8)], dev)
    for bits in (8, 4):
        err_d = max(err_d, check_dequant_agg(
            *n_valid[("resnet18", bits)], dev, bits=bits, ks=(4,),
            label="resnet18"))
    del layouts
    torch.cuda.synchronize()
    err_mq, err_mf = check_serving_kernels(dev)
    t0 = time.perf_counter()
    err_b3 = max(check_leaf_agg(update, dev),
                 check_leaf_agg_grouped(update, dev))
    err_b6 = check_lora_matmul(dev)
    print(f"per-leaf and lora_matmul checks: "
          f"{time.perf_counter() - t0:.1f} s")

    # 3. the FL round on the card ----------------------------------------
    data = quickstart_data()
    server = make_server(resnet.init(0, cfg, device="cuda"), data, "cuda")
    static = messages.message_wire_bytes(server.global_train,
                                         QuantConfig(bits=8))
    # keep the rounds' uplinks: the per-leaf phase aggregates round 1's
    # both ways
    kops.reset_launch_counts()
    round_s = []
    with recorded(server.aggregator, "aggregate") as captured:
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
    compare_with_cpu(rec1, tree1, make_server(model_cpu, data, "cpu"),
                     "quickstart")

    # 3b. the round's options, and lora_matmul's entry point --------------
    t0 = time.perf_counter()
    leaf = leaf_round_phase(data, server.history, server, captured, dev)
    ef = ef_phase(data, model_cpu, dev)
    resumed = resume_phase(data, dev)
    chain = lora_chain_phase(dev)
    engines = engine_phase(data, dev)
    prox = fedprox_phase(data, model_cpu, dev)
    print(f"options phases: {time.perf_counter() - t0:.1f} s; launches: "
          f"per-leaf {leaf['launches']}, ef {ef['launches']}, resume "
          f"{resumed['launches']}, lora chain {chain['launches']}, fedprox "
          f"{prox['launches']}")

    # 3c. the quickstart's sparse, mixed-rank and DP modes ---------------
    t0 = time.perf_counter()
    modes = {"sparse": sparse_phase(data, model_cpu, dev),
             "hetero": hetero_phase(dev),
             "dp": dp_phase(data, model_cpu, dev)}
    print(f"quickstart modes phases: {time.perf_counter() - t0:.1f} s; "
          "round-2 walls (s): " + ", ".join(
              f"{name} {m['walls'][-1]:.4f}" for name, m in modes.items()))

    # 3d. the async engine, the million-client fleet, deadline cohorts --
    t0 = time.perf_counter()
    fleets = {"async": async_phase(dev), "fleet": fleet_phase(dev),
              "deadline": deadline_phase(data, model_cpu, dev)}
    print(f"async and fleet phases: {time.perf_counter() - t0:.1f} s; "
          f"async run {fleets['async']['wall']:.3f} s, fleet run "
          f"{fleets['fleet']['wall']:.3f} s, deadline round 2 "
          f"{fleets['deadline']['walls'][-1]:.4f} s")

    # 3e. the paper's Table IV run: ResNet-18 r=64 int8 at full width --
    t0 = time.perf_counter()
    table4 = table4_phase(dev)
    print(f"table4 phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{table4['launches']}")
    if args.profile:
        profile_round(server, "vmapped cohort engine, quickstart")
        profile_round(engines["per-client server"],
                      "make_local_trainer client by client, quickstart")
        for name, m in modes.items():
            profile_round(m["server"], f"vmapped cohort engine, {name} mode")

    # 4. the serving path on the card --------------------------------------
    t0 = time.perf_counter()
    sv = serving_phase(dev)
    print(f"serving phase: {time.perf_counter() - t0:.1f} s")

    # 4b. the dense decoder LM and the telemetry on the card ------------
    t0 = time.perf_counter()
    lm_phase(dev, card)
    print(f"lm phase: {time.perf_counter() - t0:.1f} s")
    if args.profile:
        profile_lm(dev)

    # 4c. the MLA and MoE archs at their published widths ---------------
    t0 = time.perf_counter()
    lm_moe_phase(dev, card)
    print(f"lm moe phase: {time.perf_counter() - t0:.1f} s")

    # 5. times at the paths' shapes ---------------------------------------
    t_flat = time_flat_kernels(update, k, dev, "resnet8")
    time_flat_kernels(update18, table4["k"], dev, "resnet18")
    print(f"round wall times (s): flat {[round(s, 4) for s in round_s]}, "
          f"per-leaf {[round(s, 4) for s in leaf['walls']]}, ef "
          f"{[round(s, 4) for s in ef['walls']]}, fedprox "
          f"{[round(s, 4) for s in prox['walls']]}; engine phase vmapped "
          f"{[round(s, 4) for s in engines['vmapped']]}, per-client "
          f"{[round(s, 4) for s in engines['per-client']]}; table4 "
          f"{[round(s, 4) for s in table4['walls']]}")
    t_serve = time_serving_kernels(sv, dev)
    t_leaf = time_leaf_and_lora(leaf, chain, dev)

    # B1 and B2 launch on the main path and on the modes' paths
    for m in list(modes.values()) + list(fleets.values()):
        _add_counts(launches, {key: m["launches"].get(key, 0)
                               for key in ("quant_pack_rows",
                                           "dequant_agg_rows")})
    err_q = max(err_q, modes["sparse"]["err_b1"], modes["hetero"]["err_b1"],
                fleets["async"]["err_b1"], fleets["fleet"]["err_b1"])
    err_d = max(err_d, modes["hetero"]["err_b2"], fleets["async"]["err_b2"],
                fleets["fleet"]["err_b2"])
    rows = []
    for name, t, tp, bound, err, n_launch in (
            ("quant_pack_rows", *t_flat["quant_pack_rows"], err_q,
             launches["quant_pack_rows"]),
            ("dequant_agg_rows", *t_flat["dequant_agg_rows"], err_d,
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
