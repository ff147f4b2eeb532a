"""The port's operation counts (``repro_torch.roofline.op_cost``) against
the JAX package's loop-aware ``analyze_hlo`` of the compiled step, on a
one-device mesh at the smoke configs: prefill of 4 x 64 tokens and a
train step of 4 x 65 tokens (one microbatch), both on ``meta`` tensors.

Prefill: exactly equal for gemma3-4b and mamba2-370m. deepseek-v2-236b
counts more by exactly its MLA layers' latent projection: the port's
``_prefill_layer`` computes ``_mla_latent`` for the cache and
``mla_apply`` computes it again, where XLA computes it once (CSE); a
latent projection is three products (the base ``x @ w``, ``x @ a`` and
``(x a) @ b``).

Train: the port counts more than the reference, and the excess is held
op by op (``EXCESS``: FLOPs of one product -> how many more of them the
port runs), so that any new drift fails. Found by matching the
multiset of the port's products against the reference's dots:

  * the cross entropy's head product, once more in the backward pass:
    ``layers.chunked_xent`` recomputes each chunk's logits
    (``torch.utils.checkpoint``), where XLA keeps them (the products of
    ``x @ w_head``, ``x @ a`` and ``(x a) @ b``);
  * the attention products, recomputed twice: ``attention_chunked``
    checkpoints each kv chunk inside the layer's checkpoint
    (``models/layers.py:127-132`` inside ``models/lm.py:358-362``), so
    the layer's recomputation runs the chunk's forward and its backward
    runs it again; XLA recomputes them once;
  * a few linears' outputs recomputed that nothing reads (the MLP's or
    the mixer's output projection: ``torch.utils.checkpoint`` re-runs
    the whole layer; ``op_cost``'s ``needed_flops`` finds them dead),
    which XLA's rematerialization leaves out in some layers;
  * fewer of one small product in the port (gemma3: 4 of the 131,072
    FLOP LoRA products; mamba2: the reference's 8 dots of 65,536 FLOPs),
    a difference of formulation, not of work.

ROADMAP A12 records the first three as work the port spends that the
reference does not."""
import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as JR
from repro.launch import steps as JS
from repro.roofline import hlo_cost as H
from repro_torch.configs import registry as TR
from repro_torch.launch import steps as TS
from repro_torch.roofline import analysis, op_cost

torch.set_num_threads(2)

CUT = {"train_4k": {"seq": 64, "batch": 4, "step": "train"},
       "prefill_32k": {"seq": 64, "batch": 4, "step": "prefill"}}

# FLOPs of one product -> (port's count) - (reference's count)
EXCESS = {
    "gemma3-4b": {134217728: 1, 8388608: 1, 1048576: 1,
                  33554432: 2, 6291456: 3, 131072: -4},
    "mamba2-370m": {134217728: 1, 8388608: 1, 1048576: 1,
                    4194304: 4, 65536: -8},
    "deepseek-v2-236b": {134217728: 1, 8388608: 1, 1048576: 1,
                         50331648: 3, 4194304: 3},
}
# deepseek-v2's prefill: its 3 MLA layers' latent projections once more
MLA_LATENT = {786432: 3, 131072: 3, 49152: 3}


def _cells(arch, shape):
    """(the reference's dots by FLOPs, the port's products by FLOPs,
    the reference's analyze_hlo FLOPs, the port's analyze_step result)."""
    je, te = JR.get(arch), TR.get(arch)
    saved = {R: dict(R.SHAPES) for R in (JR, TR)}
    for R in (JR, TR):
        R.SHAPES.update(CUT)
    try:
        mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                    ("pod", "data", "model"))
        jb = JS.build_cell(je, shape, mesh, plan=JS.CellPlan(),
                           cfg_override=je.smoke())
        tb = TS.build_cell(te, shape, plan=TS.CellPlan(),
                           cfg_override=te.smoke(), device="meta")
    finally:
        for R, s in saved.items():
            R.SHAPES.clear()
            R.SHAPES.update(s)
    with mesh:
        text = jax.jit(jb["fn"], in_shardings=jb["in_shardings"],
                       out_shardings=jb["out_shardings"]).lower(
            *jb["args"]).compile().as_text()
    port = collections.Counter()
    orig = op_cost._Counter.__torch_dispatch__

    def counted(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = orig(self, func, types, args, kwargs)
        if self.flops > before:
            port[self.flops - before] += 1
        return out

    op_cost._Counter.__torch_dispatch__ = counted
    try:
        rec = op_cost.analyze_step(tb["fn"], *tb["args"], sites=True)
    finally:
        op_cost._Counter.__torch_dispatch__ = orig
    return _hlo_dots(text), port, H.analyze_hlo(text)["flops"], rec


def _hlo_dots(text: str) -> collections.Counter:
    """The compiled program's dots by FLOPs, each times the trip counts
    of the loops around it (``analyze_hlo``'s walk)."""
    comps = H._parse(text)
    sym = {c: {op.name: op.type_str for op in ops}
           for c, ops in comps.items()}
    out = collections.Counter()

    def walk(cname, mult):
        for op in comps.get(cname, []):
            if op.kind == "dot":
                out[H._dot_flops(op, sym[cname])] += mult
            elif op.kind in ("fusion", "call"):
                m = H._CALLS_RE.search(op.line)
                if m:
                    walk(m.group(1), mult)
            elif op.kind == "while":
                body = H._BODY_RE.search(op.line).group(1)
                trips = H._TRIP_RE.search(op.line)
                walk(body, mult * (int(trips.group(1)) if trips else 1))

    entry = next(line for line in text.splitlines()
                 if line.startswith("ENTRY"))
    walk(H._COMP_HDR_RE.match(entry).group(1), 1)
    return out


def _excess(ref: collections.Counter, port: collections.Counter) -> dict:
    return {int(k): port[k] - ref[k] for k in set(ref) | set(port)
            if port[k] != ref[k]}


@pytest.mark.parametrize("arch", ["gemma3-4b", "mamba2-370m"])
def test_prefill_flops_equal_analyze_hlo(arch):
    ref, port, total, rec = _cells(arch, "prefill_32k")
    assert rec["flops"] == total > 0
    assert _excess(ref, port) == {}


def test_deepseek_prefill_flops_exceed_by_the_mla_latent():
    ref, port, total, rec = _cells("deepseek-v2-236b", "prefill_32k")
    extra = sum(k * v for k, v in MLA_LATENT.items())
    assert _excess(ref, port) == MLA_LATENT
    assert rec["flops"] == total + extra == 378_652_672
    assert extra / total < 0.008


@pytest.mark.parametrize("arch", sorted(EXCESS))
def test_train_flops_are_the_reference_plus_the_attributed_excess(arch):
    ref, port, total, rec = _cells(arch, "train_4k")
    assert _excess(ref, port) == EXCESS[arch]
    extra = sum(k * v for k, v in EXCESS[arch].items())
    assert rec["flops"] == total + extra
    phases = collections.Counter()
    for (phase, _), f in rec["by_site"].items():
        phases[phase] += f
    assert sum(phases.values()) == rec["flops"]
    assert phases["recompute"] > 0 and phases["backward"] > 0
    # what no output reads: recomputed work only (the third bullet)
    dead = sum(rec["dead_by_site"].values())
    assert rec["flops"] - rec["needed_flops"] == dead
    assert all(site[0] == "recompute" for site in rec["dead_by_site"])


def test_roofline_terms_on_one_h100():
    """The roofline from the least bytes (arguments and new outputs
    once), the eager-traffic bound from the eager bytes, each with its
    dominant term; no fusion-boundary bytes under the JAX key."""
    t = analysis.roofline_terms({"flops": 989e12, "bytes": 6.7e12,
                                 "argument_bytes": 0.5e12,
                                 "output_bytes": 0.17e12})
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(0.2)
    assert t["t_memory_eager_s"] == pytest.approx(2.0)
    assert t["t_collective_s"] == 0.0
    assert (t["dominant"], t["dominant_eager"]) == ("compute", "memory")
    assert t["hlo_flops_per_chip"] == 989e12
    assert t["hlo_bytes_per_chip"] is None
    assert (t["min_bytes_per_chip"], t["eager_bytes_per_chip"]) == (
        0.67e12, 6.7e12)
    for key in ("collective_wire_bytes_per_chip", "n_collectives"):
        assert key in t
    assert analysis.model_flops(10, 4) == 240.0
    assert analysis.model_flops(10, 4, train=False) == 80.0


def test_op_cost_counts_storages_once_and_frees():
    """Views cost nothing and share their storage; a freed temporary
    leaves the live set (the peak is the largest live sum, the
    arguments included); meta and CPU give the same counts."""
    def step(x, w):
        t = x @ w                         # new: 4 x 8 fp32
        v = t.view(-1)[:16]               # views: no bytes, no storage
        u = (t * 2.0).sum()
        del t, v
        return u + (x @ w).sum()

    recs = []
    for dev in ("cpu", "meta"):
        x = torch.ones((4, 16), device=dev)
        w = torch.ones((16, 8), device=dev)
        recs.append(op_cost.analyze_step(step, x, w))
    a, b = recs
    assert {k: a[k] for k in ("flops", "bytes", "peak_bytes", "n_ops")} == \
        {k: b[k] for k in ("flops", "bytes", "peak_bytes", "n_ops")}
    assert a["flops"] == 2 * (2 * 4 * 16 * 8)
    assert a["argument_bytes"] == (64 + 128) * 4
    assert a["output_bytes"] == 4             # the scalar returned
    # the arguments, t, t * 2 and its sum live at once; the second product
    # reuses t's freed room
    assert a["peak_bytes"] == (64 + 128 + 32 + 32 + 1) * 4
    assert "aten.view" not in a["by_op"]
    assert a["by_op"]["aten.mm"] == {"calls": 2, "flops": 2048,
                                     "bytes": 2 * (64 + 128 + 32) * 4}


def test_analyze_step_on_cpu_equals_meta():
    """The same cell traced on the CPU and on ``meta``: FLOPs, bytes and
    the peak are equal."""
    te = TR.get("gemma3-4b")
    cfg = dataclasses.replace(te.smoke(), n_layers=3)
    saved = dict(TR.SHAPES)
    TR.SHAPES.update(CUT)
    try:
        recs = [op_cost.analyze_step(b["fn"], *b["args"])
                for b in (TS.build_cell(te, "train_4k", cfg_override=cfg,
                                        device=d) for d in ("cpu", "meta"))]
    finally:
        TR.SHAPES.clear()
        TR.SHAPES.update(saved)
    for key in ("flops", "bytes", "peak_bytes", "argument_bytes"):
        assert recs[0][key] == recs[1][key], key
