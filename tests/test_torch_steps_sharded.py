"""The LM step sharded over a device mesh (``launch/steps.py``
``build_cell(..., mesh)``, ``launch/spmd.py``) against the JAX package's
``build_cell`` and against the port's own one-card step.

* Placements: at the smoke configs, with the shapes cut as
  tests/test_dryrun_small.py cuts them, every argument leaf's placements
  (parameters, batch, optimizer state, caches) over a (2, 2, 2) mesh
  (torch's ``fake`` backend, world 8, on ``meta``) equal the JAX
  ``build_cell``'s ``in_shardings`` laid out as DTensor placements. The
  JAX side runs in a subprocess with 8 host devices (JAX fixes its
  device count at its first use), as ``eval_shape`` only. Cells: the
  four of tests/test_dryrun_small.py (minitron-4b, deepseek-v2-236b and
  mamba2-370m train at microbatch 2, gemma3-4b decode), deepseek-v2's
  train with ``seq_parallel``, seamless-m4t-medium decode, paligemma-3b
  prefill, minitron-4b prefill on the int8 base, and gemma3-4b decode at
  batch 1, where ``kv_seq`` takes both ``data`` and ``model``: there the
  reference's ``("model", "data")`` is ``("data", "model")`` here (the
  mesh order, ``launch/steps.py`` docstring), and only there. The
  reference's decode also takes the position, a replicated scalar; the
  port's fixes it when it is built.
* Values: over gloo at 4 ranks on a (2, 2) (data, model) mesh, one spawn
  running every cell, the sharded steps from the same seed-0 tree, batch
  and caches as the one-card steps (the adapters' ``b`` factors moved
  off zero, as tests/test_torch_steps.py does): train (minitron-4b and
  deepseek-v2-236b with ``seq_parallel`` off and on, deepseek-v2-236b on
  the one-card step's MoE routes, mamba2-370m and gemma3-4b
  sequence-parallel, seamless-m4t-medium, all at microbatch 2;
  minitron-4b at microbatch 4, its 2 rows over data and its MLPs
  tensor-parallel), prefill (minitron-4b,
  gemma3-4b sequence-parallel, its sliding-window layers on the whole
  sequence, paligemma-3b) and decode (gemma3-4b at batch 8 and 1,
  deepseek-v2-236b, mamba2-370m, seamless-m4t-medium; the MLPs of the
  prefill and decode steps tensor-parallel over model); mamba2-370m and
  zamba2-2.7b train at microbatch 4 (2 rows over data, the Mamba heads
  over model); each cell's rows, sequence and MLPs split where the plan
  says. Held: the loss
  within ``LOSS_REL`` (2e-3) relative; the trained tree and AdamW's
  moments within ``GRAD_L2`` (6e-2) relative L2 a leaf and the update
  (new - old) within ``UPDATE_L2`` (0.4) relative L2 a leaf (the
  tolerances of tests/test_torch_steps.py: the batch split changes only
  the order of fp32 sums, which AdamW's first step, about lr * sign(g),
  can turn into a full-lr difference on a near-zero gradient element),
  and on every leaf no gradient element whose sign the sharded step
  flips exceeds the leaf's gradient error (``flip``); gemma3-4b's
  sequence-parallel cell is held by ``flip`` instead of ``UPDATE_L2``
  (``SIGN_ONLY``: two near-zero elements of a 32-element ``q_norm``);
  logits and caches within ``SERVE_REL`` (4e-2, tests/test_torch_lm.py's
  REL) of their max: prefill runs the same row-wise arithmetic on each
  rank's rows (measured 0); split-KV decode takes each block's share of
  the softmax outside ``torch.softmax`` and adds the blocks' partial
  products, which moves a bf16 rounding by an ulp (measured up to
  3.9e-3 on seamless-m4t-medium's smoke config). Donation:
  a train step's trained tree and optimizer state and a decode step's
  caches are the arguments' local storage after the step. Each cell's
  ``head_axes`` / ``ssm_axes`` / ``vocab_axes`` / ``expert_axes`` and
  the blocks rank 0 used: the heads over model where it splits no rows
  (train at microbatch 4, prefill, gemma3-4b's sliding-window layers
  under ``seq_parallel``), the Mamba heads wherever model splits no rows
  (a decode step and a sequence-parallel step too), the vocab of the
  embedding, the head and the loss where model splits neither rows nor
  sequence, the experts of deepseek-v2-236b and
  llama4-maverick-400b-a17b in every step (their train at microbatch 4,
  prefill and batch-1 decode, on the one-card routes, are cells too).
  ``HOLDER_CELLS``: deepseek-v2-236b's prefill and train on a (pod 2,
  data 2, model 1) mesh whose 2-row dispatch chunks span 2 of the 4
  batch blocks, each dispatched by its 2 holders only (one chunk a
  rank, its capacity rows split over them), held to the one-card step
  as above. The vocab-split embedding lookup equals the whole table's
  bit for bit (bf16 and int8 base); a Mamba head block's gated norm
  equals ``rmsnorm_apply`` over the whole ``d_inner`` (exactly on
  dyadic inputs, to fp32 rounding on random ones). The split MoE
  dispatch (``moe._dispatch_split``) equals the one-rank
  ``_dispatch_chunk`` bit for bit on skewed expert ids that overflow the
  capacity, in seven layouts (``DISPATCH``). The
  exchanges' autograd Functions over each mesh axis (``spmd._AllToAll``,
  ``_ReduceScatter``: the dispatch's all-to-all, a sequence-parallel
  head block's reduce-scatter) move what they should and their
  gradients are their adjoints' (the all-to-all back, the all-gather).
* ``launch/train.py --mesh host`` runs on a one-rank gloo group with the
  one-card run's losses, and ``--mesh single`` refuses a group that is
  not 256 ranks.
* The dry run's mesh record (``dryrun_lib.run_cell(..., multi_pod=)``)
  at a smoke config: 256 and 512 chips, per-chip FLOPs below the
  one-card trace's, and the step's collectives counted."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as dist

from test_torch_sharding import spawn_ranks
from repro_torch.configs import registry as TR
from repro_torch.launch import steps as TS
from repro_torch.utils.sharding import placement_leaves, placements
from repro_torch.utils.tree import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_REL, GRAD_L2, UPDATE_L2, SERVE_REL = 2e-3, 6e-2, 0.4, 4e-2

CUT = {"train_4k": {"seq": 64, "batch": 8, "step": "train"},
       "prefill_32k": {"seq": 64, "batch": 4, "step": "prefill"},
       "decode_32k": {"seq": 128, "batch": 8, "step": "decode"},
       "decode_b1": {"seq": 128, "batch": 1, "step": "decode"}}

# (arch, shape, microbatch, seq_parallel, quantize_base)
CELLS = [("minitron-4b", "train_4k", 2, False, False),
         ("deepseek-v2-236b", "train_4k", 2, False, False),
         ("mamba2-370m", "train_4k", 2, False, False),
         ("gemma3-4b", "decode_32k", 1, False, False),
         ("deepseek-v2-236b", "train_4k", 2, True, False),
         ("seamless-m4t-medium", "decode_32k", 1, False, False),
         ("paligemma-3b", "prefill_32k", 1, False, False),
         ("minitron-4b", "prefill_32k", 1, False, True),
         ("gemma3-4b", "decode_b1", 1, False, False)]

JAX_SCRIPT = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import registry
    from repro.launch import steps as S
    registry.SHAPES.update(json.loads(sys.argv[1]))
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                ("pod", "data", "model"))
    out = []
    for arch, shape, mb, sp, q in json.loads(sys.argv[2]):
        e = registry.get(arch)
        plan = S.CellPlan(microbatch=mb, seq_parallel=sp, quantize_base=q)
        b = S.build_cell(e, shape, mesh, plan=plan, cfg_override=e.smoke())
        args = []
        for sh in b["in_shardings"]:
            leaves = jax.tree.leaves(
                sh, is_leaf=lambda x: isinstance(x, NamedSharding))
            args.append([[list(p) if isinstance(p, tuple) else p
                          for p in s.spec] for s in leaves])
        out.append({"args": args, "donate": list(b["donate"])})
    print("JSON" + json.dumps(out))
""")


@contextlib.contextmanager
def cut_shapes():
    saved = dict(TR.SHAPES)
    TR.SHAPES.update(CUT)
    try:
        yield
    finally:
        TR.SHAPES.clear()
        TR.SHAPES.update(saved)


@contextlib.contextmanager
def fake_world(world: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_shardings():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, json.dumps(CUT),
                        json.dumps(CELLS)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("JSON")][-1]
    return json.loads(line[4:])


def _spec(entry_list, decode: bool) -> tuple:
    """A JAX spec (JSON) as the port lays it out: on a decode cell the
    reference's ('model', 'data') is the mesh order ('data', 'model')."""
    out = []
    for e in entry_list:
        if isinstance(e, list):
            e = tuple(e)
            if decode and e == ("model", "data"):
                e = ("data", "model")
        out.append(e)
    return tuple(out)


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_placements_match_jax_in_shardings(jax_shardings, i):
    from torch.distributed.device_mesh import init_device_mesh
    arch, shape, mb, sp, q = CELLS[i]
    want = jax_shardings[i]
    decode = CUT[shape]["step"] == "decode"
    entry = TR.get(arch)
    with cut_shapes(), fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        plan = TS.CellPlan(microbatch=mb, seq_parallel=sp, quantize_base=q)
        b = TS.build_cell(entry, shape, mesh, plan=plan,
                          cfg_override=entry.smoke(), device="meta")
        assert tuple(b["donate"]) == tuple(want["donate"])
        wargs = want["args"]
        if decode:
            # the reference's last argument is the position, a replicated
            # scalar; the port's step fixes it when it is built
            assert wargs[-1] == [[]]
            wargs = wargs[:-1]
        assert len(b["in_placements"]) == len(wargs)
        reordered = 0
        for arg, (pls, specs) in enumerate(zip(b["in_placements"], wargs)):
            got = placement_leaves(pls)
            assert len(got) == len(specs), arg
            for j, (g, s) in enumerate(zip(got, specs)):
                w = placements(_spec(s, decode), mesh)
                assert tuple(g) == tuple(w), (arch, shape, arg, j, s)
                reordered += decode and ["model", "data"] in s
            # the DTensor arguments carry these placements
            leaves = tree_leaves(b["args"][arg])
            assert [tuple(t.placements) for t in leaves] == \
                [tuple(p) for p in got]
    # kv_seq over two axes only where the batch leaves 'data' free
    assert (reordered > 0) == (shape == "decode_b1")


# ---------------------------------------------------------------------------
# values over gloo
# ---------------------------------------------------------------------------

GLOO_CELLS = [("minitron-4b", "train_4k", 2, False, None),
              ("minitron-4b", "train_4k", 2, True, None),
              ("deepseek-v2-236b", "train_4k", 2, False, None),
              ("deepseek-v2-236b", "train_4k", 2, True, None),
              ("mamba2-370m", "train_4k", 2, True, None),
              ("seamless-m4t-medium", "train_4k", 2, False, None),
              ("minitron-4b", "train_4k", 4, False, None),
              ("minitron-4b", "prefill_32k", 1, False, None),
              ("gemma3-4b", "prefill_32k", 1, True, None),
              ("paligemma-3b", "prefill_32k", 1, False, None),
              ("gemma3-4b", "decode_32k", 1, False, None),
              ("gemma3-4b", "decode_32k", 1, False, 1),
              ("deepseek-v2-236b", "decode_32k", 1, False, None),
              ("mamba2-370m", "decode_32k", 1, False, None),
              ("seamless-m4t-medium", "decode_32k", 1, False, None),
              ("deepseek-v2-236b", "train_4k", 4, False, None),
              ("llama4-maverick-400b-a17b", "train_4k", 4, False, None),
              ("deepseek-v2-236b", "prefill_32k", 1, False, None),
              ("deepseek-v2-236b", "decode_32k", 1, False, 1),
              ("gemma3-4b", "train_4k", 2, True, None),
              ("mamba2-370m", "train_4k", 4, False, None),
              ("zamba2-2.7b", "train_4k", 4, False, None)]

# MoE cells on a (pod 2, data 2, model 1) mesh whose dispatch chunks (at
# ``chunk`` tokens, 2 rows) span 2 of the 4 batch blocks: each chunk is
# dispatched by its 2 holders only, over the step's ``holders`` mesh
# (arch, shape, microbatch, seq_parallel, batch, chunk tokens)
HOLDER_CELLS = [("deepseek-v2-236b", "prefill_32k", 1, False, None, 128),
                ("deepseek-v2-236b", "train_4k", 2, False, None, 128)]

# cells whose AdamW update is held element by element (``flip``) rather
# than by its relative L2 a leaf: gemma3-4b's sequence-parallel train
# step, whose 32-element ``q_norm`` leaves hold gradient elements of
# ~2e-7 (1e-3 of the leaf's norm), below the leaf's gradient error over
# the head blocks' reduce-scatter (~3e-6); their signs, and so AdamW's
# first step there (about lr * sign(g)), may differ, and two of 32 such
# elements give the leaf a relative L2 of 0.5. zamba2-2.7b's train step
# with its attention and Mamba heads split: its 16-element ``A_log``
# leaf (measured 0.43; its gradient within 2.6% relative L2, every other
# leaf's update within 0.28) is the same case
SIGN_ONLY = [("gemma3-4b", "train_4k", 2, True, None),
             ("zamba2-2.7b", "train_4k", 4, False, None)]

# the split MoE dispatch against the one-rank one on the same expert ids:
# (name, global rows, sequence, row axes, sequence axes, chunk tokens)
# (name, global rows, sequence, row axes, sequence axes, chunk tokens,
#  and what the split makes of it: mode, chunks held within one batch
#  block, model sharing the rank's tokens, this rank's chunks)
DISPATCH = [("rows over data and model", 4, 8, ["data", "model"], [], None,
             "a2a", False, False, 1),
            ("sequence blocks over model", 2, 8, ["data"], ["model"], None,
             "a2a", False, False, 1),
            ("model shares the rows' tokens", 2, 16, ["data"], [], None,
             "a2a", False, True, 1),
            ("every model rank all tokens", 1, 33, [], [], None,
             "rep", True, False, 1),
            ("all tokens, chunk over data", 2, 17, ["data"], [], None,
             "rep", False, False, 1),
            ("chunks within a batch block", 4, 16, ["data"], [], 16,
             "a2a", True, True, 2),
            ("chunks within rows over model", 4, 16, ["data", "model"], [],
             32, "a2a", True, False, 1)]

GLOO_BODY = """
import dataclasses
import hashlib
import time
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import registry as TR
from repro_torch.launch import spmd, steps as TS
from repro_torch.models import moe as MOE
from repro_torch.utils import pcontext
from repro_torch.utils.tree import tree_flatten, flatten_with_names
TR.SHAPES.update(json.loads(os.environ["CUT"]))
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
mesh3 = init_device_mesh("cpu", (2, 2, 1),
                         mesh_dim_names=("pod", "data", "model"))
_route = MOE.route


class Routes:
    # the one-card step's top-k, recorded call by call, then forced on
    # the sharded step's rows (a recomputation repeats its forward's)
    def __init__(self):
        self.rec, self.memo, self.force, self.i = [], {}, False, 0

    def route(self, tr, spec, xt):
        gates, idx, probs = _route(tr, spec, xt)
        key = hashlib.sha1(xt.detach().float().numpy().tobytes()).hexdigest()
        if key in self.memo:
            idx = self.memo[key]
        elif not self.force:
            self.rec.append(idx)
        else:
            idx = self.rec[self.i][pcontext.token_ids(xt.shape[0])]
            self.i += 1
        self.memo[key] = idx
        vals = probs.gather(1, idx)
        return vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9), \\
            idx, probs


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(a.norm()), 1e-30))


def rel_max(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(a.abs().max()), 1e-30))


def run_cell(mesh, arch, shape, mb, sp, batch, chunk=None):
    t0 = time.perf_counter()
    e = TR.get(arch)
    cfg = e.smoke()
    if chunk:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, max_chunk_tokens=chunk))
    plan = TS.CellPlan(microbatch=mb, seq_parallel=sp)
    u = TS.build_cell(e, shape, plan=plan, cfg_override=cfg,
                      device="cpu", batch=batch)
    s = TS.build_cell(e, shape, mesh, plan=plan, cfg_override=cfg,
                      device="cpu", batch=batch)
    g = torch.Generator().manual_seed(7)
    # b factors off zero; decode caches random; the same full values
    for (nm, a), d in zip(flatten_with_names(u["args"][1]),
                          tree_flatten(s["args"][1])[0]):
        if nm.endswith("b"):
            a.add_(0.01 * torch.randn(a.shape, generator=g))
            d.to_local().copy_(spmd.local_block(a, d.placements, mesh))
    if u["step"] == "decode":
        for a, d in zip(tree_flatten(u["args"][3:])[0],
                        tree_flatten(s["args"][3:])[0]):
            a.copy_(torch.randn(a.shape, generator=g).to(a.dtype))
            d.to_local().copy_(spmd.local_block(a, d.placements, mesh))
    old = [t.clone() for t in tree_flatten(u["args"][1])[0]]
    ptrs = [t.to_local().data_ptr() for k in s["donate"]
            for t in tree_flatten(s["args"][k])[0]]
    routes = Routes()
    MOE.route = routes.route
    try:
        uo = u["fn"](*u["args"])
        routes.force, routes.memo = True, {}
        so = s["fn"](*s["args"])
    finally:
        MOE.route = _route
    rec = {"cell": [arch, shape, sp, batch], "step": u["step"],
           "routes": len(routes.rec), "forced": routes.i,
           "axes": [list(s["batch_axes"]), list(s["seq_axes"]),
                    list(s["tp_axes"])],
           "split": [list(s["head_axes"]), list(s["expert_axes"])],
           "ssm_vocab": [list(s["ssm_axes"]), list(s["vocab_axes"])]}
    if u["step"] == "train":
        rec["loss"] = [float(uo[2]["loss"]), float(so[2]["loss"])]
        rec["l2"] = max(rel_l2(a, full(b)) for a, b in zip(
            tree_flatten(uo[:2])[0], tree_flatten(so[:2])[0])
            if a.dtype.is_floating_point)
        rec["update"] = max(rel_l2(n - o, full(m) - o) for o, n, m in zip(
            old, tree_flatten(uo[0])[0], tree_flatten(so[0])[0]))
        # the largest one-card gradient element whose sign the sharded
        # step flips, over its leaf's gradient error (at most 1: only
        # elements within the sums' rounding may flip)
        rec["flip"] = 0.0
        for a, b in zip(tree_flatten(uo[1]["mu"])[0],
                        tree_flatten(so[1]["mu"])[0]):
            a, b = a.double(), full(b).double()
            flip = torch.sign(a) != torch.sign(b)
            if flip.any():
                rec["flip"] = max(rec["flip"], float(
                    a.abs()[flip].max() / (a - b).norm()))
        rec["count"] = int(full(so[1]["count"]))
        out_ptrs = [t.to_local().data_ptr() for t in
                    tree_flatten((so[0], so[1]))[0]]
    else:
        rec["serve"] = max(rel_max(a.float(), full(b).float()) for a, b in
                           zip(tree_flatten(uo)[0], tree_flatten(so)[0])
                           if isinstance(a, torch.Tensor))
        n = len(tree_flatten(uo)[0])
        rec["n"] = [n, len(tree_flatten(so)[0])]
        out_ptrs = [t.to_local().data_ptr() for t in
                    tree_flatten(so[1])[0]] if u["step"] == "decode" else []
    rec["donated"] = ptrs == out_ptrs
    rec["log"] = {k: sorted(list(x) for x in v)
                  for k, v in s["split_log"].items()}
    rec["s"] = time.perf_counter() - t0
    return rec


results = [run_cell(mesh, *c) for c in json.loads(os.environ["CELLS"])]
holders = [run_cell(mesh3, *c) for c in json.loads(os.environ["HOLDERS"])]
dispatch = []
for name, rows, seq, axes, seq_axes, chunk, *_ in json.loads(
        os.environ["DISPATCH"]):
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.utils.sharding import tree_shardings
    spec = MOE.MoESpec(d_model=16, d_ff=32, n_experts=8, top_k=2,
                       capacity_factor=1.0,
                       max_chunk_tokens=chunk or 65536)
    g = torch.Generator().manual_seed(11)
    fz, tr = MOE.moe_init(g, spec, "lora", LoRAConfig(rank=4, alpha=8.0),
                          device="cpu")
    tr = {k: {n: (v + 0.05 * torch.randn(v.shape, generator=g)
                  if n == "b" else v) for n, v in d.items()}
          for k, d in tr.items()}
    t = rows * seq
    x = torch.randn(t, 16, generator=g).to(torch.bfloat16)
    # skewed ids: 3 of 4 tokens put expert 0 first, so its rows overflow
    idx = torch.stack([torch.randperm(8, generator=g)[:2]
                       for _ in range(t)])
    first = torch.rand(t, generator=g) < 0.75
    idx = torch.where(first[:, None] & (idx == 0), idx[:, :1], idx)
    idx[:, 0] = torch.where(first, 0, idx[:, 0])
    idx[:, 1] = torch.where(first & (idx[:, 1] == 0), 1 + (idx[:, 0] % 7),
                            idx[:, 1])
    gates = torch.softmax(torch.randn(t, 2, generator=g), -1)
    n_chunks = MOE.n_chunks_for(spec, t)
    tc = t // n_chunks
    want = torch.cat([MOE._dispatch_chunk(
        fz, tr, spec, x[i * tc:(i + 1) * tc], gates[i * tc:(i + 1) * tc],
        idx[i * tc:(i + 1) * tc], 2.0) for i in range(n_chunks)])
    pos = torch.cat([MOE.dispatch_plan(spec, idx[i * tc:(i + 1) * tc])[0]
                     for i in range(n_chunks)])
    dropped = int((pos >= MOE._cap(spec, tc)).sum())
    lfz, ltr = MOE.moe_logical(spec, "lora", False)
    dfz = TS._distribute(fz, tree_shardings(lfz, fz, mesh), mesh)
    dtr = TS._distribute(tr, tree_shardings(ltr, tr, mesh), mesh)
    ctx = spmd.LocalStep(mesh, axes, seq_axes, seq_len=seq)
    b = rows // ctx.n_rows
    s_ = seq // ctx.seq_n
    ids = ctx.token_ids(b * s_)
    with pcontext.use_local(ctx):
        lf = ctx.params({"moe": dfz})["moe"]
        lt = ctx.params({"moe": dtr})["moe"]
        sp_ = ctx.expert_split(spec, b, s_)
        got = MOE._dispatch_split(lf, lt, spec, x[ids], gates[ids],
                                  idx[ids], 2.0, sp_)
    d = (got.double() - want[ids].double()).abs().max()
    dispatch.append({"name": name, "err": float(d),
                     "scale": float(want.double().abs().max()),
                     "dropped": dropped, "mode": sp_.mode,
                     "local": sp_.local, "chunks": len(sp_.chunks),
                     "shared": sp_.shared,
                     "cap": [list(x) for x in sorted(ctx.log["capacity"])]})
adjoints = []
for ax in ("data", "model"):
    g = torch.Generator().manual_seed(5)
    xs = [torch.randn(4, 3, generator=g) for _ in range(4)]
    ys = [torch.randn(4, 3, generator=g) for _ in range(4)]
    peers = dist.get_process_group_ranks(mesh.get_group(ax))
    i = peers.index(RANK)
    x = xs[RANK].clone().requires_grad_(True)
    out = spmd._AllToAll.apply(x, mesh, ax)
    grad, = torch.autograd.grad((out * ys[RANK]).sum(), x)
    # block j of the output is peer j's block i, and back
    want = torch.cat([xs[p].chunk(2)[i] for p in peers])
    want_g = torch.cat([ys[p].chunk(2)[i] for p in peers])
    x = xs[RANK].clone().requires_grad_(True)
    out_rs = spmd._ReduceScatter.apply(x, mesh, ax, 0)
    grad_rs, = torch.autograd.grad((out_rs * ys[RANK][:2]).sum(), x)
    adjoints.append({
        "axis": ax,
        "a2a": float((out - want).abs().max()),
        "a2a_grad": float((grad - want_g).abs().max()),
        "rs": float((out_rs - sum(xs[p].chunk(2)[i] for p in peers)
                     ).abs().max()),
        "rs_grad": float((grad_rs - torch.cat(
            [ys[p][:2] for p in peers])).abs().max())})
# the vocab-split embedding lookup against the whole table's, bit for
# bit, on the bf16 and the int8 base (rows over data, vocab over model)
from repro_torch.core.lora import quantize_frozen_logical, \
    quantize_frozen_tree
from repro_torch.models import layers as L, ssm as SSM
from repro_torch.utils.sharding import tree_shardings
lookups = []
g = torch.Generator().manual_seed(3)
table = {"embed": {"w": torch.randn(64, 16, generator=g).to(
    torch.bfloat16)}}
tokens = torch.randint(0, 64, (2, 3, 40), generator=g)[
    dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["data"]]
for base in ("bf16", "int8"):
    logical = {"embed": {"w": ("vocab", "fsdp")}}
    whole = table
    if base == "int8":
        whole = quantize_frozen_tree(table)
        logical = quantize_frozen_logical(logical)
    dist_t = TS._distribute(whole, tree_shardings(logical, whole, mesh),
                            mesh)
    want = L.embed_lookup(whole["embed"], tokens)
    ctx = spmd.LocalStep(mesh, ("data",))
    with pcontext.use_local(ctx):
        got = L.embed_lookup(ctx.top(dist_t)["embed"], tokens)
    lookups.append({"base": base, "block": list(ctx.vocab_block("embed")),
                    "bits": bool(torch.equal(got.view(torch.int16),
                                             want.view(torch.int16))),
                    "dtype": str(got.dtype), "shape": list(got.shape)})
# the gated norm of a Mamba head block (8 heads of 16 channels, 4 a
# rank) against the whole d_inner's: exactly on dyadic inputs (every
# sum of squares exact in fp32, in any order), to fp32 rounding on
# random ones; and a norm over the block's channels alone differs
norms = []
g = torch.Generator().manual_seed(4)
ctx = spmd.LocalStep(mesh, ("data",))
for kind in ("dyadic", "random"):
    if kind == "dyadic":
        y = (torch.randint(-8, 9, (2, 5, 128), generator=g) / 4).to(
            torch.bfloat16)
        z = 32.0 * 2.0 ** torch.randint(0, 3, (2, 5, 128), generator=g)
        scale = 2.0 ** torch.randint(-2, 3, (128,), generator=g).float()
    else:
        y = torch.randn(2, 5, 128, generator=g)
        z = torch.randn(2, 5, 128, generator=g)
        scale = 1 + 0.1 * torch.randn(128, generator=g)
    want = SSM._gate({"norm": {"scale": scale}}, y, z)
    with pcontext.use_local(ctx):
        h0, hn = ctx.ssm_block(8)
        sl = slice(h0 * 16, (h0 + hn) * 16)
        got = SSM._gate({"norm": {"scale": scale[sl]}}, y[..., sl],
                        z[..., sl], 128)
    local = SSM._gate({"norm": {"scale": scale[sl]}}, y[..., sl],
                      z[..., sl])
    w_ = want[..., sl].double()
    norms.append({"kind": kind, "block": [h0, hn],
                  "equal": bool(torch.equal(got, want[..., sl])),
                  "rel": float((got.double() - w_).abs().max()
                               / w_.abs().max()),
                  "local_rel": float((local.double() - w_).abs().max()
                                     / w_.abs().max())})
if RANK == 0:
    json.dump({"cells": results, "holders": holders, "dispatch": dispatch,
               "adjoints": adjoints, "lookups": lookups, "norms": norms},
              open(os.path.join(OUT, "results.json"), "w"))
"""


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    out = spawn_ranks(GLOO_BODY, 4, tmp_path_factory.mktemp("steps_gloo"),
                      timeout=700, env={"CUT": json.dumps(CUT),
                                        "CELLS": json.dumps(GLOO_CELLS),
                                        "HOLDERS": json.dumps(HOLDER_CELLS),
                                        "DISPATCH": json.dumps(DISPATCH)})
    return json.load(open(out / "results.json"))


MOE_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("i", range(len(GLOO_CELLS)))
def test_sharded_step_matches_one_card(gloo_results, i):
    rec = gloo_results["cells"][i]
    arch, shape, mb, sp, batch = GLOO_CELLS[i]
    assert rec["cell"] == [arch, shape, sp, batch]
    # sequence parallelism splits the sequence over model and the rows
    # over data; else a train step's rows take model too where it
    # divides them (4 rows at microbatch 2, 2 at 4), and where model is
    # left idle the dense MLPs split over it
    rows = ["data"] if batch != 1 else []
    want = ([["data"], ["model"], []] if sp else
            [["data", "model"], [], []] if mb == 2 else
            [rows, [], ["model"]])
    assert rec["axes"] == want, rec
    # the attention heads split over model where it splits no rows (not
    # in decode; under sequence parallelism only gemma3-4b's
    # sliding-window layers), the experts wherever they divide it; rank
    # 0 holds the first block of each
    free = arch == "gemma3-4b" if sp else "model" not in want[0]
    heads = rec["step"] != "decode" and arch != "mamba2-370m" and free
    experts = arch in MOE_ARCHS
    assert rec["split"] == [["model"] if heads else [],
                            ["model"] if experts else []], rec
    if heads:
        h = 8 if arch == "minitron-4b" else 4
        assert rec["log"]["heads"] == [[h, 0, h // 2]], rec
    # the Mamba heads wherever model splits no rows (in a
    # sequence-parallel step too: a Mamba layer runs on the whole
    # sequence), the vocab where it splits neither rows nor sequence;
    # rank 0 holds the first block of each
    ssm = arch in ("mamba2-370m", "zamba2-2.7b") and \
        "model" not in want[0]
    vocab = not sp and "model" not in want[0]
    assert rec["ssm_vocab"] == [["model"] if ssm else [],
                                ["model"] if vocab else []], rec
    assert rec["log"].get("ssm_heads") == ([[8, 0, 4]] if ssm else None)
    assert rec["log"].get("vocab") == ([["embed", 512, 0, 256],
                                        ["head", 512, 0, 256]]
                                       if vocab else None), rec
    if experts:
        mode = "rep" if batch == 1 else "a2a"
        assert rec["log"]["experts"] == [[0, 4, mode, 1]], rec
    else:
        assert "experts" not in rec["log"], rec
    if rec["step"] == "train":
        lu, ls = rec["loss"]
        assert abs(ls - lu) <= LOSS_REL * abs(lu), rec
        assert rec["l2"] <= GRAD_L2, rec
        assert rec["flip"] <= 1.0, rec
        if list(GLOO_CELLS[i]) not in [list(c) for c in SIGN_ONLY]:
            assert rec["update"] <= UPDATE_L2, rec
        assert rec["count"] == 1
    else:
        assert rec["n"][0] == rec["n"][1], rec
        assert rec["serve"] <= SERVE_REL, rec
    if arch in MOE_ARCHS:
        # every MoE call of the sharded step ran on the recorded routes
        assert rec["routes"] > 0 and rec["forced"] == rec["routes"], rec
    assert rec["donated"] or rec["step"] == "prefill", rec


@pytest.mark.parametrize("i", range(len(HOLDER_CELLS)))
def test_chunks_dispatched_by_their_holders(gloo_results, i):
    """A MoE step on the (pod 2, data 2, model 1) mesh whose dispatch
    chunks span 2 of its 4 batch blocks equals the one-card step (on its
    routes): each rank dispatches only the one chunk its block holds,
    its capacity rows split over the chunk's 2 holders."""
    rec = gloo_results["holders"][i]
    arch, shape, mb, sp, batch, _ = HOLDER_CELLS[i]
    assert rec["cell"] == [arch, shape, sp, batch]
    assert rec["axes"] == [["pod", "data"], [], []], rec
    assert rec["log"]["experts"] == [[0, 8, "a2a", 1]], rec
    (first, rows, cap), = rec["log"]["capacity"]
    assert first == 0 and 2 * rows == cap, rec
    assert rec["routes"] > 0 and rec["forced"] == rec["routes"], rec
    if rec["step"] == "train":
        lu, ls = rec["loss"]
        assert abs(ls - lu) <= LOSS_REL * abs(lu), rec
        assert rec["l2"] <= GRAD_L2 and rec["update"] <= UPDATE_L2, rec
        assert rec["flip"] <= 1.0 and rec["count"] == 1, rec
        assert rec["donated"], rec
    else:
        assert rec["n"][0] == rec["n"][1], rec
        assert rec["serve"] <= SERVE_REL, rec


@pytest.mark.parametrize("base", ["bf16", "int8"])
def test_vocab_split_embedding_lookup_is_exact(gloo_results, base):
    """The embedding lookup on this rank's vocab block (rows outside it
    zero, summed over ``model``) equals the whole table's, bit for bit,
    on the bf16 and the int8 base."""
    rec = next(r for r in gloo_results["lookups"] if r["base"] == base)
    assert rec["block"] == [0, 32], rec
    assert rec["bits"] and rec["dtype"] == "torch.bfloat16", rec
    assert rec["shape"] == [3, 40, 16], rec


@pytest.mark.parametrize("kind", ["dyadic", "random"])
def test_split_gated_norm_equals_whole(gloo_results, kind):
    """A Mamba head block's gated norm (``ssm._gate`` over its channels,
    the mean square summed over ``model``) equals ``rmsnorm_apply``'s
    over the whole ``d_inner`` on those channels: exactly on dyadic
    inputs, whose sums of squares are exact in fp32 in any order, and
    to fp32 rounding on random ones. The norm over the block's channels
    alone parts from it by over 10%."""
    rec = next(r for r in gloo_results["norms"] if r["kind"] == kind)
    assert rec["block"] == [0, 4], rec
    if kind == "dyadic":
        assert rec["equal"] and rec["rel"] == 0.0, rec
    else:
        assert rec["rel"] <= 1e-6, rec
    assert rec["local_rel"] > 0.1, rec


@pytest.mark.parametrize("i", range(len(DISPATCH)))
def test_split_dispatch_matches_one_rank(gloo_results, i):
    """``moe._dispatch_split`` at 4 ranks on a (2, 2) mesh equals the
    one-rank ``_dispatch_chunk`` on the same tokens, gates and expert
    ids, bit for bit, where the capacity drops pairs (ids skewed onto
    expert 0): each rank's tokens' outputs. The layouts: rows over both
    axes, sequence blocks, model sharing a rank's tokens (the tokens
    rule), every model rank holding the same tokens (``rep``), a chunk
    across the data ranks (its capacity rows split over data) and chunks
    held within a batch block."""
    rec = gloo_results["dispatch"][i]
    name, *_, mode, local, shared, chunks = DISPATCH[i]
    assert rec["name"] == name
    assert rec["dropped"] > 0, rec
    assert rec["err"] == 0.0 and rec["scale"] > 0, rec
    assert [rec["mode"], rec["local"], rec["shared"], rec["chunks"]] == \
        [mode, local, shared, chunks], rec


@pytest.mark.parametrize("axis", ["data", "model"])
def test_exchange_functions_and_adjoints(gloo_results, axis):
    rec = next(r for r in gloo_results["adjoints"] if r["axis"] == axis)
    assert rec["a2a"] == 0.0 and rec["a2a_grad"] == 0.0, rec
    assert rec["rs"] <= 1e-6 and rec["rs_grad"] == 0.0, rec


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_train_cli_mesh_host_matches_one_card():
    from repro_torch.launch import train
    argv = ["--arch", "minitron-4b", "--smoke", "--steps", "2",
            "--device", "cpu"]
    want = train.main(argv)["losses"]
    got = train.main(argv + ["--mesh", "host"])
    assert not dist.is_initialized()
    assert np.allclose(got["losses"], want, rtol=1e-5, atol=0), (got, want)
    leaf = next(iter(got["train"]["final_norm"].values()))
    assert tuple(leaf.device_mesh.shape) == (1, 1)


def test_train_cli_mesh_refuses_a_wrong_world(tmp_path):
    from repro_torch.launch import train
    argv = ["--arch", "minitron-4b", "--smoke", "--steps", "1",
            "--device", "cpu", "--mesh", "single"]
    with pytest.raises(RuntimeError, match="256 ranks"):
        train.main(argv)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="256 ranks.*has 1"):
            train.main(argv)
    finally:
        dist.destroy_process_group()


def test_dryrun_mesh_records(monkeypatch):
    from repro_torch.launch import dryrun_lib
    e = TR.REGISTRY["minitron-4b"]
    monkeypatch.setitem(TR.REGISTRY, "minitron-4b",
                        dataclasses.replace(e, full=e.smoke))
    monkeypatch.setitem(TR.SHAPES, "train_4k",
                        {"seq": 64, "batch": 256, "step": "train"})
    one = dryrun_lib.run_cell("minitron-4b", "train_4k", save=False)
    assert one["status"] == "ok", one
    for mp, chips, name in ((False, 256, "pod16x16"),
                            (True, 512, "pod2x16x16")):
        rec = dryrun_lib.run_cell("minitron-4b", "train_4k", save=False,
                                  multi_pod=mp)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["chips"] == chips and rec["mesh"] == name
        t = rec["roofline"]
        assert 0 < t["hlo_flops_per_chip"] < one["roofline"][
            "hlo_flops_per_chip"] / 8
        assert t["n_collectives"] > 0 and rec["collective_total"] > 0
        assert rec["collectives"]["all-gather"] > 0
        assert rec["collectives"]["reduce-scatter"] > 0
        assert rec["memory"]["argument_bytes"] < \
            one["memory"]["argument_bytes"] / 8
    assert not dist.is_initialized()


def test_perf_iter_mesh_variant(monkeypatch, capsys):
    """``perf_iter --mesh single`` traces a variant's sharded step:
    ``sp_on`` splits minitron-4b's sequence over ``model``."""
    from repro_torch.launch import perf_iter
    e = TR.REGISTRY["minitron-4b"]
    monkeypatch.setitem(TR.REGISTRY, "minitron-4b",
                        dataclasses.replace(e, full=e.smoke))
    monkeypatch.setitem(TR.SHAPES, "train_4k",
                        {"seq": 64, "batch": 64, "step": "train"})
    from repro_torch.launch import dryrun_lib
    recs = []
    monkeypatch.setattr(dryrun_lib, "_append", recs.append)
    assert perf_iter.main(["--cell", "minitron-4b:train_4k", "--variant",
                           "sp_on", "--mesh", "single"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("minitron-4b x train_4k [sp_on]: ") and \
        "chips=256" in out
    assert recs[0]["seq_axes"] == ["model"] and \
        recs[0]["batch_axes"] == ["data"] and recs[0]["plan"]["seq_parallel"]
