"""The port's step builder (``repro_torch.launch.steps``) against the JAX
package's ``launch/steps.py``: the plans, the input specs of all 40
cells at the full configs, and each step kind at the smoke configs with
the shapes cut as tests/test_dryrun_small.py cuts them (train 8 x 64
tokens, decode 8 x 128 slots; prefill 4 x 64), the JAX step jitted on a
one-device mesh. Both start from one JAX ``init`` tree carried across by
``convert``, the adapters' ``b`` factors moved off zero (as
tests/test_torch_train.py does), one numpy batch and, for a decode step,
one numpy cache of random bf16 values at position ``seq - 1``.

Held: the loss within ``LOSS_REL`` (2e-3) relative, the updated train
tree and AdamW's two moments within ``GRAD_L2`` (6e-2) relative L2 a
leaf, logits and caches within ``REL`` (4e-2) of their max: the
tolerances of tests/test_torch_lm.py, which says why the two packages
part by bf16 ulps. The update itself (new - old, a leaf) is held within
``UPDATE_L2`` (0.4) relative L2 of the JAX step's, and at least one leaf
must move: AdamW's first step moves an element by about lr * sign(g), so
a near-zero gradient element whose sign differs between the packages
costs 2 lr, and the measured gaps reach 0.25 (deepseek-v2's
``norm1/scale``; 0.15-0.21 for most leaves). A skipped update parts by
1, half the learning rate by 0.5, twice it by 1. mamba2-370m's reference is compiled without XLA's
excess precision (``test_torch_lm.STRICT_BF16``). deepseek-v2-236b runs
the port on the JAX step's own routes (``test_torch_lm.RouteOracle``):
its compiled program records each MoE layer's top-k through a
``jax.debug.callback``, a microbatch's forward routes first and then
the same routes again from the backward pass's recomputation, which the
oracle's memo answers."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_lm as base
from repro.configs import registry as JR
from repro.launch import perf_iter as JP
from repro.launch import steps as JS
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.launch import perf_iter as TP
from repro_torch.launch import steps as TS
from repro_torch.optim import adamw as tadamw
from repro_torch.utils.tree import flatten_with_names, tree_leaves

torch.set_num_threads(2)

# the update (new - old) a leaf, relative L2 against the JAX step's
UPDATE_L2 = 0.4

CUT = {"train_4k": {"seq": 64, "batch": 8, "step": "train"},
       "prefill_32k": {"seq": 64, "batch": 4, "step": "prefill"},
       "decode_32k": {"seq": 128, "batch": 8, "step": "decode"}}


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", [(c["arch"], c["shape"])
                                        for c in JR.cells()])
def test_input_specs_match_jax(arch, shape):
    """Every leaf's shape and dtype, at the full config, for all 40
    cells (meta tensors against ShapeDtypeStructs)."""
    je, te = JR.get(arch), TR.get(arch)
    want = JR.input_specs(je, je.full(), shape)
    got = TR.input_specs(te, te.full(), shape)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = flatten_with_names(got)
    assert len(wl) == len(gl)
    for (path, w), (name, g) in zip(wl, gl):
        assert g.device.type == "meta", name
        assert tuple(g.shape) == tuple(w.shape), (name, path)
        assert _dtype(g) == jnp.dtype(w.dtype).name, (name, path)


def test_plans_match_jax():
    """``plan_for``'s microbatch counts, sequence parallelism and rules
    for all 40 cells, and ``DEFAULT_PLANS`` holding the JAX package's
    cells."""
    for c in JR.cells():
        a, s = c["arch"], c["shape"]
        assert TS.plan_for(a, s).microbatch == JS.plan_for(a, s).microbatch
        assert TS.plan_for(a, s).seq_parallel == \
            JS.plan_for(a, s).seq_parallel
        assert TS.plan_for(a, s).rules == JS.plan_for(a, s).rules
        assert not TS.plan_for(a, s).quantize_base
    assert set(TS.DEFAULT_PLANS) == set(JS.DEFAULT_PLANS)


def test_perf_iter_variants_match_jax():
    """Every cell's variant names, the sequence-parallel ones included,
    and the plans they set."""
    for c in JR.cells():
        a, s = c["arch"], c["shape"]
        want = JP.variants_for(a, s)
        got = TP.variants_for(a, s)
        assert list(got) == list(want), (a, s)
        for k in got:
            assert got[k].microbatch == want[k].microbatch, (a, s, k)
            assert got[k].seq_parallel == want[k].seq_parallel, (a, s, k)
            assert got[k].quantize_base == want[k].quantize_base
            gu, wu = got[k].cfg_updates or {}, want[k].cfg_updates or {}
            assert set(gu) == set(wu)
            for key in gu:
                if key == "moe":
                    assert dataclasses.asdict(gu[key]) == \
                        dataclasses.asdict(wu[key])
                else:
                    assert gu[key] == wu[key]


@contextlib.contextmanager
def cut_shapes():
    saved = {R: dict(R.SHAPES) for R in (JR, TR)}
    for R in (JR, TR):
        R.SHAPES.update(CUT)
    try:
        yield
    finally:
        for R, s in saved.items():
            R.SHAPES.clear()
            R.SHAPES.update(s)


def _mesh() -> Mesh:
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                ("pod", "data", "model"))


def _params(arch):
    """The JAX package's seed-0 smoke tree, the ``b`` factors moved."""
    entry = JR.get(arch)
    mod = JED if entry.kind == "encdec" else JLM
    p = mod.init(jax.random.PRNGKey(0), entry.smoke())
    rng = np.random.default_rng(1)
    train = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.01 * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype)
        if str(path[-1]) == "['b']" else x, p["train"])
    return p["frozen"], train


def _value(spec, rng, vocab):
    """A numpy value for one spec: tokens below ``vocab``, embeddings
    and caches N(0, 1) in bf16."""
    if jnp.issubdtype(spec.dtype, jnp.integer):
        return rng.integers(0, vocab, spec.shape).astype(np.int32)
    return np.asarray(jnp.asarray(rng.standard_normal(spec.shape),
                                  spec.dtype))


def _to_torch(tree):
    return convert.params_from_jax(jax.device_get(tree), "cpu")


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), base._np(b).astype(np.float64)
    assert a.shape == b.shape and np.isfinite(b).all()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _close_tree(got, want):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        base._close(g, np.asarray(w, np.float32))


def _run(arch, shape, microbatch=1):
    """(JAX outputs, port outputs, the train tree they began from) of
    one cell's step from one state."""
    je, te = JR.get(arch), TR.get(arch)
    jc, tc = je.smoke(), te.smoke()
    jplan = JS.CellPlan(microbatch=microbatch)
    tplan = TS.CellPlan(microbatch=microbatch)
    routes = []
    with cut_shapes():
        mesh = _mesh()
        jb = JS.build_cell(je, shape, mesh, plan=jplan, cfg_override=jc)
        tb = TS.build_cell(te, shape, plan=tplan, cfg_override=tc,
                           device="cpu")
    frozen, train = _params(arch)
    rng = np.random.default_rng(2)
    vals = [_value(s, rng, jc.vocab) for s in jax.tree.leaves(jb["args"])]
    treedef = jax.tree.structure(jb["args"])
    args = jax.tree.unflatten(treedef, vals)
    step = CUT[shape]["step"]
    if step == "train":
        opt = jadamw(weight_decay=0.0).init(train)
        jargs = (frozen, train, opt) + tuple(args[3:])
    elif step == "decode":
        jargs = (frozen, train) + tuple(args[2:-1]) + (
            jnp.asarray(CUT[shape]["seq"] - 1, jnp.int32),)
    else:
        jargs = (frozen, train) + tuple(args[2:])
    compiler = base._STRICT if arch in base.STRICT_BF16 else None
    ctx = base.jax_routes(routes) if getattr(jc, "moe", None) else \
        contextlib.nullcontext()
    with ctx, mesh:
        fn = jax.jit(jb["fn"], in_shardings=jb["in_shardings"],
                     out_shardings=jb["out_shardings"],
                     compiler_options=compiler)
        jout = jax.device_get(fn(*jargs))
    targs = tuple(_to_torch(a) for a in jargs[:2])
    if step == "train":
        targs += (tadamw(weight_decay=0.0).init(targs[1]),)
        targs += tuple(_to_torch(a) for a in jargs[3:])
    else:
        targs += tuple(_to_torch(a) for a in jargs[2:len(tb["args"])])
    if routes:
        n = base.n_moe(tc)
        fwd = [r for i in range(microbatch)
               for r in routes[2 * n * i: 2 * n * i + n]]
        assert len(routes) == 2 * n * microbatch
        with base.forced_routes(fwd) as oracle:
            tout = tb["fn"](*targs)
        assert len(oracle.check()) == n * microbatch
    else:
        tout = tb["fn"](*targs)
    return jout, tout, jax.device_get(train)


def _check_train(jout, tout, start):
    """``start``: the train tree both steps began from."""
    (jtr, jopt, jm), (ttr, topt, tm) = jout, tout
    lj, lt = float(jm["loss"]), float(tm["loss"])
    assert abs(lt - lj) <= base.LOSS_REL * abs(lj), (lt, lj)
    assert int(topt["count"]) == int(jopt["count"]) == 1
    for got, want in ((ttr, jtr), (topt["mu"], jopt["mu"]),
                      (topt["nu"], jopt["nu"])):
        names = [n for n, _ in flatten_with_names(got)]
        for nm, w, g in zip(names, jax.tree.leaves(want), tree_leaves(got)):
            assert _rel_l2(w, g) <= base.GRAD_L2, nm
    # the update itself, new - old a leaf: a skipped step, half or twice
    # the learning rate part from the JAX step's by 1, 0.5 or 1
    names = [n for n, _ in flatten_with_names(ttr)]
    moved = 0
    for nm, old, w, g in zip(names, jax.tree.leaves(start),
                             jax.tree.leaves(jtr), tree_leaves(ttr)):
        old = np.asarray(old, np.float64)
        dw = np.asarray(w, np.float64) - old
        dg = base._np(g).astype(np.float64) - old
        moved += bool(np.any(dw))
        assert _rel_l2(dw, dg) <= UPDATE_L2, nm
    assert moved


def test_gemma3_decode_step_matches_jax():
    """One decode step at position 127 of a 128-slot cache: past the
    smoke config's 8-slot window, so its ring layers write slot 7."""
    (jl, jc), (tl, tc), _ = _run("gemma3-4b", "decode_32k")
    base._close(tl, jl)
    _close_tree(tc, jc)


def test_paligemma_prefill_step_matches_jax():
    """The prefix-LM's prefill: ``prefix_embed`` before 4 x (64 -
    prefix) tokens."""
    (jl, jc, jp), (tl, tc, tp), _ = _run("paligemma-3b", "prefill_32k")
    assert tp == int(jp) == 64
    base._close(tl, jl)
    _close_tree(tc, jc)


def test_seamless_prefill_step_matches_jax():
    """``encode`` then ``cross_cache``: the cross K/V of every decoder
    layer."""
    jout, tout, _ = _run("seamless-m4t-medium", "prefill_32k")
    _close_tree(tout, jout)


def test_seamless_decode_step_matches_jax():
    (jl, jc), (tl, tc), _ = _run("seamless-m4t-medium", "decode_32k")
    base._close(tl, jl)
    _close_tree(tc, jc)


def test_build_cell_on_meta_allocates_nothing():
    """A full-size cell's step on ``meta``: the params, the optimizer
    state and the microbatched batch hold shapes only, and the batch is
    cut to the given rows."""
    te = TR.get("gemma3-4b")
    b = TS.build_cell(te, "train_4k", device="meta", batch=8)
    assert b["plan"].microbatch == 4 and b["batch"] == 8
    leaves = [t for a in b["args"] for t in tree_leaves(a)]
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert tuple(b["args"][3]["tokens"].shape) == (4, 2, 4097)
    with pytest.raises(ValueError, match="microbatches"):
        TS.build_cell(te, "train_4k", device="meta", batch=6)
