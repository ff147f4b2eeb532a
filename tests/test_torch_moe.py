"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py`` on identical inputs: the capacity, the
sort-based dispatch with its dropped pairs (given gates and ids), the
router's top-k on exact ties, ``moe_apply`` whole and token-chunked
(values, the aux loss and the gradients), and the k-slot combine
bit-identical from run to run.

Tolerances. Given the same routes, both packages compute the banks in
bf16 with fp32 accumulation and round at the same points, so the
dispatch's output is held within 1e-2 of max|y| (a bf16 ulp is 2^-8
relative; a product rounded on another order of its sums can move one
ulp, which the following bf16 products carry). The JAX functions run
op by op: compiled, XLA keeps fused bf16 chains in fp32 and the two part
by up to 1.1e-2 of max|y| (tests/test_torch_lm.py). The router, its softmax,
the gates and the aux loss are fp32 in both: rtol 1e-5. Gradients:
6e-2 relative L2 a leaf (below)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lora import LoRAConfig as JLoRA
from repro.models import moe as JMOE
from repro_torch import convert
from repro_torch.core import lora as tlora
from repro_torch.core.lora import LoRAConfig as TLoRA
from repro_torch.models import moe as TMOE
from repro_torch.utils.tree import flatten_with_names, tree_leaves, tree_map

torch.set_num_threads(2)

Y_REL = 1e-2
F32_RTOL = 1e-5
GRAD_L2 = 6e-2
SCALE = 16.0


def _specs(**kw):
    base = dict(d_model=32, d_ff=48, n_experts=8, top_k=2, n_shared=1)
    base.update(kw)
    return JMOE.MoESpec(**base), TMOE.MoESpec(**base)


def _t(x):
    return convert.params_from_jax(jax.device_get(x), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _params(jspec, seed=0):
    """JAX-initialized (frozen, train), ``b`` moved off zero, and the
    port's copies."""
    fz, tr = jax.jit(lambda key: JMOE.moe_init(
        key, jspec, "lora", JLoRA(rank=4, alpha=64.0)))(
            jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    tr = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 * jnp.asarray(rng.standard_normal(x.shape),
                                            x.dtype)
        if str(p[-1]) == "['b']" else x, tr)
    return fz, tr, _t(fz), _t(tr)


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16)


def _close(got, want, rel=Y_REL) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)
    return err


def _ref_pos(spec, idx):
    """The reference's dispatch positions (``moe.py:142-152``, restated
    in jnp): each (token, slot) pair's row in its expert's buffer."""
    t, k = idx.shape
    flat_e = jnp.asarray(idx).reshape(t * k)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.bincount(flat_e, length=spec.n_experts)
    offsets = jnp.cumsum(counts) - counts
    pos_sorted = jnp.arange(t * k) - offsets[se]
    pos = jnp.zeros(t * k, jnp.int32).at[order].set(pos_sorted)
    return np.asarray(pos).reshape(t, k)


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 4.0])
def test_cap_matches_jax(cf):
    for e, k in ((8, 1), (8, 2), (160, 6), (128, 1)):
        js, ts = _specs(n_experts=e, top_k=k, capacity_factor=cf)
        for t in (1, 2, 7, 30, 64, 1024, 2048, 65536):
            assert TMOE._cap(ts, t) == JMOE._cap(js, t), (e, k, t)


def _skewed_routes(t, k, e, seed):
    """Distinct experts a token, half the pairs on experts 0 and 1, so
    those overflow a small capacity."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    hot = rng.random(t) < 0.6
    idx[hot, 0] = 0
    if k > 1:
        idx[hot, 1] = np.where(idx[hot, 1] == 0, 1, idx[hot, 1])
    gates = rng.random((t, k)).astype(np.float32)
    return idx.astype(np.int32), gates / gates.sum(1, keepdims=True)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "sqrelu", "gelu"])
@pytest.mark.parametrize("k", [1, 2, 6], ids=lambda k: f"top{k}")
def test_dispatch_chunk_matches_jax(kind, k):
    """Given gates and ids (collisions past capacity): the dropped pairs
    are the reference's, the output its output."""
    js, ts = _specs(mlp_kind=kind, top_k=k)
    fz, tr, tfz, ttr = _params(js)
    t = 40
    idx, gates = _skewed_routes(t, k, js.n_experts, seed=k)
    xj, xt = _x((t, js.d_model), seed=3)
    yj = JMOE._dispatch_chunk(fz, tr, js, xj, jnp.asarray(gates),
                              jnp.asarray(idx), SCALE)
    yt = TMOE._dispatch_chunk(tfz, ttr, ts, xt, torch.from_numpy(gates),
                              torch.from_numpy(idx).long(), SCALE)
    pos, src, cap = TMOE.dispatch_plan(ts, torch.from_numpy(idx).long())
    assert cap == JMOE._cap(js, t)
    np.testing.assert_array_equal(pos.numpy(), _ref_pos(js, idx))
    dropped = pos.numpy() >= cap
    assert dropped.any() and not dropped.all()
    # each buffer row holds the token the reference put there
    for e in range(js.n_experts):
        for c in range(cap):
            hit = np.argwhere((idx == e) & (pos.numpy() == c))
            assert int(src[e, c]) == (int(hit[0, 0]) if len(hit) else -1)
    assert yt.dtype == torch.bfloat16
    _close(yt, yj)


def test_router_top_k_ties_take_the_lower_index():
    """Exact ties in the probabilities (equal router columns): the
    port's top-k is ``jax.lax.top_k``'s, the lower expert first."""
    js, ts = _specs(top_k=2)
    fz, tr, tfz, ttr = _params(js)
    w = np.array(tr["router"]["w"])
    for a, b in ((0, 5), (2, 3), (4, 6), (1, 7)):
        w[:, b] = w[:, a]
    tr = dict(tr, router={"w": jnp.asarray(w)})
    ttr = dict(ttr, router={"w": torch.from_numpy(w)})
    xj, xt = _x((32, js.d_model), seed=4)
    probs = jax.nn.softmax(xj.astype(jnp.float32) @ tr["router"]["w"], -1)
    gj, ij = jax.lax.top_k(probs, js.top_k)
    gt, it, pt = TMOE.route(ttr, ts, xt)
    pnp = pt.numpy()
    assert (pnp[:, 0] == pnp[:, 5]).all() and (pnp[:, 2] == pnp[:, 3]).all()
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(pnp, np.asarray(probs), rtol=F32_RTOL)
    gj = gj / jnp.maximum(gj.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=F32_RTOL)
    # a tied pair inside the top-k: the lower index first
    both = 0
    for a, b in ((0, 5), (2, 3), (4, 6), (1, 7)):
        for sel in it.numpy().tolist():
            if a in sel and b in sel:
                both += 1
                assert sel.index(a) < sel.index(b), sel
    assert both > 0
    yj, auxj = JMOE.moe_apply(fz, tr, js, xj.reshape(2, 16, -1), SCALE)
    yt, auxt = TMOE.moe_apply(tfz, ttr, ts, xt.reshape(2, 16, -1), SCALE)
    _close(yt, yj)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=F32_RTOL)


CHUNKINGS = {"whole": ((2, 16), 65536), "chunks30_by8": ((2, 15), 8),
             "chunks24_by5": ((3, 8), 5)}


def _apply_case(chunking, k):
    shape, max_chunk = CHUNKINGS[chunking]
    js, ts = _specs(top_k=k, max_chunk_tokens=max_chunk)
    t = shape[0] * shape[1]
    first = -(-t // max_chunk)
    n = TMOE.n_chunks_for(ts, t)
    assert t % n == 0 and (n > first) == (max_chunk < t)
    return (js, ts, *_params(js, seed=k),
            *_x((*shape, js.d_model), seed=5))


@pytest.mark.parametrize("chunking", list(CHUNKINGS))
@pytest.mark.parametrize("k", [1, 2])
def test_moe_apply_matches_jax(chunking, k):
    """Whole and token-chunked (30 tokens by 8: the chunk count moves
    from 4 to 5; 24 by 5: from 5 to 6): routes, output and aux."""
    js, ts, fz, tr, tfz, ttr, xj, xt = _apply_case(chunking, k)
    t = xt.shape[0] * xt.shape[1]
    yj, auxj = JMOE.moe_apply(fz, tr, js, xj, SCALE)
    yt, auxt = TMOE.moe_apply(tfz, ttr, ts, xt, SCALE)
    # the routes: the reference's top-k on the same input
    probs = jax.nn.softmax(
        xj.reshape(t, -1).astype(jnp.float32) @ tr["router"]["w"], -1)
    _, ij = jax.lax.top_k(probs, k)
    np.testing.assert_array_equal(
        TMOE.route(ttr, ts, xt.reshape(t, -1))[1].numpy(), np.asarray(ij))
    _close(yt, yj)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=F32_RTOL)


@pytest.mark.parametrize("chunking,k", [("whole", 2), ("chunks30_by8", 1)])
def test_moe_apply_gradients_match_jax(chunking, k):
    """Every adapter's and the router's gradient, the chunked path
    recomputing each chunk in the backward pass. The JAX side is
    compiled (op by op it takes seconds a shape), so the bf16 chains
    part as in the whole-model tests: tests/test_torch_lm.py's 6e-2
    relative L2 a leaf."""
    js, ts, fz, tr, tfz, ttr, xj, xt = _apply_case(chunking, k)
    wj = np.random.default_rng(6).standard_normal(xt.shape).astype(
        np.float32)

    def jloss(tr_):
        y, aux = JMOE.moe_apply(fz, tr_, js, xj, SCALE)
        return jnp.sum(y.astype(jnp.float32) * wj) + aux

    gj = jax.jit(jax.grad(jloss))(tr)
    tt = tree_map(lambda a: a.clone().requires_grad_(True), ttr)
    yt, auxt = TMOE.moe_apply(tfz, tt, ts, xt, SCALE)
    loss = (yt.float() * torch.from_numpy(wj)).sum() + auxt
    gt = torch.autograd.grad(loss, tree_leaves(tt))
    names = [n for n, _ in flatten_with_names(tt)]
    assert len(names) == len(jax.tree.leaves(gj)) == 13
    for nm, a, b in zip(names, jax.tree.leaves(gj), gt):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and np.abs(a).max() > 0, nm
        rel = np.linalg.norm(a - b) / np.linalg.norm(a)
        assert rel <= GRAD_L2, (nm, rel)


def test_combine_bit_identical_run_to_run():
    """Top-6 of 16 experts, every expert past its capacity: two calls
    give the same bits (the k-slot fold has no colliding index)."""
    js, ts = _specs(n_experts=16, top_k=6, capacity_factor=0.5)
    _, _, tfz, ttr = _params(js)
    idx, gates = _skewed_routes(96, 6, 16, seed=7)
    _, xt = _x((96, js.d_model), seed=8)
    args = (tfz, ttr, ts, xt, torch.from_numpy(gates),
            torch.from_numpy(idx).long(), SCALE)
    pos, _, cap = TMOE.dispatch_plan(ts, torch.from_numpy(idx).long())
    assert bool((pos >= cap).any())
    assert torch.equal(TMOE._dispatch_chunk(*args),
                       TMOE._dispatch_chunk(*args))


def test_moe_init_tree_matches_jax():
    """Leaves, shapes and dtypes of a stacked layer (router fp32 dense,
    banks (*stack, E, d, f) bf16, adapters (*stack, E, d, r) /
    (*stack, E, r, f) fp32, the shared experts one wide MLP)."""
    for kind in ("swiglu", "gelu"):
        js, ts = _specs(mlp_kind=kind, n_shared=2)
        jf, jt = jax.eval_shape(lambda key: JMOE.moe_init(
            key, js, "lora", JLoRA(rank=4, alpha=64.0), stack=(3,)),
            jax.random.PRNGKey(0))
        tf, tt = TMOE.moe_init(torch.Generator().manual_seed(0), ts, "lora",
                               TLoRA(rank=4, alpha=64.0), stack=(3,),
                               device="cpu")
        for got, want in ((tf, jf), (tt, jt)):
            got = dict(flatten_with_names(got))
            want = {n: (tuple(a.shape), np.dtype(a.dtype).name)
                    for n, a in flatten_with_names(_names(want))}
            assert got.keys() == want.keys()
            for key in want:
                assert (tuple(got[key].shape),
                        str(got[key].dtype).split(".")[1]) == want[key], key


def _names(tree):
    """A JAX tree of ShapeDtypeStructs as nested dicts the port's
    ``flatten_with_names`` walks."""
    if isinstance(tree, dict):
        return {k: _names(v) for k, v in tree.items()}
    return tree


def test_large_leaves_draw_slice_by_slice(monkeypatch):
    """Past ``_DRAW_WHOLE`` values a leaf is drawn one (d_in, d_out)
    slice at a time: the same draws as those slices drawn in turn,
    in the leaf's dtype, N(0, std²); at or below it the whole draw is
    unchanged."""
    shape, std = (2, 3, 64, 48), 0.5
    whole = tlora._normal(torch.Generator().manual_seed(0), shape, std,
                          torch.bfloat16, "cpu")
    gen = torch.Generator().manual_seed(0)
    want = (torch.randn(shape, generator=gen) * std).to(torch.bfloat16)
    assert torch.equal(whole, want)
    monkeypatch.setattr(tlora, "_DRAW_WHOLE", 64 * 48)
    got = tlora._normal(torch.Generator().manual_seed(0), shape, std,
                        torch.bfloat16, "cpu")
    gen = torch.Generator().manual_seed(0)
    want = torch.stack([(torch.randn(shape[-2:], generator=gen) * std)
                        for _ in range(6)]).reshape(shape).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert abs(float(got.float().std()) - std) < 0.05


def test_moe_spec_fields_match_jax():
    assert [f.name for f in dataclasses.fields(TMOE.MoESpec)] == \
        [f.name for f in dataclasses.fields(JMOE.MoESpec)]
    assert TMOE.MoESpec(1, 1, 1, 1) == TMOE.MoESpec(
        **dataclasses.asdict(JMOE.MoESpec(1, 1, 1, 1)))
