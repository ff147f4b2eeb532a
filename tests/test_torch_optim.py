"""The port's optimizers and schedules against the JAX package's, from
the same numpy trees and gradients, within rtol 1e-6 (fp32 on both
sides, the same operation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "blocks": [{"b": rng.normal(size=(5,)).astype(np.float32)},
                       {"k": rng.normal(size=(2, 3, 4)).astype(np.float32)}]}


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _assert_trees(got, want, **tol):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or TOL))


def _run(jopt, topt, steps, lr=0.05):
    """``steps`` updates of each optimizer from one tree, each step's
    gradients drawn anew from numpy. Returns (jax params, jax state,
    torch params, torch state)."""
    p = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch(p)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _tree(10 + i)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, lr)
        tp, ts = topt.update(_torch(g), ts, tp, lr)
    return jp, js, tp, ts


@pytest.mark.parametrize("momentum,nesterov,weight_decay", [
    (0.0, False, 0.0), (0.0, False, 1e-2), (0.9, False, 0.0),
    (0.9, True, 0.0), (0.9, False, 1e-2), (0.9, True, 1e-2)])
def test_sgd_matches_jax(momentum, nesterov, weight_decay):
    kw = dict(momentum=momentum, nesterov=nesterov,
              weight_decay=weight_decay)
    jp, js, tp, ts = _run(joptim.sgd(**kw), toptim.sgd(**kw), 4)
    _assert_trees(tp, jp)
    assert set(ts) == set(js)
    if momentum:
        _assert_trees(ts["mu"], js["mu"])


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax(weight_decay):
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=weight_decay)
    jp, js, tp, ts = _run(joptim.adamw(**kw), toptim.adamw(**kw), 5,
                          lr=1e-2)
    _assert_trees(tp, jp)
    _assert_trees(ts["mu"], js["mu"])
    _assert_trees(ts["nu"], js["nu"])
    assert ts["count"].dtype == torch.int32 and ts["count"].shape == ()
    assert int(ts["count"]) == int(js["count"]) == 5


@pytest.mark.parametrize("max_norm", [1e3, 0.5], ids=["below", "above"])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(3)
    jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                        max_norm)
    tg, tn = toptim.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    _assert_trees(tg, jg)
    if max_norm > float(jn):
        _assert_trees(tg, g, rtol=0, atol=0)


@pytest.mark.parametrize("tensor_step", [False, True],
                         ids=["int", "tensor"])
def test_schedules_match_jax(tensor_step):
    scheds = [(joptim.constant(0.03), toptim.constant(0.03)),
              (joptim.cosine_warmup(0.1, 5, 40),
               toptim.cosine_warmup(0.1, 5, 40)),
              (joptim.cosine_warmup(0.1, 0, 10, floor=0.01),
               toptim.cosine_warmup(0.1, 0, 10, floor=0.01))]
    for jf, tf in scheds:
        for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
            want = float(jf(step))
            got = tf(torch.tensor(step) if tensor_step else step)
            if tensor_step:
                assert isinstance(got, torch.Tensor) and got.shape == ()
                assert got.dtype == torch.float32
            else:
                assert isinstance(got, float)
            np.testing.assert_allclose(float(got), want, **TOL)
