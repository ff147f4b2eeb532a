"""Differential privacy on the uplink: the port against the JAX package.

``global_l2_norm`` within fp32 rounding; ``dp_privatize`` draws the JAX
package's noise draw for draw (keyed numpy, leaf by leaf in flatten
order), so the privatized trees agree within rtol 1e-6; ``DPConfig``
refuses what the JAX one refuses; ``gaussian_epsilon`` returns the same
floats (pure numpy); ``client_uplink`` privatizes the delta against its
start tree and packs the same wire bytes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flocora as jfl
from repro.core import messages as jmsg
from repro.core import quant as jq
from repro_torch.core import flocora as tfl
from repro_torch.core import messages as tmsg
from repro_torch.core import quant as tq
from repro_torch.utils.tree import flatten_with_names, tree_map

torch.set_num_threads(1)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return {"conv": {"a": r(1, 1, 4, 6), "b": r(3, 3, 5, 4)},
            "fc": {"a": r(12, 4), "b": r(4, 7)}, "norm": r(6)}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.asarray(x)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=1e-6, atol=0.0):
    for (name, g), (_, w) in zip(flatten_with_names(got),
                                 flatten_with_names(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_global_l2_norm_matches_jax(scale):
    tree = _tree(0, scale)
    np.testing.assert_allclose(float(tq.global_l2_norm(_t(tree))),
                               float(jq.global_l2_norm(_j(tree))),
                               rtol=1e-6)


@pytest.mark.parametrize("noise", [0.0, 0.3, 1.1])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0],
                         ids=["unclipped", "clipped", "clipped_hard"])
def test_dp_privatize_matches_jax(noise, scale):
    """Clip (factor min(1, C/||x||)) and noise keyed (seed, TAG_DP,
    *key): the same draws, results within rtol 1e-6 (atol 1e-7 for the
    noise added to clipped values)."""
    tree = _tree(1, scale)
    for key in [(0, 3), (5, 17, 2)]:
        jc, tc = jq.DPConfig(1.0, noise), tq.DPConfig(1.0, noise)
        want = jq.dp_privatize(_j(tree), jc, seed=7, key=key)
        got = tq.dp_privatize(_t(tree), tc, seed=7, key=key)
        _close(got, want, atol=1e-7)
    assert tq.TAG_DP == jq.TAG_DP


def test_dp_noise_is_keyed():
    tree = _t(_tree(2))
    cfg = tq.DPConfig(1.0, 0.5)
    a = tq.dp_privatize(tree, cfg, seed=0, key=(1, 2))
    b = tq.dp_privatize(tree, cfg, seed=0, key=(1, 2))
    c = tq.dp_privatize(tree, cfg, seed=0, key=(1, 3))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
        flatten_with_names(a), flatten_with_names(b)))
    assert not torch.equal(a["fc"]["a"], c["fc"]["a"])


@pytest.mark.parametrize("kw", [dict(clip_norm=0.0),
                                dict(noise_multiplier=-1.0),
                                dict(delta=0.0), dict(delta=1.0)])
def test_dp_config_refusals_match_jax(kw):
    with pytest.raises(ValueError):
        jq.DPConfig(**kw)
    with pytest.raises(ValueError):
        tq.DPConfig(**kw)


@pytest.mark.parametrize("noise,delta", [(0.3, 1e-5), (1.0, 1e-5),
                                         (2.5, 1e-6), (0.0, 1e-5)])
def test_gaussian_epsilon_equals_jax(noise, delta):
    for steps in (0, 1, 2, 3, 10, 100):
        assert tq.gaussian_epsilon(noise, steps, delta) == \
            jq.gaussian_epsilon(noise, steps, delta)


def test_quickstart_epsilon_values():
    """The quickstart's --dp 0.3 after rounds 1 and 2."""
    assert tq.gaussian_epsilon(0.3, 1) == 21.559841619903807
    assert tq.gaussian_epsilon(0.3, 2) == 33.736868528818945


@pytest.mark.parametrize("bits", [8, None])
@pytest.mark.parametrize("with_start", [True, False])
def test_client_uplink_privatizes_the_delta(bits, with_start):
    """The wire carries start + privatized(trainable - start), quantized
    afterwards: the same wire bytes as the JAX package's, the decoded
    trees within one int8 step (fp: rtol 1e-6)."""
    start, trained = _tree(3, 0.5), _tree(4, 0.5)
    jc = jfl.FLoCoRAConfig(rank=4, quant_bits=bits,
                           dp=jq.DPConfig(1.0, 0.3))
    tc = tfl.FLoCoRAConfig(rank=4, quant_bits=bits,
                           dp=tq.DPConfig(1.0, 0.3))
    kw = dict(rnd=2, dp_key=(2, 9), dp_seed=5)
    jm, _ = jfl.client_uplink(_j(trained), jc,
                              start=_j(start) if with_start else None, **kw)
    tm, _ = tfl.client_uplink(_t(trained), tc,
                              start=_t(start) if with_start else None, **kw)
    if bits is None:
        _close(tm, jm, atol=1e-7)
        return
    assert tmsg.packed_wire_bytes(tm) == jmsg.packed_wire_bytes(jm)
    want, got = jmsg.unpack_message(jm), tmsg.unpack_message(tm)
    for (name, g), (_, w) in zip(flatten_with_names(got),
                                 flatten_with_names(want)):
        w = np.asarray(w)
        step = (max(w.max(), 0) - min(w.min(), 0)) / 255 + 1e-6
        assert np.abs(g.numpy() - w).max() <= step, name
