"""The tree algebra of ``repro_torch.utils.tree`` (``tree_map_with_path``,
``tree_zeros_like``, ``tree_add``, ``tree_sub``, ``tree_scale``,
``tree_weighted_sum``, exported by ``repro_torch.utils`` as the JAX
package's ``repro.utils`` exports them) and the paper's ResNet configs
(``configs/resnet_paper.py``) against the JAX package's. fp32 leaves:
the same operations in the same dtype, held within rtol 1e-6 (the
weighted sum may add its K terms in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils as JU
import repro_torch.utils as TU
from repro.configs import resnet_paper as JRP
from repro_torch.configs import resnet_paper as TRP


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"blk": {"a": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": rng.standard_normal((4,)).astype(np.float32)},
            "layers": [rng.standard_normal((2, 2)).astype(np.float32),
                       rng.standard_normal((5,)).astype(np.float32)],
            "n": rng.standard_normal(()).astype(np.float32)}


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return TU.tree_map(torch.from_numpy, tree)


def _same(got, want, rtol=1e-6):
    gl = TU.flatten_with_names(got)
    wl = JU.flatten_with_names(want)
    assert [n for n, _ in gl] == [n for n, _ in wl]
    for (n, g), (_, w) in zip(gl, wl):
        assert isinstance(g, torch.Tensor), n
        assert tuple(g.shape) == tuple(w.shape), n
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=1e-7, err_msg=n)


OPS = {
    "tree_map_with_path": (
        lambda U, t: U.tree_map_with_path(
            lambda name, x: x * (len(name) + 1.0), t[0])),
    "tree_zeros_like": lambda U, t: U.tree_zeros_like(t[0]),
    "tree_add": lambda U, t: U.tree_add(t[0], t[1]),
    "tree_sub": lambda U, t: U.tree_sub(t[0], t[1]),
    "tree_scale": lambda U, t: U.tree_scale(t[0], 0.375),
    "tree_weighted_sum": lambda U, t: U.tree_weighted_sum(
        t, [0.5, 0.25, 0.125]),
    "tree_weighted_sum_array": lambda U, t: U.tree_weighted_sum(
        t, np.array([0.2, 0.3, 0.5])),
}


@pytest.mark.parametrize("op", list(OPS))
def test_tree_op_matches_jax(op):
    trees = [_tree(s) for s in range(3)]
    want = OPS[op](JU, [_jt(t) for t in trees])
    got = OPS[op](TU, [_tt(t) for t in trees])
    _same(got, want)


def test_tree_map_with_path_names():
    seen_t, seen_j = [], []
    TU.tree_map_with_path(lambda n, x: seen_t.append(n) or x,
                          _tt(_tree(0)))
    JU.tree_map_with_path(lambda n, x: seen_j.append(n) or x,
                          _jt(_tree(0)))
    assert seen_t == seen_j == ["blk/a", "blk/b", "layers/0", "layers/1",
                                "n"]


@pytest.mark.parametrize("make", ["resnet8", "resnet18"])
@pytest.mark.parametrize("kw", [{}, {"rank": 8}, {"rank": 64, "alpha": 32.0},
                                {"mode": "fedavg", "fc_mode": "lora"}],
                         ids=["default", "r8", "alpha", "options"])
def test_resnet_paper_configs_match_jax(make, kw):
    """alpha = 16·r unless given; the other fields pass through."""
    j, t = getattr(JRP, make)(**kw), getattr(TRP, make)(**kw)
    assert t.arch == j.arch and t.mode == j.mode
    assert (t.lora.rank, t.lora.alpha, t.lora.scale) == \
        (j.lora.rank, j.lora.alpha, j.lora.scale)
    for f in ("n_classes", "gn_groups", "stem_mode", "fc_mode",
              "norms_trained", "stages"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.lora.alpha == kw.get("alpha", 16.0 * kw.get("rank", 32))
