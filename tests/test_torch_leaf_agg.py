"""The grouped per-leaf aggregate (B3, ``ops.dequant_agg_leaves``) and
the per-leaf ``fedavg_packed`` that makes one call of it a round, on the
CPU against the JAX package.

Every leaf's compact (C, n) fold must be BIT-identical to the Pallas
kernel ``dequant_agg_pallas`` (interpret mode) on the stacked payloads,
sliced to its first n columns: ragged leaves (C not a multiple of 8),
a scale = 0 row with a nonzero zp, a -0.0 weight, and payloads that are
strided row slices of a flat buffer (``FlatPackedMessage.as_tree``).
The per-leaf ``fedavg_packed`` must give the same bits as the per-leaf
composition it replaced (a stack and a ``dequant_agg`` a leaf) and as
the JAX package's ``fedavg_packed``. The CUDA kernel against these plain
versions is in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import messages as jmsg
from repro.core.quant import QuantConfig as JQuantConfig
from repro.kernels.dequant_agg import dequant_agg_pallas
from repro_torch.core import aggregation as tagg
from repro_torch.core import flat as tflat
from repro_torch.core import messages as tmsg
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import tree_flatten, tree_map

torch.set_num_threads(1)


def _tree(rng) -> dict:
    """Leaves of ragged channel counts (13, 10, 37, 9, 3) and lengths
    (45, 40, 7, 300, 2100 levels a row: the last is longer than one lane
    at every width, so in a flat buffer the others are strided row
    slices), and a 1-D leaf that travels in fp32."""
    f = np.float32
    return {"conv": (rng.standard_normal((3, 3, 5, 13)) * 0.2).astype(f),
            "lin": (rng.standard_normal((40, 10)) * 0.1).astype(f),
            "tall": (rng.standard_normal((7, 37)) * 0.3).astype(f),
            "wide": (rng.standard_normal((300, 9)) * 0.05).astype(f),
            "long": (rng.standard_normal((2100, 3)) * 0.05).astype(f),
            "norm": rng.standard_normal(13).astype(f)}


def _bits_of(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _cohort(bits: int, k: int, seed: int):
    """K clients' flat messages, seen per leaf through ``as_tree`` (row
    slices of each flat buffer), with row 1 of every leaf of the last
    client at scale = 0 and a nonzero zp, and weights with a -0.0."""
    rng = np.random.default_rng(seed)
    msgs = [tflat.pack_flat(tree_map(torch.from_numpy, _tree(rng)), bits)
            for _ in range(k)]
    msgs[-1].scale[1::5] = 0.0
    msgs[-1].zp[1::5] = 3.0
    w = rng.uniform(0.1, 1.0, size=k).astype(np.float32)
    w[0] = -0.0
    return [m.as_tree() for m in msgs], w


def _columns(trees):
    return [list(col) for col in zip(*(tree_flatten(t)[0] for t in trees))
            if tmsg.is_packed_leaf(col[0])]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 5])
def test_dequant_agg_leaves_bit_identical_to_pallas(bits, k):
    trees, w = _cohort(bits, k, seed=bits * 10 + k)
    cols = _columns(trees)
    assert any(c[0].payload.stride(0) != c[0].payload.shape[1]
               for c in cols)                        # strided views
    leaves = [([(m.payload, m.scale, m.zp) for m in col],
               col[0].n_per_channel) for col in cols]
    kops.reset_launch_counts()
    got = kops.dequant_agg_leaves(leaves, torch.from_numpy(w), bits)
    assert kops.launch_counts()["dequant_agg"] == 0   # CPU: plain version
    assert len(got) == len(cols)
    for fold, col in zip(got, cols):
        n = col[0].n_per_channel
        assert tuple(fold.shape) == (col[0].channels, n)
        p = np.stack([m.payload.numpy() for m in col])
        s = np.stack([m.scale.numpy() for m in col])
        z = np.stack([m.zp.numpy() for m in col])
        pallas = dequant_agg_pallas(jnp.asarray(p), jnp.asarray(s),
                                    jnp.asarray(np.where(s > 0, z, 0.0)
                                                .astype(np.float32)),
                                    jnp.asarray(w), bits, interpret=True)
        np.testing.assert_array_equal(_bits_of(fold),
                                      _bits_of(pallas)[:, :n])


def test_dequant_agg_leaves_checks_inputs():
    trees, w = _cohort(8, 2, seed=0)
    col = _columns(trees)[0]
    leaf = ([(m.payload, m.scale, m.zp) for m in col], col[0].n_per_channel)
    with pytest.raises(ValueError, match="bits"):
        kops.dequant_agg_leaves([leaf], w, 3)
    with pytest.raises(ValueError, match="weight"):
        kops.dequant_agg_leaves([leaf], w[:1], 8)
    with pytest.raises(ValueError, match="fit"):
        kops.dequant_agg_leaves([(leaf[0], 10 ** 6)], w, 8)
    assert kops.dequant_agg_leaves([], w, 8) == []


def _old_per_leaf(msgs, weights):
    """The per-leaf composition ``fedavg_packed`` used to run: a stack of
    the K payloads and sidecars and one ``dequant_agg`` a packed leaf,
    sliced to the leaf's columns; fp leaves the weighted mean."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)

    def agg(*leaves):
        l0 = leaves[0]
        if tmsg.is_packed_leaf(l0):
            out = kops.dequant_agg(torch.stack([m.payload for m in leaves]),
                                   torch.stack([m.scale for m in leaves]),
                                   torch.stack([m.zp for m in leaves]), w,
                                   l0.bits)
            return kops.from_channel_first_2d(
                out[:, : l0.n_per_channel], l0.shape,
                l0.per_stack).to(l0.dtype)
        x = torch.stack([v.to(torch.float32) for v in leaves])
        return torch.sum(x * w.reshape((-1,) + (1,) * (x.ndim - 1)),
                         dim=0).to(l0.dtype)

    return tree_map(agg, *msgs)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_per_leaf_fedavg_packed_bit_identical(bits):
    """Per-leaf messages packed by both packages from the same numpy
    trees: the port's fedavg_packed (one grouped launch on the card) has
    the bits of the composition it replaced and, on every packed leaf,
    of the JAX package's (the fp leaf's weighted sum is ordered
    differently by the two frameworks). The weights are sample counts, as the server
    passes them: their sum is exact in any order, so both packages
    normalize them to the same bits."""
    rng = np.random.default_rng(bits)
    trees = [_tree(rng) for _ in range(5)]
    w = rng.integers(1, 200, size=5).astype(np.float32)
    tmsgs = [tmsg.pack_message(tree_map(torch.from_numpy, t),
                               QuantConfig(bits=bits), flat=False)
             for t in trees]
    jmsgs = [jmsg.pack_message(tree_map(jnp.asarray, t),
                               JQuantConfig(bits=bits), flat=False)
             for t in trees]
    got = tagg.fedavg_packed(tmsgs, torch.from_numpy(w))
    old = _old_per_leaf(tmsgs, torch.from_numpy(w))
    want = jagg.fedavg_packed(jmsgs, jnp.asarray(w))
    for key in trees[0]:
        assert got[key].shape == tuple(trees[0][key].shape)
        np.testing.assert_array_equal(_bits_of(got[key]), _bits_of(old[key]))
        if key == "norm":                    # fp: summed in either order
            np.testing.assert_allclose(got[key].numpy(), np.asarray(
                want[key]), rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(_bits_of(got[key]),
                                          _bits_of(want[key]))


def test_mixed_flat_and_per_leaf_buffer_folds_as_per_leaf():
    """A buffer mixing flat and per-leaf messages goes through
    ``as_tree``'s strided views: the same bits as all per-leaf."""
    rng = np.random.default_rng(11)
    trees = [tree_map(torch.from_numpy, _tree(rng)) for _ in range(4)]
    w = torch.tensor([3.0, 1.0, 2.0, 5.0])
    per_leaf = [tmsg.pack_message(t, QuantConfig(bits=8), flat=False)
                for t in trees]
    mixed = [tmsg.pack_message(t, QuantConfig(bits=8), flat=i % 2 == 0)
             for i, t in enumerate(trees)]
    got = tagg.fedavg_packed(mixed, w)
    want = tagg.fedavg_packed(per_leaf, w)
    for key in got:
        np.testing.assert_array_equal(_bits_of(got[key]), _bits_of(want[key]))
