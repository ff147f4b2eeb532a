"""The sparse (FLASC top-k) wire: the port against the JAX package.

``SparsityConfig``, ``keep_count`` and the static accounting equal the
JAX package's. ``sparsify_leaf`` picks the same indices as
``jax.lax.top_k`` on tie-heavy inputs (mostly zeros, repeated
magnitudes) and packs bit-identical words, scale and zp (the Pallas pack
in interpret mode); a message's survivors in ONE ``quant_pack_rows``
pack give each leaf's per-leaf words. Serialized leaves and messages are
byte-identical, in the bitmap and the index form, and decode in either
package. ``fedavg_packed`` over sparse and mixed sparse/dense cohorts,
and the EF residuals of ``ef_encode_packed(density=0.1)``, within 1e-6
of the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import messages as jmsg
from repro.core import sparse as jsp
from repro.core.quant import QuantConfig as JQuantConfig
from repro_torch.core import aggregation as tagg
from repro_torch.core import messages as tmsg
from repro_torch.core import sparse as tsp
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import flatten_with_names, tree_map

torch.set_num_threads(1)

BITS = [2, 4, 8, None]
SHAPES = [(64, 64), (3, 3, 16, 8), (1, 1, 8, 32), (100, 7), (5, 3)]
DENSITIES = [0.01, 0.1, 0.5]


def _tie_heavy(shape, seed):
    """Mostly exact zeros, a block of one repeated magnitude (both
    signs), a few distinct values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) < 0.7] = 0.0
    rep = rng.random(shape) < 0.1
    x[rep] = np.where(rng.random(int(rep.sum())) < 0.5, 0.5, -0.5)
    return x


def _words(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_leaf_equal(jl, tl):
    assert tl.shape == tuple(jl.shape) and tl.bits == jl.bits
    assert (tl.idx.numpy() == np.asarray(jl.idx)).all()
    if jl.bits is None:
        assert (tl.payload.numpy() == np.asarray(jl.payload)).all()
        return
    jp = np.asarray(jl.payload)
    assert _words(tl.payload).shape == jp.shape
    assert (_words(tl.payload) == jp).all()
    assert (_f32_bits(tl.scale.numpy()) == _f32_bits(jl.scale)).all()
    assert (_f32_bits(tl.zp.numpy()) == _f32_bits(jl.zp)).all()


def _assert_bufs_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


# -- config and accounting ----------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(density=0.1), dict(density=1.0),
    dict(density=0.2, anneal_every=2), dict(density=0.3, anneal_every=1,
                                            anneal_factor=0.7,
                                            min_density=0.05),
    dict(density=0.005, anneal_every=3, min_density=0.02)])
def test_sparsity_config_matches_jax(kw):
    jc, tc = jsp.SparsityConfig(**kw), tsp.SparsityConfig(**kw)
    assert tc.enabled == jc.enabled
    assert [tc.density_at(r) for r in range(12)] == \
        [jc.density_at(r) for r in range(12)]


@pytest.mark.parametrize("kw", [dict(density=0.0), dict(density=1.5),
                                dict(anneal_every=-1),
                                dict(anneal_factor=0.0),
                                dict(min_density=2.0)])
def test_sparsity_config_refusals_match_jax(kw):
    with pytest.raises(ValueError):
        jsp.SparsityConfig(**kw)
    with pytest.raises(ValueError):
        tsp.SparsityConfig(**kw)


@pytest.mark.parametrize("bits", BITS)
def test_keep_count_and_leaf_bytes_match_jax(bits):
    for shape in SHAPES + [(1, 1), (4096,), (3, 3, 64, 32)]:
        n = int(np.prod(shape))
        for d in DENSITIES + [1e-6, 0.031, 0.032, 1.0]:
            assert tsp.keep_count(n, d) == jsp.keep_count(n, d)
            assert tsp.sparse_leaf_wire_bytes(shape, bits, d) == \
                jsp.sparse_leaf_wire_bytes(shape, bits, d)


# -- selection and pack -------------------------------------------------------

def test_tie_order_is_jax_top_k():
    """|x| = [0,0,1,0,1,0,0,2,0,0], k = 4: ``jax.lax.top_k`` keeps
    [7, 2, 4, 0] (``torch.topk`` keeps [7, 4, 2, 8])."""
    x = np.array([0, 0, 1, 0, 1, 0, 0, 2, 0, 0], np.float32).reshape(2, 5)
    jl = jsp.sparsify_leaf(jnp.asarray(x), 0.4, 4)
    tl = tsp.sparsify_leaf(torch.from_numpy(x), 0.4, 4)
    assert tl.idx.tolist() == [0, 2, 4, 7] == np.asarray(jl.idx).tolist()
    _assert_leaf_equal(jl, tl)


@pytest.mark.parametrize("bits", BITS)
def test_sparsify_leaf_matches_jax_on_ties(bits):
    for seed, shape in enumerate(SHAPES):
        x = _tie_heavy(shape, seed)
        for d in DENSITIES:
            _assert_leaf_equal(
                jsp.sparsify_leaf(jnp.asarray(x), d, bits),
                tsp.sparsify_leaf(torch.from_numpy(x), d, bits))


@pytest.mark.parametrize("bits", BITS)
def test_one_pack_per_message_equals_per_leaf(bits):
    """``sparsify_leaves`` (one ragged ``quant_pack_rows`` call) gives
    every leaf the words, scale, zp and indices of its own pack; on CPU
    tensors no kernel launches."""
    xs = [torch.from_numpy(_tie_heavy(s, i)) for i, s in enumerate(SHAPES)]
    kops.reset_launch_counts()
    many = tsp.sparsify_leaves(xs, 0.1, bits)
    assert kops.launch_counts()["quant_pack_rows"] == 0
    for x, got in zip(xs, many):
        one = tsp.sparsify_leaf(x, 0.1, bits)
        assert torch.equal(got.idx, one.idx)
        if bits is None:
            assert torch.equal(got.payload, one.payload)
        else:
            assert (_words(got.payload) == _words(one.payload)).all()
            assert torch.equal(got.scale, one.scale)
            assert torch.equal(got.zp, one.zp)
        assert torch.equal(got.densify(), one.densify())


# -- serialization ------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("form,density", [("index", 0.01),
                                          ("bitmap", 0.3)])
def test_leaf_wire_byte_identical_both_ways(bits, form, density):
    for seed, shape in enumerate([(64, 64), (3, 3, 16, 8)]):
        x = _tie_heavy(shape, seed)
        jl = jsp.sparsify_leaf(jnp.asarray(x), density, bits)
        tl = tsp.sparsify_leaf(torch.from_numpy(x), density, bits)
        jw, tw = jl.to_wire(), tl.to_wire()
        assert ("bitmap" in tw) == (form == "bitmap")
        _assert_bufs_equal(jw, tw)
        assert tl.wire_bytes() == tsp.sparse_leaf_wire_bytes(shape, bits,
                                                             density)
        # decode across the packages, both ways
        _assert_leaf_equal(jl, tsp.SparseLeaf.from_wire(
            jw, shape, torch.float32, bits, density, device="cpu"))
        _assert_leaf_equal(jsp.SparseLeaf.from_wire(
            tw, shape, jnp.float32, bits, density), tl)
        np.testing.assert_array_equal(tl.densify().numpy(),
                                      np.asarray(jl.densify()))


def _tree(seed):
    """An adapter-like tree: a conv pair whose ``a`` is mostly exact
    zeros, a dense pair, a norm vector."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(1, 1, 4, 24)).astype(np.float32)
    a[:, :, :, rng.random(24) < 0.6] = 0.0
    return {"conv": {"a": a,
                     "b": _tie_heavy((3, 3, 16, 4), seed + 1)},
            "fc": {"a": rng.normal(size=(40, 4)).astype(np.float32),
                   "b": _tie_heavy((4, 30), seed + 2)},
            "norm": rng.normal(size=(24,)).astype(np.float32)}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.asarray(x)), tree)


@pytest.mark.parametrize("bits", [4, 8, None])
@pytest.mark.parametrize("density", [0.02, 0.1, 0.5])
def test_message_wire_matches_jax(bits, density):
    tree = _tree(0)
    jm = jmsg.pack_message(jax.tree.map(jnp.asarray, tree),
                           JQuantConfig(bits=bits), density=density)
    tm = tmsg.pack_message(_t(tree), QuantConfig(bits=bits),
                           density=density)
    assert tmsg.message_density(tm) == jmsg.message_density(jm) == density
    je, te = jmsg.message_to_wire(jm), tmsg.message_to_wire(tm)
    assert [n for n, _ in je] == [n for n, _ in te]
    for (_, a), (_, b) in zip(je, te):
        _assert_bufs_equal(a, b)
    assert tmsg.parse_wire_header(dict(te)[tmsg.HEADER_KEY]["header"]) == \
        jmsg.parse_wire_header(dict(je)[jmsg.HEADER_KEY]["header"])
    want = jmsg.message_wire_bytes(tree, JQuantConfig(bits=bits), density)
    assert tmsg.packed_wire_bytes(tm) == want == \
        tmsg.message_wire_bytes(_t(tree), QuantConfig(bits=bits), density)
    # decode across the packages, both ways
    back = tmsg.message_from_wire(je, tm, device="cpu")
    for (_, x), (_, y) in zip(flatten_with_names(tmsg.unpack_message(back)),
                              flatten_with_names(
                                  jmsg.unpack_message(jm))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    jback = jmsg.message_from_wire(te, jm)
    for (_, a), (_, b) in zip(jmsg.message_to_wire(jback), je):
        _assert_bufs_equal(a, b)


def test_dense_density_is_the_dense_wire():
    tree = _tree(1)
    for density in (None, 1.0):
        tm = tmsg.pack_message(_t(tree), QuantConfig(bits=4),
                               density=density)
        assert not any(tsp.is_sparse_leaf(x)
                       for _, x in flatten_with_names(tm))
        assert tmsg.message_density(tm) == 1.0


# -- aggregation and error feedback -------------------------------------------

def _cohort(kinds, bits, density):
    """(JAX messages, port messages, weights) for one cohort; ``kinds``
    names each client's wire: sparse, per-leaf packed, flat, or fp."""
    jms, tms = [], []
    for i, kind in enumerate(kinds):
        tree = _tree(10 + i)
        jt, tt = jax.tree.map(jnp.asarray, tree), _t(tree)
        d = density if kind == "sparse" else None
        if kind == "fp":
            jms.append(jt)
            tms.append(tt)
            continue
        jms.append(jmsg.pack_message(jt, JQuantConfig(bits=bits), density=d,
                                     flat=kind == "flat"))
        tms.append(tmsg.pack_message(tt, QuantConfig(bits=bits), density=d,
                                     flat=kind == "flat"))
    w = np.arange(3, 3 + len(kinds)).astype(np.float32)
    return jms, tms, w


@pytest.mark.parametrize("kinds", [
    ("sparse",) * 5, ("sparse", "packed", "sparse", "fp"),
    ("packed", "sparse", "flat")], ids=["sparse", "mixed", "mixed_flat"])
@pytest.mark.parametrize("bits", [4, 8])
def test_fedavg_packed_sparse_matches_jax(kinds, bits):
    jms, tms, w = _cohort(kinds, bits, 0.1)
    want = jagg.fedavg_packed(jms, jnp.asarray(w))
    got = tagg.fedavg_packed(tms, torch.from_numpy(w))
    for (name, g), (_, x) in zip(flatten_with_names(got),
                                 flatten_with_names(want)):
        x = np.asarray(x)
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
        assert np.abs(g.numpy() - x).max() <= 1e-6 * max(
            np.abs(x).max(), 1e-30), name


@pytest.mark.parametrize("bits", [4, 8, None])
def test_ef_encode_packed_sparse_matches_jax(bits):
    """density 0.1: the messages byte-identical, the residual (the
    dropped mass plus the survivors' quantization error) within 1e-6 of
    the JAX package's, two rounds running."""
    tree = _tree(3)
    jres = jagg.ef_init(jax.tree.map(jnp.asarray, tree))
    tres = tagg.ef_init(_t(tree))
    for step in range(2):
        x = jax.tree.map(lambda a: a * (1.0 + step), tree)
        jm, jres = jagg.ef_encode_packed(jax.tree.map(jnp.asarray, x), jres,
                                         JQuantConfig(bits=bits),
                                         density=0.1)
        tm, tres = tagg.ef_encode_packed(_t(x), tres,
                                         QuantConfig(bits=bits),
                                         density=0.1)
        for (_, a), (_, b) in zip(jmsg.message_to_wire(jm),
                                  tmsg.message_to_wire(tm)):
            _assert_bufs_equal(a, b)
        for (name, g), (_, r) in zip(flatten_with_names(tres),
                                     flatten_with_names(jres)):
            r = np.asarray(r)
            assert np.abs(g.numpy() - r).max() <= 1e-6 * max(
                np.abs(r).max(), 1e-30), name
        # the dropped mass rides the residual: message + residual = x + e
        recon = tmsg.unpack_message(tm)
        dropped = sum(int((v == 0).sum()) for v in
                      (recon["conv"]["b"], recon["fc"]["b"]))
        assert dropped > 0
