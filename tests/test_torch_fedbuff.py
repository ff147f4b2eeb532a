"""FedBuff and the streaming fold: the port's ``FedBuffAggregator``,
``fedbuff_*`` and ``StreamingFlatAccumulator`` (``core/aggregation.py``)
and ``flat.fold_flat`` / ``flat.flat_mean_from_sum`` against the JAX
package's, on the same numpy client trees packed by each package (the
packs are bit-identical). Aggregates within atol 1e-6 of the JAX
package's; the discount weights exactly equal; a restored accumulator
bit-identical; zero-weight and empty flushes raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import messages as jmsg
from repro.core.quant import QuantConfig as JQuantConfig
from repro_torch.core import aggregation as tagg
from repro_torch.core import flat as tflat
from repro_torch.core import lora as tlora
from repro_torch.core import messages as tmsg
from repro_torch.core.quant import QuantConfig
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

ATOL = 1e-6


def _tree(i: int, rank: int = 8) -> dict:
    rng = np.random.default_rng(100 + i)
    return {"blk": {"a": rng.normal(size=(13, rank)).astype(np.float32),
                    "b": (0.3 * rng.normal(size=(rank, 21))
                          ).astype(np.float32)},
            "norm": rng.normal(size=(7,)).astype(np.float32)}


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), \
        {"blk": {k: torch.from_numpy(v.copy()) for k, v in
                 tree["blk"].items()},
         "norm": torch.from_numpy(tree["norm"].copy())}


def _packs(ranks, bits, flat=True, density=None, offset=0):
    jm, tm = [], []
    for i, r in enumerate(ranks):
        jt, tt = _both(_tree(i + offset, r))
        jm.append(jmsg.pack_message(jt, JQuantConfig(bits=bits),
                                    flat=flat, density=density))
        tm.append(tmsg.pack_message(tt, QuantConfig(bits=bits), flat=flat,
                                    density=density))
    return jm, tm


def _hold(jtree, ttree, atol=ATOL):
    jl = jax.tree.leaves(jax.device_get(jtree))
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=atol)


def _drive(agg, msgs, n_ks, stales):
    for m, n, s in zip(msgs, n_ks, stales):
        agg.add(m, n, s)
    return agg.flush()


N_KS = [10.0, 20.0, 15.0, 5.0, 8.0]
STALES = [0.0, 1.0, 3.0, 2.0, 5.0]


@pytest.mark.parametrize("half_life", [None, 2.0, 7.5])
def test_discounted_weight_exact(half_life):
    j = jagg.FedBuffAggregator(half_life=half_life)
    t = tagg.FedBuffAggregator(half_life=half_life)
    assert t.resolved_half_life() == j.resolved_half_life()
    assert tagg.FEDBUFF_HALF_LIFE == jagg.FEDBUFF_HALF_LIFE
    for n, s in zip(N_KS, STALES):
        assert t.discounted_weight(n, s) == j.discounted_weight(n, s)


@pytest.mark.parametrize("ranks", [(8, 16, 8, 16, 16), (16, 16, 16, 16, 16)],
                         ids=["mixed", "uniform"])
def test_fedbuff_add_flush_matches_jax(ranks):
    """int8 flat messages of ranks 8 and 16 buffered with staleness, one
    rank-bucketed flush at r_target 16."""
    jm, tm = _packs(ranks, 8)
    ja = jagg.FedBuffAggregator(half_life=2.0, r_target=16)
    ta = tagg.FedBuffAggregator(half_life=2.0, r_target=16)
    for a, m in ((ja, jm), (ta, tm)):
        for msg, n, s in zip(m, N_KS, STALES):
            assert a.add(msg, n, s) == len(a.pending)
    assert ta.buffered == ja.buffered == 5
    assert ta.buffered_weight == ja.buffered_weight
    jout, tout = ja.flush(), ta.flush()
    assert not ta.pending and ta.buffered == 0
    assert tlora.tree_max_rank(tout) == 16
    _hold(jout, tout)


@pytest.mark.parametrize("rank_staleness", [False, True])
def test_fedbuff_aggregate_rank_staleness_matches_jax(rank_staleness):
    jm, tm = _packs((8, 16, 8, 16, 8), 8)
    w = np.asarray(N_KS, np.float32)
    jout = jagg.FedBuffAggregator(half_life=1.5, r_target=16,
                                  rank_staleness=rank_staleness
                                  ).aggregate(jm, jnp.asarray(w))
    tout = tagg.FedBuffAggregator(half_life=1.5, r_target=16,
                                  rank_staleness=rank_staleness
                                  ).aggregate(tm, torch.from_numpy(w))
    _hold(jout, tout)


def test_fedbuff_reference_matches_buffered_path_and_jax():
    """The incremental fp reference (``fedbuff_init/add/flush``) and the
    buffered aggregator implement one rule, in both packages."""
    trees = [_both(_tree(i)) for i in range(3)]
    hl = 2.0
    jst = jagg.fedbuff_init(trees[0][0])
    tst = tagg.fedbuff_init(trees[0][1])
    for (jt, tt), n, s in zip(trees, N_KS, STALES):
        jst = jagg.fedbuff_add(jst, jt, jnp.asarray(n), jnp.asarray(s),
                               half_life=hl)
        tst = tagg.fedbuff_add(tst, tt, n, s, half_life=hl)
    assert int(tst.count) == 3
    np.testing.assert_array_equal(tst.weight.numpy(), np.asarray(jst.weight))
    jref, _ = jagg.fedbuff_flush(jst, trees[0][0])
    tref, fresh = tagg.fedbuff_flush(tst, trees[0][1])
    assert float(fresh.weight) == 0.0 and int(fresh.count) == 0
    _hold(jref, tref)
    agg = tagg.FedBuffAggregator(half_life=hl, r_target=8)
    got = _drive(agg, [t for _, t in trees], N_KS, STALES)
    for a, b in zip(tree_leaves(got), tree_leaves(tref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("ranks", [(8, 8, 8, 8), (4, 8, 4, 8)],
                         ids=["homo", "hetero"])
def test_streaming_matches_batched_and_jax(bits, ranks):
    """Per-arrival folds (one K = 1 ``dequant_agg_rows`` each) and the
    O(1) normalize equal the buffered flush and the JAX package's
    streaming flush; one accumulator a layout."""
    jm, tm = _packs(ranks, bits)
    n_ks, stales = N_KS[:4], STALES[:4]
    ts = tagg.FedBuffAggregator(streaming=True, r_target=8)
    for m, n, s in zip(tm, n_ks, stales):
        ts.add(m, n, s)
    assert not ts.pending and ts.buffered == 4
    assert len(ts.streams) == len(set(ranks))
    out_s = ts.flush()
    assert ts.buffered == 0
    out_b = _drive(tagg.FedBuffAggregator(r_target=8), tm, n_ks, stales)
    for a, b in zip(tree_leaves(out_s), tree_leaves(out_b)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-5,
                                   atol=1e-6)
    jout = _drive(jagg.FedBuffAggregator(streaming=True, r_target=8), jm,
                  n_ks, stales)
    _hold(jout, out_s)


def test_streaming_mixed_with_sparse_pending():
    """Sparse uplinks are not flat messages: they buffer in ``pending``,
    and the mixed flush recombines stream and bucket means by weight
    mass, as the all-batched flush and the JAX package do."""
    jf, tf = _packs((8, 8), 4)
    js, tsp = _packs((8, 8), 4, flat=False, density=0.5, offset=2)
    jm = [jf[0], js[0], jf[1], js[1]]
    tm = [tf[0], tsp[0], tf[1], tsp[1]]
    n_ks, stales = N_KS[:4], STALES[:4]
    agg = tagg.FedBuffAggregator(streaming=True, r_target=8)
    out_s = _drive(agg, tm, n_ks, stales)
    assert not agg.pending and not agg.buffered
    out_b = _drive(tagg.FedBuffAggregator(r_target=8), tm, n_ks, stales)
    for a, b in zip(tree_leaves(out_s), tree_leaves(out_b)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-5,
                                   atol=1e-6)
    jout = _drive(jagg.FedBuffAggregator(streaming=True, r_target=8), jm,
                  n_ks, stales)
    _hold(jout, out_s)


@pytest.mark.parametrize("bits", [2, 8])
def test_fold_flat_matches_jax_impl(bits):
    """One fold: the K = 1 kernel's fresh contribution plus the running
    sum, and each fp leaf's ``w * leaf``, against ``_fold_flat_impl``;
    the normalize against ``_flat_mean_from_sum_impl``."""
    from repro.core import flat as jflat
    jm, tm = _packs((8, 8, 8), bits)
    lo_j, lo_t = jm[0].layout, tm[0].layout
    jacc = jnp.zeros((lo_j.c_total, lo_j.n_max), jnp.float32)
    jfp = (jnp.zeros((7,), jnp.float32),)
    st = tagg.StreamingFlatAccumulator.for_layout(lo_t, device="cpu")
    for m_j, m_t, w in zip(jm, tm, (3.0, 0.75, 1.0 / 3.0)):
        jacc, jfp = jflat._fold_flat_impl(jacc, jfp, m_j.payload,
                                          m_j.scale, m_j.zp, m_j.fp_leaves,
                                          w, lo_j)
        acc, fp = tflat.fold_flat(st.acc, st.fp_acc, m_t, w, st.n_valid)
        assert acc is not st.acc
        st.acc, st.fp_acc = acc, fp
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(fp[0].numpy(), np.asarray(jfp[0]),
                                   rtol=0, atol=ATOL)
    inv = 1.0 / 4.0833
    _hold(jflat._flat_mean_from_sum_impl(jacc, jfp, inv, lo_j),
          tflat.flat_mean_from_sum(st.acc, st.fp_acc, inv, lo_t))


def test_streaming_state_roundtrip_bit_exact():
    """A mid-buffer ``state()`` restored with ``from_state`` folds on to a
    bit-identical mean."""
    _, tm = _packs((8,) * 5, 8)
    st = tagg.StreamingFlatAccumulator.for_layout(tm[0].layout,
                                                  device="cpu")
    for m in tm[:3]:
        st.fold(m, 2.0)
    state = st.state()
    assert isinstance(state["acc"], np.ndarray) and state["count"] == 3
    st2 = tagg.StreamingFlatAccumulator.from_state(tm[0].layout, state,
                                                   device="cpu")
    for s in (st, st2):
        for m in tm[3:]:
            s.fold(m, 1.5)
    assert st2.weight == st.weight and st2.count == st.count == 5
    for a, b in zip(tree_leaves(st.mean()), tree_leaves(st2.mean())):
        assert torch.equal(a, b)
    other = _packs((4,), 8)[1][0]
    with pytest.raises(ValueError, match="layout"):
        st.fold(other, 1.0)


def test_zero_weight_and_empty_flushes_raise():
    _, tt = _both(_tree(0))
    state = tagg.fedbuff_init(tt)
    with pytest.raises(ValueError, match="zero accumulated weight"):
        tagg.fedbuff_flush(state, tt)
    state = tagg.fedbuff_add(state, tt, 0.0, 0.0, half_life=4.0)
    with pytest.raises(ValueError, match="zero accumulated weight"):
        tagg.fedbuff_flush(state, tt)
    _, tm = _packs((8,), 4)
    st = tagg.StreamingFlatAccumulator.for_layout(tm[0].layout,
                                                  device="cpu")
    with pytest.raises(ValueError, match="empty accumulator"):
        st.mean()
    st.fold(tm[0], 0.0)
    with pytest.raises(ValueError, match="zero accumulated weight"):
        st.mean()
    agg = tagg.FedBuffAggregator(streaming=True)
    with pytest.raises(ValueError, match="empty buffer"):
        agg.flush()
    agg.add(tm[0], 0.0, 0.0)
    with pytest.raises(ValueError, match="zero accumulated weight"):
        agg.flush()


def test_strict_compiles_not_ported():
    """(The name is kept from when the option was refused.) With
    ``strict_compiles`` the streaming fold runs under a zero-budget
    watchdog from its second fold on and gives the plain accumulator's
    sum bit for bit; FedBuff hands the option to its streams; a fold
    that builds a program raises ``CompileBudgetExceeded``."""
    from repro_torch.fl import AsyncConfig
    from repro_torch.obs import compile as obsc
    _, tm = _packs((8, 8, 8), 8)
    strict = tagg.StreamingFlatAccumulator.for_layout(
        tm[0].layout, strict_compiles=True, device="cpu")
    plain = tagg.StreamingFlatAccumulator.for_layout(tm[0].layout,
                                                     device="cpu")
    for i, m in enumerate(tm):
        strict.fold(m, 1.0 + i)
        plain.fold(m, 1.0 + i)
    assert torch.equal(strict.acc, plain.acc)
    agg = tagg.FedBuffAggregator(streaming=True, strict_compiles=True)
    for m in tm:
        agg.add(m, 1.0, 0.0)
    assert all(s.strict_compiles for s in agg.streams.values())
    agg.flush()
    real = tflat.fold_flat

    def building_fold(*a, **kw):
        obsc.record_build("load")
        return real(*a, **kw)

    tflat.fold_flat = building_fold
    try:
        fresh = tagg.StreamingFlatAccumulator.for_layout(
            tm[0].layout, strict_compiles=True, device="cpu")
        fresh.fold(tm[0], 1.0)                # the first fold may build
        with pytest.raises(obsc.CompileBudgetExceeded, match="fold #1"):
            fresh.fold(tm[1], 1.0)
    finally:
        tflat.fold_flat = real
    assert AsyncConfig(strict_compiles=True).strict_compiles


def test_aggregator_protocol():
    assert isinstance(tagg.FedBuffAggregator(), tagg.Aggregator)
    assert isinstance(tagg.FedAvgAggregator(), tagg.Aggregator)
    assert not isinstance(object(), tagg.Aggregator)
