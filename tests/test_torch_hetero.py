"""Heterogeneous ranks: the port against the JAX package.

``RankSchedule`` (tiers, annealing, refusals); the rank utilities: pad
and slice exact, SVD truncation held by its products (within 1e-5: the
factors may differ in sign and order between the frameworks),
``svd_energy_rank`` equal; ``bucket_by_rank``; ``fedavg_hetero`` on flat
packed cohorts within 1e-6; ``SVDRecombinationAggregator``'s products
and served ranks; per-rank downlinks byte-identical; ``client_wire_bytes``
and ``fleet_tcc_bytes`` equal, with rank schedules and sparse
uplinks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import flocora as jfl
from repro.core import lora as jlora
from repro.core import messages as jmsg
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.sparse import SparsityConfig as JSparsityConfig
from repro_torch.core import aggregation as tagg
from repro_torch.core import flocora as tfl
from repro_torch.core import lora as tlora
from repro_torch.core import messages as tmsg
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sparse import SparsityConfig
from repro_torch.utils.tree import flatten_with_names, tree_map

torch.set_num_threads(1)

TIERS = (4, 8, 16)


def _client_tree(seed, rank):
    """A conv pair (b down (3, 3, 5, r), a up (1, 1, r, 7)), a dense pair
    (a (16, r), b (r, 12)) and a norm vector, every factor non-zero."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (0.3 * rng.normal(size=shape)).astype(np.float32)

    return {"conv": {"b": r(3, 3, 5, rank), "a": r(1, 1, rank, 7)},
            "fc": {"a": r(16, rank), "b": r(rank, 12)}, "norm": r(7)}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.asarray(x)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _product(pair, lora_mod, to_np):
    """down @ up of one pair, in float64."""
    down, up, _ = lora_mod._dense_factors(pair)
    return to_np(down) @ to_np(up)


def _np_t(x):
    return x.detach().numpy().astype(np.float64)


def _np_j(x):
    return np.asarray(x, np.float64)


def _assert_tree_close(got, want, rel=1e-6):
    for (name, g), (_, w) in zip(flatten_with_names(got),
                                 flatten_with_names(want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert np.abs(g.numpy() - w).max() <= rel * max(np.abs(w).max(),
                                                        1e-30), name


# -- the schedule -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(anneal_every=2), dict(anneal_every=1, anneal_factor=0.7,
                                       min_rank=3),
    dict(anneal_every=3, min_rank=8)])
def test_rank_schedule_matches_jax(kw):
    js, ts = jfl.RankSchedule.tiered(TIERS, 10, **kw), \
        tfl.RankSchedule.tiered(TIERS, 10, **kw)
    assert ts.client_ranks == js.client_ranks
    assert (ts.n_clients, ts.max_rank) == (js.n_clients, js.max_rank)
    for rnd in range(9):
        assert ts.ranks_at(rnd) == js.ranks_at(rnd)
    assert tfl.RankSchedule.uniform(1, 2).rank_for(0) == 1


@pytest.mark.parametrize("kw", [dict(client_ranks=()),
                                dict(client_ranks=(4, 0)),
                                dict(client_ranks=(4, 8), anneal_every=-1),
                                dict(client_ranks=(4, 8), anneal_factor=0.0),
                                dict(client_ranks=(4, 8), min_rank=0)])
def test_rank_schedule_refusals_match_jax(kw):
    with pytest.raises(ValueError):
        jfl.RankSchedule(**kw)
    with pytest.raises(ValueError):
        tfl.RankSchedule(**kw)


# -- rank utilities -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["conv", "fc"])
@pytest.mark.parametrize("r_target", [2, 8, 12])
def test_pad_and_slice_exact(kind, r_target):
    pair = _client_tree(0, 8)[kind]
    jp, tp = _j(pair), _t(pair)
    if r_target >= 8:
        want, got = jlora.pad_adapter(jp, r_target), \
            tlora.pad_adapter(tp, r_target)
    else:
        want, got = jlora.slice_adapter(jp, r_target), \
            tlora.slice_adapter(tp, r_target)
    for k in pair:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert torch.equal(tlora.slice_adapter(tlora.pad_adapter(tp, 12), 8)["a"],
                       tp["a"])
    with pytest.raises(ValueError):
        tlora.pad_adapter(tp, 4)
    with pytest.raises(ValueError):
        tlora.slice_adapter(tp, 16)


@pytest.mark.parametrize("kind", ["conv", "fc"])
@pytest.mark.parametrize("r_target", [2, 5, 8, 20])
def test_svd_truncation_products_match_jax(kind, r_target):
    """``svd_adapter``/``truncate_adapter``: rank dims exactly
    ``r_target``; products within 1e-5 of the JAX package's;
    ``truncate_adapter`` on the factors gives the pair's product."""
    pair = _client_tree(1, 8)[kind]
    want = jlora.svd_adapter(_j(pair), r_target)
    got = tlora.svd_adapter(_t(pair), r_target)
    assert tlora.adapter_rank(got) == r_target
    for k in pair:
        assert tuple(got[k].shape) == tuple(want[k].shape)
    pg, pw = _product(got, tlora, _np_t), _product(want, jlora, _np_j)
    assert np.abs(pg - pw).max() <= 1e-5 * max(np.abs(pw).max(), 1.0)
    a, b = tlora._dense_factors(_t(pair))[:2]
    at, bt = tlora.truncate_adapter(a, b, r_target)
    np.testing.assert_allclose(_np_t(at) @ _np_t(bt), pg, atol=1e-6)


def test_truncate_beyond_intrinsic_rank_pads_zero():
    a = torch.from_numpy(np.random.default_rng(0).normal(
        size=(6, 2)).astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 6)).astype(np.float32))
    at, bt = tlora.truncate_adapter(a, b, 9)
    assert at.shape == (6, 9) and bt.shape == (9, 6)
    assert float(at[:, 6:].abs().max()) == 0.0
    np.testing.assert_allclose((at @ bt).numpy(), (a @ b).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("energy", [0.5, 0.9, 0.99, 1.0])
def test_svd_energy_rank_matches_jax(energy):
    rng = np.random.default_rng(2)
    for s in [np.sort(rng.uniform(0, 3, 12))[::-1],
              np.array([5.0, 1.0, 0.1, 0.0]),
              np.stack([np.sort(rng.uniform(0, 1, 8))[::-1],
                        np.zeros(8)]),
              np.zeros(5)]:
        s = np.ascontiguousarray(s, np.float32)
        assert tlora.svd_energy_rank(torch.from_numpy(s), energy) == \
            jlora.svd_energy_rank(jnp.asarray(s), energy)


@pytest.mark.parametrize("method", ["slice", "svd"])
def test_resize_tree_rank_walks_pairs_only(method):
    tree = _client_tree(3, 8)
    for r in (4, 8, 16):
        got = tlora.resize_tree_rank(_t(tree), r, method)
        want = jlora.resize_tree_rank(_j(tree), r, method)
        assert tlora.tree_ranks(got) == (r,)
        np.testing.assert_array_equal(got["norm"].numpy(), tree["norm"])
        for (_, g), (_, w) in zip(flatten_with_names(got),
                                  flatten_with_names(want)):
            assert tuple(g.shape) == tuple(w.shape)
        if method == "slice" or r >= 8:
            _assert_tree_close(got, want, rel=0.0)
    with pytest.raises(ValueError):
        tlora.resize_adapter(_t(tree)["fc"], 4, method="nope")


# -- aggregation --------------------------------------------------------------

def _mixed(ranks, bits=8, flat=True):
    trees = [_client_tree(10 + i, r) for i, r in enumerate(ranks)]
    if bits is None:
        return [_j(t) for t in trees], [_t(t) for t in trees]
    return ([jmsg.pack_message(_j(t), JQuantConfig(bits=bits), flat=flat)
             for t in trees],
            [tmsg.pack_message(_t(t), QuantConfig(bits=bits), flat=flat)
             for t in trees])


def test_bucket_by_rank_matches_jax():
    ranks = (8, 4, 16, 4, 8, 8)
    jms, tms = _mixed(ranks)
    assert tagg.bucket_by_rank(tms) == jagg.bucket_by_rank(jms) == \
        {4: [1, 3], 8: [0, 4, 5], 16: [2]}
    assert list(tagg.bucket_by_rank(tms)) == [4, 8, 16]
    assert tagg.bucket_by_rank([{"norm": torch.zeros(3)}]) == {0: [0]}


@pytest.mark.parametrize("bits,flat", [(8, True), (4, True), (8, False),
                                       (None, True)])
def test_fedavg_hetero_matches_jax(bits, flat):
    ranks = (8, 4, 16, 4, 8)
    jms, tms = _mixed(ranks, bits, flat)
    w = np.array([3, 5, 2, 7, 4], np.float32)
    want = jagg.fedavg_hetero(jms, jnp.asarray(w), 16)
    got = tagg.fedavg_hetero(tms, torch.from_numpy(w), 16)
    assert tlora.tree_ranks(got) == (16,)
    _assert_tree_close(got, want)
    # the aggregator dispatches a mixed cohort there, and pads a uniform
    # one below its target
    agg = tagg.FedAvgAggregator(QuantConfig(bits=bits), r_target=16)
    _assert_tree_close(agg.aggregate(tms, torch.from_numpy(w)), want)
    low = agg.aggregate(tms[1::2], torch.from_numpy(w[1::2]))
    assert tlora.tree_ranks(low) == (16,)


@pytest.mark.parametrize("energy", [0.9, 0.99])
@pytest.mark.parametrize("bits", [8, None])
def test_svd_recombination_matches_jax(energy, bits):
    ranks = (4, 8, 16, 8)
    jms, tms = _mixed(ranks, bits)
    w = np.array([1, 2, 3, 4], np.float32)
    jagg_ = jagg.SVDRecombinationAggregator(JQuantConfig(bits=bits), 16,
                                            energy=energy)
    tagg_ = tagg.SVDRecombinationAggregator(QuantConfig(bits=bits), 16,
                                            energy=energy)
    want = jagg_.aggregate(jms, jnp.asarray(w))
    got = tagg_.aggregate(tms, torch.from_numpy(w))
    assert tagg_.served_ranks == jagg_.served_ranks
    assert all(r <= 16 for r in tagg_.served_ranks.values())
    assert tlora.tree_ranks(got) == (16,)
    np.testing.assert_allclose(got["norm"].numpy(), np.asarray(want["norm"]),
                               rtol=1e-6, atol=1e-7)
    for key in ("conv", "fc"):
        pg = _product(got[key], tlora, _np_t)
        pw = _product(want[key], jlora, _np_j)
        assert np.abs(pg - pw).max() <= 1e-5 * max(np.abs(pw).max(), 1.0)


# -- wire accounting ----------------------------------------------------------

@pytest.mark.parametrize("rank", [None, 4, 8, 16])
def test_rank_downlink_byte_identical(rank):
    tree = _client_tree(20, 16)
    jc = jfl.FLoCoRAConfig(rank=16, quant_bits=8)
    tc = tfl.FLoCoRAConfig(rank=16, quant_bits=8)
    jm = jfl.server_downlink(_j(tree), jc, rank)
    tm = tfl.server_downlink(_t(tree), tc, rank)
    for (n, a), (m, b) in zip(jmsg.message_to_wire(jm),
                              tmsg.message_to_wire(tm)):
        assert n == m and sorted(a) == sorted(b)
        for k in a:
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
    assert tfl.client_wire_bytes(_t(tree), tc, rank) == \
        jfl.client_wire_bytes(_j(tree), jc, rank)


@pytest.mark.parametrize("sched,sparse", [
    (None, None), (dict(tiers=TIERS), None),
    (dict(tiers=TIERS, anneal_every=2), None), (None, dict(density=0.1)),
    (dict(tiers=TIERS), dict(density=0.2, anneal_every=1))])
def test_fleet_tcc_bytes_matches_jax(sched, sparse):
    tree = _client_tree(21, 16)

    def cfgs(mod, rs, sp):
        kw = dict(rank=16, quant_bits=4, error_feedback=True)
        if sched:
            kw["rank_schedule"] = rs.tiered(
                sched["tiers"], 9, anneal_every=sched.get("anneal_every",
                                                          0))
        if sparse:
            kw["sparsity"] = sp(**sparse)
        return mod.FLoCoRAConfig(**kw)

    jc = cfgs(jfl, jfl.RankSchedule, JSparsityConfig)
    tc = cfgs(tfl, tfl.RankSchedule, SparsityConfig)
    for rounds in (1, 5):
        assert tfl.fleet_tcc_bytes(_t(tree), tc, rounds) == \
            jfl.fleet_tcc_bytes(_j(tree), jc, rounds)
    assert tfl.round_wire_bytes(_t(tree), tc, 8, rnd=3) == \
        jfl.round_wire_bytes(_j(tree), jc, 8, rnd=3)
