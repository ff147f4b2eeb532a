"""The fleet's timing models, lazy populations and shards: the port's
numpy copies (``repro_torch/fl/traces.py``, ``fl/population.py``,
``data/synthetic.py``) against the JAX package's, draw for draw. Every
value must be EXACTLY equal: arrival times, churn outcomes, tiers, sampled
cids, shards and schedules are pure functions of (seed, cid, ...)."""
import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro.fl import population as jpop
from repro.fl import traces as jtr
from repro.fl.client import ClientConfig as JClientConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import population as tpop
from repro_torch.fl import traces as ttr
from repro_torch.fl.client import ClientConfig


def _keys(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(c), int(i), int(r), int(b), float(t)) for c, i, r, b, t in
            zip(rng.integers(0, 1_000_000, n), rng.integers(0, 5000, n),
                rng.choice([4, 8, 16, 32], n),
                rng.integers(1_000, 3_000_000, n),
                rng.uniform(0.0, 200_000.0, n))]


def test_tags_and_defaults_match():
    assert (ttr.TAG_LATENCY, ttr.TAG_CHURN) == (jtr.TAG_LATENCY,
                                                jtr.TAG_CHURN)
    assert ttr.LognormalLatency() == ttr.LognormalLatency(
        **vars(jtr.LognormalLatency()))
    assert vars(ttr.AvailabilityWindows()) == vars(jtr.AvailabilityWindows())


@pytest.mark.parametrize("period,duty", [(0.0, 1.0), (600.0, 0.8),
                                         (86400.0, 0.4), (100.0, 1.0)])
def test_availability_windows_exact(period, duty):
    ja, ta = jtr.AvailabilityWindows(period, duty), \
        ttr.AvailabilityWindows(period, duty)
    for cid, _, _, _, t in _keys():
        assert ta.phase(cid) == ja.phase(cid)
        assert ta.next_available(cid, t) == ja.next_available(cid, t)


def test_availability_windows_validation():
    for bad in ((-1.0, 0.5), (10.0, 0.0), (10.0, 1.5)):
        with pytest.raises(ValueError):
            ttr.AvailabilityWindows(*bad)


@pytest.mark.parametrize("p_churn", [0.0, 0.3])
@pytest.mark.parametrize("seed", [0, 7])
def test_fleet_trace_arrival_and_churn_exact(seed, p_churn):
    """Over 1,200 (cid, dispatch_idx) keys: every arrival time and churn
    outcome equals the JAX package's."""
    lat = dict(compute_median_s=45.0, network_mbps=20.0)
    win = (600.0, 0.8)
    jt = jtr.FleetTrace(seed=seed, latency=jtr.LognormalLatency(**lat),
                        availability=jtr.AvailabilityWindows(*win),
                        p_churn=p_churn)
    tt = ttr.FleetTrace(seed=seed, latency=ttr.LognormalLatency(**lat),
                        availability=ttr.AvailabilityWindows(*win),
                        p_churn=p_churn)
    churned = 0
    for cid, idx, rank, nbytes, t in _keys(seed=seed):
        assert tt.arrival(cid, idx, rank, nbytes, t) == \
            jt.arrival(cid, idx, rank, nbytes, t)
        c = tt.churned(cid, idx)
        assert c == jt.churned(cid, idx)
        churned += c
    assert (churned > 0) == (p_churn > 0)


def test_fleet_trace_validation():
    with pytest.raises(ValueError):
        ttr.FleetTrace(p_churn=1.0)
    with pytest.raises(ValueError):
        ttr.LognormalLatency(network_mbps=1e-6, network_sigma=2.0)


def test_device_tier_validation_and_defaults():
    assert [vars(t) for t in tpop.default_tiers()] == \
        [vars(t) for t in jpop.default_tiers()]
    for kw in (dict(rank=0, fraction=0.5), dict(rank=4, fraction=0.0),
               dict(rank=4, fraction=0.5, p_churn=1.0),
               dict(rank=4, fraction=0.5, period_s=-1.0),
               dict(rank=4, fraction=0.5, duty=0.0)):
        with pytest.raises(ValueError):
            jpop.DeviceTier("x", **kw)
        with pytest.raises(ValueError):
            tpop.DeviceTier("x", **kw)


def _tiers(mod):
    return (mod.DeviceTier("phone", rank=4, fraction=0.70, p_churn=0.10,
                           period_s=86400.0, duty=0.4),
            mod.DeviceTier("laptop", rank=8, fraction=0.25, p_churn=0.02),
            mod.DeviceTier("work", rank=16, fraction=0.05))


def _pops(n=1_000_000, seed=3, cache=8, shard_size=24):
    j = jpop.Population(n, _tiers(jpop), seed=seed, shard_size=shard_size,
                        shard_fn=lambda s, c: jsyn.linear_shard(
                            s, c, n=shard_size, d=16),
                        cache_clients=cache)
    t = tpop.Population(n, _tiers(tpop), seed=seed, shard_size=shard_size,
                        shard_fn=lambda s, c: tsyn.linear_shard(
                            s, c, n=shard_size, d=16),
                        cache_clients=cache)
    return j, t


def test_population_tiers_exact():
    jp, tp = _pops()
    for cid, _, _, _, _ in _keys(2000):
        assert tp.tier_index(cid) == jp.tier_index(cid)
        assert tp.rank_for(cid) == jp.rank_for(cid)
        assert tp.p_churn_for(cid) == jp.p_churn_for(cid)
        assert vars(tp.availability_for(cid)) == \
            vars(jp.availability_for(cid))
    assert tp.tier_counts(5000) == jp.tier_counts(5000)
    assert (tp.max_rank, tp.mixed_ranks, tp.expected_churn) == \
        (jp.max_rank, jp.mixed_ranks, jp.expected_churn)
    with pytest.raises(IndexError):
        tp.tier_index(tp.n_clients)


def test_population_validation():
    for args, kw in (((0,), {}), ((10,), {"shard_size": 0}),
                     ((10,), {"cache_clients": 0}), ((10,), {"tiers": ()}),
                     ((10,), {"tiers": (tpop.DeviceTier("a", 4, 0.5),)})):
        with pytest.raises(ValueError):
            tpop.Population(*args, **kw)


@pytest.mark.parametrize("n_busy", [0, 5, 60])
def test_sample_cid_exact(n_busy):
    """``sample_cid`` with a busy set, on a huge fleet (rejection
    sampling) and on a toy one (the explicit scan)."""
    for n in (1_000_000, 64):
        jp = jpop.Population(n, seed=1)
        tp = tpop.Population(n, seed=1)
        rng = np.random.default_rng(5)
        busy = set(int(c) for c in rng.integers(0, n, n_busy))
        for key in range(300):
            a = tp.sample_cid(np.random.default_rng([0, 0xB1, key]), busy)
            b = jp.sample_cid(np.random.default_rng([0, 0xB1, key]), busy)
            assert a == b
            assert a is None or a not in busy
    full = tpop.Population(4, seed=0)
    assert full.sample_cid(np.random.default_rng(0), {0, 1, 2, 3}) is None


def test_lazy_shards_exact_and_bounded():
    jp, tp = _pops(cache=8)
    cids = [3, 999_999, 3, 17, 42, 5, 6, 7, 8, 9, 10, 3, 11]
    for cid in cids:
        a, b = jp[cid], tp[cid]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert tp.peak_resident == jp.peak_resident <= 8
    assert tp.resident_clients == jp.resident_clients
    with pytest.raises(IndexError):
        tp[-1]


def test_client_shard_default_population_exact():
    """The default shard generator (vision shards from ``client_shard``)
    through a Population of the default tiers."""
    jp = jpop.Population(1_000_000, seed=0, shard_size=16, cache_clients=4)
    tp = tpop.Population(1_000_000, seed=0, shard_size=16, cache_clients=4)
    for cid in (0, 123_456, 999_999):
        a, b = jp[cid], tp[cid]
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])


@pytest.mark.parametrize("seed,cid,n,cpc", [(0, 0, 64, 3), (1, 77, 5, 1),
                                            (2, 10 ** 6, 33, 10)])
def test_client_shard_exact(seed, cid, n, cpc):
    a = jsyn.client_shard(seed, cid, n=n, classes_per_client=cpc)
    b = tsyn.client_shard(seed, cid, n=n, classes_per_client=cpc)
    assert a["x"].dtype == b["x"].dtype and a["y"].dtype == b["y"].dtype
    np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(a["y"], b["y"])
    with pytest.raises(ValueError):
        tsyn.client_shard(seed, cid, n=0)
    with pytest.raises(ValueError):
        tsyn.client_shard(seed, cid, classes_per_client=11)


@pytest.mark.parametrize("seed,cid,n,d,c", [(0, 0, 24, 16, 10),
                                            (3, 999, 7, 5, 2)])
def test_linear_shard_exact(seed, cid, n, d, c):
    a = jsyn.linear_shard(seed, cid, n=n, d=d, n_classes=c)
    b = tsyn.linear_shard(seed, cid, n=n, d=d, n_classes=c)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        tsyn.linear_shard(seed, cid, n_classes=1)


@pytest.mark.parametrize("shard,batch,epochs", [(24, 8, 2), (64, 32, 1),
                                                (5, 8, 3)])
def test_schedule_steps_exact(shard, batch, epochs):
    jp = jpop.Population(10, seed=0, shard_size=shard)
    tp = tpop.Population(10, seed=0, shard_size=shard)
    assert tp.schedule_steps(ClientConfig(local_epochs=epochs,
                                          batch_size=batch)) == \
        jp.schedule_steps(JClientConfig(local_epochs=epochs,
                                        batch_size=batch))


def test_population_trace_hooks_exact():
    jp, tp = _pops()
    jt = jpop.PopulationTrace(seed=4, population=jp)
    tt = tpop.PopulationTrace(seed=4, population=tp)
    for cid, idx, rank, nbytes, t in _keys(1500, seed=4):
        assert vars(tt.availability_for(cid)) == \
            vars(jt.availability_for(cid))
        assert tt.p_churn_for(cid) == jt.p_churn_for(cid)
        assert tt.arrival(cid, idx, rank, nbytes, t) == \
            jt.arrival(cid, idx, rank, nbytes, t)
        assert tt.churned(cid, idx) == jt.churned(cid, idx)
    with pytest.raises(ValueError):
        tpop.PopulationTrace(seed=0)
