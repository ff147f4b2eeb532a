"""The port's serving path vs the JAX package's (``repro.serve``), on the
CPU at small widths, with the same numpy-seeded stores and inputs.

  * the per-leaf wire codec: byte-identical ``message_to_wire`` entries,
    decoding across packages, ``FlatPackedMessage.as_tree`` payloads;
  * ``make_store``: bit-equal weights, wire bytes and packed pairs;
  * the cache: the same hits, misses, evictions, entries and bytes for
    one sequence of operations; ``stage``: the same slot maps and
    bit-equal slabs;
  * the engine: fused and dequant steps within atol=5e-5, rtol=1e-4 of
    the JAX engine and of the port's own ``dense_merge`` oracle (the
    reference's engine contract, tests/test_serve.py);
  * the simulator: equal reports under one fake clock.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as J
from repro.core import lora as jlora
from repro.core import messages as jmsg
from repro.core import quant as jquant
from repro.core.quant import QuantConfig as JQuantConfig
from repro.fl import traces as jtraces
from repro_torch import serve as T
from repro_torch.core import lora as tlora
from repro_torch.core import messages as tmsg
from repro_torch.core import quant as tquant
from repro_torch.core.quant import QuantConfig
from repro_torch.fl import traces as ttraces
from repro_torch.kernels import ops as kops
from repro_torch.obs import metrics as tobsm

torch.set_num_threads(1)

ENGINE_TOL = dict(atol=5e-5, rtol=1e-4)


def _tree_np(seed, d=40, r=4, n_layers=2):
    """Adapter pairs, a 1-D leaf and a 4-D leaf, as float32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"layers": [
        {"a": (rng.standard_normal((d, r)) * 0.1).astype(f),
         "b": (rng.standard_normal((r, d)) * 0.1).astype(f)}
        for _ in range(n_layers)],
        "norm": rng.standard_normal(d).astype(f),
        "conv": (rng.standard_normal((3, 3, 4, 6)) * 0.2).astype(f)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _assert_entries_equal(a, b):
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, ba), (_, bb) in zip(a, b):
        assert sorted(ba) == sorted(bb), name
        for key in ba:
            x, y = np.asarray(ba[key]), np.asarray(bb[key])
            assert x.dtype == y.dtype and x.shape == y.shape, (name, key)
            assert x.tobytes() == y.tobytes(), (name, key)


def _messages(bits, seed=0, flat=False):
    tree = _tree_np(seed)
    jm = jmsg.pack_message(_map(jnp.asarray, tree), JQuantConfig(bits=bits),
                           flat=flat)
    tm = tmsg.pack_message(_map(torch.from_numpy, tree),
                           QuantConfig(bits=bits), flat=flat)
    return jm, tm


# -- wire codec -------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_per_leaf_wire_entries_byte_identical(bits):
    jm, tm = _messages(bits)
    assert tmsg.is_packed_leaf(tm["layers"][0]["a"])
    assert not tmsg.is_packed_leaf(tm["norm"])
    _assert_entries_equal(tmsg.message_to_wire(tm), jmsg.message_to_wire(jm))
    assert tmsg.packed_wire_bytes(tm) == jmsg.packed_wire_bytes(jm) \
        == tmsg.message_wire_bytes(tm, QuantConfig(bits=bits))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_per_leaf_messages_decode_across_packages(bits):
    jm, tm = _messages(bits, seed=1)
    # JAX -> port
    got = tmsg.message_from_wire(jmsg.message_to_wire(jm), tm, device="cpu")
    for leaf, want in zip(_wire_leaves(jm), _wire_leaves(got)):
        np.testing.assert_array_equal(np.asarray(leaf.payload),
                                      want.payload.numpy())
    _assert_entries_equal(tmsg.message_to_wire(got), jmsg.message_to_wire(jm))
    # port -> JAX
    back = jmsg.message_from_wire(tmsg.message_to_wire(tm), jm)
    up_j, up_t = jmsg.unpack_message(back), tmsg.unpack_message(tm)
    for name in ("norm", "conv"):
        np.testing.assert_array_equal(np.asarray(up_j[name]),
                                      up_t[name].numpy())
    for lj, lt in zip(up_j["layers"], up_t["layers"]):
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(lj[k]), lt[k].numpy())


def _wire_leaves(msg):
    """The packed leaves of a :func:`_tree_np` message, either package."""
    return [msg["conv"]] + [p[k] for p in msg["layers"] for k in ("a", "b")]


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_flat_as_tree_payloads_match(bits):
    jm, tm = _messages(bits, seed=2, flat=True)
    jt, tt = jm.as_tree(), tm.as_tree()
    for lj, lt in zip(_wire_leaves(jt), _wire_leaves(tt)):
        np.testing.assert_array_equal(np.asarray(lj.payload),
                                      lt.payload.numpy())
        np.testing.assert_array_equal(np.asarray(lj.scale), lt.scale.numpy())
        np.testing.assert_array_equal(np.asarray(lj.zp), lt.zp.numpy())
        assert tuple(lj.shape) == lt.shape
    # the per-leaf view serializes to the flat message's own entries
    _assert_entries_equal(tmsg.message_to_wire(tt),
                          tmsg.message_to_wire(tm))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_levels_roundtrip_matches_jax(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 1 << bits, 37).astype(np.uint8)
    got = tquant.pack_levels(torch.from_numpy(q), bits)
    want = jquant.pack_levels(jnp.asarray(q), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tquant.unpack_levels(got, bits, 37).numpy(), q)


def test_dense_merge_and_apply_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    a = rng.standard_normal((16, 4)).astype(np.float32)
    b = rng.standard_normal((4, 12)).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tlora.dense_merge(*map(torch.from_numpy, (w, a, b)), 2.0).numpy(),
        np.asarray(jlora.dense_merge(*map(jnp.asarray, (w, a, b)), 2.0)),
        rtol=1e-6, atol=1e-6)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2e-2)):
        got = tlora.dense_lora_apply(*map(torch.from_numpy, (x, a, b)), 0.5,
                                     compute_dtype=dt)
        want = jlora.dense_lora_apply(*map(jnp.asarray, (x, a, b)), 0.5,
                                      compute_dtype=jdt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def test_extract_pairs_flat_per_leaf_and_packages_agree():
    tree = _tree_np(5)
    del tree["norm"], tree["conv"]
    q = QuantConfig(bits=4)
    r1, p1 = T.extract_pairs(tmsg.pack_message(
        _map(torch.from_numpy, tree), q, flat=False), 4)
    r2, p2 = T.extract_pairs(tmsg.pack_message(
        _map(torch.from_numpy, tree), q, flat=True), 4)
    r3, p3 = J.extract_pairs(jmsg.pack_message(
        _map(jnp.asarray, tree), JQuantConfig(bits=4), flat=False), 4)
    assert r1 == r2 == r3 == 4
    for q1, q2, q3 in zip(p1, p2, p3):
        for f in ("aq", "a_scale", "a_zp", "bq", "b_scale", "b_zp"):
            np.testing.assert_array_equal(getattr(q1, f), getattr(q2, f))
            np.testing.assert_array_equal(getattr(q1, f), getattr(q3, f))


def test_lognormal_latency_matches_jax():
    kw = dict(compute_median_s=5e-4, compute_sigma=0.3, network_mbps=1000.0,
              network_sigma=0.2, rank_exp=0.0)
    a, b = ttraces.LognormalLatency(**kw), jtraces.LognormalLatency(**kw)
    for i in range(5):
        assert a.sample(np.random.default_rng([0, i]), 8, 4096) == \
            b.sample(np.random.default_rng([0, i]), 8, 4096)
    with pytest.raises(ValueError):
        ttraces.LognormalLatency(network_mbps=1e-6, network_sigma=3.0)


# -- store and cache --------------------------------------------------------

@pytest.fixture(scope="module")
def stores():
    jw, js = J.make_store(16, d_model=64, seed=0)
    tw, ts = T.make_store(16, d_model=64, seed=0, device="cpu")
    return jw, js, tw, ts


def test_make_store_bit_equal(stores):
    jw, js, tw, ts = stores
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert js.cids == ts.cids and js.ranks == ts.ranks
    for c in js.cids:
        assert js.bytes_of(c) == ts.bytes_of(c)
        assert tmsg.is_wire_leaf(ts.msgs[c]) == (c % 2 == 0)
        rj, pj = J.extract_pairs(js.msgs[c], 4)
        rt, pt = T.extract_pairs(ts.msgs[c], 4)
        assert rj == rt
        for a, b in zip(pj, pt):
            for f in ("aq", "a_scale", "a_zp", "bq", "b_scale", "b_zp"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _cache_script(cache, store, policy):
    """One sequence of put/lookup/pin/unpin; returns what it observed."""
    seen = []
    for c in (0, 1, 2, 0, 3):
        if cache.lookup(c) is None:
            cache.put(c, store.msgs[c])
        seen.append((c, sorted(cache._entries), cache.nbytes))
    cache.pin(3)
    cache.pin(3)
    for c in (4, 5, 1, 6, 3, 7):
        if cache.lookup(c) is None:
            cache.put(c, store.msgs[c])
        seen.append((c, list(cache._entries), cache.nbytes))
    cache.unpin(3)
    cache.unpin(3)
    cache.put(8, store.msgs[8])
    seen.append(list(cache._entries))
    return seen, cache.stats()


@pytest.mark.parametrize("policy", ["lru", "clock"])
def test_cache_counters_match_jax(stores, policy):
    _, js, _, ts = stores
    cap = 3 * js.bytes_of(1)
    reg = tobsm.MetricsRegistry()
    tc = T.AdapterCache(cap, ts.qcfg, policy=policy, registry=reg,
                        device="cpu")
    jc = J.AdapterCache(cap, js.qcfg, policy=policy)
    got, want = _cache_script(tc, ts, policy), _cache_script(jc, js, policy)
    assert got == want
    assert got[1]["evictions"] > 0 and got[1]["hits"] > 0
    assert reg.counter_value("serve.cache.evictions") == \
        got[1]["evictions"]
    assert reg.counter_value("serve.cache.hits") == got[1]["hits"]


def test_stage_slots_and_slabs_bit_equal(stores):
    _, js, _, ts = stores
    jc = J.AdapterCache(1 << 22, js.qcfg)
    tc = T.AdapterCache(1 << 22, ts.qcfg, device="cpu")
    cids = [5, 2, 9, 0, 13, 2, 6]
    for c in cids:
        jc.put(c, js.msgs[c])
        tc.put(c, ts.msgs[c])
    js_, ts_ = jc.stage(cids, min_slots=4), tc.stage(cids, min_slots=4)
    assert sorted(js_) == sorted(ts_) == [4, 8]
    for rb in js_:
        assert js_[rb].slots == ts_[rb].slots
        assert js_[rb].n_slots == ts_[rb].n_slots
        for lj, lt in zip(js_[rb].layers, ts_[rb].layers):
            for a, b in zip(lj, lt):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(KeyError):
        tc.stage([99])


# -- engine -----------------------------------------------------------------

def _engines(n_clients=16, bits=4, path="fused", d=64):
    jw, js = J.make_store(n_clients, d_model=d, bits=bits, seed=0)
    tw, ts = T.make_store(n_clients, d_model=d, bits=bits, seed=0,
                          device="cpu")
    je = J.AdapterServingEngine(jw, 0.5, js.qcfg,
                                J.AdapterCache(1 << 22, js.qcfg),
                                fetch=js.fetch, path=path)
    te = T.AdapterServingEngine(tw, 0.5, ts.qcfg,
                                T.AdapterCache(1 << 22, ts.qcfg,
                                               device="cpu"),
                                fetch=ts.fetch, path=path, device="cpu")
    return je, te, js, ts


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("batch", [5, 8, 13])
def test_engine_steps_match_jax_and_oracle(bits, batch):
    je, te, _, _ = _engines(bits=bits)
    rng = np.random.default_rng(batch)
    cids = [int(c) for c in rng.integers(0, 16, batch)]   # mixed ranks
    x = (rng.standard_normal((batch, 64)) * 0.5).astype(np.float32)
    je.admit(cids)
    te.admit(cids)
    y = te.step(torch.from_numpy(x), cids)
    assert y.shape == (batch, 64) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(
        je.step(jnp.asarray(x), cids)), **ENGINE_TOL)
    np.testing.assert_allclose(
        y.numpy(), te.oracle_step(torch.from_numpy(x), cids).numpy(),
        **ENGINE_TOL)
    td = T.AdapterServingEngine(te.weights, 0.5, te.qcfg, te.cache,
                                path="dequant", device="cpu")
    jd = J.AdapterServingEngine(je.weights, 0.5, je.qcfg, je.cache,
                                path="dequant")
    yd = td.step(torch.from_numpy(x), cids)
    np.testing.assert_allclose(yd.numpy(), np.asarray(
        jd.step(jnp.asarray(x), cids)), **ENGINE_TOL)
    np.testing.assert_allclose(yd.numpy(), y.numpy(), **ENGINE_TOL)


def test_fused_path_never_materializes_fp32_adapters(monkeypatch):
    _, te, _, _ = _engines()

    def boom(*a, **kw):
        raise AssertionError("fp32 adapter materialization on the "
                             "serving path")

    monkeypatch.setattr(tmsg, "unpack_message", boom)
    monkeypatch.setattr(T.PackedPair, "dequant", boom)
    cids = [0, 1, 2, 3, 0]
    te.admit(cids)
    kops.reset_launch_counts()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, 64)).astype(np.float32))
    assert torch.isfinite(te.step(x, cids)).all()


def test_rank_bucket_padding_and_restaging():
    """Rank-6 adapters served from the pow2-8 bucket match serving the
    compact rank-6 slabs; a new client restages the working set."""
    bits, d, r = 4, 32, 6
    qcfg = QuantConfig(bits=bits)
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.standard_normal((d, d)) * 0.05).astype(
        np.float32))
    msgs = {}
    for c in range(4):
        tree = {"layers": [{"a": torch.from_numpy((rng.standard_normal(
            (d, r)) * 0.1).astype(np.float32)), "b": torch.from_numpy(
            (rng.standard_normal((r, d)) * 0.1).astype(np.float32))}]}
        msgs[c] = tmsg.pack_message(tree, qcfg, flat=(c == 0))
    cache = T.AdapterCache(1 << 20, qcfg, device="cpu")
    eng = T.AdapterServingEngine([w], 0.5, qcfg, cache,
                                 fetch=msgs.__getitem__, slab_slots=1,
                                 device="cpu")
    cids = [0, 1, 2, 0]
    eng.admit(cids)
    x = torch.from_numpy((rng.standard_normal((4, d)) * 0.5).astype(
        np.float32))
    y = eng.step(x, cids)
    pairs = [cache.peek(c).pairs[0] for c in range(3)]
    rw = -(-r // (32 // bits))
    slab = [torch.from_numpy(np.stack([getattr(p, f) for p in pairs]))
            for f in ("aq", "a_scale", "a_zp")]
    slab += [torch.from_numpy(np.stack([p.bq[:, :rw] for p in pairs]))]
    slab += [torch.from_numpy(np.stack([getattr(p, f) for p in pairs]))
             for f in ("b_scale", "b_zp")]
    want = kops.multi_lora_matmul_packed(x, w, *slab, [0, 1, 2, 0], 0.5,
                                         bits)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
    staged = eng._staged[8][1]
    assert staged.slots == {0: 0, 1: 1, 2: 2} and staged.n_slots == 4
    eng.admit([3])
    eng.step(x[:1], [3])
    assert eng._staged[8][1].slots == {0: 0, 1: 1, 2: 2, 3: 3}


def test_engine_rejects_unported_and_bad_options(stores):
    _, _, tw, ts = stores
    cache = T.AdapterCache(1 << 20, ts.qcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        T.AdapterServingEngine(tw, 0.5, ts.qcfg, cache,
                               strict_compiles=True, device="cpu")
    with pytest.raises(ValueError):
        T.AdapterServingEngine(tw, 0.5, ts.qcfg, cache, path="merged",
                               device="cpu")
    eng = T.AdapterServingEngine(tw, 0.5, ts.qcfg, cache, device="cpu")
    with pytest.raises(KeyError):
        eng.admit([0])                      # no fetch callback
    with pytest.raises(KeyError):
        eng.step(torch.zeros((1, 64)), [0])


# -- simulator --------------------------------------------------------------

class _FakeTime:
    """``perf_counter`` advances 0.5 ms a call: both simulators see the
    same step times, so their reports are deterministic."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 5e-4
        return self.t


def test_simulator_reports_equal_under_fake_clock(monkeypatch):
    import repro.serve.simulator as jsim
    import repro_torch.serve.simulator as tsim
    monkeypatch.setattr(jsim, "time", _FakeTime())
    monkeypatch.setattr(tsim, "time", _FakeTime())
    wl = J.WorkloadConfig(n_requests=12, rate_rps=5000.0, gen_tokens=2,
                          max_batch=4, seed=0)
    twl = T.WorkloadConfig(n_requests=12, rate_rps=5000.0, gen_tokens=2,
                           max_batch=4, seed=0)
    reps = []
    for cap in (1 << 20, None):
        je, te, js, ts = _engines(n_clients=8, d=32)
        if cap is None:           # a cache of ~3 adapters: evictions
            cap = 3 * js.bytes_of(1)
            je.cache = J.AdapterCache(cap, js.qcfg, policy="clock")
            te.cache = T.AdapterCache(cap, ts.qcfg, policy="clock",
                                      device="cpu")
        rj = J.simulate(je, js, wl)
        rt = T.simulate(te, ts, twl)
        for key in ("requests", "steps", "hits", "misses", "evictions",
                    "store_fetches", "p50_ms", "p99_ms", "cache_entries",
                    "cache_bytes"):
            assert rt[key] == rj[key], key
        reps.append(rt)
    assert reps[1]["evictions"] > 0
    assert reps[0]["hits"] + reps[0]["misses"] == 12


def test_draw_requests_match_jax(stores):
    _, js, _, ts = stores
    from repro.serve.simulator import _draw_requests as jdraw
    from repro_torch.serve.simulator import _draw_requests as tdraw
    wl = dict(n_requests=40, rate_rps=800.0, zipf_a=1.2, seed=3)
    got = [(r.cid, r.t_arrive) for r in tdraw(ts, T.WorkloadConfig(**wl))]
    want = [(r.cid, r.t_arrive) for r in jdraw(js, J.WorkloadConfig(**wl))]
    assert got == want
