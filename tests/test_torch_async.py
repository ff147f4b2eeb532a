"""The event-driven FedBuff engine and the sync server's fleet options:
the port's ``AsyncFLServer`` / ``FLServer`` against the JAX package's on
the JAX async tests' linear LoRA workload (a frozen (16, 10) weight with a
rank-r adapter and a bias), from one seed on the CPU.

Nothing in dispatch, arrival or churn depends on a number the training
computes, so every flush record's event fields and byte counters must be
EXACTLY the JAX engine's; ``client_loss`` (and ``eval_loss``) within
rtol 1e-4 and the global tree within atol 1e-5. Params come across with
``convert.params_from_jax``."""
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import messages as jmsg
from repro.core.flocora import FLoCoRAConfig as JFLoCoRAConfig
from repro.core.flocora import RankSchedule as JRankSchedule
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.lora import linear_apply as jlinear_apply
from repro.core.lora import linear_init as jlinear_init
from repro.core.quant import DPConfig as JDPConfig
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.sparse import SparsityConfig as JSparsityConfig
from repro.data import synthetic as jsyn
from repro.fl import population as jpop
from repro.fl import AsyncConfig as JAsyncConfig
from repro.fl import AsyncFLServer as JAsyncFLServer
from repro.fl import ClientConfig as JClientConfig
from repro.fl import FLServer as JFLServer
from repro.fl import FleetTrace as JFleetTrace
from repro.fl import LognormalLatency as JLognormalLatency
from repro.fl import ServerConfig as JServerConfig
from repro.utils.tree import flatten_with_names as jnames
from repro_torch import convert
from repro_torch.core import aggregation as tagg
from repro_torch.core import lora as tlora
from repro_torch.core import messages as tmsg
from repro_torch.core.flocora import FLoCoRAConfig, RankSchedule
from repro_torch.core.quant import DPConfig, QuantConfig
from repro_torch.core.sparse import SparsityConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import AsyncConfig, AsyncFLServer, ClientConfig, \
    DeviceTier, FLServer, FleetTrace, LognormalLatency, Population, \
    PopulationTrace, ServerConfig, time_to_target
from repro_torch.fl import async_engine
from repro_torch.fl import population as tpop
from repro_torch.utils.tree import flatten_with_names as tnames

torch.set_num_threads(1)

CCFG = dict(local_epochs=2, batch_size=8, lr=0.1)
EVENT_KEYS = ("version", "t_virtual", "n_arrived", "n_flushed",
              "n_churned", "staleness_mean", "staleness_max", "flush_ranks",
              "down_bytes", "up_bytes", "tcc_bytes", "wasted_bytes",
              "uplink_density", "dp_epsilon")


# -- the linear LoRA workload (tests/test_async_engine.py) -------------------

def _jax_model(rank=16):
    fz, tr = jlinear_init(jax.random.PRNGKey(0), 16, 10, "lora",
                          JLoRAConfig(rank=rank, alpha=float(rank)),
                          base_dtype=jnp.float32)
    return {"frozen": {"lin": fz},
            "train": {"lin": tr, "bias": jnp.zeros((10,))}}


def _models(rank=16):
    jm = _jax_model(rank)
    return jm, convert.params_from_jax(jax.device_get(jm), device="cpu")


def _jax_loss(frozen, train, batch):
    logits = jlinear_apply(frozen["lin"], train["lin"], batch["x"], 1.0,
                           jnp.float32) + train["bias"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, batch["y"][:, None],
                                         axis=1)), {}


def _torch_loss(frozen, train, batch):
    logits = tlora.linear_apply(frozen["lin"], train["lin"], batch["x"],
                                1.0, torch.float32) + train["bias"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1,
                                    batch["y"].long()[:, None])), {}


def _data(n=240, n_clients=10, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(16, 10)).astype(np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = np.argmax(x @ w_true + 0.1 * rng.normal(size=(n, 10)),
                  axis=1).astype(np.int32)
    parts = np.array_split(rng.permutation(n), n_clients)
    return [{"x": x[p], "y": y[p]} for p in parts], {"x": x, "y": y}


def _eval_fns(full):
    jfull = jax.tree.map(jnp.asarray, full)
    tfull = {k: torch.from_numpy(v) for k, v in full.items()}
    return (lambda f, t: {"eval_loss": float(_jax_loss(f, t, jfull)[0])},
            lambda f, t: {"eval_loss": float(_torch_loss(f, t, tfull)[0])})


def _fcfgs(mode="tiered", rank=16, n_clients=10):
    """(JAX config, port config)."""
    def build(FL, RS, DP, SP):
        if mode == "tiered":
            return FL(rank=rank, alpha=float(rank), quant_bits=8,
                      rank_schedule=RS.tiered((8, rank), n_clients))
        if mode == "dp":
            return FL(rank=rank, alpha=float(rank), quant_bits=8,
                      dp=DP(clip_norm=1.0, noise_multiplier=0.3))
        if mode == "fp":
            return FL(rank=rank, alpha=float(rank))
        if mode == "sparse":
            return FL(rank=rank, alpha=float(rank), quant_bits=4,
                      sparsity=SP(density=0.25, require_ef=False))
        if mode == "perleaf":
            return FL(rank=rank, alpha=float(rank), quant_bits=4,
                      flat_wire=False)
        return FL(rank=rank, alpha=float(rank), quant_bits=8)
    return (build(JFLoCoRAConfig, JRankSchedule, JDPConfig, JSparsityConfig),
            build(FLoCoRAConfig, RankSchedule, DPConfig, SparsityConfig))


def _traces(seed=0, p_churn=0.0):
    lat = dict(compute_median_s=10.0, network_mbps=20.0)
    return (JFleetTrace(seed=seed, latency=JLognormalLatency(**lat),
                        p_churn=p_churn),
            FleetTrace(seed=seed, latency=LognormalLatency(**lat),
                       p_churn=p_churn))


def _engines(data, acfg, mode="tiered", traces=None, eval_full=None,
             ckpt=(None, None), tdata=None):
    jc, tc = _fcfgs(mode, n_clients=len(data))
    jt, tt = traces or _traces()
    jm, tm = _models()
    jev = tev = None
    if eval_full is not None:
        jev, tev = _eval_fns(eval_full)
    js = JAsyncFLServer(jm, _jax_loss, data,
                        JAsyncConfig(**acfg, checkpoint_dir=ckpt[0]),
                        JClientConfig(**CCFG), jc, trace=jt, eval_fn=jev)
    ts = AsyncFLServer(tm, _torch_loss, data if tdata is None else tdata,
                       AsyncConfig(**acfg, checkpoint_dir=ckpt[1]),
                       ClientConfig(**CCFG), tc, trace=tt, eval_fn=tev,
                       device="cpu")
    return js, ts


def _hold_history(jh, th):
    assert len(th) == len(jh) > 0
    for a, b in zip(jh, th):
        assert set(a) == set(b)
        for key in EVENT_KEYS:
            assert b.get(key) == a.get(key), (a["version"], key)
        for key in ("client_loss", "eval_loss"):
            if key in a:
                np.testing.assert_allclose(b[key], a[key], rtol=1e-4)


def _hold_tree(jtree, ttree, atol=1e-5):
    for (na, a), (nb, b) in zip(jnames(jax.device_get(jtree)),
                                tnames(ttree)):
        assert na == nb
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=atol)


def _acfg(**kw):
    base = dict(total_arrivals=30, concurrency=4, buffer_size=5,
                microbatch_window=8.0, seed=0)
    base.update(kw)
    return base


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["batched", "streaming"])
def test_async_history_matches_jax(streaming):
    """A two-tier (r 8 / 16) int8 fleet with eval every 2 flushes."""
    data, full = _data()
    js, ts = _engines(data, _acfg(streaming_agg=streaming, eval_every=2),
                      eval_full=full)
    jh, th = js.run(), ts.run()
    assert len(th) == 6 and "eval_loss" in th[1]
    _hold_history(jh, th)
    _hold_tree(js.global_train, ts.global_train)
    assert ts.program_keys == js.program_keys
    assert len(ts.program_keys) <= 2 * (int(math.log2(4)) + 1)
    assert ts.tcc_bytes == th[-1]["tcc_bytes"] == ts.initial_model_bytes \
        + th[-1]["down_bytes"] + th[-1]["up_bytes"]
    hit = time_to_target(th, "client_loss", th[-1]["client_loss"])
    assert hit is not None and hit["tcc_bytes"] <= th[-1]["tcc_bytes"]
    assert time_to_target(th, "eval_loss", -1.0) is None
    assert time_to_target(th, "eval_loss", 0.0, mode="max")["version"] == 2


@pytest.mark.parametrize("mode", ["dp", "sparse", "perleaf"])
def test_async_wire_modes_match_jax(mode):
    """DP uplinks (``dp_epsilon`` per flush equal), sparse top-k uplinks
    and the per-leaf wire through the same event loop."""
    data, _ = _data()
    js, ts = _engines(data, _acfg(total_arrivals=20, concurrency=3,
                                  buffer_size=5), mode=mode)
    jh, th = js.run(), ts.run()
    _hold_history(jh, th)
    if mode == "dp":
        assert all("dp_epsilon" in h for h in th)
    # sparse top-k can flip a pick where the training differs in the
    # last digits; each flush then moves one survivor
    _hold_tree(js.global_train, ts.global_train,
               atol=5e-4 if mode == "sparse" else 1e-5)


def test_async_churning_population_matches_jax():
    """A 100k-client lazy Population with churning diurnal tiers on
    streaming FedBuff: every churned dispatch, wasted byte and flush
    equal to the JAX engine's; peak resident shards bounded."""
    def tiers(mod):
        return (mod.DeviceTier("phone", rank=4, fraction=0.70,
                               p_churn=0.25, period_s=86400.0, duty=0.4),
                mod.DeviceTier("laptop", rank=8, fraction=0.25,
                               p_churn=0.1),
                mod.DeviceTier("work", rank=16, fraction=0.05))

    jp = jpop.Population(100_000, tiers(jpop), seed=1, shard_size=24,
                         shard_fn=lambda s, c: jsyn.linear_shard(
                             s, c, n=24, d=16), cache_clients=16)
    tp = Population(100_000, tiers(tpop), seed=1, shard_size=24,
                    shard_fn=lambda s, c: tsyn.linear_shard(
                        s, c, n=24, d=16), cache_clients=16)
    acfg = _acfg(total_arrivals=30, concurrency=8, buffer_size=10,
                 streaming_agg=True, microbatch_window=1200.0, seed=1)
    js, ts = _engines(jp, acfg, mode="int8",
                      traces=(jpop.PopulationTrace(seed=1, population=jp),
                              PopulationTrace(seed=1, population=tp)),
                      tdata=tp)
    jh, th = js.run(), ts.run()
    _hold_history(jh, th)
    _hold_tree(js.global_train, ts.global_train)
    assert ts.n_churned == js.n_churned > 0
    assert ts.wire.wasted == th[-1]["wasted_bytes"] > 0
    assert tp.peak_resident == jp.peak_resident <= 16
    assert len({r for h in th for r in h["flush_ranks"]}) >= 2


def test_fp_wire_flush_does_not_touch_inflight_starts():
    """Quantization off: a broadcast IS the global tree. With clients in
    flight across flushes, a flush must build a new global tree, never
    write the one the in-flight starts alias."""
    data, _ = _data()
    js, ts = _engines(data, _acfg(total_arrivals=24, concurrency=6,
                                  buffer_size=3, microbatch_window=0.0),
                      mode="fp")
    ts._fill_pipeline()
    g0 = ts.global_train
    snap = {n: x.clone() for n, x in tnames(g0)}
    starts = [r.start for r in ts.inflight.values()]
    assert starts and all(x is y for s in starts for (_, x), (_, y) in
                          zip(tnames(s), tnames(g0)))
    while ts.version == 0:
        ts.step()
    assert ts.global_train is not g0
    for n, x in tnames(g0):
        assert torch.equal(x, snap[n]), n
    assert any(r.version == 0 for r in ts.inflight.values())
    th = ts.run()
    jh = js.run()
    _hold_history(jh, th)
    _hold_tree(js.global_train, ts.global_train)
    assert max(h["staleness_max"] for h in th) > 0


def _keep_oldest(src, dst):
    os.makedirs(dst)
    for fn in os.listdir(src):
        shutil.copy(os.path.join(src, fn), dst)
    steps = sorted(int(f[5:-5]) for f in os.listdir(dst)
                   if f.endswith(".json"))
    assert len(steps) >= 2
    for s in steps[1:]:
        for ext in (".npz", ".json"):
            os.remove(os.path.join(dst, f"ckpt_{s:08d}{ext}"))
    return steps[0]


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["batched", "streaming"])
def test_port_resume_is_bit_exact(tmp_path, streaming):
    """A port run killed and resumed from its oldest checkpoint replays
    the rest of the history and the final tree bit for bit."""
    data, _ = _data()
    acfg = _acfg(streaming_agg=streaming, checkpoint_every=2)

    def engine(d):
        return AsyncFLServer(_models()[1], _torch_loss, data,
                             AsyncConfig(**acfg, checkpoint_dir=d),
                             ClientConfig(**CCFG), _fcfgs()[1],
                             trace=_traces()[1], device="cpu")

    a = engine(str(tmp_path / "a"))
    ha = a.run()
    first = _keep_oldest(str(tmp_path / "a"), str(tmp_path / "b"))
    b = engine(str(tmp_path / "b"))
    assert b.try_resume()
    assert b.n_flushes == first < a.n_flushes and b.inflight
    assert any(r.msg is not None for r in b.inflight.values())
    assert b.aggregator.buffered == 0
    assert b.run() == ha
    for (n, x), (_, y) in zip(tnames(a.global_train),
                              tnames(b.global_train)):
        assert torch.equal(x, y), n


def test_port_resume_streams_three_tiers_bit_exact(tmp_path):
    """Streaming FedBuff over three rank tiers, resumed from each of its
    checkpoints: a resumed run creates its stream accumulators anew, in
    the order its first arrivals come, and the flush must sum the
    streams' means in the same order as the uninterrupted run (ascending
    rank), or the global tree moves by an ulp and the runs part."""
    def run(d, resume=False):
        pop = Population(10_000, (
            DeviceTier("a", rank=4, fraction=0.4),
            DeviceTier("b", rank=8, fraction=0.3),
            DeviceTier("c", rank=16, fraction=0.3)), seed=1, shard_size=24,
            shard_fn=lambda s, c: tsyn.linear_shard(s, c, n=24, d=16),
            cache_clients=32)
        eng = AsyncFLServer(
            _models()[1], _torch_loss, pop,
            AsyncConfig(**_acfg(total_arrivals=40, concurrency=8,
                                buffer_size=4, streaming_agg=True,
                                microbatch_window=20.0, seed=1),
                        checkpoint_dir=d, checkpoint_every=1),
            ClientConfig(**CCFG), _fcfgs("int8")[1],
            trace=PopulationTrace(seed=1, population=pop), device="cpu")
        eng.ckpt.keep_n = 0
        if resume:
            assert eng.try_resume()
        return eng, eng.run()

    a, ha = run(str(tmp_path / "a"))
    orders = set()
    for step in range(1, len(ha)):
        d = tmp_path / f"b{step}"
        d.mkdir()
        for ext in (".npz", ".json"):
            shutil.copy(tmp_path / "a" / f"ckpt_{step:08d}{ext}", d)
        b, hb = run(str(d), resume=True)
        orders.add(tuple(lora_rank(st) for st in b.aggregator.streams.values()))
        assert hb == ha, step
        for (n, x), (_, y) in zip(tnames(a.global_train),
                                  tnames(b.global_train)):
            assert torch.equal(x, y), (step, n)
    # the resumed runs did create their streams in other orders
    assert len(orders) > 1


def lora_rank(st):
    return tlora.tree_max_rank(st.shape_tree())


@pytest.mark.parametrize("mode", ["tiered", "dp"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, mode):
    """A JAX engine's checkpoint (in-flight starts and computed uplinks
    included) resumes in the port, whose rest of the run matches the JAX
    run by the event/loss/tree contract."""
    data, _ = _data()
    acfg = _acfg(checkpoint_every=2)
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    js, _ = _engines(data, acfg, mode=mode, ckpt=(da, None))
    jh = js.run()
    first = _keep_oldest(da, db)
    _, ts = _engines(data, acfg, mode=mode, ckpt=(None, db))
    assert ts.try_resume()
    assert ts.n_flushes == first
    msgs = [r.msg for r in ts.inflight.values() if r.msg is not None]
    assert msgs and all(tmsg.is_wire_leaf(m) for m in msgs)
    _hold_history(jh, ts.run())
    _hold_tree(js.global_train, ts.global_train)


@pytest.mark.parametrize("kind", ["flat", "perleaf", "sparse", "fp"])
def test_message_checkpoint_names_match_jax(kind):
    """``message_arrays`` names a wire message's tensors as the JAX
    package's checkpoint flattens its pytree (``[<flat index i>]``)."""
    rng = np.random.default_rng(0)
    tree = {"lin": {"a": rng.normal(size=(16, 8)).astype(np.float32),
                    "b": rng.normal(size=(8, 10)).astype(np.float32)},
            "bias": rng.normal(size=(10,)).astype(np.float32)}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = convert.params_from_jax(tree, device="cpu")
    kw = {"flat": dict(flat=True), "perleaf": dict(flat=False),
          "sparse": dict(density=0.5), "fp": {}}[kind]
    bits = None if kind == "fp" else 4
    jm = jmsg.pack_message(jt, JQuantConfig(bits=bits), **kw)
    tm = tmsg.pack_message(tt, QuantConfig(bits=bits), **kw)
    arrays = async_engine.message_arrays(tm)
    got = tnames(arrays)
    want = jnames(jm)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = async_engine.message_from_arrays(tm, arrays)
    for a, b in zip(tnames(tmsg.unpack_message(back)),
                    tnames(tmsg.unpack_message(tm))):
        assert torch.equal(a[1], b[1])
    assert type(back) is type(tm)


def test_async_config_validation():
    with pytest.raises(ValueError):
        AsyncConfig(buffer_size=0)
    with pytest.raises(ValueError):
        AsyncConfig(half_life=0.0)
    with pytest.raises(ValueError):
        AsyncConfig(microbatch_window=-1.0)
    with pytest.raises(ValueError):
        AsyncConfig(server_lr=0.0)
    data, _ = _data()
    model = _models()[1]

    def engine(fcfg, data=data, acfg=None, **kw):
        return AsyncFLServer(model, _torch_loss, data,
                             acfg or AsyncConfig(total_arrivals=4),
                             ClientConfig(), fcfg, device="cpu", **kw)

    with pytest.raises(ValueError, match="error feedback"):
        engine(FLoCoRAConfig(rank=16, alpha=16.0, quant_bits=8,
                             error_feedback=True))
    with pytest.raises(ValueError, match="FedBuffAggregator"):
        engine(_fcfgs()[1], aggregator=tagg.FedAvgAggregator())
    with pytest.raises(ValueError, match="rank_schedule"):
        engine(_fcfgs()[1], data=data[:4])
    with pytest.raises(ValueError, match="r_target"):
        engine(_fcfgs()[1], aggregator=tagg.FedBuffAggregator(r_target=8))
    strict = engine(_fcfgs()[1], acfg=AsyncConfig(strict_compiles=True,
                                                  streaming_agg=True))
    assert strict.aggregator.strict_compiles and strict.aggregator.streaming
    pop = Population(100, tiers=(DeviceTier("big", rank=32,
                                            fraction=1.0),))
    with pytest.raises(ValueError, match="exceeds the server rank"):
        engine(FLoCoRAConfig(rank=16, alpha=16.0), data=pop)
    eng = engine(_fcfgs()[1], acfg=AsyncConfig(half_life=3.0))
    assert eng.aggregator.half_life == 3.0
    assert eng.aggregator.r_target == 16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            AsyncFLServer(model, _torch_loss, data, AsyncConfig(),
                          ClientConfig(), _fcfgs()[1])


# -- the sync server's fleet options -----------------------------------------

def _sync_pair(data, fcfgs, scfg, jagg_=None, tagg_=None, traces=None,
               tdata=None):
    jm, tm = _models()
    jt, tt = traces or (None, None)
    js = JFLServer(jm, _jax_loss, data, JServerConfig(**scfg),
                   JClientConfig(**CCFG), fcfgs[0], aggregator=jagg_,
                   trace=jt)
    ts = FLServer(tm, _torch_loss, data if tdata is None else tdata,
                  ServerConfig(**scfg), ClientConfig(**CCFG), fcfgs[1],
                  aggregator=tagg_, trace=tt, device="cpu")
    return js, ts


SYNC_KEYS = ("round", "n_agg", "n_dropped", "n_straggled", "cohort_ranks",
             "down_bytes", "up_bytes", "round_bytes", "tcc_bytes",
             "wasted_bytes", "uplink_density", "up_bytes_measured",
             "up_bytes_by_rank")


def _hold_sync(js, ts, rounds):
    for _ in range(rounds):
        a, b = js.run_round(), ts.run_round()
        assert set(a) == set(b)
        for key in SYNC_KEYS:
            assert b.get(key) == a.get(key), key
        np.testing.assert_allclose(b["client_loss"], a["client_loss"],
                                   rtol=1e-4)
    _hold_tree(js.global_train, ts.global_train)


@pytest.mark.parametrize("p_fail", [0.0, 0.2])
def test_sync_deadline_cohorts_match_jax(p_fail):
    """Deadline cohorts from a FleetTrace (oversample 1.5): stragglers
    and wasted bytes exactly the JAX server's, round after round."""
    data, _ = _data()
    js, ts = _sync_pair(data, _fcfgs("int8"),
                        dict(n_clients=10, clients_per_round=4,
                             oversample=1.5, p_client_failure=p_fail,
                             seed=2),
                        traces=_traces(seed=3))
    _hold_sync(js, ts, 3)
    assert sum(h["n_straggled"] for h in ts.history) > 0
    assert ts.wire.wasted == sum(h["wasted_bytes"] for h in ts.history)


def test_sync_population_fleet_matches_jax():
    """A lazy 50k-client Population of three rank tiers (no schedule):
    per-tier truncated broadcasts, mixed-rank cohorts, measured bytes."""
    def make(pop_mod, syn):
        return pop_mod.Population(
            50_000, seed=2, shard_size=24, cache_clients=64,
            shard_fn=lambda s, c: syn.linear_shard(s, c, n=24, d=16))
    jp = make(jpop, jsyn)
    tp = make(tpop, tsyn)
    js, ts = _sync_pair(jp, _fcfgs("int8"),
                        dict(n_clients=50_000, clients_per_round=6,
                             seed=1), tdata=tp)
    assert ts.wire.hetero and ts.cohort_schedule_steps == \
        js.cohort_schedule_steps
    _hold_sync(js, ts, 2)
    assert len({r for h in ts.history for r in h["cohort_ranks"]}) >= 2


@pytest.mark.parametrize("rank_staleness", [False, True])
def test_sync_fedbuff_mixed_ranks_matches_jax(rank_staleness):
    """FedBuffAggregator on a mixed-rank (8 / 16) schedule: the half-life
    threaded from ServerConfig, the rank-bucketed flush as the JAX
    server's."""
    data, _ = _data()
    scfg = dict(n_clients=10, clients_per_round=6, seed=0,
                fedbuff_half_life=2.5)
    js, ts = _sync_pair(
        data, _fcfgs("tiered"), scfg,
        jagg_=jagg.FedBuffAggregator(rank_staleness=rank_staleness),
        tagg_=tagg.FedBuffAggregator(rank_staleness=rank_staleness))
    assert ts.aggregator.half_life == 2.5 and ts.aggregator.r_target == 16
    _hold_sync(js, ts, 2)
    assert tlora.tree_ranks(ts.global_train) == (16,)
    explicit = FLServer(_models()[1], _torch_loss, data,
                        ServerConfig(**scfg), ClientConfig(),
                        _fcfgs("tiered")[1], device="cpu",
                        aggregator=tagg.FedBuffAggregator(half_life=7.0))
    assert explicit.aggregator.half_life == 7.0


def test_sync_population_rank_check_and_bucketless_refusal():
    data, _ = _data()
    pop = Population(100, tiers=(DeviceTier("big", rank=32,
                                            fraction=1.0),))
    with pytest.raises(ValueError, match="exceeds the server rank"):
        FLServer(_models()[1], _torch_loss, pop, ServerConfig(),
                 ClientConfig(), FLoCoRAConfig(rank=16, alpha=16.0),
                 device="cpu")

    class PlainMean:
        def aggregate(self, msgs, weights):
            return tagg.fedavg(tagg.stack_trees(msgs), weights)

    with pytest.raises(ValueError, match="rank-bucketed"):
        FLServer(_models()[1], _torch_loss, data,
                 ServerConfig(n_clients=10, clients_per_round=4),
                 ClientConfig(), _fcfgs("tiered")[1], device="cpu",
                 aggregator=PlainMean())
