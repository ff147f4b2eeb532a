"""The port's telemetry: run fingerprints (``obs/meta.py``) and the compile
watchdog (``obs/compile.py``), mirroring tests/test_obs.py.

In the port a "compile" is a device program built for a new shape or a
new process: a kernel library's nvcc build or load, a dynamo graph of
``torch.compile``, a CUDA-graph capture. On the CPU the kernels' plain
versions build nothing, so the steady-state paths count 0 here; a
``torch.compile(..., backend="eager")`` call on a new shape is the
fresh build the watchdog must catch.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs, serve
from repro_torch.core import lora, messages
from repro_torch.core.aggregation import FedBuffAggregator, \
    StreamingFlatAccumulator
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.data.synthetic import linear_shard
from repro_torch.fl import AsyncConfig, AsyncFLServer, ClientConfig
from repro_torch.obs import compile as obsc
from repro_torch.obs import meta as obsmeta
from repro_torch.obs import metrics as obsm
from repro_torch.obs.compile import CompileBudgetExceeded, \
    CompileWatchdog, count_compiles_fixture  # noqa: F401 (the fixture)

torch.set_num_threads(2)


def test_run_meta_fingerprint():
    m = obsmeta.run_meta()
    assert set(m) == {"backend", "device_kind", "n_devices",
                      "torch_version", "cuda_version", "python_version",
                      "run_id"}
    assert m["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert m["torch_version"] == torch.__version__
    assert m["n_devices"] >= 1 and len(m["run_id"]) == 16
    assert obsmeta.run_meta()["run_id"] != m["run_id"]
    assert obs.run_meta is obsmeta.run_meta


def test_comparable_refuses_other_backends():
    a = obsmeta.run_meta()
    assert obsmeta.COMPARABLE_KEYS == ("backend", "device_kind",
                                       "torch_version")
    assert obsmeta.comparable(a, dict(a, run_id="x", n_devices=4)) == \
        (True, [])
    ok, bad = obsmeta.comparable(a, dict(a, backend="tpu",
                                         torch_version="0"))
    assert not ok and bad == ["backend", "torch_version"]
    assert obsmeta.comparable({}, a) == (True, [])


def test_count_compiles_fixture_and_watchdog(count_compiles):
    f = torch.compile(lambda x: x * 2 + 1, backend="eager")
    x = torch.arange(17.0)               # a fresh shape
    with count_compiles() as c:
        f(x)
    assert c.count >= 1
    with count_compiles() as c:          # steady state: the cached graph
        f(x)
    assert c.count == 0
    with CompileWatchdog(0, label="steady"):   # budget met: no raise
        f(x)
    with pytest.raises(CompileBudgetExceeded, match="fresh"):
        with CompileWatchdog(0, label="fresh"):
            f(torch.arange(19.0).reshape(1, 19))     # a new rank
    # a user exception propagates un-masked even over budget
    with pytest.raises(ZeroDivisionError):
        with CompileWatchdog(0):
            f(torch.arange(23.0).reshape(1, 1, 23))
            1 / 0


def test_builds_feed_enabled_default_registry():
    reg = obsm.MetricsRegistry()
    prev = obsm.set_default_registry(reg)
    try:
        before = obsc.compile_count()
        obsc.record_build("nvcc", 1.5)
        obsc.record_build("load", 0.25)
        torch.compile(lambda x: x - 3, backend="eager")(torch.arange(29.0))
        after = obsc.compile_count()
    finally:
        obsm.set_default_registry(prev)
    assert after - before >= 3
    assert reg.counter_value("torch.program_builds", kind="nvcc") == 1
    assert reg.counter_value("torch.program_builds", kind="dynamo") >= 1
    assert reg.counter_value("torch.program_build_secs") == 1.75
    obsc.record_build("load")            # a disabled registry: counted
    assert obsc.compile_count() == after + 1


def test_serving_engine_strict_steady_state(count_compiles):
    weights, store = serve.make_store(6, d_model=32, n_layers=2,
                                      device="cpu")
    cache = serve.AdapterCache(1 << 20, store.qcfg, device="cpu")
    eng = serve.AdapterServingEngine(weights, 0.5, store.qcfg, cache,
                                     fetch=lambda c: store.msgs[c],
                                     strict_compiles=True, device="cpu")
    cids = [0, 1, 2, 3]
    eng.admit(cids)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32)).astype(np.float32))
    y0 = eng.step(x, cids)
    with count_compiles() as c:
        for _ in range(3):
            y = eng.step(x, cids)
    assert c.count == 0 and torch.equal(y, y0)
    # a warm shape that builds a program raises
    real = eng._compute

    def building(*a):
        obsc.record_build("cuda_graph")
        return real(*a)

    eng._compute = building
    with pytest.raises(CompileBudgetExceeded, match="steady-state decode"):
        eng.step(x, cids)


def _flat_msgs(n):
    rng = np.random.default_rng(1)
    trees = [{"blk": {"a": torch.from_numpy(rng.normal(size=(12, 4)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(4, 9)).astype(
            np.float32))}, "n": torch.zeros(9)} for _ in range(n)]
    return [messages.pack_message(t, QuantConfig(bits=8), flat=True)
            for t in trees]


def test_streaming_fold_and_fedbuff_strict(count_compiles):
    msgs = _flat_msgs(4)
    st = StreamingFlatAccumulator.for_layout(msgs[0].layout,
                                             strict_compiles=True,
                                             device="cpu")
    st.fold(msgs[0], 1.0)
    with count_compiles() as c:
        for m in msgs[1:]:
            st.fold(m, 2.0)
    assert c.count == 0 and st.count == 4
    agg = FedBuffAggregator(streaming=True, strict_compiles=True)
    for i, m in enumerate(msgs):
        agg.add(m, 8.0, float(i))
    mean = agg.flush()
    assert mean["blk"]["a"].shape == (12, 4)


def test_async_config_strict_run():
    """An async run with ``strict_compiles`` over streaming FedBuff: every
    fold after a stream's first is watchdogged, and the run completes."""
    g = torch.Generator().manual_seed(0)
    fz, tr = lora.linear_init(g, 16, 10, "lora",
                              LoRAConfig(rank=8, alpha=8.0),
                              base_dtype=torch.float32, device="cpu")
    model = {"frozen": {"lin": fz}, "train": {"lin": tr}}

    def loss(f, t, b):
        y = lora.linear_apply(f["lin"], t["lin"], b["x"], 1.0, torch.float32)
        return torch.nn.functional.cross_entropy(y, b["y"].long()), {}

    data = [linear_shard(0, c, n=16, d=16) for c in range(6)]
    srv = AsyncFLServer(model, loss, data, AsyncConfig(
        total_arrivals=6, concurrency=3, buffer_size=3, streaming_agg=True,
        strict_compiles=True), ClientConfig(local_epochs=1, batch_size=8),
        FLoCoRAConfig(rank=8, alpha=8.0, quant_bits=8), device="cpu")
    assert srv.aggregator.strict_compiles
    hist = srv.run()
    assert len(hist) == 2
    assert all(np.isfinite(h["client_loss"]) for h in hist)
