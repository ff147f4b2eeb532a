"""The round's options against the JAX package: the per-leaf wire, error
feedback (with stragglers) and checkpoint/resume.

On the tiny linear model of tests/test_torch_fl_round.py both engines
sample the same cohorts, count identical bytes, report losses within
rtol=1e-4 and hold global trees within one quantization step. A ResNet-8
round on the per-leaf wire matches the flat wire within the two folds'
association. Checkpoints: atomic writes and ``keep_n``; a killed and
resumed port run is BIT-exact on the CPU; a checkpoint written by either
package resumes in the other."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import ClientConfig as JClientConfig
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro.core.flocora import FLoCoRAConfig as JFLoCoRAConfig
from repro_torch import checkpoint as tckpt
from repro_torch import obs
from repro_torch.core.aggregation import ErrorFeedbackFedAvg, \
    FedAvgAggregator
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.data import SyntheticVision, lda_partition
from repro_torch.fl import ClientConfig, FLServer, ServerConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import resnet as tresnet
from repro_torch.utils.tree import flatten_with_names
from test_torch_fl_round import BYTE_KEYS, _jax_loss, _Recorder, \
    _tiny_setup, _torch_loss

torch.set_num_threads(1)


def _servers(scfg: dict, ccfg: dict, fcfg: dict, n_clients: int):
    data, model = _tiny_setup(n_clients=n_clients)
    js = JFLServer(jax.tree.map(jnp.asarray, model), _jax_loss, data,
                   JServerConfig(**scfg), JClientConfig(**ccfg),
                   JFLoCoRAConfig(**fcfg))
    ts = FLServer(model, _torch_loss, data, ServerConfig(**scfg),
                  ClientConfig(**ccfg), FLoCoRAConfig(**fcfg), device="cpu")
    return js, ts


def _hold_round(jr: dict, tr: dict, js, ts, bits) -> None:
    assert set(tr) == set(jr)
    for key in BYTE_KEYS:
        assert tr.get(key) == jr.get(key), key
    np.testing.assert_allclose(tr["client_loss"], jr["client_loss"],
                               rtol=1e-4)
    jw = np.asarray(js.global_train["w"])
    step = (np.maximum(jw.max(0), 0) - np.minimum(jw.min(0), 0)) \
        / ((1 << bits) - 1)
    assert (np.abs(ts.global_train["w"].numpy() - jw)
            <= step[None, :] + 1e-6).all()
    np.testing.assert_allclose(ts.global_train["b"].numpy(),
                               np.asarray(js.global_train["b"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits,flat_wire,ef,n_clients,oversample,p_fail", [
    (8, False, False, 4, 1.0, 0.0), (4, False, False, 6, 1.5, 0.2),
    (4, True, True, 6, 1.5, 0.0), (8, False, True, 6, 1.5, 0.2),
    (2, True, True, 4, 1.0, 0.0)])
def test_round_options_parity_with_jax(bits, flat_wire, ef, n_clients,
                                       oversample, p_fail):
    """The per-leaf wire and error feedback (EF with stragglers: 3
    dispatched, 2 kept) on both engines from one seed."""
    js, ts = _servers(
        dict(rounds=3, n_clients=n_clients, clients_per_round=2,
             oversample=oversample, p_client_failure=p_fail, seed=3),
        dict(local_epochs=2, batch_size=8, lr=0.2),
        dict(rank=8, alpha=128.0, quant_bits=bits, flat_wire=flat_wire,
             error_feedback=ef), n_clients)
    assert isinstance(ts.aggregator, ErrorFeedbackFedAvg) == ef
    js.rng, ts.rng = _Recorder(js.rng), _Recorder(ts.rng)
    for _ in range(3):
        jr, tr = js.run_round(), ts.run_round()
        _hold_round(jr, tr, js, ts, bits)
    assert ts.rng.cohorts == js.rng.cohorts
    assert ts.wire.wasted == js.wire.wasted
    if ef:
        # a kept client's residual is at most half a quantization step,
        # so one flipped level moves it by at most 2 * max|e'|
        assert sorted(ts.aggregator.residuals) == \
            sorted(js.aggregator.residuals)
        for cid, res in ts.aggregator.residuals.items():
            jres = np.asarray(js.aggregator.residuals[cid]["w"])
            d = np.abs(res["w"] - jres)
            assert d.max() <= 2 * np.abs(jres).max() + 1e-5
            assert np.mean(d <= 1e-5) >= 0.9


def test_ef_residuals_commit_only_for_kept_clients(monkeypatch):
    """A kept client stores e' = (x + e) - deq(msg); a straggler stores
    e' + deq(msg), the whole compensated signal (its message was
    discarded)."""
    data, model = _tiny_setup(n_clients=6)
    srv = FLServer(model, _torch_loss, data,
                   ServerConfig(n_clients=6, clients_per_round=2,
                                oversample=2.0, seed=1),
                   ClientConfig(local_epochs=1, batch_size=8, lr=0.2),
                   FLoCoRAConfig(rank=8, alpha=128.0, quant_bits=2,
                                 error_feedback=True), device="cpu")
    uplinks = {}
    real = srv.aggregator.store_residual
    from repro_torch.core import flocora as tfl
    orig = tfl.client_uplink

    def spy(trainable, cfg, res=None, rnd=0, **kw):
        msg, new = orig(trainable, cfg, res, rnd=rnd, **kw)
        uplinks[len(uplinks)] = (trainable, msg, new)
        return msg, new

    monkeypatch.setattr(tfl, "client_uplink", spy)
    stored = {}
    monkeypatch.setattr(srv.aggregator, "store_residual",
                        lambda cid, r: (stored.__setitem__(cid, r),
                                        real(cid, r)))
    rec = srv.run_round()
    assert rec["n_agg"] == 2 and rec["n_straggled"] == 2
    assert len(stored) == 4
    sent = {}
    for trainable, msg, new in uplinks.values():
        sent[id(new)] = (trainable, msg, new)
    kept = folded = 0
    for cid, res in stored.items():
        if id(res) in sent:               # kept: e' as encoded
            kept += 1
            continue
        # straggler: e' + deq(msg) = x + e, and e started at 0, so the
        # residual is the client's whole trained tree
        folded += 1
        assert any(all(torch.allclose(res[k], t[k].to(torch.float32),
                                      rtol=1e-6, atol=1e-6) for k in t)
                   for t, _, _ in sent.values())
    assert kept == 2 and folded == 2


def test_resnet8_round_per_leaf_matches_flat():
    """ResNet-8 r=4 round 1 on the CPU on both wires: identical bytes and
    losses (the same uplinks), trees within the two folds' association
    (B3 (w*(lv - zp))*s from client 0 against B2 w*((lv - zp)*s) from
    0.0: a few ulp)."""
    rng = np.random.default_rng(0)
    sv = SyntheticVision(image=16, seed=0)
    y = rng.integers(0, 10, 96)
    x = sv.sample(rng, y)
    parts = lda_partition(y, 3, alpha=100.0)
    data = [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]
    cfg = tresnet.ResNetConfig(lora=LoRAConfig(rank=4, alpha=64.0))
    recs, trees = [], []
    for flat in (True, False):
        kops.reset_launch_counts()
        srv = FLServer(tresnet.init(0, cfg, device="cpu"),
                       lambda f, t, b: tresnet.loss_fn(f, t, cfg, b), data,
                       ServerConfig(n_clients=3, clients_per_round=3),
                       ClientConfig(local_epochs=1, batch_size=32, lr=0.01),
                       FLoCoRAConfig(rank=4, alpha=64.0, quant_bits=8,
                                     flat_wire=flat), device="cpu")
        recs.append(srv.run_round())
        trees.append(srv.global_train)
        assert sum(kops.launch_counts().values()) == 0
    for key in BYTE_KEYS + ("client_loss",):
        assert recs[0][key] == recs[1][key], key
    for (name, a), (_, b) in zip(flatten_with_names(trees[0]),
                                 flatten_with_names(trees[1])):
        scale = float(a.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 1e-6 * scale, name


def test_round_records_obs_counters_and_spans():
    data, model = _tiny_setup(n_clients=6)
    reg, tracer = obs.MetricsRegistry(), obs.Tracer()
    srv = FLServer(model, _torch_loss, data,
                   ServerConfig(n_clients=6, clients_per_round=2,
                                oversample=1.5, p_client_failure=0.2,
                                seed=3),
                   ClientConfig(local_epochs=1, batch_size=8, lr=0.2),
                   FLoCoRAConfig(rank=8, alpha=128.0, quant_bits=4),
                   registry=reg, tracer=tracer, device="cpu")
    recs = srv.run(3)
    assert reg.counter_value("wire.down_bytes") == sum(
        r["down_bytes"] for r in recs)
    assert reg.counter_value("wire.up_bytes") == sum(
        r["up_bytes"] for r in recs)
    assert reg.counter_value("wire.wasted_bytes") == srv.wire.wasted == sum(
        r["wasted_bytes"] for r in recs)
    assert reg.counter_value("fl.rounds") == 3
    names = {e["name"] for e in tracer.chrome_trace()["traceEvents"]
             if e.get("ph") == "X"}
    assert {"fl/broadcast", "fl/client_train", "fl/pack", "fl/uplink",
            "fl/aggregate"} <= names


def test_server_checks_aggregator_against_error_feedback():
    data, model = _tiny_setup()
    args = (model, _torch_loss, data, ServerConfig(n_clients=4),
            ClientConfig())
    with pytest.raises(ValueError, match="ErrorFeedbackFedAvg"):
        FLServer(*args, FLoCoRAConfig(quant_bits=8, error_feedback=True),
                 aggregator=FedAvgAggregator(QuantConfig(bits=8)),
                 device="cpu")
    with pytest.raises(ValueError, match="non-EF"):
        FLServer(*args, FLoCoRAConfig(quant_bits=8),
                 aggregator=ErrorFeedbackFedAvg(QuantConfig(bits=8)),
                 device="cpu")
    mine = ErrorFeedbackFedAvg(QuantConfig(bits=8))
    srv = FLServer(*args, FLoCoRAConfig(rank=8, quant_bits=8,
                                        error_feedback=True),
                   aggregator=mine, device="cpu")
    assert srv.aggregator is not mine and srv.aggregator.r_target == 8
    assert mine.r_target is None


# -- checkpoints -------------------------------------------------------------

def test_checkpoint_atomic_writes_and_keep_n(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    mgr = tckpt.CheckpointManager(d, keep_n=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "v": [torch.ones(2)]}
    for step in range(5):
        mgr.save(step, {"train": tree}, metadata={"round": step})
    assert sorted(os.listdir(d)) == [f"ckpt_{s:08d}.{e}" for s in (3, 4)
                                     for e in ("json", "npz")]
    assert tckpt.latest_step(d) == 4
    step, trees, man = mgr.restore_latest({"train": tree})
    assert step == 4 and man["metadata"] == {"round": 4}
    assert torch.equal(trees["train"]["w"], tree["w"])
    # a payload whose write dies leaves neither a visible step nor a
    # temp file behind
    monkeypatch.setattr(np, "savez", lambda *a, **k: (_ for _ in ()).throw(
        OSError("disk full")))
    with pytest.raises(OSError):
        mgr.save(5, {"train": tree})
    assert tckpt.latest_step(d) == 4
    assert not [f for f in os.listdir(d) if f.startswith("tmp.")]
    # a manifest without its payload is not a complete step
    open(os.path.join(d, "ckpt_00000009.json"), "w").write("{}")
    assert tckpt.latest_step(d) == 4
    assert tckpt.latest_step(str(tmp_path / "missing")) is None


def test_checkpoint_bf16_leaves_round_trip(tmp_path):
    tree = {"a": torch.randn(3, 4).to(torch.bfloat16)}
    tckpt.save(str(tmp_path), 1, {"train": tree})
    back, _ = tckpt.restore(str(tmp_path), 1, {"train": tree})
    assert back["train"]["a"].dtype == torch.bfloat16
    assert torch.equal(back["train"]["a"], tree["a"])


def _ck_server(model, data, d, flat_wire=True, every=1):
    return FLServer(model, _torch_loss, data,
                    ServerConfig(rounds=4, n_clients=6, clients_per_round=2,
                                 oversample=1.5, p_client_failure=0.2,
                                 seed=5, checkpoint_dir=d,
                                 checkpoint_every=every),
                    ClientConfig(local_epochs=1, batch_size=8, lr=0.2),
                    FLoCoRAConfig(rank=8, alpha=128.0, quant_bits=4,
                                  flat_wire=flat_wire), device="cpu")


@pytest.mark.parametrize("flat_wire", [True, False])
def test_kill_and_resume_is_bit_exact(tmp_path, flat_wire):
    data, model = _tiny_setup(n_clients=6)
    full = _ck_server(model, data, str(tmp_path / "full"), flat_wire)
    want = full.run(4)
    d = str(tmp_path / "killed")
    first = _ck_server(model, data, d, flat_wire, every=2)
    first.run(3)                      # checkpoints at round 2; "dies" in 3
    again = _ck_server(model, data, d, flat_wire, every=2)
    assert again.try_resume() and again.round == 2
    got = again.run(2)
    for w, g in zip(want[2:], got[2:]):
        assert w == g
    for (name, a), (_, b) in zip(flatten_with_names(full.global_train),
                                 flatten_with_names(again.global_train)):
        assert torch.equal(a, b), name
    assert again.rng.bit_generator.state == full.rng.bit_generator.state
    fresh = _ck_server(model, data, str(tmp_path / "empty"), flat_wire)
    assert not fresh.try_resume() and fresh.round == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """One round on the writer's engine, checkpointed; the other
    package's FLServer resumes from it and runs round 2 beside the
    writer's own round 2: the same cohort, identical bytes, losses
    within 1e-4 and trees within one quantization step."""
    d = str(tmp_path / "ck")
    scfg = dict(rounds=2, n_clients=6, clients_per_round=2, oversample=1.5,
                seed=7, checkpoint_dir=d, checkpoint_every=1)
    js, ts = _servers(scfg, dict(local_epochs=1, batch_size=8, lr=0.2),
                      dict(rank=8, alpha=128.0, quant_bits=8), 6)
    (js if writer == "jax" else ts).run_round()
    reader = ts if writer == "jax" else js
    assert reader.try_resume() and reader.round == 1
    writer_srv = js if writer == "jax" else ts
    assert reader.rng.bit_generator.state == \
        writer_srv.rng.bit_generator.state
    jr, tr = js.run_round(), ts.run_round()
    _hold_round(jr, tr, js, ts, 8)
