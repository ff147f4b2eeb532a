"""Round parity: the port's FLServer vs the JAX package's on the tiny
linear model of tests/test_packed_codec.py, from one seed.

Both engines must sample the same cohorts and batches (the numpy RNG
stream is consumed in the same order), count identical wire bytes per
round, report client losses within rtol=1e-4 and hold global trees
within one quantization step (an fp32 tie can flip one level). Plus a
port-only ResNet-8 round on the CPU, the options the port refuses, and
FLoCoRAConfig's validations against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flocora import FLoCoRAConfig as JFLoCoRAConfig
from repro.fl import ClientConfig as JClientConfig
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro_torch.core import messages as tmsg
from repro_torch.core.flocora import FLoCoRAConfig, RankSchedule
from repro_torch.core.quant import DPConfig
from repro_torch.core.sparse import SparsityConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.data import SyntheticVision, lda_partition
from repro_torch.fl import ClientConfig, FLServer, ServerConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import resnet as tresnet

torch.set_num_threads(1)


def _tiny_setup(n=96, n_clients=4, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(16, 10)).astype(np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = np.argmax(x @ w_true + 0.1 * rng.normal(size=(n, 10)), axis=1)
    parts = np.array_split(rng.permutation(n), n_clients)
    data = [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]
    model = {"frozen": {"mu": np.zeros((16,), np.float32)},
             "train": {"w": (0.01 * rng.normal(size=(16, 10))
                             ).astype(np.float32),
                       "b": np.zeros((10,), np.float32)}}
    return data, model


def _jax_loss(frozen, train, batch):
    logits = (batch["x"] - frozen["mu"]) @ train["w"] + train["b"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, batch["y"][:, None],
                                         axis=1)), {}


def _torch_loss(frozen, train, batch):
    logits = (batch["x"] - frozen["mu"]) @ train["w"] + train["b"]
    logp = torch.log_softmax(logits, dim=-1)
    y = batch["y"].to(torch.int64)
    return -torch.mean(torch.gather(logp, 1, y[:, None])), {}


class _Recorder:
    """Proxy for a server's numpy Generator that records each cohort."""

    def __init__(self, rng):
        self.rng = rng
        self.cohorts = []

    def choice(self, *a, **kw):
        out = self.rng.choice(*a, **kw)
        self.cohorts.append(sorted(int(c) for c in out))
        return out

    def __getattr__(self, name):
        return getattr(self.rng, name)


BYTE_KEYS = ("down_bytes", "up_bytes", "up_bytes_measured", "tcc_bytes",
             "round_bytes", "wasted_bytes", "n_agg", "n_dropped",
             "n_straggled")


@pytest.mark.parametrize("bits,n_clients,oversample,p_fail", [
    (4, 4, 1.0, 0.0), (8, 4, 1.0, 0.0), (8, 6, 1.5, 0.2),
    (None, 4, 1.0, 0.0)])
def test_round_parity_with_jax(bits, n_clients, oversample, p_fail):
    data, model = _tiny_setup(n_clients=n_clients)
    scfg = dict(rounds=3, n_clients=n_clients, clients_per_round=2,
                oversample=oversample, p_client_failure=p_fail, seed=3)
    ccfg = dict(local_epochs=2, batch_size=8, lr=0.2)
    fcfg = dict(rank=8, alpha=128.0, quant_bits=bits)
    js = JFLServer(jax.tree.map(jnp.asarray, model), _jax_loss, data,
                   JServerConfig(**scfg), JClientConfig(**ccfg),
                   JFLoCoRAConfig(**fcfg))
    ts = FLServer(model, _torch_loss, data, ServerConfig(**scfg),
                  ClientConfig(**ccfg), FLoCoRAConfig(**fcfg), device="cpu")
    js.rng, ts.rng = _Recorder(js.rng), _Recorder(ts.rng)
    for _ in range(3):
        jr, tr = js.run_round(), ts.run_round()
        assert set(tr) == set(jr)
        for key in BYTE_KEYS:
            assert tr.get(key) == jr.get(key), key
        np.testing.assert_allclose(tr["client_loss"], jr["client_loss"],
                                   rtol=1e-4)
        jw = np.asarray(js.global_train["w"])
        if bits is None:                 # fp wire: fp32 tolerance
            np.testing.assert_allclose(ts.global_train["w"].numpy(), jw,
                                       rtol=1e-4, atol=1e-5)
        else:                            # one step of each column's range
            step = (np.maximum(jw.max(0), 0)
                    - np.minimum(jw.min(0), 0)) / ((1 << bits) - 1)
            assert (np.abs(ts.global_train["w"].numpy() - jw)
                    <= step[None, :] + 1e-6).all()
        np.testing.assert_allclose(ts.global_train["b"].numpy(),
                                   np.asarray(js.global_train["b"]),
                                   rtol=1e-4, atol=1e-4)
    assert ts.rng.cohorts == js.rng.cohorts
    assert ts.rng.bit_generator.state == js.rng.bit_generator.state
    assert ts.wire.wasted == js.wire.wasted
    assert ts.initial_model_bytes == js.initial_model_bytes
    assert ts.round_bytes_per_client == js.round_bytes_per_client


def test_resnet8_round_on_cpu():
    """Port only: ResNet-8 r=4, 2 clients, 1 local step, 16x16 images.
    Measured uplink bytes equal the static accounting; the loss is
    finite; on the CPU no kernel is launched."""
    rng = np.random.default_rng(0)
    sv = SyntheticVision(image=16, seed=0)
    y = rng.integers(0, 10, 64)
    x = sv.sample(rng, y)
    parts = lda_partition(y, 2, alpha=100.0)
    data = [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]
    cfg = tresnet.ResNetConfig(lora=LoRAConfig(rank=4, alpha=64.0))
    model = tresnet.init(0, cfg, device="cpu")
    kops.reset_launch_counts()
    srv = FLServer(model, lambda f, t, b: tresnet.loss_fn(f, t, cfg, b),
                   data, ServerConfig(rounds=1, n_clients=2,
                                      clients_per_round=2),
                   ClientConfig(local_epochs=1, batch_size=32, lr=0.01),
                   FLoCoRAConfig(rank=4, alpha=64.0, quant_bits=8),
                   device="cpu")
    rec = srv.run_round()
    static = tmsg.message_wire_bytes(model["train"], QuantConfig(bits=8))
    assert rec["up_bytes_measured"] == static
    assert rec["up_bytes"] == rec["down_bytes"] == 2 * static
    assert rec["n_agg"] == 2 and np.isfinite(rec["client_loss"])
    assert kops.launch_counts() == {"quant_pack_rows": 0,
                                    "dequant_agg_rows": 0,
                                    "dequant_agg": 0,
                                    "multi_lora_matmul": 0,
                                    "multi_lora_matmul_packed": 0,
                                    "lora_matmul": 0}


@pytest.mark.parametrize("kw,match", [
    (dict(dp=DPConfig(noise_multiplier=0.3), error_feedback=True),
     "incompatible"),
    (dict(rank=8, rank_schedule=RankSchedule.uniform(16, 4)),
     "exceeds the server rank"),
    (dict(sparsity=SparsityConfig(density=0.1)), "needs error_feedback")],
    ids=["dp_noise_with_ef", "schedule_above_rank", "sparse_requires_ef"])
def test_flocora_config_validations(kw, match):
    """The three refusals of the JAX package's FLoCoRAConfig, message
    for message; each option on its own constructs."""
    with pytest.raises(ValueError, match=match):
        FLoCoRAConfig(quant_bits=8, **kw)
    with pytest.raises(ValueError, match=match):
        JFLoCoRAConfig(quant_bits=8, **_kw_jax(kw))
    ok = {k: v for k, v in kw.items() if k not in ("error_feedback",
                                                   "rank")}
    FLoCoRAConfig(quant_bits=8, error_feedback="dp" not in ok, **ok)


def _kw_jax(kw: dict) -> dict:
    """The same options as the JAX package's config objects."""
    from repro.core import flocora as jfl, quant as jq, sparse as jsp
    out = dict(kw)
    if "dp" in kw:
        out["dp"] = jq.DPConfig(**vars(kw["dp"]))
    if "rank_schedule" in kw:
        out["rank_schedule"] = jfl.RankSchedule(**vars(kw["rank_schedule"]))
    if "sparsity" in kw:
        out["sparsity"] = jsp.SparsityConfig(**vars(kw["sparsity"]))
    return out


def test_unported_server_options_raise():
    """The fleet options the port once refused (a FleetTrace, a lazy
    population) are ported: a trace orders a deadline cohort, and what
    still raises is a population whose tiers exceed the server rank."""
    from repro_torch.fl import FleetTrace
    data, model = _tiny_setup()
    args = (model, _torch_loss, data)
    cfgs = (ClientConfig(local_epochs=1, batch_size=8),
            FLoCoRAConfig(rank=8, quant_bits=8))
    srv = FLServer(*args, ServerConfig(n_clients=4, clients_per_round=2,
                                       oversample=2.0), *cfgs,
                   trace=FleetTrace(seed=1), device="cpu")
    rec = srv.run_round()
    assert rec["n_agg"] == 2 and rec["n_straggled"] == 2
    assert rec["wasted_bytes"] == srv.wire.wasted > 0

    class LazyPopulation(list):
        max_rank = 64

        def rank_for(self, cid):
            return 8

    with pytest.raises(ValueError, match="exceeds the server rank"):
        FLServer(model, _torch_loss, LazyPopulation(data),
                 ServerConfig(n_clients=4), *cfgs, device="cpu")


def test_batch_stackers_match_jax():
    """The numpy batch gathering is the JAX package's, draw for draw."""
    from repro.fl import client as jclient
    from repro_torch.fl import client as tclient
    data, _ = _tiny_setup(n=100, n_clients=3)
    data[0] = {k: v[:5] for k, v in data[0].items()}   # < one batch
    jc, tc = JClientConfig(local_epochs=2, batch_size=8), \
        ClientConfig(local_epochs=2, batch_size=8)
    assert tclient.cohort_steps(data, tc) == jclient.cohort_steps(data, jc)
    assert [tclient.natural_steps(d, tc) for d in data] == \
        [jclient.natural_steps(d, jc) for d in data]
    jb, jn = jclient.stack_cohort_batches(np.random.default_rng(4), data, jc)
    tb, tn = tclient.stack_cohort_batches(np.random.default_rng(4), data, tc)
    np.testing.assert_array_equal(tn, jn)
    for key in jb:
        np.testing.assert_array_equal(tb[key], jb[key])
    jp = jclient.pad_cohort_batches(jb, jn, jclient.pow2_pad(3))
    tp = tclient.pad_cohort_batches(tb, tn, tclient.pow2_pad(3))
    np.testing.assert_array_equal(tp[1], jp[1])
    np.testing.assert_array_equal(tp[0]["x"], jp[0]["x"])
