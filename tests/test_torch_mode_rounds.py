"""Round parity of the quickstart's sparse, mixed-rank and DP modes: the
port's FLServer against the JAX package's, from one seed.

On a tiny LoRA linear model (a (16, r) x (r, 10) adapter over a frozen
(16, 10) weight) and on a ResNet-8 with conv-LoRA at r <= 16 on 8x8
images: every record has the JAX record's keys; byte keys,
``cohort_ranks``, ``up_bytes_by_rank``, ``uplink_density`` and
``dp_epsilon`` are identical; losses within rtol 1e-4. On the tiny
model the global trees also stay within one quantization step of the
JAX package's (an fp32 tie can flip one level)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flocora as jfl
from repro.core import lora as jlora
from repro.core import quant as jq
from repro.core import sparse as jsp
from repro.fl import ClientConfig as JClientConfig
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro.models import resnet as jresnet
from repro_torch.core import flocora as tfl
from repro_torch.core import lora as tlora
from repro_torch.core import quant as tq
from repro_torch.core import sparse as tsp
from repro_torch.core.aggregation import SVDRecombinationAggregator
from repro_torch.fl import ClientConfig, FLServer, ServerConfig
from repro_torch.models import resnet as tresnet
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

SCALE = 2.0
BYTE_KEYS = ("down_bytes", "up_bytes", "up_bytes_measured", "tcc_bytes",
             "round_bytes", "wasted_bytes", "n_agg", "n_dropped",
             "n_straggled", "cohort_ranks", "up_bytes_by_rank",
             "uplink_density", "dp_epsilon", "round")


def _fcfgs(mode: str, rank: int, n_clients: int):
    """(JAX config, port config) of one mode at server rank ``rank``."""
    def build(fl, sp, q):
        if mode == "sparse":
            return fl.FLoCoRAConfig(rank=rank, alpha=2.0 * rank,
                                    quant_bits=4, error_feedback=True,
                                    sparsity=sp.SparsityConfig(density=0.1))
        if mode == "hetero":
            tiers = (rank // 4, rank // 2, rank)
            return fl.FLoCoRAConfig(
                rank=rank, alpha=2.0 * rank, quant_bits=8,
                rank_schedule=fl.RankSchedule.tiered(tiers, n_clients))
        return fl.FLoCoRAConfig(rank=rank, alpha=2.0 * rank, quant_bits=8,
                                dp=q.DPConfig(clip_norm=1.0,
                                              noise_multiplier=0.3))
    return build(jfl, jsp, jq), build(tfl, tsp, tq)


def _hold_records(jr: dict, tr: dict) -> None:
    assert set(tr) == set(jr)
    for key in BYTE_KEYS:
        assert tr.get(key) == jr.get(key), key
    np.testing.assert_allclose(tr["client_loss"], jr["client_loss"],
                               rtol=1e-4)


# -- the tiny LoRA linear model ---------------------------------------------

def _tiny_model(rank, seed=0):
    rng = np.random.default_rng(seed)
    return {"frozen": {"w": (rng.normal(size=(16, 10)) / 4
                             ).astype(np.float32)},
            "train": {"lin": {"a": (rng.normal(size=(16, rank)) / 4
                                    ).astype(np.float32),
                              "b": np.zeros((rank, 10), np.float32)},
                      "bias": np.zeros((10,), np.float32)}}


def _tiny_loss_jax(frozen, train, batch):
    x = batch["x"]
    logits = x @ frozen["w"] + SCALE * (x @ train["lin"]["a"]) \
        @ train["lin"]["b"] + train["bias"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, batch["y"][:, None],
                                         axis=1)), {}


def _tiny_loss_torch(frozen, train, batch):
    x = batch["x"]
    logits = x @ frozen["w"] + SCALE * (x @ train["lin"]["a"]) \
        @ train["lin"]["b"] + train["bias"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, batch["y"].long()[:, None])), {}


def _tiny_data(n=240, n_clients=10, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(16, 10)).astype(np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = np.argmax(x @ w_true, axis=1).astype(np.int32)
    parts = np.array_split(rng.permutation(n), n_clients)
    return [{"x": x[p], "y": y[p]} for p in parts]


@pytest.mark.parametrize("mode", ["sparse", "hetero", "dp"])
@pytest.mark.parametrize("oversample,p_fail", [(1.0, 0.0), (1.2, 0.1),
                                               (1.0, 0.5)])
def test_tiny_round_parity(mode, oversample, p_fail):
    data = _tiny_data()
    rank = 16 if mode == "hetero" else 8
    jc, tc = _fcfgs(mode, rank, len(data))
    scfg = dict(rounds=3, n_clients=10, clients_per_round=6, seed=2,
                oversample=oversample, p_client_failure=p_fail)
    ccfg = dict(local_epochs=2, batch_size=8, lr=0.1)
    model = _tiny_model(rank)
    js = JFLServer(jax.tree.map(jnp.asarray, model), _tiny_loss_jax, data,
                   JServerConfig(**scfg), JClientConfig(**ccfg), jc)
    ts = FLServer(model, _tiny_loss_torch, data, ServerConfig(**scfg),
                  ClientConfig(**ccfg), tc, device="cpu")
    for _ in range(3):
        jr, tr = js.run_round(), ts.run_round()
        if jr["n_agg"] == 0:
            assert tr["n_agg"] == 0 and np.isnan(tr["client_loss"])
            assert {k: tr[k] for k in BYTE_KEYS if k in tr} == \
                {k: jr[k] for k in BYTE_KEYS if k in jr}
            continue
        _hold_records(jr, tr)
        bits = tc.quant_bits
        for key in ("a", "b"):
            want = np.asarray(js.global_train["lin"][key])
            step = (max(want.max(), 0) - min(want.min(), 0)) \
                / ((1 << bits) - 1)
            got = ts.global_train["lin"][key].numpy()
            assert np.abs(got - want).max() <= step + 1e-6, key
        np.testing.assert_allclose(ts.global_train["bias"].numpy(),
                                   np.asarray(js.global_train["bias"]),
                                   rtol=1e-4, atol=1e-5)
    if mode == "hetero":
        assert any(len(h["cohort_ranks"]) > 1 for h in ts.history)
    if mode == "sparse":
        assert all(h["uplink_density"] == 0.1 for h in ts.history)
    assert ts.rng.bit_generator.state == js.rng.bit_generator.state


def test_tiny_svd_recombination_round_parity():
    """A mixed fleet served by the SVD recombination: the same records
    and served ranks in both rounds, round 1's adapter product within
    1e-5 of its scale. Round 2 trains from the broadcast of factors that
    may differ in sign and order (their int8 rounding differs), so its
    products are held by the loss only."""
    from repro.core.aggregation import SVDRecombinationAggregator as JSVD
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro_torch.core.quant import QuantConfig
    data = _tiny_data()
    jc, tc = _fcfgs("hetero", 16, len(data))
    scfg = dict(rounds=2, n_clients=10, clients_per_round=6, seed=4)
    ccfg = dict(local_epochs=1, batch_size=8, lr=0.1)
    model = _tiny_model(16)
    js = JFLServer(jax.tree.map(jnp.asarray, model), _tiny_loss_jax, data,
                   JServerConfig(**scfg), JClientConfig(**ccfg), jc,
                   aggregator=JSVD(JQuantConfig(bits=8), energy=0.95))
    ts = FLServer(model, _tiny_loss_torch, data, ServerConfig(**scfg),
                  ClientConfig(**ccfg), tc, device="cpu",
                  aggregator=SVDRecombinationAggregator(QuantConfig(bits=8),
                                                        energy=0.95))
    for rnd in range(2):
        _hold_records(js.run_round(), ts.run_round())
        assert ts.aggregator.served_ranks == js.aggregator.served_ranks
        if rnd == 0:
            pj = np.asarray(js.global_train["lin"]["a"]) \
                @ np.asarray(js.global_train["lin"]["b"])
            pt = (ts.global_train["lin"]["a"]
                  @ ts.global_train["lin"]["b"]).numpy()
            assert np.abs(pt - pj).max() <= 1e-5 * max(np.abs(pj).max(),
                                                       1.0)


# -- ResNet-8 with conv-LoRA at 8x8 -------------------------------------------

def _resnet_run(mode: str, rank: int, rounds: int):
    jcfg = jresnet.ResNetConfig(
        arch="resnet8", lora=jlora.LoRAConfig(rank=rank, alpha=2.0 * rank))
    tcfg = tresnet.ResNetConfig(
        arch="resnet8", lora=tlora.LoRAConfig(rank=rank, alpha=2.0 * rank))
    model = jax.device_get(jresnet.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    data = [{"x": x[p], "y": y[p]}
            for p in np.array_split(rng.permutation(64), 6)]
    jc, tc = _fcfgs(mode, rank, len(data))
    scfg = dict(rounds=rounds, n_clients=6, clients_per_round=4, seed=0)
    ccfg = dict(local_epochs=1, batch_size=4, lr=0.01)
    js = JFLServer(jax.tree.map(jnp.asarray, model),
                   lambda f, t, b: jresnet.loss_fn(f, t, jcfg, b),
                   data, JServerConfig(**scfg), JClientConfig(**ccfg), jc)
    ts = FLServer(model, lambda f, t, b: tresnet.loss_fn(f, t, tcfg, b),
                  data, ServerConfig(**scfg), ClientConfig(**ccfg), tc,
                  device="cpu")
    for _ in range(rounds):
        _hold_records(js.run_round(), ts.run_round())
    return ts


@pytest.mark.parametrize("mode,rank,rounds", [("sparse", 4, 2),
                                              ("hetero", 16, 1),
                                              ("dp", 4, 2)])
def test_resnet8_round_parity(mode, rank, rounds):
    ts = _resnet_run(mode, rank, rounds)
    for leaf in tree_leaves(ts.global_train):
        assert bool(torch.isfinite(leaf).all())
    if mode == "dp":
        assert ts.history[-1]["dp_epsilon"] == jq.gaussian_epsilon(
            0.3, rounds)
