"""``launch.fl_experiment`` against the JAX harness built here from
``repro``'s own modules (``benchmarks/common.py`` ``fl_experiment``'s
steps: the same numpy draws, ``resnet.init``, ``FLServer`` and the argmax
over the 1,000 held-out images), from one JAX init carried across with
``convert.params_from_jax``.

At a small size (160 images, 4 clients, K = 2, two rounds evaluated at
the second; the int4 case one round, evaluated), over the FedAvg
baseline here and, one case a file, FLoCoRA at int8, a Table II row on
the fp32 wire and an int4 run with the classifier frozen, the norms
frozen and error feedback (``test_torch_fl_experiment_*.py``): every
record's byte keys equal, ``client_loss`` within rtol 1e-4
(``test_torch_mode_rounds._hold_records``), ``test_acc`` within 0.002
(2 images of 1,000: argmax near-ties), the round bytes and TCC equal,
the global trees after the rounds as ``hold_trees`` and, with error
feedback, each client's residual as ``hold_residuals``. Then Table IV's
ResNet-18 r = 64 int8 row, built only: its static uplink is 2,379,064 B
in both packages.

The sizes are cut for the tier-1 run: the JAX package's local step
costs ~23 s of one CPU core a client on this task (XLA's 32x32
convolution gradients inside its scanned local run), most of it the
first round's compile, and a 1,000-image evaluation ~8 s in JAX and
~15 s in the port on one thread, so the held-out set is evaluated once.
``chip_smoke.py`` phase 3f runs the FedAvg, int8 and Table II cases at
``fl_experiment``'s full size on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import messages as jmessages
from repro.core.flocora import FLoCoRAConfig as JFLoCoRAConfig
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.quant import QuantConfig as JQuantConfig
from repro.data import SyntheticVision as JSyntheticVision
from repro.data import lda_partition as jlda_partition
from repro.fl import ClientConfig as JClientConfig
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro.models import resnet as jresnet
from repro_torch import convert
from repro_torch.core import messages
from repro_torch.core.quant import QuantConfig
from repro_torch.launch import fl_experiment as fe
from repro_torch.utils.tree import flatten_with_names
from test_torch_mode_rounds import _hold_records

torch.set_num_threads(1)

SIZE = dict(n_train=160, n_clients=4, clients_per_round=2, rounds=2,
            eval_every=2)
CASES = {
    "fedavg": dict(mode="fedavg", quant_bits=None),
    "flocora_int8": dict(mode="flocora", quant_bits=8),
    "table2_lora_stem_fc": dict(mode="flocora", quant_bits=None,
                                stem_mode="lora", fc_mode="lora"),
    # one round: at two, the records agree (round 2's client_loss, which
    # spends round 1's residuals, within rtol 1e-4) but int4's flipped
    # levels in round 1 part round 2's test_acc by 4 of 1,000 images
    # (0.108 against 0.104) at chance-level accuracy
    "int4_frozen_fc_ef": dict(mode="flocora", quant_bits=4,
                              fc_mode="frozen", norms_trained=False,
                              error_feedback=True, rounds=1, eval_every=1),
}
TABLE4_UP_BYTES = 2_379_064
# a leaf of the global tree after the rounds, port against JAX: within
# TREE_MOVE of how far the rounds moved it (max|x_jax - x_init|), plus
# TREE_STEPS quantization steps of its range on a quantized wire, plus
# float32's resolution of its values. Measured on these cases: at most
# 0.014 of the movement on the fp32 wire (the Table II row's stem
# ``b``), 0.91 of a step at int8 (``blocks/0/conv1/a``), 0.38 at int4.
# Leaving one of the K = 2 clients out of the mean moves a zero-started
# ``a`` factor by about half its movement
TREE_MOVE = 0.05
TREE_STEPS = 2


def _jax_experiment(arch="resnet8", rank=32, alpha=None, mode="flocora",
                    quant_bits=None, rounds=10, n_clients=40,
                    clients_per_round=4, n_train=4000, lda_alpha=0.5,
                    local_epochs=1, seed=0, stem_mode="dense",
                    fc_mode="dense", norms_trained=True, eval_every=2,
                    error_feedback=False, dp=None):
    """The JAX harness's run, step for step; returns (its result, the
    initial model as numpy, the clients' data, the held-out set, the
    server after its rounds)."""
    rng = np.random.default_rng(seed)
    sv = JSyntheticVision(seed=0)
    y = rng.integers(0, 10, n_train)
    x = sv.sample(rng, y).astype(np.float32)
    parts = jlda_partition(y, n_clients, alpha=lda_alpha, seed=seed)
    data = [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]
    yt = rng.integers(0, 10, 1000)
    xt = jnp.asarray(sv.sample(rng, yt))
    a = alpha if alpha is not None else 16.0 * rank
    cfg = jresnet.ResNetConfig(arch=arch, mode=mode,
                               lora=JLoRAConfig(rank=rank, alpha=a),
                               stem_mode=stem_mode, fc_mode=fc_mode,
                               norms_trained=norms_trained)
    model = jresnet.init(jax.random.PRNGKey(seed), cfg)
    pred = jax.jit(lambda f, t, xx: jnp.argmax(
        jresnet.apply(f, t, cfg, xx), -1))

    def eval_fn(f, t):
        p = np.asarray(pred(f, t, xt))
        return {"test_acc": float((p == yt).mean())}

    srv = JFLServer(
        model, lambda f, t, b: jresnet.loss_fn(f, t, cfg, b), data,
        JServerConfig(rounds=rounds, n_clients=n_clients,
                      clients_per_round=clients_per_round, seed=seed,
                      eval_every=eval_every),
        JClientConfig(local_epochs=local_epochs, batch_size=32, lr=0.01,
                      momentum=0.9),
        JFLoCoRAConfig(rank=rank, alpha=a, quant_bits=quant_bits,
                       error_feedback=error_feedback, dp=dp),
        eval_fn)
    hist = srv.run()
    accs = [h["test_acc"] for h in hist if "test_acc" in h]
    return ({"history": hist, "final_acc": accs[-1], "best_acc": max(accs),
             "round_bytes": srv.round_bytes_per_client,
             "tcc_bytes": rounds * srv.round_bytes_per_client},
            jax.device_get(model), data, (np.asarray(xt), yt), srv)


def hold_trees(want, got, init, bits) -> None:
    """Each leaf of ``got`` (the port's tree) against ``want`` (the JAX
    server's, carried across) as ``TREE_MOVE`` / ``TREE_STEPS`` say,
    measured from ``init``."""
    for (name, w), (_, g), (_, i) in zip(*(flatten_with_names(t)
                                           for t in (want, got, init))):
        w, g, i = (np.asarray(t) for t in (w, g, i))
        step = 0.0 if bits is None else \
            (max(w.max(), 0) - min(w.min(), 0)) / ((1 << bits) - 1)
        tol = TREE_MOVE * np.abs(w - i).max() + TREE_STEPS * step \
            + 1e-6 * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)


def hold_residuals(js, ts) -> None:
    """Error feedback's residuals, port against JAX: the same clients,
    and each residual (at most half a quantization step) within 2 x its
    max|e'| (one flipped level), equal to 1e-5 on 90% of its values."""
    assert sorted(ts.aggregator.residuals) == sorted(js.aggregator.residuals)
    for cid, res in ts.aggregator.residuals.items():
        for (name, r), (_, j) in zip(
                flatten_with_names(res),
                flatten_with_names(js.aggregator.residuals[cid])):
            d = np.abs(np.asarray(r) - np.asarray(j))
            assert d.max() <= 2 * np.abs(j).max() + 1e-5, (cid, name)
            assert np.mean(d <= 1e-5) >= 0.9, (cid, name)


def hold_case(case: str, monkeypatch) -> None:
    """The port's ``fl_experiment`` on the CPU against the JAX harness,
    from the JAX init: the same data and held-out set, the records, the
    accuracies, the round bytes and TCC, the trees and residuals."""
    kw = {**SIZE, **CASES[case]}
    want, model, data, test, js = _jax_experiment(**kw)
    setup = fe.experiment_setup(**kw)
    for got, ref in zip(setup.data, data):
        np.testing.assert_array_equal(got["x"], ref["x"])
        np.testing.assert_array_equal(got["y"], ref["y"])
    np.testing.assert_array_equal(setup.test[0], test[0])
    np.testing.assert_array_equal(setup.test[1], test[1])
    servers, build = [], fe.Setup.server
    monkeypatch.setattr(fe.Setup, "server", lambda self, *a, **kw: (
        servers.append(build(self, *a, **kw)) or servers[-1]))
    got = fe.fl_experiment(**kw, device="cpu",
                           model=convert.params_from_jax(model, "cpu"))
    assert len(got["history"]) == len(want["history"]) == kw["rounds"]
    for jr, tr in zip(want["history"], got["history"]):
        _hold_records(jr, tr)
    assert "test_acc" in got["history"][-1]
    assert got["round_bytes"] == want["round_bytes"]
    assert got["tcc_bytes"] == want["tcc_bytes"]
    for key in ("final_acc", "best_acc"):
        assert abs(got[key] - want[key]) <= 0.002, (key, got[key],
                                                    want[key])
    (ts,) = servers
    hold_trees(jax.device_get(js.global_train), ts.global_train,
               model["train"], setup.fcfg.quant_bits)
    if setup.fcfg.error_feedback:
        hold_residuals(js, ts)


@pytest.mark.parametrize("case", ["fedavg"])
def test_fl_experiment_matches_jax_harness(case, monkeypatch):
    hold_case(case, monkeypatch)


def test_table4_row_static_uplink():
    """Table IV's (ResNet-18, r = 64, int8) run, built but not run: the
    static uplink from the port's tree equals the JAX package's count
    and 2,379,064 B, and the server measures the same one-way message."""
    kw = dict(arch="resnet18", rank=64, quant_bits=8, lda_alpha=1.0,
              n_train=2000, n_clients=20, clients_per_round=4)
    setup = fe.experiment_setup(**kw)
    model = setup.init("cpu")
    ours = messages.message_wire_bytes(model["train"], QuantConfig(bits=8))
    jcfg = jresnet.ResNetConfig(arch="resnet18",
                                lora=JLoRAConfig(rank=64, alpha=1024.0))
    shapes = jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0),
                                                 jcfg))
    theirs = jmessages.message_wire_bytes(shapes["train"],
                                          JQuantConfig(bits=8))
    assert ours == theirs == TABLE4_UP_BYTES
    srv = setup.server(model, "cpu")
    assert srv.round_bytes_per_client == 2 * TABLE4_UP_BYTES
