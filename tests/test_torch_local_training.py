"""Local training: the port's engines against the JAX package's.

``make_local_trainer`` (one client, natural steps), the vmapped
``make_cohort_trainer`` (ragged ``n_steps`` including 0, and a
``pad_cohort_batches``-padded cohort) and
``make_staggered_cohort_trainer`` (a start tree per client), each with
and without FedProx, from the same numpy params and batches:
- on a tiny linear model, trees and losses within rtol 1e-5;
- on a ResNet-8 at r=4 with 8x8 images, losses within rtol 1e-4 and
  each tree leaf within 1e-4 of its magnitude (fp32 convolutions with
  another summation order, compounded over a few SGD steps).
Masked steps leave a client's params and momenta bit-identical. And the
evaluated round: ``FLServer(eval_fn=...)`` with ``eval_every`` gives the
JAX server's records, keys and values, with eval in the same rounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as jlora
from repro.core.flocora import FLoCoRAConfig as JFLoCoRAConfig
from repro.fl import ClientConfig as JClientConfig
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro.fl import client as jclient
from repro.models import resnet as jresnet
from repro_torch.core import lora as tlora
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.fl import ClientConfig, FLServer, ServerConfig
from repro_torch.fl import client as tclient
from repro_torch.models import resnet as tresnet
from repro_torch.utils.tree import tree_map

torch.set_num_threads(1)


# -- the tiny linear model --------------------------------------------------

def _tiny_loss_jax(frozen, train, batch):
    logits = (batch["x"] - frozen["mu"]) @ train["w"] + train["b"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, batch["y"][:, None],
                                         axis=1)), {}


def _tiny_loss_torch(frozen, train, batch):
    logits = (batch["x"] - frozen["mu"]) @ train["w"] + train["b"]
    logp = torch.log_softmax(logits, dim=-1)
    y = batch["y"].to(torch.int64)
    return -torch.mean(torch.gather(logp, 1, y[:, None])), {}


def _tiny_model(seed=0):
    rng = np.random.default_rng(seed)
    return {"frozen": {"mu": (0.1 * rng.normal(size=(16,))
                              ).astype(np.float32)},
            "train": {"w": (0.1 * rng.normal(size=(16, 10))
                            ).astype(np.float32),
                      "b": (0.1 * rng.normal(size=(10,))
                            ).astype(np.float32)}}


def _tiny_batches(lead, b=8, seed=1):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(*lead, b, 16)).astype(np.float32),
            "y": rng.integers(0, 10, size=(*lead, b)).astype(np.int32)}


# -- a ResNet-8 at r=4 on 8x8 images ---------------------------------------

RCFG = dict(arch="resnet8")


def _resnet_cfgs():
    return (jresnet.ResNetConfig(lora=jlora.LoRAConfig(rank=4, alpha=64.0),
                                 **RCFG),
            tresnet.ResNetConfig(lora=tlora.LoRAConfig(rank=4, alpha=64.0),
                                 **RCFG))


def _resnet_model(seed=0):
    """JAX init, then every trainable leaf moved off its init (the
    zero-initialized adapter ``a`` would give ``b`` a zero gradient)."""
    jcfg, _ = _resnet_cfgs()
    m = jax.device_get(jresnet.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    m["train"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        m["train"])
    return m


def _resnet_batches(lead, b=4, seed=1):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(*lead, b, 8, 8, 3)).astype(np.float32),
            "y": rng.integers(0, 10, size=(*lead, b)).astype(np.int32)}


def _setup(model, mu):
    """(model, JAX loss, port loss, batch maker, tolerance, relative
    tolerance, JAX client config, port client config). The ResNet trains
    at the paper's lr 0.01."""
    if model == "tiny":
        return (_tiny_model(), _tiny_loss_jax, _tiny_loss_torch,
                _tiny_batches, dict(rtol=1e-5, atol=1e-6), None,
                *_ccfgs(mu, 0.05))
    jcfg, tcfg = _resnet_cfgs()
    return (_resnet_model(),
            lambda f, t, b: jresnet.loss_fn(f, t, jcfg, b),
            lambda f, t, b: tresnet.loss_fn(f, t, tcfg, b),
            _resnet_batches, dict(rtol=1e-4, atol=0.0), 1e-4,
            *_ccfgs(mu, 0.01))


def _ccfgs(mu, lr=0.05):
    kw = dict(lr=lr, momentum=0.9, fedprox_mu=mu)
    return JClientConfig(**kw), ClientConfig(**kw)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _hold(got, want, rel, tol):
    """Leaf by leaf: within ``rel`` of the leaf's magnitude where
    ``rel`` is set, else within ``tol``."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if rel is None:
            np.testing.assert_allclose(g, w, **tol)
        else:
            assert np.abs(g - w).max() <= rel * np.abs(w).max()


MODELS = ["tiny", "resnet8"]
MUS = pytest.mark.parametrize("mu", [0.0, 0.01], ids=["sgd", "fedprox"])


@pytest.mark.parametrize("model", MODELS)
@MUS
def test_local_trainer_matches_jax(model, mu):
    m, jloss, tloss, batches, tol, rel, jc, tc = _setup(model, mu)
    b = batches((3,))
    jt, jl = jclient.make_local_trainer(jloss, jc)(
        m["frozen"], m["train"], b)
    tt, tl = tclient.make_local_trainer(tloss, tc)(
        _t(m["frozen"]), _t(m["train"]), _t(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol["rtol"])
    _hold(tt, jt, rel, tol)


@pytest.mark.parametrize("model", MODELS)
@MUS
@pytest.mark.parametrize("padded", [False, True], ids=["ragged", "padded"])
def test_cohort_trainer_matches_jax(model, mu, padded):
    """K=3 clients over a 3-step schedule with n_steps (3, 1, 0); the
    padded cohort repeats client 0 to K=4 with n_steps 0."""
    m, jloss, tloss, batches, tol, rel, jc, tc = _setup(model, mu)
    b, n = batches((3, 3)), np.array([3, 1, 0], np.int32)
    if padded:
        b, n = tclient.pad_cohort_batches(b, n, tclient.pow2_pad(3))
        assert n.tolist() == [3, 1, 0, 0]
    jt, jl = jclient.make_cohort_trainer(jloss, jc)(
        m["frozen"], m["train"], b, jnp.asarray(n))
    tt, tl = tclient.make_cohort_trainer(tloss, tc)(
        _t(m["frozen"]), _t(m["train"]), _t(b), torch.from_numpy(n))
    assert tl.shape == (len(n),)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=tol["rtol"])
    _hold(tt, jt, rel, tol)
    for k in np.flatnonzero(n == 0):       # untrained: the start, exactly
        assert float(tl[k]) == 0.0
        for got, start in zip(jax.tree.leaves(tt),
                              jax.tree.leaves(m["train"])):
            assert torch.equal(got[k], torch.from_numpy(start))


@pytest.mark.parametrize("model", MODELS)
@MUS
def test_staggered_cohort_trainer_matches_jax(model, mu):
    """K=3 clients, each from its own start tree, n_steps (2, 3, 0)."""
    m, jloss, tloss, batches, tol, rel, jc, tc = _setup(model, mu)
    rng = np.random.default_rng(5)
    starts = jax.tree.map(
        lambda a: np.stack([a + 0.02 * k * rng.normal(size=a.shape)
                            for k in range(3)]).astype(np.float32),
        m["train"])
    b, n = batches((3, 3)), np.array([2, 3, 0], np.int32)
    jt, jl = jclient.make_staggered_cohort_trainer(jloss, jc)(
        m["frozen"], starts, b, jnp.asarray(n))
    tt, tl = tclient.make_staggered_cohort_trainer(tloss, tc)(
        _t(m["frozen"]), _t(starts), _t(b), torch.from_numpy(n))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=tol["rtol"])
    _hold(tt, jt, rel, tol)
    for got, start in zip(jax.tree.leaves(tt), jax.tree.leaves(starts)):
        assert torch.equal(got[2], torch.from_numpy(start[2]))


@pytest.mark.parametrize("n_steps", [0, 2])
def test_masked_steps_leave_params_and_momenta_untouched(n_steps,
                                                         monkeypatch):
    """One client's masked run over a 4-step schedule, not vmapped, with
    an SGD whose updates record the state they are handed: every step
    past ``n_steps`` receives the momenta bit-identical to those after
    step ``n_steps`` (zeros for 0), and the params come out
    bit-identical to those after step ``n_steps``. Under vmap the same
    run leaves the same params (the cohort tests check them)."""
    seen, made = [], []
    real_sgd = tclient.sgd

    def recording_sgd(**kw):
        opt = real_sgd(**kw)

        def update(grads, state, params, lr):
            seen.append(tree_map(torch.clone, state))
            new = opt.update(grads, state, params, lr)
            made.append(tree_map(torch.clone, new))
            return new

        return opt._replace(update=update)

    monkeypatch.setattr(tclient, "sgd", recording_sgd)
    m = _tiny_model()
    _, tc = _ccfgs(0.0)
    b = _t(_tiny_batches((4,)))
    run = tclient._masked_local_run(_tiny_loss_torch, tc)
    train, loss = run(_t(m["frozen"]), _t(m["train"]), b,
                      torch.tensor(n_steps, dtype=torch.int32))
    want_params = made[n_steps - 1][0] if n_steps else _t(m["train"])
    want_mu = made[n_steps - 1][1]["mu"] if n_steps else seen[0]["mu"]
    for state in seen[n_steps:]:
        for got, want in zip(jax.tree.leaves(state["mu"]),
                             jax.tree.leaves(want_mu)):
            assert torch.equal(got, want)
    for got, want in zip(jax.tree.leaves(train),
                         jax.tree.leaves(want_params)):
        assert torch.equal(got, want)
    if n_steps == 0:
        assert float(loss) == 0.0
        assert all(not bool(x.any()) for x in jax.tree.leaves(want_mu))


def test_fedprox_refusal_is_gone():
    assert ClientConfig(fedprox_mu=0.1).fedprox_mu == 0.1


# -- the evaluated round ---------------------------------------------------

def _eval_fns(test):
    def jeval(frozen, train):
        logits = (test["x"] - frozen["mu"]) @ train["w"] + train["b"]
        return {"test_acc": float(np.mean(np.asarray(
            jnp.argmax(logits, -1)) == test["y"])),
            "test_logit_mean": float(jnp.mean(logits))}

    xt = torch.from_numpy(test["x"])

    def teval(frozen, train):
        logits = (xt - frozen["mu"]) @ train["w"] + train["b"]
        return {"test_acc": float(np.mean(
            torch.argmax(logits, -1).numpy() == test["y"])),
            "test_logit_mean": float(torch.mean(logits))}

    return jeval, teval


@pytest.mark.parametrize("eval_every,p_fail,mu", [
    (2, 0.0, 0.0), (1, 0.6, 0.0), (3, 0.0, 0.05)])
def test_evaluated_round_matches_jax(eval_every, p_fail, mu):
    """5 rounds of the JAX server and the port's from one seed: every
    record has the same keys, eval runs in the same rounds (never on an
    all-dropped round), the values agree (bytes exactly, floats within
    rtol 1e-4, as tests/test_torch_fl_round.py holds a round)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, 16)).astype(np.float32)
    y = rng.integers(0, 10, 120).astype(np.int32)
    data = [{"x": x[p], "y": y[p]} for p in
            np.array_split(rng.permutation(100), 4)]
    test = {"x": x[100:], "y": y[100:]}
    m = _tiny_model()
    scfg = dict(rounds=5, n_clients=4, clients_per_round=1,
                p_client_failure=p_fail, seed=3, eval_every=eval_every)
    ccfg = dict(local_epochs=2, batch_size=8, lr=0.2, fedprox_mu=mu)
    fcfg = dict(rank=8, alpha=128.0, quant_bits=8)
    jeval, teval = _eval_fns(test)
    js = JFLServer(jax.tree.map(jnp.asarray, m), _tiny_loss_jax, data,
                   JServerConfig(**scfg), JClientConfig(**ccfg),
                   JFLoCoRAConfig(**fcfg), eval_fn=jeval)
    ts = FLServer(m, _tiny_loss_torch, data, ServerConfig(**scfg),
                  ClientConfig(**ccfg), FLoCoRAConfig(**fcfg),
                  eval_fn=teval, device="cpu")
    evaluated = []
    for _ in range(5):
        jr, tr = js.run_round(), ts.run_round()
        assert set(tr) == set(jr)
        if "test_acc" in tr:
            evaluated.append(tr["round"])
        for key, want in jr.items():
            if isinstance(want, float) and np.isnan(want):
                assert np.isnan(tr[key]), key
            elif isinstance(want, float):
                np.testing.assert_allclose(tr[key], want, rtol=1e-4,
                                           atol=1e-6, err_msg=key)
            else:
                assert tr[key] == want, key
    assert evaluated == [r for r in range(1, 6) if r % eval_every == 0
                         and js.history[r - 1]["n_agg"] > 0]
    if p_fail:
        assert any(h["n_agg"] == 0 for h in ts.history)
