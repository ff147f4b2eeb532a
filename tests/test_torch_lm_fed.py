"""The LM slice's configs, data, wire accounting and federated loop
against the JAX package's, on the CPU: the architecture registry, the
Markov-chain token batches, the int8 message size of gemma3-4b's full
adapter tree, and ``examples/train_lm_federated.py``'s loop at its
``lm-tiny`` config (2 rounds, 2 clients, 2 local steps).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import aggregation as jagg
from repro.core import messages as jmsg
from repro.core.quant import QuantConfig as JQuant
from repro.data import synthetic as jsyn
from repro.models import lm as JLM
from repro.optim import sgd as jsgd
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.core import messages as tmsg
from repro_torch.core.quant import QuantConfig as TQuant
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import lm_federated as tfed
from repro_torch.models import lm as TLM
from repro_torch.utils.tree import flatten_with_names

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_federated", ROOT / "examples" / "train_lm_federated.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(x):
    """A config as nested plain values; dtypes by name."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if isinstance(x, type) and hasattr(x, "dtype"):    # jnp.float32
        return np.dtype(x).name
    return x


def test_registry_matches_jax():
    assert list(TR.REGISTRY) == list(JR.REGISTRY)
    assert TR.SHAPES == JR.SHAPES
    assert TR.cells() == JR.cells()
    for arch, je in JR.REGISTRY.items():
        te = TR.get(arch)
        assert (te.kind, te.long_500k_ok, te.skip_reason) == \
            (je.kind, je.long_500k_ok, je.skip_reason)
        for make in ("smoke", "full"):
            jc, tc = getattr(je, make)(), getattr(te, make)()
            assert type(jc).__name__ == type(tc).__name__
            assert _plain(tc) == _plain(jc), (arch, make)
    with pytest.raises(KeyError):
        TR.get("gpt-5")


def test_example_configs_match_jax():
    ex = _example()
    for full in (False, True):
        assert _plain(tfed.make_cfg(full)) == _plain(ex.make_cfg(full))


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 16, 0),
                                                  (32768, 8, 128, 3)])
def test_markov_lm_batch_draw_for_draw(vocab, batch, seq, seed):
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        a = jsyn.markov_lm_batch(rj, vocab, batch, seq, seed=seed)
        b = tsyn.markov_lm_batch(rt, vocab, batch, seq, seed=seed)
        assert b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(
        jsyn.synthetic_lm_batch(rj, vocab, batch, seq)["tokens"],
        tsyn.synthetic_lm_batch(rt, vocab, batch, seq)["tokens"])


@pytest.mark.parametrize("bits", [8, 4])
def test_gemma3_full_adapter_message_bytes_match_jax(bits):
    """The full gemma3-4b adapter tree's wire size, from shapes only: the
    JAX side through ``jax.eval_shape(LM.init)``, the port's through an
    init on the ``meta`` device (nothing allocated)."""
    jc, tc = JR.get("gemma3-4b").full(), TR.get("gemma3-4b").full()
    shapes = jax.eval_shape(
        lambda: JLM.init(jax.random.PRNGKey(0), jc)["train"])
    meta = TLM.init(0, tc, device="meta")
    tshapes = dict(flatten_with_names(meta["train"]))
    assert all(t.device.type == "meta" for t in tshapes.values())
    want = jmsg.message_wire_bytes(shapes, JQuant(bits=bits))
    got = tmsg.message_wire_bytes(meta["train"], TQuant(bits=bits))
    assert got == want
    assert sorted(tuple(t.shape) for t in tshapes.values()) == \
        sorted(tuple(x.shape) for x in jax.tree.leaves(shapes))
    frozen = sum(t.numel() for _, t in flatten_with_names(meta["frozen"]))
    assert frozen == 4_907_335_680


def _jax_fed(cfg, frozen, gtrain, rounds, clients, steps, batch, seq):
    """examples/train_lm_federated.py's loop, the JAX package's API."""
    qcfg = JQuant(bits=8)
    opt = jsgd(momentum=0.9)

    @jax.jit
    def local_train(train0, tokens):
        state = opt.init(train0)

        def step(carry, b):
            tr, st = carry
            loss, g = jax.value_and_grad(
                lambda t: JLM.loss_fn(frozen, t, cfg, {"tokens": b})[0])(tr)
            tr, st = opt.update(g, st, tr, 0.05)
            return (tr, st), loss

        (tr, _), losses = jax.lax.scan(step, (train0, state), tokens)
        return tr, losses

    rng = np.random.default_rng(0)
    out = []
    for _ in range(rounds):
        g_bcast = jmsg.roundtrip(gtrain, qcfg)
        trees, losses = [], []
        for c in range(clients):
            toks = np.stack([jsyn.markov_lm_batch(rng, cfg.vocab, batch, seq,
                                                  seed=c)["tokens"]
                             for _ in range(steps)])
            tr, ls = local_train(g_bcast, jnp.asarray(toks))
            trees.append(jmsg.roundtrip(tr, qcfg))
            losses.append(np.asarray(ls))
        gtrain = jagg.fedavg(jagg.stack_trees(trees),
                             jnp.full((clients,), steps * batch * seq,
                                      jnp.float32))
        out.append(np.stack(losses))
    return gtrain, out


def test_federated_lm_loop_matches_jax():
    """lm-tiny, 2 rounds x 2 clients x 2 local steps, batch 4 x 32
    tokens, from the same JAX-initialized tree: every client step's
    loss within 2e-3 relative (the bf16 tolerance of
    tests/test_torch_lm.py), the static message size exact, and the
    final global adapters within 6e-2 relative L2 a leaf (bf16 gradients
    through 4 SGD steps and two int8 round trips, where a near-boundary
    value can take the neighbouring level)."""
    jc, tc = _example().make_cfg(False), tfed.make_cfg(False)
    p = JLM.init(jax.random.PRNGKey(0), jc)
    kw = dict(rounds=2, clients=2, steps=2, batch=4, seq=32)
    gj, lj = _jax_fed(jc, p["frozen"], p["train"], **kw)
    tf = convert.params_from_jax(jax.device_get(p["frozen"]), "cpu")
    tt = convert.params_from_jax(jax.device_get(p["train"]), "cpu")
    res = tfed.run(tf, tt, tc, kw["rounds"], kw["clients"], kw["steps"],
                   kw["batch"], kw["seq"], log=None)
    assert res["msg_bytes"] == jmsg.message_wire_bytes(p["train"],
                                                       JQuant(bits=8))
    for rec, want in zip(res["rounds"], lj):
        np.testing.assert_allclose(rec["client_losses"], want, rtol=2e-3)
        assert rec["mean_loss"] == pytest.approx(float(want.mean()),
                                                 rel=2e-3)
    assert res["rounds"][1]["mean_loss"] < res["rounds"][0]["mean_loss"]
    got = dict(flatten_with_names(res["train"]))
    for name, want in flatten_with_names(
            convert.params_from_jax(jax.device_get(gj), "cpu")):
        a, b = want.numpy(), got[name].numpy()
        assert np.isfinite(b).all(), name
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        assert rel <= 6e-2, (name, rel)


def test_local_train_step_is_one_sgd_step():
    """One local step equals a hand-written SGD momentum step on the
    loss's gradient (momentum starts at zero, so it is plain SGD)."""
    cfg = tfed.make_cfg(False)
    p = TLM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(tsyn.markov_lm_batch(
        np.random.default_rng(0), cfg.vocab, 2, 16)["tokens"])
    trained, losses = tfed.make_local_train(p["frozen"], cfg)(
        p["train"], toks[None])
    names = [n for n, _ in flatten_with_names(p["train"])]
    leaves = [t.clone().requires_grad_(True)
              for _, t in flatten_with_names(p["train"])]
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    _, treedef = tree_flatten(p["train"])
    loss, _ = TLM.loss_fn(p["frozen"], tree_unflatten(treedef, leaves), cfg,
                          {"tokens": toks})
    grads = torch.autograd.grad(loss, leaves)
    assert float(losses[0]) == float(loss)
    got = dict(flatten_with_names(trained))
    for n, t, g in zip(names, leaves, grads):
        torch.testing.assert_close(got[n], (t - 0.05 * g).detach(),
                                   rtol=0, atol=1e-7)
