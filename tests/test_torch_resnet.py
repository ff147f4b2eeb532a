"""The port's ResNet-8 with conv-LoRA adapters vs the JAX model, run
eagerly (no jit), from one JAX-initialized tree carried across with
convert.py. Batch 2 of 16x16x3 images: 16 is even, so the stride-2
"SAME" convolutions pad (0, 1) as XLA does.

Logits, loss and the gradient of every trainable leaf agree at
rtol=1e-4, atol=1e-5 (fp32 on both sides, different summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import lora as jlora
from repro.models import layers as jlayers
from repro.models import resnet as jresnet
from repro.utils.tree import flatten_with_names as jnames
from repro_torch import convert
from repro_torch.core import lora as tlora
from repro_torch.models import layers as tlayers
from repro_torch.models import resnet as tresnet
from repro_torch.utils.tree import flatten_with_names, tree_size

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(**kw):
    j = jresnet.ResNetConfig(arch="resnet8",
                             lora=jlora.LoRAConfig(rank=8, alpha=128.0), **kw)
    t = tresnet.ResNetConfig(arch="resnet8",
                             lora=tlora.LoRAConfig(rank=8, alpha=128.0), **kw)
    return j, t


def _model(jcfg, seed=0, jax_init=True):
    """JAX init (or numpy draws on the JAX tree's shapes), then every
    trainable leaf moved off its init (the zero-initialized adapter
    ``a`` would give ``b`` a zero gradient)."""
    rng = np.random.default_rng(seed)
    if jax_init:
        m = jax.device_get(jax.jit(lambda k: jresnet.init(k, jcfg))(
            jax.random.PRNGKey(seed)))
    else:
        m = jax.tree.map(
            lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
            jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0),
                                                jcfg)))
    m["train"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        m["train"])
    return m


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    m = _model(jcfg)
    rng = np.random.default_rng(1)
    batch = {"x": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
             "y": np.array([3, 8], np.int32)}
    return jcfg, tcfg, m, batch


def test_logits_and_loss_match_jax(setup):
    jcfg, tcfg, m, batch = setup
    pm = convert.params_from_jax(m, "cpu")
    want = np.asarray(jresnet.apply(m["frozen"], m["train"], jcfg,
                                    jnp.asarray(batch["x"])))
    got = tresnet.apply(pm["frozen"], pm["train"], tcfg,
                        torch.from_numpy(batch["x"]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jl, _ = jresnet.loss_fn(m["frozen"], m["train"], jcfg,
                            jax.tree.map(jnp.asarray, batch))
    tl, _ = tresnet.loss_fn(pm["frozen"], pm["train"], tcfg,
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_gradients_match_jax(setup):
    jcfg, tcfg, m, batch = setup
    jb = jax.tree.map(jnp.asarray, batch)
    jgrads = jax.grad(lambda t: jresnet.loss_fn(m["frozen"], t, jcfg,
                                                jb)[0])(
        jax.tree.map(jnp.asarray, m["train"]))
    pm = convert.params_from_jax(m, "cpu")
    names_params = flatten_with_names(pm["train"])
    params = [p.requires_grad_(True) for _, p in names_params]
    loss, _ = tresnet.loss_fn(pm["frozen"], pm["train"], tcfg,
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, params)
    jg = jnames(jgrads)
    assert [n for n, _ in names_params] == [n for n, _ in jg]
    for (n, want), got in zip(jg, grads):
        assert float(np.abs(np.asarray(want)).max()) > 0.0, n
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("kw", [{"fc_mode": "lora"}, {"stem_mode": "lora"},
                                {"mode": "fedavg"}])
def test_variant_logits_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    m = _model(jcfg, seed=2, jax_init=False)
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    pm = convert.params_from_jax(m, "cpu")
    want = np.asarray(jresnet.apply(m["frozen"], m["train"], jcfg,
                                    jnp.asarray(x)))
    got = tresnet.apply(pm["frozen"], pm["train"], tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k,stride,size", [(3, 2, 16), (1, 2, 16),
                                           (3, 1, 16), (3, 2, 15)])
def test_same_conv_matches_xla(k, stride, size):
    """XLA's "SAME" puts the odd pad pixel last: (0, 1) for a 3x3 stride-2
    conv on an even input, where F.conv2d(padding=1) pads (1, 1)."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, size, size, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 8, 16)).astype(np.float32)
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=dn))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tlora.conv2d_nchw(xt, torch.from_numpy(w), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    if (k, stride, size) == (3, 2, 16):
        naive = F.conv2d(xt, torch.from_numpy(w).permute(3, 2, 0, 1),
                         stride=stride, padding=1).permute(0, 2, 3, 1)
        assert not np.allclose(naive.numpy(), want, **TOL)


def test_conv_lora_apply_stride2_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    b = rng.normal(size=(3, 3, 8, 4)).astype(np.float32)
    a = rng.normal(size=(1, 1, 4, 16)).astype(np.float32)
    want = np.asarray(jlora.conv_lora_apply(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(a), 2.0, (2, 2), "SAME"))
    got = tlora.conv_lora_apply(torch.from_numpy(x), torch.from_numpy(b),
                                torch.from_numpy(a), 2.0, (2, 2), "SAME")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_groupnorm_matches_jax():
    rng = np.random.default_rng(6)
    x = (3.0 * rng.normal(size=(2, 5, 5, 64)) + 1.0).astype(np.float32)
    p = {"scale": rng.normal(size=(64,)).astype(np.float32),
         "bias": rng.normal(size=(64,)).astype(np.float32)}
    want = np.asarray(jlayers.groupnorm_apply(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), groups=32))
    got = tlayers.groupnorm_apply({k: torch.from_numpy(v)
                                   for k, v in p.items()},
                                  torch.from_numpy(x), groups=32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("rank,trained,total", [
    (8, 69_450, 1_290_058),
    (16, 131_914, 1_352_522),
    (32, 256_842, 1_477_450),
])
def test_table1_param_counts(rank, trained, total):
    """Paper Table I, from the port's own init."""
    cfg = tresnet.ResNetConfig(
        arch="resnet8", lora=tlora.LoRAConfig(rank=rank, alpha=16.0 * rank))
    p = tresnet.init(0, cfg, device="cpu")
    assert tree_size(p["train"]) == trained
    assert tree_size(p["train"]) + tree_size(p["frozen"]) == total


def test_fedavg_resnet8_params():
    p = tresnet.init(0, tresnet.ResNetConfig(mode="fedavg"), device="cpu")
    assert tree_size(p["train"]) == 1_227_594          # paper: 1.23M


def test_init_tree_matches_jax_structure():
    jcfg, tcfg = _cfgs()
    jm = jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0), jcfg))
    tm = tresnet.init(0, tcfg, device="cpu")
    assert [(n, tuple(x.shape)) for n, x in flatten_with_names(tm)] == \
        [(n, tuple(x.shape)) for n, x in jnames(jm)]
