"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
JAX package's, on JAX ``init`` trees carried across by ``convert`` with
the adapters' ``b`` factors moved off zero: seamless-m4t-medium's smoke
config and tests/test_consistency.py's enc-dec config. Each function
(``init``, ``encode``, ``decode_train``, ``loss_fn`` and its adapter
gradients, ``cross_cache``, ``self_cache_init``, ``decode_step``) is
held to the reference at tests/test_torch_lm.py's tolerances (its
module docstring says why): REL = 4e-2 of the max for hidden states,
logits and caches, LOSS_REL = 2e-3 for the loss, GRAD_L2 = 6e-2 relative
L2 for each gradient. The JAX results of a config are computed once and
shared by its checks. Measured (the CPU, torch 2.13, jax 0.9): the
encoder output and the decoder's hidden states within 0.82-1.40% of
their max, the cross cache equal, the decode logits and self caches
within 1.34%, the loss within 6.7e-4 relative, every gradient within
2.3% relative L2.

Also the port's own decode against its teacher-forced decoder
(tests/test_consistency.py's check at 5e-2 absolute: the port 0.047 on
seamless's smoke config and 0.031 on the consistency config, the
reference 0.040 and 0.035, of logits of max ~4), and remat on and off
giving the same gradients."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro.configs import registry as JR
from repro.core.lora import LoRAConfig as JLoRA
from repro.models import encdec as JED
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.core.lora import LoRAConfig as TLoRA
from repro_torch.core.lora import linear_apply as tlinear
from repro_torch.models import encdec as TED
from repro_torch.utils.tree import flatten_with_names, tree_leaves, tree_map

torch.set_num_threads(2)

_close = base._close
ARCH = "seamless-m4t-medium"
# tests/test_consistency.py::test_encdec_stepwise_equals_teacher_forcing
CONSIST = dict(n_enc_layers=2, n_dec_layers=2, d_model=32, n_heads=4,
               n_kv_heads=4, head_dim=8, d_ff=64, vocab=128)
NAMES = [ARCH, "consist"]
SRC, STEPS, SMAX = 12, 9, 16      # frames, decode steps, self-cache slots


def _cfgs(name):
    if name == ARCH:
        return JR.get(name).smoke(), TR.get(name).smoke()
    return (JED.EncDecConfig(name="t", lora=JLoRA(rank=4, alpha=64.0),
                             **CONSIST),
            TED.EncDecConfig(name="t", lora=TLoRA(rank=4, alpha=64.0),
                             **CONSIST))


@functools.lru_cache(maxsize=None)
def _case(name):
    """The trees, the inputs and the JAX package's results, once (init,
    the loss's gradient and the decode step jitted: compiled once, they
    take a third of the eager calls' time)."""
    jc, tc = _cfgs(name)
    p = jax.jit(lambda k: {part: JED.init(k, jc)[part]
                           for part in ("frozen", "train")})(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jt = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.01 * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype)
        if str(path[-1]) == "['b']" else x, p["train"])
    jf = p["frozen"]
    src = rng.standard_normal((2, SRC, jc.d_model)).astype(np.float32)
    tgt = rng.integers(0, jc.vocab, (2, STEPS + 1)).astype(np.int32)
    batch = {"src_embed": jnp.asarray(src), "tgt_tokens": jnp.asarray(tgt)}
    mem = JED.encode(jf, jt, jc, jnp.asarray(src))
    hd = JED.decode_train(jf, jt, jc, jnp.asarray(tgt[:, :-1]), mem)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda t: JED.loss_fn(jf, t, jc, batch), has_aux=True))(jt)
    cross = JED.cross_cache(jf, jt, jc, mem)
    caches = JED.self_cache_init(jc, 2, SMAX)
    cache0 = jax.device_get(caches)
    step = jax.jit(lambda tok, cache, pos: JED.decode_step(
        jf, jt, jc, tok, cache, cross, pos))
    steps = []
    for t in range(STEPS):
        lg, caches = step(jnp.asarray(tgt[:, t:t + 1]), caches,
                          jnp.asarray(t, jnp.int32))
        steps.append(np.asarray(lg))
    return {"jc": jc, "tc": tc, "p": p, "jf": jf, "jt": jt, "src": src,
            "tgt": tgt, "tf": convert.params_from_jax(jax.device_get(jf),
                                                      "cpu"),
            "tt": convert.params_from_jax(jax.device_get(jt), "cpu"),
            "mem": jax.device_get(mem), "hd": jax.device_get(hd),
            "loss": float(loss), "xent": float(aux["xent"]),
            "grads": jax.device_get(grads), "cross": jax.device_get(cross),
            "cache0": cache0, "steps": steps,
            "caches": jax.device_get(caches)}


def _mem(c) -> torch.Tensor:
    """The JAX package's encoder output as a port tensor (bf16)."""
    return convert.params_from_jax(c["mem"], "cpu")


def _same_dtype(got: torch.Tensor, want) -> None:
    assert str(got.dtype) == f"torch.{np.asarray(want).dtype.name}", (
        got.dtype, np.asarray(want).dtype)


def check_convert_carries_the_tree(name):
    """``params_from_jax`` carries an enc-dec tree leaf for leaf: the
    names, shapes, dtypes and values of the JAX tree."""
    c = _case(name)
    for part, tree in (("frozen", c["tf"]), ("train", c["tt"])):
        want = jax.tree_util.tree_flatten_with_path(c["j" + part[0]])[0]
        got = flatten_with_names(tree)
        assert len(got) == len(want)
        for (nm, t), (path, a) in zip(got, want):
            assert nm == "/".join(str(getattr(k, "key", getattr(
                k, "idx", k))) for k in path), (nm, path)
            _same_dtype(t, a)
            assert np.array_equal(base._np(t), np.asarray(a, np.float32)), nm


def check_init_tree_matches_jax(name):
    """The port's own ``init``: the reference's leaves, shapes and
    dtypes; every ``b`` zero and every norm one."""
    c = _case(name)
    p = TED.init(torch.Generator().manual_seed(0), c["tc"], device="cpu")
    for part in ("frozen", "train"):
        want = dict(flatten_with_names(convert.params_from_jax(
            jax.device_get(c["p"][part]), "cpu")))
        got = dict(flatten_with_names(p[part]))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
            if k.endswith("/b") or k.endswith("scale"):
                assert torch.equal(got[k], want[k]), k
    assert {"norm_x", "cross"} <= set(p["train"]["dec"])
    assert "cross" not in p["train"]["enc"]


def check_encode_matches_jax(name):
    c = _case(name)
    got = TED.encode(c["tf"], c["tt"], c["tc"], c["src"])
    assert got.dtype == torch.bfloat16
    _close(got, c["mem"])


def check_decode_train_matches_jax(name):
    """The teacher-forced decoder on the reference's encoder output."""
    c = _case(name)
    got = TED.decode_train(c["tf"], c["tt"], c["tc"], c["tgt"][:, :-1],
                           _mem(c))
    assert got.shape == (2, STEPS, c["tc"].d_model)
    _close(got, c["hd"])


def check_loss_and_adapter_grads_match_jax(name):
    c = _case(name)
    tt = tree_map(lambda t: t.clone().requires_grad_(True), c["tt"])
    loss, aux = TED.loss_fn(c["tf"], tt, c["tc"],
                            {"src_embed": c["src"], "tgt_tokens": c["tgt"]})
    assert set(aux) == {"xent"} and aux["xent"] is loss
    assert abs(float(loss.detach()) - c["loss"]) <= \
        base.LOSS_REL * abs(c["loss"])
    names = [n for n, _ in flatten_with_names(tt)]
    gt = torch.autograd.grad(loss, tree_leaves(tt))
    gj = jax.tree.leaves(c["grads"])
    assert len(gj) == len(gt) == len(names)
    for nm, a, b in zip(names, gj, gt):
        a, b = base._np(a), base._np(b)
        assert a.shape == b.shape and np.isfinite(b).all(), nm
        assert np.abs(a).max() > 0, nm
        rel = np.linalg.norm(a - b) / np.linalg.norm(a)
        assert rel <= base.GRAD_L2, (nm, rel)
    assert all(t.grad is None and not t.requires_grad
               for t in tree_leaves(c["tf"]))


def check_cross_cache_matches_jax(name):
    """The stacked cross K/V of the reference's encoder output, in its
    dtype."""
    c = _case(name)
    got = TED.cross_cache(c["tf"], c["tt"], c["tc"], _mem(c))
    assert set(got) == set(c["cross"])
    for k in got:
        _same_dtype(got[k], c["cross"][k])
        assert got[k].shape == (c["tc"].n_dec_layers, 2, SRC,
                                c["tc"].n_kv_heads, c["tc"].head_dim)
        _close(got[k], c["cross"][k])


def check_self_cache_init_matches_jax(name):
    c = _case(name)
    got = TED.self_cache_init(c["tc"], 2, SMAX, device="cpu")
    assert set(got) == set(c["cache0"])
    for k in got:
        _same_dtype(got[k], c["cache0"][k])
        assert tuple(got[k].shape) == c["cache0"][k].shape
        assert not bool(got[k].any())


def check_decode_steps_match_jax(name):
    """The whole serving path: encode, cross_cache, self_cache_init and
    9 decode steps; every step's logits and the final caches."""
    c = _case(name)
    tf, tt, tc = c["tf"], c["tt"], c["tc"]
    with torch.no_grad():
        mem = TED.encode(tf, tt, tc, c["src"])
        cross = TED.cross_cache(tf, tt, tc, mem)
        caches = TED.self_cache_init(tc, 2, SMAX, device="cpu")
        for t in range(STEPS):
            lg, out = TED.decode_step(tf, tt, tc, c["tgt"][:, t:t + 1],
                                      caches, cross, t)
            assert out is caches
            assert lg.shape == (2, 1, tc.vocab) and lg.dtype == torch.float32
            _close(lg, c["steps"][t])
    for k in caches:
        _same_dtype(caches[k], c["caches"][k])
        _close(caches[k], c["caches"][k])
        assert not bool(caches[k][:, :, STEPS:].any())
    for k in cross:
        _close(cross[k], c["cross"][k])


def check_stepwise_equals_teacher_forcing(name):
    """The port's own decode steps reproduce its teacher-forced decoder's
    logits (tests/test_consistency.py's check, 5e-2 absolute)."""
    c = _case(name)
    tf, tt, tc = c["tf"], c["tt"], c["tc"]
    with torch.no_grad():
        mem = TED.encode(tf, tt, tc, c["src"])
        cross = TED.cross_cache(tf, tt, tc, mem)
        caches = TED.self_cache_init(tc, 2, SMAX, device="cpu")
        steps = [TED.decode_step(tf, tt, tc, c["tgt"][:, t:t + 1], caches,
                                 cross, t)[0] for t in range(STEPS)]
        h = TED.decode_train(tf, tt, tc, c["tgt"][:, :STEPS], mem)
        fl = tlinear(tf["head"], tt["head"], h, tc.lora.scale).float()
    err = float((torch.cat(steps, dim=1) - fl).abs().max())
    assert err < base.CONSIST_TOL, err


def check_remat_keeps_the_gradients(name):
    """``cfg.remat`` (each layer recomputed in the backward pass) gives
    the gradients and the loss of the plain backward, bit for bit."""
    c = _case(name)
    batch = {"src_embed": c["src"], "tgt_tokens": c["tgt"]}
    out = []
    for remat in (True, False):
        tc = dataclasses.replace(c["tc"], remat=remat)
        tt = tree_map(lambda t: t.clone().requires_grad_(True), c["tt"])
        loss, _ = TED.loss_fn(c["tf"], tt, tc, batch)
        out.append((loss.detach(), torch.autograd.grad(loss,
                                                       tree_leaves(tt))))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("check", [
    check_convert_carries_the_tree, check_init_tree_matches_jax,
    check_encode_matches_jax, check_decode_train_matches_jax,
    check_loss_and_adapter_grads_match_jax, check_cross_cache_matches_jax,
    check_self_cache_init_matches_jax, check_decode_steps_match_jax,
    check_stepwise_equals_teacher_forcing, check_remat_keeps_the_gradients],
    ids=lambda f: f.__name__[len("check_"):])
def test_encdec_matches_jax(check, name):
    check(name)


def test_lm_functions_refuse_the_encdec_config():
    """The decoder LM's functions point an enc-dec config to
    ``models/encdec.py``."""
    from repro_torch.models import lm as TLM
    cfg = TR.get(ARCH).smoke()
    with pytest.raises(TypeError, match="models.encdec"):
        TLM.init(0, cfg, device="cpu")
    with pytest.raises(TypeError, match="models.encdec"):
        TLM.cache_init(cfg, 1, 8, device="cpu")
