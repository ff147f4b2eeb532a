"""The prefix-LM (paligemma-3b's smoke config, and the same with its 4
query heads padded to 8 as the published config pads 8 to 16) against
the JAX package, on JAX ``init`` trees carried across by ``convert``
with the adapters' ``b`` factors moved off zero, at tests/test_torch_
lm.py's tolerances (its module docstring says why). An 8-token prefix
of random patch embeddings (the image frontend is a stub) goes before
16 or 24 text tokens: ``forward``, ``loss_fn`` with a loss mask and its
adapter gradients, ``prefill`` + 8 decode steps with every cache leaf,
and the port's decode against its own teacher-forced forward, each with
``prefix_embed``. Measured (the CPU, torch 2.13, jax 0.9): hidden states,
logits and caches within 1.10% of their max, the loss within 1.2e-4
relative, every gradient within 1.4% relative L2; the port's prefill
equals its forward and its decode step lies within 0.016-0.023 of it
(logits of max ~4.5).

Text only, the reference is asymmetric and the port copies it:
``forward`` falls back to ``cfg.prefix_len`` (the first 8 TEXT tokens
attend both ways), ``prefill`` does not (causal throughout), so the
two part on a prefix-LM (0.031-0.039 on the last logits here; the
reference's own 0.0234 on paligemma's smoke config at seed 0).
``generate`` is text only and sizes its cache as prompt + gen +
``cfg.prefix_len``, the reference's formula."""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro import serve as jserve
from repro.configs import registry as JR
from repro.models import lm as JLM
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch.configs import registry as TR
from repro_torch.models import lm as TLM
from repro_torch.utils.tree import flatten_with_names, tree_leaves, tree_map

torch.set_num_threads(2)

_close = base._close
ARCH = "paligemma-3b"
NAMES = [ARCH, "padded"]
P, PROMPT, STEPS = 8, 16, 8     # prefix, prompt, decode steps


def _cfgs(name):
    jc, tc = JR.get(ARCH).smoke(), TR.get(ARCH).smoke()
    if name == "padded":
        jc, tc = (dataclasses.replace(c, pad_heads_to=8) for c in (jc, tc))
    assert jc.prefix_lm and jc.prefix_len == P
    return jc, tc


@contextlib.contextmanager
def recorded_prefill(mod, calls: list):
    """While open, every ``mod.prefill`` call appends its ``max_seq``
    and the caches' slot counts to ``calls``."""
    orig = mod.prefill

    def prefill(*args, **kw):
        out = orig(*args, **kw)
        calls.append((kw.get("max_seq"),
                      sorted({int(t.shape[2]) for t in (
                          tree_leaves(out[1]) if mod is TLM
                          else jax.tree.leaves(out[1]))})))
        return out

    mod.prefill = prefill
    try:
        yield calls
    finally:
        mod.prefill = orig


@functools.lru_cache(maxsize=None)
def _case(name):
    """The trees, the inputs and the JAX package's results, once."""
    jc, tc = _cfgs(name)
    p = jax.jit(lambda k: {part: JLM.init(k, jc)[part]
                           for part in ("frozen", "train")})(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jt = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.01 * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype)
        if str(path[-1]) == "['b']" else x, p["train"])
    jf = p["frozen"]
    toks = rng.integers(0, jc.vocab, (2, PROMPT + STEPS + 1)).astype(
        np.int32)
    pre = rng.standard_normal((2, P, jc.d_model)).astype(np.float32)
    mask = (rng.random((2, PROMPT + STEPS)) < 0.7).astype(np.float32)
    jpre = jnp.asarray(pre)
    out = {"jc": jc, "tc": tc, "p": p, "jf": jf, "jt": jt, "toks": toks,
           "pre": pre, "mask": mask,
           "tf": convert.params_from_jax(jax.device_get(jf), "cpu"),
           "tt": convert.params_from_jax(jax.device_get(jt), "cpu")}
    fwd = jax.jit(lambda tok, pe: JLM.forward(jf, jt, jc, tok, pe)[0])
    out["h_pre"] = np.asarray(fwd(jnp.asarray(toks[:, :-1]), jpre))
    out["h_txt"] = np.asarray(fwd(jnp.asarray(toks[:, :-1]), None))
    batch = {"tokens": jnp.asarray(toks), "prefix_embed": jpre,
             "loss_mask": jnp.asarray(mask)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda t: JLM.loss_fn(jf, t, jc, batch), has_aux=True))(jt)
    out["loss"], out["grads"] = float(loss), jax.device_get(grads)
    prefill = jax.jit(lambda tok, pe: JLM.prefill(
        jf, jt, jc, tok, pe, max_seq=P + PROMPT + STEPS))
    decode = jax.jit(lambda tok, cache, pos: JLM.decode_step(
        jf, jt, jc, tok, cache, pos))
    lp, caches, pos = prefill(jnp.asarray(toks[:, :PROMPT]), jpre)
    out["prefill"], out["pos"] = np.asarray(lp), int(pos)
    out["caches"] = jax.device_get(caches)
    steps = []
    for t in range(PROMPT, PROMPT + STEPS):
        ld, caches = decode(jnp.asarray(toks[:, t:t + 1]), caches,
                            jnp.asarray(P + t, jnp.int32))
        steps.append(np.asarray(ld))
    out["steps"], out["final_caches"] = steps, jax.device_get(caches)
    out["text_prefill"] = np.asarray(JLM.prefill(
        jf, jt, jc, jnp.asarray(toks[:, :PROMPT]))[0])
    with recorded_prefill(JLM, []) as calls:
        gen, _ = jserve.generate(jf, jt, jc, jnp.asarray(toks[:, :PROMPT]),
                                 STEPS)
    out["gen"], out["gen_prefill"] = np.array(gen), calls
    return out


def check_forward_with_prefix_matches_jax(name):
    c = _case(name)
    h, aux = TLM.forward(c["tf"], c["tt"], c["tc"], c["toks"][:, :-1],
                         prefix_embed=c["pre"])
    assert h.shape == (2, P + PROMPT + STEPS, c["tc"].d_model)
    assert h.dtype == torch.bfloat16 and float(aux) == 0.0
    _close(h, c["h_pre"])


def check_loss_and_adapter_grads_with_prefix_match_jax(name):
    """The loss over the text labels only (the prefix's rows dropped),
    under a loss mask, and every adapter's gradient."""
    c = _case(name)
    tt = tree_map(lambda t: t.clone().requires_grad_(True), c["tt"])
    batch = {"tokens": c["toks"], "prefix_embed": c["pre"],
             "loss_mask": c["mask"]}
    loss, _ = TLM.loss_fn(c["tf"], tt, c["tc"], batch)
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
    # the mask counts: unmasked, the loss is another
    full, _ = TLM.loss_fn(c["tf"], c["tt"], c["tc"],
                          {"tokens": c["toks"], "prefix_embed": c["pre"]})
    assert abs(float(full) - c["loss"]) > base.LOSS_REL * abs(c["loss"])


def check_prefill_and_decode_with_prefix_match_jax(name):
    """Prefill of the prefix and a 16-token prompt, every cache leaf,
    then 8 decode steps at positions 24..31."""
    c = _case(name)
    lp, caches, pos = TLM.prefill(c["tf"], c["tt"], c["tc"],
                                  c["toks"][:, :PROMPT], c["pre"],
                                  max_seq=P + PROMPT + STEPS)
    assert pos == c["pos"] == P + PROMPT
    _close(lp, c["prefill"])
    got, want = tree_leaves(caches), jax.tree.leaves(c["caches"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert str(a.dtype) == f"torch.{b.dtype.name}" and a.shape == b.shape
        _close(a, b)
    for t, ld_j in zip(range(PROMPT, PROMPT + STEPS), c["steps"]):
        ld, caches = TLM.decode_step(c["tf"], c["tt"], c["tc"],
                                     c["toks"][:, t:t + 1], caches, P + t)
        _close(ld, ld_j)
    for a, b in zip(tree_leaves(caches), jax.tree.leaves(c["final_caches"])):
        _close(a, b)


def check_text_forward_falls_back_to_prefix_len(name):
    """Without ``prefix_embed`` the forward makes the first
    ``cfg.prefix_len`` text tokens bidirectional, as the reference's: it
    matches the reference and parts from a causal forward there."""
    c = _case(name)
    h, _ = TLM.forward(c["tf"], c["tt"], c["tc"], c["toks"][:, :-1])
    _close(h, c["h_txt"])
    causal, _ = TLM.forward(c["tf"], c["tt"],
                            dataclasses.replace(c["tc"], prefix_lm=False),
                            c["toks"][:, :-1])
    assert float((h[:, 0] - causal[:, 0]).abs().max()) > 0


def check_text_prefill_is_causal_as_the_reference(name):
    """The reference's asymmetry: a text-only prefill is causal
    throughout, so its last logits match the reference's prefill and
    part from the forward's fallback."""
    c = _case(name)
    lp, _, pos = TLM.prefill(c["tf"], c["tt"], c["tc"], c["toks"][:, :PROMPT])
    assert pos == PROMPT
    _close(lp, c["text_prefill"])
    h, _ = TLM.forward(c["tf"], c["tt"], c["tc"], c["toks"][:, :PROMPT])
    fl = TLM._head_logits(c["tf"], c["tt"], c["tc"], h[:, -1])
    assert float((fl - lp).abs().max()) > 1e-3


def check_generate_text_only_matches_jax(name):
    """Greedy text-only ``generate``: the ``max_seq`` it passes to
    ``prefill`` and the cache it builds are the reference's prompt + gen
    + ``cfg.prefix_len``; the tokens equal the reference's except past a
    near tie (the port's logits along the reference's tokens put the two
    choices within twice the logits tolerance)."""
    c = _case(name)
    with recorded_prefill(TLM, []) as calls:
        toks, timing = tserve.generate(c["tf"], c["tt"], c["tc"],
                                       c["toks"][:, :PROMPT], STEPS,
                                       device="cpu")
    want = PROMPT + STEPS + P
    assert calls == c["gen_prefill"] == [(want, [want])]
    assert toks.shape == (2, STEPS) and timing["decode_steps"] == STEPS - 1
    got, ref = toks.numpy(), c["gen"]
    if not np.array_equal(got, ref):
        _, caches, pos = TLM.prefill(c["tf"], c["tt"], c["tc"],
                                     c["toks"][:, :PROMPT], max_seq=want)
        path = [TLM.prefill(c["tf"], c["tt"], c["tc"],
                            c["toks"][:, :PROMPT])[0]]
        for i in range(STEPS - 1):
            ld, caches = TLM.decode_step(c["tf"], c["tt"], c["tc"],
                                         ref[:, i:i + 1], caches, pos + i)
            path.append(ld[:, 0])
        logits = torch.stack(path, dim=1).numpy()
        for row in range(2):
            diff = np.nonzero(got[row] != ref[row])[0]
            if diff.size:
                i = int(diff[0])
                lg = logits[row, i]
                gap = lg[got[row, i]] - lg[ref[row, i]]
                assert abs(gap) <= 2 * base.REL * np.abs(lg).max(), (row, i)


def check_decode_matches_teacher_forced_forward(name):
    """The port's own serving path with the prefix: prefill + a decode
    step reproduce the teacher-forced forward's logits over [prefix;
    prompt + 1] (tests/test_consistency.py's 5e-2)."""
    c = _case(name)
    tf, tt, tc, toks = c["tf"], c["tt"], c["tc"], c["toks"]
    lp, caches, pos = TLM.prefill(tf, tt, tc, toks[:, :PROMPT], c["pre"],
                                  max_seq=P + PROMPT + 1)
    ld, _ = TLM.decode_step(tf, tt, tc, toks[:, PROMPT:PROMPT + 1], caches,
                            pos)
    h, _ = TLM.forward(tf, tt, tc, toks[:, :PROMPT + 1], c["pre"])
    fl = TLM._head_logits(tf, tt, tc, h)
    assert float((lp - fl[:, P + PROMPT - 1]).abs().max()) < base.CONSIST_TOL
    assert float((ld[:, 0] - fl[:, P + PROMPT]).abs().max()) < \
        base.CONSIST_TOL


def check_prefix_mask(name):
    """Within the prefix attention goes both ways: a change to the last
    prefix embedding moves the first position's output. Past it, it is
    causal: a change to text token 3 leaves every earlier position's
    output as it was, bit for bit, and moves the later ones."""
    c = _case(name)
    tf, tt, tc, toks = c["tf"], c["tt"], c["tc"], c["toks"][:, :PROMPT]
    h, _ = TLM.forward(tf, tt, tc, toks, c["pre"])
    pre = c["pre"].copy()
    pre[:, P - 1] += 1.0
    h2, _ = TLM.forward(tf, tt, tc, toks, pre)
    assert float((h2[:, 0] - h[:, 0]).abs().max()) > 0
    toks2 = toks.copy()
    toks2[:, 3] = (toks2[:, 3] + 1) % tc.vocab
    h3, _ = TLM.forward(tf, tt, tc, toks2, c["pre"])
    assert torch.equal(h3[:, :P + 3], h[:, :P + 3])
    assert all(float((h3[:, t] - h[:, t]).abs().max()) > 0
               for t in range(P + 3, P + PROMPT))


def check_init_tree_matches_jax(name):
    """The port's own init: the JAX package's leaves, shapes and dtypes;
    b zero, the norms one."""
    c = _case(name)
    p = TLM.init(torch.Generator().manual_seed(0), c["tc"], device="cpu")
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


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("check", [
    check_forward_with_prefix_matches_jax,
    check_loss_and_adapter_grads_with_prefix_match_jax,
    check_prefill_and_decode_with_prefix_match_jax,
    check_text_forward_falls_back_to_prefix_len,
    check_text_prefill_is_causal_as_the_reference,
    check_generate_text_only_matches_jax,
    check_decode_matches_teacher_forced_forward, check_prefix_mask,
    check_init_tree_matches_jax],
    ids=lambda f: f.__name__[len("check_"):])
def test_prefix_lm_matches_jax(check, name):
    check(name)
