"""The port's training entry point (``repro_torch.launch.train``) against the
JAX package's ``launch/train.py`` loop, on the smoke configs of
paligemma-3b (prefix-LM), seamless-m4t-medium (enc-dec) and gemma3-4b
(dense): the same loop built from the JAX package's ``loss_fn`` and
``adamw`` (its ``train_step``, jitted) on the batches the reference's
loop draws from ``default_rng(0)``, from one JAX ``init`` tree carried
across by ``convert`` with the adapters' ``b`` factors moved off zero.
The losses are held to LOSS_REL = 2e-3 relative, and the trained tree
and AdamW's moments (the running means of the gradients and of their
squares) to GRAD_L2 = 6e-2 relative L2 a leaf (tests/test_torch_lm.py's
tolerances). Measured (the CPU, torch 2.13, jax 0.9): the losses within
4.2e-4, the trees within 0.70%, the moments within 2.2%.

The updates (trained - start) are not held: AdamW steps each element by
about lr whatever its gradient's size, so where a gradient element lies
within the packages' bf16 noise of zero the two step it in opposite
directions. After three steps the updates part by up to 17% relative L2
a leaf (gemma3's ``k_norm``), and from a zero ``b`` (the init) the
trained ``b`` factors themselves by up to 12%.

A resume restores the trees and the optimizer state bit for bit, and its
next step takes the FIRST batch of ``default_rng(0)``: the reference
draws anew at every start (``src/repro/launch/train.py:83-85``), so a
resumed run does not continue the interrupted run's batch order."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro.configs import registry as JR
from repro.data.synthetic import markov_lm_batch as jmarkov
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry as TR
from repro_torch.launch import train
from repro_torch.utils.tree import flatten_with_names, tree_leaves

torch.set_num_threads(2)

ARCHS = ["paligemma-3b", "seamless-m4t-medium", "gemma3-4b"]
BATCH, SEQ, STEPS, LR = 2, 16, 3, 3e-4


def _args(steps, ckpt=None):
    argv = ["--arch", "x", "--steps", str(steps), "--batch", str(BATCH),
            "--seq", str(SEQ), "--lr", str(LR), "--checkpoint-every", "1"]
    return train.parse_args(argv + (["--checkpoint-dir", ckpt] if ckpt
                                    else []))


def reference_batch(rng, cfg, kind):
    """The reference loop's batch (``src/repro/launch/train.py:86-98``)."""
    if kind == "encdec":
        return {"src_embed": jnp.asarray(rng.normal(size=(
            BATCH, SEQ, cfg.d_model)), jnp.bfloat16),
            "tgt_tokens": jnp.asarray(jmarkov(rng, cfg.vocab, BATCH,
                                              SEQ)["tokens"])}
    batch = {"tokens": jnp.asarray(jmarkov(rng, cfg.vocab, BATCH,
                                           SEQ)["tokens"])}
    if cfg.prefix_lm:
        batch["prefix_embed"] = jnp.asarray(rng.normal(size=(
            BATCH, cfg.prefix_len, cfg.d_model)), jnp.bfloat16)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The reference's loop, ``STEPS`` steps from its seed-0 init (the
    ``b`` factors moved)."""
    entry = JR.get(arch)
    jc, kind = entry.smoke(), entry.kind
    mod = JED if kind == "encdec" else JLM
    p = jax.jit(lambda k: {part: mod.init(k, jc)[part]
                           for part in ("frozen", "train")})(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tr = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.01 * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype)
        if str(path[-1]) == "['b']" else x, p["train"])
    frozen = p["frozen"]
    opt = jadamw()
    st = opt.init(tr)

    @jax.jit
    def train_step(tr, st, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda t: mod.loss_fn(frozen, t, jc, batch), has_aux=True)(tr)
        tr, st = opt.update(grads, st, tr, LR)
        return tr, st, loss

    rng = np.random.default_rng(0)
    out = {"kind": kind, "frozen": jax.device_get(frozen),
           "train0": jax.device_get(tr), "batches": [], "losses": []}
    for _ in range(STEPS):
        batch = reference_batch(rng, jc, kind)
        tr, st, loss = train_step(tr, st, batch)
        out["batches"].append(jax.device_get(batch))
        out["losses"].append(float(loss))
    out["train"], out["opt"] = jax.device_get(tr), jax.device_get(st)
    return out


def _port(arch):
    """(frozen, train, cfg, kind) of the port from the JAX init tree."""
    j = _jax_run(arch)
    return (convert.params_from_jax(j["frozen"], "cpu"),
            convert.params_from_jax(j["train0"], "cpu"),
            TR.get(arch).smoke(), j["kind"])


def check_batches_are_the_reference_draws(arch):
    """``draw_batch`` from ``default_rng(0)``: the reference loop's
    batches, bit for bit."""
    j = _jax_run(arch)
    cfg = TR.get(arch).smoke()
    rng = np.random.default_rng(0)
    for want in j["batches"]:
        got = train.draw_batch(rng, cfg, j["kind"], BATCH, SEQ, "cpu")
        assert got.keys() == want.keys()
        for k in want:
            assert str(got[k].dtype) == f"torch.{want[k].dtype.name}", k
            assert np.array_equal(base._np(got[k]),
                                  np.asarray(want[k], np.float32)), k


def check_loop_matches_jax(arch):
    """Three steps of ``train_loop`` against the reference's loop: the
    losses, the trained tree and the optimizer's moments."""
    j = _jax_run(arch)
    frozen, tr, cfg, kind = _port(arch)
    out = train.train_loop(frozen, tr, cfg, kind, _args(STEPS),
                           np.random.default_rng(0))
    assert out["start"] == 0 and len(out["losses"]) == STEPS
    for got, want in zip(out["losses"], j["losses"]):
        assert abs(got - want) <= base.LOSS_REL * abs(want), (got, want)
    assert int(out["opt"]["count"]) == int(j["opt"]["count"]) == STEPS
    for part, want in (("train", j["train"]), ("opt", j["opt"])):
        got = out[part] if part == "train" else {
            k: out["opt"][k] for k in ("mu", "nu")}
        want = want if part == "train" else {k: want[k]
                                             for k in ("mu", "nu")}
        names = [n for n, _ in flatten_with_names(got)]
        for nm, a, b in zip(names, jax.tree.leaves(want), tree_leaves(got)):
            a, b = np.asarray(a, np.float64), base._np(b)
            assert a.shape == b.shape and np.isfinite(b).all(), nm
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
            assert rel <= base.GRAD_L2, (part, nm, rel)


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def check_resume_restores_bit_for_bit(arch, tmp_path):
    """Two steps checkpointed every step, then a fresh run of three on
    the same directory: it restores step 2's trees and optimizer state
    bit for bit, and its one step equals a step from that state on the
    first batch of ``default_rng(0)`` (not the third)."""
    frozen, tr, cfg, kind = _port(arch)
    d = str(tmp_path)
    first = train.train_loop(frozen, tr, cfg, kind, _args(2, d),
                             np.random.default_rng(0))
    restored = []
    orig = CheckpointManager.restore_latest

    def restore_latest(self, like, device=None):
        got = orig(self, like, device)
        restored.append(got)
        return got

    CheckpointManager.restore_latest = restore_latest
    try:
        resumed = train.train_loop(frozen, tr, cfg, kind, _args(3, d),
                                   np.random.default_rng(0))
    finally:
        CheckpointManager.restore_latest = orig
    (step, trees, _), = restored
    assert step == 2 and resumed["start"] == 2
    assert len(resumed["losses"]) == 1
    assert _equal_trees(trees["train"], first["train"])
    assert _equal_trees(trees["opt"], first["opt"])
    rng = np.random.default_rng(0)
    batches = [train.draw_batch(rng, cfg, kind, BATCH, SEQ, "cpu")
               for _ in range(3)]
    steps = [train.train_step(frozen, first["train"], first["opt"], cfg,
                              kind, b, LR) for b in (batches[0], batches[2])]
    assert _equal_trees(resumed["train"], steps[0][0])
    assert _equal_trees(resumed["opt"], steps[0][1])
    assert float(steps[0][2]) == resumed["losses"][0]
    assert not _equal_trees(resumed["train"], steps[1][0])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("check", [
    check_batches_are_the_reference_draws, check_loop_matches_jax],
    ids=lambda f: f.__name__[len("check_"):])
def test_train_loop_matches_jax(check, arch):
    check(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_restores_bit_for_bit(arch, tmp_path):
    check_resume_restores_bit_for_bit(arch, tmp_path)


@pytest.mark.parametrize("arch", ARCHS)
def test_main_runs_on_cpu(arch, tmp_path, capsys):
    out = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                      "2", "--seq", "16", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path),
                      "--checkpoint-every", "2"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    text = capsys.readouterr().out
    assert "step 2: loss=" in text and text.rstrip().endswith("done")
    assert CheckpointManager(str(tmp_path)).restore_latest(
        {"train": out["train"]})[0] == 2
