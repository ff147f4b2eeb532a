"""The Mamba-2 archs against the JAX package: mamba2-370m (48 Mamba-2
layers, attention-free) and zamba2-2.7b (Mamba-2 layers with ONE frozen
GQA block shared every 6 layers, each invocation with its own adapters,
gelu MLP and KV cache) at their smoke configs, and tests/test_
consistency.py's Mamba (chunk 8) and zamba (shared every 2) configs:
tests/test_torch_lm.py's six whole-model checks, whose module docstring
states the tolerances. The prompt of 16 tokens is one chunk of the
smoke configs (chunk 16) and two of the consistency configs (chunk 8);
the teacher-forced forward over 17 or 24 tokens takes the tail padding.

The reference runs without XLA's excess precision (tests/test_torch_lm.py
says why). Measured against it on these four configs (the CPU, torch
2.13, jax 0.9): hidden states within 0.41% of max|h|, prefill and decode
logits within 0.51% of max|logit|, every cache leaf (the fp32 SSM state
and conv inputs, zamba's bf16 k/v) within 0.45% of its max, the loss
within 7.5e-5 relative, and every adapter and dense-trained gradient
(``wb``, ``wc``, ``wdt``, ``conv``, ``A_log``, ``D``, ``dt_bias``, the
norms) within 1.5% relative L2: inside tests/test_torch_lm.py's
REL = 4e-2, LOSS_REL = 2e-3 and GRAD_L2 = 6e-2.

Also the two prompt-length rules of a Mamba prefill (both packages'
behaviour) and the serving entry point on the CPU for both archs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro.core.lora import linear_apply as jlinear
from repro.models import lm as JLM
from repro_torch import serve as tserve
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as TLM

torch.set_num_threads(2)

NAMES = base.SSM + list(base.CONSIST_SSM)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("check", [
    base.check_forward_matches_jax,
    base.check_loss_and_adapter_grads_match_jax,
    base.check_prefill_and_decode_match_jax,
    base.check_generate_greedy_matches_jax,
    base.check_decode_matches_teacher_forced_forward,
    base.check_init_tree_structure_matches_jax],
    ids=lambda f: f.__name__[len("check_"):])
def test_ssm_arch_matches_jax(check, name):
    check(name)


def test_prompt_past_the_chunk_and_not_a_multiple_raises():
    """A 20-token prompt at chunk 16: the JAX package's final-state pass
    reshapes without the tail padding and fails; the port raises
    ValueError saying why. 32 tokens (two whole chunks) run in both."""
    c = base._case("mamba2-370m")
    toks = np.concatenate([c["toks"], c["toks"]], axis=1)
    with pytest.raises(TypeError, match="reshape"):
        JLM.prefill(c["jf"], c["jt"], c["jc"], jnp.asarray(toks[:, :20]))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TLM.prefill(c["tf"], c["tt"], c["tc"], toks[:, :20])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tserve.generate(c["tf"], c["tt"], c["tc"], toks[:, :20], 4,
                        device="cpu")
    lj, _, _ = JLM.prefill(c["jf"], c["jt"], c["jc"],
                           jnp.asarray(toks[:, :32]))
    lt, _, _ = TLM.prefill(c["tf"], c["tt"], c["tc"], toks[:, :32])
    base._close(lt, lj)


def test_prompt_shorter_than_the_conv_window_raises():
    """A 2-token prompt at conv kernel 4: the JAX package stores the two
    inputs at the front of its 3-slot conv cache, so its next decode
    step parts from its own teacher-forced forward; the port raises
    ValueError. At 3 tokens (the whole window) the JAX decode agrees
    with its forward and the port runs."""
    c = base._case("mamba2-370m")
    jc, jf, jt, toks = c["jc"], c["jf"], c["jt"], c["toks"]

    def jax_decode_err(s):
        _, caches, pos = JLM.prefill(jf, jt, jc, jnp.asarray(toks[:, :s]),
                                     max_seq=s + 1)
        ld, _ = JLM.decode_step(jf, jt, jc, jnp.asarray(toks[:, s:s + 1]),
                                caches, pos)
        h, _ = JLM.forward(jf, jt, jc, jnp.asarray(toks[:, :s + 1]))
        fl = jlinear(jf["head"], jt["head"], h, jc.lora.scale)
        return float(jnp.max(jnp.abs(ld[:, 0] - fl[:, s])))

    assert jax_decode_err(2) > 10 * base.CONSIST_TOL
    assert jax_decode_err(3) < base.CONSIST_TOL
    with pytest.raises(ValueError, match="at least 3 tokens"):
        TLM.prefill(c["tf"], c["tt"], c["tc"], toks[:, :2])
    lt, _, _ = TLM.prefill(c["tf"], c["tt"], c["tc"], toks[:, :3])
    lj, _, _ = JLM.prefill(jf, jt, jc, jnp.asarray(toks[:, :3]))
    base._close(lt, lj)


def test_shared_attention_is_one_frozen_set():
    """zamba2: one frozen GQA set at ``frozen['shared_attn']``, no
    frozen attention in the groups; each invocation has its own stacked
    adapters; the Mamba positions have no norm2."""
    c = base._case("zamba2-2.7b")
    tf, tt = c["tf"], c["tt"]
    assert set(tf["shared_attn"]) == {"wq", "wk", "wv", "wo"}
    assert tf["shared_attn"]["wq"]["w"].ndim == 2
    shared, *mamba = tt["groups"][0]
    assert "attn" not in tf["groups"][0][0] and "mlp" in tf["groups"][0][0]
    assert shared["attn"]["wq"]["a"].shape[0] == 2       # 2 invocations
    assert all("norm2" not in m and "mix" in m for m in mamba)


@pytest.mark.parametrize("arch", base.SSM)
def test_serve_entry_point_runs_on_cpu(arch):
    out = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--prompt-len", "16", "--gen", "4"])
    toks = out["tokens"]
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and out["decode_steps"] == 3
