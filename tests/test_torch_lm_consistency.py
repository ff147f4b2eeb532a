"""The port's LM against the JAX package's on tests/test_consistency.py's
GQA, padded-head and sliding-window-ring configs: the checks of
tests/test_torch_lm.py (whose module docstring states the tolerances),
the head's logits, and the reference behaviour at a prompt shorter than
the window."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro.core.lora import linear_apply as jlinear
from repro.models import lm as JLM
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch.models import lm as TLM

torch.set_num_threads(2)

_case, _close = base._case, base._close


@pytest.mark.parametrize("name", list(base.CONSIST))
@pytest.mark.parametrize("check", [
    base.check_forward_matches_jax,
    base.check_loss_and_adapter_grads_match_jax,
    base.check_prefill_and_decode_match_jax,
    base.check_generate_greedy_matches_jax,
    base.check_decode_matches_teacher_forced_forward,
    base.check_init_tree_structure_matches_jax],
    ids=lambda f: f.__name__[len("check_"):])
def test_consistency_config_matches_jax(check, name):
    check(name)


def test_head_logits_match_jax_linear_apply():
    c = _case("gqa")
    h, _ = JLM.forward(c["jf"], c["jt"], c["jc"], jnp.asarray(c["toks"]))
    want = jlinear(c["jf"]["head"], c["jt"]["head"], h, c["jc"].lora.scale)
    got = TLM._head_logits(c["tf"], c["tt"], c["tc"],
                           convert.params_from_jax(
                               np.asarray(jax.device_get(h)), "cpu"))
    _close(got, want, rel=1e-2)


def test_prompt_shorter_than_window_raises_in_both():
    """The reference behaviour: at a sliding-window layer a prompt no
    longer than the window, with max_seq past it, cannot build its ring
    cache. The JAX package fails (a shape error in its cache update);
    the port raises ValueError. With max_seq <= window both run and
    agree."""
    c = _case("window_ring")
    toks = c["toks"][:, :6]
    with pytest.raises(Exception):
        JLM.prefill(c["jf"], c["jt"], c["jc"], jnp.asarray(toks),
                    max_seq=12)
    with pytest.raises(ValueError, match="ring cache holds 8 slots"):
        TLM.prefill(c["tf"], c["tt"], c["tc"], toks, max_seq=12)
    with pytest.raises(ValueError, match="window"):
        tserve.generate(c["tf"], c["tt"], c["tc"], toks, 6, device="cpu")
    lj, _, _ = JLM.prefill(c["jf"], c["jt"], c["jc"], jnp.asarray(toks),
                           max_seq=8)
    lt, _, _ = TLM.prefill(c["tf"], c["tt"], c["tc"], toks, max_seq=8)
    _close(lt, lj)
