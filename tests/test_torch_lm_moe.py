"""The MLA and MoE archs, deepseek-v2-236b (MLA, 8 experts top-2 + 2
shared) and llama4-maverick-400b-a17b (GQA, a MoE layer every other
layer, top-1 + 1 shared), at their smoke configs against the JAX
package: tests/test_torch_lm.py's six whole-model checks (whose module
docstring states the tolerances and the teacher-forced routes)."""
import pytest
import torch

import test_torch_lm as base

torch.set_num_threads(2)


@pytest.mark.parametrize("name", base.MLA_MOE)
@pytest.mark.parametrize("check", [
    base.check_forward_matches_jax,
    base.check_loss_and_adapter_grads_match_jax,
    base.check_prefill_and_decode_match_jax,
    base.check_generate_greedy_matches_jax,
    base.check_decode_matches_teacher_forced_forward,
    base.check_init_tree_structure_matches_jax],
    ids=lambda f: f.__name__[len("check_"):])
def test_mla_moe_arch_matches_jax(check, name):
    """On teacher-forced routes; decode against the forward at the
    no-drop capacity."""
    check(name)
