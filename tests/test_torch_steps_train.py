"""The port's train step (``repro_torch.launch.steps``) against the JAX
package's, jitted on a one-device mesh: tests/test_torch_steps.py's
setting and tolerances (its docstring), for minitron-4b, mamba2-370m and
deepseek-v2-236b at two microbatches of 4 x 65 tokens (the fp32 gradient
sum over the microbatches, then one AdamW step) and seamless-m4t-medium
at one of 8 x 65."""
import pytest

from test_torch_steps import _check_train, _run


@pytest.mark.parametrize("arch", ["minitron-4b", "mamba2-370m",
                                  "deepseek-v2-236b"])
def test_train_step_microbatch_2_matches_jax(arch):
    """Two microbatches of 4 x 65 tokens, the fp32 gradient sum, one
    AdamW step (deepseek-v2 on the JAX step's routes)."""
    _check_train(*_run(arch, "train_4k", microbatch=2))


def test_seamless_train_step_matches_jax():
    _check_train(*_run("seamless-m4t-medium", "train_4k"))
