"""``launch.fl_experiment`` against the JAX harness: the
``flocora_int8`` case of ``test_torch_fl_experiment.CASES``
(one case a file)."""
import pytest

from test_torch_fl_experiment import hold_case


@pytest.mark.parametrize("case", ["flocora_int8"])
def test_fl_experiment_matches_jax_harness(case, monkeypatch):
    hold_case(case, monkeypatch)
