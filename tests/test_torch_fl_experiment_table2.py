"""``launch.fl_experiment`` against the JAX harness: the
``table2_lora_stem_fc`` case of ``test_torch_fl_experiment.CASES``
(one case a file)."""
import pytest

from test_torch_fl_experiment import hold_case


@pytest.mark.parametrize("case", ["table2_lora_stem_fc"])
def test_fl_experiment_matches_jax_harness(case, monkeypatch):
    hold_case(case, monkeypatch)
