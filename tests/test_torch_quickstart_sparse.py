"""Round 1 of ``launch.quickstart``'s ``run_sparse(1, 0.1)`` against the
JAX package's ``FLServer``: the ``sparse`` case of
``test_torch_quickstart_rounds.hold_round1`` (one mode a file)."""
import pytest

from test_torch_quickstart_rounds import hold_round1


@pytest.mark.parametrize("mode", ["sparse"])
def test_round1_matches_jax_server(mode, capsys, monkeypatch):
    hold_round1(mode, capsys, monkeypatch)
