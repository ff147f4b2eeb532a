"""Fixtures of the benchmark's CPU tests."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)

