"""Bench run metadata: who/what produced a measurement.

A measurement carries a ``meta`` block from :func:`run_meta`, so a
comparison can refuse to diff a CPU run against a card's (or torch
versions apart) instead of reporting phantom regressions. The run id is
random and HOSTNAME-FREE: the JSON is committed or uploaded, and machine
names don't belong in the repo.
"""
from __future__ import annotations

import platform
import secrets

import torch


def run_meta() -> dict:
    """Environment fingerprint of one benchmark run."""
    cuda = torch.cuda.is_available()
    return {
        "backend": "cuda" if cuda else "cpu",
        "device_kind": (torch.cuda.get_device_name(0) if cuda
                        else platform.machine() or "cpu"),
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": platform.python_version(),
        # random, not host-derived: uploaded artifacts stay anonymous
        "run_id": secrets.token_hex(8),
    }


# meta keys that must MATCH for two runs to be comparable; the rest
# (n_devices, cuda and python patch levels, run_id) only annotate
COMPARABLE_KEYS = ("backend", "device_kind", "torch_version")


def comparable(a: dict, b: dict) -> tuple[bool, list[str]]:
    """Can run ``a`` be diffed against run ``b``? Returns (ok,
    mismatched keys); missing meta on either side compares as unknown
    (ok=True, caller warns)."""
    if not a or not b:
        return True, []
    bad = [k for k in COMPARABLE_KEYS
           if k in a and k in b and a[k] != b[k]]
    return not bad, bad
