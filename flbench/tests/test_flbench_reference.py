"""The plain reference against the port's ``FLServer.run_round`` on the
CPU, at a small size: sound runs pass, and the control and the faults
that a run can have fail."""
from __future__ import annotations

import contextlib

import pytest
import torch

from flbench import bench, calibrate, judge
from flbench.tests.tiny import TINY_LIMITS, tiny_cell

CPU = torch.device("cpu")
WIRES = {"int8": ("flocora", 8), "fp32": ("fedavg", None)}


def readings(cell, seed, program=contextlib.nullcontext):
    with program():
        run = bench.prepare(cell, seed, CPU)
        port, failed = bench.checked_rounds(cell, run)
    run.pop("server")
    ref = bench.reference_rounds(cell, run, seed, CPU)
    return bench.numbers(cell, run, port, ref), failed


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_port_matches_reference(wire, monkeypatch):
    monkeypatch.setattr(bench, "CHECKED_ROUNDS", 2)
    cell = tiny_cell(*WIRES[wire])
    res = bench.run_cell(cell, 2 ** 31 + 11, 0.0, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] == 3 and res["failed"] == 0
    assert res["checks"]["wire"]["value"] == 0.0
    assert set(res["metrics"]) == {"round_s", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_bf16_autocast_fails(wire):
    cell = tiny_cell(*WIRES[wire])
    nums, _ = readings(cell, 5, lambda: torch.autocast(
        "cpu", dtype=torch.bfloat16))
    ok, checks = judge.verdict(nums, TINY_LIMITS)
    assert not ok, checks
    assert nums["update_median"] > 3 * TINY_LIMITS["update_median"]


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_tf32_control_fails(wire):
    """The control: the reference in TF32 put in the program's place."""
    cell = tiny_cell(*WIRES[wire])
    sound, _ = readings(cell, 6)
    ctrl = calibrate.one(cell, 6, "control", CPU)["numbers"]
    assert judge.verdict(sound, TINY_LIMITS)[0]
    assert not judge.verdict(ctrl, TINY_LIMITS)[0], ctrl
    assert ctrl["update_median"] > 3 * sound["update_median"], (ctrl, sound)


@contextlib.contextmanager
def state_unchanged():
    from repro_torch.fl import FLServer
    orig = FLServer.run_round

    def run_round(self):
        before = self.global_train
        rec = orig(self)
        self.global_train = before
        return rec

    FLServer.run_round = run_round
    try:
        yield
    finally:
        FLServer.run_round = orig


FAULTS = {"state_unchanged": state_unchanged,
          "half_batch": calibrate.half_batch,
          "uplink_altered": calibrate.altered_uplink,
          "frozen_norms": calibrate.frozen_norms,
          "one_client_unchanged": calibrate.one_client}


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_run_is_not_correct(fault, wire):
    """A whole run (the look for a card skipped) with the timed path
    broken underneath reports ``correct`` false."""
    cell = tiny_cell(*WIRES[wire])
    with FAULTS[fault]():
        res = bench.run_cell(cell, 9, 0.0, False, "cpu")
    assert not res["correct"], res["checks"]



# the numbers each training fault has to read at ten times its limit
READ_BY = {"frozen_norms": ("step1_worst", "step3_worst", "update_median"),
           "one_client_unchanged": ("step1_worst", "step3_worst")}


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("fault", sorted(READ_BY))
def test_training_faults_read_in_their_numbers(fault, wire):
    """Every GroupNorm scale and shift left as broadcast, or one client of
    the cohort left untrained: the worst leaf after one and three steps
    reads it, whatever the other clients say, and frozen norms the whole
    run's median leaf too."""
    nums, _ = readings(tiny_cell(*WIRES[wire]), 3, FAULTS[fault])
    for name in READ_BY[fault]:
        assert nums[name] > 10 * TINY_LIMITS[name], (name, nums)
