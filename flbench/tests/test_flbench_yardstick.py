"""The yardstick's arithmetic: the data split, the FLOPs of a training
step, the flat wire's pack and reduce bytes, and the sampler replay."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from flbench import cells, data, yardstick
from flbench.reference import fl as ref_fl

BENCH = cells.benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _cell(name):
    w = CELLS[name]
    return (json.loads((cells.HERE / "configs" / f"{w['config']}.json")
                       .read_text()),
            json.loads((cells.HERE / "workloads" / f"{w['traffic']}.json")
                       .read_text()))


@pytest.mark.parametrize("name,steps", [("resnet8-flocora-k10", 33),
                                        ("resnet18-flocora-k10", 32),
                                        ("resnet8-fedavg-k10", 33)])
def test_partition_fixes_the_schedule(name, steps):
    cfg, traffic = _cell(name)
    sizes = [len(p) for p in data.split(traffic, cfg)[1]]
    assert len(sizes) == 100 and sum(sizes) == 50_000
    assert ref_fl.schedule_steps(sizes, cfg["batch_size"],
                                 cfg["local_epochs"]) == steps


def test_lda_copy_equals_the_port():
    from repro_torch.data import lda_partition
    y = data.labels(5000, 10, 3)
    for got, want in zip(data.lda_partition(y, 20, 0.5, seed=3),
                         lda_partition(y, 20, 0.5, seed=3)):
        np.testing.assert_array_equal(got, want)


def test_images_follow_the_seed():
    temps = data.templates(10, 8, 3)
    y = data.labels(64, 10, 0)
    a = data.images(y, temps, 2 ** 31 + 5, "cpu")
    b = data.images(y, temps, 2 ** 31 + 5, "cpu")
    c = data.images(y, temps, 7, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a sample is its class template rolled, maybe flipped, plus noise
    resid = (a - torch.from_numpy(temps)[y]).std()
    assert 0.3 < float(resid) < 1.5


@pytest.mark.parametrize("config,mode,gflop", [("resnet8", "flocora", 1.19),
                                               ("resnet18", "flocora", 4.04),
                                               ("resnet8", "fedavg", 1.16)])
def test_flops_per_image(config, mode, gflop):
    cfg = json.loads((cells.HERE / "configs" / f"{config}.json").read_text())
    got = yardstick.flops_per_image(cfg, mode)
    assert round(got / 1e9, 2) == gflop


@pytest.mark.parametrize("config,k,b1,b2", [
    ("resnet8", 5, 5_157_496, 17_828_300),
    ("resnet18", 4, 37_009_784, 120_458_104)])
def test_pack_and_reduce_bytes(config, k, b1, b2):
    cfg = json.loads((cells.HERE / "configs" / f"{config}.json").read_text())
    lo = yardstick.layout(cfg, "flocora", 8)
    assert yardstick.b1_bytes(lo) == b1
    assert yardstick.b2_bytes(lo, k) == b2


def test_base_parameters():
    cfg = json.loads((cells.HERE / "configs" / "resnet8.json").read_text())
    from flbench.reference import model as ref_model
    n = sum(int(np.prod(s[2])) for s in ref_model.param_specs(cfg, "fedavg"))
    assert n == cfg["base_params"]


def test_sampler_replays_the_server_stream():
    from repro_torch.fl.client import ClientConfig, stack_cohort_batches
    sizes = [40, 70, 33, 100, 64]
    datas = [{"y": np.arange(n)} for n in sizes]
    ccfg = ClientConfig(local_epochs=1, batch_size=16)
    rng = np.random.default_rng(99)
    s = ref_fl.Sampler(99, sizes, 5, 3, 16, 1)
    for _ in range(3):
        want = s.next_round()
        cohort = rng.choice(5, size=3, replace=False)
        [rng.exponential(1.0) for _ in cohort]
        batches, n_steps = stack_cohort_batches(
            rng, [datas[c] for c in cohort], ccfg,
            steps=ref_fl.schedule_steps(sizes, 16, 1))
        assert list(cohort) == want["cohort"]
        assert list(n_steps) == want["n_steps"]
        for i, idx in enumerate(want["idx"]):
            np.testing.assert_array_equal(batches["y"][i], idx)


class _Ev:
    """A stand-in for a profiler event."""

    def __init__(self, name, start, end, corr=0, device=False, ann=False):
        self._n, self._s, self._e, self._c = name, start, end, corr
        self._d, self._a = device, ann

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a


def test_trace_reduction():
    from flbench import trace
    evs = [
        _Ev("fl/pack", 0, 100, ann=True),
        _Ev("fl/aggregate", 200, 300, ann=True),
        _Ev("fl/pack", 0, 100, ann=True, device=True),  # its device mirror
        _Ev("cudaLaunchKernel", 10, 12, corr=1),
        _Ev("cudaLaunchKernel", 20, 22, corr=2),
        _Ev("cudaMemsetAsync", 150, 151, corr=3),
        _Ev("cudaLaunchKernel", 210, 212, corr=4),
        _Ev("k1", 1000, 1100, corr=1, device=True),
        _Ev("k2", 1050, 1200, corr=2, device=True),   # overlaps k1
        _Ev("memset", 1300, 1310, corr=3, device=True),
        _Ev("k3", 1400, 1500, corr=4, device=True),
    ]
    got = trace.reduce(evs)
    assert got["ops"] == 4
    assert got["busy_s"] == pytest.approx((200 + 10 + 100) / 1e9)
    assert got["by_span"]["fl/pack"] == {"launches": 2,
                                         "device_s": pytest.approx(250e-9)}
    assert got["by_span"]["fl/aggregate"]["launches"] == 1
    assert got["by_span"][trace.OUTSIDE]["device_s"] == pytest.approx(10e-9)
    assert got["idle_by_span"] == {trace.OUTSIDE: pytest.approx(100e-9),
                                   "fl/aggregate": pytest.approx(90e-9)}
    assert got["by_name"]["k2"] == pytest.approx(150e-9)
