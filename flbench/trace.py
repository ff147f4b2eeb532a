"""The traced run: the program's spans and two ``torch.profiler`` slices.

``AnnotatingTracer`` is the program's own span tracer (``obs/trace.py``)
that also opens a profiler range of the same name around each span, so
a device operation can be put in the span in which the host launched
it. ``profile_rounds`` runs whole rounds under the profiler and reduces
its events (``reduce``):

* every device operation (kernel, copy, set) is matched to the runtime
  call that launched it by its correlation id;
* ``busy_s`` is the union of the device operations' intervals, so
  operations that overlap on several streams count once;
* by span: the launches and the summed device time of the operations
  launched inside it;
* idle gaps: each gap in the union, charged to the span in which the
  host launched the operation that ended it.

One slice profiles the device alone (the least overhead: busy share and
model FLOP utilization); the other adds the host's operators and the
span ranges (what each span launched).
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.obs.trace import Tracer

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
OUTSIDE = "outside spans"


class AnnotatingTracer(Tracer):
    """A span tracer whose spans are also profiler ranges."""

    @contextlib.contextmanager
    def span(self, name: str, track: str = "main", **args):
        if not self.enabled:
            yield
            return
        with record_function(name), super().span(name, track, **args):
            yield


def span_totals(tracer: Tracer) -> dict:
    """{span name: [seconds, ...]} of the tracer's complete events."""
    out = defaultdict(list)
    for e in tracer.events:
        if e.get("ph") == "X":
            out[e["name"]].append(e["dur"] / 1e6)
    return dict(out)


def profile_rounds(server, rounds: int, host: bool) -> dict:
    """``rounds`` whole rounds of ``server`` under the profiler, reduced.
    ``host`` adds the host's operators and the span ranges."""
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            server.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = reduce(prof.profiler.kineto_results.events())
    out.update(wall_s=wall, rounds=rounds)
    return out


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def reduce(events) -> dict:
    runtime, spans, launches, ops = {}, [], [], []
    for e in events:
        if _is_device(e):
            continue
        name = e.name()
        if name.startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
            if name in LAUNCHES:
                launches.append(e.start_ns())
        elif name.startswith("fl/") and e.is_user_annotation():
            spans.append((e.start_ns(), e.end_ns(), name))
    for e in events:
        if _is_device(e) and not e.is_user_annotation() \
                and e.correlation_id() in runtime:
            ops.append((e.start_ns(), e.end_ns(), e.name(),
                        runtime[e.correlation_id()]))
    spans.sort()
    starts = [s[0] for s in spans]

    def span_of(t_ns: int) -> str:
        i = bisect.bisect_right(starts, t_ns) - 1
        if i >= 0 and spans[i][1] >= t_ns:
            return spans[i][2]
        return OUTSIDE

    by_name = defaultdict(float)
    by_span = defaultdict(lambda: {"launches": 0, "device_s": 0.0})
    for t in launches:
        by_span[span_of(t)]["launches"] += 1
    for s, e, name, t_launch in ops:
        by_name[name] += (e - s) / 1e9
        by_span[span_of(t_launch)]["device_s"] += (e - s) / 1e9
    ops.sort()
    busy, idle = 0, defaultdict(float)
    end = None
    for s, e, _, t_launch in ops:
        if end is None or s > end:
            if end is not None:
                idle[span_of(t_launch)] += (s - end) / 1e9
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return {"busy_s": busy / 1e9, "ops": len(ops), "by_name": dict(by_name),
            "by_span": {k: dict(v) for k, v in by_span.items()},
            "idle_by_span": dict(idle), "spans": len(spans)}
