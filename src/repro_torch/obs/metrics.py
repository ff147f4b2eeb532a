"""Metrics registry: labeled counters, gauges and histograms.

One place to record what the system actually did — bytes on the wire,
staleness at arrival, cache churn, compile counts — instead of ad-hoc
dicts and plain-int attributes scattered across the engines.

Design constraints, in order:

  * NEAR-ZERO OVERHEAD WHEN DISABLED. The default process-global
    registry starts disabled; every record call checks one bool and
    returns. Hot paths (the serve decode step, the async event loop)
    instrument unconditionally and rely on this.
  * LABELED. A counter is a family keyed by label values —
    ``reg.inc("wire.up_bytes", n, rank=8, density=0.1)`` — so the
    bits x density x rank x staleness knob grid lands in one metric,
    not a name explosion.
  * INJECTABLE. Engines take ``registry=None`` meaning the process
    default (:func:`default_registry`), or an explicit
    :class:`MetricsRegistry` instance for isolated measurement (tests
    construct their own and never see each other's counts).

``dump()`` renders everything as one plain-JSON dict (label sets
serialize as ``"k=v,k=v"`` strings), the "metrics dump" the README's
observability section documents.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import threading
from typing import Any, Optional

# default histogram bucket upper bounds: pow2-ish ladder wide enough
# for staleness (versions), queue depths and microsecond latencies
DEFAULT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                   256.0, 1024.0, 4096.0, 16384.0, 65536.0)


def _label_key(labels: dict) -> str:
    """Canonical string form of a label set (sorted, JSON-friendly)."""
    if not labels:
        return ""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


@dataclasses.dataclass
class Counter:
    """Monotonic sum per label set."""
    name: str
    values: dict = dataclasses.field(default_factory=dict)

    def inc(self, value: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + value

    @property
    def total(self) -> float:
        return sum(self.values.values())

    def get(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)


@dataclasses.dataclass
class Gauge:
    """Last-write-wins value per label set."""
    name: str
    values: dict = dataclasses.field(default_factory=dict)

    def set(self, value: float, **labels) -> None:
        self.values[_label_key(labels)] = value

    def get(self, **labels) -> Optional[float]:
        return self.values.get(_label_key(labels))


@dataclasses.dataclass
class _HistState:
    count: int = 0
    sum: float = 0.0
    min: float = math.inf
    max: float = -math.inf
    bucket_counts: Optional[list] = None


@dataclasses.dataclass
class Histogram:
    """Count/sum/min/max plus cumulative-bucket counts per label set.

    ``buckets`` are upper bounds (``le``); observations above the last
    bound land in the implicit +inf bucket."""
    name: str
    buckets: tuple = DEFAULT_BUCKETS
    values: dict = dataclasses.field(default_factory=dict)

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        st = self.values.get(k)
        if st is None:
            st = _HistState(bucket_counts=[0] * (len(self.buckets) + 1))
            self.values[k] = st
        st.count += 1
        st.sum += value
        st.min = min(st.min, value)
        st.max = max(st.max, value)
        st.bucket_counts[bisect.bisect_left(self.buckets, value)] += 1

    def get(self, **labels) -> Optional[_HistState]:
        return self.values.get(_label_key(labels))

    def mean(self, **labels) -> float:
        st = self.get(**labels)
        if st is None or st.count == 0:
            return float("nan")
        return st.sum / st.count


class MetricsRegistry:
    """Get-or-create store of named metrics. All record paths are
    guarded by ``enabled`` — a disabled registry does one attribute
    check per call and touches nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    # -- get-or-create -----------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, buckets))
        return h

    # -- record (no-ops when disabled) -------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        if not self.enabled:
            return
        self.counter(name).inc(value, **labels)

    def set(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        self.gauge(name).set(value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        self.histogram(name).observe(value, **labels)

    # -- read --------------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        c = self._counters.get(name)
        if c is None:
            return 0.0
        return c.total if not labels else c.get(**labels)

    def dump(self) -> dict:
        """Everything as one plain-JSON dict."""
        out: dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for name, c in sorted(self._counters.items()):
            out["counters"][name] = dict(sorted(c.values.items()))
        for name, g in sorted(self._gauges.items()):
            out["gauges"][name] = dict(sorted(g.values.items()))
        for name, h in sorted(self._histograms.items()):
            out["histograms"][name] = {
                k: {"count": st.count, "sum": st.sum,
                    "min": st.min if st.count else None,
                    "max": st.max if st.count else None,
                    "buckets": list(h.buckets),
                    "bucket_counts": list(st.bucket_counts)}
                for k, st in sorted(h.values.items())}
        return out

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=1, default=str)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# -- process-global default (disabled until someone opts in) ---------------
_DEFAULT = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (returns the previous one, so callers
    can restore it — tests use try/finally around this)."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, reg
    return prev


def get_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Injection helper: an explicit instance wins, None means the
    process default."""
    return _DEFAULT if reg is None else reg
