"""Compile watchdog: ONE count of the device programs the process built.

In the port a "compile" is a device program built for a new shape or a
new process. Three sources feed one monotonic count:

  * each ``nvcc`` build and each ``ctypes`` load of a kernel library
    (``kernels/build.py`` calls :func:`record_build`);
  * each new dynamo graph of ``torch.compile``: the growth of
    ``torch._dynamo.utils.counters["stats"]["unique_graphs"]``, read
    when the count is read, and only once dynamo has been imported (a
    process that never called ``torch.compile`` has built no graph);
  * each CUDA-graph capture (:func:`record_build` with
    ``kind="cuda_graph"``; no path captures one yet).

The count is exposed three ways, as in the JAX package:

  * :func:`compile_count`: the monotonic process total;
  * :class:`count_compiles`: ``with count_compiles() as c: ...;
    c.count`` measurement context;
  * :class:`CompileWatchdog`: an ENFORCING context, raising
    :class:`CompileBudgetExceeded` when the block built more than
    ``max_compiles`` programs. The serving engine
    (``AdapterServingEngine(strict_compiles=True)``) and the streaming
    accumulator (``StreamingFlatAccumulator(strict_compiles=True)``, and
    ``FedBuffAggregator`` and ``AsyncConfig`` through it) wrap their
    steady-state paths in a zero-budget watchdog.

Every build also feeds the default metrics registry when it is enabled
(``torch.program_builds`` counter labelled by kind,
``torch.program_build_secs`` sum), so build counts show up in the same
metrics dump as bytes and staleness.

The pytest fixture ``count_compiles_fixture`` hands tests the
context-manager class under the name ``count_compiles``.
"""
from __future__ import annotations

import sys

from repro_torch.obs import metrics as _metrics

_COMPILES = [0]
_DYNAMO_SEEN = [0]     # unique_graphs already folded into _COMPILES


def record_build(kind: str, seconds: float = 0.0) -> None:
    """Count one device program built (``kind``: ``"nvcc"``,
    ``"load"``, ``"dynamo"`` or ``"cuda_graph"``)."""
    _COMPILES[0] += 1
    reg = _metrics.default_registry()
    if reg.enabled:
        reg.inc("torch.program_builds", kind=kind)
        reg.inc("torch.program_build_secs", float(seconds))


def _sync_dynamo() -> None:
    """Fold the dynamo graphs built since the last read into the count."""
    utils = sys.modules.get("torch._dynamo.utils")
    if utils is None:
        return
    graphs = int(utils.counters["stats"]["unique_graphs"])
    for _ in range(graphs - _DYNAMO_SEEN[0]):
        record_build("dynamo")
    _DYNAMO_SEEN[0] = max(_DYNAMO_SEEN[0], graphs)


def compile_count() -> int:
    """Monotonic count of device programs built since process start."""
    _sync_dynamo()
    return _COMPILES[0]


class count_compiles:
    """``with count_compiles() as c: ...; c.count``: programs built
    inside the block (kernel builds and loads, dynamo graphs, CUDA-graph
    captures)."""

    def __enter__(self) -> "count_compiles":
        self.start = compile_count()
        return self

    def __exit__(self, *exc) -> None:
        self.count = compile_count() - self.start

    @property
    def so_far(self) -> int:
        return compile_count() - self.start


class CompileBudgetExceeded(RuntimeError):
    """A watchdog-guarded block built more programs than allowed."""


class CompileWatchdog(count_compiles):
    """Enforcing variant of :class:`count_compiles`: on exit (without a
    pending exception) raises :class:`CompileBudgetExceeded` when the
    block built more than ``max_compiles`` programs.

    >>> with CompileWatchdog(0, label="steady-state decode"):
    ...     engine.step(x, cids)     # must reuse built programs
    """

    def __init__(self, max_compiles: int = 0, label: str = ""):
        self.max_compiles = int(max_compiles)
        self.label = label

    def __exit__(self, exc_type, *exc) -> None:
        self.count = compile_count() - self.start
        if exc_type is None and self.count > self.max_compiles:
            what = f" [{self.label}]" if self.label else ""
            raise CompileBudgetExceeded(
                f"compile watchdog{what}: {self.count} program "
                f"build(s) in a block budgeted for {self.max_compiles}")


try:        # pragma: no cover - exercised through the test suite
    import pytest

    @pytest.fixture(name="count_compiles")
    def count_compiles_fixture():
        """The measurement context as a fixture: tests take
        ``count_compiles`` as an argument and use it exactly like the
        class (``with count_compiles() as c: ...``)."""
        return count_compiles
except ImportError:                       # runs without pytest
    pass
