"""Unified telemetry layer: metrics, tracing, compile watchdog.

  * :mod:`repro_torch.obs.metrics` — labeled counters/gauges/histograms
    in a registry (process-global default, disabled until opted in, or
    an injected instance);
  * :mod:`repro_torch.obs.trace` — span tracer on wall OR virtual
    clocks, Chrome-trace JSON + JSONL export;
  * :mod:`repro_torch.obs.compile` — the ONE count of device programs
    built (kernel builds and loads, dynamo graphs, CUDA-graph
    captures): measurement context, enforcing watchdog, pytest fixture;
  * :mod:`repro_torch.obs.meta` — run fingerprints (backend, device,
    torch and CUDA versions), so runs on different backends are never
    compared.

Quick start (everything off by default, near-zero overhead until
enabled)::

    from repro_torch import obs
    reg, tracer = obs.enable()
    ... run a serve simulation ...
    reg.dump()
    tracer.export_chrome("trace.json")
"""
from repro_torch.obs.compile import (CompileBudgetExceeded, CompileWatchdog,
                                     compile_count, count_compiles)
from repro_torch.obs.meta import run_meta
from repro_torch.obs.metrics import (MetricsRegistry, default_registry,
                                     get_registry, set_default_registry)
from repro_torch.obs.trace import (Tracer, default_tracer, get_tracer,
                                   set_default_tracer)


def enable() -> tuple[MetricsRegistry, Tracer]:
    """Switch the process-global registry AND tracer on; returns both."""
    reg, tracer = default_registry(), default_tracer()
    reg.enabled = True
    tracer.enabled = True
    return reg, tracer


def disable() -> None:
    default_registry().enabled = False
    default_tracer().enabled = False


__all__ = [
    "CompileBudgetExceeded", "CompileWatchdog", "MetricsRegistry",
    "Tracer", "compile_count", "count_compiles", "default_registry",
    "default_tracer", "disable", "enable", "get_registry", "get_tracer",
    "run_meta", "set_default_registry", "set_default_tracer",
]
