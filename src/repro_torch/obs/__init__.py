"""Telemetry: metrics and tracing (plain Python, copied from the JAX
package).

  * :mod:`repro_torch.obs.metrics` — labeled counters/gauges/histograms
    in a registry (process-global default, disabled until opted in, or
    an injected instance);
  * :mod:`repro_torch.obs.trace` — span tracer on wall OR virtual
    clocks, Chrome-trace JSON + JSONL export.

The JAX package's backend-compile watchdog (``obs/compile.py``) and run
fingerprints (``obs/meta.py``) are not ported.

Quick start (everything off by default, near-zero overhead until
enabled)::

    from repro_torch import obs
    reg, tracer = obs.enable()
    ... run a serve simulation ...
    reg.dump()
    tracer.export_chrome("trace.json")
"""
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
    "MetricsRegistry", "Tracer", "default_registry", "default_tracer",
    "disable", "enable", "get_registry", "get_tracer",
    "set_default_registry", "set_default_tracer",
]
