"""Client timing models (numpy only; copied from the JAX package).

Only :class:`LognormalLatency` is ported: the serving simulator draws
each cache miss's fetch delay from it. ``AvailabilityWindows``,
``FleetTrace`` and the population traces are not ported.

Per-arrival latency = lognormal compute time (optionally scaled by the
client's adapter-rank tier) + wire-transfer time at a lognormal-jittered
throughput, so bigger messages take longer. All times are VIRTUAL
seconds on the simulator clock; every draw comes from the
``np.random.Generator`` the caller passes, keyed by the caller.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# __post_init__ rejects throughput configs whose jittered draw could
# plausibly underflow the 1 byte/s floor in ``sample``: lognormal(0, s)
# stays above exp(-_JITTER_LOG_RANGE * s) except with probability
# ~1e-9 (the 6-sigma left tail), so any config passing the check never
# actually hits the floor in a simulated fleet's lifetime.
_JITTER_LOG_RANGE = 6.0


@dataclasses.dataclass(frozen=True)
class LognormalLatency:
    """Per-arrival latency = compute + transfer.

    Transfer-time model: the configured link rate ``network_mbps``
    (megaBITS per second) converts to bytes/s, one lognormal draw
    jitters the WHOLE transfer (per-arrival congestion, not per-packet),
    and the message pays ``wire_bytes / (bytes_per_s * jitter)``
    seconds:

        compute  ~ compute_median_s * lognormal(0, compute_sigma)
                   * (rank / rank_ref) ** rank_exp
        bytes_per_s = network_mbps * 1e6 / 8 * lognormal(0, network_sigma)
        transfer = wire_bytes / bytes_per_s

    ``rank_exp > 0`` makes higher-rank tiers slower (more adapter math
    per step); 0 decouples compute time from the tier.

    ``__post_init__`` rejects configs whose jittered throughput could
    plausibly underflow 1 byte/s (the numeric floor in :meth:`sample`):
    the floor exists only as a division guard, and silently flooring a
    *configured* sub-byte/s link would make transfers FASTER than
    configured — fail loudly at construction instead.
    """
    compute_median_s: float = 30.0
    compute_sigma: float = 0.6
    network_mbps: float = 20.0
    network_sigma: float = 0.4
    rank_ref: int = 8
    rank_exp: float = 1.0

    def __post_init__(self):
        if self.compute_median_s <= 0 or self.network_mbps <= 0:
            raise ValueError("latency medians must be positive")
        if self.compute_sigma < 0 or self.network_sigma < 0:
            raise ValueError("sigmas must be >= 0")
        if self.rank_ref < 1:
            raise ValueError("rank_ref must be >= 1")
        worst_bps = self.network_mbps * 1e6 / 8.0 \
            * math.exp(-_JITTER_LOG_RANGE * self.network_sigma)
        if worst_bps < 1.0:
            raise ValueError(
                f"network_mbps={self.network_mbps} with network_sigma="
                f"{self.network_sigma} can jitter below 1 byte/s "
                f"(6-sigma draw: {worst_bps:.3g} B/s) — the sample-time "
                "floor would silently speed such transfers up; raise "
                "network_mbps or lower network_sigma")

    def sample(self, rng: np.random.Generator, rank: int,
               wire_bytes: int) -> float:
        comp = (self.compute_median_s
                * rng.lognormal(0.0, self.compute_sigma)
                * (max(rank, 1) / self.rank_ref) ** self.rank_exp)
        # max() is a pure division guard: __post_init__ rejects any
        # config that could plausibly reach it (see class docstring)
        bps = self.network_mbps * 1e6 / 8.0 \
            * rng.lognormal(0.0, self.network_sigma)
        return comp + wire_bytes / max(bps, 1.0)
