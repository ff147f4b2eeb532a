"""Client latency, availability and churn traces for the federation
engines (numpy only; a copy of the JAX package's ``repro/fl/traces.py``).

A production fleet is not round-lockstep: a client's update arrives
whenever its compute + network latency and its availability windows
allow, if it arrives at all (devices churn mid-round). These are the
timing models the async engine (``fl/async_engine.py``) schedules its
dispatch and arrival events with, and that ``fl/server.py`` orders
deadline cohorts by:

  * :class:`LognormalLatency` — lognormal compute time scaled by the
    client's adapter-rank tier plus wire-transfer time at a
    lognormal-jittered throughput, so bigger messages take longer (the
    serving simulator also draws each cache miss's fetch delay from it);
  * :class:`AvailabilityWindows` — periodic per-client availability: a
    dispatch outside the client's window waits for the next one;
  * :class:`FleetTrace` — composes the two, adds mid-round CHURN
    (``p_churn``: a dispatched client drops before its uplink lands) and
    owns DETERMINISTIC REPLAY: every latency and churn draw is keyed by
    ``(seed, tag, cid, dispatch_idx)`` through a fresh
    ``np.random.Generator``, so the trace is a pure function of those ids
    and equals the JAX package's draw for draw.

The per-client hooks (``availability_for`` / ``p_churn_for``) let
``fl/population.PopulationTrace`` resolve windows and churn per DEVICE
TIER without per-client state. All times are VIRTUAL seconds on the
simulator clock.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# rng key domains for trace draws (the engines use their own domains for
# client sampling, batch shuffling and failure draws; disjoint first
# keys keep every stream independent under the shared seed)
TAG_LATENCY = 0xA1
TAG_CHURN = 0xA2

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


@dataclasses.dataclass(frozen=True)
class AvailabilityWindows:
    """Periodic per-client availability: client ``cid`` is available for
    the first ``duty`` fraction of every ``period_s`` window, with a
    deterministic per-client phase (a Knuth-hash spread, so the fleet's
    windows are staggered instead of synchronized). ``period_s = 0`` or
    ``duty >= 1`` means always available."""
    period_s: float = 0.0
    duty: float = 1.0

    def __post_init__(self):
        if self.period_s < 0:
            raise ValueError("period_s must be >= 0")
        if not 0.0 < self.duty <= 1.0:
            raise ValueError("duty must be in (0, 1]")

    def phase(self, cid: int) -> float:
        if self.period_s <= 0:
            return 0.0
        return ((cid * 2654435761) % (1 << 32)) / float(1 << 32) \
            * self.period_s

    def next_available(self, cid: int, t: float) -> float:
        """Earliest time >= t at which client cid is available."""
        if self.period_s <= 0 or self.duty >= 1.0:
            return t
        pos = (t - self.phase(cid)) % self.period_s
        if pos < self.duty * self.period_s:
            return t
        return t + (self.period_s - pos)


@dataclasses.dataclass(frozen=True)
class FleetTrace:
    """Deterministic-replay fleet timing model.

    ``arrival(cid, dispatch_idx, rank, wire_bytes, t_dispatch)`` returns
    the virtual time at which that dispatch's update reaches the server:
    availability wait, then the sampled compute+transfer latency.
    ``churned(cid, dispatch_idx)`` decides whether that dispatch DROPS
    mid-round (the downlink was spent, the uplink never lands). Both
    draws are pure functions of ``(seed, cid, dispatch_idx)`` — see the
    module docstring for why that makes runs replayable.

    Subclasses (e.g. ``PopulationTrace``) override the per-client hooks
    ``availability_for`` / ``p_churn_for`` to model heterogeneous
    device tiers without per-client state."""
    seed: int = 0
    latency: LognormalLatency = dataclasses.field(
        default_factory=LognormalLatency)
    availability: AvailabilityWindows = dataclasses.field(
        default_factory=AvailabilityWindows)
    p_churn: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.p_churn < 1.0:
            raise ValueError("p_churn must be in [0, 1)")

    # -- per-client hooks (uniform here; tiered in PopulationTrace) ---------
    def availability_for(self, cid: int) -> AvailabilityWindows:
        return self.availability

    def p_churn_for(self, cid: int) -> float:
        return self.p_churn

    def arrival(self, cid: int, dispatch_idx: int, rank: int,
                wire_bytes: int, t_dispatch: float) -> float:
        rng = np.random.default_rng(
            [self.seed, TAG_LATENCY, cid, dispatch_idx])
        t0 = self.availability_for(cid).next_available(cid, t_dispatch)
        return t0 + self.latency.sample(rng, rank, wire_bytes)

    def churned(self, cid: int, dispatch_idx: int) -> bool:
        """True when this dispatch drops mid-round. Keyed like the
        latency draw, so replay/resume reproduces every churn outcome."""
        p = self.p_churn_for(cid)
        if p <= 0.0:
            return False
        rng = np.random.default_rng(
            [self.seed, TAG_CHURN, cid, dispatch_idx])
        return bool(rng.random() < p)
