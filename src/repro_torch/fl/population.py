"""Lazy client populations: million-client fleets without per-client state
(numpy only; a copy of the JAX package's ``repro/fl/population.py``).

The engines' original client-identity layer was a materialized
``list[dict]`` of per-client datasets — every structure keyed by cid
(data shards, rank schedules, free-client lists) was O(fleet), which is
fine for dozens of simulated clients and impossible for the FedBuff
paper's operating point (buffers of K~10 drawn from MILLIONS of
concurrent devices). This module replaces that layer with a
:class:`Population`: every per-client property is a PURE FUNCTION of
``(seed, cid)``, computed on demand:

  * DEVICE TIERS (:class:`DeviceTier`) — the fleet is a mix of device
    classes (phones/laptops/workstations), each with an adapter rank,
    a population fraction, a mid-round churn probability and a diurnal
    availability profile. ``tier_for(cid)`` hashes the cid onto the
    cumulative fraction split, so tier membership needs no table;
  * LAZY DATA SHARDS — ``population[cid]`` generates client cid's
    synthetic shard from ``data/synthetic.py`` keyed ``(seed, cid)``
    (bit-identical on regeneration), held in a bounded LRU so peak
    resident data is O(cache), never O(fleet). ``peak_resident`` is the
    measured high-water mark the fleet benchmark asserts on;
  * LAZY SAMPLING — ``sample_cid(rng, busy)`` rejection-samples a
    dispatch candidate against the (tiny) busy set instead of
    enumerating the fleet's free clients.

``Population`` quacks like the engines' ``client_data`` list
(``__len__`` / ``__getitem__``), so both engines accept either.
:class:`PopulationTrace` composes a population with
:class:`~repro_torch.fl.traces.FleetTrace`: availability windows and churn
probabilities resolve per TIER, while every draw stays keyed by
``(seed, cid, dispatch_idx)`` — deterministic replay and bit-exact
checkpoint/resume survive the tiering.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from repro_torch.data import synthetic
from repro_torch.fl.client import ClientConfig
from repro_torch.fl.traces import AvailabilityWindows, FleetTrace

# hash constant for tier assignment (Knuth multiplicative; same idiom as
# AvailabilityWindows.phase but a distinct stream: a client's tier and
# its availability phase must not correlate)
_TIER_HASH = 2246822519


@dataclasses.dataclass(frozen=True)
class DeviceTier:
    """One device class in the fleet mix.

    ``fraction`` is the tier's share of the population (fractions must
    sum to 1); ``rank`` its adapter rank tier; ``p_churn`` the
    probability a dispatched client of this tier drops mid-round;
    ``period_s``/``duty`` its diurnal availability profile (phones
    charge at night; 0/1.0 = always available)."""
    name: str
    rank: int
    fraction: float
    p_churn: float = 0.0
    period_s: float = 0.0
    duty: float = 1.0

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError("tier rank must be >= 1")
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError("tier fraction must be in (0, 1]")
        if not 0.0 <= self.p_churn < 1.0:
            raise ValueError("tier p_churn must be in [0, 1)")
        # delegate window validation
        AvailabilityWindows(self.period_s, self.duty)


def default_tiers() -> tuple[DeviceTier, ...]:
    """A production-shaped mix: mostly phones, some laptops, few
    workstations — diurnal phones churn, plugged-in machines don't."""
    return (
        DeviceTier("phone", rank=4, fraction=0.70, p_churn=0.08,
                   period_s=86400.0, duty=0.4),
        DeviceTier("laptop", rank=8, fraction=0.25, p_churn=0.03,
                   period_s=86400.0, duty=0.7),
        DeviceTier("workstation", rank=16, fraction=0.05),
    )


class Population:
    """A lazy fleet of ``n_clients`` simulated devices (see module
    docstring). ``shard_fn(seed, cid) -> dict`` generates one client's
    dataset on demand (default: :func:`repro_torch.data.synthetic
    .client_shard` with ``shard_size`` samples); ``cache_clients``
    bounds how many generated shards stay resident."""

    def __init__(self, n_clients: int,
                 tiers: Optional[tuple[DeviceTier, ...]] = None,
                 seed: int = 0, shard_size: int = 64,
                 shard_fn: Optional[Callable[[int, int], dict]] = None,
                 cache_clients: int = 256):
        if n_clients < 1:
            raise ValueError("n_clients must be >= 1")
        if shard_size < 1:
            raise ValueError("shard_size must be >= 1")
        if cache_clients < 1:
            raise ValueError("cache_clients must be >= 1")
        tiers = default_tiers() if tiers is None else tuple(tiers)
        if not tiers:
            raise ValueError("population needs at least one tier")
        total = sum(t.fraction for t in tiers)
        if abs(total - 1.0) > 1e-6:
            raise ValueError(
                f"tier fractions must sum to 1, got {total}")
        self.n_clients = n_clients
        self.tiers = tiers
        self.seed = seed
        self.shard_size = shard_size
        self._shard_fn = shard_fn if shard_fn is not None else (
            lambda s, cid: synthetic.client_shard(s, cid, n=shard_size))
        self.cache_clients = cache_clients
        self._cache: OrderedDict[int, dict] = OrderedDict()
        self.peak_resident = 0
        # cumulative fraction boundaries for the tier hash
        cum = np.cumsum([t.fraction for t in tiers])
        cum[-1] = 1.0            # absorb fp rounding at the top edge
        self._cum = cum
        self._windows = tuple(AvailabilityWindows(t.period_s, t.duty)
                              for t in tiers)

    # -- tier properties (pure functions of cid) ----------------------------
    def tier_index(self, cid: int) -> int:
        if not 0 <= cid < self.n_clients:
            raise IndexError(f"cid {cid} outside fleet of "
                             f"{self.n_clients}")
        u = (((cid + self.seed + 1) * _TIER_HASH) % (1 << 32)) \
            / float(1 << 32)
        return int(np.searchsorted(self._cum, u, side="right")
                   .clip(0, len(self.tiers) - 1))

    def tier_for(self, cid: int) -> DeviceTier:
        return self.tiers[self.tier_index(cid)]

    def rank_for(self, cid: int) -> int:
        return self.tier_for(cid).rank

    def p_churn_for(self, cid: int) -> float:
        return self.tier_for(cid).p_churn

    def availability_for(self, cid: int) -> AvailabilityWindows:
        return self._windows[self.tier_index(cid)]

    @property
    def max_rank(self) -> int:
        return max(t.rank for t in self.tiers)

    @property
    def mixed_ranks(self) -> bool:
        return len({t.rank for t in self.tiers}) > 1

    @property
    def expected_churn(self) -> float:
        """Fleet-mean dispatch churn probability (fraction-weighted)."""
        return sum(t.fraction * t.p_churn for t in self.tiers)

    def tier_counts(self, sample: int = 10000) -> dict[str, int]:
        """Tier histogram over the first ``sample`` cids (diagnostics —
        the hash split approximates the configured fractions)."""
        n = min(sample, self.n_clients)
        out = {t.name: 0 for t in self.tiers}
        for cid in range(n):
            out[self.tier_for(cid).name] += 1
        return out

    # -- lazy data shards (bounded LRU, O(cache) resident) ------------------
    def __len__(self) -> int:
        return self.n_clients

    def __getitem__(self, cid: int) -> dict:
        if not 0 <= cid < self.n_clients:
            raise IndexError(cid)
        got = self._cache.get(cid)
        if got is not None:
            self._cache.move_to_end(cid)
            return got
        shard = self._shard_fn(self.seed, cid)
        self._cache[cid] = shard
        while len(self._cache) > self.cache_clients:
            self._cache.popitem(last=False)
        self.peak_resident = max(self.peak_resident, len(self._cache))
        return shard

    @property
    def resident_clients(self) -> int:
        return len(self._cache)

    def schedule_steps(self, ccfg: ClientConfig) -> int:
        """Fixed cohort-program schedule length: every shard has
        ``shard_size`` samples, so the fleet-wide natural step count is
        O(1) — no per-client scan (the eager path's ``cohort_steps``
        iterates the whole fleet)."""
        return max(1, self.shard_size // ccfg.batch_size) \
            * ccfg.local_epochs

    # -- lazy dispatch sampling ---------------------------------------------
    def sample_cid(self, rng: np.random.Generator,
                   busy: Optional[set] = None) -> Optional[int]:
        """One dispatch candidate, uniform over non-busy clients.

        Rejection-samples against the busy set — O(1) expected when
        ``len(busy) << n_clients`` (the async engine keeps
        O(concurrency) in flight over a fleet of millions). Falls back
        to an explicit scan only for toy fleets where the busy set is a
        large fraction of the population; returns None when every
        client is busy."""
        if not busy:
            return int(rng.integers(self.n_clients))
        if len(busy) >= self.n_clients:
            return None
        # expected tries = n / (n - busy); 64 tries fails with prob
        # <= (busy/n)^64, vanishing unless the fleet is nearly saturated
        for _ in range(64):
            cid = int(rng.integers(self.n_clients))
            if cid not in busy:
                return cid
        free = [c for c in range(self.n_clients) if c not in busy]
        return int(free[rng.integers(len(free))]) if free else None


@dataclasses.dataclass(frozen=True)
class PopulationTrace(FleetTrace):
    """A :class:`FleetTrace` whose availability windows and churn
    probabilities resolve per DEVICE TIER from a lazy population —
    phones are diurnal and flaky, workstations always-on — while every
    latency/churn draw stays keyed ``(seed, cid, dispatch_idx)``
    (deterministic replay; see traces.py)."""
    population: Optional[Population] = None

    def __post_init__(self):
        super().__post_init__()
        if self.population is None:
            raise ValueError("PopulationTrace requires a population")

    def availability_for(self, cid: int) -> AvailabilityWindows:
        return self.population.availability_for(cid)

    def p_churn_for(self, cid: int) -> float:
        return self.population.p_churn_for(cid)
