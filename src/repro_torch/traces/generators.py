"""Seeded synthetic trace generators (§4.2's experimental regime).

Every generator is deterministic under a fixed ``seed`` and returns plain
numpy arrays / timelines; the top-level factories assemble them into
:class:`~repro_torch.traces.profile.TraceProfile` bundles:

* :func:`homogeneous_profile` — the paper-naive control: identical speeds,
  symmetric scalar bandwidth, everyone always online.
* :func:`diurnal_profile`    — the realistic regime: heavy-tailed
  (lognormal) device speeds, asymmetric last-mile bandwidth, WAN latency,
  and sine-windowed diurnal availability with per-node phase (each device
  is online during its local "daytime", as in real FL device traces).
* :func:`flash_crowd_profile` — a small always-on core plus a crowd that
  arrives in one staggered wave (workload spike scenario).
* :func:`starved_cohort_profile` — a bandwidth-starved cohort on an
  otherwise homogeneous population (Table-4-style stress).

The latency model reuses :func:`repro_torch.sim.network.wan_latency_matrix`
(synthetic stand-in for the WonderNetwork 227-city ping dataset) with the
paper's round-robin node→city assignment.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.sim.network import wan_latency_matrix
from repro_torch.traces.availability import AvailabilityTimeline
from repro_torch.traces.profile import TraceProfile

# ---------------------------------------------------------------------------
# per-node scalars
# ---------------------------------------------------------------------------


def lognormal_speeds(n: int, seed: int, *, base: float = 0.05,
                     sigma: float = 0.6, cap_factor: float = 12.0) -> np.ndarray:
    """Heavy-tailed seconds-per-batch: median ``base``, long straggler tail
    capped at ``cap_factor``·base (real device fleets have a few very slow
    phones, not infinitely slow ones)."""
    rng = np.random.default_rng(seed)
    s = base * rng.lognormal(mean=0.0, sigma=sigma, size=n)
    return np.clip(s, base / cap_factor, base * cap_factor)


def zipf_speeds(n: int, seed: int, *, base: float = 0.04, alpha: float = 2.0,
                max_factor: int = 10) -> np.ndarray:
    """Zipf-tiered speeds: most devices fast, a power-law tail of stragglers."""
    rng = np.random.default_rng(seed)
    tier = np.minimum(rng.zipf(alpha, size=n), max_factor)
    return base * tier.astype(np.float64)


def asymmetric_bandwidth(n: int, seed: int, *, downlink_median: float = 20e6,
                         sigma: float = 0.5, asymmetry_median: float = 4.0,
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(uplink, downlink) bytes/s per node. Last-mile links are asymmetric:
    uplink = downlink / ratio with a lognormal ratio (median ~4x, DSL-like).
    """
    rng = np.random.default_rng(seed)
    down = downlink_median * rng.lognormal(0.0, sigma, size=n)
    ratio = asymmetry_median * rng.lognormal(0.0, 0.3, size=n)
    up = down / np.maximum(ratio, 1.0)
    return up, down


# ---------------------------------------------------------------------------
# availability
# ---------------------------------------------------------------------------


def diurnal_availability(n: int, seed: int, *, period: float = 240.0,
                         mean_fraction: float = 0.7,
                         fraction_jitter: float = 0.15,
                         phase_concentration: float = 0.0,
                         ) -> Tuple[AvailabilityTimeline, ...]:
    """One online window per period per node, sine-day style.

    Node *i* is online for a contiguous window of length ``f_i·period``
    whose start is the node's phase — uniform phases model a global
    population (timezones spread around the clock);
    ``phase_concentration > 0`` pulls phases toward a common "daytime"
    (0 = uniform, 1 = everyone in lockstep → timezone-correlated dropout).
    Windows wrapping the period boundary become two intervals which the
    timeline fuses across tiles.
    """
    rng = np.random.default_rng(seed)
    tls = []
    common = rng.uniform(0.0, period)
    for _ in range(n):
        frac = float(np.clip(rng.normal(mean_fraction, fraction_jitter),
                             0.15, 0.98))
        phase = float(rng.uniform(0.0, period))
        start = (phase_concentration * common
                 + (1.0 - phase_concentration) * phase) % period
        length = frac * period
        end = start + length
        if end <= period:
            spans = ((start, end),)
        else:
            spans = ((0.0, end - period), (start, period))
        tls.append(AvailabilityTimeline(intervals=spans, period=period))
    return tuple(tls)


def fragmented_availability(n: int, seed: int, *, period: float = 240.0,
                            slot: float = 10.0, base: float = 0.8,
                            amplitude: float = 0.15,
                            ) -> Tuple[AvailabilityTimeline, ...]:
    """Flaky-device regime: per-slot Bernoulli online draws whose probability
    is sine-modulated over the period — short dropouts and rejoins rather
    than one clean window."""
    rng = np.random.default_rng(seed)
    n_slots = max(1, int(round(period / slot)))
    tls = []
    for _ in range(n):
        phase = rng.uniform(0.0, 2 * math.pi)
        mids = (np.arange(n_slots) + 0.5) * slot
        p = np.clip(base + amplitude * np.sin(2 * math.pi * mids / period
                                              + phase), 0.05, 0.98)
        on = rng.random(n_slots) < p
        if not on.any():
            on[int(np.argmax(p))] = True
        spans, start = [], None
        for k, flag in enumerate(on):
            if flag and start is None:
                start = k * slot
            if not flag and start is not None:
                spans.append((start, k * slot))
                start = None
        if start is not None:
            spans.append((start, n_slots * slot))
        tls.append(AvailabilityTimeline(intervals=tuple(spans),
                                        period=n_slots * slot))
    return tuple(tls)


def always_on(n: int) -> Tuple[AvailabilityTimeline, ...]:
    return tuple(AvailabilityTimeline.always_on() for _ in range(n))


# ---------------------------------------------------------------------------
# assembled profiles
# ---------------------------------------------------------------------------


def _geo(n: int, seed: int, n_cities: int = 227):
    lat = wan_latency_matrix(n_cities=min(n_cities, max(n, 2)), seed=seed)
    city = np.arange(n) % len(lat)            # round-robin, §4.2
    return lat, city


def homogeneous_profile(n: int, seed: int = 0, *, speed: float = 0.05,
                        bandwidth: float = 20e6) -> TraceProfile:
    lat, city = _geo(n, seed)
    flat = np.full(n, 1.0)
    return TraceProfile(
        name="homogeneous", seed=seed,
        speeds=flat * speed, uplink=flat * bandwidth,
        downlink=flat * bandwidth, latency=lat, city=city,
        availability=always_on(n))


def diurnal_profile(n: int = 64, seed: int = 0, *, period: float = 240.0,
                    base_speed: float = 0.05, mean_availability: float = 0.7,
                    phase_concentration: float = 0.0,
                    downlink_median: float = 20e6) -> TraceProfile:
    lat, city = _geo(n, seed)
    up, down = asymmetric_bandwidth(n, seed + 1,
                                    downlink_median=downlink_median)
    return TraceProfile(
        name="diurnal", seed=seed,
        speeds=lognormal_speeds(n, seed, base=base_speed),
        uplink=up, downlink=down, latency=lat, city=city,
        availability=diurnal_availability(
            n, seed + 2, period=period, mean_fraction=mean_availability,
            phase_concentration=phase_concentration))


def flash_crowd_profile(n: int, seed: int = 0, *, core_fraction: float = 0.15,
                        arrival_at: float = 60.0, arrival_span: float = 30.0,
                        base_speed: float = 0.05) -> TraceProfile:
    """A small always-on core; the rest arrive in one staggered wave."""
    lat, city = _geo(n, seed)
    rng = np.random.default_rng(seed + 3)
    up, down = asymmetric_bandwidth(n, seed + 1)
    n_core = max(1, int(core_fraction * n))
    tls = []
    for i in range(n):
        if i < n_core:
            tls.append(AvailabilityTimeline.always_on())
        else:
            t = arrival_at + float(rng.uniform(0.0, arrival_span))
            tls.append(AvailabilityTimeline(intervals=((t, math.inf),)))
    return TraceProfile(
        name="flash_crowd", seed=seed,
        speeds=lognormal_speeds(n, seed, base=base_speed),
        uplink=up, downlink=down, latency=lat, city=city,
        availability=tuple(tls))


def starved_cohort_profile(n: int, seed: int = 0, *, fraction: float = 0.3,
                           starved_uplink: float = 250e3,
                           bandwidth: float = 20e6,
                           speed: float = 0.05) -> TraceProfile:
    """Homogeneous compute + availability, but a seeded cohort has dial-up
    class uplink — isolates the bandwidth axis of heterogeneity."""
    lat, city = _geo(n, seed)
    rng = np.random.default_rng(seed + 4)
    up = np.full(n, float(bandwidth))
    starved = rng.choice(n, size=max(1, int(fraction * n)), replace=False)
    up[starved] = starved_uplink
    return TraceProfile(
        name="starved_cohort", seed=seed,
        speeds=np.full(n, speed), uplink=up,
        downlink=np.full(n, float(bandwidth)), latency=lat, city=city,
        availability=always_on(n))
