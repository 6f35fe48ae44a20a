"""`TraceProfile` — one bundle describing a heterogeneous population.

This is the experimental methodology of the paper's §4.2 made first-class:
instead of a uniform-random speed helper and one global bandwidth scalar,
a profile carries, per node,

* ``speeds``       — seconds per training batch (compute heterogeneity)
* ``uplink``/``downlink`` — asymmetric last-mile capacity in bytes/s
* ``latency`` + ``city``  — pairwise one-way WAN latency via a city
  assignment (the paper replays WonderNetwork pings between 227 cities)
* ``availability`` — an online/offline timeline per node (churn)

Profiles are produced by the seeded generators in
:mod:`repro_torch.traces.generators` or loaded from real measurement files
later (see ``docs/TRACES.md``); every consumer — ``Network``, the session
drivers, benchmarks — reads from this one schema.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from repro_torch.traces.availability import AvailabilityTimeline


@dataclass(frozen=True, eq=False)
class TraceProfile:
    name: str
    speeds: np.ndarray                       # (n,) seconds/batch
    uplink: np.ndarray                       # (n,) bytes/s
    downlink: np.ndarray                     # (n,) bytes/s
    latency: np.ndarray                      # (n_cities, n_cities) seconds
    city: np.ndarray                         # (n,) city index per node
    availability: Tuple[AvailabilityTimeline, ...]
    seed: int = 0

    def __post_init__(self):
        n = len(self.speeds)
        for attr in ("uplink", "downlink", "city"):
            if len(getattr(self, attr)) != n:
                raise ValueError(f"{attr} has {len(getattr(self, attr))} "
                                 f"entries for {n} nodes")
        if len(self.availability) != n:
            raise ValueError("one availability timeline per node required")
        if self.latency.ndim != 2 or self.latency.shape[0] != self.latency.shape[1]:
            raise ValueError("latency must be a square matrix")
        if self.city.max(initial=0) >= len(self.latency):
            raise ValueError("city index out of latency-matrix range")
        if (self.speeds <= 0).any() or (self.uplink <= 0).any() \
                or (self.downlink <= 0).any():
            raise ValueError("speeds and capacities must be positive")

    # ------------------------------------------------------------ accessors

    @property
    def n(self) -> int:
        return len(self.speeds)

    def node_index(self, node_id: str) -> int:
        """Sessions name nodes "0".."n-1" (late joiners may exceed n)."""
        return int(node_id) % self.n

    def node_speed(self, node_id: str) -> float:
        return float(self.speeds[self.node_index(node_id)])

    def pair_latency(self, src: str, dst: str) -> float:
        i = self.city[self.node_index(src)]
        j = self.city[self.node_index(dst)]
        return float(self.latency[i, j])

    def node_uplink(self, node_id: str) -> float:
        """Total upstream bytes/s of a node — under flow-level contention
        this is *shared* by all its concurrent outgoing transfers."""
        return float(self.uplink[self.node_index(node_id)])

    def node_downlink(self, node_id: str) -> float:
        return float(self.downlink[self.node_index(node_id)])

    def link_capacity(self, src: str, dst: str) -> float:
        """Per-flow bytes/s: the tighter of src uplink and dst downlink."""
        return min(self.node_uplink(src), self.node_downlink(dst))

    def timeline(self, node_id: str) -> AvailabilityTimeline:
        return self.availability[self.node_index(node_id)]

    # ------------------------------------------------------------- summaries

    def describe(self, horizon: Optional[float] = None) -> dict:
        """Summary stats; pass ``horizon`` for an exact availability
        measure over [0, horizon) (matters for aperiodic arrivals)."""
        up, down, sp = self.uplink, self.downlink, self.speeds
        frac = [tl.online_fraction(horizon) for tl in self.availability]
        return {
            "name": self.name, "n": self.n, "seed": self.seed,
            "speed_p50_s": float(np.median(sp)),
            "speed_p95_s": float(np.percentile(sp, 95)),
            "uplink_mean_mbps": float(np.mean(up) * 8 / 1e6),
            "downlink_mean_mbps": float(np.mean(down) * 8 / 1e6),
            "mean_availability": float(np.mean(frac)),
            "always_on_nodes": int(sum(tl.is_always_on
                                       for tl in self.availability)),
        }
