"""Availability timelines: when is a node online?

The paper's deployment runs on edge devices that come and go (diurnal
usage, flaky links — §4.2, Figs. 5–6). An :class:`AvailabilityTimeline`
encodes that as a set of half-open ``[start, end)`` online intervals,
optionally repeating with a ``period`` so short synthetic traces tile
cleanly over arbitrarily long simulation horizons.

Sessions consume timelines through two queries:

* :meth:`is_online` — instantaneous state, used for the round-1 bootstrap
  (offline nodes cannot be in S^1).
* :meth:`transitions` — the ordered online/offline flips inside a window,
  which the churn driver turns into ``crash()`` / rejoin (Alg. 2) events.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple


@dataclass(frozen=True)
class AvailabilityTimeline:
    """Online intervals, optionally periodic.

    ``intervals`` are half-open ``[start, end)`` spans, sorted and
    non-overlapping. With ``period > 0`` they describe one period starting
    at t=0 and repeat forever; an interval ending exactly at ``period``
    fuses with a successor starting at 0 in the next tile (no spurious
    off/on flip at the boundary). With ``period == 0`` the intervals are
    absolute (``math.inf`` end = online forever).
    """

    intervals: Tuple[Tuple[float, float], ...]
    period: float = 0.0

    def __post_init__(self):
        prev_end = None
        for (s, e) in self.intervals:
            if not (e > s >= 0.0):
                raise ValueError(f"bad interval [{s}, {e})")
            if prev_end is not None and s < prev_end:
                raise ValueError("intervals must be sorted and disjoint")
            prev_end = e
            if self.period > 0 and e > self.period:
                raise ValueError("periodic interval exceeds the period")

    # ------------------------------------------------------------- factories

    @classmethod
    def always_on(cls) -> "AvailabilityTimeline":
        return cls(intervals=((0.0, math.inf),), period=0.0)

    @classmethod
    def from_onsets(cls, flips: List[float], *, start_online: bool,
                    horizon: float) -> "AvailabilityTimeline":
        """Build an absolute timeline from a sorted list of flip times."""
        spans, online, t = [], start_online, 0.0
        for f in list(flips) + [horizon]:
            if online and f > t:
                spans.append((t, f))
            online, t = not online, f
        return cls(intervals=tuple(spans), period=0.0)

    # --------------------------------------------------------------- queries

    def is_online(self, t: float) -> bool:
        if self.period > 0:
            t = t % self.period
        i = bisect.bisect_right([s for s, _ in self.intervals], t) - 1
        return i >= 0 and t < self.intervals[i][1]

    @property
    def is_always_on(self) -> bool:
        return (self.period <= 0 and len(self.intervals) == 1
                and self.intervals[0][0] == 0.0
                and math.isinf(self.intervals[0][1]))

    def online_fraction(self, horizon: Optional[float] = None) -> float:
        """Fraction of time online. With ``horizon`` the measure is exact
        over ``[0, horizon)``; without it, periodic timelines use one
        period and semi-infinite ones their asymptotic value (1.0) —
        pass a horizon for honest numbers on e.g. flash-crowd arrivals.
        """
        if horizon is not None and horizon > 0:
            def measure(a, b):
                return sum(max(0.0, min(e, b) - max(s, a))
                           for s, e in self.intervals)
            if self.period <= 0:
                return measure(0.0, horizon) / horizon
            full, rem = divmod(horizon, self.period)
            return (full * measure(0.0, self.period)
                    + measure(0.0, rem)) / horizon
        length = sum(e - s for s, e in self.intervals
                     if not math.isinf(e))
        if any(math.isinf(e) for _, e in self.intervals):
            return 1.0
        span = self.period if self.period > 0 else (
            self.intervals[-1][1] if self.intervals else 1.0)
        return length / span if span else 0.0

    def next_online(self, t: float) -> float:
        """Earliest time >= t at which the node is online (inf if never)."""
        if self.is_online(t):
            return t
        if self.period > 0:
            for tt, goes_online in self.transitions(t, t + self.period):
                if goes_online:
                    return tt
            return math.inf
        for (s, _e) in self.intervals:
            if s >= t:
                return s
        return math.inf

    def _period_edges(self) -> List[Tuple[float, bool]]:
        """(offset, goes_online) edges inside one period, wrap-merged."""
        edges: List[Tuple[float, bool]] = []
        wrap = (bool(self.intervals)
                and self.intervals[0][0] == 0.0
                and self.intervals[-1][1] == self.period)
        for idx, (s, e) in enumerate(self.intervals):
            if not (wrap and idx == 0):
                edges.append((s, True))
            if not (wrap and idx == len(self.intervals) - 1):
                edges.append((e, False))
        return sorted(edges)

    def transitions(self, t0: float, t1: float) -> Iterator[Tuple[float, bool]]:
        """Yield ``(time, goes_online)`` state changes with t0 < time <= t1.

        Periodic timelines tile: the same per-period edge pattern repeats
        every ``period`` seconds, with boundary-touching intervals fused so
        a node online across the wrap sees no transition at k·period.
        """
        if self.period <= 0:
            for (s, e) in self.intervals:
                if t0 < s <= t1:
                    yield (s, True)
                if not math.isinf(e) and t0 < e <= t1:
                    yield (e, False)
            return
        edges = self._period_edges()
        if not edges:
            return
        tile = math.floor(t0 / self.period)
        last_tile = math.floor(t1 / self.period)
        while tile <= last_tile:
            base = tile * self.period
            for off, online in edges:
                t = base + off
                if t0 < t <= t1:
                    yield (t, online)
                elif t > t1:
                    return
            tile += 1
