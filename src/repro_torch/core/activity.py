"""Activity tracking and unresponsive-node suppression (Alg. 3).

``N_i`` maps node id -> highest round in which that node is known to have
been active. Updates are monotone (MAX-merge), so estimates behave like
logical clocks: they can lag the true round but never lead it.

Like :class:`~repro_torch.core.registry.Registry`, the tracker is layered —
an immutable population-wide *base* (session bootstrap) plus a per-node
delta with copy-on-write snapshots — and keeps an incremental XOR
``digest`` of its effective ``(j, k̂_j)`` entries so identical trackers
merge in O(1). ``round_estimate`` is a maintained running max (updates
are monotone and entries are never deleted), not an O(n) scan.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.registry import JOINED, Registry, _Chain, _entry_hash


class _ActivityBase:
    """Immutable population-wide layer shared by every node's tracker."""

    __slots__ = ("latest", "digest", "max_val")

    def __init__(self, latest: dict):
        self.latest = latest
        d = 0
        for j, k in latest.items():
            d ^= _entry_hash(j, k)
        self.digest = d
        self.max_val = max(latest.values()) if latest else None


class ActivityTracker:
    __slots__ = ("_base", "_dl", "_digest", "_extra", "_max", "_shared")

    def __init__(self, latest: Optional[dict] = None, _shared: bool = False):
        self._base: Optional[_ActivityBase] = None
        self._dl: Dict[str, int] = latest if latest is not None else {}
        self._shared = _shared
        self._extra = len(self._dl)
        d = 0
        for j, k in self._dl.items():
            d ^= _entry_hash(j, k)
        self._digest = d
        self._max = max(self._dl.values()) if self._dl else None

    @classmethod
    def from_base(cls, latest: dict) -> "ActivityTracker":
        t = cls.__new__(cls)
        t._base = _ActivityBase(latest)
        t._dl = {}
        t._digest = t._base.digest
        t._extra = 0
        t._max = t._base.max_val
        t._shared = False
        return t

    # ---- flat-dict compatible surface -------------------------------------

    @property
    def latest(self):
        if self._base is None:
            return self._dl
        return _Chain(self._base.latest, self._dl, self._extra)

    @property
    def digest(self) -> int:
        return self._digest

    def __eq__(self, other):
        if not isinstance(other, ActivityTracker):
            return NotImplemented
        return dict(self.latest) == dict(other.latest)

    __hash__ = None

    def __repr__(self):
        return f"ActivityTracker(latest={dict(self.latest)!r})"

    # ---- internals --------------------------------------------------------

    def _own(self) -> None:
        if self._shared:
            self._dl = dict(self._dl)
            self._shared = False

    def _get(self, j: str) -> Optional[int]:
        k = self._dl.get(j)
        if k is None and self._base is not None:
            return self._base.latest.get(j)
        return k

    def _apply(self, j: str, k_hat: int, cur: Optional[int]) -> None:
        self._own()
        if cur is None:
            self._extra += 1
        else:
            self._digest ^= _entry_hash(j, cur)
        self._dl[j] = k_hat
        self._digest ^= _entry_hash(j, k_hat)
        if self._max is None or k_hat > self._max:
            self._max = k_hat

    # ---- Alg. 3 -----------------------------------------------------------

    def update(self, j: str, k_hat: int) -> None:
        """UPDATEACTIVITY — keep the max observed round for j."""
        cur = self._get(j)
        if cur is None or k_hat > cur:
            self._apply(j, k_hat, cur)

    def merge(self, other: "ActivityTracker") -> None:
        # MAX-merge. Identical trackers (the steady state for piggybacked
        # views) short-circuit on digest equality; trackers sharing our
        # base layer walk only the sender's delta.
        if other._digest == self._digest:
            return
        ob = other._base
        if ob is not None and ob is self._base:
            src = other._dl.items()
        else:
            src = other.latest.items()
        for j, k in src:
            cur = self._get(j)
            if cur is None or k > cur:
                self._apply(j, k, cur)

    def round_estimate(self) -> int:
        """k̂ — max round observed from anyone (Alg. 2, l.25)."""
        return self._max if self._max is not None else 0

    def candidates(self, registry: Registry, round_k: int,
                   window: int) -> List[str]:
        """CANDIDATES(k) — registered AND active within the last Δk rounds.

        Once ``round_k`` outruns the base layer's activity rounds (true
        for any bootstrapped session past its first Δk rounds), no base
        entry can qualify on its own and only the delta — nodes actually
        observed active — is scanned: O(active), not O(population)."""
        floor = round_k - window
        dl = self._dl
        base = self._base
        out = []
        if (base is not None and base.max_val is not None
                and base.max_val > floor):
            bl = base.latest
            for j, k in bl.items():
                if dl.get(j, k) > floor and registry._event_of(j) == JOINED:
                    out.append(j)
            for j, k in dl.items():
                if k > floor and j not in bl \
                        and registry._event_of(j) == JOINED:
                    out.append(j)
        else:
            for j, k in dl.items():
                if k > floor and registry._event_of(j) == JOINED:
                    out.append(j)
        return out

    def snapshot(self) -> "ActivityTracker":
        """O(1) copy-on-write snapshot."""
        self._shared = True
        t = ActivityTracker.__new__(ActivityTracker)
        t._base = self._base
        t._dl = self._dl
        t._digest = self._digest
        t._extra = self._extra
        t._max = self._max
        t._shared = True
        return t
