"""Membership registry (Alg. 2) — a last-writer-wins dictionary CRDT.

Each node ``i`` keeps, for every known node ``j``, the most recent
``joined``/``left`` event together with the per-node persistent counter
``c_j`` that ordered it. Merging keeps the higher-counter event, making
merge commutative, associative and idempotent (property-tested).

Two structural optimizations keep this O(changes), not O(population):

* **Layered base + delta.** A session bootstraps every node from one
  immutable population-wide *base* (``Registry.from_base``, built by
  ``repro_torch.sim.soa.population_view``); each node's registry holds only a
  small *delta* of entries that diverged from it. Snapshots are
  copy-on-write over the delta alone, so piggybacking a view on a model
  message costs O(1) and the first post-snapshot mutation copies
  O(delta) — not O(n) as a flat dict would.
* **Incremental digest.** ``digest`` is the XOR of a stable 64-bit hash
  of every effective ``(j, c_j, event)`` entry, maintained per update.
  Equal digests mean (up to a ~2^-64 collision) equal membership views,
  which lets ``merge`` skip identical views in O(1) — the steady state
  for view gossip — and keys the population-level sample-order memo
  (``repro_torch.sim.soa``).

The public mapping surface is unchanged: ``events`` / ``counters``
behave like the flat dicts they used to be (a read-only chain view over
base + delta when layered), iterating base entries first and then
delta-only entries — exactly the insertion order the flat implementation
produced for a bootstrapped population.
"""

from __future__ import annotations

import hashlib
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional, Tuple

JOINED = "joined"
LEFT = "left"


# Stable (not process-salted) 64-bit entry hashes: digests must agree
# across runs so golden trajectories cannot depend on PYTHONHASHSEED.
# Entries recur across the population (every receiver applies the same
# (j, c, e) update), so a bounded memo turns repeated hashing into a
# dict hit.
_ENTRY_MEMO: Dict[tuple, int] = {}
_ENTRY_MEMO_MAX = 1 << 17


def _entry_hash(*entry) -> int:
    h = _ENTRY_MEMO.get(entry)
    if h is None:
        if len(_ENTRY_MEMO) >= _ENTRY_MEMO_MAX:
            _ENTRY_MEMO.clear()
        token = "|".join(map(str, entry)).encode()
        h = _ENTRY_MEMO[entry] = int.from_bytes(
            hashlib.blake2b(token, digest_size=8).digest(), "little")
    return h


class _Chain(Mapping):
    """Read-only mapping over (immutable base, small delta): delta wins."""

    __slots__ = ("_b", "_d", "_extra")

    def __init__(self, base: dict, delta: dict, extra: int):
        self._b = base
        self._d = delta
        self._extra = extra          # count of delta keys not in base

    def __getitem__(self, k):
        try:
            return self._d[k]
        except KeyError:
            return self._b[k]

    def get(self, k, default=None):
        v = self._d.get(k)
        if v is None and k not in self._d:
            return self._b.get(k, default)
        return v

    def __contains__(self, k):
        return k in self._d or k in self._b

    def __iter__(self) -> Iterator:
        b = self._b
        yield from b
        for k in self._d:
            if k not in b:
                yield k

    def __len__(self):
        return len(self._b) + self._extra


class _RegistryBase:
    """Immutable population-wide layer shared by every node's registry."""

    __slots__ = ("events", "counters", "digest")

    def __init__(self, events: dict, counters: dict):
        self.events = events
        self.counters = counters
        d = 0
        for j, c in counters.items():
            d ^= _entry_hash(j, c, events[j])
        self.digest = d


class Registry:
    __slots__ = ("_base", "_dev", "_dct", "_digest", "_extra", "_shared")

    def __init__(self, events: Optional[dict] = None,
                 counters: Optional[dict] = None, _shared: bool = False):
        self._base: Optional[_RegistryBase] = None
        self._dev: Dict[str, str] = events if events is not None else {}
        self._dct: Dict[str, int] = counters if counters is not None else {}
        self._shared = _shared
        self._extra = len(self._dct)
        d = 0
        for j, c in self._dct.items():
            d ^= _entry_hash(j, c, self._dev[j])
        self._digest = d

    @classmethod
    def from_base(cls, events: dict, counters: dict) -> "Registry":
        """A registry layered over an immutable population base; deltas
        start empty. Intended for session bootstrap via
        ``repro_torch.sim.soa.population_view``."""
        r = cls.__new__(cls)
        r._base = _RegistryBase(events, counters)
        r._dev = {}
        r._dct = {}
        r._digest = r._base.digest
        r._extra = 0
        r._shared = False
        return r

    # ---- flat-dict compatible surface -------------------------------------

    @property
    def events(self):
        if self._base is None:
            return self._dev
        return _Chain(self._base.events, self._dev, self._extra)

    @property
    def counters(self):
        if self._base is None:
            return self._dct
        return _Chain(self._base.counters, self._dct, self._extra)

    @property
    def digest(self) -> int:
        """Stable 64-bit XOR digest of the effective (j, c, e) entries —
        equal digests ⇔ equal views (mod ~2^-64 collisions)."""
        return self._digest

    def __len__(self):
        base = self._base
        return self._extra + (len(base.counters) if base is not None else 0)

    def __eq__(self, other):
        if not isinstance(other, Registry):
            return NotImplemented
        return (dict(self.events) == dict(other.events)
                and dict(self.counters) == dict(other.counters))

    __hash__ = None

    def __repr__(self):
        return (f"Registry(events={dict(self.events)!r}, "
                f"counters={dict(self.counters)!r})")

    # ---- internals --------------------------------------------------------

    def _own(self) -> None:
        """Copy-on-write barrier: called before any mutation. Only the
        delta is copied; the base layer is immutable by construction."""
        if self._shared:
            self._dev = dict(self._dev)
            self._dct = dict(self._dct)
            self._shared = False

    def _counter_of(self, j: str) -> Optional[int]:
        c = self._dct.get(j)
        if c is None and self._base is not None:
            return self._base.counters.get(j)
        return c

    def _event_of(self, j: str) -> Optional[str]:
        e = self._dev.get(j)
        if e is None and self._base is not None:
            return self._base.events.get(j)
        return e

    # ---- Alg. 2 -----------------------------------------------------------

    def update(self, j: str, c_j: int, event: str) -> bool:
        """UPDATEREGISTRY — apply iff newer. Returns True if applied.

        Counters are bumped only by node j itself (Alg. 2), so equal
        counters with different events cannot arise in a faithful run;
        still, merges must converge under arbitrary inputs, so ties break
        deterministically toward 'left' (the safe state).
        """
        base = self._base
        have = self._dct.get(j)
        in_delta = have is not None
        if not in_delta and base is not None:
            have = base.counters.get(j)
        if have is None or have < c_j:
            self._own()
            if have is None:
                self._extra += 1
            else:
                old_e = self._dev[j] if in_delta else base.events[j]
                self._digest ^= _entry_hash(j, have, old_e)
            self._dev[j] = event
            self._dct[j] = c_j
            self._digest ^= _entry_hash(j, c_j, event)
            return True
        if have == c_j and event == LEFT:
            cur_e = self._dev[j] if in_delta else base.events[j]
            if cur_e == JOINED:
                self._own()
                self._dev[j] = LEFT
                self._dct[j] = c_j       # shadow the base entry, if any
                self._digest ^= (_entry_hash(j, c_j, JOINED)
                                 ^ _entry_hash(j, c_j, LEFT))
                return True
        return False

    def merge(self, other: "Registry") -> int:
        """MERGEREGISTRY — LWW union; returns number of entries updated.

        O(1) for identical views (digest equality); O(|other's delta|)
        for views sharing our base layer — the common case once a session
        bootstraps everyone from one ``population_view``."""
        if other._digest == self._digest:
            return 0
        n = 0
        ob = other._base
        if ob is not None and ob is self._base:
            src = other._dct.items()     # only the delta can differ
        else:
            src = other.counters.items()
        oev = other._dev
        obev = ob.events if ob is not None else None
        for j, c_j in src:
            e = oev.get(j)
            if e is None:
                e = obev[j]
            # Fast path (no mutation): the common steady state is a view
            # that is not ahead of us anywhere.
            have = self._counter_of(j)
            if have is not None and have > c_j:
                continue
            if have == c_j and not (e == LEFT
                                    and self._event_of(j) == JOINED):
                continue
            n += self.update(j, c_j, e)
        return n

    def registered(self) -> List[str]:
        """Nodes whose latest event is 'joined' (Alg. 2, REGISTERED)."""
        return list(self.iter_registered())

    def iter_registered(self) -> Iterator[str]:
        """Lazy ``registered()`` — callers that only need the first few
        peers (e.g. the auto-rejoin advertisement) stop at O(s), not
        O(population)."""
        dev = self._dev
        base = self._base
        if base is None:
            for j, e in dev.items():
                if e == JOINED:
                    yield j
            return
        bev = base.events
        for j, e in bev.items():
            if dev.get(j, e) == JOINED:
                yield j
        for j, e in dev.items():
            if e == JOINED and j not in bev:
                yield j

    def is_registered(self, j: str) -> bool:
        return self._event_of(j) == JOINED

    def snapshot(self) -> "Registry":
        """O(1) copy-on-write snapshot (wire immutability preserved: both
        sides copy their delta before their next write)."""
        self._shared = True
        r = Registry.__new__(Registry)
        r._base = self._base
        r._dev = self._dev
        r._dct = self._dct
        r._digest = self._digest
        r._extra = self._extra
        r._shared = True
        return r

    def items(self) -> List[Tuple[str, int, str]]:
        ev, ct = self.events, self.counters
        return [(j, ct[j], ev[j]) for j in ct]
