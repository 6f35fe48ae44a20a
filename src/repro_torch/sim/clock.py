"""Event-queue simulation kernel with virtual time and cancellable events.

Two interchangeable queue tiers sit behind :class:`Simulator`:

* ``queue="bucket"`` (default) — a calendar/bucket queue: events are
  binned by ``int(time / bucket_width)`` into per-bucket heaps, and a
  small min-heap of bucket keys finds the earliest non-empty bucket.
  Every event in bucket ``k`` precedes every event in bucket ``k+1``
  (binning is monotone in time), so the global minimum always lives in
  the smallest non-empty bucket; within a bucket the heap orders by the
  same ``(time, seq)`` tuple the flat heap used. Million-event runs pay
  ``O(log bucket_population)`` per operation instead of ``O(log total)``.
* ``queue="heap"`` — the single flat binary heap, kept as the reference
  implementation; ``tests/test_clock.py`` proves both tiers emit events
  in an identical order on randomized schedules.

**Tie-break contract** (pinned by ``tests/test_faults.py::
test_offline_beats_delivery_on_shared_timestamp`` and relied on by the
churn driver): events sharing a timestamp fire in schedule-call order.
Both tiers order by ``(time, seq)`` where ``seq`` is a global insertion
counter, so the contract holds identically in either mode — the bucket
tier is a pure data-structure change, not a semantics change.
"""

from __future__ import annotations

import heapq
import itertools
import warnings
from typing import Callable, Optional


class _Rec:
    """Mutable per-event record (the heap entries are immutable tuples)."""

    __slots__ = ("fn", "cancelled")

    def __init__(self, fn: Callable):
        self.fn = fn
        self.cancelled = False


class Handle:
    """Returned by ``schedule``; ``cancel()`` makes the event a no-op."""

    __slots__ = ("_ev",)

    def __init__(self, ev: _Rec):
        self._ev = ev

    def cancel(self) -> None:
        self._ev.cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._ev.cancelled


class _HeapQueue:
    """Reference tier: one flat binary heap of (time, seq, rec) tuples."""

    __slots__ = ("_h",)

    def __init__(self):
        self._h: list = []

    def push(self, item) -> None:
        heapq.heappush(self._h, item)

    def peek(self):
        return self._h[0] if self._h else None

    def pop(self):
        return heapq.heappop(self._h)

    def __len__(self):
        return len(self._h)

    def __iter__(self):
        return iter(self._h)


class _BucketQueue:
    """Calendar-queue tier: per-bucket heaps + a min-heap of bucket keys.

    Invariant: a key sits in ``_keys`` at least once for every non-empty
    bucket; stale keys (bucket drained, possibly re-created later) are
    lazily discarded by ``_top``. Binning is monotone — ``t1 <= t2``
    implies ``key(t1) <= key(t2)`` — so the earliest event is always in
    the bucket with the smallest live key, and the within-bucket heap
    preserves the exact ``(time, seq)`` order of the flat heap.
    """

    __slots__ = ("width", "_buckets", "_keys")

    def __init__(self, width: float = 0.25):
        if width <= 0:
            raise ValueError("bucket_width must be positive")
        self.width = width
        self._buckets: dict = {}        # key -> [(time, seq, rec), ...] heap
        self._keys: list = []           # min-heap of (possibly stale) keys

    def push(self, item) -> None:
        k = int(item[0] / self.width)
        b = self._buckets.get(k)
        if b is None:
            self._buckets[k] = b = []
            heapq.heappush(self._keys, k)
        heapq.heappush(b, item)

    def _top(self):
        keys = self._keys
        buckets = self._buckets
        while keys:
            b = buckets.get(keys[0])
            if b:
                return b
            k = heapq.heappop(keys)     # drained or duplicated key: discard
            if b is not None:
                del buckets[k]
        return None

    def peek(self):
        b = self._top()
        return b[0] if b is not None else None

    def pop(self):
        return heapq.heappop(self._top())

    def __len__(self):
        return sum(len(b) for b in self._buckets.values())

    def __iter__(self):
        for b in self._buckets.values():
            yield from b


class Simulator:
    def __init__(self, queue: str = "bucket", bucket_width: float = 0.25):
        if queue not in ("bucket", "heap"):
            raise ValueError(f"unknown queue tier {queue!r}")
        self.now: float = 0.0
        self.queue_kind = queue
        self._q = (_BucketQueue(bucket_width) if queue == "bucket"
                   else _HeapQueue())
        self._seq = itertools.count()
        self.events_processed = 0
        self.exhausted = False       # last run() hit max_events

    def schedule(self, delay: float, fn: Callable) -> Handle:
        rec = _Rec(fn)
        self._q.push((self.now + max(delay, 0.0), next(self._seq), rec))
        return Handle(rec)

    def run(self, until: Optional[float] = None,
            max_events: int = 50_000_000) -> None:
        """Process events up to ``until`` (inclusive) or queue exhaustion.

        ``now`` always lands on ``until`` when given — even if the queue
        drains early — so later ``schedule(at - sim.now)`` arithmetic stays
        correct across consecutive ``run`` calls. Hitting ``max_events``
        sets ``self.exhausted`` and warns: a truncated run is not the same
        thing as a converged one.
        """
        self.exhausted = False
        budget_start = self.events_processed
        q = self._q
        while True:
            head = q.peek()
            if head is None:
                break
            if until is not None and head[0] > until:
                self.now = until
                return
            if self.events_processed - budget_start >= max_events:
                self.exhausted = True
                warnings.warn(
                    f"Simulator.run stopped after max_events={max_events} "
                    f"with {self.pending} events still pending at "
                    f"t={self.now:.3f} — results are truncated, not "
                    f"converged", RuntimeWarning, stacklevel=2)
                return
            t, _, rec = q.pop()
            if rec.cancelled:
                continue
            self.now = t
            self.events_processed += 1
            rec.fn()
        if until is not None and self.now < until:
            self.now = until

    @property
    def pending(self) -> int:
        return sum(1 for _, _, rec in self._q if not rec.cancelled)
