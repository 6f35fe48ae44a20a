"""Dynamic same-timestamp conflict detector (shadow-mode).

The event queue's tie-break contract pins that events sharing a
timestamp fire in schedule-call (``seq``) order. That makes equal-
timestamp outcomes *deterministic* — but only as deterministic as the
code that issued the ``schedule()`` calls: a fan-out loop iterating an
unordered collection (the DL003 lint hazard) assigns ``seq`` in a
PYTHONHASHSEED-dependent order, and if two of those events write the
same protocol state, the run is deterministic only by accident.

:class:`RaceDetector` instruments a session **in shadow mode**: it wraps
``Simulator.schedule`` so every handler records

* the **call site** that scheduled it and the handler that was executing
  at the time (scheduling provenance),
* its **write set** over shared protocol state, obtained by diffing
  cheap snapshots before/after the handler: SoA ``online`` rows,
  per-node membership-view digests (``registry.digest``,
  ``activity.digest``), per-node round counters, and ``Network`` flow-
  table membership.

A **conflict** is an equal-timestamp pair of handlers that both changed
the same key to different values — i.e. the final state depends on their
``seq`` order. Idempotent double-writes (both set ``online=False``)
leave no diff for the second handler and vanish naturally; accumulator
state whose updates commute (byte counters, ``train_seconds``,
injection stats) is deliberately *not* tracked — order cannot change its
final value. Reported conflicts carry both scheduling sites so they can
be traced back to a DL003-flagged source (``link_lint_findings``).

Contracts (tested in ``tests/test_torch_analysis.py``):

* **Zero-cost when detached** — nothing in the simulator or network
  references this module; the instrument is pure observation installed
  by ``attach``.
* **Byte-identical when attached** — wrapping reads state, never
  mutates it, draws no RNG and schedules no events: an instrumented
  golden session reproduces its pinned fingerprint exactly.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["RaceDetector", "Conflict", "RaceReport"]

_ROUND_ATTRS = ("k_agg", "k_train", "counter", "round", "cycles")


@dataclass(frozen=True)
class _Site:
    file: str
    line: int

    def __str__(self) -> str:
        return f"{os.path.basename(self.file)}:{self.line}"


@dataclass
class _Event:
    index: int                    # execution order (== (time, seq) order)
    t: float
    site: Optional[_Site]         # where schedule() was called
    parent: Optional[int]         # event executing when this was scheduled
    writes: Dict[tuple, tuple] = field(default_factory=dict)  # key -> post


@dataclass
class Conflict:
    t: float
    key: tuple
    first: _Event
    second: _Event
    value_first: tuple
    value_second: tuple
    dl003_linked: bool = False

    def describe(self) -> str:
        link = "  [traces to DL003-flagged source]" if self.dl003_linked else ""
        return (f"t={self.t:.6f} key={self.key}: event#{self.first.index} "
                f"(scheduled at {self.first.site}) wrote "
                f"{self.value_first}, then event#{self.second.index} "
                f"(scheduled at {self.second.site}) overwrote with "
                f"{self.value_second} — outcome depends on seq order{link}")


@dataclass
class RaceReport:
    events_observed: int
    events_with_writes: int
    timestamp_groups: int
    conflicts: List[Conflict]

    @property
    def clean(self) -> bool:
        return not self.conflicts

    def summary(self) -> str:
        lines = [f"{self.events_observed} events observed, "
                 f"{self.events_with_writes} wrote tracked state, "
                 f"{self.timestamp_groups} shared-timestamp groups, "
                 f"{len(self.conflicts)} conflict(s)"]
        lines.extend(c.describe() for c in self.conflicts)
        return "\n".join(lines)


class RaceDetector:
    """Attach to a session before ``run()``; read :meth:`report` after.

    ``session`` is duck-typed: ``.sim`` is required; ``.nodes`` (id ->
    node) and ``.net`` (with ``.state`` SoA columns and ``._out`` flow
    tables) are observed when present, so the detector works on the
    protocol sessions and on bare-simulator test harnesses alike.
    """

    def __init__(self) -> None:
        self._session = None
        self._sim = None
        self._events: List[_Event] = []
        self._groups: Dict[float, List[_Event]] = {}
        self._current: Optional[_Event] = None
        self._last_snap: Optional[Dict[tuple, tuple]] = None
        self._flow_tokens: Dict[int, int] = {}
        self._flow_refs: List[object] = []      # keep ids stable (no reuse)

    # ------------------------------------------------------------- attach

    def attach(self, session):
        if self._session is not None:
            raise RuntimeError("RaceDetector instances are single-use")
        self._session = session
        self._sim = sim = session.sim
        orig_schedule = sim.schedule

        def schedule(delay, fn):
            frame = sys._getframe(1)
            site = _Site(frame.f_code.co_filename, frame.f_lineno)
            parent = self._current.index if self._current is not None else None
            return orig_schedule(delay, self._wrap(fn, site, parent))

        sim.schedule = schedule
        # events the session constructor already queued (round-1 bootstrap,
        # deferred joins) predate the attach: wrap them in place so their
        # writes are observed too, with unknown provenance.
        for _, _, rec in sim._q:
            rec.fn = self._wrap(rec.fn, None, None)
        return session

    def _wrap(self, fn, site: Optional[_Site], parent: Optional[int]):
        def run():
            ev = _Event(len(self._events), self._sim.now, site, parent)
            self._events.append(ev)
            pre = self._last_snap if self._last_snap is not None \
                else self._snapshot()
            prev, self._current = self._current, ev
            try:
                fn()
            finally:
                self._current = prev
            post = self._snapshot()
            self._last_snap = post
            self._diff(pre, post, ev)
            if ev.writes:
                self._groups.setdefault(ev.t, []).append(ev)

        return run

    # ---------------------------------------------------------- snapshots

    def _snapshot(self) -> Dict[tuple, tuple]:
        snap: Dict[tuple, tuple] = {}
        sess = self._session
        net = getattr(sess, "net", None)
        state = getattr(net, "state", None)
        if state is not None:
            online = state.online
            for nid, row in state.index.items():
                snap[("online", nid)] = (bool(online[row]),)
        nodes = getattr(sess, "nodes", None)
        if nodes:
            for nid, node in nodes.items():
                reg = getattr(node, "registry", None)
                act = getattr(node, "activity", None)
                if reg is not None and act is not None:
                    snap[("view", nid)] = (reg.digest, act.digest)
                for attr in _ROUND_ATTRS:
                    v = getattr(node, attr, None)
                    if v is not None and not callable(v):
                        snap[("round", nid, attr)] = (v,)
        if net is not None and getattr(net, "_out", None) is not None:
            for src, flows in net._out.items():
                for f in flows:
                    tok = self._flow_tokens.get(id(f))
                    if tok is None:
                        tok = self._flow_tokens[id(f)] = len(self._flow_refs)
                        self._flow_refs.append(f)
                    snap[("flow", tok)] = (f.src, f.dst)
        return snap

    @staticmethod
    def _diff(pre: Dict[tuple, tuple], post: Dict[tuple, tuple],
              ev: _Event) -> None:
        for k, v in post.items():
            if pre.get(k) != v:
                ev.writes[k] = v
        for k in pre:
            if k not in post:
                ev.writes[k] = ("<gone>",)

    # ------------------------------------------------------------- report

    def report(self) -> RaceReport:
        conflicts: List[Conflict] = []
        groups = 0
        for t in sorted(self._groups):
            evs = self._groups[t]
            if len(evs) < 2:
                continue
            groups += 1
            for i, a in enumerate(evs):
                for b in evs[i + 1:]:
                    for k in a.writes.keys() & b.writes.keys():
                        if a.writes[k] != b.writes[k]:
                            conflicts.append(Conflict(
                                t, k, a, b, a.writes[k], b.writes[k]))
        conflicts.sort(key=lambda c: (c.t, c.first.index, c.second.index,
                                      repr(c.key)))
        return RaceReport(
            events_observed=len(self._events),
            events_with_writes=sum(1 for e in self._events if e.writes),
            timestamp_groups=groups,
            conflicts=conflicts)

    def link_lint_findings(self, report: RaceReport, findings) -> RaceReport:
        """Mark conflicts whose scheduling site lies in a file with DL003
        findings (waived or not): the seq order of that pair traces back
        to a statically-flagged unordered source. Coarse (file-level) by
        design — the lint finding carries the exact line."""
        dl003_files = {os.path.basename(f.path)
                       for f in findings if f.rule == "DL003"}
        for c in report.conflicts:
            for site in (c.first.site, c.second.site):
                if (site is not None
                        and os.path.basename(site.file) in dl003_files):
                    c.dl003_linked = True
        return report


def run_shadow_check(session_factory, duration: float,
                     fingerprint=None) -> Tuple[RaceReport, bool]:
    """Run ``session_factory()`` twice — clean and instrumented — and
    return (race report, trajectories identical). Used by the CLI and
    the CI shadow check: proves both 'zero conflicts' and 'instrument
    attached is byte-identical'."""
    clean = session_factory().run(duration)
    det = RaceDetector()
    sess = session_factory()
    det.attach(sess)
    instrumented = sess.run(duration)
    fp = fingerprint or _default_fingerprint
    return det.report(), fp(clean) == fp(instrumented)


def _default_fingerprint(result) -> str:
    import hashlib
    import json
    blob = json.dumps({"rt": result.round_times, "hist": result.history,
                       "usage": result.usage, "churn": result.churn_events},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
