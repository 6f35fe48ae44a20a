"""Fault-injection fabric: declarative, seeded, composable fault schedules.

Plexus's core claim is *practicality* — surviving churn, aggregator
failure, duplicated/out-of-order control traffic, and stragglers. The
clean simulator only models crashes (delivery to an offline endpoint is
dropped); this module adds every other imperfection as a declarative
:class:`FaultSchedule` attached to a session::

    from repro_torch.sim.fault import (FaultSchedule, Drop, Duplicate, Jitter,
                                 LatencySpike, Partition, Straggler,
                                 AggregatorKill)

    schedule = FaultSchedule(rules=(
        Drop(p=0.1),                              # 10% loss, all links
        Duplicate(p=0.05, gap=0.2),               # spurious retransmits
        Jitter(max_delay=0.3),                    # bounded reordering
        LatencySpike(extra=2.0, t0=60, t1=90),    # WAN brownout window
        Partition(groups=(("0", "1", "2"),), t0=100, t1=130),
        Straggler(nodes=3, factor=8.0, t0=50, t1=200),
        AggregatorKill(round_k=5, rejoin_after=30.0),
    ), seed=0)
    session = ModestSession(..., fault=schedule)

Design contract (tested by ``tests/test_faults.py``):

* **Zero-cost by default.** With ``fault=None`` the network takes the
  exact pre-fault code path: trajectories are byte-identical to a build
  without this module (golden test in ``test_determinism.py``).
* **Seeded determinism.** All randomness comes from one
  ``np.random.default_rng(schedule.seed)`` owned by the injector and
  drawn in simulator event order, so the same (session seed, schedule)
  pair replays the same faulty trajectory bit-for-bit. To reproduce a
  failing conformance schedule, rebuild the schedule from the seed
  printed in the failure (docs/FAULTS.md).
* **Composability.** Rules are independent dataclasses filtered by
  (src, dst, message kind, time window); a schedule is just a tuple of
  them. Drops win over duplicates; latency shaping composes additively.
* **Physicality.** Loss happens *in transit*: the sender is charged
  ``bytes_out``, the receiver never sees ``bytes_in`` — byte accounting
  stays conservative (received <= sent, the conformance invariant). A
  duplicate is a spurious retransmission and charges the sender again.
  Self-sends (loopback) never traverse the WAN and are exempt from all
  link faults. A partition starting mid-transfer aborts the flows that
  cross the cut (``Network.abort_flows``); messages already within one
  side keep flowing. Partitions need no heal event: the cut is a pure
  time-window predicate, so traffic resumes the instant ``t1`` passes.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np

_INF = math.inf


# ---------------------------------------------------------------------------
# Rule grammar
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _LinkRule:
    """Shared selector surface: link endpoints, message kinds, time window.

    ``src``/``dst`` are node-id tuples (None = any endpoint), ``kinds``
    message class names like ``("Ping", "Pong")`` (None = any), and the
    rule is live for sim times ``t0 <= now < t1``.
    """

    src: Optional[Tuple[str, ...]] = None
    dst: Optional[Tuple[str, ...]] = None
    kinds: Optional[Tuple[str, ...]] = None
    t0: float = 0.0
    t1: float = _INF

    def matches(self, src: str, dst: str, msg, now: float) -> bool:
        if not (self.t0 <= now < self.t1):
            return False
        if self.src is not None and src not in self.src:
            return False
        if self.dst is not None and dst not in self.dst:
            return False
        if self.kinds is not None and type(msg).__name__ not in self.kinds:
            return False
        return True


@dataclass(frozen=True)
class Drop(_LinkRule):
    """Per-link message loss: each matching message is lost with prob ``p``."""

    p: float = 0.1


@dataclass(frozen=True)
class Duplicate(_LinkRule):
    """Spurious retransmission: with prob ``p`` a second copy of the
    message arrives up to ``gap`` seconds after the first (the sender is
    charged for both — duplicates are real traffic)."""

    p: float = 0.1
    gap: float = 0.1


@dataclass(frozen=True)
class Jitter(_LinkRule):
    """Bounded extra latency uniform in [0, ``max_delay``] per message —
    the reordering primitive: two messages on the same link may swap
    arrival order, but never by more than ``max_delay`` seconds."""

    max_delay: float = 0.2


@dataclass(frozen=True)
class LatencySpike(_LinkRule):
    """Deterministic extra one-way latency during the window (a WAN
    brownout / route flap): every matching message pays ``extra``."""

    extra: float = 1.0


@dataclass(frozen=True)
class Partition:
    """Component-level split: during [t0, t1) messages between different
    groups are dropped and flows crossing the cut are aborted at ``t0``.
    Nodes absent from every listed group form one implicit extra group."""

    groups: Tuple[Tuple[str, ...], ...] = ()
    t0: float = 0.0
    t1: float = _INF

    def group_of(self, nid: str) -> int:
        for gi, g in enumerate(self.groups):
            if nid in g:
                return gi
        return len(self.groups)               # the implicit rest-group

    def severs(self, src: str, dst: str, now: float) -> bool:
        if not (self.t0 <= now < self.t1):
            return False
        return self.group_of(src) != self.group_of(dst)


@dataclass(frozen=True)
class Straggler:
    """Transient compute slowdown via the cost model: at ``t0`` the
    targeted nodes' seconds-per-batch is multiplied by ``factor``; at
    ``t1`` the original speed is restored. ``nodes`` is either explicit
    ids or an int — that many nodes drawn by the injector's seeded rng."""

    nodes: Union[Tuple[str, ...], int] = 1
    factor: float = 4.0
    t0: float = 0.0
    t1: float = _INF


@dataclass(frozen=True)
class AggregatorKill:
    """Targeted mid-round aggregator failure (paper §4's failover story):
    when the first ``AggregateMsg`` for round ``round_k`` goes on the wire
    its destination is, by construction, a designated aggregator of that
    round — kill it ``after`` seconds later (0 = before the model can be
    delivered, i.e. death *post-sample*), and bring it back through
    Alg. 2 rejoin ``rejoin_after`` seconds after the kill (None = never).
    ``count`` kills that many distinct designated aggregators."""

    round_k: int = 2
    after: float = 0.0
    rejoin_after: Optional[float] = 30.0
    count: int = 1


LINK_RULES = (Drop, Duplicate, Jitter, LatencySpike)
Rule = Union[Drop, Duplicate, Jitter, LatencySpike, Partition, Straggler,
             AggregatorKill]


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable, reusable bundle of fault rules + the rng seed that
    makes every injection decision reproducible. Attach with
    ``Session(..., fault=schedule)``; the session builds a private
    :class:`FaultInjector`, so one schedule can drive many runs (the
    two-run determinism invariant depends on exactly this split)."""

    rules: Tuple[Rule, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))


# ---------------------------------------------------------------------------
# Injector (per-session mutable state)
# ---------------------------------------------------------------------------


class FaultInjector:
    """Binds one :class:`FaultSchedule` to one session.

    The network consults :meth:`transit` for every WAN send (the single
    interception point); straggler/partition/kill side effects are
    simulator events scheduled by :meth:`install`. ``stats`` counts every
    injection for post-hoc assertions and the bench overhead row.
    """

    def __init__(self, schedule: FaultSchedule, session):
        self.schedule = schedule
        self.session = session
        self.sim = session.sim
        self.net = session.net
        self.rng = np.random.default_rng(schedule.seed)
        self.rules = list(schedule.rules)
        self.stats: Counter = Counter()
        self._kill_state: dict = {}           # rule -> set(killed ids)
        self._orig_speed: dict = {}           # nid -> pre-straggler speed
        self._active_slow: dict = {}          # nid -> active factor multiset
        self._horizon = None                  # set by install()
        self._installed = False
        session.net.fault = self

    # -- life-cycle ---------------------------------------------------------

    def install(self, horizon: float) -> None:
        """Schedule the time-triggered side effects (idempotent). Like
        ``AvailabilityDriver.install``, windows opening beyond
        ``now + horizon`` are not scheduled — they cannot affect the
        run."""
        if self._installed:
            return
        self._installed = True
        self._horizon = self.sim.now + horizon
        for rule in self.rules:
            self._install_rule(rule)

    def add(self, rule: Rule) -> None:
        """Runtime rule injection (the conformance state machine drives
        faults interactively). Link rules take effect on the next send;
        stragglers/partitions get their window events scheduled now."""
        self.rules.append(rule)
        if self._installed:
            self._install_rule(rule)

    def _install_rule(self, rule: Rule) -> None:
        t0 = getattr(rule, "t0", 0.0)
        if self._horizon is not None and t0 >= self._horizon:
            return
        if isinstance(rule, Straggler):
            ids = self._straggler_ids(rule)
            self._at(rule.t0, lambda: self._slow_down(ids, rule.factor))
            if math.isfinite(rule.t1):
                self._at(rule.t1,
                         lambda: self._restore_speed(ids, rule.factor))
        elif isinstance(rule, Partition):
            # flows already mid-transfer across the cut die at t0
            self._at(rule.t0, lambda: self._sever(rule))

    def _at(self, t: float, fn) -> None:
        self.sim.schedule(max(t - self.sim.now, 0.0), fn)

    # -- link fault decision (called by Network.send) -----------------------

    def transit(self, src: str, dst: str, msg, lat: float) -> Sequence[float]:
        """Latencies at which copies of ``msg`` should be dispatched:
        ``()`` = lost in transit, ``(lat,)`` = untouched, longer = extra
        spurious copies. Draw order is simulator event order, so the
        whole faulty trajectory is a pure function of the seeds."""
        now = self.sim.now
        self._observe(src, dst, msg, now)
        for rule in self.rules:
            if isinstance(rule, Partition) and rule.severs(src, dst, now):
                self.stats["partitioned"] += 1
                return ()
            if (isinstance(rule, Drop) and rule.matches(src, dst, msg, now)
                    and self.rng.random() < rule.p):
                self.stats["dropped"] += 1
                return ()
        delay = lat
        for rule in self.rules:
            if not isinstance(rule, (Jitter, LatencySpike)):
                continue
            if not rule.matches(src, dst, msg, now):
                continue
            if isinstance(rule, LatencySpike):
                self.stats["delayed"] += 1
                delay += rule.extra
            else:
                self.stats["jittered"] += 1
                delay += float(self.rng.uniform(0.0, rule.max_delay))
        out = [delay]
        for rule in self.rules:
            if (isinstance(rule, Duplicate)
                    and rule.matches(src, dst, msg, now)
                    and self.rng.random() < rule.p):
                self.stats["duplicated"] += 1
                out.append(delay + float(self.rng.uniform(0.0, rule.gap)))
        return out

    def severed(self, src: str, dst: str) -> bool:
        """Is the (src, dst) link currently cut by a partition? Consulted
        by the flow scheduler at flow *start* so a payload launched just
        before the cut cannot sneak its transfer through the window."""
        now = self.sim.now
        for rule in self.rules:
            if isinstance(rule, Partition) and rule.severs(src, dst, now):
                self.stats["flows_severed"] += 1
                return True
        return False

    # -- targeted aggregator kill -------------------------------------------

    def _observe(self, src: str, dst: str, msg, now: float) -> None:
        round_k = getattr(msg, "round_k", None)
        # MaskedModelMsg is the secure-agg twin of AggregateMsg: a kill
        # aimed at "whoever receives round-k models" must fire for it too,
        # or secure sessions would dodge the targeted-kill schedules.
        if round_k is None or type(msg).__name__ not in ("AggregateMsg",
                                                         "MaskedModelMsg"):
            return
        for rule in self.rules:
            if not isinstance(rule, AggregatorKill):
                continue
            if rule.round_k != round_k:
                continue
            killed = self._kill_state.setdefault(rule, set())
            if dst in killed or len(killed) >= rule.count:
                continue
            killed.add(dst)
            self.stats["aggregator_kills"] += 1
            self.sim.schedule(rule.after, lambda nid=dst: self._kill(nid))
            if rule.rejoin_after is not None:
                self.sim.schedule(rule.after + rule.rejoin_after,
                                  lambda nid=dst: self._rejoin(nid))

    def _kill(self, nid: str) -> None:
        self.session._trace_offline(nid)

    def _rejoin(self, nid: str) -> None:
        self.session._trace_online(nid)

    # -- straggler side effects ---------------------------------------------

    _SPEED_ATTRS = ("train_speed", "speed")

    def _straggler_ids(self, rule: Straggler) -> Tuple[str, ...]:
        if not isinstance(rule.nodes, int):
            return tuple(rule.nodes)
        # plain lexicographic sort: deterministic draw order without
        # assuming node ids are numeric (joiners may be named anything)
        pool = sorted(self.session.nodes)
        k = min(rule.nodes, len(pool))
        return tuple(self.rng.choice(pool, size=k, replace=False))

    def _speed_attr(self, node) -> Optional[str]:
        for attr in self._SPEED_ATTRS:
            if hasattr(node, attr):
                return attr
        return None

    def _refit_speed(self, nid: str) -> None:
        """Recompute a node's speed from its saved original and the
        multiset of currently-active straggler factors. Overlapping
        windows therefore compose, and when the last one ends the speed
        is restored *exactly* (no x·f/f float residue)."""
        node = self.session.nodes.get(nid)
        attr = self._speed_attr(node) if node is not None else None
        if attr is None:
            return
        factors = self._active_slow.get(nid, [])
        if not factors:
            orig = self._orig_speed.pop(nid, None)
            self._active_slow.pop(nid, None)
            if orig is not None:
                setattr(node, attr, orig)
            return
        speed = self._orig_speed[nid]
        for f in factors:
            speed *= f
        setattr(node, attr, speed)

    def _slow_down(self, ids: Tuple[str, ...], factor: float) -> None:
        for nid in ids:
            node = self.session.nodes.get(nid)
            attr = self._speed_attr(node) if node is not None else None
            if attr is None:
                continue
            self._orig_speed.setdefault(nid, getattr(node, attr))
            self._active_slow.setdefault(nid, []).append(factor)
            self._refit_speed(nid)
            self.stats["straggled"] += 1

    def _restore_speed(self, ids: Tuple[str, ...], factor: float) -> None:
        for nid in ids:
            active = self._active_slow.get(nid)
            if active and factor in active:
                active.remove(factor)
            self._refit_speed(nid)

    # -- partition side effects ---------------------------------------------

    def _sever(self, rule: Partition) -> None:
        aborted = self.net.abort_flows(
            lambda src, dst: rule.group_of(src) != rule.group_of(dst))
        self.stats["flows_severed"] += aborted
