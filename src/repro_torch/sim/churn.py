"""Availability-driven churn: trace timelines → crash / rejoin events.

Before this module, churn was scripted by hand (``schedule_crash`` /
``schedule_leave`` calls per experiment). :class:`AvailabilityDriver`
replaces that with the paper's §4.2 methodology: each node follows its
:class:`~repro_torch.traces.availability.AvailabilityTimeline` — it crashes when
the trace goes offline and rejoins through Alg. 2 when it comes back.

The driver is session-agnostic: it only needs two callbacks. Sessions
decide what "offline" and "online" mean for their node type (MoDeST nodes
re-advertise a Joined event; gossip nodes restart their cycle; D-SGD
nodes merely flip ``online`` — the synchronous baseline has no rejoin
story, which is exactly the paper's point).
"""

from __future__ import annotations

from typing import Callable, List, Sequence


class AvailabilityDriver:
    """Schedules one sim event per availability transition in a horizon."""

    def __init__(self, sim, profile, node_ids: Sequence[str], *,
                 on_offline: Callable[[str], None],
                 on_online: Callable[[str], None],
                 network=None):
        self.sim = sim
        self.profile = profile
        self.node_ids = list(node_ids)
        self.on_offline = on_offline
        self.on_online = on_online
        # With a contention-aware fabric, a crash also kills the node's
        # in-flight transfers, handing their bandwidth back to survivors.
        self.network = network
        self.events_scheduled = 0
        self.events_fired = 0

    def initially_offline(self, at: float = 0.0) -> List[str]:
        return [nid for nid in self.node_ids
                if not self.profile.timeline(nid).is_online(at)]

    def install(self, horizon: float) -> int:
        """Schedule all transitions in (now, now + horizon]; returns count.

        Tie-breaking contract (pinned by ``tests/test_faults.py::
        test_offline_beats_delivery_on_shared_timestamp``): the event
        queue breaks equal-timestamp ties by insertion order, and
        ``install`` runs at session start — before any protocol traffic
        is scheduled — so an availability transition always executes
        *before* a message delivery sharing its timestamp. A message
        arriving exactly when its destination goes offline is therefore
        deterministically dropped, in every protocol.
        """
        t0 = self.sim.now
        for nid in self.node_ids:
            for t, goes_online in self.profile.timeline(nid).transitions(
                    t0, t0 + horizon):
                self.sim.schedule(t - t0, self._fire(nid, goes_online))
                self.events_scheduled += 1
        return self.events_scheduled

    def _fire(self, nid: str, goes_online: bool):
        def fire():
            self.events_fired += 1
            (self.on_online if goes_online else self.on_offline)(nid)
            if not goes_online and self.network is not None:
                self.network.node_offline(nid)

        return fire
