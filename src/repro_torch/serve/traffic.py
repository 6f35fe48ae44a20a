"""Query traffic: trace availability profiles re-read as request arrival.

The generators in ``repro_torch.traces`` describe *when devices are around*;
for the query plane the same timelines describe *when users query* — a
diurnal profile becomes a diurnal request wave, a flash-crowd profile a
sudden pile-on. Each query client is co-located with a population node
(same city/links via the id-modulo mapping) and issues Poisson requests
at ``rate_per_client`` thinned by its timeline: a draw landing in an
offline span is simply not issued.

All arrival times are drawn at install time, in client-id order, from
one session-owned ``default_rng(session_seed + seed_offset)`` stream —
the trajectory stays a pure function of (seed, schedule) and no
iteration over unordered collections feeds the event queue (DL001/DL003,
docs/ANALYSIS.md).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core import messages as M


class QueryClient:
    """One query endpoint; records per-request latency and staleness."""

    def __init__(self, client_id: str, sim, net, fabric):
        self.node_id = client_id
        self.online = True
        self.sim = sim
        self.net = net
        self.fabric = fabric
        self.pending: Dict[int, float] = {}       # req_id -> t_sent
        self.issued = 0
        self.served = 0
        self.latencies: List[float] = []
        self.staleness: List[int] = []
        self.rejected: Dict[str, int] = {}

    def issue(self, req_id: int, method, replica_id: str) -> None:
        msg = M.RequestMsg(sender=self.node_id, req_id=req_id,
                           method=method.name, nbytes=method.request_bytes)
        self.pending[req_id] = self.sim.now
        self.issued += 1
        self.net.send(self.node_id, replica_id, msg)

    def receive(self, msg) -> None:
        if not isinstance(msg, M.ResponseMsg):
            return
        t_sent = self.pending.pop(msg.req_id, None)
        if t_sent is None:
            return                        # duplicate response (fault fabric)
        if msg.dropped:
            self.rejected[msg.dropped] = self.rejected.get(msg.dropped, 0) + 1
            return
        self.served += 1
        self.latencies.append(self.sim.now - t_sent)
        self.staleness.append(max(0, self.fabric.frontier - msg.round_k))


class RequestLoadDriver:
    """Schedules every query arrival for the horizon up front (the same
    install-time pattern as the churn driver, so tie-breaking against
    protocol events is deterministic by construction)."""

    def __init__(self, sim, cfg, clients, replicas, net, seed: int):
        self.sim = sim
        self.cfg = cfg
        self.clients = list(clients)
        self.replicas = list(replicas)
        self.net = net
        self.seed = seed
        self.requests_scheduled = 0

    def _replica_order(self, client) -> List[str]:
        """Replica ids in routing preference order for one client."""
        ids = [r.node_id for r in self.replicas]
        if self.cfg.routing == "nearest":
            # stable sort: latency ties keep deployment order
            ids.sort(key=lambda rid: self.net.latency(client.node_id, rid))
        return ids

    def install(self, horizon: float) -> int:
        cfg = self.cfg
        if cfg.rate_per_client <= 0 or not self.clients:
            return 0
        rng = np.random.default_rng(self.seed + cfg.seed_offset)
        methods = list(cfg.methods)
        profile = cfg.request_profile
        t0 = self.sim.now
        req_id = 0
        for j, client in enumerate(self.clients):
            timeline = (profile.timeline(str(j % profile.n))
                        if profile is not None else None)
            order = self._replica_order(client)
            t = 0.0
            while req_id < cfg.max_requests:
                t += float(rng.exponential(1.0 / cfg.rate_per_client))
                if t >= horizon:
                    break
                if timeline is not None and not timeline.is_online(t0 + t):
                    continue              # offline span: the user is away
                method = methods[req_id % len(methods)]
                replica_id = (order[0] if cfg.routing == "nearest"
                              else order[req_id % len(order)])
                self.sim.schedule(
                    t, (lambda c=client, r=req_id, m=method, d=replica_id:
                        c.issue(r, m, d)))
                req_id += 1
                self.requests_scheduled += 1
        return self.requests_scheduled
