"""Serving replica: snapshot install + per-method admission/batching queue.

A replica is a registered network endpoint (``Network.register``), so
snapshots and queries reach it through ``Network.send`` like any protocol
message — contention shapes the transfers and fault schedules can drop or
duplicate them. Per method it runs the saxml admission pipeline:

* **admission** — at most ``max_queue`` requests wait; beyond that the
  request is rejected immediately (``dropped="admission"``);
* **batching** — one batch per method executes at a time; a batch
  dispatches as soon as ``max_batch`` requests are queued, or after
  ``batch_wait_s`` of linger with a partial batch;
* **deadline** — requests that waited longer than ``deadline_s`` are
  dropped at dispatch time (``dropped="deadline"``), never served late;
* **unloaded** — until the first snapshot installs there is nothing to
  serve with; queries are rejected (``dropped="unloaded"``).

Batch service time scales with the *host node's* heterogeneous speed
(see :class:`repro_torch.serve.config.MethodConfig`). Snapshots install
monotonically by round — a stale copy arriving late (reordered, or
duplicated by the fault fabric) never rolls the served model back.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

from repro_torch.core import messages as M


class ServingReplica:
    """One replica of the deployment, co-located with a population node."""

    def __init__(self, replica_id: str, sim, net, methods, speed: float,
                 fabric):
        self.node_id = replica_id
        self.online = True           # replicas are infrastructure (§4.3)
        self.sim = sim
        self.net = net
        self.speed = float(speed)
        self.fabric = fabric
        self.methods = {m.name: m for m in methods}
        # servable state
        self.round = 0
        self.params = None                        # installed ModelPayload
        self.install_log: List[Tuple[int, float]] = []   # (round, sim_t)
        self.snapshots_installed = 0
        self.stale_snapshots_dropped = 0
        # per-method queues: entries are (msg, deadline_t)
        self._queue: Dict[str, deque] = {m: deque() for m in self.methods}
        self._busy: Dict[str, bool] = {m: False for m in self.methods}
        self._linger: Dict[str, object] = {m: None for m in self.methods}
        # counters
        self.dropped_admission = 0
        self.dropped_deadline = 0
        self.dropped_unloaded = 0
        self.batches = 0
        self.items_served = 0

    # -------------------------------------------------------------- receive

    def receive(self, msg) -> None:
        if isinstance(msg, M.SnapshotMsg):
            self._install(msg)
        elif isinstance(msg, M.RequestMsg):
            self._admit(msg)

    def _install(self, msg: M.SnapshotMsg) -> None:
        if msg.round_k <= self.round:
            self.stale_snapshots_dropped += 1
            return
        self.round = msg.round_k
        self.params = self.fabric.load_snapshot(msg)
        self.install_log.append((msg.round_k, self.sim.now))
        self.snapshots_installed += 1

    # ------------------------------------------------------------ admission

    def _admit(self, msg: M.RequestMsg) -> None:
        mcfg = self.methods.get(msg.method)
        if mcfg is None:
            self._reject(msg, "admission")
            self.dropped_admission += 1
            return
        if self.params is None:
            self.dropped_unloaded += 1
            self._reject(msg, "unloaded")
            return
        q = self._queue[msg.method]
        if len(q) >= mcfg.max_queue:
            self.dropped_admission += 1
            self._reject(msg, "admission")
            return
        q.append((msg, self.sim.now + mcfg.deadline_s))
        self._maybe_dispatch(msg.method)

    def _reject(self, msg: M.RequestMsg, reason: str) -> None:
        self.net.send(self.node_id, msg.sender,
                      M.ResponseMsg(sender=self.node_id, req_id=msg.req_id,
                                    round_k=self.round, dropped=reason))

    # ------------------------------------------------------------- batching

    def _maybe_dispatch(self, method: str) -> None:
        if self._busy[method]:
            return
        mcfg = self.methods[method]
        q = self._queue[method]
        self._expire(method)
        if not q:
            return
        if len(q) >= mcfg.max_batch:
            self._cancel_linger(method)
            self._dispatch(method)
        elif self._linger[method] is None:
            self._linger[method] = self.sim.schedule(
                mcfg.batch_wait_s, lambda: self._linger_fire(method))

    def _linger_fire(self, method: str) -> None:
        self._linger[method] = None
        if not self._busy[method]:
            self._expire(method)
            if self._queue[method]:
                self._dispatch(method)

    def _cancel_linger(self, method: str) -> None:
        h = self._linger[method]
        if h is not None:
            h.cancel()
            self._linger[method] = None

    def _expire(self, method: str) -> None:
        """Deadline drop at dispatch time: entries queue in arrival order,
        so expired ones sit at the front."""
        q = self._queue[method]
        now = self.sim.now
        while q and q[0][1] <= now:
            msg, _ = q.popleft()
            self.dropped_deadline += 1
            self._reject(msg, "deadline")

    def _dispatch(self, method: str) -> None:
        mcfg = self.methods[method]
        q = self._queue[method]
        batch = [q.popleft()[0] for _ in range(min(mcfg.max_batch, len(q)))]
        if not batch:
            return
        self._busy[method] = True
        dur = self.speed * (mcfg.cost_base + mcfg.cost_per_item * len(batch))
        self.sim.schedule(dur, lambda: self._finish(method, batch))

    def _finish(self, method: str, batch) -> None:
        mcfg = self.methods[method]
        self._busy[method] = False
        self.batches += 1
        self.items_served += len(batch)
        for msg in batch:
            self.net.send(self.node_id, msg.sender,
                          M.ResponseMsg(sender=self.node_id,
                                        req_id=msg.req_id,
                                        round_k=self.round,
                                        nbytes=mcfg.response_bytes))
        self._maybe_dispatch(method)
