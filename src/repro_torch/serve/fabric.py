"""ServingFabric: wires a deployment into a training session.

The fabric owns everything the ``serve=`` config implies:

* **replicas** — ``n_replicas``
  :class:`~repro_torch.serve.replica.ServingReplica` endpoints registered
  on the session's network with ids ``n + i`` (co-located with
  population node ``i % n``: same city, link class and compute speed
  through the id-modulo trace mapping);
* **clients** — one :class:`~repro_torch.serve.traffic.QueryClient` per
  population node (ids ``2n + j``, co-located with node ``j``), driven by
  :class:`~repro_torch.serve.traffic.RequestLoadDriver`;
* **publication** — the session calls :meth:`on_round` whenever a new
  round completes anywhere in the population; every ``publish_every``-th
  round (plus round 1, so replicas load early) is fanned out to all
  replicas as :class:`~repro_torch.core.messages.SnapshotMsg` *from the node
  that completed the round*, charging its uplink under contention and
  passing through the fault interception point;
* **checkpoint spool** — with ``spool_dir`` set, real-params snapshots
  round-trip through ``checkpoint.save``/``checkpoint.restore`` on the
  publish/install path (the saxml servable-load discipline), with
  ``restore_shardings`` threaded into restore (None: each leaf lands on
  the device of the training-side leaf it was saved from);
* **metrics** — :meth:`summary` folds client/replica counters into the
  served-model staleness, p50/p99 latency and snapshot fan-out bytes
  reported on ``SessionResult.serving``.

Construction happens only when a config is attached; ``serve=None``
sessions never instantiate a fabric (zero-cost contract, pinned by the
golden trajectories).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from repro_torch import checkpoint
from repro_torch.core import messages as M
from repro_torch.engine.flat import as_tree
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.replica import ServingReplica
from repro_torch.serve.traffic import QueryClient, RequestLoadDriver


class ServingFabric:
    def __init__(self, session, cfg: ServeConfig, speeds, seed: int):
        self.session = session
        self.cfg = cfg
        self.sim = session.sim
        self.net = session.net
        n = len(session.nodes)
        speeds = np.asarray(speeds, float)
        self.frontier = 0                 # latest training round completed
        self._last_published = 0
        self.snapshots_published = 0
        # last spooled pytree (restore like=): views into a training-side
        # buffer, read only for shapes, dtypes and devices
        self._template = None

        self.replicas: List[ServingReplica] = []
        for i in range(cfg.n_replicas):
            rid = str(n + i)
            replica = ServingReplica(rid, self.sim, self.net, cfg.methods,
                                     float(speeds[i % len(speeds)]), self)
            self.net.register(replica)
            self.replicas.append(replica)

        n_clients = cfg.n_clients or n
        self.clients: List[QueryClient] = []
        for j in range(n_clients):
            client = QueryClient(str(2 * n + j), self.sim, self.net, self)
            self.net.register(client)
            self.clients.append(client)

        req_profile = cfg.request_profile
        if req_profile is None:
            req_profile = getattr(session, "profile", None)
        self._driver = RequestLoadDriver(
            self.sim, _with_profile(cfg, req_profile),
            self.clients, self.replicas, self.net, seed)

    # ---------------------------------------------------------- publication

    def on_round(self, k: int, params, src_node: str) -> None:
        """Called by the session on each *new* population-level round."""
        self.frontier = max(self.frontier, k)
        if k <= self._last_published:
            return
        if k != 1 and k % self.cfg.publish_every != 0:
            return
        self._last_published = k
        payload = (M.ModelPayload(params=params) if params is not None
                   else M.ModelPayload(nbytes=self.session.task.model_bytes()))
        if self.cfg.spool_dir is not None and params is not None:
            self._spool_save(k, params)
        for replica in self.replicas:
            self.net.account_payload(payload.size_bytes())
            self.net.send(src_node, replica.node_id,
                          M.SnapshotMsg(sender=src_node, round_k=k,
                                        model=payload))
        self.snapshots_published += 1

    # ----------------------------------------------------- checkpoint spool

    def _spool_path(self, round_k: int) -> str:
        return os.path.join(self.cfg.spool_dir, f"round_{round_k:06d}")

    def _spool_save(self, round_k: int, params) -> None:
        tree = as_tree(params)
        checkpoint.save(self._spool_path(round_k), tree,
                        meta={"round": round_k})
        self._template = tree

    def load_snapshot(self, msg: M.SnapshotMsg):
        """The replica-side install hook: with a spool, the servable model
        is what ``checkpoint.restore`` returns (save/restore round-trip on
        the serving path); otherwise the wire payload installs directly."""
        if (self.cfg.spool_dir is None or msg.model.params is None
                or self._template is None):
            return msg.model
        restored, _meta = checkpoint.restore(
            self._spool_path(msg.round_k), self._template,
            shardings=self.cfg.restore_shardings)
        return M.ModelPayload(params=restored)

    # ---------------------------------------------------------------- hooks

    def install(self, horizon: float) -> int:
        return self._driver.install(horizon)

    # -------------------------------------------------------------- metrics

    def summary(self) -> dict:
        lat = np.concatenate(
            [np.asarray(c.latencies, float) for c in self.clients]
        ) if any(c.latencies for c in self.clients) else np.empty(0)
        stal = np.concatenate(
            [np.asarray(c.staleness, float) for c in self.clients]
        ) if any(c.staleness for c in self.clients) else np.empty(0)
        issued = sum(c.issued for c in self.clients)
        served = sum(c.served for c in self.clients)
        rejected: dict = {}
        for c in self.clients:
            for reason, cnt in c.rejected.items():
                rejected[reason] = rejected.get(reason, 0) + cnt
        by_type = self.net.bytes_by_type
        batches = sum(r.batches for r in self.replicas)
        return {
            "requests": int(issued),
            "served": int(served),
            "rejected": rejected,
            "dropped_admission": sum(r.dropped_admission
                                     for r in self.replicas),
            "dropped_deadline": sum(r.dropped_deadline
                                    for r in self.replicas),
            "dropped_unloaded": sum(r.dropped_unloaded
                                    for r in self.replicas),
            "lost": int(issued - served - sum(rejected.values())),
            "p50_latency_s": _pct(lat, 50),
            "p99_latency_s": _pct(lat, 99),
            "mean_latency_s": (round(float(lat.mean()), 6)
                               if lat.size else None),
            "staleness_mean_rounds": (round(float(stal.mean()), 3)
                                      if stal.size else None),
            "staleness_max_rounds": (int(stal.max()) if stal.size else None),
            "snapshots_published": int(self.snapshots_published),
            "snapshots_installed": sum(r.snapshots_installed
                                       for r in self.replicas),
            "stale_snapshots_dropped": sum(r.stale_snapshots_dropped
                                           for r in self.replicas),
            "snapshot_bytes": int(by_type.get("SnapshotMsg", 0)),
            "request_bytes": int(by_type.get("RequestMsg", 0)),
            "response_bytes": int(by_type.get("ResponseMsg", 0)),
            "batches": int(batches),
            "mean_batch": (round(sum(r.items_served for r in self.replicas)
                                 / batches, 3) if batches else None),
            "frontier_round": int(self.frontier),
            "replica_rounds": [int(r.round) for r in self.replicas],
        }


def _pct(arr: np.ndarray, q: float) -> Optional[float]:
    return round(float(np.percentile(arr, q)), 6) if arr.size else None


def _with_profile(cfg: ServeConfig, profile) -> ServeConfig:
    if cfg.request_profile is profile:
        return cfg
    import dataclasses
    return dataclasses.replace(cfg, request_profile=profile)
