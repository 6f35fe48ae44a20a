"""Struct-of-arrays population state for the simulator hot path.

At paper scale and beyond (n = 10k..100k+) the
per-node Python objects became the bottleneck: node status, capacities
and training-time accounting were attribute reads scattered across the
heap, and every membership view carried O(n) dictionary state. This
module concentrates the population-wide hot state into contiguous numpy
arrays indexed by a dense integer row id:

* ``online`` — node status (node ``online`` attributes are properties
  over this array);
* ``uplink`` / ``downlink`` + ``cap_valid`` — the effective last-mile
  capacity cache (``Network.node_uplink``/``node_downlink`` resolve
  through here; overrides invalidate a row, not a dict entry);
* ``train_seconds`` — §4.5 training-resource accounting, written by the
  node property on every (partial) training;
* ``view_digest`` — per-node membership-view digests
  (``registry.digest ^ activity.digest``), refreshable in bulk for
  population-level convergence queries.

It also hosts the two population-level caches that make the protocol
layer O(changes) instead of O(n):

* :func:`population_view` — the single immutable base layer every node's
  ``Registry``/``ActivityTracker`` is stacked on (see those modules);
* :meth:`PopulationState.sample_order_for` — the Alg. 1 hashed candidate
  order memoized by ``(registry.digest, activity.digest, round)``:
  nodes with identical views (the common case — that is the point of
  Alg. 1) share one candidate scan + sort per round instead of one per
  ``SAMPLE()`` call.

Everything here is semantics-preserving by construction: the golden
trajectories in ``tests/test_determinism.py`` pin that a SoA-backed
session is byte-identical to the flat-object implementation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.activity import ActivityTracker
from repro_torch.core.hashing import sample_order
from repro_torch.core.registry import JOINED, Registry


def population_view(ids) -> Tuple[Registry, ActivityTracker]:
    """The out-of-band bootstrap view (§4.1) as one shared base layer:
    everyone registered with counter 1, activity 0. Nodes adopt it via
    ``bootstrap(ids, base=population_view(ids))`` — construction is O(n)
    for the whole session and each node's divergence lives in a small
    per-node delta."""
    ids = list(ids)
    reg = Registry.from_base({j: JOINED for j in ids},
                             {j: 1 for j in ids})
    act = ActivityTracker.from_base({j: 0 for j in ids})
    return reg, act


class PopulationState:
    """Dense-row arrays for one simulated population.

    Rows are assigned on first :meth:`ensure` in registration order, so
    a session's canonical ``"0".."n-1"`` ids map to rows ``0..n-1``.
    Arrays grow geometrically; node ids stay strings at the protocol
    layer (wire messages, registries) — only hot state is columnar.
    """

    _ORDER_MEMO_MAX = 1 << 14

    def __init__(self, capacity_hint: int = 0):
        cap = max(int(capacity_hint), 16)
        self.index: Dict[str, int] = {}
        self.ids: List[str] = []
        self.online = np.ones(cap, dtype=bool)
        self.uplink = np.zeros(cap, dtype=np.float64)
        self.downlink = np.zeros(cap, dtype=np.float64)
        self.cap_valid = np.zeros(cap, dtype=bool)
        self.train_seconds = np.zeros(cap, dtype=np.float64)
        self.view_digest = np.zeros(cap, dtype=np.uint64)
        # (registry digest, activity digest, round) -> hashed candidate order
        self._order_memo: Dict[tuple, list] = {}

    def __len__(self) -> int:
        return len(self.ids)

    def _grow(self, need: int) -> None:
        cap = max(need, 2 * len(self.online))
        for name in ("online", "uplink", "downlink", "cap_valid",
                     "train_seconds", "view_digest"):
            old = getattr(self, name)
            new = np.zeros(cap, dtype=old.dtype)
            if name == "online":
                new[:] = True
            new[: len(old)] = old
            setattr(self, name, new)

    def ensure(self, nid: str) -> int:
        """Row of ``nid``, assigning (and growing) on first sight."""
        row = self.index.get(nid)
        if row is None:
            row = self.index[nid] = len(self.ids)
            self.ids.append(nid)
            if row >= len(self.online):
                self._grow(row + 1)
        return row

    def row(self, nid: str) -> int:
        return self.index[nid]

    # ---- capacity cache ---------------------------------------------------

    def invalidate_capacity(self, nid: str) -> None:
        row = self.index.get(nid)
        if row is not None:
            self.cap_valid[row] = False

    # ---- membership-view digests ------------------------------------------

    def refresh_view_digests(self, nodes) -> np.ndarray:
        """Mirror each node's ``registry.digest ^ activity.digest`` into
        the ``view_digest`` column; returns the populated slice. One bulk
        pass (e.g. end-of-run convergence metrics), not a hot-path hook.
        ``nodes`` maps node id -> an object with registry/activity."""
        for nid, node in nodes.items():
            row = self.ensure(nid)
            self.view_digest[row] = np.uint64(
                (node.registry.digest ^ node.activity.digest)
                & 0xFFFFFFFFFFFFFFFF)
        return self.view_digest[: len(self.ids)]

    def distinct_views(self, nodes) -> int:
        """Number of distinct membership views across ``nodes``."""
        digests = self.refresh_view_digests(nodes)
        rows = [self.index[nid] for nid in nodes]
        return len(np.unique(digests[rows])) if rows else 0

    # ---- population-level sample-order memo -------------------------------

    def sample_order_for(self, node, round_k: int) -> list:
        """Alg. 1 hashed candidate order for ``node`` at ``round_k``,
        shared across every node whose (registry, activity) digests
        match. Callers must treat the result as immutable."""
        key = (node.registry.digest, node.activity.digest, round_k)
        order = self._order_memo.get(key)
        if order is None:
            if len(self._order_memo) >= self._ORDER_MEMO_MAX:
                for stale in [k for k in self._order_memo
                              if k[2] < round_k - 1]:
                    del self._order_memo[stale]
                if len(self._order_memo) >= self._ORDER_MEMO_MAX:
                    self._order_memo.clear()
            cands = node.candidates(round_k)
            order = self._order_memo[key] = sample_order(cands, round_k)
        return order
