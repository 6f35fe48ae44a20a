"""Decentralized sampling of active nodes (Alg. 1).

``Sampler`` is the per-node implementation: it derives the hashed candidate
order, optimistically pings the first ``s`` in parallel, then walks the tail
one-by-one for missing replies, retrying whole rounds while the network is
asynchronous. Completion is continuation-style (the simulator has no
blocking await): ``sample(k, s, cont)`` calls ``cont(live_nodes)`` once
``s`` live nodes replied (or all candidates were exhausted — see note).

A node can legitimately run *two* samples for the same round number at
once — e.g. as the trainer of round k it samples A^{k+1}, while as an
aggregator of round k+1 it samples S^{k+1}. Pending state is therefore
keyed by a unique token per ``sample()`` call, never by round number; a
Pong for round k (liveness evidence for that round) is routed to every
sample still waiting on k.

Deviation note: when fewer than ``s`` candidates exist at all (e.g. after
the Fig. 6 crash of 80 % of nodes with small populations), the paper's
Alg. 1 retries forever until membership recovers; we additionally resolve
with all live candidates if at least ``min_fraction`` of ``s`` replied after
a full pass, which matches the deployed behaviour described in §4.7 (rounds
continue with the 20 surviving nodes).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Set

from repro_torch.core import messages as M
from repro_torch.core.hashing import sample_order


@dataclass
class _PendingSample:
    token: int
    round_k: int
    size: int
    cont: Callable[[List[str]], None]
    order: List[str]
    replied: List[str] = field(default_factory=list)   # L[k], arrival order
    pinged: Set[str] = field(default_factory=set)
    handles: List[object] = field(default_factory=list)  # cancellable timers
    next_idx: int = 0
    done: bool = False
    retries: int = 0
    exclude: frozenset = frozenset()                   # failover blacklist


class Sampler:
    """One per node; owns Alg. 1 state. The node routes Pongs here."""

    MAX_RETRIES = 8          # sim guard for permanently-dead populations
    MIN_FRACTION = 0.5       # resolve with >= this fraction after exhaustion

    def __init__(self, node):
        self.node = node                 # needs .node_id .sim .net .candidates(k)
        self._tokens = itertools.count()
        self._pending: Dict[int, _PendingSample] = {}        # token -> state
        self._by_round: Dict[int, List[int]] = {}            # round -> tokens

    # -- public ---------------------------------------------------------------

    def sample(self, round_k: int, size: int,
               cont: Callable[[List[str]], None], *,
               exclude=(), _retries: int = 0) -> None:
        """``exclude`` drops specific candidates from this sample — the
        failover path re-samples A^{k+1} *without* the aggregators it
        already tried, otherwise the deterministic hash order would hand
        back the same (possibly wedged) node every time."""
        exclude = frozenset(exclude)
        state = getattr(self.node.net, "state", None)
        if state is not None and hasattr(self.node, "registry"):
            # Population-level memo: every node with the same membership
            # view derives the same hashed order (the point of Alg. 1),
            # so the candidate scan + sort runs once per (view, round)
            # equivalence class, not once per SAMPLE() call. Filtering
            # the cached order afterwards is equivalent to filtering the
            # candidates first: the hash order is a total order on node
            # ids, so dropping excluded entries preserves it exactly.
            order = state.sample_order_for(self.node, round_k)
            if exclude:
                order = [c for c in order if c not in exclude]
        else:
            cands = self.node.candidates(round_k)
            if exclude:
                cands = [c for c in cands if c not in exclude]
            order = sample_order(cands, round_k)
        st = _PendingSample(next(self._tokens), round_k, size, cont, order,
                            retries=_retries, exclude=exclude)
        self._pending[st.token] = st
        self._by_round.setdefault(round_k, []).append(st.token)
        if not order:
            self._retry_later(st)
            return
        # Optimistically ping the first s in parallel (Alg. 1, l.10-12).
        for j in order[:size]:
            self._ping(st, j)
        st.next_idx = min(size, len(order))
        self._after(st, self.node.timeout, lambda: self._deadline(st))

    def on_pong(self, round_k: int, j: str) -> None:
        for token in list(self._by_round.get(round_k, ())):
            st = self._pending.get(token)
            if st is None or st.done:
                continue
            if j not in st.replied:
                st.replied.append(j)                   # L[k].add(j)
            if len(st.replied) >= st.size:
                self._resolve(st)

    # -- internals --------------------------------------------------------------

    def _after(self, st: _PendingSample, delay: float,
               fn: Callable[[], None]) -> None:
        """Schedule a callback owned by one sample; it is cancelled (not
        just ignored) once the sample resolves."""
        st.handles.append(self.node.sim.schedule(delay, fn))

    def _finish(self, st: _PendingSample) -> None:
        st.done = True
        for h in st.handles:
            h.cancel()
        st.handles.clear()
        self._pending.pop(st.token, None)
        tokens = self._by_round.get(st.round_k)
        if tokens is not None:
            try:
                tokens.remove(st.token)
            except ValueError:
                pass
            if not tokens:
                del self._by_round[st.round_k]

    def _ping(self, st: _PendingSample, j: str) -> None:
        st.pinged.add(j)
        if j == self.node.node_id:
            # A node is trivially live to itself; the paper's nodes also
            # ping themselves (loopback), we short-circuit the wire.
            self._after(st, 0.0, lambda: self.on_pong(st.round_k, j))
            return
        self.node.net.send(self.node.node_id, j,
                           M.Ping(sender=self.node.node_id, round_k=st.round_k))

    def _deadline(self, st: _PendingSample) -> None:
        """Δt passed for the optimistic batch: walk the tail sequentially."""
        if st.done:
            return
        if len(st.replied) >= st.size:
            self._resolve(st)
            return
        self._advance(st)

    def _advance(self, st: _PendingSample) -> None:
        if st.done:
            return
        if len(st.replied) >= st.size:
            self._resolve(st)
            return
        if st.next_idx >= len(st.order):
            # Whole candidate list exhausted (Alg. 1 l.21 retries; see
            # module docstring for the small-population resolution rule).
            need = max(1, int(st.size * self.MIN_FRACTION))
            if len(st.replied) >= min(need, len(st.order)):
                self._resolve(st)
            else:
                self._retry_later(st)
            return
        j = st.order[st.next_idx]
        st.next_idx += 1
        if j in st.pinged:
            self._after(st, 0.0, lambda: self._advance(st))
            return
        self._ping(st, j)
        self._after(st, self.node.timeout, lambda: self._advance(st))

    def _retry_later(self, st: _PendingSample) -> None:
        st.retries += 1
        if st.retries > self.MAX_RETRIES:
            self._finish(st)
            st.cont(list(st.replied))                  # best effort
            return

        def again():
            if st.done:
                return
            self._finish(st)
            # the fresh state inherits the retry budget already burned
            self.sample(st.round_k, st.size, st.cont, exclude=st.exclude,
                        _retries=st.retries)

        self._after(st, self.node.timeout, again)

    def _resolve(self, st: _PendingSample) -> None:
        self._finish(st)
        st.cont(st.replied[:st.size])                  # L[k].HEAD(s)
