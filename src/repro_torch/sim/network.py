"""WAN network model: latency matrix + shared bandwidth + byte accounting.

The paper replays WonderNetwork ping times between 227 cities; offline we
synthesize an equivalent geo-latency matrix (points on a sphere, great-
circle propagation delay + jitter) with the same 5–300 ms RTT range, and
assign nodes to cities round-robin exactly as in §4.2.

Capacity is modeled at flow level (see ``docs/NETWORK.md``): concurrent
transfers touching the same node *share* its uplink/downlink via max-min
fair allocation (progressive filling), so an aggregator receiving sf·s
models simultaneously no longer enjoys sf·s times its real downlink.
``contention=False`` restores the legacy per-flow ``min(uplink, downlink)``
semantics for A/B comparison.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np


def wan_latency_matrix(n_cities: int = 227, seed: int = 7) -> np.ndarray:
    """One-way latency (seconds) between synthetic cities."""
    rng = np.random.default_rng(seed)
    # Random points on the unit sphere.
    v = rng.normal(size=(n_cities, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    # Great-circle angle -> propagation delay. Earth half-circumference
    # ~20000 km at ~200 km/ms effective fiber speed ≈ 100 ms max one-way,
    # plus per-hop jitter and a 2 ms floor.
    ang = np.arccos(np.clip(v @ v.T, -1, 1))           # [0, pi]
    base = ang / np.pi * 0.100
    jitter = rng.uniform(0.002, 0.02, size=(n_cities, n_cities))
    lat = base + (jitter + jitter.T) / 2
    np.fill_diagonal(lat, 0.0005)
    return lat.astype(np.float64)


class _Flow:
    """One in-flight transfer: bytes remaining and its current fair rate."""

    __slots__ = ("src", "dst", "remaining", "rate", "deliver", "handle",
                 "t_last", "total")

    def __init__(self, src: str, dst: str, nbytes: float,
                 deliver: Callable[[], None], now: float):
        self.src = src
        self.dst = dst
        self.total = float(nbytes)
        self.remaining = float(nbytes)
        self.rate = 0.0
        self.deliver = deliver
        self.handle = None          # cancellable completion event
        self.t_last = now           # sim time `remaining` was last drained to


class Network:
    """Message fabric with latency + capacity delays and byte accounting.

    With ``contention=True`` (the default) every transfer of at least
    ``min_flow_bytes`` becomes a :class:`_Flow`; on each flow start/finish
    (and on :meth:`set_node_capacity`, :meth:`node_offline`) the max-min
    fair rates of the affected flows are recomputed and their completion
    events rescheduled. Reallocation walks only the connected component of
    the flow/resource graph touching the changed *node direction* (uplink
    and downlink are separate resources) — max-min allocations decompose
    over these components, so this is exact yet stays O(flows near the
    change) for the star-shaped traffic the protocol generates, and the
    direction-aware walk keeps an aggregator's fan-in from dragging its
    unrelated outgoing traffic into every recompute.

    Control messages below ``min_flow_bytes`` (pings, pongs, membership
    events) keep the closed-form delay: their transfer time at WAN rates is
    microseconds, and routing them through the scheduler would only burn
    simulator events without moving any completion time measurably.

    ``contention=False`` restores the legacy semantics where every flow
    gets the full ``min(uplink[src], downlink[dst])`` regardless of
    concurrency.

    ``contention="approx"`` keeps the exact progressive-filling path for
    small components but switches to a vectorized, level-capped
    approximate max-min fill once a component reaches
    ``approx_threshold`` flows (see :meth:`_fill_approx` and
    docs/SCALE.md). The exact path stays the default and stays
    golden-pinned — the approximation is strictly opt-in, the same
    zero-cost-by-default contract as ``engine="sequential"`` and
    ``fault=None``.
    """

    def __init__(self, sim, n_nodes: int, *, latency: Optional[np.ndarray] = None,
                 bandwidth: float = 20e6, uplink: Optional[np.ndarray] = None,
                 downlink: Optional[np.ndarray] = None,
                 city: Optional[np.ndarray] = None, seed: int = 0,
                 contention=True, min_flow_bytes: int = 4096,
                 approx_threshold: int = 64, approx_levels: int = 12):
        from repro_torch.sim.soa import PopulationState

        self.sim = sim
        self.bandwidth = bandwidth   # bytes/s (paper: WAN uplink)
        self.contention = contention
        self.min_flow_bytes = min_flow_bytes
        self.approx_threshold = approx_threshold
        self.approx_levels = approx_levels
        # struct-of-arrays hot state (status, capacity cache, train
        # accounting) shared with the session's nodes — see repro_torch.sim.soa
        self.state = PopulationState(n_nodes)
        self._uplink = None if uplink is None else np.asarray(uplink, float)
        self._downlink = (None if downlink is None
                          else np.asarray(downlink, float))
        lat = latency if latency is not None else wan_latency_matrix(seed=seed)
        cities = (np.asarray(city) if city is not None
                  else np.arange(n_nodes) % len(lat))  # round-robin (§4.2)
        self._lat = lat
        self._city = cities
        self.nodes: Dict[str, object] = {}
        # flow scheduler state — insertion-ordered flow sets (dict keys) so
        # reallocation order, and with it event tie-breaking, is
        # deterministic by construction rather than by object-id accident
        self._out: Dict[str, Dict[_Flow, None]] = defaultdict(dict)
        self._in: Dict[str, Dict[_Flow, None]] = defaultdict(dict)
        self._cap_override: Dict[str, tuple] = {}    # nid -> (up, down)
        self.flows_completed = 0
        self.flows_aborted = 0
        self.reallocations = 0
        self.approx_fills = 0        # reallocations served by _fill_approx
        # accounting
        self.bytes_out = defaultdict(int)
        self.bytes_in = defaultdict(int)
        self.bytes_by_type = defaultdict(int)
        self.msgs_by_type = defaultdict(int)

    _profile = None     # set by from_profile: the single source of truth
    fault = None        # set by sim.fault.FaultInjector; None = clean fabric

    @classmethod
    def from_profile(cls, sim, profile, *, contention=True,
                     min_flow_bytes: int = 4096,
                     approx_threshold: int = 64,
                     approx_levels: int = 12) -> "Network":
        """Build the fabric from a TraceProfile; latency and capacity
        queries delegate to the profile so the semantics live in one
        place (the raw-array constructor path remains for ad-hoc use)."""
        net = cls(sim, profile.n, latency=profile.latency,
                  uplink=profile.uplink, downlink=profile.downlink,
                  city=profile.city, seed=profile.seed,
                  contention=contention, min_flow_bytes=min_flow_bytes,
                  approx_threshold=approx_threshold,
                  approx_levels=approx_levels)
        net._profile = profile
        return net

    def register(self, node) -> None:
        self.nodes[node.node_id] = node
        self.state.ensure(node.node_id)

    def latency(self, src: str, dst: str) -> float:
        if self._profile is not None:
            return self._profile.pair_latency(src, dst)
        i = self._city[int(src) % len(self._city)]
        j = self._city[int(dst) % len(self._city)]
        return float(self._lat[i, j])

    def latency_matrix(self, ids) -> np.ndarray:
        """Pairwise one-way latency for ``ids`` as an array — the
        vectorized form of :meth:`latency` (same node→city mapping), for
        whole-population computations like FL-server selection."""
        if self._profile is not None:
            city = self._profile.city
            ci = city[[self._profile.node_index(i) for i in ids]]
            lat = self._profile.latency
        else:
            ci = np.asarray([self._city[int(i) % len(self._city)]
                             for i in ids])
            lat = self._lat
        return lat[np.ix_(ci, ci)].astype(np.float64)

    # ---- capacity queries -------------------------------------------------

    def node_uplink(self, nid: str) -> float:
        """Total upstream bytes/s of one node (shared by its outgoing
        flows). Cached in the SoA capacity columns; ``set_node_capacity``
        invalidates a row rather than a dict entry."""
        st = self.state
        row = st.index.get(nid)
        if row is None:
            row = st.ensure(nid)
        if not st.cap_valid[row]:
            st.uplink[row] = self._uplink_of(nid)
            st.downlink[row] = self._downlink_of(nid)
            st.cap_valid[row] = True
        return float(st.uplink[row])

    def node_downlink(self, nid: str) -> float:
        st = self.state
        row = st.index.get(nid)
        if row is None:
            row = st.ensure(nid)
        if not st.cap_valid[row]:
            st.uplink[row] = self._uplink_of(nid)
            st.downlink[row] = self._downlink_of(nid)
            st.cap_valid[row] = True
        return float(st.downlink[row])

    def _uplink_of(self, nid: str) -> float:
        ov = self._cap_override.get(nid)
        if ov is not None and ov[0] is not None:
            return ov[0]
        if self._profile is not None:
            return self._profile.node_uplink(nid)
        if self._uplink is not None:
            return float(self._uplink[int(nid) % len(self._uplink)])
        if self._downlink is not None:
            return float("inf")     # per-link mode: missing direction is free
        return self.bandwidth       # scalar mode: symmetric last-mile cap

    def _downlink_of(self, nid: str) -> float:
        ov = self._cap_override.get(nid)
        if ov is not None and ov[1] is not None:
            return ov[1]
        if self._profile is not None:
            return self._profile.node_downlink(nid)
        if self._downlink is not None:
            return float(self._downlink[int(nid) % len(self._downlink)])
        if self._uplink is not None:
            return float("inf")
        return self.bandwidth

    def link_capacity(self, src: str, dst: str) -> float:
        """Bytes/s available to one *uncontended* src→dst flow."""
        return min(self.node_uplink(src), self.node_downlink(dst))

    def transfer_time(self, src: str, dst: str, nbytes: int) -> float:
        """Uncontended transfer estimate (legacy formula; also the lower
        bound the fair-share scheduler converges to for a lone flow)."""
        return nbytes / self.link_capacity(src, dst)

    def set_node_capacity(self, nid: str, *, uplink: Optional[float] = None,
                          downlink: Optional[float] = None) -> None:
        """Trace-driven capacity change: override a node's last-mile caps
        from now on and refit every in-flight flow touching it. Pass None
        to leave a direction untouched (a previous override persists);
        use :meth:`clear_node_capacity` to drop back to the
        profile/array value."""
        old = self._cap_override.get(nid, (None, None))
        self._cap_override[nid] = (uplink if uplink is not None else old[0],
                                   downlink if downlink is not None else old[1])
        self.state.invalidate_capacity(nid)
        if self.contention:
            self._reallocate((("u", nid), ("d", nid)))

    def clear_node_capacity(self, nid: str) -> None:
        """Remove any :meth:`set_node_capacity` override, reverting the
        node to its profile/array capacity, and refit in-flight flows."""
        if self._cap_override.pop(nid, None) is not None:
            self.state.invalidate_capacity(nid)
            if self.contention:
                self._reallocate((("u", nid), ("d", nid)))

    # ---- sending ----------------------------------------------------------

    def send(self, src: str, dst: str, msg) -> None:
        size = msg.size_bytes()
        self.bytes_out[src] += size
        self.bytes_by_type[type(msg).__name__] += size
        self.msgs_by_type[type(msg).__name__] += 1
        node = self.nodes.get(dst)
        if node is None:
            return

        def deliver():
            n = self.nodes.get(dst)
            if n is None or not n.online:
                return                       # crashed/unresponsive: dropped
            self.bytes_in[dst] += size
            n.receive(msg)

        lat = self.latency(src, dst)
        if self.fault is None or src == dst:
            # Clean fabric (and loopback, which never traverses the WAN
            # and is exempt from link faults): the exact pre-fault path,
            # so fault=None sessions stay byte-identical by construction.
            self._dispatch(src, dst, msg, size, lat, deliver)
            return
        for i, fault_lat in enumerate(self.fault.transit(src, dst, msg, lat)):
            if i:
                # spurious retransmission: the duplicate is real traffic
                # and the sender pays for it again; a duplicated *model*
                # is still payload, not protocol overhead, so mirror the
                # account_payload() the sender made for the first copy
                self.bytes_out[src] += size
                self.bytes_by_type[type(msg).__name__] += size
                self.msgs_by_type[type(msg).__name__] += 1
                model = getattr(msg, "model", None)
                if model is not None:
                    self._payload_bytes += model.size_bytes()
            self._dispatch(src, dst, msg, size, fault_lat, deliver)

    def _dispatch(self, src: str, dst: str, msg, size: int, lat: float,
                  deliver: Callable[[], None]) -> None:
        """Schedule one copy of a message with one-way latency ``lat``."""
        if self.contention and src == dst:
            # Loopback (a node sampled into its own S^k hands the model to
            # itself): never traverses the last mile, so it must not steal
            # max-min share from the node's genuine WAN fan-in/fan-out.
            self.sim.schedule(lat, deliver)
            return
        if not self.contention or size < self.min_flow_bytes:
            self.sim.schedule(lat + self.transfer_time(src, dst, size),
                              deliver)
            return
        # Propagation delay first, then the payload occupies the links.
        self.sim.schedule(lat, lambda: self._start_flow(src, dst, size,
                                                        deliver))

    # ---- flow scheduler ---------------------------------------------------

    def _start_flow(self, src, dst, nbytes, deliver) -> None:
        # A transfer can't start against a dead endpoint (connection
        # refused / sender process gone). Without this check, payloads
        # launched into a crash window would become ghost flows that
        # throttle survivors' shared links for their full duration —
        # the legacy formula never charged these doomed sends anywhere.
        for nid in (src, dst):
            n = self.nodes.get(nid)
            if n is not None and not n.online:
                self.flows_aborted += 1
                return
        # A payload launched just before a partition cut must not sneak
        # through: its flow would start *inside* the window (transit() was
        # consulted at send time, before the cut existed).
        if self.fault is not None and self.fault.severed(src, dst):
            self.flows_aborted += 1
            return
        f = _Flow(src, dst, nbytes, deliver, self.sim.now)
        self._out[src][f] = None
        self._in[dst][f] = None
        self._reallocate((("u", src), ("d", dst)), seed_flows=(f,))

    def _remove_flow(self, f: _Flow) -> None:
        self._out[f.src].pop(f, None)
        self._in[f.dst].pop(f, None)
        if f.handle is not None:
            f.handle.cancel()
            f.handle = None

    def _complete(self, f: _Flow) -> None:
        f.handle = None
        self._remove_flow(f)
        self.flows_completed += 1
        f.deliver()
        self._reallocate((("u", f.src), ("d", f.dst)))

    def node_offline(self, nid: str) -> None:
        """A node crashed: its in-flight transfers (both directions) die
        with it and their capacity is immediately handed back to survivors.
        Idempotent; a no-op under ``contention=False`` where the legacy
        drop-at-delivery rule already applies."""
        if not self.contention:
            return
        doomed = list(self._out.get(nid, ())) + list(self._in.get(nid, ()))
        if not doomed:
            return
        seeds = []
        for f in doomed:
            self._remove_flow(f)
            self.flows_aborted += 1
            seeds.extend((("u", f.src), ("d", f.dst)))
        self._reallocate(seeds)

    def abort_flows(self, pred: Callable[[str, str], bool]) -> int:
        """Abort every in-flight flow whose ``(src, dst)`` satisfies
        ``pred`` — e.g. transfers crossing a network partition cut — and
        hand their capacity back to the surviving flows. Returns the
        number of flows killed. No-op under ``contention=False`` (there
        are no flows to kill; delivery-time checks still apply)."""
        if not self.contention:
            return 0
        doomed = [f for fs in self._out.values() for f in fs
                  if pred(f.src, f.dst)]
        if not doomed:
            return 0
        seeds = []
        now = self.sim.now
        for f in doomed:
            # The receiver is alive — it really did take delivery of the
            # bytes streamed up to the cut, so they count toward its
            # ingress (unlike node_offline, where the receiving process
            # died and nothing past the kernel buffer was ever consumed).
            if f.rate > 0.0 and now > f.t_last:
                f.remaining = max(0.0, f.remaining - f.rate * (now - f.t_last))
                f.t_last = now
            self.bytes_in[f.dst] += int(f.total - f.remaining)
            self._remove_flow(f)
            self.flows_aborted += 1
            seeds.extend((("u", f.src), ("d", f.dst)))
        self._reallocate(seeds)
        return len(doomed)

    def _component(self, seed_resources, seed_flows=()):
        """Flows coupled (directly or transitively) to the seeds, walking
        the bipartite flow/resource graph where a resource is one *node
        direction* — ("u", nid) uplink or ("d", nid) downlink. Max-min
        allocations decompose over these components, and the direction-
        aware walk is strictly tighter than a node-level walk: an
        aggregator's fan-in no longer drags its unrelated outgoing flows
        (and everything transitively behind them) into every reallocation.
        Resources with infinite capacity never bind, hence never couple —
        they are not expanded (seed resources always are: a capacity
        override may have just *become* infinite and its flows still need
        refitting). ``seed_flows`` are included unconditionally (a newly
        started flow must get a rate even if nothing constrains it)."""
        flows: Dict[_Flow, None] = {}
        stack: list = []
        seen = set()

        def add_flow(f: _Flow) -> None:
            if f not in flows:
                flows[f] = None
                for r in (("u", f.src), ("d", f.dst)):
                    if r not in seen:
                        stack.append(r)

        for f in seed_flows:
            add_flow(f)
        for r in seed_resources:
            if r not in seen:
                seen.add(r)
                side = self._out if r[0] == "u" else self._in
                for f in side.get(r[1], ()):
                    add_flow(f)
        while stack:
            r = stack.pop()
            if r in seen:
                continue
            seen.add(r)
            d, nid = r
            cap = (self.node_uplink(nid) if d == "u"
                   else self.node_downlink(nid))
            if not math.isfinite(cap):
                continue
            side = self._out if d == "u" else self._in
            for f in side.get(nid, ()):
                add_flow(f)
        return list(flows)

    def _reallocate(self, seed_resources, seed_flows=()) -> None:
        """Recompute fair rates over the affected component, then
        reschedule every completion event. The fill itself is either the
        exact progressive-filling pass (:meth:`_fill_exact`, default) or
        — under ``contention="approx"`` for components of at least
        ``approx_threshold`` flows — the level-capped vectorized
        approximation (:meth:`_fill_approx`)."""
        flows = self._component(seed_resources, seed_flows)
        if not flows:
            return
        self.reallocations += 1
        now = self.sim.now
        old_rate = []
        for f in flows:                       # drain progress at old rates
            if f.rate > 0.0 and now > f.t_last:
                f.remaining = max(0.0, f.remaining - f.rate * (now - f.t_last))
            f.t_last = now
            old_rate.append(f.rate)
        if (self.contention == "approx"
                and len(flows) >= self.approx_threshold):
            self.approx_fills += 1
            self._fill_approx(flows)
        else:
            self._fill_exact(flows)
        for f, old in zip(flows, old_rate):
            if f.rate == old and f.handle is not None:
                continue       # unchanged rate: the old event is still right
            if f.handle is not None:
                f.handle.cancel()
            eta = (0.0 if not math.isfinite(f.rate)
                   else f.remaining / f.rate if f.rate > 0.0 else None)
            f.handle = (None if eta is None
                        else self.sim.schedule(eta,
                                               lambda f=f: self._complete(f)))

    def _fill_exact(self, flows) -> None:
        """Progressive filling (exact max-min fair share): repeatedly find
        the most-loaded resource (a node's up or down direction), freeze
        its flows at the equal share, give leftover capacity back, repeat."""
        # resources: ("u", node) = uplink, ("d", node) = downlink
        cap: Dict[tuple, float] = {}
        users: Dict[tuple, list] = {}
        for f in flows:
            ru = ("u", f.src)
            if ru not in cap:
                up = self.node_uplink(f.src)
                if math.isfinite(up):
                    cap[ru] = up
                    users[ru] = [f]
            elif ru in users:
                users[ru].append(f)
            rd = ("d", f.dst)
            if rd not in cap:
                down = self.node_downlink(f.dst)
                if math.isfinite(down):
                    cap[rd] = down
                    users[rd] = [f]
            elif rd in users:
                users[rd].append(f)
        unfrozen = dict.fromkeys(flows)
        while unfrozen:
            shares = [(cap[r] / live, r) for r, fs in users.items()
                      if (live := sum(1 for f in fs if f in unfrozen))]
            if not shares:                    # no finite resource binds
                for f in unfrozen:
                    f.rate = math.inf
                break
            best = min(s for s, _ in shares)
            share = max(best, 0.0)
            # Freeze every resource tied (to fp tolerance) with the
            # bottleneck in the same pass: exactly-tied symmetric caps
            # would otherwise leave an ulp-negative residual behind and
            # strand the residual's flows at rate 0 — a silent hang.
            for _, r in [p for p in shares
                         if p[0] <= best + 1e-9 * max(abs(best), 1.0)]:
                for f in users[r]:
                    if f not in unfrozen:
                        continue
                    f.rate = share
                    del unfrozen[f]
                    other = ("d", f.dst) if r[0] == "u" else ("u", f.src)
                    if other in cap and other != r:
                        cap[other] = max(0.0, cap[other] - share)

    def _fill_approx(self, flows) -> None:
        """Level-capped vectorized max-min: run at most ``approx_levels``
        progressive-filling passes with numpy bincounts instead of the
        per-flow Python loop, then give every still-unfrozen flow its
        locally safe share ``min_r cap_r / live_r``.

        Properties (tested in ``tests/test_network_invariants.py``):

        * identical (up to float association) to the exact fill whenever
          the component has at most ``approx_levels`` distinct bottleneck
          levels — star-shaped protocol traffic typically has 1–3;
        * always feasible: per-resource rate sums never exceed capacity,
          because the tail assignment splits each resource's *remaining*
          capacity over its remaining users;
        * never strands a flow at rate 0: remaining capacity stays
          positive for any resource with live users (same tie-tolerance
          freeze as the exact pass), and tail rates inherit that;
        * conservative: tail rates are never above the exact max-min
          rates, so approximate completions are never early beyond float
          noise — the documented ε is on throughput given up, not
          capacity violated.
        """
        F = len(flows)
        # resource table: finite node-directions touched by the component
        res_index: Dict[tuple, int] = {}
        caps: list = []
        u_idx = np.empty(F, dtype=np.int64)
        d_idx = np.empty(F, dtype=np.int64)
        for i, f in enumerate(flows):
            for arr, r, capf in ((u_idx, ("u", f.src), self.node_uplink),
                                 (d_idx, ("d", f.dst), self.node_downlink)):
                ri = res_index.get(r)
                if ri is None:
                    c = capf(r[1])
                    if math.isfinite(c):
                        ri = res_index[r] = len(caps)
                        caps.append(c)
                    else:
                        ri = -1
                        res_index[r] = -1
                arr[i] = ri
        R = len(caps)
        rate = np.zeros(F)
        frozen = np.zeros(F, dtype=bool)
        if R == 0:
            rate[:] = math.inf
        else:
            cap = np.asarray(caps, dtype=np.float64)
            has_u, has_d = u_idx >= 0, d_idx >= 0
            for _ in range(self.approx_levels):
                live = ~frozen
                cnt = (np.bincount(u_idx[live & has_u], minlength=R)
                       + np.bincount(d_idx[live & has_d], minlength=R))
                binding = cnt > 0
                if not binding.any():
                    rate[live] = math.inf     # no finite resource binds
                    frozen[:] = True
                    break
                share_r = np.full(R, math.inf)
                share_r[binding] = cap[binding] / cnt[binding]
                best = share_r.min()
                tol = best + 1e-9 * max(abs(best), 1.0)
                tied = share_r <= tol
                newly = live & ((has_u & tied[np.maximum(u_idx, 0)])
                                | (has_d & tied[np.maximum(d_idx, 0)]))
                share = max(best, 0.0)
                rate[newly] = share
                cap = np.maximum(
                    0.0,
                    cap - share * (
                        np.bincount(u_idx[newly & has_u], minlength=R)
                        + np.bincount(d_idx[newly & has_d], minlength=R)))
                frozen |= newly
                if frozen.all():
                    break
            tail = ~frozen
            if tail.any():
                # split each resource's remaining capacity over its
                # remaining users — feasible by construction
                live_cnt = (np.bincount(u_idx[tail & has_u], minlength=R)
                            + np.bincount(d_idx[tail & has_d], minlength=R))
                safe = np.full(R, math.inf)
                nz = live_cnt > 0
                safe[nz] = cap[nz] / live_cnt[nz]
                t_rate = np.full(F, math.inf)
                iu = tail & has_u
                t_rate[iu] = np.minimum(t_rate[iu], safe[u_idx[iu]])
                idn = tail & has_d
                t_rate[idn] = np.minimum(t_rate[idn], safe[d_idx[idn]])
                rate[tail] = t_rate[tail]
        for i, f in enumerate(flows):
            f.rate = float(rate[i])

    @property
    def active_flows(self) -> int:
        return sum(len(s) for s in self._out.values())

    # ---- Table-4 style summaries -----------------------------------------

    def usage_summary(self) -> dict:
        # Paper Table 4 counts incoming+outgoing per node; "Total" sums that
        # over nodes (hence the FedAvg server's Max ≈ 50% of Total).
        per_node = {nid: self.bytes_out[nid] + self.bytes_in[nid]
                    for nid in self.nodes}
        vals = list(per_node.values()) or [0]
        return {
            "total_bytes": int(sum(self.bytes_out.values())
                               + sum(self.bytes_in.values())),
            "sent_bytes": int(sum(self.bytes_out.values())),
            "min_node_bytes": int(min(vals)),
            "max_node_bytes": int(max(vals)),
            "by_type": dict(self.bytes_by_type),
            "msgs_by_type": dict(self.msgs_by_type),
        }

    def overhead_fraction(self) -> float:
        """MoDeST overhead = all bytes beyond raw model payloads (Table 4
        bottom): views, pings/pongs, join/left and framing."""
        total = sum(self.bytes_by_type.values())
        return (total - self._payload_bytes) / total if total else 0.0

    _payload_bytes: int = 0

    def account_payload(self, nbytes: int) -> None:
        """Called by the transport for every raw model payload sent."""
        self._payload_bytes += nbytes
