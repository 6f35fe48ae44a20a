"""Session drivers: MoDeST, FedAvg (emulated per §4.3) and D-SGD baselines.

Each session wires a population of nodes to the simulator + network, runs
the protocol for a simulated duration, and collects:

* ``history`` — (sim_time, round, metrics) model-quality curve
* ``round_times`` — completion time per round
* ``sample_durations`` — SAMPLE() latency (Fig. 6 bottom)
* ``network.usage_summary()`` — Table 4 byte accounting
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.core import messages as M
from repro_torch.core.hashing import sample_order
from repro_torch.core.node import ModestNode
from repro_torch.core.tasks import AbstractTask, LearningTask
from repro_torch.data.loader import FederatedData
from repro_torch.engine.cohort import make_engine
from repro_torch.serve import ServingFabric
from repro_torch.sim.churn import AvailabilityDriver
from repro_torch.sim.clock import Simulator
from repro_torch.sim.fault import FaultInjector
from repro_torch.sim.network import Network
from repro_torch.sim.soa import population_view


def _fault_setup(session, fault):
    """Bind a FaultSchedule to a session (None = clean fabric, which keeps
    the pre-fault network code path byte-for-byte)."""
    return None if fault is None else FaultInjector(fault, session)


def _serve_setup(session, serve, speeds, seed):
    """Attach a serving deployment (None = no fabric at all: no replica or
    client endpoints, no events, no RNG draws — the golden trajectories
    stay byte-identical by construction)."""
    if serve is None:
        return None
    return ServingFabric(session, serve, speeds, seed)


def _speeds(n: int, seed: int, base: float = 0.05, spread: float = 3.0):
    """Heterogeneous per-node seconds-per-batch (stragglers exist)."""
    rng = np.random.default_rng(seed + 1234)
    return base * rng.uniform(1.0, spread, size=n)


def _net_and_speeds(sim, n_nodes: int, profile, bandwidth: float, seed: int,
                    contention: bool = True):
    """Fabric + per-node speeds: from the TraceProfile when given, else the
    legacy uniform-random regime with a symmetric bandwidth scalar."""
    if profile is None:
        return (Network(sim, n_nodes, bandwidth=bandwidth, seed=seed,
                        contention=contention),
                _speeds(n_nodes, seed))
    if n_nodes > profile.n:
        raise ValueError(f"profile covers {profile.n} nodes, session wants "
                         f"{n_nodes}")
    return (Network.from_profile(sim, profile, contention=contention),
            np.asarray(profile.speeds, float))


def _profile_defaults(profile, n_nodes, task, extra_required=()):
    """(n_nodes, task) defaulted from the profile; without one, every listed
    argument is required and the TypeError names the missing ones."""
    if profile is None:
        needed = {"n_nodes": n_nodes, "task": task, **dict(extra_required)}
        missing = [k for k, v in needed.items() if v is None]
        if missing:
            raise TypeError("without profile=, required: "
                            + ", ".join(missing))
        return n_nodes, task
    return (n_nodes or profile.n,
            task or AbstractTask(model_bytes_=346_000))


def _churn_setup(sim, profile, enabled: bool, ids, on_offline, on_online,
                 network=None):
    """(driver, initially-offline ids); (None, ()) when churn is off.

    The offline ids come back as a *list* in node-id order, never a set:
    callers iterate it to flip status flags, and set iteration order over
    str ids is PYTHONHASHSEED-dependent (the DL003 lint hazard) — today
    those writes are commutative, but the iteration order must not be one
    refactor away from leaking into event scheduling."""
    if profile is None or not enabled:
        return None, []
    driver = AvailabilityDriver(sim, profile, ids,
                                on_offline=on_offline, on_online=on_online,
                                network=network)
    return driver, driver.initially_offline()


@dataclass
class SessionResult:
    history: List[dict] = field(default_factory=list)
    round_times: List[tuple] = field(default_factory=list)
    sample_durations: List[tuple] = field(default_factory=list)
    usage: dict = field(default_factory=dict)
    overhead_fraction: float = 0.0
    rounds_completed: int = 0
    final_metrics: dict = field(default_factory=dict)
    churn_events: int = 0             # availability transitions fired
    fault_stats: Dict[str, int] = field(default_factory=dict)  # injections
    # training resources (paper §4.5): node-seconds of on-device compute,
    # including compute burned by trainings that were cancelled/crashed
    train_node_seconds: float = 0.0
    trainings_completed: int = 0
    # query-plane summary (repro_torch.serve); None unless the
    # session ran with a serve= deployment attached
    serving: Optional[dict] = None

    def metric_curve(self, key: str):
        return [(h["t"], h[key]) for h in self.history if key in h]

    def round_intervals(self) -> List[float]:
        ts = [t for t, _ in self.round_times]
        return [b - a for a, b in zip(ts, ts[1:])]


class ModestSession:
    """Full MoDeST session (the paper's system).

    Heterogeneity comes from either the legacy knobs (``bandwidth`` scalar
    + uniform-random speeds) or a :class:`~repro_torch.traces.TraceProfile`
    passed as ``profile=``: per-node speeds, per-link capacity, and —
    unless ``churn_from_profile=False`` — automatic churn, with nodes
    crashing when their availability trace goes offline and rejoining via
    Alg. 2 when it comes back. With a profile, ``n_nodes``/``mcfg``/
    ``tcfg``/``task`` become optional (sized from the profile).

    ``engine`` selects the compute path: ``"batched"`` (one stacked
    flat-model batch per sampled cohort — default for tasks that support
    it, i.e. :class:`~repro_torch.models.tasks.TorchTask`), ``"sharded"``
    (the batched engine with its aggregations split over the local cards;
    falls back to batched on one card or the CPU), ``"sequential"``
    (per-node reference path), or None for auto. Event semantics are
    identical either way — per-node train durations still come from the
    cost model; only wall-clock changes.

    ``device``: where the session computes; None means the card (and
    raises without one), ``"cpu"`` the CPU. The task must live there.

    ``serve`` attaches a :class:`~repro_torch.serve.ServeConfig`
    deployment: completed rounds fan out as snapshots to serving replicas
    and query traffic is answered alongside training on the same fabric.
    ``None`` (default) builds no serving state at all.

    ``mcfg.secure_agg="masked"`` turns on pairwise-mask secure aggregation
    (``repro_torch.secureagg``): trainers seal their models before pushing
    and aggregators unmask and aggregate in one fused kernel.
    """

    def __init__(self, *, n_nodes: Optional[int] = None,
                 mcfg: Optional[ModestConfig] = None,
                 tcfg: Optional[TrainConfig] = None,
                 task: Optional[LearningTask] = None,
                 data: Optional[FederatedData] = None,
                 bandwidth: float = 20e6, seed: int = 0,
                 eval_every_rounds: int = 10,
                 fixed_aggregator: bool = False,
                 profile=None, churn_from_profile: bool = True,
                 contention: bool = True,
                 engine: Optional[str] = None,
                 fault=None, serve=None, device=None):
        n_nodes, task = _profile_defaults(profile, n_nodes, task,
                                          extra_required=(("mcfg", mcfg),))
        # Churny regimes need sf < 1 to keep rounds moving when sampled
        # trainers drop mid-round (paper Table 2 explores exactly this).
        mcfg = mcfg or ModestConfig(n_nodes=n_nodes, success_fraction=0.8,
                                    ping_timeout=1.0)
        tcfg = tcfg or TrainConfig()
        self.sim = Simulator()
        self.net, speeds = _net_and_speeds(self.sim, n_nodes, profile,
                                           bandwidth, seed, contention)
        # Bound before any protocol traffic so even the round-1 bootstrap
        # (which pings under fixed_aggregator) goes through the fabric.
        self.fault_injector = _fault_setup(self, fault)
        self.mcfg, self.tcfg, self.task = mcfg, tcfg, task
        self.engine = make_engine(engine, task, device=device)
        self.eval_every = eval_every_rounds
        self.data = data
        self.result = SessionResult()
        self._latest_round_seen = 0
        self._eval_models: Dict[int, object] = {}
        self.profile = profile
        # Uniform RNG threading (docs/ANALYSIS.md DL001): every stream the
        # session consumes is derived from the session seed with a fixed
        # offset, so (seed, schedule) -> trajectory stays a pure function.
        self._churn_rng = np.random.default_rng(seed + 5678)
        self._join_rng = np.random.default_rng(seed + 9012)

        ids = [str(i) for i in range(n_nodes)]
        # insertion-ordered (dict, not set): this collection is iterated
        # below, and iteration order must be deterministic by construction
        # (docs/ANALYSIS.md DL003), not by the accident of str hashing
        offline_now: Dict[str, None] = {}
        if profile is not None and churn_from_profile:
            offline_now = {nid: None for nid in ids
                           if not profile.timeline(nid).is_online(0.0)}
        fixed_id = None
        if fixed_aggregator:
            # The FL server must be online when round 1 bootstraps: prefer
            # nodes online at t=0, else the earliest-returning ones.
            cand = [i for i in ids if i not in offline_now]
            if not cand and profile is not None:
                first = {i: profile.timeline(i).next_online(0.0) for i in ids}
                t_min = min(first.values())
                if math.isfinite(t_min):
                    cand = [i for i in ids if first[i] == t_min]
            fixed_id = self._best_connected(cand or ids)
        # The FL server is infrastructure (§4.3, highly available): exempt
        # it from trace churn — a synchronous FL baseline with a flickering
        # server wedges forever, which is not the comparison the paper runs.
        self.churn_driver, _ = _churn_setup(
            self.sim, profile, churn_from_profile,
            [i for i in ids if i != fixed_id],
            self._trace_offline, self._trace_online, network=self.net)
        offline_now.pop(fixed_id, None)
        # One shared bootstrap view, adopted copy-on-write by every node:
        # a single immutable base layer (repro_torch.sim.soa.population_view)
        # under per-node deltas, so construction is O(n) and a node's
        # first post-snapshot mutation copies O(delta), not O(n).
        base_reg, base_act = population_view(ids)
        self.nodes: Dict[str, ModestNode] = {}
        for i, nid in enumerate(ids):
            node = ModestNode(
                nid, self.sim, self.net, mcfg, tcfg, task,
                data=data.clients[i % len(data.clients)] if data else None,
                train_speed=float(speeds[i]),
                on_aggregate=self._on_aggregate,
                fixed_aggregator=fixed_id,
                engine=self.engine)
            node.bootstrap(ids, base=(base_reg, base_act))
            self.nodes[nid] = node
        for nid in offline_now:
            self.nodes[nid].online = False

        # Serving rides on the same network fabric; built before the
        # round-1 bootstrap so the bootstrap aggregation (which may
        # complete round 1 synchronously under fixed_aggregator) already
        # publishes its snapshot.
        self.serving = _serve_setup(self, serve, speeds, seed)

        # Round-1 bootstrap: nodes that find themselves in S^1 self-activate
        # (only nodes whose trace says they are online at t=0 qualify). When
        # the whole population is trace-offline at t=0 (e.g. lockstep diurnal
        # phases), the bootstrap is deferred to the earliest online moment —
        # rejoin alone advertises membership but never starts a round.
        init = task.init_params(tcfg.seed) if data is not None else None
        self._fixed_id = fixed_id
        if len(offline_now) == len(ids):
            t_star = min(profile.timeline(nid).next_online(0.0)
                         for nid in ids)
            if math.isfinite(t_star):
                self.sim.schedule(t_star,
                                  lambda: self._bootstrap_round1(init))
        else:
            self._bootstrap_round1(init)

    def _bootstrap_round1(self, init) -> None:
        ids = list(self.nodes)
        online = [nid for nid in sample_order(ids, 1)
                  if (self.profile is None or self.churn_driver is None
                      or self.profile.timeline(nid).is_online(self.sim.now))]
        if self._fixed_id is not None:
            # FL emulation: the fixed server aggregates; participants of S^1
            # are chosen by it. Server bootstraps the round by "aggregating"
            # the initial model once.
            server = self.nodes[self._fixed_id]
            server.recover()
            payload = (M.ModelPayload(params=init) if init is not None
                       else M.ModelPayload(nbytes=self.task.model_bytes()))
            server.k_agg = 1
            server._theta_list = [payload]
            server._theta_from = [server.node_id]
            server._do_aggregate(1)
        else:
            cohort = online[:self.mcfg.sample_size]
            # Secure mode: S^1 is the mask roster of the bootstrap round.
            roster = tuple(cohort) if self.mcfg.secure_agg else ()
            for nid in cohort:
                node = self.nodes[nid]
                node.recover()              # deferred case: trace says online
                node.self_activate(1, init, roster=roster)

    # ------------------------------------------------------------------ hooks

    def _best_connected(self, ids) -> str:
        """§4.3: the FL server = node with lowest median latency to others.

        Vectorized over the latency matrix: the per-pair python loop was
        O(n²) ``latency()`` calls, several seconds of setup at n = 1000.
        """
        if len(ids) == 1:
            return ids[0]
        m = self.net.latency_matrix(ids)
        np.fill_diagonal(m, np.nan)
        med = np.nanmedian(m, axis=1)
        return ids[int(np.argmin(med))]

    def _on_aggregate(self, k: int, params, node: ModestNode) -> None:
        now = self.sim.now
        if k > self._latest_round_seen:
            self._latest_round_seen = k
            self.result.round_times.append((now, k))
            if params is not None and (k % self.eval_every == 0 or k == 1):
                self._eval_models[k] = params
            elif params is None and (k % self.eval_every == 0 or k == 1):
                self.result.history.append({"t": now, "round": k})
            if self.serving is not None:
                self.serving.on_round(k, params, node.node_id)

    # ------------------------------------------------------------------- churn

    def _trace_offline(self, nid: str) -> None:
        node = self.nodes.get(nid)
        if node is not None:
            node.crash()
            # stop the engine from plan-ahead-training an offline node
            self.engine.register_client(nid, None)

    def _trace_online(self, nid: str) -> None:
        """Trace came back: recover and rejoin through Alg. 2 — the node
        advertises a Joined event to s random bootstrap peers."""
        node = self.nodes.get(nid)
        if node is None or node.online:
            return
        node.recover()
        if node.data is not None:
            self.engine.register_client(nid, node.data)
        # Uniform peer draw without materializing the O(n) peers list:
        # numpy's choice over an int population consumes the rng stream
        # identically to choice over the equivalent list, so drawing row
        # indices and skipping self reproduces the legacy selection
        # byte-for-byte (pinned by the golden trajectories).
        ids, pos = self._peer_index()
        i = pos.get(nid)
        m = len(ids) - (1 if i is not None else 0)
        if m > 0:
            k = min(self.mcfg.sample_size, m)
            drawn = self._churn_rng.choice(m, size=k, replace=False)
            sel = [ids[j] if i is None or j < i else ids[j + 1]
                   for j in drawn]
            node.request_join(sel)
        node._last_active_t = self.sim.now

    def _peer_index(self):
        """(ids list, id -> position) over the current population; nodes
        are only ever added, so the cache is refreshed by length check."""
        cached = getattr(self, "_peer_cache", None)
        if cached is None or cached[2] != len(self.nodes):
            ids = list(self.nodes)
            cached = self._peer_cache = (
                ids, {j: i for i, j in enumerate(ids)}, len(ids))
        return cached[0], cached[1]

    def schedule_join(self, at: float, node_id: str, *, data_idx: int = 0) -> None:
        def do_join():
            node = ModestNode(
                node_id, self.sim, self.net, self.mcfg, self.tcfg, self.task,
                data=self.data.clients[data_idx % len(self.data.clients)]
                if self.data else None,
                train_speed=0.05, on_aggregate=self._on_aggregate,
                engine=self.engine)
            # A joiner knows only its bootstrap peers (Alg. 2 Require),
            # drawn from the session-owned join stream — not an ad-hoc
            # default_rng(len(node_id)), which tied the draw to the id's
            # *length* instead of the session seed and made two different
            # joiners with same-length names pick identical peers.
            peers = list(self._join_rng.choice(
                [n for n in self.nodes], size=min(self.mcfg.sample_size,
                                                  len(self.nodes)),
                replace=False))
            self.nodes[node_id] = node
            node.request_join(peers)

        self.sim.schedule(at - self.sim.now, do_join)

    def schedule_crash(self, at: float, node_id: str) -> None:
        self.sim.schedule(at - self.sim.now,
                          lambda: self.nodes[node_id].crash())

    def schedule_leave(self, at: float, node_id: str) -> None:
        def do_leave():
            node = self.nodes[node_id]
            peers = [n for n in self.nodes if n != node_id][: self.mcfg.sample_size]
            node.request_leave(peers)

        self.sim.schedule(at - self.sim.now, do_leave)

    # --------------------------------------------------------------------- run

    def run(self, duration: float) -> SessionResult:
        if self.churn_driver is not None:
            self.churn_driver.install(duration)
        if self.fault_injector is not None:
            self.fault_injector.install(duration)
        if self.serving is not None:
            self.serving.install(duration)
        self.sim.run(until=duration)
        if self.churn_driver is not None:
            self.result.churn_events = self.churn_driver.events_fired
        if self.fault_injector is not None:
            self.result.fault_stats = dict(self.fault_injector.stats)
        if self.serving is not None:
            self.result.serving = self.serving.summary()
        # Evaluate collected models (lazily, once, at the end — evaluation
        # does not consume simulated time, matching §4.2). One stacked
        # sweep over all snapshots for tasks that support it.
        if self.data is not None and self.data.test is not None:
            pending = [(t, k) for (t, k) in self.result.round_times
                       if k in self._eval_models]
            metrics = self.engine.evaluate_models(
                [self._eval_models[k] for _, k in pending], self.data.test)
            for (t, k), m in zip(pending, metrics):
                self.result.history.append({"t": t, "round": k, **m})
        self.result.history.sort(key=lambda h: h["t"])
        self.result.usage = self.net.usage_summary()
        self.result.overhead_fraction = self.net.overhead_fraction()
        self.result.rounds_completed = self._latest_round_seen
        for node in self.nodes.values():
            self.result.sample_durations.extend(node.sample_durations)
            self.result.train_node_seconds += node.train_seconds
            self.result.trainings_completed += node.trainings_completed
        self.result.sample_durations.sort()
        if self.result.history:
            self.result.final_metrics = {
                k: v for k, v in self.result.history[-1].items()
                if k not in ("t", "round")}
        return self.result


# ---------------------------------------------------------------------------
# D-SGD baseline (§4.3): one-peer exponential graph, synchronous rounds.
# ---------------------------------------------------------------------------


class _SoANodeMixin:
    """Baseline nodes keep their status/accounting in the population's
    struct-of-arrays columns too, so scale tooling can query one array
    regardless of protocol."""

    @property
    def online(self) -> bool:
        return bool(self._pop.online[self._row])

    @online.setter
    def online(self, value: bool) -> None:
        self._pop.online[self._row] = bool(value)

    @property
    def train_seconds(self) -> float:
        return float(self._pop.train_seconds[self._row])

    @train_seconds.setter
    def train_seconds(self, value: float) -> None:
        self._pop.train_seconds[self._row] = value


class _DSGDNode(_SoANodeMixin):
    def __init__(self, node_id, session, data, speed):
        self.node_id = node_id
        self.session = session
        self.sim = session.sim
        self.net = session.net
        self._pop = self.net.state
        self._row = self._pop.ensure(node_id)
        self.data = data
        self.speed = speed
        self.online = True
        self.params = None
        self.round = 1
        self.trained = False
        self.inbox: Dict[int, list] = {}       # round -> [(sender, model)]
        self.agg_log: list = []                # (round, senders) audit trail
        self.dup_models_dropped = 0
        self.train_seconds = 0.0
        self.trainings_completed = 0
        self._train_started_at = 0.0
        self._train_dur = 0.0
        self._went_offline_at = None

    def start_round(self):
        self.trained = False
        dur = self.session.task.train_time(
            self.data, batch_size=self.session.tcfg.batch_size,
            epochs=1, speed=self.speed)
        self._train_started_at = self.sim.now
        self._train_dur = dur
        if self.params is not None and self.data is not None:
            # params are final for this round (aggregation happened in
            # maybe_advance), so the engine may batch the compute with
            # whichever peers start their round before our finish fires.
            self.session.engine.submit(
                self.node_id, self.round, self.params, self.data,
                batch_size=self.session.tcfg.batch_size, epochs=1,
                seed=self.round)
        self.sim.schedule(dur, self.finish_train)

    def finish_train(self):
        if not self.online:
            # crashed mid-train: drop the round, but the compute burned up
            # to the crash still counts as consumed training resources
            if self._went_offline_at is not None:
                self.train_seconds += max(0.0, min(
                    self._went_offline_at - self._train_started_at,
                    self._train_dur))
            return
        self.train_seconds += self._train_dur
        self.trainings_completed += 1
        if self.params is not None and self.data is not None:
            self.params = self.session.engine.result(
                self.node_id, self.round, self.params, self.data,
                batch_size=self.session.tcfg.batch_size,
                epochs=1, seed=self.round)
        self.trained = True
        # one-peer exponential graph: send to (i + 2^(k mod log2 n)) mod n
        n = len(self.session.nodes)
        hop = 2 ** (self.round % max(1, int(math.log2(n))))
        dst = str((int(self.node_id) + hop) % n)
        payload = (M.ModelPayload(params=self.params) if self.params is not None
                   else M.ModelPayload(nbytes=self.session.task.model_bytes()))
        m = M.AggregateMsg(sender=self.node_id, round_k=self.round,
                           model=payload, view=None)
        self.net.account_payload(m.model.size_bytes())
        self.net.send(self.node_id, dst, m)
        self.maybe_advance()

    def receive(self, msg):
        if isinstance(msg, M.AggregateMsg):
            box = self.inbox.setdefault(msg.round_k, [])
            if any(s == msg.sender for s, _ in box):
                # Duplicated delivery (fault fabric): the exponential
                # graph has exactly one in-neighbor per round, so a
                # second copy from the same sender would double-weight
                # its model in the synchronous average.
                self.dup_models_dropped += 1
                return
            box.append((msg.sender, msg.model))
            self.maybe_advance()

    def maybe_advance(self):
        if self.trained and self.inbox.get(self.round):
            incoming = self.inbox.pop(self.round)
            self.agg_log.append(
                (self.round,
                 (self.node_id,) + tuple(s for s, _ in incoming)))
            if self.params is not None:
                self.params = self.session.engine.aggregate(
                    [self.params] + [m.params for _, m in incoming])
            self.round += 1
            self.session.on_round(self.node_id, self.round, self.params)
            self.start_round()


class DSGDSession:
    """D-SGD on a one-peer exponential graph (Ying et al. 2021), as §4.3.

    Accepts ``profile=`` for trace-driven speeds / per-link capacity /
    availability. Note the synchronous ring has no rejoin protocol: an
    offline node simply drops messages, so under a churny profile D-SGD
    wedges — which is the paper's argument for sampling-based DL.
    """

    def __init__(self, *, n_nodes: Optional[int] = None,
                 tcfg: Optional[TrainConfig] = None,
                 task: Optional[LearningTask] = None,
                 data: Optional[FederatedData] = None, bandwidth: float = 20e6,
                 seed: int = 0, eval_every_rounds: int = 10,
                 profile=None, churn_from_profile: bool = True,
                 contention: bool = True, engine: Optional[str] = None,
                 fault=None, serve=None, device=None):
        n_nodes, task = _profile_defaults(profile, n_nodes, task)
        tcfg = tcfg or TrainConfig()
        self.sim = Simulator()
        self.net, speeds = _net_and_speeds(self.sim, n_nodes, profile,
                                           bandwidth, seed, contention)
        self.fault_injector = _fault_setup(self, fault)
        self.tcfg, self.task = tcfg, task
        self.engine = make_engine(engine, task, device=device)
        self.eval_every = eval_every_rounds
        self.data = data
        self.result = SessionResult()
        self._snapshots: Dict[int, list] = {}
        self.nodes: Dict[str, _DSGDNode] = {}
        for i in range(n_nodes):
            node = _DSGDNode(str(i), self,
                             data.clients[i % len(data.clients)] if data else None,
                             float(speeds[i]))
            node.params = task.init_params(tcfg.seed) if data is not None else None
            self.net.register(node)
            self.nodes[str(i)] = node
        self.profile = profile
        self.serving = _serve_setup(self, serve, speeds, seed)
        self.churn_driver, offline_now = _churn_setup(
            self.sim, profile, churn_from_profile, list(self.nodes),
            self._trace_offline, self._trace_online,
            network=self.net)
        for nid in offline_now:
            self.nodes[nid].online = False

    def _trace_offline(self, nid: str) -> None:
        node = self.nodes[nid]
        node.online = False
        node._went_offline_at = self.sim.now

    def _trace_online(self, nid: str) -> None:
        node = self.nodes[nid]
        node.online = True
        node._went_offline_at = None

    def on_round(self, node_id: str, new_round: int, params) -> None:
        if new_round % self.eval_every == 0 and params is not None:
            self._snapshots.setdefault(new_round, [])
            if len(self._snapshots[new_round]) < 8:   # sample of local models
                self._snapshots[new_round].append((self.sim.now, params))
        # Population-level progression: first completion of each round by
        # *any* node. Observing only node "0"
        # would make round_times — and with it repro_torch.eval's time-to-round — an
        # artifact of one node's availability trace under churn.
        if new_round > self.result.rounds_completed:
            self.result.round_times.append((self.sim.now, new_round))
            self.result.rounds_completed = new_round
            if self.serving is not None:
                self.serving.on_round(new_round, params, node_id)

    def run(self, duration: float) -> SessionResult:
        if self.churn_driver is not None:
            self.churn_driver.install(duration)
        if self.fault_injector is not None:
            self.fault_injector.install(duration)
        if self.serving is not None:
            self.serving.install(duration)
        for node in self.nodes.values():
            if node.online:
                node.start_round()
        self.sim.run(until=duration)
        if self.churn_driver is not None:
            self.result.churn_events = self.churn_driver.events_fired
        if self.fault_injector is not None:
            self.result.fault_stats = dict(self.fault_injector.stats)
        if self.serving is not None:
            self.result.serving = self.serving.summary()
        if self.data is not None and self.data.test is not None:
            for k, snaps in sorted(self._snapshots.items()):
                metrics = self.engine.evaluate_models([p for _, p in snaps],
                                                      self.data.test)
                t = max(t for t, _ in snaps)
                mean = {key: float(np.mean([m[key] for m in metrics]))
                        for key in metrics[0]}
                std = {key + "_std": float(np.std([m[key] for m in metrics]))
                       for key in metrics[0]}
                self.result.history.append({"t": t, "round": k, **mean, **std})
        self.result.usage = self.net.usage_summary()
        self.result.overhead_fraction = self.net.overhead_fraction()
        for node in self.nodes.values():
            self.result.train_node_seconds += node.train_seconds
            self.result.trainings_completed += node.trainings_completed
        if self.result.history:
            self.result.final_metrics = {
                k: v for k, v in self.result.history[-1].items()
                if k not in ("t", "round")}
        return self.result


# ---------------------------------------------------------------------------
# Gossip Learning baseline (Ormándi et al.; paper §5): every node trains on
# a fixed cadence and pushes its model to one random peer; the receiver
# averages it into its local model. No rounds, no sampling, no aggregators.
# ---------------------------------------------------------------------------


class _GossipNode(_SoANodeMixin):
    def __init__(self, node_id, session, data, speed, period):
        self.node_id = node_id
        self.session = session
        self.sim = session.sim
        self.net = session.net
        self._pop = self.net.state
        self._row = self._pop.ensure(node_id)
        self.data = data
        self.speed = speed
        self.period = period
        self.online = True
        self.params = None
        self.cycles = 0
        self.loop_live = False         # a cycle/done event is in flight
        self.train_seconds = 0.0
        self.trainings_completed = 0
        self._went_offline_at = None

    def start(self):
        self.sim.schedule(self.period * (0.5 + 0.5 * (int(self.node_id) % 7) / 7),
                          self.cycle)
        self.loop_live = True

    def cycle(self):
        if not self.online:
            self.loop_live = False     # loop dies; churn driver may resume it
            return
        self.loop_live = True
        dur = self.session.task.train_time(
            self.data, batch_size=self.session.tcfg.batch_size,
            epochs=1, speed=self.speed)
        started_at = self.sim.now

        def done():
            if not self.online:
                self.loop_live = False  # went offline mid-train: drop work
                if self._went_offline_at is not None:
                    self.train_seconds += max(0.0, min(
                        self._went_offline_at - started_at, dur))
                return
            self.train_seconds += dur
            self.trainings_completed += 1
            if self.params is not None and self.data is not None:
                # Gossip can't pre-submit: receive() may fold a pushed
                # model into self.params mid-training. The engine call
                # still routes through the fast fused lowering (S = 1).
                self.params = self.session.engine.result(
                    self.node_id, self.cycles, self.params, self.data,
                    batch_size=self.session.tcfg.batch_size,
                    epochs=1, seed=self.cycles)
            self.cycles += 1
            dst = self._pick_peer()
            if dst is not None:
                payload = (M.ModelPayload(params=self.params)
                           if self.params is not None else
                           M.ModelPayload(nbytes=self.session.task.model_bytes()))
                msg = M.AggregateMsg(sender=self.node_id, round_k=self.cycles,
                                     model=payload, view=None)
                self.net.account_payload(msg.model.size_bytes())
                self.net.send(self.node_id, dst, msg)
            self.session.on_cycle(self.node_id, self.cycles, self.params)
            self.sim.schedule(self.period, self.cycle)

        self.sim.schedule(dur, done)

    def _pick_peer(self):
        """Uniform random peer, *excluding self*: a self-push is a no-op
        average that still inflated Table-4 byte accounting."""
        n = len(self.session.nodes)
        if n <= 1:
            return None
        d = int(self.session.rng.integers(0, n - 1))
        if d >= int(self.node_id):
            d += 1
        return str(d)

    def receive(self, msg):
        if isinstance(msg, M.AggregateMsg) and msg.model.params is not None:
            if self.params is not None:
                self.params = self.session.engine.aggregate(
                    [self.params, msg.model.params])


class GossipSession:
    """Gossip Learning: fixed per-node cycle period (the tuning MoDeST's
    push design removes — §3.6). With ``profile=``, offline nodes pause
    their cycle and resume it when the trace brings them back."""

    def __init__(self, *, n_nodes: Optional[int] = None,
                 tcfg: Optional[TrainConfig] = None,
                 task: Optional[LearningTask] = None,
                 data: Optional[FederatedData] = None, bandwidth: float = 20e6,
                 seed: int = 0, eval_every_rounds: int = 10,
                 period: float = 5.0, profile=None,
                 churn_from_profile: bool = True, contention: bool = True,
                 engine: Optional[str] = None, fault=None, serve=None,
                 device=None):
        n_nodes, task = _profile_defaults(profile, n_nodes, task)
        tcfg = tcfg or TrainConfig()
        self.sim = Simulator()
        self.net, speeds = _net_and_speeds(self.sim, n_nodes, profile,
                                           bandwidth, seed, contention)
        self.fault_injector = _fault_setup(self, fault)
        self.tcfg, self.task = tcfg, task
        self.engine = make_engine(engine, task, device=device)
        self.eval_every = eval_every_rounds
        self.data = data
        self.rng = np.random.default_rng(seed)
        self.result = SessionResult()
        self._snapshots = {}
        self.nodes = {}
        for i in range(n_nodes):
            node = _GossipNode(str(i), self,
                               data.clients[i % len(data.clients)] if data else None,
                               float(speeds[i]), period)
            node.params = task.init_params(tcfg.seed) if data is not None else None
            self.net.register(node)
            self.nodes[str(i)] = node
        self.profile = profile
        self.serving = _serve_setup(self, serve, speeds, seed)
        self.churn_driver, offline_now = _churn_setup(
            self.sim, profile, churn_from_profile, list(self.nodes),
            self._trace_offline, self._trace_online, network=self.net)
        for nid in offline_now:
            self.nodes[nid].online = False

    def _trace_offline(self, nid: str) -> None:
        node = self.nodes[nid]
        node.online = False
        node._went_offline_at = self.sim.now

    def _trace_online(self, nid: str) -> None:
        node = self.nodes[nid]
        if not node.online:
            node.online = True
            node._went_offline_at = None
            if not node.loop_live:                 # resume a dead gossip loop
                node.loop_live = True
                self.sim.schedule(0.0, node.cycle)

    def on_cycle(self, node_id, cycle, params):
        # Cycle progression is population-level (first node to reach each
        # cycle count); model-quality snapshots stay pinned to node "0"
        # as the fixed observer so the curve tracks one model's history.
        if cycle > self.result.rounds_completed:
            self.result.round_times.append((self.sim.now, cycle))
            self.result.rounds_completed = cycle
            if self.serving is not None:
                self.serving.on_round(cycle, params, node_id)
        if node_id == "0":
            if cycle % self.eval_every == 0 and params is not None:
                self._snapshots[cycle] = (self.sim.now, params)

    def run(self, duration: float) -> SessionResult:
        if self.churn_driver is not None:
            self.churn_driver.install(duration)
        if self.fault_injector is not None:
            self.fault_injector.install(duration)
        if self.serving is not None:
            self.serving.install(duration)
        for node in self.nodes.values():
            if node.online:
                node.start()
        self.sim.run(until=duration)
        if self.churn_driver is not None:
            self.result.churn_events = self.churn_driver.events_fired
        if self.fault_injector is not None:
            self.result.fault_stats = dict(self.fault_injector.stats)
        if self.serving is not None:
            self.result.serving = self.serving.summary()
        if self.data is not None and self.data.test is not None:
            snaps = sorted(self._snapshots.items())
            metrics = self.engine.evaluate_models([p for _, (_, p) in snaps],
                                                  self.data.test)
            for (k, (t, _p)), m in zip(snaps, metrics):
                self.result.history.append({"t": t, "round": k, **m})
        self.result.usage = self.net.usage_summary()
        self.result.overhead_fraction = self.net.overhead_fraction()
        for node in self.nodes.values():
            self.result.train_node_seconds += node.train_seconds
            self.result.trainings_completed += node.trainings_completed
        if self.result.history:
            self.result.final_metrics = {
                k: v for k, v in self.result.history[-1].items()
                if k not in ("t", "round")}
        return self.result


def fedavg_session(**kw) -> ModestSession:
    """FedAvg emulation exactly as §4.3: a=1, fixed best-connected
    aggregator, no sampling pings, sf=1. Like the session classes,
    ``mcfg`` may be omitted when a ``profile=`` sizes the population."""
    mcfg: Optional[ModestConfig] = kw.pop("mcfg", None)
    if mcfg is None:
        profile = kw.get("profile")
        if profile is None:
            raise TypeError("fedavg_session requires mcfg= or profile=")
        n = kw.get("n_nodes") or profile.n
        mcfg = ModestConfig(n_nodes=n, ping_timeout=1.0)
    # dataclasses.replace, not a field-by-field rebuild: any other field
    # the caller set (failover, future knobs) must survive the override.
    mcfg = dataclasses.replace(mcfg, n_aggregators=1, success_fraction=1.0)
    return ModestSession(mcfg=mcfg, fixed_aggregator=True, **kw)
