"""The MoDeST node — Algorithms 2, 3 and 4 combined.

Each node runs two logical tasks (aggregation and training) with separate
round counters ``k_agg`` / ``k_train``, exactly as §3.6 prescribes:

* ``aggregate(k, θ_j, V_j)`` — accumulate models for round ``k``; once
  ``sf·s`` arrived, average, sample ``S^k`` and push ``train`` to it.
* ``train(k, θ_a, V_j)`` — (re)start local training for round ``k``;
  higher-``k`` messages cancel in-flight training; on completion, sample
  ``A^{k+1}`` and push ``aggregate`` to the next aggregators.

Views piggyback on both message kinds and are merged on receipt. Liveness
(ping/pong) is served even mid-training. Failures are modelled by the
network refusing delivery to ``online=False`` nodes.
"""

from __future__ import annotations

import math
from itertools import islice
from typing import Callable, List, Optional

from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.core import messages as M
from repro_torch.core.activity import ActivityTracker
from repro_torch.core.registry import JOINED, LEFT, Registry
from repro_torch.core.sampling import Sampler
from repro_torch.core.tasks import AbstractTask, LearningTask
from repro_torch.core.views import View


class ModestNode:
    def __init__(self, node_id: str, sim, net, mcfg: ModestConfig,
                 tcfg: TrainConfig, task: LearningTask, data=None, *,
                 train_speed: float = 0.05,
                 on_aggregate: Optional[Callable] = None,
                 fixed_aggregator: Optional[str] = None,
                 engine=None):
        self.node_id = node_id
        self.sim = sim
        self.net = net
        # Hot per-node state (online flag, train-seconds accounting) lives
        # in the population's struct-of-arrays columns; the attributes
        # below are properties over this row (repro_torch.sim.soa).
        self._pop = net.state
        self._row = net.state.ensure(node_id)
        self.mcfg = mcfg
        self.tcfg = tcfg
        self.task = task
        self.data = data
        # Compute engine (repro_torch.engine): sessions share one BatchedEngine
        # across the population so a sampled cohort's trainings run as one
        # stacked batch. Default: the sequential per-node path.
        if engine is None:
            from repro_torch.engine.cohort import SequentialEngine
            engine = SequentialEngine(task)
        self.engine = engine
        if data is not None:
            engine.register_client(node_id, data)
        self.train_speed = train_speed
        self.on_aggregate = on_aggregate       # session hook: (k, params, node)
        # FL-emulation mode (§4.3): single fixed aggregator, no sampling.
        self.fixed_aggregator = fixed_aggregator

        self.registry = Registry()
        self.activity = ActivityTracker()
        self.sampler = Sampler(self)
        self.timeout = mcfg.ping_timeout

        self.online = True
        self.counter = 0                       # persistent c_i
        self.k_agg = 0
        self.k_train = 0
        self._theta_list: List = []            # Θ
        self._theta_from: List[str] = []       # sender of each model in Θ
        self._seen_round = 0                   # max round in any model msg
        self.agg_log: List[tuple] = []         # (k, senders) per aggregation
        self.dup_models_dropped = 0            # duplicate AggregateMsg guard
        self.failovers = 0                     # aggregator-failover re-sends
        self._push_acked = set()               # rounds with a model Ack
        self._agg_models_done = set()          # rounds already aggregated (guard)
        self._train_done = set()               # rounds already trained (guard)
        self._train_handle = None              # cancellable pending training
        self._train_round_pending = None
        self._train_started_at = 0.0
        self.sample_durations: List[tuple] = []   # (t, seconds) for Fig. 6
        # Secure aggregation arrives with a later slice of this package;
        # until then a session that asks for it is refused at construction
        # rather than silently run in the clear.
        if getattr(mcfg, "secure_agg", None):
            raise NotImplementedError("secure aggregation: later slice")
        # Training-resource accounting (paper §4.5: resource usage = time
        # spent training). Completed trainings count in full; cancelled or
        # crash-interrupted ones count the compute burned up to the cut.
        self.train_seconds = 0.0
        self.trainings_completed = 0

        # §3.5 auto-rejoin: a node wrongly suspected unresponsive re-joins
        # once it has been inactive for more than Δk · (average round time).
        self._last_active_t = 0.0
        self._last_active_k = 0
        self._round_time_est = 4.0 * mcfg.ping_timeout   # prior; refined online

        net.register(self)
        self._schedule_rejoin_check()

    # ---- SoA-backed hot state (see repro_torch.sim.soa.PopulationState) ----------

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

    @property
    def view_digest(self) -> int:
        """Stable 64-bit digest of this node's membership view."""
        return self.registry.digest ^ self.activity.digest

    # ------------------------------------------------------------------ utils

    def candidates(self, round_k: int) -> List[str]:
        return self.activity.candidates(self.registry, round_k,
                                        self.mcfg.activity_window)

    def view(self) -> View:
        return View.of(self.registry, self.activity)

    def _sf_threshold(self) -> int:
        return max(1, math.ceil(self.mcfg.success_fraction * self.mcfg.sample_size))

    # -------------------------------------------------------------- membership

    def bootstrap(self, all_ids: List[str], *, base=None) -> None:
        """Out-of-band initial view (metadata download, §4.1): everyone
        registered with counter 1, activity 0.

        ``base`` is an optional prebuilt ``(Registry, ActivityTracker)``
        pair shared by the whole population; it is adopted as a
        copy-on-write snapshot, making session construction O(n) instead
        of O(n²) — the dominant startup cost at paper scale (n = 1000).
        """
        if base is not None:
            self.registry = base[0].snapshot()
            self.activity = base[1].snapshot()
        else:
            for j in all_ids:
                self.registry.update(j, 1, JOINED)
                self.activity.update(j, 0)
        self.counter = max(self.counter, 1)

    def request_join(self, peers: List[str]) -> None:
        """Alg. 2 l.17 — advertise a joined event to s random peers."""
        self.counter += 1
        self.registry.update(self.node_id, self.counter, JOINED)
        self.activity.update(self.node_id, self.activity.round_estimate())
        for j in peers:
            self.net.send(self.node_id, j,
                          M.Joined(sender=self.node_id, node=self.node_id,
                                   counter=self.counter))

    def request_leave(self, peers: List[str]) -> None:
        self.counter += 1
        self.registry.update(self.node_id, self.counter, LEFT)
        for j in peers:
            self.net.send(self.node_id, j,
                          M.Left(sender=self.node_id, node=self.node_id,
                                 counter=self.counter))
        self.online = False
        # Like crash(): a leaver's in-flight training and transfers die
        # with it and must not keep throttling survivors' shared links.
        # (The Left messages above are sub-min_flow_bytes and unaffected.)
        self._cancel_training()
        self.net.node_offline(self.node_id)

    def crash(self) -> None:
        self.online = False
        self._cancel_training()                # the process died mid-train
        # The process's sockets died with it: abort in-flight transfers so
        # the contention scheduler hands their bandwidth back to survivors.
        self.net.node_offline(self.node_id)

    def _cancel_training(self) -> None:
        if self._train_handle is not None:
            self._train_handle.cancel()
            self._train_handle = None
            self._train_round_pending = None
            # partial compute burned before the interruption still counts
            self.train_seconds += self.sim.now - self._train_started_at

    def recover(self) -> None:
        self.online = True

    # ------------------------------------------------------------- auto-rejoin

    def _note_active(self, round_k: int) -> None:
        """Record own activity and refine the per-round time estimate Δt̄."""
        if round_k > self._last_active_k and self._last_active_k > 0:
            dt = (self.sim.now - self._last_active_t) / (round_k - self._last_active_k)
            if dt > 0:
                self._round_time_est = 0.7 * self._round_time_est + 0.3 * dt
        if round_k > self._last_active_k:
            self._last_active_k = round_k
            self._last_active_t = self.sim.now

    def _schedule_rejoin_check(self) -> None:
        period = max(self.mcfg.activity_window * self._round_time_est, 4 * self.timeout)

        def check():
            if self.online:
                idle = self.sim.now - self._last_active_t
                if idle > self.mcfg.activity_window * self._round_time_est:
                    # lazy scan: O(sample_size), not O(population) — at
                    # n = 100k the eager registered() list dominated the
                    # periodic check's cost
                    peers = list(islice(
                        (j for j in self.registry.iter_registered()
                         if j != self.node_id), self.mcfg.sample_size))
                    if peers:
                        self.request_join(peers)
                        self._last_active_t = self.sim.now
            self._schedule_rejoin_check()

        self.sim.schedule(period, check)

    # ----------------------------------------------------------------- receive

    def receive(self, msg: M.Message) -> None:
        if not self.online:
            return
        if isinstance(msg, M.Ping):
            self.net.send(self.node_id, msg.sender,
                          M.Pong(sender=self.node_id, round_k=msg.round_k))
        elif isinstance(msg, M.Pong):
            self.sampler.on_pong(msg.round_k, msg.sender)
        elif isinstance(msg, M.Ack):
            self._push_acked.add(msg.round_k)
        elif isinstance(msg, M.Joined):
            applied = self.registry.update(msg.node, msg.counter, JOINED)
            if applied:
                self.activity.update(msg.node, self.activity.round_estimate())
        elif isinstance(msg, M.Left):
            self.registry.update(msg.node, msg.counter, LEFT)
        elif isinstance(msg, M.AggregateMsg):
            self._on_aggregate_msg(msg)
        elif isinstance(msg, M.TrainMsg):
            self._on_train_msg(msg)

    # ------------------------------------------------------------- aggregation

    def _on_aggregate_msg(self, msg: M.AggregateMsg) -> None:
        if self.failover_enabled():
            # Receipt ack (even for stale/duplicate copies): "this model
            # is in live hands, don't failover-re-send it". Gated with
            # the failover machinery so clean trajectories are untouched.
            self.net.send(self.node_id, msg.sender,
                          M.Ack(sender=self.node_id, round_k=msg.round_k))
        if msg.view is not None:
            msg.view.merge_into(self.registry, self.activity)
        self.activity.update(self.node_id, msg.round_k)
        self._note_active(msg.round_k)
        self._seen_round = max(self._seen_round, msg.round_k)
        k = msg.round_k
        if k < self.k_agg or k in self._agg_models_done:
            return                                         # stale (§3.6)
        if k > self.k_agg:
            self.k_agg = k
            self._theta_list = [msg.model]
            self._theta_from = [msg.sender]
            # Liveness guard (implementation detail, mirrors sf's purpose):
            # if participants crash *after* being sampled, fewer than sf·s
            # models ever arrive; aggregate what we have after a long stall
            # instead of wedging the session (cancelled if threshold met).
            if self._stall_handle is not None:
                self._stall_handle.cancel()
            self._stall_handle = self.sim.schedule(
                30 * self.timeout, lambda: self._stall_aggregate(k))
        else:
            if msg.sender in self._theta_from:
                # Duplicated delivery (spurious retransmit) or a trainer's
                # failover re-send racing the original: one model per
                # sender per round, or the average silently double-weights
                # whoever's packets duplicated.
                self.dup_models_dropped += 1
                return
            self._theta_list.append(msg.model)
            self._theta_from.append(msg.sender)
        if len(self._theta_list) >= self._sf_threshold():
            self._maybe_aggregate(k)

    _stall_handle = None

    def _stall_aggregate(self, k: int) -> None:
        self._stall_handle = None
        if not self.online:
            return
        if k == self.k_agg and k not in self._agg_models_done and self._theta_list:
            self._maybe_aggregate(k)

    def _maybe_aggregate(self, k: int) -> None:
        """Threshold/stall satisfied: aggregate."""
        self._do_aggregate(k)

    def _do_aggregate(self, k: int) -> None:
        self._agg_models_done.add(k)
        if self._stall_handle is not None:
            self._stall_handle.cancel()
            self._stall_handle = None
        models = self._theta_list
        # Audit trail for the conformance invariant "no model aggregated
        # twice per round": one entry per aggregation this node performed,
        # bounded by rounds x aggregators.
        self.agg_log.append((k, tuple(self._theta_from)))
        self._theta_list = []
        self._theta_from = []
        if models and models[0].params is not None:
            agg = self.engine.aggregate([m.params for m in models])
            payload = M.ModelPayload(params=agg)
        else:
            nbytes = models[0].nbytes if models else self.task.model_bytes()
            payload = M.ModelPayload(params=None, nbytes=nbytes)
        if self.on_aggregate is not None:
            self.on_aggregate(k, payload.params, self)

        t0 = self.sim.now

        def send_train(sample: List[str], _tries: int = 0) -> None:
            if not self.online:                # crashed while sampling
                return
            if not sample and _tries < 5 and self.failover_enabled():
                # Every candidate was unreachable (mass crash, partition,
                # total ping loss): an empty S^k is a guaranteed wedge —
                # the aggregated model exists but nobody will ever train
                # it. Hold the model and re-sample once the network has
                # had a timeout to heal. Gated with the rest of the
                # failover hardening: empty resolutions do occur in clean
                # churny runs, and retrying there would shift the
                # golden-pinned trajectories.
                self.sim.schedule(self.timeout, lambda: self.sampler.sample(
                    k, self.mcfg.sample_size,
                    lambda s: send_train(s, _tries + 1)))
                return
            self.sample_durations.append((t0, self.sim.now - t0))
            if payload.params is not None:
                # The TrainMsgs below are immutable once sent, so the
                # engine may compute the cohort's trainings as one batch
                # before they arrive (WAN transfers usually outlast the
                # train durations, which would otherwise fragment the
                # cohort into single-node flushes).
                self.engine.plan_cohort(
                    k, sample, payload.params,
                    batch_size=self.tcfg.batch_size,
                    epochs=self.mcfg.local_steps,
                    seed=self.tcfg.seed + k)
            v = self.view()
            for j in sample:
                m = M.TrainMsg(sender=self.node_id, round_k=k,
                               model=M.ModelPayload(params=payload.params,
                                                    nbytes=payload.nbytes),
                               view=v, roster=())
                self.net.account_payload(m.model.size_bytes())
                self.net.send(self.node_id, j, m)

        self.sampler.sample(k, self.mcfg.sample_size, send_train)

    # ---------------------------------------------------------------- training

    def _on_train_msg(self, msg: M.TrainMsg) -> None:
        if msg.view is not None:
            msg.view.merge_into(self.registry, self.activity)
        self.activity.update(self.node_id, msg.round_k)
        self._note_active(msg.round_k)
        # A TrainMsg for k is evidence round k's aggregation completed:
        # it short-circuits any pending failover watch for round k-1.
        self._seen_round = max(self._seen_round, msg.round_k)
        k = msg.round_k
        if k < self.k_train or k in self._train_done:
            return                                         # stale
        if k > self.k_train:
            self.k_train = k
            self._cancel_training()                        # CANCEL(θ̄)
        if self._train_round_pending is not None:
            return                                         # PENDING(θ̄)

        duration = self.task.train_time(
            self.data, batch_size=self.tcfg.batch_size,
            epochs=self.mcfg.local_steps, speed=self.train_speed)
        self._train_round_pending = k
        self._train_started_at = self.sim.now
        incoming = msg.model
        if incoming.params is not None and self.data is not None:
            # Training starts now in simulated time; the engine may batch
            # this node's compute with the rest of the sampled cohort
            # (results are demanded at `finish`, duration later).
            self.engine.submit(self.node_id, k, incoming.params, self.data,
                               batch_size=self.tcfg.batch_size,
                               epochs=self.mcfg.local_steps,
                               seed=self.tcfg.seed + k)

        def finish() -> None:
            self._train_handle = None
            self._train_round_pending = None
            if not self.online:                # crashed mid-train: drop work
                return
            self.train_seconds += duration
            if k != self.k_train or k in self._train_done:
                return
            self.trainings_completed += 1
            self._train_done.add(k)
            if incoming.params is not None:
                updated = self.engine.result(
                    self.node_id, k, incoming.params, self.data,
                    batch_size=self.tcfg.batch_size,
                    epochs=self.mcfg.local_steps, seed=self.tcfg.seed + k)
                payload = M.ModelPayload(params=updated)
            else:
                payload = M.ModelPayload(params=None, nbytes=incoming.nbytes)

            if self.fixed_aggregator is not None:          # FL emulation
                self._push_model(k, payload, [self.fixed_aggregator])
            else:
                self.sampler.sample(
                    k + 1, self.mcfg.n_aggregators,
                    lambda aggs: self._push_model(k, payload, aggs))

        self._train_handle = self.sim.schedule(duration, finish)

    # ------------------------------------------------------- model push + §4
    # failover: a trainer that pushed its round-k model watches for round
    # k+1 progress; if the designated aggregators died post-sample, it
    # re-samples A^{k+1} *excluding them* and re-sends. The watch timer is
    # armed only when failover is enabled (mcfg.failover — "auto" means
    # "a fault fabric is attached"), so clean golden trajectories carry
    # zero extra events; the duplicate-sender guard in aggregation makes
    # re-sends safe even when the original aggregator was merely slow.

    FAILOVER_TIMEOUT_MULT = 20      # x ping_timeout before declaring death
    FAILOVER_MAX_RETRIES = 2

    def failover_enabled(self) -> bool:
        fo = getattr(self.mcfg, "failover", "auto")
        if fo == "auto":
            return getattr(self.net, "fault", None) is not None
        return bool(fo)

    def _push_model(self, k: int, payload: M.ModelPayload, aggs: List[str],
                    tried=(), tries: int = 0) -> None:
        # Legacy quirk, golden-pinned: the *first* push (tries == 0) is
        # not gated on being online — a node that crashed while sampling
        # A^{k+1} still flushes the model its process had already queued
        # (the sampler continuation fires from a timer). Failover
        # re-sends are new code and do check.
        if tries and not self.online:
            return
        if (not aggs and tries <= self.FAILOVER_MAX_RETRIES
                and self.failover_enabled()):
            # Sampling A^{k+1} came back empty (mass unreachability): the
            # trained model would be silently lost and the round with it.
            # Hold it and re-sample after a timeout (gated like the S^k
            # retry — see there).
            self.sim.schedule(self.timeout, lambda: self.sampler.sample(
                k + 1, self.mcfg.n_aggregators,
                lambda a: self._push_model(k, payload, a, tried, tries + 1),
                exclude=tried))
            return
        v = self.view()
        for j in aggs:
            m = M.AggregateMsg(sender=self.node_id, round_k=k + 1,
                               model=M.ModelPayload(params=payload.params,
                                                    nbytes=payload.nbytes),
                               view=v)
            self.net.account_payload(m.model.size_bytes())
            self.net.send(self.node_id, j, m)
        if (self.failover_enabled() and tries <= self.FAILOVER_MAX_RETRIES
                and self.fixed_aggregator is None):
            # No watch in FL-emulation mode: the fixed server is
            # churn-exempt infrastructure (§4.3), and a decentralized
            # re-sample would spawn rogue aggregators inside the
            # centralized baseline.
            tried = tuple(tried) + tuple(aggs)
            self.sim.schedule(
                self.FAILOVER_TIMEOUT_MULT * self.timeout,
                lambda: self._check_failover(k, payload, tried, tries))

    def _check_failover(self, k: int, payload: M.ModelPayload,
                        tried: tuple, tries: int) -> None:
        if (not self.online or self._seen_round > k
                or k + 1 in self._push_acked):
            return          # round k+1 progressed, or an aggregator acked
        self.failovers += 1

        def resend(aggs: List[str]) -> None:
            if self._seen_round > k or k + 1 in self._push_acked:
                return      # progress arrived while we were sampling
            self._push_model(k, payload, aggs, tried, tries + 1)

        self.sampler.sample(k + 1, self.mcfg.n_aggregators, resend,
                            exclude=tried)

    # ----------------------------------------------------------------- kickoff

    def self_activate(self, round_k: int, init_params, roster=()) -> None:
        """Round-1 bootstrap (Alg. 4 l.6-8): a node that finds itself in S^1
        sends itself the initial model. ``roster`` is S^1 (secure mode:
        the bootstrap cohort is the mask group of the first round)."""
        payload = (M.ModelPayload(params=init_params) if init_params is not None
                   else M.ModelPayload(nbytes=self.task.model_bytes()))
        self.receive(M.TrainMsg(  # noqa: DL004(round-1 self-activation is loopback — never on the WAN, exempt from link faults by the fabric contract)
            sender=self.node_id, round_k=round_k,
            model=payload, view=self.view(), roster=tuple(roster)))
