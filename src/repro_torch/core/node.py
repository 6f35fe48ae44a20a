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
from repro_torch.secureagg.masking import PairwiseMasker, SealedModel, threshold


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
        # Secure aggregation (repro_torch.secureagg, docs/SECUREAGG.md). All
        # state below is inert when mcfg.secure_agg is None: no masker is
        # built, no branches fire, golden trajectories are byte-identical.
        self.secure_agg = getattr(mcfg, "secure_agg", None)
        self._masker = PairwiseMasker(mcfg.seed) if self.secure_agg else None
        self._sa_train_roster: dict = {}   # train round k -> cohort S^k
        self._sa_shares_sent: set = set()  # train rounds whose shares went out
        self._sa_held: dict = {}           # train round -> {owner: (x, y)}
        self._sa_collected: dict = {}      # agg round -> {responder: {owner: share}}
        self._sa_pending: set = set()      # agg rounds with an unmask in flight
        self._sa_handle: dict = {}         # agg round -> abort timer handle
        self._sa_tries: dict = {}          # agg round -> unmask retry count
        self.secagg_log: List[tuple] = []  # (k, max_t, n_sealed, min_margin)
        self.secagg_aborts = 0             # unmask attempts below threshold
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
        elif isinstance(msg, M.ShareMsg):
            self._on_share_msg(msg)
        elif isinstance(msg, M.UnmaskReq):
            self._on_unmask_req(msg)
        elif isinstance(msg, M.UnmaskShareMsg):
            self._on_unmask_share(msg)
        elif isinstance(msg, M.AggregateMsg):
            self._on_aggregate_msg(msg)          # incl. MaskedModelMsg
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
        """Threshold/stall satisfied: aggregate — but sealed rows must
        clear the share-recovery gate first (docs/SECUREAGG.md)."""
        if self.secure_agg and any(isinstance(m.params, SealedModel)
                                   for m in self._theta_list):
            self._begin_unmask(k)
        else:
            self._do_aggregate(k)

    def _do_aggregate(self, k: int, secrets=None) -> None:
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
        payload = self._sa_aggregate(models, secrets) if self.secure_agg else None
        if payload is None:
            if models and models[0].params is not None:
                agg = self.engine.aggregate([m.params for m in models])
                payload = M.ModelPayload(params=agg)
            else:
                nbytes = models[0].nbytes if models else self.task.model_bytes()
                payload = M.ModelPayload(params=None, nbytes=nbytes)
        if self.secure_agg:
            self._sa_gc(k)
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
            # Secure mode: the cohort roster rides the TrainMsg — each
            # trainer derives its pairwise mask row and addresses its
            # Shamir shares from it (docs/SECUREAGG.md).
            roster = tuple(sample) if self.secure_agg else ()
            for j in sample:
                m = M.TrainMsg(sender=self.node_id, round_k=k,
                               model=M.ModelPayload(params=payload.params,
                                                    nbytes=payload.nbytes),
                               view=v, roster=roster)
                self.net.account_payload(m.model.size_bytes())
                self.net.send(self.node_id, j, m)

        self.sampler.sample(k, self.mcfg.sample_size, send_train)

    # ------------------------------------------------------ secure aggregation
    # (repro_torch.secureagg, docs/SECUREAGG.md). Trainer half: distribute Shamir
    # shares of the per-round mask secret over the cohort, seal the update
    # before pushing. Aggregator half: adopt one mask roster per round,
    # collect >= t shares per *arrived* sender from the survivors, then run
    # the fused unmask-aggregate kernel. Every message goes through
    # Network.send like the rest of the protocol, so fault schedules apply.

    SA_UNMASK_TIMEOUT_MULT = 10     # x ping_timeout per share-collection poll
    SA_MAX_TRIES = 3                # polls before declaring the round lost

    def _on_share_msg(self, msg: M.ShareMsg) -> None:
        if not self.secure_agg:
            return
        self._sa_held.setdefault(msg.round_k, {})[msg.owner] = tuple(msg.share)

    def _sa_distribute_shares(self, k: int, roster: tuple) -> None:
        """Split this node's round-k mask secret over the cohort (one
        share per member; own share is held locally, never on the wire)."""
        self._sa_shares_sent.add(k)
        self._sa_train_roster[k] = roster
        for member, share in self._masker.make_shares(
                self.node_id, k, roster).items():
            if member == self.node_id:
                self._sa_held.setdefault(k, {})[self.node_id] = share
            else:
                self.net.send(self.node_id, member, M.ShareMsg(
                    sender=self.node_id, round_k=k, owner=self.node_id,
                    share=share))

    def _sa_seal(self, k: int, payload: M.ModelPayload) -> M.ModelPayload:
        roster = self._sa_train_roster.get(k)
        if not roster:
            # No roster rode the TrainMsg (round-1 bootstrap without one):
            # degrade to a singleton roster so the update still never
            # travels in the clear — the threshold gate then needs only
            # this node's own share.
            roster = (self.node_id,)
            if k not in self._sa_shares_sent:
                self._sa_distribute_shares(k, roster)
        nbytes = payload.size_bytes()
        sealed = self._masker.seal(payload.params, self.node_id, k,
                                   roster, nbytes)
        return M.ModelPayload(params=sealed, nbytes=nbytes)

    def _on_unmask_req(self, msg: M.UnmaskReq) -> None:
        """Survivor half of recovery: reveal the shares held for the
        *arrived* senders only — dropped senders' secrets stay split."""
        if not self.secure_agg:
            return
        held = self._sa_held.get(msg.round_k)
        if not held:
            return
        revealable = set(msg.survivors)
        shares = tuple((owner, x, y)
                       for owner, (x, y) in sorted(held.items())
                       if owner in revealable)
        if shares:
            self.net.send(self.node_id, msg.sender, M.UnmaskShareMsg(
                sender=self.node_id, round_k=msg.round_k, shares=shares))

    def _on_unmask_share(self, msg: M.UnmaskShareMsg) -> None:
        if not self.secure_agg:
            return
        k = msg.round_k + 1            # share round = train round = k_agg - 1
        if k != self.k_agg or k in self._agg_models_done:
            return
        held = self._sa_collected.setdefault(k, {}).setdefault(msg.sender, {})
        held.update({owner: (x, y) for owner, x, y in msg.shares})
        if k in self._sa_pending:
            self._sa_check(k)

    def _begin_unmask(self, k: int) -> None:
        if k in self._sa_pending or k in self._agg_models_done:
            return
        self._sa_pending.add(k)
        col = self._sa_collected.setdefault(k, {})
        held = self._sa_held.get(k - 1)
        if held:                       # aggregator may hold shares itself
            col[self.node_id] = dict(held)
        # Arrived sealed senders: the only secrets recovery may reveal.
        # Their shares live with their *roster* members (co-aggregators
        # sample different cohorts, so rosters differ per row — each row
        # unmasks independently against its own roster).
        arrived, holders = [], set()
        for sender, m in zip(self._theta_from, self._theta_list):
            if isinstance(m.params, SealedModel):
                arrived.append(sender)
                holders.update(m.params.roster)
        survivors = tuple(arrived)
        roster = tuple(sorted(holders))
        for j in roster:
            if j != self.node_id:
                self.net.send(self.node_id, j, M.UnmaskReq(
                    sender=self.node_id, round_k=k - 1, roster=roster,
                    survivors=survivors))
        self._sa_handle[k] = self.sim.schedule(
            self.SA_UNMASK_TIMEOUT_MULT * self.timeout,
            lambda: self._sa_timeout(k))
        self._sa_check(k)

    def _sa_satisfied(self, k: int):
        """{sealed sender: (t, >= t distinct shares)} once every arrived
        sealed row can be recovered; None while any is short. Thresholds
        are per sender — each row was split over its own roster."""
        col = self._sa_collected.get(k, {})
        out = {}
        for sender, m in zip(self._theta_from, self._theta_list):
            if not isinstance(m.params, SealedModel):
                continue
            t = threshold(len(m.params.roster))
            xs = {}
            for held in col.values():
                sh = held.get(sender)
                if sh is not None:
                    xs[sh[0]] = sh     # distinct share indices only
            if len(xs) < t:
                return None
            out[sender] = (t, sorted(xs.values()))
        return out or None

    def _sa_check(self, k: int) -> None:
        per_sender = self._sa_satisfied(k)
        if per_sender is None:
            return
        h = self._sa_handle.pop(k, None)
        if h is not None:
            h.cancel()
        self._sa_pending.discard(k)
        if k != self.k_agg or k in self._agg_models_done:
            return
        secrets = {s: self._masker.reconstruct(xs, t)
                   for s, (t, xs) in per_sender.items()}
        self.secagg_log.append(
            (k, max(t for t, _ in per_sender.values()), len(per_sender),
             min(len(xs) - t for t, xs in per_sender.values())))
        self._do_aggregate(k, secrets)

    def _sa_timeout(self, k: int) -> None:
        self._sa_handle.pop(k, None)
        if k not in self._sa_pending:
            return
        if not self.online or k != self.k_agg or k in self._agg_models_done:
            self._sa_pending.discard(k)
            return
        self._sa_check(k)              # a late share may have raced the timer
        if k not in self._sa_pending:
            return
        # Below threshold: NEVER unmask. Abort this attempt; re-poll the
        # survivors a bounded number of times (late models widen the share
        # pool), then leave the round to the co-aggregator / failover.
        self.secagg_aborts += 1
        self._sa_pending.discard(k)
        tries = self._sa_tries.get(k, 0) + 1
        self._sa_tries[k] = tries
        if tries < self.SA_MAX_TRIES:
            self._begin_unmask(k)

    def _sa_aggregate(self, models: List, secrets) -> Optional[M.ModelPayload]:
        """Aggregate a round containing sealed rows; None means "plain
        round, use the ordinary path" (e.g. the FL bootstrap push)."""
        sealed = [m.params for m in models
                  if isinstance(m.params, SealedModel)]
        if not sealed:
            return None
        secrets = secrets or {}
        kinds = {sm.kind for sm in sealed}
        if kinds == {"bytes"}:
            return M.ModelPayload(params=None, nbytes=sealed[0].nbytes)
        if kinds == {"flat"} and len(sealed) == len(models):
            seeds, signs = self._masker.unmask_matrices(sealed, secrets)
            agg = self.engine.aggregate_masked(
                [sm.payload for sm in sealed], seeds, signs)
            return M.ModelPayload(params=agg)
        # Mixed sealed/plain or scalar rows: exact per-row unseal, then
        # the ordinary aggregate (cold path — unit/protocol tests only).
        plain = []
        for m in models:
            p = m.params
            if isinstance(p, SealedModel):
                sk = secrets[p.sender]
                p = (self._masker.unseal_scalar(p, sk) if p.kind == "scalar"
                     else self._masker.unseal_flat(p, sk))
            plain.append(p)
        return M.ModelPayload(params=self.engine.aggregate(plain))

    def _sa_gc(self, k: int) -> None:
        """Bound per-round secure-agg state (old rounds can no longer be
        aggregated here; a trailing window survives for slow co-aggregators
        still polling shares for recent rounds)."""
        horizon = k - 8
        for d in (self._sa_train_roster, self._sa_held,
                  self._sa_collected, self._sa_tries):
            for kk in [kk for kk in d if kk < horizon]:
                del d[kk]
        for kk in [kk for kk in self._sa_handle if kk < horizon]:
            self._sa_handle.pop(kk).cancel()
        self._sa_shares_sent = {kk for kk in self._sa_shares_sent
                                if kk >= horizon}
        self._sa_pending = {kk for kk in self._sa_pending if kk >= horizon}

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
        if (self.secure_agg and msg.roster
                and k not in self._sa_shares_sent):
            # Shares go out as soon as the cohort is known — training and
            # WAN share delivery overlap, so recovery shares are usually
            # in place before any model arrives at an aggregator.
            self._sa_distribute_shares(k, tuple(msg.roster))
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
            if self.secure_agg:
                payload = self._sa_seal(k, payload)        # masked bits only

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
            if isinstance(payload.params, SealedModel):
                m = M.MaskedModelMsg(sender=self.node_id, round_k=k + 1,
                                     model=M.ModelPayload(
                                         params=payload.params,
                                         nbytes=payload.nbytes),
                                     view=v, roster=payload.params.roster)
            else:
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
