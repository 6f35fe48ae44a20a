"""Batched cohort training: collapse S·B per-node steps to B.

The simulator samples a cohort S^k every round and each sampled node
trains the *same* aggregated model on its own shard. Training is a pure
function of ``(θ, shard, seed)``, so the engine can run the whole cohort
as one ``(S, N)`` flat-buffer batch without changing event semantics —
the simulator still attributes per-node train *durations* from the cost
model; only the wall-clock cost of computing the results changes.

Flow: nodes ``submit()`` when a round's training starts (message arrival)
and ``result()`` when the simulated duration elapses. The first demanded
result flushes everything queued at that sim-time as one stacked batch —
cohort members whose messages arrived earlier ride along, so a round
typically costs one flush. Jobs whose round was cancelled mid-flight are
pruned on the node's next submit; a ``result()`` whose job was never
queued (or whose θ doesn't match the queued one, e.g. a second aggregator
won the race with a different partial average) falls back to the
sequential path — correctness never depends on the cache.

Batching semantics (the ragged-tail fix, shared with the sequential
path): client batches are padded to a uniform shape with a per-row loss
mask — masked rows contribute exactly zero gradient, unlike the old
sample replication which silently upweighted repeated samples. Cohort
members are grouped by step count before stacking (non-IID shard sizes
are ragged), so no member rides through wasted no-op steps; the step
itself additionally gates params and optimizer state with a per-row
``active`` mask, keeping any padded grouping policy exact by construction.

Every group runs at the full cohort width in one pass per batch index.

Results are keyed by the *identity* of the submitted params object
(``id(params)``): a caller that copies, moves (``.to(device)``) or
re-packs a model between ``submit`` and ``result`` turns the cache hit
into the value-compare or the sequential fallback — correct, but slow and
silent. ``flushes`` / ``jobs_run`` exist so runs can check that the cohort
really went through batched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.flat import FlatModel, FlatSpec, as_buffer, as_tree
from repro_torch.engine.lowering import stacked_grads_for
from repro_torch.engine.optim_flat import build_flat
from repro_torch.utils.device import resolve_device


class SequentialEngine:
    """Reference engine: the exact pre-engine compute path — per-node
    ``task.local_train``, per-leaf aggregation, per-model evaluation."""

    name = "sequential"

    def __init__(self, task):
        self.task = task

    def submit(self, node_id, tag, params, client, *, batch_size, epochs,
               seed) -> None:
        pass

    def plan_cohort(self, tag, node_ids, params, *, batch_size, epochs,
                    seed) -> None:
        pass

    def register_client(self, node_id, client) -> None:
        pass

    def result(self, node_id, tag, params, client, *, batch_size, epochs,
               seed, lr_scale: float = 1.0):
        return self.task.local_train(params, client, batch_size=batch_size,
                                     epochs=epochs, seed=seed,
                                     lr_scale=lr_scale)

    def aggregate(self, models, weights=None):
        return self.task.aggregate_sequential(models, weights)

    def aggregate_masked(self, models, seeds, signs, weights=None):
        """Secure-agg path (repro_torch.secureagg): unmask+aggregate sealed
        FlatModels in one fused pass. The sequential engine delegates to
        the task like :meth:`aggregate` does."""
        return self.task.aggregate_masked(models, seeds, signs, weights)

    def evaluate_models(self, models, test):
        return [self.task.evaluate(p, test) for p in models]


@dataclass
class _Job:
    node_id: str
    tag: int
    params: Any                 # pinned reference: identity keys the cache
    client: Any
    batch_size: int
    epochs: int
    seed: int
    confirmed: bool = True      # False for plan-ahead jobs (send-time hook)

    @property
    def key(self) -> Tuple[str, int, int]:
        return (self.node_id, self.tag, id(self.params))

    @property
    def hp(self) -> Tuple[int, int, int]:
        """Training hyperparameters — a cached result is only valid for
        a demand with the same (batch_size, epochs, seed)."""
        return (self.batch_size, self.epochs, self.seed)


class BatchedEngine:
    """Flat-model batched cohort trainer for a
    :class:`~repro_torch.models.tasks.TorchTask`."""

    name = "batched"

    def __init__(self, task):
        self.task = task
        self.spec = task.flat_spec
        self._queue: List[_Job] = []
        # key -> (result FlatModel, the θ the job trained from, confirmed,
        #         the job's (batch_size, epochs, seed))
        self._done: Dict[Tuple[str, int, int],
                         Tuple[FlatModel, Any, bool, tuple]] = {}
        self._alt_specs: Dict[tuple, Any] = {}
        self._clients: Dict[str, Any] = {}
        self._served: set = set()   # (node, tag) already delivered
        # The step closure is cached on the task and shared by every
        # engine (one per session) built over it.
        self._opt, self._step = _cohort_ops(task)
        self.flushes = 0            # introspection for tests/benchmarks
        self.jobs_run = 0
        self.fallbacks = 0          # demands no queued job could serve

    # ------------------------------------------------------------------ api

    def register_client(self, node_id, client) -> None:
        """Teach the engine a node's shard so ``plan_cohort`` can build
        that node's batches (sessions call this for every node)."""
        self._clients[node_id] = client

    def plan_cohort(self, tag, node_ids, params, *, batch_size, epochs,
                    seed) -> None:
        """Send-time hook: the aggregator of round ``tag`` knows the whole
        sampled cohort and the (immutable, already-in-flight) θ̄, so the
        cohort's trainings can be queued before the TrainMsgs arrive —
        without this, WAN transfer staggering (transfer ≫ train duration)
        fragments cohorts into S=1 flushes. A plan never overrides a
        confirmed (arrival-time) submit, and results are value-checked
        before use, so racing aggregators stay correct.
        """
        if params is None:
            return
        self._gc(tag)
        for nid in node_ids:
            client = self._clients.get(nid)
            if client is None:
                continue
            if (nid, tag) in self._served:
                continue   # a later aggregator re-planning a done round
            if any(j.node_id == nid and j.tag == tag for j in self._queue) \
                    or any(k[0] == nid and k[1] == tag for k in self._done):
                continue                      # first plan/submit wins
            self._prune(nid, tag)
            self._queue.append(_Job(nid, tag, params, client, batch_size,
                                    epochs, seed, confirmed=False))

    def submit(self, node_id, tag, params, client, *, batch_size, epochs,
               seed) -> None:
        if params is None or client is None:
            return
        self._gc(tag)
        self._prune(node_id, tag)
        job = _Job(node_id, tag, params, client, batch_size, epochs, seed)
        if job.key in self._done:
            return
        for i, j in enumerate(self._queue):
            if j.node_id == node_id and j.tag == tag:
                if j.params is params and j.hp == job.hp:
                    return                   # already queued (plan or dup)
                if not j.confirmed:
                    self._queue[i] = job     # arrival overrides the plan
                    return
        self._queue.append(job)

    def result(self, node_id, tag, params, client, *, batch_size, epochs,
               seed, lr_scale: float = 1.0):
        hp = (batch_size, epochs, seed)
        hit = self._lookup(node_id, tag, params, hp)
        if hit is None and any(j.node_id == node_id and j.tag == tag
                               for j in self._queue):
            self._flush()
            hit = self._lookup(node_id, tag, params, hp)
        if hit is None:
            # never planned (θ or hyperparameter mismatch, or unknown
            # node): train it alone, same math
            self.fallbacks += 1
            self.submit(node_id, tag, params, client, batch_size=batch_size,
                        epochs=epochs, seed=seed)
            self._flush()
            hit = self._lookup(node_id, tag, params, hp)
        if hit is not None:
            self._served.add((node_id, tag))
            return hit
        self._served.add((node_id, tag))
        return self.task.local_train(params, client, batch_size=batch_size,
                                     epochs=epochs, seed=seed,
                                     lr_scale=lr_scale)

    # -------------------------------------------------------------- internals

    _max_tag = 0

    def _gc(self, tag: int) -> None:
        """Drop *plan-originated* bookkeeping more than a few rounds
        stale: plans for nodes that crashed or lost the round race are
        never demanded. Confirmed submits are exempt — a D-SGD straggler
        may legitimately run many rounds behind the population — and are
        instead pruned per node by ``_prune``."""
        self._max_tag = max(self._max_tag, tag)
        horizon = self._max_tag - 3
        # confirmed entries get a much longer leash (a node that crashed
        # mid-train never demands its result; a permanently-departed one
        # must not pin a buffer forever)
        chorizon = self._max_tag - 50
        if horizon > 0:
            self._queue = [j for j in self._queue
                           if j.tag >= (horizon if not j.confirmed
                                        else chorizon)]
            for key in [k for k, v in list(self._done.items())
                        if k[1] < (horizon if not v[2] else chorizon)]:
                del self._done[key]
            self._served = {s for s in self._served if s[1] >= horizon}

    def _prune(self, node_id, tag) -> None:
        """A node acting at round ``tag`` cancels its stale lower rounds."""
        self._queue = [j for j in self._queue
                       if not (j.node_id == node_id and j.tag < tag)]
        for key in [k for k in self._done
                    if k[0] == node_id and k[1] < tag]:
            del self._done[key]

    def _lookup(self, node_id, tag, params, hp):
        """Cached result for (node, tag) trained from θ == ``params`` with
        the same (batch_size, epochs, seed).

        θ matches by object identity first; value equality as the
        tiebreak — with a > 1 aggregators and sf = 1 both aggregators
        push numerically equal θ̄ as distinct objects, and the planned one
        may not be the object the node ends up training from.
        """
        key = (node_id, tag, id(params))
        entry = self._done.get(key)
        if entry is not None and entry[3] == hp:
            return self._done.pop(key)[0]
        for k in list(self._done):
            if k[0] == node_id and k[1] == tag and self._done[k][3] == hp:
                if self._same_value(self._done[k][1], params):
                    return self._done.pop(k)[0]
        return None

    def _same_value(self, a, b) -> bool:
        """Tight allclose, not bit equality: racing aggregators of the
        same round with sf = 1 average the same models in different
        arrival orders, so their θ̄ differ by fp summation order (~1e-7).
        Using either is within the engine's tolerance contract; genuinely
        different partial averages (sf < 1) are far outside these bounds
        and fall back."""
        if a is b:
            return True
        try:
            ab = as_buffer(a, self.spec)
            bb = as_buffer(b, self.spec)
            return bool(torch.allclose(ab, bb, rtol=1e-6, atol=1e-6))  # host sync
        except Exception:
            return False

    def aggregate(self, models, weights=None):
        """Whole-model one-pass aggregation (stays flat: FlatModel out)."""
        return self.task.aggregate(models, weights)

    def aggregate_masked(self, models, seeds, signs, weights=None):
        """Fused unmask→aggregate over sealed FlatModels (secure agg)."""
        return self.task.aggregate_masked(models, seeds, signs, weights)

    def evaluate_models(self, models, test):
        return self.task.evaluate_many(models, test)

    # ----------------------------------------------------------------- flush

    def _flush(self) -> None:
        jobs, self._queue = self._queue, []
        if not jobs:
            return
        # One stacked group per (batch_size, epochs, n_steps): batch
        # shapes must agree, and bucketing by step count keeps a short
        # client from riding along through masked no-op steps (non-IID
        # partitions make shard sizes — and so step counts — ragged).
        groups: Dict[Tuple[int, int, int], List[Tuple[_Job, list]]] = {}
        for j in jobs:
            batches = self.task._padded_batches(j.client, j.batch_size,
                                                seed=j.seed, epochs=j.epochs)
            if not batches:                   # empty shard: training is a
                self._done[j.key] = (         # no-op, like the sequential
                    FlatModel(as_buffer(j.params, self.spec),  # path
                              self._out_spec(j.params)),
                    j.params, j.confirmed, j.hp)
                continue
            groups.setdefault((j.batch_size, j.epochs, len(batches)),
                              []).append((j, batches))
        for group in groups.values():
            self._run_group(group)          # the full cohort width at once

    def _run_group(self, pairs: List[Tuple[_Job, list]]) -> None:
        jobs = [j for j, _ in pairs]
        self.flushes += 1
        self.jobs_run += len(jobs)
        S = len(jobs)
        per_job = [b for _, b in pairs]
        T = max(len(b) for b in per_job)
        x0, y0 = per_job[0][0][0], per_job[0][0][1]
        xs = np.zeros((T, S) + x0.shape, x0.dtype)
        ys = np.zeros((T, S) + y0.shape, y0.dtype)
        ms = np.zeros((T, S, x0.shape[0]), np.float32)
        act = np.zeros((T, S), np.bool_)
        for s, batches in enumerate(per_job):
            for t, (x, y, m) in enumerate(batches):
                xs[t, s], ys[t, s], ms[t, s], act[t, s] = x, y, m, True

        dev = self.task.device
        buf = torch.stack([as_buffer(j.params, self.spec) for j in jobs])
        if buf.device != dev:
            raise ValueError(f"submitted params live on {buf.device}, the "
                             f"task on {dev}")
        # one host->device copy per array for the whole group, then one
        # step per batch index
        xs_d, ys_d, ms_d, act_d = (torch.from_numpy(a).to(dev)
                                   for a in (xs, ys, ms, act))
        # handed over in a list, so that _train holds the stack's only
        # reference and each step frees the stack before it
        held = [buf]
        del buf
        buf = self._train(held, xs_d, ys_d, ms_d, act_d)
        for s, j in enumerate(jobs):
            self._done[j.key] = (FlatModel(buf[s], self._out_spec(j.params)),
                                 j.params, j.confirmed, j.hp)

    def _train(self, held, xs, ys, ms, act):
        """The ``(S, N)`` stack (``held``'s one element, taken out) after
        one step per batch index."""
        buf = held.pop()
        state = self._opt.init(buf)
        for t in range(xs.shape[0]):
            buf, state = self._step(buf, state, xs[t], ys[t], ms[t], act[t])
        return buf

    def _out_spec(self, params):
        """Results must come back in the *submitted* params' dtypes (e.g. a
        bf16-cast model trained through the fp32 engine stays bf16)."""
        if isinstance(params, FlatModel):
            return params.spec
        leaves = self.spec.treedef.flatten_up_to(params)
        dts = tuple(l.dtype for l in leaves)
        if dts == self.spec.dtypes:
            return self.spec
        alt = self._alt_specs.get(dts)
        if alt is None:
            alt = FlatSpec(self.spec.treedef, self.spec.shapes, dts)
            self._alt_specs[dts] = alt
        return alt


class MeshEngine(BatchedEngine):
    """BatchedEngine whose flat buffers split the parameter axis N over a
    device mesh (see :mod:`repro_torch.sharding`).

    In one process the mesh is a tuple of devices. Aggregation takes the
    per-shard one-pass path (:meth:`FlatSpec.sharding`,
    ``kernels.fused.*_sharded``): shard r runs on ``mesh[r]`` and the
    result is gathered on the mesh's first device, where the task lives,
    its mean, codes and scales bit-identical to the batched engine's.
    Cohort training runs on that first device as in ``batched``.

    In a world (``launch.world``; ``mesh`` a world's ``DeviceMesh``, split
    over its ``model`` axis) this is the reference's
    ``_cohort_ops(task, shardings)``: each rank holds its lane chunk of the
    ``(S, N)`` parameter and optimizer-state buffers (:func:`shard_align`
    lanes, zero-padded at the tail); a step gathers the parameter buffer,
    computes the gradients on the whole (replicated) leaves, and updates
    the rank's own chunk, elementwise over N, so no value changes. The
    trained stack is gathered for the session, whose event loop every rank
    runs whole. Aggregation runs B1 / B2 on the rank's chunk, or B4 / B5
    at the chunk's ``base`` with the global ``n_valid``, and gathers the
    chunks. ``state_lanes`` records the lanes of the last group's state.

    Event semantics are untouched — same simulated rounds, durations and
    byte accounting as ``batched``.
    """

    name = "sharded"
    state_lanes: Optional[Dict[str, tuple]] = None

    def __init__(self, task, mesh):
        super().__init__(task)
        self.shardings = task.flat_spec.sharding(mesh)
        self.mesh = self.shardings.mesh
        if self.shardings.home != task.device:
            raise ValueError(f"mesh starts at {self.shardings.home}, the "
                             f"task lives on {task.device}")

    def _train(self, held, xs, ys, ms, act):
        sh = self.shardings
        if sh.group is None:
            return super()._train(held, xs, ys, ms, act)
        from repro_torch import collectives
        from repro_torch.kernels.fused import shard_chunk

        N = held[0].shape[1]
        _, part = shard_chunk(held.pop(), sh.rank, sh.n_shards)
        state = self._opt.init(part)
        grads, update = _world_ops(self.task)
        for t in range(xs.shape[0]):
            whole = collectives.all_gather(part, sh.group, dim=1)[:, :N]
            g = grads(whole, xs[t], ys[t], ms[t])
            del whole
            g = [shard_chunk(g, sh.rank, sh.n_shards)[1]]
            part, state = update(g, state, part, act[t])
        self.state_lanes = {k: tuple(v.shape) for k, v in state.items()}
        return collectives.all_gather(part, sh.group, dim=1)[:, :N]

    def aggregate(self, models, weights=None):
        return self.task.aggregate(models, weights,
                                   shardings=self.shardings)

    def aggregate_masked(self, models, seeds, signs, weights=None):
        return self.task.aggregate_masked(models, seeds, signs, weights,
                                          shardings=self.shardings)


def _gated_update(opt_update, grad, state, buf, active):
    """The optimizer's update of the ``(S, n)`` rows ``buf`` by the
    gradient in the one-element list ``grad``, gated per row by
    ``active``; elementwise over the lanes. The gradient is taken out of
    the list, so it is freed once the update has read it: the packed
    gradient lives only until the update, and the update takes the sum in
    place (buf + upd, the same bits): (4 + 4 + 4) bytes a lane a member at
    the update's peak, not 22, which is what lets a published-width MoE
    layer train in cohorts of two on one card."""
    with torch.no_grad():
        upd, nstate = opt_update(grad.pop(), state, buf)
        keep = active[:, None]
        nbuf = torch.where(keep, upd.add_(buf), buf)
        nstate = {k: (torch.where(keep, v, state[k]) if v.dim() == 2
                      else torch.where(active, v, state[k]))
                  for k, v in nstate.items()}
    return nbuf, nstate


def _world_ops(task):
    """(packed stacked gradient of a whole ``(S, N)`` stack, gated update
    of a lane chunk) for a world's :class:`MeshEngine`, cached on the
    task."""
    cached = getattr(task, "_world_ops_cache", None)
    if cached is not None:
        return cached
    spec = task.flat_spec
    grads = stacked_grads_for(task)
    opt_update = _cohort_ops(task)[0].update

    def grad_rows(whole, xb, yb, mb):
        return spec.pack_stacked(grads(spec.unpack_stacked(whole), xb, yb,
                                       mb))

    def update(grad, state, part, active):
        return _gated_update(opt_update, grad, state, part, active)

    ops = task._world_ops_cache = (grad_rows, update)
    return ops


def _cohort_ops(task):
    """(flat optimizer, per-batch step) for ``task``, cached on it.

    The stacked step collapses S·B per-node steps to B, with the ``(S, N)``
    params and optimizer-state buffers as the carry. Per-row ``active``
    gates params *and* state, so a member with fewer local batches than the
    group's max would be carried through trailing slots untouched — under
    the current same-step-count grouping in ``_flush`` the mask is always
    all-True, but the gating keeps any padded grouping policy exact.
    """
    cached = getattr(task, "_cohort_ops_cache", None)
    if cached is not None:
        return cached
    spec = task.flat_spec
    grads = stacked_grads_for(task)
    opt = build_flat(task.tcfg)
    opt_update = opt.update

    def step(buf, state, xb, yb, mb, active):
        # the unpacked leaves live only through the gradient
        return _gated_update(opt_update, [spec.pack_stacked(
            grads(spec.unpack_stacked(buf), xb, yb, mb))], state, buf,
            active)

    ops = task._cohort_ops_cache = (opt, step)
    return ops


def make_engine(kind: Optional[str], task, device=None):
    """``kind``: "batched" | "sharded" | "sequential" | None (auto).

    Auto picks batched for tasks that expose the flat/cohort surface
    (:class:`~repro_torch.models.tasks.TorchTask`) and sequential otherwise
    (e.g. :class:`~repro_torch.core.tasks.AbstractTask` byte-only runs,
    where there is nothing to compute). "sharded" runs the batched engine
    with its aggregations split over the local cards
    (:func:`repro_torch.launch.mesh.make_engine_mesh`); with fewer than two
    (one card, or the CPU) it falls back to "batched" (sharding would be a
    no-op). Inside a world (``launch.world``) "sharded" splits N over every
    rank of the world, whatever its size.

    ``device``: None means the card, like every entry point; a task that
    lives on another device than the one asked for raises.
    """
    device = resolve_device(device)
    task_device = getattr(task, "device", None)
    if task_device is not None and task_device != device:
        raise ValueError(f"task lives on {task_device}, engine asked for "
                         f"{device}")
    if kind is None:
        kind = "batched" if getattr(task, "supports_cohort", False) \
            else "sequential"
    if kind == "sharded":
        if not getattr(task, "supports_cohort", False):
            return SequentialEngine(task)
        from repro_torch.launch.mesh import make_engine_mesh
        from repro_torch.launch.world import current_world
        world = current_world()
        if world is not None:                 # N over every rank
            return MeshEngine(task, world.mesh((world.size,), ("model",)))
        mesh = make_engine_mesh(device)
        if mesh is None:
            return BatchedEngine(task)
        return MeshEngine(task, mesh)
    if kind == "batched":
        if not getattr(task, "supports_cohort", False):
            return SequentialEngine(task)
        return BatchedEngine(task)
    if kind == "sequential":
        return SequentialEngine(task)
    raise ValueError(f"unknown engine {kind!r} "
                     "(expected 'batched', 'sharded' or 'sequential')")


__all__ = ["BatchedEngine", "MeshEngine", "SequentialEngine", "make_engine",
           "FlatModel", "as_tree"]
