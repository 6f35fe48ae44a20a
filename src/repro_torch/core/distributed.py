"""The mesh form of a MoDeST round, and serving.

:class:`DistributedTrainer` computes a full MoDeST round in the mesh form:

1. every participant slot runs ``E`` local SGD steps on its own replica
   (or one step on ``E`` accumulated microbatches);
2. the round's aggregation is the strategy's masked mix over the
   participant axis (``core/strategy.py``).

``weights`` is the host-side protocol's output: which slots count this
round (sampling mask, ``sf`` failures, stragglers). The step is
protocol-agnostic: one step serves MoDeST, FedAvg and D-SGD; only the
mask and the strategy differ. The participant count comes from
``sharding.ShardingPolicy``. The P replicas lie stacked on one device
(every leaf has a leading P axis). ``state_spec`` gives every leaf of the
state its spec on the production mesh, and ``shard_state`` places a state
by them: it checks that each spec divides its leaf and puts the leaf whole
on the one device the mesh names. PyTorch compiles nothing, so
``jit_train_step`` returns the step that ``build_train_step`` builds.

:class:`Server` serves a model: ``specs`` gives the parameters' and the
cache's specs (``shard_seq``: the cache's sequence axis over ``data``),
``abstract_cache`` the cache's shapes on the ``meta`` device, and
``shard_params`` / ``shard_cache`` place tensors as ``shard_state`` does.
``prefill`` / ``decode`` (which ``jit_prefill`` / ``jit_decode`` return)
run without autograd and write into the cache they are given, as the
reference's donated cache is consumed.

A mesh here is a :class:`~repro_torch.sharding.DeviceMesh` (``launch.mesh``)
or a tuple of devices, of ``mesh_cfg.n_devices`` entries. In one process it
names one device, however many times; a mesh of distinct devices there
raises ``NotImplementedError``; nothing falls back to one device.

In a world (``launch.world``: one process a device, the mesh its
``DeviceMesh``) both classes split the tensors over the ranks by their
specs (``sharding.ShardingPolicy`` under the world's rules:
``token_shift_whole``, ``in_proj_halves``, ``attention_whole``), at every
participant granularity and on a mesh with a ``pod`` axis:

* ``data_rank``: P over ``data`` (``("pod", "data")`` with ``multi_pod``),
  a rank holding P / data replicas, each replica's leaves over ``model``
  (tensor parallelism of the dense, RWKV-6, Hymba, Whisper and LLaVA
  families and expert parallelism of the MoE,
  ``models.layers.tensor_parallel``);
* ``chip``: P over every device, a rank holding P / n_devices whole
  replicas (the policy splits no leaf, so no layer meets another rank:
  ``ShardingPolicy.splits_model`` is false);
* ``pod``: P over ``pod`` (P = 1 without ``multi_pod``), each
  participant's leaves split over ``data`` as well as ``model`` (FSDP,
  ``models.layers.fully_sharded``: a leaf gathered over ``data`` where a
  layer reads it, its gradient reduce-scattered back; under ``cfg.remat``
  each block recomputes its forward, and its gathers, for its backward),
  and its batch rows over ``data``: each rank's loss is the mean over its
  rows, the participant's gradient the mean over ``data`` of the ranks'
  (leaves whole on ``data`` all-reduced), its loss the mean of the ranks'.
  A masked batch takes the participant's count of valid tokens (one
  all-reduce, ``models.layers.token_mean``), so ranks with unequal
  counts give one process's loss and gradient.

``init_state`` and ``Server.init_params`` draw a rank's shards leaf by
leaf (:func:`draw_local`, bit for bit the whole draw's slices),
``shard_state`` slices a whole state, ``gather_state`` gives the whole
state back. A step takes the whole batch and the whole ``(P,)`` weights,
which every rank's host code draws alike, and trains the rank's
participants on their batch rows; a gradient clip takes each
participant's norm over every shard of its gradient. The strategy's mix
gathers the P axis over the participant axes and applies the one-process
arithmetic, so the mix is bit for bit the one-process mix of the same
replicas (or, where the gathered replicas would not fit, reduces a
weighted mean's partials over them: :meth:`DistributedTrainer.mix_form`);
under FSDP it mixes each rank's shards, elementwise as whole leaves. The
server splits the batch over ``data``, the parameters by ``param_spec``
and the cache by ``cache_spec`` (kv heads, Whisper's cross kv heads or
RWKV-6's state heads over ``model``, under the same rules); ``prefill``
and ``decode`` take the whole batch and return the whole logits on every
rank. A cache split by sequence keeps the reference's spec: over
``model`` where the kv heads do not divide it (the world rule
``kv_whole``), over ``data`` under ``shard_seq``, whose batch and decode
token are whole on every ``data`` rank (each runs the whole prefill, and
the logits need no gather); the decode combines the ranks' partial
softmaxes (``models.layers.seq_split``). A MoE batch whose rank rows split
a routing group routes each token in one process's group: the ranks
gather their expert choices over the rows' axis and rebuild one process's
slots (``models.moe.routing``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import collectives, optim
from repro_torch.config import H100, MeshConfig, ModelConfig, TrainConfig
from repro_torch.core.strategy import (Strategy, build_strategy,
                                       weighted_mean_share)
from repro_torch.models import Model, build
from repro_torch.models import layers as L
from repro_torch.sharding import (DeviceMesh, ShardingPolicy, _k,
                                  axis_names, gather_over, gather_tree,
                                  local_shard, mesh_device, reduce_over)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (tree_flatten, tree_flatten_with_path,
                                      tree_leaves, tree_map)


class TrainState(NamedTuple):
    params: Any          # (P, ...) stacked replicas
    opt_state: Any       # (P, ...) per-participant optimizer state
    server_state: Any    # aggregator-side optimizer state (FedYogi etc.)
    round: torch.Tensor


def _mesh_and_device(mesh, mesh_cfg: MeshConfig, device):
    """``(mesh, device)``: the mesh checked against ``mesh_cfg`` and the one
    device it names (None: ``device``, else the card); a mesh of distinct
    devices raises ``NotImplementedError``."""
    if mesh is None:
        return None, resolve_device(device)
    if not isinstance(mesh, DeviceMesh):
        mesh = tuple(torch.device(d) for d in mesh)
    size = mesh.size if isinstance(mesh, DeviceMesh) else len(mesh)
    if size != mesh_cfg.n_devices:
        raise ValueError(f"a mesh of {size} entries for a MeshConfig of "
                         f"{mesh_cfg.n_devices} devices")
    if isinstance(mesh, DeviceMesh) and (
            mesh.dims, mesh.axis_names) != (mesh_cfg.shape, mesh_cfg.axes):
        raise ValueError(f"a mesh of {mesh.shape} for a MeshConfig of "
                         f"{dict(zip(mesh_cfg.axes, mesh_cfg.shape))}")
    home = resolve_device(mesh_device(mesh))
    dev = home if device is None else resolve_device(device)
    if dev != home:
        raise ValueError(f"the mesh names {home}, the caller {dev}")
    return mesh, dev


def _place(tree, specs, policy: ShardingPolicy, device):
    """Every tensor of ``tree`` whole on ``device``, once its spec (the
    matching leaf of ``specs``) is checked to divide it."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for leaf, spec in zip(leaves, treedef.flatten_up_to(specs)):
        if isinstance(leaf, torch.Tensor):
            if not policy.divides(spec, tuple(leaf.shape)):
                raise ValueError(f"spec {spec} does not divide a leaf of "
                                 f"shape {tuple(leaf.shape)}")
            leaf = leaf.to(device)
        out.append(leaf)
    return treedef.unflatten(out)


def _world_of(mesh):
    """``mesh`` where it is a world's (every granularity and mesh splits
    there), None outside a world."""
    if isinstance(mesh, DeviceMesh) and mesh.in_world:
        return mesh
    return None


def _rows(tree, mesh: DeviceMesh, axis, n_local: int, dim: int = 0):
    """Every leaf's rows (along ``dim``) of this rank's index along
    ``axis`` (a name, a tuple of names or None)."""
    i = mesh.axis_index(axis)
    return tree_map(lambda x: x.narrow(dim, i * n_local, n_local), tree)


def _stack_copies(tree, P):
    """P real copies of every leaf along a new leading axis (each slot is
    then updated on its own, so no slot may be a view of another)."""
    return tree_map(lambda x: x[None].repeat((P,) + (1,) * x.dim()), tree)


def fsdp_dims(params, specs, axis: str = "data"):
    """``{path: dim}``: the dimension of each leaf that ``specs`` (one
    participant's, matching ``params``) split over ``axis``, as the layers
    read it (``models.layers.fully_sharded``): a layer's leaves
    (``layers``, ``encoder``, ``decoder``) without the layer axis."""
    flat, treedef = tree_flatten_with_path(params)
    dims = {}
    for (path, _), spec in zip(flat, treedef.flatten_up_to(specs)):
        path = "/".join(_k(p) for p in path)
        for d, entry in enumerate(spec):
            if axis in axis_names(entry):
                stacked = path.split("/")[0] in ("layers", "encoder",
                                                 "decoder")
                dims[path] = d - 1 if stacked else d
    return dims


class _DrawOrder:
    """``layers.drawing``'s hook on a ``meta`` init: the order of the
    draws, and the draws each stack of blocks put together."""

    def __init__(self):
        self.order, self.stacks, self.keep = [], {}, []

    def drawn(self, w):
        self.order.append(id(w))
        self.keep.append(w)           # ids stay unique while it lives
        return w

    def stacked(self, parts, out):
        self.stacks[id(out)] = [id(p) for p in parts]
        self.keep += [out, *parts]


class _KeepSlices:
    """``layers.drawing``'s hook that keeps this rank's slice of each draw
    (``specs`` in the order of the draws)."""

    def __init__(self, specs, mesh):
        self.specs, self.mesh, self.k = specs, mesh, 0

    def drawn(self, w):
        spec = self.specs[self.k]
        self.k += 1
        return local_shard([w], [spec], self.mesh)[0]

    def stacked(self, parts, out):
        pass


def draw_local(model: Model, spec_of, mesh: DeviceMesh, seed: int, device):
    """This rank's slices of ``model.init(Generator(device).manual_seed(
    seed), device)`` by the specs ``spec_of(params)`` gives (one
    participant's), drawn leaf by leaf: each weight is sliced as it is
    drawn, so no rank holds more than one whole leaf at a time, and a stack
    of blocks stacks the slices. Bit for bit ``local_shard`` of the whole
    draw: the same draws, in the same order, sliced alike."""
    order = _DrawOrder()
    with L.drawing(order):
        meta = model.init(torch.Generator().manual_seed(0), "meta")
    flat, treedef = tree_flatten(meta)
    specs = treedef.flatten_up_to(spec_of(meta))
    spec_of_draw = {}
    for leaf, spec in zip(flat, specs):
        for part in order.stacks.get(id(leaf), ()):
            spec_of_draw[part] = spec[1:]           # a layer's slice
        spec_of_draw.setdefault(id(leaf), spec)
    keep = _KeepSlices([spec_of_draw[i] for i in order.order], mesh)
    del order
    with L.drawing(keep):
        params = model.init(torch.Generator(device=device).manual_seed(seed),
                            device)
    leaves = tree_flatten(params)[0]
    # what was not drawn (norms, constants) is still whole
    out = treedef.unflatten([
        local_shard([x], [spec], mesh)[0] if x.shape == w.shape else x
        for x, w, spec in zip(leaves, flat, specs)])
    if torch.device(device).type == "cuda":
        # the whole leaves' draws were the largest blocks the allocator
        # holds: give them back to the ranks that share the card
        torch.cuda.empty_cache()
    return out


def _dot64(a: torch.Tensor, b: torch.Tensor,
           chunk: int = 1 << 26) -> torch.Tensor:
    """The dot product of two tensors of one shape in float64, taken
    ``chunk`` elements at a time (a leaf of billions of elements would
    need three float64 copies of itself at once)."""
    a, b = a.reshape(-1), b.reshape(-1)
    return sum(torch.dot(a[i:i + chunk].double(), b[i:i + chunk].double())
               for i in range(0, a.numel(), chunk))


def _data_mean(grads, n: int):
    """One participant's gradient from the sum over its ``n`` FSDP ranks
    of their gradients, each of the rank's loss (the mean over its rows,
    or its share of the participant's masked mean scaled by ``n``,
    ``layers.token_mean``): the mean over the ranks."""
    return tree_map(lambda g: g / n, grads)


class DistributedTrainer:
    """The mesh form's round step over P participant replicas.

    ``mesh``: None, or a mesh of ``mesh_cfg.n_devices`` entries that all
    name ``device`` (None: the mesh's device, else the card).
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 mesh_cfg: MeshConfig, *, strategy: str = "modest",
                 mesh=None, device=None):
        self.cfg, self.tcfg, self.mesh_cfg = cfg, tcfg, mesh_cfg
        self.model: Model = build(cfg)
        self.policy = ShardingPolicy(cfg, mesh_cfg)
        self.strategy: Strategy = build_strategy(strategy, tcfg)
        self.mesh, self.device = _mesh_and_device(mesh, mesh_cfg, device)
        self.world = _world_of(self.mesh)
        # in a world the clip's norm spans a participant's shards (_clip)
        self.opt = optim.build(tcfg if self.world is None else
                               dataclasses.replace(tcfg, grad_clip=0.0))
        self._one = None

    @property
    def local_participants(self) -> int:
        """The participant replicas this process holds (P over the size of
        the participant axes in a world, else P)."""
        P = self.policy.n_participants
        if self.world is None:
            return P
        return P // self.world.axis_size(self.policy.part_axis)

    @property
    def shard_axes(self):
        """The mesh axes over which a world splits one participant's leaves
        (``model`` under tensor parallelism, ``data`` under FSDP)."""
        if self.world is None:
            return ()
        return (("model",) if self.policy.splits_model else ()) + (
            (self.policy.fsdp_axis,) if self.policy.splits_data else ())

    # ------------------------------------------------------------------ state

    def abstract_state(self) -> TrainState:
        """The state's shapes and dtypes, on the ``meta`` device."""
        P = self.policy.n_participants
        params = self.model.init(torch.Generator().manual_seed(0), "meta")
        opt_state = self.opt.init(params)
        stack = lambda t: tree_map(                          # noqa: E731
            lambda l: torch.empty((P,) + tuple(l.shape), dtype=l.dtype,
                                  device="meta"), t)
        params_P = stack(params)
        server = self.strategy.init_state(params_P)
        return TrainState(params_P, stack(opt_state), server,
                          torch.zeros((), dtype=torch.int32, device="meta"))

    def _one_spec(self, one):
        """One participant's parameter specs (in a world, its rules)."""
        return self.policy.param_spec(one, with_participants=False,
                                      world=self.world is not None)

    def init_state(self, seed: int = 0) -> TrainState:
        """P copies of one model drawn from ``seed`` on the trainer's
        device (placed by :meth:`shard_state` where there is a mesh). In a
        world, this rank's shard: its P / (participant axes) copies of its
        slices of the model, drawn leaf by leaf (:func:`draw_local`)."""
        P = self.policy.n_participants
        if self.world is not None:
            params = draw_local(self.model, self._one_spec, self.world, seed,
                                self.device)
            P = self.local_participants
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, self.device)
        params_P = _stack_copies(params, P)
        opt_P = _stack_copies(self.opt.init(params), P)
        del params
        server = self.strategy.init_state(params_P)
        state = TrainState(params_P, opt_P, server,
                           torch.zeros((), dtype=torch.int32,
                                       device=self.device))
        if self.mesh is not None and self.world is None:
            state = self.shard_state(state)
        return state

    def shard_state(self, state: TrainState) -> TrainState:
        """Place a whole state by :meth:`state_spec`: every spec checked
        to divide its leaf; every leaf whole on the trainer's device, or
        in a world this rank's slice of it."""
        if self.world is not None:
            state = tree_map(lambda x: x.to(self.device), state)
            return local_shard(state, self.state_spec(state), self.world)
        return _place(state, self.state_spec(state), self.policy,
                      self.device)

    def gather_state(self, state: TrainState) -> TrainState:
        """The whole state from every rank's shards (in a world; every
        rank takes part and gets it); the state itself outside one."""
        if self.world is None:
            return state
        return gather_tree(state, self.state_spec(self.abstract_state()),
                           self.world)

    def _one_participant(self):
        """One participant's parameter leaves on the ``meta`` device and
        their specs (flat, in ``tree_leaves`` order), made once."""
        if self._one is None:
            one = self.model.init(torch.Generator().manual_seed(0), "meta")
            self._one = one, tree_flatten(one)[1].flatten_up_to(
                self._one_spec(one))
        return self._one

    def _counts(self, spec) -> bool:
        """Whether this rank counts a leaf of ``spec`` in a sum over one
        participant's shards: a leaf whole on a shard axis counts once,
        on its rank 0 there."""
        named = {a for e in spec for a in axis_names(e)}
        return not any(a not in named and self.world.axis_index(a)
                       for a in self.shard_axes)

    def _reduce_shards(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the axes that split a participant
        (:attr:`shard_axes`): alike on every rank that holds it."""
        for a in self.shard_axes:
            collectives.all_reduce(t, self.world.group(a))
        return t

    def param_sketch(self, state: TrainState, k: int = 4) -> torch.Tensor:
        """``k`` seeded Gaussian projections of each parameter leaf of the
        first replica this process holds: ``(leaves, k)`` float64 on the
        CPU. In a world each rank projects its slice on the same slice of
        the whole leaf's directions and the axes that split a participant
        (``model``, and ``data`` under FSDP) sum the pieces, a leaf whole
        on an axis counted once, so a world and one process give the same
        numbers for the same replica, up to the order of the sums. The
        sketch is linear: two runs' changes from one start compare by
        relative norm without gathering a replica."""
        one, specs = self._one_participant()
        gen = torch.Generator(device=self.device)
        out = torch.zeros((len(specs), k), dtype=torch.float64,
                          device=self.device)
        for i, (x, w, spec) in enumerate(zip(tree_leaves(state.params),
                                             tree_leaves(one), specs)):
            if self.world is not None and not self._counts(spec):
                continue
            for j in range(k):
                gen.manual_seed(i * k + j)
                r = torch.randn(tuple(w.shape), generator=gen,
                                device=self.device)
                if self.world is not None:
                    r = local_shard([r], [spec], self.world)[0]
                out[i, j] = _dot64(x[0], r)
        if self.world is not None:
            self._reduce_shards(out)
        return out.cpu()

    # ------------------------------------------------------------- shardings

    def state_spec(self, state: TrainState):
        """The state's specs: parameter and optimizer leaves carry (P, ...)
        (the parameter rules of one participant, P's axis prepended);
        the server state takes the parameter rules, the round none (in a
        world, under the world's rules)."""
        part = self.policy.part_axis

        def stacked(tree):
            one = tree_map(lambda x: torch.empty(
                tuple(x.shape[1:]), dtype=x.dtype, device="meta"), tree)
            specs = self._one_spec(one)
            treedef = tree_flatten(one)[1]
            return treedef.unflatten(
                [(part,) + s for s in treedef.flatten_up_to(specs)])

        if tree_leaves(state.server_state):
            server_spec = self._one_spec(state.server_state)
        else:
            server_spec = tree_map(lambda _: (), state.server_state)
        return TrainState(stacked(state.params), stacked(state.opt_state),
                          server_spec, ())

    # ------------------------------------------------------------- train step

    def build_train_step(self, *, local_steps: int = 1, hop: int = 1,
                         accumulate: bool = False):
        """``train_step(state, batch, weights) -> (state, metrics)``;
        ``batch`` leaves ``(P, E, B, ...)`` (tokens, labels and any other
        input the family's loss reads, such as ``frames`` or
        ``image_embeds``), ``weights`` ``(P,)``.

        ``accumulate=False``: the E axis is MoDeST's sequential local SGD
        steps (one optimizer update a slice). ``accumulate=True``: the E
        axis is gradient-accumulation microbatches of ONE step, the mean of
        their gradients. Each participant's gradient is that of its own
        loss (``engine.lowering.stacked_value_and_grad``: the P losses
        under ``torch.func.vmap``, one backward pass of their sum; a loop
        over the participants where the loss issues collectives); the
        optimizer's update is vmapped over P, so its reductions (the
        clip's global norm, adamw's step count) are per participant; in a
        world the clip's norm is taken over every shard of a participant's
        gradient first (:meth:`_clip`). ``local_steps`` is read from the
        batch, as in the reference."""
        from repro_torch.models.tasks import refuse_flash_training

        cfg, world = self.cfg, self.world
        grads_of = self._grads_fn()
        update_of = torch.func.vmap(self.opt.update)

        def update(grads, opt_P, params_P):
            return update_of(self._clip(grads), opt_P, params_P)

        def train_step(state: TrainState, batch, weights):
            refuse_flash_training(cfg)
            batch = self._local_batch(batch)
            with self._in_world():
                return local_step(state, batch, weights)

        def local_step(state: TrainState, batch, weights):
            E = tree_leaves(batch)[0].shape[1]
            micro = [tree_map(lambda x: x[:, e], batch) for e in range(E)]
            params_P, opt_P = state.params, state.opt_state
            if accumulate:
                acc, loss_sum = None, 0.0
                for mb in micro:
                    loss, g = grads_of(params_P, mb)
                    acc = g if acc is None else tree_map(torch.add, acc, g)
                    loss_sum = loss_sum + loss
                grads = tree_map(lambda g: g / E, acc)
                del acc
                upd, opt_P = update(grads, opt_P, params_P)
                del grads
                params_P = optim.apply_updates(params_P, upd)
                del upd
                losses = loss_sum / E
            else:
                step_losses = []
                for mb in micro:
                    loss, grads = grads_of(params_P, mb)
                    upd, opt_P = update(grads, opt_P, params_P)
                    del grads       # no step holds more than one gradient
                    params_P = optim.apply_updates(params_P, upd)
                    del upd
                    step_losses.append(loss)
                losses = torch.mean(torch.stack(step_losses), dim=0)
            new_P, server = self._mix(state.params, params_P, weights,
                                      state.server_state, hop)
            if world is not None:
                losses = gather_over(losses, world, self.policy.part_axis)
            metrics = {"loss": torch.mean(losses),
                       "active": torch.sum(weights)}
            return TrainState(new_P, opt_P, server, state.round + 1), metrics

        return train_step

    def _grads_fn(self):
        """``grads_of(params_P, batch) -> (losses (P,), grads)`` of the
        local participants on their rows (``batch`` leaves ``(P, B,
        ...)``), before any clip: the vmapped form, or a loop over the
        participants where the loss issues collectives (tensor
        parallelism, FSDP). Under FSDP the leaves whole on ``data`` have
        their partial gradients summed there, and every gradient and loss
        is the mean over the ``data`` ranks (:func:`_data_mean`)."""
        from repro_torch.engine.lowering import (looped_value_and_grad,
                                                 stacked_value_and_grad)

        world = self.world
        fsdp = world is not None and self.policy.splits_data
        collective = fsdp or (world is not None and self.policy.splits_model)
        raw = (looped_value_and_grad if collective
               else stacked_value_and_grad)(self.model.loss_fn)
        if not fsdp:
            return raw
        axis = self.policy.fsdp_axis
        whole = [axis not in {a for e in s for a in axis_names(e)}
                 for s in self._one_participant()[1]]
        n = world.axis_size(axis)

        def grads_of(params_P, batch):
            loss, grads = raw(params_P, batch)
            group = world.group(axis)
            leaves, treedef = tree_flatten(grads)
            leaves = [collectives.reduce_from_group(g, group) if w else g
                      for g, w in zip(leaves, whole)]
            loss = collectives.all_reduce(loss.clone(), group) / n
            return loss, _data_mean(treedef.unflatten(leaves), n)

        return grads_of

    @contextlib.contextmanager
    def _in_world(self):
        """The layers' collectives of a world's step: tensor parallelism
        where the policy splits ``model``, FSDP where it splits ``data``
        (``cfg.remat`` honoured; the loss's means over every rank's rows,
        ``layers.split_rows``)."""
        world = self.world
        tp = world is not None and self.policy.splits_model
        fsdp = world is not None and self.policy.splits_data
        dims = {}
        if fsdp:
            one = self._one_participant()[0]
            dims = fsdp_dims(one, self._one_spec(one), self.policy.fsdp_axis)
        with L.tensor_parallel(world if tp else None), \
                L.fully_sharded(world if fsdp else None, dims,
                                remat=self.cfg.remat), \
                L.split_rows(world if fsdp else None, self.policy.batch_axis,
                             means=True):
            yield

    def _local_batch(self, batch):
        """This rank's part of a whole batch ``(P, E, B, ...)``: its
        participants' rows (:func:`_rows` over the participant axes) and,
        under FSDP, its rows of each (:meth:`_participant_rows`)."""
        if self.world is None:
            return batch
        batch = _rows(batch, self.world, self.policy.part_axis,
                      self.local_participants)
        if self.policy.splits_data:
            batch = self._participant_rows(batch)
        return batch

    def grads(self, state: TrainState, batch):
        """Each local participant's loss and gradient of the first local
        step of ``batch`` (a step's whole ``(P, E, B, ...)`` batch), as
        the step computes them before the clip: in a world this rank's
        shards of the gradients, which :meth:`gather_state`'s specs put
        back together."""
        batch = tree_map(lambda x: x[:, 0], self._local_batch(batch))
        with self._in_world():
            return self._grads_fn()(state.params, batch)

    def _participant_rows(self, batch):
        """This rank's contiguous rows of each participant's batch
        (``batch_axis``, dim 2 of ``(P, E, B, ...)``) under FSDP; rows
        ``data`` does not divide raise ``ValueError``. The loss's means
        over them are the participant's (``layers.split_rows``: a masked
        mean over the participant's valid tokens, the MoE's routing groups
        and load-balance loss one process's)."""
        axis = self.policy.batch_axis
        n = self.world.axis_size(axis)
        B = batch["tokens"].shape[2]
        if B % n:
            raise ValueError(f"a participant's {B} rows over {n} "
                             f"{axis} ranks")
        return _rows(batch, self.world, axis, B // n, dim=2)

    def _clip(self, grads):
        """In a world with ``tcfg.grad_clip``: each participant's gradient
        scaled by ``optim.clip_scale`` of its global norm, the squares
        summed over every shard (:meth:`_counts`, :meth:`_reduce_shards`),
        so every shard takes the same factor as one process's whole
        gradient; else ``grads``."""
        if self.world is None or not self.tcfg.grad_clip:
            return grads
        _, specs = self._one_participant()
        leaves, treedef = tree_flatten(grads)
        P = leaves[0].shape[0]
        sq = torch.zeros((P,), dtype=torch.float32, device=leaves[0].device)
        for g, spec in zip(leaves, specs):
            if self._counts(spec):
                sq = sq + torch.sum(torch.square(
                    g.to(torch.float32)).reshape(P, -1), dim=1)
        scale = optim.clip_scale(torch.sqrt(self._reduce_shards(sq)),
                                 self.tcfg.grad_clip)
        for g in leaves:            # the step's own gradient: in place
            g.mul_(scale.reshape((P,) + (1,) * (g.dim() - 1)).to(g.dtype))
        return grads

    def mix_form(self, new_P) -> str:
        """How a world's mix meets the other participant ranks:
        ``"gather"``, the whole P axis and the one-process arithmetic (bit
        for bit the one-process mix), or ``"reduce"``, a weighted mean's
        fp32 partials summed over the participant axes (at tolerance:
        another summation order). The reduction serves a plain weighted
        mean alone (modest and fedavg without a server optimizer), where
        the gathered replicas would take more than half the card's memory
        (``config.H100.hbm_bytes``): the state's own sizes decide, so a
        configuration takes one form on every device and in every run."""
        plain_mean = (self.strategy.name in ("modest", "fedavg")
                      and self.tcfg.server_optimizer in ("avg", "sgd"))
        need = self.world.axis_size(self.policy.part_axis) * sum(
            x.numel() * x.element_size() for x in tree_leaves(new_P))
        return "reduce" if plain_mean and need > H100.hbm_bytes / 2 \
            else "gather"

    def _mix(self, prev_P, new_P, weights, server_state, hop):
        """The strategy's mix; in a world, by :meth:`mix_form`: of the
        whole P axis gathered over the participant axes (this rank's rows
        kept), or the weighted mean's shares
        (``strategy.weighted_mean_share``) summed over them. Under FSDP
        each rank mixes its shards (the mix is elementwise over P)."""
        if self.world is None:
            return self.strategy.mix(prev_P, new_P, weights, server_state,
                                     hop)
        axis = self.policy.part_axis
        if self.mix_form(new_P) == "reduce":
            n = self.local_participants
            i = self.world.axis_index(axis)
            share = weighted_mean_share(weights, slice(i * n, (i + 1) * n),
                                        getattr(torch, self.tcfg.agg_dtype))

            def reduced(x):
                part = reduce_over(share(x), self.world, axis)
                return part.to(x.dtype)[None].expand(x.shape).contiguous()

            return tree_map(reduced, new_P), server_state

        def whole(tree):
            return tree_map(lambda x: gather_over(x, self.world, axis),
                            tree)

        # only the server optimizer reads the replicas before the round
        reads_prev = (self.strategy.name in ("modest", "fedavg")
                      and self.tcfg.server_optimizer not in ("avg", "sgd"))
        out, server_state = self.strategy.mix(
            whole(prev_P) if reads_prev else prev_P, whole(new_P), weights,
            server_state, hop)
        out = _rows(out, self.world, axis, self.local_participants)
        return tree_map(lambda x: x.contiguous(), out), server_state

    def jit_train_step(self, state_template: Optional[TrainState] = None,
                       batch_template=None, **kw):
        """The step of :meth:`build_train_step`: PyTorch compiles nothing,
        and the templates, which set a mesh's placements in the reference,
        are not read."""
        del state_template, batch_template
        return self.build_train_step(**kw)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


class Server:
    """Batched serving: prefill + single-token decode.

    ``mesh_cfg`` (None: one device) sets the specs; ``mesh`` (None: serve
    on ``device``, else the card) names the device, as for
    :class:`DistributedTrainer`."""

    def __init__(self, cfg: ModelConfig, mesh_cfg: Optional[MeshConfig] = None,
                 *, mesh=None, shard_seq: bool = False, device=None):
        if mesh_cfg is None:
            mesh_cfg = MeshConfig(data=1, model=1)
        self.cfg = cfg
        self.model: Model = build(cfg)
        self.policy = ShardingPolicy(cfg, mesh_cfg)
        self.mesh, self.device = _mesh_and_device(mesh, mesh_cfg, device)
        self.shard_seq = shard_seq
        self.world = _world_of(self.mesh)
        self._dims = None

    def init_params(self, seed: int = 0):
        """The parameters drawn from ``seed`` on the server's device, as
        ``model.init(Generator(device).manual_seed(seed), device)`` draws
        them, placed by :meth:`shard_params`; in a world this rank's
        slices, drawn leaf by leaf (:func:`draw_local`)."""
        if self.world is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return self.shard_params(self.model.init(gen, self.device))
        return draw_local(self.model, lambda t: self.policy.param_spec(
            t, with_participants=False, world=True), self.world, seed,
            self.device)

    def abstract_cache(self, batch_size: int, max_len: int):
        """The cache's shapes and dtypes, on the ``meta`` device."""
        return self.model.init_cache(batch_size, max_len, "meta")

    def specs(self, params_t, cache_t):
        """The parameters' and the cache's specs (in a world, under the
        world's rules)."""
        world = self.world is not None
        pspec = self.policy.param_spec(params_t, with_participants=False,
                                       world=world)
        cspec = self.policy.cache_spec(cache_t, shard_seq=self.shard_seq,
                                       world=world)
        return pspec, cspec

    def shard_params(self, params):
        """Place whole params by their specs on the server's device (in a
        world: this rank's slices)."""
        spec = self.policy.param_spec(params, with_participants=False,
                                      world=self.world is not None)
        if self.world is not None:
            return local_shard(tree_map(lambda x: x.to(self.device), params),
                               spec, self.world)
        return _place(params, spec, self.policy, self.device)

    def shard_cache(self, cache):
        """Place a whole cache by its specs (in a world: this rank's
        slices, batch rows over ``data``, kv or state heads over ``model``
        and the sequence over the axis the spec names, under the world's
        rules). A world's placed cache carries the axes that split its
        sequence under ``"seq_axes"`` (``{"k": axis, "xk": axis}``, None:
        whole), which :meth:`prefill` and :meth:`decode` read from the
        cache they are given (a cache without them is taken whole along
        its sequence)."""
        spec = self.policy.cache_spec(cache, shard_seq=self.shard_seq,
                                      world=self.world is not None)
        if self.world is not None:
            cache = tree_map(lambda x: x.to(self.device)
                             if isinstance(x, torch.Tensor) else x, cache)
            return dict(local_shard(cache, spec, self.world),
                        seq_axes={name: ShardingPolicy.seq_axis(spec, name)
                                  for name in ("k", "xk")})
        return _place(cache, spec, self.policy, self.device)

    def jit_prefill(self, params_t, batch_t, cache_t):
        """The prefill callable, :meth:`prefill`: PyTorch compiles nothing,
        and the templates, which set a mesh's placements in the reference,
        are not read."""
        del params_t, batch_t, cache_t
        return self.prefill

    def jit_decode(self, params_t, cache_t, batch_size: Optional[int] = None):
        """The decode callable, :meth:`decode` (templates as in
        :meth:`jit_prefill`)."""
        del params_t, cache_t, batch_size
        return self.decode

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        return self._serve(self.model.prefill, params, batch, cache)

    @torch.no_grad()
    def decode(self, params, token, cache):
        return self._serve(self.model.decode_step, params, token, cache)

    def _serve(self, fn, params, batch, cache):
        """``fn(params, batch, cache)``; in a world, on this rank's batch
        rows (``data``; under ``shard_seq`` the whole batch) and shards
        (``model`` where the policy splits it; ``data`` too under FSDP,
        each leaf gathered where it is read) and on its chunk of the
        cache's sequence (the cache's ``seq_axes``, ``layers.seq_split``),
        the logits gathered over
        ``data`` where the rows were split: every rank returns the whole
        logits and its own cache."""
        if self.world is None:
            return fn(params, batch, cache)
        B = tree_leaves(batch)[0].shape[0]
        rows = None if self.shard_seq else "data"
        n = self.world.axis_size(rows)
        if B % n:
            raise ValueError(f"a batch of {B} over {n} data ranks")
        fsdp = self.policy.splits_data
        if fsdp and self._dims is None:
            meta = self.model.init(torch.Generator().manual_seed(0), "meta")
            self._dims = fsdp_dims(meta, self.policy.param_spec(
                meta, with_participants=False, world=True),
                self.policy.fsdp_axis)
        with L.tensor_parallel(self.world if self.policy.splits_model
                               else None), \
                L.fully_sharded(self.world if fsdp else None,
                                self._dims or {}), \
                L.split_rows(self.world, rows), \
                L.seq_split(self.world, cache.get("seq_axes", {})):
            logits, cache = fn(params, _rows(batch, self.world, rows,
                                             B // n), cache)
        if n > 1:
            logits = collectives.all_gather(logits, self.world.group(rows))
        return logits, cache
