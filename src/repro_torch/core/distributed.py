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
specs. The trainer's participants are split over ``data`` (``data_rank``
granularity: a rank holds P / data replicas) and each replica's leaves
over ``model`` (tensor parallelism of the dense, RWKV-6, Hymba, Whisper
and LLaVA families and expert parallelism of the MoE,
``models.layers.tensor_parallel``), by the specs under the world's rules
(``sharding``: ``token_shift_whole``, ``in_proj_halves``,
``attention_whole``);
``init_state`` and ``shard_state`` give a rank its shards
(``sharding.local_shard``), ``gather_state`` the whole state back. A step
takes the whole batch and the whole ``(P,)`` weights, which every rank's
host code draws alike, and trains the rank's
participants on their batch rows; the strategy's mix gathers the P axis
over ``data`` and applies the one-process arithmetic, so the mix is bit
for bit the one-process mix of the same replicas (or, where the gathered
replicas would not fit, reduces a weighted mean's partials over ``data``:
:meth:`DistributedTrainer.mix_form`). The server splits the
batch over ``data``, the parameters by ``param_spec`` and the cache by
``cache_spec`` (kv heads, Whisper's cross kv heads or RWKV-6's state
heads over ``model``, under the same rules); ``prefill`` and ``decode``
take
the whole batch and return the whole logits on every rank; a MoE batch
whose rank's tokens would route in other groups than one process's, where
a group could drop slots, raises (``models.moe.rank_groups_match``).
Other granularities than ``data_rank``, a ``pod`` axis, a gradient clip
under tensor parallelism and a cache split by sequence raise
``NotImplementedError`` (ROADMAP A12b-3).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import collectives, optim
from repro_torch.config import H100, MeshConfig, ModelConfig, TrainConfig
from repro_torch.core.strategy import (Strategy, build_strategy,
                                       weighted_mean_share)
from repro_torch.models import Model, build
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.sharding import (DeviceMesh, ShardingPolicy, _k,
                                  axis_names, gather_tree, local_shard,
                                  mesh_device)
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


def _world_of(mesh, cfg: ModelConfig, policy: ShardingPolicy, what: str):
    """``mesh`` where it is a world's, after checking that this slice
    splits ``cfg`` there (every LM family splits over ``model``); None
    outside a world."""
    if not (isinstance(mesh, DeviceMesh) and mesh.in_world):
        return None
    if what == "training" and (cfg.participant_granularity != "data_rank"
                               or "pod" in mesh.axis_names):
        raise NotImplementedError(
            f"training at {cfg.participant_granularity!r} granularity on "
            f"a {mesh.axis_names} world (ROADMAP A12b-3: data_rank on "
            "data x model)")
    return mesh


def _rows(tree, mesh: DeviceMesh, axis, n_local: int):
    """Every leaf's rows (dim 0) of this rank's index along ``axis``."""
    i = mesh.axis_index(axis)
    return tree_map(lambda x: x[i * n_local:(i + 1) * n_local], tree)


def _stack_copies(tree, P):
    """P real copies of every leaf along a new leading axis (each slot is
    then updated on its own, so no slot may be a view of another)."""
    return tree_map(lambda x: x[None].repeat((P,) + (1,) * x.dim()), tree)


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
        self.opt = optim.build(tcfg)
        self.mesh, self.device = _mesh_and_device(mesh, mesh_cfg, device)
        self.world = _world_of(self.mesh, cfg, self.policy, "training")
        if self.world is not None and self.world.axis_size("model") > 1 \
                and tcfg.grad_clip:
            raise NotImplementedError(
                "a gradient clip under tensor parallelism across ranks "
                "(ROADMAP A12b-3)")

    @property
    def local_participants(self) -> int:
        """The participant replicas this process holds (P / data in a
        world, else P)."""
        P = self.policy.n_participants
        if self.world is None:
            return P
        return P // self.world.axis_size(self.policy.part_axis)

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

    def init_state(self, seed: int = 0) -> TrainState:
        """P copies of one model drawn from ``seed`` on the trainer's
        device (placed by :meth:`shard_state` where there is a mesh). In a
        world, this rank's shard: its P / data copies of its slices of the
        model."""
        P = self.policy.n_participants
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen, self.device)
        if self.world is not None:
            params = local_shard(params, self.policy.param_spec(
                params, with_participants=False, world=True), self.world)
            P = self.local_participants
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

    def param_sketch(self, state: TrainState, k: int = 4) -> torch.Tensor:
        """``k`` seeded Gaussian projections of each parameter leaf of the
        first replica this process holds: ``(leaves, k)`` float64 on the
        CPU. In a world each rank projects its slice on the same slice of
        the whole leaf's directions and the ``model`` axis sums the
        pieces, so a world and one process give the same numbers for the
        same replica, up to the order of the sums. The sketch is linear:
        two runs' changes from one start compare by relative norm without
        gathering a replica."""
        tp = self.world is not None and self.world.axis_size("model") > 1
        whole = self.abstract_state().params
        one = tree_map(lambda x: torch.empty(tuple(x.shape[1:]),
                                             dtype=x.dtype, device="meta"),
                       whole)
        specs = tree_flatten(one)[1].flatten_up_to(self.policy.param_spec(
            one, with_participants=False, world=self.world is not None))
        gen = torch.Generator(device=self.device)
        out = torch.zeros((len(specs), k), dtype=torch.float64,
                          device=self.device)
        for i, (x, w, spec) in enumerate(zip(tree_leaves(state.params),
                                             tree_leaves(one), specs)):
            split = tp and any("model" in axis_names(a) for a in spec)
            if tp and not split and self.world.axis_index("model"):
                continue            # one model rank holds the whole leaf
            for j in range(k):
                gen.manual_seed(i * k + j)
                r = torch.randn(tuple(w.shape), generator=gen,
                                device=self.device)
                if self.world is not None:
                    r = local_shard([r], [spec], self.world)[0]
                out[i, j] = torch.sum(x[0].double() * r.double())
        if tp:
            collectives.all_reduce(out, self.world.group("model"))
        return out.cpu()

    # ------------------------------------------------------------- shardings

    def state_spec(self, state: TrainState):
        """The state's specs: parameter and optimizer leaves carry (P, ...)
        (the parameter rules of one participant, P's axis prepended);
        the server state takes the parameter rules, the round none (in a
        world, under the world's rules)."""
        part = self.policy.part_axis
        world = self.world is not None

        def stacked(tree):
            one = tree_map(lambda x: torch.empty(
                tuple(x.shape[1:]), dtype=x.dtype, device="meta"), tree)
            specs = self.policy.param_spec(one, with_participants=False,
                                           world=world)
            treedef = tree_flatten(one)[1]
            return treedef.unflatten(
                [(part,) + s for s in treedef.flatten_up_to(specs)])

        if tree_leaves(state.server_state):
            server_spec = self.policy.param_spec(state.server_state,
                                                 with_participants=False,
                                                 world=world)
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
        under ``torch.func.vmap``, one backward pass of their sum); the
        optimizer's update is vmapped over P, so its
        reductions (the clip's global norm, adamw's step count) are per
        participant. ``local_steps`` is read from the batch, as in the
        reference."""
        from repro_torch.engine.lowering import (looped_value_and_grad,
                                                 stacked_value_and_grad)
        from repro_torch.models.tasks import refuse_flash_training

        cfg, model, opt, strategy = self.cfg, self.model, self.opt, \
            self.strategy
        world = self.world
        tp = world is not None and world.axis_size("model") > 1
        grads_of = (looped_value_and_grad if tp
                    else stacked_value_and_grad)(model.loss_fn)
        update_of = torch.func.vmap(opt.update)

        def train_step(state: TrainState, batch, weights):
            refuse_flash_training(cfg)
            if world is None:
                return local_step(state, batch, weights)
            batch = _rows(batch, world, self.policy.part_axis,
                          self.local_participants)
            with L.tensor_parallel(world):
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
                upd, opt_P = update_of(grads, opt_P, params_P)
                params_P = optim.apply_updates(params_P, upd)
                losses = loss_sum / E
            else:
                step_losses = []
                for mb in micro:
                    loss, grads = grads_of(params_P, mb)
                    upd, opt_P = update_of(grads, opt_P, params_P)
                    params_P = optim.apply_updates(params_P, upd)
                    step_losses.append(loss)
                losses = torch.mean(torch.stack(step_losses), dim=0)
            new_P, server = self._mix(state.params, params_P, weights,
                                      state.server_state, hop)
            if world is not None:
                losses = collectives.all_gather(
                    losses, world.group(self.policy.part_axis))
            metrics = {"loss": torch.mean(losses),
                       "active": torch.sum(weights)}
            return TrainState(new_P, opt_P, server, state.round + 1), metrics

        return train_step

    def mix_form(self, new_P) -> str:
        """How a world's mix meets the other ``data`` ranks: ``"gather"``,
        the whole P axis and the one-process arithmetic (bit for bit the
        one-process mix), or ``"reduce"``, a weighted mean's fp32 partials
        summed over ``data`` (at tolerance: another summation order). The
        reduction serves a plain weighted mean alone (modest and fedavg
        without a server optimizer), where the gathered replicas would take
        more than half the card's memory (``config.H100.hbm_bytes``): the
        state's own sizes decide, so a configuration takes one form on
        every device and in every run."""
        plain_mean = (self.strategy.name in ("modest", "fedavg")
                      and self.tcfg.server_optimizer in ("avg", "sgd"))
        need = self.world.axis_size(self.policy.part_axis) * sum(
            x.numel() * x.element_size() for x in tree_leaves(new_P))
        return "reduce" if plain_mean and need > H100.hbm_bytes / 2 \
            else "gather"

    def _mix(self, prev_P, new_P, weights, server_state, hop):
        """The strategy's mix; in a world, by :meth:`mix_form`: of the
        whole P axis gathered over ``data`` (this rank's rows kept), or the
        weighted mean's shares (``strategy.weighted_mean_share``) summed
        over ``data``."""
        if self.world is None:
            return self.strategy.mix(prev_P, new_P, weights, server_state,
                                     hop)
        group = self.world.group(self.policy.part_axis)
        if self.mix_form(new_P) == "reduce":
            n = self.local_participants
            i = self.world.axis_index(self.policy.part_axis)
            share = weighted_mean_share(weights, slice(i * n, (i + 1) * n),
                                        getattr(torch, self.tcfg.agg_dtype))

            def reduced(x):
                part = collectives.all_reduce(share(x), group)
                return part.to(x.dtype)[None].expand(x.shape).contiguous()

            return tree_map(reduced, new_P), server_state

        def whole(tree):
            return tree_map(lambda x: collectives.all_gather(x, group),
                            tree)

        # only the server optimizer reads the replicas before the round
        reads_prev = (self.strategy.name in ("modest", "fedavg")
                      and self.tcfg.server_optimizer not in ("avg", "sgd"))
        out, server_state = self.strategy.mix(
            whole(prev_P) if reads_prev else prev_P, whole(new_P), weights,
            server_state, hop)
        out = _rows(out, self.world, self.policy.part_axis,
                    self.local_participants)
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
        self.world = _world_of(self.mesh, cfg, self.policy, "serving")
        if self.world is not None and shard_seq:
            raise NotImplementedError("a cache split by sequence across "
                                      "ranks (ROADMAP A12b-3)")

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
        slices, batch rows over ``data`` and kv or state heads over
        ``model``, under the world's rules; a spec that splits the sequence
        raises)."""
        spec = self.policy.cache_spec(cache, shard_seq=self.shard_seq,
                                      world=self.world is not None)
        if self.world is not None:
            for (path, _), s in zip(tree_flatten_with_path(cache)[0],
                                    tree_flatten(cache)[1].flatten_up_to(
                                        spec)):
                if _k(path[-1]) in ("k", "v", "xk", "xv") and s[2]:
                    raise NotImplementedError(
                        f"a cache spec {s} splits the sequence (kv heads "
                        "the model axis does not divide; ROADMAP A12b-3)")
            cache = tree_map(lambda x: x.to(self.device)
                             if isinstance(x, torch.Tensor) else x, cache)
            return local_shard(cache, spec, self.world)
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
        rows (``data``) and shards (``model``), the logits gathered over
        ``data``: every rank returns the whole logits and its own
        cache."""
        if self.world is None:
            return fn(params, batch, cache)
        tokens = tree_leaves(batch)[0]
        B = tokens.shape[0]
        n = self.world.axis_size("data")
        if B % n:
            raise ValueError(f"a batch of {B} over {n} data ranks")
        if self.cfg.family == "moe" and not moe.rank_groups_match(
                self.cfg, tokens.numel(), n):
            raise NotImplementedError(
                f"routing {tokens.numel()} tokens in groups split over {n} "
                "data ranks, where a group could drop other slots than one "
                "process's (ROADMAP A12b-3)")
        with L.tensor_parallel(self.world):
            logits, cache = fn(params, _rows(batch, self.world, "data",
                                             B // n), cache)
        return collectives.all_gather(logits, self.world.group("data")), \
            cache
