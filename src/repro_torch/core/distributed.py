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
(every leaf has a leading P axis); a mesh here is a tuple of devices that
names that one device (``launch/train.py --mode mesh``), and the
reference's placement of the stack on a mesh of distinct cards
(``state_spec``, ``shard_state``) is not part of this package. PyTorch
compiles nothing, so ``jit_train_step`` returns the step that
``build_train_step`` builds.

:class:`Server` serves on one device: ``shard_params`` / ``shard_cache``
place tensors on it, and ``prefill`` / ``decode`` take the place of the
reference's ``jit_prefill`` / ``jit_decode``. They run without autograd;
both write into the cache they are given, as the reference's donated
cache is consumed. The reference's ``shard_seq`` (sequence-sharded cache
specs), ``specs`` and ``abstract_cache`` describe a mesh and have no
counterpart here; a mesh of more than one device raises.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import optim
from repro_torch.config import MeshConfig, ModelConfig, TrainConfig
from repro_torch.core.strategy import Strategy, build_strategy
from repro_torch.models import Model, build
from repro_torch.sharding import ShardingPolicy
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any          # (P, ...) stacked replicas
    opt_state: Any       # (P, ...) per-participant optimizer state
    server_state: Any    # aggregator-side optimizer state (FedYogi etc.)
    round: torch.Tensor


def _stack_copies(tree, P):
    """P real copies of every leaf along a new leading axis (each slot is
    then updated on its own, so no slot may be a view of another)."""
    return tree_map(lambda x: x[None].repeat((P,) + (1,) * x.dim()), tree)


class DistributedTrainer:
    """The mesh form's round step over P participant replicas.

    ``mesh``: None, or a tuple of devices that all name ``device`` (None:
    the mesh's device, else the card); its length is
    ``mesh_cfg.n_devices``.
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 mesh_cfg: MeshConfig, *, strategy: str = "modest",
                 mesh=None, device=None):
        self.cfg, self.tcfg, self.mesh_cfg = cfg, tcfg, mesh_cfg
        self.model: Model = build(cfg)
        self.policy = ShardingPolicy(cfg, mesh_cfg)
        self.strategy: Strategy = build_strategy(strategy, tcfg)
        self.opt = optim.build(tcfg)
        if mesh is not None:
            mesh = tuple(torch.device(d) for d in mesh)
            if len(mesh) != mesh_cfg.n_devices:
                raise ValueError(f"a mesh of {len(mesh)} entries for a "
                                 f"MeshConfig of {mesh_cfg.n_devices} "
                                 "devices")
            if len(set(mesh)) > 1:
                raise NotImplementedError(
                    "a mesh of distinct devices: the participants lie "
                    "stacked on one device (ROADMAP A12)")
            if device is None:
                device = mesh[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        if mesh is not None and mesh[0] != self.device:
            raise ValueError(f"the mesh names {mesh[0]}, the trainer "
                             f"{self.device}")

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
        device."""
        P = self.policy.n_participants
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen, self.device)
        params_P = _stack_copies(params, P)
        opt_P = _stack_copies(self.opt.init(params), P)
        del params
        server = self.strategy.init_state(params_P)
        return TrainState(params_P, opt_P, server,
                          torch.zeros((), dtype=torch.int32,
                                      device=self.device))

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
        from repro_torch.engine.lowering import stacked_value_and_grad
        from repro_torch.models.tasks import refuse_flash_training

        cfg, model, opt, strategy = self.cfg, self.model, self.opt, \
            self.strategy
        grads_of = stacked_value_and_grad(model.loss_fn)
        update_of = torch.func.vmap(opt.update)

        def train_step(state: TrainState, batch, weights):
            refuse_flash_training(cfg)
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
            new_P, server = strategy.mix(state.params, params_P, weights,
                                         state.server_state, hop)
            metrics = {"loss": torch.mean(losses),
                       "active": torch.sum(weights)}
            return TrainState(new_P, opt_P, server, state.round + 1), metrics

        return train_step

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
    """Batched serving: prefill + single-token decode."""

    def __init__(self, cfg: ModelConfig, mesh_cfg: Optional[MeshConfig] = None,
                 *, device=None):
        if mesh_cfg is not None and mesh_cfg.n_devices > 1:
            raise NotImplementedError(
                f"a mesh of {mesh_cfg.n_devices} devices: the package serves "
                "on one device until the mesh form lands (ROADMAP A12)")
        self.cfg = cfg
        self.model: Model = build(cfg)
        self.device = resolve_device(device)

    def _place(self, tree):
        return tree_map(
            lambda x: x.to(self.device) if isinstance(x, torch.Tensor) else x,
            tree)

    def shard_params(self, params):
        """Place host-initialized params on the server's device."""
        return self._place(params)

    def shard_cache(self, cache):
        return self._place(cache)

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        return self.model.prefill(params, batch, cache)

    @torch.no_grad()
    def decode(self, params, token, cache):
        return self.model.decode_step(params, token, cache)
