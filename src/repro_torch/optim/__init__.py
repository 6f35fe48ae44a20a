"""Optimizers: a small functional set with the exact update rules the paper
and its FL variants need.

An optimizer is a pair of pure functions bundled in :class:`Optimizer`:

    init(params)                 -> state
    update(grads, state, params) -> (updates, state)

``apply_updates`` adds the updates. ``yogi`` implements the server-side
optimizer of FedYogi (Reddi et al., 2021), which the paper singles out as
directly implementable on MoDeST aggregators (§5).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.utils.pytree import (tree_global_norm, tree_leaves, tree_map,
                                      tree_zeros_like)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------------------


def sgd(lr: float, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        if weight_decay and params is not None:
            return tree_map(lambda g, p: -lr * (g + weight_decay * p),
                            grads, params), state
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False,
             weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return tree_zeros_like(params)

    def update(grads, state, params=None):
        if weight_decay and params is not None:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        new_m = tree_map(lambda m, g: beta * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr * (beta * m + g), new_m, grads)
        else:
            upd = tree_map(lambda m: -lr * m, new_m)
        return upd, new_m

    return Optimizer(init, update)


class _AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def _zero_count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return _AdamState(tree_zeros_like(params), tree_zeros_like(params),
                          _zero_count(params))

    def update(grads, state, params=None):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                      state.nu, grads)
        c = count.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - b1 ** c)
        nu_hat_scale = 1.0 / (1 - b2 ** c)

        def u(m, v, p):
            step = -lr * (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale)
                                               + eps)
            if weight_decay and p is not None:
                step = step - lr * weight_decay * p
            return step

        if params is None:
            upd = tree_map(lambda m, v: u(m, v, None), mu, nu)
        else:
            upd = tree_map(u, mu, nu, params)
        return upd, _AdamState(mu, nu, count)

    return Optimizer(init, update)


def yogi(lr: float, b1: float = 0.9, b2: float = 0.99,
         eps: float = 1e-3) -> Optimizer:
    """Yogi (used server-side for FedYogi): v += (1-b2) * g^2 * sign(g^2 - v)."""

    def init(params):
        return _AdamState(tree_zeros_like(params), tree_zeros_like(params),
                          _zero_count(params))

    def update(grads, state, params=None):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(
            lambda v, g: v - (1 - b2) * torch.square(g)
            * torch.sign(v - torch.square(g)),
            state.nu, grads)
        upd = tree_map(lambda m, v: -lr * m / (torch.sqrt(v) + eps), mu, nu)
        return upd, _AdamState(mu, nu, count)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------


def clip_scale(norm, max_norm: float):
    """The factor that brings a gradient of global norm ``norm`` within
    ``max_norm`` (1 where it is within already)."""
    return torch.clamp_max(max_norm / (norm + 1e-12), 1.0)


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """``opt`` on the gradient scaled by :func:`clip_scale` of its global
    norm. Across ranks, where one gradient lies in shards, the norm is
    taken over every shard (``core.distributed.DistributedTrainer``)."""
    def update(grads, state, params=None):
        scale = clip_scale(tree_global_norm(grads), max_norm)
        grads = tree_map(lambda g: g * scale, grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0):
    """``lr_at(step)``: a linear warm-up over ``warmup`` steps, then a
    cosine decay from ``base_lr`` to 0 at ``total_steps`` (fp32)."""
    def lr_at(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr_at


def build(cfg: TrainConfig, server: bool = False) -> Optimizer:
    """Build the client- or server-side optimizer from a TrainConfig."""
    name = cfg.server_optimizer if server else cfg.optimizer
    lr = cfg.server_lr if server else cfg.lr
    if name in ("sgd", "avg"):
        opt = sgd(lr, cfg.weight_decay if not server else 0.0)
    elif name == "momentum":
        opt = momentum(lr, cfg.momentum or 0.9, weight_decay=cfg.weight_decay)
    elif name == "adamw":
        opt = adamw(lr, weight_decay=cfg.weight_decay)
    elif name == "yogi":
        opt = yogi(lr)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if cfg.grad_clip and not server:
        opt = clip_by_global_norm(opt, cfg.grad_clip)
    return opt
