"""Flat-space optimizers for the batched cohort engine.

The update rules in :mod:`repro_torch.optim` are leaf-wise elementwise
(plus a per-model global-norm clip), so on a ``(S, N)`` stack of flat
models they are exact row-wise vector ops — no pytree traffic in the hot
loop. Each builder mirrors ``optim.build(tcfg)`` in fp32 so the batched
trajectory matches the sequential one to float tolerance.

State layout: a dict of ``(S, N)`` buffers (plus ``(S,)`` step counts for
adam). The cohort step gates state advancement with the per-row ``active``
mask so padded step slots are exact no-ops.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.config import TrainConfig


class FlatOptimizer(NamedTuple):
    init: Callable    # (S, N) params -> state dict
    update: Callable  # (grads (S,N), state, params) -> (updates, state)


def _clip_rows(g, max_norm):
    norm = torch.sqrt(torch.sum(torch.square(g), dim=1, keepdim=True))
    return g * torch.clamp_max(max_norm / (norm + 1e-12), 1.0)


def build_flat(cfg: TrainConfig) -> FlatOptimizer:
    name = cfg.optimizer
    lr, wd = cfg.lr, cfg.weight_decay

    if name in ("sgd", "avg"):
        def init(p):
            return {}

        def update(g, state, p):
            if wd:
                g = g + wd * p
            return -lr * g, state

    elif name == "momentum":
        beta = cfg.momentum or 0.9

        def init(p):
            return {"m": torch.zeros_like(p)}

        def update(g, state, p):
            if wd:
                g = g + wd * p
            m = beta * state["m"] + g
            return -lr * m, {"m": m}

    elif name == "adamw":
        b1, b2, eps = 0.9, 0.999, 1e-8

        def init(p):
            return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p),
                    "count": torch.zeros((p.shape[0],), dtype=torch.float32,
                                         device=p.device)}

        def update(g, state, p):
            c = state["count"] + 1.0
            mu = b1 * state["mu"] + (1 - b1) * g
            nu = b2 * state["nu"] + (1 - b2) * torch.square(g)
            mh = mu / (1 - b1 ** c)[:, None]
            nh = nu / (1 - b2 ** c)[:, None]
            upd = -lr * mh / (torch.sqrt(nh) + eps)
            if wd:
                upd = upd - lr * wd * p
            return upd, {"mu": mu, "nu": nu, "count": c}

    elif name == "yogi":
        b1, b2, eps = 0.9, 0.99, 1e-3

        def init(p):
            return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

        def update(g, state, p):
            g2 = torch.square(g)
            mu = b1 * state["mu"] + (1 - b1) * g
            nu = state["nu"] - (1 - b2) * g2 * torch.sign(state["nu"] - g2)
            return -lr * mu / (torch.sqrt(nu) + eps), {"mu": mu, "nu": nu}

    else:
        raise ValueError(f"unknown optimizer {name!r}")

    if cfg.grad_clip:
        inner = update

        def update(g, state, p, _inner=inner):   # noqa: F811
            return _inner(_clip_rows(g, cfg.grad_clip), state, p)

    return FlatOptimizer(init, update)
