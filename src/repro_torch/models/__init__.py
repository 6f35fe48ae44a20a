"""Model zoo: architectures as pure init/apply functions on dicts of tensors.

``build(cfg)`` dispatches on ``cfg.family`` and returns a :class:`Model`
bundle with a uniform interface:

    init(generator, device=None)       -> params
    loss_fn(params, batch)             -> (loss, metrics)

Only the ``cnn`` family is part of this package so far.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.config import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "cnn":
        from repro_torch.models import cnn as m
    elif cfg.family in ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "mf"):
        raise NotImplementedError(f"family {cfg.family!r}: later slice")
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: m.init(generator, cfg, device),
        loss_fn=lambda params, batch: m.loss_fn(params, cfg, batch),
    )
