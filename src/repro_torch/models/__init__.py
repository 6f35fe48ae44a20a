"""Model zoo: architectures as pure init/apply functions on dicts of tensors.

``build(cfg)`` dispatches on ``cfg.family`` and returns a :class:`Model`
bundle with a uniform interface:

    init(generator, device=None)                -> params
    loss_fn(params, batch)                      -> (loss, metrics)
    init_cache(batch, max_len, device=None)     -> cache   # decode shapes
    prefill(params, batch, cache)               -> (logits, cache)
    decode_step(params, token, cache)           -> (logits, cache)

Every family of the reference is here: ``dense`` (``transformer``), ``moe``,
``ssm`` (``rwkv``), ``hybrid`` (``hymba``), ``audio`` (``whisper``), ``vlm``
(``llava``), ``cnn`` and ``mf``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from repro_torch.config import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    init_cache: Callable
    prefill: Optional[Callable]
    decode_step: Optional[Callable]


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "cnn":
        from repro_torch.models import cnn as m
    elif cfg.family == "mf":
        from repro_torch.models import mf as m
    elif cfg.family == "dense":
        from repro_torch.models import transformer as m
    elif cfg.family == "moe":
        from repro_torch.models import moe as m
    elif cfg.family == "ssm":
        from repro_torch.models import rwkv as m
    elif cfg.family == "hybrid":
        from repro_torch.models import hymba as m
    elif cfg.family == "audio":
        from repro_torch.models import whisper as m
    elif cfg.family == "vlm":
        from repro_torch.models import llava as m
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: m.init(generator, cfg, device),
        loss_fn=lambda params, batch: m.loss_fn(params, cfg, batch),
        init_cache=(lambda batch, max_len, device=None:
                    m.init_cache(cfg, batch, max_len, device))
        if hasattr(m, "init_cache") else _no_cache,
        prefill=(lambda params, batch, cache:
                 m.prefill(params, cfg, batch, cache))
        if hasattr(m, "prefill") else None,
        decode_step=(lambda params, token, cache:
                     m.decode_step(params, cfg, token, cache))
        if hasattr(m, "decode_step") else None,
    )


def _no_cache(*_a, **_k):
    raise NotImplementedError("this family has no decode cache")
