"""Architecture registry.

Every architecture has one module here exporting ``CONFIG`` (the exact
published dims, citation in ``citation``). Select with ``get_config(name)``;
``reduced()`` gives the 2-layer, d_model≤256 smoke variant the CPU tests
use. The package holds the paper CNN, the paper MF and the dense LM family
so far.
"""

from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig  # noqa: F401

from repro_torch.configs import (
    gemma2_27b,
    llama3_405b,
    paper_cnn,
    paper_mf,
    starcoder2_15b,
    tinyllama_1_1b,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (starcoder2_15b, llama3_405b, gemma2_27b, tinyllama_1_1b,
              paper_cnn, paper_mf)
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=256."""
    if cfg.family in ("cnn", "mf"):
        return cfg
    d = min(cfg.d_model, 256)
    hd = 32
    heads = max(2, min(4, cfg.n_heads))
    kv = max(1, min(heads, cfg.n_kv_heads or heads))
    kw = dict(
        n_layers=2,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 512) or 512,
        vocab=min(cfg.vocab, 512),
        param_dtype="float32",
        remat=False,
        participant_granularity="data_rank",
    )
    if cfg.window:
        kw.update(window=64)
    return dataclasses.replace(cfg, **kw)
