"""Architecture registry.

Every architecture has one module here exporting ``CONFIG`` (the exact
published dims, citation in ``citation``). Select with ``get_config(name)``;
``reduced()`` gives the 2-layer, d_model<=256, <=4-expert smoke variant the
CPU tests use. ``ASSIGNED`` lists the LM architectures (every arch but the
paper's CNN and MF).
"""

from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig, SHAPES  # noqa: F401

from repro_torch.configs import (
    arctic_480b,
    gemma2_27b,
    hymba_1_5b,
    llama3_405b,
    llava_next_mistral_7b,
    paper_cnn,
    paper_mf,
    qwen3_moe_30b_a3b,
    rwkv6_1_6b,
    starcoder2_15b,
    tinyllama_1_1b,
    whisper_large_v3,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        hymba_1_5b,
        arctic_480b,
        starcoder2_15b,
        rwkv6_1_6b,
        llama3_405b,
        qwen3_moe_30b_a3b,
        whisper_large_v3,
        gemma2_27b,
        llava_next_mistral_7b,
        tinyllama_1_1b,
        paper_cnn,
        paper_mf,
    )
}

ASSIGNED = [n for n in ARCHS if not n.startswith("paper-")]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=256,
    <=4 experts."""
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
    if cfg.family == "moe":
        kw.update(
            moe_num_experts=4,
            moe_top_k=min(2, cfg.moe_top_k),
            moe_d_ff_expert=128,
            moe_dense_ff=128 if cfg.moe_dense_ff else 0,
            moe_group_size=16,
        )
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=min(cfg.ssm_state or 8, 8))
    if cfg.family == "audio":
        kw.update(encoder_layers=2, n_frames=16)
    if cfg.family == "vlm":
        kw.update(image_tokens=8, anyres_tiles=2)
    if cfg.window:
        kw.update(window=64)
    return dataclasses.replace(cfg, **kw)
