"""Hymba-1.5B — hybrid-head transformer: parallel attention + Mamba heads
in every block [arXiv:2411.13676]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,          # GQA kv=5
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    window=1024,           # hymba uses sliding-window attn on most layers
    param_dtype="bfloat16",
    citation="Hymba: A Hybrid-head Architecture for Small Language Models [arXiv:2411.13676]",
)
