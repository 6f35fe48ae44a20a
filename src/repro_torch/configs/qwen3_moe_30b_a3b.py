"""Qwen3-30B-A3B — 128-expert top-8 MoE, thin experts
[hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,          # GQA kv=4
    head_dim=128,          # qwen3 uses head_dim 128 (q proj 4096 > d_model)
    d_ff=768,
    vocab=151936,
    rope_theta=1_000_000.0,
    moe_num_experts=128,
    moe_top_k=8,
    moe_d_ff_expert=768,
    param_dtype="bfloat16",
    citation="Qwen3 model card [hf:Qwen/Qwen3-30B-A3B]",
)
