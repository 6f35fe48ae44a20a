"""Snowflake Arctic (480B) — dense-MoE hybrid: 128-expert top-2 MoE with a
parallel dense residual MLP [hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    moe_num_experts=128,
    moe_top_k=2,
    moe_d_ff_expert=4864,
    moe_dense_ff=4864,     # arctic's dense residual path
    participant_granularity="pod",   # ~960 GB of bf16 params: replica = a pod
    param_dtype="bfloat16",
    citation="Snowflake Arctic model card [hf:Snowflake/snowflake-arctic-base]",
)
