"""RWKV-6 "Finch" 1.6B — attention-free RNN with data-dependent decay
[arXiv:2404.05892]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # wkv heads (head_size 64)
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    ssm_state=64,          # per-head state is head_dim x head_dim
    param_dtype="bfloat16",
    citation="Eagle and Finch: RWKV with Matrix-Valued States and Dynamic Recurrence [arXiv:2404.05892]",
)
