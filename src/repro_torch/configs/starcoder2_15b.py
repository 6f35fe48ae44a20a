"""StarCoder2-15B — dense GQA decoder with RoPE [arXiv:2402.19173]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,          # GQA kv=4
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    rope_theta=100_000.0,
    param_dtype="bfloat16",
    citation="StarCoder 2 and The Stack v2 [arXiv:2402.19173]",
)
