"""Llama-3.1 405B — dense GQA decoder, 128k vocab [arXiv:2407.21783]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=500_000.0,
    participant_granularity="pod",   # 810 GB bf16 params: replica = a pod
    param_dtype="bfloat16",
    citation="The Llama 3 Herd of Models [arXiv:2407.21783]",
)
