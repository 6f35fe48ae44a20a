"""TinyLlama 1.1B — llama2-architecture small model [arXiv:2401.02385]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,           # GQA kv=4
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    param_dtype="bfloat16",
    citation="TinyLlama: An Open-Source Small Language Model [arXiv:2401.02385]",
)
