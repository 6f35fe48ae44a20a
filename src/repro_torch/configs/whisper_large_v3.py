"""Whisper large-v3 — encoder-decoder; the conv/mel frontend is a stub per
the brief: ``input_specs`` provides 1500 precomputed frame embeddings
[arXiv:2212.04356]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers
    encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,          # MHA
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    n_frames=1500,
    param_dtype="bfloat16",
    citation="Robust Speech Recognition via Large-Scale Weak Supervision [arXiv:2212.04356]",
)
