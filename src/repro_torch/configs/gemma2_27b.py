"""Gemma 2 27B — alternating local(4096-window)/global attention with
logit soft-capping [arXiv:2408.00118]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,          # GQA kv=16
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    window=4096,
    local_global_alt=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    param_dtype="bfloat16",
    citation="Gemma 2: Improving Open Language Models at a Practical Size [arXiv:2408.00118]",
)
