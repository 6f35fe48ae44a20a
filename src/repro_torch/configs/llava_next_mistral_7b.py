"""LLaVA-NeXT (Mistral-7B backbone) — the ViT/projector frontend is a stub
per the brief: ``input_specs`` provides precomputed anyres patch embeddings
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,           # GQA kv=8
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    window=4096,            # mistral native sliding window
    image_tokens=576,       # per tile; anyres uses `anyres_tiles` tiles
    anyres_tiles=5,
    param_dtype="bfloat16",
    citation="LLaVA-NeXT model card [hf:llava-hf/llava-v1.6-mistral-7b-hf]",
)
