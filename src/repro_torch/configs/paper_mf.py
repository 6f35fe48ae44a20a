"""The paper's matrix-factorization recommender (MovieLens 100K, Table 3).
One-user-one-node partitioning; embedding dim 20 per the paper."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-mf",
    family="mf",
    mf_users=610,
    mf_items=1000,
    mf_dim=20,
    param_dtype="float32",
    citation="MoDeST Table 3 — Matrix Factorization on MovieLens",
)
