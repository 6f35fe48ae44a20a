"""Architecture registry.

Every architecture has one module here exporting ``CONFIG`` (the exact
published dims, citation in ``citation``). Select with ``get_config(name)``.
"""

from __future__ import annotations

from repro_torch.config import ModelConfig  # noqa: F401

from repro_torch.configs import paper_cnn

ARCHS = {m.CONFIG.name: m.CONFIG for m in (paper_cnn,)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
