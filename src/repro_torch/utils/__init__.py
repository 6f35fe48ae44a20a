"""Shared utilities: pytree math and device resolution."""

from repro_torch.utils.device import resolve_device  # noqa: F401
from repro_torch.utils.pytree import (  # noqa: F401
    check_aggregation_weights,
    tree_flatten,
    tree_global_norm,
    tree_leaves,
    tree_map,
    tree_size_bytes,
    tree_unflatten,
    tree_weighted_mean,
    tree_zeros_like,
)
