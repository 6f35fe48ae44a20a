"""The sharded FlatModel engine's device mesh.

A function, not a module-level constant, so that importing this module
touches no device state. The reference's production-mesh helpers (pods,
``MeshConfig``) are not part of this package.
"""

from __future__ import annotations

import torch


def make_engine_mesh(device=None):
    """The mesh of the sharded FlatModel engine (``engine="sharded"``): all
    local CUDA devices along the ``model`` axis, starting at ``device``
    (None: the current one), where flat buffers live. The engine splits the
    flat parameter axis N over it and keeps cohort rows whole.

    Returns None where there are fewer than two CUDA devices (a host
    without a card included) or ``device`` is not a CUDA device: sharding
    would be a no-op, and ``make_engine`` falls back to the batched engine.
    """
    n = torch.cuda.device_count()
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or n < 2:
        return None
    first = torch.cuda.current_device() if dev.index is None else dev.index
    return tuple(torch.device("cuda", (first + i) % n) for i in range(n))
