"""Serving: batched prefill + single-token decode of an LM on one device.

The reference's module also holds the mesh form of a MoDeST round
(``DistributedTrainer``, ``make_train_step``), which waits for ROADMAP A12
along with every mesh of more than one device. What is here is its
``Server``, on one device: ``shard_params`` / ``shard_cache`` place tensors
on it, and ``prefill`` / ``decode`` take the place of the reference's
``jit_prefill`` / ``jit_decode``. They compile nothing (PyTorch runs
eagerly) and run without autograd; both write into the cache they are
given, as the reference's donated cache is consumed. The reference's
``shard_seq`` (sequence-sharded cache specs), ``specs`` and
``abstract_cache`` describe a mesh and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import MeshConfig, ModelConfig
from repro_torch.models import Model, build
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


class Server:
    """Batched serving: prefill + single-token decode."""

    def __init__(self, cfg: ModelConfig, mesh_cfg: Optional[MeshConfig] = None,
                 *, device=None):
        if mesh_cfg is not None and mesh_cfg.n_devices > 1:
            raise NotImplementedError(
                f"a mesh of {mesh_cfg.n_devices} devices: the package serves "
                "on one device until the mesh form lands (ROADMAP A12)")
        self.cfg = cfg
        self.model: Model = build(cfg)
        self.device = resolve_device(device)

    def _place(self, tree):
        return tree_map(
            lambda x: x.to(self.device) if isinstance(x, torch.Tensor) else x,
            tree)

    def shard_params(self, params):
        """Place host-initialized params on the server's device."""
        return self._place(params)

    def shard_cache(self, cache):
        return self._place(cache)

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        return self.model.prefill(params, batch, cache)

    @torch.no_grad()
    def decode(self, params, token, cache):
        return self.model.decode_step(params, token, cache)
