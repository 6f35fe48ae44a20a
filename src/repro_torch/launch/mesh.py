"""Device meshes: the production mesh and the sharded FlatModel engine's.

Functions, not module-level constants, so that importing this module
touches no device state.

The production mesh (``data`` x ``model``, 16 x 16 a pod; ``pod`` x
``data`` x ``model`` with ``multi_pod``) is a
:class:`~repro_torch.sharding.DeviceMesh`. In one process its entries all
name one device: on one card every entry names the card (256 entries, 512
with ``multi_pod``), and every tensor lies whole on it, as
``launch/train.py --mode mesh`` stacks its participants there. Inside a
world (:mod:`repro_torch.launch.world`, one process a device) the mesh is
the world's: its entries are the ranks' devices, each axis has its
process group, and tensors are split over the ranks by their specs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.config import MeshConfig
from repro_torch.launch.world import current_world
from repro_torch.sharding import DeviceMesh
from repro_torch.utils.device import resolve_device


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """A mesh of ``shape`` over the named ``axes``. Inside a world, the
    world's mesh (``World.mesh``; ``device``, if given, must be this
    rank's); otherwise a mesh whose every entry names ``device`` (None:
    the card)."""
    world = current_world()
    if world is not None:
        if device is not None and resolve_device(device) != world.device:
            raise ValueError(f"rank {world.rank} runs on {world.device}, "
                             f"the caller asked for {device}")
        return world.mesh(shape, axes)
    return DeviceMesh((resolve_device(device),) * math.prod(shape),
                      tuple(axes), tuple(shape))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16×16 = 256 entries a pod; 2 pods = 512 entries multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MeshConfig(multi_pod=multi_pod)


def make_mesh_from_config(mesh_cfg: MeshConfig, device=None):
    return make_mesh(mesh_cfg.shape, mesh_cfg.axes, device)


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
