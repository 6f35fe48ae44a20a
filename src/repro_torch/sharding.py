"""Flat-model shardings: where the FlatModel engine's flat layouts lie on a
device mesh, and how the aggregation kernels split them.

A mesh here is a hashable tuple of ``torch.device``s along one axis,
``model``. It may name one device more than once: k chunks of one card
run the same code as k cards (``launch.mesh.make_engine_mesh`` builds the
mesh of all local cards). Every flat buffer lives whole on the mesh's
first device; a layout's ``spec`` says, like a ``PartitionSpec``, which
dimension the kernels split over the mesh: the parameter axis N of the
``(N,)`` / ``(S, N)`` / ``(P, N)`` buffers, shard r running on ``mesh[r]``
(``kernels.fused.*_sharded``).

Of the reference's production-mesh policy, :class:`ShardingPolicy` holds
the participant rules, which set the mesh form's participant count
(``core.distributed.DistributedTrainer``). Its rule tables and specs
(``param_spec``, ``cache_spec``, ``batch_spec``, ``input_specs``) place
tensors on a mesh of distinct devices and are not part of this package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.config import MeshConfig, ModelConfig


@dataclass(frozen=True)
class FlatPlacement:
    """One flat layout on a mesh, the counterpart of a ``NamedSharding``:
    ``spec`` names for each dimension of the buffer the mesh axis it is
    split over (None: not split). The buffer itself lives on ``home``."""

    mesh: Tuple[torch.device, ...]
    spec: Tuple[Optional[str], ...]

    @property
    def home(self) -> torch.device:
        return self.mesh[0]


@dataclass(frozen=True)
class FlatShardings:
    """The FlatModel engine's flat layouts on a mesh.

    The parameter axis N is split over ``model_axis``; the leading stack
    axes (S cohort rows, P population replicas) are not. Hashable (frozen,
    hashable fields), so caches can key off it.
    """

    mesh: Tuple[torch.device, ...]
    vec: FlatPlacement          # (N,)  — one flat model
    stack: FlatPlacement        # (S, N) — cohort rows × params
    pop: FlatPlacement          # (P, N) — population replicas × params
    replicated: FlatPlacement   # weights (P,), (S,) state rows, scalars
    model_axis: str = "model"

    @property
    def n_shards(self) -> int:
        return len(self.mesh)


def flat_shardings(mesh, *, model_axis: str = "model",
                   row_axis: Optional[str] = None) -> FlatShardings:
    """Build :class:`FlatShardings` for ``mesh`` (a sequence of devices or
    device names).

    The reference's ``row_axis`` maps the leading S/P axis to a second
    mesh axis; a mesh here has one axis, so only None (rows whole on every
    shard, the layout the one-pass aggregation wants) is taken.
    """
    mesh = tuple(torch.device(d) for d in mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    if row_axis is not None:
        raise ValueError(f"row_axis={row_axis!r}: a mesh here has the one "
                         f"axis {model_axis!r}, and rows are not split")

    def place(*spec):
        return FlatPlacement(mesh, spec)

    return FlatShardings(mesh=mesh, vec=place(model_axis),
                         stack=place(None, model_axis),
                         pop=place(None, model_axis), replicated=place(),
                         model_axis=model_axis)


class ShardingPolicy:
    """The participant rules of the production mesh.

    ``cfg.participant_granularity`` says what one MoDeST participant slot
    holds: ``"data_rank"`` a row of ``model`` devices (P = ``data``, times
    ``pods`` with ``multi_pod``); ``"chip"`` one device (P = every device;
    the model is replicated); ``"pod"`` a whole pod (P = ``pods`` with
    ``multi_pod``, else 1; parameters FSDP-sharded over ``data``).
    ``part_axis`` names the mesh axes that carry P, ``fsdp_axis`` and
    ``batch_axis`` those that shard a participant's parameters and batch.
    """

    def __init__(self, cfg: ModelConfig, mesh_cfg: MeshConfig):
        self.cfg = cfg
        self.mesh_cfg = mesh_cfg
        self._axis_size = {"data": mesh_cfg.data, "model": mesh_cfg.model,
                           "pod": mesh_cfg.pods if mesh_cfg.multi_pod else 1}
        gran = cfg.participant_granularity
        if gran == "pod":
            self.part_axis: Optional[object] = ("pod" if mesh_cfg.multi_pod
                                                else None)
            self.n_participants = mesh_cfg.pods if mesh_cfg.multi_pod else 1
            self.fsdp_axis: Optional[str] = "data"
            self.batch_axis: Optional[str] = "data"
        elif gran == "chip":
            # one participant a chip: the model is fully replicated
            self.part_axis = (("pod", "data", "model") if mesh_cfg.multi_pod
                              else ("data", "model"))
            self.n_participants = mesh_cfg.n_devices
            self.fsdp_axis = None
            self.batch_axis = None
            self._replicated = True
        else:                                     # "data_rank"
            self.part_axis = (("pod", "data") if mesh_cfg.multi_pod
                              else "data")
            self.n_participants = (mesh_cfg.pods * mesh_cfg.data
                                   if mesh_cfg.multi_pod else mesh_cfg.data)
            self.fsdp_axis = None
            self.batch_axis = None

    _replicated = False

    def _axes_size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self._axis_size.get(a, 1)
            return n
        return self._axis_size.get(axis, 1)


__all__ = ["FlatPlacement", "FlatShardings", "ShardingPolicy",
           "flat_shardings"]
