"""Sharding: where tensors lie on a device mesh.

Two kinds of mesh appear here.

* The flat-model engine's mesh is a hashable tuple of ``torch.device``s
  along one axis, ``model``. It may name one device more than once: k
  chunks of one card run the same code as k cards
  (``launch.mesh.make_engine_mesh`` builds the mesh of all local cards).
  Every flat buffer lives whole on the mesh's first device; a layout's
  ``spec`` says, like a ``PartitionSpec``, which dimension the kernels
  split over the mesh: the parameter axis N of the ``(N,)`` / ``(S, N)`` /
  ``(P, N)`` buffers, shard r running on ``mesh[r]``
  (``kernels.fused.*_sharded``).
* The production mesh (:class:`DeviceMesh`, ``launch.mesh``) has named
  axes, ``data`` x ``model`` or ``pod`` x ``data`` x ``model``.
  :class:`ShardingPolicy` maps every parameter, optimizer-state leaf,
  input and cache leaf of a model to a spec on it: a tuple with one entry a
  dimension, each an axis name, a tuple of them, or None (not split), as
  ``tuple()`` of the reference's ``PartitionSpec``. The train path's
  leaves carry a leading participant axis P; the serve path's do not.

Axes: ``data`` carries participant replicas (MoDeST sample slots) for
archs up to ~30 B, or FSDP shards for the pod-granularity giants
(llama3-405b, arctic-480b); ``model`` tensor/expert parallelism inside one
participant; ``pod`` (multi-pod) participants at pod granularity, or more
participant slots at data_rank granularity.

A mesh comes in two forms.

* In one process it may name one device many times, and then every tensor
  lies whole on that device (``core.distributed``): the specs say where
  each piece would go on distinct devices, and placing by them is checked
  (each spec divides its tensor). One process does not split tensors over
  distinct devices (:func:`mesh_device` raises).
* In a world (:mod:`repro_torch.launch.world`: one process a device) a
  :class:`DeviceMesh` has the ranks' devices as its entries, this
  process's ``rank`` and a process group an axis. :func:`local_shard`
  gives a rank its slice of a whole tree by the specs and
  :func:`gather_tree` puts the slices back together; a
  :class:`FlatShardings` over a world splits the flat engine's N over
  its ``model`` axis, one lane chunk a rank.

The world's rules. A world runs Megatron's tensor parallelism, which keeps
the residual stream replicated over ``model``, where XLA's partitioner
reshards activations to whatever the specs ask. Three rules therefore give
a world rank another layout than the reference's specs for a few leaves
(``ShardingPolicy.param_spec`` / ``cache_spec`` with ``world=True``); each
is a difference of layout, not of result, and XLA's plan for the same
specs is what ``launch/dryrun.py`` reckons:

* ``token_shift_whole``: RWKV-6's token shifts ``last_tm`` and ``last_cm``
  (``(L, B, d)``, the last token's residual stream), which the reference
  splits over ``model`` on d, lie whole over ``model`` (batch rows over
  ``data``); ``S`` stays split by heads.
* ``in_proj_halves``: Hymba's ``in_proj`` holds ``xin`` and ``z`` side by
  side (``(d, 2 d_inner)``); a rank takes the same d_inner lanes of both
  halves (a :class:`Blocks` entry: columns ``[r di/M, (r+1) di/M)`` of
  each), so that they meet its lanes of ``conv``, ``dt_up``, ``a_log``
  and the state. A contiguous split would give one rank all of ``xin``.
* ``attention_whole``: where ``model`` does not divide the query heads
  (Hymba's 25 at published widths), the attention's ``w[qkvo]`` (and
  Whisper's cross-attention's) and the ``k`` / ``v`` cache (and Whisper's
  ``xk`` / ``xv``) lie whole over ``model`` and the attention runs
  replicated; the reference's specs split a head there.
* ``kv_whole``: where ``model`` divides the query heads but not the kv
  heads (TinyLlama's 32 / 4 at ``model = 8``), ``attn/wk`` and
  ``attn/wv`` (and Whisper's cross-attention's) lie whole over ``model``;
  a rank's query heads read the columns of their own kv group
  (``models.layers._local_heads``), and the gradient of the whole weights
  is summed over ``model`` (Megatron's *f* on the weights). The
  reference's specs split their lanes, in the middle of a head. The cache
  keeps the reference's spec there: its sequence over ``model``, every kv
  head on each rank (``models.layers.seq_split``).

A cache split by sequence (``cache_spec``: T over ``model`` where the kv
heads do not divide it, or over ``data`` under ``shard_seq``) keeps the
reference's layout: a rank holds the positions ``[r T / n, (r+1) T / n)``
of every batch row it holds, and the decode combines the ranks' partial
softmaxes (``models.layers.seq_split``).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.utils.pytree import tree_flatten, tree_flatten_with_path


@dataclass(frozen=True)
class DeviceMesh:
    """A device mesh with named axes, the counterpart of a jax ``Mesh``:
    ``devices`` in row-major order over ``dims``, one size an axis of
    ``axis_names``. ``shape[axis]`` reads as a jax ``Mesh``'s does.
    Hashable (frozen, hashable fields).

    The world form (``launch.world.World.mesh``) also has this process's
    ``rank`` (its entry) and ``groups``, the process group of each axis
    (the ranks that differ only in that axis's coordinate)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    rank: Optional[int] = None
    groups: Tuple[Any, ...] = field(default=(), compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "dims", tuple(int(n) for n in self.dims))
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"axes {self.axis_names} for dims {self.dims}")
        if len(self.devices) != math.prod(self.dims):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"dims {self.dims}")
        if self.rank is not None and not 0 <= self.rank < len(self.devices):
            raise ValueError(f"rank {self.rank} of a mesh of "
                             f"{len(self.devices)} entries")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def in_world(self) -> bool:
        """Whether this is a world's mesh (one process an entry)."""
        return self.rank is not None

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's coordinate on each axis."""
        rank, out = self.rank, []
        for n in reversed(self.dims):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def axis_size(self, axis) -> int:
        """The size of ``axis`` (a name, a tuple of names or None)."""
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            return math.prod(self.axis_size(a) for a in axis)
        return self.shape.get(axis, 1)

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (row-major over a tuple of
        names, as a ``PartitionSpec`` entry splits a dimension)."""
        if axis is None:
            return 0
        if isinstance(axis, tuple):
            i = 0
            for a in axis:
                i = i * self.axis_size(a) + self.axis_index(a)
            return i
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of the named ``axis``."""
        if not self.in_world:
            raise ValueError("a mesh outside a world has no process groups")
        return self.groups[self.axis_names.index(axis)]


def mesh_device(mesh) -> torch.device:
    """The device of this process on ``mesh`` (a :class:`DeviceMesh` or a
    sequence of devices): in a world, this rank's entry; otherwise the one
    device the mesh names. One process does not split tensors over
    distinct devices: such a mesh outside a world raises
    ``NotImplementedError`` naming how to start a world."""
    if isinstance(mesh, DeviceMesh) and mesh.in_world:
        return mesh.devices[mesh.rank]
    devices = mesh.devices if isinstance(mesh, DeviceMesh) else tuple(
        torch.device(d) for d in mesh)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"a mesh of distinct devices {sorted(map(str, set(devices)))} "
            "in one process: tensors split over devices need one process "
            "a device; start a world (repro_torch.launch.world.run_world, "
            "or the launchers' --world) and build the mesh inside it "
            "(ROADMAP A12b)")
    return devices[0]


@dataclass(frozen=True)
class Blocks:
    """A world rule's spec entry (``in_proj_halves``): the dimension
    holds ``n`` equal blocks side by side and each block is split over
    ``axis``, so a rank holds the same piece of every block, side by
    side."""

    axis: Any
    n: int


def axis_names(entry) -> Tuple[str, ...]:
    """The mesh axes that one entry of a spec names."""
    if isinstance(entry, Blocks):
        entry = entry.axis
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _dim_axes(spec, ndim: int):
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return spec[:ndim]


def local_shard(tree, specs, mesh: DeviceMesh):
    """This rank's slice of every tensor of a whole ``tree``, by ``specs``
    (a matching tree of specs): each dimension split over its axes, the
    rank's index along them choosing the contiguous piece. Leaves that are
    not tensors (a cache's host ``pos``) pass through; a spec that does not
    divide its dimension raises."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for leaf, spec in zip(leaves, treedef.flatten_up_to(specs)):
        if isinstance(leaf, torch.Tensor):
            for d, entry in enumerate(_dim_axes(spec, leaf.dim())):
                blocks = entry.n if isinstance(entry, Blocks) else 1
                axis = entry.axis if isinstance(entry, Blocks) else entry
                n = mesh.axis_size(axis)
                if n == 1:
                    continue
                if leaf.shape[d] % (n * blocks):
                    raise ValueError(f"spec {spec} does not divide a leaf "
                                     f"of shape {tuple(leaf.shape)}")
                block = leaf.shape[d] // blocks
                size, i = block // n, mesh.axis_index(axis)
                pieces = [leaf.narrow(d, b * block + i * size, size)
                          for b in range(blocks)]
                # a view where the rank's piece is one block: one copy at
                # the end, not one a split dimension
                leaf = pieces[0] if blocks == 1 else torch.cat(pieces, dim=d)
            leaf = leaf.contiguous()
        out.append(leaf)
    return treedef.unflatten(out)


def gather_tree(tree, specs, mesh: DeviceMesh):
    """The whole tensors back from every rank's :func:`local_shard` slices
    (collectives over the axes' groups, on every rank)."""
    from repro_torch import collectives

    leaves, treedef = tree_flatten(tree)
    out = []
    for leaf, spec in zip(leaves, treedef.flatten_up_to(specs)):
        if isinstance(leaf, torch.Tensor):
            for d, entry in enumerate(_dim_axes(spec, leaf.dim())):
                blocks = entry.n if isinstance(entry, Blocks) else 1
                for a in reversed(axis_names(entry)):  # the innermost first
                    n = mesh.axis_size(a)
                    if n == 1:
                        continue
                    leaf = collectives.all_gather(leaf, mesh.group(a), dim=d)
                    if blocks > 1:      # rank-major pieces -> block-major
                        parts = leaf.chunk(n * blocks, dim=d)
                        leaf = torch.cat([parts[r * blocks + b]
                                          for b in range(blocks)
                                          for r in range(n)], dim=d)
        out.append(leaf)
    return treedef.unflatten(out)


def gather_over(x, mesh: DeviceMesh, axis, dim: int = 0):
    """``x`` of every rank along ``axis`` (a name, a tuple of names or
    None) concatenated along ``dim``: gathered axis by axis, the innermost
    first, so that the pieces lie in row-major order, as
    :meth:`DeviceMesh.axis_index` reads a tuple; None gathers nothing."""
    from repro_torch import collectives

    for a in reversed(axis_names(axis)):
        if mesh.axis_size(a) > 1:
            x = collectives.all_gather(x, mesh.group(a), dim=dim)
    return x


def reduce_over(x, mesh: DeviceMesh, axis, op: str = "sum"):
    """``x`` reduced in place over every rank along ``axis`` (a name, a
    tuple of names or None), axis by axis; None reduces nothing."""
    from repro_torch import collectives

    for a in reversed(axis_names(axis)):
        if mesh.axis_size(a) > 1:
            collectives.all_reduce(x, mesh.group(a), op)
    return x


@dataclass(frozen=True)
class FlatPlacement:
    """One flat layout on a mesh, the counterpart of a ``NamedSharding``:
    ``spec`` names for each dimension of the buffer the mesh axis it is
    split over (None: not split). The buffer itself lives on ``home``:
    the mesh's first device, or in a world this rank's."""

    mesh: Tuple[torch.device, ...]
    spec: Tuple[Optional[str], ...]
    home_index: int = 0

    @property
    def home(self) -> torch.device:
        return self.mesh[self.home_index]


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
    # a world's: the process group of the model axis and this rank's
    # shard index on it (None and 0 in one process)
    group: Any = field(default=None, compare=False)
    rank: int = 0

    @property
    def n_shards(self) -> int:
        return len(self.mesh)

    @property
    def home(self) -> torch.device:
        return self.vec.home


def flat_shardings(mesh, *, model_axis: str = "model",
                   row_axis: Optional[str] = None) -> FlatShardings:
    """Build :class:`FlatShardings` for ``mesh``: a sequence of devices or
    device names, or a world's :class:`DeviceMesh`, whose ``model_axis``
    line through this rank becomes the mesh (shard r on the line's rank r,
    with the axis's process group).

    The reference's ``row_axis`` maps the leading S/P axis to a second
    mesh axis; a mesh here splits N alone, so only None (rows whole on
    every shard, the layout the one-pass aggregation wants) is taken.
    """
    group, rank = None, 0
    if isinstance(mesh, DeviceMesh):
        if not mesh.in_world:
            mesh = mesh.devices
        else:
            a = mesh.axis_names.index(model_axis)
            coords = list(mesh.coords)
            line = []
            for c in range(mesh.dims[a]):
                coords[a] = c
                r = 0
                for ci, n in zip(coords, mesh.dims):
                    r = r * n + ci
                line.append(mesh.devices[r])
            group, rank = mesh.group(model_axis), mesh.coords[a]
            mesh = line
    mesh = tuple(torch.device(d) for d in mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    if row_axis is not None:
        raise ValueError(f"row_axis={row_axis!r}: a mesh here splits N "
                         f"over {model_axis!r} alone, and rows are not "
                         "split")

    def place(*spec):
        return FlatPlacement(mesh, spec, rank)

    return FlatShardings(mesh=mesh, vec=place(model_axis),
                         stack=place(None, model_axis),
                         pop=place(None, model_axis), replicated=place(),
                         model_axis=model_axis, group=group, rank=rank)


class ShardingPolicy:
    """Maps every parameter, input and cache leaf to a spec on the
    production mesh.

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

    @property
    def splits_model(self) -> bool:
        """Whether a participant's leaves are split over ``model`` (tensor
        and expert parallelism): not at ``chip`` granularity, where the
        ``model`` axis carries participants, nor on a ``model`` axis of
        one."""
        return not self._replicated and self._axis_size["model"] > 1

    @property
    def splits_data(self) -> bool:
        """Whether a participant's leaves and batch rows are split over
        ``data`` (FSDP: ``pod`` granularity on a ``data`` axis past
        one)."""
        return self.fsdp_axis is not None and \
            self._axes_size(self.fsdp_axis) > 1

    # ------------------------------------------------------------------ rules

    def _base_rules(self):
        """(regex on '/'-joined path, spec WITHOUT layer/participant axes).

        ``F`` marks the FSDP axis (None unless pod granularity); ``M`` the
        tensor/expert-parallel axis.
        """
        F, M = self.fsdp_axis, "model"
        if self.cfg.replicate_attention:
            # replicate ALL attention params (self- and cross-attention,
            # wq/wk/wv and wo), so attention needs no TP all-reduce
            attn = [(r"attn/w[qkvo]$", None)]      # re.search: xattn too
        else:
            attn = [
                (r"attn/w[qkv]$", (F, M)),
                (r"attn/wo$", (M, F)),
                (r"xattn/w[qkv]$", (F, M)),
                (r"xattn/wo$", (M, F)),
            ]
        return [
            # embeddings / heads
            (r"embed$", (M, F)),
            (r"enc_pos$", (None, F)),
            (r"lm_head$", (F, M)),
            # MoE: experts over the model axis (expert parallelism);
            # arctic's dense residual shards like a normal MLP.
            (r"moe/router$", (F, None)),
            (r"moe/dense/w[gu]$", (F, M)),
            (r"moe/dense/wd$", (M, F)),
            (r"moe/w[gud]$", (M, F, None)),
            # attention (TP by default, replicated under
            # cfg.replicate_attention)
            *attn,
            # dense MLPs (swiglu / gelu): first matmuls shard d_ff
            (r"mlp/w[gui]$", (F, M)),
            (r"mlp/w[do]$", (M, F)),
            # rwkv time-mix / channel-mix
            (r"tm/w[rkvg]$", (F, M)),
            (r"tm/wo$", (M, F)),
            (r"tm/decay_a$", (F, None)),
            (r"tm/decay_b$", (None, M)),
            (r"tm/w0$", (M,)),
            (r"tm/u$", (M, None)),
            (r"tm/mu$", (None, F)),
            (r"cm/wk$", (F, M)),
            (r"cm/wv$", (M, F)),
            (r"cm/wr$", (F, M)),
            (r"cm/mu$", (None, F)),
            # hymba mamba branch (d_inner sharded over model)
            (r"mamba/in_proj$", (F, M)),
            (r"mamba/out_proj$", (M, F)),
            (r"mamba/conv$", (None, M)),
            (r"mamba/conv_b$", (M,)),
            (r"mamba/dt_proj$", (M, None)),
            (r"mamba/dt_up$", (None, M)),
            (r"mamba/dt_bias$", (M,)),
            (r"mamba/bc_proj$", (M, None)),
            (r"mamba/a_log$", (M, None)),
            (r"mamba/d_skip$", (M,)),
            # cnn / mf (protocol-form models: replicate)
            (r"(users|items|b_user|b_item)$", None),
        ]

    def _match(self, path: str) -> Tuple:
        if self._replicated:
            return (None,) * 8
        for pat, spec in self._base_rules():
            if re.search(pat, path):
                if spec is None:
                    break
                return spec
        # norms / scalars / biases: replicated (trimmed to rank by caller)
        return (None,) * 8

    def _axes_size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self._axis_size.get(a, 1)
            return n
        return self._axis_size.get(axis, 1)

    def _fix_divisibility(self, spec, shape):
        """Drop axis assignments whose size does not divide the dim (odd
        vocabs like 51866/32001, kv_heads < model ranks): replicate that
        dim instead."""
        out = []
        for dim, axis in zip(shape, spec):
            out.append(axis if (axis is None or dim % self._axes_size(axis) == 0)
                       else None)
        return tuple(out)

    def divides(self, spec, shape) -> bool:
        """Whether every axis of ``spec`` divides its dimension of
        ``shape`` (one entry a dimension)."""
        return len(spec) == len(shape) and all(
            dim % self._axes_size(axis) == 0 for dim, axis in zip(shape, spec))

    # ------------------------------------------------------------ public API

    def _attention_whole(self) -> bool:
        """The world rule ``attention_whole``: ``model`` does not divide
        the query heads."""
        return self.cfg.n_heads % self._axis_size["model"] != 0

    def kv_whole(self) -> bool:
        """The world rule ``kv_whole``: ``model`` divides the query heads
        but not the kv heads (and the policy splits ``model``)."""
        M = self._axis_size["model"]
        return (self.splits_model and not self._attention_whole()
                and self.cfg.n_kv_heads % M != 0)

    def _world_param_rule(self, path: str, spec: Tuple) -> Tuple:
        """A parameter's spec under the world's rules (module docstring):
        ``attention_whole``, ``kv_whole`` and ``in_proj_halves``."""
        if (re.search(r"attn/w[qkvo]$", path) and self._attention_whole()
                or re.search(r"attn/w[kv]$", path) and self.kv_whole()):
            return tuple(None if "model" in axis_names(a) else a
                         for a in spec)
        if re.search(r"mamba/in_proj$", path) and spec[-1] is not None:
            return spec[:-1] + (Blocks(spec[-1], 2),)
        return spec

    def param_spec(self, params, *, with_participants: bool,
                   world: bool = False) -> object:
        """Tree of specs matching ``params`` (a tree of tensors, real or on
        the ``meta`` device, or anything with a ``shape``).

        ``with_participants`` expects a leading P axis on every leaf and a
        layer-stack axis on leaves under ``layers``/``encoder``/``decoder``.
        ``world``: a world rank's layout, the world's rules (module
        docstring) applied to the reference's specs.
        """
        flat, treedef = tree_flatten_with_path(params)
        specs = []
        for path_elems, leaf in flat:
            path = "/".join(_k(p) for p in path_elems)
            base = list(self._match(path))
            stacked = bool(re.search(r"(layers|encoder|decoder)/", path + "/"))
            shape = _shape(leaf)
            ndim = len(shape)
            lead = (1 if with_participants else 0) + (1 if stacked else 0)
            base = base[: max(ndim - lead, 0)]
            while len(base) < ndim - lead:
                base.append(None)
            spec = tuple(base)
            if stacked:
                spec = (None,) + spec
            if with_participants:
                spec = (self.part_axis,) + spec
            spec = self._fix_divisibility(spec, shape)
            if world:
                spec = self._world_param_rule(path, spec)
            specs.append(spec)
        return treedef.unflatten(specs)

    def batch_spec(self, batch, *, with_participants: bool,
                   shard_seq: bool = False) -> object:
        """Inputs: train (P, E, B, ...) — E is the local-step/microbatch
        axis; serve (B, ...)."""
        def leaf_spec(leaf):
            shape = _shape(leaf)
            nd = len(shape)
            if with_participants:
                spec = ([self.part_axis, None, self.batch_axis]
                        + [None] * (nd - 3))
            else:
                spec = [None if shard_seq else "data"] + [None] * (nd - 1)
            return self._fix_divisibility(tuple(spec), shape)

        leaves, treedef = tree_flatten(batch)
        return treedef.unflatten([leaf_spec(x) for x in leaves])

    def cache_spec(self, cache, *, shard_seq: bool,
                   world: bool = False) -> object:
        """KV caches (L,B,T,KV,hd) + recurrent states.

        ``shard_seq`` (long_500k, B=1): shard T over ``data`` —
        flash-decoding-style partial softmax; otherwise shard B.
        ``world``: a world rank's layout (the rules ``token_shift_whole``
        and ``attention_whole`` of the module docstring; at ``chip``
        granularity, whose replicas are whole, nothing over ``model``).
        A split sequence (T over ``model`` where the kv heads do not divide
        it, over ``data`` under ``shard_seq``) is the reference's in a
        world too (:meth:`seq_axis`).
        """
        def leaf_spec(path_elems, leaf):
            name = _k(path_elems[-1]) if path_elems else ""
            shape = _shape(leaf)
            nd = len(shape)
            if nd == 0:
                return ()
            if name in ("k", "v", "xk", "xv"):           # (L,B,T,KV,hd)
                kv_ok = shape[3] % self._axis_size["model"] == 0
                if shard_seq:
                    spec = (None, None, "data", "model" if kv_ok else None, None)
                elif kv_ok:
                    spec = (None, "data", None, "model", None)
                else:
                    # kv heads don't divide the model axis: shard the
                    # sequence dim over 'model' instead
                    spec = (None, "data", "model", None, None)
            elif name == "S":                             # rwkv (L,B,H,hd,hd)
                spec = (None, None if shard_seq else "data", "model", None, None)
            elif name == "ssm":                           # hymba (L,B,di,N)
                spec = (None, None if shard_seq else "data", "model", None)
            elif name in ("conv", "last_tm", "last_cm"):  # (L,B,*,d)/(L,B,d)
                spec = ((None, None if shard_seq else "data", None, "model")
                        if nd == 4 else
                        (None, None if shard_seq else "data", "model"))
            else:
                spec = tuple([None] * nd)
            spec = self._fix_divisibility(spec, shape)
            if world and (not self.splits_model
                          or name in ("last_tm", "last_cm") or (
                              name in ("k", "v", "xk", "xv")
                              and self._attention_whole())):
                spec = tuple(None if a == "model" else a for a in spec)
            return spec

        flat, treedef = tree_flatten_with_path(cache)
        return treedef.unflatten([leaf_spec(pe, leaf) for pe, leaf in flat])

    @staticmethod
    def seq_axis(cache_spec, name: str = "k"):
        """The mesh axis over which ``cache_spec`` (a tree of
        :meth:`cache_spec`) splits the sequence of the cache leaf ``name``
        (``k``: the self-attention's keys and values; ``xk``: Whisper's
        cross cache), or None: whole."""
        spec = cache_spec.get(name) if isinstance(cache_spec, dict) else None
        return spec[2] if spec is not None and len(spec) > 2 else None

    def weights_spec(self) -> Tuple:
        return (self.part_axis,)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape; a host scalar (a cache's ``pos``) has none."""
    return tuple(getattr(leaf, "shape", ()))


def _k(p) -> str:
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "idx"):
        return str(p.idx)
    if hasattr(p, "name"):
        return str(p.name)
    return str(p)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig, policy: ShardingPolicy):
    """Stand-ins on the ``meta`` device for every model input of this
    (arch, shape): shapes and dtypes, no data.

    train: per-participant token batches (P, E=1, B/P, S)
    prefill: (B, S) prompt (+ modality stubs)
    decode: (B, 1) next token (the cache holding ``seq_len`` tokens is the
    server's ``abstract_cache``)
    """
    i32 = torch.int32
    bf = getattr(torch, cfg.param_dtype)

    def sd(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "train":
        Pn = policy.n_participants
        B = max(shape.global_batch // max(Pn, 1), 1)
        batch = {
            "tokens": sd((Pn, 1, B, shape.seq_len), i32),
            "labels": sd((Pn, 1, B, shape.seq_len), i32),
        }
        if cfg.family == "audio":
            batch["frames"] = sd((Pn, 1, B, cfg.n_frames, cfg.d_model), bf)
        if cfg.family == "vlm":
            n_img = cfg.image_tokens * cfg.anyres_tiles
            batch["image_embeds"] = sd((Pn, 1, B, n_img, cfg.d_model), bf)
        return batch

    B = shape.global_batch
    if shape.kind == "prefill":
        batch = {"tokens": sd((B, shape.seq_len), i32)}
        if cfg.family == "audio":
            batch["frames"] = sd((B, cfg.n_frames, cfg.d_model), bf)
        if cfg.family == "vlm":
            n_img = cfg.image_tokens * cfg.anyres_tiles
            batch["image_embeds"] = sd((B, n_img, cfg.d_model), bf)
        return batch

    # decode: one token against a seq_len cache
    return {"token": sd((B, 1), i32)}


__all__ = ["Blocks", "DeviceMesh", "FlatPlacement", "FlatShardings",
           "ShardingPolicy", "axis_names", "flat_shardings", "gather_over",
           "gather_tree", "input_specs", "local_shard", "mesh_device",
           "reduce_over"]
