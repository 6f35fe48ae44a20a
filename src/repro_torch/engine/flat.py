"""FlatModel: contiguous-buffer model representation for the compute engine.

The protocol core moves *pytrees* between nodes; the compute hot loop wants
*vectors*. A :class:`FlatSpec` is computed once per task and records, for
every leaf of the parameter pytree: offsets into one contiguous ``(N,)``
fp32 buffer, the original shape/dtype, and a precomputed integer-leaf mask
(optimizer step counters and token counts must round to nearest on the way
back out).

Inside the hot loop (aggregation, cohort training) models live as single
``(N,)`` buffers (stacked to ``(P, N)`` / ``(S, N)``); unflattening back to
the pytree happens only at task boundaries — evaluation and the wire for
non-engine consumers. Unpacked fp32 leaves are *views* of the buffer, not
copies; nothing in the package writes to a parameter tensor in place.

Leaf order, offsets and the mask equal the reference package's, so a flat
buffer can be handed from one package to the other as a numpy array.

Precision note: the flat buffer is fp32. bf16 leaves round-trip exactly
(bf16 ⊂ fp32); integer leaves are exact up to 2^24 (the protocol's integer
leaves are step/round counters, far below that) and are rounded to nearest
(half to even) when unpacked.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_flatten, tree_map

_NP_TO_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return _NP_TO_TORCH[np.dtype(dt).name]


def _is_int(dt: torch.dtype) -> bool:
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


class FlatSpec:
    """Layout of one model family's parameter pytree in a flat buffer."""

    def __init__(self, treedef, shapes, dtypes):
        self.treedef = treedef
        self.shapes: Tuple[tuple, ...] = tuple(tuple(s) for s in shapes)
        self.dtypes: Tuple[torch.dtype, ...] = tuple(
            _torch_dtype(d) for d in dtypes)
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        offs = np.cumsum((0,) + self.sizes)
        self.offsets = tuple(int(o) for o in offs[:-1])
        self.n = int(offs[-1])
        # wire/storage size of the *original* pytree (per-leaf dtypes), not
        # of the fp32 working buffer — byte accounting must not change when
        # a model rides through the engine.
        self.nbytes = sum(s * d.itemsize
                          for s, d in zip(self.sizes, self.dtypes))
        mask = np.zeros(self.n, np.bool_)
        for off, size, dt in zip(self.offsets, self.sizes, self.dtypes):
            if _is_int(dt):
                mask[off:off + size] = True
        self.int_mask = mask              # (n,) True where the leaf is integer
        self.has_int = bool(mask.any())
        self._mask_on: Dict[torch.device, torch.Tensor] = {}

    @classmethod
    def from_tree(cls, tree) -> "FlatSpec":
        """Works on tensors, numpy arrays and python scalars as leaves."""
        leaves, treedef = tree_flatten(tree)
        shapes = [tuple(l.shape) if hasattr(l, "shape") else np.shape(l)
                  for l in leaves]
        dtypes = [l.dtype if hasattr(l, "dtype") else np.asarray(l).dtype
                  for l in leaves]
        return cls(treedef, shapes, dtypes)

    def int_mask_on(self, device) -> Optional[torch.Tensor]:
        """The integer-leaf mask as ``(n,)`` bytes on ``device`` (uploaded
        once per device); None when the spec has no integer leaf."""
        if not self.has_int:
            return None
        device = torch.device(device)
        m = self._mask_on.get(device)
        if m is None:
            m = torch.from_numpy(self.int_mask.astype(np.uint8)).to(device)
            self._mask_on[device] = m
        return m

    # ------------------------------------------------------------------ pack

    def pack(self, tree) -> torch.Tensor:
        """pytree -> (n,) fp32 buffer."""
        leaves = self.treedef.flatten_up_to(tree)
        return torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])

    def pack_stacked(self, tree) -> torch.Tensor:
        """pytree with a leading stack axis S on every leaf -> (S, n) fp32."""
        leaves = self.treedef.flatten_up_to(tree)
        s = leaves[0].shape[0]
        return torch.cat(
            [l.reshape(s, -1).to(torch.float32) for l in leaves], dim=1)

    def pack_many(self, trees: Sequence) -> torch.Tensor:
        """list of P pytrees -> (P, n) fp32."""
        return torch.stack([self.pack(t) for t in trees])

    # ---------------------------------------------------------------- unpack

    def _leaf_views(self, buf, lead: tuple):
        out = []
        for off, size, shape, dt in zip(self.offsets, self.sizes,
                                        self.shapes, self.dtypes):
            x = buf[..., off:off + size].reshape(lead + shape)
            if _is_int(dt):
                x = torch.round(x)           # half to even, as jnp.round
            out.append(x.to(dt))
        return out

    def unpack(self, buf) -> Any:
        """(n,) buffer -> pytree with original shapes/dtypes."""
        return self.treedef.unflatten(self._leaf_views(buf, ()))

    def unpack_stacked(self, buf) -> Any:
        """(S, n) -> pytree whose every leaf has a leading S axis."""
        return self.treedef.unflatten(self._leaf_views(buf, (buf.shape[0],)))

    # -------------------------------------------------------------- sharding

    def sharding(self, mesh, *, model_axis: str = "model",
                 row_axis: Optional[str] = None):
        """This spec's flat layouts on ``mesh`` (a sequence of devices).

        Returns a :class:`repro_torch.sharding.FlatShardings`: the
        parameter axis N of the ``(N,)`` / ``(S, N)`` / ``(P, N)`` buffers
        is split over ``model_axis``; leading S/P axes are not. The layouts
        do not depend on ``n`` — the kernels pad each shard to a SUBTILE
        multiple (see :func:`repro_torch.kernels.fused.shard_align`) so
        per-subtile quantization stays bit-identical to one device.
        """
        from repro_torch.sharding import flat_shardings
        return flat_shardings(mesh, model_axis=model_axis, row_axis=row_axis)

    def __eq__(self, other):
        return (isinstance(other, FlatSpec)
                and self.treedef == other.treedef
                and self.shapes == other.shapes
                and self.dtypes == other.dtypes)

    def __hash__(self):
        return hash((self.treedef, self.shapes, self.dtypes))

    def __repr__(self):
        return (f"FlatSpec(n={self.n}, leaves={len(self.shapes)}, "
                f"nbytes={self.nbytes})")


@dataclass(eq=False)           # eq would compare tensors elementwise;
class FlatModel:               # identity comparison is the meaningful one
    """A model as one fp32 buffer + the spec to rebuild the pytree.

    Payloads carry FlatModel through the hot loop; ``tree`` materializes
    the pytree lazily at task boundaries (and caches it).
    """

    buffer: torch.Tensor                 # (n,) fp32
    spec: FlatSpec
    _tree: Optional[Any] = field(default=None, repr=False, compare=False)

    @property
    def tree(self):
        if self._tree is None:
            self._tree = self.spec.unpack(self.buffer)
        return self._tree

    @property
    def wire_bytes(self) -> int:
        """Byte size on the wire = size of the original-dtype pytree."""
        return self.spec.nbytes

    @classmethod
    def pack(cls, tree, spec: Optional[FlatSpec] = None) -> "FlatModel":
        if isinstance(tree, FlatModel):
            return tree
        spec = spec or FlatSpec.from_tree(tree)
        return cls(spec.pack(tree), spec)


def as_tree(params):
    """Boundary helper: FlatModel -> pytree; anything else passes through."""
    if isinstance(params, FlatModel):
        return params.tree
    return params


def as_buffer(params, spec: FlatSpec):
    """Hot-loop helper: pytree or FlatModel -> (n,) fp32 buffer."""
    if isinstance(params, FlatModel):
        return params.buffer
    return spec.pack(params)


# ---------------------------------------------------------------------------
# Carrying weights across: numpy trees <-> the port's parameter trees
# ---------------------------------------------------------------------------


def _leaf_from_numpy(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # numpy has no native bf16: the
        bits = np.ascontiguousarray(a).view(np.uint16)   # bits carry over
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def params_from_numpy(tree, device=None):
    """Tree of numpy arrays (e.g. the reference task's ``init_params``
    fetched to the host) -> the same tree of tensors on ``device``
    (None = cuda). Shapes, dtypes and bits are kept, bf16 included."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def params_to_numpy(tree):
    """Tree of tensors (or a FlatModel) -> tree of numpy arrays on the
    host. numpy has no bf16, so bf16 leaves come back widened to fp32
    (exact); every other dtype is kept."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    return tree_map(leaf, as_tree(tree))
