"""Pytree checkpointing to .npz with JSON metadata. Keys are '/'-joined
tree paths (a dict entry by its key, a sequence element by its index, a
namedtuple field by its name), so restore round-trips any nested
dict/list/namedtuple structure produced by the models and optimizers, and
a file written here restores in the reference package and back.

Two safety rails on the key scheme:

* a dict key that itself contains ``'/'`` (e.g. the engine's ``attn/wo``
  leaf names) can flatten to the same npz key as a genuinely nested path —
  ``save`` detects the collision and raises instead of silently letting
  the later array overwrite the earlier one;
* ``restore`` names the missing key (and previews the checkpoint's actual
  keys) when the template has leaves the checkpoint lacks.

npz has no bfloat16 (nor float8): such a leaf is stored as its unsigned
bit view, with the dtype's name (``"bfloat16"``, as the reference writes
it) under a parallel ``__dtype__/<key>`` entry. Tensors on the card are
copied to the host to be written.

``restore`` places every leaf on a device: by default the device of its
template leaf (a numpy template leaf gives a CPU tensor); ``shardings=``
names one device for every leaf, a pytree of devices matching the
template, or a :class:`repro_torch.sharding.FlatShardings`, whose
``replicated`` placement (the mesh's first device) takes every leaf.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.flat import FlatModel, _torch_dtype, as_tree
from repro_torch.utils.pytree import (tree_flatten_with_path, tree_leaves,
                                      tree_unflatten)

_NPZ_NATIVE = set("?bhilqBHILQefdgFD")
_NUMPY_HAS = {torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
              torch.int64, torch.float16, torch.float32, torch.float64,
              torch.complex64, torch.complex128}
_SIGNED_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a host array npz can store, plus the real dtype's name
    where npz lacks it (the array is then its unsigned bit view)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _NUMPY_HAS:
            return t.numpy(), None
        size = t.element_size()
        bits = t.view(_SIGNED_OF_SIZE[size]).numpy()
        return bits.view(np.dtype(f"u{size}")), str(t.dtype).split(".")[-1]
    arr = np.asarray(leaf)
    if arr.dtype.char not in _NPZ_NATIVE:
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), str(arr.dtype)
    return arr, None


def _flatten(tree) -> dict:
    flat = {}
    origin = {}          # npz key -> tree path parts, for collision errors

    def put(key, parts, arr):
        if key in flat:
            raise ValueError(
                f"checkpoint key collision: tree paths {origin[key]!r} and "
                f"{parts!r} both flatten to npz key {key!r} — a dict key "
                "containing '/' is indistinguishable from a nested path in "
                "the flat namespace; rename the offending key")
        flat[key] = arr
        origin[key] = parts

    for path, leaf in tree_flatten_with_path(tree)[0]:
        parts = tuple(_path_str(p) for p in path)
        key = "/".join(parts)
        arr, dtype_name = _to_numpy(leaf)
        if dtype_name is not None:
            put("__dtype__/" + key, ("__dtype__",) + parts,
                np.array(dtype_name))
        put(key, parts, arr)
    return flat


def _path_str(p) -> str:
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "idx"):
        return str(p.idx)
    if hasattr(p, "name"):
        return str(p.name)
    return str(p)


def save(path: str, tree, meta: Optional[dict] = None) -> None:
    tree = as_tree(tree)     # checkpoints are a FlatModel task boundary
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    with open(_meta_path(path), "w") as fh:
        json.dump(meta or {}, fh)


def _is_flat_shardings(shardings) -> bool:
    # duck-typed, as in the reference: the flat layouts of a mesh
    return hasattr(shardings, "replicated") and hasattr(shardings, "mesh")


def _leaf_devices(shardings, like_leaves):
    """One device (or None: the template leaf's own) per template leaf."""
    if shardings is None:
        return [None] * len(like_leaves)
    if _is_flat_shardings(shardings):
        # pytree leaves load replicated; the flat (N,) layouts apply to
        # packed buffers, not to individual leaves
        return [shardings.replicated.home] * len(like_leaves)
    if isinstance(shardings, (torch.device, str)):
        return [torch.device(shardings)] * len(like_leaves)
    sh_leaves = tree_leaves(shardings)
    if len(sh_leaves) != len(like_leaves):
        raise ValueError(
            f"shardings pytree has {len(sh_leaves)} leaves for a template "
            f"with {len(like_leaves)} leaves")
    return [torch.device(d) for d in sh_leaves]


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name is None:
        return torch.from_numpy(arr)
    bits = arr.view(np.dtype(f"i{arr.dtype.itemsize}"))
    return torch.from_numpy(bits).view(getattr(torch, dtype_name))


def restore(path: str, like, *, shardings=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (a template pytree of
    tensors or numpy arrays); returns ``(tree, meta)``, every leaf a
    tensor of its template leaf's shape and dtype.

    ``shardings`` places the leaves: None puts each on its template leaf's
    device (a numpy leaf's is the CPU), a ``torch.device`` or string puts
    all of them there, a pytree of devices matching the template one each,
    a ``FlatShardings`` all of them on its ``replicated`` placement.

    ``like`` may be a :class:`~repro_torch.engine.flat.FlatModel`: the
    checkpoint restores into its pytree and re-packs, and with a
    ``FlatShardings`` the packed buffer lands on the flat ``vec`` layout's
    device.
    """
    if isinstance(like, FlatModel):
        tree, meta = restore(path, like.tree, shardings=shardings)
        model = FlatModel.pack(tree, like.spec)
        if _is_flat_shardings(shardings):
            model = FlatModel(model.buffer.to(shardings.vec.home), like.spec)
        return model, meta

    paths, treedef = tree_flatten_with_path(like)
    devices = _leaf_devices(shardings, [leaf for _, leaf in paths])
    out = []
    with np.load(path if path.endswith(".npz") else path + ".npz") as npz:
        for (path_elems, leaf), device in zip(paths, devices):
            key = "/".join(_path_str(p) for p in path_elems)
            if key not in npz:
                avail = sorted(k for k in npz.files
                               if not k.startswith("__dtype__/"))
                preview = ", ".join(avail[:8]) + (", ..." if len(avail) > 8
                                                  else "")
                raise KeyError(
                    f"template leaf {key!r} not in checkpoint {path!r}; the "
                    f"checkpoint has {len(avail)} keys: "
                    f"{preview or '(none)'}")
            arr = npz[key]
            dkey = "__dtype__/" + key
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint/template shape mismatch at "
                                 f"{key}: {arr.shape} vs {leaf.shape}")
            t = _from_numpy(arr, str(npz[dkey]) if dkey in npz else None)
            if device is None:
                device = (leaf.device if isinstance(leaf, torch.Tensor)
                          else torch.device("cpu"))
            out.append(t.to(device=device, dtype=_torch_dtype(leaf.dtype)))
    meta = {}
    mp = _meta_path(path)
    if os.path.exists(mp):
        with open(mp) as fh:
            meta = json.load(fh)
    return tree_unflatten(treedef, out), meta


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"
