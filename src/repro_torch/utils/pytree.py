"""Pytree arithmetic used by optimizers, aggregation and the protocol core.

A pytree here is a nesting of ``dict`` / ``list`` / ``tuple`` /
namedtuple / ``None`` around leaves (tensors, arrays, scalars). Flattening
reproduces the order of ``jax.tree.flatten``: dict entries by sorted key,
sequences and namedtuple fields in order, ``None`` holding no leaf — so the
flat-buffer layout built on it (:mod:`repro_torch.engine.flat`) is
interchangeable with the reference's. A namedtuple keeps its type: mapping
over an optimizer state gives back the same state class.

:func:`tree_flatten_with_path` names every leaf by the key parts that
``jax.tree_util.tree_flatten_with_path`` gives it (a dict entry by its key,
a sequence element by its index, a namedtuple field by its name), which is
what checkpoint files are keyed by.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Hashable, List, Tuple

import numpy as np
import torch

_LEAF = ("leaf",)
_NONE = ("none",)


class TreeDef:
    """Hashable structure of a pytree (the part that is not leaves)."""

    __slots__ = ("node", "num_leaves")

    def __init__(self, node, num_leaves: int):
        self.node = node
        self.num_leaves = num_leaves

    def flatten_up_to(self, tree) -> List[Any]:
        """Leaves of ``tree`` read along *this* structure (``tree`` may hold
        whole subtrees where this structure has a leaf)."""
        out: List[Any] = []
        _flatten_up_to(self.node, tree, out)
        return out

    def unflatten(self, leaves):
        it = iter(leaves)
        tree = _unflatten(self.node, it)
        if next(it, _LEAF) is not _LEAF:
            raise ValueError("too many leaves for this tree structure")
        return tree

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self.node == other.node

    def __hash__(self):
        return hash(self.node)

    def __repr__(self):
        return f"TreeDef({self.num_leaves} leaves)"


@dataclass(frozen=True)
class DictKey:
    """Path part of a dict entry (``jax.tree_util.DictKey``)."""
    key: Hashable


@dataclass(frozen=True)
class SequenceKey:
    """Path part of a list or tuple element (``jax.tree_util.SequenceKey``)."""
    idx: int


@dataclass(frozen=True)
class GetAttrKey:
    """Path part of a namedtuple field (``jax.tree_util.GetAttrKey``)."""
    name: str


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _structure(tree, leaves: list):
    if tree is None:
        return _NONE
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_structure(tree[k], leaves) for k in keys))
    if _is_namedtuple(tree):
        return ("namedtuple", type(tree),
                tuple(_structure(t, leaves) for t in tree))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(_structure(t, leaves) for t in tree))
    leaves.append(tree)
    return _LEAF


def _flatten_up_to(node, tree, out: list) -> None:
    kind = node[0]
    if kind == "leaf":
        out.append(tree)
    elif kind == "none":
        if tree is not None:
            raise ValueError("tree structure mismatch: expected None")
    elif kind == "dict":
        if not isinstance(tree, dict) or tuple(sorted(tree)) != node[1]:
            raise ValueError("tree structure mismatch: dict keys differ")
        for k, child in zip(node[1], node[2]):
            _flatten_up_to(child, tree[k], out)
    elif kind == "namedtuple":
        if type(tree) is not node[1]:
            raise ValueError(f"tree structure mismatch: expected "
                             f"{node[1].__name__}")
        for child, sub in zip(node[2], tree):
            _flatten_up_to(child, sub, out)
    else:
        if not isinstance(tree, (list, tuple)) or len(tree) != len(node[1]):
            raise ValueError("tree structure mismatch: sequence differs")
        for child, sub in zip(node[1], tree):
            _flatten_up_to(child, sub, out)


def _unflatten(node, it):
    kind = node[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(child, it) for k, child in zip(node[1], node[2])}
    if kind == "namedtuple":
        return node[1](*[_unflatten(child, it) for child in node[2]])
    seq = [_unflatten(child, it) for child in node[1]]
    return seq if kind == "list" else tuple(seq)


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    node = _structure(tree, leaves)
    return leaves, TreeDef(node, len(leaves))


def _paths(node, prefix: tuple, out: list) -> None:
    kind = node[0]
    if kind == "leaf":
        out.append(prefix)
    elif kind == "dict":
        for k, child in zip(node[1], node[2]):
            _paths(child, prefix + (DictKey(k),), out)
    elif kind == "namedtuple":
        for name, child in zip(node[1]._fields, node[2]):
            _paths(child, prefix + (GetAttrKey(name),), out)
    elif kind != "none":
        for i, child in enumerate(node[1]):
            _paths(child, prefix + (SequenceKey(i),), out)


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in leaf order; a path is a tuple
    of :class:`DictKey` / :class:`SequenceKey` / :class:`GetAttrKey`."""
    leaves, treedef = tree_flatten(tree)
    paths: list = []
    _paths(treedef.node, (), paths)
    return list(zip(paths, leaves)), treedef


def tree_unflatten(treedef: TreeDef, leaves):
    return treedef.unflatten(leaves)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(leaves, *others)])


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.subtract, a, b)


def tree_scale(tree, alpha):
    return tree_map(lambda x: x * alpha, tree)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leaf-wise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def check_aggregation_weights(weights) -> None:
    """Shared zero-weight guard for every aggregation path (see
    :func:`tree_weighted_mean` for the contract). Reads the weights on the
    host, so pass host values (lists, numpy, CPU tensors)."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    total = float(np.sum(np.asarray(weights, np.float32)))
    if total <= 0.0:
        raise ValueError(f"aggregation weights sum to {total}; "
                         "weighted mean requires a positive total")


def tree_weighted_mean(trees, weights):
    """Weighted mean of a list of pytrees of tensors.

    This is the *reference* aggregation used by the protocol core (the
    sequential engine); the whole-model one-pass kernels in
    :mod:`repro_torch.kernels.fused` implement the same contraction.

    **Zero-weight contract** (shared by every aggregation path — this
    function and ``aggregate_flatmodel``): ``weights`` need not be
    normalized, but a non-positive total is a caller error and raises
    ``ValueError``.
    """
    check_aggregation_weights(weights)
    w_host = torch.as_tensor(np.asarray(weights, np.float32))
    cache = {}

    def avg(*leaves):
        dev = leaves[0].device
        if dev not in cache:
            w = w_host.to(dev)
            cache[dev] = (w, torch.sum(w))
        w, total = cache[dev]
        stacked = torch.stack([leaf.to(torch.float32) for leaf in leaves])
        out = torch.tensordot(w, stacked, dims=1) / total
        return out.to(leaves[0].dtype)

    return tree_map(avg, *trees)


def tree_global_norm(tree):
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def tree_num_params(tree) -> int:
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)))


def _itemsize(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return np.dtype(x.dtype).itemsize


def tree_size_bytes(tree) -> int:
    """Total byte size of a pytree of tensors or arrays.

    A :class:`~repro_torch.engine.flat.FlatModel` reports the byte size of
    the pytree it encodes (original per-leaf dtypes), not of its fp32
    working buffer — wire accounting is representation-independent.
    """
    if hasattr(tree, "wire_bytes"):            # FlatModel (duck-typed: no
        return int(tree.wire_bytes)            # engine import in utils)
    total = 0
    for x in tree_leaves(tree):
        total += int(np.prod(tuple(x.shape))) * _itemsize(x)
    return total
