"""The PyTorch package's pytree against ``jax.tree_util``: leaf order,
path keys, and the structure that unflatten rebuilds, on trees with dicts
(a ``/`` in a key included), lists, tuples, ``None`` and namedtuples (an
adamw state). Tier: exact (structure, order, keys, leaf bits)."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim
from repro_torch.engine.flat import FlatSpec
from repro_torch.utils.pytree import (TreeDef, tree_flatten,
                                      tree_flatten_with_path, tree_leaves,
                                      tree_map, tree_unflatten)

Pair = collections.namedtuple("Pair", ["left", "right"])


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((3,), (2, 2), (4,), (1,), (2,), (5,))]


def _tree(kind, pkg, seed=0):
    """The same tree built of jnp arrays (``pkg="jax"``) or tensors."""
    a = _arrays(seed)
    leaf = jnp.asarray if pkg == "jax" else torch.from_numpy
    adamw = (joptim if pkg == "jax" else optim).adamw(1e-3)
    if kind == "nested":
        return {"b": [leaf(a[0]), None, (leaf(a[1]), leaf(a[2]))],
                "a/x": leaf(a[3]), "a": {"x": leaf(a[4])}}
    if kind == "adamw":
        return {"params": {"w": leaf(a[0]), "b": leaf(a[3])},
                "opt": adamw.init({"w": leaf(a[0]), "b": leaf(a[3])})}
    if kind == "namedtuples":
        return [Pair(leaf(a[0]), Pair(None, [leaf(a[1])])),
                (leaf(a[2]),), {"z": Pair(leaf(a[5]), leaf(a[4]))}]
    raise ValueError(kind)


KINDS = ("nested", "adamw", "namedtuples")


def _parts(path):
    """A path of either package as (key class name, key) pairs."""
    out = []
    for p in path:
        name = type(p).__name__
        attr = {"DictKey": "key", "SequenceKey": "idx",
                "GetAttrKey": "name"}[name]
        out.append((name, getattr(p, attr)))
    return tuple(out)


def _shape_of(tree):
    """Container types and dict keys, leaves replaced by a marker."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _shape_of(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        fields = getattr(type(tree), "_fields", None)
        kind = (type(tree).__name__, fields) if fields else \
            type(tree).__name__
        return (kind, tuple(_shape_of(t) for t in tree))
    return "leaf"


@pytest.mark.parametrize("kind", KINDS)
def test_flatten_order_and_path_keys_equal_jax(kind):
    jt, tt = _tree(kind, "jax"), _tree(kind, "torch")
    jpaths, _ = jax.tree_util.tree_flatten_with_path(jt)
    tpaths, treedef = tree_flatten_with_path(tt)
    assert [_parts(p) for p, _ in tpaths] == \
        [_parts(p) for p, _ in jpaths]
    assert len(tpaths) == treedef.num_leaves == len(jax.tree.leaves(jt))
    for (_, a), (_, b) in zip(tpaths, jpaths):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [l for _, l in tpaths] == tree_leaves(tt)


@pytest.mark.parametrize("kind", KINDS)
def test_map_and_unflatten_rebuild_the_structure_jax_rebuilds(kind):
    jt, tt = _tree(kind, "jax"), _tree(kind, "torch")
    jout = jax.tree.map(lambda x: x * 2, jt)
    tout = tree_map(lambda x: x * 2, tt)
    assert _shape_of(tout) == _shape_of(jout) == _shape_of(tt)
    leaves, treedef = tree_flatten(tt)
    back = tree_unflatten(treedef, leaves)
    assert _shape_of(back) == _shape_of(tt)
    for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_adamw_state_keeps_its_type_and_field_names():
    state = optim.adamw(1e-3).init({"w": torch.ones(3)})
    doubled = tree_map(lambda x: x * 2, state)
    assert type(doubled) is type(state)
    assert torch.equal(doubled.mu["w"], torch.zeros(3))
    assert doubled.count.dtype == torch.int32
    keys = ["/".join(str(getattr(p, "name", getattr(p, "key", None)))
                     for p in path)
            for path, _ in tree_flatten_with_path({"opt": state})[0]]
    assert keys == ["opt/mu/w", "opt/nu/w", "opt/count"]


def test_namedtuple_and_tuple_structures_differ_as_in_jax():
    state = optim.adamw(1e-3).init({"w": torch.ones(3)})
    jstate = joptim.adamw(1e-3).init({"w": jnp.ones(3)})
    assert (jax.tree.structure(jstate)
            != jax.tree.structure(tuple(jstate)))
    d_nt, d_tup = tree_flatten(state)[1], tree_flatten(tuple(state))[1]
    assert isinstance(d_nt, TreeDef) and d_nt != d_tup
    assert d_nt == tree_flatten(tree_map(lambda x: x + 1, state))[1]
    assert hash(d_nt) == hash(tree_flatten(
        optim.adamw(0.5).init({"w": torch.zeros(3)}))[1])
    # a plain tuple read along a namedtuple's structure is a mismatch
    with pytest.raises(ValueError, match="_AdamState"):
        d_nt.flatten_up_to(tuple(state))
    assert len(d_nt.flatten_up_to(state)) == 3
    with pytest.raises(ValueError):
        jax.tree.map(lambda x, y: x, jstate, tuple(jstate))


def test_flatspec_equality_hash_and_pack_unchanged_by_namedtuples():
    """FlatSpec compares and hashes by structure; a namedtuple in the tree
    gives a spec of its own, equal to its twin, and pack/unpack round-trip
    it with its type."""
    tree = {"params": {"w": torch.arange(4.0)},
            "opt": optim.adamw(1e-3).init({"w": torch.arange(4.0)})}
    a, b = FlatSpec.from_tree(tree), FlatSpec.from_tree(
        tree_map(torch.clone, tree))
    assert a == b and hash(a) == hash(b)
    plain = {"params": tree["params"], "opt": tuple(tree["opt"])}
    assert FlatSpec.from_tree(plain) != a
    assert a.n == 13 and a.has_int
    back = a.unpack(a.pack(tree))
    assert type(back["opt"]) is type(tree["opt"])
    assert back["opt"].count.dtype == torch.int32
    for x, y in zip(tree_leaves(back), tree_leaves(tree)):
        assert torch.equal(x, y)
