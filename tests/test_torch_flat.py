"""Flat buffers are interchangeable between the reference package (JAX)
and the PyTorch package: same leaf order, offsets, byte counts and integer
mask, and a buffer packed by one unpacks in the other to equal bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.flat import FlatModel as JFlatModel
from repro.engine.flat import FlatSpec as JFlatSpec
from repro.models.tasks import cnn_task as jax_cnn_task
from repro_torch.engine.flat import (FlatModel, FlatSpec, as_buffer, as_tree,
                                     params_from_numpy, params_to_numpy)
from repro_torch.models.tasks import cnn_task
from repro_torch.utils.pytree import (tree_flatten, tree_leaves, tree_map,
                                      tree_size_bytes)
from test_torch_threads import one_torch_thread  # noqa: F401

CNN_KEYS = ["b1", "b2", "conv1", "conv2", "fc1", "fc2", "out"]


def _jax_tree(kind, image=(8, 8, 3), seed=0):
    """CNN params from the reference's init, then recast per ``kind``."""
    params = jax_cnn_task(cnn_image=image).init_params(seed)
    if kind == "bf16":
        params = jax.tree.map(lambda l: l.astype(jnp.bfloat16), params)
    elif kind == "int32":
        params = dict(params)
        params["step"] = jnp.asarray([7, -3, 123456], jnp.int32)
    return params


def _to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int32"])
def test_spec_equals_reference(kind):
    jt = _jax_tree(kind)
    js = JFlatSpec.from_tree(jt)
    ts = FlatSpec.from_tree(params_from_numpy(_to_numpy_tree(jt), "cpu"))
    assert ts.n == js.n and ts.nbytes == js.nbytes
    assert ts.offsets == js.offsets and ts.sizes == js.sizes
    assert ts.shapes == js.shapes
    assert ts.has_int == js.has_int
    np.testing.assert_array_equal(ts.int_mask, js.int_mask)
    assert [str(d).replace("torch.", "") for d in ts.dtypes] == \
        [np.dtype(d).name for d in js.dtypes]


def test_leaf_order_is_sorted_keys_like_jax():
    tree = params_from_numpy(_to_numpy_tree(_jax_tree("fp32")), "cpu")
    leaves, treedef = tree_flatten(tree)
    want = jax.tree.leaves(_jax_tree("fp32"))
    assert sorted(tree) == CNN_KEYS and len(leaves) == 7
    for a, b in zip(leaves, want):
        assert tuple(a.shape) == b.shape
    # nested containers: dict keys sorted, sequences in order, None no leaf
    nested = {"z": [1, (2, 3)], "a": {"y": 4, "x": None, "b": 5}}
    assert tree_leaves(nested) == jax.tree.leaves(nested) == [5, 4, 1, 2, 3]
    rebuilt = tree_flatten(nested)[1].unflatten([10, 20, 30, 40, 50])
    assert rebuilt == {"z": [30, (40, 50)], "a": {"y": 20, "x": None, "b": 10}}


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int32"])
def test_pack_in_jax_unpack_in_torch_and_back(kind):
    jt = _jax_tree(kind)
    js = JFlatSpec.from_tree(jt)
    jbuf = np.asarray(JFlatModel.pack(jt, js).buffer)          # (n,) fp32

    tt = params_from_numpy(_to_numpy_tree(jt), "cpu")
    ts = FlatSpec.from_tree(tt)
    # the reference's buffer unpacks in the port to the reference's leaves
    unpacked = ts.unpack(torch.from_numpy(jbuf.copy()))
    for k in jt:
        assert tuple(unpacked[k].shape) == jt[k].shape
        np.testing.assert_array_equal(
            unpacked[k].to(torch.float64).numpy(),
            np.asarray(jt[k], np.float64), err_msg=k)
    # and the port's pack of that tree gives the reference's buffer bits
    tbuf = ts.pack(unpacked).numpy()
    np.testing.assert_array_equal(_bits(tbuf), _bits(jbuf))
    np.testing.assert_array_equal(_bits(ts.pack(tt).numpy()), _bits(jbuf))
    # back: the port's buffer unpacks in the reference to equal leaves
    back = js.unpack(jnp.asarray(tbuf))
    for k in jt:
        assert back[k].dtype == jt[k].dtype
        np.testing.assert_array_equal(np.asarray(back[k], np.float64),
                                      np.asarray(jt[k], np.float64))


def test_stacked_pack_unpack_match_reference():
    jts = [_jax_tree("int32", seed=s) for s in range(3)]
    js = JFlatSpec.from_tree(jts[0])
    jstack = np.asarray(js.pack_many(jts))
    tts = [params_from_numpy(_to_numpy_tree(t), "cpu") for t in jts]
    ts = FlatSpec.from_tree(tts[0])
    tstack = ts.pack_many(tts)
    np.testing.assert_array_equal(_bits(tstack.numpy()), _bits(jstack))
    stacked = ts.unpack_stacked(tstack)
    assert stacked["conv1"].shape == (3,) + tuple(tts[0]["conv1"].shape)
    np.testing.assert_array_equal(
        _bits(ts.pack_stacked(stacked).numpy()), _bits(jstack))
    jst = js.unpack_stacked(jnp.asarray(jstack))
    for k in jst:
        np.testing.assert_array_equal(
            stacked[k].to(torch.float64).numpy(),
            np.asarray(jst[k], np.float64))


def test_unpack_rounds_integer_leaves_half_to_even():
    tree = {"step": torch.tensor([7, -3, 0, 0], dtype=torch.int32)}
    spec = FlatSpec.from_tree(tree)
    out = spec.unpack(torch.tensor([6.6, -3.4, 0.5, 1.5]))
    assert out["step"].dtype == torch.int32
    assert out["step"].tolist() == [7, -3, 0, 2]       # round, half to even
    jout = JFlatSpec.from_tree({"step": jnp.zeros(4, jnp.int32)}).unpack(
        jnp.asarray([6.6, -3.4, 0.5, 1.5], jnp.float32))
    assert jout["step"].tolist() == out["step"].tolist()


def test_flatmodel_lazy_tree_wire_bytes_and_helpers():
    task = cnn_task(device="cpu", cnn_image=(8, 8, 3))
    params = task.init_params(0)
    fm = FlatModel.pack(params, task.flat_spec)
    assert FlatModel.pack(fm) is fm
    assert fm._tree is None and fm.buffer.dtype == torch.float32
    assert fm.tree is fm.tree                           # cached
    assert as_tree(fm) is fm.tree and as_tree(params) is params
    assert as_buffer(fm, task.flat_spec) is fm.buffer
    assert torch.equal(as_buffer(params, task.flat_spec), fm.buffer)
    assert tree_size_bytes(fm) == tree_size_bytes(params) == fm.wire_bytes
    assert task.model_bytes() == tree_size_bytes(params)
    jtask = jax_cnn_task(cnn_image=(8, 8, 3))
    assert task.model_bytes() == jtask.model_bytes()
    assert task.flat_spec.n == jtask.flat_spec.n


def test_full_width_cnn_layout():
    spec = cnn_task(device="cpu").flat_spec
    jspec = jax_cnn_task().flat_spec
    assert spec.n == jspec.n == 136672 and len(spec.shapes) == 7
    assert spec.offsets == jspec.offsets and spec.nbytes == jspec.nbytes
    assert not spec.has_int and spec.int_mask_on("cpu") is None


def test_spec_eq_hash_and_mask_upload():
    a = FlatSpec.from_tree({"w": torch.zeros(3), "k": torch.zeros(2, dtype=torch.int32)})
    b = FlatSpec.from_tree({"k": torch.ones(2, dtype=torch.int32), "w": torch.ones(3)})
    c = FlatSpec.from_tree({"w": torch.zeros(3), "k": torch.zeros(2)})
    assert a == b and hash(a) == hash(b) and a != c
    m = a.int_mask_on("cpu")
    assert m.dtype == torch.uint8 and m.tolist() == [1, 1, 0, 0, 0]
    assert a.int_mask_on("cpu") is m                    # uploaded once


def test_params_numpy_round_trip_keeps_bits():
    jt = _jax_tree("bf16")
    tt = params_from_numpy(_to_numpy_tree(jt), "cpu")
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(tt))
    back = params_to_numpy(tt)
    for k in jt:
        np.testing.assert_array_equal(back[k], np.asarray(jt[k], np.float32))
    it = params_from_numpy({"step": np.asarray([1, 2], np.int32)}, "cpu")
    assert params_to_numpy(it)["step"].dtype == np.int32
    assert tree_map(lambda x: x.dtype, it) == {"step": torch.int32}
