"""Checkpoints of the PyTorch package: the cases of ``test_checkpoint.py``
mirrored on the port, and files that cross between the two packages.

Tiers: exact throughout. Keys, dtypes, shapes and meta equal the
reference's; every restored leaf equals the saved one bit for bit, bf16
and int32 leaves, optimizer states and ``FlatModel`` buffers included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro import optim as joptim
from repro.engine.flat import FlatModel as JFlatModel
from repro_torch import checkpoint, configs, optim
from repro_torch.engine.flat import FlatModel
from repro_torch.models import build
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401


def _bits(x) -> np.ndarray:
    """A leaf of either package as a host array of its exact bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same_bits(a, b) -> None:
    a, b = _bits(a), _bits(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_roundtrip_nested(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": [torch.zeros((2, 2)), torch.full((1,), 7.0)]}}
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, tree, meta={"round": 12})
    back, meta = checkpoint.restore(path, tree)
    assert meta["round"] == 12
    for x, y in zip(tree_leaves(back), tree_leaves(tree)):
        assert x.dtype == y.dtype
        _same_bits(x, y)


def test_roundtrip_model_and_opt(tmp_path):
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    params = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    opt = optim.momentum(0.1)
    state = {"params": params, "opt": opt.init(params)}
    path = str(tmp_path / "full")
    checkpoint.save(path, state, meta={"arch": cfg.name})
    back, meta = checkpoint.restore(path, state)
    assert meta["arch"] == cfg.name
    a, b = tree_leaves(back), tree_leaves(state)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same_bits(x, y)


def test_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "bad")
    checkpoint.save(path, {"w": torch.zeros((3, 3))})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(path, {"w": torch.zeros((4, 4))})


# --------------------------------------------- parametrized round-trip grid


def _family_params(family: str):
    from repro_torch.models.tasks import cnn_task, mf_task
    task = cnn_task(device="cpu") if family == "cnn" else mf_task(
        device="cpu")
    return task.init_params(0)


@pytest.mark.parametrize("family", ["cnn", "mf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("kind", ["pytree", "flatmodel"])
def test_roundtrip_grid(tmp_path, family, dtype, kind):
    """Task families × leaf dtypes × FlatModel vs pytree templates."""
    params = _family_params(family)
    if not dtype.is_floating_point:
        # small exact integers (step counters): cast survives the fp32
        # flat buffer too (exact up to 2^24)
        tree = tree_map(lambda x: (torch.arange(x.numel()).reshape(x.shape)
                                   % 97).to(dtype), params)
    else:
        tree = tree_map(lambda x: x.to(dtype), params)
    obj = FlatModel.pack(tree) if kind == "flatmodel" else tree
    path = str(tmp_path / f"{family}-{dtype}-{kind}")
    checkpoint.save(path, obj, meta={"family": family})
    back, meta = checkpoint.restore(path, obj)
    assert meta["family"] == family
    if kind == "flatmodel":
        assert isinstance(back, FlatModel)
        assert torch.equal(back.buffer, obj.buffer)
        back = back.tree
    for x, y in zip(tree_leaves(back), tree_leaves(tree)):
        assert x.dtype == y.dtype
        _same_bits(x, y)


# ------------------------------------------------------- failure-mode rails


def test_slash_key_collision_raises(tmp_path):
    """A dict key containing '/' must not silently overwrite the
    genuinely nested path it collides with."""
    tree = {"attn/wo": torch.zeros((2,)), "attn": {"wo": torch.ones((2,))}}
    with pytest.raises(ValueError, match="collision"):
        checkpoint.save(str(tmp_path / "clash"), tree)


def test_slash_key_without_collision_roundtrips(tmp_path):
    tree = {"attn/wo": torch.arange(3, dtype=torch.float32)}
    path = str(tmp_path / "slashed")
    checkpoint.save(path, tree)
    back, _ = checkpoint.restore(path, tree)
    assert torch.equal(back["attn/wo"], tree["attn/wo"])


def test_dtype_companion_collision_raises(tmp_path):
    """A literal '__dtype__/...' key colliding with a bf16 leaf's dtype
    companion entry is caught too."""
    tree = {"__dtype__": {"w": torch.zeros((2,))},
            "w": torch.ones((2,), dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="collision"):
        checkpoint.save(str(tmp_path / "dclash"), tree)


def test_missing_key_clear_error(tmp_path):
    path = str(tmp_path / "partial")
    checkpoint.save(path, {"layer0": torch.zeros((2,)),
                           "layer1": torch.ones((2,))})
    with pytest.raises(KeyError) as exc:
        checkpoint.restore(path, {"layer0": torch.zeros((2,)),
                                  "layer2": torch.zeros((2,))})
    msg = str(exc.value)
    assert "layer2" in msg                  # which key is missing
    assert "layer0" in msg and "layer1" in msg   # what the checkpoint has


# -------------------------------------------------------- device placement


def test_restore_with_single_sharding(tmp_path):
    """One device for every leaf; without one, each leaf lands on its
    template leaf's device (a numpy template leaf's is the CPU). The
    ``meta`` device stands in for a second device on a machine with one."""
    tree = {"w": torch.arange(4, dtype=torch.float32),
            "n": torch.arange(3, dtype=torch.int32)}
    path = str(tmp_path / "sh")
    checkpoint.save(path, tree)
    for sh in ("meta", torch.device("meta")):
        back, _ = checkpoint.restore(path, tree, shardings=sh)
        assert {x.device.type for x in tree_leaves(back)} == {"meta"}
        assert back["n"].dtype == torch.int32
    back, _ = checkpoint.restore(path, tree_map(lambda x: x.to("meta"),
                                                tree))
    assert back["w"].is_meta and back["n"].dtype == torch.int32
    back, _ = checkpoint.restore(path, tree_map(lambda x: x.numpy(), tree))
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in tree_leaves(back))
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["n"], tree["n"])


def test_restore_with_sharding_pytree(tmp_path):
    tree = {"a": torch.zeros((2,)), "b": torch.ones((3,))}
    path = str(tmp_path / "shtree")
    checkpoint.save(path, tree)
    back, _ = checkpoint.restore(path, tree,
                                 shardings={"a": "meta", "b": "cpu"})
    assert back["a"].is_meta and back["b"].device.type == "cpu"
    assert torch.equal(back["b"], tree["b"])
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, tree, shardings={"a": "cpu"})


def test_restore_flatmodel_with_flat_shardings(tmp_path):
    """The reference's ``FlatShardings`` form: leaves land on its
    ``replicated`` placement, the mesh's first device, and a ``FlatModel``
    template re-packs onto ``vec``'s; a ``FlatModel`` template restored with
    a device re-packs there, and without one onto its own buffer's
    device."""
    fm = FlatModel.pack({"w": torch.arange(6, dtype=torch.float32),
                         "k": torch.arange(2, dtype=torch.int32)})
    path = str(tmp_path / "fmsh")
    checkpoint.save(path, fm)
    for mesh in (("cpu",) * 4, ("meta", "cpu")):
        fs = fm.spec.sharding(mesh)
        back, _ = checkpoint.restore(path, fm, shardings=fs)
        assert isinstance(back, FlatModel) and back.spec == fm.spec
        assert back.buffer.device == fs.vec.home == torch.device(mesh[0])
        tree, _ = checkpoint.restore(path, fm.tree, shardings=fs)
        assert {t.device for t in tree.values()} == {fs.replicated.home}
        if fs.replicated.home.type == "cpu":
            assert torch.equal(back.buffer, fm.buffer)
            assert all(torch.equal(tree[k], fm.tree[k]) for k in tree)
        else:
            assert back.buffer.is_meta and back.buffer.shape == (8,)
    back, _ = checkpoint.restore(path, fm, shardings="cpu")
    assert isinstance(back, FlatModel) and back.spec == fm.spec
    assert torch.equal(back.buffer, fm.buffer)
    back, _ = checkpoint.restore(path, fm, shardings="meta")
    assert back.buffer.is_meta and back.buffer.shape == fm.buffer.shape


# ------------------------------------------------------ across the packages


def _state_numpy(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "n": rng.integers(-50, 50, size=(5,)).astype(np.int32)}


def _jax_state(src):
    params = {"w": jnp.asarray(src["w"], jnp.bfloat16),
              "b": jnp.asarray(src["b"]), "n": jnp.asarray(src["n"])}
    opt = joptim.adamw(1e-3).init({"w": jnp.asarray(src["w"]),
                                   "b": jnp.asarray(src["b"])})
    opt = jax.tree.map(lambda x: x + 3, opt)     # counts and moments != 0
    return {"params": params, "opt": opt,
            "flat": JFlatModel.pack({"w": jnp.asarray(src["w"]),
                                     "n": jnp.asarray(src["n"])})}


def _torch_state(src):
    t = {k: torch.from_numpy(v) for k, v in src.items()}
    params = {"w": t["w"].to(torch.bfloat16), "b": t["b"], "n": t["n"]}
    opt = optim.adamw(1e-3).init({"w": t["w"], "b": t["b"]})
    opt = tree_map(lambda x: x + 3, opt)
    return {"params": params, "opt": opt,
            "flat": FlatModel.pack({"w": t["w"], "n": t["n"]})}


def _keys_and_dtypes(path):
    with np.load(path + ".npz") as npz:
        return {k: (npz[k].dtype.str, npz[k].shape,
                    str(npz[k]) if k.startswith("__dtype__/") else None)
                for k in npz.files}


@pytest.mark.parametrize("part", ["params", "opt", "flat"])
def test_reference_file_restores_in_the_port(tmp_path, part):
    """A file the reference wrote restores in the port, into a tree of
    tensors or a FlatModel, to the reference's bits and meta; and the
    port writes the same keys, dtypes and shapes for the same state."""
    src = _state_numpy()
    jstate, tstate = _jax_state(src), _torch_state(src)
    jpath, tpath = str(tmp_path / "ref"), str(tmp_path / "port")
    jcheckpoint.save(jpath, jstate[part], meta={"round": 7, "part": part})
    checkpoint.save(tpath, tstate[part], meta={"round": 7, "part": part})
    assert _keys_and_dtypes(tpath) == _keys_and_dtypes(jpath)
    back, meta = checkpoint.restore(jpath, tstate[part])
    assert meta == {"round": 7, "part": part}
    if part == "flat":
        assert isinstance(back, FlatModel)
        _same_bits(back.buffer, jstate["flat"].buffer)
        back, want = back.tree, jstate["flat"].tree
    else:
        want = jstate[part]
        assert type(back) is type(tstate[part])
    got, ref = tree_leaves(back), jax.tree.leaves(want)
    assert len(got) == len(ref) > 0
    for x, y in zip(got, ref):
        _same_bits(x, y)


@pytest.mark.parametrize("part", ["params", "opt", "flat"])
def test_port_file_restores_in_the_reference(tmp_path, part):
    """The other way: a file the port wrote (bf16 leaves as their bit view,
    the dtype's name beside them) restores in the reference bit for bit."""
    src = _state_numpy(seed=1)
    jstate, tstate = _jax_state(src), _torch_state(src)
    path = str(tmp_path / "port")
    checkpoint.save(path, tstate[part], meta={"round": 9})
    back, meta = jcheckpoint.restore(path, jstate[part])
    assert meta == {"round": 9}
    if part == "flat":
        assert isinstance(back, JFlatModel)
        _same_bits(tstate["flat"].buffer, back.buffer)
        back, have = back.tree, tstate["flat"].tree
    else:
        have = tstate[part]
        assert type(back) is type(jstate[part])
    got, ref = jax.tree.leaves(back), tree_leaves(have)
    assert len(got) == len(ref) > 0
    for x, y in zip(ref, got):
        _same_bits(x, y)
