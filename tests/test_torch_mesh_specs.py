"""The PyTorch package's mesh surfaces against the reference's:
``sharding.ShardingPolicy``'s specs (``param_spec``, ``batch_spec``,
``cache_spec``, ``weights_spec``, ``input_specs``),
``DistributedTrainer.state_spec`` / ``shard_state``, ``Server.specs`` /
``abstract_cache``, and the meshes of ``launch/mesh.py``.

Every arch of ``configs.ASSIGNED`` at its published size, under
``MeshConfig()`` and ``MeshConfig(multi_pod=True)``. Tier: exact. A port
spec is a tuple; it must equal ``tuple()`` of the reference's
``PartitionSpec`` at the same leaf path (``input_specs``: shapes and
dtypes). Templates cost nothing on either side: the reference's come from
``jax.eval_shape``, the port's from inits on the ``meta`` device. The
reference's meshes are read with its ``make_mesh`` replaced by a recorder,
as ``tests/test_sharded.py`` does, so no jax device state is touched.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import repro.launch.mesh as jmesh
from repro import configs as jconfigs
from repro.config import SHAPES as JSHAPES
from repro.config import MeshConfig as JMeshConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core.distributed import DistributedTrainer as JTrainer
from repro.core.distributed import Server as JServer
from repro.models import build as jbuild
from repro.sharding import ShardingPolicy as JPolicy
from repro.sharding import input_specs as j_input_specs
from repro_torch import configs
from repro_torch.config import SHAPES, MeshConfig, TrainConfig
from repro_torch.core.distributed import DistributedTrainer, Server
from repro_torch.launch import mesh as lm
from repro_torch.models import build
from repro_torch.sharding import (DeviceMesh, ShardingPolicy, _k,
                                  input_specs, mesh_device)
from repro_torch.utils.pytree import (tree_flatten_with_path, tree_leaves,
                                      tree_map)
from test_torch_threads import one_torch_thread  # noqa: F401

MULTI_POD = [False, True]
GRANULARITIES = ["pod", "chip", "data_rank"]
CACHES = [(32, 1024), (1, 4096)]          # (batch, max_len) of the caches


def _path(path_elems) -> str:
    return "/".join(_k(p) for p in path_elems)


def _jspecs(specs) -> dict:
    """The reference's spec tree as {leaf path: tuple(PartitionSpec)}."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_path(p): tuple(s) for p, s in flat}


def _specs(template, specs) -> dict:
    """The port's spec tree, read along ``template``'s structure."""
    flat, treedef = tree_flatten_with_path(template)
    return {_path(p): s for (p, _), s in zip(flat,
                                              treedef.flatten_up_to(specs))}


def _same_shapes(got, want):
    """Port meta tensors against the reference's ShapeDtypeStructs."""
    gl = tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [_path(p) for p, _ in gl] == [_path(p) for p, _ in wl]
    for (_, g), (_, w) in zip(gl, wl):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(np.dtype(w.dtype))


@functools.lru_cache(maxsize=None)
def _jtree(arch):
    return jax.eval_shape(jbuild(jconfigs.get_config(arch)).init,
                          jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _tree(arch):
    return build(configs.get_config(arch)).init(torch.Generator(), "meta")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", MULTI_POD)
@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_state_spec_equals_reference(arch, multi_pod):
    """``state_spec(abstract_state())`` leaf by leaf, adamw's state
    (``mu``, ``nu``, ``count``) included."""
    jt = JTrainer(jconfigs.get_config(arch), JTrainConfig(optimizer="adamw"),
                  JMeshConfig(multi_pod=multi_pod))
    tr = DistributedTrainer(configs.get_config(arch),
                            TrainConfig(optimizer="adamw"),
                            MeshConfig(multi_pod=multi_pod), device="cpu")
    jstate, state = jt.abstract_state(), tr.abstract_state()
    want = _jspecs(jt.state_spec(jstate))
    got = _specs(state, tr.state_spec(state))
    assert got == want
    assert any(k.startswith("opt_state/mu/") for k in got)
    for leaf, spec in zip(tree_leaves(state), [got[k] for k in got]):
        assert tr.policy.divides(spec, tuple(leaf.shape))


@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("multi_pod", MULTI_POD)
@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_server_specs_equal_reference(arch, multi_pod, shard_seq):
    """``Server.specs`` over the parameters and two caches
    (``abstract_cache``, on the ``meta`` device, shaped as the
    reference's)."""
    jserver = JServer(jconfigs.get_config(arch),
                      JMeshConfig(multi_pod=multi_pod), shard_seq=shard_seq)
    server = Server(configs.get_config(arch), MeshConfig(multi_pod=multi_pod),
                    shard_seq=shard_seq, device="cpu")
    for B, T in CACHES:
        jcache, cache = jserver.abstract_cache(B, T), server.abstract_cache(B, T)
        _same_shapes({k: v for k, v in cache.items() if k != "pos"},
                     {k: v for k, v in jcache.items() if k != "pos"})
        jp, jc = jserver.specs(_jtree(arch), jcache)
        p, c = server.specs(_tree(arch), cache)
        assert _specs(_tree(arch), p) == _jspecs(jp)
        assert _specs(cache, c) == _jspecs(jc)


@pytest.mark.parametrize("multi_pod", MULTI_POD)
@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_inputs_batches_and_weights_equal_reference(arch, multi_pod):
    """``input_specs`` over ``SHAPES`` (meta tensors of the reference's
    shapes and dtypes), ``batch_spec`` of them (train with participants;
    serve with ``shard_seq`` off and on) and ``weights_spec``."""
    jpol = JPolicy(jconfigs.get_config(arch), JMeshConfig(multi_pod=multi_pod))
    pol = ShardingPolicy(configs.get_config(arch),
                         MeshConfig(multi_pod=multi_pod))
    assert pol.weights_spec() == tuple(jpol.weights_spec())
    assert sorted(SHAPES) == sorted(JSHAPES)
    for name in SHAPES:
        want = j_input_specs(jpol.cfg, JSHAPES[name], jpol)
        got = input_specs(pol.cfg, SHAPES[name], pol)
        _same_shapes(got, want)
        train = SHAPES[name].kind == "train"
        for shard_seq in ([False] if train else [False, True]):
            jb = jpol.batch_spec(want, with_participants=train,
                                 shard_seq=shard_seq)
            assert _specs(got, pol.batch_spec(
                got, with_participants=train, shard_seq=shard_seq)) == \
                _jspecs(jb)


@pytest.mark.parametrize("gran", GRANULARITIES)
@pytest.mark.parametrize("multi_pod", MULTI_POD)
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_spec_granularities_equal_reference(arch, multi_pod, gran):
    """``param_spec`` with every participant granularity (as
    ``tests/test_sharding.py`` overrides it), on the serve-path tree and
    the train-path tree (a leading participant axis)."""
    jpol = JPolicy(jconfigs.get_config(arch).with_(
        participant_granularity=gran), JMeshConfig(multi_pod=multi_pod))
    pol = ShardingPolicy(configs.get_config(arch).with_(
        participant_granularity=gran), MeshConfig(multi_pod=multi_pod))
    assert (pol.n_participants, pol.part_axis, pol.fsdp_axis,
            pol.batch_axis) == (jpol.n_participants, jpol.part_axis,
                                jpol.fsdp_axis, jpol.batch_axis)
    Pn = pol.n_participants
    jP = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        (Pn,) + tuple(x.shape), x.dtype), _jtree(arch))
    tP = tree_map(lambda x: torch.empty((Pn,) + tuple(x.shape),
                                        dtype=x.dtype, device="meta"),
                  _tree(arch))
    for with_p, jt, t in [(False, _jtree(arch), _tree(arch)), (True, jP, tP)]:
        got = _specs(t, pol.param_spec(t, with_participants=with_p))
        assert got == _jspecs(jpol.param_spec(jt, with_participants=with_p))


@pytest.mark.parametrize("multi_pod", MULTI_POD)
def test_fix_divisibility_equals_reference_on_a_grid(multi_pod):
    rng = np.random.default_rng(0)
    axes_pool = [None, "data", "model", "pod", ("data", "model"),
                 ("pod", "data"), ("pod", "data", "model")]
    for gran in GRANULARITIES:
        cfg = configs.get_config("tinyllama-1.1b").with_(
            participant_granularity=gran)
        jpol = JPolicy(jconfigs.get_config("tinyllama-1.1b").with_(
            participant_granularity=gran), JMeshConfig(multi_pod=multi_pod))
        pol = ShardingPolicy(cfg, MeshConfig(multi_pod=multi_pod))
        for _ in range(300):
            ndim = int(rng.integers(0, 5))
            shape = tuple(int(rng.choice([1, 2, 7, 16, 32, 51866, 32001,
                                          4096, 100, 512]))
                          for _ in range(ndim))
            spec = tuple(axes_pool[int(rng.integers(len(axes_pool)))]
                         for _ in range(ndim))
            fixed = pol._fix_divisibility(spec, shape)
            assert fixed == jpol._fix_divisibility(spec, shape)
            assert pol.divides(fixed, shape)
            assert pol._axes_size(spec[0] if spec else None) == \
                jpol._axes_size(spec[0] if spec else None)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_meshes_equal_reference(monkeypatch):
    """The production meshes and ``make_mesh_from_config``: shapes and axes
    as the reference asks its ``make_mesh`` for them; every entry names the
    one device asked for (the CPU here, the card by default)."""
    calls = []
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes: calls.append(
        (tuple(shape), tuple(axes))))
    meshes = []
    for mp in MULTI_POD:
        jmesh.make_production_mesh(multi_pod=mp)
        meshes.append(lm.make_production_mesh(multi_pod=mp, device="cpu"))
        assert lm.mesh_config(multi_pod=mp) == MeshConfig(multi_pod=mp)
        assert jmesh.mesh_config(multi_pod=mp) == JMeshConfig(multi_pod=mp)
    for kw in (dict(), dict(multi_pod=True), dict(data=2, model=4),
               dict(multi_pod=True, pods=3, data=2, model=1)):
        jmesh.make_mesh_from_config(JMeshConfig(**kw))
        meshes.append(lm.make_mesh_from_config(MeshConfig(**kw), "cpu"))
    assert [(m.dims, m.axis_names) for m in meshes] == calls
    for m, (shape, axes) in zip(meshes, calls):
        assert m.shape == dict(zip(axes, shape))
        assert m.size == int(np.prod(shape))
        assert set(m.devices) == {torch.device("cpu")}
        assert mesh_device(m) == torch.device("cpu")
    assert meshes[0].size == 256 and meshes[1].size == 512
    assert meshes[1].shape["pod"] == 2 and meshes[0].shape["model"] == 16
    assert hash(meshes[0]) == hash(lm.make_production_mesh(device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lm.make_production_mesh()
    with pytest.raises(ValueError):
        DeviceMesh(("cpu",) * 3, ("data", "model"), (2, 2))
    with pytest.raises(NotImplementedError, match="A12b"):
        mesh_device(DeviceMesh(("cpu", "meta"), ("data", "model"), (1, 2)))


# ---------------------------------------------------------------------------
# a round after shard_state
# ---------------------------------------------------------------------------


SMALL = dict(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
             vocab=64)


def test_round_after_shard_state_equals_the_unsharded_round():
    """A trainer on a 2 x 2 mesh naming the CPU places its state by
    ``state_spec`` (``init_state`` calls ``shard_state``); its round equals
    the round of a trainer with no mesh, bit for bit. A mesh of distinct
    devices raises, naming A12b."""
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b")).with_(**SMALL)
    mcfg = MeshConfig(data=2, model=2)
    tcfg = TrainConfig(optimizer="momentum", lr=0.1)
    plain = DistributedTrainer(cfg, tcfg, mcfg, device="cpu")
    meshed = DistributedTrainer(cfg, tcfg, mcfg,
                                mesh=lm.make_mesh_from_config(mcfg, "cpu"))
    assert meshed.device == torch.device("cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 2, 2, 16)))
             for k in ("tokens", "labels")}
    weights = torch.tensor([1.0, 0.5])
    state = plain.init_state(3)
    sharded = meshed.shard_state(state)
    for a, b in zip(tree_leaves(meshed.init_state(3)), tree_leaves(state)):
        assert torch.equal(a, b)
    want, wm = plain.jit_train_step()(state, batch, weights)
    got, gm = meshed.jit_train_step()(sharded, batch, weights)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    assert torch.equal(gm["loss"], wm["loss"])
    with pytest.raises(NotImplementedError, match="A12b"):
        DistributedTrainer(cfg, tcfg, MeshConfig(data=2, model=1),
                           mesh=DeviceMesh(("cpu", "meta"), ("data", "model"),
                                           (2, 1)))
    with pytest.raises(ValueError, match="MeshConfig"):
        DistributedTrainer(cfg, tcfg, MeshConfig(data=4, model=1),
                           mesh=lm.make_mesh_from_config(mcfg, "cpu"))
