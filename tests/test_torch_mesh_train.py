"""The mesh form of a round in the PyTorch package against the reference's:
``core/strategy.py``, ``sharding.ShardingPolicy``'s participant rules,
``MeshConfig``, ``core.distributed.DistributedTrainer`` and
``launch/train.py --mode mesh``.

The reference's trainer runs on one CPU device (``mesh=None``) under
``jax.jit``; its state is carried across with ``params_from_numpy``.
Models are reduced configs at a small width (d_model 64, 2 query heads
and 1 KV head of 32, d_ff 128, vocab 64, 16 tokens; the MoE's experts ff
32), in fp32. Tiers: the participant rules and ``MeshConfig`` exact;
strategies ``rtol = atol = 1e-6`` in fp32 and one bf16 step (2^-8
relative) in bfloat16; trainer rounds (parameters, optimizer state,
metrics) ``rtol = atol = 1e-5``; the launcher's round lines exact up to
the loss and the seconds, the losses ``1e-5``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import MeshConfig as JMeshConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import strategy as jstrategy
from repro.core.distributed import DistributedTrainer as JTrainer
from repro.core.hashing import select_sample as j_select_sample
from repro.data import make_lm_task as j_make_lm_task
from repro.sharding import ShardingPolicy as JPolicy
from repro_torch import configs
from repro_torch.config import MeshConfig, TrainConfig
from repro_torch.core import strategy
from repro_torch.core.distributed import DistributedTrainer, TrainState
from repro_torch.engine.flat import params_from_numpy
from repro_torch.launch import train
from repro_torch.sharding import ShardingPolicy
from repro_torch.utils.pytree import (tree_flatten, tree_global_norm,
                                      tree_leaves)
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
             vocab=64)
EXTRA = {"qwen3-moe-30b-a3b": dict(moe_d_ff_expert=32)}
B, T = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_trees(got, want, **tol):
    gl, wl = tree_leaves(got), jax.tree.leaves(_np(want))
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# MeshConfig and the participant rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(multi_pod=True),
                                dict(data=2, model=2),
                                dict(multi_pod=True, pods=3, data=4, model=1)])
def test_mesh_config_equals_reference(kw):
    got, want = MeshConfig(**kw), JMeshConfig(**kw)
    for field in ("multi_pod", "data", "model", "pods", "shape", "axes",
                  "n_devices"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("arch,gran", [("tinyllama-1.1b", None),
                                       ("llama3-405b", None),
                                       ("tinyllama-1.1b", "chip")])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_participant_rules_equal_reference(arch, gran, multi_pod):
    """``data_rank`` (TinyLlama), ``pod`` (Llama-3 405B) and ``chip``
    granularity under ``MeshConfig()`` and ``MeshConfig(multi_pod=True)``:
    the counterpart of ``tests/test_sharding.py``'s participant counts."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    if gran:
        cfg = cfg.with_(participant_granularity=gran)
        jcfg = jcfg.with_(participant_granularity=gran)
    got = ShardingPolicy(cfg, MeshConfig(multi_pod=multi_pod))
    want = JPolicy(jcfg, JMeshConfig(multi_pod=multi_pod))
    for field in ("part_axis", "n_participants", "fsdp_axis", "batch_axis",
                  "_replicated"):
        assert getattr(got, field) == getattr(want, field), field
    for axis in (None, "data", "model", "pod", ("data", "model"),
                 ("pod", "data"), ("pod", "data", "model"), "other"):
        assert got._axes_size(axis) == want._axes_size(axis), axis
    if arch == "tinyllama-1.1b" and not gran:
        assert got.n_participants == (32 if multi_pod else 16)


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------


def _trees(P, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((P, 5, 3)).astype(dtype),
            "b": {"c": rng.standard_normal((P, 7)).astype(dtype)}}


def _both(tree):
    return (params_from_numpy(tree, "cpu"), _to_jax(tree))


WEIGHTS = np.array([1.0, 0.0, 2.0, 1.0], np.float32)


@pytest.mark.parametrize("name,tkw,hop", [
    ("modest", dict(), 1),
    ("modest", dict(agg_dtype="bfloat16"), 1),
    ("fedavg", dict(server_optimizer="yogi", server_lr=0.1), 1),
    ("dsgd", dict(), 1),
    ("dsgd", dict(), 2),
    ("local", dict(), 1),
])
def test_strategy_equals_reference(name, tkw, hop):
    """Two rounds of each mix on seeded stacked trees (P = 4, one slot at
    weight 0): the mixed trees and the server optimizer's state."""
    tcfg, jtcfg = TrainConfig(**tkw), JTrainConfig(**tkw)
    s, js = strategy.build_strategy(name, tcfg), jstrategy.build_strategy(
        name, jtcfg)
    assert s.name == js.name == name
    prev = _trees(4, 0)
    prev = jax.tree.map(lambda x: np.broadcast_to(x[:1], x.shape).copy(),
                        prev)                         # replicas equal
    tprev, jprev = _both(prev)
    state, jstate = s.init_state(tprev), js.init_state(jprev)
    _close_trees(state, jstate)
    w, jw = torch.from_numpy(WEIGHTS), jnp.asarray(WEIGHTS)
    bf16 = tkw.get("agg_dtype") == "bfloat16"
    tol = dict(rtol=2 ** -8, atol=2 ** -8) if bf16 else dict(rtol=1e-6,
                                                            atol=1e-6)
    for r in range(2):
        new = _trees(4, 1 + r)
        got, state = s.mix(tprev, params_from_numpy(new, "cpu"), w, state,
                           hop)
        want, jstate = js.mix(jprev, _to_jax(new), jw, jstate, hop)
        _close_trees(got, want, **tol)
        _close_trees(state, jstate, **tol)
        for leaf, jleaf in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert leaf.dtype == torch.float32 == getattr(
                torch, str(jleaf.dtype))
        tprev, jprev = got, want
    if name in ("modest", "fedavg"):
        for leaf in tree_leaves(got):
            assert torch.equal(leaf[0], leaf[3])      # every slot the mean


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _cfgs(arch):
    kw = dict(SMALL, **EXTRA.get(arch, {}))
    return (configs.reduced(configs.get_config(arch)).with_(**kw),
            jconfigs.reduced(jconfigs.get_config(arch)).with_(**kw))


def _batch(cfg, P, E, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (P, E, B, T)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (P, E, B, T)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = (rng.standard_normal((P, E, B, cfg.n_frames,
                                            cfg.d_model)) * 0.1
                       ).astype(np.float32)
    if cfg.family == "vlm":
        n_img = cfg.image_tokens * cfg.anyres_tiles
        b["image_embeds"] = (rng.standard_normal((P, E, B, n_img,
                                                  cfg.d_model)) * 0.1
                             ).astype(np.float32)
    return b


def _state_from(jstate):
    s = _np(jstate)
    return TrainState(params_from_numpy(s.params, "cpu"),
                      params_from_numpy(s.opt_state, "cpu"),
                      params_from_numpy(s.server_state, "cpu"),
                      torch.as_tensor(np.array(s.round)))


@pytest.mark.parametrize("arch,E,tkw,skw", [
    ("tinyllama-1.1b", 2, dict(), dict()),
    ("tinyllama-1.1b", 2, dict(), dict(accumulate=True)),
    ("tinyllama-1.1b", 2, dict(optimizer="momentum", momentum=0.9,
                               grad_clip=0.05),
     dict()),
    ("qwen3-moe-30b-a3b", 1, dict(), dict()),
    ("whisper-large-v3", 1, dict(), dict()),
    ("llava-next-mistral-7b", 1, dict(), dict()),
])
def test_trainer_rounds_equal_reference(arch, E, tkw, skw):
    """Two modest rounds at P = 2 (weights 1 and 0, then 1 and 1) from the
    reference's initial state: parameters, per-slot optimizer state and
    metrics. Whisper's batch carries ``frames``, LLaVA's
    ``image_embeds``. With ``grad_clip`` each slot clips to its own norm
    (the two slots' norms differ, and both are clipped)."""
    cfg, jcfg = _cfgs(arch)
    tkw = dict(dict(optimizer="sgd", lr=0.05), **tkw)
    mesh = dict(data=2, model=1)
    jtr = JTrainer(jcfg, JTrainConfig(**tkw), JMeshConfig(**mesh),
                   strategy="modest", mesh=None, donate=False)
    tr = DistributedTrainer(cfg, TrainConfig(**tkw), MeshConfig(**mesh),
                            strategy="modest", device="cpu")
    assert tr.policy.n_participants == jtr.policy.n_participants == 2
    jstate = jtr.init_state(0)
    state = _state_from(jstate)
    jstep = jax.jit(jtr.build_train_step(**skw))
    step = tr.jit_train_step(**skw)
    for r, weights in enumerate(([1.0, 0.0], [1.0, 1.0])):
        nb = _batch(cfg, 2, E, seed=10 + r)
        w = np.asarray(weights, np.float32)
        jstate, jm = jstep(jstate, _to_jax(nb), jnp.asarray(w))
        state, m = step(state, {k: torch.as_tensor(v) for k, v in nb.items()},
                        torch.from_numpy(w))
        assert int(state.round) == int(jstate.round) == r + 1
        _close_trees(state.params, jstate.params)
        _close_trees(state.opt_state, jstate.opt_state)
        assert sorted(m) == sorted(jm) == ["active", "loss"]
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
        assert float(m["active"]) == float(jm["active"]) == w.sum()
    if tkw.get("grad_clip"):
        loss_of = torch.func.vmap(lambda p, b: tr.model.loss_fn(p, b)[0])
        leaves, treedef = tree_flatten(state.params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        nb = {k: torch.as_tensor(v[:, 0]) for k, v in _batch(
            cfg, 2, E, seed=99).items()}
        grads = torch.autograd.grad(
            torch.sum(loss_of(treedef.unflatten(leaves), nb)), leaves)
        norms = [float(tree_global_norm([g[p] for g in grads]))
                 for p in range(2)]
        assert min(norms) > tkw["grad_clip"] and norms[0] != norms[1]


def test_abstract_state_is_on_meta_and_init_gives_real_copies():
    cfg, _ = _cfgs("tinyllama-1.1b")
    tr = DistributedTrainer(cfg, TrainConfig(optimizer="momentum", lr=0.1),
                            MeshConfig(data=3, model=1), device="cpu")
    abstract = tr.abstract_state()
    state = tr.init_state(0)
    assert isinstance(state, TrainState)
    for a, x in zip(tree_leaves(abstract), tree_leaves(state)):
        assert a.device.type == "meta" and a.shape == x.shape
        assert a.dtype == x.dtype
    for leaf in tree_leaves(state.params) + tree_leaves(state.opt_state):
        assert leaf.shape[0] == 3 and leaf.is_contiguous()
        assert leaf.stride(0) == leaf[0].numel()      # no expanded view
        assert torch.equal(leaf[0], leaf[2])
    with pytest.raises(NotImplementedError, match="A12"):
        DistributedTrainer(cfg, TrainConfig(), MeshConfig(data=2, model=1),
                           mesh=("cpu", "meta"))
    with pytest.raises(ValueError):
        DistributedTrainer(cfg, TrainConfig(), MeshConfig(data=2, model=1),
                           mesh=("cpu",) * 3)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


LINE = re.compile(r"\[train:mesh\] round=(\d+) sample=(\[.*\])\.\.\. "
                  r"active=(\d+)/(\d+) loss=(\d+\.\d{4}) \(\d+\.\d\ds\)$")


@pytest.mark.parametrize("algo,devices", [("modest", 4), ("dsgd", 8)])
def test_run_mesh_prints_the_reference_lines(algo, devices, capsys,
                                             monkeypatch):
    """``main([... "--mode", "mesh", "--device", "cpu", "--devices", "4",
    "--model-parallel", "2", "--rounds", "2"])`` on the reduced TinyLlama:
    P = 2, the reference's round lines (sample, active slots) and its
    losses within 1e-5 of the reference's loop at the same seed (the
    reference's ``run_mesh`` protocol on one CPU device, its state
    carried across). After modest rounds every slot holds the mean. D-SGD
    runs on 8 devices (P = 4): at P = 2 its pairwise average is the full
    mean, and at P = 4 the slots differ."""
    args = ["--mode", "mesh", "--algo", algo, "--devices", str(devices),
            "--model-parallel", "2", "--rounds", "2", "--nodes", "6",
            "--batch-size", "4", "--seq-len", "16", "--local-steps", "2",
            "--failure-rate", "0.4", "--seed", "1"]
    jcfg = jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b"))
    jtr = JTrainer(jcfg, JTrainConfig(optimizer="sgd", lr=0.05,
                                      batch_size=4, seed=1),
                   JMeshConfig(multi_pod=False, data=devices // 2, model=2),
                   strategy=algo, mesh=None, donate=False)
    P = jtr.policy.n_participants
    assert P == devices // 2
    jstate = jtr.init_state(1)
    monkeypatch.setattr(DistributedTrainer, "init_state",
                        lambda self, seed=0: _state_from(jstate))
    out = train.main(args + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "[train:mesh] done" and len(lines) == 3

    population = [f"client-{i}" for i in range(6)]
    data = j_make_lm_task(6, seq_len=17, vocab=jcfg.vocab, seed=1)
    rng = np.random.default_rng(1)
    step = jax.jit(jtr.build_train_step())
    for r, line in enumerate(lines[:-1], start=1):
        ids = j_select_sample(population, r, P)
        idxs = [population.index(s) for s in ids]
        xs, ys = zip(*[data.pack_sample(idxs, 4, seed=r * 31 + e)
                       for e in range(2)])
        batch = {"tokens": jnp.asarray(np.stack([x[:, :, :16] for x in xs],
                                                axis=1)),
                 "labels": jnp.asarray(np.stack([y[:, :, :16] for y in ys],
                                                axis=1))}
        weights = (rng.random(P) >= 0.4).astype(np.float32)
        if weights.sum() == 0:
            weights[0] = 1.0
        jstate, metrics = step(jstate, batch, jnp.asarray(weights))
        m = LINE.match(line)
        assert m, line
        assert (int(m[1]), m[2], int(m[3]), int(m[4])) == (
            r, str(ids[:4]), int(weights.sum()), P)
        np.testing.assert_allclose(out["history"][r - 1]["loss"],
                                   float(metrics["loss"]), **TOL)
        assert m[5] == f"{out['history'][r - 1]['loss']:.4f}"
    _close_trees(out["state"].params, jstate.params)
    leaves = tree_leaves(out["state"].params)
    same = all(torch.equal(l[0], l[p]) for l in leaves for p in range(P))
    assert same == (algo == "modest")
