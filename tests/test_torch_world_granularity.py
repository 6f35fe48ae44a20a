"""Every participant granularity across ranks, a mesh with a ``pod`` axis
and the gradient clip, in gloo worlds of 2 and 4 ranks.

* ``pod`` granularity, FSDP over ``data``: the reduced llama3-405b on a
  2 x 2 world (P = 1, every leaf split over ``data`` and ``model``) and on
  a ``pods=2, data=2, model=1`` world (P = 2 over ``pod``), each with a
  gradient clip that binds, and the reduced arctic-480b on 2 x 2 (its
  experts and router gathered over ``data``, its routing groups whole on
  each rank): three MoDeST rounds, then serving (a prefill and one
  decode).
* ``chip`` granularity (P = 4, whole replicas, no collective in the
  layers) and ``data_rank`` on a ``pod`` mesh (P = 4 over
  ``("pod", "data")``), with the reduced TinyLlama.
* Every leaf's gradient on 2 x 1 and 2 x 2 FSDP worlds, ``cfg.remat`` off
  and on; the collectives of one ``local`` step beside the count reckoned
  by hand; two controls that must be caught (a step without its
  ``1 / data``, and a clip whose norm is a rank's own shards'); the
  leaf-by-leaf draw bit for bit the whole draw's slices; the launchers.

The reference runs the same rounds and serving on 4 forced host devices
in one subprocess, from ``jax.random.key(0)``'s weights; the port's runs
start from those weights (``params_from_numpy``). Tolerances:
``rtol = atol = 1e-5`` against the port's one process and against the
reference.
"""

import glob
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_world_bodies as bodies
from repro_torch import configs
from repro_torch.config import MeshConfig, TrainConfig
from repro_torch.core.distributed import DistributedTrainer, Server, \
    draw_local
from repro_torch.engine.flat import params_from_numpy, params_to_numpy
from repro_torch.engine.lowering import stacked_value_and_grad
from repro_torch.launch.world import run_world
from repro_torch.models import build
from repro_torch.sharding import DeviceMesh, ShardingPolicy, local_shard
from repro_torch.utils.pytree import tree_flatten, tree_leaves, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, PROMPT, MAX_LEN = 4, 32, 16, 24
CLIP = 0.5
WORLD = dict(device="cpu", threads=1, quiet=True, timeout=170.0)
MESH = dict(data=2, model=2)
PODS = dict(multi_pod=True, pods=2, data=2, model=1)
# name: (arch, granularity, mesh, P, clip)
CASES = {"llama-fsdp": ("llama3-405b", "pod", MESH, 1, CLIP),
         "llama-pods": ("llama3-405b", "pod", PODS, 2, CLIP),
         "arctic-fsdp": ("arctic-480b", "pod", MESH, 1, 0.0),
         "tiny-chip": ("tinyllama-1.1b", "chip", MESH, 4, 0.0),
         "tiny-pods": ("tinyllama-1.1b", "data_rank", PODS, 4, 0.0)}
WEIGHTS = {1: [[1.0]] * 3, 2: [[1.0, 1.0], [1.0, 0.0], [1.0, 1.0]],
           4: [[1.0] * 4, [1.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 1.0]]}

REFERENCE = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro import configs
from repro.config import MeshConfig, TrainConfig
from repro.core.distributed import DistributedTrainer, Server
from repro.utils.compat import make_mesh, set_mesh
assert jax.device_count() == 4

out = {}
for name, (arch, gran, mesh_kw, P, clip) in %(CASES)r.items():
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              participant_granularity=gran)
    mesh_cfg = MeshConfig(**mesh_kw)
    mesh = make_mesh(mesh_cfg.shape, mesh_cfg.axes)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(P, 1, %(B)d, %(S)d)).astype(np.int32)
    rec = {"batch": {"tokens": toks, "labels": toks}}
    trainer = DistributedTrainer(
        cfg, TrainConfig(optimizer="sgd", lr=0.1, grad_clip=clip), mesh_cfg,
        strategy="modest", mesh=mesh, donate=False)
    with set_mesh(mesh):
        state = trainer.init_state(0)
        rec["init"] = jax.tree.map(lambda x: np.asarray(x[0]), state.params)
        tmpl = {k: jax.ShapeDtypeStruct(toks.shape, jnp.int32)
                for k in ("tokens", "labels")}
        step = trainer.jit_train_step(batch_template=tmpl)
        losses, rounds = [], []
        for w in %(WEIGHTS)r[P]:
            state, m = step(state, rec["batch"], np.asarray(w, np.float32))
            losses.append(float(m["loss"]))
            rounds.append(jax.tree.map(np.asarray, state.params))
        rec["losses"], rec["rounds"] = losses, rounds
    server = Server(cfg, mesh_cfg, mesh=mesh)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(4, %(PROMPT)d)).astype(np.int32)
    with set_mesh(mesh):
        params = server.shard_params(jax.tree.map(jnp.asarray, rec["init"]))
        cache = server.shard_cache(server.model.init_cache(4, %(MAX_LEN)d))
        prefill = server.jit_prefill(
            jax.eval_shape(lambda: params),
            {"tokens": jax.ShapeDtypeStruct(prompt.shape, jnp.int32)},
            jax.eval_shape(lambda: cache))
        logits, cache = prefill(params, {"tokens": prompt}, cache)
        decode = server.jit_decode(jax.eval_shape(lambda: params),
                                   jax.eval_shape(lambda: cache))
        tok = np.asarray(jnp.argmax(logits[:, -1:], -1), np.int32)
        dlogits, cache = decode(params, tok, cache)
    rec["serve"] = {"prompt": prompt, "prefill": np.asarray(logits),
                    "tok": np.asarray(tok), "decode": np.asarray(dlogits)}
    out[name] = rec
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % dict(CASES=CASES, WEIGHTS=WEIGHTS, B=B, S=S, PROMPT=PROMPT,
           MAX_LEN=MAX_LEN)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                           path], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def worlds(reference):
    """Every case in one 4-rank world (each case's mesh made there)."""
    cases = {name: (arch, gran, mesh_kw, reference[name]["init"],
                    reference[name]["batch"], WEIGHTS[P], clip,
                    reference[name]["serve"]["prompt"], MAX_LEN,
                    name == "llama-fsdp")
             for name, (arch, gran, mesh_kw, P, clip) in CASES.items()}
    ranks = run_world(bodies.granularity_worlds_body, 4, args=(cases,),
                      **WORLD)
    return {name: [r[name] for r in ranks] for name in CASES}


def _cfg(name, **overrides):
    arch, gran = CASES[name][:2]
    return configs.reduced(configs.get_config(arch)).with_(
        participant_granularity=gran, **overrides)


def _one_process(name, init, batch_np, clip, n=None):
    """The port's one-process trainer on the case's mesh config (P stacked
    on one device): each round's loss and parameters."""
    arch, gran, mesh_kw, P, _ = CASES[name]
    tr = DistributedTrainer(_cfg(name), TrainConfig(optimizer="sgd", lr=0.1,
                                                    grad_clip=clip),
                            MeshConfig(**mesh_kw), strategy="modest",
                            device="cpu")
    state = bodies.whole_state(tr, params_from_numpy(init, "cpu"))
    step = tr.jit_train_step()
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    losses, rounds = [], []
    for w in WEIGHTS[P][:n]:
        state, m = step(state, batch, torch.tensor(w))
        losses.append(float(m["loss"]))
        rounds.append(state.params)
    return losses, rounds


@pytest.mark.parametrize("name", list(CASES))
def test_world_rounds_equal_one_process_and_reference(reference, worlds,
                                                      name):
    """Each round's loss and parameters (every leaf, gathered) against the
    port's one process and the reference, every rank alike; a rank holds
    its ``(P / participant axes)`` replicas of its slices (at ``pod``
    granularity a quarter of each leaf split over ``data`` and
    ``model``)."""
    ref = reference[name]
    clip = CASES[name][4]
    losses, rounds = _one_process(name, ref["init"], ref["batch"], clip)
    got = worlds[name][0]
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    for g_round, w_round, j_round in zip(got["rounds"], rounds,
                                         ref["rounds"]):
        for g, w, j in zip(tree_leaves(g_round), tree_leaves(w_round),
                           tree_leaves(j_round)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
            np.testing.assert_allclose(g.numpy(), j, **TOL)
    assert all(r["losses"] == got["losses"] for r in worlds[name])
    assert losses[-1] < losses[0]
    # every case's P fills its participant axes: one replica a rank
    mesh_kw = CASES[name][2]
    embed = got["local"][tree_leaves_index(ref["init"], "embed")]
    vocab, d = ref["init"]["embed"].shape
    if CASES[name][1] == "pod":
        assert embed == (1, vocab // mesh_kw["model"], d // mesh_kw["data"])
    else:
        assert embed == (1, vocab // (mesh_kw["model"] if CASES[name][1] ==
                                      "data_rank" else 1), d)


def tree_leaves_index(tree, key):
    """The index of the top-level ``key`` among ``tree``'s leaves."""
    return [k for k, _ in _paths(tree)].index(key)


def _paths(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _paths(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


@pytest.mark.parametrize("name", list(CASES))
def test_world_serve_equals_one_process_and_reference(reference, worlds,
                                                      name):
    """Prefill and decode logits on every rank against one process's and
    the reference's, the greedy token alike; a ``pod``-granularity server
    holds each rank's FSDP slices and gathers them where they are read,
    a ``chip`` one whole weights."""
    ref = reference[name]
    server = Server(_cfg(name), device="cpu")
    params = params_from_numpy(ref["init"], "cpu")
    cache = server.model.init_cache(4, MAX_LEN, "cpu")
    prompt = {"tokens": torch.as_tensor(ref["serve"]["prompt"])}
    logits, cache = server.prefill(params, prompt, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    dlogits, _ = server.decode(params, tok, cache)
    for r in worlds[name]:
        assert torch.equal(r["tok"], tok) and r["pos"] == PROMPT + 1
        for key, one, want in (("prefill", logits, ref["serve"]["prefill"]),
                               ("decode", dlogits, ref["serve"]["decode"])):
            np.testing.assert_allclose(r[key].numpy(), one.numpy(), **TOL)
            np.testing.assert_allclose(r[key].numpy(), want, **TOL)
        fsdp = CASES[name][1] == "pod" and CASES[name][2]["data"] > 1
        assert (r["serve_counts"]["all_gather"] > 2) == fsdp
        assert r["serve_counts"]["reduce_scatter"] == 0
        if CASES[name][1] == "chip":
            assert r["served"] == [tuple(x.shape) for x in
                                   tree_leaves(params)]


@pytest.mark.parametrize("name", ["tiny-chip", "tiny-pods"])
def test_world_mix_is_the_one_process_mix(worlds, name):
    """A world's mix over the participant axes (a tuple: ``("data",
    "model")`` at ``chip`` granularity, ``("pod", "data")`` on a pod mesh)
    is bit for bit the one-process mix of the same replicas: the first
    round's mixed parameters (gathered) equal the strategy's mix, in this
    process, of the whole P axis the world's mix was given."""
    from repro_torch.core.strategy import build_strategy

    P = CASES[name][3]
    got = worlds[name][0]
    mix = build_strategy("modest", TrainConfig(optimizer="sgd", lr=0.1)).mix
    want, _ = mix(got["mixed_in"], got["mixed_in"],
                  torch.tensor(WEIGHTS[P][0]), (), 1)
    assert tree_leaves(got["mixed_in"])[0].shape[0] == P
    for g, w in zip(tree_leaves(got["rounds"][0]), tree_leaves(want)):
        assert torch.equal(g, w)


def test_world_clip_binds_and_its_controls_are_caught(reference, worlds):
    """The llama3-405b 2 x 2 world's clip binds (its first gradient's norm
    past CLIP, read in one process), and both controls move a round's
    update far outside the tolerance: without the step's ``1 / data`` the
    update doubles, and with the clip's norm of a rank's own shards it
    grows (measured 0.8-1.0 relative L2 for both; held above 0.1)."""
    name = "llama-fsdp"
    ref = reference[name]
    tr = DistributedTrainer(_cfg(name), TrainConfig(), MeshConfig(**MESH),
                            device="cpu")
    state = bodies.whole_state(tr, params_from_numpy(ref["init"], "cpu"))
    batch = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    _, grads = tr.grads(state, batch)
    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                for g in tree_leaves(grads))))
    assert norm > 2 * CLIP
    init = params_from_numpy(ref["init"], "cpu")
    got = worlds[name][0]

    def update_gap(params, clip):
        _, rounds = _one_process(name, ref["init"], ref["batch"], clip, 1)
        num = den = 0.0
        for g, w, x in zip(tree_leaves(params), tree_leaves(rounds[0]),
                           tree_leaves(init)):
            num += float(torch.sum((g[0] - w[0]) ** 2))
            den += float(torch.sum((w[0] - x) ** 2))
        return (num / den) ** 0.5

    assert update_gap(got["rounds"][0], CLIP) < 1e-4
    assert update_gap(got["no_data_mean"], 0.0) > 0.1
    assert update_gap(got["local_clip"], CLIP) > 0.1


def _grad_case(arch, mesh_kw, seed=3):
    cfg = configs.reduced(configs.get_config(arch))
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(1, 1, B, S)).astype(np.int64)
    batch = {"tokens": toks, "labels": toks}
    ranks = run_world(bodies.granularity_grad_body,
                      MeshConfig(**mesh_kw).n_devices,
                      args=(arch, mesh_kw, params_to_numpy(params), batch),
                      **WORLD)
    whole = stacked_value_and_grad(build(cfg).loss_fn)(
        tree_map(lambda x: x[None], params),
        {k: torch.as_tensor(v)[:, 0] for k, v in batch.items()})
    return ranks, whole


# gathers (forward; remat: again in the backward) and reduce-scatters of a
# 2 x 2 FSDP step of the reduced llama3-405b (2 layers): each layer's
# seven matrices (wq, wk, wv, wo, wg, wu, wd; its norms whole on data),
# the embedding and the head; all-reduces: tensor parallelism's 13 (the
# dense family's 1 x 2 count: the embedding, wo and wd, the loss's three,
# the inputs' f and h's), the gradients of the three norm leaves (ln1 and
# ln2, stacked by layer, and final_norm) summed over data, and the loss's
# mean over data
STEP_GATHERS = 2 * 7 + 2
STEP_ALL_REDUCES = 13 + 3 + 1


@pytest.mark.parametrize("mesh_kw", [dict(data=2, model=1), MESH],
                         ids=["2x1", "2x2"])
def test_world_fsdp_gradients_equal_one_process(mesh_kw):
    """Every leaf's gradient (gathered by the state's specs) and the loss
    of one FSDP step, with ``cfg.remat`` off and on, against one
    process's; remat gathers each layer's matrices again for the backward
    and changes no value; the collectives of one ``local`` step as
    reckoned by hand (STEP_GATHERS, STEP_ALL_REDUCES)."""
    ranks, (loss, grads) = _grad_case("llama3-405b", mesh_kw)
    tp = mesh_kw["model"] > 1
    for r in ranks:
        for remat in (False, True):
            got = r[remat]
            np.testing.assert_allclose(float(got["loss"][0]),
                                       float(loss[0]), **TOL)
            counts = got["counts"]
            assert counts["all_gather"] == STEP_GATHERS + (
                2 * 7 if remat else 0)
            assert counts["reduce_scatter"] == STEP_GATHERS
    for remat in (False, True):
        for g, w in zip(tree_leaves(ranks[0][remat]["grads"]),
                        tree_leaves(grads)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    step = ranks[0]["step_counts"]
    assert step["all_gather"] == STEP_GATHERS
    assert step["reduce_scatter"] == STEP_GATHERS
    assert step["all_reduce"] == (STEP_ALL_REDUCES if tp
                                  else STEP_ALL_REDUCES - 13)


@pytest.mark.parametrize("arch,gran", [
    ("llama3-405b", "pod"), ("arctic-480b", "pod"),
    ("tinyllama-1.1b", "chip"), ("rwkv6-1.6b", "data_rank"),
    ("hymba-1.5b", "data_rank"), ("whisper-large-v3", "pod")])
def test_leaf_by_leaf_draw_equals_the_whole_draws_slices(arch, gran):
    """``draw_local`` (each weight sliced as it is drawn, a stack of blocks
    stacking the slices) gives every rank of a 2 x 2 mesh its slices of
    the whole draw bit for bit, under the world's rules (Hymba's
    ``in_proj`` halves included)."""
    cfg = configs.reduced(configs.get_config(arch)).with_(
        participant_granularity=gran)
    model = build(cfg)
    whole = model.init(torch.Generator().manual_seed(5), "cpu")
    policy = ShardingPolicy(cfg, MeshConfig(**MESH))

    def spec_of(t):
        return policy.param_spec(t, with_participants=False, world=True)

    for rank in range(4):
        mesh = DeviceMesh(("cpu",) * 4, ("data", "model"), (2, 2), rank=rank)
        got = draw_local(model, spec_of, mesh, 5, "cpu")
        want = local_shard(whole, spec_of(whole), mesh)
        assert tree_flatten(got)[1] == tree_flatten(want)[1]
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert any(g.numel() * 4 == w.numel() for g, w in zip(
        tree_leaves(got), tree_leaves(whole))) == (gran == "pod")


def test_launchers_run_pod_granularity_worlds():
    """``train.py --mode mesh --arch llama3-405b --set
    participant_granularity=pod --world`` (FSDP over 2 x 2) gives one
    process's losses and change sketch; ``serve.py --world`` of the
    reduced TinyLlama at ``pod`` granularity on 2 x 1 (which stopped in
    its first norm with a shape error before the world gathered its
    leaves) gives one process's tokens and logits."""
    from repro_torch.launch import serve, train

    argv = ["--mode", "mesh", "--arch", "llama3-405b", "--set",
            "participant_granularity=pod", "--devices", "4", "--rounds",
            "2", "--device", "cpu"]
    one = train.main(argv)
    got = train.main(argv + ["--world"])
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in one["history"]], **TOL)
    for r in got["ranks"]:
        np.testing.assert_allclose(r["change_sketch"],
                                   one["change_sketch"].numpy(), rtol=1e-4,
                                   atol=1e-6)
        assert r["change_sketch"] == got["ranks"][0]["change_sketch"]
    argv = ["--devices", "2", "--model-parallel", "1", "--set",
            "participant_granularity=pod", "--new-tokens", "3", "--device",
            "cpu"]
    one = serve.main(argv)
    got = serve.main(argv + ["--world"], teacher=one["tokens"][:, :2])
    assert np.array_equal(got["tokens"], one["tokens"])
    served = serve.main(argv, teacher=one["tokens"][:, :2])
    for g, w in zip(got["step_logits"], served["step_logits"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_reduce_scatter_and_the_fsdp_gather():
    """``collectives.reduce_scatter`` keeps a rank's piece of the group's
    sum along the dimension, in the tensor's dtype (sent as it is, summed
    in fp32), plain and staged through the host (counted: the tensor out
    and the piece back, through files in shared memory that grow for a
    larger tensor and are removed when the ranks leave); FSDP's gather
    (``gather_shards``) puts the ranks' pieces together forward and
    reduce-scatters the gradient backward."""
    ranks = run_world(bodies.reduce_scatter_body, 2, **WORLD)
    whole = sum((torch.arange(8.0).reshape(2, 4) + 10 * r) for r in (0, 1))
    grad = torch.arange(8.0).reshape(4, 2) * (1 + 2)
    for r, out in enumerate(ranks):
        want = whole[:, 2 * r:2 * r + 2]
        for key in ("plain", "staged"):
            assert out[key].dtype == torch.bfloat16
            assert torch.equal(out[key].float(), want)
        assert out["counts"]["reduce_scatter"] == 1
        assert out["counts"]["reduce_scatter_bytes"] == 8 * 2
        # the reduce-scatter's tensor out and piece back, the gather's
        # piece out and the group's pieces back
        assert out["counts"]["staged_bytes"] == (8 * 2 + 4 * 2) + 16 * 3
        assert torch.equal(out["gathered_last"], torch.cat(
            [(torch.arange(8.0).reshape(2, 4) + 10 * q).to(torch.bfloat16)
             for q in (0, 1)], dim=-1))
        # a larger tensor after the exchange's files grew
        big = torch.cat([whole, whole + 200], dim=1)
        assert torch.equal(out["grown"][0].float(), big[:, 4 * r:4 * r + 4])
        assert torch.equal(out["grown"][1], torch.cat(
            [torch.cat([b, b + 100], dim=1) for b in (
                (torch.arange(8.0).reshape(2, 4) + 10 * q).to(torch.bfloat16)
                for q in (0, 1))], dim=-1))
        assert out["grown"][2] == 2
        assert torch.equal(out["gathered"], torch.cat(
            [torch.arange(4.0).reshape(2, 2) + q for q in (0, 1)]))
        assert torch.equal(out["grad"], grad[2 * r:2 * r + 2])
    # every rank removed its exchange files as it left
    assert not glob.glob(ranks[0]["shm_prefix"] + "_*")
