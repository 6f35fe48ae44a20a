"""The MoE across ranks: qwen3-moe with its experts split over ``model``
(expert parallelism by the reference's specs, ``moe/w[gud]``), in gloo
worlds of 2 and 4 ranks.

* A 2 x 2 world: three MoDeST rounds of the reduced qwen3-moe (P = 2 over
  ``data``, two experts a rank), then serving from the same weights (a
  4 x 16 prompt and one decode).
* 1 x 2 worlds: every leaf's gradient of the reduced qwen3-moe and of
  arctic-480b (whose dense residual splits as a dense MLP), the router's
  included, gathered by its spec; and the control with Megatron's *f*
  left off ``combine``, which must fail the router's gradient.

The reference runs the same round and serving on 4 forced host devices
(a 2 x 2 mesh) in one subprocess, from ``jax.random.key(0)``'s weights;
the port's runs start from those weights (``params_from_numpy``).
Tolerances: ``rtol = atol = 1e-5`` against the port's one process and
against the reference.
"""

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
from repro_torch.core.distributed import DistributedTrainer, Server
from repro_torch.engine.flat import params_from_numpy
from repro_torch.engine.lowering import stacked_value_and_grad
from repro_torch.launch.world import run_world
from repro_torch.models import build
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen3-moe-30b-a3b"
WEIGHTS = [[1.0, 1.0], [1.0, 0.0], [1.0, 1.0]]
B, S, PROMPT, MAX_LEN = 2, 32, 16, 24
WORLD = dict(device="cpu", threads=1, quiet=True, timeout=170.0)

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro import configs
from repro.config import MeshConfig, TrainConfig
from repro.core.distributed import DistributedTrainer, Server
from repro.utils.compat import make_mesh, set_mesh
assert jax.device_count() == 4
mesh = make_mesh((2, 2), ("data", "model"))
mesh_cfg = MeshConfig(data=2, model=2)
cfg = configs.reduced(configs.get_config(%(ARCH)r))
toks = np.random.default_rng(1).integers(
    0, cfg.vocab, size=(2, 1, %(B)d, %(S)d)).astype(np.int32)
out = {"toks": toks}
trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd", lr=0.1),
                             mesh_cfg, strategy="modest", mesh=mesh,
                             donate=False)
with set_mesh(mesh):
    state = trainer.init_state(0)
    out["init"] = jax.tree.map(lambda x: np.asarray(x[0]), state.params)
    tmpl = {k: jax.ShapeDtypeStruct(toks.shape, jnp.int32)
            for k in ("tokens", "labels")}
    step = trainer.jit_train_step(batch_template=tmpl)
    losses = []
    for w in %(WEIGHTS)r:
        state, m = step(state, {"tokens": toks, "labels": toks},
                        np.asarray(w, np.float32))
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["final"] = jax.tree.map(np.asarray, state.params)
server = Server(cfg, mesh_cfg, mesh=mesh)
with set_mesh(mesh):
    params = server.shard_params(jax.tree.map(jnp.asarray, out["init"]))
    cache = server.shard_cache(server.model.init_cache(4, %(MAX_LEN)d))
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(4, %(PROMPT)d)).astype(np.int32)
    prefill = server.jit_prefill(
        jax.eval_shape(lambda: params),
        {"tokens": jax.ShapeDtypeStruct(tokens.shape, tokens.dtype)},
        jax.eval_shape(lambda: cache))
    logits, cache = prefill(params, {"tokens": tokens}, cache)
    decode = server.jit_decode(jax.eval_shape(lambda: params),
                               jax.eval_shape(lambda: cache))
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    dlogits, cache = decode(params, tok, cache)
out["serve"] = {"tokens": tokens, "prefill": np.asarray(logits),
                "tok": np.asarray(tok), "decode": np.asarray(dlogits)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % dict(ARCH=ARCH, B=B, S=S, WEIGHTS=WEIGHTS, PROMPT=PROMPT,
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


def _cfg(arch=ARCH):
    return configs.reduced(configs.get_config(arch))


@pytest.fixture(scope="module")
def world(reference):
    ref = reference["serve"]
    return run_world(bodies.moe_world_body, 4,
                     args=(reference["init"], reference["toks"], WEIGHTS,
                           reference["init"], ref["tokens"], MAX_LEN),
                     **WORLD)


def test_moe_world_round_equals_one_process_and_reference(reference, world):
    """Each round's loss and the final parameters (every expert, the
    router and the attention, gathered) against the port's one-process
    trainer (P = 2 stacked) and the reference; each rank held two of the
    four experts of its one participant."""
    tr = DistributedTrainer(_cfg(), TrainConfig(optimizer="sgd", lr=0.1),
                            bodies.MOE_MESH, strategy="modest",
                            device="cpu")
    state = bodies.whole_state(tr, params_from_numpy(reference["init"],
                                                     "cpu"))
    step = tr.jit_train_step()
    toks = torch.as_tensor(reference["toks"])
    losses = []
    for w in WEIGHTS:
        state, m = step(state, {"tokens": toks, "labels": toks},
                        torch.tensor(w))
        losses.append(float(m["loss"]))
    got = world[0]
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    np.testing.assert_allclose(got["losses"], reference["losses"], **TOL)
    for g, w, j in zip(tree_leaves(got["final"]), tree_leaves(state.params),
                       tree_leaves(reference["final"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), j, **TOL)
    assert all(r["losses"] == got["losses"] for r in world)
    assert all(r["experts"] == (1, 2, 2, 256, 128) for r in world)
    assert losses[-1] < losses[0]


def test_moe_world_serve_equals_one_process_and_reference(reference, world):
    """Prefill and decode logits on every rank against one process's and
    the reference's; the greedy token alike; each rank served two experts
    and its kv heads, and issued only all-reduces and the logits' gathers
    (no routing collective: the router runs replicated)."""
    ref = reference["serve"]
    server = Server(_cfg(), MeshConfig(data=1, model=1), device="cpu")
    params = params_from_numpy(reference["init"], "cpu")
    cache = server.model.init_cache(4, MAX_LEN, "cpu")
    logits, cache = server.prefill(params, {"tokens": torch.as_tensor(
        ref["tokens"])}, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    dlogits, _ = server.decode(params, tok, cache)
    for r in world:
        assert torch.equal(r["tok"], tok) and r["pos"] == PROMPT + 1
        for key, one, want in (("prefill", logits, ref["prefill"]),
                               ("decode", dlogits, ref["decode"])):
            np.testing.assert_allclose(r[key].numpy(), one.numpy(), **TOL)
            np.testing.assert_allclose(r[key].numpy(), want, **TOL)
        assert np.array_equal(r["tok"].numpy(), ref["tok"])
        assert r["served_experts"] == (2, 2, 256, 128)
        assert r["cache"] == (2, 2, MAX_LEN, 2, 32)
        # per layer: wo and the combine forward; the embedding; the
        # logits gathered over model (vocab) and then data, twice
        counts = r["serve_counts"]
        assert counts["all_reduce"] == 2 * (2 * 2 + 1)
        assert counts["all_gather"] == 2 * 2


@pytest.mark.parametrize("arch,split,calls,nbytes",
                         [(ARCH, 9, 15, 676_608),
                          ("arctic-480b", 12, 19, 938_752)])
def test_moe_gradients_equal_one_process(arch, split, calls, nbytes):
    """Every leaf's gradient on a 1 x 2 world, gathered by its spec, the
    router's included (Megatron's *f* on ``xg`` and ``combine``), against
    one process's; and the loss. ``split`` leaves are the rank's slices
    (embedding, head, q/k/v/o, the experts' g/u/d; arctic's dense g/u/d).
    The all-reduces a rank issues for the step (``collectives.COUNTS``):
    per layer the attention's and the combine's *g* forward, *f* on the
    attention's input, on ``xg`` and on ``combine`` backward (arctic's
    dense residual adds its own pair); the embedding, the loss's max, sum
    and target logit, and *f* on ``h``. The dry run reckons XLA's plan for
    the same step instead: 23 all-reduces and 5 all-gathers
    (``tests/test_torch_dryrun.py``; ROADMAP C14)."""
    cfg = _cfg(arch)
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    ranks = run_world(bodies.moe_grad_body, 2,
                      args=(arch, _numpy(params), toks), **WORLD)
    t = torch.as_tensor(toks)[None]
    loss, grads = stacked_value_and_grad(build(cfg).loss_fn)(
        tree_map(lambda x: x[None], params), {"tokens": t, "labels": t})
    for r in ranks:
        assert r["split"] == split
        assert r["counts"]["all_reduce"] == calls
        assert r["counts"]["all_reduce_bytes"] == nbytes
        assert r["counts"]["all_gather"] == 0
        np.testing.assert_allclose(float(r["loss"]), float(loss[0]), **TOL)
        for g, w in zip(tree_leaves(r["grads"]), tree_leaves(grads)):
            np.testing.assert_allclose(g.numpy(), w[0].numpy(), **TOL)
        router = r["grads"]["layers"]["moe"]["router"]
        assert float(router.abs().max()) > 1e-4


def test_moe_gradients_without_f_on_combine_are_caught():
    """The control: with *f* left off ``combine``, each rank's gates see
    only its experts' gradient, so the router's gradient (gathered from
    rank 0) moves far outside TOL (0.72 relative L2 measured, held above
    0.1) while the loss is unchanged."""
    cfg = _cfg()
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    ranks = run_world(bodies.moe_grad_body, 2,
                      args=(ARCH, _numpy(params), toks, True), **WORLD)
    t = torch.as_tensor(toks)[None]
    loss, grads = stacked_value_and_grad(build(cfg).loss_fn)(
        tree_map(lambda x: x[None], params), {"tokens": t, "labels": t})
    np.testing.assert_allclose(float(ranks[0]["loss"]), float(loss[0]),
                               **TOL)
    got = ranks[0]["grads"]["layers"]["moe"]["router"].numpy()
    want = grads["layers"]["moe"]["router"][0].numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) > 0.1


def _numpy(params):
    from repro_torch.engine.flat import params_to_numpy
    return params_to_numpy(params)


def test_moe_launchers_run_a_world(capfd):
    """``launch/train.py --mode mesh --world`` and ``launch/serve.py
    --world`` take qwen3-moe: the 2 x 2 world's round losses within 1e-5
    of one process's and its change sketch alike on every rank; its
    teacher-forced decode gives one process's tokens."""
    from repro_torch.launch import serve, train

    argv = ["--mode", "mesh", "--arch", ARCH, "--devices", "4",
            "--model-parallel", "2", "--rounds", "1", "--device", "cpu"]
    one = train.main(argv)
    got = train.main(argv + ["--world"])
    capfd.readouterr()
    for g, w in zip(got["history"], one["history"]):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * (1 + abs(w["loss"]))
    assert all(r["change_sketch"] == got["ranks"][0]["change_sketch"]
               for r in got["ranks"])

    argv = ["--arch", ARCH, "--devices", "4", "--model-parallel", "2",
            "--new-tokens", "3", "--device", "cpu"]
    one = serve.main(argv)
    got = serve.main(argv + ["--world"], teacher=one["tokens"][:, :2])
    assert np.array_equal(got["tokens"], one["tokens"])
    assert len(got["ranks"]) == 4
