"""The mesh round and serving across ranks: 4 x 2 worlds running the
bodies of the reference's ``tests/test_distributed.py``.

* MoDeST: four rounds of the reduced TinyLlama, P = 4 participants over
  ``data``, tensor parallel 2 over ``model``, slot 2 at weight 0 in every
  round, its mix by gathering P and, again, by reducing the weighted
  mean's partials; D-SGD: one round at full weights. One 8-rank world
  runs all three.
* Serving: the reduced gemma2-27b, a 4 x 16 prompt and one decode, on a
  second 8-rank world.
* Gradients: every leaf's gradient of the reduced TinyLlama on a 1 x 2
  world (vocab-parallel embedding and loss, column- and row-parallel
  pairs), gathered by its spec.

The reference runs the same three bodies on 8 forced host devices in one
subprocess (its device count is fixed when jax starts), from
``jax.random.key(0)``'s weights; the port's runs start from those weights
(``params_from_numpy``). Tolerances: the worlds against the port's
one-process trainer and server, and against the reference (which
partitions its arithmetic over 8 devices in its own order),
``rtol = atol = 1e-5``; the gaps measured are written at ``REF_TOL``.
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
# the largest gaps to the reference measured on the CPU: losses 9.5e-7
# (MoDeST; D-SGD 0), final parameters 1.4e-7 (MoDeST; D-SGD 4.7e-8),
# prefill logits 8.5e-7 and decode logits 8.3e-7 (of magnitude 1.2)
REF_TOL = dict(rtol=1e-5, atol=1e-5)
MODEST = [[1.0, 1.0, 0.0, 1.0]] * 4
DSGD = [[1.0, 1.0, 1.0, 1.0]]
B, S, PROMPT, MAX_LEN = 2, 32, 16, 24
WORLD = dict(device="cpu", threads=1, quiet=True, timeout=170.0)

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from repro import configs
from repro.config import MeshConfig, TrainConfig
from repro.core.distributed import DistributedTrainer, Server
from repro.utils.compat import make_mesh, set_mesh
assert jax.device_count() == 8
mesh = make_mesh((4, 2), ("data", "model"))
mesh_cfg = MeshConfig(data=4, model=2)
out = {}
cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
toks = np.random.default_rng(1).integers(
    0, cfg.vocab, size=(4, 1, %(B)d, %(S)d)).astype(np.int32)
out["toks"] = toks
for name, weights in (("modest", %(MODEST)r), ("dsgd", %(DSGD)r)):
    trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd", lr=0.1),
                                 mesh_cfg, strategy=name, mesh=mesh,
                                 donate=False)
    with set_mesh(mesh):
        state = trainer.init_state(0)
        out["init"] = jax.tree.map(lambda x: np.asarray(x[0]), state.params)
        tmpl = {k: jax.ShapeDtypeStruct(toks.shape, jnp.int32)
                for k in ("tokens", "labels")}
        step = trainer.jit_train_step(batch_template=tmpl)
        losses = []
        for w in weights:
            state, m = step(state, {"tokens": toks, "labels": toks},
                            np.asarray(w, np.float32))
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses,
                     "final": jax.tree.map(np.asarray, state.params)}
gcfg = configs.reduced(configs.get_config("gemma2-27b"))
server = Server(gcfg, mesh_cfg, mesh=mesh)
with set_mesh(mesh):
    params = server.shard_params(server.model.init(jax.random.key(0)))
    cache = server.shard_cache(server.model.init_cache(4, %(MAX_LEN)d))
    tokens = np.random.default_rng(1).integers(
        0, gcfg.vocab, size=(4, %(PROMPT)d)).astype(np.int32)
    prefill = server.jit_prefill(
        jax.eval_shape(lambda: params),
        {"tokens": jax.ShapeDtypeStruct(tokens.shape, tokens.dtype)},
        jax.eval_shape(lambda: cache))
    logits, cache = prefill(params, {"tokens": tokens}, cache)
    decode = server.jit_decode(jax.eval_shape(lambda: params),
                               jax.eval_shape(lambda: cache))
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    dlogits, cache = decode(params, tok, cache)
out["serve"] = {"params": jax.tree.map(np.asarray, params),
                "tokens": tokens, "prefill": np.asarray(logits),
                "tok": np.asarray(tok), "decode": np.asarray(dlogits)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % dict(B=B, S=S, MODEST=MODEST, DSGD=DSGD, PROMPT=PROMPT,
           MAX_LEN=MAX_LEN)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                           path], capture_output=True, text=True,
                          timeout=420, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _train_cfg():
    return configs.reduced(configs.get_config("tinyllama-1.1b"))


def _one_process(ref, name, weights):
    """The port's one-process trainer (P = 4 stacked, no tensor
    parallelism) from the reference's weights."""
    tr = DistributedTrainer(_train_cfg(), TrainConfig(optimizer="sgd",
                                                      lr=0.1),
                            bodies.TRAIN_MESH, strategy=name, device="cpu")
    state = bodies.whole_state(tr, params_from_numpy(ref["init"], "cpu"))
    step = tr.jit_train_step()
    toks = torch.as_tensor(ref["toks"])
    losses = []
    for w in weights:
        state, m = step(state, {"tokens": toks, "labels": toks},
                        torch.tensor(w))
        losses.append(float(m["loss"]))
    return losses, state.params


@pytest.fixture(scope="module")
def trained(reference):
    world = run_world(bodies.trainer_body, 8,
                      args=(reference["init"], reference["toks"],
                            [("modest", MODEST, "auto"),
                             ("dsgd", DSGD, "auto"),
                             ("modest", MODEST, "reduce"),
                             ("local", DSGD, "auto")]), **WORLD)
    one = {name: _one_process(reference, name, w)
           for name, w in (("modest", MODEST), ("dsgd", DSGD))}
    return world, one


@pytest.mark.parametrize("name,mix", [("modest", "auto"), ("dsgd", "auto"),
                                      ("modest", "reduce")])
def test_world_round_equals_one_process_and_reference(reference, trained,
                                                      name, mix):
    """Losses, activity and final parameters against the one-process
    trainer and the reference; the mix gathers P on the CPU (``auto``),
    or reduces the weighted mean's partials (``reduce``)."""
    world, one = trained
    losses, params = one[name]
    got = world[0][f"{name}/{mix}"]
    assert got["form"] == ("reduce" if mix == "reduce" else "gather")
    np.testing.assert_allclose([r["loss"] for r in got["rounds"]], losses,
                               **TOL)
    np.testing.assert_allclose([r["loss"] for r in got["rounds"]],
                               reference[name]["losses"], **REF_TOL)
    assert [r["active"] for r in got["rounds"]] == [
        sum(w) for w in (MODEST if name == "modest" else DSGD)]
    for g, w, j in zip(tree_leaves(got["final"]), tree_leaves(params),
                       tree_leaves(reference[name]["final"])):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), j, **REF_TOL)
    # every rank gathered the same model; each held its shards only
    assert all(r[f"{name}/{mix}"]["digest"] == got["digest"] for r in world)
    whole = [tuple(x.shape) for x in tree_leaves(params)]
    for r in world:
        local = r[f"{name}/{mix}"]["local"]
        assert all(s[0] == 1 for s in local)
        assert sum(np.prod(s) for s in local) < sum(
            np.prod(s) for s in whole) / 4
    if name == "modest":
        assert losses[-1] < losses[0]
        assert all(r["gap"] < 1e-5 for r in got["rounds"])
    else:
        assert got["rounds"][0]["gap"] > 1e-6


def test_world_local_step_all_reduces_beside_the_reckoning(trained):
    """The ``local`` step of the 4 x 2 world issues the dense family's
    tensor-parallel all-reduces through ``collectives``: 13 calls, 656,128
    bytes a rank. The dry run reckons XLA's program at this mesh: 13
    all-reduces, 1,049,352 bytes (``tests/test_torch_dryrun.py`` holds it
    to XLA's compile). The terms that separate them: XLA reduces the input
    gradients of q, k, v and of g, u apart (five operands a layer), where
    Megatron's *f* sums each block input's gradient once (two), 3 x L
    activations of (1, 2, 32, 256) fp32; and XLA all-reduces the metrics
    (loss, active: 8 bytes) over ``data``, where the world gathers the
    losses. The remat term is 0 here (the reduced config has no remat; the
    port never recomputes)."""
    from repro_torch.launch import dryrun
    from repro_torch.config import ShapeConfig

    world, _ = trained
    cfg = _train_cfg()
    rec = dryrun.reckon(cfg, ShapeConfig("train_small", S, 4 * B, "train"),
                        bodies.TRAIN_MESH, strategy="local")["collectives"]
    act = 1 * B * S * cfg.d_model * 4
    split_operands = 3 * cfg.n_layers * act
    metrics = 8
    assert rec["remat"] == {"bytes": {}, "counts": {}}
    assert rec["bytes"] == {"all-reduce": 1_049_352}
    for r in world:
        counts = r["local/auto"]["rounds"][0]["counts"]
        assert counts["all_reduce"] == 13 == rec["counts"]["all-reduce"]
        assert counts["all_reduce_bytes"] == 656_128
        assert counts["all_reduce_bytes"] + split_operands + metrics == \
            rec["bytes"]["all-reduce"]
        assert counts["all_gather"] > 0          # the losses, and the mix


@pytest.fixture(scope="module")
def served(reference):
    ref = reference["serve"]
    world = run_world(bodies.serve_body, 8,
                      args=(ref["params"], ref["tokens"], MAX_LEN), **WORLD)
    cfg = configs.reduced(configs.get_config("gemma2-27b"))
    server = Server(cfg, MeshConfig(data=1, model=1), device="cpu")
    params = params_from_numpy(ref["params"], "cpu")
    cache = server.model.init_cache(4, MAX_LEN, "cpu")
    logits, cache = server.prefill(params, {"tokens": torch.as_tensor(
        ref["tokens"])}, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    dlogits, cache = server.decode(params, tok, cache)
    return world, (logits, tok, dlogits, cache)


def test_world_serve_equals_one_process_and_reference(reference, served):
    world, (logits, tok, dlogits, cache) = served
    ref = reference["serve"]
    for r in world:
        assert r["params_are_slices"]
        assert torch.equal(r["tok"], tok) and r["pos"] == PROMPT + 1
        np.testing.assert_allclose(r["prefill"].numpy(), logits.numpy(),
                                   **TOL)
        np.testing.assert_allclose(r["decode"].numpy(), dlogits.numpy(),
                                   **TOL)
        np.testing.assert_allclose(r["prefill"].numpy(), ref["prefill"],
                                   **REF_TOL)
        np.testing.assert_allclose(r["decode"].numpy(), ref["decode"],
                                   **REF_TOL)
        assert np.array_equal(r["tok"].numpy(), ref["tok"])
        # the cache a rank holds: its batch row and kv heads of the whole
        for k, spec in r["cache_spec"].items():
            assert spec == (None, "data", None, "model", None)
            want = bodies.slice_by_spec(cache[k].numpy(), spec, (4, 2),
                                        ("data", "model"), r["coords"])
            assert r["cache"][k].shape == want.shape == (2, 1, MAX_LEN, 2,
                                                         32)
            np.testing.assert_allclose(r["cache"][k].numpy(), want, **TOL)


def test_tensor_parallel_gradients_equal_one_process(reference):
    """Every leaf's gradient on a 1 x 2 world, gathered by its spec,
    against one process's; the loss too."""
    toks = reference["toks"][0, 0]
    world = run_world(bodies.grad_body, 2, args=(reference["init"], toks),
                      **WORLD)
    cfg = _train_cfg()
    params = tree_map(lambda x: x[None],
                      params_from_numpy(reference["init"], "cpu"))
    t = torch.as_tensor(toks)[None]
    loss, grads = stacked_value_and_grad(build(cfg).loss_fn)(
        params, {"tokens": t, "labels": t})
    for r in world:
        assert r["split"] == 9       # embed, lm_head, q/k/v/o, mlp g/u/d
        np.testing.assert_allclose(float(r["loss"]), float(loss[0]), **TOL)
        for g, w in zip(tree_leaves(r["grads"]), tree_leaves(grads)):
            np.testing.assert_allclose(g.numpy(), w[0].numpy(), **TOL)


def test_tensor_parallel_gradients_without_f_are_caught(reference):
    """The control of the test above: with Megatron's *f* left out (the
    gradients of the column-parallel products' inputs not summed over
    ``model``), the loss is unchanged but the gradients below the last
    layer move far outside TOL: the worst leaf 0.93 relative L2 measured,
    held above 0.3."""
    toks = reference["toks"][0, 0]
    world = run_world(bodies.grad_body, 2,
                      args=(reference["init"], toks, True), **WORLD)
    cfg = _train_cfg()
    params = tree_map(lambda x: x[None],
                      params_from_numpy(reference["init"], "cpu"))
    t = torch.as_tensor(toks)[None]
    loss, grads = stacked_value_and_grad(build(cfg).loss_fn)(
        params, {"tokens": t, "labels": t})
    gaps = [float(np.linalg.norm(g.numpy() - w[0].numpy())
                  / np.linalg.norm(w[0].numpy()))
            for g, w in zip(tree_leaves(world[0]["grads"]),
                            tree_leaves(grads))]
    np.testing.assert_allclose(float(world[0]["loss"]), float(loss[0]), **TOL)
    assert max(gaps) > 0.3
