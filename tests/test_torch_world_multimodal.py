"""Whisper and LLaVA across ranks: their heads, d_ff and vocab split over
``model`` by the reference's specs, in gloo worlds of 2 and 4 ranks.

* 2 x 2 worlds: three MoDeST rounds of the reduced Whisper and of the
  reduced LLaVA (P = 2 over ``data``, two heads, half of d_ff and half of
  the vocab a rank), with ``frames`` and ``image_embeds`` in the batch,
  then serving from the same weights (a 4 x 56 prompt and one decode).
  LLaVA's 16 image and 56 text positions pass its reduced window of 64,
  so the world's sliding-window mask is exercised, in training and in the
  prefill.
* 1 x 2 worlds: every leaf's gradient of both families, and of LLaVA with
  2 kv heads (GQA); the control with Megatron's *f* left off Whisper's
  encoder output; the collectives a rank issues for the step beside the
  dry run's reckoning of XLA's plan.
* The server launcher's ``--world`` with Whisper.

The reference runs the same rounds and serving on 4 forced host devices
(a 2 x 2 mesh) in one subprocess, from ``jax.random.key(0)``'s weights;
its ``DistributedTrainer`` takes the frontend's input in the batch, as the
port's does (the mesh launcher feeds tokens alone, ROADMAP C11). The
port's runs start from those weights (``params_from_numpy``). Tolerances:
``rtol = atol = 1e-5`` against the port's one process and against the
reference.
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
from repro_torch.engine.flat import params_from_numpy, params_to_numpy
from repro_torch.engine.lowering import stacked_value_and_grad
from repro_torch.launch import dryrun
from repro_torch.launch.world import run_world
from repro_torch.models import build
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["whisper-large-v3", "llava-next-mistral-7b"]
WEIGHTS = [[1.0, 1.0], [1.0, 0.0], [1.0, 1.0]]
B, S, PROMPT = 2, 56, 56
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


out = {}
for arch in %(ARCHS)r:
    cfg = configs.reduced(configs.get_config(arch))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 1, %(B)d, %(S)d)
                        ).astype(np.int32)
    key, n = (("frames", cfg.n_frames) if cfg.family == "audio" else
              ("image_embeds", cfg.image_tokens * cfg.anyres_tiles))
    batch = {"tokens": toks, "labels": toks,
             key: rng.standard_normal((2, 1, %(B)d, n, cfg.d_model)
                                      ).astype(np.float32)}
    rec = {"batch": batch}
    trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd", lr=0.1),
                                 mesh_cfg, strategy="modest", mesh=mesh,
                                 donate=False)
    with set_mesh(mesh):
        state = trainer.init_state(0)
        rec["init"] = jax.tree.map(lambda x: np.asarray(x[0]), state.params)
        tmpl = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                for k, v in batch.items()}
        step = trainer.jit_train_step(batch_template=tmpl)
        losses, rounds = [], []
        for w in %(WEIGHTS)r:
            state, m = step(state, batch, np.asarray(w, np.float32))
            losses.append(float(m["loss"]))
            rounds.append(jax.tree.map(np.asarray, state.params))
        rec["losses"], rec["rounds"] = losses, rounds
    server = Server(cfg, mesh_cfg, mesh=mesh)
    n_img = n if cfg.family == "vlm" else 0
    max_len = n_img + %(PROMPT)d + 8
    rec["max_len"] = max_len
    with set_mesh(mesh):
        params = server.shard_params(jax.tree.map(jnp.asarray, rec["init"]))
        cache = server.shard_cache(server.model.init_cache(4, max_len))
        rng = np.random.default_rng(2)
        prompt = {"tokens": rng.integers(0, cfg.vocab, size=(
                      4, %(PROMPT)d)).astype(np.int32),
                  key: rng.standard_normal((4, n, cfg.d_model)
                                           ).astype(np.float32)}
        prefill = server.jit_prefill(
            jax.eval_shape(lambda: params),
            {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in prompt.items()},
            jax.eval_shape(lambda: cache))
        logits, cache = prefill(params, prompt, cache)
        decode = server.jit_decode(jax.eval_shape(lambda: params),
                                   jax.eval_shape(lambda: cache))
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        dlogits, cache = decode(params, tok, cache)
    rec["serve"] = {"prompt": prompt, "prefill": np.asarray(logits),
                    "tok": np.asarray(tok), "decode": np.asarray(dlogits)}
    out[arch] = rec
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % dict(ARCHS=ARCHS, B=B, S=S, WEIGHTS=WEIGHTS, PROMPT=PROMPT)


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


def _cfg(arch, **overrides):
    return configs.reduced(configs.get_config(arch)).with_(**overrides)


@pytest.fixture(scope="module")
def worlds(reference):
    out = {}
    for arch in ARCHS:
        ref = reference[arch]
        out[arch] = run_world(
            bodies.multimodal_world_body, 4,
            args=(arch, ref["init"], ref["batch"], WEIGHTS,
                  ref["serve"]["prompt"], ref["max_len"]), **WORLD)
    return out


def _one_process_rounds(arch, init, batch_np):
    tr = DistributedTrainer(_cfg(arch), TrainConfig(optimizer="sgd", lr=0.1),
                            bodies.MULTIMODAL_MESH, strategy="modest",
                            device="cpu")
    state = bodies.whole_state(tr, params_from_numpy(init, "cpu"))
    step = tr.jit_train_step()
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    losses, rounds = [], []
    for w in WEIGHTS:
        state, m = step(state, batch, torch.tensor(w))
        losses.append(float(m["loss"]))
        rounds.append(state.params)
    return losses, rounds


def _paths(tree, prefix=""):
    """``(path, leaf)`` of a tree of dicts, in ``tree_leaves``' order."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _paths(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


@pytest.mark.parametrize("arch", ARCHS)
def test_world_rounds_equal_one_process_and_reference(reference, worlds,
                                                      arch):
    """Each round's loss and each round's parameters (every leaf,
    gathered) against the port's one-process trainer (P = 2 stacked), and
    against the reference; every rank reports the same losses."""
    ref = reference[arch]
    losses, rounds = _one_process_rounds(arch, ref["init"], ref["batch"])
    got = worlds[arch][0]
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    paths = [k for k, _ in _paths(ref["rounds"][0])]
    for r, (g_round, w_round, j_round) in enumerate(
            zip(got["rounds"], rounds, ref["rounds"])):
        for i, (g, w, j) in enumerate(zip(tree_leaves(g_round),
                                          tree_leaves(w_round),
                                          tree_leaves(j_round))):
            msg = f"round {r} {paths[i]}"
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=msg,
                                       **TOL)
            np.testing.assert_allclose(g.numpy(), j, err_msg=msg, **TOL)
    assert all(w["losses"] == got["losses"] for w in worlds[arch])
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_world_serve_equals_one_process_and_reference(reference, worlds,
                                                      arch):
    """Prefill and decode logits on every rank against one process's and
    the reference's; the greedy token alike; each rank's cache holds its
    batch rows and its kv heads (Whisper's cross cache too), and the
    serving issued only all-reduces and the logits' gathers."""
    ref = reference[arch]
    cfg = _cfg(arch)
    server = Server(cfg, MeshConfig(data=1, model=1), device="cpu")
    params = params_from_numpy(ref["init"], "cpu")
    cache = server.model.init_cache(4, ref["max_len"], "cpu")
    prompt = {k: torch.as_tensor(v) for k, v in ref["serve"]["prompt"].items()}
    logits, cache = server.prefill(params, prompt, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    dlogits, _ = server.decode(params, tok, cache)
    n_img = 16 if arch.startswith("llava") else 0
    for r in worlds[arch]:
        assert torch.equal(r["tok"], tok) and r["pos"] == n_img + PROMPT + 1
        for key, one, want in (("prefill", logits, ref["serve"]["prefill"]),
                               ("decode", dlogits, ref["serve"]["decode"])):
            np.testing.assert_allclose(r[key].numpy(), one.numpy(), **TOL)
            np.testing.assert_allclose(r[key].numpy(), want, **TOL)
        assert np.array_equal(r["tok"].numpy(), ref["serve"]["tok"])
        self_kv = (2, 2, ref["max_len"], 2, 32)
        counts = r["serve_counts"]
        if arch == "whisper-large-v3":
            assert r["cache"] == {"k": self_kv, "v": self_kv,
                                  "xk": (2, 2, 16, 2, 32),
                                  "xv": (2, 2, 16, 2, 32)}
            # the prefill: the embedding, per encoder layer wo and the
            # MLP's wo, per decoder layer both attentions' wo and the
            # MLP's; the decode: no encoder
            assert counts["all_reduce"] == (1 + 2 * 2 + 2 * 3) + (1 + 2 * 3)
        else:
            assert r["cache"] == {"k": self_kv, "v": self_kv}
            # the embedding of the text tokens, per layer wo and wd
            assert counts["all_reduce"] == 2 * (1 + 2 * 2)
        # the logits over model, then data
        assert counts["all_gather"] == 2 * 2


# (arch, overrides, leaves split, all-reduces, their bytes) of a 1 x 2
# world's local step, two sequences of 56: forward, g on the embedding, on
# every row-parallel output (Whisper's encoder attention and MLP, its
# decoder's two attentions and MLP; LLaVA's attention and MLP) and the
# loss's max, sum and target logit; backward, f on every block's
# column-parallel input (the encoder's self-attention shares its input's
# between q, k and v), on ``h`` and, once, on Whisper's encoder output.
GRAD_CASES = [("whisper-large-v3", {}, 17, 26, 1_901_888),
              ("llava-next-mistral-7b", {}, 9, 13, 1_410_368),
              ("llava-next-mistral-7b", {"n_kv_heads": 2}, 9, 13,
               1_410_368)]


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    if cfg.family == "audio":
        key, n = "frames", cfg.n_frames
    else:
        key, n = "image_embeds", cfg.image_tokens * cfg.anyres_tiles
    return {"tokens": toks, "labels": toks,
            key: rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)}


def _grad_world(arch, overrides, drop_f=False):
    cfg = _cfg(arch, **overrides)
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg)
    ranks = run_world(bodies.multimodal_grad_body, 2,
                      args=(arch, params_to_numpy(params), batch, overrides,
                            drop_f), **WORLD)
    whole = stacked_value_and_grad(build(cfg).loss_fn)(
        tree_map(lambda x: x[None], params),
        {k: torch.as_tensor(v)[None] for k, v in batch.items()})
    return ranks, whole


@pytest.mark.parametrize("arch,overrides,split,calls,nbytes", GRAD_CASES,
                         ids=["whisper", "llava", "llava-gqa"])
def test_world_gradients_equal_one_process(arch, overrides, split, calls,
                                           nbytes):
    """Every leaf's gradient on a 1 x 2 world, gathered by the world's
    specs, against one process's, and the loss; the leaves split and the
    all-reduces a rank issued (``GRAD_CASES``)."""
    ranks, (loss, grads) = _grad_world(arch, overrides)
    for r in ranks:
        assert r["split"] == split
        assert r["counts"]["all_reduce"] == calls
        assert r["counts"]["all_reduce_bytes"] == nbytes
        assert r["counts"]["all_gather"] == 0
        np.testing.assert_allclose(float(r["loss"]), float(loss[0]), **TOL)
        for g, w in zip(tree_leaves(r["grads"]), tree_leaves(grads)):
            np.testing.assert_allclose(g.numpy(), w[0].numpy(), **TOL)


def test_whisper_gradients_without_f_on_enc_are_caught():
    """The control: with *f* left off Whisper's encoder output, its
    gradient is one rank's heads' share, so ``enc_pos`` and every encoder
    leaf move far outside the tolerance (0.68 to 0.77 relative L2
    measured; held above 0.1), while the loss and the decoder's leaves are
    unchanged; the rank issues one all-reduce fewer."""
    ranks, (loss, grads) = _grad_world("whisper-large-v3", {}, True)
    got, want = ranks[0]["grads"], grads
    np.testing.assert_allclose(float(ranks[0]["loss"]), float(loss[0]),
                               **TOL)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert ranks[0]["counts"]["all_reduce"] == GRAD_CASES[0][3] - 1
    assert rel(got["enc_pos"].numpy(), want["enc_pos"][0].numpy()) > 0.1
    for g, w in zip(tree_leaves(got["encoder"]), tree_leaves(
            want["encoder"])):
        assert rel(g.numpy(), w[0].numpy()) > 0.1
    for g, w in zip(tree_leaves(got["decoder"]), tree_leaves(
            want["decoder"])):
        np.testing.assert_allclose(g.numpy(), w[0].numpy(), **TOL)


def test_world_local_step_all_reduces_beside_the_reckoning():
    """One rank's collectives for a local step (``COUNTS`` of the 1 x 2
    worlds above: the world's plan) beside the dry run's reckoning of XLA's
    plan for the same step at ``model = 2`` (the 4 x 2 mesh that
    ``tests/test_torch_dryrun.py`` holds to XLA's compile; its ``data``
    axis adds the metrics' all-reduce, 8 bytes), at a participant's two
    sequences of 56. Both meet in all-reduces alone, and the forward
    passes alike. Backward, XLA sums the input gradients of a block's
    column-parallel products apart (the k and v operands of every
    self-attention, beside q's; LLaVA's MLP's ``wu`` beside ``wg``), where
    the world's one *f* on the input sums one; XLA sums Whisper's encoder
    output's gradient in every decoder layer (two operands at n_frames a
    layer), the world once; XLA puts the target logit and ``h``'s gradient
    in one op, the world in two. LLaVA's plans are the dense family's at
    the merged length (the concatenation adds none; the embedding and the
    loss are the text's) (ROADMAP C14)."""
    shape = dryrun.ShapeConfig("train_small", S, 8, "train")
    act = B * S * 256 * 4                         # (B, S, d) fp32
    frames = B * 16 * 256 * 4                     # (B, n_frames, d)
    merged = B * (16 + S) * 256 * 4               # (B, n_img + S, d)
    # (XLA's count and bytes, XLA's ops and bytes the world does not issue)
    xla = {"whisper-large-v3": (25, 2_590_024, 1 - 1 - 1,
                                8 + 2 * 2 * act + 2 * 2 * frames
                                + 2 * 2 * frames - frames),
           "llava-next-mistral-7b": (13, 2_295_112, 1 - 1,
                                     8 + 2 * 2 * merged + 2 * merged)}
    for arch, (count, nbytes, fewer, more_bytes) in xla.items():
        rec = dryrun.reckon(_cfg(arch), shape, MeshConfig(data=4, model=2),
                            strategy="local", micro_override=1)
        assert rec["collectives"]["counts"] == {"all-reduce": count}, arch
        assert rec["collectives"]["bytes"] == {"all-reduce": nbytes}, arch
        calls, world_bytes = next((c, b) for a, o, _, c, b in GRAD_CASES
                                  if a == arch and not o)
        assert count - calls == fewer, arch
        assert nbytes - world_bytes == more_bytes, arch


def test_server_launcher_runs_a_whisper_world():
    """``launch/serve.py --world`` with Whisper (the launcher builds
    ``frames``): the 2 x 2 world's teacher-forced decode gives one
    process's tokens."""
    from repro_torch.launch import serve

    argv = ["--arch", "whisper-large-v3", "--devices", "4",
            "--model-parallel", "2", "--new-tokens", "3", "--device", "cpu"]
    one = serve.main(argv)
    got = serve.main(argv + ["--world"], teacher=one["tokens"][:, :2])
    assert np.array_equal(got["tokens"], one["tokens"])
    assert len(got["ranks"]) == 4
