"""Caches split by sequence across ranks and kv heads that the ``model``
axis does not divide, in gloo worlds of 2 and 4 ranks.

* ``shard_seq`` on a 2 x 1 world (the cache's sequence over ``data``, the
  batch and the decode token whole on every rank): the reduced TinyLlama,
  gemma2 (a window of 6 and its local and global layers), qwen3-moe,
  LLaVA, Whisper (self and cross caches), Hymba and RWKV-6 (their states
  whole over ``data``), in one world. The cache is long enough that the
  decodes land in rank 0's chunk while rank 1's holds no valid position.
* kv = 1 on a 1 x 2 world (the world rule ``kv_whole``: ``wk`` / ``wv``
  whole over ``model``, the cache's sequence over ``model``): TinyLlama,
  qwen3-moe and LLaVA served; a train step's loss and every gradient
  against one process's; a control with the sum of ``wk`` / ``wv``'s
  gradient over ``model`` left out, which the gradient check catches.
* On a 2 x 2 world: ``shard_seq`` with kv = 1 (T over ``data``, kv whole
  over ``model``) and ``shard_seq`` at ``pod`` granularity (FSDP).

Each serve is a prefill and 4 greedy decodes (one process's tokens fed to
the world and the reference), against the port's one process and the
reference's, from ``jax.random.key(0)``'s weights (``params_from_numpy``);
each rank's cache is its spec's slice of one process's. Tolerances:
``rtol = atol = 1e-5``; against the reference, ``atol`` is 1e-5 times the
logits' largest magnitude where that is above 1, the rule of
``tests/test_torch_world_recurrent.py`` (RWKV-6's logits differ from the
reference's by 1.1e-5 at a magnitude of 2.3; ROADMAP C12). ``shard_seq``,
a kv = 1 cache placed over ``model`` and ``shard_seq`` at ``pod``
granularity build and place on a rank's mesh without groups too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world_bodies as bodies
from repro import configs as jconfigs
from repro.models import build as jbuild
from repro_torch import configs
from repro_torch.config import MeshConfig, TrainConfig
from repro_torch.core.distributed import DistributedTrainer, Server
from repro_torch.engine.flat import params_from_numpy
from repro_torch.launch.world import run_world
from repro_torch.sharding import DeviceMesh, ShardingPolicy
from repro_torch.utils.pytree import tree_flatten_with_path, tree_leaves
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = dict(device="cpu", threads=1, quiet=True, timeout=170.0)
B, PROMPT, NEW = 2, 8, 4
SEQ = dict(data=2, model=1)
KV = dict(data=1, model=2)
BOTH = dict(data=2, model=2)
# name: (arch, overrides, mesh, shard_seq, max_len)
SERVES = {
    "tiny": ("tinyllama-1.1b", {}, SEQ, True, 32),
    "gemma2": ("gemma2-27b", dict(window=6), SEQ, True, 32),
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}, SEQ, True, 32),
    "llava": ("llava-next-mistral-7b", {}, SEQ, True, 64),
    "whisper": ("whisper-large-v3", {}, SEQ, True, 32),
    "hymba": ("hymba-1.5b", {}, SEQ, True, 32),
    "rwkv": ("rwkv6-1.6b", {}, SEQ, True, 32),
    "tiny-kv1": ("tinyllama-1.1b", dict(n_kv_heads=1), KV, False, 32),
    "moe-kv1": ("qwen3-moe-30b-a3b", dict(n_kv_heads=1), KV, False, 32),
    "llava-kv1": ("llava-next-mistral-7b", dict(n_kv_heads=1), KV, False,
                  64),
    "seq-kv1": ("tinyllama-1.1b", dict(n_kv_heads=1), BOTH, True, 32),
    "seq-pod": ("tinyllama-1.1b", dict(participant_granularity="pod"), BOTH,
                True, 32),
}
WORLDS = {2: ("tiny", "gemma2", "qwen3-moe", "llava", "whisper", "hymba",
              "rwkv"),
          "kv": ("tiny-kv1", "moe-kv1", "llava-kv1"),
          4: ("seq-kv1", "seq-pod")}
# name: (arch, overrides, mesh); kv = 1 on 1 x 2, and at pod on 2 x 2
# (FSDP over data beside kv_whole over model)
GRADS = {a: (a, dict(n_kv_heads=1), KV) for a in (
    "tinyllama-1.1b", "qwen3-moe-30b-a3b", "llava-next-mistral-7b")}
GRADS["tiny-pod-kv1"] = ("tinyllama-1.1b", dict(
    n_kv_heads=1, participant_granularity="pod"), BOTH)


def _k(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _cfgs(arch, overrides):
    return (jconfigs.reduced(jconfigs.get_config(arch)).with_(**overrides),
            configs.reduced(configs.get_config(arch)).with_(**overrides))


def _params(jcfg):
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))


def _batch(cfg, rng, lead=()):
    out = {"tokens": rng.integers(0, cfg.vocab, lead + (B, PROMPT))}
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal(
            lead + (B, cfg.n_frames, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = (rng.standard_normal(
            lead + (B, cfg.image_tokens * cfg.anyres_tiles, cfg.d_model))
            * 0.1).astype(np.float32)
    return out


def _one_serve(cfg, params_np, batch_np, max_len):
    """One process: the prefill and 4 greedy decodes; the tokens, every
    step's last logits and the final cache."""
    server = Server(cfg, device="cpu")
    params = params_from_numpy(params_np, "cpu")
    cache = server.model.init_cache(B, max_len, "cpu")
    logits, cache = server.prefill(
        params, {k: torch.as_tensor(v) for k, v in batch_np.items()}, cache)
    steps, toks = [logits[:, -1]], []
    for _ in range(NEW):
        tok = torch.argmax(logits[:, -1:], dim=-1)
        toks.append(tok)
        logits, cache = server.decode(params, tok, cache)
        steps.append(logits[:, -1])
    return torch.cat(toks, dim=1).numpy(), torch.stack(steps), cache


def _ref_serve(jcfg, params_np, batch_np, teacher, max_len):
    model = jbuild(jcfg)
    params = jax.tree.map(jnp.asarray, params_np)
    cache = model.init_cache(B, max_len)
    logits, cache = model.prefill(
        params, {k: jnp.asarray(v) for k, v in batch_np.items()}, cache)
    steps = [np.asarray(logits[:, -1])]
    for i in range(teacher.shape[1]):
        logits, cache = model.decode_step(
            params, jnp.asarray(teacher[:, i:i + 1], jnp.int32), cache)
        steps.append(np.asarray(logits[:, -1]))
    return np.stack(steps)


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, (arch, kw, mesh, seq, max_len) in SERVES.items():
        jcfg, cfg = _cfgs(arch, kw)
        params_np = _params(jcfg)
        batch_np = _batch(cfg, np.random.default_rng(len(name)))
        toks, steps, cache = _one_serve(cfg, params_np, batch_np, max_len)
        out[name] = dict(
            args=(arch, kw, mesh, params_np, batch_np, toks, max_len, seq),
            steps=steps, cache=cache,
            ref=_ref_serve(jcfg, params_np, batch_np, toks, max_len))
    return out


@pytest.fixture(scope="module")
def grad_cases():
    out = {}
    for name, (arch, kw, mesh) in GRADS.items():
        jcfg, cfg = _cfgs(arch, kw)
        params_np = _params(jcfg)
        b = _batch(cfg, np.random.default_rng(5), lead=(1, 1))
        b["labels"] = np.roll(b["tokens"], -1, axis=-1)
        trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd",
                                                      lr=0.1),
                                     MeshConfig(**mesh), device="cpu")
        state = bodies.whole_state(trainer, params_from_numpy(params_np,
                                                              "cpu"))
        loss, grads = trainer.grads(state, {k: torch.as_tensor(v)
                                            for k, v in b.items()})
        out[name] = dict(args=(arch, kw, mesh, params_np, b), loss=loss,
                         grads=grads)
    return out


@pytest.fixture(scope="module")
def worlds(cases, grad_cases):
    got = {}
    for key, names in WORLDS.items():
        serves = {n: cases[n]["args"] for n in names}
        grads = {n: c["args"] for n, c in grad_cases.items()
                 if c["args"][2] == {"kv": KV, 4: BOTH}.get(key)}
        if key == "kv":
            grads["control"] = grad_cases["tinyllama-1.1b"]["args"] + (True,)
        n = 4 if key == 4 else 2
        got[key] = run_world(bodies.seq_worlds_body, n,
                             args=(serves, grads), **WORLD)
    return got


def _ranks(worlds, name):
    key = next(k for k, names in WORLDS.items() if name in names)
    return [r["serves"][name] for r in worlds[key]]


@pytest.mark.parametrize("name", list(SERVES))
def test_world_serve_equals_one_process_and_reference(cases, worlds, name):
    case = cases[name]
    arch, kw, mesh, *_ = case["args"]
    want = case["ref"]
    np.testing.assert_allclose(case["steps"].numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    mcfg = MeshConfig(**mesh)
    for r in _ranks(worlds, name):
        np.testing.assert_allclose(r["steps"].numpy(),
                                   case["steps"].numpy(), **TOL)
        assert r["pos"] == case["cache"]["pos"]
        for k, leaf in r["cache"].items():
            want = bodies.slice_by_spec(case["cache"][k].numpy(),
                                        r["spec"][k], mcfg.shape, mcfg.axes,
                                        r["coords"])
            assert leaf.shape == want.shape, (k, leaf.shape, want.shape)
            np.testing.assert_allclose(leaf.numpy(), want, **TOL)
    first = _ranks(worlds, name)[0]
    seq = first["spec"].get("k", (None,) * 5)[2]
    # the cache served names its own layout
    assert all(r["seq_axes"]["k"] == seq for r in _ranks(worlds, name))
    if case["args"][-1]:                        # shard_seq: T over data
        assert seq == ("data" if "k" in first["spec"] else None)
        if "xk" in first["spec"]:
            assert first["spec"]["xk"][2] == "data"
    else:                                       # kv = 1: T over model
        assert seq == "model" and first["spec"]["k"][3] is None
        # kv_whole: wk / wv whole on every rank, wq split
        cfg = _cfgs(arch, kw)[1]
        hd = cfg.resolved_head_dim()
        assert first["local"]["wk"][-1] == cfg.n_kv_heads * hd
        assert first["local"]["wq"][-1] == cfg.n_heads * hd // 2
    if seq is not None:                         # the partials' gathers
        assert first["counts"]["all_gather"] > 0


@pytest.mark.parametrize("name", list(GRADS))
def test_kv_whole_gradients_equal_one_process(grad_cases, worlds, name):
    """kv = 1 on 1 x 2, and at pod granularity on 2 x 2: the loss and
    every gradient of a train step."""
    case = grad_cases[name]
    ranks = [r["grads"][name]
             for r in worlds["kv" if GRADS[name][2] == KV else 4]]
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"][0]),
                                   float(case["loss"][0]), **TOL)
    whole = case["grads"]["layers"]["attn"]["wk"].shape
    assert all(r["local"]["wk"][-1] == whole[-1]      # whole over model
               for r in ranks)
    got, want = ranks[0]["grads"], case["grads"]
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_kv_whole_gradients_without_the_sum_are_caught(grad_cases, worlds):
    """The control: ``wk`` / ``wv``'s gradient not summed over ``model``
    differs from one process's (the other rank's heads' part is missing),
    while every other leaf still agrees."""
    want = grad_cases["tinyllama-1.1b"]["grads"]
    got = worlds["kv"][0]["grads"]["control"]["grads"]
    caught = [_k(path) for (path, w), g in zip(
        tree_flatten_with_path(want)[0], tree_leaves(got))
        if not np.allclose(g.numpy(), w.numpy(), **TOL)]
    assert caught and all(n.endswith(("attn/wk", "attn/wv"))
                          for n in caught), caught


@pytest.mark.parametrize("what", ["seq_cache", "grad_clip", "moe_serve_tp"])
def test_world_builds_and_places_split_caches(what):
    """A server on a rank's mesh builds and places its cache (no process
    is started: a mesh without groups; the runs themselves are the worlds
    above): ``shard_seq`` (``seq_cache``),
    ``shard_seq`` at ``pod`` granularity (``grad_clip``) and a kv = 1
    cache over ``model`` (``moe_serve_tp``)."""
    mesh = DeviceMesh(("cpu",) * 8, ("data", "model"), (4, 2), rank=3)
    mcfg = MeshConfig(data=4, model=2)
    dense = configs.reduced(configs.get_config("tinyllama-1.1b"))
    kw = dict(mesh=mesh, device="cpu")
    if what == "seq_cache":
        server = Server(dense, mcfg, shard_seq=True, **kw)
        cache = server.shard_cache(server.model.init_cache(8, 8, "cpu"))
        assert cache["k"].shape == (2, 8, 2, 2, 32)     # T / 4, kv / 2
        assert cache["seq_axes"] == {"k": "data", "xk": None}
    elif what == "grad_clip":
        server = Server(dense.with_(participant_granularity="pod"), mcfg,
                        shard_seq=True, **kw)
        cache = server.shard_cache(server.model.init_cache(8, 8, "cpu"))
        assert cache["k"].shape == (2, 8, 2, 2, 32)
    else:
        one_kv = dense.with_(n_kv_heads=1)
        server = Server(one_kv, mcfg, **kw)
        cache = server.shard_cache(server.model.init_cache(8, 8, "cpu"))
        assert cache["k"].shape == (2, 2, 4, 1, 32)     # B / 4, T / 2
        assert cache["seq_axes"] == {"k": "model", "xk": None}
        policy = ShardingPolicy(one_kv, mcfg)
        assert policy.kv_whole()
        params = server.model.init(torch.Generator().manual_seed(0), "meta")
        spec = policy.param_spec(params, with_participants=False, world=True)
        assert spec["layers"]["attn"]["wk"] == (None, None, None)
        assert spec["layers"]["attn"]["wq"] == (None, None, "model")
        # the reference's specs (world=False) split wk's lanes
        ref = policy.param_spec(params, with_participants=False)
        assert ref["layers"]["attn"]["wk"] == (None, None, "model")
