"""Gradients of the MoE, RWKV-6, Hymba, Whisper and LLaVA-NeXT families in
the PyTorch package against the reference's ``jax.value_and_grad``, the
MoE's routing under ``torch.func.vmap``, and the stacked cohort lowering
(``engine/lowering.py``) against per-model autograd.

Each family runs its reduced config at a small width (d_model 64, 2 query
heads and 1 KV head of 32, d_ff 128, vocab 64, 16 tokens; the MoE's experts
ff 32), in fp32. Parameters come from the reference's ``init`` through
``params_from_numpy``; inputs from numpy seeds; Whisper's batch carries
``frames`` and LLaVA's ``image_embeds``, as the reference's own model
tests feed them. Tiers: the MoE's top-k indices and kept slots exact;
losses ``rtol = atol = 1e-5``; gradients ``rtol = 1e-5`` and ``atol =
1e-5`` times the leaf's largest magnitude where that is above 1
(RWKV's bonus ``u`` has gradients in the hundreds, from the per-head
norm of a near-zero first output, and XLA and PyTorch sum them in other
orders: about 4e-6 of the leaf's scale apart); the stacked lowering
against the port's own per-model autograd ``1e-6``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import moe as JM
from repro_torch import configs
from repro_torch.engine.flat import params_from_numpy
from repro_torch.engine.lowering import stacked_grads_for, stacked_metrics_for
from repro_torch.models import build
from repro_torch.models import moe as M
from repro_torch.models.tasks import lm_task
from repro_torch.utils.pytree import tree_flatten, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
             vocab=64)
EXTRA = {"qwen3-moe-30b-a3b": dict(moe_d_ff_expert=32)}
ARCHS = ["qwen3-moe-30b-a3b", "rwkv6-1.6b", "hymba-1.5b",
         "whisper-large-v3", "llava-next-mistral-7b"]
TRAINED = ARCHS[:3]                     # the families sessions train
B, T = 3, 16


def _cfgs(arch):
    kw = dict(SMALL, **EXTRA.get(arch, {}))
    return (jconfigs.reduced(jconfigs.get_config(arch)).with_(**kw),
            configs.reduced(configs.get_config(arch)).with_(**kw))


@functools.lru_cache(maxsize=None)
def _jinit(jcfg):
    return jax.jit(jbuild(jcfg).init)


def _jparams(jcfg, seed):
    """The reference's initial parameters (its init under ``jax.jit``:
    one compile a config instead of an eager op a leaf)."""
    return jax.tree.map(np.asarray, _jinit(jcfg)(jax.random.key(seed)))


def _batch(cfg, seed):
    """numpy batch: tokens, labels, a row mask over the sequence (row 0
    kept), and the family's stubbed frontend input."""
    rng = np.random.default_rng(100 + seed)
    rows = rng.random(B) < 0.7
    rows[0] = True
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
         "mask": np.broadcast_to(rows[:, None], (B, T)).astype(np.float32)}
    if cfg.family == "audio":
        b["frames"] = (rng.standard_normal((B, cfg.n_frames, cfg.d_model))
                       * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        n_img = cfg.image_tokens * cfg.anyres_tiles
        b["image_embeds"] = (rng.standard_normal((B, n_img, cfg.d_model))
                             * 0.1).astype(np.float32)
    return b


def _grad_close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def _port_value_and_grad(cfg, params, batch):
    leaves, treedef = tree_flatten(params)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    loss, metrics = build(cfg).loss_fn(treedef.unflatten(leaves), batch)
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch):
    """Value and every gradient leaf of ``loss_fn`` from the reference's
    parameters, Whisper with ``frames`` and LLaVA with ``image_embeds``;
    the MoE's metrics carry its auxiliary loss."""
    jcfg, cfg = _cfgs(arch)
    jp = _jparams(jcfg, 3)
    nb = _batch(cfg, 1)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(jbuild(jcfg).loss_fn,
                                                   has_aux=True))(
        jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v)
                                        for k, v in nb.items()})
    loss, metrics, grads = _port_value_and_grad(
        cfg, params_from_numpy(jp, "cpu"),
        {k: torch.as_tensor(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert sorted(metrics) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmet[k]), **TOL)
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    assert len(grads) == len(jleaves)
    for g, want in zip(grads, jleaves):
        assert g.shape == want.shape
        _grad_close(g, want)


def test_moe_routing_under_vmap_is_the_references_per_member():
    """Two members' routing, taken inside the vmapped loss that the
    cohort step runs: at every layer the top-k experts of every token and
    the kept slots equal the reference's routing of that member alone
    (groups and capacity per member; padded rows still route)."""
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b")
    jps = [_jparams(jcfg, s) for s in range(2)]
    nbs = [_batch(cfg, 5 + s) for s in range(2)]

    want_idx = []
    for jp, nb in zip(jps, nbs):
        seen = []
        top_k = jax.lax.top_k

        def spy(x, k):
            out = top_k(x, k)
            jax.debug.callback(lambda i: seen.append(np.asarray(i)), out[1])
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JM.jax.lax, "top_k", spy)
            jax.block_until_ready(jax.jit(
                lambda p, b: JM.loss_fn(p, jcfg, b))(
                    jax.tree.map(jnp.asarray, jp),
                    {k: jnp.asarray(v) for k, v in nb.items()}))
        assert len(seen) == cfg.n_layers
        want_idx.append(seen)

    routing = M.routing

    def routed(params, tokens, labels, mask):
        seen = []

        def spy(p, c, xg, span=None):
            r = routing(p, c, xg, span)
            seen.append(r)
            return r

        M.routing = spy
        try:
            M.loss_fn(params, cfg, {"tokens": tokens, "labels": labels,
                                    "mask": mask})
        finally:
            M.routing = routing
        return ([r["idx"] for r in seen], [r["keep"] for r in seen])

    stacked = tree_map(lambda *ls: torch.stack(ls),
                       *[params_from_numpy(jp, "cpu") for jp in jps])
    tb = {k: torch.stack([torch.as_tensor(nb[k]) for nb in nbs])
          for k in ("tokens", "labels", "mask")}
    with torch.no_grad():
        idx, keep = torch.func.vmap(routed)(stacked, tb["tokens"],
                                            tb["labels"], tb["mask"])
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    G = min(cfg.moe_group_size, B * T)
    C = max(4, int(np.ceil(G * k / E * cfg.moe_capacity_factor)))
    for layer in range(cfg.n_layers):
        for s in range(2):
            ji = want_idx[s][layer]
            np.testing.assert_array_equal(idx[layer][s].numpy(), ji)
            flat = np.eye(E, dtype=np.float32)[ji].reshape(
                ji.shape[0], -1, E)
            pos = ((np.cumsum(flat, axis=1) - flat) * flat).sum(-1)
            np.testing.assert_array_equal(keep[layer][s].numpy(),
                                          (pos < C).astype(np.float32))
    # the two members route apart: merging their tokens would not give this
    assert not np.array_equal(want_idx[0][0], want_idx[1][0])


@pytest.mark.parametrize("arch", TRAINED)
def test_stacked_lowering_equals_per_model_autograd(arch):
    """Three members of different weights, each on its own masked batch:
    the stacked gradient of member s equals autograd of member s's own
    loss; the stacked metrics on a shared batch equal each model's."""
    jcfg, cfg = _cfgs(arch)
    task = lm_task(arch, device="cpu", **SMALL, **EXTRA.get(arch, {}))
    assert task.cfg == cfg
    trees = [params_from_numpy(_jparams(jcfg, s), "cpu") for s in range(3)]
    nbs = [_batch(cfg, 10 + s) for s in range(3)]
    stacked = tree_map(lambda *ls: torch.stack(ls), *trees)
    xb, yb, mb = (torch.stack([torch.as_tensor(nb[key]) for nb in nbs])
                  for key in ("tokens", "labels", "mask"))
    got = tree_flatten(stacked_grads_for(task)(stacked, xb, yb,
                                               mb[:, :, 0]))[0]
    for s, tree in enumerate(trees):
        batch = {k: torch.as_tensor(v) for k, v in nbs[s].items()}
        _, _, want = _port_value_and_grad(cfg, tree, batch)
        for g, w in zip(got, want):
            assert g.shape[1:] == w.shape
            torch.testing.assert_close(g[s], w, rtol=1e-6, atol=1e-6)
    shared = task._to_batch(nbs[0]["tokens"], nbs[0]["labels"])
    with torch.no_grad():
        ms = stacked_metrics_for(task)(stacked, shared)
        for s, tree in enumerate(trees):
            one = task.model.loss_fn(tree, shared)[1]
            assert sorted(ms) == sorted(one)
            for key in one:
                torch.testing.assert_close(ms[key][s], one[key], rtol=1e-6,
                                           atol=1e-6)
