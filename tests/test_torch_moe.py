"""The PyTorch package's MoE family (qwen3-moe-30b-a3b, arctic-480b) and
architecture registry against the reference's, at the reduced configs.

Parameters come from the reference's ``init`` and are carried across with
``engine.flat.params_from_numpy``; inputs come from numpy seeds. The
reduced configs run in fp32: ``rtol = atol = 1e-4``, as
``test_torch_lm.py`` (XLA and PyTorch sum in other orders). The routing is
compared exactly first: the expert indices, each slot's place in its
expert's buffer and which slots are kept, since a flipped near-tie of two
router probabilities would move tokens between experts (none does at these
seeds); exact ties (a padding token's probabilities are all equal) go to
the lower expert first in both. A ``use_flash=True`` prefill runs the reference's Pallas kernel in
interpret mode and the port's plain version of its CUDA kernel.
"""

import dataclasses

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
from repro_torch.models import build
from repro_torch.models import moe as M
from repro_torch.utils.pytree import tree_flatten
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **kw):
    return (jconfigs.reduced(jconfigs.get_config(arch)).with_(**kw),
            configs.reduced(configs.get_config(arch)).with_(**kw))


def _params(jcfg, seed=0):
    jp = JM.init(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(want, np.float32), **(tol or TOL))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_and_reduced_configs_equal_reference():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert len(configs.ARCHS) == 12
    for name in configs.ARCHS:
        for cfg, jcfg in ((configs.get_config(name),
                           jconfigs.get_config(name)),
                          (configs.reduced(configs.get_config(name)),
                           jconfigs.reduced(jconfigs.get_config(name)))):
            assert (dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)), name
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_build_returns_a_model_for_every_family():
    families = set()
    for name in configs.ARCHS:
        cfg = configs.reduced(configs.get_config(name))
        model = build(cfg)
        assert model.cfg is cfg and callable(model.init)
        jmodel = jbuild(jconfigs.reduced(jconfigs.get_config(name)))
        for attr in ("prefill", "decode_step"):
            assert (getattr(model, attr) is None) == (
                getattr(jmodel, attr) is None), (name, attr)
        families.add(cfg.family)
    assert families == {"dense", "moe", "ssm", "hybrid", "audio", "vlm",
                        "cnn", "mf"}


# ---------------------------------------------------------------------------
# routing and the MoE FFN
# ---------------------------------------------------------------------------


def _jax_routing(router, xg, k):
    probs = jax.nn.softmax(jnp.asarray(xg) @ jnp.asarray(router), axis=-1)
    gates, idx = jax.lax.top_k(probs, k)
    return np.asarray(probs), np.asarray(gates), np.asarray(idx)


@pytest.mark.parametrize("E,k,G,d,seed", [
    (4, 2, 16, 256, 0),          # the reduced configs
    (128, 8, 256, 256, 1),       # qwen3's experts, top-k and group
])
def test_routing_indices_equal_reference_exactly(E, k, G, d, seed):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((3, G, d)).astype(np.float32)
    xg[-1, -5:] = 0.0            # padding tokens: every probability ties
    router = (rng.standard_normal((d, E)) * 0.02).astype(np.float32)
    cfg = configs.get_config("qwen3-moe-30b-a3b").with_(
        moe_num_experts=E, moe_top_k=k, d_model=d)
    r = M.routing({"router": torch.from_numpy(router)}, cfg,
                  torch.from_numpy(xg))
    probs, gates, idx = _jax_routing(router, xg, k)
    np.testing.assert_array_equal(r["idx"].numpy(), idx)
    gates = gates / np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    _close(r["gates"], gates)
    _close(r["probs"], probs)
    # each slot's place in its expert's buffer, from the indices alone
    flat = np.eye(E, dtype=np.float32)[idx].reshape(3, G * k, E)
    pos = ((np.cumsum(flat, axis=1) - flat) * flat).sum(-1)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    np.testing.assert_array_equal(r["keep"].numpy(),
                                  (pos < r["C"]).astype(np.float32))
    assert r["C"] == max(4, int(np.ceil(G * k / E * 1.25)))


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-moe-30b-a3b", dict()),
    ("qwen3-moe-30b-a3b", dict(moe_capacity_factor=0.5)),   # slots dropped
    ("arctic-480b", dict()),                                 # dense residual
])
def test_moe_ffn_matches_reference(arch, kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tl = {n: (t[0] if not isinstance(t, dict) else
              {m: u[0] for m, u in t.items()})
          for n, t in tp["layers"]["moe"].items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 41, cfg.d_model)).astype(np.float32)      # 82 tokens: 14 pads
    jout, jaux = JM.moe_ffn(jl, jcfg, jnp.asarray(x))
    tout, taux = M.moe_ffn(tl, cfg, torch.from_numpy(x))
    _close(tout, jout)
    _close(taux, jaux)
    xg = torch.nn.functional.pad(torch.from_numpy(x).reshape(82, -1),
                                 (0, 0, 0, 14)).reshape(6, 16, -1)
    dropped = 1 - float(M.routing(tl, cfg, xg)["keep"].mean())
    if "moe_capacity_factor" in kw:     # C = 4 of 32 slots a group
        assert dropped >= 0.5


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw,S", [
    ("qwen3-moe-30b-a3b", dict(use_flash=True), 128),
    ("qwen3-moe-30b-a3b", dict(), 24),
    ("arctic-480b", dict(), 24),
])
def test_reduced_moe_model_matches_reference(arch, kw, S):
    jcfg, cfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg)
    B = 2
    toks = _tokens(cfg, B, S, seed=S)
    jloss, jmet = JM.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(toks)})
    tloss, tmet = M.loss_fn(tp, cfg, {"tokens": torch.as_tensor(toks),
                                      "labels": torch.as_tensor(toks)})
    _close(tloss, jloss)
    _close(tmet["loss"], jmet["loss"])
    _close(tmet["aux_loss"], jmet["aux_loss"])

    jcache = JM.init_cache(jcfg, B, S + 8)
    tcache = M.init_cache(cfg, B, S + 8, "cpu")
    jlog, jcache = jax.jit(lambda p, b, c: JM.prefill(p, jcfg, b, c))(
        jp, {"tokens": jnp.asarray(toks)}, jcache)
    tlog, tcache = M.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                             tcache)
    assert tlog.shape == (B, 1, cfg.vocab) and tcache["pos"] == S
    _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])

    jdec = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    tok = np.asarray(jnp.argmax(jlog[:, -1:], -1))
    for _ in range(4):
        jlog, jcache = jdec(jp, jnp.asarray(tok, jnp.int32), jcache)
        tlog, tcache = M.decode_step(tp, cfg, torch.tensor(tok), tcache)
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog[:, -1:], -1))
    assert tcache["pos"] == int(jcache["pos"]) == S + 4
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_chunked_loss_matches_reference():
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b", xent_chunk=8)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg, 2, 24, seed=9)
    mask = np.random.default_rng(9).random((2, 24)) < 0.7
    jloss, _ = JM.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(toks[:, ::-1]),
                                     "mask": jnp.asarray(mask)})
    tloss, _ = M.loss_fn(tp, cfg, {"tokens": torch.as_tensor(toks),
                                   "labels": torch.as_tensor(
                                       toks[:, ::-1].copy()),
                                   "mask": torch.as_tensor(mask)})
    _close(tloss, jloss)


# ---------------------------------------------------------------------------
# carrying a bf16 tree with fp32 leaves
# ---------------------------------------------------------------------------


def test_bf16_tree_keeps_its_fp32_router():
    jcfg, cfg = _cfgs("arctic-480b", param_dtype="bfloat16")
    jp = JM.init(jax.random.key(5), jcfg)
    host = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(host, "cpu")
    jleaves, _ = jax.tree_util.tree_flatten_with_path(host)
    for path, a in jleaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == a.shape
        if path[-1].key == "router":
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
    # the port's own init has the same tree, shapes and dtypes
    mine = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    leaves, treedef = tree_flatten(mine)
    assert treedef == tree_flatten(tp)[1]
    assert [(tuple(t.shape), t.dtype) for t in leaves] == [
        (tuple(t.shape), t.dtype) for t in tree_flatten(tp)[0]]
