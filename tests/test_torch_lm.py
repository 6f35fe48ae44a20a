"""The PyTorch package's dense LM serving path against the reference's, at
the reduced configs: layers, whole models (loss, prefill logits and cache,
decode steps). The ``Server``, the launcher and the carrying of parameter
trees are in ``test_torch_serve.py``.

Parameters come from the reference's ``init`` and are carried across with
``engine.flat.params_from_numpy``; inputs come from numpy seeds. The
reduced configs run in fp32: ``rtol = atol = 1e-4`` (XLA and PyTorch sum in
other orders; the largest difference seen is 6e-6). The flash path on CPU
tensors is the kernel's plain version, held against the reference's Pallas
kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.engine.flat import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **kw):
    return (jconfigs.reduced(jconfigs.get_config(arch)).with_(**kw),
            configs.reduced(configs.get_config(arch)).with_(**kw))


def _params(jcfg, seed=0):
    jp = JT.init(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().numpy()),
                               np.asarray(want), **(tol or TOL))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norm_rope_swiglu_match_reference():
    jcfg, cfg = _cfgs("tinyllama-1.1b")
    jp, tp = _params(jcfg)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = {k: {n: t[0] for n, t in v.items()} for k, v in tp["layers"].items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1
    _close(L.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    heads = x.reshape(2, 24, 8, 32)
    for pos in (np.arange(24), np.full((2, 1), 1000)):
        h = heads[:, :pos.shape[-1]]
        _close(L.rope(torch.from_numpy(h), torch.from_numpy(pos), 10_000.0),
               JL.rope(jnp.asarray(h), jnp.asarray(pos), 10_000.0))
    _close(L.swiglu(tl["mlp"], torch.from_numpy(x)),
           JL.swiglu(jl["mlp"], jnp.asarray(x)))


@pytest.mark.parametrize("variant", [
    dict(use_flash=True), dict(use_flash=False), dict(window=48),
    dict(attn_softcap=20.0), dict(use_flash=True, n_kv_heads=2),
])
def test_attention_and_decode_match_reference(variant):
    jcfg, cfg = _cfgs("tinyllama-1.1b", **variant)
    jp, tp = _params(jcfg)
    ja, ta = (jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
              {n: t[0] for n, t in tp["layers"]["attn"].items()})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    window = variant.get("window", 0)
    _close(L.attention(ta, torch.from_numpy(x), cfg, window=window)[0],
           JL.attention(ja, jnp.asarray(x), jcfg, window=window))

    T_, pos, hd = 40, 29, cfg.resolved_head_dim()
    ck = rng.standard_normal((2, T_, cfg.n_kv_heads, hd)).astype(np.float32)
    cv = rng.standard_normal((2, T_, cfg.n_kv_heads, hd)).astype(np.float32)
    x1 = x[:, :1]
    jout, jk, jv = JL.attention_decode(ja, jnp.asarray(x1), jnp.asarray(ck),
                                       jnp.asarray(cv), pos, jcfg,
                                       window=window)
    tout, tk, tv = L.attention_decode(ta, torch.from_numpy(x1),
                                      torch.from_numpy(ck.copy()),
                                      torch.from_numpy(cv.copy()), pos, cfg,
                                      window=window)
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw,S", [
    ("tinyllama-1.1b", dict(use_flash=True), 128),
    ("tinyllama-1.1b", dict(use_flash=True), 256),
    ("tinyllama-1.1b", dict(use_flash=True, n_kv_heads=2), 128),
    ("tinyllama-1.1b", dict(), 24),
    ("gemma2-27b", dict(), 24),
    ("starcoder2-15b", dict(), 24),
])
def test_reduced_model_matches_reference(arch, kw, S):
    jcfg, cfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg)
    B = 2
    toks = _tokens(cfg, B, S, seed=S)
    jloss, _ = JT.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(toks)})
    tloss, _ = T.loss_fn(tp, cfg, {"tokens": torch.as_tensor(toks),
                                   "labels": torch.as_tensor(toks)})
    _close(tloss, jloss)

    jcache = JT.init_cache(jcfg, B, S + 8)
    tcache = T.init_cache(cfg, B, S + 8, "cpu")
    jlog, jcache = jax.jit(lambda p, b, c: JT.prefill(p, jcfg, b, c))(
        jp, {"tokens": jnp.asarray(toks)}, jcache)
    tlog, tcache = T.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                             tcache)
    assert tlog.shape == (B, 1, cfg.vocab) and tcache["pos"] == S
    _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])

    jdec = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    tok = np.asarray(jnp.argmax(jlog[:, -1:], -1))
    for _ in range(4):
        jlog, jcache = jdec(jp, jnp.asarray(tok, jnp.int32), jcache)
        tlog, tcache = T.decode_step(tp, cfg, torch.tensor(tok), tcache)
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog[:, -1:], -1))
    assert tcache["pos"] == int(jcache["pos"]) == S + 4
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-27b"])
def test_chunked_loss_matches_reference(arch):
    """``xent_chunk``: the sequence-chunked loss, with an untied head and
    with gemma2's tied, soft-capped one, under a token mask."""
    jcfg, cfg = _cfgs(arch, xent_chunk=8)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg, 2, 24, seed=9)
    mask = np.random.default_rng(9).random((2, 24)) < 0.7
    jloss, _ = JT.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(toks[:, ::-1]),
                                     "mask": jnp.asarray(mask)})
    tloss, _ = T.loss_fn(tp, cfg, {"tokens": torch.as_tensor(toks),
                                   "labels": torch.as_tensor(
                                       toks[:, ::-1].copy()),
                                   "mask": torch.as_tensor(mask)})
    _close(tloss, jloss)


def test_flash_prefill_equals_plain_prefill():
    """Within the port: the flash branch and the plain attention give the
    same prefill (on CPU tensors the flash wrapper takes its plain
    version, so this holds the dispatch and layouts, not the kernel)."""
    _, cfg = _cfgs("tinyllama-1.1b", n_kv_heads=2)
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(_tokens(cfg, 2, 256, seed=5))
    outs = []
    for flash in (True, False):
        c = cfg.with_(use_flash=flash)
        outs.append(T.prefill(params, c, {"tokens": toks},
                              T.init_cache(c, 2, 260, "cpu")))
    (lf, cf), (lp, cp) = outs
    torch.testing.assert_close(lf, lp, rtol=3e-5, atol=3e-5)
    assert torch.equal(cf["k"], cp["k"]) and torch.equal(cf["v"], cp["v"])
