"""The PyTorch package's recurrent families, RWKV-6 (``ssm``) and Hymba
(``hybrid``), against the reference's, at the reduced configs: the layer
norm and the WKV6 scan, whole models (loss, prefill logits, cache or
recurrent state, decode steps: Hymba's conv tail and selective scan carry
their state from the prefill), and decode after S tokens against a prefill
over S+1.

Parameters come from the reference's ``init`` and are carried across with
``engine.flat.params_from_numpy``; inputs come from numpy seeds. The
reduced configs run in fp32: ``rtol = atol = 1e-4``, as
``test_torch_lm.py`` (XLA and PyTorch sum in other orders; the recurrences
run the same steps in the same order). ``F.softplus`` returns x itself
above 20 where ``jax.nn.softplus`` computes log1p(exp(x)); the two differ
there by less than 2e-9, far inside the tolerance. A ``use_flash=True``
prefill runs the reference's Pallas kernel in interpret mode and the
port's plain version of its CUDA kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import hymba as JH
from repro.models import layers as JL
from repro.models import rwkv as JR
from repro_torch import configs
from repro_torch.engine.flat import params_from_numpy
from repro_torch.models import hymba as H
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.utils.pytree import tree_flatten
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
MODULES = {"rwkv6-1.6b": (JR, R), "hymba-1.5b": (JH, H)}


def _cfgs(arch, **kw):
    return (jconfigs.reduced(jconfigs.get_config(arch)).with_(**kw),
            configs.reduced(configs.get_config(arch)).with_(**kw))


def _params(jm, jcfg, seed=0):
    jp = jm.init(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(want, np.float32), **(tol or TOL))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _same_cache(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    assert tcache["pos"] == int(jcache["pos"])
    for key in jcache:
        if key != "pos":
            assert tuple(tcache[key].shape) == jcache[key].shape, key
            _close(tcache[key], jcache[key])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 7, 96)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(96).astype(np.float32),
         "bias": rng.standard_normal(96).astype(np.float32)}
    want = JL.layer_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(L.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x)), want)
    init = L.layer_norm_init(96, torch.float32)
    jinit = JL.layer_norm_init(96, jnp.float32)
    assert list(init) == sorted(jinit)
    for k in init:
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit[k]))


def test_wkv_scan_matches_reference():
    """The WKV6 scan from a state that is not zero."""
    rng = np.random.default_rng(1)
    B, T, Hh, hd = 2, 9, 3, 8
    r, k, v = (rng.standard_normal((B, T, Hh, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 0.99, (B, T, Hh, hd)).astype(np.float32)
    u = rng.standard_normal((Hh, hd)).astype(np.float32)
    S0 = rng.standard_normal((B, Hh, hd, hd)).astype(np.float32)
    jout, jS = JR.wkv_scan(*map(jnp.asarray, (r, k, v, w, u, S0)))
    tout, tS = R.wkv_scan(*map(torch.from_numpy, (r, k, v, w, u, S0)))
    _close(tout, jout)
    _close(tS, jS)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw,S", [
    ("rwkv6-1.6b", dict(), 24),
    ("hymba-1.5b", dict(use_flash=True), 128),
    ("hymba-1.5b", dict(), 96),            # past the reduced window of 64
])
def test_reduced_model_matches_reference(arch, kw, S):
    jm, tm = MODULES[arch]
    jcfg, cfg = _cfgs(arch, **kw)
    jp, tp = _params(jm, jcfg)
    B = 2
    toks = _tokens(cfg, B, S, seed=S)
    jloss, _ = jm.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(toks)})
    tloss, _ = tm.loss_fn(tp, cfg, {"tokens": torch.as_tensor(toks),
                                    "labels": torch.as_tensor(toks)})
    _close(tloss, jloss)

    jcache = jm.init_cache(jcfg, B, S + 8)
    tcache = tm.init_cache(cfg, B, S + 8, "cpu")
    jlog, jcache = jax.jit(lambda p, b, c: jm.prefill(p, jcfg, b, c))(
        jp, {"tokens": jnp.asarray(toks)}, jcache)
    tlog, tcache = tm.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                              tcache)
    assert tlog.shape == (B, 1, cfg.vocab) and tcache["pos"] == S
    _close(tlog, jlog)
    _same_cache(tcache, jcache)

    jdec = jax.jit(lambda p, t, c: jm.decode_step(p, jcfg, t, c))
    tok = np.asarray(jnp.argmax(jlog[:, -1:], -1))
    for _ in range(4):
        jlog, jcache = jdec(jp, jnp.asarray(tok, jnp.int32), jcache)
        tlog, tcache = tm.decode_step(tp, cfg, torch.tensor(tok), tcache)
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog[:, -1:], -1))
    assert tcache["pos"] == S + 4
    _same_cache(tcache, jcache)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_decode_after_prefill_equals_a_longer_prefill(arch):
    """Within the port: the recurrent state (and KV cache) after S tokens,
    advanced by one decode step, gives the last logits of a prefill over
    the S+1 tokens."""
    jm, tm = MODULES[arch]
    _, cfg = _cfgs(arch)
    params = tm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(_tokens(cfg, 2, 41, seed=4))
    _, cache = tm.prefill(params, cfg, {"tokens": toks[:, :40]},
                          tm.init_cache(cfg, 2, 48, "cpu"))
    step, _ = tm.decode_step(params, cfg, toks[:, 40:], cache)
    whole, _ = tm.prefill(params, cfg, {"tokens": toks},
                          tm.init_cache(cfg, 2, 48, "cpu"))
    torch.testing.assert_close(step, whole, rtol=1e-5, atol=1e-5)


def test_bf16_tree_keeps_its_fp32_a_log():
    jcfg, cfg = _cfgs("hymba-1.5b", param_dtype="bfloat16")
    jp = JH.init(jax.random.key(5), jcfg)
    host = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(host, "cpu")
    jleaves, _ = jax.tree_util.tree_flatten_with_path(host)
    for path, a in jleaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == a.shape
        if path[-1].key == "a_log":
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
    for jm, tm, arch in ((JH, H, "hymba-1.5b"), (JR, R, "rwkv6-1.6b")):
        jcfg, cfg = _cfgs(arch, param_dtype="bfloat16")
        want = params_from_numpy(jax.tree.map(
            np.asarray, jm.init(jax.random.key(0), jcfg)), "cpu")
        mine = tm.init(torch.Generator().manual_seed(0), cfg, "cpu")
        assert tree_flatten(mine)[1] == tree_flatten(want)[1]
        assert [(tuple(t.shape), t.dtype) for t in tree_flatten(mine)[0]] \
            == [(tuple(t.shape), t.dtype) for t in tree_flatten(want)[0]]
        # the a_log leaf has no randomness: the reference's, to one ulp of
        # the two libraries' logarithms
        if arch == "hymba-1.5b":
            np.testing.assert_array_max_ulp(
                mine["layers"]["mamba"]["a_log"].numpy(),
                want["layers"]["mamba"]["a_log"].numpy(), maxulp=1)
