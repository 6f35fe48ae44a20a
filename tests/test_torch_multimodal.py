"""The PyTorch package's multimodal families, Whisper (``audio``) and
LLaVA-NeXT (``vlm``), against the reference's, at the reduced configs:
whole models (loss, prefill logits, the cache with Whisper's cross-
attention keys and values of the encoder states, decode steps), and the
serving launcher with the stubbed frontends' inputs (``frames``,
``image_embeds``).

Parameters come from the reference's ``init`` and are carried across with
``engine.flat.params_from_numpy``; inputs come from numpy seeds. The
reduced configs run in fp32: ``rtol = atol = 1e-4``, as
``test_torch_lm.py`` (XLA and PyTorch sum in other orders). A
``use_flash=True`` prefill runs the reference's Pallas kernel in interpret
mode and the port's plain version of its CUDA kernel: Whisper's decoder
self-attention and LLaVA's backbone over [image ‖ text] take the flash
branch; the encoder and the cross-attention do not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import llava as JV
from repro.models import whisper as JW
from repro_torch import configs
from repro_torch.engine.flat import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve
from repro_torch.models import llava as V
from repro_torch.models import whisper as W
from repro_torch.utils.pytree import tree_flatten
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
MODULES = {"whisper-large-v3": (JW, W), "llava-next-mistral-7b": (JV, V)}


def _cfgs(arch, **kw):
    return (jconfigs.reduced(jconfigs.get_config(arch)).with_(**kw),
            configs.reduced(configs.get_config(arch)).with_(**kw))


def _params(jm, jcfg, seed=0):
    jp = jm.init(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(want, np.float32), **(tol or TOL))


def _batch(cfg, B, S, seed):
    """Tokens and the family's stubbed frontend input, numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "audio":
        batch["frames"] = (rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)) * 0.1).astype(np.float32)
    else:
        batch["image_embeds"] = (rng.standard_normal(
            (B, V.n_image_tokens(cfg), cfg.d_model)) * 0.1).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw,S", [
    ("whisper-large-v3", dict(use_flash=True), 128),
    ("llava-next-mistral-7b", dict(use_flash=True), 112),   # 16 + 112 = 128
    ("llava-next-mistral-7b", dict(), 80),       # 96 positions, window 64
])
def test_reduced_model_matches_reference(arch, kw, S):
    jm, tm = MODULES[arch]
    jcfg, cfg = _cfgs(arch, **kw)
    jp, tp = _params(jm, jcfg)
    B = 2
    nb = _batch(cfg, B, S, seed=S)
    mask = np.random.default_rng(S).random((B, S)) < 0.8
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.as_tensor(v) for k, v in nb.items()}
    jloss, _ = jm.loss_fn(jp, jcfg, dict(jb, labels=jb["tokens"][:, ::-1],
                                         mask=jnp.asarray(mask)))
    tloss, _ = tm.loss_fn(tp, cfg, dict(tb, labels=tb["tokens"].flip(1),
                                        mask=torch.as_tensor(mask)))
    _close(tloss, jloss)

    n_img = V.n_image_tokens(cfg) if cfg.family == "vlm" else 0
    jcache = jm.init_cache(jcfg, B, n_img + S + 8)
    tcache = tm.init_cache(cfg, B, n_img + S + 8, "cpu")
    jlog, jcache = jax.jit(lambda p, b, c: jm.prefill(p, jcfg, b, c))(
        jp, jb, jcache)
    tlog, tcache = tm.prefill(tp, cfg, tb, tcache)
    assert tlog.shape == (B, 1, cfg.vocab)
    assert tcache["pos"] == int(jcache["pos"]) == n_img + S
    _close(tlog, jlog)
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        if key != "pos":
            _close(tcache[key], jcache[key])

    jdec = jax.jit(lambda p, t, c: jm.decode_step(p, jcfg, t, c))
    tok = np.asarray(jnp.argmax(jlog[:, -1:], -1))
    for _ in range(4):
        jlog, jcache = jdec(jp, jnp.asarray(tok, jnp.int32), jcache)
        tlog, tcache = tm.decode_step(tp, cfg, torch.tensor(tok), tcache)
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog[:, -1:], -1))
    assert tcache["pos"] == int(jcache["pos"]) == n_img + S + 4
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_port_init_has_the_reference_tree():
    for arch, (jm, tm) in MODULES.items():
        jcfg, cfg = _cfgs(arch, param_dtype="bfloat16")
        want = params_from_numpy(jax.tree.map(
            np.asarray, jm.init(jax.random.key(0), jcfg)), "cpu")
        mine = tm.init(torch.Generator().manual_seed(0), cfg, "cpu")
        assert tree_flatten(mine)[1] == tree_flatten(want)[1], arch
        assert [(tuple(t.shape), t.dtype) for t in tree_flatten(mine)[0]] \
            == [(tuple(t.shape), t.dtype) for t in tree_flatten(want)[0]]


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-mistral-7b"])
def test_serve_launcher_serves_the_multimodal_archs(arch, capsys):
    """The launcher draws the family's frontend input and, for the vlm,
    makes room in the cache for the image positions (16 here, more than
    its 8 spare slots)."""
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "16",
            "--new-tokens", "12", "--device", "cpu", "--seed", "4"]
    out = serve.main(argv)
    cfg = configs.reduced(configs.get_config(arch))
    assert out["arch"] == arch and out["tokens"].shape == (2, 12)
    assert ((0 <= out["tokens"]) & (out["tokens"] < cfg.vocab)).all()
    assert f"[serve] arch={arch} device=cpu" in capsys.readouterr().out
    np.testing.assert_array_equal(serve.main(argv)["tokens"], out["tokens"])
    assert flash_attention.launches == 0


def test_decode_past_the_cache_raises():
    """A cache too short for the image positions and the new tokens: the
    port raises where the reference's clamped write overwrites the last
    slot (ROADMAP C10)."""
    _, cfg = _cfgs("llava-next-mistral-7b")
    params = V.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 1, 8, 0).items()}
    _, cache = V.prefill(params, cfg, batch, V.init_cache(cfg, 1, 25, "cpu"))
    tok = torch.zeros((1, 1), dtype=torch.long)
    _, cache = V.decode_step(params, cfg, tok, cache)       # position 24
    with pytest.raises(IndexError, match="position 25"):
        V.decode_step(params, cfg, tok, cache)
