"""The decode over a cache split by sequence (``layers.seq_split``), held
against one process's, without a world.

A rank of ``n`` holds the positions ``[r T/n, (r+1) T/n)`` of the cache;
its decode computes fp32 partials (row max, sum of exponentials, weighted
values) over them, gathers every rank's over the chunk's axis and combines
them in rank order. Here the ranks run one after another in one process:
``collectives.all_gather`` is replaced by a recorder, a first pass records
each rank's partials and a second hands every rank all of them, in rank
order, as the gather would. Each rank's output must equal one process's
``attention_decode_masked`` / ``cross_attention_decode`` (and the
reference's ``attention_decode``) within 1e-5, every rank must give the
same bits, and each rank's cache must be its slice of one process's after
the write. Covered: GQA groups, a window and gemma2's local and global
layers with its soft-cap, decode positions in the first, a middle and the
last chunk, chunks with no valid position, 1 to 4 chunks, and a T that the
axis does not divide (the cache stays whole and the decode runs locally).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import collectives, configs
from repro_torch.config import MeshConfig
from repro_torch.engine.flat import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.sharding import ShardingPolicy
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
T_, B = 32, 2


def _cfgs(arch, **kw):
    return (jconfigs.reduced(jconfigs.get_config(arch)).with_(**kw),
            configs.reduced(configs.get_config(arch)).with_(**kw))


def _attn(arch, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jp = jax.tree.map(np.asarray, JT.init(jax.random.key(0), jcfg))
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    return jcfg, cfg, ja, params_from_numpy(ja, "cpu")


def _ranks(n, run, axis="data"):
    """``[run(r) for r in range(n)]``, each under ``seq_split`` of the
    cache ``k`` and ``xk`` over a stand-in mesh of ``n`` ranks on
    ``axis``, its one ``all_gather`` answered by every rank's tensor: a
    first pass records them, a second returns them in rank order."""
    parts = {}
    real = collectives.all_gather

    def mesh(r):
        return types.SimpleNamespace(
            in_world=True, group=lambda a: "chunks",
            axis_index=lambda a: r, axis_size=lambda a: n)

    def passes(r, gather):
        collectives.all_gather = gather
        try:
            with L.seq_split(mesh(r), {"k": axis, "xk": axis}):
                return run(r)
        finally:
            collectives.all_gather = real

    for r in range(n):
        def record(t, group, dim=0, r=r):
            assert group == "chunks"
            parts[r] = t.clone()
            return torch.cat([t] * n, dim=dim)
        passes(r, record)
    outs = []
    for r in range(n):
        def answer(t, group, dim=0, r=r):
            assert torch.equal(t, parts[r])
            return torch.cat([parts[i] for i in range(n)], dim=dim)
        outs.append(passes(r, answer))
    return outs


def _valid(pos, window=0):
    kpos = np.arange(T_)
    v = kpos <= pos
    if window:
        v &= (pos - kpos) < window
    return v


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(want, np.float32), **TOL)


CASES = [
    # (arch, overrides, window, n, pos)
    ("tinyllama-1.1b", dict(n_kv_heads=2), 0, 2, 5),       # first chunk
    ("tinyllama-1.1b", dict(n_kv_heads=2), 0, 4, 13),      # a middle one
    ("tinyllama-1.1b", dict(n_kv_heads=1), 0, 4, 31),      # the last one
    ("tinyllama-1.1b", dict(), 0, 1, 9),
    ("tinyllama-1.1b", dict(n_kv_heads=1), 6, 4, 27),      # early ones empty
    ("tinyllama-1.1b", dict(n_kv_heads=2), 6, 2, 17),
    ("llava-next-mistral-7b", dict(window=8), 8, 4, 22),
    ("gemma2-27b", dict(), 64, 4, 20),                      # local layer
    ("gemma2-27b", dict(window=4), 4, 2, 24),              # local, capped
    ("gemma2-27b", dict(), 0, 4, 30),                       # global layer
    ("gemma2-27b", dict(n_kv_heads=2), 0, 3, 2),            # T % 3 != 0
]


@pytest.mark.parametrize("arch,kw,window,n,pos", CASES)
def test_chunked_decode_equals_one_process(arch, kw, window, n, pos):
    jcfg, cfg, ja, ta = _attn(arch, **kw)
    hd, KV = cfg.resolved_head_dim(), cfg.n_kv_heads
    rng = np.random.default_rng(pos + 7 * n)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, T_, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, T_, KV, hd)).astype(np.float32)
    valid = torch.from_numpy(_valid(pos, window))
    one_k, one_v = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    one, _, _ = L.attention_decode_masked(ta, torch.from_numpy(x), one_k,
                                          one_v, pos, cfg, valid)
    jout, jk, _ = JL.attention_decode(ja, jnp.asarray(x), jnp.asarray(ck),
                                      jnp.asarray(cv), pos, jcfg,
                                      window=window)
    _close(one, jout)
    if T_ % n:
        # the spec keeps a cache the axis does not divide whole: no chunk
        policy = ShardingPolicy(cfg, MeshConfig(data=n, model=1))
        spec = policy.cache_spec({"k": torch.empty((1, B, T_, KV, hd),
                                                   device="meta")},
                                 shard_seq=True, world=True)
        assert ShardingPolicy.seq_axis(spec) is None
        n = 1
    Tl = T_ // n
    caches = [(torch.from_numpy(ck[:, r * Tl:(r + 1) * Tl].copy()),
               torch.from_numpy(cv[:, r * Tl:(r + 1) * Tl].copy()))
              for r in range(n)]

    def rank(r):
        k, v = (c.clone() for c in caches[r])
        out, k, v = L.attention_decode_masked(ta, torch.from_numpy(x), k, v,
                                              pos, cfg, valid)
        return out, k, v

    outs = _ranks(n, rank)
    for r, (out, k, v) in enumerate(outs):
        _close(out, one)
        assert torch.equal(out, outs[0][0])          # every rank's bits
        assert torch.equal(k, one_k[:, r * Tl:(r + 1) * Tl])
        assert torch.equal(v, one_v[:, r * Tl:(r + 1) * Tl])
    _close(outs[pos // Tl][1], jk[:, pos // Tl * Tl:(pos // Tl + 1) * Tl])
    with pytest.raises(IndexError):
        _ranks(n, lambda r: L.attention_decode_masked(
            ta, torch.from_numpy(x), *caches[r], T_, cfg,
            torch.ones(T_, dtype=torch.bool)))


@pytest.mark.parametrize("n,kv", [(1, 4), (2, 4), (4, 2), (4, 1)])
def test_chunked_cross_decode_equals_one_process(n, kv):
    """Whisper's cross cache split by frames: every position valid."""
    _, cfg, _, ta = _attn("whisper-large-v3", n_kv_heads=kv)
    hd = cfg.resolved_head_dim()
    rng = np.random.default_rng(n + kv)
    Fr = 16
    x = torch.from_numpy(rng.standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    xk = torch.from_numpy(rng.standard_normal(
        (B, Fr, kv, hd)).astype(np.float32))
    xv = torch.from_numpy(rng.standard_normal(
        (B, Fr, kv, hd)).astype(np.float32))
    one = L.cross_attention_decode(ta, x, xk, xv, cfg)
    Fl = Fr // n
    outs = _ranks(n, lambda r: L.cross_attention_decode(
        ta, x, xk[:, r * Fl:(r + 1) * Fl], xv[:, r * Fl:(r + 1) * Fl], cfg))
    for out in outs:
        _close(out, one.numpy())
        assert torch.equal(out, outs[0])


def test_partials_with_an_empty_chunk_add_nothing():
    """``combine_partials`` of a rank whose chunk holds no valid position
    (row max the mask's -1e30, no weight): the other ranks' result, and
    a rank of all -1e30 scores does not win the row max."""
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.standard_normal((1, 1, 2, 2, 8)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 8, 2, 4)).astype(
        np.float32))
    want = torch.einsum("bskgt,btkh->bskgh", torch.softmax(s, dim=-1), v)

    def part(scores, vals, valid):
        m = torch.amax(scores, dim=-1, keepdim=True)
        e = torch.exp(scores - m) * valid.to(torch.float32)
        return torch.cat([m, e.sum(-1, keepdim=True), torch.einsum(
            "bskgt,btkh->bskgh", e, vals)], dim=-1)

    empty = part(torch.full_like(s, -1e30), v, torch.zeros(8, dtype=bool))
    whole = part(s, v, torch.ones(8, dtype=bool))
    real = collectives.all_gather
    collectives.all_gather = lambda t, group, dim=0: torch.cat(
        [empty[None], whole[None], empty[None]], dim=dim)
    try:
        got = L.combine_partials(whole, None)
    finally:
        collectives.all_gather = real
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_prefill_writes_only_the_ranks_chunk():
    src = torch.arange(2 * 10 * 3 * 4, dtype=torch.float32).reshape(
        2, 10, 3, 4)

    def rank(r):
        dst = torch.full((2, 4, 3, 4), -1.0)
        L.write_prefill(dst, src)
        pos = L.cache_positions(dst[None])
        return dst, pos

    got = _ranks(4, rank)
    for r, (dst, pos) in enumerate(got):
        assert torch.equal(pos, torch.arange(16))
        lo, hi = 4 * r, min(4 * r + 4, 10)
        if hi > lo:
            assert torch.equal(dst[:, :hi - lo], src[:, lo:hi])
        assert bool((dst[:, max(hi - lo, 0):] == -1).all())
    with pytest.raises(IndexError):
        _ranks(2, lambda r: L.write_prefill(torch.zeros((2, 4, 3, 4)), src))
