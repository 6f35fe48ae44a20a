"""Hymba (hymba-1.5b): hybrid-head blocks. Attention and Mamba-style
selective-SSM heads run *in parallel* on the same input, their outputs
normalized and averaged (Hymba §2; meta-tokens omitted as in the
reference).

* attention branch: GQA with a sliding window, passed as ``mask`` (so
  ``use_flash`` drops it for S > window, as in the reference: ROADMAP C4)
* mamba branch: depthwise causal conv (width ``ssm_conv``), then a
  selective scan with data-dependent (Δ, B, C), diagonal A, skip D, silu
  gate
* decode state: KV cache + conv tail + SSM state (fp32).

The conv and the scan are plain PyTorch: the scan's per-step terms are
computed for the whole sequence at once and a Python loop over time runs
the recurrence (the reference's ``lax.scan``). The tree is the
reference's, keys sorted, ``a_log`` fp32 in a bf16 model.

Across ranks (``models.layers.tensor_parallel``; the reference's specs):
the mamba branch's d_inner is split over the group. ``in_proj`` is
column-parallel, a rank holding the same d_inner lanes of its ``xin`` and
``z`` halves (``sharding``'s world rule ``in_proj_halves``), so its
``conv``, ``dt_up``, ``a_log``, ``d_skip`` lanes, conv tail and SSM state
line up; ``dt_proj``, ``bc_proj`` and ``out_proj`` are row-parallel. The
sums of ``dt_proj`` and ``bc_proj`` enter every rank's own lanes again, so
each is summed forward (*g*) and its gradient summed backward (*f*,
:func:`_summed`). The attention splits by heads, or runs replicated where
the axis does not divide the query heads (the world rule
``attention_whole``); the MLP splits as ``layers.swiglu``. The norms and
the residual stream stay replicated; the embedding and the head are split
by vocab where the axis divides it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.device import resolve_device

DT_RANK = 64


def _dtype(cfg):
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def mamba_init(generator, cfg, device=None):
    dt = _dtype(cfg)
    d = cfg.d_model
    di = d                                   # d_inner = d_model
    N = cfg.ssm_state
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    p = {
        "in_proj": L.dense_init(generator, (d, 2 * di), dt, device=device),
        "conv": L.dense_init(generator, (cfg.ssm_conv, di), dt, scale=0.2,
                             device=device),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "dt_proj": L.dense_init(generator, (di, DT_RANK), dt, device=device),
        "dt_up": L.dense_init(generator, (DT_RANK, di), dt, device=device),
        "dt_bias": torch.full((di,), -4.6, dtype=dt, device=device),
        "bc_proj": L.dense_init(generator, (di, 2 * N), dt, device=device),
        "a_log": torch.log(a.repeat(di, 1)),
        "d_skip": torch.ones((di,), dtype=dt, device=device),
        "out_proj": L.dense_init(generator, (di, d), dt, device=device),
    }
    return dict(sorted(p.items()))


def block_init(generator, cfg, device=None):
    dt = _dtype(cfg)
    p = {
        "ln1": L.rms_norm_init(cfg.d_model, dt, device),
        "attn": L.attention_init(generator, cfg, dt, device=device),
        "mamba": mamba_init(generator, cfg, device),
        "attn_out_norm": L.rms_norm_init(cfg.d_model, dt, device),
        "mamba_out_norm": L.rms_norm_init(cfg.d_model, dt, device),
        "ln2": L.rms_norm_init(cfg.d_model, dt, device),
        "mlp": L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dt, device),
    }
    return dict(sorted(p.items()))


def init(generator, cfg, device=None):
    """Random parameters from ``generator`` (drawn on its device), placed on
    ``device`` (None = cuda)."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    embed = L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device)
    blocks = [block_init(generator, cfg, device) for _ in range(cfg.n_layers)]
    layers = L.stack_blocks(blocks)
    del blocks
    return {
        "embed": embed,
        "final_norm": L.rms_norm_init(cfg.d_model, dt, device),
        "layers": layers,
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab), dt,
                                device=device),
    }


# ---------------------------------------------------------------------------
# mamba branch
# ---------------------------------------------------------------------------


def _causal_conv(p, x, tail=None):
    """Depthwise causal conv. x: (B,T,di); tail: (B,W-1,di) carried state.
    Returns (y, new_tail)."""
    W = p["conv"].shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                     # (B, T+W-1, di)
    # windowed sum: y_t = sum_w conv[w] * x_{t-W+1+w}
    y = sum(xp[:, w:w + x.shape[1], :] * p["conv"][w][None, None, :]
            for w in range(W))
    new_tail = xp[:, -(W - 1):, :] if W > 1 else tail
    return y + p["conv_b"][None, None, :], new_tail


def _summed(y, split: bool):
    """A row-parallel product's partial output summed over the group (*g*),
    with *f* after it: the sum enters every rank's own d_inner lanes, so
    each rank's gradient of it is partial and is summed backward."""
    return L._copy_in(L._reduce_out(y, split), split)


def _ssm_scan(p, x, state, split: bool = False):
    """Selective scan. x: (B,T,di) post-conv; state: (B,di,N) fp32
    (``split``: this rank's d_inner lanes). Returns (y (B,T,di) fp32,
    final state)."""
    dtv = F.softplus(_summed(x @ p["dt_proj"], split) @ p["dt_up"]
                     + p["dt_bias"][None, None, :]).to(torch.float32)
    N = p["a_log"].shape[1]
    bc = _summed(x @ p["bc_proj"], split)
    Bm, Cm = bc[..., :N].to(torch.float32), bc[..., N:].to(torch.float32)
    A = -torch.exp(p["a_log"])                            # (di,N), negative
    xf = x.to(torch.float32)
    # every step's decay and input at once: (B,T,di,N)
    dA = torch.exp(dtv[..., None] * A[None, None])
    inp = (dtv * xf)[..., None] * Bm[:, :, None, :]
    ys = []
    for t in range(x.shape[1]):
        state = dA[:, t] * state + inp[:, t]
        ys.append(torch.einsum("bdn,bn->bd", state, Cm[:, t]))
    y = torch.stack(ys, dim=1)                            # (B,T,di)
    return y + p["d_skip"][None, None, :].to(torch.float32) * xf, state


def mamba_branch(p, x, mstate):
    """mstate: {'conv': (B,W-1,di), 'ssm': (B,di,N) fp32}, of this rank's
    d_inner lanes (d_inner = d_model: split where ``conv_b`` is
    narrower than ``x``)."""
    split = L.is_split(p["conv_b"].shape[0], x.shape[-1])
    xz = L._copy_in(x, split) @ p["in_proj"]
    di = xz.shape[-1] // 2
    xin, z = xz[..., :di], xz[..., di:]
    xc, conv_tail = _causal_conv(p, xin, mstate["conv"])
    xc = F.silu(xc)
    y, ssm = _ssm_scan(p, xc, mstate["ssm"], split)
    y = L._reduce_out((y.to(x.dtype) * F.silu(z)) @ p["out_proj"], split)
    return y, {"conv": conv_tail, "ssm": ssm}


# ---------------------------------------------------------------------------
# model interface
# ---------------------------------------------------------------------------


def _hybrid_block(p, cfg, x, positions, mask, mstate, decode_cache=None,
                  pos=None, valid=None):
    """One block -> (x, mstate, (k, v)): with ``decode_cache=(k, v)`` the
    attention is one decode step against it (written in place), else a
    prefill whose rotated keys and values are returned."""
    xn = L.rms_norm(p["ln1"], x, cfg.norm_eps)
    if decode_cache is None:
        a, kv = L.attention(p["attn"], xn, cfg, positions=positions,
                            mask=mask)
    else:
        ck, cv = decode_cache
        a, ck, cv = L.attention_decode_masked(p["attn"], xn, ck, cv, pos,
                                              cfg, valid)
        kv = (ck, cv)
    m, mstate = mamba_branch(p["mamba"], xn, mstate)
    fused = 0.5 * (L.rms_norm(p["attn_out_norm"], a, cfg.norm_eps)
                   + L.rms_norm(p["mamba_out_norm"], m, cfg.norm_eps))
    x = x + fused
    h = L.swiglu(p["mlp"], L.rms_norm(p["ln2"], x, cfg.norm_eps), cfg.d_ff)
    return x + h, mstate, kv


def _zero_mstates(cfg, B, device=None, di=None):
    """Zero conv tails and SSM states of ``B`` rows over ``di`` d_inner
    lanes (None: all, d_model; a rank holds its own)."""
    di, N, W = di or cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((cfg.n_layers, B, W - 1, di), dtype=_dtype(cfg),
                            device=device),
        "ssm": torch.zeros((cfg.n_layers, B, di, N), dtype=torch.float32,
                           device=device),
    }


def _stack(params, cfg, x, states, cache=None):
    """The layer stack over a prompt from the recurrent ``states``
    ({'conv', 'ssm'}, stacked by layer); with a ``cache``, each layer's
    keys and values go into its first S positions and its final conv tail
    and SSM state into ``cache['conv']``/``cache['ssm']`` (``states`` may
    be the cache itself: layer i reads its state before writing it)."""
    S = x.shape[1]
    mask = L.causal_mask(S, S, window=cfg.window, device=x.device)
    positions = torch.arange(S, device=x.device)
    for i in range(cfg.n_layers):
        x, mstate, (k, v) = T.apply_layer(
            _hybrid_block, params, i, cfg, x, positions, mask,
            {"conv": states["conv"][i], "ssm": states["ssm"][i]})
        if cache is not None:
            L.write_prefill(cache["k"][i], k)
            L.write_prefill(cache["v"][i], v)
            cache["conv"][i] = mstate["conv"]
            cache["ssm"][i] = mstate["ssm"]
    return L.rms_norm(params["final_norm"], x, cfg.norm_eps)


def loss_fn(params, cfg, batch):
    tokens, labels = batch["tokens"], batch["labels"]
    x = L.embed_lookup(L.param(params, "embed"), tokens, cfg.vocab)
    h = _stack(params, cfg, x, _zero_mstates(
        cfg, tokens.shape[0], x.device,
        di=params["layers"]["mamba"]["conv_b"].shape[-1]))
    loss = L.lm_xent(h, L.param(params, "lm_head"), labels, cfg.vocab,
                     batch.get("mask"))
    return loss, {"loss": loss}


def init_cache(cfg, batch_size, max_len, device=None):
    """KV cache of ``max_len`` positions (the reference computes the
    window-bounded length and allocates ``max_len``), conv tails and SSM
    states."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim()
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, hd)
    ms = _zero_mstates(cfg, batch_size, device)
    return {
        "k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
        "v": torch.zeros(shape, dtype=_dtype(cfg), device=device),
        "conv": ms["conv"],
        "ssm": ms["ssm"],
        "pos": 0,
    }


def prefill(params, cfg, batch, cache):
    tokens = batch["tokens"]
    x = L.embed_lookup(L.param(params, "embed"), tokens, cfg.vocab)
    h = _stack(params, cfg, x, cache, cache)     # layer i reads, then writes
    return (L.lm_logits(h[:, -1:], L.param(params, "lm_head"), cfg.vocab),
            dict(cache, pos=tokens.shape[1]))


def decode_step(params, cfg, token, cache):
    pos = cache["pos"]
    x = L.embed_lookup(L.param(params, "embed"), token, cfg.vocab)
    kpos = L.cache_positions(cache["k"])
    valid = kpos <= pos
    if cfg.window:
        valid &= (pos - kpos) < cfg.window
    for i in range(cfg.n_layers):
        x, mstate, _ = _hybrid_block(
            T._layer(params, i), cfg, x, None, None,
            {"conv": cache["conv"][i], "ssm": cache["ssm"][i]},
            decode_cache=(cache["k"][i], cache["v"][i]), pos=pos, valid=valid)
        cache["conv"][i] = mstate["conv"]
        cache["ssm"][i] = mstate["ssm"]
    h = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return (L.lm_logits(h, L.param(params, "lm_head"), cfg.vocab),
            dict(cache, pos=pos + 1))
