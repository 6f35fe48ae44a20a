"""Shared layers: init helpers, norms, RoPE, GQA attention (prefill and
cached decode, sliding-window and soft-cap variants), gated MLPs and the
cross entropies.

Conventions, as in the reference:
* params are dicts of tensors; the model modules stack them along a leading
  layer axis.
* activations compute in bfloat16 when params are bf16, with fp32 scores,
  softmax and loss; the reduced smoke configs run fully in fp32.
* attention masks: ``causal`` plus an optional ``window`` (key within the
  last W positions); gemma2's ``local_global_alt`` alternates window/full by
  layer parity (even layers local).
* random init draws from a ``torch.Generator`` on the generator's device
  and then moves, so one seed gives the same weights on every device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention_bshd


def _is_meta(device) -> bool:
    """An init on the ``meta`` device gives shapes and dtypes only: it
    draws nothing (a layout needs no weights)."""
    return device is not None and torch.device(device).type == "meta"


def dense_init(generator, shape, dtype, scale: Optional[float] = None,
               device=None):
    """Normal(0, scale²) weights, ``scale`` defaulting to fan_in^-1/2.
    Drawn from ``generator`` (on the generator's device) and then moved,
    so the same seed gives the same weights on every device; on ``meta``
    nothing is drawn."""
    if _is_meta(device):
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return w.to(dtype=dtype, device=device)


def embed_init(generator, vocab, d, dtype, device=None):
    if _is_meta(device):
        return torch.empty((vocab, d), dtype=dtype, device="meta")
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=generator.device) * 0.02
    return w.to(dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm_init(d, dtype, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}  # (1+scale)


def rms_norm(p, x, eps=1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freq / half)                          # (half,)
    ang = positions[..., None].to(torch.float32) * inv     # (..., S, half)
    ang = ang[..., None, :]                                # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_init(generator, cfg, dtype, d_in: Optional[int] = None,
                   device=None):
    d = d_in or cfg.d_model
    hd = cfg.resolved_head_dim()
    return {
        "wq": dense_init(generator, (d, cfg.n_heads * hd), dtype, device=device),
        "wk": dense_init(generator, (d, cfg.n_kv_heads * hd), dtype,
                         device=device),
        "wv": dense_init(generator, (d, cfg.n_kv_heads * hd), dtype,
                         device=device),
        "wo": dense_init(generator, (cfg.n_heads * hd, d), dtype, device=device),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _gqa_scores(q, k, n_kv: int):
    """q: (B,S,H,hd), k: (B,T,KV,hd) -> scores (B,S,KV,G,T), fp32."""
    B, S, H, hd = q.shape
    g = H // n_kv
    qg = q.reshape(B, S, n_kv, g, hd)
    return torch.einsum("bskgh,btkh->bskgt", qg.to(torch.float32),
                        k.to(torch.float32)) * (hd ** -0.5)


def _gqa_out(probs, v, H: int):
    """probs: (B,S,KV,G,T), v: (B,T,KV,hd) -> (B,S,H*hd)."""
    out = torch.einsum("bskgt,btkh->bskgh", probs, v.to(torch.float32))
    B, S = out.shape[:2]
    return out.reshape(B, S, H * v.shape[-1])


def causal_mask(S: int, T: int, *, offset: int = 0, window: int = 0,
                device=None):
    """(S,T) bool mask; query position i attends key j iff j <= i+offset and
    (no window or i+offset-j < window)."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= (qpos - kpos) < window
    return m


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def attention(p, x, cfg, *, window: int = 0, positions=None,
              kv_override=None, mask=None):
    """Full (train/prefill) self- or cross-attention.

    ``kv_override=(k_in, v_in)`` switches to cross-attention over encoder
    states. ``mask`` overrides the causal mask (None + kv_override = full
    visibility). With ``cfg.use_flash`` and a plain-causal setup (no
    window/softcap) at ``S % 128 == 0`` — the reference's dispatch, kept
    verbatim so the kernel runs exactly where the reference's does — the
    causal flash kernel computes it, reading the (B,S,H,hd) projections
    through strides. Returns ``(out, (k, v))``: the keys, rotated, and the
    values, (B,S,KV,hd), are what a prefill writes into its cache (the
    reference returns ``out`` alone and its prefill projects them again).
    """
    B, S, d = x.shape
    hd = cfg.resolved_head_dim()
    q = _split_heads(x @ p["wq"], cfg.n_heads, hd)
    if kv_override is None:
        k = _split_heads(x @ p["wk"], cfg.n_kv_heads, hd)
        v = _split_heads(x @ p["wv"], cfg.n_kv_heads, hd)
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if (cfg.use_flash and not cfg.attn_softcap and not window
                and not cfg.local_global_alt and S % 128 == 0):
            out = flash_attention_bshd(q, k, v, causal=True)
            out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
            return out, (k, v)
        if mask is None:
            mask = causal_mask(S, S, window=window, device=x.device)
    else:
        enc = kv_override
        k = _split_heads(enc @ p["wk"], cfg.n_kv_heads, hd)
        v = _split_heads(enc @ p["wv"], cfg.n_kv_heads, hd)
    scores = _gqa_scores(q, k, cfg.n_kv_heads)
    scores = softcap(scores, cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask[None, :, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, v, cfg.n_heads).to(x.dtype) @ p["wo"]
    return out, (k, v)


def attention_decode(p, x, cache_k, cache_v, pos: int, cfg, *,
                     window: int = 0):
    """One-token decode against a KV cache.

    x: (B,1,d); cache_k/v: (B,T,KV,hd); pos: int — number of tokens
    already in the cache (a host integer: a device scalar would make every
    step synchronise to index the cache). The new key and value are written
    into the caches in place (the reference's serving loop donates its
    cache). Returns (out (B,1,d), cache_k, cache_v).
    """
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    valid = kpos <= pos
    if window:
        valid &= (pos - kpos) < window
    return attention_decode_masked(p, x, cache_k, cache_v, pos, cfg, valid)


def attention_decode_masked(p, x, cache_k, cache_v, pos: int, cfg, valid):
    """:func:`attention_decode` with the validity vector over the cache's
    T positions given (the model chooses local or global by layer)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim()
    q = _split_heads(x @ p["wq"], cfg.n_heads, hd)
    k_new = _split_heads(x @ p["wk"], cfg.n_kv_heads, hd)
    v_new = _split_heads(x @ p["wv"], cfg.n_kv_heads, hd)
    posv = torch.full((B, 1), pos, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
    scores = _gqa_scores(q, cache_k, cfg.n_kv_heads)        # (B,1,KV,G,T)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(valid[None, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, cache_v, cfg.n_heads).to(x.dtype)
    return out @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_init(generator, d, d_ff, dtype, device=None):
    return {
        "wg": dense_init(generator, (d, d_ff), dtype, device=device),
        "wu": dense_init(generator, (d, d_ff), dtype, device=device),
        "wd": dense_init(generator, (d_ff, d), dtype, device=device),
    }


def swiglu(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def chunked_softmax_xent(h, head_w, labels, chunk, *, softcap_v=0.0,
                         mask=None, head_transposed=False):
    """Sequence-chunked LM loss: never materializes (B,S,V) logits.

    ``head_w``: (d, V) — or (V, d) with ``head_transposed=True`` for tied
    embeddings (the transpose is never materialized).
    """
    B, S, d = h.shape
    n_chunks = S // chunk
    if n_chunks * chunk != S:
        raise ValueError("xent_chunk must divide seq_len")
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        h_i, l_i = h[:, sl], labels[:, sl]
        m_i = (torch.ones(l_i.shape, dtype=torch.float32, device=h.device)
               if mask is None else mask[:, sl].to(torch.float32))
        if head_transposed:
            logits = torch.einsum("bcd,vd->bcv", h_i, head_w)
        else:
            logits = h_i @ head_w
        logits = softcap(logits.to(torch.float32), softcap_v)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, l_i[..., None].long())[..., 0]
        nll = nll + torch.sum((logz - gold) * m_i)
        denom = denom + torch.sum(m_i)
    return nll / torch.clamp_min(denom, 1.0)


def shard_activations(x, enabled: bool):
    """The reference constrains the residual stream's feature dim over the
    mesh's 'model' axis when ``enabled``; the package runs on one device, so
    this is the identity either way."""
    return x


def softmax_xent(logits, labels, mask=None):
    """Token-level cross entropy; logits fp32-cast; mask optional (B,S)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
