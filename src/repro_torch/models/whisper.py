"""Whisper large-v3 backbone (whisper-large-v3): encoder-decoder.

As in the reference, the mel-spectrogram and conv frontend are a stub: the
batch brings ``n_frames`` precomputed frame embeddings at ``d_model`` as
``frames``. This module is the transformer: a bidirectional encoder over
the frames (a learned position table, no RoPE) and a causal decoder (RoPE
self-attention) with per-layer cross-attention whose keys and values are
computed once at prefill and cached (``xk``, ``xv``). The head is tied
(``embed.T``). The tree is the reference's, keys sorted; layers are
stacked along a leading axis and a Python loop indexes them (views).

Under ``layers.tensor_parallel`` every function here takes a rank's shards
(its heads of both attentions and of the cross cache ``xk`` / ``xv``, its
slice of d_ff, its vocab slice of the tied ``embed``) and returns the
whole logits or loss on every rank. ``enc_pos``, the norms and the
residual streams stay replicated over ``model``. Its layers come from the
dense family's ``transformer._layer`` (``encoder`` and ``decoder``), and
``enc_pos`` and ``embed`` through ``layers.param``, so that FSDP gathers
them as it does every family's. The encoder's output feeds every decoder
layer's cross-attention keys and values, so its gradient is partial on
each rank: one *f* on it ahead of the decoder (:func:`_enc_in`) sums the
layers' partials locally and then once over the group.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.device import resolve_device


def _dtype(cfg):
    return getattr(torch, cfg.param_dtype)




# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def enc_block_init(generator, cfg, device=None):
    dt = _dtype(cfg)
    return {
        "attn": L.attention_init(generator, cfg, dt, device=device),
        "ln1": L.layer_norm_init(cfg.d_model, dt, device),
        "ln2": L.layer_norm_init(cfg.d_model, dt, device),
        "mlp": L.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, dt, device),
    }


def dec_block_init(generator, cfg, device=None):
    dt = _dtype(cfg)
    p = {
        "attn": L.attention_init(generator, cfg, dt, device=device),
        "ln1": L.layer_norm_init(cfg.d_model, dt, device),
        "ln_x": L.layer_norm_init(cfg.d_model, dt, device),
        "xattn": L.attention_init(generator, cfg, dt, device=device),
        "ln2": L.layer_norm_init(cfg.d_model, dt, device),
        "mlp": L.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, dt, device),
    }
    return dict(sorted(p.items()))


def init(generator, cfg, device=None):
    """Random parameters from ``generator`` (drawn on its device), placed on
    ``device`` (None = cuda)."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    p = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device),
        "enc_pos": L.embed_init(generator, cfg.n_frames, cfg.d_model, dt,
                                device),
        "encoder": L.stack_blocks([enc_block_init(generator, cfg, device)
                                   for _ in range(cfg.encoder_layers)]),
        "enc_norm": L.layer_norm_init(cfg.d_model, dt, device),
        "decoder": L.stack_blocks([dec_block_init(generator, cfg, device)
                                   for _ in range(cfg.n_layers)]),
        "final_norm": L.layer_norm_init(cfg.d_model, dt, device),
    }
    return dict(sorted(p.items()))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(params, cfg, frames):
    """frames: (B, n_frames, d) stubbed embeddings -> encoder states."""
    x = frames.to(_dtype(cfg)) + L.param(params, "enc_pos")[None]
    for i in range(cfg.encoder_layers):
        x = T.apply_layer(_enc_block, params, i, cfg, x, key="encoder")
    return L.layer_norm(params["enc_norm"], x, cfg.norm_eps)


def _enc_block(p, cfg, x):
    """One encoder block."""
    xn = L.layer_norm(p["ln1"], x, cfg.norm_eps)
    # bidirectional self-attention, no RoPE (the position table): the
    # reference passes an all-true mask, which masks nothing
    h, _ = L.attention(p["attn"], xn, cfg, kv_override=xn)
    x = x + h
    h = L.gelu_mlp(p["mlp"], L.layer_norm(p["ln2"], x, cfg.norm_eps),
                   cfg.d_ff)
    return x + h


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _dec_block(p, cfg, x, positions, mask, enc):
    """One decoder block -> (x, (k, v) of the self-attention, (k, v) of the
    encoder states)."""
    h, kv = L.attention(p["attn"], L.layer_norm(p["ln1"], x, cfg.norm_eps),
                        cfg, positions=positions, mask=mask)
    x = x + h
    h, xkv = L.attention(p["xattn"], L.layer_norm(p["ln_x"], x, cfg.norm_eps),
                         cfg, kv_override=enc)
    x = x + h
    h = L.gelu_mlp(p["mlp"], L.layer_norm(p["ln2"], x, cfg.norm_eps),
                   cfg.d_ff)
    return x + h, kv, xkv


def _enc_in(enc, params, cfg):
    """The encoder's output as the decoder's cross-attentions read it:
    under ``layers.tensor_parallel`` with the heads split, Megatron's *f*
    (the identity forward; backward, the group's sum of the gradient that
    the layers' keys and values gave it, summed locally first)."""
    heads = params["decoder"]["xattn"]["wq"].shape[-1] // \
        cfg.resolved_head_dim()
    return L._copy_in(enc, L.is_split(heads, cfg.n_heads))


def _decode_stack(params, cfg, tokens, enc, cache=None):
    """The decoder over a prompt; with a ``cache``, each layer's self keys
    and values go into its first S positions and its cross keys and values
    into ``xk``/``xv``."""
    S = tokens.shape[1]
    enc = _enc_in(enc, params, cfg)
    x = L.embed_lookup(L.param(params, "embed"), tokens, cfg.vocab)
    mask = L.causal_mask(S, S, device=x.device)
    positions = torch.arange(S, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v), (xk, xv) = T.apply_layer(_dec_block, params, i, cfg, x,
                                            positions, mask, enc,
                                            key="decoder")
        if cache is not None:
            L.write_prefill(cache["k"][i], k)
            L.write_prefill(cache["v"][i], v)
            L.write_prefill(cache["xk"][i], xk, "xk")
            L.write_prefill(cache["xv"][i], xv, "xk")
    return L.layer_norm(params["final_norm"], x, cfg.norm_eps)


def loss_fn(params, cfg, batch):
    """batch: frames (B,F,d), tokens (B,S), labels (B,S)."""
    enc = encode(params, cfg, batch["frames"])
    h = _decode_stack(params, cfg, batch["tokens"], enc)
    # whisper ties the head (no lm_head: the dense family's tied branch)
    loss = T.head_loss(params, cfg, h, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_cache(cfg, batch_size, max_len, device=None):
    device = resolve_device(device)
    hd = cfg.resolved_head_dim()
    dt = _dtype(cfg)
    self_shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, hd)
    cross_shape = (cfg.n_layers, batch_size, cfg.n_frames, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(self_shape, dtype=dt, device=device),
        "v": torch.zeros(self_shape, dtype=dt, device=device),
        "xk": torch.zeros(cross_shape, dtype=dt, device=device),
        "xv": torch.zeros(cross_shape, dtype=dt, device=device),
        "pos": 0,
    }


def prefill(params, cfg, batch, cache):
    """Encode the audio, cache each layer's cross keys and values, prefill
    the text prompt."""
    enc = encode(params, cfg, batch["frames"])
    h = _decode_stack(params, cfg, batch["tokens"], enc, cache)
    return (T.logits_fn(params, cfg, h[:, -1:]),
            dict(cache, pos=batch["tokens"].shape[1]))


def decode_step(params, cfg, token, cache):
    pos = cache["pos"]
    x = L.embed_lookup(L.param(params, "embed"), token, cfg.vocab)
    valid = L.cache_positions(cache["k"]) <= pos
    for i in range(cfg.n_layers):
        p = T._layer(params, i, "decoder")
        xn = L.layer_norm(p["ln1"], x, cfg.norm_eps)
        out, _, _ = L.attention_decode_masked(
            p["attn"], xn, cache["k"][i], cache["v"][i], pos, cfg, valid)
        x = x + out
        # cross-attention against the cached encoder keys and values
        x = x + L.cross_attention_decode(
            p["xattn"], L.layer_norm(p["ln_x"], x, cfg.norm_eps),
            cache["xk"][i], cache["xv"][i], cfg)
        h = L.gelu_mlp(p["mlp"], L.layer_norm(p["ln2"], x, cfg.norm_eps),
                       cfg.d_ff)
        x = x + h
    h = L.layer_norm(params["final_norm"], x, cfg.norm_eps)
    return T.logits_fn(params, cfg, h), dict(cache, pos=pos + 1)
