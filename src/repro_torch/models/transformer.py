"""Dense GQA decoder LM (llama3 / starcoder2 / tinyllama / gemma2).

One block definition covers the dense variants:
* RoPE GQA attention, SwiGLU MLP, RMSNorm (pre-norm; gemma2 adds post-norms)
* optional sliding ``window``; gemma2's ``local_global_alt`` alternates
  local/global by layer parity (even = local)
* optional attention/final logit soft-capping (gemma2)
* layers are stacked along a leading axis, dict keys in sorted order: the
  reference's parameter tree, so ``engine.flat.params_from_numpy`` carries
  a reference tree across unchanged. The reference scans over the stack;
  here a Python loop indexes it (views, no copies).

Exports the uniform model interface (init / loss_fn / init_cache / prefill /
decode_step). Under ``layers.tensor_parallel`` every function here takes a
rank's shards of the parameters and the cache (its heads, its slices of
d_ff and of the vocab) and returns the whole logits or loss on every rank.
Under ``layers.fully_sharded`` (FSDP over ``data``) every leaf is read
through :func:`_layer` or ``layers.param``, which gather it over ``data``;
``cfg.remat`` (checkpoint each block, as the reference's
``jax.checkpoint``) then runs each block under a non-reentrant checkpoint
with its gathers inside (:func:`apply_layer`), and changes no value. The
cache is
``{"k", "v": (L,B,T,KV,hd), "pos": int}``; prefill and decode write the new
keys and values into its tensors in place (the reference's serving loop
donates its cache) and ``pos`` is a host integer, so no step synchronises
with the device to index the cache. A cache split by sequence
(``layers.seq_split``) is written through ``layers.write_prefill`` and
the decode, its validity vectors over global positions.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def _dtype(cfg):
    return getattr(torch, cfg.param_dtype)


def _layer(params, i, key: str = "layers"):
    """Layer ``i``'s leaves of the stack ``params[key]`` (views; every
    family takes its layers here): under ``layers.fully_sharded``, each
    leaf split over ``data`` gathered."""
    return L.gathered_layer(tree_map(lambda t: t[i], params[key]), key)


def apply_layer(fn, params, i, *args, key: str = "layers"):
    """``fn(_layer(params, i, key), *args)``; where ``layers.remat`` says
    so, under a non-reentrant checkpoint with the gather inside it: the
    gathered weights and the block's activations are freed when its
    forward ends, and its backward runs the forward (and its gathers)
    again."""
    if L.remat():
        return checkpoint(lambda *a: fn(_layer(params, i, key), *a), *args,
                          use_reentrant=False)
    return fn(_layer(params, i, key), *args)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def block_init(generator, cfg, device=None):
    dt = _dtype(cfg)
    p = {
        "attn": L.attention_init(generator, cfg, dt, device=device),
        "ln1": L.rms_norm_init(cfg.d_model, dt, device),
        "ln2": L.rms_norm_init(cfg.d_model, dt, device),
        "mlp": L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dt, device),
    }
    if cfg.local_global_alt:                     # gemma2 post-norms
        p["post_ln1"] = L.rms_norm_init(cfg.d_model, dt, device)
        p["post_ln2"] = L.rms_norm_init(cfg.d_model, dt, device)
    return dict(sorted(p.items()))


def init(generator, cfg, device=None):
    """Random parameters from ``generator`` (drawn on its device), placed on
    ``device`` (None = cuda)."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    embed = L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device)
    blocks = [block_init(generator, cfg, device) for _ in range(cfg.n_layers)]
    params = {
        "embed": embed,
        "final_norm": L.rms_norm_init(cfg.d_model, dt, device),
        "layers": L.stack_blocks(blocks),
    }
    del blocks
    if not cfg.local_global_alt:                 # gemma2 ties the LM head
        params["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                         dt, device=device)
    return dict(sorted(params.items()))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _masks(cfg, S, T, offset=0, device=None):
    full = L.causal_mask(S, T, offset=offset, device=device)
    if cfg.local_global_alt:
        local = L.causal_mask(S, T, offset=offset, window=cfg.window,
                              device=device)
        return full, local
    if cfg.window:
        return L.causal_mask(S, T, offset=offset, window=cfg.window,
                             device=device), None
    return full, None


def _layer_mask(cfg, i, full, local):
    """Even layers are local under ``local_global_alt``."""
    return local if cfg.local_global_alt and i % 2 == 0 else full


def _block_apply(p, cfg, x, positions, mask):
    """One block; returns (x, (k, v)) with the layer's rotated keys and its
    values for a prefill's cache."""
    h, kv = L.attention(p["attn"], L.rms_norm(p["ln1"], x, cfg.norm_eps),
                        cfg, positions=positions, mask=mask)
    if "post_ln1" in p:
        h = L.rms_norm(p["post_ln1"], h, cfg.norm_eps)
    x = x + h
    h = L.swiglu(p["mlp"], L.rms_norm(p["ln2"], x, cfg.norm_eps), cfg.d_ff)
    if "post_ln2" in p:
        h = L.rms_norm(p["post_ln2"], h, cfg.norm_eps)
    return x + h, kv


def stack_forward(params, cfg, x, positions, cache=None):
    """Run the layer stack on embeddings x (B,S,d). With a ``cache``, each
    layer's keys and values are written into its first S positions."""
    S = x.shape[1]
    full, local = _masks(cfg, S, S, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v) = apply_layer(_block_apply, params, i, cfg, x, positions,
                                _layer_mask(cfg, i, full, local))
        if cache is not None:
            L.write_prefill(cache["k"][i], k)
            L.write_prefill(cache["v"][i], v)
        x = L.shard_activations(x, cfg.act_shard)
    return L.rms_norm(params["final_norm"], x, cfg.norm_eps)


def logits_fn(params, cfg, h):
    """The LM head's fp32 logits (soft-capped); under tensor parallelism
    with the head split by vocab, the slices gathered over the group."""
    tied = "lm_head" not in params
    return _head_logits(cfg, h, L.param(params, "embed" if tied else
                                        "lm_head"), tied)


def _head_logits(cfg, h, head, tied: bool):
    """:func:`logits_fn` of the head as the layers read it."""
    if L.vocab_split(head, cfg.vocab, transposed=tied):
        logits = L.vocab_logits(h, head, transposed=tied)
    elif tied:
        logits = h @ head.T
    else:
        logits = h @ head
    return L.softcap(logits.to(torch.float32), cfg.final_softcap)


def embed_tokens(params, cfg, tokens):
    x = L.embed_lookup(L.param(params, "embed"), tokens, cfg.vocab)
    if cfg.local_global_alt:                     # gemma scales embeddings
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def head_loss(params, cfg, h, labels, mask=None):
    """The LM loss of the final states ``h`` (B,S,d) under the head
    (``lm_head``, else the tied ``embed``): the vocab-parallel loss where
    the head is this rank's vocab slice under tensor parallelism, else the
    chunked loss with ``cfg.xent_chunk``, else :func:`L.softmax_xent` of
    :func:`logits_fn`. The dense loss, LLaVA's (its text positions) and
    Whisper's (its tied head) share it."""
    tied = "lm_head" not in params
    head = L.param(params, "embed" if tied else "lm_head")
    if L.vocab_split(head, cfg.vocab, transposed=tied):
        return L.vocab_parallel_xent(h, head, labels, cfg.xent_chunk,
                                     softcap_v=cfg.final_softcap, mask=mask,
                                     head_transposed=tied)
    if cfg.xent_chunk:
        return L.chunked_softmax_xent(h, head, labels, cfg.xent_chunk,
                                      softcap_v=cfg.final_softcap, mask=mask,
                                      head_transposed=tied)
    return L.softmax_xent(_head_logits(cfg, h, head, tied), labels, mask)


def loss_fn(params, cfg, batch):
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    h = stack_forward(params, cfg, x,
                      torch.arange(tokens.shape[1], device=x.device))
    loss = head_loss(params, cfg, h, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def init_cache(cfg, batch_size, max_len, device=None):
    device = resolve_device(device)
    hd = cfg.resolved_head_dim()
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, hd)
    dt = _dtype(cfg)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": 0,
    }


def prefill(params, cfg, batch, cache):
    """Run the prompt through the stack, filling the cache."""
    x = embed_tokens(params, cfg, batch["tokens"])
    return prefill_embeds(params, cfg, x, cache)


def prefill_embeds(params, cfg, x, cache):
    """Prefill from raw embeddings (B,S,d) -> (logits of the last position
    (B,1,V), cache)."""
    S = x.shape[1]
    h = stack_forward(params, cfg, x, torch.arange(S, device=x.device), cache)
    return logits_fn(params, cfg, h[:, -1:]), dict(cache, pos=S)


def decode_step(params, cfg, token, cache):
    """One new token (B,1) against the cache; returns (logits, cache)."""
    pos = cache["pos"]
    x = embed_tokens(params, cfg, token)
    kpos = L.cache_positions(cache["k"])
    valid_full = kpos <= pos
    valid_local = (valid_full & ((pos - kpos) < cfg.window) if cfg.window
                   else valid_full)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        if cfg.local_global_alt:
            valid = valid_local if i % 2 == 0 else valid_full
        else:
            valid = valid_local
        xn = L.rms_norm(p["ln1"], x, cfg.norm_eps)
        out, _, _ = L.attention_decode_masked(
            p["attn"], xn, cache["k"][i], cache["v"][i], pos, cfg, valid)
        if "post_ln1" in p:
            out = L.rms_norm(p["post_ln1"], out, cfg.norm_eps)
        x = x + out
        h = L.swiglu(p["mlp"], L.rms_norm(p["ln2"], x, cfg.norm_eps),
                     cfg.d_ff)
        if "post_ln2" in p:
            h = L.rms_norm(p["post_ln2"], h, cfg.norm_eps)
        x = x + h
    cache = dict(cache, pos=pos + 1)
    h = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, h), cache
