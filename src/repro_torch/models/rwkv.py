"""RWKV-6 "Finch" (rwkv6-1.6b): attention-free RNN LM.

The Finch features, as in the reference:
* matrix-valued per-head state ``S ∈ R^{hd×hd}`` (head_dim 64),
* **data-dependent decay** ``w_t = exp(-exp(w0 + tanh(x W_a) W_b))``,
* bonus ``u`` for the current token, token-shift mixing, and the
  squared-ReLU channel-mix FFN.

Recurrence (per head):
    out_t = r_t · (S_{t-1} + (u ∘ k_t) ⊗ v_t)
    S_t   = diag(w_t) · S_{t-1} + k_t ⊗ v_t

Prefill and training run the recurrence as a Python loop over time (the
reference's ``lax.scan``; plain PyTorch, no kernel); decode is one step of
it. There is no KV cache: the state is ``{"S": (L,B,H,hd,hd) fp32,
"last_tm", "last_cm": (L,B,d), "pos": int}``, written in place, with
``pos`` a host integer. The tree is the reference's, keys sorted.

Across ranks (``models.layers.tensor_parallel``; the reference's specs):
the time-mix's ``w[rkvg]`` and ``decay_b`` are column-parallel, so a rank
runs its heads (their ``w0``, ``u``, state ``S``), and ``wo`` is
row-parallel; Megatron's *f* sits on each mixed input of a split product,
on the decay's ``tanh(mix @ decay_a)``, whose replicated ``decay_a`` feeds
the split ``decay_b``, and on the per-head norm ``ln_x``'s replicated
scale and bias, which meet the rank's heads alone. The channel-mix's ``wk``
is column- and ``wv`` row-parallel; its gate ``sigmoid(xr @ wr)``, split
over d by ``wr``'s columns, is gathered to the whole d
(:func:`layers.gather_lanes`) and meets the summed ``k @ wv`` on every
rank. The residual stream, the
token shifts and the norms stay replicated; the embedding and the head
are split by vocab. Every count of heads is read from the weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.device import resolve_device

DECAY_LORA = 64


def _dtype(cfg):
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _uniform_half(generator, shape, dtype, device=None):
    """Uniform [0, 0.5) weights drawn on the generator's device, then moved
    (nothing is drawn on ``meta``)."""
    if L._is_meta(device):
        return L._drawn(torch.empty(shape, dtype=dtype, device="meta"),
                        dtype, "meta")
    w = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device).mul_(0.5)
    return L._drawn(w, dtype, device)


def block_init(generator, cfg, device=None):
    dt = _dtype(cfg)
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.resolved_head_dim()

    def dense(shape):
        return L.dense_init(generator, shape, dt, device=device)

    tm = {
        "mu": _uniform_half(generator, (5, d), dt, device),     # r,k,v,w,g
        "wr": dense((d, H * hd)),
        "wk": dense((d, H * hd)),
        "wv": dense((d, H * hd)),
        "wg": dense((d, H * hd)),
        "wo": dense((H * hd, d)),
        "decay_a": dense((d, DECAY_LORA)),
        "decay_b": dense((DECAY_LORA, H * hd)),
        "w0": torch.full((H * hd,), -0.6931, dtype=dt, device=device),
        "u": torch.zeros((H, hd), dtype=dt, device=device),
        "ln_x": L.layer_norm_init(hd, dt, device),   # per-head group norm
    }
    cm = {
        "mu": _uniform_half(generator, (2, d), dt, device),     # k,r
        "wk": dense((d, cfg.d_ff)),
        "wv": dense((cfg.d_ff, d)),
        "wr": dense((d, d)),
    }
    return {
        "cm": dict(sorted(cm.items())),
        "ln1": L.layer_norm_init(d, dt, device),
        "ln2": L.layer_norm_init(d, dt, device),
        "tm": dict(sorted(tm.items())),
    }


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
        "final_norm": L.layer_norm_init(cfg.d_model, dt, device),
        "layers": layers,
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab), dt,
                                device=device),
    }


# ---------------------------------------------------------------------------
# time-mix (WKV6)
# ---------------------------------------------------------------------------


def _shift(x, last):
    """Token shift: previous token's features; ``last`` (B,d) seeds t=0."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _heads(p, cfg):
    """``(H, split)``: the heads of this rank's time-mix weights and
    whether they are split over the tensor-parallel group."""
    H = p["u"].shape[0]
    return H, L.is_split(H, cfg.n_heads)


def _decay_in(h, split: bool):
    """Megatron's *f* on ``tanh(mix @ decay_a)`` before the split
    ``decay_b``: the replicated ``decay_a`` gets its whole gradient only
    where the slices' gradients are summed over the group."""
    return L._copy_in(h, split)


def _tm_projections(p, cfg, x, last_x):
    """r,k,v,g,w for a whole sequence (this rank's heads). x: (B,T,d)."""
    B, Tn, d = x.shape
    hd = cfg.resolved_head_dim()
    H, split = _heads(p, cfg)
    xx = _shift(x, last_x)

    def mix(i):
        return x + (xx - x) * p["mu"][i][None, None, :]

    def col(i, w):
        return (L._copy_in(mix(i), split) @ p[w]).reshape(B, Tn, H, hd)

    r, k, v = col(0, "wr"), col(1, "wk"), col(2, "wv")
    # data-dependent decay (Finch): low-rank + base, squashed to (0,1)
    dw = _decay_in(torch.tanh(mix(3) @ p["decay_a"]), split) @ p["decay_b"]
    w = torch.exp(-torch.exp(p["w0"].to(torch.float32)
                             + dw.to(torch.float32))).reshape(B, Tn, H, hd)
    g = F.silu(col(4, "wg"))
    return r, k, v, w, g


def wkv_scan(r, k, v, w, u, state):
    """Run the WKV6 recurrence over time.

    r,k,v,w: (B,T,H,hd); u: (H,hd); state: (B,H,hd,hd) fp32.
    Returns (out (B,T,H,hd) fp32, final state).
    """
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    outs = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhi,bhj->bhij", k[:, t], v[:, t])
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def time_mix(p, cfg, x, tm_state):
    """tm_state: {'S': (B,H,hd,hd) fp32, 'last': (B,d)}."""
    B, Tn, d = x.shape
    H, split = _heads(p, cfg)
    r, k, v, w, g = _tm_projections(p, cfg, x, tm_state["last"])
    out, S = wkv_scan(r, k, v, w, p["u"].to(torch.float32), tm_state["S"])
    # the per-head norm: its replicated scale and bias meet this rank's
    # heads alone, so their gradients are summed over the group (*f*)
    ln_x = {k: L._copy_in(v, split) for k, v in p["ln_x"].items()}
    out = L.layer_norm(ln_x, out.to(x.dtype))
    out = (out * g).reshape(B, Tn, H * cfg.resolved_head_dim())
    return L._reduce_out(out @ p["wo"], split), {"S": S, "last": x[:, -1, :]}


def channel_mix(p, cfg, x, last_x):
    xx = _shift(x, last_x)
    xk = x + (xx - x) * p["mu"][0][None, None, :]
    xr = x + (xx - x) * p["mu"][1][None, None, :]
    split_k = L.is_split(p["wk"].shape[1], cfg.d_ff)
    split_r = L.is_split(p["wr"].shape[1], cfg.d_model)
    k = torch.square(torch.relu(L._copy_in(xk, split_k) @ p["wk"]))
    kv = L._reduce_out(k @ p["wv"], split_k)
    gate = torch.sigmoid(L._copy_in(xr, split_r) @ p["wr"])
    if split_r:
        gate = L.gather_lanes(gate, cfg.d_model)
    return gate * kv, x[:, -1, :]


# ---------------------------------------------------------------------------
# model interface
# ---------------------------------------------------------------------------


def _zero_states(cfg, B, device=None, H=None):
    """Zero states of ``B`` rows; ``H`` heads (None: the config's; a rank
    holds its own)."""
    H, hd = H or cfg.n_heads, cfg.resolved_head_dim()
    return {
        "S": torch.zeros((cfg.n_layers, B, H, hd, hd), dtype=torch.float32,
                         device=device),
        "last_cm": torch.zeros((cfg.n_layers, B, cfg.d_model),
                               dtype=_dtype(cfg), device=device),
        "last_tm": torch.zeros((cfg.n_layers, B, cfg.d_model),
                               dtype=_dtype(cfg), device=device),
        "pos": 0,
    }


def _block(p, cfg, x, S, last_tm, last_cm):
    """One block from its states -> (x, the time-mix's state, the
    channel-mix's token shift)."""
    h, tm_state = time_mix(p["tm"], cfg,
                           L.layer_norm(p["ln1"], x, cfg.norm_eps),
                           {"S": S, "last": last_tm})
    x = x + h
    h, lcm = channel_mix(p["cm"], cfg, L.layer_norm(p["ln2"], x, cfg.norm_eps),
                         last_cm)
    return x + h, tm_state, lcm


def _stack(params, cfg, x, states, write=True):
    """The layer stack from ``states``, which it advances in place (layer i
    reads its state before writing it) -> (final-normed h, states with
    ``pos`` moved on by the sequence length). ``write=False`` leaves
    ``states`` as they are: the loss writes nothing in place, so that it
    runs under ``torch.func.vmap`` and autograd."""
    for i in range(cfg.n_layers):
        x, tm_state, lcm = T.apply_layer(_block, params, i, cfg, x,
                                         states["S"][i],
                                         states["last_tm"][i],
                                         states["last_cm"][i])
        if not write:
            continue
        states["S"][i] = tm_state["S"]
        states["last_tm"][i] = tm_state["last"]
        states["last_cm"][i] = lcm
    return (L.layer_norm(params["final_norm"], x, cfg.norm_eps),
            dict(states, pos=states["pos"] + x.shape[1]))


def loss_fn(params, cfg, batch):
    tokens, labels = batch["tokens"], batch["labels"]
    x = L.embed_lookup(L.param(params, "embed"), tokens, cfg.vocab)
    states = _zero_states(cfg, tokens.shape[0], x.device,
                          H=params["layers"]["tm"]["u"].shape[1])
    h, _ = _stack(params, cfg, x, states, write=False)
    loss = L.lm_xent(h, L.param(params, "lm_head"), labels, cfg.vocab,
                     batch.get("mask"))
    return loss, {"loss": loss}


def init_cache(cfg, batch_size, max_len, device=None):
    """The O(1) recurrent state: ``max_len`` is not read."""
    return _zero_states(cfg, batch_size, resolve_device(device))


def prefill(params, cfg, batch, cache):
    x = L.embed_lookup(L.param(params, "embed"), batch["tokens"], cfg.vocab)
    h, states = _stack(params, cfg, x, cache)
    return L.lm_logits(h[:, -1:], L.param(params, "lm_head"), cfg.vocab), \
        states


def decode_step(params, cfg, token, cache):
    x = L.embed_lookup(L.param(params, "embed"), token, cfg.vocab)  # (B,1,d)
    h, states = _stack(params, cfg, x, cache)
    return L.lm_logits(h, L.param(params, "lm_head"), cfg.vocab), states
