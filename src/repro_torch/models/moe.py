"""Mixture-of-Experts LM (arctic-480b, qwen3-moe-30b-a3b).

GShard/Switch-style one-hot dispatch, as in the reference:
* tokens are grouped (``moe_group_size``) and each (token, choice) gets a
  position in its expert's capacity-``C`` buffer via a cumulative-sum
  priority; overflow slots are dropped (the residual passes through).
* dispatch and combine are einsums over dense one-hot tensors, so the
  expert weights are read whole: a decode step reads every expert.
* arctic's parallel *dense residual* MLP via ``moe_dense_ff``.

The tree is the reference's, keys sorted; the fp32 ``router`` stays fp32 in
a bf16 model. Layers are stacked along a leading axis and a Python loop
indexes them (views); the cache is the dense family's
(``transformer.init_cache``), written in place, with a host-integer ``pos``.

Expert parallelism (a world's ``model`` axis, ``layers.tensor_parallel``),
by the reference's specs (``moe/w[gud]`` split by expert): a rank holds
``E / model`` experts of ``wg``, ``wu`` and ``wd``. The router, the routing
and the load-balance loss stay replicated (every rank routes every token
alike). A rank takes its experts' slices of ``dispatch`` and ``combine``,
fills and runs only their buffers, and the group sums the combined outputs
(Megatron's *g*). Megatron's *f* goes on the dispatch's input ``xg`` and on
``combine`` before they are sliced, so that ``xg``'s and the router's
gradients are whole and alike on every rank. Attention, arctic's dense
residual (column- and row-parallel ``swiglu``), the embedding and the head
split as in the dense family.

Under FSDP (``layers.fully_sharded``) the experts' ``(M, F, None)`` slices
and the router's ``(F, None)`` gather over ``data`` like any other leaf.

Routing groups are one process's, as in the reference, wherever a world
splits the rows of a batch over ranks (``layers.split_rows``: serving's
batch over ``data``, FSDP's participant rows). Each rank routes its own
tokens and gathers their top-k expert indices over the rows' axis; every
rank then rebuilds one process's order of the slots in each group its
tokens touch, the last group's padding included, so its own slots'
``pos`` and ``keep`` are one process's, bit for bit (:func:`routing`).
It fills only its own slots of the capacity buffers (an expert acts on
each slot alone: no activation crosses ranks). The load-balance loss's
``f`` and ``imp`` are one process's means over every token
(``layers.rows_sum``). Where the rank's tokens fill whole groups
(:func:`rank_groups_equal`), or, serving, no group can drop a slot
(:func:`rank_groups_match`), they route alone, with no gather.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import collectives
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.device import resolve_device

AUX_LOSS_WEIGHT = 0.01


def _dtype(cfg):
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def moe_ffn_init(generator, cfg, device=None):
    dt = _dtype(cfg)
    E, d, ff = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff_expert
    p = {
        "router": L.dense_init(generator, (d, E), torch.float32, scale=0.02,
                               device=device),
        "wg": L.dense_init(generator, (E, d, ff), dt, scale=d ** -0.5,
                           device=device),
        "wu": L.dense_init(generator, (E, d, ff), dt, scale=d ** -0.5,
                           device=device),
        "wd": L.dense_init(generator, (E, ff, d), dt, scale=ff ** -0.5,
                           device=device),
    }
    if cfg.moe_dense_ff:
        p["dense"] = L.swiglu_init(generator, d, cfg.moe_dense_ff, dt, device)
    return dict(sorted(p.items()))


def block_init(generator, cfg, device=None):
    dt = _dtype(cfg)
    return {
        "attn": L.attention_init(generator, cfg, dt, device=device),
        "ln1": L.rms_norm_init(cfg.d_model, dt, device),
        "ln2": L.rms_norm_init(cfg.d_model, dt, device),
        "moe": moe_ffn_init(generator, cfg, device),
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
        "final_norm": L.rms_norm_init(cfg.d_model, dt, device),
        "layers": layers,
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab), dt,
                                device=device),
    }


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    """Where a world splits the tokens' rows over ranks (``layers.
    split_rows``), this rank's place in one process's routing groups: the
    rows' group and size, the one-process token count ``N``, group size
    ``G`` and group count ``Gn``, the first group this rank's tokens touch
    ``g0``, the place ``off`` of its first token in those groups, its
    token count ``t``, and whether it holds the last token (and so counts
    the padding in the load-balance loss)."""
    group: Any
    size: int
    N: int
    G: int
    Gn: int
    g0: int
    off: int
    t: int
    last: bool


def _choices(p, cfg, xg):
    """The router's ``probs`` (Gn,G,E) and each token's normalised top-k
    ``gates`` and expert ``idx`` (Gn,G,k), from a stable descending sort."""
    k = cfg.moe_top_k
    logits = xg.to(torch.float32) @ p["router"]                 # (Gn,G,E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]                   # (Gn,G,k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def _slots(cfg, idx, C: int):
    """Each (token, choice) slot's one-hot expert ``flat`` (Gn,G*k,E), its
    place ``pos`` in its expert's buffer (the slots ahead of it in its
    group) and ``keep`` (pos < C), fp32, from the experts ``idx``
    (Gn,G,k)."""
    Gn, G, k = idx.shape
    flat = F.one_hot(idx, cfg.moe_num_experts).to(torch.float32).reshape(
        Gn, G * k, -1)
    prio = torch.cumsum(flat, dim=1) - flat                     # slots ahead
    pos = torch.sum(prio * flat, dim=-1)                        # (Gn,G*k)
    return flat, pos, (pos < C).to(torch.float32)


def _own_slots(span: Span, ng: int, k: int, device, padding: bool = False):
    """(ng, G*k) fp32: 1 at this rank's slots in the groups it touches
    (``padding``: the last group's padding too, where this rank holds the
    last token)."""
    j = torch.arange(ng * span.G, device=device)
    own = (j >= span.off) & (j < span.off + span.t)
    if padding and span.last:
        own |= j >= span.off + span.t
    return own.to(torch.float32).repeat_interleave(k).reshape(ng, -1)


def routing(p, cfg, xg, span: Optional[Span] = None):
    """Router of grouped tokens xg (Gn,G,d) -> dict of ``probs`` (Gn,G,E),
    normalised top-k ``gates`` and ``idx`` (Gn,G,k), each (token, choice)
    slot's place ``pos`` in its expert's buffer and ``keep`` (Gn,G*k), fp32,
    and ``C``, the slots an expert has in a group. The top k come from a stable descending sort,
    so equal probabilities (a padding token's are all equal) keep the lower
    expert first, as ``jax.lax.top_k`` does (``torch.topk`` breaks ties in
    no set order); the cumulative priority depends on that order.

    ``span``: ``xg`` holds this rank's tokens at their places in the
    one-process groups they touch (zeros elsewhere). The ranks gather
    their tokens' experts over the rows' group, and every rank rebuilds
    the one-process order of the slots in those groups, the last group's
    padding included (zero inputs: uniform probabilities, experts
    ``0 .. k-1`` by the stable sort); its own slots' ``pos`` and ``keep``
    are then one process's, and ``keep`` is 0 at every other slot. The
    dict's ``every_keep`` is one process's ``keep`` at every slot of those
    groups."""
    k = cfg.moe_top_k
    G = xg.shape[1]
    probs, gates, idx = _choices(p, cfg, xg)
    C = capacity(cfg, G)
    out = {"probs": probs, "gates": gates, "idx": idx, "C": C}
    if span is None:
        out["flat"], out["pos"], out["keep"] = _slots(cfg, idx, C)
        return out
    mine = idx.reshape(-1, k)[span.off:span.off + span.t]
    every = collectives.all_gather(mine, span.group, dim=0)         # (N,k)
    pad = torch.arange(k, device=idx.device).expand(span.Gn * G - span.N, k)
    touched = torch.cat([every, pad])[span.g0 * G:
                                      span.g0 * G + idx.numel() // k]
    out["flat"], out["pos"], out["every_keep"] = _slots(
        cfg, touched.reshape(idx.shape), C)
    out["keep"] = out["every_keep"] * _own_slots(span, xg.shape[0], k,
                                                 xg.device)
    return out


def _span(cfg, t: int) -> Optional[Span]:
    """This rank's :class:`Span` where a world splits the rows
    (``layers.split_rows``) and its ``t`` tokens would not route alone as
    one process's do; None where they do (:func:`rank_groups_equal` for
    training, whose load-balance loss counts too; :func:`rank_groups_match`
    for serving, which discards it) or where no world splits the rows."""
    rows = L.row_split()
    if rows is None:
        return None
    n, N = rows.size, t * rows.size
    alone = rank_groups_equal if rows.means else rank_groups_match
    if alone(cfg, N, n):
        return None
    G = min(cfg.moe_group_size, N)
    a = rows.rank * t
    return Span(rows.group, n, N, G, -(-N // G), a // G, a % G, t,
                rows.rank == n - 1)


def moe_ffn(p, cfg, x):
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar). Where a world splits
    the rows and a rank's tokens would route in other groups than one
    process's (:func:`_span`), they route in one process's groups
    (:func:`routing`), their buffers holding only their own slots (an
    expert acts on each slot alone), and the load-balance loss counts
    every token of every rank, padding included (``layers.rows_sum``)."""
    B, S, d = x.shape
    tokens = B * S
    span = _span(cfg, tokens)
    xt = x.reshape(tokens, d)
    if span is None:
        G = min(cfg.moe_group_size, tokens)
        Gn = -(-tokens // G)
        off, n_all = 0, Gn * G
        xt = F.pad(xt, (0, 0, 0, Gn * G - tokens))
    else:
        G, off, n_all = span.G, span.off, span.Gn * span.G
        Gn = (off + tokens - 1) // G + 1                        # touched
        xt = F.pad(xt, (0, 0, off, Gn * G - off - tokens))
    xg = xt.reshape(Gn, G, d)

    E, k = cfg.moe_num_experts, cfg.moe_top_k
    r = routing(p, cfg, xg, span)
    C = r["C"]
    # one-hot of each slot's place; an overflowed slot (pos >= C) gets an
    # all-zero row, as jax.nn.one_hot gives (F.one_hot would raise)
    cap_oh = (r["pos"].to(torch.int64)[..., None]
              == torch.arange(C, device=x.device)).to(torch.float32)
    disp = (r["flat"][..., None] * cap_oh[:, :, None, :]
            * r["keep"][..., None, None]).reshape(Gn, G, k, E, C)
    del cap_oh
    combine = (disp * r["gates"][..., None, None]).sum(2)       # (Gn,G,E,C)
    dispatch = disp.sum(2)                                      # (Gn,G,E,C)
    del disp

    dt = x.dtype
    split = L.expert_split(p["wg"].shape[0], E)
    x_in, disp_e, comb_e = xg, dispatch, combine
    if split is not None:                       # this rank's experts only
        sl, group = split
        x_in = collectives.copy_to_group(xg, group)
        disp_e = dispatch[:, :, sl]
        comb_e = _combine_in(combine, group)[:, :, sl]
    buffers = torch.einsum("gtec,gtd->gecd", disp_e.to(dt), x_in)
    h = F.silu(torch.einsum("gecd,edf->gecf", buffers, p["wg"]))
    h = h * torch.einsum("gecd,edf->gecf", buffers, p["wu"])
    expert_out = torch.einsum("gecf,efd->gecd", h, p["wd"])
    out = torch.einsum("gecd,gtec->gtd", expert_out, comb_e.to(dt))
    if split is not None:
        out = collectives.reduce_from_group(out, split[1])

    out = out.reshape(Gn * G, d)[off:off + tokens].reshape(B, S, d)
    if "dense" in p:                                            # arctic
        out = out + L.swiglu(p["dense"], x, cfg.moe_dense_ff)

    # Switch-style load-balance loss: E·Σ_e f_e·p_e == 1 at uniform routing
    # token share and router mass over every token of one process's groups:
    # under a row split the group's sums (layers.rows_mean / rows_sum)
    if span is None:
        f = L.rows_mean(dispatch.sum(dim=3).mean(dim=(0, 1)) / k)
        imp = L.rows_mean(r["probs"].mean(dim=(0, 1)))
    else:
        counted = _own_slots(span, Gn, k, x.device, padding=True)
        f = L.rows_sum(torch.einsum("gse,gs->e", r["flat"],
                                    r["every_keep"] * counted)) / (n_all * k)
        tok = counted.reshape(Gn, G, k)[..., 0]
        imp = L.rows_sum(torch.einsum("gte,gt->e", r["probs"], tok)) / n_all
    aux = E * torch.sum(f * imp)
    return out, aux


def capacity(cfg, G: int) -> int:
    """The slots an expert has in a group of ``G`` tokens."""
    return max(4, int(math.ceil(G * cfg.moe_top_k / cfg.moe_num_experts
                                * cfg.moe_capacity_factor)))


def rank_groups_equal(cfg, tokens: int, n: int) -> bool:
    """Whether the ``tokens // n`` contiguous tokens of ``tokens`` that each
    of ``n`` ranks routes fill whole groups of the one-process grouping
    (no padding on either side): then every group, and every mean over the
    groups (the load-balance loss's, ``layers.rows_mean``), is one
    process's, and the rank routes alone (:func:`_span`)."""
    G_all = min(cfg.moe_group_size, tokens)
    local = tokens // n
    return local % G_all == 0 and min(cfg.moe_group_size, local) == G_all


def rank_groups_match(cfg, tokens: int, n: int) -> bool:
    """Whether routing ``tokens // n`` contiguous tokens of ``tokens`` on
    each of ``n`` ranks (a world's serving splits the batch over ``data``)
    gives one process's dispatch: the rank's tokens fill whole groups of
    the one-process grouping (:func:`rank_groups_equal`), or no group on
    either side can drop a slot (each expert's capacity holds every token
    of a group). Serving's ranks then route alone (:func:`_span`)."""
    if rank_groups_equal(cfg, tokens, n):
        return True
    G_all = min(cfg.moe_group_size, tokens)
    G = min(cfg.moe_group_size, tokens // n)
    return capacity(cfg, G_all) >= G_all and capacity(cfg, G) >= G


def _combine_in(combine, group):
    """Megatron's *f* on the combine weights, before a rank takes its
    experts' slice: the identity forward; backward, the group's sum of the
    slices' gradients, so each rank's gates (and the router) get the whole
    gradient."""
    return collectives.copy_to_group(combine, group)


# ---------------------------------------------------------------------------
# model interface
# ---------------------------------------------------------------------------


def _block(p, cfg, x, positions, mask):
    """One block; returns (x, aux, (k, v)) with the layer's rotated keys and
    its values for a prefill's cache."""
    h, kv = L.attention(p["attn"], L.rms_norm(p["ln1"], x, cfg.norm_eps),
                        cfg, positions=positions, mask=mask)
    x = x + h
    h, a = moe_ffn(p["moe"], cfg, L.rms_norm(p["ln2"], x, cfg.norm_eps))
    return L.shard_activations(x + h, cfg.act_shard), a, kv


def _stack(params, cfg, x, positions, mask, cache=None):
    """The layer stack -> (final-normed h, mean aux loss); with a
    ``cache``, each layer's keys and values go into its first S
    positions."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a, (k, v) = T.apply_layer(_block, params, i, cfg, x, positions,
                                     mask)
        aux = aux + a
        if cache is not None:
            L.write_prefill(cache["k"][i], k)
            L.write_prefill(cache["v"][i], v)
    return (L.rms_norm(params["final_norm"], x, cfg.norm_eps),
            aux / cfg.n_layers)


def loss_fn(params, cfg, batch):
    tokens, labels = batch["tokens"], batch["labels"]
    x = L.embed_lookup(L.param(params, "embed"), tokens, cfg.vocab)
    S = tokens.shape[1]
    mask = L.causal_mask(S, S, window=cfg.window, device=x.device)
    h, aux = _stack(params, cfg, x, torch.arange(S, device=x.device), mask)
    head = L.param(params, "lm_head")
    if L.vocab_split(head, cfg.vocab):
        xent = L.vocab_parallel_xent(h, head, labels,
                                     cfg.xent_chunk, mask=batch.get("mask"))
    elif cfg.xent_chunk:
        xent = L.chunked_softmax_xent(h, head, labels,
                                      cfg.xent_chunk, mask=batch.get("mask"))
    else:
        logits = h @ head
        xent = L.softmax_xent(logits, labels, batch.get("mask"))
    loss = xent + AUX_LOSS_WEIGHT * aux
    return loss, {"loss": xent, "aux_loss": aux}


def init_cache(cfg, batch_size, max_len, device=None):
    return T.init_cache(cfg, batch_size, max_len, device)


def prefill(params, cfg, batch, cache):
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = L.embed_lookup(L.param(params, "embed"), tokens, cfg.vocab)
    mask = L.causal_mask(S, S, window=cfg.window, device=x.device)
    h, _ = _stack(params, cfg, x, torch.arange(S, device=x.device), mask,
                  cache)
    return L.lm_logits(h[:, -1:], L.param(params, "lm_head"), cfg.vocab), \
        dict(cache, pos=S)


def decode_step(params, cfg, token, cache):
    pos = cache["pos"]
    x = L.embed_lookup(L.param(params, "embed"), token, cfg.vocab)
    kpos = L.cache_positions(cache["k"])
    valid = kpos <= pos
    if cfg.window:
        valid &= (pos - kpos) < cfg.window
    for i in range(cfg.n_layers):
        p = T._layer(params, i)
        xn = L.rms_norm(p["ln1"], x, cfg.norm_eps)
        out, _, _ = L.attention_decode_masked(
            p["attn"], xn, cache["k"][i], cache["v"][i], pos, cfg, valid)
        x = x + out
        h, _ = moe_ffn(p["moe"], cfg, L.rms_norm(p["ln2"], x, cfg.norm_eps))
        x = x + h
    h = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(h, L.param(params, "lm_head"), cfg.vocab), \
        dict(cache, pos=pos + 1)
