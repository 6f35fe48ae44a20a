"""Analytic roofline model on one NVIDIA H100 (``config.H100``).

The compute and memory terms are derived analytically from exact parameter
counts (read from the parameter tree initialised on the ``meta`` device,
so MoE/expert scaling and heads are exact) plus standard
attention/recurrence formulas; the collective term takes the bytes the
caller counted. The FLOP and byte terms are the reference's exactly; only
the hardware constants are the card's.

Conventions: all terms are GLOBAL per executed step (one MoDeST round for
train shapes, one token for decode, one prompt for prefill); the roofline
seconds divide by the card count.

Formulas:
  train flops   = 3 · (2·N_act·T + F_attn + F_mix)      (fwd + 2×bwd)
  prefill flops =      2·N_act·T + F_attn
  decode flops  =      2·N_act·B + F_attn_decode
  F_attn (causal) = Σ_layers 4 · T · ctx̄ · H · hd   (scores + out, ×2 ops)
  memory train  ≈ E·P·3·params + α·activations + logits traffic
  memory decode ≈ params (streamed once per token) + cache read/write
"""

from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.config import H100, ModelConfig, ShapeConfig
from repro_torch.models import build
from repro_torch.utils.pytree import tree_flatten_with_path

ACT_ALPHA = 8.0          # activation HBM traffic multiplier (fwd w+r, remat, bwd)


def aggregation_roofline(n_params: int, p: int, *, itemsize: int = 4,
                         fused_quantize: bool = False, chips: int = 1) -> dict:
    """HBM-traffic model of the MoDeST aggregation step (the engine's
    one-pass whole-model kernel vs the per-leaf path).

    One pass reads the ``(P, N)`` stack once and writes the mean once:
    ``(P+1)·N·itemsize`` bytes. The per-leaf path moves the same payload
    but adds a ravel/stack round trip per leaf (read + write of every
    replica's leaf), modeled as ``2×`` the stack bytes on top. The fused
    aggregate→quantize variant appends int8 codes + fp32 scales to the
    single pass instead of re-reading the mean in a second kernel (which
    would cost ``(1+1/4)·N·itemsize`` more).

    The times are the bytes over ``chips`` cards' HBM rate, in µs and not
    rounded (the reference rounds to 0.01 µs; the MF session's pass takes
    0.15 µs here).
    """
    stack = (p + 1) * n_params * itemsize
    onepass = stack + (n_params + 4 * (n_params // 16384 + 1)
                       if fused_quantize else 0)
    per_leaf = stack + 2 * p * n_params * itemsize
    if fused_quantize:
        per_leaf += 2 * n_params * itemsize + n_params   # extra quant pass
    bw = chips * H100.hbm_bandwidth
    return {
        "onepass_bytes": int(onepass),
        "per_leaf_bytes": int(per_leaf),
        "onepass_us": onepass / bw * 1e6,
        "per_leaf_us": per_leaf / bw * 1e6,
    }


def _param_leaves(cfg: ModelConfig):
    """``(path, shape, itemsize)`` of every parameter, from an init on the
    ``meta`` device (no weights)."""
    tree = build(cfg).init(torch.Generator().manual_seed(0), "meta")
    out = []
    for path_elems, leaf in tree_flatten_with_path(tree)[0]:
        path = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path_elems)
        out.append((path, tuple(leaf.shape), leaf.element_size()))
    return out


def param_stats(cfg: ModelConfig) -> dict:
    """Exact parameter counts/bytes from the parameter tree."""
    total = 0
    total_bytes = 0
    matmul = 0.0          # params participating in per-token matmuls
    active = 0.0          # ...scaled by expert activation (top-k/E)
    moe_scale = (cfg.moe_top_k / cfg.moe_num_experts
                 if cfg.moe_num_experts else 1.0)
    for path, shape, itemsize in _param_leaves(cfg):
        n = int(np.prod(shape)) if shape else 1
        total += n
        total_bytes += n * itemsize
        if len(shape) < 2:
            continue
        if re.search(r"embed$", path) and not re.search(r"enc_pos", path):
            # lookup, not matmul — unless tied as the LM head (gemma2/whisper)
            if cfg.local_global_alt or cfg.family == "audio":
                matmul += n
                active += n
            continue
        if re.search(r"enc_pos$|mu$|conv$", path):
            continue
        if re.search(r"moe/w[gud]$", path):
            matmul += n
            active += n * moe_scale * cfg.moe_capacity_factor
            continue
        matmul += n
        active += n
    return {"total": total, "bytes": total_bytes,
            "matmul": matmul, "active": active}


def _attn_flops(cfg: ModelConfig, T: int, ctx: float, layers: int) -> float:
    """scores (T·ctx·H·hd) + out (same), ×2 flops per MAC."""
    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    return 4.0 * T * ctx * H * hd * layers


def _avg_ctx(cfg: ModelConfig, S: int) -> float:
    """average causal context per query, honoring windows/local-global."""
    full = S / 2.0
    if not cfg.window:
        return full
    w = min(cfg.window, S)
    local = w * (1 - w / (2.0 * S))        # exact mean of min(i, w)
    if cfg.local_global_alt:
        return 0.5 * (local + full)
    return local


def analytic_terms(cfg: ModelConfig, shape: ShapeConfig, *,
                   n_participants: int, local_steps: int = 1,
                   collective_total_bytes: int = 0,
                   chips: int = 256) -> dict:
    """FLOPs, model FLOPs, HBM bytes and the roofline's seconds of one
    step of ``cfg`` at ``shape`` on ``chips`` H100s (compute at the bf16
    peak, memory at the HBM rate, collectives at ``ici_bandwidth``)."""
    ps = param_stats(cfg)
    stats: dict = {"params": ps["total"], "param_bytes": ps["bytes"]}
    dt_bytes = getattr(torch, cfg.param_dtype).itemsize
    d, V = cfg.d_model, cfg.vocab
    L = cfg.n_layers

    attn_layers = 0 if cfg.family == "ssm" else L
    rec_flops_tok = 0.0
    if cfg.family == "ssm":
        H, hd = cfg.n_heads, cfg.resolved_head_dim()
        rec_flops_tok = 6.0 * H * hd * hd * L          # wkv state ops
    if cfg.family == "hybrid":
        rec_flops_tok += 6.0 * d * cfg.ssm_state * L   # selective scan

    if shape.kind == "train":
        # One round consumes global_batch×seq tokens total; the E axis
        # (local SGD / grad-accum micro-steps) SPLITS that batch, so it
        # does not multiply FLOPs — only the per-step parameter traffic.
        T = shape.global_batch * shape.seq_len
        ctx = _avg_ctx(cfg, shape.seq_len)
        fwd = (2.0 * ps["active"] * T
               + _attn_flops(cfg, T, ctx, attn_layers)
               + rec_flops_tok * T)
        if cfg.family == "moe":                        # dispatch/combine
            G = cfg.moe_group_size
            fwd += 4.0 * T * G * cfg.moe_top_k * cfg.moe_capacity_factor * d * L
        flops = 3.0 * fwd
        model_flops = 6.0 * ps["active"] * T
        replicas = max(n_participants, 1)
        act_bytes = ACT_ALPHA * L * T * d * dt_bytes
        logit_bytes = 8.0 * T * V                      # f32 logits r+w
        mem = (3.0 * ps["bytes"] * replicas * local_steps
               + act_bytes + logit_bytes)
    elif shape.kind == "prefill":
        T = shape.global_batch * shape.seq_len
        ctx = _avg_ctx(cfg, shape.seq_len)
        flops = (2.0 * ps["active"] * T
                 + _attn_flops(cfg, T, ctx, attn_layers)
                 + rec_flops_tok * T)
        model_flops = 2.0 * ps["active"] * T
        mem = ps["bytes"] + 2.0 * L * T * d * dt_bytes
    else:                                              # decode: one token
        B = shape.global_batch
        kv = cfg.n_kv_heads * cfg.resolved_head_dim()
        ctx = (min(cfg.window, shape.seq_len) if (cfg.window and not
               cfg.local_global_alt) else shape.seq_len)
        if cfg.local_global_alt and cfg.window:
            ctx = 0.5 * (min(cfg.window, shape.seq_len) + shape.seq_len)
        flops = (2.0 * ps["active"] * B
                 + _attn_flops(cfg, B, ctx, attn_layers)
                 + rec_flops_tok * B)
        model_flops = 2.0 * ps["active"] * B
        cache_bytes = 0.0
        if cfg.family not in ("ssm",):
            cache_bytes = 2.0 * attn_layers * B * ctx * kv * dt_bytes
        if cfg.family in ("ssm", "hybrid"):
            H, hd = cfg.n_heads, cfg.resolved_head_dim()
            cache_bytes += L * B * (H * hd * hd if cfg.family == "ssm"
                                    else d * cfg.ssm_state) * 4 * 2
        mem = ps["bytes"] + cache_bytes

    compute_s = flops / (chips * H100.peak_flops_bf16)
    memory_s = mem / (chips * H100.hbm_bandwidth)
    collective_s = collective_total_bytes / (chips * H100.ici_bandwidth)
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    stats.update({
        "flops": flops, "model_flops": model_flops,
        "useful_flop_ratio": model_flops / flops if flops else 0.0,
        "hbm_bytes": mem,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
    })
    return stats
