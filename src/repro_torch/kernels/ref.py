"""Plain-torch oracles for the kernels (tests assert against these).

Division is IEEE everywhere. On a CUDA tensor PyTorch turns ``x / 127.0``
(a python scalar divisor) into a multiplication by the reciprocal, which
can differ from the division by one ulp; the divisor is therefore a
0-dim tensor on the input's device, which takes the true-division path on
both devices and matches ``__fdiv_rn`` in the CUDA kernels.
"""

from __future__ import annotations

import torch

TILE = 16384     # quantization granularity; equals kernels.fused.SUBTILE


def aggregate_ref(x, w):
    """x: (P, N); w: (P,) -> (N,) weighted mean, fp32 accumulation."""
    wf = w.to(torch.float32)
    total = torch.clamp_min(torch.sum(wf), 1e-9)
    out = torch.tensordot(wf, x.to(torch.float32), dims=([0], [0])) / total
    return out.to(x.dtype)


def quantize_ref(x):
    """x: (N,) -> (codes int8 (N,), scales f32 (N/TILE,)), per-tile absmax."""
    N = x.shape[0]
    t = x.to(torch.float32).reshape(N // TILE, TILE)
    absmax = torch.amax(torch.abs(t), dim=1)
    scales = torch.clamp_min(absmax, 1e-12) / torch.full(
        (), 127.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(t / scales[:, None]), -127, 127)
    return q.to(torch.int8).reshape(N), scales


def dequantize_ref(q, s, dtype=torch.float32):
    N = q.shape[0]
    t = q.to(torch.float32).reshape(N // TILE, TILE) * s[:, None]
    return t.reshape(N).to(dtype)


def flash_attention_ref(q, k, v, causal=True):
    """Full-softmax GQA attention oracle. q: (B,Hq,S,hd); k/v: (B,Hkv,S,hd)."""
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, S, hd).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bkgsh,bkth->bkgst", qg, kf) * hd ** -0.5
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bkth->bkgsh", p, vf)
    return out.reshape(B, Hq, S, hd).to(q.dtype)
