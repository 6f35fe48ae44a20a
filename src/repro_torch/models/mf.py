"""Matrix-factorization recommender (MoDeST Table 3, MovieLens).

Koren-style biased MF: r̂(u,i) = μ + b_u + b_i + p_u · q_i, embedding
dim 20 per the paper, trained with SGD on squared error + L2.
"""

from __future__ import annotations

import torch

from repro_torch.utils.device import resolve_device

L2 = 1e-4


def init(generator, cfg, device=None):
    """Random parameters from ``generator`` (a CPU ``torch.Generator``),
    placed on ``device`` (None = cuda)."""
    device = resolve_device(device)
    f32 = torch.float32

    def normal(shape):
        return (torch.randn(shape, generator=generator, dtype=f32,
                            device=generator.device) * 0.1).to(device)

    return {
        "users": normal((cfg.mf_users, cfg.mf_dim)),
        "items": normal((cfg.mf_items, cfg.mf_dim)),
        "b_user": torch.zeros((cfg.mf_users,), dtype=f32, device=device),
        "b_item": torch.zeros((cfg.mf_items,), dtype=f32, device=device),
        "mu": torch.tensor(3.0, dtype=f32, device=device),
    }


def predict(params, pairs):
    u, i = pairs[:, 0].long(), pairs[:, 1].long()
    dot = torch.sum(params["users"][u] * params["items"][i], dim=-1)
    return params["mu"] + params["b_user"][u] + params["b_item"][i] + dot


def loss_fn(params, cfg, batch):
    pred = predict(params, batch["x"])
    err = torch.square(pred - batch["y"])
    u, i = batch["x"][:, 0].long(), batch["x"][:, 1].long()
    reg_u = torch.sum(torch.square(params["users"][u]), -1)
    reg_i = torch.sum(torch.square(params["items"][i]), -1)
    mask = batch.get("mask")                   # per-row; padded rows drop out
    if mask is None:
        mse = torch.mean(err)
        reg = L2 * (torch.mean(reg_u) + torch.mean(reg_i))
    else:
        m = mask.to(torch.float32)
        denom = torch.clamp_min(torch.sum(m), 1.0)
        mse = torch.sum(err * m) / denom
        reg = L2 * (torch.sum(reg_u * m) + torch.sum(reg_i * m)) / denom
    return mse + reg, {"loss": mse, "mse": mse}
