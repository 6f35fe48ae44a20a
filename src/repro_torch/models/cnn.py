"""The paper's CNN image classifier (LeNet-style; MoDeST Table 3).

Conv net used by the protocol-form experiments (Figs. 3–6) — ~350 KB of
parameters at CIFAR shape, matching the paper's "CNN (LeNet)".

Layouts are the reference's: images NHWC, conv weights HWIO, the flattened
feature vector in (H, W, C) order. The transposes to PyTorch's NCHW / OIHW
happen in here and nowhere else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device


def init(generator, cfg, device=None):
    """Random parameters from ``generator`` (a CPU ``torch.Generator``),
    placed on ``device`` (None = cuda)."""
    device = resolve_device(device)
    H, W, C = cfg.cnn_image
    c1, c2 = cfg.cnn_channels
    f32 = torch.float32

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, dtype=f32,
                            device=generator.device) * scale).to(device)

    # two 5x5 convs + 2x2 pools -> spatial reduction by 4 (same padding)
    flat = (H // 4) * (W // 4) * c2
    conv1 = normal((5, 5, C, c1), 0.1)
    conv2 = normal((5, 5, c1, c2), 0.1)
    return {
        "conv1": conv1,
        "b1": torch.zeros((c1,), dtype=f32, device=device),
        "conv2": conv2,
        "b2": torch.zeros((c2,), dtype=f32, device=device),
        "fc1": L.dense_init(generator, (flat, 120), f32, device=device),
        "fc2": L.dense_init(generator, (120, 84), f32, device=device),
        "out": L.dense_init(generator, (84, cfg.cnn_classes), f32,
                            device=device),
    }


def _conv(x, w, b):
    """SAME conv + bias + relu; x NCHW, w HWIO."""
    kh, kw = w.shape[0], w.shape[1]
    y = F.conv2d(x.to(w.dtype), w.permute(3, 2, 0, 1), b,
                 padding=(kh // 2, kw // 2))
    return F.relu(y)


def _pool(x):
    return F.max_pool2d(x, 2)


def apply(params, cfg, x):
    """x: (B, H, W, C) -> logits (B, classes)."""
    x = x.permute(0, 3, 1, 2)
    x = _conv(x, params["conv1"], params["b1"])
    x = _pool(x)
    x = _conv(x, params["conv2"], params["b2"])
    x = _pool(x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"])
    x = F.relu(x @ params["fc2"])
    return x @ params["out"]


def loss_fn(params, cfg, batch):
    logits = apply(params, cfg, batch["x"])
    labels = batch["y"].long()
    mask = batch.get("mask")                   # per-row; padded rows drop out
    loss = L.softmax_xent(logits[:, None, :], labels[:, None],
                          mask if mask is None else mask[:, None])
    hit = (torch.argmax(logits, -1) == labels).to(torch.float32)
    if mask is None:
        acc = torch.mean(hit)
    else:
        m = mask.to(torch.float32)
        acc = torch.sum(hit * m) / torch.clamp_min(torch.sum(m), 1.0)
    return loss, {"loss": loss, "accuracy": acc}
