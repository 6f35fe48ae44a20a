"""Shared layers: init helpers and the masked cross entropy."""

from __future__ import annotations

from typing import Optional

import torch


def dense_init(generator, shape, dtype, scale: Optional[float] = None,
               device=None):
    """Normal(0, scale²) weights, ``scale`` defaulting to fan_in^-1/2.
    Drawn from ``generator`` (on the generator's device) and then moved,
    so the same seed gives the same weights on every device."""
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return w.to(dtype=dtype, device=device)


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
