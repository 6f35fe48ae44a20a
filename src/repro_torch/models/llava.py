"""LLaVA-NeXT with Mistral-7B backbone (llava-next-mistral-7b).

As in the reference, the vision tower and projector are a stub: the batch
brings precomputed patch embeddings at ``d_model`` (``image_tokens`` per
tile x ``anyres_tiles`` tiles, the anyres grid) as ``image_embeds``. This
module is the language side: embeddings = [image patches ‖ text tokens], a
causal LM loss on the text positions, Mistral's sliding window. The
parameters, cache and decode step are the dense backbone's, and so is its
split under ``layers.tensor_parallel``: the image embeddings are a
replicated input, the text tokens' lookup is vocab-parallel and the loss
is the dense head's (``transformer.head_loss``) on the text positions.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T

init = T.init                       # identical backbone parameters
init_cache = T.init_cache


def n_image_tokens(cfg) -> int:
    return cfg.image_tokens * cfg.anyres_tiles


def _merge(params, cfg, batch):
    """[image ‖ text] embeddings and the number of image positions."""
    img = batch["image_embeds"].to(getattr(torch, cfg.param_dtype))
    tok = T.embed_tokens(params, cfg, batch["tokens"])
    return torch.cat([img, tok], dim=1), img.shape[1]


def loss_fn(params, cfg, batch):
    x, n_img = _merge(params, cfg, batch)
    S_total = x.shape[1]
    h = T.stack_forward(params, cfg, x,
                        torch.arange(S_total, device=x.device))
    loss = T.head_loss(params, cfg, h[:, n_img:],          # text positions
                       batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


def prefill(params, cfg, batch, cache):
    """Prompt = image patches + text prefix."""
    x, _ = _merge(params, cfg, batch)
    return T.prefill_embeds(params, cfg, x, cache)


decode_step = T.decode_step          # identical to the dense backbone
