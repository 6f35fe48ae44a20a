"""Public wrappers over the aggregation kernels: whole-model one-pass
aggregation of FlatModels and pytrees, plain and over sealed rows."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.flat import FlatModel, FlatSpec, as_buffer
from repro_torch.kernels.fused import (aggregate_flat_onepass,
                                       aggregate_quantize_flat,
                                       unmask_aggregate_flat,
                                       unmask_aggregate_quantize_flat)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import check_aggregation_weights as _check_weights


def aggregate_flatmodel(models, weights=None, *, spec=None, quantize=False,
                        device=None):
    """Whole-model one-pass aggregation over FlatModels (or pytrees).

    ``models``: list of :class:`~repro_torch.engine.flat.FlatModel` and/or
    pytrees (mixed is fine — trees are packed against ``spec``, derived
    from the first model when omitted). Returns a FlatModel; with
    ``quantize=True`` returns ``(FlatModel, codes int8 (n,), scales)``
    from the fused aggregate→quantize kernel — no extra round trip through
    device memory.

    ``device``: where the models live and the aggregation runs; None means
    the card. Models on another device raise (nothing is moved behind the
    caller's back). On the card the CUDA kernels run; on the CPU their
    plain versions.
    """
    if weights is None:
        weights = [1.0] * len(models)
    _check_weights(weights)
    device = resolve_device(device)
    if spec is None:
        first = models[0]
        spec = first.spec if isinstance(first, FlatModel) else \
            FlatSpec.from_tree(first)
    bufs = [as_buffer(m, spec) for m in models]
    for b in bufs:
        if b.device != device:
            raise ValueError(f"model on {b.device}, aggregation on {device}")
    x = torch.stack(bufs)
    w = torch.tensor([float(v) for v in weights], dtype=torch.float32,
                     device=device)
    int_mask = spec.int_mask_on(device)
    if quantize:
        mean, codes, scales = aggregate_quantize_flat(x, w, int_mask)
        return FlatModel(mean, spec), codes, scales
    return FlatModel(aggregate_flat_onepass(x, w, int_mask), spec)


def masked_aggregate_flatmodel(models, weights=None, *, seeds, signs,
                               spec=None, quantize=False, device=None):
    """Secure-aggregation twin of :func:`aggregate_flatmodel`.

    ``models`` are FlatModels whose buffers hold *sealed* bit patterns
    (``repro_torch.secureagg.masking``); ``seeds``/``signs`` are the
    per-row ``(P, R)`` mask-derivation matrices of
    ``PairwiseMasker.unmask_matrices`` (array-likes of integers). The
    kernel regenerates each row's mask from its seeds, removes it exactly
    in the uint32 ring and runs the identical aggregate(→quantize) math:
    mean, codes and scales are bit-identical to :func:`aggregate_flatmodel`
    on the unsealed rows. The sealed rows are only ever copied as bits.
    """
    if weights is None:
        weights = [1.0] * len(models)
    _check_weights(weights)
    device = resolve_device(device)
    if spec is None:
        spec = models[0].spec
    bufs = [as_buffer(m, spec) for m in models]
    for b in bufs:
        if b.device != device:
            raise ValueError(f"model on {b.device}, aggregation on {device}")
    y = torch.stack([b.view(torch.int32) for b in bufs]).view(torch.float32)
    w = torch.tensor([float(v) for v in weights], dtype=torch.float32,
                     device=device)
    seeds = torch.as_tensor(np.asarray(seeds, np.int64), device=device)
    signs = torch.as_tensor(np.asarray(signs, np.int64), device=device)
    int_mask = spec.int_mask_on(device)
    if quantize:
        mean, codes, scales = unmask_aggregate_quantize_flat(
            y, w, int_mask, seeds=seeds, signs=signs)
        return FlatModel(mean, spec), codes, scales
    return FlatModel(unmask_aggregate_flat(y, w, int_mask, seeds=seeds,
                                           signs=signs), spec)
