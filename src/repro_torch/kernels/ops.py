"""Public wrappers over the kernels: per-leaf aggregation of flat stacks
and pytrees, int8 delta quantisation and its inverse, and whole-model
one-pass aggregation of FlatModels and pytrees, plain and over sealed rows.

Each wrapper runs where its inputs live: the CUDA kernels on the card, their
plain versions on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.flat import FlatModel, FlatSpec, _is_int, as_buffer
from repro_torch.kernels.aggregate import aggregate_tiles
from repro_torch.kernels.fused import (
    aggregate_flat_onepass, aggregate_flat_onepass_sharded,
    aggregate_quantize_flat, aggregate_quantize_flat_sharded,
    unmask_aggregate_flat, unmask_aggregate_flat_sharded,
    unmask_aggregate_quantize_flat, unmask_aggregate_quantize_flat_sharded)
from repro_torch.kernels.quantize import (TILE, dequantize_tiles, n_tiles,
                                          quantize_tiles)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import check_aggregation_weights as _check_weights
from repro_torch.utils.pytree import tree_flatten


def _host_weights(w):
    """Weights as a CPU fp32 tensor (read on the host for the check)."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(w, np.float32))


def aggregate_flat(x, w):
    """x: (P, N) stacked flattened models; w: (P,) (host values or a
    tensor). Weighted mean (N,) in ``x.dtype``: one launch of the per-leaf
    kernel on the card. A non-positive total weight raises."""
    w = _host_weights(w)
    _check_weights(w)
    return aggregate_tiles(x, w.to(x.device))


def aggregate_pytree(models, weights):
    """MoDeST aggregation over a list of model pytrees via the per-leaf
    kernel: one launch per leaf.

    Integer leaves (optimizer step counters, token counts) go through the
    kernel as fp32 and are rounded half to even at the end, so 6.999999
    comes back as 7, not 6. Every leaf comes back in its own dtype and
    shape (0-dim leaves included). The hot loop uses
    :func:`aggregate_flatmodel` (one launch per model) instead.
    """
    w = _host_weights(weights)
    _check_weights(w)
    on = {}

    def leaf(*xs):
        dt, dev = xs[0].dtype, xs[0].device
        if dev not in on:
            on[dev] = w.to(dev)
        is_int = _is_int(dt)
        flat = [x.reshape(-1).to(torch.float32) if is_int else x.reshape(-1)
                for x in xs]
        out = aggregate_tiles(torch.stack(flat), on[dev]).reshape(xs[0].shape)
        if is_int:
            out = torch.round(out)
        return out.to(dt)

    first, treedef = tree_flatten(models[0])
    rest = [treedef.flatten_up_to(m) for m in models[1:]]
    return treedef.unflatten([leaf(*xs) for xs in zip(first, *rest)])


def quantize_flat(x):
    """x: (N,) -> (int8 codes (N,), per-TILE scales (ceil(N/TILE),)): the
    codes of ``x`` padded with zeros to whole tiles, trimmed to ``N``; the
    scales are not trimmed."""
    return quantize_tiles(x)


def dequantize_flat(q, s, n=None, *, dtype=torch.float32):
    """Codes and scales -> (n,) values in ``dtype`` (``n`` defaults to the
    number of codes). As in the reference, the codes stand for a
    zero-padded vector of whole tiles, so an ``n`` past the codes reads
    zeros up to the end of the last tile."""
    out = dequantize_tiles(q, s, dtype=dtype)
    if n is None:
        return out
    N = q.shape[0]
    if n > N:
        out = torch.nn.functional.pad(out, (0, min(n, n_tiles(N) * TILE) - N))
    return out[:n]


def quantized_delta_push(theta, theta_ref):
    """Compressed model push: int8(θ − θ_ref) + scales, per leaf.

    Returns ``(codes_tree, scales_tree)``; the delta of each leaf is taken
    in fp32 and quantised in one launch. Reconstruct with
    :func:`quantized_delta_pull`. Wire size ≈ params × 1 byte + 4/TILE.
    """
    leaves, treedef = tree_flatten(theta)
    refs = treedef.flatten_up_to(theta_ref)
    pairs = [quantize_flat((t.to(torch.float32) - r.to(torch.float32))
                           .reshape(-1)) for t, r in zip(leaves, refs)]
    return (treedef.unflatten([p[0] for p in pairs]),
            treedef.unflatten([p[1] for p in pairs]))


def quantized_delta_pull(codes, scales, theta_ref):
    """θ_ref + dequant(codes, scales), per leaf, in θ_ref's dtypes: one
    dequantise launch per leaf (to fp32), then the add in fp32."""
    refs, treedef = tree_flatten(theta_ref)
    qs = treedef.flatten_up_to(codes)
    ss = treedef.flatten_up_to(scales)
    out = []
    for q, s, r in zip(qs, ss, refs):
        d = dequantize_flat(q, s, n=r.numel())
        out.append((r.to(torch.float32) + d.reshape(r.shape)).to(r.dtype))
    return treedef.unflatten(out)


def _sharded(shardings, device):
    """True where ``shardings`` splits the aggregation (more than one
    shard, or a world's mesh of any size); its home must be ``device``,
    where the models live and the result lands (the mesh's first device,
    or in a world this rank's)."""
    if shardings is None or (shardings.n_shards <= 1
                             and shardings.group is None):
        return False
    if shardings.replicated.home != device:
        raise ValueError(f"mesh starts at {shardings.replicated.home}, "
                         f"aggregation on {device}")
    return True


def aggregate_flatmodel(models, weights=None, *, spec=None, quantize=False,
                        device=None, shardings=None):
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

    ``shardings``: a :class:`repro_torch.sharding.FlatShardings` (from
    ``spec.sharding(mesh)``, its mesh starting at ``device``) splits the
    parameter axis over the mesh and aggregates per shard; mean, codes and
    scales are bit-identical to the single-device path. Ignored on a
    1-shard mesh.
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
    if _sharded(shardings, device):
        if quantize:
            mean, codes, scales = aggregate_quantize_flat_sharded(
                x, w, int_mask, mesh=shardings)
            return FlatModel(mean, spec), codes, scales
        return FlatModel(aggregate_flat_onepass_sharded(
            x, w, int_mask, mesh=shardings), spec)
    if quantize:
        mean, codes, scales = aggregate_quantize_flat(x, w, int_mask)
        return FlatModel(mean, spec), codes, scales
    return FlatModel(aggregate_flat_onepass(x, w, int_mask), spec)


def masked_aggregate_flatmodel(models, weights=None, *, seeds, signs,
                               spec=None, quantize=False, device=None,
                               shardings=None):
    """Secure-aggregation twin of :func:`aggregate_flatmodel`.

    ``models`` are FlatModels whose buffers hold *sealed* bit patterns
    (``repro_torch.secureagg.masking``); ``seeds``/``signs`` are the
    per-row ``(P, R)`` mask-derivation matrices of
    ``PairwiseMasker.unmask_matrices`` (array-likes of integers). The
    kernel regenerates each row's mask from its seeds, removes it exactly
    in the uint32 ring and runs the identical aggregate(→quantize) math:
    mean, codes and scales are bit-identical to :func:`aggregate_flatmodel`
    on the unsealed rows, on one device or split by ``shardings``. The
    sealed rows are only ever copied as bits.
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
    if _sharded(shardings, device):
        kw = dict(seeds=seeds, signs=signs, mesh=shardings)
        if quantize:
            mean, codes, scales = unmask_aggregate_quantize_flat_sharded(
                y, w, int_mask, **kw)
            return FlatModel(mean, spec), codes, scales
        return FlatModel(unmask_aggregate_flat_sharded(y, w, int_mask, **kw),
                         spec)
    if quantize:
        mean, codes, scales = unmask_aggregate_quantize_flat(
            y, w, int_mask, seeds=seeds, signs=signs)
        return FlatModel(mean, spec), codes, scales
    return FlatModel(unmask_aggregate_flat(y, w, int_mask, seeds=seeds,
                                           signs=signs), spec)
