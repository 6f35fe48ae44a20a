"""Shared layers: init helpers, norms (RMS and layer norm), RoPE, GQA
attention (prefill and cached decode, sliding-window and soft-cap
variants), the gated and GELU MLPs and the cross entropies.

Conventions, as in the reference:
* params are dicts of tensors; the model modules stack them along a leading
  layer axis.
* activations compute in bfloat16 when params are bf16, with fp32 scores,
  softmax and loss; the reduced smoke configs run fully in fp32.
* attention masks: ``causal`` plus an optional ``window`` (key within the
  last W positions); gemma2's ``local_global_alt`` alternates window/full by
  layer parity (even layers local).
* random init draws from a ``torch.Generator`` on the generator's device
  and then moves, so one seed gives the same weights on every device.

Tensor parallelism (a world's ``model`` axis, :func:`tensor_parallel`):
inside the block the layers take the local shards that
``sharding.ShardingPolicy``'s rules give a rank and meet in the
collectives of :mod:`repro_torch.collectives`. The query, key and value
projections and the MLP's first products are column-parallel (the rank's
heads, its slice of d_ff), the attention output and the MLP's last product
row-parallel (the fp32 partials summed over the group); the embedding and
the LM head are split by vocab (a masked local lookup summed over the
group, and :func:`vocab_parallel_xent`); the MoE's experts by their
leading axis (:func:`expert_split`, ``models/moe.py``). A layer reads from
its weights' shapes whether they are split: a dimension that the rules
replicate (a vocab or head count the axis does not divide,
``replicate_attention``) needs no collective. The residual stream and the norms stay replicated.
Where the axis divides the query heads but not the kv heads (the world
rule ``kv_whole``), ``wk`` and ``wv`` are whole on every rank: a rank's
query heads read their kv group's columns, and *f* on the weights sums
their gradient over the group (:func:`_local_heads`).

A cache split by sequence (:func:`seq_split`: T over ``model`` where the
kv heads do not divide it, or over ``data`` under ``shard_seq``): rank
``r`` of ``n`` holds the positions ``[r T/n, (r+1) T/n)`` of every kv
head of its cache. Every write goes through :func:`write_prefill` (the
positions of the rank's chunk) or the decode (the new token on the rank
that owns ``pos``); the models build their validity vectors over global
positions (:func:`cache_positions`). A decode computes fp32 partials over
the rank's chunk (the row max ``m``, the sum of exponentials ``l``, the
weighted values ``o``), gathers them over the chunk's axis in one
``all_gather`` a layer and combines them in rank order, so that every rank
holds the same bits (:func:`_cached_attention`); a chunk with no valid
position has ``l = o = 0``. Where T is split over ``model``, the rank
gathers ``q`` over ``model`` first, attends with every head and keeps its
own heads' output for its row-parallel ``wo``.

Rows split over ranks (:func:`split_rows`: serving's batch over ``data``,
FSDP's participant rows): a MoE layer routes its own tokens in the
one-process groups (``models/moe.py``), and under training the means over
the rows (:func:`rows_mean`, :func:`token_mean`) are one participant's.

FSDP (a world's ``data`` axis at ``pod`` granularity, :func:`fully_sharded`):
a rank holds its ``data`` slice of every leaf the rules split there (the
``F`` entries of ``sharding.ShardingPolicy``), and the layers gather a
leaf over ``data`` just before they read it (:func:`gathered_layer` for a
layer of the stack, :func:`param` for a top-level leaf): what they get is
the rank's tensor-parallel slice, read by its shape as above. The gather's
backward reduce-scatters the gradient over ``data``
(``collectives.gather_shards``). Under ``cfg.remat`` a block runs under a
non-reentrant checkpoint with its gathers inside (:func:`remat`): the
gathered weights are freed when its forward ends and gathered again for
its backward.

Drawing (:func:`drawing`): every weight :func:`dense_init` and
:func:`embed_init` draw, and every stack of blocks (:func:`stack_blocks`),
passes through a hook, so that a rank may keep only its slices of each
leaf as it is drawn (``core.distributed.draw_local``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import collectives
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.sharding import _k
from repro_torch.utils.pytree import tree_flatten_with_path, tree_map


class TensorParallel(NamedTuple):
    """The group of the tensor-parallel axis, this rank's index on it and
    its size."""
    group: Any
    rank: int
    size: int


_TP: Optional[TensorParallel] = None


@contextmanager
def tensor_parallel(mesh, axis: str = "model"):
    """Run the layers inside the block tensor-parallel over ``axis`` of a
    world's ``mesh`` (a no-op for a mesh outside a world, for None, and
    for an axis of size 1)."""
    global _TP
    prev = _TP
    if (mesh is not None and getattr(mesh, "in_world", False)
            and mesh.axis_size(axis) > 1):
        _TP = TensorParallel(mesh.group(axis), mesh.axis_index(axis),
                             mesh.axis_size(axis))
    else:
        _TP = None
    try:
        yield _TP
    finally:
        _TP = prev


class FullyShardedData(NamedTuple):
    """The group of the FSDP axis, its size, the dimension each leaf is
    split along (by its '/'-joined path; a layer's leaves by their path
    under the stack, the layer axis taken off; absent: whole), and whether
    blocks recompute their forward for the backward (``cfg.remat``)."""
    group: Any
    size: int
    dims: Dict[str, int]
    remat: bool


_FSDP: Optional[FullyShardedData] = None


@contextmanager
def fully_sharded(mesh, dims: Dict[str, int], *, remat: bool = False):
    """Run the layers with the leaves of ``dims`` split over the ``data``
    axis of a world's ``mesh`` (the rules' FSDP axis) and gathered where
    they are read (a no-op for a mesh outside a world, for None, and for
    an axis of size 1)."""
    global _FSDP
    prev = _FSDP
    if (mesh is not None and getattr(mesh, "in_world", False)
            and mesh.axis_size("data") > 1):
        _FSDP = FullyShardedData(mesh.group("data"), mesh.axis_size("data"),
                                 dict(dims), remat)
    else:
        _FSDP = None
    try:
        yield _FSDP
    finally:
        _FSDP = prev


class RowSplit(NamedTuple):
    """The rows of a batch split over a world's axis, in contiguous
    blocks: the axis's group, this rank's index and its size, and whether
    the loss's means are one participant's over every rank's rows
    (training; serving discards the MoE's load-balance loss)."""
    group: Any
    rank: int
    size: int
    means: bool


_ROWS: Optional[RowSplit] = None


@contextmanager
def split_rows(mesh, axis, *, means: bool = False):
    """Run the layers on this rank's contiguous block of a batch's rows,
    split over ``axis`` of a world's ``mesh`` (a no-op for a mesh outside
    a world, for None, and for an axis of size 1)."""
    global _ROWS
    prev = _ROWS
    if (mesh is not None and getattr(mesh, "in_world", False)
            and mesh.axis_size(axis) > 1):
        _ROWS = RowSplit(mesh.group(axis), mesh.axis_index(axis),
                         mesh.axis_size(axis), means)
    else:
        _ROWS = None
    try:
        yield _ROWS
    finally:
        _ROWS = prev


def row_split() -> Optional[RowSplit]:
    """The rows' split of :func:`split_rows`, or None."""
    return _ROWS


class SeqChunk(NamedTuple):
    """A cache's sequence split over a world's axis (its name): the
    axis's group, this rank's index on it and its size."""
    axis: str
    group: Any
    rank: int
    size: int


_SEQ: Dict[str, SeqChunk] = {}


@contextmanager
def seq_split(mesh, axes: Dict[str, Optional[str]]):
    """Run the layers with the caches of ``axes`` (``{"k": axis, "xk":
    axis}``: the self-attention's keys and values, Whisper's cross cache;
    None: whole) split by sequence over those axes of a world's ``mesh``
    (an axis of size 1, or a mesh outside a world, splits nothing)."""
    global _SEQ
    prev = _SEQ
    on = mesh is not None and getattr(mesh, "in_world", False)
    _SEQ = {name: SeqChunk(a, mesh.group(a), mesh.axis_index(a),
                           mesh.axis_size(a))
            for name, a in axes.items()
            if on and a is not None and mesh.axis_size(a) > 1}
    try:
        yield _SEQ
    finally:
        _SEQ = prev


def _chunk(cache, which: str):
    """``(chunk, first, T)`` of one layer's cache ``(B, T_local, ...)``:
    its :class:`SeqChunk` (None: whole), its first global position and
    the whole cache's length."""
    c = _SEQ.get(which)
    n = cache.shape[1]
    return (c, c.rank * n, c.size * n) if c is not None else (None, 0, n)


def cache_positions(cache, which: str = "k"):
    """The global positions ``arange(T)`` of a layer-stacked cache leaf
    ``(L, B, T_local, ...)`` (the models' validity vectors are built over
    them, so windows and local/global layers read the same positions on
    every rank)."""
    return torch.arange(_chunk(cache[0], which)[2], device=cache.device)


def write_prefill(dst, src, which: str = "k"):
    """Write a prompt's keys or values ``src`` (B, S, KV, hd), positions
    ``0 .. S-1``, into one layer's cache ``dst`` (B, T_local, KV, hd):
    under :func:`seq_split`, the positions of this rank's chunk only."""
    _, lo, T = _chunk(dst, which)
    if src.shape[1] > T:
        raise IndexError(f"a prompt of {src.shape[1]} positions into a "
                         f"cache of {T}")
    n = min(src.shape[1] - lo, dst.shape[1])
    if n > 0:
        dst[:, :n] = src[:, lo:lo + n]


def _gathered(x, path: str):
    dim = None if _FSDP is None else _FSDP.dims.get(path)
    return x if dim is None else collectives.gather_shards(x, _FSDP.group,
                                                          dim)


def param(params, key: str):
    """The top-level leaf ``params[key]`` as the layers read it: under
    :func:`fully_sharded`, gathered over the group."""
    return _gathered(params[key], key)


def gathered_layer(layer, prefix: str):
    """A layer's leaves (a tree, its paths under ``prefix``: ``layers``,
    ``encoder``, ``decoder``) as the layers read them: under
    :func:`fully_sharded`, each leaf split over the group gathered."""
    if _FSDP is None:
        return layer
    flat, treedef = tree_flatten_with_path(layer)
    return treedef.unflatten([
        _gathered(x, "/".join([prefix] + [_k(p) for p in path]))
        for path, x in flat])


def remat() -> bool:
    """Whether a block runs under a checkpoint: :func:`fully_sharded` with
    ``remat`` on, where autograd records."""
    return _FSDP is not None and _FSDP.remat and torch.is_grad_enabled()


def rows_sum(x):
    """A sum over one participant's rows (``x`` this rank's part): under
    :func:`split_rows` with ``means``, the group's sum, whose gradient
    reaches every rank's ``x`` as one process's would (the group's sum
    both ways: each rank's loss holds the whole sum, and the step takes the
    mean of the ranks' gradients); else ``x``."""
    if _ROWS is None or not _ROWS.means:
        return x
    y = collectives.copy_to_group(x, _ROWS.group)
    return collectives.reduce_from_group(y, _ROWS.group)


def rows_mean(x):
    """A mean over one participant's rows (``x`` this rank's mean): the
    mean of the ranks' means (equal row counts) under :func:`split_rows`
    with ``means`` (:func:`rows_sum`); else ``x``."""
    if _ROWS is None or not _ROWS.means:
        return x
    return rows_sum(x) / _ROWS.size


def token_mean(total, count):
    """A loss's mean ``total / count`` over valid tokens. Under
    :func:`split_rows` with ``means`` the count is the participant's (one
    all-reduce over the group), and the rank's share is scaled by the
    group's size, so that the mean of the ranks' losses and of their
    gradients (the step's) is one process's, however unequal the ranks'
    valid counts."""
    if _ROWS is None or not _ROWS.means:
        return total / torch.clamp_min(count, 1.0)
    n = collectives.all_reduce(count.detach().clone(), _ROWS.group)
    return total * _ROWS.size / torch.clamp_min(n, 1.0)


def _copy_in(x, split: bool):
    """A column-parallel product's input (its gradient summed over the
    group backward)."""
    return collectives.copy_to_group(x, _TP.group) if split else x


def _reduce_out(y, split: bool):
    """A row-parallel product's partial output summed over the group."""
    return collectives.reduce_from_group(y, _TP.group) if split else y


def is_split(n_local: int, n_all: int) -> bool:
    """Whether a dimension of ``n_all`` of which this rank's weights hold
    ``n_local`` is split over the group under :func:`tensor_parallel`."""
    return _TP is not None and n_local != n_all


def gather_lanes(y, n_all: int):
    """The whole ``(..., n_all)`` from each rank's contiguous lanes ``y``
    of it (a column-parallel output): this rank's lanes put into zeros of
    the whole width and summed over the group (Megatron's *g*; exact, each
    lane is one rank's value plus zeros). Backward, the rank's lanes of
    the whole gradient, which every rank holds alike."""
    n = y.shape[-1]
    y = F.pad(y, (_TP.rank * n, n_all - (_TP.rank + 1) * n))
    return collectives.reduce_from_group(y, _TP.group)


def vocab_split(head_w, vocab: int, transposed: bool = False) -> bool:
    """Whether ``head_w`` (d, V) — (V, d) ``transposed`` — is this rank's
    vocab slice under :func:`tensor_parallel`."""
    return _TP is not None and head_w.shape[0 if transposed else 1] != vocab


def expert_split(n_local: int, n_all: int):
    """``(slice, group)`` under :func:`tensor_parallel` where a weight's
    leading expert axis of ``n_all`` is split (this rank holds ``n_local``):
    the experts this rank holds and the group; else None."""
    if _TP is None or n_local == n_all:
        return None
    return slice(_TP.rank * n_local, (_TP.rank + 1) * n_local), _TP.group


def embed_lookup(table, tokens, vocab: int):
    """``table[tokens]``; under :func:`tensor_parallel` with the table
    split by vocab, the rows this rank holds (others zero) summed over the
    group."""
    if _TP is None or table.shape[0] == vocab:
        return table[tokens]
    n = table.shape[0]
    local = tokens.long() - _TP.rank * n
    ok = (local >= 0) & (local < n)
    x = table[torch.where(ok, local, torch.zeros_like(local))]
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return collectives.reduce_from_group(x, _TP.group)


def vocab_logits(h, head_w, *, transposed: bool = False):
    """Serving's logits (no autograd) from this rank's vocab slice of the
    head, gathered over the group along the vocab: every rank holds the
    whole (..., V) logits."""
    local = (torch.einsum("...d,vd->...v", h, head_w) if transposed
             else h @ head_w)
    return collectives.all_gather(local, _TP.group, dim=-1)


def lm_logits(h, head_w, vocab: int):
    """Serving's fp32 logits ``h @ head_w``; a head split by vocab has its
    slices gathered over the group (:func:`vocab_logits`)."""
    if vocab_split(head_w, vocab):
        return vocab_logits(h, head_w).to(torch.float32)
    return (h @ head_w).to(torch.float32)


def lm_xent(h, head_w, labels, vocab: int, mask=None):
    """The LM loss of ``h`` under the head ``head_w`` (d, V), the whole
    sequence at once: :func:`softmax_xent` of the logits, or
    :func:`vocab_parallel_xent` where the head is this rank's vocab slice."""
    if vocab_split(head_w, vocab):
        return vocab_parallel_xent(h, head_w, labels, mask=mask)
    return softmax_xent(h @ head_w, labels, mask)


_DRAW = None


@contextmanager
def drawing(hook):
    """Pass every weight :func:`dense_init` / :func:`embed_init` draw
    through ``hook.drawn(w)`` (the fp32 draw; what it returns is cast and
    kept in the tree), and tell ``hook.stacked(parts, out)`` of every
    stack of blocks (:func:`stack_blocks`)."""
    global _DRAW
    prev, _DRAW = _DRAW, hook
    try:
        yield hook
    finally:
        _DRAW = prev


def _drawn(w, dtype, device):
    """A drawn weight ``w`` in ``dtype`` on ``device``: under
    :func:`drawing`, what the hook keeps of it, taken before the cast
    (an elementwise cast: the same bits as a slice of the cast whole,
    without a second whole copy)."""
    if _DRAW is not None:
        w = _DRAW.drawn(w)
    return w.to(dtype=dtype, device=device)


def stack_blocks(blocks):
    """The blocks' (trees of one layer's leaves) leaves stacked along a new
    leading layer axis."""
    def stack(*parts):
        out = torch.stack(parts)
        if _DRAW is not None:
            _DRAW.stacked(parts, out)
        return out

    return tree_map(stack, *blocks)


def _is_meta(device) -> bool:
    """An init on the ``meta`` device gives shapes and dtypes only: it
    draws nothing (a layout needs no weights)."""
    return device is not None and torch.device(device).type == "meta"


def dense_init(generator, shape, dtype, scale: Optional[float] = None,
               device=None):
    """Normal(0, scale²) weights, ``scale`` defaulting to fan_in^-1/2.
    Drawn from ``generator`` (on the generator's device) and then moved,
    so the same seed gives the same weights on every device; on ``meta``
    nothing is drawn."""
    if _is_meta(device):
        return _drawn(torch.empty(shape, dtype=dtype, device="meta"),
                      dtype, "meta")
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device).mul_(scale)
    return _drawn(w, dtype, device)


def embed_init(generator, vocab, d, dtype, device=None):
    if _is_meta(device):
        return _drawn(torch.empty((vocab, d), dtype=dtype, device="meta"),
                      dtype, "meta")
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=generator.device).mul_(0.02)
    return _drawn(w, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm_init(d, dtype, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}  # (1+scale)


def rms_norm(p, x, eps=1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def layer_norm_init(d, dtype, device=None):
    return {"bias": torch.zeros((d,), dtype=dtype, device=device),
            "scale": torch.ones((d,), dtype=dtype, device=device)}


def layer_norm(p, x, eps=1e-5):
    """Over the last dim, in fp32; the variance is the population one, as
    ``jnp.var`` (``correction=0``; ``torch.var`` defaults to 1)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freq / half)                          # (half,)
    ang = positions[..., None].to(torch.float32) * inv     # (..., S, half)
    ang = ang[..., None, :]                                # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_init(generator, cfg, dtype, d_in: Optional[int] = None,
                   device=None):
    d = d_in or cfg.d_model
    hd = cfg.resolved_head_dim()
    return {
        "wq": dense_init(generator, (d, cfg.n_heads * hd), dtype, device=device),
        "wk": dense_init(generator, (d, cfg.n_kv_heads * hd), dtype,
                         device=device),
        "wv": dense_init(generator, (d, cfg.n_kv_heads * hd), dtype,
                         device=device),
        "wo": dense_init(generator, (cfg.n_heads * hd, d), dtype, device=device),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _gqa_scores(q, k, n_kv: int):
    """q: (B,S,H,hd), k: (B,T,KV,hd) -> scores (B,S,KV,G,T), fp32."""
    B, S, H, hd = q.shape
    g = H // n_kv
    qg = q.reshape(B, S, n_kv, g, hd)
    return torch.einsum("bskgh,btkh->bskgt", qg.to(torch.float32),
                        k.to(torch.float32)) * (hd ** -0.5)


def _gqa_out(probs, v, H: int):
    """probs: (B,S,KV,G,T), v: (B,T,KV,hd) -> (B,S,H*hd)."""
    out = torch.einsum("bskgt,btkh->bskgh", probs, v.to(torch.float32))
    B, S = out.shape[:2]
    return out.reshape(B, S, H * v.shape[-1])


def causal_mask(S: int, T: int, *, offset: int = 0, window: int = 0,
                device=None):
    """(S,T) bool mask; query position i attends key j iff j <= i+offset and
    (no window or i+offset-j < window)."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= (qpos - kpos) < window
    return m


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def attention(p, x, cfg, *, window: int = 0, positions=None,
              kv_override=None, mask=None):
    """Full (train/prefill) self- or cross-attention.

    ``kv_override`` (the keys' and values' input) switches to
    cross-attention over encoder states, or, where it is ``x`` itself, to
    self-attention without RoPE (Whisper's bidirectional encoder). Under
    :func:`tensor_parallel` ``x`` is a column-parallel input (Megatron's
    *f*, which ``x`` as ``kv_override`` shares); another ``kv_override``
    is not: the caller sums its gradient over the group, once for all the
    layers that read it (``whisper._enc_in``). ``mask`` overrides the
    causal mask (None + kv_override = full visibility). With
    ``cfg.use_flash`` and a plain-causal setup (no
    window/softcap) at ``S % 128 == 0`` — the reference's dispatch, kept
    verbatim so the kernel runs exactly where the reference's does — the
    causal flash kernel computes it, reading the (B,S,H,hd) projections
    through strides. Returns ``(out, (k, v))``: the keys, rotated, and the
    values, (B,S,KV,hd), are what a prefill writes into its cache (the
    reference returns ``out`` alone and its prefill projects them again).
    """
    B, S, d = x.shape
    hd = cfg.resolved_head_dim()
    H, KV, split, kv, wk, wv = _local_heads(p, cfg)
    own_kv = kv_override is x
    x = _copy_in(x, split)
    q = _split_heads(x @ p["wq"], H, hd)
    if kv_override is None:
        k = _split_heads(x @ wk, KV, hd)
        v = _split_heads(x @ wv, KV, hd)
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if (cfg.use_flash and not cfg.attn_softcap and not window
                and not cfg.local_global_alt and S % 128 == 0):
            out = flash_attention_bshd(q, k[:, :, kv], v[:, :, kv],
                                       causal=True)
            out = out.reshape(B, S, H * hd) @ p["wo"]
            return _reduce_out(out, split), (k, v)
        if mask is None:
            mask = causal_mask(S, S, window=window, device=x.device)
    else:
        enc = x if own_kv else kv_override
        k = _split_heads(enc @ wk, KV, hd)
        v = _split_heads(enc @ wv, KV, hd)
    ka, va = k[:, :, kv], v[:, :, kv]
    scores = _gqa_scores(q, ka, ka.shape[2])
    scores = softcap(scores, cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask[None, :, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, va, H).to(x.dtype) @ p["wo"]
    return _reduce_out(out, split), (k, v)


def _kv_whole_in(w):
    """Megatron's *f* on a key or value weight that is whole on every rank
    of the group (the world rule ``kv_whole``): the identity forward; the
    group's sum of its gradient backward, since each rank's query heads
    read only their group's columns."""
    return collectives.copy_to_group(w, _TP.group)


def _local_heads(p, cfg):
    """``(H, KV, split, kv, wk, wv)``: the query heads of this rank's
    attention weights, the kv heads of its key and value weights, whether
    the query heads are split over the tensor-parallel group, the slice of
    the kv heads its query heads meet, and the key and value weights.
    Where the rules keep the kv projections whole (``kv_whole``: kv heads
    the axis does not divide) and split the query heads, the rank's query
    heads meet their own group's kv heads, and the weights' gradient is
    summed over the group (:func:`_kv_whole_in`). The keys and values of
    every kv head the weights hold are what a cache keeps."""
    hd = cfg.resolved_head_dim()
    H = p["wq"].shape[1] // hd
    KV = p["wk"].shape[1] // hd
    wk, wv = p["wk"], p["wv"]
    split = _TP is not None and H != cfg.n_heads
    kv = slice(0, KV)
    if split and KV == cfg.n_kv_heads:
        g = cfg.n_heads // cfg.n_kv_heads
        first = _TP.rank * H
        lo, hi = first // g, (first + H - 1) // g + 1
        if H % (hi - lo) or (hi - lo > 1 and H // (hi - lo) != g):
            raise NotImplementedError(
                f"{H} query heads a rank over {cfg.n_kv_heads} replicated "
                "kv heads do not fall into whole groups")
        kv = slice(lo, hi)
        wk, wv = _kv_whole_in(wk), _kv_whole_in(wv)
    return H, KV, split, kv, wk, wv


def attention_decode(p, x, cache_k, cache_v, pos: int, cfg, *,
                     window: int = 0):
    """One-token decode against a KV cache.

    x: (B,1,d); cache_k/v: (B,T,KV,hd); pos: int — number of tokens
    already in the cache (a host integer: a device scalar would make every
    step synchronise to index the cache). The new key and value are written
    into the caches in place (the reference's serving loop donates its
    cache). Returns (out (B,1,d), cache_k, cache_v).
    """
    kpos = torch.arange(_chunk(cache_k, "k")[2], device=x.device)
    valid = kpos <= pos
    if window:
        valid &= (pos - kpos) < window
    return attention_decode_masked(p, x, cache_k, cache_v, pos, cfg, valid)


def attention_decode_masked(p, x, cache_k, cache_v, pos: int, cfg, valid):
    """:func:`attention_decode` with the validity vector over the cache's
    T global positions given (the model chooses local or global by layer).
    A ``pos`` past the cache raises (the reference's
    ``dynamic_update_slice`` clamps it and overwrites the last slot;
    ROADMAP C10). Under :func:`seq_split` the new key and value go into
    the cache of the rank whose chunk holds ``pos``, and the attention
    combines the ranks' partials (:func:`_cached_attention`)."""
    _, lo, T = _chunk(cache_k, "k")
    if pos >= T:
        raise IndexError(f"decode at position {pos} of a cache of "
                         f"{T} positions")
    B = x.shape[0]
    hd = cfg.resolved_head_dim()
    H, KV, split, kv, wk, wv = _local_heads(p, cfg)
    x = _copy_in(x, split)
    q = _split_heads(x @ p["wq"], H, hd)
    k_new = _split_heads(x @ wk, KV, hd)
    v_new = _split_heads(x @ wv, KV, hd)
    posv = torch.full((B, 1), pos, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)
    at = pos - lo
    if 0 <= at < cache_k.shape[1]:
        cache_k[:, at:at + 1] = k_new.to(cache_k.dtype)
        cache_v[:, at:at + 1] = v_new.to(cache_v.dtype)
    out = _cached_attention(q, cache_k, cache_v,
                            valid[lo:lo + cache_k.shape[1]], cfg, "k", kv)
    return _reduce_out(out.to(x.dtype) @ p["wo"], split), cache_k, cache_v


def cross_attention_decode(p, x, xk, xv, cfg):
    """One token's cross-attention (x: (B,1,d)) against the encoder's
    cached keys and values ``xk`` / ``xv`` (B,F,KV,hd), every position
    visible. Under :func:`tensor_parallel` the rank's query heads (from
    ``wq``'s width) meet the rank's kv heads of the cache, and the output
    of ``wo`` is summed over the group, as in
    :func:`attention_decode_masked`; under :func:`seq_split` the ranks'
    partials over their frames are combined."""
    hd = cfg.resolved_head_dim()
    H, _, split, kv, _, _ = _local_heads(p, cfg)
    x = _copy_in(x, split)
    q = _split_heads(x @ p["wq"], H, hd)
    out = _cached_attention(q, xk, xv, None, cfg, "xk", kv)
    return _reduce_out(out.to(x.dtype) @ p["wo"], split)


def _cached_attention(q, ck, cv, valid, cfg, which: str, kv):
    """One token's attention, fp32 (B, 1, H*hd), of this rank's query heads
    ``q`` (B, 1, H, hd) over one layer's cache ``ck`` / ``cv`` (B, T, KV,
    hd), the positions of ``valid`` (T,) visible (None: all), the kv heads
    of ``kv`` meeting the query heads.

    Under :func:`seq_split` of the cache ``which``: fp32 partials over the
    rank's chunk, gathered over the chunk's axis and combined in rank order
    (:func:`combine_partials`). Where that axis is the tensor-parallel one
    (T over ``model``; the cache holds every kv head), ``q`` is gathered
    over it first, every head attends, and the rank keeps its own heads'
    output."""
    chunk = _SEQ.get(which)
    H = q.shape[2]
    over_model = (chunk is not None and chunk.axis == "model"
                  and _TP is not None)
    if over_model:
        q = collectives.all_gather(q, chunk.group, dim=2)
    else:
        ck, cv = ck[:, :, kv], cv[:, :, kv]
    scores = softcap(_gqa_scores(q, ck, ck.shape[2]), cfg.attn_softcap)
    if valid is not None:
        scores = torch.where(valid[None, None, None, None, :], scores, -1e30)
    if chunk is None:
        return _gqa_out(torch.softmax(scores, dim=-1), cv, H)
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    if valid is not None:
        e = e * valid.to(e.dtype)
    l = torch.sum(e, dim=-1, keepdim=True)
    o = torch.einsum("bskgt,btkh->bskgh", e, cv.to(torch.float32))
    out = combine_partials(torch.cat([m, l, o], dim=-1), chunk.group)
    B = out.shape[0]
    out = out.reshape(B, 1, -1)
    if over_model:
        hd = q.shape[-1]
        out = out[..., chunk.rank * H * hd:(chunk.rank + 1) * H * hd]
    return out


def combine_partials(part, group):
    """The softmax-weighted values from every rank's partials ``part``
    (``(..., 2 + hd)``: the row max ``m``, the sum of exponentials ``l``
    and the weighted values ``o`` over the rank's positions, fp32),
    gathered over ``group`` in one ``all_gather`` and combined in rank
    order: ``sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r`` with ``M``
    the largest ``m``. Every rank combines the same bits in the same
    order. A rank with no valid position has ``l = o = 0`` (its ``m`` is
    the mask's -1e30, below every valid row max), so it adds nothing."""
    parts = collectives.all_gather(part[None], group, dim=0)
    M = torch.amax(parts[..., :1], dim=0)
    num = den = None
    for r in range(parts.shape[0]):
        w = torch.exp(parts[r, ..., :1] - M)
        d, n = w * parts[r, ..., 1:2], w * parts[r, ..., 2:]
        den = d if den is None else den + d
        num = n if num is None else num + n
    return num / den


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_init(generator, d, d_ff, dtype, device=None):
    return {
        "wg": dense_init(generator, (d, d_ff), dtype, device=device),
        "wu": dense_init(generator, (d, d_ff), dtype, device=device),
        "wd": dense_init(generator, (d_ff, d), dtype, device=device),
    }


def swiglu(p, x, d_ff: Optional[int] = None):
    """The gated MLP; with ``d_ff`` (the config's) and this rank's slice
    of it under :func:`tensor_parallel`, column- then row-parallel."""
    split = _TP is not None and d_ff is not None and p["wg"].shape[1] != d_ff
    x = _copy_in(x, split)
    return _reduce_out((F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"], split)


def gelu_mlp_init(generator, d, d_ff, dtype, device=None):
    return {
        "wi": dense_init(generator, (d, d_ff), dtype, device=device),
        "wo": dense_init(generator, (d_ff, d), dtype, device=device),
    }


def gelu_mlp(p, x, d_ff: Optional[int] = None):
    """The tanh form of GELU, as ``jax.nn.gelu(approximate=True)`` (torch's
    default is the erf form); with ``d_ff`` (the config's) and this rank's
    slice of it under :func:`tensor_parallel`, column- then row-parallel,
    as :func:`swiglu`."""
    split = _TP is not None and d_ff is not None and p["wi"].shape[1] != d_ff
    x = _copy_in(x, split)
    return _reduce_out(F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"],
                       split)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def chunked_softmax_xent(h, head_w, labels, chunk, *, softcap_v=0.0,
                         mask=None, head_transposed=False):
    """Sequence-chunked LM loss: never materializes (B,S,V) logits.

    ``head_w``: (d, V) — or (V, d) with ``head_transposed=True`` for tied
    embeddings (the transpose is never materialized).
    """
    B, S, d = h.shape
    n_chunks = S // chunk
    if n_chunks * chunk != S:
        raise ValueError("xent_chunk must divide seq_len")
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        h_i, l_i = h[:, sl], labels[:, sl]
        m_i = (torch.ones(l_i.shape, dtype=torch.float32, device=h.device)
               if mask is None else mask[:, sl].to(torch.float32))
        if head_transposed:
            logits = torch.einsum("bcd,vd->bcv", h_i, head_w)
        else:
            logits = h_i @ head_w
        logits = softcap(logits.to(torch.float32), softcap_v)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, l_i[..., None].long())[..., 0]
        nll = nll + torch.sum((logz - gold) * m_i)
        denom = denom + torch.sum(m_i)
    if mask is not None:
        return token_mean(nll, denom)
    return nll / torch.clamp_min(denom, 1.0)


def vocab_parallel_xent(h, head_w, labels, chunk: int = 0, *,
                        softcap_v=0.0, mask=None, head_transposed=False):
    """:func:`chunked_softmax_xent` with ``head_w`` this rank's vocab slice
    under :func:`tensor_parallel` (``chunk`` 0: the whole sequence at
    once). Each rank computes its slice's logits (gemma2's final softcap
    is elementwise, before the reductions); the max over the vocab, the
    sum of exponentials and the target's logit are summed (the max: taken)
    over the group, so every rank holds the whole loss, and the gradient
    reaches each slice of the head and, summed over the group, ``h``."""
    B, S, d = h.shape
    chunk = chunk or S
    n_chunks = S // chunk
    if n_chunks * chunk != S:
        raise ValueError("xent_chunk must divide seq_len")
    group = _TP.group
    h = collectives.copy_to_group(h, group)
    n = head_w.shape[0 if head_transposed else 1]
    lo = _TP.rank * n
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        h_i, l_i = h[:, sl], labels[:, sl]
        m_i = (torch.ones(l_i.shape, dtype=torch.float32, device=h.device)
               if mask is None else mask[:, sl].to(torch.float32))
        if head_transposed:
            logits = torch.einsum("bcd,vd->bcv", h_i, head_w)
        else:
            logits = h_i @ head_w
        logits = softcap(logits.to(torch.float32), softcap_v)
        top = collectives.all_reduce(torch.amax(logits.detach(), dim=-1),
                                     group, "max")
        sumexp = collectives.reduce_from_group(
            torch.sum(torch.exp(logits - top[..., None]), dim=-1), group)
        local = l_i.long() - lo
        ok = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, torch.where(
            ok, local, torch.zeros_like(local))[..., None])[..., 0]
        gold = collectives.reduce_from_group(
            torch.where(ok, gold, torch.zeros_like(gold)), group)
        nll = nll + torch.sum((torch.log(sumexp) + top - gold) * m_i)
        denom = denom + torch.sum(m_i)
    if mask is not None:
        return token_mean(nll, denom)
    return nll / torch.clamp_min(denom, 1.0)


def shard_activations(x, enabled: bool):
    """The reference constrains the residual stream's feature dim over the
    mesh's 'model' axis when ``enabled``; here the residual stream stays
    replicated over the tensor-parallel group (:func:`tensor_parallel`),
    so this is the identity either way."""
    return x


def softmax_xent(logits, labels, mask=None):
    """Token-level cross entropy; logits fp32-cast; mask optional (B,S)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return token_mean(torch.sum(nll * mask), torch.sum(mask))
    return torch.mean(nll)
