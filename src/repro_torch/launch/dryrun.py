"""The dry run: every (architecture x input shape) on the production meshes,
reckoned on the ``meta`` device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--force]

Nothing is compiled and no device is touched: every state, batch, cache and
set of weights is built on ``meta`` (shapes and dtypes, no storage), the
mesh's entries name ``meta``, and every figure is reckoned from the specs of
``sharding.ShardingPolicy``. A leaf's bytes on one device are its bytes
divided by the sizes of the mesh axes its spec names. So it runs the same on
a machine with or without a card, and sets no environment variable.

Each record holds:

* ``memory``: ``argument_size_in_bytes`` (every argument of the step: the
  train state, the batch and the weights; or the parameters, the batch or
  token and the cache), split by part in ``by_part``, and
  ``output_size_in_bytes`` (what the step returns, plus the 8-byte entry a
  returned leaf takes in the output tuple's index table, which the compiled
  step counts too), split in ``output_by_part``. A cache's host ``pos`` is
  counted as the int32 scalar it is on the wire. The figures that only a
  compiler gives (``temp_size_in_bytes``, ``generated_code_size_in_bytes``)
  are left out, and ``reckoned`` is true.
* ``collectives``: the train step's aggregation over the participant axis
  (``core/strategy.py``): ``modest`` and ``fedavg`` one all-reduce of one
  participant's parameters on a device in the aggregation's dtype, plus the
  fp32 sum of the weights; ``dsgd`` one collective-permute a parameter leaf
  of its fp32 shard; ``local`` none (``strategy``). Then the collectives
  that the model's own layout puts into a train, prefill or decode step
  (``model``, :func:`model_collectives`): the tensor-parallel reductions of
  the forward and backward passes, the MoE's routing collectives, the
  backward's recomputation under ``cfg.remat`` (also apart, in ``remat``)
  and a train step's metrics. They are reckoned for every LM family at
  ``data_rank`` granularity, as XLA's compile of the reference places and
  combines them, in the program's dtypes (XLA's CPU backend widens a bf16
  all-reduce to fp32; the wire here is the program's); ``reckoned`` names
  what is not (FSDP, a cache split by sequence, a head split by the model
  axis). ``total_bytes`` is the
  bytes on one device times the device count, as the roofline reads it.
* ``roofline``: ``roofline.analytic_terms`` on ``config.H100`` with the
  collective bytes above; ``raw_hlo_flops`` and ``raw_hlo_bytes`` are None
  (there is no compiled module).

Artifacts: ``build/dryrun/{arch}__{shape}__{mesh}__{strategy}[__tag].json``
(git-ignored). Existing artifacts are skipped unless ``--force``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import NamedTuple, Optional

import torch

from repro_torch import configs
from repro_torch.config import (SHAPES, H100, MeshConfig, ShapeConfig,
                                TrainConfig, parse_overrides)
from repro_torch.core.distributed import DistributedTrainer, Server
from repro_torch.launch.mesh import make_mesh_from_config, mesh_config
from repro_torch.models import hymba, moe, rwkv
from repro_torch.roofline import analytic_terms
from repro_torch.sharding import ShardingPolicy, _k, input_specs
from repro_torch.utils.pytree import tree_flatten, tree_flatten_with_path

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")

# Grad-accumulation microbatching per arch for train_4k (E axis of the
# batch), the reference's table.
TRAIN_MICRO = {
    "llama3-405b": 16,
    "arctic-480b": 8,
    "gemma2-27b": 4,
    "starcoder2-15b": 4,
    "qwen3-moe-30b-a3b": 4,
    "llava-next-mistral-7b": 4,
    "whisper-large-v3": 2,
    "hymba-1.5b": 1,
    "rwkv6-1.6b": 1,
    "tinyllama-1.1b": 1,
}

# long_500k needs sub-quadratic attention: dense/moe/audio/vlm archs without
# a native window get an explicit sliding window.
LONG_CTX_WINDOW = 8192

# bytes of a scalar the port keeps on the host (a cache's ``pos``): the
# int32 the reference's cache holds
HOST_SCALAR_BYTES = 4
# bytes a returned leaf takes in the output tuple's index table
TUPLE_ENTRY_BYTES = 8
COLLECTIVES_RECKONED = "strategy aggregation and the model's collectives"


def effective_config(arch: str, shape_name: str):
    cfg = configs.get_config(arch)
    if shape_name == "long_500k" and cfg.window == 0 and cfg.family in (
            "dense", "moe", "audio", "vlm"):
        cfg = cfg.with_(window=LONG_CTX_WINDOW)
    return cfg


def _micro_batch(arch: str, shape, n_participants: int, micro_override=None):
    micro = micro_override or TRAIN_MICRO.get(arch, 1)
    per_part = max(shape.global_batch // max(n_participants, 1), 1)
    micro = min(micro, per_part)
    return micro, max(per_part // micro, 1)


# ---------------------------------------------------------------------------
# bytes on one device
# ---------------------------------------------------------------------------


def leaf_bytes(tree, specs, policy: ShardingPolicy) -> dict:
    """``{leaf path: bytes on one device}`` of ``tree`` under ``specs`` (a
    tree of specs matching it): a tensor's bytes over the sizes of the mesh
    axes its spec names; a host int, :data:`HOST_SCALAR_BYTES`."""
    flat, treedef = tree_flatten_with_path(tree)
    out = {}
    for (path, leaf), spec in zip(flat, treedef.flatten_up_to(specs)):
        key = "/".join(_k(p) for p in path)
        if not isinstance(leaf, torch.Tensor):
            out[key] = HOST_SCALAR_BYTES
            continue
        split = math.prod(policy._axes_size(a) for a in spec)
        nbytes = leaf.numel() * leaf.element_size()
        if nbytes % split:
            raise ValueError(f"{key}: spec {spec} splits {nbytes} bytes "
                             f"{split} ways")
        out[key] = nbytes // split
    return out


def per_device_bytes(tree, specs, policy: ShardingPolicy) -> int:
    return sum(leaf_bytes(tree, specs, policy).values())


# ---------------------------------------------------------------------------
# the step's arguments and outputs
# ---------------------------------------------------------------------------


def step_parts(cfg, shape: ShapeConfig, mesh_cfg: MeshConfig, *,
               strategy: str = "modest", agg_dtype: str = "float32",
               micro_override=None, arch: Optional[str] = None) -> dict:
    """The step's arguments and outputs on the ``meta`` device, each part a
    ``(tree, specs)`` pair: ``{"policy", "arguments": {part: ...},
    "outputs": {part: ...}}``, with ``micro_steps`` / ``micro_batch`` for a
    train step. ``arch`` names ``cfg`` in :data:`TRAIN_MICRO`."""
    mesh = make_mesh_from_config(mesh_cfg, "meta")
    policy = ShardingPolicy(cfg, mesh_cfg)
    out: dict = {"policy": policy}
    if shape.kind == "train":
        micro, b_micro = _micro_batch(arch or cfg.name, shape,
                                      policy.n_participants, micro_override)
        trainer = DistributedTrainer(
            cfg, TrainConfig(optimizer="sgd", agg_dtype=agg_dtype),
            mesh_cfg, strategy=strategy, mesh=mesh)
        state_t = trainer.abstract_state()
        spec = trainer.state_spec(state_t)
        batch_t = _train_batch_template(cfg, shape, policy, micro, b_micro)
        weights_t = torch.empty((policy.n_participants,), dtype=torch.float32,
                                device="meta")
        metrics_t = {k: torch.empty((), dtype=torch.float32, device="meta")
                     for k in ("loss", "active")}
        out.update(micro_steps=micro, micro_batch=b_micro, arguments={
            "params": (state_t.params, spec.params),
            "optimizer_state": (state_t.opt_state, spec.opt_state),
            "strategy_state": (state_t.server_state, spec.server_state),
            "round": (state_t.round, spec.round),
            "batch": (batch_t, policy.batch_spec(batch_t,
                                                 with_participants=True)),
            "weights": (weights_t, policy.weights_spec()),
        }, outputs={
            "state": (state_t, spec),
            "metrics": (metrics_t, {"loss": (), "active": ()}),
        })
        return out

    shard_seq = shape.name == "long_500k"
    server = Server(cfg, mesh_cfg, mesh=mesh, shard_seq=shard_seq)
    params_t = server.model.init(torch.Generator().manual_seed(0), "meta")
    B = shape.global_batch
    cache_t = server.abstract_cache(B, _cache_len(cfg, shape))
    pspec, cspec = server.specs(params_t, cache_t)
    if shape.kind == "prefill":
        batch_t = input_specs(cfg, shape, policy)
        bspec = policy.batch_spec(batch_t, with_participants=False,
                                  shard_seq=shard_seq)
        b_axis = bspec["tokens"][0]
    else:
        batch_t = torch.empty((B, 1), dtype=torch.int32, device="meta")
        bspec = policy._fix_divisibility(
            (None if shard_seq else "data", None), (B, 1))
        b_axis = bspec[0]
    logits_t = torch.empty((B, 1, cfg.vocab), dtype=torch.float32,
                           device="meta")
    out.update(arguments={
        "params": (params_t, pspec),
        "batch": (batch_t, bspec),
        "cache": (cache_t, cspec),
    }, outputs={
        "logits": (logits_t, policy._fix_divisibility(
            (b_axis, None, _vocab_axis(params_t, pspec)),
            tuple(logits_t.shape))),
        "cache": (cache_t, cspec),
    })
    return out


def _vocab_axis(params, pspec):
    """The mesh axis that splits the vocabulary of the output projection
    (``lm_head``'s last dimension, else the tied ``embed``'s first): the
    logits' last dimension inherits it."""
    if "lm_head" in params:
        return pspec["lm_head"][-1]
    return pspec["embed"][0]


def _train_batch_template(cfg, shape, policy, micro, b_micro):
    i32, bf = torch.int32, getattr(torch, cfg.param_dtype)
    Pn = policy.n_participants

    def sd(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    batch = {
        "tokens": sd((Pn, micro, b_micro, shape.seq_len), i32),
        "labels": sd((Pn, micro, b_micro, shape.seq_len), i32),
    }
    if cfg.family == "audio":
        batch["frames"] = sd((Pn, micro, b_micro, cfg.n_frames, cfg.d_model),
                             bf)
    if cfg.family == "vlm":
        n_img = cfg.image_tokens * cfg.anyres_tiles
        batch["image_embeds"] = sd((Pn, micro, b_micro, n_img, cfg.d_model),
                                   bf)
    return batch


def _cache_len(cfg, shape):
    max_len = shape.seq_len
    if cfg.family == "vlm":
        max_len += cfg.image_tokens * cfg.anyres_tiles
    return max_len


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def strategy_collectives(strategy: str, params_t, params_spec,
                         policy: ShardingPolicy,
                         agg_dtype: str = "float32") -> dict:
    """The aggregation's collectives on one device over the participant
    axis, ``{"bytes": {kind: n}, "counts": {kind: n}}``. ``params_t`` is
    the stacked ``(P, ...)`` parameter tree, ``params_spec`` its specs
    (the participant axis first). A leaf whose participant axis is not
    split needs none."""
    if strategy == "local":
        return {"bytes": {}, "counts": {}}
    flat, treedef = tree_flatten(params_t)
    specs = treedef.flatten_up_to(params_spec)
    split = [(leaf, spec) for leaf, spec in zip(flat, specs)
             if spec and spec[0] is not None]
    if not split:
        return {"bytes": {}, "counts": {}}
    if strategy in ("modest", "fedavg"):
        # the weighted mean of one participant's shard, in agg_dtype, and
        # the weights' fp32 sum
        wire = getattr(torch, agg_dtype).itemsize
        n = sum(leaf[0].numel() // math.prod(
            policy._axes_size(a) for a in spec[1:]) for leaf, spec in split)
        return {"bytes": {"all-reduce": n * wire + 4},
                "counts": {"all-reduce": 1}}
    if strategy == "dsgd":
        # each leaf's fp32 shard goes to the neighbour slot
        n = sum(leaf.numel() // math.prod(policy._axes_size(a) for a in spec)
                for leaf, spec in split)
        return {"bytes": {"collective-permute": n * 4},
                "counts": {"collective-permute": len(split)}}
    raise ValueError(f"unknown strategy {strategy!r}")


class Collective(NamedTuple):
    """One collective of the step as XLA's partitioner places it and its
    all-reduce combiner groups it: one op over the mesh ``axis``, moving
    ``operands`` (``(shape on one device, dtype)`` each: an all-reduce's
    operands, an all-gather's result, as ``utils/hlo.py::collective_bytes``
    counts them), run ``times`` a step (layers x local steps). ``remat``
    marks a recomputation of the forward pass inside the backward one."""
    kind: str
    what: str
    axis: str
    operands: tuple
    times: int = 1
    remat: bool = False

    def nbytes(self, widen: bool = False) -> int:
        """Bytes a step on one device; ``widen`` counts 16-bit floats at 4
        bytes, as XLA's CPU backend widens them."""
        def size(dt):
            n = getattr(torch, dt).itemsize
            return 4 if widen and dt in ("bfloat16", "float16") else n
        return self.times * sum(math.prod(s) * size(dt)
                                for s, dt in self.operands)


def summarize(colls, widen: bool = False) -> dict:
    """``{"bytes": {kind: n}, "counts": {kind: n}}`` of a list of
    :class:`Collective`."""
    out: dict = {"bytes": {}, "counts": {}}
    for c in colls:
        out["bytes"][c.kind] = out["bytes"].get(c.kind, 0) + c.nbytes(widen)
        out["counts"][c.kind] = out["counts"].get(c.kind, 0) + c.times
    return out


def _splits(spec, dim: int) -> bool:
    axis = spec[dim] if dim < len(spec) else None
    return "model" in (axis if isinstance(axis, tuple) else (axis,))


def model_collectives(cfg, shape: ShapeConfig, policy: ShardingPolicy,
                      params_spec, *, micro: int = 1, b_micro: int = 1):
    """The collectives the model's own layout puts into a train, prefill
    or decode step, besides the strategy's aggregation: ``(list of
    Collective, [what is not reckoned])``.

    Reckoned from one participant's parameter specs (``params_spec``, the
    layer axis first under ``layers``) and the model's products, for every
    LM family at ``data_rank`` granularity, as XLA's compile of the
    reference shows them (held exactly at a 4 x 2 mesh by
    ``tests/test_torch_dryrun.py``):

    * a row-parallel product's output (attention's ``wo``, the MLP's
      ``wd``, the MoE's combine over the experts) and a vocab-parallel
      lookup: one all-reduce each, in the activations' dtype;
    * backward, the input gradients of the column-parallel products of one
      input (``wq``, ``wk``, ``wv``; ``wg``, ``wu``): one all-reduce of
      one operand each (XLA sums them apart, then combines the ops);
    * a vocab-parallel loss: the fp32 max and sum of exponentials over the
      vocab, and one op of the target's logit with the gradient of ``h``;
    * the MoE: the router's softmax over experts split by ``model``, the
      top k's gathers (over ``model`` and, as XLA replicates the top k's
      operand, over the participants), the slot positions' sum over
      experts, the aux loss with the combine; backward, the gates', the
      softmax's and ``xg``'s gradients (router and dispatch paths in one
      op), and the router's gradient gathered over ``model`` at the end.
      Serving splits the token groups over ``data``: the groups where
      ``data`` divides their count, else the tokens of a group (a decode),
      which adds the priority's gather and the dispatch's all-reduce over
      ``data``;
    * RWKV-6, Hymba and Whisper: :func:`_rwkv_collectives`,
      :func:`_hymba_collectives`, :func:`_whisper_collectives`;
    * LLaVA: the dense family's, its blocks at the merged length
      ``n_img + S`` (the concatenation adds no collective), its embedding
      and loss at the S text positions;
    * ``cfg.remat``: the backward pass recomputes the forward's collectives
      that it needs (attention's output, the router's), once again;
    * a train step's metrics: one all-reduce of two fp32 scalars over the
      participant axis.
    """
    train = shape.kind == "train"
    colls, notes = [], []
    if train and policy._axes_size(policy.part_axis) > 1:
        colls.append(Collective("all-reduce", "metrics (loss, active)",
                                _axis_name(policy.part_axis),
                                (((), "float32"), ((), "float32"))))
    M = policy._axes_size("model")
    if policy.fsdp_axis is not None:
        notes.append("tensor-parallel and FSDP collectives not reckoned "
                     f"({cfg.participant_granularity!r} granularity)")
        return colls, notes
    if M == 1 or policy._replicated:
        return colls, notes

    specs = dict(_flat_specs(params_spec))
    at = cfg.param_dtype
    d, L = cfg.d_model, cfg.n_layers
    if cfg.n_heads % M or cfg.n_kv_heads % M:
        notes.append("head resharding where the model axis splits a head "
                     "not reckoned")
    if train:
        P_loc = policy.n_participants // policy._axes_size(policy.part_axis)
        lead = (P_loc, b_micro)
        S, top_times = shape.seq_len, micro
    else:
        Dn = policy._axes_size("data")
        B = shape.global_batch
        shard_seq = shape.name == "long_500k"
        if shard_seq and cfg.family == "ssm":
            notes.append("a batch of one row replicated over data not held "
                         "to XLA")
        elif shard_seq:
            notes.append("attention over a cache split by sequence not "
                         "reckoned")
        lead = (B // Dn if not shard_seq and B % Dn == 0 else B,)
        S = shape.seq_len if shape.kind == "prefill" else 1
        top_times = 1
    # LLaVA's layers run over [image ‖ text]; its embedding and loss over
    # the text (a decode adds no image)
    S_top = S
    if cfg.family == "vlm" and S > 1:
        S += cfg.image_tokens * cfg.anyres_tiles
    act = lead + (S, d)
    times = L * top_times

    def add(kind, what, axis, operands, n=times, remat=False):
        colls.append(Collective(kind, what, axis, tuple(operands), n, remat))

    if cfg.family == "ssm":
        _rwkv_collectives(cfg, specs, M, lead, S, train, add, times,
                          top_times)
        return colls, notes
    if cfg.family == "hybrid":
        _hymba_collectives(cfg, specs, M, lead, S, train, add, times)
        mlp_in, attn_in = [], []
    elif cfg.family == "audio":
        _whisper_collectives(cfg, specs, lead, S, train, add, top_times)
        mlp_in, attn_in = [], []
    else:
        mlp_in, attn_in = _dense_moe_collectives(
            cfg, shape, policy, specs, lead, S, train, add, times)
    if train:
        if mlp_in:
            add("all-reduce", "MLP input gradients (column-parallel)",
                "model", [(act, at)] * len(mlp_in))
        if attn_in:
            add("all-reduce", "attention input gradients (column-parallel)",
                "model", [(act, at)] * len(attn_in))
    tied = "lm_head" not in specs
    if _splits(specs["embed"], 0):
        add("all-reduce", "vocab-parallel embedding", "model",
            [(lead + (S_top, d), at)], n=top_times)
    if train and (_splits(specs["embed"], 0) if tied
                  else _splits(specs["lm_head"], 1)):
        chunks = (S_top // cfg.xent_chunk) if cfg.xent_chunk else 1
        tok = lead + (S_top // chunks,)
        n = top_times * chunks
        add("all-reduce", "vocab-parallel loss: max", "model",
            [(tok, "float32")], n=n)
        add("all-reduce", "vocab-parallel loss: sum of exponentials",
            "model", [(tok, "float32")], n=n)
        add("all-reduce", "vocab-parallel loss: target logit and the "
            "gradient of h", "model",
            [(tok + (d,), at), (tok + (1,), "float32")], n=n)
    return colls, notes


def _dense_moe_collectives(cfg, shape, policy, specs, lead, S, train, add,
                           times):
    """The dense and MoE blocks' collectives (see
    :func:`model_collectives`); returns the column-parallel products whose
    input gradients the backward sums (the MLP's, the attention's)."""
    at, act = cfg.param_dtype, lead + (S, cfg.d_model)
    attn_in = [w for w in ("wq", "wk", "wv")
               if _splits(specs[f"layers/attn/{w}"], 2)]
    attn_out = _splits(specs["layers/attn/wo"], 1)
    if attn_out:
        add("all-reduce", "attention output (row-parallel wo)", "model",
            [(act, at)])
        if train and cfg.remat:
            add("all-reduce", "attention output, recomputed", "model",
                [(act, at)], remat=True)
    if cfg.family in ("dense", "vlm"):
        if _splits(specs["layers/mlp/wd"], 1):
            add("all-reduce", "MLP output (row-parallel wd)", "model",
                [(act, at)])
        mlp_in = [w for w in ("wg", "wu")
                  if _splits(specs[f"layers/mlp/{w}"], 2)]
    else:
        mlp_in = []
        if "layers/moe/dense/wd" in specs and _splits(
                specs["layers/moe/dense/wd"], 1):
            add("all-reduce", "dense residual output (row-parallel wd)",
                "model", [(act, at)])
        if "layers/moe/dense/wg" in specs:
            mlp_in = [w for w in ("wg", "wu")
                      if _splits(specs[f"layers/moe/dense/{w}"], 2)]
        if _splits(specs["layers/moe/wg"], 1):
            _moe_collectives(cfg, shape, policy, lead, S, train, add, times)
    return mlp_in, attn_in


def _whisper_collectives(cfg, specs, lead, S, train, add, top_times):
    """Whisper's block collectives (see :func:`model_collectives`) as XLA's
    partitioner places them. Forward, one all-reduce a row-parallel
    output: the encoder's attention and MLP at ``(lead, n_frames, d)`` (a
    train step or a prefill; a decode reads the cached cross keys and
    values), the decoder's self-attention, cross-attention and MLP at
    ``(lead, S, d)``. Backward, a decoder layer sums its MLP's input
    gradient, its cross-attention's (the query's at S, with the gradient
    that its keys' and values' products give the encoder output, two
    operands at n_frames: XLA sums that gradient in every layer) and its
    self-attention's three; an encoder layer its MLP's and its
    self-attention's three (one input, three products). Under
    ``cfg.remat`` the backward recomputes each attention's output (both
    of a decoder layer), not the MLPs'."""
    d, at = cfg.d_model, cfg.param_dtype
    enc, dec = lead + (cfg.n_frames, d), lead + (S, d)
    Le, L = cfg.encoder_layers * top_times, cfg.n_layers * top_times
    blocks = []
    if train or S > 1:
        blocks.append(("encoder", enc, Le))
    blocks.append(("decoder", dec, L))
    for stack, act, n in blocks:
        attn = _splits(specs[f"{stack}/attn/wo"], 1)
        mlp = _splits(specs[f"{stack}/mlp/wo"], 1)
        outs = (["self-attention"] if attn else []) + (
            ["cross-attention"] if stack == "decoder" and _splits(
                specs["decoder/xattn/wo"], 1) else [])
        for what in outs:
            add("all-reduce", f"{stack} {what} output (row-parallel wo)",
                "model", [(act, at)], n=n)
        if mlp:
            add("all-reduce", f"{stack} MLP output (row-parallel wo)",
                "model", [(act, at)], n=n)
        if not train:
            continue
        if cfg.remat:
            for what in outs:
                add("all-reduce", f"{stack} {what} output, recomputed",
                    "model", [(act, at)], n=n, remat=True)
        if mlp:
            add("all-reduce", f"backward: {stack} MLP input gradient "
                "(column-parallel wi)", "model", [(act, at)], n=n)
        if "cross-attention" in outs:
            add("all-reduce", "backward: cross-attention input gradients "
                "(wq's at S; wk's and wv's, the encoder output's, at "
                "n_frames)", "model", [(enc, at), (enc, at), (act, at)],
                n=n)
        if attn:
            add("all-reduce", f"backward: {stack} self-attention input "
                "gradients (column-parallel w[qkv])", "model",
                [(act, at)] * 3, n=n)


def _rwkv_collectives(cfg, specs, M, lead, S, train, add, times,
                      top_times):
    """RWKV-6's collectives (see :func:`model_collectives`) as XLA's
    partitioner places them: the reference's specs split the token shifts
    ``last_tm`` / ``last_cm`` and the channel-mix gate over d, so the
    residual stream lies split over d on ``model``. Each layer norm then
    sums its mean and variance over d; the mixed inputs of the
    column-parallel products are gathered over d (four in the time-mix,
    two in the channel-mix); the decay's ``mix @ decay_a`` (``decay_a``
    replicated) and the row-parallel ``wo`` and ``wv`` are all-reduced
    (at one token the decay's sum rides with the channel-mix's: the step's
    output does not wait for it). Backward: eight activations gathered
    over d a layer, the column-parallel products' input gradients (the
    channel-mix's two, the time-mix's four with ``decay_a``'s), the norms'
    and the per-head ``ln_x``'s scale and bias, summed over the heads; at
    the top the vocab-parallel embedding and loss, ``h`` gathered for the
    head, and the gradients of the leaves replicated over d (the norms,
    ``mu``, ``decay_a``) gathered. Under ``cfg.remat`` the backward
    recomputes the forward's seven all-reduces (not its gathers). A
    decode's embedding lookup is resharded over ``data`` as the 4 x 2
    compile does it (a gather of the rows' flags, an all-to-all, an
    all-reduce and a collective-permute; their shapes scaled here by B /
    data and d / model)."""
    d, L, at, f32 = cfg.d_model, cfg.n_layers, cfg.param_dtype, "float32"
    act, tok = lead + (S, d), lead + (S,)
    lora = lead + (S, rwkv.DECAY_LORA)
    one = lead + (1, d)

    def norm(what, n=times, remat=False):
        add("all-reduce", f"{what}: mean over d", "model", [(tok, f32)], n,
            remat)
        add("all-reduce", f"{what}: variance over d", "model",
            [(tok, f32)] * 2, n, remat)

    def forward_reduces(remat=False):
        sfx = ", recomputed" if remat else ""
        norm("ln1" + sfx, remat=remat)
        if S > 1:
            add("all-reduce", "decay: mix @ decay_a summed over d" + sfx,
                "model", [(lora, at)], remat=remat)
        add("all-reduce", "time-mix output (row-parallel wo)" + sfx,
            "model", [(act, at)], remat=remat)
        norm("ln2" + sfx, remat=remat)
        if S > 1:
            add("all-reduce", "channel-mix output (row-parallel wv)" + sfx,
                "model", [(act, at)], remat=remat)
        else:
            add("all-reduce", "channel-mix output (row-parallel wv) and "
                "the decay's sum over d" + sfx, "model",
                [(act, at), (lora, at)], remat=remat)

    forward_reduces()
    add("all-gather", "time-mix: mixed inputs of w[rkvg] over d", "model",
        [(act, at)], n=4 * times)
    add("all-gather", "channel-mix: mixed inputs of wk and wr over d",
        "model", [(act, at)], n=2 * times)
    if train:
        if cfg.remat:
            forward_reduces(remat=True)
        P_loc = lead[0]
        hd = cfg.resolved_head_dim()
        add("all-gather", "backward: activations over d", "model",
            [(act, at)], n=8 * times)
        add("all-reduce", "backward: channel-mix input gradients "
            "(column-parallel wk, wr)", "model", [(act, at)] * 2)
        norm("backward: ln2")
        add("all-reduce", "backward: time-mix input gradients "
            "(column-parallel w[rkvg], and decay_a's)", "model",
            [(act, at)] * 4 + [(lora, at)])
        add("all-reduce", "backward: ln1: variance over d", "model",
            [(tok, f32)] * 2)
        add("all-reduce", "backward: ln1: mean over d, with ln_x's scale "
            "and bias gradients over the heads", "model",
            [(tok, f32), ((P_loc, hd), at), ((P_loc, hd), at)])
    # the top: embedding, final norm, head
    if _splits(specs["embed"], 0):
        if S == 1 and not train:
            B_loc = lead[0]
            add("all-gather", "embedding lookup at one token: the rows' "
                "flags", "data", [((B_loc * M, 1, 1), "bool")], n=1)
            add("all-to-all", "embedding lookup at one token: the rows "
                "over data", "data", [((1, B_loc, 1, 1, d // M), at)] * 2,
                n=1)
            add("all-reduce", "embedding lookup at one token: the "
                "vocab-parallel sum", "model", [((B_loc * M, 1, d // M), at)],
                n=1)
            add("collective-permute", "embedding lookup at one token: the "
                "rows back", "data", [((B_loc, 1, d // M), at)], n=1)
        else:
            add("all-reduce", "vocab-parallel embedding", "model",
                [(act, at)], n=top_times)
    norm("final norm", n=top_times)
    add("all-gather", "h over d, for the head", "model",
        [(act if train else one, at)], n=top_times)
    if not train:
        return
    if _splits(specs["lm_head"], 1):
        add("all-reduce", "vocab-parallel loss: max", "model", [(tok, f32)],
            n=top_times)
        add("all-reduce", "vocab-parallel loss: sum of exponentials",
            "model", [(tok, f32)], n=top_times)
        add("all-reduce", "backward: h's gradient (vocab-parallel head)",
            "model", [(act, at)], n=top_times)
    add("all-reduce", "backward: final norm: variance over d", "model",
        [(tok, f32)] * 2, n=top_times)
    add("all-reduce", "backward: target logit, with the final norm's mean",
        "model", [(tok, f32), (tok + (1,), f32)], n=top_times)
    add("all-gather", "backward: the embedding's gradient over d", "model",
        [(act, at)], n=top_times)
    P_loc = lead[0]
    for what, shp in (("final norm's scale", (P_loc, d)),
                      ("final norm's bias", (P_loc, d)),
                      ("channel-mix mu", (P_loc, L, 2, d)),
                      ("ln1's and ln2's scale and bias", (P_loc, L, d)),
                      ("decay_a", (P_loc, L, d, rwkv.DECAY_LORA)),
                      ("time-mix mu", (P_loc, L, 5, d))):
        n = 4 if what.startswith("ln1") else 1
        add("all-gather", f"backward: {what} gradient over d", "model",
            [(shp, at)], n=n * top_times)


def _hymba_collectives(cfg, specs, M, lead, S, train, add, times):
    """Hymba's block collectives (see :func:`model_collectives`) as XLA's
    partitioner places them. The contiguous split of ``in_proj``'s columns
    gives each rank whole halves (``xin`` on the first ranks, ``z`` on the
    last), so two collective-permutes a layer move each half's d_inner
    lanes to their ranks (and two move the gradients back); ``dt_proj``
    and ``bc_proj`` are row-parallel (one all-reduce of both), the
    attention's ``wo`` and ``out_proj`` one all-reduce of both, the MLP's
    ``wd`` one. Backward: the scan's B and C gradients summed over
    d_inner at every step, the MLP's input gradients, and the attention's
    and ``in_proj``'s, with dt's low-rank gradient, in two all-reduces.
    Under ``cfg.remat`` the backward recomputes the permutes, the
    ``dt_proj``/``bc_proj`` sums with one row-parallel output, and the
    other."""
    d, at, f32 = cfg.d_model, cfg.param_dtype, "float32"
    act = lead + (S, d)
    lanes = lead + (S, d // M)                  # d_inner = d_model
    dt = lead + (S, hymba.DT_RANK)
    bc = lead + (S, 2 * cfg.ssm_state)
    add("collective-permute", "in_proj's halves to the d_inner lanes",
        "model", [(lanes, at)], n=2 * times)
    add("all-reduce", "dt_proj and bc_proj (row-parallel)", "model",
        [(dt, at), (bc, at)])
    add("all-reduce", "attention and mamba outputs (row-parallel wo, "
        "out_proj)", "model", [(act, at)] * 2)
    add("all-reduce", "MLP output (row-parallel wd)", "model", [(act, at)])
    if not train:
        return
    if cfg.remat:
        add("collective-permute", "in_proj's halves, recomputed", "model",
            [(lanes, at)], n=2 * times, remat=True)
        add("all-reduce", "a row-parallel output with dt_proj and bc_proj, "
            "recomputed", "model", [(act, at), (dt, at), (bc, at)],
            remat=True)
        add("all-reduce", "a row-parallel output, recomputed", "model",
            [(act, at)], remat=True)
    add("all-reduce", "backward: the scan's B and C gradients over "
        "d_inner, a step", "model", [(lead + (cfg.ssm_state,), f32)] * 2,
        n=times * S)
    add("all-reduce", "backward: MLP input gradients (column-parallel)",
        "model", [(act, at)] * 2)
    add("collective-permute", "backward: in_proj's halves' gradients",
        "model", [(lanes, at)], n=2 * times)
    add("all-reduce", "backward: attention and in_proj input gradients, "
        "with dt's low-rank gradient", "model", [(act, at)] * 2 + [(dt, at)])
    add("all-reduce", "backward: attention and in_proj input gradients",
        "model", [(act, at)] * 2)


def _moe_collectives(cfg, shape, policy, lead, S, train, add, times):
    """The MoE layer's collectives (see :func:`model_collectives`), its
    experts split over ``model``."""
    M = policy._axes_size("model")
    E, k, d, at = (cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model,
                   cfg.param_dtype)
    f32 = "float32"
    if train:
        tokens = lead[1] * S
        G = min(cfg.moe_group_size, tokens)
        Gn = -(-tokens // G)
        P_loc = lead[0]
        grp = (P_loc, Gn, G)
        part = policy._axes_size(policy.part_axis)
        router = [("all-reduce", "router softmax: max over experts", "model",
                   [(grp, f32)]),
                  ("all-reduce", "router softmax: sum over experts", "model",
                   [(grp, f32)]),
                  ("all-gather", "top k: router probabilities over experts",
                   "model", [(grp + (E,), f32)])]
        if part > 1:
            router.append(("all-gather", "top k: router probabilities over "
                           "participants", _axis_name(policy.part_axis),
                           [((P_loc * part, Gn, G, E), f32)]))
        router.append(("all-reduce", "slot positions: sum over experts",
                       "model", [((P_loc, Gn, G * k), f32)]))
        for c in router:
            add(*c)
        add("all-reduce", "combine over experts, with the aux loss", "model",
            [(grp + (d,), at), ((P_loc,), f32)])
        if cfg.remat:
            for kind, what, axis, ops in router:
                add(kind, what + ", recomputed", axis, ops, remat=True)
        add("all-reduce", "gates' gradient", "model", [(grp + (k,), f32)])
        add("all-reduce", "router softmax's gradient", "model", [(grp, f32)])
        add("all-reduce", "xg's gradient (router and dispatch)", "model",
            [(grp + (d,), f32), (grp + (d,), at)])
        add("all-gather", "router's gradient over experts", "model",
            [((P_loc, cfg.n_layers, d, E), f32)], n=times // cfg.n_layers)
        return
    Dn = policy._axes_size("data")
    tokens = shape.global_batch * S
    G = min(cfg.moe_group_size, tokens)
    Gn = -(-tokens // G)
    C = moe.capacity(cfg, G)
    Gn_loc, G_loc = Gn, G
    if Dn > 1 and shape.name != "long_500k":
        add("all-gather", "top k: router probabilities over data", "data",
            [((Gn, G, E), f32)])
        if Gn % Dn == 0:
            Gn_loc = Gn // Dn
        else:
            G_loc = G // Dn
            add("all-gather", "slot priorities over data", "data",
                [((Gn, G * k, E // M), f32)])
    add("all-reduce", "slot positions: sum over experts", "model",
        [((Gn_loc, G_loc * k), f32)])
    if G_loc != G:
        add("all-reduce", "dispatch over the group's tokens", "data",
            [((Gn, E // M, C, d), at)])
    add("all-reduce", "combine over experts", "model",
        [((Gn_loc, G_loc, d), at)])


def _axis_name(axis) -> str:
    return ",".join(axis) if isinstance(axis, tuple) else str(axis)


def _flat_specs(params_spec):
    """``(path, spec)`` of every leaf of a parameter spec tree (a spec is a
    tuple, so the tree is walked by its dicts)."""
    for key, val in params_spec.items():
        if isinstance(val, dict):
            for sub, spec in _flat_specs(val):
                yield f"{key}/{sub}", spec
        else:
            yield key, val


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


def reckon(cfg, shape: ShapeConfig, mesh_cfg: MeshConfig, *,
           strategy: str = "modest", agg_dtype: str = "float32",
           micro_override=None, accumulate: bool = False,
           arch: Optional[str] = None) -> dict:
    """The dry-run record's figures for ``cfg`` at ``shape`` on a mesh of
    ``mesh_cfg``: ``participants``, ``window``, ``memory``,
    ``collectives``, ``roofline`` (and ``micro_steps``, ``micro_batch``,
    ``accumulate`` for a train step)."""
    parts = step_parts(cfg, shape, mesh_cfg, strategy=strategy,
                       agg_dtype=agg_dtype, micro_override=micro_override,
                       arch=arch)
    policy = parts["policy"]
    record: dict = {"participants": policy.n_participants,
                    "window": cfg.window}
    if shape.kind == "train":
        record.update(micro_steps=parts["micro_steps"],
                      micro_batch=parts["micro_batch"],
                      accumulate=accumulate)
    by_part = {k: per_device_bytes(t, s, policy)
               for k, (t, s) in parts["arguments"].items()}
    out_by_part = {k: per_device_bytes(t, s, policy)
                   for k, (t, s) in parts["outputs"].items()}
    out_by_part["tuple_index"] = TUPLE_ENTRY_BYTES * sum(
        len(tree_flatten(t)[0]) for t, _ in parts["outputs"].values())
    record["memory"] = {
        "argument_size_in_bytes": sum(by_part.values()),
        "output_size_in_bytes": sum(out_by_part.values()),
        "by_part": by_part,
        "output_by_part": out_by_part,
        "reckoned": True,
    }
    params_t, params_spec = parts["arguments"]["params"]
    if shape.kind == "train":
        own = strategy_collectives(strategy, params_t, params_spec, policy,
                                   agg_dtype)
        treedef = tree_flatten(params_t)[1]
        one_spec = treedef.unflatten(
            [s[1:] for s in treedef.flatten_up_to(params_spec)])
        model, notes = model_collectives(
            cfg, shape, policy, one_spec, micro=parts["micro_steps"],
            b_micro=parts["micro_batch"])
    else:
        own = {"bytes": {}, "counts": {}}
        model, notes = model_collectives(cfg, shape, policy, params_spec)
    by_model = summarize(model)
    coll = {key: {k: own[key].get(k, 0) + by_model[key].get(k, 0)
                  for k in sorted(set(own[key]) | set(by_model[key]))}
            for key in ("bytes", "counts")}
    per_device = int(sum(coll["bytes"].values()))
    record["collectives"] = {
        **coll, "per_device_bytes": per_device,
        "total_bytes": per_device * mesh_cfg.n_devices,
        "strategy": own, "model": by_model,
        "remat": summarize([c for c in model if c.remat]),
        "reckoned": "; ".join([COLLECTIVES_RECKONED] + notes)}
    record["roofline"] = analytic_terms(
        cfg, shape,
        n_participants=policy.n_participants,
        local_steps=record.get("micro_steps", 1),
        collective_total_bytes=record["collectives"]["total_bytes"],
        chips=mesh_cfg.n_devices)
    record["roofline"]["raw_hlo_flops"] = None
    record["roofline"]["raw_hlo_bytes"] = None
    return record


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool,
               strategy: str = "modest", verbose: bool = True,
               extra_cfg=None, agg_dtype: str = "float32",
               micro_override=None, accumulate: bool = False) -> dict:
    """One record on the production mesh (``multi_pod``: two pods);
    :func:`reckon` takes any ``MeshConfig``."""
    shape = SHAPES[shape_name]
    cfg = effective_config(arch, shape_name)
    if extra_cfg:
        cfg = cfg.with_(**extra_cfg)
    mcfg = mesh_config(multi_pod=multi_pod)
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mcfg.shape)),
        "strategy": strategy if shape.kind == "train" else "serve",
    }
    t0 = time.perf_counter()  # noqa: DL002(reckoning wall time for the dry-run record)
    body = reckon(cfg, shape, mcfg, strategy=strategy, agg_dtype=agg_dtype,
                  micro_override=micro_override, accumulate=accumulate,
                  arch=arch)
    record.update(participants=body.pop("participants"),
                  window=body.pop("window"),
                  overrides=dict(extra_cfg or {}))
    record.update(body)
    record["reckon_s"] = time.perf_counter() - t0  # noqa: DL002(reckoning wall time for the dry-run record)
    if verbose:
        _print_summary(record)
    return record


def _print_summary(r: dict) -> None:
    rl = r["roofline"]
    mem = r["memory"]
    print(f"[dryrun] {r['arch']:24s} {r['shape']:12s} mesh={r['mesh']:10s} "
          f"reckon={r['reckon_s']:7.3f}s "
          f"flops={rl['flops']:.3e} "
          f"coll={r['collectives']['total_bytes']:.3e}B "
          f"args/dev={mem['argument_size_in_bytes'] / 1e9:.2f}GB "
          f"temp/dev=not reckoned "
          f"dom={rl['dominant']}")
    print(f"  memory (reckoned): {mem['by_part']}")
    print(f"  collectives ({r['collectives']['reckoned']}): "
          f"{r['collectives']['bytes']}")
    print(f"  roofline: compute={rl['compute_s']:.4f}s "
          f"memory={rl['memory_s']:.4f}s "
          f"collective={rl['collective_s']:.4f}s "
          f"useful={rl['useful_flop_ratio']:.3f}")


def artifact_path(arch, shape_name, multi_pod, strategy="modest", tag=""):
    mesh = "2x16x16" if multi_pod else "16x16"
    suffix = f"__{tag}" if tag else ""
    return os.path.abspath(os.path.join(
        ARTIFACT_DIR, f"{arch}__{shape_name}__{mesh}__{strategy}{suffix}.json"))


def main(argv=None):
    """Write the records asked for; returns the paths written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--strategy", default="modest",
                    choices=["modest", "fedavg", "dsgd", "local"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix for perf expts")
    ap.add_argument("--agg-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--micro", type=int, default=None,
                    help="override grad-accum micro steps (perf expts)")
    ap.add_argument("--accumulate", action="store_true",
                    help="E axis = grad accumulation (one update per round)")
    ap.add_argument("--set", nargs="*", default=[],
                    help="cfg overrides key=value (perf experiments)")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    archs = configs.ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    failures, written = [], []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                path = artifact_path(arch, shape_name, mp, args.strategy,
                                     args.tag)
                if os.path.exists(path) and not args.force:
                    print(f"[dryrun] skip existing {os.path.basename(path)}")
                    continue
                try:
                    rec = dryrun_one(arch, shape_name, multi_pod=mp,
                                     strategy=args.strategy,
                                     extra_cfg=overrides,
                                     agg_dtype=args.agg_dtype,
                                     micro_override=args.micro,
                                     accumulate=args.accumulate)
                    with open(path, "w") as fh:
                        json.dump(rec, fh, indent=1)
                    written.append(path)
                except Exception as e:
                    failures.append((arch, shape_name, mp, repr(e)))
                    print(f"[dryrun] FAIL {arch} {shape_name} mp={mp}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall dry-runs OK ({len(written)} written)")
    return written


if __name__ == "__main__":
    main()
