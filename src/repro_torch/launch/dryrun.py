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
  of its fp32 shard; ``local`` none; prefill and decode none. The
  tensor-parallel collectives of the forward and backward passes are not
  reckoned (``reckoned`` says so). ``total_bytes`` is the bytes on one
  device times the device count, as the roofline reads it.
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
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.config import (SHAPES, H100, MeshConfig, ShapeConfig,
                                TrainConfig, parse_overrides)
from repro_torch.core.distributed import DistributedTrainer, Server
from repro_torch.launch.mesh import make_mesh_from_config, mesh_config
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
COLLECTIVES_RECKONED = ("strategy aggregation only; tensor-parallel "
                        "collectives not reckoned")


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
    if shape.kind == "train":
        params_t, params_spec = parts["arguments"]["params"]
        coll = strategy_collectives(strategy, params_t, params_spec, policy,
                                    agg_dtype)
    else:
        coll = {"bytes": {}, "counts": {}}
    per_device = int(sum(coll["bytes"].values()))
    record["collectives"] = {**coll, "per_device_bytes": per_device,
                             "total_bytes": per_device * mesh_cfg.n_devices,
                             "reckoned": COLLECTIVES_RECKONED}
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
