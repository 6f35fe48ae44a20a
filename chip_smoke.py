#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mf-gap-readings   # what MF_GAP_TOL is set from

Builds the CUDA kernels from the sources in this checkout (into ``build/``),
holds each against its plain PyTorch version on the card, then drives the
two main paths and checks that each really went through its kernels:

* plain: one MoDeST session with the paper CNN at full width through the
  batched engine (``fused.agg``), and a fused aggregate→quantize over the
  session's last cohort (``fused.agg_quant``);
* masked (``secure_agg="masked"``): the same session with secure
  aggregation, where every trainer seals its model (``fused.mask``) and
  every aggregator unmasks and aggregates the sealed rows in one launch
  (``fused.unmask_agg``), and a fused unmask→aggregate→quantize over its
  last sealed cohort (``fused.unmask_agg_quant``);
* serve: TinyLlama-1.1B at full width and depth (22 layers, bf16, weights
  from a seeded generator) through ``Server`` with ``use_flash=True``: a
  prefill of 4 x 1024 tokens, 32 greedy decode steps and a second prefill,
  each prefill launching the flash-attention kernel once a layer
  (``flash_attention``), then the serving launcher at full size once
  (its config leaves ``use_flash`` off: plain attention, no launch);
* mesh_serve: the serving launcher (``launch.serve.main``) at the serve
  phase's shape and seed with ``--full-size --set use_flash=true
  --devices 8 --model-parallel 2``: a 4 x 2 mesh whose entries all name
  the card, one ``flash_attention`` launch a layer. Gates: its tokens bit
  for bit the serve phase's; then ``Server(cfg, MeshConfig())`` on the
  production mesh (256 entries naming the card), every spec of the serve
  phase's parameters and of a real cache dividing its tensor. Reported:
  prefill seconds, decode tokens/s and the prefill against the H100
  roofline's (``roofline.analytic_terms(..., chips=1)``);
* trees: the per-leaf wrappers on real model trees. ``aggregate_pytree``
  over ten paper-CNN trees (7 fp32 leaves, N = 136,672, plus an int32 leaf
  whose mean lands on .5) and over four TinyLlama-1.1B trees at full width
  and depth (bf16, 1,100,048,384 parameters in 12 leaves), one launch of
  the per-leaf kernel a leaf (``aggregate.agg``); then
  ``quantized_delta_push`` and ``quantized_delta_pull`` of one tree against
  a second, one quantise (``quantize.quant``) and one dequantise
  (``quantize.dequant``) launch a leaf;
* MF: the paper's matrix-factorization task through the training launcher
  (``launch.train.main(["--task", "mf", ...])``: 32 nodes, cohorts of 10,
  aggregating through ``fused.agg``, then ``fused.agg_quant`` over its last
  cohort), and the same session with ``secure_agg="masked"`` built
  directly (``fused.mask``, ``fused.unmask_agg``, then
  ``fused.unmask_agg_quant`` over its last sealed cohort);
* served: the CNN session of the plain path with a serving deployment
  (``ServeConfig(n_replicas=2, publish_every=1, spool_dir=...)``), each
  published round saved by ``checkpoint.save`` and installed on both
  replicas by ``checkpoint.restore`` onto the card (``fused.agg`` at every
  aggregation); every install ``torch.equal`` to the params the fabric was
  handed at its round, and the same session without the spool giving the
  same ``serving`` dict and round times; wall seconds of both, and the
  spool's seconds per save and per install;
* ckpt_lm: one TinyLlama-1.1B tree at full width and depth (bf16, 12
  leaves, 2.2 GB) saved to a temporary directory and restored onto the
  card, every leaf ``torch.equal``; seconds and GB/s of each;
* mf_ckpt: the MF session through the training launcher again, with
  ``--ckpt PATH --ckpt-every 1``; the last file, restored into the MF
  template on the card, equals the last params saved, bit for bit, and its
  meta the last save's;
* sharded: the sharded FlatModel path on the one card, its mesh the card
  named k times. ``make_engine("sharded")`` falls back to the batched
  engine and ``engine="sharded"`` runs the batched session (rounds and
  bytes). B1, B2, B4 and B5 through the sharded entry points at 1, 2, 4
  and 8 chunks (pad to ``shard_align``, one launch a chunk, B4 and B5 at
  the chunk's lane base against the global ``n_valid``, gather) at the
  CNN stack with an integer leaf, the MF stack and the ragged streaming
  stack: mean, codes and scales bit for bit one launch's, each chunk's B4
  and B5 output the matching slice of one launch's (pad lanes zeros), the
  form each chunk's launcher picks, times at 1 and 4 chunks, and B4 and B5
  at a lane base (rows sealed at that base: bit for bit the plain
  kernels) against base 0, in turns. Then ``engine="sharded"`` with the
  mesh as 4 chunks of the card (``MeshEngine``), plain and masked, against
  the same session on the batched engine, both with cuDNN's deterministic
  algorithms: rounds and bytes equal, accuracy within 0.02 at every
  evaluated round, every aggregation 4 launches, and each re-aggregated in
  one launch over its inputs bit for bit;
* lm_train: MoDeST sessions that train a dense LM at TinyLlama's full
  widths (``lm_task("tinyllama-1.1b", reduce=False, n_layers=2)``: d_model
  2048, 32 query and 4 KV heads of 64, d_ff 5632, vocab 32000, bf16
  leaves; N = 219,162,624 lanes in 12 leaves, 438.3 MB on the wire) on the
  batched engine, 16 nodes, cohorts of 4, batch 8 of 96 tokens, 750
  simulated seconds, plain and with ``secure_agg="masked"``: every cohort
  step one ``torch.func`` pass over its 4 members, ``fused.agg`` once an
  aggregation (masked: ``fused.mask`` once a training and
  ``fused.unmask_agg`` once an aggregation, no plaintext on the wire), and
  ``fused.agg_quant`` (masked: ``fused.unmask_agg_quant``) over the last
  cohort; every mean within 1e-6 of the plain version of its inputs
  (masked: bit for bit ``fused.agg`` on the rows the plain path unseals),
  codes and scales bit for bit the plain quantiser's on the kernel's
  mean, every loss finite; a second, instrumented run of each for the
  breakdown; one cohort step against ``task._step`` for one member, every
  parameter within ``LM_STEP_BF16_SPACINGS`` bf16 steps; ``fused.agg`` and
  ``fused.unmask_agg`` at P = 10 over that N (P·N past 2^31, 8.8 GB of
  rows) against their plain versions; B1-B5 timed at P = 4 over that N;
* families: the other LM families served through ``Server`` with
  ``use_flash=True`` at published widths (``FAMILY_MODELS``, bf16, seeded
  random weights, prompts and stubbed frontend inputs from numpy seeds):
  qwen3-moe-30b-a3b (4 of its 48 layers, 4 x 1024 tokens),
  llava-next-mistral-7b (2,880 image embeddings and 192 text tokens a
  row), whisper-large-v3 (1,500 frames, 4 x 128 decoder tokens),
  hymba-1.5b (4 x 512) and rwkv6-1.6b (4 x 256), one at a time: a prefill
  to warm up, a counted prefill and 16 greedy decode steps each; every
  prefill of the four with attention launches ``flash_attention`` once an
  attention layer; finite logits, caches and states at the expected
  position, ids inside the vocabulary; flash against plain logits as in
  the serve phase; rwkv's decode after S tokens against a prefill over
  S+1 in fp32 (``LOGIT_REL_TOL_FP32``); the MoE's loss, auxiliary loss
  and the share of slots dropped at capacity, and a profile of its
  prefill; then the serving launcher at every new arch's reduced config
  and at whisper-large-v3's full size.
* lm_families_train: MoDeST sessions that train the MoE, RWKV-6 and Hymba
  families at published widths on the batched engine (bf16 leaves, seeded
  weights, ``FAMILY_TRAIN``: qwen3-moe-30b-a3b at 1 of 48 layers with 4
  nodes, cohorts of 2 and one aggregator, rwkv6-1.6b and hymba-1.5b at 2
  layers with 8 nodes and cohorts of 4), hymba also masked: every aggregation through
  ``fused.agg`` (masked: ``fused.mask`` once a training,
  ``fused.unmask_agg`` once an aggregation) and one quantised aggregation
  of the last cohort (``fused.agg_quant`` / ``fused.unmask_agg_quant``).
  Gates: the launches, at least ``FAMILY_TRAIN_ROUNDS`` rounds, finite
  losses (and the MoE's auxiliary loss), finite parameters, every trained
  model on the wire at least once (total bytes), the last mean within
  ``TOL`` of the plain version (masked: bit for bit ``fused.agg`` on the
  unsealed rows) and the quantised codes bit for bit. Reported: each
  session's wall and peak memory, one cohort step's time (CUDA events), and the MoE's share of slots dropped
  at capacity.
* mesh_train: the mesh form of a round. ``launch.train.main(["--mode",
  "mesh", "--full-size", ...])`` trains TinyLlama-1.1B at full width and
  depth: modest on 4 devices (P = 2, 3 rounds, failure rate 0.3), after
  which every replica must equal the others, and D-SGD on 8 (P = 4, one
  round), after which they must differ (at P = 2 D-SGD's pairwise mean is
  the full mean); the devices of a mesh all name the card. Then one
  ``DistributedTrainer`` round each of whisper-large-v3 (published widths,
  4 of 32 encoder and 4 of 32 decoder layers) with ``frames`` and of
  llava-next-mistral-7b (2 of 32 layers) with ``image_embeds``. Gates:
  finite losses, every slot active where no failure was drawn. Reported:
  the seconds of each round and the peak memory. Last, one TinyLlama-1.1B
  round (P = 2) after ``DistributedTrainer.shard_state`` on a 2 x 2 mesh
  naming the card, bit for bit the same round without a mesh.
* dryrun (after mesh_serve): ``launch.dryrun.main(["--all",
  "--both-meshes"])`` in this process into a temporary directory: 10 archs
  x 4 shapes x 2 meshes = 80 records reckoned on the ``meta`` device.
  Gates: every record complete; the card's allocated bytes and their peak
  (reset first) unchanged across the run; TinyLlama's ``prefill_32k``
  record on the 16 x 16 mesh holds, as its parameters' bytes a device, the
  serve phase's real full-size parameters under the same specs; TinyLlama's
  and qwen3-moe's model collectives (tensor-parallel, the MoE's routing)
  reckoned in every record, and RWKV-6's and Hymba's. Reported: the
  seconds, how many records exceed ``config.H100.hbm_bytes`` a device, and
  those four archs' model collectives a device by shape and mesh, with
  the remat term apart;
* examples: the six examples' twins (``examples/torch_*.py``) at the
  reference's defaults: ``quickstart`` (12 nodes, the paper CNN at full
  width, 60 simulated s), ``compare_fl_dl`` (FedAvg, D-SGD and MoDeST, 24
  nodes, 120 s, each training the CNN), ``train_lm`` (16 nodes, TinyLlama
  reduced to 4 layers and d_model 256, 240 s), the byte-only
  ``churn_resilience`` and ``trace_replay``, and ``torch_serve_batch.py
  --arch tinyllama-1.1b`` as a process of its own. Gates: every session
  that trains passes ``check_session`` with ``fused.agg`` launched once an
  aggregation and no other kernel; every printed number finite. Reported:
  each session's wall, rounds, final metric and bytes, and D-SGD's bytes
  over MoDeST's.
* world (last): the port across ranks (``launch.world``, one process a
  rank) on the one card, its ranks sharing it (gloo; gathers staged
  through host memory): the CNN session of ``session`` and its masked
  twin (20 simulated s) through ``engine="sharded"`` on a world of 4
  ranks, N in 4 lane chunks; ``launch/train.py --mode mesh --full-size
  --world`` (TinyLlama, MoDeST, P = 2, TP 2, 3 rounds); ``launch/serve.py
  --full-size --set use_flash=true --world`` on 2 x 2 at the serve phase's
  shape and seed, decodes teacher-forced on its tokens; a 1-rank NCCL
  world of the plain session; then qwen3-moe with its experts over
  ``model`` (``world_moe``): ``launch/serve.py --full-size --set
  n_layers=4 --set use_flash=true --world`` on 2 x 2 at the families
  phase's shape (B 4, 1,024 tokens), 3 decodes teacher-forced on its
  tokens, and ``launch/train.py --mode mesh --full-size --set n_layers=1
  --world`` (MoDeST, P = 2, TP 2, 3 rounds); then RWKV-6 and Hymba with
  their heads and d_inner over ``model`` (``world_recurrent``): the same
  serve at the families phase's shapes and full depth (Hymba with
  flash) and the mesh round at 2 layers (RWKV-6's also in fp32); then
  Whisper and LLaVA with their heads, d_ff and vocab over ``model``
  (``world_multimodal``): the same serve with flash at the families
  phase's shapes, Whisper at full depth and LLaVA at 8 of 32 layers, and
  a mesh round at ``MESH_FAMILIES``' cuts through ``DistributedTrainer``
  in a world body with ``frames`` / ``image_embeds`` in the batch (the
  launcher feeds tokens alone, ROADMAP C11); then every participant
  granularity (``world_granularities``): llama3-405b at published widths
  cut to 1 of 126 layers at ``pod`` granularity on 2 x 2 (P = 1, FSDP
  over ``data``, TP over ``model``), ``launch/serve.py --full-size --set
  n_layers=1 --set use_flash=true --world`` at B 4, 1,024 tokens, 3
  decodes teacher-forced on a one-process run's tokens, and 3 MoDeST
  rounds through ``DistributedTrainer`` in a world body, SGD 0.05 with a
  clip at half one process's first gradient norm; TinyLlama at 2 of 22
  layers on a ``pods=2, data=2, model=1`` world, 3 rounds at each of
  ``pod`` (P 2 over ``pod``, FSDP over ``data``, a clip that binds),
  ``chip`` (P 4) and ``data_rank`` (P 4 over ``("pod", "data")``)
  granularity. Gates: every rank's
  sessions bit for bit the same sessions on the batched engine in this
  process (both under cuDNN's deterministic algorithms: trajectory and
  history hash, every aggregation, the final model, a fused
  aggregate→quantize plain and masked), B1, B2, B3, B4 and B5 launched
  on every rank; the mesh rounds'
  losses within ``WORLD_LOSS_RTOL`` of ``mesh_train``'s one-process rounds,
  a quarter of what the one-process rounds at learning rate 0 (a skipped
  update) read; the sketch of the replicas' change over the rounds
  (``DistributedTrainer.param_sketch``) alike on every rank and within
  ``WORLD_CHANGE_REL`` of the one-process run's by relative norm (a
  skipped update is 1 off); the logits within ``WORLD_LOGITS_REL_L2`` of
  the serve phase's prefill and of the one-process launcher's
  teacher-forced decodes, 22 ``flash_attention`` launches a rank and no
  other; B1, B2, B4, B5 on a rank's lane chunk bit for bit the slice of
  one launch (``chunk_rows``, timed); the MoE serve's prefill logits
  within ``WORLD_LOGITS_REL_L2`` of the families phase's one-process bf16
  run, every step's distance from that run's fp32 logits within
  ``WORLD_MOE_ERR_RATIO`` times its bf16 run's, 4 ``flash_attention``
  launches a rank (B 2, 16 / 2 heads, hd 128) and no other; the MoE
  round's losses within ``WORLD_MOE_LOSS_RTOL`` and its change sketch held
  as TinyLlama's, against its own one-process rounds and their control
  at learning rate 0; RWKV-6's and Hymba's serves held as the MoE's
  decodes at every step (and the prefill within one process's own bf16
  distance from fp32 where that passes ``WORLD_LOGITS_REL_L2``), 32
  ``flash_attention`` launches a Hymba rank (B 2, 25 / 5 heads) and no
  other, none on an RWKV-6 rank; their rounds by ``world_recurrent_train``
  (Hymba's sketch against its control; RWKV-6's bf16 rounds by C12's rule
  against a one-process run from weights moved by one ulp, its update in
  fp32); Whisper's and LLaVA's serves held as Hymba's, 32 (Whisper: B 2,
  10 / 10 heads, S 128) and 8 (LLaVA: B 2, 16 / 4 heads, S 3,072)
  ``flash_attention`` launches a rank and no other, their rounds' losses
  within ``WORLD_MULTIMODAL_LOSS_RTOL`` and their sketches as Hymba's;
  llama3-405b's serve held as Whisper's, one ``flash_attention`` launch a
  rank (B 2, 64 / 4 heads, hd 128, S 1,024) and no other; the
  granularities' rounds' losses within ``WORLD_GRAN_LOSS_RTOL`` and their
  sketches as Hymba's. Reported: each world's backend, seconds, and each
  rank's launches, seconds, staged bytes, peak and host peak (its largest
  resident set); the share of the MoE serve's
  (token, choice) slots routed to another expert than in one process, by
  step.

Each path is driven with every launch count set to 0 just before it and
read just after.

Before the paths, the kernels phase times every kernel beside its plain
version; B1-B5 at the CNN session's stack (P = 10, N = 136,672), with an
integer leaf, at a streaming shape (P = 16, N = 2^24), ragged, and at the MF
session's stack (P = 10, N = 11,173), next to the launch floor (a
one-element ``fill_``). The masked kernels' rows carry ``pipe_bound_ms``,
their least time on the integer pipes: the PRG's own instructions a mask
word, read from the SASS of the library this run built (``fused_sass``),
and every B1-B5 row names the kernel and grid its launcher chose
(``form``). The ``roofline`` line holds ``roofline.aggregation_roofline``'s
one-pass time for B1 and B2 (the H100's HBM rate, ``config.H100``) to
``bound_ms`` at the CNN, MF and TinyLlama-session stacks: within
``ROOFLINE_REL_TOL``, the P weights' bytes that the roofline leaves out. A call of B2 and of B5 after the timed graph replays must
give what the first call gave, bit for bit, with the arrival counts and
absmax words of the quantised forms' workspace back at 0. ``masked_edges`` holds the
masked kernels bit for bit at edge shapes; ``quant_edges`` holds B1, B2,
B4 and B5 to one another and B2 and B5's codes and scales to the plain
quantiser at the edges of the quantised forms (subtiles, the rows
kernel's limit, every block size a launcher can choose, P·R = 6144);
``nonfinite`` holds B2, B5 and B7 to the reference's quantisation of a
NaN and an Inf lane (scale NaN or Inf, codes 0). B9 is also held and
timed at the four layouts of the families phase's prefills and at a rank's
share of each of the world phase's flash serves. ``fused_ptxas`` prints
the registers and spills of every kernel of ``fused_agg.cu``, each of
which must be built for sm_90a with no spill.

It needs a CUDA device and fails without one (non-zero exit, nothing is
caught). Each phase prints one JSON line. The last three lines are: the
card's name and power limit, one JSON object ``{"kernels": [...]}`` with
every kernel's numbers from this run, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Tolerances: kernel mean against the plain version ``rtol = atol = 1e-6``
(summation order and fused multiply-add differ); int8 codes and scales are
compared bit for bit against the plain quantiser applied to the kernel's
own mean (a NaN scale equals a NaN: its bits are not the format's); the
two kernels' means are compared bit for bit. A NaN or Inf lane is held to
the reference's quantisation as the plain quantiser gives it on the CPU.
The seal is compared with its plain version bit for bit; the masked
kernels' mean, codes and scales with the plain kernels' on the unsealed
rows bit for bit.
Flash attention against its plain version (the full softmax in fp32):
``rtol = atol = 3e-5`` in fp32, the reference's own kernel-test tolerance;
in bf16 ``rtol = 1e-2, atol = 1e-4``. Both versions round an fp32 result
to bf16, so where their fp32 sums straddle a rounding point they differ by
one bf16 step, at most 2^-7 = 0.0078 of the value: ``rtol`` passes that
and no more, and ``atol`` is far above the fp32 sums' own difference and
far below the outputs' typical size (about 0.02 at the serving shape), so
a kernel that keeps its sums in bf16 (several per cent off) fails, and so
does one that rounds P to one bf16 before P·V (the bf16 kernel splits P
in two bf16 terms). SDPA's error under the same check is reported beside
its time and not gated; the ptxas lines of the flash kernels (registers,
spills, target) are printed, and each must be built for sm_90a.

The per-leaf kernels: fp32 means against ``ref.aggregate_ref``
``rtol = atol = 1e-6``; bf16 means equal or one bf16 step apart (both
round an fp32 sum whose last bits may differ; the share of such lanes is
printed); integer leaves exact; quantised codes and scales and
dequantised values bit for bit the plain versions'; a push-pull round trip
within half a quantisation step of each lane's tile, plus half a step of
the result's own type (fp32 or bf16).

The MF sessions: rounds and total bytes equal between the batched and the
sequential engine; the held-out MSE at every evaluated round, and the MSE
on the clients' own training ratings at the end, within ``MF_GAP_TOL`` of
each other (set from the readings of ``--mf-gap-readings``: between the
largest gap of sound runs and the smallest a fault planted in the stacked
gradients shows); the training-ratings MSE lower at the end than at round
0. The held-out MSE's direction is reported, not gated: on this synthetic
task it rises with training in the reference as in the port (ROADMAP C6).

The serve phase's flash prefill against the same prefill with
``use_flash=False``, for three draws of weights and prompts: with the
weights widened to fp32, the relative L2 error of the last position's
logits at most ``1e-4`` (the kernel's own error is about 1e-7 of a value;
the bound leaves room for its spread); in bf16, whose roundings spread
through the 22 layers to a gap of about 1e-2 between any two orders of
summation, the flash path's relative L2 distance from the fp32 plain
logits at most twice the plain bf16 path's own distance from them.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM, bf16 dense on the tensor cores
# H100 SXM, INT32 outside the tensor cores: 64 INT32 lanes an SM x 132 SMs
# x 1.98 GHz boost x 2 (a multiply-add counted as two), as the "Peak INT32
# TOPS" row of NVIDIA's H100 Tensor Core GPU Architecture white paper
INT32_OPS_PER_S = 33.5e12
# integer operations of one mask term at one lane: the PRG word (counter
# xor, two mixes of 8, one add; the seed's product is per row, hoisted),
# then the sign's product and the running sum
TERM_OPS = 18 + 2
# Hopper's integer ALU pipe and its FMA pipe each issue 64 lanes an SM a
# clock (the masked kernels' bound on them: ``pipe_bound_ms``)
INT_PIPE_LANES = 64
TOL = 1e-6
FLASH_TOL = {torch.float32: {"rtol": 3e-5, "atol": 3e-5},
             torch.bfloat16: {"rtol": 1e-2, "atol": 1e-4}}
LOGIT_REL_TOL_FP32 = 1e-4
BF16_ERR_RATIO = 2.0            # flash bf16 error / plain bf16 error, at most
SERVE_SEEDS = (0, 1, 2)         # weights and prompts of the logits check
SERVE_B, SERVE_S, SERVE_NEW = 4, 1024, 32     # the serve phase's shape
TREE_WEIGHTS = (0.5, 1.0, 2.0, 0.25)    # the TinyLlama trees' aggregation
# MF, batched engine against sequential: the largest held-out MSE gap over
# the evaluated rounds, and the training-ratings MSE gap at the end. Set
# from ``--mf-gap-readings`` on one H100: sound runs (seeds 0-3) reach
# 2.4e-7 and 1.2e-8; the planted faults 7.0e-3 and 3.3e-3 or more, but
# the dropped L2 term only 1.0e-6 held out and 2.8e-6 on the training
# ratings, which is the gap that catches it.
MF_GAP_TOL = {"heldout_gap": 1e-5, "train_end_gap": 2e-7}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def run_cmd(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, iters: int, warmup: int = 3, replays: int = 3) -> float:
    """Device time of one ``fn()``: ``iters`` calls are captured into one
    CUDA graph and the graph is replayed, so the host's cost of issuing
    each call (which exceeds the kernel's own time at small shapes) stays
    out of the figure. CUDA events around the replays, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def eager_ms(fn, iters: int, warmup: int = 3) -> float:
    """Time per call of ``iters`` back-to-back eager calls (CUDA events):
    what a caller sees, the host's issuing cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(kind: str, P: int, N: int, R: int, int_lanes: bool):
    """Least time the card could take for kernel ``kind`` at one shape:
    the larger of the bytes that must move (each input read once, each
    output written once) over the HBM rate, and the operations over the
    peak rate of their type. Integer and float operations run on separate
    pipes, so the operations' time is the larger of the two."""
    quant = kind.endswith("quant")
    if kind == "fused.mask":                     # one row in, one out
        nbytes, flops = 8 * N + 16 * R, 0
        int_ops = N * (TERM_OPS * R + 1)
    else:
        nbytes = 4 * (P * N + P + N) + (N if int_lanes else 0)
        if quant:
            nbytes += N + 4 * (-(-N // 16384))
        flops = 2 * P * N + N
        int_ops = 0
        if kind.startswith("fused.unmask"):      # regenerate and subtract
            nbytes += 16 * P * R
            int_ops = P * N * (TERM_OPS * R + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's largest SM clock (``nvidia-smi clocks.max.sm``)."""
    return 1e6 * float(run_cmd(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"])
                       .splitlines()[0])


def pipe_bound_ms(kind: str, P: int, N: int, R: int, word_pipes) -> float:
    """Least time of a masked kernel on the integer pipes: the busier of
    the ALU and FMA pipes' instructions a mask word, as the PRG itself
    issues them in this build (``word_pipes``, from ``prg_word_pipes``),
    times the words (R a lane, a row each), over 64 lanes an SM a clock on
    every SM at the largest SM clock."""
    words = R * N if kind == "fused.mask" else P * R * N
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (max(word_pipes[kind].values()) * words
            / (sms * INT_PIPE_LANES * sm_clock_hz()) * 1e3)


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def make_inputs(P: int, N: int, n_int: int, seed: int, dev):
    """(x, w, mask): fp32 stack and weights from a seed; the last ``n_int``
    lanes hold small integers and are marked in the byte mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((P, N), generator=g, device=dev, dtype=torch.float32)
    w = torch.rand((P,), generator=g, device=dev, dtype=torch.float32) + 0.5
    mask = None
    if n_int:
        x[:, N - n_int:] = torch.randint(0, 50, (P, n_int), generator=g,
                                         device=dev).to(torch.float32)
        mask = torch.zeros((N,), dtype=torch.uint8, device=dev)
        mask[N - n_int:] = 1
    return x, w, mask


def same(a, b) -> bool:
    """Equal shapes, types and values, a NaN equal to a NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def check_quant(mean, codes, scales, fused):
    """Codes and scales bit for bit against the plain quantiser applied to
    the kernel's own mean."""
    ref_codes, ref_scales = fused._plain_quantize(mean)
    if codes.dtype != torch.int8 or codes.shape != mean.shape:
        raise AssertionError(f"codes {codes.dtype} {tuple(codes.shape)}")
    if not same(scales, ref_scales):
        raise AssertionError("scales differ from the plain quantiser's")
    if not torch.equal(codes, ref_codes):
        bad = int((codes != ref_codes).sum())
        raise AssertionError(f"{bad} codes differ from the plain quantiser's")


def kernel_phase(dev, word_pipes):
    from repro_torch.kernels import fused

    # half-to-even on integer lanes: [7, 8] -> 7.5 -> 8, [100, 101] -> 100
    x = torch.zeros((2, 8), device=dev)
    x[0, :2] = torch.tensor([7.0, 100.0], device=dev)
    x[1, :2] = torch.tensor([8.0, 101.0], device=dev)
    w = torch.ones((2,), device=dev)
    m = torch.zeros((8,), dtype=torch.uint8, device=dev)
    m[:2] = 1
    got = fused.aggregate_flat_onepass(x, w, m)[:2].tolist()
    got_q = fused.aggregate_quantize_flat(x, w, m)[0][:2].tolist()
    if got != [8.0, 100.0] or got_q != [8.0, 100.0]:
        raise AssertionError(f"half-to-even rounding: {got} {got_q}")

    rows = fused_rows(dev, fused, word_pipes)
    masked_edges(dev, fused)
    quant_edges(dev, fused)
    nonfinite_check(dev)
    flash_rows(rows, dev)
    tile_rows(rows, dev)
    emit("kernels", tolerance={"mean_rtol_atol": TOL, "codes": "bit-identical",
                               "flash": {str(t)[6:]: v
                                         for t, v in FLASH_TOL.items()},
                               "scales": "bit-identical",
                               "agg_vs_agg_quant_mean": "bit-identical",
                               "mask_vs_plain": "bit-identical",
                               "unmask_vs_plain_kernels_on_unsealed_rows":
                                   "bit-identical",
                               "per_leaf_mean_bf16": "at most one bf16 step",
                               "quantize_and_dequantize": "bit-identical",
                               "nan_inf_lanes": "the reference's codes and "
                                                "scales"},
         launch_floor_ms=launch_floor_ms(dev), kernels=rows)
    return rows


# B1-B5's timed shapes; the first is the CNN session's, the main path's
FUSED_SHAPES = [
    # name, P, N, integer lanes, timing iterations
    ("session", 10, 136672, 0, 200),
    ("session_int_leaf", 10, 136672 + 4, 4, 200),
    ("stream", 16, 1 << 24, 0, 10),
    ("stream_ragged", 16, (1 << 24) - 1003, 1000, 10),
    ("mf_session", 10, 11173, 0, 200),          # the MF session's stack
]


def launch_floor_ms(dev) -> float:
    """Graph-replay time of a one-element ``fill_``: what any launch costs
    on this card, a yardstick for the kernels at the sessions' shapes."""
    t = torch.zeros((1,), device=dev)
    return time_ms(lambda: t.fill_(1.0), 200)


def fused_rows(dev, fused, word_pipes):
    """B1-B5 at ``FUSED_SHAPES``: each checked against its plain version
    and timed beside it."""
    rows = {"fused.agg": [], "fused.agg_quant": []}
    for i, shape in enumerate(FUSED_SHAPES):
        fused_shape_rows(rows, dev, fused, word_pipes, shape, seed=100 + i)
    return rows


def fused_shape_rows(rows, dev, fused, word_pipes, shape, seed: int):
    """B1-B5 at one ``(name, P, N, integer lanes, iterations)`` shape,
    appended to ``rows``: each checked against its plain version and
    timed beside it (the masked kernels on rows sealed from ``seed +
    100``)."""
    name, P, N, n_int, iters = shape
    x, w, mask = make_inputs(P, N, n_int, seed=seed, dev=dev)
    mean = fused.aggregate_flat_onepass(x, w, mask)
    mean_q, codes, scales = fused.aggregate_quantize_flat(x, w, mask)
    torch.cuda.synchronize()
    plain_mean = fused._plain_onepass(x, w, mask)
    for got_mean in (mean, mean_q):
        if got_mean.shape != (N,) or not torch.isfinite(got_mean).all():
            raise AssertionError(f"{name}: bad mean")
    err = float((mean - plain_mean).abs().max())
    if not torch.allclose(mean, plain_mean, rtol=TOL, atol=TOL):
        raise AssertionError(f"{name}: mean off by {err}")
    if not torch.equal(mean, mean_q):
        raise AssertionError(f"{name}: the two kernels' means differ")
    check_quant(mean_q, codes, scales, fused)

    wn = w / w.sum()
    calls = {
        "fused.agg": (
            lambda: fused.aggregate_flat_onepass(x, w, mask),
            lambda: fused._plain_onepass(x, w, mask),
            lambda: torch.matmul(wn, x)),     # yardstick only
        "fused.agg_quant": (
            lambda: fused.aggregate_quantize_flat(x, w, mask),
            lambda: fused._plain_onepass_quant(x, w, mask),
            None),                            # no single library call
    }
    for kname, (kernel, plain_fn, library) in calls.items():
        b, by = bound_ms(kname, P, N, 0, mask is not None)
        rows[kname].append({
            "shape": name, "P": P, "N": N, "int_lanes": n_int,
            "form": plan_label(fused, kname, N),
            "max_abs_err": err, "ms": time_ms(kernel, iters),
            "plain_ms": time_ms(plain_fn, iters),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(library, iters) if library else None,
            "eager_ms": eager_ms(kernel, iters),
            "eager_plain_ms": eager_ms(plain_fn, iters)})
    check_again(fused, f"{name}: fused.agg_quant",
                lambda: fused.aggregate_quantize_flat(x, w, mask),
                (mean_q, codes, scales))
    masked_rows(rows, name, x, w, mask, n_int, iters, seed=seed + 100,
                fused=fused, word_pipes=word_pipes)
    del x, w, mask, mean, mean_q, codes, scales, plain_mean
    torch.cuda.empty_cache()


def bits(t):
    """A bit view for comparing arbitrary fp32 bit patterns (NaN != NaN)."""
    return t.view(torch.int32)


def plan_label(fused, kname, N: int, terms: int = 0) -> str:
    """The kernel and grid the launcher of ``kname`` picks at N lanes (and
    ``terms`` staged mask terms), as ``lanes x4 64x534 together`` (form,
    four lanes a thread, threads x blocks; for a quantised form on the
    mean's grid, whether its blocks wait for the subtile or its last block
    writes the codes)."""
    if kname not in fused._PLAN_OPS:
        return "lanes 256"                       # the seal's one grid
    p = fused.launch_plan(kname, N, terms)
    mode = ""
    if kname.endswith("quant"):
        mode = " together" if p["together"] else " last block"
    return "{} {}{}x{}{}".format(p["form"], "x4 " if p["vec"] else "",
                                 p["threads"], p["blocks"], mode)


def check_again(fused, what, call, first):
    """A quantised call after the timed graph replays gives what ``first``
    gave, bit for bit, and leaves every arrival count and absmax word of
    the workspace at 0."""
    again = call()
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int8), b.view(torch.int8))
               for a, b in zip(again, first)):
        raise AssertionError(f"{what}: a call after the graph replays "
                             "differs from the first")
    for ws in fused._WORKSPACE.values():
        for words in (ws.words, *ws.kept):
            if words[:2].any():
                raise AssertionError(f"{what}: workspace words left at "
                                     f"{words[:2].nonzero().tolist()[:4]}")


def mask_terms(P: int, seed: int, dev):
    """(P, P) seeds and signs as the protocol makes them: uint32 seeds held
    in int64, signs of +1 and -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    seeds = torch.randint(0, 1 << 32, (P, P), generator=g, device=dev,
                          dtype=torch.int64)
    signs = torch.where(torch.rand((P, P), generator=g, device=dev) < 0.5,
                        -1, 1).to(torch.int64)
    return seeds, signs


def masked_rows(rows, name, x, w, mask, n_int, iters, seed, fused,
                word_pipes):
    """The seal and the two masked kernels at one shape, R = P terms a row:
    the seal against its plain version bit for bit, row by row; the masked
    kernels against the plain kernels on the unsealed rows bit for bit, and
    against their own plain versions within the tolerance."""
    P, N = x.shape
    seeds, signs = mask_terms(P, seed, x.device)
    y = torch.stack([fused.apply_mask_flat(x[p], seeds[p], signs[p])
                     for p in range(P)])
    torch.cuda.synchronize()
    for p in range(P):
        if not torch.equal(bits(y[p]), bits(fused._plain_mask(
                x[p], seeds[p], signs[p]))):
            raise AssertionError(f"{name}: fused.mask differs from its plain "
                                 f"version on row {p}")
    kw = dict(seeds=seeds, signs=signs)
    mean = fused.unmask_aggregate_flat(y, w, mask, **kw)
    qmean, codes, scales = fused.unmask_aggregate_quantize_flat(y, w, mask,
                                                                **kw)
    pmean, pcodes, pscales = fused.aggregate_quantize_flat(x, w, mask)
    torch.cuda.synchronize()
    if not torch.equal(mean, fused.aggregate_flat_onepass(x, w, mask)):
        raise AssertionError(f"{name}: fused.unmask_agg != fused.agg on the "
                             "unsealed rows")
    if not (torch.equal(qmean, pmean) and torch.equal(codes, pcodes)
            and torch.equal(scales, pscales)):
        raise AssertionError(f"{name}: fused.unmask_agg_quant != "
                             "fused.agg_quant on the unsealed rows")
    plain = plain_unmask_onepass(fused, y, w, mask, seeds, signs)
    err = float((mean - plain).abs().max())
    if not torch.allclose(mean, plain, rtol=TOL, atol=TOL):
        raise AssertionError(f"{name}: masked mean off by {err}")
    del plain
    # the plain masked versions move (P, N) int64 temporaries through ~30
    # passes a term: at the streaming shape one call takes most of a second,
    # and past PLAIN_LANES lanes they run in lane chunks (plain_unmask_*)
    slow = N > 1_000_000
    pi = 1 if slow else iters
    calls = {
        "fused.mask": (lambda: fused.apply_mask_flat(x[0], seeds[0], signs[0]),
                       lambda: fused._plain_mask(x[0], seeds[0], signs[0])),
        "fused.unmask_agg": (
            lambda: fused.unmask_aggregate_flat(y, w, mask, **kw),
            lambda: plain_unmask_onepass(fused, y, w, mask, seeds, signs)),
        "fused.unmask_agg_quant": (
            lambda: fused.unmask_aggregate_quantize_flat(y, w, mask, **kw),
            lambda: plain_unmask_onepass(fused, y, w, mask, seeds, signs,
                                         quant=True)),
    }
    for kname, (kernel, plain_fn) in calls.items():
        b, by = bound_ms(kname, P, N, P, mask is not None)
        rows.setdefault(kname, []).append({
            "shape": name, "P": P, "R": P, "N": N, "int_lanes": n_int,
            "form": plan_label(fused, kname, N, P * P),
            "pipe_bound_ms": pipe_bound_ms(kname, P, N, P, word_pipes),
            "max_abs_err": 0.0 if kname == "fused.mask" else err,
            "plain_lane_chunks": (1 if kname == "fused.mask"
                                  else plain_chunks(N)),
            "ms": time_ms(kernel, iters),
            "plain_ms": time_ms(plain_fn, pi, warmup=1,
                                replays=2 if slow else 3),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "eager_ms": eager_ms(kernel, iters),
            "eager_plain_ms": eager_ms(plain_fn, pi, warmup=1)})
        torch.cuda.empty_cache()
    check_again(fused, f"{name}: fused.unmask_agg_quant",
                lambda: fused.unmask_aggregate_quantize_flat(y, w, mask, **kw),
                (qmean, codes, scales))


# The masked kernels' edges, checked, not timed: rows across the mean's
# unroll (P), terms across the four-term unroll (R), lanes across blocks
# and groups of 32, and both of B4's kernels (N); rows across the row
# chunks of the kernel for few lanes (``EDGE_MANY_ROWS``, at N where that
# kernel runs); staged terms at and past 48 KB of shared memory, with the
# static shared memory of the rows kernel (N 11,173) and of the lane
# kernel's reduction (N 136,672) on top; a sealed NaN payload and a
# subnormal lane.
EDGE_P = (1, 3, 7, 17)
EDGE_R = (1, 3, 17)
EDGE_N = ((1, 0), (5, 0), (11173, 0), (136676, 4))      # (N, integer lanes)
EDGE_MANY_ROWS = ((65, 3, 5), (65, 3, 11173), (130, 3, 5),
                  (130, 3, 11173))                      # (P, R, N)
EDGE_MANY_TERMS = ((1, 6144, 777), (3, 2048, 3001), (3, 1024, 11173),
                   (3, 1024, 136672))                   # (P, R, N)


def masked_edges(dev, fused):
    """Each edge shape in ``masked_rows``' manner, bit for bit: every
    sealed row against ``_plain_mask``, the masked means, codes and scales
    against ``fused.agg`` / ``fused.agg_quant`` on the unsealed rows."""
    cases = [(P, R, N, n_int) for P in EDGE_P for R in EDGE_R
             for N, n_int in EDGE_N]
    cases += [(P, R, N, 0) for P, R, N in EDGE_MANY_ROWS + EDGE_MANY_TERMS]
    for i, (P, R, N, n_int) in enumerate(cases):
        x, w, mask = make_inputs(P, N, n_int, seed=700 + i, dev=dev)
        if i == 0 or (P, R, N) == (7, 3, 11173):
            x.view(torch.int32)[:, 0] = 0x7FC00001          # NaN payload
            if N > 1:
                x.view(torch.int32)[:, -1] = 0x00000001     # subnormal
        g = torch.Generator(device=dev).manual_seed(800 + i)
        seeds = torch.randint(0, 1 << 32, (P, R), generator=g, device=dev,
                              dtype=torch.int64)
        signs = torch.where(torch.rand((P, R), generator=g, device=dev)
                            < 0.5, -1, 1).to(torch.int64)
        name = f"edge P={P} R={R} N={N}"
        y = torch.stack([fused.apply_mask_flat(x[p], seeds[p], signs[p])
                         for p in range(P)])
        for p in range(P):
            if not torch.equal(bits(y[p]), bits(fused._plain_mask(
                    x[p], seeds[p], signs[p]))):
                raise AssertionError(f"{name}: fused.mask differs from its "
                                     f"plain version on row {p}")
        kw = dict(seeds=seeds, signs=signs)
        got = [fused.unmask_aggregate_flat(y, w, mask, **kw),
               *fused.unmask_aggregate_quantize_flat(y, w, mask, **kw)]
        want = [fused.aggregate_flat_onepass(x, w, mask),
                *fused.aggregate_quantize_flat(x, w, mask)]
        for what, a, b in zip(("mean", "agg_quant mean", "codes", "scales"),
                              got, want):
            if not torch.equal(a.view(torch.int8), b.view(torch.int8)):
                raise AssertionError(f"{name}: masked {what} differs from "
                                     "the plain kernel's on the unsealed rows")
    emit("masked_edges", cases=len(cases), P=EDGE_P, R=EDGE_R,
         N=[n for n, _ in EDGE_N], many_rows=EDGE_MANY_ROWS,
         many_terms=EDGE_MANY_TERMS,
         vs_plain="bit-identical")


# The quantised forms' edges: N on both sides of a subtile, of three and
# of B5's rows kernel's limit (67,552 on 132 SMs), and many subtiles in
# grids too large to be resident at once (2 M lanes and 4.3 M: the last
# block writes the codes); then, scanned upward from
# 67,553, the first N at which B4 (compared here too) picks each block
# size it can choose; P·R = 6144 in the rows kernel and the lane kernel;
# integer lanes.
QUANT_EDGE_N = (16383, 16384, 16385, 3 * 16384 + 1, 67552, 67553,
                2_000_000, 2_000_001, 264 * 16384 + 1)
QUANT_EDGE_TERMS = ((3, 2048, 16385), (48, 128, 67553))  # (P, R, N)


def b4_edge_scan(fused):
    """{block size: the first N >= 67,553 where B4's launcher picks it}."""
    found = {}
    for N in range(67553, 67553 + 40000):
        p = fused.launch_plan("fused.unmask_agg", N)
        found.setdefault(p["threads"], N)
        if len(found) == 4:
            break
    return found


def quant_edges(dev, fused):
    """B1, B2, B4 and B5 at the quantised forms' edges: the four means bit
    for bit one another, B1 within TOL of the plain version, B2 and B5's
    codes and scales bit for bit one another and the plain quantiser of
    their own mean. Fails unless the cases reach every form and block
    size the two quantised launchers can choose, both ways of writing the
    codes on the mean's grid, and each block size of B4."""
    scanned = b4_edge_scan(fused)
    cases = [(3, 3, N, 0) for N in QUANT_EDGE_N + tuple(sorted(
        scanned.values()))]
    cases += [(P, R, N, 0) for P, R, N in QUANT_EDGE_TERMS]
    cases += [(4, 3, 136676, 4), (4, 3, 67553, 3)]          # integer lanes
    seen = set()
    for i, (P, R, N, n_int) in enumerate(cases):
        x, w, mask = make_inputs(P, N, n_int, seed=1000 + i, dev=dev)
        g = torch.Generator(device=dev).manual_seed(1100 + i)
        seeds = torch.randint(0, 1 << 32, (P, R), generator=g, device=dev,
                              dtype=torch.int64)
        signs = torch.where(torch.rand((P, R), generator=g, device=dev)
                            < 0.5, -1, 1).to(torch.int64)
        kw = dict(seeds=seeds, signs=signs)
        y = torch.stack([fused.apply_mask_flat(x[p], seeds[p], signs[p])
                         for p in range(P)])
        m1 = fused.aggregate_flat_onepass(x, w, mask)
        m2, c2, s2 = fused.aggregate_quantize_flat(x, w, mask)
        m4 = fused.unmask_aggregate_flat(y, w, mask, **kw)
        m5, c5, s5 = fused.unmask_aggregate_quantize_flat(y, w, mask, **kw)
        torch.cuda.synchronize()
        name = f"quant edge P={P} R={R} N={N}"
        for kname, terms in (("fused.agg_quant", 0),
                             ("fused.unmask_agg_quant", P * R)):
            form, grid = plan_label(fused, kname, N, terms).rsplit("x", 1)
            seen.add((kname, form))
            seen.update((kname, mode) for mode in ("together", "last block")
                        if grid.endswith(mode))
        if not all(torch.equal(bits(m1), bits(m)) for m in (m2, m4, m5)):
            raise AssertionError(f"{name}: B1, B2, B4, B5 means differ")
        plain = fused._plain_onepass(x, w, mask)
        if not torch.allclose(m1, plain, rtol=TOL, atol=TOL):
            raise AssertionError(f"{name}: B1 off its plain version by "
                                 f"{float((m1 - plain).abs().max())}")
        if not (torch.equal(c2, c5) and torch.equal(bits(s2), bits(s5))):
            raise AssertionError(f"{name}: B2 and B5 codes or scales differ")
        check_quant(m2, c2, s2, fused)
    want = {("fused.agg_quant", f) for f in ("lanes x4 256", "lanes 256")}
    want |= {("fused.unmask_agg_quant", f) for f in ("lanes 256", "rows 128")}
    want |= {(k, mode) for k in ("fused.agg_quant", "fused.unmask_agg_quant")
             for mode in ("together", "last block")}
    if not want <= seen or sorted(scanned) != [64, 128, 192, 256]:
        raise AssertionError(f"quant_edges reached {sorted(seen)}, the "
                             f"launchers choose {sorted(want)}")
    emit("quant_edges", cases=len(cases), N=[c[2] for c in cases],
         terms=QUANT_EDGE_TERMS, forms=sorted(f"{k}: {f}" for k, f in seen),
         b4_threads=scanned,
         vs_plain="bit-identical")


def nonfinite_readings(dev, fused, qz, N: int) -> dict:
    """B2, B5 and B7 with a NaN at lane 1000 of subtile 0, +Inf of subtile
    1 and -Inf of subtile 2 (row 0 of a P = 3 stack; B7 quantises that row
    alone): each kernel's scales of those subtiles, its codes at those
    lanes, how many codes of each subtile are not 0, and whether all its
    codes and scales are the plain quantiser's on the CPU (the reference's
    values); the card's plain quantiser is read the same way."""
    S = 16384
    x, w, _ = make_inputs(3, N, 0, seed=900, dev=dev)
    lanes = [s * S + 1000 for s in range(3)]
    for lane, v in zip(lanes, (float("nan"), float("inf"), float("-inf"))):
        x[0, lane] = v
    seeds, signs = mask_terms(3, 901, dev)
    y = torch.stack([fused.apply_mask_flat(x[p], seeds[p], signs[p])
                     for p in range(3)])
    outs = {"fused.agg_quant": fused.aggregate_quantize_flat(x, w),
            "fused.unmask_agg_quant": fused.unmask_aggregate_quantize_flat(
                y, w, seeds=seeds, signs=signs),
            "quantize.quant": (x[0], *qz.quantize_tiles(x[0]))}
    plain_mean = outs["fused.agg_quant"][0]
    outs["plain_on_card"] = (plain_mean, *fused._plain_quantize(plain_mean))
    torch.cuda.synchronize()
    readings = {}
    for name, (v, codes, scales) in outs.items():
        want_codes, want_scales = fused._plain_quantize(v.cpu())
        readings[name] = {
            "scales": [repr(float(s)) for s in scales[:3].tolist()],
            "codes_at_lanes": [int(codes[lane]) for lane in lanes],
            "nonzero_codes": [int(codes[s * S:(s + 1) * S].count_nonzero())
                              for s in range(3)],
            "as_reference": same(scales.cpu(), want_scales)
                            and torch.equal(codes.cpu(), want_codes)}
    return readings


def nonfinite_check(dev):
    """``nonfinite_readings`` where B2 and B5 run each of their forms (the
    rows kernel, the lane kernel whose blocks wait for their subtile, and
    the lane kernel whose last block writes the codes): every
    kernel gives the reference's scale NaN, Inf, Inf and codes 0 in the
    three subtiles. The card's plain quantiser is reported, not gated."""
    from repro_torch.kernels import fused
    from repro_torch.kernels import quantize as qz

    out = {}
    want = {"scales": ["nan", "inf", "inf"], "codes_at_lanes": [0, 0, 0],
            "nonzero_codes": [0, 0, 0], "as_reference": True}
    for N in (3 * 16384 + 5, 136672, 264 * 16384):
        out[N] = nonfinite_readings(dev, fused, qz, N)
        for name, got in out[N].items():
            if name != "plain_on_card" and got != want:
                raise AssertionError(f"N={N}: {name} quantises NaN and Inf "
                                     f"lanes as {got}, the reference as "
                                     f"{want}")
    emit("nonfinite", want=want, readings=out)


def tile_bound_ms(kind: str, P: int, N: int, in_size: int, out_size: int):
    """Least time for one call of a per-leaf kernel: its inputs read once
    and its outputs written once over the HBM rate, against its fp32
    operations over the fp32 peak (a multiply-add a row and one division
    a lane to aggregate; absolute value, maximum, division, rounding and
    two clamps a lane to quantise; one product a lane to dequantise)."""
    tiles = -(-N // 16384)
    if kind == "aggregate.agg":
        nbytes, flops = in_size * P * N + 4 * P + out_size * N, 2 * P * N + N
    elif kind == "quantize.quant":
        nbytes, flops = in_size * N + N + 4 * tiles, 6 * N
    else:
        nbytes, flops = N + 4 * tiles + out_size * N, N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_steps(a, b):
    """How many bf16 steps apart two bf16 tensors lie, lane by lane (the
    bit patterns put in one order, -0 beside +0)."""
    def ordered(t):
        v = t.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)
    return (ordered(a) - ordered(b)).abs()


def check_mean(got, plain, what):
    """A kernel mean against its plain version: fp32 within TOL, bf16 at
    most one step apart, integers exact. Returns (max abs error, share of
    lanes one bf16 step apart)."""
    if got.shape != plain.shape or got.dtype != plain.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype}, want "
                             f"{tuple(plain.shape)} {plain.dtype}")
    err = float((got.float() - plain.float()).abs().max())
    if got.dtype == torch.bfloat16:
        steps = bf16_steps(got, plain)
        if int(steps.max()) > 1:
            raise AssertionError(f"{what}: {int(steps.max())} bf16 steps off")
        return err, float((steps != 0).float().mean())
    if not got.dtype.is_floating_point:
        if not torch.equal(got, plain):
            raise AssertionError(f"{what}: integer leaf differs")
    elif not torch.isfinite(got).all() or not torch.allclose(
            got, plain, rtol=TOL, atol=TOL):
        raise AssertionError(f"{what}: off by {err}")
    return err, 0.0


def tile_rows(rows, dev):
    """B6-B8 against their plain versions at the TinyLlama embedding leaf
    (the largest leaf of the trees phase; B6 at P = 4 in bf16, B7 on its
    fp32 delta, B8 back to fp32), the paper CNN's largest leaf (P = 10,
    fp32) and B1's streaming shape (P = 16, N = 2^24, fp32), timed beside
    the plain versions; for B6 ``torch.matmul`` of the normalised weights
    with the stack, and for B8 where N is whole tiles ``torch.mul`` of the
    codes viewed as (tiles, 16384) by the scales as a column, as
    yardsticks (the package never calls them; whether B8's equals the
    kernel's output bit for bit is printed)."""
    from repro_torch.kernels import aggregate as agg
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels.ref import aggregate_ref

    shapes = [
        # name, P, N, B6 dtype, timing iterations
        ("tinyllama_embed", 4, 65536000, torch.bfloat16, 10),
        ("cnn_fc1", 10, 122880, torch.float32, 200),
        ("stream", 16, 1 << 24, torch.float32, 10),
    ]
    for i, (name, P, N, dtype, iters) in enumerate(shapes):
        g = torch.Generator(device=dev).manual_seed(600 + i)
        x = torch.randn((P, N), generator=g, device=dev).to(dtype)
        w = torch.rand((P,), generator=g, device=dev) + 0.5
        got = agg.aggregate_tiles(x, w)
        torch.cuda.synchronize()
        err, share = check_mean(got, aggregate_ref(x, w), f"{name} B6")
        wn = (w / w.sum()).to(dtype)
        esize = x.element_size()
        b, by = tile_bound_ms("aggregate.agg", P, N, esize, esize)
        rows.setdefault("aggregate.agg", []).append({
            "shape": name, "P": P, "N": N, "dtype": str(dtype)[6:],
            "max_abs_err": err, "bf16_one_step_share": share,
            "ms": time_ms(lambda: agg.aggregate_tiles(x, w), iters),
            "plain_ms": time_ms(lambda: aggregate_ref(x, w), iters),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(lambda: torch.matmul(wn, x), iters),
            "library": "torch.matmul",
            "eager_ms": eager_ms(lambda: agg.aggregate_tiles(x, w), iters)})
        # the quantisers on an fp32 delta of the same length
        d = (x[0].float() - x[1 % P].float()) if P > 1 else x[0].float()
        del x, got
        torch.cuda.empty_cache()
        codes, scales = qz.quantize_tiles(d)
        back = qz.dequantize_tiles(codes, scales)
        torch.cuda.synchronize()
        pc, ps = qz._plain_quantize(d)
        if not (torch.equal(codes, pc) and torch.equal(scales, ps)):
            raise AssertionError(f"{name}: B7 codes or scales differ from the "
                                 f"plain version's ({int((codes != pc).sum())} "
                                 "codes)")
        plain_back = qz._plain_dequantize(codes, scales, torch.float32)
        if not torch.equal(back, plain_back):
            raise AssertionError(f"{name}: B8 differs from its plain version")
        # B8's one-call yardstick where N is whole tiles: the int8 codes as
        # (tiles, TILE) times the scales as a column (the promotion casts)
        whole = N % qz.TILE == 0
        grid = codes.view(-1, qz.TILE) if whole else None
        library = (lambda: torch.mul(grid, scales[:, None])) if whole else None
        for kname, kernel, plain_fn, b_args, lib_fn in (
                ("quantize.quant", lambda: qz.quantize_tiles(d),
                 lambda: qz._plain_quantize(d), (4, 1), None),
                ("quantize.dequant", lambda: qz.dequantize_tiles(codes, scales),
                 lambda: qz._plain_dequantize(codes, scales, torch.float32),
                 (1, 4), library)):
            b, by = tile_bound_ms(kname, 1, N, *b_args)
            row = {
                "shape": name, "N": N, "dtype": "float32", "max_abs_err": 0.0,
                "ms": time_ms(kernel, iters), "plain_ms": time_ms(plain_fn, iters),
                "bound_ms": b, "bound_by": by,
                "library_ms": time_ms(lib_fn, iters) if lib_fn else None,
                "eager_ms": eager_ms(kernel, iters)}
            if lib_fn:
                row["library"] = "torch.mul (int8 codes x scales column)"
                row["library_equals_kernel"] = torch.equal(
                    lib_fn().reshape(-1), back)
            rows.setdefault(kname, []).append(row)
        del d, codes, scales, back, plain_back, pc, ps, grid, library
        torch.cuda.empty_cache()


def flash_bound_ms(B, Hq, Hkv, S, hd, dtype, causal):
    """Least time for one attention call: q, k, v read once and the output
    written once over the HBM rate, against the 4·hd operations a (query,
    key) pair that is not masked needs (two multiply-adds a dim, for q·k and
    p·v) over the peak of the inputs' type: bf16 on the tensor cores, fp32
    outside them. Also the least time of the kernel's own design on the
    pipe it uses: bf16 runs p·v twice (P in two bf16 terms), 6·hd tensor
    operations a pair; fp32 runs the 4·hd on the CUDA cores."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * B * S * hd * (2 * Hq + 2 * Hkv)
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * Hq * hd * pairs
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    design = 1.5 * t_ops if dtype == torch.bfloat16 else t_ops
    return bound + (max(t_bytes, design),)


def flash_qkv(B, Hq, Hkv, S, hd, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(shape, generator=g, device=dev) * 0.5).to(dtype)
            for shape in ((B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]


def err_share(got, plain, tol):
    """Largest error over its allowance ``atol + rtol |plain|``."""
    a, b = got.to(torch.float32), plain.to(torch.float32)
    return float(((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())).max())


def flash_check(q, k, v, causal, name):
    """Kernel against its plain version: shape, type, finite, tolerance;
    returns the largest absolute error, the largest error over its
    allowance ``atol + rtol |plain|`` (at most 1) and the relative L2
    error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    plain = flash_attention_ref(q, k, v, causal)
    if got.shape != q.shape or got.dtype != q.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    a, b = got.to(torch.float32), plain.to(torch.float32)
    tol = FLASH_TOL[q.dtype]
    err = float((a - b).abs().max())
    share = err_share(a, b, tol)
    rel = float((a - b).norm() / b.norm())
    if not torch.allclose(a, b, **tol):
        raise AssertionError(f"{name}: off its plain version by {err} "
                             f"({share} of its tolerance)")
    return err, share, rel


def flash_label(mangled: str) -> str:
    name = re.search(r"(flash_(?:tc|fwd)_kernel)I(\w*?)EEv", mangled)
    return mangled if not name else "{}<{}>".format(
        name.group(1), ",".join(
            (["float"] if name.group(2).startswith("f") else [])
            + re.findall(r"Li(\d+)", name.group(2))))


def fused_label(mangled: str) -> str:
    """``fused_agg_kernel<SealedRows,0,1>`` from its mangled name
    (template arguments: row reader, bools, ints)."""
    name = re.search(r"\d(fused_[a-z_]*kernel)", mangled)
    if not name:
        return mangled
    targs = re.search(r"kernelI(.*?)Ev", mangled)
    if not targs:
        return name.group(1)
    t = re.sub(r"NS_\d+(PlainRows|SealedRows)(?:ILb(\d)EE)?",
               lambda m: m.group(1) + (f"<{m.group(2)}>" if m.group(2)
                                       else "") + ",", targs.group(1))
    t = re.sub(r"Lb(\d)E|Li(\d+)E",
               lambda m: (m.group(1) or m.group(2)) + ",", t)
    return "{}<{}>".format(name.group(1), t.replace("E", "").rstrip(","))


def ptxas_kernels(log: str, label=flash_label):
    """Target, registers, spills and static shared memory of each kernel
    in a ``-Xptxas -v`` log (shared memory sized in a launcher is dynamic
    and not in it: the bf16 flash kernel's ring and Q, the staged mask
    terms)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for '(\w+)'", ln)
        if m:
            cur = {"kernel": label(m.group(1)), "target": m.group(2)}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                sm = re.search(r"(\d+) bytes smem", ln)
                cur["registers"] = int(m.group(1))
                cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def flash_rows(rows, dev):
    """B9 against its plain version at the serving shape and at S = 640
    (where the reference's tiling raises, ROADMAP C3), causal and not, fp32
    and bf16, at starcoder2-15b's heads (hd 128, bf16, causal) and at the
    four layouts of the families phase's prefills and at a rank's share of
    the world phase's 2 x 2 serves (TinyLlama: B 2, 16 / 2 heads;
    qwen3-moe: B 2, 16 / 2 heads at hd 128, S 1024; Hymba: B 2, 25 / 5
    heads, S 512; Whisper: B 2, 10 / 10 heads, S 128; LLaVA: B 2, 16 / 4
    heads at hd 128, S 3,072; llama3-405b: B 2, 64 / 4 heads at hd 128, S
    1024; TinyLlama's shard_seq serve: B 1, 16 / 2 heads, S 8,192; its
    kv_whole serve: B 4, 4 / 1 heads, S 1024; bf16, causal), timed
    beside its plain version and PyTorch's ``scaled_dot_product_attention``
    (a yardstick; the package never calls it), whose error under the same
    check is reported, not gated. bf16 rows also time each block shape of
    the kernel (one or two query heads of a KV head a block, one a
    warpgroup). The serving shape in bf16, causal, is the main path's and
    comes first. Then every head dim and a ragged length, checked only,
    each block shape equal bit for bit to the wrapper's choice."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    out = rows.setdefault("flash_attention", [])
    cases = [(SERVE_B, 32, 4, S, 64, dtype, causal, None)
             for S in (SERVE_S, 640)
             for dtype in (torch.bfloat16, torch.float32)
             for causal in (True, False)]
    cases.append((SERVE_B, 48, 4, SERVE_S, 128, torch.bfloat16, True, None))
    # the layouts the families phase's prefills give the kernel
    layouts = family_flash_layouts()
    cases += [(*layout, torch.bfloat16, True, arch)
              for arch, layout in layouts.items()]
    # a rank's share in the world phase's 2 x 2 serve: half the batch over
    # data, 32 / 4 heads halved over model
    cases.append((SERVE_B // 2, 32 // 2, 4 // 2, SERVE_S, 64,
                  torch.bfloat16, True, WORLD_FLASH_ROW))
    # and a rank's share in its qwen3-moe serve: half the batch, half of
    # the query and kv heads (hd 128)
    B, Hq, Hkv, S, hd = layouts[WORLD_MOE_ARCH]
    cases.append((B // 2, Hq // 2, Hkv // 2, S, hd, torch.bfloat16, True,
                  WORLD_MOE_FLASH_ROW))
    # and a rank's share in its Hymba serve: half the batch, every head
    # (the axis divides neither 25 nor 5: the attention runs replicated)
    B, Hq, Hkv, S, hd = layouts["hymba-1.5b"]
    cases.append((B // 2, Hq, Hkv, S, hd, torch.bfloat16, True,
                  WORLD_HYMBA_FLASH_ROW))
    # and a rank's share in its Whisper and LLaVA serves: half the batch,
    # half of the query and kv heads (Whisper's decoder self-attention,
    # 20 / 20 heads at hd 64; LLaVA's 32 / 8 at hd 128 over [image ‖ text])
    for arch, row in WORLD_MULTIMODAL_FLASH_ROWS.items():
        B, Hq, Hkv, S, hd = layouts[arch]
        cases.append((B // 2, Hq // 2, Hkv // 2, S, hd, torch.bfloat16,
                      True, row))
    # and a rank's share in llama3-405b's FSDP serve (W1): half the batch,
    # 128 / 8 heads halved over model, hd 128
    B, S = WORLD_FSDP_SERVE
    cases.append((B // 2, 128 // 2, 8 // 2, S, 128, torch.bfloat16, True,
                  WORLD_FSDP_FLASH_ROW))
    # and a rank's share in TinyLlama's shard_seq serve (W3): the whole
    # batch of 1 on every data rank, 32 / 4 heads halved over model
    cases.append((1, 32 // 2, 4 // 2, WORLD_SEQ_S, 64, torch.bfloat16, True,
                  WORLD_SEQ_FLASH_ROW))
    # and in its kv_whole serve (W4): the whole batch, 32 / 8 query heads
    # a rank meeting their group's one kv head
    cases.append((SERVE_B, 32 // WORLD_KV_RANKS, 1, SERVE_S, 64,
                  torch.bfloat16, True, WORLD_KV_FLASH_ROW))
    for i, (B, Hq, Hkv, S, hd, dtype, causal, arch) in enumerate(cases):
        name = arch or (
            f"S{S}_{str(dtype)[6:]}_{'causal' if causal else 'full'}"
            + ("" if hd == 64 else f"_Hq{Hq}_hd{hd}"))
        q, k, v = flash_qkv(B, Hq, Hkv, S, hd, dtype, 300 + i, dev)
        err, share, rel = flash_check(q, k, v, causal, name)
        b, by, design = flash_bound_ms(B, Hq, Hkv, S, hd, dtype, causal)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
        try:
            library = time_ms(sdpa, 20)
        except RuntimeError as e:        # a yardstick only: note and go on
            library, library_error, library_share = None, str(e)[:200], None
        else:
            library_error = None
            library_share = err_share(sdpa(), flash_attention_ref(
                q, k, v, causal), FLASH_TOL[dtype])
        row = {
            "shape": name, "model": arch if arch in layouts else None,
            "B": B, "Hq": Hq, "Hkv": Hkv,
            "S": S, "hd": hd,
            "dtype": str(dtype)[6:], "causal": causal, "max_abs_err": err,
            "err_share_of_tol": share, "rel_l2_err": rel,
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                          20),
            "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, causal),
                                5 if S <= SERVE_S else 2),
            "bound_ms": b, "bound_by": by, "design_bound_ms": design,
            "library_ms": library, "library": "scaled_dot_product_attention",
            "library_error": library_error,
            "library_err_share_of_tol": library_share,
            "eager_ms": eager_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal), 20)}
        if dtype == torch.bfloat16:      # each block shape the kernel has
            o = torch.empty_like(q)
            row["warpgroups"] = fa.warpgroups_for(hd, Hq // Hkv)
            row["ms_by_warpgroups"] = {str(n): time_ms(
                lambda: fa._launch(q, k, v, o, causal, warpgroups=n), 20)
                for n in (1, 2) if (Hq // Hkv) % n == 0}
            del o
        out.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    # every template, GQA with B > 1, ragged tails, a length of one
    for j, (B_, Hq_, Hkv_, S, hd_) in enumerate([
            (2, 4, 2, 77, 32), (2, 4, 1, 200, 128), (3, 6, 3, 1, 64),
            (1, 8, 8, 1000, 64)]):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = flash_qkv(B_, Hq_, Hkv_, S, hd_, dtype, 400 + j, dev)
                name = f"B{B_} Hq{Hq_} Hkv{Hkv_} S{S} hd{hd_} {dtype}"
                flash_check(q, k, v, causal, name)
                if dtype == torch.bfloat16:     # each block shape
                    want = fa.flash_attention(q, k, v, causal=causal)
                    for n in (1, 2):
                        if (Hq_ // Hkv_) % n:
                            continue
                        o = torch.empty_like(q)
                        fa._launch(q, k, v, o, causal, warpgroups=n)
                        if not torch.equal(o, want):
                            raise AssertionError(
                                f"{name}: {n} heads a block differ")
    # the model's layout: (B,S,H,hd) read and written through strides
    q, k, v = flash_qkv(2, 8, 2, 300, 64, torch.bfloat16, 500, dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    got = fa.flash_attention_bshd(qt, kt, vt).transpose(1, 2)
    if not torch.equal(got, fa.flash_attention(q, k, v)):
        raise AssertionError("flash_attention_bshd differs from the "
                             "(B,H,S,hd) call")


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------


def cnn_session(n_nodes: int, sample_size: int, engine: str, task=None,
                secure_agg=None, serve=None, device=None):
    from repro_torch.config import ModestConfig, TrainConfig
    from repro_torch.data.synthetic import make_classification_task
    from repro_torch.models.tasks import cnn_task
    from repro_torch.sim.runner import ModestSession

    return ModestSession(
        n_nodes=n_nodes,
        mcfg=ModestConfig(n_nodes=n_nodes, sample_size=sample_size,
                          n_aggregators=2, success_fraction=1.0,
                          ping_timeout=1.0, secure_agg=secure_agg),
        tcfg=TrainConfig(batch_size=20),
        task=task or cnn_task(device=device),
        data=make_classification_task(n_nodes, samples_per_node=100,
                                      iid=False, alpha=0.5, seed=0),
        seed=0, eval_every_rounds=5, engine=engine, serve=serve,
        device=device)


def record_aggregations(session, masked: bool, record=None):
    """Every aggregation's inputs and result, recorded around the engine
    without changing what it does: handed to ``record`` (default: appended
    to the list returned)."""
    calls = []
    record = record or calls.append
    if masked:
        inner = session.engine.aggregate_masked

        def aggregate_masked(models, seeds, signs, weights=None):
            out = inner(models, seeds, signs, weights)
            record((list(models), seeds, signs, weights, out))
            return out

        session.engine.aggregate_masked = aggregate_masked
    else:
        inner = session.engine.aggregate

        def aggregate(models, weights=None):
            out = inner(models, weights)
            record((list(models), weights, out))
            return out

        session.engine.aggregate = aggregate
    return calls


def reset_counts():
    from repro_torch.kernels import KERNELS
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def read_counts():
    from repro_torch.kernels import KERNELS
    return {n: k["wrapper"].launches for n, k in KERNELS.items()}


def synced_seconds(fn, *args):
    """``(fn(*args), seconds)`` on the host clock, synchronising the card
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_session(session, sim_seconds: float):
    return synced_seconds(session.run, sim_seconds)


def check_session(session, result, metric="accuracy", min_rounds=10):
    """What every session must show: enough rounds, batched cohorts served
    by queued jobs, finite parameters (the evaluated models; a D-SGD
    session's, every node's) and a finite ``metric`` history."""
    from repro_torch.engine.flat import as_buffer

    spec = session.task.flat_spec
    eng = session.engine
    acc = [(h["round"], h[metric]) for h in result.history if metric in h]
    if result.rounds_completed < min_rounds:
        raise AssertionError(f"only {result.rounds_completed} rounds")
    if eng.jobs_run <= 0 or eng.jobs_run <= eng.flushes:
        raise AssertionError(f"cohort not batched: {eng.jobs_run} jobs in "
                             f"{eng.flushes} flushes")
    # every training was served by a job queued ahead of its demand: a
    # parameter object re-made between submit and result would miss the
    # identity-keyed cache and be trained alone, without any error
    if eng.fallbacks != 0 or eng.jobs_run < result.trainings_completed:
        raise AssertionError(
            f"{eng.fallbacks} trainings fell back to training alone; "
            f"{eng.jobs_run} jobs for {result.trainings_completed} trainings")
    models = (session._eval_models.values()
              if hasattr(session, "_eval_models")
              else [node.params for node in session.nodes.values()])
    for b in [as_buffer(m, spec) for m in models]:
        if b.device != session.task.device or b.device.type != "cuda" or \
                b.shape != (spec.n,):
            raise AssertionError(f"buffer {tuple(b.shape)} on {b.device}")
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite parameters after training")
    if not acc or not all(np.isfinite(a) for _, a in acc):
        raise AssertionError(f"no finite {metric} history: {acc}")
    return acc


def session_phase(sim_seconds: float):
    from repro_torch.engine.flat import as_buffer
    from repro_torch.kernels import fused

    session = cnn_session(32, 10, "batched")
    spec = session.task.flat_spec
    if spec.n != 136672 or len(spec.shapes) != 7:
        raise AssertionError(f"paper-cnn layout changed: {spec}")
    calls = record_aggregations(session, masked=False)
    reset_counts()                         # counts of this path only
    result, wall = run_session(session, sim_seconds)

    n_agg = sum(len(node.agg_log) for node in session.nodes.values())
    eng = session.engine
    if fused.aggregate_flat_onepass.launches != n_agg or n_agg == 0:
        raise AssertionError(
            f"{fused.aggregate_flat_onepass.launches} fused.agg launches "
            f"for {n_agg} aggregations")
    acc = check_session(session, result)
    models = calls[-1][0]
    for b in [as_buffer(m, spec) for m in models]:
        if b.device.type != "cuda" or b.shape != (spec.n,):
            raise AssertionError(f"buffer {tuple(b.shape)} on {b.device}")
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite parameters after training")
    emit("session", model="paper-cnn", n_params=spec.n, n_nodes=32,
         sample_size=10, sim_seconds=sim_seconds,
         rounds=result.rounds_completed, wall_seconds=wall,
         accuracy=acc, flushes=eng.flushes, jobs=eng.jobs_run,
         fallbacks=eng.fallbacks, aggregations=n_agg,
         launches=read_counts(), trainings=result.trainings_completed,
         total_bytes=result.usage["total_bytes"])
    return session, models


def arm_sniffer(session):
    """Send-time wire tap: every model push that is not a sealed model."""
    from repro_torch.secureagg import SealedModel

    leaks = []
    orig = session.net.send

    def send(src, dst, msg):
        name = type(msg).__name__
        model = getattr(msg, "model", None)
        if model is not None and (name == "AggregateMsg" or (
                name == "MaskedModelMsg"
                and not isinstance(model.params, SealedModel))):
            leaks.append((src, dst, name))
        orig(src, dst, msg)

    session.net.send = send
    return leaks


def masked_session_phase(sim_seconds: float):
    """The session of ``session_phase`` with ``secure_agg="masked"``: every
    trained model is sealed on the card before it is pushed, and every
    aggregation unmasks and aggregates its sealed rows in one launch."""
    from repro_torch.kernels import fused

    session = cnn_session(32, 10, "batched", secure_agg="masked")
    leaks = arm_sniffer(session)
    calls = record_aggregations(session, masked=True)
    reset_counts()                         # counts of this path only
    result, wall = run_session(session, sim_seconds)
    launches = read_counts()

    n_agg = sum(len(node.agg_log) for node in session.nodes.values())
    logs = [e for node in session.nodes.values() for e in node.secagg_log]
    if not (launches["fused.unmask_agg"] == len(calls) == len(logs) == n_agg
            > 0):
        raise AssertionError(
            f"{launches['fused.unmask_agg']} fused.unmask_agg launches, "
            f"{len(calls)} masked aggregations, {len(logs)} unmasks, "
            f"{n_agg} aggregations")
    if launches["fused.mask"] != result.trainings_completed:
        raise AssertionError(f"{launches['fused.mask']} fused.mask launches "
                             f"for {result.trainings_completed} trainings")
    if launches["fused.agg"] or launches["fused.agg_quant"]:
        raise AssertionError(f"plain aggregation in a masked session: "
                             f"{launches}")
    if leaks:
        raise AssertionError(f"plaintext models on the wire: {leaks[:5]}")
    if any(margin < 0 for _, _, _, margin in logs):
        raise AssertionError(f"unmasked below threshold: {logs}")
    acc = check_session(session, result)
    spec = session.task.flat_spec
    emit("masked_session", model="paper-cnn", n_params=spec.n, n_nodes=32,
         sample_size=10, sim_seconds=sim_seconds,
         rounds=result.rounds_completed, wall_seconds=wall, accuracy=acc,
         aggregations=n_agg, unmasks=len(logs),
         trainings=result.trainings_completed, launches=launches,
         flushes=session.engine.flushes, jobs=session.engine.jobs_run,
         min_share_margin=min(m for _, _, _, m in logs),
         secagg_aborts=sum(n.secagg_aborts for n in session.nodes.values()),
         total_bytes=result.usage["total_bytes"])
    return session, calls


def unseal_plain(models, seeds, signs, weights):
    """The sealed rows of one masked aggregation unsealed by the plain
    path, and their weights."""
    from repro_torch.kernels import fused

    y = torch.stack([bits(m.buffer) for m in models]).view(torch.float32)
    x = plain_unseal(fused, y, torch.as_tensor(np.asarray(seeds, np.int64),
                                               device=y.device),
                     torch.as_tensor(np.asarray(signs, np.int64),
                                     device=y.device))
    w = torch.tensor([1.0] * len(models) if weights is None else weights,
                     dtype=torch.float32, device=y.device)
    return x, w


# The plain unmask holds each word in an int64 and moves (P, N) of them
# through ~30 passes a term: past this many lanes it runs in lane chunks
# (each at its lane base), which changes no value and keeps its
# temporaries to a few GB
PLAIN_LANES = 1 << 25


def plain_chunks(N: int) -> int:
    return -(-N // PLAIN_LANES) if N > 2 * PLAIN_LANES else 1


def plain_unseal(fused, y, seeds, signs):
    """``fused._plain_unmask_stack`` of the whole rows, in lane chunks
    past ``2 * PLAIN_LANES`` lanes."""
    N = y.shape[1]
    if plain_chunks(N) == 1:
        return fused._plain_unmask_stack(y, seeds, signs)
    out = torch.empty_like(y)
    for lo in range(0, N, PLAIN_LANES):
        out[:, lo:lo + PLAIN_LANES] = fused._plain_unmask_stack(
            y[:, lo:lo + PLAIN_LANES], seeds, signs, base=lo, n_valid=N)
    return out


def plain_unmask_onepass(fused, y, w, mask, seeds, signs, quant=False):
    """The plain versions of B4 (B5 with ``quant``), the unmask in lane
    chunks past ``2 * PLAIN_LANES`` lanes, the mean over the chunks'
    rows, then (B5) the plain quantiser over the whole mean."""
    N = y.shape[1]
    if plain_chunks(N) == 1:
        if quant:
            return fused._plain_unmask_onepass_quant(y, w, mask, seeds,
                                                     signs)
        return fused._plain_unmask_onepass(y, w, mask, seeds, signs)
    mean = torch.cat([fused._plain_unmask_onepass(
        y[:, lo:lo + PLAIN_LANES], w,
        None if mask is None else mask[lo:lo + PLAIN_LANES], seeds, signs,
        base=lo, n_valid=N) for lo in range(0, N, PLAIN_LANES)])
    if quant:
        return (mean, *fused._plain_quantize(mean))
    return mean


def means_check(session, calls, masked: bool, phase: str):
    """Every mean of the session recorded in ``calls`` within 1e-6 of the
    plain version of its inputs; masked, also bit for bit ``fused.agg`` on
    the rows the plain path unseals (run after the counted path: these
    launches are comparisons). Returns the largest difference."""
    from repro_torch.engine.flat import as_buffer
    from repro_torch.kernels import fused

    spec, worst = session.task.flat_spec, 0.0
    mask = spec.int_mask_on(torch.device("cuda", 0))
    for call in calls:
        if masked:
            models, seeds, signs, weights, out = call
            x, w = unseal_plain(models, seeds, signs, weights)
            if not torch.equal(out.buffer,
                               fused.aggregate_flat_onepass(x, w, mask)):
                raise AssertionError("a masked mean differs from fused.agg "
                                     "on the unsealed rows")
        else:
            models, weights, out = call
            x = torch.stack([as_buffer(m, spec) for m in models])
            w = torch.tensor([1.0] * len(models) if weights is None
                             else weights, dtype=torch.float32,
                             device=x.device)
        plain = fused._plain_onepass(x, w, mask)
        worst = max(worst, float((out.buffer - plain).abs().max()))
        if not torch.allclose(out.buffer, plain, rtol=TOL, atol=TOL):
            raise AssertionError(f"{phase}: a mean off by {worst}")
        del x, plain
    emit(phase, aggregations=len(calls), max_abs_err=worst,
         **({"vs_agg_on_unsealed_rows": "bit-identical"} if masked else {}))
    return worst


def masked_agg_quant_phase(session, last):
    """Fused unmask→aggregate→quantize over the last sealed cohort through
    the public entry point; part of the counted masked path."""
    from repro_torch.kernels import fused
    from repro_torch.kernels.ops import masked_aggregate_flatmodel

    models, seeds, signs, weights, _ = last
    spec = session.task.flat_spec
    before = fused.unmask_aggregate_quantize_flat.launches
    out = masked_aggregate_flatmodel(models, weights, seeds=seeds,
                                     signs=signs, spec=spec, quantize=True)
    torch.cuda.synchronize()
    launched = fused.unmask_aggregate_quantize_flat.launches - before
    if launched != 1:
        raise AssertionError(f"{launched} fused.unmask_agg_quant launches")
    return out


def masked_agg_quant_check(session, last, out, phase="masked_agg_quant"):
    """Mean, codes and scales bit for bit those of ``fused.agg_quant`` on
    the rows unsealed by the plain path."""
    from repro_torch.kernels import fused

    models, seeds, signs, weights, _ = last
    spec = session.task.flat_spec
    x, w = unseal_plain(models, seeds, signs, weights)
    want = fused.aggregate_quantize_flat(x, w, spec.int_mask_on(x.device))
    got = (out[0].buffer, out[1], out[2])
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("fused.unmask_agg_quant differs from "
                             "fused.agg_quant on the unsealed rows")
    check_quant(out[0].buffer, out[1], out[2], fused)
    emit(phase, models=len(models), n=spec.n,
         subtiles=int(out[2].shape[0]),
         vs_agg_quant_on_unsealed_rows="bit-identical")


def agg_quant_phase(session, models):
    """Fused aggregate→quantize over the last cohort's trained models,
    through the public entry point; still part of the counted main path."""
    from repro_torch.kernels import fused
    from repro_torch.kernels.ops import aggregate_flatmodel

    spec = session.task.flat_spec
    before = fused.aggregate_quantize_flat.launches
    out, codes, scales = aggregate_flatmodel(models, spec=spec, quantize=True)
    torch.cuda.synchronize()
    launched = fused.aggregate_quantize_flat.launches - before
    if launched != 1:
        raise AssertionError(f"{launched} fused.agg_quant launches")
    return out, codes, scales


def agg_quant_check(session, models, out, codes, scales, phase="agg_quant"):
    from repro_torch.engine.flat import as_buffer
    from repro_torch.kernels import fused

    spec = session.task.flat_spec
    x = torch.stack([as_buffer(m, spec) for m in models])
    w = torch.ones((len(models),), device=x.device)
    plain = fused._plain_onepass(x, w, None)
    err = float((out.buffer - plain).abs().max())
    if not torch.allclose(out.buffer, plain, rtol=TOL, atol=TOL):
        raise AssertionError(f"agg_quant mean off by {err}")
    if scales.shape != (-(-spec.n // fused.SUBTILE),):
        raise AssertionError(f"scales {tuple(scales.shape)}")
    check_quant(out.buffer, codes, scales, fused)
    emit(phase, models=len(models), n=spec.n,
         subtiles=int(scales.shape[0]), max_abs_err=err,
         codes="bit-identical", scales="bit-identical")


def breakdown_phase(sim_seconds: float, secure_agg=None, session=None,
                    phase="breakdown"):
    """Where the session's wall time goes. A second, instrumented run of
    the same session (synchronising around each engine call and, masked,
    around each seal), kept apart from the counted run so that run stays as
    a user would run it. ``session``: another session than the CNN's."""
    if session is None:
        session = cnn_session(32, 10, "batched", secure_agg=secure_agg)
    eng = session.engine
    spent = {"train": 0.0, "aggregate": 0.0, "evaluate": 0.0, "seal": 0.0}

    def timed(name, inner):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    eng._run_group = timed("train", eng._run_group)
    eng.aggregate = timed("aggregate", eng.aggregate)
    eng.aggregate_masked = timed("aggregate", eng.aggregate_masked)
    eng.evaluate_models = timed("evaluate", eng.evaluate_models)
    for node in session.nodes.values():
        if node._masker is not None:
            node._masker.seal = timed("seal", node._masker.seal)
    torch.cuda.reset_peak_memory_stats()
    result, wall = run_session(session, sim_seconds)
    host = wall - sum(spent.values())
    out = dict(secure_agg=secure_agg, rounds=result.rounds_completed,
               wall_seconds=wall, train_seconds=spent["train"],
               aggregate_seconds=spent["aggregate"],
               evaluate_seconds=spent["evaluate"],
               seal_seconds=spent["seal"], host_seconds=host,
               shares={k: v / wall for k, v in (*spent.items(),
                                                ("host", host))},
               flushes=eng.flushes, jobs=eng.jobs_run,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(phase, **out)
    return out


def profile_phase(sim_seconds: float):
    """The device's busy share of the session: a third run of the same
    session under ``torch.profiler``. Device-side events only — operator
    rows carry their kernels' time too, and counting both would double it.
    Tracing slows the host, so the share without tracing is somewhat
    higher. Where the profiler records no device time the share is
    reported as null (not measured), never as zero."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    session = cnn_session(32, 10, "batched")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = session.run(sim_seconds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_s = sum(t for _, t, _ in rows) / 1e6
    emit("profile", sim_seconds=sim_seconds, rounds=result.rounds_completed,
         wall_seconds_traced=wall,
         device_seconds=device_s if rows else None,
         device_busy_share=device_s / wall if rows else None,
         device_launches=sum(c for _, _, c in rows) if rows else None,
         top_kernels=[{"name": k[:80], "device_ms": t / 1e3, "count": c}
                      for k, t, c in rows[:10]])


def serve_phase(dev):
    """The serving path: TinyLlama-1.1B at full width and depth through
    ``Server`` with ``use_flash=True`` (prefill, 32 greedy decode steps, a
    second prefill for a warm time), then ``launch.serve.main`` at full size
    once. Counted: the caller sets the counts to 0 just before and reads them
    just after."""
    from repro_torch import configs
    from repro_torch.core.distributed import Server
    from repro_torch.launch import serve
    from repro_torch.utils.pytree import tree_leaves

    cfg = configs.get_config("tinyllama-1.1b").with_(use_flash=True)
    B, S, new = SERVE_B, SERVE_S, SERVE_NEW
    server = Server(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = server.shard_params(server.model.init(
        torch.Generator(device=dev).manual_seed(0), dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (B, S)), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def timed_prefill():
        cache = server.model.init_cache(B, S + new + 8, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = server.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        return logits, cache, time.perf_counter() - t0

    logits, cache, cold_s = timed_prefill()
    first = torch.argmax(logits[:, -1:], dim=-1)
    tok, generated = first, [first]
    t0 = time.perf_counter()
    for _ in range(new):
        logits, cache = server.decode(params, tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    flash_logits, _, warm_s = timed_prefill()
    peak = torch.cuda.max_memory_allocated(dev)
    launcher = serve.main(["--full-size", "--batch", str(B), "--prompt-len",
                           "128", "--new-tokens", "8", "--seed", "0"])

    gen = torch.cat(generated, dim=1)
    if flash_logits.shape != (B, 1, cfg.vocab) or not torch.isfinite(
            flash_logits).all():
        raise AssertionError(f"prefill logits {tuple(flash_logits.shape)}, "
                             "or not finite")
    if cache["pos"] != S + new or not torch.isfinite(
            cache["k"][:, :, :S + new].float()).all():
        raise AssertionError(f"cache at {cache['pos']}, or not finite")
    if not ((0 <= gen) & (gen < cfg.vocab)).all():
        raise AssertionError("generated ids out of the vocabulary")
    if launcher["tokens"].shape != (B, 8):
        raise AssertionError(f"launcher tokens {launcher['tokens'].shape}")
    return {"cfg": cfg, "server": server, "params": params, "toks": toks,
            "flash_logits": flash_logits, "first_tokens": first,
            "tokens": gen,
            "prefills": 2, "line": dict(
                model=cfg.name, n_params=sum(t.numel()
                                             for t in tree_leaves(params)),
                n_layers=cfg.n_layers, dtype=cfg.param_dtype, batch=B,
                prompt_len=S, new_tokens=new, init_seconds=init_s,
                prefill_seconds_cold=cold_s, prefill_seconds=warm_s,
                prefill_tokens_per_s=B * S / warm_s, decode_seconds=decode_s,
                decode_tokens_per_s=B * new / decode_s,
                peak_memory_bytes=peak,
                sample_ids=gen[0, :12].tolist(),
                launcher={k: launcher[k] for k in (
                    "prefill_seconds", "decode_seconds",
                    "decode_tokens_per_s")})}


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def logits_gaps(cfg, params, batch, dev, flash_bf16=None):
    """Last-position prefill logits of the flash and plain paths over
    ``batch`` (tokens, and the family's frames or image embeddings), in
    bf16 and with the weights widened exactly to fp32; returns their gaps.
    The fp32 plain logits stand for the exact ones."""
    from repro_torch.core.distributed import Server
    from repro_torch.utils.pytree import tree_map

    B, S = batch["tokens"].shape
    if "image_embeds" in batch:
        S += batch["image_embeds"].shape[1]
    got = {}
    for dtype in ("bfloat16", "float32"):
        p = params if dtype == "bfloat16" else tree_map(
            lambda t: t.to(torch.float32), params)
        for flash in (True, False):
            if dtype == "bfloat16" and flash and flash_bf16 is not None:
                got[dtype, flash] = flash_bf16
                continue
            srv = Server(cfg.with_(param_dtype=dtype, use_flash=flash),
                         device=dev)
            got[dtype, flash], _ = srv.prefill(
                p, batch, srv.model.init_cache(B, S + 8, dev))
        del p
    exact = got["float32", False]
    flash16, plain16 = got["bfloat16", True], got["bfloat16", False]
    gaps = {"bf16_flash_vs_plain": rel_l2(flash16, plain16),
            "bf16_flash_err": rel_l2(flash16, exact),
            "bf16_plain_err": rel_l2(plain16, exact),
            "fp32_flash_vs_plain": rel_l2(got["float32", True], exact),
            "bf16_max_abs_gap": float((flash16 - plain16).abs().max()),
            "max_abs_logit": float(plain16.abs().max()),
            "first_token_agreement": float(
                (flash16.argmax(-1) == plain16.argmax(-1)).float().mean())}
    gaps["bf16_err_ratio"] = gaps["bf16_flash_err"] / gaps["bf16_plain_err"]
    if not gaps["fp32_flash_vs_plain"] <= LOGIT_REL_TOL_FP32:
        raise AssertionError(f"fp32 flash prefill logits off the plain "
                             f"prefill's: {gaps}")
    if not gaps["bf16_err_ratio"] <= BF16_ERR_RATIO:
        raise AssertionError(f"bf16 flash prefill logits further from the "
                             f"fp32 ones than {BF16_ERR_RATIO}x the plain "
                             f"path's: {gaps}")
    return gaps


def serve_check(out, flash_ms):
    """After the counted run: the flash prefill's logits against the same
    prefill with ``use_flash=False`` for each of ``SERVE_SEEDS`` (the first
    is the counted run's), the plain path's prefill time, a profile of one
    flash prefill, and the kernel's share of prefill time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.distributed import Server

    cfg, params, toks, dev = (out["cfg"], out["params"], out["toks"],
                              out["server"].device)
    B, S = toks.shape
    plain = Server(cfg.with_(use_flash=False), device=dev)
    times = []
    for _ in range(2):                     # the second call is warm
        cache = plain.model.init_cache(B, S + 8, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    gaps = [dict(seed=SERVE_SEEDS[0], **logits_gaps(
        cfg, params, {"tokens": toks}, dev, flash_bf16=out["flash_logits"]))]
    for seed in SERVE_SEEDS[1:]:
        p = out["server"].model.init(
            torch.Generator(device=dev).manual_seed(seed), dev)
        t = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab, (B, S)), device=dev)
        gaps.append(dict(seed=seed, **logits_gaps(cfg, p, {"tokens": t},
                                                  dev)))
        del p
    torch.cuda.empty_cache()

    cache = out["server"].model.init_cache(B, S + 8, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out["server"].prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    kern.sort(key=lambda r: -r[1])
    device_s = sum(t for _, t, _ in kern) / 1e6
    flash_s = cfg.n_layers * flash_ms / 1e3
    line = out["line"]
    emit("serve", **line, flash_launches_per_prefill=cfg.n_layers,
         plain_prefill_seconds=times[-1],
         plain_prefill_seconds_cold=times[0],
         logits_gaps=gaps, fp32_logits_rel_l2_tol=LOGIT_REL_TOL_FP32,
         bf16_err_ratio_tol=BF16_ERR_RATIO,
         flash_share_of_prefill=flash_s / line["prefill_seconds"],
         profile={"wall_seconds_traced": wall,
                  "device_seconds": device_s if kern else None,
                  "device_busy_share": device_s / wall if kern else None,
                  "top_kernels": [{"name": k[:80], "device_ms": t / 1e3,
                                   "count": c} for k, t, c in kern[:8]]})


def trees_phase(dev):
    """The per-leaf wrappers on real model trees, counted (the caller sets
    the counts to 0 just before and reads them just after): aggregation of
    ten paper-CNN trees and four TinyLlama-1.1B trees, then a push and a
    pull of one tree against a second, on each model."""
    from repro_torch import configs
    from repro_torch.kernels.ops import (aggregate_pytree,
                                         quantized_delta_pull,
                                         quantized_delta_push)
    from repro_torch.models import build

    cnn = build(configs.get_config("paper-cnn"))
    cnn_trees = [cnn.init(torch.Generator().manual_seed(s), dev)
                 for s in range(10)]
    # an integer leaf: equal weights put the means of [p] and [100 + p]
    # over p = 0..9 on 4.5 and 104.5, which round half to even to 4, 104
    with_step = [dict(t, step=torch.tensor([p, 100 + p], dtype=torch.int32,
                                           device=dev))
                 for p, t in enumerate(cnn_trees)]
    tl_cfg = configs.get_config("tinyllama-1.1b")
    tl = build(tl_cfg)
    tl_trees = [tl.init(torch.Generator(device=dev).manual_seed(s), dev)
                for s in range(len(TREE_WEIGHTS))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cnn_mean = aggregate_pytree(with_step, [1.0] * len(with_step))
    tl_mean = aggregate_pytree(tl_trees, list(TREE_WEIGHTS))
    pushed = {}
    for name, (theta, ref_tree) in (("paper-cnn", cnn_trees[:2]),
                                    ("tinyllama-1.1b", tl_trees[:2])):
        codes, scales = quantized_delta_push(theta, ref_tree)
        pushed[name] = (theta, ref_tree, codes, scales,
                        quantized_delta_pull(codes, scales, ref_tree))
    torch.cuda.synchronize()
    return {"cnn_trees": with_step, "tl_trees": tl_trees,
            "cnn_mean": cnn_mean, "tl_mean": tl_mean, "pushed": pushed,
            "wall_seconds": time.perf_counter() - t0}


def trees_check(out, launches):
    """Launch counts exactly one a leaf, then every output against the
    plain versions (after the counted run: the dequantise launches made
    here are comparisons)."""
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels.ref import aggregate_ref
    from repro_torch.utils.pytree import tree_flatten, tree_leaves

    n_cnn = len(tree_leaves(out["cnn_trees"][0]))
    n_tl = len(tree_leaves(out["tl_trees"][0]))
    n_push = len(tree_leaves(out["pushed"]["paper-cnn"][0])) + n_tl
    want = {"aggregate.agg": n_cnn + n_tl, "quantize.quant": n_push,
            "quantize.dequant": n_push}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"trees launches {launches}, want {want} and "
                             "no other kernel")
    report = {}
    for name, trees, mean, weights in (
            ("paper-cnn", out["cnn_trees"], out["cnn_mean"],
             [1.0] * len(out["cnn_trees"])),
            ("tinyllama-1.1b", out["tl_trees"], out["tl_mean"],
             list(TREE_WEIGHTS))):
        leaves, treedef = tree_flatten(trees[0])
        rest = [treedef.flatten_up_to(t) for t in trees[1:]]
        got = treedef.flatten_up_to(mean)
        w = torch.tensor(weights, dtype=torch.float32, device=leaves[0].device)
        errs, shares, lanes = [], [], 0
        for g, xs in zip(got, zip(leaves, *rest)):
            stack = torch.stack([x.reshape(-1) for x in xs])
            if xs[0].dtype.is_floating_point:
                plain = aggregate_ref(stack, w)
            else:
                plain = torch.round(aggregate_ref(stack.float(), w)).to(
                    xs[0].dtype)
            err, share = check_mean(g.reshape(-1), plain, f"{name} mean")
            errs.append(err)
            shares.append(share * plain.numel())
            lanes += plain.numel()
            del stack, plain
        report[name] = {"leaves": len(leaves), "params": lanes,
                        "max_abs_err": max(errs),
                        "bf16_one_step_share": sum(shares) / lanes}
    step = out["cnn_mean"]["step"].tolist()
    if step != [4, 104]:
        raise AssertionError(f"integer leaf means {step}, want [4, 104]")
    for name, (theta, ref_tree, codes, scales, back) in out["pushed"].items():
        worst = 0.0
        for t, r, q, sc, b in zip(*(tree_leaves(x) for x in (
                theta, ref_tree, codes, scales, back))):
            d = (t.float() - r.float()).reshape(-1)
            pq, ps = qz._plain_quantize(d)
            if not (torch.equal(q, pq) and torch.equal(sc, ps)):
                raise AssertionError(f"{name}: pushed codes or scales differ "
                                     "from the plain quantiser's")
            plain_d = qz._plain_dequantize(q, sc, torch.float32)
            if not torch.equal(qz.dequantize_tiles(q, sc), plain_d):
                raise AssertionError(f"{name}: dequantised delta differs "
                                     "from the plain version's")
            plain_b = (r.float() + plain_d.reshape(r.shape)).to(r.dtype)
            if b.dtype != r.dtype or not torch.equal(b, plain_b):
                raise AssertionError(f"{name}: pulled tree differs from the "
                                     "plain pull")
            # half a step of the tile's scale (x 1.001 for the fp32
            # rounding of the delta), plus half a step of b's own type
            half = torch.repeat_interleave(sc * 0.5 * 1.001, 16384)[:d.numel()]
            ulp = b.float().abs().reshape(-1) * torch.finfo(b.dtype).eps * 0.5
            gap = (b.float() - t.float()).reshape(-1).abs()
            if not bool((gap <= half + ulp).all()):
                raise AssertionError(f"{name}: round trip beyond half a step")
            worst = max(worst, float((gap / (half + ulp)).max()))
        report[name].update(push_pull_worst_share_of_bound=worst,
                            code_bytes=sum(q.numel()
                                           for q in tree_leaves(codes)))
    emit("trees", launches=launches, wall_seconds=out["wall_seconds"],
         tinyllama_weights=TREE_WEIGHTS, trees=report,
         codes_and_scales="bit-identical", dequantised="bit-identical")


def mf_train_mse(task, data, params):
    """MSE of ``params`` on every client's own training ratings."""
    from repro_torch.data.loader import ClientDataset

    train = ClientDataset(np.concatenate([c.x for c in data.clients]),
                          np.concatenate([c.y for c in data.clients]))
    return task.evaluate(params, train)["mse"]


def mf_learning(session, gate: bool = True):
    """Round-0 and last-snapshot MSE, held out and on the training ratings;
    with ``gate``, the training MSE must fall."""
    task, data = session.task, session.data
    init = task.init_params(session.tcfg.seed)
    last = session._eval_models[max(session._eval_models)]
    out = {"heldout_mse_round0": task.evaluate(init, data.test)["mse"],
           "heldout_mse_end": task.evaluate(last, data.test)["mse"],
           "train_mse_round0": mf_train_mse(task, data, init),
           "train_mse_end": mf_train_mse(task, data, last)}
    if not gate:
        return out
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"non-finite MSE: {out}")
    if not out["train_mse_end"] < out["train_mse_round0"]:
        raise AssertionError(f"MF did not fit its training ratings: {out}")
    return out


def mf_args(sim_seconds: float):
    return ["--task", "mf", "--nodes", "32", "--sample-size", "10",
            "--duration", str(sim_seconds), "--eval-every", "5",
            "--seed", "0"]


def mf_direct_session(engine: str, seed: int = 0, device=None, **mcfg):
    """The session that ``launch.train.main(mf_args(...))`` builds, built
    directly, on ``engine``; ``mcfg`` adds to its ``ModestConfig``."""
    from repro_torch.config import ModestConfig, TrainConfig
    from repro_torch.data import make_mf_task
    from repro_torch.models.tasks import mf_task
    from repro_torch.sim.runner import ModestSession

    return ModestSession(
        n_nodes=32, mcfg=ModestConfig(n_nodes=32, sample_size=10,
                                      n_aggregators=2, success_fraction=1.0,
                                      ping_timeout=1.0, **mcfg),
        tcfg=TrainConfig(batch_size=20, seed=seed),
        task=mf_task(device=device, mf_users=32, mf_items=500),
        data=make_mf_task(32, n_items=500, seed=seed), seed=seed,
        eval_every_rounds=5, engine=engine, device=device)


def mf_session_phase(sim_seconds: float):
    """The MF session through the training launcher, as a user starts it,
    then a fused aggregate→quantize over its last cohort; counted (the
    caller sets the counts to 0 just before). The launcher's session is
    taken from its ``run`` to read its nodes and snapshots."""
    from repro_torch.kernels import fused
    from repro_torch.launch import train
    from repro_torch.sim import runner

    seen = {}
    run = runner.ModestSession.run

    def keep(self, duration):
        seen["session"] = self
        seen["calls"] = record_aggregations(self, masked=False)
        return run(self, duration)

    runner.ModestSession.run = keep
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "mf.csv")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = train.main(mf_args(sim_seconds) + ["--out", csv_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(csv_path) as fh:
            rows = list(csv.DictReader(fh))
    runner.ModestSession.run = run
    session = seen["session"]
    models = seen["calls"][-1][0]
    quantized = agg_quant_phase(session, models)
    launches = read_counts()

    n_agg = sum(len(node.agg_log) for node in session.nodes.values())
    if {k: v for k, v in launches.items() if v} != {
            "fused.agg": n_agg, "fused.agg_quant": 1} or n_agg == 0:
        raise AssertionError(f"MF launches {launches} for {n_agg} "
                             "aggregations")
    mse = check_session(session, result, metric="mse")
    if len(rows) != len(result.history) or [
            (int(r["round"]), float(r["mse"])) for r in rows] != mse:
        raise AssertionError("the launcher's CSV differs from its history")
    return session, result, (models, quantized), {
        "wall_seconds": wall, "launches": launches, "aggregations": n_agg,
        "mse": mse, "csv_rows": len(rows)}


def mf_check(session, result, last, line, sim_seconds: float):
    """After the counted run: the last cohort's fused aggregate→quantize
    against the plain version, the same session on the sequential engine
    (rounds and bytes equal, the gaps of ``mf_engine_gap`` below
    ``MF_GAP_TOL``), and learning."""
    models, (out, codes, scales) = last
    agg_quant_check(session, models, out, codes, scales, phase="mf_agg_quant")
    seq = mf_direct_session("sequential")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = seq.run(sim_seconds)
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    if rs.rounds_completed != result.rounds_completed:
        raise AssertionError("MF engines disagree on rounds completed")
    if rs.usage["total_bytes"] != result.usage["total_bytes"]:
        raise AssertionError("MF engines disagree on total bytes")
    gaps = mf_engine_gap(session, seq, result, rs)
    if not result.history or not gaps["same_trajectory"]:
        raise AssertionError(f"MF evaluated rounds differ: {result.history}"
                             f" {rs.history}")
    for key, tol in MF_GAP_TOL.items():
        if not gaps[key] < tol:
            raise AssertionError(f"MF engines' {key} {gaps[key]} is not "
                                 f"below {tol}")
    emit("mf_session", model="paper-mf", n_params=session.task.flat_spec.n,
         n_nodes=32, sample_size=10, sim_seconds=sim_seconds,
         rounds=result.rounds_completed, trainings=result.trainings_completed,
         total_bytes=result.usage["total_bytes"],
         flushes=session.engine.flushes, jobs=session.engine.jobs_run,
         sequential_wall_seconds=seq_wall, engine_gaps=gaps,
         **line, **mf_learning(session))


def mf_masked_session_phase(sim_seconds: float):
    """The MF session of the launcher with ``secure_agg="masked"``, built
    directly (the launcher has no such option), then a fused
    unmask→aggregate→quantize over its last sealed cohort; counted."""
    session = mf_direct_session("batched", secure_agg="masked")
    leaks = arm_sniffer(session)
    calls = record_aggregations(session, masked=True)
    result, wall = run_session(session, sim_seconds)
    mout = masked_agg_quant_phase(session, calls[-1])
    launches = read_counts()

    n_agg = sum(len(node.agg_log) for node in session.nodes.values())
    logs = [e for node in session.nodes.values() for e in node.secagg_log]
    want = {"fused.mask": result.trainings_completed,
            "fused.unmask_agg": n_agg, "fused.unmask_agg_quant": 1}
    if {k: v for k, v in launches.items() if v} != want or not (
            len(calls) == len(logs) == n_agg > 0):
        raise AssertionError(f"masked MF launches {launches}, want {want}; "
                             f"{len(calls)} masked aggregations, {len(logs)} "
                             "unmasks")
    if leaks:
        raise AssertionError(f"plaintext models on the wire: {leaks[:5]}")
    if any(margin < 0 for _, _, _, margin in logs):
        raise AssertionError(f"unmasked below threshold: {logs}")
    mse = check_session(session, result, metric="mse")
    means_check(session, calls, True, phase="mf_masked_means")
    masked_agg_quant_check(session, calls[-1], mout,
                           phase="mf_masked_agg_quant")
    emit("mf_masked_session", model="paper-mf",
         n_params=session.task.flat_spec.n, n_nodes=32, sample_size=10,
         sim_seconds=sim_seconds, rounds=result.rounds_completed,
         wall_seconds=wall, trainings=result.trainings_completed,
         aggregations=n_agg, unmasks=len(logs), launches=launches,
         flushes=session.engine.flushes, jobs=session.engine.jobs_run,
         min_share_margin=min(m for _, _, _, m in logs),
         secagg_aborts=sum(n.secagg_aborts for n in session.nodes.values()),
         total_bytes=result.usage["total_bytes"], mse=mse,
         **mf_learning(session))


MF_SOUND_SEEDS = (0, 1, 2, 3)
MF_FAULTS = ("bias_grads_dropped", "l2_dropped", "grads_of_another_model")


@contextlib.contextmanager
def planted_fault(name: str):
    """Within ``with``: the cohort engine's stacked MF gradients carry one
    deliberate fault (for :func:`mf_gap_readings` only). The package's code
    is not touched; the engine's reference to the lowering is swapped for
    the duration."""
    from repro_torch.engine import cohort
    from repro_torch.models import mf

    orig = cohort.stacked_grads_for

    def faulty(task):
        grads = orig(task)

        def g(ptree, xb, yb, mb):
            if name == "l2_dropped":
                l2, mf.L2 = mf.L2, 0.0
                try:
                    return grads(ptree, xb, yb, mb)
                finally:
                    mf.L2 = l2
            out = grads(ptree, xb, yb, mb)
            if name == "bias_grads_dropped":
                out["b_user"] = torch.zeros_like(out["b_user"])
                out["b_item"] = torch.zeros_like(out["b_item"])
            else:           # model s gets the gradient of model s - 1
                out = {k: torch.roll(v, 1, 0) for k, v in out.items()}
            return out
        return g

    cohort.stacked_grads_for = faulty
    try:
        yield
    finally:
        cohort.stacked_grads_for = orig


def mf_engine_gap(batched, sequential, rb, rs):
    """What ``mf_check`` compares between the two engines' runs of one MF
    session: trajectory equal, and the largest held-out MSE gap over the
    evaluated rounds; with the training-ratings MSE gap at the end."""
    mb = {h["round"]: h["mse"] for h in rb.history}
    ms = {h["round"]: h["mse"] for h in rs.history}
    lb = mf_learning(batched, gate=False)
    ls = mf_learning(sequential, gate=False)
    return {"same_trajectory": (rb.rounds_completed == rs.rounds_completed
                                and rb.usage["total_bytes"]
                                == rs.usage["total_bytes"]
                                and mb.keys() == ms.keys()),
            "heldout_gap": max((abs(mb[k] - ms[k]) for k in mb.keys() & ms),
                               default=float("inf")),
            "train_end_gap": abs(lb["train_mse_end"] - ls["train_mse_end"]),
            "train_mse_moved": lb["train_mse_round0"] - lb["train_mse_end"]}


def mf_gap_readings(device=None, sim_seconds: float = 40.0) -> int:
    """``python3 chip_smoke.py --mf-gap-readings``: the readings that
    ``MF_GAP_TOL`` is set from. The MF session of ``mf_check``, batched
    against sequential: sound over ``MF_SOUND_SEEDS``, then at seed 0 with
    each of ``MF_FAULTS`` planted in the batched engine's stacked
    gradients. Prints one JSON line."""
    sound, faults = [], []
    for seed in MF_SOUND_SEEDS:
        seq = mf_direct_session("sequential", seed=seed, device=device)
        rs = seq.run(sim_seconds)
        bat = mf_direct_session("batched", seed=seed, device=device)
        rb = bat.run(sim_seconds)
        sound.append({"seed": seed, **mf_engine_gap(bat, seq, rb, rs)})
        if seed == 0:
            seq0, rs0 = seq, rs
    for name in MF_FAULTS:
        with planted_fault(name):
            bat = mf_direct_session("batched", seed=0, device=device)
            rb = bat.run(sim_seconds)
        faults.append({"fault": name, **mf_engine_gap(bat, seq0, rb, rs0)})
    emit("mf_gap_readings", sim_seconds=sim_seconds, sound=sound,
         faults=faults, tol=MF_GAP_TOL)
    return 0


def dump_sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library, kept beside it (``.sass``)."""
    from repro_torch.kernels import build
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    text = run_cmd([str(tool), "-sass", str(lib)])
    lib.with_suffix(".sass").write_text(text)
    return text


# SASS opcodes by the Hopper pipe that issues them: the integer ALU pipe and
# the FMA pipe (IMAD, the integer multiply-add, runs there)
ALU_OPS = ("LOP3", "SHF", "ISETP", "IADD3", "LEA", "SEL", "PRMT", "MOV",
           "IMNMX", "VIADD", "IABS", "PLOP3", "BMSK", "SGXT")
FMA_OPS = ("IMAD", "FFMA", "FMUL", "FADD")
PRG_MIX = ("0x7feb352d", "0x846ca68b", "-0x7b935975")   # kPrgMix1, kPrgMix2
# the SASS functions of each masked kernel (labels from ``fused_label``),
# in the forms over whole rows (no lane of padding: ``SealedRows<0>``, the
# rows kernel's second argument 0) that the main path launches
PRG_KERNELS = {"fused.mask": ("fused_mask_kernel",),
               "fused.unmask_agg": ("fused_agg_kernel<SealedRows<0>,0,0>",
                                    "fused_unmask_rows_kernel<0,0>"),
               "fused.unmask_agg_quant": (
                   "fused_agg_kernel<SealedRows<0>,0,1>",
                   "fused_agg_kernel<SealedRows<0>,0,2>",
                   "fused_unmask_rows_kernel<1,0>",
                   "fused_unmask_rows_kernel<2,0>")}


def sass_functions(sass: str):
    """{kernel label: [(address, opcode, operands)]} of a ``cuobjdump
    -sass`` listing."""
    funcs, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(fused_label(m.group(1)), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def sass_registers(op: str, args: str):
    """(written, read) registers of one SASS instruction: the first operand
    is written, as wide as the instruction (.64 and .WIDE two, .128 four),
    unless it is an address or the instruction a store or a branch."""
    ops = [a.strip() for a in args.split(",")]
    regs = [re.findall(r"\b(U?R\d+|U?P\d)\b", a) for a in ops]
    if not ops or ops[0].startswith("[") or op.startswith(("ST", "BRA")):
        return [], [r for rs in regs for r in rs]
    width = 4 if ".128" in op else 2 if (".64" in op or "WIDE" in op) else 1
    out = []
    for r in regs[0][:1]:
        kind, n = re.match(r"(\D+)(\d+)", r).groups()
        out = [f"{kind}{int(n) + k}" for k in range(width)]
    return out, [r for rs in regs[1:] for r in rs]


def prg_chain(body):
    """Indices of the instructions of ``body`` (a loop, in order) that
    compute mask words: the products by the PRG's constants and every
    ALU- or FMA-pipe instruction on a path of values into or out of them
    (a load, or a value made before the loop, ends a path)."""
    regs = [sass_registers(op, args) for _, op, args in body]
    n = len(body)

    def writer(i, r):          # this iteration's, else the last one's
        for j in list(range(i - 1, -1, -1)) + list(range(n - 1, i - 1, -1)):
            if r in regs[j][0]:
                return j
        return None

    def computes(i):
        return body[i][1].split(".")[0] in ALU_OPS + FMA_OPS

    chain = {i for i, (_, op, args) in enumerate(body)
             if op.startswith("IMAD") and any(c in args.lower()
                                              for c in PRG_MIX)}
    todo = list(chain)
    while todo:                                      # into the products
        i = todo.pop()
        for r in regs[i][1]:
            j = writer(i, r)
            if j is not None and j not in chain and computes(j):
                chain.add(j)
                todo.append(j)
    grew = True
    while grew:                                      # out of them
        grew = False
        for i in range(n):
            if i not in chain and computes(i) and any(
                    writer(i, r) in chain for r in regs[i][1]):
                chain.add(i)
                grew = True
    return chain


def mask_word_loop(ins):
    """The innermost loop of a kernel that makes the most mask words (a
    backward branch with no other inside): (its instructions, words), a
    word found by its two products by kPrgMix2; None where none does."""
    branches = [(a, int(m.group(1), 16)) for a, op, args in ins
                if op.startswith("BRA")
                and (m := re.search(r"0x([0-9a-f]+)", args))
                and int(m.group(1), 16) < a]
    best = None
    for end, start in branches:
        if any(start <= t < a <= end and (a, t) != (end, start)
               for a, t in branches):
            continue                               # not innermost
        body = [i for i in ins if start <= i[0] <= end]
        words = sum(op.startswith("IMAD") and any(
            c in args.lower() for c in PRG_MIX[1:]) for _, op, args in body) / 2
        if words and (best is None or words > best[1]):
            best = (body, words)
    return best


def prg_word_pipes(sass: str):
    """Instructions a mask word on the integer ALU and FMA pipes in each
    masked kernel's mask-word loop: those of the PRG's own chain (``prg``:
    the products, shifts, xors, the seed's add, the sign's product and the
    sum) and all of the loop's (``loop``: its counter and addresses too).
    Returns ({kind: the fewest ``prg`` counts over its kernels}, the counts
    of every kernel)."""
    per_kernel = {}
    for label, ins in sass_functions(sass).items():
        found = mask_word_loop(ins)
        if found is None:
            continue
        body, words = found
        chain = prg_chain(body)
        counts = {"words": words}
        for what, idx in (("prg", chain), ("loop", range(len(body)))):
            pipes = [body[i][1].split(".")[0] for i in idx]
            counts[what] = {"alu": sum(op in ALU_OPS for op in pipes) / words,
                            "fma": sum(op in FMA_OPS for op in pipes) / words}
        per_kernel[label] = counts
    by_kind = {}
    for kind, prefixes in PRG_KERNELS.items():
        forms = [c["prg"] for k, c in per_kernel.items()
                 if k.startswith(prefixes)]
        if not forms:
            raise AssertionError(f"no mask-word loop of {kind} in the SASS: "
                                 f"{sorted(per_kernel)}")
        by_kind[kind] = min(forms, key=lambda c: max(c.values()))
    return by_kind, per_kernel


# ---------------------------------------------------------------------------
# the checkpoint and serving paths
# ---------------------------------------------------------------------------


def served_session(sim_seconds: float, spool_dir):
    """The session of ``session_phase`` with ``ServeConfig(n_replicas=2,
    publish_every=1, spool_dir=spool_dir)``, run once. Records, in both
    forms alike, the training-side params the fabric is handed at each
    round (a copy on the card), every install's params and the seconds of
    each spool save and install (synchronised)."""
    from repro_torch.engine.flat import as_tree
    from repro_torch.serve import ServeConfig
    from repro_torch.utils.pytree import tree_map

    session = cnn_session(32, 10, "batched", serve=ServeConfig(
        n_replicas=2, publish_every=1, spool_dir=spool_dir))
    fabric = session.serving
    rec = {"handed": {}, "installed": [], "save": [], "restore": []}
    on_round, save, load = (fabric.on_round, fabric._spool_save,
                            fabric.load_snapshot)

    def record(k, params, src):
        if params is not None and k not in rec["handed"]:
            rec["handed"][k] = tree_map(torch.clone, as_tree(params))
        on_round(k, params, src)

    def timed_save(k, params):
        rec["save"].append(synced_seconds(save, k, params)[1])

    def timed_load(msg):
        payload, seconds = synced_seconds(load, msg)
        rec["restore"].append(seconds)
        rec["installed"].append((msg.round_k, payload.params))
        return payload

    fabric.on_round = record
    fabric._spool_save = timed_save
    fabric.load_snapshot = timed_load
    reset_counts()                         # counts of this path only
    result, wall = run_session(session, sim_seconds)
    return session, result, wall, rec, read_counts()


def same_tree(got, want, what: str) -> None:
    """Every leaf of ``got`` on the card and ``torch.equal`` to ``want``'s,
    dtype and shape included."""
    from repro_torch.engine.flat import as_tree
    from repro_torch.utils.pytree import tree_leaves

    a, b = tree_leaves(as_tree(got)), tree_leaves(want)
    if len(a) != len(b) or not a:
        raise AssertionError(f"{what}: {len(a)} leaves against {len(b)}")
    for x, y in zip(a, b):
        if x.device.type != "cuda" or x.dtype != y.dtype or \
                not torch.equal(x, y):
            raise AssertionError(f"{what}: a leaf {tuple(x.shape)} "
                                 f"{x.dtype} on {x.device} differs")


def check_served(session, result, rec, launches, spooled):
    """What every run of the served session must show: ``fused.agg`` at
    each aggregation, something installed and served, one file a
    publication where there is a spool, and every install (and each
    replica's last) equal on the card to what the fabric was handed."""
    n_agg = sum(len(node.agg_log) for node in session.nodes.values())
    if launches["fused.agg"] != n_agg or n_agg == 0:
        raise AssertionError(f"{launches['fused.agg']} fused.agg launches "
                             f"for {n_agg} aggregations")
    check_session(session, result)
    serving = result.serving
    if not serving["snapshots_installed"] > 0 or not serving["served"] > 0:
        raise AssertionError(f"nothing installed or served: {serving}")
    if spooled is not None and spooled != serving["snapshots_published"]:
        raise AssertionError(f"{spooled} files for {serving}")
    if len(rec["installed"]) != serving["snapshots_installed"] or \
            bool(rec["save"]) != (spooled is not None):
        raise AssertionError(f"{len(rec['installed'])} installs, "
                             f"{len(rec['save'])} saves for {serving}")
    for k, params in rec["installed"]:
        same_tree(params, rec["handed"][k], f"install of round {k}")
    for replica in session.serving.replicas:
        same_tree(replica.params.params, rec["handed"][replica.round],
                  f"replica {replica.node_id}")
    return n_agg


def served_phase(sim_seconds: float):
    """The paper-CNN session with a serving deployment whose snapshots
    spool through ``checkpoint.save`` / ``checkpoint.restore``, and the
    same session without the spool, in turns (spool, none, none, spool),
    each counted and checked by ``check_served``; every run must give the
    first one's ``serving`` dict and round times."""
    walls = {"spool": [], "no_spool": []}
    timers = {"save": [], "restore": []}
    first = None
    for turn in ("spool", "no_spool", "no_spool", "spool"):
        with tempfile.TemporaryDirectory() as tmp:
            session, result, wall, rec, launches = served_session(
                sim_seconds, tmp if turn == "spool" else None)
            files = sorted(Path(tmp).glob("round_*.npz"))
            snapshot_bytes = files[0].stat().st_size if files else None
        n_agg = check_served(session, result, rec, launches,
                             len(files) if turn == "spool" else None)
        walls[turn].append(wall)
        if turn == "spool":
            timers["save"] += rec["save"]
            timers["restore"] += rec["restore"]
            file_bytes = snapshot_bytes
        if first is None:
            first = (result.serving, result.round_times, launches, n_agg,
                     result.rounds_completed, session.task.flat_spec.n)
        elif (result.serving, result.round_times) != first[:2]:
            raise AssertionError(f"the {turn} run differs: "
                                 f"{result.serving} against {first[0]}")
        del session, rec
    serving, _, launches, n_agg, rounds, n_params = first
    spool_mean = float(np.mean(walls["spool"]))
    gap = spool_mean - float(np.mean(walls["no_spool"]))
    timed = (sum(timers["save"]) + sum(timers["restore"])) / 2
    emit("served", model="paper-cnn", n_params=n_params, n_nodes=32,
         sample_size=10, sim_seconds=sim_seconds, n_replicas=2,
         publish_every=1, rounds=rounds, aggregations=n_agg,
         launches=launches, wall_seconds=walls["spool"],
         wall_seconds_no_spool=walls["no_spool"],
         spool_wall_gap_seconds=gap, spool_wall_gap_share=gap / spool_mean,
         publications=serving["snapshots_published"],
         installs=serving["snapshots_installed"],
         spool_save_seconds_per_publication=float(np.mean(timers["save"])),
         spool_restore_seconds_per_install=float(
             np.mean(timers["restore"])),
         spool_timed_seconds_per_run=timed,
         spool_timed_share=timed / spool_mean,
         snapshot_file_bytes=file_bytes,
         serving={k: serving[k] for k in (
             "requests", "served", "lost", "p50_latency_s", "p99_latency_s",
             "staleness_mean_rounds", "snapshots_published",
             "snapshots_installed", "snapshot_bytes", "frontier_round")})


def ckpt_lm_phase(dev):
    """One TinyLlama-1.1B tree at full width and depth (bf16, 12 leaves)
    saved to a temporary directory and restored onto the card: every leaf
    ``torch.equal`` to the saved one, in bf16; seconds and GB/s of each."""
    from repro_torch import checkpoint, configs
    from repro_torch.models import build
    from repro_torch.utils.pytree import tree_leaves

    cfg = configs.get_config("tinyllama-1.1b")
    tree = build(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    leaves = tree_leaves(tree)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    if len(leaves) != 12 or {x.dtype for x in leaves} != {torch.bfloat16}:
        raise AssertionError(f"tinyllama tree changed: {len(leaves)} leaves")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tinyllama-1.1b")
        _, save_s = synced_seconds(checkpoint.save, path, tree,
                                   {"arch": cfg.name})
        file_bytes = os.path.getsize(path + ".npz")
        (back, meta), restore_s = synced_seconds(checkpoint.restore, path,
                                                 tree)
    if meta != {"arch": cfg.name}:
        raise AssertionError(f"meta {meta}")
    same_tree(back, tree, "tinyllama-1.1b checkpoint")
    del back
    # the copies alone, for the files' share of the times above
    host, d2h_s = synced_seconds(lambda: [x.cpu() for x in leaves])
    _, h2d_s = synced_seconds(lambda: [x.to(dev) for x in host])
    emit("ckpt_lm", model=cfg.name, leaves=len(leaves), bytes=nbytes,
         file_bytes=file_bytes, save_seconds=save_s,
         restore_seconds=restore_s, save_gb_per_s=nbytes / save_s / 1e9,
         restore_gb_per_s=nbytes / restore_s / 1e9,
         device_to_host_seconds=d2h_s, host_to_device_seconds=h2d_s)


def mf_ckpt_phase(sim_seconds: float):
    """The MF session through ``launch.train.main`` with ``--ckpt PATH
    --ckpt-every 1``, counted, apart from ``mf_session``'s timed call: the
    last save, restored into the MF template on the card, equals the last
    params the launcher's hook saved, bit for bit, with its meta."""
    from repro_torch import checkpoint
    from repro_torch.engine.flat import as_tree
    from repro_torch.launch import train
    from repro_torch.models.tasks import mf_task
    from repro_torch.utils.pytree import tree_map

    saves = []
    save = checkpoint.save

    def keep(path, tree, meta=None):
        saves.append((tree_map(torch.clone, as_tree(tree)), dict(meta)))
        save(path, tree, meta)

    checkpoint.save = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "mf.npz")
            reset_counts()                 # counts of this path only
            result, wall = synced_seconds(train.main, mf_args(sim_seconds) + [
                "--ckpt", path, "--ckpt-every", "1",
                "--out", os.path.join(tmp, "mf.csv")])
            launches = read_counts()
            template = mf_task(mf_users=32, mf_items=500).init_params(0)
            (back, meta), restore_s = synced_seconds(checkpoint.restore,
                                                     path, template)
    finally:
        checkpoint.save = save
    if not saves or launches["fused.agg"] <= 0:
        raise AssertionError(f"{len(saves)} saves, launches {launches}")
    rounds = [m["round"] for _, m in saves]
    if rounds != sorted(set(rounds)) or meta != saves[-1][1] or \
            meta != {"round": rounds[-1], "algo": "modest", "task": "mf"}:
        raise AssertionError(f"meta {meta} after saves of rounds {rounds}")
    same_tree(back, saves[-1][0], "the MF launcher's last checkpoint")
    emit("mf_ckpt", model="paper-mf", sim_seconds=sim_seconds,
         rounds=result.rounds_completed, saves=len(saves),
         last_round=rounds[-1], launches=launches, wall_seconds=wall,
         restore_seconds=restore_s)


def engines_phase():
    from repro_torch.models.tasks import cnn_task

    task = cnn_task()
    res = {}
    for engine in ("batched", "sequential"):
        t0 = time.perf_counter()
        res[engine] = cnn_session(6, 3, engine, task=task).run(25.0)
        torch.cuda.synchronize()
        res[engine + "_wall"] = time.perf_counter() - t0
    rb, rs = res["batched"], res["sequential"]
    if rb.rounds_completed != rs.rounds_completed:
        raise AssertionError("engines disagree on rounds completed")
    if rb.usage["total_bytes"] != rs.usage["total_bytes"]:
        raise AssertionError("engines disagree on total bytes")
    ab = {h["round"]: h["accuracy"] for h in rb.history if "accuracy" in h}
    as_ = {h["round"]: h["accuracy"] for h in rs.history if "accuracy" in h}
    if not ab or ab.keys() != as_.keys():
        raise AssertionError(f"accuracy rounds differ: {ab} {as_}")
    worst = max(abs(ab[k] - as_[k]) for k in ab)
    if worst >= 0.02:
        raise AssertionError(f"engine accuracies differ by {worst}")
    emit("engines", rounds=rb.rounds_completed,
         total_bytes=rb.usage["total_bytes"], max_accuracy_gap=worst,
         batched_wall_seconds=res["batched_wall"],
         sequential_wall_seconds=res["sequential_wall"])


# ---------------------------------------------------------------------------
# the sharded path: the flat axis split into chunks of the one card
# ---------------------------------------------------------------------------

SHARD_CHUNKS = (1, 2, 4, 8)
SHARD_SHAPES = [
    # name, P (= R), N, integer lanes, timing iterations
    ("session_int_leaf", 10, 136672, 4, 200),   # the CNN session's stack
    ("mf_session", 10, 11173, 0, 200),          # the MF session's
    ("stream_ragged", 16, (1 << 24) - 1003, 1000, 10),
]
SHARD_TIMED = (1, 4)            # chunk counts timed beside one launch
SHARD_BASE = 1 << 20            # a lane base (64 subtiles) for B4/B5's time


@contextlib.contextmanager
def chunk_mesh(dev, k: int):
    """``make_engine_mesh`` giving k chunks of ``dev``: the mesh that
    ``engine="sharded"`` builds where there are k cards."""
    import repro_torch.launch.mesh as lm

    inner = lm.make_engine_mesh
    lm.make_engine_mesh = lambda device=None: (dev,) * k
    try:
        yield
    finally:
        lm.make_engine_mesh = inner


def shard_slices_check(fused, name, y, w, mask, kw, whole, k, dev):
    """Each chunk's B4 and B5 output, launched alone at its ``base`` with
    the global ``n_valid``, equals the matching slice of one launch over
    the whole rows; its pad lanes are zeros and its pad subtiles have the
    scale of zeros."""
    N = y.shape[1]
    zero_scale = fused._plain_quantize(torch.zeros((1,), device=dev))[1]
    mean1, (qmean1, codes1, scales1) = whole
    for base, yr, mr in fused._pad_sharded(y.view(torch.int32), mask,
                                           (dev,) * k):
        yr = yr.view(torch.float32)
        live = max(0, min(yr.shape[1], N - base))
        mean = fused.unmask_aggregate_flat(yr, w, mr, base=base, n_valid=N,
                                           **kw)
        qmean, codes, scales = fused.unmask_aggregate_quantize_flat(
            yr, w, mr, base=base, n_valid=N, **kw)
        torch.cuda.synchronize()
        s0, s_live = base // fused.SUBTILE, -(-live // fused.SUBTILE)
        if not (torch.equal(mean[:live], mean1[base:base + live])
                and torch.equal(qmean, mean)
                and torch.equal(codes[:live], codes1[base:base + live])
                and torch.equal(scales[:s_live],
                                scales1[s0:s0 + s_live])):
            raise AssertionError(f"{name}: chunk at lane {base} of {k} "
                                 "differs from the whole launch's slice")
        if (mean[live:].any() or codes[live:].any()
                or not torch.equal(scales[s_live:],
                                   zero_scale.expand(len(scales) - s_live))):
            raise AssertionError(f"{name}: chunk at lane {base} of {k}: "
                                 "pad lanes not zeros")


def sealed_at(fused, x, seeds, signs, base: int):
    """The rows of ``x`` sealed as lanes ``base + l`` of longer rows (the
    plain PRG, row by row: the seal kernel starts at lane 0)."""
    N = x.shape[1]
    lanes = torch.arange(base, base + N, dtype=torch.int64, device=x.device)
    return torch.stack([fused._from_bits(
        (fused._bits(x[p]) + fused._plain_mask_words(seeds[p], signs[p],
                                                     lanes)) & fused.MASK32)
        for p in range(x.shape[0])])


def shard_rows(dev, fused):
    """B1, B2, B4 and B5 at 1, 2, 4 and 8 chunks of the card (``dev``
    named k times as the mesh) against one launch over the whole stack,
    bit for bit, at ``SHARD_SHAPES``; the form each chunk's launcher
    picks; the sharded entry points (pad, split, k launches, gather)
    timed at ``SHARD_TIMED`` beside one launch; B4 and B5 at a lane base
    against base 0 over the same rows."""
    out = []
    for i, (name, P, N, n_int, iters) in enumerate(SHARD_SHAPES):
        x, w, mask = make_inputs(P, N, n_int, seed=300 + i, dev=dev)
        seeds, signs = mask_terms(P, seed=400 + i, dev=dev)
        y = torch.stack([fused.apply_mask_flat(x[p], seeds[p], signs[p])
                         for p in range(P)])
        kw = dict(seeds=seeds, signs=signs)
        one = {"fused.agg": lambda: fused.aggregate_flat_onepass(x, w, mask),
               "fused.agg_quant":
                   lambda: fused.aggregate_quantize_flat(x, w, mask),
               "fused.unmask_agg":
                   lambda: fused.unmask_aggregate_flat(y, w, mask, **kw),
               "fused.unmask_agg_quant":
                   lambda: fused.unmask_aggregate_quantize_flat(y, w, mask,
                                                                **kw)}
        want = {kname: call() for kname, call in one.items()}
        torch.cuda.synchronize()
        plain = (want["fused.agg"],) + tuple(want["fused.agg_quant"])
        if not (torch.equal(want["fused.unmask_agg"], plain[0])
                and all(torch.equal(a, b) for a, b in
                        zip(want["fused.unmask_agg_quant"], plain[1:]))
                and torch.equal(plain[0], plain[1])):
            raise AssertionError(f"{name}: one launch: masked != plain")
        row = {"shape": name, "P": P, "R": P, "N": N, "int_lanes": n_int,
               "form": {}, "ms": {}}
        for k in SHARD_CHUNKS:
            mesh = (dev,) * k
            sharded = {
                "fused.agg": lambda: fused.aggregate_flat_onepass_sharded(
                    x, w, mask, mesh=mesh),
                "fused.agg_quant":
                    lambda: fused.aggregate_quantize_flat_sharded(
                        x, w, mask, mesh=mesh),
                "fused.unmask_agg":
                    lambda: fused.unmask_aggregate_flat_sharded(
                        y, w, mask, mesh=mesh, **kw),
                "fused.unmask_agg_quant":
                    lambda: fused.unmask_aggregate_quantize_flat_sharded(
                        y, w, mask, mesh=mesh, **kw)}
            local_n = fused.shard_align(N, k) // k
            for kname, call in sharded.items():
                got = call()
                torch.cuda.synchronize()
                same_out = (torch.equal(got, want[kname])
                            if isinstance(got, torch.Tensor) else
                            all(torch.equal(a, b)
                                for a, b in zip(got, want[kname])))
                if not same_out:
                    raise AssertionError(f"{name}: {kname} at {k} chunks "
                                         "differs from one launch")
                terms = P * P if "unmask" in kname else 0
                row["form"].setdefault(kname, {})[k] = plan_label(
                    fused, kname, local_n, terms)
                if k in SHARD_TIMED:
                    row["ms"].setdefault(kname, {})[k] = time_ms(call, iters)
            shard_slices_check(fused, name, y, w, mask, kw,
                               (want["fused.unmask_agg"],
                                want["fused.unmask_agg_quant"]), k, dev)
            check_again(fused, f"{name}: {k} chunks",
                        sharded["fused.unmask_agg_quant"],
                        want["fused.unmask_agg_quant"])
        row["one_launch_ms"] = {kname: time_ms(call, iters)
                                for kname, call in one.items()}
        row["one_launch_form"] = {kname: plan_label(
            fused, kname, N, P * P if "unmask" in kname else 0)
            for kname in one}
        # B4 and B5 at a lane base: the rows sealed at counters base + l
        # (by the plain PRG) unmask to the plain results bit for bit, and
        # are timed against base 0 over the rows sealed at 0, in turns
        yb = sealed_at(fused, x, seeds, signs, SHARD_BASE)
        based = dict(kw, base=SHARD_BASE, n_valid=SHARD_BASE + N)
        at_base = (fused.unmask_aggregate_flat(yb, w, mask, **based),
                   fused.unmask_aggregate_quantize_flat(yb, w, mask,
                                                        **based))
        torch.cuda.synchronize()
        if not (torch.equal(at_base[0], plain[0]) and all(
                torch.equal(a, b) for a, b in zip(at_base[1], plain[1:]))):
            raise AssertionError(f"{name}: B4/B5 at lane base {SHARD_BASE}"
                                 " differ from the plain kernels")
        del at_base
        turns = {"fused.unmask_agg": (
                     one["fused.unmask_agg"],
                     lambda: fused.unmask_aggregate_flat(yb, w, mask,
                                                         **based)),
                 "fused.unmask_agg_quant": (
                     one["fused.unmask_agg_quant"],
                     lambda: fused.unmask_aggregate_quantize_flat(
                         yb, w, mask, **based))}
        row["base_turns_ms"] = {
            kname: [time_ms(f, iters) for f in (at0, at_base, at_base, at0)]
            for kname, (at0, at_base) in turns.items()}
        bound = {kname: bound_ms(kname, P, N, P if "unmask" in kname else 0,
                                 mask is not None)[0] for kname in one}
        row["bound_ms"] = bound
        out.append(row)
        del x, w, mask, y, yb, seeds, signs, want, plain, one, turns
        torch.cuda.empty_cache()
    return out


def batched_reference(sim_seconds: float, secure_agg=None):
    """What a MeshEngine session is held to: the rounds, bytes, accuracy
    history and wall seconds of the same session on the batched engine."""
    session = cnn_session(32, 10, "batched", secure_agg=secure_agg)
    result, wall = run_session(session, sim_seconds)
    return {"rounds": result.rounds_completed,
            "total_bytes": result.usage["total_bytes"], "wall": wall,
            "accuracy": check_session(session, result),
            "history": result.history}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: two runs of one session then
    train alike, so a difference between engines is the engines'."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def mesh_session_check(session, result, calls, ref, masked: bool):
    """A MeshEngine session against the batched session ``ref`` (its
    rounds, bytes and accuracy history): rounds and bytes equal, accuracy
    within 0.02 at every evaluated round, and every aggregation of the
    session re-aggregated in one launch over the same inputs, bit for
    bit."""
    task = session.task
    if result.rounds_completed != ref["rounds"]:
        raise AssertionError(f"{result.rounds_completed} rounds, batched "
                             f"{ref['rounds']}")
    if result.usage["total_bytes"] != ref["total_bytes"]:
        raise AssertionError("sharded and batched sessions disagree on "
                             "total bytes")
    acc = check_session(session, result)
    got, want = dict(acc), dict(ref["accuracy"])
    if got.keys() != want.keys():
        raise AssertionError(f"accuracy rounds differ: {got} {want}")
    gap = max(abs(got[r] - want[r]) for r in got)
    if gap >= 0.02:
        raise AssertionError(f"sharded accuracy off the batched by {gap}")
    for args, out in calls:
        again = (task.aggregate_masked(*args) if masked
                 else task.aggregate(*args))
        if not torch.equal(again.buffer, out.buffer):
            raise AssertionError("a sharded aggregation differs from one "
                                 "launch over its inputs")
    return gap


def mesh_session(dev, sim_seconds: float, ref, k: int, secure_agg=None):
    """The CNN session of ``session_phase`` (or the masked one) through
    ``engine="sharded"`` on a mesh of k chunks of the card, counted."""
    from repro_torch.engine import MeshEngine

    with chunk_mesh(dev, k):
        session = cnn_session(32, 10, "sharded", secure_agg=secure_agg)
    eng = session.engine
    if not isinstance(eng, MeshEngine) or eng.shardings.n_shards != k:
        raise AssertionError(f"engine {type(eng).__name__}, not a "
                             f"{k}-chunk MeshEngine")
    calls = []
    name = "aggregate_masked" if secure_agg else "aggregate"
    inner = getattr(eng, name)

    def record(*args):
        out = inner(*args)
        calls.append((args, out))
        return out

    setattr(eng, name, record)
    reset_counts()                         # counts of this path only
    result, wall = run_session(session, sim_seconds)
    launches = read_counts()
    n_agg = sum(len(node.agg_log) for node in session.nodes.values())
    kname = "fused.unmask_agg" if secure_agg else "fused.agg"
    if not (launches[kname] == k * len(calls) == k * n_agg > 0):
        raise AssertionError(f"{launches[kname]} {kname} launches for "
                             f"{len(calls)} aggregations in {k} chunks")
    if secure_agg and launches["fused.mask"] != result.trainings_completed:
        raise AssertionError(f"{launches['fused.mask']} fused.mask launches "
                             f"for {result.trainings_completed} trainings")
    gap = mesh_session_check(session, result, calls, ref,
                             masked=secure_agg is not None)
    return {"secure_agg": secure_agg, "chunks": k,
            "history_equal": result.history == ref["history"],
            "rounds": result.rounds_completed,
            "total_bytes": result.usage["total_bytes"],
            "wall_seconds": wall, "batched_wall_seconds": ref["wall"],
            "aggregations": n_agg, "max_accuracy_gap": gap,
            "launches": launches,
            "reaggregated_in_one_launch": "bit-identical"}


def sharded_phase(dev, sim_seconds: float):
    """The sharded path on the one card: (a) ``make_engine("sharded")``
    falls back to the batched engine and its session is the batched one;
    (b) B1, B2, B4 and B5 in 1-8 chunks against one launch
    (``shard_rows``); (c) MeshEngine CNN sessions, plain and masked, on
    4 chunks of the card against the same sessions on the batched engine,
    both with cuDNN's deterministic algorithms."""
    from repro_torch.engine import BatchedEngine, make_engine
    from repro_torch.kernels import fused
    from repro_torch.models.tasks import cnn_task

    t0 = time.perf_counter()
    task = cnn_task()
    eng = make_engine("sharded", task)
    if type(eng) is not BatchedEngine:
        raise AssertionError(f"make_engine('sharded') on one card gave "
                             f"{type(eng).__name__}")
    fallback = {e: cnn_session(6, 3, e, task=task).run(25.0)
                for e in ("sharded", "batched")}
    if (fallback["sharded"].rounds_completed
            != fallback["batched"].rounds_completed
            or fallback["sharded"].usage["total_bytes"]
            != fallback["batched"].usage["total_bytes"]):
        raise AssertionError("engine='sharded' on one card is not the "
                             "batched session")
    rows = shard_rows(dev, fused)
    sessions = []
    with deterministic_cudnn():
        for secure_agg in (None, "masked"):
            ref = batched_reference(sim_seconds, secure_agg)
            sessions.append(mesh_session(dev, sim_seconds, ref, 4,
                                         secure_agg=secure_agg))
    emit("sharded", fallback={"engine": type(eng).__name__,
                              "rounds": fallback["sharded"].rounds_completed,
                              "total_bytes":
                                  fallback["sharded"].usage["total_bytes"]},
         chunks=SHARD_CHUNKS, vs_one_launch="bit-identical", shapes=rows,
         sessions=sessions, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# lm_train: MoDeST sessions that train a TinyLlama-width dense LM
# ---------------------------------------------------------------------------

LM_LAYERS = 2                   # TinyLlama's 22 cut to 2 (PERF.md section 4)
LM_N = 219_162_624              # its flat lanes at 2 layers, 12 leaves
LM_NODES, LM_COHORT, LM_BATCH = 16, 4, 8
LM_SIM_SECONDS = 750.0          # about 140 simulated s a round on the WAN
LM_MIN_ROUNDS = 4
LM_WIDE_P = 10                  # P * N past 2^31: the wide-stack check
LM_SHAPE = ("lm_session", LM_COHORT, LM_N, 0, 10)   # B1-B5's timed shape
# One cohort step of the stacked lowering against ``task._step`` for one
# member. The two sum their bf16 products in different orders, so their
# gradients differ: per leaf, the relative L2 distance of the stacked
# step's update from ``_step``'s at most LM_GRAD_REL_L2 (the CPU tests
# hold the package's bf16 gradients to the reference's at the same
# bound). The engine updates in fp32 and rounds once where ``_step``
# rounds the update to bf16 and then the sum, so each parameter may differ
# by the two updates' difference plus LM_STEP_BF16_SPACINGS bf16 steps at
# the largest magnitude its step touches (at most 1.5 by the roundings).
LM_GRAD_REL_L2 = 2.0 ** -5
LM_STEP_BF16_SPACINGS = 2.0


def lm_task_full():
    from repro_torch.models.tasks import lm_task
    return lm_task("tinyllama-1.1b", reduce=False, n_layers=LM_LAYERS)


def lm_session(task, secure_agg=None):
    from repro_torch.config import ModestConfig, TrainConfig
    from repro_torch.data.synthetic import make_lm_task
    from repro_torch.sim.runner import ModestSession

    return ModestSession(
        n_nodes=LM_NODES,
        mcfg=ModestConfig(n_nodes=LM_NODES, sample_size=LM_COHORT,
                          n_aggregators=2, success_fraction=1.0,
                          ping_timeout=1.0, secure_agg=secure_agg),
        tcfg=TrainConfig(batch_size=LM_BATCH), task=task,
        data=make_lm_task(LM_NODES, samples_per_node=24, seq_len=97,
                          vocab=task.cfg.vocab, iid=False, seed=0),
        seed=0, eval_every_rounds=2, engine="batched", device=task.device)


def lm_counted_session(task, masked: bool):
    """The session with the counts set to 0 just before it and read just
    after, plus (B2 / B5) one quantised aggregation of its last cohort."""
    from repro_torch.kernels import fused

    session = lm_session(task, secure_agg="masked" if masked else None)
    leaks = arm_sniffer(session) if masked else []
    calls = record_aggregations(session, masked)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result, wall = run_session(session, LM_SIM_SECONDS)
    if masked:
        quant = masked_agg_quant_phase(session, calls[-1])
    else:
        quant = agg_quant_phase(session, calls[-1][0])
    launches = read_counts()
    n_agg = sum(len(node.agg_log) for node in session.nodes.values())
    name, qname = (("fused.unmask_agg", "fused.unmask_agg_quant") if masked
                   else ("fused.agg", "fused.agg_quant"))
    want = {k: 0 for k in launches}
    want.update({name: n_agg, qname: 1})
    if masked:
        want["fused.mask"] = result.trainings_completed
    if launches != want or n_agg != len(calls) or n_agg == 0:
        raise AssertionError(f"launches {launches}, want {want}; "
                             f"{len(calls)} aggregations recorded")
    if leaks:
        raise AssertionError(f"plaintext models on the wire: {leaks[:5]}")
    loss = check_session(session, result, metric="loss",
                         min_rounds=LM_MIN_ROUNDS)
    return dict(session=session, result=result, wall=wall, calls=calls,
                quant=quant, launches=launches, loss=loss,
                max_memory_allocated=torch.cuda.max_memory_allocated())


def bf16_spacing(m):
    """Distance between neighbouring bf16 values at magnitude ``m``."""
    m = torch.clamp_min(m.abs(), 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def vmap_grad_form(task):
    """The reference's form of the stacked gradient, ``vmap(grad(loss))``,
    timed beside the package's (vmap of the losses, one backward of their
    sum) as a yardstick only."""
    from repro_torch.models import transformer

    cfg = task.cfg

    def loss(params, tokens, labels, mask):
        return transformer.loss_fn(params, cfg, {
            "tokens": tokens, "labels": labels, "mask": mask})[0]

    per_model = torch.func.vmap(torch.func.grad(loss))
    return lambda ptree, xb, yb, mb: per_model(
        ptree, xb, yb, mb[:, :, None].expand(xb.shape))


def cuda_ms(fn, reps: int = 3):
    """CUDA-event times of ``reps`` calls of ``fn`` after one warm-up,
    each with the peak memory it reached."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times, peaks = [], []
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        peaks.append(torch.cuda.max_memory_allocated())
        del out
    return times, max(peaks)


def lm_step_check(task, data):
    """One cohort step of the stacked lowering (the engine's step over
    ``(S, N)``) on the first clients' first batches against ``task._step``
    for member 0, leaf by leaf: the updates within ``LM_GRAD_REL_L2`` and
    every parameter within the updates' difference plus
    ``LM_STEP_BF16_SPACINGS`` bf16 steps; the step's time, and the
    stacked gradient's beside the vmap(grad) form's."""
    from repro_torch.engine.cohort import _cohort_ops
    from repro_torch.engine.lowering import stacked_grads_for
    from repro_torch.utils.pytree import tree_flatten, tree_flatten_with_path

    spec = task.flat_spec
    opt, step = _cohort_ops(task)
    params = task.init_params(1)
    buf = spec.pack(params)
    bufs = torch.stack([buf] * LM_COHORT)
    batches = [task._padded_batches(data.clients[s], LM_BATCH)[0]
               for s in range(LM_COHORT)]
    dev = buf.device
    xb, yb, mb = (torch.from_numpy(np.stack([b[i] for b in batches])).to(dev)
                  for i in range(3))
    act = torch.ones(LM_COHORT, dtype=torch.bool, device=dev)
    new, _ = step(bufs, opt.init(bufs), xb, yb, mb, act)
    seen = {}
    inner = task._opt                   # keep the gradient _step computes
    task._opt = inner._replace(update=lambda g, state, p=None: (
        seen.__setitem__("g", g), inner.update(g, state, p))[1])
    try:
        want, _, loss = task._step(params, inner.init(params),
                                   task._to_batch(*batches[0]))
    finally:
        task._opt = inner
    lr, upd = task.tcfg.lr, new[0] - buf
    leaves, worst, worst_rel = {}, 0.0, 0.0
    for (path, p0), off, size, got, w, gq in zip(
            tree_flatten_with_path(params)[0], spec.offsets, spec.sizes,
            tree_flatten(spec.unpack(new[0]))[0], tree_flatten(want)[0],
            tree_flatten(seen["g"])[0]):
        p0, got, w = (t.float().reshape(-1) for t in (p0, got, w))
        us, uq = upd[off:off + size], -lr * gq.float().reshape(-1)
        rel = float((us - uq).norm() / torch.clamp_min(uq.norm(), 1e-30))
        big = torch.stack([p0.abs(), us.abs(), uq.abs(), got.abs(),
                           w.abs()]).amax(0)
        sp = bf16_spacing(big)
        rounding = ((got - w).abs() - (us - uq).abs()) / sp
        d = (got - w).abs() / sp
        leaves["/".join(str(getattr(k, "key", k)) for k in path)] = {
            "update_rel_l2": rel,
            "rounding_bf16_spacings": float(rounding.max()),
            "max_bf16_spacings": float(d.max()),
            "lanes_over_one_spacing": int((d > 1).sum()), "lanes": size}
        worst, worst_rel = max(worst, float(rounding.max())), max(worst_rel,
                                                                  rel)
    del new, want, upd, seen
    ptree = spec.unpack_stacked(bufs)
    step_ms, step_peak = cuda_ms(lambda: step(bufs, opt.init(bufs), xb, yb,
                                              mb, act))
    grad_ms, grad_peak = cuda_ms(lambda: stacked_grads_for(task)(
        ptree, xb, yb, mb))
    vg = vmap_grad_form(task)
    vg_ms, vg_peak = cuda_ms(lambda: vg(ptree, xb, yb, mb))
    tokens = int(mb.numel()) * xb.shape[-1]
    out = {"update_rel_l2": worst_rel, "tolerance_update_rel_l2":
           LM_GRAD_REL_L2, "rounding_bf16_spacings": worst,
           "tolerance_bf16_spacings": LM_STEP_BF16_SPACINGS,
           "loss": float(loss), "leaves": leaves,
           "cohort_step_ms": step_ms, "cohort_step_peak_bytes": step_peak,
           "grads_ms": grad_ms, "grads_peak_bytes": grad_peak,
           "vmap_grad_ms": vg_ms, "vmap_grad_peak_bytes": vg_peak,
           "tokens": tokens, "flops": 6 * spec.n * tokens,
           "bf16_bound_ms": 6 * spec.n * tokens / BF16_FLOPS_PER_S * 1e3}
    emit("lm_step", **out)
    if worst_rel > LM_GRAD_REL_L2 or worst > LM_STEP_BF16_SPACINGS or \
            not torch.isfinite(loss):
        raise AssertionError(f"stacked step against _step: updates "
                             f"{worst_rel} apart, parameters {worst} bf16 "
                             "steps past the updates' difference")
    return out


def lm_wide_check(dev, N: int):
    """``fused.agg`` and ``fused.unmask_agg`` at P = LM_WIDE_P over N lanes
    (P * N past 2^31): the mean within 1e-6 of the plain version; rows
    sealed by ``fused.mask`` unseal by the plain path to the original bits;
    the unmask equal to ``fused.agg`` bit for bit."""
    from repro_torch.kernels import fused

    P = LM_WIDE_P
    x, w, _ = make_inputs(P, N, 0, seed=900, dev=dev)
    mean = fused.aggregate_flat_onepass(x, w)
    plain = fused._plain_onepass(x, w)
    err = float((mean - plain).abs().max())
    if not torch.allclose(mean, plain, rtol=TOL, atol=TOL):
        raise AssertionError(f"P = {P}: fused.agg off by {err}")
    del plain
    seeds, signs = mask_terms(P, seed=901, dev=dev)
    y = torch.empty_like(x)
    for p in range(P):
        y[p] = fused.apply_mask_flat(x[p], seeds[p], signs[p])
    umean = fused.unmask_aggregate_flat(y, w, seeds=seeds, signs=signs)
    torch.cuda.synchronize()
    if not torch.equal(umean, mean):
        raise AssertionError(f"P = {P}: fused.unmask_agg != fused.agg on the "
                             "unsealed rows")
    unsealed = plain_unseal(fused, y, seeds, signs)
    if not torch.equal(bits(unsealed), bits(x)):
        raise AssertionError(f"P = {P}: the plain unseal does not give the "
                             "rows back")
    del unsealed
    plain = plain_unmask_onepass(fused, y, w, None, seeds, signs)
    uerr = float((umean - plain).abs().max())
    if not torch.allclose(umean, plain, rtol=TOL, atol=TOL):
        raise AssertionError(f"P = {P}: fused.unmask_agg off by {uerr}")
    out = {"P": P, "N": N, "elements": P * N, "past_2_31": P * N > 2 ** 31,
           "rows_gb": P * N * 4 / 1e9, "agg_max_abs_err": err,
           "unmask_max_abs_err": uerr, "unmask_vs_agg": "bit-identical",
           "plain_unseal_vs_rows": "bit-identical",
           "agg_ms": time_ms(lambda: fused.aggregate_flat_onepass(x, w), 3),
           "unmask_agg_ms": time_ms(lambda: fused.unmask_aggregate_flat(
               y, w, seeds=seeds, signs=signs), 3),
           "agg_bound_ms": bound_ms("fused.agg", P, N, 0, False)[0],
           "unmask_agg_bound_ms": bound_ms("fused.unmask_agg", P, N, P,
                                           False)[0]}
    del x, y, w, mean, umean, plain
    torch.cuda.empty_cache()
    return out


def release():
    """Give the card back what finished sessions held: a session's nodes
    and hooks refer to one another, so its tensors go only when the cycle
    collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def lm_row(lm, name: str) -> dict:
    """One kernel's numbers at the TinyLlama-width session's stack (P = 4,
    N = 219,162,624): its times and bound from the timed shape, its
    launches in the plain and the masked counted sessions."""
    row = lm["kernels"][name]
    return {"P": row["P"], "N": row["N"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "max_abs_err": row["max_abs_err"],
            "launches": {k: lm[k]["launches"][name]
                         for k in ("plain", "masked")}}


def lm_train_phase(dev, word_pipes):
    """MoDeST sessions that train TinyLlama at full width (2 of its 22
    layers, bf16 leaves, N = 219,162,624 lanes) on the batched engine,
    plain and masked, each counted; their breakdowns; one cohort step
    against ``task._step``; the wide-stack check; B1-B5 timed at N."""
    from repro_torch.kernels import fused

    t0 = time.perf_counter()
    task = lm_task_full()
    spec = task.flat_spec
    if spec.n != LM_N or len(spec.shapes) != 12:
        raise AssertionError(f"TinyLlama-width layout changed: {spec}")
    out = {"model": "tinyllama-1.1b", "n_layers": LM_LAYERS, "n_params":
           spec.n, "wire_bytes": spec.nbytes, "n_nodes": LM_NODES,
           "sample_size": LM_COHORT, "batch_size": LM_BATCH,
           "sim_seconds": LM_SIM_SECONDS}
    for masked in (False, True):
        run = lm_counted_session(task, masked)
        key = "masked" if masked else "plain"
        if masked:
            masked_agg_quant_check(run["session"], run["calls"][-1],
                                   run["quant"], phase="lm_masked_agg_quant")
        else:
            agg_quant_check(run["session"], run["calls"][-1][0],
                            *run["quant"], phase="lm_agg_quant")
        worst = means_check(run["session"], run["calls"], masked,
                            "lm_masked_means" if masked else "lm_means")
        res = run["result"]
        out[key] = {"rounds": res.rounds_completed,
                    "wall_seconds": run["wall"],
                    "rounds_per_wall_second": res.rounds_completed
                    / run["wall"], "loss": run["loss"],
                    "aggregations": len(run["calls"]),
                    "trainings": res.trainings_completed,
                    "flushes": run["session"].engine.flushes,
                    "jobs": run["session"].engine.jobs_run,
                    "launches": run["launches"],
                    "means_max_abs_err": worst,
                    "models_per_aggregation": [len(c[0]) for c in
                                               run["calls"]],
                    "total_bytes": res.usage["total_bytes"],
                    "max_memory_allocated": run["max_memory_allocated"]}
        emit("lm_masked_session" if masked else "lm_session", **out[key])
        data = run["session"].data
        del run
        release()
        if not masked:
            out["step"] = lm_step_check(task, data)
            release()
        out[key]["breakdown"] = breakdown_phase(
            LM_SIM_SECONDS, "masked" if masked else None,
            session=lm_session(task, "masked" if masked else None),
            phase="lm_breakdown")
        release()
    del task
    release()
    out["wide"] = lm_wide_check(dev, LM_N)
    emit("lm_wide", **out["wide"])
    rows = {"fused.agg": [], "fused.agg_quant": []}
    fused_shape_rows(rows, dev, fused, word_pipes, LM_SHAPE, seed=950)
    out["kernels"] = {k: v[0] for k, v in rows.items()}
    emit("lm_kernels", kernels=out["kernels"])
    out["seconds"] = time.perf_counter() - t0
    emit("lm_train", seconds=out["seconds"], model=out["model"],
         n_params=spec.n, **{k: {"rounds": out[k]["rounds"],
                                 "wall_seconds": out[k]["wall_seconds"],
                                 "shares": out[k]["breakdown"]["shares"]}
                             for k in ("plain", "masked")},
         update_rel_l2=out["step"]["update_rel_l2"],
         rounding_bf16_spacings=out["step"]["rounding_bf16_spacings"],
         cohort_step_ms=out["step"]["cohort_step_ms"])
    return out

# ---------------------------------------------------------------------------
# the families phase: the other LM families served at published widths
# ---------------------------------------------------------------------------

# arch, config overrides, batch, text tokens a row, attention layers a
# prefill (the flash kernel's launches). Widths are the published ones, in
# bf16; qwen3-moe's depth is cut from 48 to 4 layers (init stacks a list of
# blocks, which doubles the weights for a moment: 2 x 61 GB at 48). LLaVA's
# prompt adds its 576 x 5 image embeddings to the text: S = 3,072, under
# its 4,096 window, as hymba's 512 is under its 1,024, so the window masks
# nothing and the flash check measures the kernel, not ROADMAP C4.
FAMILY_MODELS = [
    ("qwen3-moe-30b-a3b", {"n_layers": 4}, 4, 1024, 4),
    ("llava-next-mistral-7b", {}, 4, 192, 32),
    ("whisper-large-v3", {}, 4, 128, 32),
    ("hymba-1.5b", {}, 4, 512, 32),
    ("rwkv6-1.6b", {}, 4, 256, 0),
]
FAMILY_NEW = 16                 # greedy decode steps a model
FAMILY_LAUNCHER_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b", "rwkv6-1.6b",
                         "hymba-1.5b", "whisper-large-v3",
                         "llava-next-mistral-7b")


def family_config(arch, overrides):
    from repro_torch import configs
    return configs.get_config(arch).with_(use_flash=True, **overrides)


def image_positions(cfg) -> int:
    return cfg.image_tokens * cfg.anyres_tiles if cfg.family == "vlm" else 0


def family_flash_layouts():
    """(B, Hq, Hkv, S, hd) of the flash kernel's calls in each attention
    family's prefill."""
    out = {}
    for arch, over, B, S_text, n_attn in FAMILY_MODELS:
        if n_attn:
            cfg = family_config(arch, over)
            out[arch] = (B, cfg.n_heads, cfg.n_kv_heads,
                         image_positions(cfg) + S_text,
                         cfg.resolved_head_dim())
    return out


def family_batch(cfg, B, S_text, seed, dev):
    """Prompt tokens and the family's stubbed frontend input (frames or
    image embeddings, standard normal x 0.1 in the parameters' type), from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, S_text)), device=dev)}

    def embeds(n):
        x = rng.standard_normal((B, n, cfg.d_model), dtype=np.float32) * 0.1
        return torch.as_tensor(x, device=dev).to(getattr(torch,
                                                         cfg.param_dtype))

    if cfg.family == "audio":
        batch["frames"] = embeds(cfg.n_frames)
    if cfg.family == "vlm":
        batch["image_embeds"] = embeds(image_positions(cfg))
    return batch


def traced(fn):
    """Wall seconds of ``fn()`` under ``torch.profiler``, the device time of
    its kernels, the device's busy share and the top kernels (null where
    the profiler records no device time: not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    kern.sort(key=lambda r: -r[1])
    device_s = sum(t for _, t, _ in kern) / 1e6
    by_class = {}
    for k, t, _ in kern:
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0) + t / 1e3
    return {"wall_seconds_traced": wall,
            "device_seconds": device_s if kern else None,
            "device_busy_share": device_s / wall if kern else None,
            "device_ms_by_class": by_class,
            "top_kernels": [{"name": k[:80], "device_ms": t / 1e3,
                             "count": c} for k, t, c in kern[:12]]}


def kernel_class(name: str) -> str:
    """A device kernel's kind, from its name: the flash kernel, matrix
    products (cuBLAS), scans, reductions, copies, other elementwise."""
    for cls, marks in (("flash_attention", ("flash_tc_kernel",
                                            "flash_fwd_kernel")),
                       ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
                       ("scan", ("scan",)), ("reduce", ("reduce_kernel",)),
                       ("copy", ("copy",))):
        if any(m in name for m in marks):
            return cls
    return "elementwise"


def check_family_cache(cache, pos: int, name: str):
    """Every cache or state tensor finite (the KV caches up to ``pos``)."""
    for key, t in cache.items():
        if key == "pos":
            continue
        if key in ("k", "v"):
            t = t[:, :, :pos]
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: cache {key!r} not finite")


def moe_loss_check(server, params, batch):
    """One ``loss_fn`` forward of the MoE model on next-token labels, and
    the share of (token, choice) slots each layer's routing dropped at
    capacity (read through ``moe.routing``)."""
    from repro_torch.models import moe

    routing, kept = moe.routing, []

    def recording(p, cfg, xg, *span):
        r = routing(p, cfg, xg, *span)
        kept.append(float(r["keep"].mean()))
        return r

    labels = torch.roll(batch["tokens"], -1, dims=1)
    moe.routing = recording
    try:
        with torch.no_grad():
            loss, metrics = server.model.loss_fn(
                params, {"tokens": batch["tokens"], "labels": labels})
    finally:
        moe.routing = routing
    out = {"loss": float(loss), "xent": float(metrics["loss"]),
           "aux_loss": float(metrics["aux_loss"]),
           "dropped_slot_share_by_layer": [1 - k for k in kept]}
    if not all(np.isfinite([out["loss"], out["aux_loss"]])):
        raise AssertionError(f"moe loss not finite: {out}")
    return out


def rwkv_step_check(cfg, params, batch, dev):
    """In fp32: the logits of one decode step after a prefill over the S
    prompt tokens against the last logits of a prefill over S+1 tokens
    (one more token drawn from ``numpy.random.default_rng(1)``)."""
    from repro_torch.core.distributed import Server
    from repro_torch.utils.pytree import tree_map

    srv = Server(cfg.with_(param_dtype="float32"), device=dev)
    p = tree_map(lambda t: t.to(torch.float32), params)
    B, S = batch["tokens"].shape
    toks = torch.cat([batch["tokens"], torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, 1)),
        device=dev)], dim=1)
    _, cache = srv.prefill(p, {"tokens": toks[:, :S]},
                           srv.model.init_cache(B, S + 1, dev))
    step, _ = srv.decode(p, toks[:, S:], cache)
    whole, _ = srv.prefill(p, {"tokens": toks},
                           srv.model.init_cache(B, S + 1, dev))
    gap = rel_l2(step, whole)
    del p
    if not gap <= LOGIT_REL_TOL_FP32:
        raise AssertionError(f"rwkv decode after {S} tokens off the "
                             f"prefill over {S + 1}: {gap}")
    return {"fp32_step_vs_prefill_rel_l2": gap, "prompt_tokens": S}


def family_model(dev, arch, over, B, S_text, n_attn):
    """One model through ``Server``: init, a prefill to warm up, a counted
    prefill, ``FAMILY_NEW`` greedy decode steps, then its checks. Returns
    its line and the flash launches it made."""
    from repro_torch.core.distributed import Server
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.utils.pytree import tree_leaves

    cfg = family_config(arch, over)
    S = image_positions(cfg) + S_text
    server = Server(cfg, device=dev)
    launches0 = flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = server.shard_params(server.model.init(
        torch.Generator(device=dev).manual_seed(0), dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = family_batch(cfg, B, S_text, 0, dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def timed_prefill():
        cache = server.model.init_cache(B, S + FAMILY_NEW + 8, dev)
        before = flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = server.prefill(params, batch, cache)
        torch.cuda.synchronize()
        return (logits, cache, time.perf_counter() - t0,
                flash_attention.launches - before)

    _, _, cold_s, cold_launches = timed_prefill()
    prefill_logits, cache, warm_s, warm_launches = timed_prefill()
    tok = torch.argmax(prefill_logits[:, -1:], dim=-1)
    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(FAMILY_NEW):
        logits, cache = server.decode(params, tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)

    gen = torch.cat(generated, dim=1)
    if cold_launches != n_attn or warm_launches != n_attn:
        raise AssertionError(f"{arch}: {cold_launches} and {warm_launches} "
                             f"flash launches a prefill, want {n_attn}")
    if prefill_logits.shape != (B, 1, cfg.vocab) or not torch.isfinite(
            prefill_logits).all():
        raise AssertionError(f"{arch}: prefill logits "
                             f"{tuple(prefill_logits.shape)}, or not finite")
    if cache["pos"] != S + FAMILY_NEW:
        raise AssertionError(f"{arch}: cache at {cache['pos']}, want "
                             f"{S + FAMILY_NEW}")
    check_family_cache(cache, cache["pos"], arch)
    if not ((0 <= gen) & (gen < cfg.vocab)).all():
        raise AssertionError(f"{arch}: generated ids out of the vocabulary")
    del cache
    line = dict(
        model=arch, family=cfg.family, n_params=sum(
            t.numel() for t in tree_leaves(params)),
        n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim(),
        vocab=cfg.vocab, dtype=cfg.param_dtype, batch=B, prompt_len=S,
        text_tokens=S_text, new_tokens=FAMILY_NEW, init_seconds=init_s,
        prefill_seconds_cold=cold_s, prefill_seconds=warm_s,
        prefill_tokens_per_s=B * S / warm_s, decode_seconds=decode_s,
        decode_tokens_per_s=B * FAMILY_NEW / decode_s,
        flash_launches_per_prefill=warm_launches, peak_memory_bytes=peak,
        sample_ids=gen[0, :12].tolist())
    ref = None
    if cfg.family in ("moe", "ssm", "hybrid", "audio"):
        ref = dict(world_reference(cfg, params, batch,
                                   gen[:, :WORLD_NEW - 1], dev),
                   tokens=gen.cpu())
    if cfg.family == "moe":
        line["depth_cut"] = {"published_layers": 48, "run": cfg.n_layers}
        line["experts"] = {"n": cfg.moe_num_experts, "top_k": cfg.moe_top_k,
                           "d_ff": cfg.moe_d_ff_expert,
                           "group": cfg.moe_group_size}
        line["loss"] = moe_loss_check(server, params, batch)
        line["profile"] = traced(lambda: server.prefill(
            params, batch, server.model.init_cache(B, S + 8, dev)))
    if n_attn:
        line["logits_gaps"] = logits_gaps(cfg, params, batch, dev,
                                          flash_bf16=prefill_logits)
    else:
        line["step_check"] = rwkv_step_check(cfg, params, batch, dev)
    line["peak_memory_bytes_with_checks"] = torch.cuda.max_memory_allocated(
        dev)
    del params, server, batch, prefill_logits
    release()
    return line, flash_attention.launches - launches0, ref


def world_reference(cfg, params, batch, teacher, dev):
    """The world phase's one-process reference for a family it serves
    across ranks (the MoE, RWKV-6, Hymba, Whisper, LLaVA): a prefill of
    ``batch`` and a
    decode of each column of ``teacher`` (teacher-forced), in bf16 and, as
    the control, with the weights widened exactly to fp32; for each, every
    step's last-position logits and, for the MoE, every layer's routing of
    every step (``recorded_routes``), on the CPU."""
    from repro_torch.core.distributed import Server
    from repro_torch.utils.pytree import tree_map

    B, S = batch["tokens"].shape
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = params if dtype == "bfloat16" else tree_map(
            lambda t: t.to(torch.float32), params)
        srv = Server(cfg.with_(param_dtype=dtype), device=dev)
        steps = []

        def run():
            cache = srv.model.init_cache(
                B, image_positions(cfg) + S + teacher.shape[1] + 8, dev)
            logits, cache = srv.prefill(p, batch, cache)
            steps.append(logits[:, -1].float().cpu())
            for i in range(teacher.shape[1]):
                logits, cache = srv.decode(p, teacher[:, i:i + 1], cache)
                steps.append(logits[:, -1].float().cpu())

        if cfg.family == "moe":
            routes = recorded_routes(run,
                                     cfg.n_layers * (1 + teacher.shape[1]))
        else:
            run()
            routes = None
        out[dtype] = {"step_logits": steps, "routes": routes}
        del p, srv
    return out


def recorded_routes(run, n_calls: int):
    """``run()`` with ``models.moe.routing`` wrapped to keep the top-k
    expert indices of its first ``n_calls`` calls, token by token
    ((Gn x G, k)), on the CPU; the port's function is put back after."""
    from repro_torch.models import moe

    real, routes = moe.routing, []

    def recording(p, cfg, xg, *span):
        r = real(p, cfg, xg, *span)
        if len(routes) < n_calls:
            routes.append(r["idx"].reshape(-1, r["idx"].shape[-1]).cpu())
        return r

    moe.routing = recording
    try:
        run()
    finally:
        moe.routing = real
    return routes


def families_phase(dev):
    """The other LM families served at published widths through ``Server``
    with ``use_flash=True`` (``FAMILY_MODELS``), one at a time, each
    model's memory given back before the next; then the serving launcher at
    every new arch's reduced config and whisper-large-v3 at full size.
    Counted: the caller sets the counts to 0 just before and reads them
    just after. Returns the lines, the flash launches the phase made and
    the one-process references of qwen3-moe, RWKV-6, Hymba and Whisper for
    the world phase (``world_refs``: prefill and teacher-forced decode logits,
    tokens, the MoE's routing)."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    lines, flash, world_refs = {}, 0, {}
    for arch, over, B, S_text, n_attn in FAMILY_MODELS:
        line, launched, ref = family_model(dev, arch, over, B, S_text,
                                           n_attn)
        emit("family", **line)
        lines[arch], flash = line, flash + launched
        if ref is not None:
            world_refs[arch] = ref
    launcher = {}
    for arch in FAMILY_LAUNCHER_ARCHS:
        out = serve.main(["--arch", arch, "--seed", "0"])
        launcher[arch] = {k: out[k] for k in (
            "prefill_seconds", "decode_seconds", "decode_tokens_per_s")}
        if out["tokens"].shape != (4, 16):
            raise AssertionError(f"launcher {arch}: {out['tokens'].shape}")
    out = serve.main(["--arch", "whisper-large-v3", "--full-size"])
    launcher["whisper-large-v3 --full-size"] = {k: out[k] for k in (
        "prefill_seconds", "decode_seconds", "decode_tokens_per_s")}
    release()
    seconds = time.perf_counter() - t0
    emit("families", seconds=seconds, launcher=launcher,
         fp32_logits_rel_l2_tol=LOGIT_REL_TOL_FP32,
         bf16_err_ratio_tol=BF16_ERR_RATIO,
         models={a: {k: line[k] for k in (
             "prefill_seconds", "decode_tokens_per_s", "peak_memory_bytes",
             "flash_launches_per_prefill")} for a, line in lines.items()})
    return {"lines": lines, "flash_launches": flash, "seconds": seconds,
            "world_refs": world_refs}


# ---------------------------------------------------------------------------
# lm_families_train: MoDeST sessions that train the MoE, RWKV-6 and Hymba
# families at published widths
# ---------------------------------------------------------------------------

# arch, depth cut, nodes, cohort (sample size), aggregators, evaluated
# every so many rounds, simulated seconds, also masked. Widths are the
# published ones, bf16 leaves; the cuts are PERF.md section 4's. The MoE's
# one layer holds 128 experts (N = 1,245,452,288 lanes with its embedding
# and head, 4.98 GB a flat fp32 model): 4 nodes, cohorts of 2, one
# aggregator, 800 simulated s (4 rounds), evaluated at rounds 1 and 4:
# the session keeps each evaluated round's fp32 model until it ends (lazy
# evaluation, as the reference's runner), and beside the 35 GB cohort
# step two of them already bring the peak near 60 GB (PERF.md section 6).
FAMILY_TRAIN = [
    ("qwen3-moe-30b-a3b", {"n_layers": 1}, 4, 2, 1, 4, 800.0, False),
    ("rwkv6-1.6b", {"n_layers": 2}, 8, 4, 2, 2, 1300.0, False),
    ("hymba-1.5b", {"n_layers": 2}, 8, 4, 2, 2, 750.0, True),
]
FAMILY_TRAIN_ROUNDS = 3


def moe_dropped_slots(task, buffer, data):
    """The share of (token, choice) slots dropped at capacity in every
    layer, for one client's batch through the trained model."""
    from repro_torch.models import moe

    seen = []
    routing = moe.routing

    def spy(p, cfg, xg, *span):
        r = routing(p, cfg, xg, *span)
        seen.append(r["keep"])
        return r

    x, y, m = task._padded_batches(data.clients[0], LM_BATCH)[0]
    moe.routing = spy
    try:
        with torch.no_grad():
            task.model.loss_fn(task.flat_spec.unpack(buffer),
                               task._to_batch(x, y, m))
    finally:
        moe.routing = routing
    keep = torch.cat([k.reshape(-1) for k in seen])
    return {"slots": int(keep.numel()),
            "dropped": int((keep == 0).sum()),
            "share": float((keep == 0).float().mean())}


def family_step_ms(task, data, cohort: int):
    """One cohort step of the engine over ``cohort`` stacked copies of a
    seeded model on the first clients' batches: CUDA-event times, and the
    peak memory it reached."""
    from repro_torch.engine.cohort import _cohort_ops

    spec = task.flat_spec
    opt, step = _cohort_ops(task)
    bufs = spec.pack(task.init_params(1))[None].repeat(cohort, 1)
    batches = [task._padded_batches(data.clients[s], LM_BATCH)[0]
               for s in range(cohort)]
    xb, yb, mb = (torch.from_numpy(np.stack([b[i] for b in batches])).to(
        bufs.device) for i in range(3))
    act = torch.ones(cohort, dtype=torch.bool, device=bufs.device)
    times, peak = cuda_ms(lambda: step(bufs, opt.init(bufs), xb, yb, mb,
                                       act)[0], reps=2)
    return {"ms": times, "peak_bytes": peak, "tokens": int(xb.numel())}


def family_train_session(arch, over, nodes, cohort, aggregators,
                         eval_every, sim_seconds, masked):
    """One counted MoDeST session of ``arch`` at published widths cut to
    ``over``; returns its line."""
    from repro_torch import configs
    from repro_torch.config import ModestConfig, TrainConfig
    from repro_torch.data.synthetic import make_lm_task
    from repro_torch.engine.flat import as_buffer
    from repro_torch.models.tasks import lm_task
    from repro_torch.sim.runner import ModestSession

    task = lm_task(arch, reduce=False, **over)
    spec = task.flat_spec
    data = make_lm_task(nodes, samples_per_node=24, seq_len=97,
                        vocab=task.cfg.vocab, iid=False, seed=0)
    session = ModestSession(
        n_nodes=nodes,
        mcfg=ModestConfig(n_nodes=nodes, sample_size=cohort,
                          n_aggregators=aggregators, success_fraction=1.0,
                          ping_timeout=1.0,
                          secure_agg="masked" if masked else None),
        tcfg=TrainConfig(batch_size=LM_BATCH), task=task, data=data, seed=0,
        eval_every_rounds=eval_every, engine="batched", device=task.device)
    leaks = arm_sniffer(session) if masked else []
    # only the last aggregation is kept: a whole session's inputs would
    # hold every trained model alive
    last = {"n": 0}
    record_aggregations(session, masked, lambda call: last.update(
        call=call, n=last["n"] + 1))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result, wall = run_session(session, sim_seconds)
    if masked:
        quant = masked_agg_quant_phase(session, last["call"])
    else:
        quant = agg_quant_phase(session, last["call"][0])
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_agg = sum(len(node.agg_log) for node in session.nodes.values())
    name, qname = (("fused.unmask_agg", "fused.unmask_agg_quant") if masked
                   else ("fused.agg", "fused.agg_quant"))
    want = {k: 0 for k in launches}
    want.update({name: n_agg, qname: 1})
    if masked:
        want["fused.mask"] = result.trainings_completed
    if launches != want or n_agg != last["n"] or n_agg == 0:
        raise AssertionError(f"{arch}: launches {launches}, want {want}; "
                             f"{last['n']} aggregations recorded")
    if leaks:
        raise AssertionError(f"{arch}: plaintext models on the wire: "
                             f"{leaks[:5]}")
    loss = check_session(session, result, metric="loss",
                         min_rounds=FAMILY_TRAIN_ROUNDS)
    if result.usage["total_bytes"] < result.trainings_completed * spec.nbytes:
        raise AssertionError(f"{arch}: {result.usage['total_bytes']} bytes "
                             f"for {result.trainings_completed} trained "
                             f"models of {spec.nbytes}")
    tag = "_masked" if masked else ""
    if masked:
        masked_agg_quant_check(session, last["call"], quant,
                               phase="family_masked_agg_quant")
    else:
        agg_quant_check(session, last["call"][0], *quant,
                        phase="family_agg_quant")
    worst = means_check(session, [last["call"]], masked,
                        f"family_means{tag}")
    line = dict(
        model=arch, family=task.cfg.family, masked=masked,
        n_layers=task.cfg.n_layers,
        published_layers=configs.get_config(arch).n_layers,
        n_params=spec.n, wire_bytes=spec.nbytes, n_nodes=nodes,
        sample_size=cohort, aggregators=aggregators,
        eval_every_rounds=eval_every, batch_size=LM_BATCH,
        tokens_a_sample=96,
        sim_seconds=sim_seconds, rounds=result.rounds_completed,
        trainings=result.trainings_completed, aggregations=n_agg,
        total_bytes=result.usage["total_bytes"], wall_seconds=wall,
        loss=loss, launches={k: v for k, v in launches.items() if v},
        means_max_abs_err=worst, peak_memory_bytes=peak)
    if task.cfg.family == "moe":
        aux = [h["aux_loss"] for h in result.history if "aux_loss" in h]
        if not aux or not all(np.isfinite(a) for a in aux):
            raise AssertionError(f"{arch}: auxiliary loss {aux}")
        line["aux_loss"] = aux
        final = as_buffer(session._eval_models[max(session._eval_models)],
                          spec)
    else:
        final = None
    del session, last, quant, result
    release()
    if final is not None:
        line["dropped_at_capacity"] = moe_dropped_slots(task, final, data)
        del final
    step = family_step_ms(task, data, cohort)
    line["cohort_step_ms"] = step["ms"]
    line["cohort_step_peak_bytes"] = step["peak_bytes"]
    line["cohort_step_tokens"] = step["tokens"]
    del task
    release()
    emit("family_train", **line)
    return line


def lm_families_train_phase():
    """``FAMILY_TRAIN``'s sessions one after another, each counted on its
    own (counts at 0 just before, read just after), their memory given
    back before the next."""
    t0 = time.perf_counter()
    lines = {}
    for arch, over, *setup, also_masked in FAMILY_TRAIN:
        for masked in (False, True) if also_masked else (False,):
            line = family_train_session(arch, over, *setup, masked)
            lines[arch + (" masked" if masked else "")] = line
    seconds = time.perf_counter() - t0
    emit("lm_families_train", seconds=seconds,
         sessions={k: {f: v[f] for f in (
             "rounds", "wall_seconds", "cohort_step_ms",
             "peak_memory_bytes")}
             for k, v in lines.items()})
    return {"lines": lines, "seconds": seconds}


# ---------------------------------------------------------------------------
# mesh_train: the mesh form of a round
# ---------------------------------------------------------------------------

MESH_ARGS = ["--mode", "mesh", "--arch", "tinyllama-1.1b", "--full-size",
             "--model-parallel", "2", "--failure-rate", "0.3", "--seed", "0"]
MESH_RUNS = (("modest", 4, 3), ("dsgd", 8, 1))   # algo, devices, rounds
# arch, depth cut, batch rows a participant, text tokens a row
MESH_FAMILIES = (
    ("whisper-large-v3", {"n_layers": 4, "encoder_layers": 4}, 2, 64),
    ("llava-next-mistral-7b", {"n_layers": 2}, 1, 64),
)


def replicas_equal(state) -> bool:
    from repro_torch.utils.pytree import tree_leaves
    return all(torch.equal(leaf[0], leaf[p]) for leaf in tree_leaves(
        state.params) for p in range(1, leaf.shape[0]))


def family_train_batch(cfg, P, B, T, seed, dev):
    """A mesh round's batch for a family whose loss reads the stubbed
    frontend input, from ``numpy.random.default_rng(seed)``: tokens and
    labels ``(P, 1, B, T)`` and frames or image embeddings ``(P, 1, B, n,
    d)``, standard normal x 0.1 in fp32; and the input's key."""
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (P, 1, B, T)),
                                device=dev) for k in ("tokens", "labels")}
    key, n = (("frames", cfg.n_frames) if cfg.family == "audio" else
              ("image_embeds", image_positions(cfg)))
    batch[key] = torch.as_tensor(
        rng.standard_normal((P, 1, B, n, cfg.d_model), dtype=np.float32)
        * 0.1, device=dev)
    return batch, key


def mesh_family_round(dev, arch, over, B, T):
    """Two ``DistributedTrainer`` rounds at P = 2 (the first one cold) of
    ``arch`` at published widths cut to ``over``, the batch carrying the
    family's stubbed frontend input."""
    from repro_torch import configs
    from repro_torch.config import MeshConfig, TrainConfig
    from repro_torch.core.distributed import DistributedTrainer
    from repro_torch.utils.pytree import tree_leaves

    cfg = configs.get_config(arch).with_(**over)
    P = 2
    trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd", lr=0.05),
                                 MeshConfig(data=P, model=1),
                                 mesh=(dev,) * P, device=dev)
    state = trainer.init_state(0)
    step = trainer.jit_train_step()
    batch, key = family_train_batch(cfg, P, B, T, 0, dev)
    weights = torch.ones(P, device=dev)
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for _ in range(2):
        (state, metrics), s = synced_seconds(step, state, batch, weights)
        seconds.append(s)
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)) or not replicas_equal(state):
        raise AssertionError(f"{arch}: losses {losses}, or replicas apart")
    line = dict(model=arch, family=cfg.family, input=key,
                input_shape=list(batch[key].shape), n_layers=cfg.n_layers,
                published_layers=configs.get_config(arch).n_layers,
                encoder_layers=cfg.encoder_layers if cfg.family == "audio"
                else None, participants=P, batch=B, text_tokens=T,
                n_params=sum(x[0].numel() for x in tree_leaves(state.params)),
                losses=losses, round_seconds=seconds,
                peak_memory_bytes=torch.cuda.max_memory_allocated())
    del state, batch, trainer, step
    release()
    return line


MESH_SHARD = dict(data=2, model=2)      # the shard_state round's mesh
MESH_SHARD_BATCH = (8, 64)              # rows a participant, tokens a row


def mesh_shard_round(dev):
    """One round of TinyLlama-1.1B at full size, P = 2, on a state placed
    by ``shard_state`` on a 2 x 2 mesh naming the card, against the same
    round of a trainer without a mesh on the same state: every leaf and
    the loss bit for bit."""
    from repro_torch import configs
    from repro_torch.config import MeshConfig, TrainConfig
    from repro_torch.core.distributed import DistributedTrainer
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.utils.pytree import tree_flatten, tree_leaves

    cfg = configs.get_config("tinyllama-1.1b")
    mcfg = MeshConfig(**MESH_SHARD)
    tcfg = TrainConfig(optimizer="sgd", lr=0.05)
    plain = DistributedTrainer(cfg, tcfg, mcfg, device=dev)
    meshed = DistributedTrainer(cfg, tcfg, mcfg,
                                mesh=make_mesh_from_config(mcfg, dev))
    P = plain.policy.n_participants
    state = plain.init_state(0)
    (sharded, shard_s) = synced_seconds(meshed.shard_state, state)
    specs = tree_flatten(state)[1].flatten_up_to(meshed.state_spec(state))
    rng = np.random.default_rng(0)
    B, T = MESH_SHARD_BATCH
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (P, 1, B, T)),
                                device=dev) for k in ("tokens", "labels")}
    weights = torch.ones(P, device=dev)
    (want, wm), plain_s = synced_seconds(plain.jit_train_step(), state,
                                         batch, weights)
    (got, gm), mesh_s = synced_seconds(meshed.jit_train_step(), sharded,
                                       batch, weights)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    if not same or not torch.equal(gm["loss"], wm["loss"]) or not \
            np.isfinite(float(wm["loss"])):
        raise AssertionError(f"the round after shard_state differs from "
                             f"the unsharded round (loss {float(gm['loss'])}"
                             f" against {float(wm['loss'])})")
    line = dict(model=cfg.name, mesh=meshed.mesh.shape, participants=P,
                batch=B, tokens=T, leaves=len(specs),
                split_leaves=sum(any(a is not None for a in sp)
                                 for sp in specs),
                loss=float(wm["loss"]), shard_state_seconds=shard_s,
                round_seconds_unsharded=plain_s, round_seconds_sharded=mesh_s,
                bit_for_bit=True)
    del state, sharded, want, got, plain, meshed
    release()
    return line


def mesh_train_phase(dev):
    """The launcher's mesh form at TinyLlama's full size (modest, then
    D-SGD), then a Whisper and a LLaVA round of ``DistributedTrainer``,
    then a TinyLlama round after ``shard_state`` against the unsharded
    one."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    out = {"launcher": {}, "families": {}}
    sketches = {}
    for algo, devices, rounds in MESH_RUNS:
        torch.cuda.reset_peak_memory_stats()
        res = train.main(MESH_ARGS + ["--algo", algo, "--devices",
                                      str(devices), "--device", str(dev),
                                      "--rounds", str(rounds)])
        torch.cuda.synchronize()
        hist = res["history"]
        P = res["trainer"].policy.n_participants
        same = replicas_equal(res["state"])
        if len(hist) != rounds or P != devices // 2 or not all(
                np.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"mesh {algo}: {hist}, P = {P}")
        if same != (algo == "modest"):
            raise AssertionError(f"mesh {algo}: replicas equal: {same}")
        out["launcher"][algo] = dict(
            devices=devices, participants=P, rounds=hist,
            replicas_equal=same,
            peak_memory_bytes=torch.cuda.max_memory_allocated())
        sketches[algo] = res["change_sketch"]
        del res
        release()
    for arch, over, B, T in MESH_FAMILIES:
        out["families"][arch] = mesh_family_round(dev, arch, over, B, T)
    out["shard_state_round"] = mesh_shard_round(dev)
    out["seconds"] = time.perf_counter() - t0
    emit("mesh_train", **out)
    out["change_sketches"] = sketches       # the world phase's, not printed
    return out


# ---------------------------------------------------------------------------
# mesh_serve: the serving launcher on a mesh naming the card
# ---------------------------------------------------------------------------

MESH_SERVE_ARGS = ["--arch", "tinyllama-1.1b", "--full-size", "--devices",
                   "8", "--model-parallel", "2", "--set", "use_flash=true",
                   "--seed", "0"]


def mesh_serve_phase(dev):
    """``launch.serve.main`` at TinyLlama-1.1B's full size with flash, on a
    4 x 2 mesh whose 8 entries name the card, at the serve phase's shape
    and seed. Counted: the caller sets the counts to 0 just before and
    reads them just after."""
    from repro_torch.launch import serve

    return serve.main(MESH_SERVE_ARGS + [
        "--batch", str(SERVE_B), "--prompt-len", str(SERVE_S),
        "--new-tokens", str(SERVE_NEW), "--device", str(dev)])


def mesh_serve_check(out, served, launches):
    """The mesh launcher's tokens against the one-device serve phase's, bit
    for bit; one flash launch a layer and no other kernel; its prefill
    against the roofline's (``analytic_terms`` on one H100); then ``Server``
    on the production mesh (256 entries naming the card): the specs of the
    serve phase's parameters and of a real cache, each of which must divide
    its tensor, and ``shard_params`` / ``shard_cache`` by them."""
    from repro_torch.config import MeshConfig, ShapeConfig
    from repro_torch.core.distributed import Server
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import analytic_terms
    from repro_torch.utils.pytree import tree_flatten

    cfg, dev = served["cfg"], served["server"].device
    want = served["tokens"][:, :SERVE_NEW].cpu().numpy()
    if out["devices"] != 8 or not np.array_equal(out["tokens"], want):
        raise AssertionError(f"mesh-served tokens {out['tokens'][0, :12]} "
                             f"against one device's {want[0, :12]}")
    if launches["flash_attention"] != cfg.n_layers or sum(
            launches.values()) != cfg.n_layers:
        raise AssertionError(f"mesh_serve launches {launches}, want "
                             f"{cfg.n_layers} of flash_attention only")
    terms = analytic_terms(cfg, ShapeConfig("serve", SERVE_S, SERVE_B,
                                            "prefill"),
                           n_participants=1, chips=1)
    roof_s = max(terms["compute_s"], terms["memory_s"])

    mesh = make_production_mesh(device=dev)
    server = Server(cfg, MeshConfig(), mesh=mesh)
    cache = server.model.init_cache(SERVE_B, SERVE_S + SERVE_NEW + 8, dev)
    spec_lines = {}
    for name, tree, specs in zip(("params", "cache"),
                                 (served["params"], cache),
                                 server.specs(served["params"], cache)):
        leaves, treedef = tree_flatten(tree)
        for leaf, spec in zip(leaves, treedef.flatten_up_to(specs)):
            shape = tuple(getattr(leaf, "shape", ()))
            if not server.policy.divides(spec, shape):
                raise AssertionError(f"{name}: spec {spec} does not divide "
                                     f"{shape}")
        spec_lines[name] = {"leaves": len(leaves), "split": sum(
            any(a is not None for a in sp)
            for sp in treedef.flatten_up_to(specs))}
    placed = server.shard_params(served["params"])
    server.shard_cache(cache)
    if any(t.device != dev for t in tree_flatten(placed)[0]):
        raise AssertionError("a placed parameter is off the card")
    emit("mesh_serve", model=cfg.name, n_layers=cfg.n_layers,
         dtype=cfg.param_dtype, use_flash=cfg.use_flash, devices=8,
         mesh={"data": 4, "model": 2}, batch=SERVE_B, prompt_len=SERVE_S,
         new_tokens=SERVE_NEW, tokens_equal_one_device=True,
         flash_launches=launches["flash_attention"],
         prefill_seconds=out["prefill_seconds"],
         decode_seconds=out["decode_seconds"],
         decode_tokens_per_s=out["decode_tokens_per_s"],
         one_device_prefill_seconds=served["line"]["prefill_seconds"],
         roofline={k: terms[k] for k in ("flops", "model_flops",
                                         "hbm_bytes", "compute_s",
                                         "memory_s", "dominant")},
         roofline_prefill_seconds=roof_s,
         measured_over_roofline=out["prefill_seconds"] / roof_s,
         roofline_share=roof_s / out["prefill_seconds"],
         production_mesh={"shape": mesh.shape, "entries": mesh.size,
                          **spec_lines})
    return launches["flash_attention"]


# ---------------------------------------------------------------------------
# dryrun: every (arch x shape) on both production meshes, on the meta device
# ---------------------------------------------------------------------------

DRYRUN_RECORDS = 80             # 10 archs x 4 shapes x 2 meshes
DRYRUN_KEYS = ("arch", "shape", "mesh", "strategy", "participants", "window",
               "memory", "collectives", "roofline", "reckon_s")


def dryrun_phase(dev, served):
    """``launch.dryrun.main(["--all", "--both-meshes"])`` in this process,
    into a temporary directory. Gates: 80 complete records; the card's
    allocation and its peak (reset first) unchanged across the run, which
    builds everything on ``meta``; TinyLlama's ``prefill_32k`` record on the
    16 x 16 mesh holds the bytes a device of the serve phase's real
    full-size parameters under the same specs."""
    from repro_torch.config import H100, MeshConfig
    from repro_torch.launch import dryrun
    from repro_torch.sharding import ShardingPolicy

    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    saved = dryrun.ARTIFACT_DIR
    with tempfile.TemporaryDirectory() as tmp:
        dryrun.ARTIFACT_DIR = tmp
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as text:
                paths = dryrun.main(["--all", "--both-meshes"])
            seconds = time.perf_counter() - t0
        finally:
            dryrun.ARTIFACT_DIR = saved
        records = []
        for path in paths:
            with open(path) as fh:
                records.append(json.load(fh))
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    if len(records) != DRYRUN_RECORDS or "all dry-runs OK" not in \
            text.getvalue():
        raise AssertionError(f"{len(records)} dry-run records")
    for r in records:
        mem = r.get("memory", {})
        if any(k not in r for k in DRYRUN_KEYS) or not (
                mem.get("argument_size_in_bytes", 0) > 0
                and mem["argument_size_in_bytes"] == sum(
                    mem["by_part"].values())
                and mem.get("output_size_in_bytes", 0) > 0
                and np.isfinite(r["roofline"]["flops"])):
            raise AssertionError(f"incomplete record {r}")
    if after != before or peak != before:
        raise AssertionError(f"the dry run moved the card's allocation: "
                             f"{before} -> {after} bytes, peak {peak}")
    rec = next(r for r in records if (r["arch"], r["shape"], r["mesh"]) == (
        "tinyllama-1.1b", "prefill_32k", "16x16"))
    params = served["params"]
    policy = ShardingPolicy(served["cfg"], MeshConfig())
    real = dryrun.per_device_bytes(
        params, policy.param_spec(params, with_participants=False), policy)
    if rec["memory"]["by_part"]["params"] != real:
        raise AssertionError(f"dry-run params {rec['memory']['by_part']} "
                             f"against {real} bytes a device on the card")
    args = [r["memory"]["argument_size_in_bytes"] for r in records]
    # the model's collectives (tensor-parallel and the MoE's routing) a
    # device, by shape and mesh, with the backward's recomputation apart
    model_bytes = {
        arch: {f"{r['shape']}/{r['mesh']}": {
            "bytes": r["collectives"]["model"]["bytes"],
            "counts": r["collectives"]["model"]["counts"],
            "remat_bytes": r["collectives"]["remat"]["bytes"]}
            for r in records if r["arch"] == arch}
        for arch in ("tinyllama-1.1b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
                     "hymba-1.5b", "whisper-large-v3",
                     "llava-next-mistral-7b")}
    if not all(v["bytes"] for m in model_bytes.values()
               for v in m.values()) or any(
            "tensor-parallel collectives not reckoned"
            in r["collectives"]["reckoned"] for r in records):
        raise AssertionError(f"model collectives not reckoned: {model_bytes}")
    emit("dryrun", records=len(records), seconds=seconds,
         allocated_bytes=before, peak_bytes=peak,
         over_hbm=sum(a > H100.hbm_bytes for a in args),
         hbm_bytes=H100.hbm_bytes, max_argument_bytes=max(args),
         max_argument_record=records[int(np.argmax(args))]["arch"] + "/"
         + records[int(np.argmax(args))]["shape"] + "/"
         + records[int(np.argmax(args))]["mesh"],
         tinyllama_prefill_params_bytes=real,
         tinyllama_prefill=rec["memory"],
         model_collective_bytes_per_device=model_bytes)


# ---------------------------------------------------------------------------
# examples: the six examples' twins at the reference's defaults
# ---------------------------------------------------------------------------

EXAMPLES_DIR = Path(__file__).resolve().parent / "examples"
NON_FINITE = re.compile(r"\b(nan|inf)\b", re.I)


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES_DIR / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(what: str, fn, *args):
    """``(fn(*args), its printed lines, wall seconds)``, the card
    synchronised before and after; every number printed must be finite."""
    with contextlib.redirect_stdout(io.StringIO()) as text:
        out, wall = synced_seconds(fn, *args)
    if NON_FINITE.search(text.getvalue()):
        raise AssertionError(f"{what} printed a non-finite metric:\n"
                             f"{text.getvalue()}")
    return out, text.getvalue().splitlines(), wall


@contextlib.contextmanager
def counted_aggregations():
    """Every ``BatchedEngine.aggregate`` call while the block runs, as the
    number of models it was handed (a list the caller may clear)."""
    from repro_torch.engine.cohort import BatchedEngine

    calls = []
    inner = BatchedEngine.aggregate

    def aggregate(self, models, weights=None):
        calls.append(len(models))
        return inner(self, models, weights)

    BatchedEngine.aggregate = aggregate
    try:
        yield calls
    finally:
        BatchedEngine.aggregate = inner


def one_agg_per_aggregation(session, calls, what: str) -> int:
    """The counts since the last reset: ``fused.agg`` once per aggregation
    the engine ran (``calls``), and no other kernel. A protocol round in
    which an aggregator holds no model (FedAvg's bootstrap) is logged in
    its ``agg_log`` but aggregates nothing."""
    n_agg = len(calls)
    logged = sum(len(node.agg_log) for node in session.nodes.values())
    counts = read_counts()
    if n_agg == 0 or n_agg > logged or counts["fused.agg"] != n_agg or sum(
            counts.values()) != n_agg:
        raise AssertionError(f"{what}: launches {counts} for {n_agg} "
                             f"aggregations ({logged} logged)")
    return n_agg


def example_line(session, res, wall, n_agg, metric="accuracy"):
    return dict(wall_seconds=wall, rounds=res.rounds_completed,
                final=res.final_metrics.get(metric),
                total_bytes=res.usage["total_bytes"], aggregations=n_agg,
                logged_aggregations=sum(len(node.agg_log)
                                        for node in session.nodes.values()),
                trainings=res.trainings_completed,
                jobs=session.engine.jobs_run,
                flushes=session.engine.flushes)


# ---------------------------------------------------------------------------
# world: the port across ranks, one process a rank, on the one card
# ---------------------------------------------------------------------------

WORLD_RANKS = 4                 # the CNN session's world (N over 4 ranks)
# its simulated seconds, plain and masked (20 until W3-W5 needed the
# script's clock)
WORLD_SIM_SECONDS = 10.0
# The rounds of the families' and the granularities' worlds (W1, W2): 3
# until W3-W5 needed the script's clock. The gates whose control needs a
# third round keep 3 (WORLD_CONTROL_ROUNDS): TinyLlama's 2 x 2 round
# (mesh_train's modest run; its skipped update moves round 2's loss by
# 4.16e-4, round 3's by 5.20e-4, against 4 bounds of 4e-4), RWKV-6's fp32
# round (3.70e-4 at round 2: a third round's 1.22e-3 passes) and W4.
WORLD_TRAIN_ROUNDS = 2
WORLD_CONTROL_ROUNDS = 3
WORLD_NEW = 4                   # prefill, then 3 teacher-forced decodes
WORLD_FLASH_ROW = "world_rank"  # flash_rows' row at a rank's serve share
# The world's bf16 logits and losses against one process's: tensor
# parallelism sums each row-parallel product as two bf16-rounded halves in
# fp32, one process rounds the whole sum once. The loss bound lies between
# the sound run's largest gap (2.5e-5) and a skipped update's (5.2e-4: the
# one-process rounds at learning rate 0, read in every run and held to at
# least 4 bounds); the change bound between the sound run's 0.16 (bf16
# parameters round some updates the other way) and a skipped update's 1
# (readings on one H100: PERF.md section 6, PR 30).
WORLD_LOGITS_REL_L2 = 5e-2
WORLD_LOSS_RTOL = 1e-4
WORLD_CHANGE_REL = 0.4
# qwen3-moe across ranks (experts over model): the serve at the families
# phase's shape and depth against its one-process run, and a mesh round at
# one of its 48 layers (N = 1,245,452,288) held as TinyLlama's is. The
# prefill's logits are held to WORLD_LOGITS_REL_L2 of one process's (0.0129
# read; its bf16 prefill lies 0.0150 from its fp32 one). A decode of 4
# tokens moves by whole experts where a near tie between the k-th and next
# expert flips, in the world (0.034-0.091 read, predicted 0.02-0.04: PERF.md
# section 6, PR 31) as in one process's bf16 against fp32: so each step's
# logits are held by their distance from the fp32 logits, at most
# WORLD_MOE_ERR_RATIO times one process's bf16 distance (the control, read
# in every run), as the flash path's bf16 error is held to the plain one's.
WORLD_MOE_ERR_RATIO = 2.0
# The MoE round's losses: before any update (round 1) the world's forward
# already reads 9.8e-5 from one process's (routing flips between near-tied
# experts), and a skipped update moves the loss by as little (1.1e-4, 7e-5;
# dev31_2, PERF.md section 6, PR 31): the bound sits 5-10 times above the
# forward noise predicted, and the change sketch holds the update.
WORLD_MOE_LOSS_RTOL = 1e-3
WORLD_MOE_ARCH = "qwen3-moe-30b-a3b"
WORLD_MOE_FLASH_ROW = "world_rank_moe"
WORLD_MOE_MESH_ARGS = ["--mode", "mesh", "--arch", WORLD_MOE_ARCH,
                       "--full-size", "--set", "n_layers=1",
                       "--model-parallel", "2", "--failure-rate", "0.3",
                       "--seed", "0"]
# RWKV-6 and Hymba across ranks (heads and d_inner over model; PR 32): the
# serves at the families phase's shapes and full depth, held as the MoE's
# (the prefill within WORLD_LOGITS_REL_L2 of one process's bf16 logits;
# each step's distance from the fp32 control at most WORLD_MOE_ERR_RATIO
# times one process's bf16 distance, or WORLD_LOGITS_REL_L2 where that is
# larger), and their mesh rounds at 2 layers held as TinyLlama's: losses
# within WORLD_RECURRENT_LOSS_RTOL, to which the same rounds at learning
# rate 0 must lie at least 4 bounds away; the change sketch within
# WORLD_CHANGE_REL, alike on every rank. The bounds are set from the
# predictions (forward noise 1e-5-1e-4, a skipped update 1e-3-1e-2 at
# rounds 2-3) written before the first run (PERF.md section 6, PR 32).
WORLD_RECURRENT = ("rwkv6-1.6b", "hymba-1.5b")
WORLD_RECURRENT_LOSS_RTOL = 2.5e-4
WORLD_HYMBA_FLASH_ROW = "world_rank_hymba"
# Whisper and LLaVA across ranks (heads, d_ff and vocab over model): the
# serves at the families phase's shapes, Whisper at full depth (32 + 32
# layers) and LLaVA cut to WORLD_LLAVA_CUT (each rank draws the whole model
# before it keeps its half: four ranks at 32 layers would need about 88 GB
# of the card's 80), each against a one-process reference at the same
# depth, held as RWKV-6's and Hymba's serves are; their mesh rounds at
# MESH_FAMILIES' cuts through DistributedTrainer in a world body (the
# launcher feeds no frames or image embeddings, ROADMAP C11), held as
# the MoE's round is: losses within WORLD_MULTIMODAL_LOSS_RTOL of one
# process's same rounds (the learning-rate-0 control's gaps reported
# beside them), the change sketch within WORLD_CHANGE_REL and the
# control's past it, alike on every rank. A skipped update moves round 3's
# loss by 1.5e-3 in both families, and the world's bf16 rounding moves the
# update itself by 0.13 relative (the sketch), so a round-3 loss may move
# by 0.1-0.2 of 1.5e-3: the bound sits between that and a skipped
# update's, and the sketch holds the update (the second prediction,
# written after the first reading and before the next run: PERF.md
# section 6, Whisper and LLaVA).
WORLD_MULTIMODAL = ("whisper-large-v3", "llava-next-mistral-7b")
WORLD_LLAVA_CUT = {"n_layers": 4}     # 8 until W3-W5 needed the clock
WORLD_MULTIMODAL_LOSS_RTOL = 1e-3
WORLD_MULTIMODAL_WEIGHTS = ((1.0, 1.0), (1.0, 0.0), (1.0, 1.0))
WORLD_MULTIMODAL_FLASH_ROWS = {"whisper-large-v3": "world_rank_whisper",
                               "llava-next-mistral-7b": "world_rank_llava"}

# Participant granularities across ranks. W1: llama3-405b at
# published widths cut to 1 of its 126 layers (7.39 B parameters, 14.8 GB
# in bf16: 3.7 GB a rank), ``pod`` granularity on 2 x 2 (P = 1, FSDP over
# data, TP over model): its serve at WORLD_FSDP_SERVE held as the families'
# serves are, and 3 MoDeST rounds at SGD 0.05 with a clip at
# WORLD_FSDP_CLIP_SHARE of one process's first gradient norm (so that it
# binds and its norm spans both axes). W2: TinyLlama at published widths
# cut to 2 of 22 layers on a ``pods=2, data=2, model=1`` world, at each of
# WORLD_POD_RUNS' granularities. Each round is held against one process's
# same rounds by ``world_train``: losses within WORLD_GRAN_LOSS_RTOL (the
# MoE's and Whisper's bound: the world's bf16 sums move an update's
# rounding, so a later round's loss moves by a fraction of a skipped
# update's; the lr-0 control's gaps are reported beside), the change
# sketch within WORLD_CHANGE_REL and the control's past it, alike on every
# rank. The predictions these bounds come from stand in PERF.md section 6
# (participant granularities), written before the first run.
WORLD_FSDP_ARCH = "llama3-405b"
WORLD_FSDP_CUT = {"n_layers": 1}
WORLD_FSDP_MESH = {"data": 2, "model": 2}
WORLD_FSDP_SERVE = (4, 1024)            # B, prompt tokens
WORLD_FSDP_TRAIN = (4, 256)             # rows a participant, tokens a row
WORLD_FSDP_LR = 0.05
WORLD_FSDP_CLIP_SHARE = 0.5
WORLD_FSDP_FLASH_ROW = "world_rank_llama3_405b"
WORLD_GRAN_LOSS_RTOL = 1e-3
WORLD_POD_ARCH = "tinyllama-1.1b"
WORLD_POD_CUT = {"n_layers": 2}
WORLD_POD_MESH = {"multi_pod": True, "pods": 2, "data": 2, "model": 1}
WORLD_POD_TRAIN = (4, 64)
WORLD_POD_RUNS = (("pod", 2, 0.5), ("chip", 4, None),
                  ("data_rank", 4, None))   # granularity, P, clip share
WORLD_POD_WEIGHTS = {2: ((1.0, 1.0), (1.0, 0.0), (1.0, 1.0)),
                     4: ((1.0, 1.0, 1.0, 1.0), (1.0, 0.0, 1.0, 1.0),
                         (1.0, 1.0, 0.0, 1.0))}

# What a world refused before: caches split by sequence, kv heads the
# model axis does not divide, MoE routing groups split over data. W3:
# TinyLlama at full depth served with ``--shard-seq`` (the cache's
# sequence over data, B 1, a prompt of WORLD_SEQ_S tokens that every data
# rank prefills whole) in the 2 x 2 serve world, after its flash serve.
# W4: TinyLlama at full depth on a data=1, model=8 world (32 / 4 heads:
# the world rule kv_whole, wk / wv whole on every rank, the cache's
# sequence over model: the serving launcher rounds a world's cache length
# up to a multiple of its size, 1,036 to 1,040 here), its serve at the
# serve phase's shape and 3 mesh rounds at WORLD_KV_TRAIN's cut (P = 1,
# no failures, so every round updates), their losses within
# WORLD_LOSS_RTOL: the sound rounds' largest gap (7.9e-5) and a skipped
# update's smallest (1.69e-4) lie either side of it, and at 2 layers a
# skipped update lies under the 4 bounds the control gate asks, so the
# lr-0 control's loss gaps are reported and its change sketch holds the
# update (readings in PERF.md section 6, what a world refused). W5:
# qwen3-moe at 4 of 48 layers served at WORLD_MOE_GROUP (B, prompt) in
# the qwen3-moe serve world, each decode routing B tokens in one group,
# B / 2 a rank: 64 tokens' 8 choices over 128 experts give an expert 4
# slots on average against a capacity of 5, so the checked layer drops
# slots (``moe_group_check`` asks for a drop; at B 8, capacity 4, it
# dropped none). The prompt is a multiple of 128, so that the prefill
# runs B9, and long enough that the prefill's bf16 rounding moves few
# routes: one process's bf16 prefill logits lie 0.053 from its fp32 ones
# at 128 tokens, 0.041 at 256 and 0.015 at 1,024, and the world's are held
# within WORLD_LOGITS_REL_L2 of one process's (PERF.md section 6, what a
# world refused). Serves are held by ``held_serve``, rounds by
# ``world_train``; the predictions stand in PERF.md section 6 (what a
# world refused).
WORLD_SEQ_S = 8192
WORLD_SEQ_FLASH_ROW = "world_rank_shard_seq"
WORLD_KV_RANKS = 8
WORLD_KV_FLASH_ROW = "world_rank_kv_whole"
WORLD_KV_TRAIN = ["--mode", "mesh", "--arch", "tinyllama-1.1b",
                  "--full-size", "--set", "n_layers=2", "--devices",
                  str(WORLD_KV_RANKS), "--model-parallel",
                  str(WORLD_KV_RANKS), "--failure-rate", "0.0", "--seed",
                  "0", "--algo", "modest", "--rounds",
                  str(WORLD_CONTROL_ROUNDS)]
WORLD_MOE_GROUP = (64, 512)


def digest(t) -> str:
    """The bits of a tensor, hashed: equal digests are bit-for-bit equal
    tensors (dtype and shape included)."""
    import hashlib
    a = t.detach().contiguous().cpu()
    h = hashlib.sha256(f"{a.dtype}{tuple(a.shape)}".encode())
    h.update(a.view(torch.uint8).numpy().tobytes() if a.numel() else b"")
    return h.hexdigest()[:16]


def world_quant(task, shardings):
    """The fused aggregate→quantize of five seeded models, plain and
    masked (``tests/sharded_child.py``'s), on the card."""
    from repro_torch.engine.flat import FlatModel
    from repro_torch.kernels.ops import (aggregate_flatmodel,
                                         masked_aggregate_flatmodel)
    from repro_torch.secureagg import PairwiseMasker

    dev = task.device
    spec = task.flat_spec
    rng = np.random.default_rng(0)
    models = [FlatModel(torch.from_numpy(rng.standard_normal(spec.n).astype(
        np.float32)).to(dev), spec) for _ in range(5)]
    weights = list(rng.random(5) + 0.1)
    plain = aggregate_flatmodel(models, weights, spec=spec, quantize=True,
                                device=dev, shardings=shardings)
    masker = PairwiseMasker(0)
    roster = tuple(f"n{i}" for i in range(len(models)))
    sealed = [masker.seal(m, roster[i], 7, roster, spec.nbytes)
              for i, m in enumerate(models)]
    secrets = {nid: masker.secret(nid, 7) for nid in roster}
    seeds, signs = masker.unmask_matrices(sealed, secrets)
    masked = masked_aggregate_flatmodel(
        [sm.payload for sm in sealed], weights, seeds=seeds, signs=signs,
        spec=spec, quantize=True, device=dev, shardings=shardings)
    return [digest(t) for t in (plain[0].buffer, plain[1], plain[2])], \
        [digest(t) for t in (masked[0].buffer, masked[1], masked[2])]


def world_session_run(engine: str, secure_agg, sim_seconds: float, dev):
    """The CNN session of ``session_phase`` (or its masked twin) under
    cuDNN's deterministic algorithms on ``engine``: its trajectory and the
    digests of every aggregation, the final model and ``world_quant``."""
    import hashlib
    from repro_torch.engine import MeshEngine

    with deterministic_cudnn():
        session = cnn_session(32, 10, engine, secure_agg=secure_agg,
                              device=dev)
        eng = session.engine
        if (engine == "sharded") != isinstance(eng, MeshEngine):
            raise AssertionError(f"engine {engine!r} gave "
                                 f"{type(eng).__name__}")
        means = record_aggregations(session, masked=secure_agg is not None)
        result = session.run(sim_seconds)
        final = session._eval_models[max(session._eval_models)].buffer
        plain, masked = world_quant(session.task,
                                    getattr(eng, "shardings", None))
    return {"secure_agg": secure_agg, "rounds": result.rounds_completed,
            "total_bytes": result.usage["total_bytes"],
            "round_times": result.round_times, "history": result.history,
            "history_hash": hashlib.sha256(json.dumps(
                result.history).encode()).hexdigest()[:16],
            "aggregations": [digest(c[-1].buffer) for c in means],
            "final": digest(final), "quant": plain, "masked_quant": masked,
            "state_lanes": getattr(eng, "state_lanes", None),
            "shards": getattr(getattr(eng, "shardings", None), "n_shards",
                              None)}


def world_session_body(world, secure_aggs, sim_seconds: float):
    """One rank of the world's CNN sessions (``engine="sharded"`` inside
    the world: N over every rank); its sessions and report (launches
    counted from 0 in the rank)."""
    from repro_torch import collectives
    from repro_torch.launch.world import rank_report

    reset_counts()
    collectives.reset_counts()
    if world.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(world.device)
    t0 = time.perf_counter()
    sessions = [world_session_run("sharded", sa, sim_seconds, world.device)
                for sa in secure_aggs]
    return {"sessions": sessions,
            "report": rank_report(world, time.perf_counter() - t0)}


def world_sessions_check(ranks, refs, what: str):
    """Every rank's sessions bit for bit the batched ones ``refs``."""
    for r in ranks:
        for got, want in zip(r["sessions"], refs):
            for key in ("rounds", "total_bytes", "round_times", "history",
                        "history_hash", "aggregations", "final", "quant",
                        "masked_quant"):
                if got[key] != want[key]:
                    raise AssertionError(
                        f"{what}: rank {r['report']['rank']}'s "
                        f"{got['secure_agg']} session differs from the "
                        f"batched one in {key}")
            if got["masked_quant"] != got["quant"]:
                raise AssertionError(f"{what}: masked quantised aggregate "
                                     "differs from the plain one")


def world_chunk_rows(dev):
    """B1, B2, B4 and B5 as a rank of the world's CNN sessions launches
    them: the P = 10 rows of its lane chunk (rank 1 of WORLD_RANKS, 49,152
    lanes of N = 136,672 at lane base 49,152; B4/B5 with the global
    n_valid), each bit for bit the matching slice of one launch over the
    whole stack and within TOL of its plain version (the mean); ms
    (CUDA-graph replay), the plain version's ms on the same inputs, and
    the bound at the chunk's shape."""
    from repro_torch.kernels import fused

    P, N, r = 10, 136_672, 1
    local_n = fused.shard_align(N, WORLD_RANKS) // WORLD_RANKS
    base = r * local_n
    x, w, _ = make_inputs(P, N, 0, seed=500, dev=dev)
    seeds, signs = mask_terms(P, seed=501, dev=dev)
    y = torch.stack([fused.apply_mask_flat(x[p], seeds[p], signs[p])
                     for p in range(P)])
    xr = x[:, base:base + local_n].contiguous()
    yr = y[:, base:base + local_n].contiguous()
    kw = dict(seeds=seeds, signs=signs, base=base, n_valid=N)
    calls = {
        "fused.agg": (lambda: fused.aggregate_flat_onepass(xr, w),
                      lambda: fused._plain_onepass(xr, w)),
        "fused.agg_quant": (lambda: fused.aggregate_quantize_flat(xr, w),
                            lambda: fused._plain_onepass_quant(xr, w)),
        "fused.unmask_agg": (
            lambda: fused.unmask_aggregate_flat(yr, w, **kw),
            lambda: fused._plain_unmask_onepass(yr, w, None, seeds, signs,
                                                base, N)),
        "fused.unmask_agg_quant": (
            lambda: fused.unmask_aggregate_quantize_flat(yr, w, **kw),
            lambda: fused._plain_unmask_onepass_quant(yr, w, None, seeds,
                                                      signs, base, N))}
    mean, codes, scales = fused.aggregate_quantize_flat(x, w)
    sub = slice(base // fused.SUBTILE, (base + local_n) // fused.SUBTILE)
    want = (mean[base:base + local_n], codes[base:base + local_n],
            scales[sub])
    rows = {}
    for name, (call, plain) in calls.items():
        got = call()
        got = got if isinstance(got, tuple) else (got,)
        ref = plain()
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        for g, wnt in zip(got, want):
            if not torch.equal(g, wnt):
                raise AssertionError(f"{name} on a rank's chunk differs "
                                     "from the slice of one launch")
        err = float((got[0] - ref[0]).abs().max())
        if not torch.allclose(got[0], ref[0], rtol=TOL, atol=TOL):
            raise AssertionError(f"{name} on a rank's chunk is {err} off "
                                 "its plain version")
        t_bound, by = bound_ms(name, P, local_n,
                               P if "unmask" in name else 0, False)
        rows[name] = {"P": P, "R": P if "unmask" in name else 0,
                      "N": local_n, "base": base, "n_valid": N,
                      "ms": time_ms(call, 200),
                      "plain_ms": time_ms(plain, 5, warmup=1, replays=1),
                      "bound_ms": t_bound, "bound_by": by,
                      "max_abs_err": err,
                      "vs_one_launch": "bit-identical slice"}
    return rows


def world_train(dev, where, mesh_rounds, mesh_sketch, argv=None,
                loss_rtol=WORLD_LOSS_RTOL, loss_control=True, own=None,
                loss_rounds=None, change_control=True, run=None,
                rounds=WORLD_TRAIN_ROUNDS):
    """``launch/train.py --mode mesh --world`` at ``argv`` (None:
    ``MESH_ARGS``; MoDeST, 2 x 2, ranks on ``where``), or ``run(device,
    world, lr)`` where given (the launcher's result: ``history``,
    ``change_sketch`` and, in a world, ``ranks``), for
    ``rounds`` rounds, gated against the one-process run's rounds
    ``mesh_rounds`` (losses within ``loss_rtol``) and change sketch
    ``mesh_sketch`` (``launch.train`` on ``dev``) and against a control
    run here: the same rounds with the update skipped (learning rate 0),
    whose loss gaps must pass 4 bounds where ``loss_control`` and whose
    sketch must lie further than the bound where ``change_control``.
    Chaotic models (RWKV-6, ROADMAP C12) hold only their first
    ``loss_rounds`` losses to ``loss_rtol``; with ``own``, the ``(rounds,
    sketch)`` of a one-process run from weights moved by about one ulp
    (``nudged_init``), the later rounds and the sketch are held within
    twice that run's gaps where that is larger (C12's rule), else the
    later rounds are reported. Its part of the world line, each rank's
    report under ``ranks_report``."""
    from repro_torch.launch import train

    if run is None:
        argv = (MESH_ARGS if argv is None else argv) + [
            "--algo", "modest", "--devices", "4", "--rounds", str(rounds)]

        def run(device, world, lr=None):
            return train.main(argv + ["--device", device] + (
                ["--lr", str(lr)] if lr is not None else []) + (
                ["--world"] if world else []))

    # the control: the one-process rounds with the update skipped
    control = run(str(dev), False, 0)
    skipped, skipped_sketch = control["history"], control["change_sketch"]
    del control
    release()
    trained = run(where, True)

    def loss_gaps(hist):
        gaps = []
        for got, want in zip(hist, mesh_rounds):
            if (got["round"], got["active"]) != (want["round"],
                                                 want["active"]):
                raise AssertionError(f"world round {got} against {want}")
            gaps.append(abs(got["loss"] - want["loss"]) / abs(want["loss"]))
        if len(gaps) != rounds:
            raise AssertionError(f"{len(gaps)} rounds")
        return gaps

    gaps_train, gaps_skipped = loss_gaps(trained["history"]), \
        loss_gaps(skipped)
    sketches = [np.asarray(r["change_sketch"]) for r in trained["ranks"]]
    want = np.asarray(mesh_sketch)

    def change_gap(sketch):
        return float(np.linalg.norm(np.asarray(sketch) - want)
                     / np.linalg.norm(want))

    loss_rounds = rounds if loss_rounds is None else loss_rounds
    loss_bounds = [loss_rtol] * loss_rounds + [None] * (rounds - loss_rounds)
    change_bound = WORLD_CHANGE_REL
    line = {}
    if own is not None:
        own_gaps, own_change = loss_gaps(own[0]), change_gap(own[1])
        loss_bounds = loss_bounds[:loss_rounds] + [
            max(loss_rtol, 2 * g) for g in own_gaps[loss_rounds:]]
        change_bound = max(WORLD_CHANGE_REL, 2 * own_change)
        line = {"one_ulp_loss_rel_gaps": own_gaps,
                "one_ulp_change_rel_gap": own_change}
    line = {"world": "2 x 2", "rounds": trained["history"],
            "one_process": mesh_rounds[:rounds],
            "loss_rel_gaps": gaps_train, "loss_rel_bound": loss_rtol,
            "loss_rel_bounds": loss_bounds,
            "skipped_update_loss_rel_gaps": gaps_skipped,
            "skipped_update_change_rel_gap": change_gap(skipped_sketch),
            "change_rel_gap": change_gap(sketches[0]),
            "change_rel_bound": change_bound,
            "change_norm": float(np.linalg.norm(want)),
            "ranks_alike": all(np.array_equal(x, sketches[0])
                               for x in sketches), **line}
    # round 1 runs before any update: a skipped update shows from round 2
    if any(b is not None and g > b
           for g, b in zip(gaps_train, loss_bounds)) or (
            loss_control and max(gaps_skipped[1:]) < 4 * loss_rtol) or (
            change_control
            and line["skipped_update_change_rel_gap"] <= change_bound) or \
            line["change_rel_gap"] > change_bound or \
            not line["ranks_alike"] or \
            any(any(r["launches"].values()) for r in trained["ranks"]):
        raise AssertionError(f"the world's rounds against one process's: "
                             f"{json.dumps(line)}; ranks {trained['ranks']}")
    return dict(line, ranks_report=trained["ranks"])


@contextlib.contextmanager
def nudged_init(seed: int = 7):
    """``DistributedTrainer.init_state`` with every floating leaf moved by
    about one ulp of its dtype (times 1 +- eps, the sign drawn from
    ``seed``, alike in every replica): a one-process run under it reads a
    model's own sensitivity to rounding (ROADMAP C12's probe)."""
    from repro_torch.core.distributed import DistributedTrainer, TrainState
    from repro_torch.utils.pytree import tree_map

    real = DistributedTrainer.init_state

    def init_state(self, seed0=0):
        state = real(self, seed0)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def nudge(x):
            if not x.is_floating_point():
                return x
            sign = torch.randint(0, 2, tuple(x.shape[1:]), generator=gen,
                                 device=x.device) * 2 - 1
            eps = torch.finfo(x.dtype).eps
            return (x.double() * (1 + sign * eps)).to(x.dtype)

        return TrainState(tree_map(nudge, state.params), *state[1:])

    DistributedTrainer.init_state = init_state
    try:
        yield
    finally:
        DistributedTrainer.init_state = real


def world_moe_serve_body(world, argv, teacher, n_calls, group=None):
    """A rank of the qwen3-moe serve world: the serving launcher's own rank
    (``launch.serve._serve_rank``, what ``--world`` runs) on ``argv``, with
    the routing of its first ``n_calls`` MoE layers kept (the prefill's and
    the decodes', ``recorded_routes``); then, with ``group = (argv,
    teacher, call)``, W5's serve in the same world (``world_serves_body``'s
    counts set to 0 first), the router's input and this rank's routing at
    its MoE call ``call`` kept (``captured_route``)."""
    from repro_torch.launch import serve

    out = {}
    routes = recorded_routes(lambda: out.update(serve._serve_rank(
        world, serve.parse_args(argv), teacher)), n_calls)
    out = dict(out, routes=routes, coords=world.rank)
    if group is not None:
        g_argv, g_teacher, call = group
        release()
        out["group"] = {}
        out["group"]["route"] = captured_route(lambda: out["group"].update(
            world_serves_body(world, [(g_argv, g_teacher)])[0]), call)
    return out


def world_serves_body(world, runs):
    """A rank of a serve world that runs the serving launcher's own rank
    (``launch.serve._serve_rank``, what ``--world`` runs) once for each
    ``(argv, teacher)`` of ``runs``, one after another in one world (one
    start-up): the kernels' and the collectives' counts and the card's
    peak set to 0 before each, so each report is its own serve's."""
    from repro_torch import collectives
    from repro_torch.launch import serve

    outs = []
    for argv, teacher in runs:
        release()
        reset_counts()
        collectives.reset_counts()
        if world.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(world.device)
        outs.append(serve._serve_rank(world, serve.parse_args(argv),
                                      teacher))
    return outs


def captured_route(run, call: int):
    """``run()`` with ``models.moe.routing`` wrapped to keep, of its call
    number ``call``, the router's input (this rank's layout of the groups
    its tokens touch), the router, the slots' ``pos``, ``keep`` and
    ``every_keep`` and the rank's place in the groups (``span``: None where
    its tokens route alone), on the CPU; the port's function is put back
    after."""
    from repro_torch.models import moe

    real, seen, kept = moe.routing, [0], {}

    def capture(p, cfg, xg, *span):
        r = real(p, cfg, xg, *span)
        if seen[0] == call:
            sp = span[0] if span else None
            kept.update(
                x=xg.cpu(), router=p["router"].cpu(), pos=r["pos"].cpu(),
                keep=r["keep"].cpu(), every_keep=None if sp is None
                else r["every_keep"].cpu(),
                C=r["C"], span=None if sp is None else {
                    "off": sp.off, "t": sp.t, "G": sp.G, "N": sp.N,
                    "g0": sp.g0})
        seen[0] += 1
        return r

    moe.routing = capture
    try:
        run()
    finally:
        moe.routing = real
    return kept


def world_moe(dev, where, moe_ref, group_ref):
    """qwen3-moe across ranks on 2 x 2 worlds whose ranks share the card:
    ``world_moe_serve`` (W5 in its world), then ``world_moe_train``."""
    serve_line = world_moe_serve(where, moe_ref, group_ref)
    release()
    return {"serve": serve_line, "train": world_moe_train(dev, where)}


def world_moe_serve(where, moe_ref, group_ref):
    """qwen3-moe's serve across ranks (experts over ``model``):

    * ``launch/serve.py --full-size --set n_layers=4 --set use_flash=true
      --world`` at the families phase's shape and seed (its ranks run the
      launcher's own rank function, ``world_moe_serve_body``), decodes
      teacher-forced on the families phase's greedy tokens, against the
      one-process reference ``moe_ref`` (``world_reference``: bf16, and
      fp32 as the control). Gates: the prefill's logits within
      WORLD_LOGITS_REL_L2 of one process's bf16 ones; at every step the
      world's distance from the fp32 logits at most WORLD_MOE_ERR_RATIO
      times one process's bf16 distance (or WORLD_LOGITS_REL_L2, where
      that is larger): a decode of 4 tokens moves by whole experts where a
      near tie flips, in one process's bf16 as in the world; each rank
      launches ``flash_attention`` once a layer, on its 2 rows and 16 / 2
      heads, and nothing else. Reported: the shares of (token, choice)
      slots routed to another expert than one process's bf16 run (and
      than its fp32 run), by step.
    * W5, in the same world: the same launcher at ``--batch``
      WORLD_MOE_GROUP[0] and a prompt of WORLD_MOE_GROUP[1] tokens, whose
      decodes route B tokens in one group of capacity 4 split B / 2 a
      rank (``models.moe.routing`` with a span), held by ``held_serve``
      against ``group_ref``; and exactly: the first decode's first MoE
      layer, each rank's ``pos`` and ``keep`` at its own slots bit for
      bit one process's routing of that layer's whole router input, the
      ranks' own rows put together, where one process drops slots
      (``moe_group_check``).
    """
    from repro_torch.launch.world import run_world

    arch, over, B, S, n_attn = next(m for m in FAMILY_MODELS
                                    if m[0] == WORLD_MOE_ARCH)
    L = over["n_layers"]
    argv = ["--arch", arch, "--full-size", "--devices", "4",
            "--model-parallel", "2", "--set", "use_flash=true", "--batch",
            str(B), "--prompt-len", str(S), "--new-tokens", str(WORLD_NEW),
            "--seed", "0", "--device", where]
    argv += [a for k, v in over.items() for a in ("--set", f"{k}={v}")]
    teacher = moe_ref["tokens"][:, :WORLD_NEW - 1].numpy()
    gB, gS = WORLD_MOE_GROUP
    g_argv = list(argv)
    g_argv[g_argv.index("--batch") + 1] = str(gB)
    g_argv[g_argv.index("--prompt-len") + 1] = str(gS)
    g_teacher = group_ref["tokens"][:, :WORLD_NEW - 1].numpy()
    t0 = time.perf_counter()
    ranks = run_world(world_moe_serve_body, 4, device=where,
                      args=(argv, teacher, L * WORLD_NEW,
                            (g_argv, g_teacher, L)), timeout=600.0)
    t_serve = time.perf_counter() - t0
    served = ranks[0]
    one, exact = moe_ref["bfloat16"], moe_ref["float32"]
    steps = served["step_logits"]
    gaps = [rel_l2(g, w) for g, w in zip(steps, one["step_logits"])]
    world_err = [rel_l2(g, w) for g, w in zip(steps, exact["step_logits"])]
    one_err = [rel_l2(g, w) for g, w in zip(one["step_logits"],
                                            exact["step_logits"])]
    bounds = [max(WORLD_MOE_ERR_RATIO * e, WORLD_LOGITS_REL_L2)
              for e in one_err]
    for r in ranks:
        fl = r["report"]["launches"]["flash_attention"]
        if fl != n_attn or sum(r["report"]["launches"].values()) != fl:
            raise AssertionError(f"moe serve rank {r['coords']} launched "
                                 f"{r['report']['launches']}, want {n_attn}"
                                 " flash only")
    # every step's routes, tokens in batch order: model rank 0 of each
    # data rank holds its rows' (every model rank routes alike)
    world_routes = [torch.cat([r["routes"][i] for r in ranks
                               if r["coords"] % 2 == 0])
                    for i in range(L * WORLD_NEW)]

    def flip_shares(xs, ys):
        """The share of (token, choice) slots whose experts differ, by
        step (the mean over its L layers)."""
        if [x.shape for x in xs] != [y.shape for y in ys]:
            raise AssertionError("moe routes of another shape")
        by_call = [float((x != y).float().mean()) for x, y in zip(xs, ys)]
        return [float(np.mean(by_call[i * L:(i + 1) * L]))
                for i in range(WORLD_NEW)]

    serve_line = {
        "world": "2 x 2", "arch": arch, "depth_cut": over, "batch": B,
        "prompt_len": S, "step_rel_l2": gaps,
        "prefill_rel_l2_bound": WORLD_LOGITS_REL_L2,
        "world_vs_fp32_rel_l2": world_err,
        "one_process_bf16_vs_fp32_rel_l2": one_err,
        "vs_fp32_bounds": bounds, "err_ratio_bound": WORLD_MOE_ERR_RATIO,
        "routing_flip_share_by_step": flip_shares(world_routes,
                                                  one["routes"]),
        "routing_flip_share_vs_fp32_by_step": flip_shares(world_routes,
                                                          exact["routes"]),
        "one_process_bf16_vs_fp32_flip_share_by_step": flip_shares(
            one["routes"], exact["routes"]),
        "tokens_equal": bool(np.array_equal(
            served["tokens"], moe_ref["tokens"][:, :WORLD_NEW].numpy())),
        "prefill_seconds": served["prefill_seconds"],
        "decode_seconds": served["decode_seconds"],
        "world_seconds": t_serve,
        "ranks_report": [r["report"] for r in ranks]}
    if len(gaps) != WORLD_NEW or gaps[0] > WORLD_LOGITS_REL_L2 or any(
            e > b for e, b in zip(world_err, bounds)):
        raise AssertionError(f"moe world logits: {json.dumps(serve_line)}")
    group = dict(ranks[0]["group"], ranks=[r["group"]["report"]
                                           for r in ranks])
    serve_line["groups_split"] = dict(
        held_serve(arch, group, group_ref, n_attn, t_serve, "2 x 2", gB, gS,
                   over),
        route=moe_group_check([r["group"]["route"] for r in ranks],
                              [r["coords"] for r in ranks], over, where))
    return serve_line


def moe_group_check(routes, coords, over, dev):
    """W5's exact check: one MoE layer's routing in a world whose ranks
    split its routing group over ``data`` (``captured_route`` of each
    rank, on a 2 x 2 world: ``coords`` the ranks' flat indices) against
    one process's routing (``models.moe.routing``, on ``dev``) of the
    whole router input, put together from the ranks' own rows (model rank
    0 of each data rank): each rank's ``pos`` and ``keep`` at its own
    slots, and its ``every_keep`` at every slot of the group, bit for bit;
    one process drops at least one slot there (else the check could not
    see a fault in how the ranks compute ``keep``). Reported: the slots
    one process keeps and drops there."""
    from repro_torch.models import moe

    cfg = family_config(WORLD_MOE_ARCH, over)
    k = cfg.moe_top_k
    own = [r for r, c in zip(routes, coords) if c % 2 == 0]
    if any(r["span"] is None for r in routes):
        raise AssertionError("a W5 rank routed its tokens alone: "
                             f"{[r['span'] for r in routes]}")
    x = torch.cat([r["x"].reshape(-1, r["x"].shape[-1])[
        r["span"]["off"]:r["span"]["off"] + r["span"]["t"]] for r in own])
    G = routes[0]["span"]["G"]
    whole = moe.routing({"router": routes[0]["router"].to(dev)}, cfg,
                        x.reshape(-1, G, x.shape[-1]).to(dev))
    want_pos, want_keep = whole["pos"].cpu(), whole["keep"].cpu()
    equal = []
    for r, c in zip(routes, coords):
        sp, d = r["span"], c // 2
        a, lo, t = d * sp["t"], sp["off"], sp["t"]
        mine = slice(lo * k, (lo + t) * k)
        theirs = slice(a * k, (a + t) * k)
        equal.append(
            torch.equal(r["pos"].reshape(-1)[mine],
                        want_pos.reshape(-1)[theirs])
            and torch.equal(r["keep"].reshape(-1)[mine],
                            want_keep.reshape(-1)[theirs])
            and torch.equal(r["every_keep"].reshape(-1),
                            want_keep.reshape(-1)[
                                sp["g0"] * G * k:(sp["g0"] + 1) * G * k]))
    line = {"tokens": int(x.shape[0]), "group": G, "capacity": whole["C"],
            "top_k": k, "slots": int(want_keep.numel()),
            "kept": int(want_keep.sum()),
            "dropped": int(want_keep.numel() - want_keep.sum()),
            "ranks_equal_bit_for_bit": equal}
    if not all(equal) or len(equal) != 4 or line["dropped"] == 0:
        raise AssertionError(f"W5 routing off one process's, or no slot "
                             f"dropped: {line}")
    return line


def world_moe_train(dev, where):
    """``launch/train.py --mode mesh --full-size --set n_layers=1 --world``
    of qwen3-moe (MoDeST, P = 2, TP 2; 3 rounds), held by ``world_train``
    against the same rounds in one process here: its change sketch within
    WORLD_CHANGE_REL and alike on every rank, no kernel launched, the
    losses within WORLD_MOE_LOSS_RTOL. The control at learning rate 0 is
    read too; its loss gaps are reported and not required to pass 4
    bounds: a skipped update moves the MoE's loss by about its forward
    noise across ranks (routing flips), so here the sketch, which the
    control puts 1 away, is what sees a skipped update."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    one = train.main(WORLD_MOE_MESH_ARGS + [
        "--algo", "modest", "--devices", "4", "--rounds",
        str(WORLD_TRAIN_ROUNDS), "--device", str(dev)])
    rounds, sketch = one["history"], one["change_sketch"]
    del one
    release()
    trained = world_train(dev, where, rounds, sketch, WORLD_MOE_MESH_ARGS,
                          loss_rtol=WORLD_MOE_LOSS_RTOL, loss_control=False)
    return dict(trained, arch=WORLD_MOE_ARCH, depth_cut={"n_layers": 1},
                world_seconds=time.perf_counter() - t0)


def world_recurrent(dev, where, arch, ref):
    """RWKV-6 or Hymba across ranks on 2 x 2 worlds whose ranks share the
    card: ``world_family_serve``, then ``world_recurrent_train``."""
    serve_line = world_family_serve(where, arch, ref)
    release()
    return {"serve": serve_line, "train": world_recurrent_train(dev, where,
                                                                 arch)}


def world_family_serve(where, arch, ref, over=None, n_attn=None,
                       shape=None):
    """``launch/serve.py --full-size --world`` of RWKV-6, Hymba, Whisper or
    LLaVA (those with attention with ``--set use_flash=true``) at the
    families phase's shape and seed, at full depth or cut to ``over`` with
    ``n_attn`` attention layers, decodes teacher-forced on its greedy
    tokens, against the
    one-process reference ``ref`` (``world_reference``: bf16, and fp32 as
    the control). Gates: at every step the world's distance from the fp32
    logits at most WORLD_MOE_ERR_RATIO times one process's bf16 distance
    (or WORLD_LOGITS_REL_L2 where that is larger); the prefill's logits
    within WORLD_LOGITS_REL_L2 of one process's bf16 ones, or within one
    process's own bf16 distance from fp32 where that is larger (RWKV-6's
    bf16 prefill lies 0.30 from its fp32 one at 24 layers: ROADMAP C12);
    a Hymba rank launches ``flash_attention`` once a layer, on its 2 rows
    and every head, a Whisper or LLaVA rank once a (decoder) self-attention
    layer, on its 2 rows and half the heads, an RWKV-6 rank no kernel, and
    nothing else. ``shape``: ``(B, S)`` of an arch the families phase does
    not serve (llama3-405b), with ``over`` and ``n_attn``."""
    from repro_torch.launch import serve

    if shape is None:
        _, whole, B, S, n_whole = next(m for m in FAMILY_MODELS
                                       if m[0] == arch)
        over = whole if over is None else over
        n_attn = n_whole if n_attn is None else n_attn
    else:
        B, S = shape
    argv = ["--arch", arch, "--full-size", "--devices", "4",
            "--model-parallel", "2", "--batch", str(B), "--prompt-len",
            str(S), "--new-tokens", str(WORLD_NEW), "--seed", "0",
            "--device", where, "--world"]
    argv += ["--set", "use_flash=true"] if n_attn else []
    argv += [a for k, v in over.items() for a in ("--set", f"{k}={v}")]
    teacher = ref["tokens"][:, :WORLD_NEW - 1].numpy()
    t0 = time.perf_counter()
    served = serve.main(argv, teacher=teacher)
    return held_serve(arch, served, ref, n_attn, time.perf_counter() - t0,
                      "2 x 2", B, S, over)


def held_serve(arch, served, ref, n_attn, t_serve, world, B, S, over=None,
               seq_axis=None):
    """A serve world's result ``served`` (``launch/serve.py --world``'s:
    rank 0's ``step_logits`` and every rank's report under ``ranks``),
    teacher-forced on ``ref``'s tokens, held against the one-process
    reference ``ref`` (``world_reference``: bf16, and fp32 as the
    control). Gates: at every step the world's distance from the fp32
    logits at most WORLD_MOE_ERR_RATIO times one process's bf16 distance
    (or WORLD_LOGITS_REL_L2 where that is larger); the prefill's logits
    within WORLD_LOGITS_REL_L2 of one process's bf16 ones, or within one
    process's own bf16 distance from fp32 where that is larger; every rank
    launches ``flash_attention`` ``n_attn`` times and nothing else, and
    served a cache whose sequence its spec splits over ``seq_axis`` (None:
    whole; the rank report's ``seq_axes``); the logits finite. Returns its
    line."""
    one, exact = ref["bfloat16"], ref["float32"]
    steps = served["step_logits"]
    gaps = [rel_l2(g, w) for g, w in zip(steps, one["step_logits"])]
    world_err = [rel_l2(g, w) for g, w in zip(steps, exact["step_logits"])]
    one_err = [rel_l2(g, w) for g, w in zip(one["step_logits"],
                                            exact["step_logits"])]
    bounds = [max(WORLD_MOE_ERR_RATIO * e, WORLD_LOGITS_REL_L2)
              for e in one_err]
    prefill_bound = max(WORLD_LOGITS_REL_L2, one_err[0])
    for r in served["ranks"]:
        if r["launches"].get("flash_attention", 0) != n_attn or sum(
                r["launches"].values()) != n_attn:
            raise AssertionError(f"{arch} serve rank {r['rank']} launched "
                                 f"{r['launches']}, want {n_attn} flash "
                                 "and nothing else")
        if r["seq_axes"]["k"] != seq_axis:
            raise AssertionError(f"{arch} serve rank {r['rank']} split its "
                                 f"cache's sequence over {r['seq_axes']}, "
                                 f"want {seq_axis}")
    line = {
        "world": world, "arch": arch, "depth_cut": over or None,
        "batch": B, "prompt_len": S, "cache_seq_axis": seq_axis,
        "step_rel_l2": gaps, "prefill_rel_l2_bound": prefill_bound,
        "world_vs_fp32_rel_l2": world_err,
        "one_process_bf16_vs_fp32_rel_l2": one_err,
        "vs_fp32_bounds": bounds, "err_ratio_bound": WORLD_MOE_ERR_RATIO,
        "tokens_equal": bool(np.array_equal(
            served["tokens"], ref["tokens"][:, :WORLD_NEW].numpy())),
        "prefill_seconds": served["prefill_seconds"],
        "decode_seconds": served["decode_seconds"],
        "world_seconds": t_serve, "ranks_report": served["ranks"]}
    if len(gaps) != WORLD_NEW or gaps[0] > prefill_bound or any(
            e > b for e, b in zip(world_err, bounds)) or not all(
            torch.isfinite(g).all() for g in steps):
        raise AssertionError(f"{arch} world logits: {json.dumps(line)}")
    return line


def world_recurrent_train(dev, where, arch):
    """``launch/train.py --mode mesh --full-size --set n_layers=2
    --world`` of RWKV-6 or Hymba (MoDeST, P = 2, TP 2; 3 rounds), held by
    ``world_train`` against the same rounds in one process here, its
    change sketch alike on every rank, no kernel launched:

    * Hymba: losses within WORLD_RECURRENT_LOSS_RTOL, the change sketch
      within WORLD_CHANGE_REL; the learning-rate-0 control's sketch lies
      past the bound (its loss gaps are reported: a skipped update moves
      Hymba's loss by about the world's forward noise at this scale);
    * RWKV-6 (ROADMAP C12: the per-head norm of a near-zero first output
      amplifies rounding). In bf16 an ulp's move of one process's weights
      moves its update as far as skipping it does, so round 1 (before any
      update) is held to WORLD_RECURRENT_LOSS_RTOL and the later rounds
      and the sketch within twice a one-process run from weights moved by
      about one bf16 ulp (``nudged_init``). The update is held in fp32
      (``--set param_dtype=float32``): rounds 1-2 within WORLD_LOSS_RTOL,
      the lr-0 control past 4 bounds, the sketch within WORLD_CHANGE_REL
      and the control's past it; round 3, two chaotic updates on, is
      reported."""
    from repro_torch.launch import train

    argv = ["--mode", "mesh", "--arch", arch, "--full-size", "--set",
            "n_layers=2", "--model-parallel", "2", "--failure-rate", "0.3",
            "--seed", "0"]
    one_argv = ["--algo", "modest", "--devices", "4", "--device", str(dev)]

    def one_process(args, rounds=WORLD_TRAIN_ROUNDS):
        out = train.main(args + one_argv + ["--rounds", str(rounds)])
        rounds, sketch = out["history"], out["change_sketch"]
        del out
        release()
        return rounds, sketch

    t0 = time.perf_counter()
    rounds, sketch = one_process(argv)
    if arch != "rwkv6-1.6b":
        trained = world_train(dev, where, rounds, sketch, argv,
                              loss_rtol=WORLD_RECURRENT_LOSS_RTOL,
                              loss_control=False)
        return dict(trained, arch=arch, depth_cut={"n_layers": 2},
                    world_seconds=time.perf_counter() - t0)
    with nudged_init():
        own = one_process(argv)
    trained = world_train(dev, where, rounds, sketch, argv,
                          loss_rtol=WORLD_RECURRENT_LOSS_RTOL,
                          loss_control=False, own=own, loss_rounds=1,
                          change_control=False)
    t1 = time.perf_counter()
    argv32 = argv + ["--set", "param_dtype=float32"]
    rounds32, sketch32 = one_process(argv32, WORLD_CONTROL_ROUNDS)
    fp32 = world_train(dev, where, rounds32, sketch32, argv32, loss_rounds=2,
                       rounds=WORLD_CONTROL_ROUNDS)
    return dict(trained, arch=arch, depth_cut={"n_layers": 2},
                world_seconds=t1 - t0,
                fp32=dict(fp32, world_seconds=time.perf_counter() - t1))


def world_cut_reference(dev, arch, over, B, S_text):
    """``world_reference`` of ``arch`` cut to ``over`` (a serve world run
    at a depth cut), at the families phase's seed and batch, teacher-forced
    on its own greedy tokens (a prefill, then WORLD_NEW - 1 decodes)."""
    from repro_torch.core.distributed import Server

    cfg = family_config(arch, over)
    server = Server(cfg, device=dev)
    params = server.model.init(torch.Generator(device=dev).manual_seed(0),
                               dev)
    batch = family_batch(cfg, B, S_text, 0, dev)
    cache = server.model.init_cache(
        B, image_positions(cfg) + S_text + WORLD_NEW + 8, dev)
    logits, cache = server.prefill(params, batch, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    generated = [tok]
    for _ in range(WORLD_NEW - 1):
        logits, cache = server.decode(params, tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        generated.append(tok)
    gen = torch.cat(generated, dim=1)
    del cache, logits
    ref = dict(world_reference(cfg, params, batch, gen[:, :WORLD_NEW - 1],
                               dev), tokens=gen.cpu())
    del params, server, batch
    release()
    return ref


def family_mesh_rounds(arch, over, B, T, device, lr=None):
    """The mesh launcher's MoDeST rounds for a family whose batch carries
    the stubbed frontend input, which ``launch/train.py`` does not feed
    (ROADMAP C11): ``DistributedTrainer`` at P = 2, TP 2 on a 2 x 2 mesh
    (the world's inside one, else one naming ``device`` four times), from
    ``init_state(0)``, WORLD_TRAIN_ROUNDS rounds of
    WORLD_MULTIMODAL_WEIGHTS, each on ``family_train_batch`` seeded by the
    round (``B`` rows a participant, ``T`` tokens a row), SGD at ``lr``
    (None: the launcher's 0.05). Returns the launcher's ``history`` and
    ``change_sketch``."""
    from repro_torch import configs
    from repro_torch.config import MeshConfig, TrainConfig
    from repro_torch.core.distributed import DistributedTrainer
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = configs.get_config(arch).with_(**over)
    mesh_cfg = MeshConfig(data=2, model=2)
    trainer = DistributedTrainer(
        cfg, TrainConfig(optimizer="sgd", lr=0.05 if lr is None else lr),
        mesh_cfg, strategy="modest",
        mesh=make_mesh_from_config(mesh_cfg, device), device=device)
    P = trainer.policy.n_participants
    state = trainer.init_state(0)
    start = trainer.param_sketch(state)
    step = trainer.jit_train_step()
    history = []
    for r, w in enumerate(WORLD_MULTIMODAL_WEIGHTS[:WORLD_TRAIN_ROUNDS], 1):
        batch, _ = family_train_batch(cfg, P, B, T, r, device)
        state, metrics = step(state, batch, torch.tensor(w, device=device))
        history.append({"round": r, "active": int(sum(w)),
                        "loss": float(metrics["loss"])})
    sketch = trainer.param_sketch(state) - start
    del state, trainer, step
    return {"history": history, "change_sketch": sketch}


def world_family_train_body(world, arch, over, B, T, lr):
    """A rank of ``family_mesh_rounds``' world: its rounds and its report
    (``launch.world.rank_report``, the history and change sketch
    added)."""
    from repro_torch.launch.world import rank_report

    t0 = time.perf_counter()
    out = family_mesh_rounds(arch, over, B, T, world.device, lr)
    report = rank_report(world, time.perf_counter() - t0)
    report["history"] = out["history"]
    report["change_sketch"] = out["change_sketch"].tolist()
    return report


def world_multimodal(dev, where, arch, ref):
    """Whisper or LLaVA across ranks on 2 x 2 worlds whose ranks share the
    card: ``world_family_serve`` (Whisper at full depth; LLaVA cut to
    WORLD_LLAVA_CUT against ``world_cut_reference``), then the mesh round
    at MESH_FAMILIES' cut (``world_multimodal_train``)."""
    t0 = time.perf_counter()
    _, _, B, S, n_attn = next(m for m in FAMILY_MODELS if m[0] == arch)
    if arch == "llava-next-mistral-7b":
        ref = world_cut_reference(dev, arch, WORLD_LLAVA_CUT, B, S)
        serve_line = world_family_serve(
            where, arch, ref, over=WORLD_LLAVA_CUT,
            n_attn=WORLD_LLAVA_CUT["n_layers"])
    else:
        serve_line = world_family_serve(where, arch, ref)
    serve_line["world_seconds_with_reference"] = time.perf_counter() - t0
    release()
    return {"serve": serve_line, "train": world_multimodal_train(dev, where,
                                                                 arch)}


def world_multimodal_train(dev, where, arch):
    """Whisper's or LLaVA's mesh round at MESH_FAMILIES' cut,
    ``family_mesh_rounds`` in one process and in a 2 x 2 world whose ranks
    share the card, held by ``world_train`` (the constants above
    WORLD_MULTIMODAL)."""
    from repro_torch.launch.world import run_world

    _, over, B_train, T = next(m for m in MESH_FAMILIES if m[0] == arch)

    def run(device, world, lr=None):
        if not world:
            return family_mesh_rounds(arch, over, B_train, T,
                                      torch.device(device), lr)
        ranks = run_world(world_family_train_body, 4, device=device,
                          args=(arch, over, B_train, T, lr), timeout=600.0)
        return {"history": ranks[0]["history"], "ranks": ranks}

    t1 = time.perf_counter()
    one = run(str(dev), False)
    release()
    trained = world_train(dev, where, one["history"], one["change_sketch"],
                          loss_rtol=WORLD_MULTIMODAL_LOSS_RTOL,
                          loss_control=False, run=run)
    return dict(trained, arch=arch, depth_cut=over,
                world_seconds=time.perf_counter() - t1)


@contextlib.contextmanager
def ranks_alloc_conf(conf: str = "expandable_segments:True"):
    """``PYTORCH_CUDA_ALLOC_CONF`` for the ranks of the worlds started
    inside (a spawned rank reads it when it starts; this process's
    allocator is set already): W1's four ranks hold most of the card, and
    segments that grow in place keep the blocks freed by one layer's
    gathers usable for the next."""
    key = "PYTORCH_CUDA_ALLOC_CONF"
    prev = os.environ.get(key)
    os.environ[key] = conf
    try:
        yield
    finally:
        if prev is None:
            del os.environ[key]
        else:
            os.environ[key] = prev


def world_fsdp_serve(dev, where):
    """W1's serve: llama3-405b at published widths cut to WORLD_FSDP_CUT
    (1 of 126 layers), ``pod`` granularity (P = 1, FSDP over ``data``,
    TP over ``model``), through ``launch/serve.py --full-size --world`` on
    2 x 2 at WORLD_FSDP_SERVE, flash on, a prefill and WORLD_NEW - 1
    decodes teacher-forced on a one-process run's greedy tokens. The
    one-process reference (``world_cut_reference``: bf16, and fp32 as the
    control) runs first and gives the card back before the world starts.
    Gates as ``world_family_serve``'s: one B9 a rank a prefill (B 2, 64 /
    4 heads) and nothing else."""
    B, S = WORLD_FSDP_SERVE
    t0 = time.perf_counter()
    ref = world_cut_reference(dev, WORLD_FSDP_ARCH, WORLD_FSDP_CUT, B, S)
    t_ref = time.perf_counter() - t0
    with ranks_alloc_conf():
        line = world_family_serve(where, WORLD_FSDP_ARCH, ref,
                                  over=WORLD_FSDP_CUT,
                                  n_attn=WORLD_FSDP_CUT["n_layers"],
                                  shape=(B, S))
    return dict(line, reference_seconds=t_ref,
                published_layers=126, granularity="pod")


def gran_batch(cfg, P, B, T, seed, dev):
    """A granularity round's batch: tokens and labels ``(P, 1, B, T)``
    from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, (P, 1, B, T)),
                               device=dev) for k in ("tokens", "labels")}


def gran_trainer(arch, over, mesh_kw, device, lr, clip):
    """``DistributedTrainer`` of ``arch`` at published widths cut to
    ``over`` (its participant granularity among the keys) on
    ``MeshConfig(**mesh_kw)``: the world's mesh inside one, else one naming
    ``device``; MoDeST, SGD at ``lr`` with a clip of ``clip``."""
    from repro_torch import configs
    from repro_torch.config import MeshConfig, TrainConfig
    from repro_torch.core.distributed import DistributedTrainer
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = configs.get_config(arch).with_(**over)
    mesh_cfg = MeshConfig(**mesh_kw)
    return DistributedTrainer(
        cfg, TrainConfig(optimizer="sgd", lr=lr, grad_clip=clip), mesh_cfg,
        strategy="modest", mesh=make_mesh_from_config(mesh_cfg, device),
        device=device)


def gran_first_norm(arch, over, mesh_kw, B, T, device) -> float:
    """The global norm of the first participant's gradient at round 1's
    batch from ``init_state(0)``, in one process (the clip of a round
    that must bind is set below it)."""
    from repro_torch.utils.pytree import tree_leaves

    trainer = gran_trainer(arch, over, mesh_kw, device, 0.0, 0.0)
    state = trainer.init_state(0)
    batch = gran_batch(trainer.cfg, trainer.policy.n_participants, B, T, 1,
                       device)
    _, grads = trainer.grads(state, batch)
    norm = float(torch.sqrt(sum(torch.sum(g[0].double() ** 2)
                                for g in tree_leaves(grads))))
    del state, grads, trainer
    release()
    return norm


def gran_rounds(arch, over, mesh_kw, B, T, device, lr, clip, weights):
    """``gran_trainer``'s WORLD_TRAIN_ROUNDS rounds of ``weights`` from
    ``init_state(0)``, each on ``gran_batch`` seeded by the round (``B``
    rows a participant, ``T`` tokens a row). Returns the launcher's
    ``history`` and ``change_sketch``."""
    trainer = gran_trainer(arch, over, mesh_kw, device, lr, clip)
    P = trainer.policy.n_participants
    state = trainer.init_state(0)
    start = trainer.param_sketch(state)
    step = trainer.jit_train_step()
    history = []
    for r, w in enumerate(weights[:WORLD_TRAIN_ROUNDS], 1):
        batch = gran_batch(trainer.cfg, P, B, T, r, device)
        state, metrics = step(state, batch, torch.tensor(w, device=device))
        history.append({"round": r, "active": int(sum(w)),
                        "loss": float(metrics["loss"])})
    sketch = trainer.param_sketch(state) - start
    del state, trainer, step
    return {"history": history, "change_sketch": sketch}


def world_gran_train_body(world, arch, over, mesh_kw, B, T, lr, clip,
                          weights):
    """A rank of ``gran_rounds``' world: its rounds and its report
    (``launch.world.rank_report``, the history and change sketch
    added)."""
    from repro_torch.launch.world import rank_report

    t0 = time.perf_counter()
    out = gran_rounds(arch, over, mesh_kw, B, T, world.device, lr, clip,
                      weights)
    report = rank_report(world, time.perf_counter() - t0)
    report["history"] = out["history"]
    report["change_sketch"] = out["change_sketch"].tolist()
    return report


def world_gran_runs_body(world, runs):
    """A rank of the granularities' one world: ``world_gran_train_body``
    of each of ``runs`` in turn, the collectives' counts and the peak set
    to 0 and the card's cache given back before each."""
    from repro_torch import collectives

    out = []
    for args in runs:
        collectives.reset_counts()
        if world.device.type == "cuda":
            release()
            torch.cuda.reset_peak_memory_stats(world.device)
        out.append(world_gran_train_body(world, *args))
    return out


def gran_clip(arch, over, mesh_kw, shape, clip_share, dev):
    """``(first gradient norm, clip)``: the clip at ``clip_share`` of one
    process's first gradient norm (``gran_first_norm``), so that it binds;
    ``(None, 0.0)`` without a share."""
    if clip_share is None:
        return None, 0.0
    norm = gran_first_norm(arch, over, mesh_kw, *shape, dev)
    return norm, clip_share * norm


def world_gran_train(dev, where, arch, over, mesh_kw, shape, weights,
                     world_ranks, clip=0.0, lr=WORLD_FSDP_LR,
                     loss_rtol=WORLD_GRAN_LOSS_RTOL):
    """A granularity round (``gran_rounds``) that a world of
    ``MeshConfig(**mesh_kw)`` whose ranks share the card ran already (its
    rank reports ``world_ranks``), held by ``world_train`` against the
    same rounds in one process here (losses within ``loss_rtol``, the
    learning-rate-0 control's gaps reported beside; the change sketch
    within WORLD_CHANGE_REL, the control's past it; alike on every
    rank)."""
    from repro_torch.config import MeshConfig

    B, T = shape
    t0 = time.perf_counter()

    def run(device, world, lr_=None):
        if world:
            return {"history": world_ranks[0]["history"],
                    "ranks": world_ranks}
        return gran_rounds(arch, over, mesh_kw, B, T, torch.device(device),
                           lr if lr_ is None else lr_, clip, weights)

    one = run(str(dev), False)
    release()
    trained = world_train(dev, where, one["history"], one["change_sketch"],
                          loss_rtol=loss_rtol, loss_control=False, run=run)
    return dict(trained, world=" x ".join(map(str, MeshConfig(
        **mesh_kw).shape)), arch=arch, depth_cut=over, mesh=mesh_kw,
        batch=B, tokens=T, grad_clip=clip or None,
        seconds_with_one_process=time.perf_counter() - t0)


def world_granularities(dev, where):
    """W1 and W2: llama3-405b at ``pod`` granularity on 2 x 2 (FSDP over
    ``data``, TP over ``model``; ``world_fsdp_serve``, then its round with
    a clip that binds), and TinyLlama at published widths cut to
    WORLD_POD_CUT on a ``pods=2, data=2, model=1`` world, at each of
    WORLD_POD_RUNS' granularities (``pod``: P 2 over ``pod``, FSDP over
    ``data``, with a clip that binds; ``chip``: P 4; ``data_rank``: P 4
    over ``("pod", "data")``)."""
    from repro_torch.launch.world import run_world

    t0 = time.perf_counter()
    serve_line = world_fsdp_serve(dev, where)
    serve_line["world_seconds_with_reference"] = time.perf_counter() - t0
    release()
    # the rounds' clips, from one process's first gradients; then W1's
    # round and W2's three in one world; then each held against its
    # one-process rounds
    t1 = time.perf_counter()
    runs = [("fsdp", WORLD_FSDP_ARCH, WORLD_FSDP_CUT, WORLD_FSDP_MESH,
             WORLD_FSDP_TRAIN, WORLD_FSDP_CLIP_SHARE,
             [[1.0]] * WORLD_TRAIN_ROUNDS)]
    for gran, P, clip_share in WORLD_POD_RUNS:
        runs.append((gran, WORLD_POD_ARCH,
                     dict(WORLD_POD_CUT, participant_granularity=gran),
                     WORLD_POD_MESH, WORLD_POD_TRAIN, clip_share,
                     WORLD_POD_WEIGHTS[P]))
    clips = [gran_clip(arch, over, mesh_kw, shape, share, dev)
             for _, arch, over, mesh_kw, shape, share, _ in runs]
    args = [(arch, over, mesh_kw, *shape, WORLD_FSDP_LR, clip, weights)
            for (_, arch, over, mesh_kw, shape, _, weights), (_, clip)
            in zip(runs, clips)]
    t_world = time.perf_counter()
    with ranks_alloc_conf():
        ranks = run_world(world_gran_runs_body, WORLD_RANKS, device=where,
                          args=(args,), timeout=1200.0)
    t_world = time.perf_counter() - t_world
    lines = {}
    for i, ((name, arch, over, mesh_kw, shape, _, weights),
            (norm, clip)) in enumerate(zip(runs, clips)):
        t2 = time.perf_counter()
        lines[name] = dict(world_gran_train(
            dev, where, arch, over, mesh_kw, shape, weights,
            [r[i] for r in ranks], clip=clip), first_grad_norm=norm,
            seconds_one_process=time.perf_counter() - t2)
        release()
    train_line = lines.pop("fsdp")
    return {"fsdp_serve": serve_line, "fsdp_train": train_line,
            "pod_mesh": lines, "rounds_world_seconds": t_world,
            "rounds_seconds": time.perf_counter() - t1,
            "seconds": time.perf_counter() - t0}


def world_kv_whole_body(world, train_argv, serve_argv, teacher):
    """A rank of W4's world: the mesh launcher's own rank
    (``launch.train._mesh_rank``, what ``--mode mesh --world`` runs) on
    ``train_argv``, then the serving launcher's (``world_serves_body``) on
    ``serve_argv``, in one world."""
    from repro_torch.launch import train

    out = {"train": train._mesh_rank(world, train.parse_args(train_argv))}
    out["serve"] = world_serves_body(world, [(serve_argv, teacher)])[0]
    return out


def world_kv_whole(dev, where, ref):
    """W4: TinyLlama at published widths on a data=1, model=8 world whose
    eight ranks share the card (the world rule ``kv_whole``: 32 / 4 heads,
    ``wk`` / ``wv`` whole on every rank, each rank's 4 query heads meeting
    their group's kv head, the cache's sequence over ``model``), in one
    world: 3 mesh rounds at WORLD_KV_TRAIN's cut (MoDeST, P = 1), held by
    ``world_train`` against the same rounds in one process here (and the
    learning-rate-0 control), then the serving launcher at full depth at
    the serve phase's shape with flash, decodes teacher-forced, held by
    ``held_serve`` against ``ref`` (22 B9 a rank, at B 4, 4 / 1 heads)."""
    from repro_torch.launch import train
    from repro_torch.launch.world import run_world

    serve_argv = ["--arch", "tinyllama-1.1b", "--full-size", "--devices",
                  str(WORLD_KV_RANKS), "--model-parallel",
                  str(WORLD_KV_RANKS), "--set", "use_flash=true", "--batch",
                  str(SERVE_B), "--prompt-len", str(SERVE_S),
                  "--new-tokens", str(WORLD_NEW), "--seed", "0", "--device",
                  where]
    teacher = ref["tokens"][:, :WORLD_NEW - 1].numpy()
    t0 = time.perf_counter()
    with ranks_alloc_conf():
        ranks = run_world(world_kv_whole_body, WORLD_KV_RANKS, device=where,
                          args=(WORLD_KV_TRAIN + ["--device", where],
                                serve_argv, teacher), timeout=900.0)
    t_world = time.perf_counter() - t0
    world = f"1 x {WORLD_KV_RANKS}"
    serve_line = held_serve(
        "tinyllama-1.1b", dict(ranks[0]["serve"], ranks=[
            r["serve"]["report"] for r in ranks]), ref, 22, t_world, world,
        SERVE_B, SERVE_S, seq_axis="model")
    trained = {"history": ranks[0]["train"]["history"],
               "ranks": [r["train"] for r in ranks]}
    del ranks
    release()
    one = train.main(WORLD_KV_TRAIN + ["--device", str(dev)])
    one_rounds, sketch = one["history"], one["change_sketch"]
    del one
    release()

    def run(device, in_world, lr=None):
        if in_world:
            return trained
        return train.main(WORLD_KV_TRAIN + ["--device", device] + (
            ["--lr", str(lr)] if lr is not None else []))

    train_line = world_train(dev, where, one_rounds, sketch,
                             loss_control=False, run=run,
                             rounds=WORLD_CONTROL_ROUNDS)
    train_line.update(world=world, depth_cut={"n_layers": 2})
    return {"serve": serve_line, "train": train_line,
            "world_seconds": t_world}


def world_phase(dev, mesh_rounds, mesh_sketch, serve_tokens, serve_prefill,
                world_refs, world_device=None):
    """The port across ranks (``launch.world``) on the one card, whose
    ranks share it (gloo, gathers staged through host memory):

    * the CNN session of ``session_phase`` and its masked twin on a world
      of 4 ranks through ``engine="sharded"`` (N over the ranks): bit for
      bit the same sessions on the batched engine in this process, both
      under cuDNN's deterministic algorithms (trajectory, every
      aggregation, the final model, a fused aggregate→quantize plain and
      masked); B1, B2, B3, B4, B5 launched on every rank;
    * ``launch/train.py --mode mesh --full-size --world`` (TinyLlama,
      MoDeST, P = 2, TP 2 on 2 x 2): its losses within WORLD_LOSS_RTOL of
      ``mesh_train``'s one-process modest rounds (``mesh_rounds``), which
      must lie at most a quarter of the way to the gap of a skipped
      update (the one-process rounds at learning rate 0, run here); the
      sketch of its replicas' change over the rounds alike on every rank
      and within WORLD_CHANGE_REL of ``mesh_train``'s (``mesh_sketch``)
      by relative norm; no kernel launched;
    * ``launch/serve.py --full-size --set use_flash=true --world`` on 2 x 2
      at the serve phase's shape and seed, decodes teacher-forced on its
      tokens: logits within WORLD_LOGITS_REL_L2 of the serve phase's
      prefill and of the one-process launcher's teacher-forced decodes,
      22 ``flash_attention`` launches a rank (one prefill) and no other;
    * a 1-rank world (NCCL) of the plain session, bit for bit too;
    * qwen3-moe's serve and mesh round, its experts over ``model``
      (``world_moe``, against the families phase's reference);
    * RWKV-6's and Hymba's serves at full depth and their 2-layer mesh
      rounds, their heads and d_inner over ``model``
      (``world_recurrent``, against the families phase's references);
    * Whisper's serve at full depth and LLaVA's at WORLD_LLAVA_CUT, and
      their mesh rounds at MESH_FAMILIES' cuts, heads, d_ff and vocab over
      ``model`` (``world_multimodal``: Whisper against the families
      phase's reference, LLaVA against one at its cut);
    * every participant granularity (``world_granularities``): W1,
      llama3-405b at 1 of 126 layers at ``pod`` granularity on 2 x 2
      (FSDP over ``data``, TP over ``model``), its serve and its round
      with a clip that binds; W2, TinyLlama at 2 layers on a ``pods=2,
      data=2, model=1`` world at ``pod``, ``chip`` and ``data_rank``
      granularity; each rank's peak, staged bytes and host peak reported;
    * what a world refused before (``held_serve``, ``world_train``; their
      one-process references first, while the card is free): W3,
      TinyLlama at full depth served with ``--shard-seq`` (B 1,
      WORLD_SEQ_S prompt tokens, the cache's sequence over ``data``) as the
      second serve of the 2 x 2 serve world; W5, qwen3-moe's decodes
      routing a group split over ``data`` (``WORLD_MOE_GROUP``), the
      second serve of its serve world, with the exact routing check
      (``moe_group_check``); W4, TinyLlama on a ``data=1, model=8`` world
      (the rule ``kv_whole``, the cache's sequence over ``model``), 3
      mesh rounds at 2 layers and its serve at full depth in one world
      (``world_kv_whole``).

    The families' and the granularities' worlds run WORLD_TRAIN_ROUNDS
    rounds; TinyLlama's, RWKV-6's fp32 and W4's WORLD_CONTROL_ROUNDS.

    ``world_device`` (None: ``dev``) is where the worlds' ranks run:
    ``"cuda"`` spreads them over the cards, one a rank where there are
    enough (NCCL)."""
    from repro_torch.launch import serve
    from repro_torch.launch.world import run_world

    t0 = time.perf_counter()
    # the one-process references of W3, W4 and W5, while the card is free
    split_refs = {
        "seq": world_cut_reference(dev, "tinyllama-1.1b", {}, 1,
                                   WORLD_SEQ_S),
        "kv": world_cut_reference(dev, "tinyllama-1.1b", {}, SERVE_B,
                                  SERVE_S),
        "group": world_cut_reference(dev, WORLD_MOE_ARCH, {"n_layers": 4},
                                     *WORLD_MOE_GROUP)}
    t_split_refs = time.perf_counter() - t0
    chunk_rows = world_chunk_rows(dev)
    refs = [world_session_run("batched", sa, WORLD_SIM_SECONDS, dev)
            for sa in (None, "masked")]
    t_ref = time.perf_counter() - t0
    t1 = time.perf_counter()
    where = str(dev) if world_device is None else world_device
    ranks = run_world(world_session_body, WORLD_RANKS, device=where,
                      args=((None, "masked"), WORLD_SIM_SECONDS),
                      timeout=600.0)
    t_sessions = time.perf_counter() - t1
    world_sessions_check(ranks, refs, "sessions")
    for r in ranks:
        launched = r["report"]["launches"]
        for name in ("fused.agg", "fused.agg_quant", "fused.mask",
                     "fused.unmask_agg", "fused.unmask_agg_quant"):
            if launched[name] <= 0:
                raise AssertionError(f"rank {r['report']['rank']} never "
                                     f"launched {name}")
        lanes = r["sessions"][0]["state_lanes"]
        if r["sessions"][0]["shards"] != WORLD_RANKS:
            raise AssertionError(f"{r['sessions'][0]['shards']} shards")
    t1 = time.perf_counter()
    nccl = run_world(world_session_body, 1, device=str(dev),
                     args=((None,), WORLD_SIM_SECONDS), timeout=600.0)
    t_nccl = time.perf_counter() - t1
    if nccl[0]["report"]["backend"] != "nccl":
        raise AssertionError(f"a 1-rank world on {nccl[0]['report']}")
    world_sessions_check(nccl, refs[:1], "nccl")

    t1 = time.perf_counter()
    trained = world_train(dev, where, mesh_rounds, mesh_sketch,
                          rounds=WORLD_CONTROL_ROUNDS)
    t_train = time.perf_counter() - t1

    argv = ["--arch", "tinyllama-1.1b", "--full-size", "--devices", "4",
            "--model-parallel", "2", "--set", "use_flash=true", "--batch",
            str(SERVE_B), "--prompt-len", str(SERVE_S), "--new-tokens",
            str(WORLD_NEW), "--seed", "0", "--device", str(dev)]
    teacher = serve_tokens[:, :WORLD_NEW - 1].numpy()
    reset_counts()
    one = serve.main(argv, teacher=teacher)
    one_launches = read_counts()
    release()
    seq_argv = argv[:-2] + ["--device", where, "--shard-seq"]
    seq_argv[seq_argv.index("--batch") + 1] = "1"
    seq_argv[seq_argv.index("--prompt-len") + 1] = str(WORLD_SEQ_S)
    t1 = time.perf_counter()
    both = run_world(world_serves_body, 4, device=where, args=(
        [(argv[:-2] + ["--device", where], teacher),
         (seq_argv, split_refs["seq"]["tokens"][:, :WORLD_NEW - 1].numpy())],
    ), timeout=900.0)
    t_serve = time.perf_counter() - t1
    served = dict(both[0][0], ranks=[r[0]["report"] for r in both])
    seq_line = held_serve("tinyllama-1.1b", dict(
        both[0][1], ranks=[r[1]["report"] for r in both]),
        split_refs["seq"], 22, t_serve, "2 x 2, shard_seq", 1, WORLD_SEQ_S,
        seq_axis="data")
    seq_line["prefill_seconds_by_rank"] = [r[1]["prefill_seconds"]
                                           for r in both]
    gaps = [rel_l2(g, w) for g, w in zip(served["step_logits"],
                                         one["step_logits"])]
    prefill_gap = rel_l2(served["step_logits"][0], serve_prefill)
    one_prefill_gap = rel_l2(one["step_logits"][0], serve_prefill)
    if max(gaps + [prefill_gap]) > WORLD_LOGITS_REL_L2 or len(gaps) != \
            WORLD_NEW:
        raise AssertionError(f"world logits off one process's: {gaps}, "
                             f"prefill {prefill_gap}")
    for r in served["ranks"]:
        fl = r["launches"]["flash_attention"]
        if fl != 22 or sum(r["launches"].values()) != fl:
            raise AssertionError(f"serve rank {r['rank']} launched "
                                 f"{r['launches']}, want 22 flash only")
    if one_launches["flash_attention"] != 22:
        raise AssertionError(f"one-process launcher: {one_launches}")

    release()
    moe = world_moe(dev, where, world_refs[WORLD_MOE_ARCH],
                    split_refs["group"])
    recurrent = {}
    for arch in WORLD_RECURRENT:
        release()
        t1 = time.perf_counter()
        recurrent[arch] = dict(world_recurrent(dev, where, arch,
                                               world_refs[arch]),
                               seconds=time.perf_counter() - t1)
    multimodal = {}
    for arch in WORLD_MULTIMODAL:
        release()
        t1 = time.perf_counter()
        multimodal[arch] = dict(world_multimodal(dev, where, arch,
                                                 world_refs.get(arch)),
                                seconds=time.perf_counter() - t1)
    release()
    grans = world_granularities(dev, where)
    release()
    t1 = time.perf_counter()
    kv_whole = world_kv_whole(dev, where, split_refs["kv"])
    kv_whole["seconds"] = time.perf_counter() - t1

    def reports(rs):
        return [{k: r[k] for k in ("rank", "backend", "launches",
                                   "staged_bytes", "seconds", "peak_bytes",
                                   "host_peak_bytes")}
                for r in rs]

    line = {
        "chunk_rows": chunk_rows,
        "sessions": {
            "ranks": WORLD_RANKS, "sim_seconds": WORLD_SIM_SECONDS,
            "vs_batched": "bit-identical",
            "rounds": [s["rounds"] for s in refs],
            "state_lanes": lanes, "batched_seconds": t_ref,
            "world_seconds": t_sessions,
            "ranks_report": reports([r["report"] for r in ranks])},
        "nccl": {"backend": "nccl", "vs_batched": "bit-identical",
                 "world_seconds": t_nccl,
                 "ranks_report": reports([nccl[0]["report"]])},
        "train": dict(trained, world_seconds=t_train,
                      ranks_report=reports(trained["ranks_report"])),
        "serve": {"world": "2 x 2", "prefill_rel_l2": prefill_gap,
                  "one_process_prefill_rel_l2": one_prefill_gap,
                  "step_rel_l2": gaps, "world_seconds": t_serve,
                  "tokens_equal": bool(np.array_equal(
                      served["tokens"], one["tokens"])),
                  "prefill_seconds": served["prefill_seconds"],
                  "one_process_prefill_seconds": one["prefill_seconds"],
                  "ranks_report": reports(served["ranks"])},
        "moe_serve": dict({k: v for k, v in moe["serve"].items()
                           if k != "groups_split"}, ranks_report=reports(
            moe["serve"]["ranks_report"])),
        "moe_train": dict(moe["train"], ranks_report=reports(
            moe["train"]["ranks_report"])),
        "recurrent": {arch: {
            "seconds": rec["seconds"],
            "serve": dict(rec["serve"], ranks_report=reports(
                rec["serve"]["ranks_report"])),
            "train": dict(rec["train"], ranks_report=reports(
                rec["train"]["ranks_report"]), **({"fp32": dict(
                    rec["train"]["fp32"], ranks_report=reports(
                        rec["train"]["fp32"]["ranks_report"]))}
                    if "fp32" in rec["train"] else {}))}
            for arch, rec in recurrent.items()},
        "multimodal": {arch: {
            "seconds": rec["seconds"],
            "serve": dict(rec["serve"], ranks_report=reports(
                rec["serve"]["ranks_report"])),
            "train": dict(rec["train"], ranks_report=reports(
                rec["train"]["ranks_report"]))}
            for arch, rec in multimodal.items()},
        "granularities": {
            "seconds": grans["seconds"],
            "fsdp_serve": dict(grans["fsdp_serve"], ranks_report=reports(
                grans["fsdp_serve"]["ranks_report"])),
            "fsdp_train": dict(grans["fsdp_train"], ranks_report=reports(
                grans["fsdp_train"]["ranks_report"])),
            "pod_mesh": {gran: dict(rec, ranks_report=reports(
                rec["ranks_report"])) for gran, rec in
                grans["pod_mesh"].items()},
            "rounds_world_seconds": grans["rounds_world_seconds"],
            "rounds_seconds": grans["rounds_seconds"]},
        "shard_seq_serve": dict(seq_line, ranks_report=reports(
            seq_line["ranks_report"])),
        "moe_groups_split": dict(moe["serve"]["groups_split"],
                                 ranks_report=reports(
                                     moe["serve"]["groups_split"][
                                         "ranks_report"])),
        "kv_whole": {
            "seconds": kv_whole["seconds"],
            "world_seconds": kv_whole["world_seconds"],
            "serve": dict(kv_whole["serve"], ranks_report=reports(
                kv_whole["serve"]["ranks_report"])),
            "train": dict(kv_whole["train"], ranks_report=reports(
                kv_whole["train"]["ranks_report"]))},
        "split_references_seconds": t_split_refs,
        "seconds": time.perf_counter() - t0}
    emit("world", **line)
    return line


def examples_phase():
    """``examples/torch_*.py`` in this process at the reference's defaults
    on the card: ``quickstart`` (12 nodes, the paper CNN, 60 simulated s),
    ``compare_fl_dl`` (FedAvg, D-SGD and MoDeST, 24 nodes, 120 s, each
    training the CNN), ``train_lm`` (16 nodes, TinyLlama at 4 layers and
    d_model 256, 240 s), the byte-only ``churn_resilience`` and
    ``trace_replay`` (sessions on the card's device, nothing to compute),
    then ``torch_serve_batch.py --arch tinyllama-1.1b`` as a process of its
    own. Gates: every session that trains passes ``check_session``, with
    ``fused.agg`` launched once per aggregation the engine runs and no other
    kernel (counts set to 0 before each session, read after); every printed
    number finite."""
    with counted_aggregations() as calls:
        return examples_run(calls)


def examples_run(calls):
    """The body of :func:`examples_phase`; ``calls`` counts the engine's
    aggregations."""
    t_all = time.perf_counter()
    out, total = {}, {n: 0 for n in read_counts()}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    quick = load_example("quickstart")
    calls.clear()
    reset_counts()
    (session, res), lines, wall = printed("quickstart", quick.main, [])
    n_agg = one_agg_per_aggregation(session, calls, "quickstart")
    check_session(session, res)
    add(read_counts())
    out["quickstart"] = dict(example_line(session, res, wall, n_agg),
                             printed=lines)
    del session, res

    compare = load_example("compare_fl_dl")
    algos = {}

    def on_session(algo, session):
        inner = session.run

        def run(duration):
            calls.clear()
            reset_counts()
            res, wall = synced_seconds(inner, duration)
            n_agg = one_agg_per_aggregation(session, calls, algo)
            check_session(session, res)
            add(read_counts())
            algos[algo] = example_line(session, res, wall, n_agg)
            return res

        session.run = run

    results, lines, wall = printed("compare_fl_dl", compare.run, 24, 120.0,
                                   None, on_session)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        compare.report({a: r for a, (_, r) in results.items()})
    if NON_FINITE.search(text.getvalue()):
        raise AssertionError(f"compare_fl_dl printed:\n{text.getvalue()}")
    usage = {a: r.usage["total_bytes"] for a, (_, r) in results.items()}
    out["compare_fl_dl"] = dict(
        algos, wall_seconds=wall,
        dsgd_over_modest_bytes=usage["dsgd"] / usage["modest"],
        printed=text.getvalue().splitlines())
    del results

    lm = load_example("train_lm")
    calls.clear()
    reset_counts()
    (task, session, res), lines, wall = printed("train_lm", lm.main, [])
    n_agg = one_agg_per_aggregation(session, calls, "train_lm")
    check_session(session, res, metric="loss")
    add(read_counts())
    out["train_lm"] = dict(example_line(session, res, wall, n_agg, "loss"),
                           n_params=task.flat_spec.n, printed=lines)
    del task, session, res

    for name in ("churn_resilience", "trace_replay"):
        twin = load_example(name)
        reset_counts()
        got, lines, wall = printed(name, twin.main, [])
        add(read_counts())
        if not any("rounds" in ln for ln in lines):
            raise AssertionError(f"{name} printed {lines}")
        out[name] = dict(wall_seconds=wall, printed=lines)

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(EXAMPLES_DIR /
                                               "torch_serve_batch.py"),
                           "--arch", "tinyllama-1.1b"], capture_output=True,
                          text=True, timeout=600)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 2 or not lines[0].startswith(
            "[serve] arch=tinyllama-1.1b device=cuda") or \
            NON_FINITE.search(proc.stdout):
        raise AssertionError(f"serve_batch: rc {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr[-3000:]}")
    out["serve_batch"] = dict(wall_seconds=time.perf_counter() - t0,
                              printed=lines)
    out["seconds"] = time.perf_counter() - t_all
    out["launches"] = total
    emit("examples", **out)
    return out


# ---------------------------------------------------------------------------
# roofline: the H100 roofline's aggregation bytes against bound_ms
# ---------------------------------------------------------------------------

# (stack, P, N): the CNN session's, the MF session's, the TinyLlama session's
ROOFLINE_SHAPES = (("cnn_session", 10, 136_672), ("mf_session", 10, 11_173),
                   ("lm_session", LM_COHORT, LM_N))
# bound_ms counts the P fp32 weights that the roofline leaves out: 4 P bytes
# over (P + 1) N x 4 or more, below 1e-4 at these stacks
ROOFLINE_REL_TOL = 1e-4


def roofline_rows():
    """``roofline.aggregation_roofline``'s one-pass time (B1; B2 with
    ``fused_quantize=True``) against ``bound_ms`` at ``ROOFLINE_SHAPES``:
    both bounded by bytes, the bound above the roofline by less than
    ``ROOFLINE_REL_TOL``; and this script's card constants those of
    ``config.H100``. Arithmetic only: it runs without a card."""
    from repro_torch.config import H100
    from repro_torch.roofline import aggregation_roofline

    mine = {"hbm_bandwidth": HBM_BYTES_PER_S,
            "peak_flops_fp32": FP32_FLOPS_PER_S,
            "peak_flops_bf16": BF16_FLOPS_PER_S,
            "peak_ops_int32": INT32_OPS_PER_S}
    if any(getattr(H100, k) != v for k, v in mine.items()):
        raise AssertionError(f"config.H100 {H100} against {mine}")
    rows = []
    for name, P, N in ROOFLINE_SHAPES:
        row = {"stack": name, "P": P, "N": N}
        for kind, quant in (("fused.agg", False), ("fused.agg_quant", True)):
            roof = aggregation_roofline(N, P, fused_quantize=quant)
            bound, by = bound_ms(kind, P, N, 0, False)
            ms = roof["onepass_us"] / 1e3
            gap = (bound - ms) / bound
            if by != "bytes" or not 0 < gap <= ROOFLINE_REL_TOL:
                raise AssertionError(f"{name} {kind}: roofline {ms} ms, "
                                     f"bound {bound} ms ({by})")
            row[kind] = {"roofline_ms": ms,
                         "onepass_bytes": roof["onepass_bytes"],
                         "bound_ms": bound, "rel_gap": gap}
        rows.append(row)
    return rows


def roofline_phase(dev):
    """``roofline_rows`` beside the card's own SM count and clock."""
    from repro_torch.config import H100

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms != H100.n_sms:
        raise AssertionError(f"{sms} SMs, config.H100 says {H100.n_sms}")
    emit("roofline", stacks=roofline_rows(), rel_tol=ROOFLINE_REL_TOL,
         h100={k: getattr(H100, k) for k in (
             "hbm_bandwidth", "peak_flops_bf16", "peak_flops_fp32",
             "peak_ops_int32", "n_sms", "sm_clock_hz", "hbm_bytes")},
         card_sms=sms, card_sm_clock_hz=sm_clock_hz())


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    import repro_torch  # noqa: F401  (sets the numerics)
    from repro_torch.kernels import KERNELS, build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    nvcc = re.search(r"release ([\d.]+)",
                     run_cmd([build.find_nvcc(), "--version"]))
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.group(1) if nvcc else None, card=card,
         python=sys.version.split()[0],
         allow_tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    sources = ["fused_agg", "flash_attention", "aggregate", "quantize"]
    build.build(sources)                             # fails loudly
    emit("build", seconds=time.perf_counter() - t0,
         seconds_by_source={n: build.build_seconds(n) for n in sources},
         ptxas={n: [ln for ln in build.build_log(n).splitlines()
                    if "registers" in ln or "Compiling" in ln]
                for n in sources})
    flash_kernels = ptxas_kernels(build.build_log("flash_attention"))
    emit("flash_ptxas", kernels=flash_kernels)
    if not any(k["kernel"].startswith("flash_tc_kernel") for k in
               flash_kernels) or {k["target"] for k in flash_kernels} != {
                   "sm_90a"}:
        raise AssertionError(f"flash_attention.cu's kernels not all built "
                             f"for sm_90a: {flash_kernels}")
    fused_kernels = ptxas_kernels(build.build_log("fused_agg"), fused_label)
    emit("fused_ptxas", kernels=fused_kernels)
    if not fused_kernels or {k["target"] for k in fused_kernels} != {
            "sm_90a"} or any(k.get("spill_stores") or k.get("spill_loads")
                             for k in fused_kernels):
        raise AssertionError(f"fused_agg.cu's kernels not all built for "
                             f"sm_90a without spills: {fused_kernels}")
    word_pipes, sass_counts = prg_word_pipes(
        dump_sass(build.library_path("fused_agg")))
    emit("fused_sass", prg=word_pipes, kernels=sass_counts)

    rows = kernel_phase(dev, word_pipes)
    roofline_phase(dev)
    # each main path with the counts set to 0 just before it, read after
    session, models = session_phase(sim_seconds=40.0)
    out, codes, scales = agg_quant_phase(session, models)
    plain_launches = read_counts()
    msession, calls = masked_session_phase(sim_seconds=40.0)
    last = calls[-1]
    mout = masked_agg_quant_phase(msession, last)
    masked_launches = read_counts()
    reset_counts()
    served = serve_phase(dev)
    serve_launches = read_counts()
    reset_counts()
    trees = trees_phase(dev)
    trees_launches = read_counts()
    launches = {}
    for names, counted in (({"fused.agg", "fused.agg_quant"}, plain_launches),
                           ({"fused.mask", "fused.unmask_agg",
                             "fused.unmask_agg_quant"}, masked_launches),
                           ({"flash_attention"}, serve_launches),
                           ({"aggregate.agg", "quantize.quant",
                             "quantize.dequant"}, trees_launches)):
        for name in names:
            if counted[name] <= 0:
                raise AssertionError(f"the main path never launched {name}")
            launches[name] = counted[name]
    if set(launches) != set(KERNELS):
        raise AssertionError(f"kernels outside the paths: {set(KERNELS)}")
    want = served["cfg"].n_layers * served["prefills"]
    if serve_launches["flash_attention"] != want or sum(
            serve_launches.values()) != want:
        raise AssertionError(f"serve path launches {serve_launches}, want "
                             f"{want} of flash_attention only")
    agg_quant_check(session, models, out, codes, scales)
    means_check(msession, calls, True, phase="masked_means")
    masked_agg_quant_check(msession, last, mout)
    del session, models, msession, calls, last, out, codes, scales, mout
    serve_check(served, rows["flash_attention"][0]["ms"])
    reset_counts()
    mesh_served = mesh_serve_phase(dev)
    mesh_serve_launches = read_counts()
    mesh_serve_check(mesh_served, served, mesh_serve_launches)
    reset_counts()
    dryrun_phase(dev, served)
    if any(read_counts().values()):
        raise AssertionError(f"the dry run launched {read_counts()}")
    serve_tokens = served["tokens"].cpu()
    serve_prefill = served["flash_logits"][:, -1].float().cpu()
    del served, mesh_served
    trees_check(trees, trees_launches)
    del trees
    torch.cuda.empty_cache()
    reset_counts()
    mf, mf_result, mf_last, mf_line = mf_session_phase(sim_seconds=40.0)
    mf_check(mf, mf_result, mf_last, mf_line, sim_seconds=40.0)
    del mf, mf_last
    reset_counts()
    mf_masked_session_phase(sim_seconds=40.0)
    breakdown_phase(sim_seconds=40.0)
    breakdown_phase(sim_seconds=40.0, secure_agg="masked")
    profile_phase(sim_seconds=20.0)
    engines_phase()
    served_phase(sim_seconds=40.0)
    ckpt_lm_phase(dev)
    torch.cuda.empty_cache()
    mf_ckpt_phase(sim_seconds=40.0)
    sharded_phase(dev, sim_seconds=40.0)
    torch.cuda.empty_cache()
    lm = lm_train_phase(dev, word_pipes)
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    families = families_phase(dev)
    family_launches = read_counts()
    if family_launches["flash_attention"] != families["flash_launches"] or \
            sum(family_launches.values()) != families["flash_launches"] or \
            families["flash_launches"] <= 0:
        raise AssertionError(f"families phase launches {family_launches}, "
                             f"want {families['flash_launches']} of "
                             "flash_attention only")
    world_refs = families["world_refs"]
    del families
    release()
    families_train = lm_families_train_phase()
    train_launches = {}
    for line in families_train["lines"].values():
        for name, n in line["launches"].items():
            train_launches[name] = train_launches.get(name, 0) + n
    reset_counts()
    mesh = mesh_train_phase(dev)
    mesh_launches = read_counts()
    mesh_rounds = mesh["launcher"]["modest"]["rounds"]
    mesh_sketch = mesh["change_sketches"]["modest"]
    del mesh
    if any(mesh_launches.values()):
        raise AssertionError(f"the mesh form launched {mesh_launches}: no "
                             "kernel lies on it")
    gc.collect()
    torch.cuda.empty_cache()
    examples = examples_phase()
    gc.collect()
    torch.cuda.empty_cache()
    world = world_phase(dev, mesh_rounds, mesh_sketch, serve_tokens,
                        serve_prefill, world_refs)
    del world_refs
    world_launches = {
        name: [r["launches"][name]
               for r in world["sessions"]["ranks_report"]]
        for name in world["chunk_rows"]}
    world_launches["flash_attention"] = [
        r["launches"]["flash_attention"]
        for r in world["serve"]["ranks_report"]]
    world_rows = dict(world["chunk_rows"])

    def flash_row(shape):
        return {k: r[k] for r in rows["flash_attention"]
                if r["shape"] == shape
                for k in ("B", "Hq", "Hkv", "S", "hd", "ms", "plain_ms",
                          "bound_ms", "bound_by", "library_ms",
                          "max_abs_err")}

    world_rows["flash_attention"] = dict(flash_row(WORLD_FLASH_ROW), moe=dict(
        flash_row(WORLD_MOE_FLASH_ROW), arch=WORLD_MOE_ARCH,
        launches_by_rank=[r["launches"]["flash_attention"]
                          for r in world["moe_serve"]["ranks_report"]]),
        hymba=dict(flash_row(WORLD_HYMBA_FLASH_ROW), arch="hymba-1.5b",
                   launches_by_rank=[
                       r["launches"]["flash_attention"] for r in
                       world["recurrent"]["hymba-1.5b"]["serve"][
                           "ranks_report"]]),
        **{arch.split("-")[0]: dict(
            flash_row(row), arch=arch, launches_by_rank=[
                r["launches"]["flash_attention"] for r in
                world["multimodal"][arch]["serve"]["ranks_report"]])
           for arch, row in WORLD_MULTIMODAL_FLASH_ROWS.items()},
        llama3_405b=dict(
            flash_row(WORLD_FSDP_FLASH_ROW), arch=WORLD_FSDP_ARCH,
            launches_by_rank=[
                r["launches"]["flash_attention"] for r in
                world["granularities"]["fsdp_serve"]["ranks_report"]]),
        shard_seq=dict(
            flash_row(WORLD_SEQ_FLASH_ROW), arch="tinyllama-1.1b",
            launches_by_rank=[
                r["launches"]["flash_attention"] for r in
                world["shard_seq_serve"]["ranks_report"]]),
        kv_whole=dict(
            flash_row(WORLD_KV_FLASH_ROW), arch="tinyllama-1.1b",
            launches_by_rank=[
                r["launches"]["flash_attention"] for r in
                world["kv_whole"]["serve"]["ranks_report"]]),
        moe_groups_split={"arch": WORLD_MOE_ARCH, "launches_by_rank": [
            r["launches"]["flash_attention"] for r in
            world["moe_groups_split"]["ranks_report"]]})

    kernels = []
    for name, meta in KERNELS.items():
        at_session = rows[name][0]          # the main path's shape
        kernels.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": at_session["max_abs_err"],
            "ms": at_session["ms"], "plain_ms": at_session["plain_ms"],
            "bound_ms": at_session["bound_ms"],
            "bound_by": at_session["bound_by"],
            "library_ms": at_session["library_ms"],
            **({"pipe_bound_ms": at_session["pipe_bound_ms"]}
               if "pipe_bound_ms" in at_session else {}),
            **({"at_lm_train": lm_row(lm, name)}
               if name in lm["kernels"] else {}),
            **({"at_lm_families_train": {"launches": train_launches[name]}}
               if name in train_launches else {}),
            **({"at_examples": {"launches": examples["launches"][name]}}
               if examples["launches"][name] else {}),
            **({"at_mesh_serve": {
                "launches": mesh_serve_launches[name]}}
               if name == "flash_attention" else {}),
            **({"at_world": dict(
                world_rows.get(name, {}),
                launches_by_rank=world_launches[name])}
               if name in world_launches else {}),
            **({"at_families": {
                "launches": family_launches[name],
                "by_model": {r["model"]: {k: r[k] for k in (
                    "B", "Hq", "Hkv", "S", "hd", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "max_abs_err")}
                    for r in rows[name] if r.get("model")}}}
               if name == "flash_attention" else {})})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--mf-gap-readings"]:
        if not torch.cuda.is_available():
            raise SystemExit("--mf-gap-readings needs a CUDA device")
        sys.exit(mf_gap_readings())
    sys.exit(main())
