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
  rows) against their plain versions; B1-B5 timed at P = 4 over that N.

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
(``form``). A call of B2 and of B5 after the timed graph replays must
give what the first call gave, bit for bit, with the arrival counts and
absmax words of the quantised forms' workspace back at 0. ``masked_edges`` holds the
masked kernels bit for bit at edge shapes; ``quant_edges`` holds B1, B2,
B4 and B5 to one another and B2 and B5's codes and scales to the plain
quantiser at the edges of the quantised forms (subtiles, the rows
kernel's limit, every block size a launcher can choose, P·R = 6144);
``nonfinite`` holds B2, B5 and B7 to the reference's quantisation of a
NaN and an Inf lane (scale NaN or Inf, codes 0). ``fused_ptxas`` prints
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
    with the stack as a yardstick (the package never calls it)."""
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
        for kname, kernel, plain_fn, b_args in (
                ("quantize.quant", lambda: qz.quantize_tiles(d),
                 lambda: qz._plain_quantize(d), (4, 1)),
                ("quantize.dequant", lambda: qz.dequantize_tiles(codes, scales),
                 lambda: qz._plain_dequantize(codes, scales, torch.float32),
                 (1, 4))):
            b, by = tile_bound_ms(kname, 1, N, *b_args)
            rows.setdefault(kname, []).append({
                "shape": name, "N": N, "dtype": "float32", "max_abs_err": 0.0,
                "ms": time_ms(kernel, iters), "plain_ms": time_ms(plain_fn, iters),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "eager_ms": eager_ms(kernel, iters)})
        del d, codes, scales, back, plain_back, pc, ps
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
    and bf16, and at starcoder2-15b's heads (hd 128, bf16, causal), timed
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
    cases = [(SERVE_B, 32, 4, S, 64, dtype, causal) for S in (SERVE_S, 640)
             for dtype in (torch.bfloat16, torch.float32)
             for causal in (True, False)]
    cases.append((SERVE_B, 48, 4, SERVE_S, 128, torch.bfloat16, True))
    for i, (B, Hq, Hkv, S, hd, dtype, causal) in enumerate(cases):
        name = (f"S{S}_{str(dtype)[6:]}_{'causal' if causal else 'full'}"
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
            "shape": name, "B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "hd": hd,
            "dtype": str(dtype)[6:], "causal": causal, "max_abs_err": err,
            "err_share_of_tol": share, "rel_l2_err": rel,
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                          20),
            "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, causal), 5),
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
                secure_agg=None, serve=None):
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
        task=task or cnn_task(),
        data=make_classification_task(n_nodes, samples_per_node=100,
                                      iid=False, alpha=0.5, seed=0),
        seed=0, eval_every_rounds=5, engine=engine, serve=serve)


def record_aggregations(session, masked: bool):
    """Every aggregation's inputs and result, recorded around the engine
    without changing what it does."""
    calls = []
    if masked:
        inner = session.engine.aggregate_masked

        def aggregate_masked(models, seeds, signs, weights=None):
            out = inner(models, seeds, signs, weights)
            calls.append((list(models), seeds, signs, weights, out))
            return out

        session.engine.aggregate_masked = aggregate_masked
    else:
        inner = session.engine.aggregate

        def aggregate(models, weights=None):
            out = inner(models, weights)
            calls.append((list(models), weights, out))
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
    by queued jobs, finite parameters and a finite ``metric`` history."""
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
    for b in [as_buffer(m, spec) for m in session._eval_models.values()]:
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


def logits_gaps(cfg, params, toks, dev, flash_bf16=None):
    """Last-position prefill logits of the flash and plain paths, in bf16 and
    with the weights widened exactly to fp32; returns their gaps. The fp32
    plain logits stand for the exact ones."""
    from repro_torch.core.distributed import Server
    from repro_torch.utils.pytree import tree_map

    B, S = toks.shape
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
                p, {"tokens": toks}, srv.model.init_cache(B, S + 8, dev))
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
        cfg, params, toks, dev, flash_bf16=out["flash_logits"]))]
    for seed in SERVE_SEEDS[1:]:
        p = out["server"].model.init(
            torch.Generator(device=dev).manual_seed(seed), dev)
        t = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab, (B, S)), device=dev)
        gaps.append(dict(seed=seed, **logits_gaps(cfg, p, t, dev)))
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
    release = re.search(r"release ([\d.]+)",
                        run_cmd([build.find_nvcc(), "--version"]))
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=release.group(1) if release else None, card=card,
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
    del served
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
               if name in lm["kernels"] else {})})
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
