#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (into ``build/``),
holds each against its plain PyTorch version on the card, then drives the
main path — one MoDeST session with the paper CNN at full width through the
batched engine, and a fused aggregate→quantize over the session's last
cohort — and checks that the path really went through the kernels.

It needs a CUDA device and fails without one (non-zero exit, nothing is
caught). Each phase prints one JSON line. The last three lines are: the
card's name and power limit, one JSON object ``{"kernels": [...]}`` with
every kernel's numbers from this run, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Tolerances: kernel mean against the plain version ``rtol = atol = 1e-6``
(summation order and fused multiply-add differ); int8 codes and scales are
compared bit for bit against the plain quantiser applied to the kernel's
own mean; the two kernels' means are compared bit for bit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores
TOL = 1e-6


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


def bound_ms(P: int, N: int, masked: bool, quant: bool):
    """Least time the card could take: each input read once, each output
    written once, against the multiply-adds at the fp32 rate."""
    nbytes = 4 * (P * N + P + N) + (N if masked else 0)
    if quant:
        nbytes += N + 4 * (-(-N // 16384))
    flops = 2 * P * N + N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def check_quant(mean, codes, scales, fused):
    """Codes and scales bit for bit against the plain quantiser applied to
    the kernel's own mean."""
    ref_codes, ref_scales = fused._plain_quantize(mean)
    if codes.dtype != torch.int8 or codes.shape != mean.shape:
        raise AssertionError(f"codes {codes.dtype} {tuple(codes.shape)}")
    if not torch.equal(scales, ref_scales):
        raise AssertionError("scales differ from the plain quantiser's")
    if not torch.equal(codes, ref_codes):
        bad = int((codes != ref_codes).sum())
        raise AssertionError(f"{bad} codes differ from the plain quantiser's")


def kernel_phase(dev):
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

    shapes = [
        # name, P, N, integer lanes, timing iterations
        ("session", 10, 136672, 0, 200),
        ("session_int_leaf", 10, 136672 + 4, 4, 200),
        ("stream", 16, 1 << 24, 0, 10),
        ("stream_ragged", 16, (1 << 24) - 1003, 1000, 10),
    ]
    rows = {"fused.agg": [], "fused.agg_quant": []}
    for i, (name, P, N, n_int, iters) in enumerate(shapes):
        x, w, mask = make_inputs(P, N, n_int, seed=100 + i, dev=dev)
        mean = fused.aggregate_flat_onepass(x, w, mask)
        mean_q, codes, scales = fused.aggregate_quantize_flat(x, w, mask)
        torch.cuda.synchronize()
        plain = fused._plain_onepass(x, w, mask)
        for got_mean in (mean, mean_q):
            if got_mean.shape != (N,) or not torch.isfinite(got_mean).all():
                raise AssertionError(f"{name}: bad mean")
        err = float((mean - plain).abs().max())
        if not torch.allclose(mean, plain, rtol=TOL, atol=TOL):
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
            b, by = bound_ms(P, N, mask is not None, kname.endswith("quant"))
            rows[kname].append({
                "shape": name, "P": P, "N": N, "int_lanes": n_int,
                "max_abs_err": err, "ms": time_ms(kernel, iters),
                "plain_ms": time_ms(plain_fn, iters),
                "bound_ms": b, "bound_by": by,
                "library_ms": time_ms(library, iters) if library else None,
                "eager_ms": eager_ms(kernel, iters),
                "eager_plain_ms": eager_ms(plain_fn, iters)})
        del x, w, mask, mean, mean_q, codes, scales, plain
    torch.cuda.empty_cache()
    emit("kernels", tolerance={"mean_rtol_atol": TOL, "codes": "bit-identical",
                               "scales": "bit-identical",
                               "agg_vs_agg_quant_mean": "bit-identical"},
         kernels=rows)
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------


def cnn_session(n_nodes: int, sample_size: int, engine: str, task=None):
    from repro_torch.config import ModestConfig, TrainConfig
    from repro_torch.data.synthetic import make_classification_task
    from repro_torch.models.tasks import cnn_task
    from repro_torch.sim.runner import ModestSession

    return ModestSession(
        n_nodes=n_nodes,
        mcfg=ModestConfig(n_nodes=n_nodes, sample_size=sample_size,
                          n_aggregators=2, success_fraction=1.0,
                          ping_timeout=1.0),
        tcfg=TrainConfig(batch_size=20),
        task=task or cnn_task(),
        data=make_classification_task(n_nodes, samples_per_node=100,
                                      iid=False, alpha=0.5, seed=0),
        seed=0, eval_every_rounds=5, engine=engine)


def record_aggregate_inputs(session):
    """Keep the models of the session's most recent aggregation (the last
    cohort's trained models) without changing what the engine does."""
    last = {}
    inner = session.engine.aggregate

    def aggregate(models, weights=None):
        last["models"] = list(models)
        return inner(models, weights)

    session.engine.aggregate = aggregate
    return last


def session_phase(sim_seconds: float):
    from repro_torch.engine.flat import as_buffer
    from repro_torch.kernels import KERNELS, fused

    session = cnn_session(32, 10, "batched")
    spec = session.task.flat_spec
    if spec.n != 136672 or len(spec.shapes) != 7:
        raise AssertionError(f"paper-cnn layout changed: {spec}")
    last = record_aggregate_inputs(session)
    for k in KERNELS.values():
        k["wrapper"].launches = 0          # counts of the main path only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = session.run(sim_seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    n_agg = sum(len(node.agg_log) for node in session.nodes.values())
    eng = session.engine
    acc = [(h["round"], h["accuracy"]) for h in result.history
           if "accuracy" in h]
    if result.rounds_completed < 10:
        raise AssertionError(f"only {result.rounds_completed} rounds")
    if fused.aggregate_flat_onepass.launches != n_agg or n_agg == 0:
        raise AssertionError(
            f"{fused.aggregate_flat_onepass.launches} fused.agg launches "
            f"for {n_agg} aggregations")
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
    models = last["models"]
    bufs = [as_buffer(m, spec) for m in models]
    evals = [as_buffer(m, spec) for m in session._eval_models.values()]
    for b in bufs + evals:
        if b.device.type != "cuda" or b.shape != (spec.n,):
            raise AssertionError(f"buffer {tuple(b.shape)} on {b.device}")
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite parameters after training")
    if not acc or not all(np.isfinite(a) for _, a in acc):
        raise AssertionError(f"no finite accuracy history: {acc}")
    emit("session", model="paper-cnn", n_params=spec.n, n_nodes=32,
         sample_size=10, sim_seconds=sim_seconds,
         rounds=result.rounds_completed, wall_seconds=wall,
         accuracy=acc, flushes=eng.flushes, jobs=eng.jobs_run,
         fallbacks=eng.fallbacks, aggregations=n_agg,
         launches={n: k["wrapper"].launches for n, k in KERNELS.items()},
         trainings=result.trainings_completed,
         total_bytes=result.usage["total_bytes"])
    return session, models


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


def agg_quant_check(session, models, out, codes, scales):
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
    emit("agg_quant", models=len(models), n=spec.n,
         subtiles=int(scales.shape[0]), max_abs_err=err,
         codes="bit-identical", scales="bit-identical")


def breakdown_phase(sim_seconds: float):
    """Where the session's wall time goes. A second, instrumented run of
    the same session (synchronising around each engine call), kept apart
    from the counted run so that run stays as a user would run it."""
    session = cnn_session(32, 10, "batched")
    eng = session.engine
    spent = {"train": 0.0, "aggregate": 0.0, "evaluate": 0.0}

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
    eng.evaluate_models = timed("evaluate", eng.evaluate_models)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = session.run(sim_seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emit("breakdown", rounds=result.rounds_completed, wall_seconds=wall,
         train_seconds=spent["train"], aggregate_seconds=spent["aggregate"],
         evaluate_seconds=spent["evaluate"],
         host_seconds=wall - sum(spent.values()),
         flushes=eng.flushes, jobs=eng.jobs_run)


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
    build.build(["fused_agg"])                       # fails loudly
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln for ln in build.build_log("fused_agg").splitlines()
                if "registers" in ln or "Compiling" in ln])

    rows = kernel_phase(dev)
    session, models = session_phase(sim_seconds=40.0)
    out, codes, scales = agg_quant_phase(session, models)
    launches = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    agg_quant_check(session, models, out, codes, scales)
    breakdown_phase(sim_seconds=40.0)
    profile_phase(sim_seconds=20.0)
    engines_phase()

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
            "library_ms": at_session["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
