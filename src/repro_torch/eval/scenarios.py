"""Scenario-matrix runner: algorithm × trace regime × seed, in one call.

The paper's comparisons (Tables 3–4, Figs. 5–6) are a matrix: each
algorithm (MoDeST, D-SGD, Gossip, emulated FedAvg) under each
heterogeneity regime, repeated over seeds. This module makes that matrix
one invocation::

    from repro_torch.eval import scenario_matrix

    out = scenario_matrix(n=100, seeds=(0, 1, 2), duration=300.0)
    out["summary"]            # per (algo, regime): the three paper metrics
    out["ratios"]["diurnal"]  # baselines vs MoDeST, paper-style × factors

Sessions run byte-only (:class:`~repro_torch.core.tasks.AbstractTask` at a real
model size), so the matrix covers paper-scale populations without doing
FLOPs; time-to-accuracy uses the round-R proxy (see
:mod:`repro_torch.eval.metrics`). Caveat: a round does different amounts of
learning per algorithm (MoDeST trains s sampled nodes, D-SGD all n,
a gossip cycle is one node's counter), so byte-only
``time_to_target_x`` ratios are comparable *within* an algorithm across
regimes/populations, not across algorithms — pass
``task=``/``data=``/``target=`` (a real learning task and accuracy
target) for the paper's cross-algorithm time-to-accuracy axis; the
communication and training-resource axes are unit-compatible either
way (docs/EVAL.md).

Like every entry point of the package, ``run_scenario`` and
``scenario_matrix`` take ``device=None``, which means the card (and raises
without one); pass ``device="cpu"`` to run the sessions on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.tasks import AbstractTask
from repro_torch.eval.metrics import EvalMetrics, compare, evaluate_session
from repro_torch.serve import SERVE_REGIMES
from repro_torch.sim.fault import (AggregatorKill, Drop, Duplicate,
                                   FaultSchedule, Jitter, LatencySpike,
                                   Partition, Straggler)
from repro_torch.sim.runner import (DSGDSession, GossipSession,
                                    ModestSession, fedavg_session)
from repro_torch.traces import (diurnal_profile, flash_crowd_profile,
                                homogeneous_profile, starved_cohort_profile)

REGIMES = {
    "homogeneous": homogeneous_profile,
    "diurnal": diurnal_profile,
    "flash_crowd": flash_crowd_profile,
    "starved_cohort": starved_cohort_profile,
}


def _lossy_wan(seed: int, duration: float, n: int = 64) -> FaultSchedule:
    """Imperfect-but-functional WAN: steady loss, bounded reordering,
    spurious retransmits."""
    return FaultSchedule(rules=(Drop(p=0.1), Jitter(max_delay=0.2),
                                Duplicate(p=0.05, gap=0.2)), seed=seed)


def _flaky_core(seed: int, duration: float, n: int = 64) -> FaultSchedule:
    """Infrastructure-level incidents: a mid-run partition of a quarter
    of the population, a latency brownout, and a targeted aggregator
    kill with Alg.-2 rejoin."""
    cut = tuple(str(i) for i in range(max(2, n // 4)))
    return FaultSchedule(rules=(
        Partition(groups=(cut,), t0=0.3 * duration, t1=0.4 * duration),
        LatencySpike(extra=1.5, t0=0.55 * duration, t1=0.65 * duration),
        AggregatorKill(round_k=5, rejoin_after=0.1 * duration),
    ), seed=seed)


def _stragglers(seed: int, duration: float, n: int = 64) -> FaultSchedule:
    """Transient compute slowdown of a quarter of the population for the
    middle half of the run."""
    return FaultSchedule(rules=(
        Straggler(nodes=max(1, n // 4), factor=5.0, t0=0.25 * duration,
                  t1=0.75 * duration),), seed=seed)


# Fault regimes composing with the trace regimes above (docs/FAULTS.md):
# every factory is (seed, duration, n) -> FaultSchedule, so schedules
# scale with the scenario horizon and population and stay
# seed-reproducible.
FAULT_REGIMES = {
    "lossy_wan": _lossy_wan,
    "flaky_core": _flaky_core,
    "stragglers": _stragglers,
}

_SESSIONS = {
    "modest": ModestSession,
    "dsgd": DSGDSession,
    "gossip": GossipSession,
    "fedavg": fedavg_session,
}

DEFAULT_ALGOS = ("modest", "dsgd", "gossip", "fedavg")


@dataclass(frozen=True)
class Scenario:
    """One cell of the matrix."""

    algo: str                         # modest | dsgd | gossip | fedavg
    regime: str                       # key of REGIMES
    n: int = 64
    seed: int = 0
    duration: float = 300.0
    model_bytes: int = 346_000        # CIFAR-10 CNN (Table 3)
    target_round: int = 20            # time-to-accuracy proxy round
    contention: bool = True
    fault: Optional[str] = None       # key of FAULT_REGIMES (None = clean)
    serve: Optional[str] = None       # key of SERVE_REGIMES (None = none)

    def profile(self):
        try:
            factory = REGIMES[self.regime]
        except KeyError:
            raise ValueError(f"unknown regime {self.regime!r}; "
                             f"one of {sorted(REGIMES)}") from None
        return factory(self.n, seed=self.seed)

    def fault_schedule(self):
        if self.fault is None:
            return None
        try:
            factory = FAULT_REGIMES[self.fault]
        except KeyError:
            raise ValueError(f"unknown fault regime {self.fault!r}; "
                             f"one of {sorted(FAULT_REGIMES)}") from None
        return factory(self.seed, self.duration, self.n)

    def serve_config(self):
        if self.serve is None:
            return None
        try:
            factory = SERVE_REGIMES[self.serve]
        except KeyError:
            raise ValueError(f"unknown serve regime {self.serve!r}; "
                             f"one of {sorted(SERVE_REGIMES)}") from None
        return factory(self.n, self.seed, self.duration)


def run_scenario(sc: Scenario, *, task=None, data=None,
                 target: Optional[float] = None,
                 target_key: str = "accuracy",
                 device=None) -> Tuple[object, EvalMetrics]:
    """Run one cell on ``device`` (None = the card); returns
    ``(SessionResult, EvalMetrics)``.

    The session wall-clock and event count ride along in
    ``EvalMetrics.extras`` so scale benchmarks can reuse the runner.
    """
    try:
        session_cls = _SESSIONS[sc.algo]
    except KeyError:
        raise ValueError(f"unknown algo {sc.algo!r}; "
                         f"one of {sorted(_SESSIONS)}") from None
    task = task or AbstractTask(model_bytes_=sc.model_bytes)
    t0 = time.perf_counter()  # noqa: DL002(wall_s is host benchmark timing, never simulation semantics)
    session = session_cls(profile=sc.profile(), task=task, data=data,
                          seed=sc.seed, contention=sc.contention,
                          fault=sc.fault_schedule(), serve=sc.serve_config(),
                          device=device)
    result = session.run(sc.duration)
    wall = time.perf_counter() - t0  # noqa: DL002(wall_s is host benchmark timing, never simulation semantics)
    metrics = evaluate_session(
        result, algo=sc.algo,
        target=target, target_key=target_key,
        target_round=None if target is not None else sc.target_round)
    metrics.extras.update({
        "regime": sc.regime, "n": sc.n, "seed": sc.seed,
        "duration_s": sc.duration,
        "wall_s": round(wall, 3),
        "sim_events": session.sim.events_processed,
        "events_per_s": int(session.sim.events_processed / max(wall, 1e-9)),
        "churn_events": result.churn_events,
        "fault": sc.fault or "clean",
        "fault_injections": int(sum(result.fault_stats.values())),
    })
    if result.serving is not None:
        s = result.serving
        metrics.extras.update({
            "serve": sc.serve or "custom",
            "requests": s["requests"],
            "served": s["served"],
            "p50_latency_s": s["p50_latency_s"],
            "p99_latency_s": s["p99_latency_s"],
            "staleness_mean_rounds": s["staleness_mean_rounds"],
            "snapshot_mb": round(s["snapshot_bytes"] / 1e6, 3),
        })
    return result, metrics


def _mean_or_none(vals):
    vals = [v for v in vals if v is not None]
    return round(float(np.mean(vals)), 3) if vals else None


def scenario_matrix(*, algos: Sequence[str] = DEFAULT_ALGOS,
                    regimes: Iterable[str] = tuple(REGIMES),
                    faults: Sequence[Optional[str]] = (None,),
                    serve: Sequence[Optional[str]] = (None,),
                    n: int = 64, seeds: Sequence[int] = (0,),
                    duration: float = 300.0, model_bytes: int = 346_000,
                    target_round: int = 20, contention: bool = True,
                    task=None, data=None, target: Optional[float] = None,
                    device=None) -> Dict[str, object]:
    """Sweep the full matrix; returns ``rows`` (one per cell × seed),
    ``summary`` (seed-averaged, one per cell) and ``ratios`` (per
    regime × fault × serve, baselines vs MoDeST). ``faults`` adds the
    fault-injection axis: each entry is a :data:`FAULT_REGIMES` key or
    None for the clean fabric. ``serve`` adds the query-plane axis: each
    entry is a ``repro_torch.serve.SERVE_REGIMES`` key or None for no serving
    deployment (rows then carry staleness, p50/p99 request latency and
    snapshot fan-out megabytes). Ratio keys append ``"+fault"`` /
    ``"+serve:name"`` for the non-default cells. Every session runs on
    ``device`` (None = the card)."""
    rows, summary, ratios = [], [], {}
    for regime in regimes:
        for fault in faults:
            for srv in serve:
                per_algo: Dict[str, EvalMetrics] = {}
                for algo in algos:
                    runs = []
                    for seed in seeds:
                        sc = Scenario(algo=algo, regime=regime, n=n,
                                      seed=seed, duration=duration,
                                      model_bytes=model_bytes,
                                      target_round=target_round,
                                      contention=contention, fault=fault,
                                      serve=srv)
                        _, m = run_scenario(sc, task=task, data=data,
                                            target=target, device=device)
                        runs.append(m)
                        rows.append(m.as_row())
                    mean = EvalMetrics(
                        algo=algo,
                        time_to_target_s=_mean_or_none(
                            [m.time_to_target_s for m in runs]),
                        communication_bytes=int(np.mean(
                            [m.communication_bytes for m in runs])),
                        train_node_seconds=float(np.mean(
                            [m.train_node_seconds for m in runs])),
                        rounds_completed=int(np.mean(
                            [m.rounds_completed for m in runs])),
                        target=runs[0].target,
                        extras={"regime": regime, "fault": fault or "clean",
                                "serve": srv or "off",
                                "n": n, "seeds": len(seeds),
                                "reached_target": sum(
                                    m.time_to_target_s is not None
                                    for m in runs)},
                    )
                    if srv is not None:
                        mean.extras.update({
                            "p50_latency_s": _mean_or_none(
                                [m.extras.get("p50_latency_s")
                                 for m in runs]),
                            "p99_latency_s": _mean_or_none(
                                [m.extras.get("p99_latency_s")
                                 for m in runs]),
                            "staleness_mean_rounds": _mean_or_none(
                                [m.extras.get("staleness_mean_rounds")
                                 for m in runs]),
                            "snapshot_mb": _mean_or_none(
                                [m.extras.get("snapshot_mb")
                                 for m in runs]),
                        })
                    per_algo[algo] = mean
                    summary.append(mean.as_row())
                if "modest" in per_algo and len(per_algo) > 1:
                    key = regime
                    if fault is not None:
                        key += f"+{fault}"
                    if srv is not None:
                        key += f"+serve:{srv}"
                    ratios[key] = compare(per_algo, baseline_of="modest")
    return {"rows": rows, "summary": summary, "ratios": ratios}
