"""The paper's three headline metrics, computed from a SessionResult.

Plexus reports its gains as ratios over baselines on exactly three axes
(§4.5, Table 4, Fig. 5):

* **time-to-accuracy** — simulated seconds until the model-quality curve
  first reaches a target value (1.2–8.3× claimed),
* **communication volume** — total bytes moved by the protocol
  (2.4–15.3× claimed),
* **training resources** — node-seconds of on-device compute
  (6.4–370× claimed).

This module computes each from the artifacts every session driver already
collects (``history``, ``usage_summary()``, per-node ``train_seconds``),
so a single run yields all three; :func:`compare` forms the paper-style
ratio table between algorithms.

Abstract (byte-only) sessions have no learning curve; for those,
:func:`time_to_round` is the time-to-accuracy proxy — with a fixed
learning task, "reach accuracy X" and "complete round R" coincide (the
paper's own Table 3 fixes target accuracy per dataset and measures the
wall-clock to get there).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class EvalMetrics:
    """One session, the three paper axes (None = never reached)."""

    algo: str
    time_to_target_s: Optional[float]
    communication_bytes: int
    train_node_seconds: float
    rounds_completed: int = 0
    target: Optional[float] = None
    extras: dict = field(default_factory=dict)

    def as_row(self) -> dict:
        return {
            "algo": self.algo,
            "time_to_target_s": self.time_to_target_s,
            "communication_gb": round(self.communication_bytes / 1e9, 4),
            "train_node_hours": round(self.train_node_seconds / 3600.0, 4),
            "rounds": self.rounds_completed,
            **self.extras,
        }


def time_to_metric(result, target: float, *, key: str = "accuracy",
                   higher_is_better: bool = True) -> Optional[float]:
    """Simulated seconds until ``history[key]`` first reaches ``target``.

    Returns None when the run never got there (the honest answer — papers
    sometimes report the budget cap instead, which hides divergence).
    """
    for h in sorted(result.history, key=lambda h: h["t"]):
        if key not in h:
            continue
        v = h[key]
        if (v >= target) if higher_is_better else (v <= target):
            return float(h["t"])
    return None


def time_to_round(result, round_k: int) -> Optional[float]:
    """Simulated seconds until round ``round_k`` first completed
    anywhere in the population — the time-to-accuracy proxy for
    byte-only (AbstractTask) sessions. Comparable across regimes and
    population sizes for one algorithm; across *algorithms* a round is
    not a fixed amount of learning (see docs/EVAL.md), so use a real
    task + :func:`time_to_metric` for that comparison."""
    for t, k in result.round_times:
        if k >= round_k:
            return float(t)
    return None


def communication_volume(result) -> Dict[str, int]:
    """Bytes moved, straight from ``network.usage_summary()`` (Table 4):
    ``total`` counts incoming+outgoing summed over nodes, ``sent`` each
    byte once; ``by_type`` splits payload vs protocol overhead."""
    u = result.usage or {}
    return {
        "total": int(u.get("total_bytes", 0)),
        "sent": int(u.get("sent_bytes", 0)),
        "max_node": int(u.get("max_node_bytes", 0)),
        "by_type": dict(u.get("by_type", {})),
    }


def training_resources(result) -> Dict[str, float]:
    """Node-seconds of on-device compute (the paper's 'resource usage'
    axis). Includes compute burned by trainings that were cancelled or
    crashed mid-round — wasted work is exactly what D-SGD pays under
    churn and what sampling is supposed to avoid."""
    return {
        "train_node_seconds": float(result.train_node_seconds),
        "trainings_completed": int(result.trainings_completed),
    }


def evaluate_session(result, *, algo: str = "?",
                     target: Optional[float] = None,
                     target_key: str = "accuracy",
                     target_round: Optional[int] = None) -> EvalMetrics:
    """All three paper metrics from one finished session.

    Pass ``target`` (+ ``target_key``) for learning runs with a real
    quality curve, or ``target_round`` for byte-only runs.
    """
    if target is not None:
        tta = time_to_metric(result, target, key=target_key)
    elif target_round is not None:
        tta = time_to_round(result, target_round)
    else:
        tta = None
    return EvalMetrics(
        algo=algo,
        time_to_target_s=tta,
        communication_bytes=communication_volume(result)["sent"],
        train_node_seconds=training_resources(result)["train_node_seconds"],
        rounds_completed=int(result.rounds_completed),
        target=target if target is not None else target_round,
    )


def compare(metrics: Dict[str, EvalMetrics],
            baseline_of: str = "modest") -> Dict[str, dict]:
    """Paper-style ratio table: for every algorithm, how many × more
    time / bytes / compute it needs than ``baseline_of`` (MoDeST). Ratios
    > 1 mean the baseline wins that axis; inf when the other algorithm
    never reached the target at all (e.g. D-SGD wedged under churn)."""
    base = metrics.get(baseline_of)
    if base is None:
        raise KeyError(f"no '{baseline_of}' entry to compare against")

    def ratio(x, y):
        if y in (None, 0):
            return None
        if x is None:
            return math.inf
        return round(x / y, 3)

    out = {}
    for name, m in metrics.items():
        if name == baseline_of:
            continue
        out[name] = {
            "time_to_target_x": ratio(m.time_to_target_s,
                                      base.time_to_target_s),
            "communication_x": ratio(float(m.communication_bytes),
                                     float(base.communication_bytes)),
            "train_resources_x": ratio(m.train_node_seconds,
                                       base.train_node_seconds),
        }
    return out
