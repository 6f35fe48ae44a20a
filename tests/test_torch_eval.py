"""``repro_torch.eval`` — the cases of ``test_eval.py`` mirrored on the
port: metric math on synthetic results, and scenario matrices whose rows,
seed-averaged summaries and ratio tables equal the reference's exactly,
leaving out the wall-clock columns (``wall_s``, ``events_per_s``)."""

import math

import pytest

import repro.eval as jeval
from repro_torch.eval import (EvalMetrics, compare, evaluate_session,
                              scenario_matrix, time_to_metric, time_to_round)
from repro_torch.sim.runner import SessionResult
from test_torch_threads import one_torch_thread  # noqa: F401

WALL = ("wall_s", "events_per_s")


def _result(**kw):
    r = SessionResult()
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _same_matrix(out, ref):
    def strip(rows):
        return [{k: v for k, v in r.items() if k not in WALL} for r in rows]

    assert strip(out["rows"]) == strip(ref["rows"])
    assert out["summary"] == ref["summary"]
    assert out["ratios"] == ref["ratios"]


def test_time_to_metric_first_crossing():
    r = _result(history=[{"t": 10.0, "accuracy": 0.2},
                         {"t": 30.0, "accuracy": 0.55},
                         {"t": 20.0, "accuracy": 0.5},
                         {"t": 40.0, "accuracy": 0.4}])   # non-monotone ok
    assert time_to_metric(r, 0.5) == 20.0                 # sorted by t
    assert time_to_metric(r, 0.9) is None
    assert time_to_metric(r, 0.45, key="accuracy",
                          higher_is_better=False) == 10.0


def test_time_to_round_proxy():
    r = _result(round_times=[(5.0, 1), (9.0, 3), (12.0, 4)])
    assert time_to_round(r, 2) == 9.0                     # first k >= 2
    assert time_to_round(r, 9) is None


def test_evaluate_session_collects_three_axes():
    r = _result(round_times=[(5.0, 1), (8.0, 2)],
                usage={"total_bytes": 100, "sent_bytes": 60},
                train_node_seconds=12.5, trainings_completed=3,
                rounds_completed=2)
    m = evaluate_session(r, algo="modest", target_round=2)
    assert m.time_to_target_s == 8.0
    assert m.communication_bytes == 60
    assert m.train_node_seconds == 12.5
    assert m.as_row() == jeval.evaluate_session(
        r, algo="modest", target_round=2).as_row()


def test_compare_ratios_and_wedged_baseline():
    base = EvalMetrics("modest", 10.0, 1000, 50.0)
    slow = EvalMetrics("dsgd", 30.0, 15000, 500.0)
    dead = EvalMetrics("gossip", None, 400, 25.0)
    out = compare({"modest": base, "dsgd": slow, "gossip": dead})
    assert out["dsgd"] == {"time_to_target_x": 3.0,
                           "communication_x": 15.0,
                           "train_resources_x": 10.0}
    assert out["gossip"]["time_to_target_x"] == math.inf  # never reached
    with pytest.raises(KeyError):
        compare({"dsgd": slow})


def test_scenario_matrix_single_invocation_covers_algos_and_regimes():
    kw = dict(algos=("modest", "dsgd", "fedavg"),
              regimes=("homogeneous", "diurnal"),
              n=16, seeds=(0,), duration=60.0, target_round=3)
    out = scenario_matrix(device="cpu", **kw)
    _same_matrix(out, jeval.scenario_matrix(**kw))
    algos = {row["algo"] for row in out["summary"]}
    regimes = {row["regime"] for row in out["summary"]}
    assert algos == {"modest", "dsgd", "fedavg"}
    assert regimes == {"homogeneous", "diurnal"}
    assert len(out["rows"]) == 6
    for row in out["rows"]:
        assert row["communication_gb"] > 0
        assert row["train_node_hours"] >= 0
    # ratios exist vs the modest baseline for every regime
    assert set(out["ratios"]) == {"homogeneous", "diurnal"}
    for regime in out["ratios"].values():
        assert set(regime) == {"dsgd", "fedavg"}
        for axes in regime.values():
            assert set(axes) == {"time_to_target_x", "communication_x",
                                 "train_resources_x"}


def test_unknown_algo_and_regime_raise():
    from repro_torch.eval import Scenario, run_scenario
    with pytest.raises(ValueError):
        run_scenario(Scenario(algo="sgd??", regime="diurnal"), device="cpu")
    with pytest.raises(ValueError):
        Scenario(algo="modest", regime="lunar").profile()
    with pytest.raises(ValueError):
        Scenario(algo="modest", regime="diurnal",
                 serve="stampede").serve_config()


def test_scenario_matrix_fault_axis():
    """Fault regimes compose with trace regimes as a matrix axis: rows
    are tagged, schedules actually inject, ratio keys distinguish the
    faulty cells, and every number is the reference's."""
    kw = dict(algos=("modest", "gossip"), regimes=("homogeneous",),
              faults=(None, "lossy_wan"), n=16, seeds=(0, 1), duration=60.0,
              target_round=3)
    out = scenario_matrix(device="cpu", **kw)
    _same_matrix(out, jeval.scenario_matrix(**kw))
    assert len(out["rows"]) == 8
    by_fault = {row["fault"] for row in out["rows"]}
    assert by_fault == {"clean", "lossy_wan"}
    for row in out["rows"]:
        if row["fault"] == "lossy_wan":
            assert row["fault_injections"] > 0
        else:
            assert row["fault_injections"] == 0
    assert set(out["ratios"]) == {"homogeneous", "homogeneous+lossy_wan"}


def test_unknown_fault_regime_raises():
    from repro_torch.eval import FAULT_REGIMES, Scenario
    with pytest.raises(ValueError):
        Scenario(algo="modest", regime="diurnal",
                 fault="gremlins").fault_schedule()
    assert set(FAULT_REGIMES) == set(jeval.FAULT_REGIMES)
