"""`repro_torch.eval` — the paper's three headline metrics plus the scenario
matrix that produces them (docs/EVAL.md).

* :mod:`repro_torch.eval.metrics` — time-to-accuracy@target, communication
  volume, and training resources (node-seconds of compute) from one
  finished session, plus paper-style × ratio comparison.
* :mod:`repro_torch.eval.scenarios` — algorithm × trace-regime × seed
  matrix runner (MoDeST vs D-SGD vs Gossip vs emulated FedAvg under
  homogeneous / diurnal / flash-crowd / starved-cohort regimes).
"""

from repro_torch.eval.metrics import (  # noqa: F401
    EvalMetrics,
    communication_volume,
    compare,
    evaluate_session,
    time_to_metric,
    time_to_round,
    training_resources,
)
from repro_torch.eval.scenarios import (  # noqa: F401
    DEFAULT_ALGOS,
    FAULT_REGIMES,
    REGIMES,
    Scenario,
    run_scenario,
    scenario_matrix,
)
