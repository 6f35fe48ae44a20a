"""Dynamic membership + crash resilience (paper Figs. 5-6) on the PyTorch
package: nodes join an in-progress session, then 80% of the population
crashes; MoDeST keeps making progress with the survivors. The twin of
``examples/churn_resilience.py``: the same session (a byte-only task, so
nothing is computed) and the same printed lines; the session is built on
the card unless ``--device`` names another device.

    PYTHONPATH=src python examples/torch_churn_resilience.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.core.tasks import AbstractTask
from repro_torch.sim.runner import ModestSession


def run(device=None):
    """The churn session run for 420 simulated seconds:
    ``(session, result)``."""
    n = 40
    mcfg = ModestConfig(n_nodes=n, sample_size=10, n_aggregators=5,
                        success_fraction=0.9, ping_timeout=2.0,
                        activity_window=8)
    s = ModestSession(n_nodes=n, mcfg=mcfg, tcfg=TrainConfig(),
                      task=AbstractTask(model_bytes_=346_000), seed=0,
                      device=device)

    # three late joiners
    for i in range(3):
        s.schedule_join(20.0 + 15 * i, str(100 + i))
    # crash 80% in waves starting at t=120
    rng = np.random.default_rng(0)
    for i, v in enumerate(rng.choice(n, size=int(0.8 * n), replace=False)):
        s.schedule_crash(120.0 + 6.0 * (i // 4), str(v))

    return s, s.run(420.0)


def report(s, res) -> None:
    print(f"rounds completed: {res.rounds_completed}")
    for lo, hi, label in [(0, 120, "before crashes"),
                          (120, 180, "during crash wave"),
                          (180, 420, "after (20% survivors)")]:
        ks = [k for t, k in res.round_times if lo <= t < hi]
        sd = [d for t, d in res.sample_durations if lo <= t < hi]
        rate = (max(ks) - min(ks)) / (hi - lo) if len(ks) > 1 else 0.0
        print(f"  {label:24s} rounds/s={rate:5.2f} "
              f"avg_sample_ms={1000 * np.mean(sd):7.1f}" if sd else
              f"  {label:24s} rounds/s={rate:5.2f}")
    for i in range(3):
        nid = str(100 + i)
        know = sum(1 for node in s.nodes.values()
                   if node.node_id != nid and node.registry.is_registered(nid))
        print(f"joiner {nid}: known by {know}/{len(s.nodes) - 1} nodes")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    s, res = run(args.device)
    report(s, res)
    return s, res


if __name__ == "__main__":
    main()
