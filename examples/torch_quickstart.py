"""Quickstart on the PyTorch package: a 12-node MoDeST session training the
paper's CNN on synthetic non-IID data, on the card (``--device cpu`` for
the CPU). The twin of ``examples/quickstart.py``: the same session and the
same printed lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.data import make_classification_task
from repro_torch.models.tasks import cnn_task
from repro_torch.sim.runner import ModestSession

N_NODES, DURATION = 12, 60.0


def run(duration: float = DURATION, device=None):
    """The quickstart session run for ``duration`` simulated seconds:
    ``(session, result)``."""
    n = N_NODES
    data = make_classification_task(n, samples_per_node=40, iid=False, seed=0)
    session = ModestSession(
        n_nodes=n,
        mcfg=ModestConfig(n_nodes=n, sample_size=4, n_aggregators=2,
                          success_fraction=1.0, ping_timeout=1.0),
        tcfg=TrainConfig(batch_size=20),
        task=cnn_task(device=device),
        data=data,
        seed=0,
        eval_every_rounds=10,
        device=device,
    )
    return session, session.run(duration)


def report(res) -> None:
    print(f"rounds completed: {res.rounds_completed}")
    print("accuracy curve (sim-time, round, acc):")
    for h in res.history:
        if "accuracy" in h:
            print(f"  t={h['t']:6.1f}s  round={h['round']:3d}  "
                  f"acc={h['accuracy']:.3f}")
    u = res.usage
    print(f"network: total={u['total_bytes'] / 1e6:.1f}MB  "
          f"min={u['min_node_bytes'] / 1e6:.1f}MB  "
          f"max={u['max_node_bytes'] / 1e6:.1f}MB  "
          f"overhead={res.overhead_fraction:.2%}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    session, res = run(device=args.device)
    report(res)
    return session, res


if __name__ == "__main__":
    main()
