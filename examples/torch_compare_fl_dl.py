"""The paper's central comparison (Fig. 3 + Table 4) on the PyTorch
package: FedAvg vs D-SGD vs MoDeST on the same task, same wall-clock
budget — convergence AND network usage, with every session training the
paper's CNN on the card (``--device cpu`` for the CPU). The twin of
``examples/compare_fl_dl.py``: the same sessions and the same printed
lines.

    PYTHONPATH=src python examples/torch_compare_fl_dl.py [--duration 120] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.data import make_classification_task
from repro_torch.models.tasks import cnn_task
from repro_torch.sim.runner import DSGDSession, ModestSession, fedavg_session

ALGOS = ("fedavg", "dsgd", "modest")


def build(algo: str, nodes: int, task, data, device=None):
    """The session of ``algo`` over ``nodes`` nodes sharing ``task`` and
    ``data``."""
    mcfg = ModestConfig(n_nodes=nodes, sample_size=5, n_aggregators=2,
                        success_fraction=1.0, ping_timeout=1.0)
    tcfg = TrainConfig(batch_size=20)
    if algo == "dsgd":
        return DSGDSession(n_nodes=nodes, tcfg=tcfg, task=task, data=data,
                           seed=0, eval_every_rounds=10, device=device)
    if algo == "fedavg":
        return fedavg_session(n_nodes=nodes, mcfg=mcfg, tcfg=tcfg, task=task,
                              data=data, seed=0, eval_every_rounds=10,
                              device=device)
    return ModestSession(n_nodes=nodes, mcfg=mcfg, tcfg=tcfg, task=task,
                         data=data, seed=0, eval_every_rounds=10,
                         device=device)


def run(nodes: int = 24, duration: float = 120.0, device=None,
        on_session=None):
    """Each algorithm's session run for ``duration`` simulated seconds:
    ``{algo: (session, result)}``. ``on_session(algo, session)``, if given,
    is called on each session before it runs."""
    data = make_classification_task(nodes, samples_per_node=40,
                                    iid=False, alpha=0.5, seed=0)
    task = cnn_task(device=device)
    out = {}
    for algo in ALGOS:
        session = build(algo, nodes, task, data, device)
        if on_session is not None:
            on_session(algo, session)
        out[algo] = (session, session.run(duration))
    return out


def report(results) -> None:
    print(f"{'algo':8s} {'rounds':>6s} {'final_acc':>9s} {'total_GB':>9s} "
          f"{'min_MB':>8s} {'max_MB':>8s}")
    for algo, res in results.items():
        u = res.usage
        print(f"{algo:8s} {res.rounds_completed:6d} "
              f"{res.final_metrics.get('accuracy', float('nan')):9.3f} "
              f"{u['total_bytes'] / 1e9:9.3f} "
              f"{u['min_node_bytes'] / 1e6:8.1f} "
              f"{u['max_node_bytes'] / 1e6:8.1f}")
    dl, md = results["dsgd"].usage, results["modest"].usage
    print(f"\nD-SGD / MoDeST communication ratio: "
          f"{dl['total_bytes'] / md['total_bytes']:.1f}x "
          f"(paper: 3x-14x at full scale)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=24)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = run(args.nodes, args.duration, args.device)
    report({algo: res for algo, (_, res) in out.items()})
    return out


if __name__ == "__main__":
    main()
