"""End-to-end LM training through the full MoDeST protocol stack on the
PyTorch package: a transformer LM (tinyllama family, size configurable)
trained for a few hundred rounds over simulated WAN nodes, on the card
(``--device cpu`` for the CPU). The twin of ``examples/train_lm.py``: the
same command line, session and printed lines.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
    PYTHONPATH=src python examples/torch_train_lm.py --d-model 768 --layers 12 \\
        --duration 3600            # ~100M params

The same model/protocol scales to the production mesh via
``repro_torch.launch.train --mode mesh`` and the dry run's configs
(``repro_torch.launch.dryrun``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.data import make_lm_task
from repro_torch.models.tasks import lm_task
from repro_torch.sim.runner import ModestSession
from repro_torch.utils.pytree import tree_num_params


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--seq-len", type=int, default=96)
    ap.add_argument("--duration", type=float, default=240.0)
    ap.add_argument("--sample-size", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def run(args):
    """The task and the session of ``args`` (from :func:`parse`), run for
    ``args.duration`` simulated seconds: ``(task, session, result)``."""
    task = lm_task("tinyllama-1.1b", reduce=True,
                   n_layers=args.layers, d_model=args.d_model,
                   vocab=args.vocab, d_ff=4 * args.d_model,
                   tcfg=TrainConfig(optimizer="sgd", lr=0.1, batch_size=8),
                   device=args.device)
    data = make_lm_task(args.nodes, samples_per_node=24,
                        seq_len=args.seq_len + 1, vocab=args.vocab,
                        iid=False, seed=0)
    session = ModestSession(
        n_nodes=args.nodes,
        mcfg=ModestConfig(n_nodes=args.nodes, sample_size=args.sample_size,
                          n_aggregators=2, ping_timeout=1.0),
        tcfg=TrainConfig(optimizer="sgd", lr=0.1, batch_size=8),
        task=task, data=data, seed=0, eval_every_rounds=20,
        device=args.device)
    return task, session, session.run(args.duration)


def report(args, task, res) -> None:
    n_params = tree_num_params(task.init_params(0))
    print(f"model: {args.layers}L d={args.d_model} vocab={args.vocab} "
          f"-> {n_params / 1e6:.1f}M params "
          f"({task.model_bytes() / 1e6:.1f} MB on the wire)")
    print(f"rounds completed: {res.rounds_completed}")
    for h in res.history:
        if "loss" in h:
            print(f"  t={h['t']:7.1f}s round={h['round']:4d} "
                  f"test_loss={h['loss']:.4f}")
    print(f"network total: {res.usage['total_bytes'] / 1e9:.2f} GB, "
          f"overhead {res.overhead_fraction:.2%}")


def main(argv=None):
    """Train, then print the model line and the curve; returns
    ``(task, session, result)``."""
    args = parse(argv)
    task, session, res = run(args)
    report(args, task, res)
    return task, session, res


if __name__ == "__main__":
    main()
