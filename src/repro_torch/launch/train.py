"""Training launcher.

``--mode sim`` is the paper's deployment form: a discrete-event WAN
session running MoDeST / FedAvg / D-SGD over n nodes (Figs. 3–6), with the
paper's CNN or MF task or a dense LM of the zoo (``--task lm --arch
NAME``: its 2-layer smoke variant, ``configs.reduced``, on synthetic
Markov-chain text), on the card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.train --mode sim \\
        --algo modest --task mf --nodes 50 --duration 300 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --task lm \\
        --arch tinyllama-1.1b --nodes 8 --duration 60 --device cpu

The session's evaluation history is written as CSV to ``--out`` (stdout
when omitted), one row per evaluated round. With ``--ckpt PATH`` a MoDeST
or FedAvg session saves its latest aggregated model there
(``repro_torch.checkpoint``, meta ``{"round", "algo", "task"}``) whenever
``--ckpt-every`` rounds have passed since the last save. The options that
``--mode sim`` reads keep the reference launcher's names and defaults.
Not part of this package yet, and raising ``NotImplementedError``:
``--mode mesh`` (ROADMAP A12); the options that only it reads (``--lr``,
``--full-size``, ``--model-parallel``, ...) are left out until then, so
the parser rejects them.
"""

from __future__ import annotations

import argparse


def run_sim(args):
    """Build and run the session that ``args`` describe; returns its
    :class:`~repro_torch.sim.runner.SessionResult`."""
    from repro_torch.config import ModestConfig, TrainConfig
    from repro_torch.data import (make_classification_task, make_lm_task,
                                  make_mf_task)
    from repro_torch.models.tasks import cnn_task, lm_task, mf_task
    from repro_torch.sim.runner import (DSGDSession, ModestSession,
                                        fedavg_session)
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.logging import CSVLogger

    device = resolve_device(args.device)
    if args.task == "cnn":
        data = make_classification_task(args.nodes, iid=args.iid,
                                        seed=args.seed)
        task = cnn_task(device=device)
    elif args.task == "mf":
        data = make_mf_task(args.nodes, n_items=500, seed=args.seed)
        task = mf_task(device=device, mf_users=args.nodes, mf_items=500)
    else:
        data = make_lm_task(args.nodes, iid=args.iid, seed=args.seed)
        task = lm_task(args.arch, device=device)

    mcfg = ModestConfig(n_nodes=args.nodes, sample_size=args.sample_size,
                        n_aggregators=args.aggregators,
                        success_fraction=args.sf, ping_timeout=args.timeout)
    tcfg = TrainConfig(batch_size=args.batch_size, seed=args.seed)
    common = dict(n_nodes=args.nodes, tcfg=tcfg, task=task, data=data,
                  seed=args.seed, eval_every_rounds=args.eval_every,
                  device=device)
    if args.algo == "dsgd":
        session = DSGDSession(**common)
    elif args.algo == "fedavg":
        session = fedavg_session(mcfg=mcfg, **common)
    else:
        session = ModestSession(mcfg=mcfg, **common)

    if args.ckpt and args.algo in ("modest", "fedavg"):
        # persist the latest aggregated model periodically
        from repro_torch import checkpoint

        orig_hook = session._on_aggregate
        state = {"last": 0}

        def hook(k, params, node):
            orig_hook(k, params, node)
            if params is not None and k - state["last"] >= args.ckpt_every:
                state["last"] = k
                checkpoint.save(args.ckpt, params,
                                meta={"round": k, "algo": args.algo,
                                      "task": args.task})

        session._on_aggregate = hook
        for node in session.nodes.values():
            node.on_aggregate = hook

    res = session.run(args.duration)
    log = CSVLogger(args.out)
    for h in res.history:
        log.log(algo=args.algo, **h)
    log.close()
    print(f"[train:sim] algo={args.algo} rounds={res.rounds_completed} "
          f"total={res.usage['total_bytes'] / 1e9:.2f}GB "
          f"min={res.usage['min_node_bytes'] / 1e6:.1f}MB "
          f"max={res.usage['max_node_bytes'] / 1e6:.1f}MB "
          f"overhead={res.overhead_fraction:.3%} final={res.final_metrics}")
    return res


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None) and run; returns the
    session's result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="sim", choices=["sim", "mesh"])
    ap.add_argument("--algo", default="modest",
                    choices=["modest", "fedavg", "dsgd", "local"])
    ap.add_argument("--task", default="cnn", choices=["cnn", "mf", "lm"])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="dense LM of --task lm (its reduced variant)")
    ap.add_argument("--nodes", type=int, default=50)
    ap.add_argument("--sample-size", type=int, default=10)
    ap.add_argument("--aggregators", type=int, default=2)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--timeout", type=float, default=1.0)
    ap.add_argument("--batch-size", type=int, default=20)
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path for the aggregated global model")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.mode == "mesh":
        raise NotImplementedError("--mode mesh: the device-mesh trainer is "
                                  "not part of this package yet (ROADMAP "
                                  "A12)")
    return run_sim(args)


if __name__ == "__main__":
    main()
