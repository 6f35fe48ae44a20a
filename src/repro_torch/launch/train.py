"""Training launcher.

``--mode sim`` is the paper's deployment form: a discrete-event WAN
session running MoDeST / FedAvg / D-SGD over n nodes (Figs. 3–6), with the
paper's CNN or MF task or an LM of the zoo (``--task lm --arch NAME``:
its 2-layer smoke variant, ``configs.reduced``, on synthetic Markov-chain
text), on the card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.train --mode sim \\
        --algo modest --task mf --nodes 50 --duration 300 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --task lm \\
        --arch tinyllama-1.1b --nodes 8 --duration 60 --device cpu

The session's evaluation history is written as CSV to ``--out`` (stdout
when omitted), one row per evaluated round. With ``--ckpt PATH`` a MoDeST
or FedAvg session saves its latest aggregated model there
(``repro_torch.checkpoint``, meta ``{"round", "algo", "task"}``) whenever
``--ckpt-every`` rounds have passed since the last save. ``--task lm``
takes any LM of the zoo: dense, moe, ssm (rwkv) and hybrid (hymba) archs
train; an audio or vlm arch stops at its first step with ``KeyError``,
as the reference does (its batches carry no ``frames`` /
``image_embeds``; ROADMAP C11).

``--mode mesh`` is the datacenter form: the round step of
``core.distributed.DistributedTrainer`` over P participant replicas, with
the MoDeST protocol (hash sampling and failure masks) running host-side.
``--devices N`` makes a ``data`` x ``model`` mesh of N entries
(``launch.mesh.make_mesh_from_config``), each naming ``--device`` (the
card by default): the P = N / ``--model-parallel`` participants (for a
``data_rank`` arch) lie stacked on that one device, the state placed by
its specs (``DistributedTrainer.shard_state``). The reduced config
unless ``--full-size``; SGD at ``--lr``; the batches carry tokens and
labels.

    PYTHONPATH=src python -m repro_torch.launch.train --mode mesh \\
        --devices 4 --model-parallel 2 --arch tinyllama-1.1b --rounds 5 \\
        [--device cpu] [--world]

With ``--world`` the mesh is a world of ``--devices`` ranks, one process a
device (``launch.world``; on the card, one card a rank where there are
enough, else ranks sharing a card; ``--device cpu``: gloo ranks on the
CPU): the participants are split over ``data`` and each replica's leaves
over ``model`` (tensor parallelism), every rank draws the same samples,
batches and weights, and rank 0 prints the round lines. :func:`main`
returns ``{"history", "ranks"}`` then: rank 0's history and each rank's
report (``launch.world.rank_report``, its ``history_hash`` and
``change_sketch`` added).

The options keep the reference launcher's names and defaults, and add
``--world`` and, for the mesh mode, the serving launcher's ``--set
KEY=VALUE`` (a field of the model's config, such as a depth cut).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


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


WORLD_TIMEOUT = 3600.0     # seconds a world of the launcher may take


def run_mesh(args):
    """Run ``args.rounds`` mesh-form rounds; returns ``{"trainer",
    "state", "history", "change_sketch"}``, one history entry a round
    (``round``, ``active``, ``loss``, ``seconds``) and the sketch of the
    first replica's change over the rounds
    (``DistributedTrainer.param_sketch``), or with ``args.world`` the
    world's ``{"history", "ranks"}``."""
    if args.world:
        from repro_torch.launch.world import run_world
        ranks = run_world(_mesh_rank, _world_size(args), device=args.device,
                          args=(args,), timeout=WORLD_TIMEOUT)
        return {"history": ranks[0]["history"], "ranks": ranks}
    return _mesh_rounds(args)


def _world_size(args) -> int:
    if not args.devices:
        raise SystemExit("--world needs --devices: the number of ranks")
    return args.devices


def _mesh_rank(world, args):
    """One rank of ``--mode mesh --world``: the rounds, its report."""
    import hashlib
    import json

    from repro_torch.launch.world import rank_report

    t0 = time.perf_counter()  # noqa: DL002(a rank's seconds, reported only)
    out = _mesh_rounds(args, quiet=world.rank != 0)
    seconds = time.perf_counter() - t0  # noqa: DL002(a rank's seconds, reported only)
    hist = [{k: h[k] for k in ("round", "active", "loss")}
            for h in out["history"]]
    report = rank_report(world, seconds)
    report["history"] = out["history"]
    report["change_sketch"] = out["change_sketch"].tolist()
    report["history_hash"] = hashlib.sha256(
        json.dumps(hist).encode()).hexdigest()[:16]
    return report


def _mesh_rounds(args, quiet: bool = False):
    import torch

    from repro_torch import configs
    from repro_torch.config import MeshConfig, TrainConfig, parse_overrides
    from repro_torch.core.distributed import DistributedTrainer
    from repro_torch.core.hashing import select_sample
    from repro_torch.data import make_lm_task
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    n_dev = args.devices or (torch.cuda.device_count()
                             if device.type == "cuda" else 1)
    model_par = args.model_parallel
    if model_par <= 0 or n_dev % model_par != 0:
        raise SystemExit(
            f"[train:mesh] device_count={n_dev} is not divisible by "
            f"--model-parallel {model_par}; pick a model-parallel degree "
            "that divides the device count")
    data_par = n_dev // model_par
    mesh_cfg = MeshConfig(multi_pod=False, data=data_par, model=model_par)
    mesh = make_mesh_from_config(mesh_cfg, device)

    cfg = configs.get_config(args.arch)
    if not args.full_size:
        cfg = configs.reduced(cfg)
    cfg = cfg.with_(**parse_overrides(args.set))
    tcfg = TrainConfig(optimizer="sgd", lr=args.lr,
                       batch_size=args.batch_size, seed=args.seed)
    trainer = DistributedTrainer(cfg, tcfg, mesh_cfg, strategy=args.algo,
                                 mesh=mesh, device=device)
    P = trainer.policy.n_participants

    # Host-side MoDeST protocol: population of client ids; each round the
    # hash sampler picks P clients; crash/straggler masks map to weights.
    population = [f"client-{i}" for i in range(args.nodes)]
    data = make_lm_task(args.nodes, seq_len=args.seq_len + 1,
                        vocab=cfg.vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed)

    state = trainer.init_state(args.seed)
    start = trainer.param_sketch(state)
    step = trainer.jit_train_step()
    history = []
    for r in range(1, args.rounds + 1):
        sample_ids = select_sample(population, r, P)
        idxs = [population.index(s) for s in sample_ids]
        xs, ys = [], []
        for e in range(args.local_steps):
            x, y = data.pack_sample(idxs, args.batch_size, seed=r * 31 + e)
            xs.append(x[:, :, :args.seq_len])
            ys.append(y[:, :, :args.seq_len])
        batch = {"tokens": torch.as_tensor(np.stack(xs, axis=1),
                                           device=device),
                 "labels": torch.as_tensor(np.stack(ys, axis=1),
                                           device=device)}
        # sf semantics: drop slots that "failed" this round
        weights = (rng.random(P) >= args.failure_rate).astype(np.float32)
        if weights.sum() == 0:
            weights[0] = 1.0
        t0 = time.time()  # noqa: DL002(per-round step timing display)
        state, metrics = step(state, batch,
                              torch.as_tensor(weights, device=device))
        loss = float(metrics["loss"])                       # host sync
        seconds = time.time() - t0  # noqa: DL002(per-round step timing display)
        if not quiet:
            print(f"[train:mesh] round={r} sample={sample_ids[:4]}... "
                  f"active={int(weights.sum())}/{P} loss={loss:.4f} "
                  f"({seconds:.2f}s)")
        history.append({"round": r, "active": int(weights.sum()),
                        "loss": loss, "seconds": seconds})
    if not quiet:
        print("[train:mesh] done")
    return {"trainer": trainer, "state": state, "history": history,
            "change_sketch": trainer.param_sketch(state) - start}


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None) and run; returns the
    session's result (``--mode sim``) or :func:`run_mesh`'s."""
    args = parse_args(argv)
    if args.mode == "mesh":
        return run_mesh(args)
    return run_sim(args)


def parse_args(argv=None):
    """The options of :func:`main` (``sys.argv[1:]`` when None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="sim", choices=["sim", "mesh"])
    ap.add_argument("--algo", default="modest",
                    choices=["modest", "fedavg", "dsgd", "local"])
    ap.add_argument("--task", default="cnn", choices=["cnn", "mf", "lm"])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="LM of --task lm and --mode mesh: any arch of the "
                         "zoo (dense, moe, rwkv, hymba, ...); its reduced "
                         "variant unless --full-size (mesh)")
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
    # mesh mode
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--failure-rate", type=float, default=0.0)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="mesh mode: override a field of the model's config "
                         "(a depth cut: --set n_layers=1)")
    ap.add_argument("--world", action="store_true",
                    help="mesh mode: a world of --devices ranks, one "
                         "process a device (launch.world)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main()
