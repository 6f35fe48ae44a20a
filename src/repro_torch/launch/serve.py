"""Serving launcher: batched prefill + token-by-token greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch 4 --prompt-len 32 --new-tokens 16 [--devices 8] \\
        [--full-size] [--set use_flash=true] [--device cpu] [--world] \\
        [--shard-seq]

Runs the reduced config by default and the published one with
``--full-size``, on the card unless ``--device`` names another. Weights come
from a ``torch.Generator`` seeded with ``--seed`` on that device, prompts
from ``numpy.random.default_rng(--seed)``, which also draws the stubbed
frontends' inputs, scaled by 0.1 and cast to ``param_dtype``: ``frames``
(B, n_frames, d_model) for the audio family, ``image_embeds``
(B, image_tokens * anyres_tiles, d_model) for the vlm family, whose image
positions are added to the cache's length. ``--set key=value`` (repeated)
overrides fields of the model's config (``config.parse_overrides``), such
as ``use_flash=true`` for the flash-attention kernel in prefill.

With ``--devices N`` the server runs on a ``data`` x ``model`` mesh of N
entries (``N / --model-parallel`` x ``--model-parallel``) that all name the
serving device: the parameters and the cache are placed by their specs on
that mesh (each spec checked to divide its tensor) and lie whole on the
device, so the tokens are those of one-device serving. A model-parallel
degree that does not divide N stops the launcher.

With ``--world`` as well, the N entries are the devices of a world of N
ranks, one process a device (``launch.world``): the batch is split over
``data``, the parameters by their specs and the cache's kv heads over
``model`` (tensor parallelism; with ``use_flash`` each rank's prefill runs
the flash kernel on its own heads), every rank holds the whole logits and
so draws the same tokens, and rank 0 prints the lines. :func:`main` then
returns rank 0's results with ``ranks``, each rank's report
(``launch.world.rank_report``). ``--shard-seq`` splits the cache's
sequence over ``data`` instead of the batch (the reference's long-context
serving, ``long_500k``): every ``data`` rank runs the whole batch, and
the decode combines the ranks' partial softmaxes. Where the kv heads are
whole over ``model`` (the world rule ``kv_whole``) the cache's sequence
splits over ``model``. In a world the cache's length is rounded up to a
multiple of the world's size, so that the axis its spec splits the
sequence over divides it (the positions past the prompt and the new
tokens are never valid, so the logits are those of the unrounded cache);
each rank's report names that axis (``seq_axes``, the placed cache's).

``main(argv, teacher=ids)`` feeds the decode steps the ``(B, >=
new_tokens - 1)`` ``ids`` in place of its own greedy tokens and returns
the last position's logits of the prefill and of every decode step under
``step_logits`` (fp32, on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


WORLD_TIMEOUT = 3600.0     # seconds a world of the launcher may take


def parse_args(argv=None):
    """The options of :func:`main` (``sys.argv[1:]`` when None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override a field of the model's config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--world", action="store_true",
                    help="with --devices N: a world of N ranks, one "
                         "process a device (launch.world)")
    ap.add_argument("--shard-seq", action="store_true",
                    help="split the cache's sequence over data, not the "
                         "batch")
    return ap.parse_args(argv)


def main(argv=None, teacher=None):
    args = parse_args(argv)
    if args.world:
        from repro_torch.launch.world import run_world
        if not args.devices:
            raise SystemExit("--world needs --devices: the number of ranks")
        ranks = run_world(_serve_rank, args.devices, device=args.device,
                          args=(args, teacher), timeout=WORLD_TIMEOUT)
        return dict(ranks[0], ranks=[r["report"] for r in ranks])
    return serve(args, teacher)


def _serve_rank(world, args, teacher):
    """One rank of ``--world``: :func:`serve`, its report (the logits of
    rank 0 alone)."""
    from repro_torch.launch.world import rank_report

    t0 = time.perf_counter()  # noqa: DL002(a rank's seconds, reported only)
    out = serve(args, teacher, quiet=world.rank != 0)
    out["report"] = dict(rank_report(world, time.perf_counter() - t0),  # noqa: DL002(a rank's seconds, reported only)
                         seq_axes=out.pop("seq_axes"))
    if world.rank != 0:
        out.pop("step_logits", None)
    return out


def serve(args, teacher=None, quiet: bool = False):
    """Serve as ``args`` (the parsed options) say; see :func:`main`."""
    from repro_torch import configs
    from repro_torch.config import MeshConfig, parse_overrides
    from repro_torch.core.distributed import Server
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = configs.get_config(args.arch)
    if not args.full_size:
        cfg = configs.reduced(cfg)
    cfg = cfg.with_(**parse_overrides(args.set))

    if args.devices:
        mp = args.model_parallel
        if mp <= 0 or args.devices % mp != 0:
            raise SystemExit(
                f"[serve] device_count={args.devices} is not divisible "
                f"by --model-parallel {mp}; pick a model-parallel degree "
                "that divides the device count")
        mesh_cfg = MeshConfig(data=args.devices // mp, model=mp)
    else:
        mesh_cfg = MeshConfig(data=1, model=1)

    mesh = make_mesh_from_config(mesh_cfg, args.device)
    server = Server(cfg, mesh_cfg, mesh=mesh, shard_seq=args.shard_seq)
    dev = server.device
    n_img = cfg.image_tokens * cfg.anyres_tiles if cfg.family == "vlm" else 0
    max_len = args.prompt_len + args.new_tokens + 8 + n_img
    if server.world is not None:
        max_len = -(-max_len // mesh.size) * mesh.size

    params = server.init_params(args.seed)
    cache = server.shard_cache(server.model.init_cache(args.batch, max_len,
                                                       dev))
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        device=dev)}

    def embeds(n):
        x = rng.standard_normal((args.batch, n, cfg.d_model),
                                dtype=np.float32) * 0.1
        return torch.as_tensor(x, device=dev).to(getattr(torch,
                                                         cfg.param_dtype))

    if cfg.family == "audio":
        batch["frames"] = embeds(cfg.n_frames)
    if cfg.family == "vlm":
        batch["image_embeds"] = embeds(n_img)

    prefill = server.jit_prefill(params, batch, cache)
    decode = server.jit_decode(params, cache)
    _sync(dev)
    t0 = time.perf_counter()  # noqa: DL002(prefill/decode throughput timing display)
    logits, cache = prefill(params, batch, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0  # noqa: DL002(prefill/decode throughput timing display)

    tok = torch.argmax(logits[:, -1:], dim=-1)
    generated = [tok]
    steps = [logits[:, -1].float().cpu()] if teacher is not None else None
    t0 = time.perf_counter()  # noqa: DL002(prefill/decode throughput timing display)
    for i in range(args.new_tokens - 1):
        if teacher is not None:
            tok = torch.as_tensor(teacher[:, i:i + 1], device=dev)
        logits, cache = decode(params, tok, cache)
        if teacher is not None:
            steps.append(logits[:, -1].float().cpu())
        tok = torch.argmax(logits[:, -1:], dim=-1)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0  # noqa: DL002(prefill/decode throughput timing display)

    toks = torch.cat(generated, dim=1).cpu().numpy()
    tps = args.batch * (args.new_tokens - 1) / max(t_decode, 1e-9)
    if not quiet:
        print(f"[serve] arch={cfg.name} device={dev} devices={mesh.size} "
              f"batch={args.batch} "
              f"prefill({args.prompt_len} toks)={t_prefill:.3f}s "
              f"decode={t_decode:.3f}s ({tps:.1f} tok/s)")
        print(f"[serve] sample output ids: {toks[0, :12].tolist()}")
    out = {"arch": cfg.name, "devices": mesh.size, "tokens": toks,
           "seq_axes": cache.get("seq_axes"), "prefill_seconds": t_prefill,
           "decode_seconds": t_decode, "decode_tokens_per_s": tps}
    if steps is not None:
        out["step_logits"] = steps
    return out


if __name__ == "__main__":
    main()
