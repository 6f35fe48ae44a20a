"""Serving launcher: batched prefill + token-by-token greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch 4 --prompt-len 32 --new-tokens 16 [--full-size] [--device cpu]

Runs the reduced config by default and the published one with
``--full-size``, on the card unless ``--device`` names another. Weights come
from a ``torch.Generator`` seeded with ``--seed`` on that device, prompts
from ``numpy.random.default_rng(--seed)``. ``--devices`` and
``--model-parallel`` describe a mesh as in the reference; a mesh of more
than one device raises ``NotImplementedError`` until ROADMAP A12.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.config import MeshConfig
    from repro_torch.core.distributed import Server

    cfg = configs.get_config(args.arch)
    if not args.full_size:
        cfg = configs.reduced(cfg)

    if args.devices:
        mp = args.model_parallel
        if mp <= 0 or args.devices % mp != 0:
            raise SystemExit(
                f"[serve] device_count={args.devices} is not divisible "
                f"by --model-parallel {mp}; pick a model-parallel degree "
                "that divides the device count")
        mesh_cfg = MeshConfig(data=args.devices // mp, model=mp)
    else:
        mesh_cfg = MeshConfig()

    server = Server(cfg, mesh_cfg, device=args.device)
    dev = server.device
    max_len = args.prompt_len + args.new_tokens + 8

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = server.shard_params(server.model.init(gen, dev))
    cache = server.shard_cache(server.model.init_cache(args.batch, max_len,
                                                       dev))
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        device=dev)}

    _sync(dev)
    t0 = time.perf_counter()  # noqa: DL002(prefill/decode throughput timing display)
    logits, cache = server.prefill(params, batch, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0  # noqa: DL002(prefill/decode throughput timing display)

    tok = torch.argmax(logits[:, -1:], dim=-1)
    generated = [tok]
    t0 = time.perf_counter()  # noqa: DL002(prefill/decode throughput timing display)
    for _ in range(args.new_tokens - 1):
        logits, cache = server.decode(params, tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0  # noqa: DL002(prefill/decode throughput timing display)

    toks = torch.cat(generated, dim=1).cpu().numpy()
    tps = args.batch * (args.new_tokens - 1) / max(t_decode, 1e-9)
    print(f"[serve] arch={cfg.name} device={dev} batch={args.batch} "
          f"prefill({args.prompt_len} toks)={t_prefill:.3f}s "
          f"decode={t_decode:.3f}s ({tps:.1f} tok/s)")
    print(f"[serve] sample output ids: {toks[0, :12].tolist()}")
    return {"arch": cfg.name, "tokens": toks, "prefill_seconds": t_prefill,
            "decode_seconds": t_decode, "decode_tokens_per_s": tps}


if __name__ == "__main__":
    main()
