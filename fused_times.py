"""Times B1-B5 (``repro_torch.kernels.fused``) of the checkout this script
is in, on the card, at the kernels phase's shapes of ``chip_smoke.py``:
each kernel checked against its plain version and timed beside it
(CUDA-graph replay), with the launch floor, the kernel and grid each
launcher chose (``form``), ``torch.matmul`` at B1's shapes, the ptxas
lines of ``fused_agg.cu`` and the instructions a mask word in its SASS;
then B1, B2, B4 and B5 in 1-8 chunks of the card against one launch
(``chip_smoke.shard_rows``: bit for bit, forms, times at 1 and 4 chunks,
B4/B5 at a lane base). Prints one JSON line.

    python3 fused_times.py

To compare two commits on one card, unpack the other into a git-ignored
directory (``git archive <commit> | tar -x -C build/parent``), copy this
script and ``chip_smoke.py`` into it, and run both copies in one call, in
turns: parent, change, change, parent. It fails without a CUDA device.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("fused_times.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    import repro_torch  # noqa: F401  (sets the numerics)
    from repro_torch.kernels import build, fused

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"]).splitlines()[0]
    (lib,) = build.build(["fused_agg"])
    word_pipes, sass_counts = cs.prg_word_pipes(cs.dump_sass(lib))
    rows = cs.fused_rows(dev, fused, word_pipes)
    cs.emit("fused_times", root=str(cs.ROOT), card=card,
            launch_floor_ms=cs.launch_floor_ms(dev),
            ptxas=cs.ptxas_kernels(build.build_log("fused_agg"),
                                   cs.fused_label),
            sass=sass_counts,
            ms={k: {r["shape"]: r["ms"] for r in v} for k, v in rows.items()},
            form={k: {r["shape"]: r["form"] for r in v}
                  for k, v in rows.items()},
            matmul_ms={r["shape"]: r["library_ms"] for r in rows["fused.agg"]},
            pipe_bound_ms={k: {r["shape"]: r["pipe_bound_ms"] for r in v}
                           for k, v in rows.items() if k in word_pipes},
            sharded=cs.shard_rows(dev, fused))
    return 0


if __name__ == "__main__":
    sys.exit(main())
