"""Batched serving on the PyTorch package: prefill a batch of prompts for
one of the assigned architectures (reduced size unless ``--full-size``)
and decode new tokens, on the card unless ``--device`` names another
device. The twin of ``examples/serve_batch.py``: it delegates to the
serving launcher, ``python -m repro_torch.launch.serve``.

    PYTHONPATH=src python examples/torch_serve_batch.py --arch gemma2-27b
    PYTHONPATH=src python examples/torch_serve_batch.py --arch rwkv6-1.6b --new-tokens 24
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    """Run the launcher in a process of its own; returns its exit code."""
    args = list(sys.argv[1:] if argv is None else argv) or [
        "--arch", "tinyllama-1.1b"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    # delegate to the serving launcher (examples stay thin wrappers over the
    # public entrypoints, as a deployment would use them)
    return subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env)


if __name__ == "__main__":
    raise SystemExit(main())
