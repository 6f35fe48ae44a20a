"""Build and load the package's CUDA kernels.

Sources live in ``kernels/csrc/*.cu``, with the headers they share in
``kernels/csrc/*.cuh``. Each source is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with ``ctypes``
— seconds per file, where a build through PyTorch's extension headers
takes minutes. Libraries are built at first use into ``build/`` at the
root of the checkout, keyed by a hash of the source, the headers and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. Nothing is built or looked for at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}

# False in a rank of a world (``launch.world``): its parent built every
# library, and a rank that would have to run nvcc raises instead
NVCC_ALLOWED = True


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and "
                       "in /usr/local/cuda): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def _nvcc(cmd):
    t0 = time.perf_counter()  # noqa: DL002(nvcc build seconds, reported only)
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter() - t0  # noqa: DL002(nvcc build seconds, reported only)


def build(names: Iterable[str]) -> List[Path]:
    """Compile every named source that has no up-to-date library: one
    ``nvcc`` per source, all started together. A failed build raises with
    the compiler's output. The compiler's log (register and shared-memory
    use per kernel) is kept beside the library as ``<lib>.log``, ending in
    the build's wall seconds."""
    names = list(names)
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        if not NVCC_ALLOWED:
            raise RuntimeError(f"{out} is not built, and this process may "
                               "not run nvcc (a rank of a world loads the "
                               "libraries its parent built)")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs.append((out, tmp, [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                str(CSRC / f"{name}.cu")]))
    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        results = list(pool.map(_nvcc, [cmd for _, _, cmd in jobs]))
    failed = []
    for (out, tmp, cmd), (proc, seconds) in zip(jobs, results):
        if proc.returncode != 0 or not tmp.exists():
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}")
            continue
        out.with_suffix(".log").write_text(
            f"{proc.stdout}nvcc wall seconds: {seconds!r}\n")
        os.replace(tmp, out)                 # atomic: safe across processes
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def build_log(name: str) -> str:
    """``nvcc -Xptxas -v`` output of the last build of ``name`` ('' if the
    library was not built yet)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_seconds(name: str) -> Optional[float]:
    """Wall seconds of the last build of ``name`` (None if not built)."""
    m = re.search(r"nvcc wall seconds: (\S+)", build_log(name))
    return float(m.group(1)) if m else None
