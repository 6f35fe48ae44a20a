"""A world: one process a device, as PyTorch spreads work over devices.

The reference runs one process over many devices; here every device has a
process of its own (a *rank*), and the ranks run the same host code: the
same seeds, the same event loop, the same branches. Only the tensors are
split, by the specs of :class:`repro_torch.sharding.ShardingPolicy` and
the flat engine's lane chunks, and the ranks meet in the collectives of
:mod:`repro_torch.collectives`.

    from repro_torch.launch.world import run_world
    results = run_world(body, 4, device="cpu", args=(...,), timeout=120.0)

:func:`run_world` starts ``n`` ranks by the ``forkserver`` method (CUDA
may be initialised in the parent, so never ``fork`` from it): a server
process that has imported torch and the port, and nothing more, forks
each rank, which starts with this process's environment of the moment
(as a spawned one would) and without importing torch again (four ranks
importing it at once took 8–9 s on one H100's host), and calls
``body(world, *args)`` with its :class:`World`, and returns the ranks'
return values in rank order (tensors in them are moved to the CPU). The
ranks rendezvous through a ``file://`` store in a temporary directory, so
any number of worlds may start at once on one host. The parent joins them
under ``timeout`` seconds: a rank that raises, dies or outlives the
timeout ends the world (every rank is killed), and the failing rank's
traceback is raised as :class:`WorldError` (:class:`WorldTimeout` for the
timeout).

Devices and backends. ``device="cpu"`` puts every rank on the CPU (gloo).
On the card (``device=None`` or ``"cuda"``) rank ``r`` takes card
``r mod torch.cuda.device_count()``; ``"cuda:i"`` puts every rank on card
``i``. The backend follows from the ranks' devices (:func:`pick_backend`)
and is printed: NCCL where the ranks hold distinct cards, gloo where
several ranks share one card (NCCL refuses two ranks on one GPU) or on
the CPU. An NCCL initialisation that fails raises; nothing falls back.

Kernels. On the card the parent builds every CUDA source before it spawns
(:func:`repro_torch.kernels.build.build`); a rank only loads the libraries
in ``build/`` and raises if it would have to run ``nvcc``.

Inside a rank, :func:`current_world` is its :class:`World`, whose
:meth:`World.mesh` gives a :class:`~repro_torch.sharding.DeviceMesh` of
named axes with a process group an axis
(``launch.mesh.make_mesh`` returns it there).
"""

from __future__ import annotations

import glob
import itertools
import math
import os
import pickle
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

_WORLD: Optional["World"] = None

SOURCES = ("fused_agg", "flash_attention", "aggregate", "quantize")
# what the forkserver imports once, before it forks any rank
FORKSERVER_PRELOAD = ["torch", "torch.distributed", "numpy",
                      "repro_torch.launch.world",
                      "repro_torch.core.distributed"]


class WorldError(RuntimeError):
    """A rank of a world failed; the message holds its traceback."""


class WorldTimeout(WorldError):
    """A world outlived its timeout; every rank was killed."""


def current_world() -> Optional["World"]:
    """This process's :class:`World`, or None outside a world."""
    return _WORLD


def pick_backend(devices: Sequence) -> str:
    """gloo on the CPU and where two ranks share a card; NCCL where every
    rank holds a card of its own."""
    devices = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devices):
        if any(d.type == "cuda" for d in devices):
            raise ValueError(f"a world of CPU and CUDA ranks: {devices}")
        return "gloo"
    return "nccl" if len(set(devices)) == len(devices) else "gloo"


def rank_devices(n: int, device=None) -> Tuple[torch.device, ...]:
    """The device of each of ``n`` ranks (see the module's docstring). A
    world asked for the card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return (dev,) * n
    if dev.type != "cuda":
        raise ValueError(f"a world on {dev}: ranks run on the CPU or cards")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("a world on the card needs a CUDA device and "
                           "none is available; pass device='cpu' for a "
                           "world on the CPU")
    if dev.index is not None:
        return (dev,) * n
    return tuple(torch.device("cuda", r % count) for r in range(n))


class World:
    """One rank's view of its world: ``rank`` of ``size``, its ``device``,
    every rank's ``devices`` and the ``backend``."""

    def __init__(self, rank: int, size: int, devices, backend: str,
                 shm_prefix: str = ""):
        self.rank, self.size = rank, size
        self.devices = tuple(torch.device(d) for d in devices)
        self.device = self.devices[rank]
        self.backend = backend
        # where its gloo groups' exchange files go (collectives.set_exchange)
        self.shm_prefix = shm_prefix
        self._meshes: Dict[tuple, Any] = {}

    def mesh(self, shape, axes):
        """The world as a :class:`~repro_torch.sharding.DeviceMesh` of
        ``shape`` over the named ``axes`` (row-major over the ranks), with
        a process group an axis: the ranks that differ only in that
        axis's coordinate. Every rank must ask for the same meshes in the
        same order (groups are made collectively); each is made once."""
        import torch.distributed as dist

        from repro_torch.sharding import DeviceMesh

        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        key = (shape, axes)
        if key in self._meshes:
            return self._meshes[key]
        if math.prod(shape) != self.size:
            raise ValueError(f"a mesh of {shape} over a world of "
                             f"{self.size} ranks")
        from repro_torch import collectives

        groups = []
        for a in range(len(shape)):
            mine = None
            others = [range(s) for i, s in enumerate(shape) if i != a]
            for rest in itertools.product(*others):
                ranks = []
                for c in range(shape[a]):
                    full = list(rest)
                    full.insert(a, c)
                    ranks.append(_flat(full, shape))
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
                    if self.backend == "gloo":      # ranks on one host
                        collectives.set_exchange(g, self.shm_prefix)
            groups.append(mine)
        mesh = DeviceMesh(self.devices, axes, shape, rank=self.rank,
                          groups=tuple(groups))
        self._meshes[key] = mesh
        return mesh


def _flat(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def _to_host(x):
    """``x`` with every tensor moved to the CPU (what a rank hands back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, tuple):
        return type(x)(*(_to_host(v) for v in x))
    return x


class _CallerStd:
    """The caller's standard output and error, handed to a rank: a rank
    forked by the server would otherwise write to the server's, those of
    the moment the server started. Passed as file descriptors
    (``multiprocessing.reduction.DupFd``, as the start method passes a
    queue's pipes) and put in place as the rank unpickles its
    arguments."""

    def __reduce__(self):
        from multiprocessing import reduction
        return (_take_std, (reduction.DupFd(1), reduction.DupFd(2)))


def _take_std(out, err):
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(out.detach(), 1)
    os.dup2(err.detach(), 2)


def _shm_prefix(store: str) -> str:
    """Where a world's exchange files go: shared memory, under the name of
    the world's own temporary directory."""
    root = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    return os.path.join(root, os.path.basename(os.path.dirname(store)))


def _rank_main(rank, size, devices, backend, store, timeout, threads, body,
               results, env, std):
    del std                             # in place already (_CallerStd)
    global _WORLD
    try:
        os.environ.clear()              # the parent's, as spawn gives it
        os.environ.update(env)
        import torch.distributed as dist

        from repro_torch import collectives
        from repro_torch.kernels import build

        with open(body, "rb") as f:
            fn, args = pickle.load(f)

        if threads:
            torch.set_num_threads(threads)
        build.NVCC_ALLOWED = False
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=size,
                                timeout=timedelta(seconds=timeout), **kw)
        _WORLD = World(rank, size, devices, backend, _shm_prefix(store))
        out = fn(_WORLD, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        collectives.close_exchanges()
        # pickled here, so that tensors travel as bytes and not as
        # shared memory that dies with the rank
        results.put((rank, True, pickle.dumps(_to_host(out))))
    except BaseException:
        # the parent raises the traceback and ends the world
        results.put((rank, False, traceback.format_exc()))
        raise
    dist.barrier()
    dist.destroy_process_group()


def run_world(fn: Callable, n: int, *, device=None, args: tuple = (),
              timeout: float = 180.0, threads: Optional[int] = None,
              quiet: bool = False) -> List[Any]:
    """Run ``fn(world, *args)`` on ``n`` ranks and return their results in
    rank order (see the module's docstring). ``fn`` and ``args`` must
    pickle (``fn`` a module-level function). ``threads``: torch's
    intra-op threads a rank (None: the host's cores shared out; on the
    card too, where the ranks' host work is the staged collectives' copies
    and sums). ``quiet`` skips the line that names
    the backend."""
    import multiprocessing as mp

    devices = rank_devices(n, device)
    backend = pick_backend(devices)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n)
    if devices[0].type == "cuda":
        from repro_torch.kernels import build
        build.build(SOURCES)                 # the ranks only load them
    if not quiet:
        print(f"[world] ranks={n} backend={backend} "
              f"devices={[str(d) for d in devices]}", flush=True)
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    # the body and its arguments go through a file: a process's own
    # arguments are written to it while the one before it starts up, so
    # large ones would start the ranks one after another
    body = os.path.join(tmp, "body.pkl")
    with open(body, "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(FORKSERVER_PRELOAD)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, devices, backend,
                               os.path.join(tmp, "store"), timeout, threads,
                               body, results, dict(os.environ),
                               _CallerStd()))
             for r in range(n)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout  # noqa: DL002(a world's timeout on the host's clock)
        dead_since: Dict[int, float] = {}
        while len(out) < n:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue_mod.Empty:
                now = time.monotonic()  # noqa: DL002(a world's timeout on the host's clock)
                for r, p in enumerate(procs):
                    if r in out or p.is_alive() or p.exitcode == 0:
                        continue
                    # give a message in flight a moment to arrive
                    if now - dead_since.setdefault(r, now) > 2.0:
                        raise WorldError(f"rank {r} of {n} died with exit "
                                         f"code {p.exitcode}")
                if now > deadline:
                    raise WorldTimeout(
                        f"a world of {n} ranks outlived its {timeout} s; "
                        f"ranks {sorted(set(range(n)) - set(out))} had not "
                        "finished")
                continue
            if not ok:
                raise WorldError(f"rank {rank} of {n} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))  # noqa: DL002(a world's timeout on the host's clock)
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
        # a rank that failed leaves its exchange files behind
        for path in glob.glob(_shm_prefix(os.path.join(tmp, "store"))
                              + "_*"):
            os.unlink(path)
    return [out[r] for r in range(n)]


def rank_report(world: World, seconds: float) -> dict:
    """What a rank reports of a run: its rank and device, the backend, the
    kernel launches it counted, the bytes its collectives staged, its
    seconds, its peak device bytes (None on the CPU) and its host peak
    (the process's largest resident set, ``getrusage``)."""
    import resource

    from repro_torch import collectives
    from repro_torch.kernels import KERNELS

    peak = (torch.cuda.max_memory_allocated(world.device)
            if world.device.type == "cuda" else None)
    host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return {"rank": world.rank, "device": str(world.device),
            "backend": world.backend,
            "launches": {k: v["wrapper"].launches for k, v in KERNELS.items()},
            "staged_bytes": collectives.COUNTS["staged_bytes"],
            "seconds": seconds, "peak_bytes": peak,
            "host_peak_bytes": host}


__all__ = ["World", "WorldError", "WorldTimeout", "current_world",
           "pick_backend", "rank_devices", "rank_report", "run_world"]
