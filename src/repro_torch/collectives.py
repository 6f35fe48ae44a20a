"""Every collective the package issues, over ``torch.distributed`` groups.

A world (:mod:`repro_torch.launch.world`) runs one process a device, and
its mesh (:class:`repro_torch.sharding.DeviceMesh`) carries a process group
for each named axis. The functions here are the only ones in the package
that call ``torch.distributed``'s collectives:

* :func:`all_reduce` — sum (or max) of a tensor over a group, in place;
* :func:`all_gather` — the group's tensors concatenated along a dimension,
  in group-rank order; a pure copy of bits (the tensors travel as bytes,
  so every dtype, bfloat16 and bool included, goes through unchanged),
  through ``torch.distributed.all_gather``'s list form, which every torch
  version and backend takes (``all_gather_into_tensor`` is deprecated in
  newer versions);
* :func:`broadcast` — one rank's tensor to the group, in place;
* :func:`reduce_scatter` — the group's sum of a tensor, of which each
  rank keeps its contiguous piece along a dimension (the pieces travel in
  the tensor's dtype, an all-to-all, and are summed in fp32);
* :func:`copy_to_group` / :func:`reduce_from_group` — the autograd pair of
  tensor parallelism (Megatron's *f* and *g*): the first is the identity
  forward and sums the gradient over the group backward (the input of a
  column-parallel product), the second sums over the group forward and is
  the identity backward (the output of a row-parallel product, a
  vocab-parallel lookup or a vocab-parallel softmax's terms);
* :func:`gather_shards` — the autograd pair of FSDP: the group's pieces
  gathered along a dimension forward, the gradient reduce-scattered back
  to the pieces backward (a weight split over ``data``, gathered where a
  layer reads it).

Staging. Under gloo, PyTorch's documentation lists only ``broadcast`` and
``all_reduce`` as taking CUDA tensors. :func:`all_gather` and
:func:`reduce_scatter` of a CUDA tensor over a gloo group (several ranks
sharing one card) are therefore staged through host memory: each rank
copies its tensor into a file of its own in shared memory and copies the
others' pieces from theirs back onto the card, between two barriers of
the group (:class:`_Exchange`, :func:`set_exchange`; gloo itself moved a
0.8 GB piece between two of four ranks on one H100's host in 1.53–1.82
s, where the copies to and from the card take a fraction of it).
``COUNTS["staged_bytes"]`` adds the bytes of both copies; the arithmetic
stays on the card in every rank.
``COUNTS`` also counts the calls of each collective, and
``COUNTS["all_reduce_bytes"]`` / ``COUNTS["reduce_scatter_bytes"]`` the
bytes of each all-reduce's / reduce-scatter's operand (one rank's, as
``launch/dryrun.py`` reckons a device's).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_EXCHANGES = {}

COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0,
          "reduce_scatter": 0, "reduce_scatter_bytes": 0, "broadcast": 0,
          "staged_bytes": 0}


class _Exchange:
    """How a group whose ranks share one host stages a transfer: each rank
    writes its piece into a file of its own in shared memory (under
    ``prefix``, named by the group's ranks, the rank and a generation),
    the others map it and read it after a barrier, and a second barrier
    lets the files be written again. Every rank of the group makes the same
    calls with the same sizes (collective semantics), so the files grow
    alike everywhere: to the largest transfer yet, in steps of ``STEP``
    bytes."""

    STEP = 256 << 20

    def __init__(self, group, prefix: str):
        self.group, self.prefix = group, prefix
        self.ranks = dist.get_process_group_ranks(group)
        self.me = self.ranks.index(dist.get_rank())
        self.size, self.gen, self.maps = 0, 0, []

    def _path(self, r: int) -> str:
        return (f"{self.prefix}_{'-'.join(map(str, self.ranks))}_"
                f"{self.ranks[r]}_{self.gen}")

    def barrier(self) -> None:
        # an all-reduce of one number: it returns on no rank before every
        # rank has entered it
        dist.all_reduce(torch.zeros(1), group=self.group)

    def views(self, nbytes: int):
        """Every rank's file as a byte tensor of ``nbytes`` (this rank's
        writable), grown first where it holds fewer."""
        import numpy as np

        if nbytes > self.size:
            self.close()
            self.gen += 1
            self.size = -(-nbytes // self.STEP) * self.STEP
            mine = np.memmap(self._path(self.me), dtype=np.uint8,
                             mode="w+", shape=(self.size,))
            self.barrier()              # every rank's file exists
            self.maps = [mine if r == self.me else np.memmap(
                self._path(r), dtype=np.uint8, mode="r+",
                shape=(self.size,)) for r in range(len(self.ranks))]
        return [torch.from_numpy(np.asarray(m[:nbytes]))
                for m in self.maps]

    def close(self) -> None:
        """Unmap every file and remove this rank's (a barrier first, so
        that no rank still reads it)."""
        if self.maps:
            self.barrier()
            self.maps = []
            os.unlink(self._path(self.me))


def set_exchange(group, prefix: str) -> None:
    """Stage ``group``'s transfers of CUDA tensors through files in shared
    memory under ``prefix`` (:class:`_Exchange`: its ranks share a host;
    ``launch.world.World.mesh`` sets it for every gloo group)."""
    _EXCHANGES[group] = _Exchange(group, prefix)


def close_exchanges() -> None:
    """Remove this process's exchange files (every rank of every group
    calls it together, as a world's rank does before it leaves)."""
    for ex in _EXCHANGES.values():
        ex.close()
    _EXCHANGES.clear()


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def backend(group) -> str:
    """The backend of ``group``, lower case (``"gloo"`` or ``"nccl"``)."""
    return str(dist.get_backend(group)).lower()


def group_size(group) -> int:
    return dist.get_world_size(group)


def _op(op: str):
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"unknown reduction {op!r}")
    return ops[op]


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place and return it."""
    COUNTS["all_reduce"] += 1
    COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=_op(op), group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the group's rank ``src`` (a rank of the group) on every
    rank, in place."""
    COUNTS["broadcast"] += 1
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def _needs_staging(x: torch.Tensor, group) -> bool:
    """Whether a gather of ``x`` over ``group`` goes through host memory:
    a CUDA tensor over gloo."""
    return x.is_cuda and backend(group) == "gloo"


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (one shape on every rank) concatenated along
    ``dim`` in group-rank order, on ``t``'s device. Staged through host
    memory for a CUDA tensor over gloo (see the module's docstring)."""
    COUNTS["all_gather"] += 1
    n = group_size(group)
    x = t.contiguous()
    flat = x.reshape(-1).view(torch.uint8) if x.numel() else x.reshape(-1)
    if not _needs_staging(x, group):
        outs = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(outs, flat, group=group)
        return torch.cat([o.view(x.dtype).reshape(x.shape) if x.numel()
                          else o.reshape(x.shape) for o in outs], dim=dim)
    COUNTS["staged_bytes"] += flat.numel() * (1 + n)
    ex = _EXCHANGES[group]
    views = ex.views(flat.numel())
    views[ex.me].copy_(flat)
    ex.barrier()                        # every rank's piece is written
    # each piece straight into its place: the card holds the whole once
    dim %= max(x.dim(), 1)
    size = x.shape[dim]
    whole = torch.empty(x.shape[:dim] + (n * size,) + x.shape[dim + 1:],
                        dtype=x.dtype, device=t.device)
    for r, v in enumerate(views):
        whole.narrow(dim, r * size, size).copy_(
            x if r == ex.me else v.view(x.dtype).reshape(x.shape))
    ex.barrier()                        # every rank has read every file
    return whole


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's sum of ``t`` (one shape on every rank), of which this
    rank keeps its contiguous piece along ``dim`` (group-rank order, as
    :func:`all_gather` puts the pieces), in ``t``'s dtype and on its
    device. Each rank's piece travels in ``t``'s dtype and the pieces are
    summed in fp32, in group-rank order, as :func:`_reduce_fp32` sums.
    Staged through host memory for a CUDA tensor over gloo (see the
    module's docstring)."""
    n = group_size(group)
    rows = t.shape[dim]
    if rows % n:
        raise ValueError(f"a reduce-scatter of {rows} rows over {n} ranks")
    x = t.movedim(dim, 0).contiguous()
    COUNTS["reduce_scatter"] += 1
    COUNTS["reduce_scatter_bytes"] += x.numel() * x.element_size()
    sent = x.reshape(n, -1)             # row j: rank j's piece
    if _needs_staging(x, group):
        ex = _EXCHANGES[group]
        views = ex.views(x.numel() * x.element_size())
        views[ex.me].copy_(x.reshape(-1).view(torch.uint8))
        ex.barrier()                    # every rank's tensor is written
        out = _sum_fp32([sent[ex.me] if r == ex.me else v.view(
            x.dtype).reshape(sent.shape)[ex.me].to(t.device)
            for r, v in enumerate(views)])
        ex.barrier()                    # every rank has read every file
        COUNTS["staged_bytes"] += (t.numel() + t.numel() // n) \
            * t.element_size()
    else:
        recv = torch.empty_like(sent)
        dist.all_to_all_single(recv, sent, group=group)
        out = _sum_fp32(list(recv))
    return out.to(t.dtype).reshape((rows // n,) + tuple(x.shape[1:])) \
        .movedim(0, dim)


def _sum_fp32(pieces):
    """The pieces' sum in fp32, in their order (a new tensor)."""
    out = pieces[0].to(torch.float32, copy=True)
    for p in pieces[1:]:
        out.add_(p)
    return out


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def gather_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """FSDP's gather of a weight split over ``group`` along ``dim``: the
    whole weight forward (:func:`all_gather`); backward, the group's sum of
    the whole gradient, of which each rank keeps its piece
    (:func:`reduce_scatter`)."""
    return _GatherShards.apply(x, group, dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_fp32(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _reduce_fp32(x, group):
    """The sum of ``x`` over ``group``, reduced in fp32 (partials of a
    lower precision are widened first) and returned in ``x``'s dtype."""
    y = x.to(torch.float32, copy=True).contiguous()
    all_reduce(y, group)
    return y.to(x.dtype)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: ``x`` forward, the group's sum of its gradient
    backward."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: the group's sum of ``x`` (in fp32) forward, the
    gradient unchanged backward."""
    return _ReduceFromGroup.apply(x, group)


__all__ = ["COUNTS", "all_gather", "all_reduce", "backend", "broadcast",
           "close_exchanges", "copy_to_group", "gather_shards",
           "group_size", "reduce_from_group", "reduce_scatter",
           "reset_counts", "set_exchange"]
