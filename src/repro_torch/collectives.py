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
* :func:`copy_to_group` / :func:`reduce_from_group` — the autograd pair of
  tensor parallelism (Megatron's *f* and *g*): the first is the identity
  forward and sums the gradient over the group backward (the input of a
  column-parallel product), the second sums over the group forward and is
  the identity backward (the output of a row-parallel product, a
  vocab-parallel lookup or a vocab-parallel softmax's terms).

Staging. Under gloo, PyTorch's documentation lists only ``broadcast`` and
``all_reduce`` as taking CUDA tensors. :func:`all_gather` of a CUDA tensor
over a gloo group (several ranks sharing one card) is therefore staged
through host memory: the tensor is copied to the CPU, gathered there and
the result copied back onto the card. ``COUNTS["staged_bytes"]`` adds the
bytes of both copies; the arithmetic stays on the card in every rank.
``COUNTS`` also counts the calls of each collective, and
``COUNTS["all_reduce_bytes"]`` the bytes of each all-reduce's operand (one
rank's, as ``launch/dryrun.py`` reckons a device's).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0,
          "broadcast": 0, "staged_bytes": 0}


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
    staged = _needs_staging(x, group)
    if staged:
        flat = flat.cpu()
        COUNTS["staged_bytes"] += flat.numel() * (1 + n)
    outs = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(outs, flat, group=group)
    if staged:
        outs = [o.to(t.device) for o in outs]
    parts = [o.view(x.dtype).reshape(x.shape) if x.numel() else
             o.reshape(x.shape) for o in outs]
    return torch.cat(parts, dim=dim)


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
           "copy_to_group", "group_size", "reduce_from_group",
           "reset_counts"]
