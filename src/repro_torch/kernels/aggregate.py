"""Per-leaf weighted multi-model aggregation kernel.

Computes ``out = Σ_p w_p · x_p / Σ_p w_p`` over ``P`` stacked copies of one
flattened leaf, with fp32 accumulation and the output in ``x``'s type. It
replaces the reference package's Pallas kernel ``_agg_kernel``
(``kernels/aggregate.py``, entry point ``aggregate_tiles``) with hand-written
CUDA C++ for Hopper, ``csrc/aggregate.cu``: a grid over lanes with 16-byte
loads, bounded by bytes on the card (the design and its numbers are at the
top of the source). It takes fp32 and bf16, the types the protocol ships.

Unlike the whole-model kernel ``fused.agg``, it has no integer mask and
writes ``x``'s type: ``ops.aggregate_pytree`` sends integer leaves through
it as fp32 and rounds them afterwards.

``TILE`` (16384 lanes) is the reference's block size. The CUDA kernel masks
its tail, so it takes any ``N`` and the result does not depend on TILE.

Dispatch is by where the tensors live: a CUDA tensor launches the kernel or
raises (an unsupported dtype raises ``TypeError``; there is no fallback),
and a CPU tensor takes the plain PyTorch version, ``ref.aggregate_ref``,
which is also what the kernel is compared with on the card. Launches are
counted in ``aggregate_tiles.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import TILE, aggregate_ref  # noqa: F401

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("aggregate")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.aggregate_launch.argtypes = [p, p, p, i, i, ll, p]
        lib.aggregate_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def aggregate_tiles(x, w):
    """x: (P, N); w: (P,) -> weighted mean (N,) in ``x.dtype``. One kernel
    launch on the card (fp32 or bf16 ``x``, contiguous); the weights are
    taken as fp32. The caller checks that they sum to more than zero."""
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[0]:
        raise ValueError(f"expected x (P, N) and w (P,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"empty stack {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.device.type == "cpu":
        return aggregate_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"aggregate kernel takes fp32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    P, N = x.shape
    w = w.to(torch.float32).contiguous()
    out = torch.empty((N,), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().aggregate_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), DTYPES[x.dtype], P, N,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"aggregate.agg: kernel launch failed with CUDA "
                           f"error {rc} (cudaGetLastError)")
    aggregate_tiles.launches += 1
    return out


aggregate_tiles.launches = 0
