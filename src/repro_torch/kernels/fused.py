"""Whole-model one-pass aggregation kernels (the FlatModel engine's core).

The whole model is a single ``(P, N)`` stack of flat fp32 buffers and
aggregation is ONE kernel launch:

* :func:`aggregate_flat_onepass` — weighted mean over P replicas.
  Integer-leaf positions (``int_mask``) are rounded half-to-even *inside*
  the kernel, so optimizer counters survive aggregation exactly without a
  second pass.
* :func:`aggregate_quantize_flat` — the fused aggregate→quantize variant:
  emits the fp32 mean *and* int8 codes + per-subtile scales straight from
  registers, saving the extra device-memory round trip of a separate
  quantize call.

These replace the reference package's Pallas kernels ``_agg_kernel`` and
``_agg_quant_kernel`` (``kernels/fused.py``) with hand-written CUDA C++ for
Hopper, ``csrc/fused_agg.cu``. Both are bounded by bytes on the card: a
stream of ``(P+1)·N`` words in and ``N`` out; at the session's shape the
stack sits in L2 and the launch dominates. The design (a grid over lanes
with 16-byte loads; for the quantised form one block per subtile with the
means held in registers across the absmax reduction) is described at the
top of the source.

Dispatch is by where the tensors live: a CUDA tensor launches the kernel or
raises — there is no fallback — and a CPU tensor takes the plain PyTorch
version beside it (``_plain_onepass`` / ``_plain_onepass_quant``), which is
also what the kernels are compared against on the card. Each wrapper counts
its launches in a plain integer attribute ``launches``.

``SUBTILE`` (16384 lanes) is the quantization granularity and part of the
wire format. Codes and scales equal ``ref.quantize_ref`` of the
SUBTILE-padded mean bit for bit; pad lanes count as exact zeros.

Zero total weight is a caller error: ``aggregate_flatmodel`` checks it on
the host before anything is launched, and the wrappers check it themselves
for CPU tensors; on the card they do not (it would force a synchronise).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.utils.pytree import check_aggregation_weights

SUBTILE = 16384               # quantization granularity (= ref.TILE)

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("fused_agg")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_agg_launch.argtypes = [p, p, p, p, i, ll, p]
        lib.fused_agg_launch.restype = ctypes.c_int
        lib.fused_agg_quant_launch.argtypes = [p, p, p, p, p, p, i, ll, p]
        lib.fused_agg_quant_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the comparison on the card)
# ---------------------------------------------------------------------------


def _plain_onepass(x, w, int_mask=None):
    total = torch.sum(w)
    mean = torch.sum(w[:, None] * x, dim=0) / total
    if int_mask is not None:
        mean = torch.where(int_mask.to(torch.bool), torch.round(mean), mean)
    return mean


def _plain_quantize(mean):
    """Per-SUBTILE int8 quantisation of an (n,) mean, ragged tail padded
    with zeros: ``ref.quantize_ref`` on the padded vector."""
    from repro_torch.kernels.ref import quantize_ref
    n = mean.shape[0]
    pad = (-n) % SUBTILE
    padded = torch.nn.functional.pad(mean, (0, pad)) if pad else mean
    codes, scales = quantize_ref(padded)
    return codes[:n], scales


def _plain_onepass_quant(x, w, int_mask=None):
    mean = _plain_onepass(x, w, int_mask)
    codes, scales = _plain_quantize(mean)
    return mean, codes, scales


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_args(x, w, int_mask):
    """Validated ``(x, w, mask-as-bytes-or-None)``; raises on anything the
    kernels do not take."""
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[0]:
        raise ValueError(f"expected x (P, N) and w (P,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"empty stack {tuple(x.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"expected fp32 x and w, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("x and w must be contiguous")
    if int_mask is not None:
        if int_mask.shape != (x.shape[1],):
            raise ValueError(f"int_mask must be ({x.shape[1]},), got "
                             f"{tuple(int_mask.shape)}")
        if int_mask.device != x.device:
            raise ValueError(f"x on {x.device} but int_mask on "
                             f"{int_mask.device}")
        if int_mask.dtype == torch.bool:
            int_mask = int_mask.view(torch.uint8)
        elif int_mask.dtype != torch.uint8:
            raise TypeError("int_mask must be bool or uint8 (one byte a "
                            f"lane), got {int_mask.dtype}")
        if not int_mask.is_contiguous():
            raise ValueError("int_mask must be contiguous")
    return x, w, int_mask


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} (cudaGetLastError)")


def aggregate_flat_onepass(x, w, int_mask=None):
    """x: (P, N) flat fp32 models; w: (P,). One kernel launch → mean (N,).

    ``int_mask`` (bool or uint8, (N,)) marks integer-leaf positions
    (rounded in-kernel); None means all-float.
    """
    x, w, m = _check_args(x, w, int_mask)
    if x.device.type == "cpu":
        check_aggregation_weights(w)
        return _plain_onepass(x, w, m)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    P, N = x.shape
    lib = _lib()
    out = torch.empty((N,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.fused_agg_launch(
            x.data_ptr(), w.data_ptr(), None if m is None else m.data_ptr(),
            out.data_ptr(), P, N, _stream(x))
    _raise_on(rc, "fused.agg")
    aggregate_flat_onepass.launches += 1
    return out


def aggregate_quantize_flat(x, w, int_mask=None):
    """Fused aggregate→quantize: one kernel launch → (mean (N,), codes int8
    (N,), scales (ceil(N/SUBTILE),)).

    Codes/scales match ``quantize_ref(mean)`` applied to the SUBTILE-padded
    mean bit for bit.
    """
    x, w, m = _check_args(x, w, int_mask)
    if x.device.type == "cpu":
        check_aggregation_weights(w)
        return _plain_onepass_quant(x, w, m)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    P, N = x.shape
    lib = _lib()
    mean = torch.empty((N,), dtype=torch.float32, device=x.device)
    codes = torch.empty((N,), dtype=torch.int8, device=x.device)
    scales = torch.empty((-(-N // SUBTILE),), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.fused_agg_quant_launch(
            x.data_ptr(), w.data_ptr(), None if m is None else m.data_ptr(),
            mean.data_ptr(), codes.data_ptr(), scales.data_ptr(), P, N,
            _stream(x))
    _raise_on(rc, "fused.agg_quant")
    aggregate_quantize_flat.launches += 1
    return mean, codes, scales


aggregate_flat_onepass.launches = 0
aggregate_quantize_flat.launches = 0
