"""Int8 delta quantisation kernels (the compressed model push).

Participants push ``θ_i − θ_ref`` instead of ``θ_i``; the delta is
symmetric-int8 quantised with one fp32 scale per ``TILE`` lanes:
``scale = max(absmax, 1e-12) / 127`` and
``codes = clip(rint(x / scale), -127, 127)``; dequantisation is
``codes · scale`` in a requested type. These replace the reference
package's Pallas kernels ``_quant_kernel`` and ``_dequant_kernel``
(``kernels/quantize.py``, entry points ``quantize_tiles`` and
``dequantize_tiles``) with hand-written CUDA C++ for Hopper,
``csrc/quantize.cu``: one block a tile that reads the tile once into
registers for quantisation, an elementwise grid for dequantisation; both
bounded by bytes on the card (the design and its numbers are at the top of
the source).

``TILE`` (16384 lanes) is part of the wire format. The reference's entries
need ``N % TILE == 0`` and its wrappers pad with zeros; here any ``N`` is
taken and lanes past ``N`` count as exact zeros, which is the same result
without the padded copy. Codes and scales equal ``ref.quantize_ref`` of the
zero-padded input bit for bit (IEEE division, see ROADMAP C1).

Dispatch is by where the tensors live: a CUDA tensor launches the kernel or
raises (fp32 or bf16 input and output; anything else raises ``TypeError``;
there is no fallback), and a CPU tensor takes the plain PyTorch versions,
``ref.quantize_ref`` / ``ref.dequantize_ref`` on the padded vector, which
are also what the kernels are compared with on the card. Launches are
counted in ``quantize_tiles.launches`` and ``dequantize_tiles.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import TILE, dequantize_ref, quantize_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("quantize")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quantize_launch.argtypes = [p, i, p, p, ll, p]
        lib.quantize_launch.restype = ctypes.c_int
        lib.dequantize_launch.argtypes = [p, p, p, i, ll, p]
        lib.dequantize_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def n_tiles(n: int) -> int:
    return -(-n // TILE)


def _pad(t):
    pad = (-t.shape[0]) % TILE
    return F.pad(t, (0, pad)) if pad else t


def _plain_quantize(x):
    n = x.shape[0]
    codes, scales = quantize_ref(_pad(x))
    return codes[:n], scales


def _plain_dequantize(q, s, dtype):
    return dequantize_ref(_pad(q), s, dtype)[:q.shape[0]]


def _cuda_checks(t, name, dtypes):
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} takes {sorted(map(str, dtypes))}, got "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} (cudaGetLastError)")


def quantize_tiles(x):
    """x: (N,) -> (codes int8 (N,), scales fp32 (ceil(N/TILE),)). One
    kernel launch on the card (fp32 or bf16 ``x``)."""
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"expected a non-empty (N,) vector, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return _plain_quantize(x)
    _cuda_checks(x, "quantize kernel", DTYPES)
    N = x.shape[0]
    codes = torch.empty((N,), dtype=torch.int8, device=x.device)
    scales = torch.empty((n_tiles(N),), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().quantize_launch(
            x.data_ptr(), DTYPES[x.dtype], codes.data_ptr(), scales.data_ptr(),
            N, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "quantize.quant")
    quantize_tiles.launches += 1
    return codes, scales


def dequantize_tiles(q, s, *, dtype=torch.float32):
    """q: (N,) int8 codes; s: (ceil(N/TILE),) fp32 scales -> (N,) in
    ``dtype``. One kernel launch on the card (fp32 or bf16 out)."""
    if q.dim() != 1 or q.shape[0] < 1 or q.dtype != torch.int8:
        raise ValueError(f"expected non-empty (N,) int8 codes, got "
                         f"{tuple(q.shape)} {q.dtype}")
    if s.shape != (n_tiles(q.shape[0]),) or s.dtype != torch.float32:
        raise ValueError(f"expected ({n_tiles(q.shape[0])},) fp32 scales, "
                         f"got {tuple(s.shape)} {s.dtype}")
    if s.device != q.device:
        raise ValueError(f"codes on {q.device} but scales on {s.device}")
    if q.device.type == "cpu":
        return _plain_dequantize(q, s, dtype)
    _cuda_checks(q, "dequantize kernel", (torch.int8,))
    if dtype not in DTYPES:
        raise TypeError(f"dequantize kernel writes fp32 or bf16, got {dtype}")
    s = s.contiguous()
    N = q.shape[0]
    out = torch.empty((N,), dtype=dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().dequantize_launch(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), DTYPES[dtype], N,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "quantize.dequant")
    dequantize_tiles.launches += 1
    return out


quantize_tiles.launches = 0
dequantize_tiles.launches = 0
