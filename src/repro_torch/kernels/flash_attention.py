"""Blocked (flash-style) causal GQA attention, forward.

Replaces the reference package's Pallas kernel ``_flash_kernel``
(``kernels/flash_attention.py``) with hand-written CUDA C++ for Hopper,
``csrc/flash_attention.cu``: online softmax over KV tiles with running
``(m, l, acc)`` in fp32, so scores never reach device memory beyond a
tile. Query head ``h`` reads KV head ``h // (Hq/Hkv)`` by index (no repeat
is materialised); causal masking uses ``-1e30``; the last divide is
``acc / max(l, 1e-30)`` by IEEE division; the output is in ``q.dtype``.
Head dims 32, 64 and 128, and any ``S >= 1`` (the tail tile is masked),
where the reference's tiling needs ``S % min(512, S) == 0`` (ROADMAP C3).
In causal mode the KV loop stops at the diagonal. The source has one kernel
a type: bf16 runs on the tensor cores through ``wgmma`` with P split into
two bf16 terms (``flash_attention_bf16_launch``), fp32 on the CUDA cores
(``flash_attention_launch``); the design and its numbers are at the top of
the source.

* :func:`flash_attention` — the reference's signature: ``q (B,Hq,S,hd)``,
  ``k, v (B,Hkv,S,hd)`` -> ``(B,Hq,S,hd)``.
* :func:`flash_attention_bshd` — the same on ``(B,S,H,hd)`` tensors, as
  the model's projections come: the kernel reads them through strides and
  writes a ``(B,S,Hq,hd)`` output, so the transposes around the call in the
  reference's ``layers.attention`` are not needed.

Dispatch is by where the tensors live: a CUDA tensor launches the kernel of
its type or raises (an unsupported dtype, head dim or stride raises; there
is no fallback), and a CPU tensor takes the plain PyTorch version,
``ref.flash_attention_ref`` (the full softmax in fp32), which is also what
the kernel is compared with on the card. The kernel has no backward: on a
CUDA tensor that requires grad the wrapper raises. Launches are counted in
``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128)

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        strides, f = ctypes.POINTER(ctypes.c_longlong), ctypes.c_float
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, strides, i, f, p]
        lib.flash_attention_bf16_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, strides, i, f, i, p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_bf16_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(q, k, v):
    """(B,H,S,hd) views of q, k, v; raises on what no version takes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected 4-d q, k, v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, hd)
            or Hkv < 1 or Hq % Hkv):
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)}: need k == v shapes, the same "
                         "B, S, hd, and Hq % Hkv == 0")
    if B < 1 or S < 1:
        raise ValueError(f"empty attention {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def warpgroups_for(hd: int, group: int) -> int:
    """Query heads a block of the bf16 kernel takes, one a warpgroup, all
    of one KV head: two where the group allows it and hd <= 64 (measured
    faster there on one H100; PERF.md §6), else one."""
    return 2 if hd <= 64 and group % 2 == 0 else 1


def _launch(q, k, v, out, causal: bool, warpgroups: int = 0) -> None:
    """Launch the kernel of q's type on (B,H,S,hd) views (any strides with a
    contiguous innermost dim and 16-byte aligned rows) writing into the
    view ``out``; ``warpgroups`` overrides the bf16 kernel's block
    (:func:`warpgroups_for`)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Hq, S, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes fp32 or bf16, got "
                        f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError("flash_attention has a forward kernel "
                                  "only; no backward (ROADMAP B9)")
    per_row = 16 // q.element_size()     # elements in 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(s % per_row for s in t.stride()[:3])):
            raise ValueError(f"{name}: the kernel needs a contiguous head "
                             f"dim and 16-byte aligned rows, got strides "
                             f"{t.stride()}")
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, out)
                                         for s in t.stride()[:3]])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), hd, B,
            Hq, k.shape[1], S, strides, int(causal), hd ** -0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            rc = _lib().flash_attention_bf16_launch(
                *args, warpgroups or warpgroups_for(hd, Hq // k.shape[1]),
                stream)
        else:
            rc = _lib().flash_attention_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc} (cudaGetLastError)")
    flash_attention.launches += 1


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Hq, S, hd); k/v: (B, Hkv, S, hd) with Hq % Hkv == 0 ->
    (B, Hq, S, hd) in ``q.dtype``. One kernel launch on the card."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal)
    return out


def flash_attention_bshd(q, k, v, *, causal: bool = True):
    """:func:`flash_attention` on q: (B, S, Hq, hd), k/v: (B, S, Hkv, hd)
    -> (B, S, Hq, hd); on the card the kernel reads and writes this layout
    in place of the transposes."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    _check(qt, kt, vt)
    if q.device.type == "cpu":
        return flash_attention_ref(qt, kt, vt, causal=causal).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(qt, kt, vt, out.transpose(1, 2), causal)
    return out


flash_attention.launches = 0
