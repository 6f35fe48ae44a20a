"""Whole-model one-pass aggregation kernels (the FlatModel engine's core).

The whole model is a single ``(P, N)`` stack of flat fp32 buffers and
aggregation is ONE kernel launch:

* :func:`aggregate_flat_onepass` — weighted mean over P replicas.
  Integer-leaf positions (``int_mask``) are rounded half-to-even *inside*
  the kernel, so optimizer counters survive aggregation exactly without a
  second pass.
* :func:`aggregate_quantize_flat` — the fused aggregate→quantize variant:
  emits the fp32 mean *and* int8 codes + per-subtile scales in the same
  launch, saving a separate quantize call.

Secure aggregation (``repro_torch.secureagg``) adds three more, over
*sealed* rows whose fp32 bit patterns were shifted in the uint32 ring by a
counter-based PRG mask (lane index = counter):

* :func:`apply_mask_flat` — seal: ``bits(buf) + Σ_j sign_j·PRG(seed_j, l)``
  mod 2^32; the same call with ``-signs`` unseals.
* :func:`unmask_aggregate_flat` — per row, regenerate the mask from its
  ``(P, R)`` seeds/signs, subtract it in the ring, then
  :func:`aggregate_flat_onepass`'s math: the mean equals the plain mean of
  the unsealed rows bit for bit.
* :func:`unmask_aggregate_quantize_flat` — the same, then the quantise tail
  of :func:`aggregate_quantize_flat`.

The two masked kernels take the reference's lane ``base`` and a global
``n_valid``, so one launch can unmask one shard of longer rows. The four
``*_sharded`` entry points split N over a mesh of devices (one device may
stand in it k times) and launch one kernel a shard; their results equal
one call's bit for bit. Over a world's mesh (``FlatShardings`` with a
process group) each rank launches the kernel on its own chunk alone and
the chunks' results are gathered on every rank.

These replace the reference package's Pallas kernels ``_agg_kernel``,
``_agg_quant_kernel``, ``_unmask_agg_kernel``, ``_unmask_agg_quant_kernel``
and its jitted ``apply_mask_flat`` (``kernels/fused.py``) with hand-written
CUDA C++ for Hopper, ``csrc/fused_agg.cu``. The plain forms are bounded by
bytes on the card: a stream of ``(P+1)·N`` words in and ``N`` out; at the
session's shape the stack sits in L2 and the launch dominates. The masked
forms are bounded by the PRG's integer operations (P·R words a lane). The
design (a grid over lanes with 16-byte loads; the masked forms the same
kernel reading rows through an unsealing reader, with a block size chosen
from N, or for a model too small to fill the card a kernel that spreads
its rows over warps; the quantised forms on the same grids, where every
block of a subtile waits for the subtile's absmax and quantises its own
means when the whole grid fits on the card at once, or else the last block
of a subtile to finish writes its codes) is described at the top of the
source. The quantised forms count arrivals in a workspace that the
wrappers own (``_workspace``).

Dispatch is by where the tensors live: a CUDA tensor launches the kernel or
raises — there is no fallback — and a CPU tensor takes the plain PyTorch
version beside it (``_plain_onepass`` / ``_plain_onepass_quant``), which is
also what the kernels are compared against on the card. The masked plain
versions (``_plain_mask_words``, ``_plain_unmask_stack``) hold each uint32
in an int64 and multiply in 16-bit halves, so no product passes 2^63; the
plain unmask is followed by the very ``_plain_onepass`` /
``_plain_onepass_quant`` of the plain path, so masked and plain agree bit for
bit by construction. Each wrapper counts its launches in a plain integer
attribute ``launches``.

A sealed buffer is arbitrary bits held as fp32 (NaNs with payloads,
subnormals): between seal and unmask only bit copies may touch it, and the
kernels and plain versions read it as integers.

``SUBTILE`` (16384 lanes) is the quantization granularity and part of the
wire format. Codes and scales equal ``ref.quantize_ref`` of the
SUBTILE-padded mean bit for bit; pad lanes count as exact zeros.

Zero total weight is a caller error: ``aggregate_flatmodel`` checks it on
the host before anything is launched, and the wrappers check it themselves
for CPU tensors; on the card they do not (it would force a synchronise).
"""

from __future__ import annotations

import ctypes
import operator

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
        lib.fused_agg_quant_launch.argtypes = [p, p, p, p, p, p, p, p, p, i,
                                               ll, p]
        lib.fused_agg_quant_launch.restype = ctypes.c_int
        lib.fused_mask_launch.argtypes = [p, p, p, i, p, ll, p]
        lib.fused_mask_launch.restype = ctypes.c_int
        lib.fused_unmask_agg_launch.argtypes = [p, p, p, p, p, i, ll, ll, p,
                                                i, ll, p]
        lib.fused_unmask_agg_launch.restype = ctypes.c_int
        lib.fused_unmask_agg_quant_launch.argtypes = [p, p, p, p, p, i, ll, ll,
                                                      p, p, p, p, p, p, i, ll,
                                                      p]
        lib.fused_unmask_agg_quant_launch.restype = ctypes.c_int
        lib.fused_plan.argtypes = [i, ll, i, p, p, p, p, p]
        lib.fused_plan.restype = ctypes.c_int
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


# The mask PRG (``repro_torch.secureagg.prg.prg_word``), elementwise over
# int64 tensors that hold uint32 values. Torch's ``>>`` on int64 is
# arithmetic, so every value is kept in [0, 2^32) before it is shifted.

MASK32 = 0xFFFFFFFF
_PRG_MIX1 = 0x7FEB352D
_PRG_MIX2 = 0x846CA68B


def _mul32(a, b):
    """``a * b mod 2^32`` for ``a`` and ``b`` in [0, 2^32) (tensors or
    ints): ``b`` is split into 16-bit halves, so no product reaches 2^49."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK32


def _mix32(x):
    x = _mul32(x ^ (x >> 16), _PRG_MIX1)
    x = _mul32(x ^ (x >> 15), _PRG_MIX2)
    return x ^ (x >> 16)


def _plain_prg(seeds, lanes):
    """PRG word at counter ``lanes`` under ``seeds`` (broadcast int64)."""
    x = lanes ^ _mul32(seeds, _PRG_MIX1)
    return _mix32((_mix32(x) + seeds) & MASK32)


def _plain_mask_words(seeds, signs, lanes):
    """``Σ_j signs[..., j] · PRG(seeds[..., j], lane)`` mod 2^32: seeds and
    signs ``(..., R)`` int64, lanes ``(L,)`` -> ``(..., L)`` int64. A -1
    sign is 2^32 - 1, ring negation."""
    seeds, signs = seeds & MASK32, signs & MASK32
    out = torch.zeros(seeds.shape[:-1] + lanes.shape, dtype=torch.int64,
                      device=lanes.device)
    for j in range(seeds.shape[-1]):              # R is small
        words = _plain_prg(seeds[..., j:j + 1], lanes)
        out = (out + _mul32(words, signs[..., j:j + 1])) & MASK32
    return out


def _bits(x):
    """fp32 -> its bit pattern as an int64 in [0, 2^32) (no float op)."""
    return x.view(torch.int32).to(torch.int64) & MASK32


def _from_bits(b):
    """int64 in [0, 2^32) -> the fp32 with that bit pattern."""
    return torch.where(b > 0x7FFFFFFF, b - (1 << 32), b).to(
        torch.int32).view(torch.float32)


def _plain_mask(buf, seeds, signs):
    lanes = torch.arange(buf.shape[0], dtype=torch.int64, device=buf.device)
    return _from_bits((_bits(buf) + _plain_mask_words(seeds, signs, lanes))
                      & MASK32)


def _plain_unmask_stack(y, seeds, signs, base=0, n_valid=None):
    """Sealed rows ``y (P, N)`` and their ``(P, R)`` seeds/signs -> the
    unsealed rows, exactly (ring subtraction). Lane ``l`` of ``y`` is lane
    ``base + l`` of the sealed row, its PRG counter; lanes whose counter is
    at or past ``n_valid`` (None: N) are padding that was never sealed and
    pass as they are, as in the reference's ``_unmask_bits``."""
    N = y.shape[1]
    n_valid = N if n_valid is None else n_valid
    live = max(0, min(N, n_valid - base))      # the counters below n_valid
    out = _bits(y)
    lanes = torch.arange(base, base + live, dtype=torch.int64,
                         device=y.device)
    out[:, :live] = (out[:, :live] - _plain_mask_words(seeds, signs, lanes)
                     ) & MASK32
    return _from_bits(out)


def _plain_unmask_onepass(y, w, int_mask, seeds, signs, base=0,
                          n_valid=None):
    return _plain_onepass(_plain_unmask_stack(y, seeds, signs, base, n_valid),
                          w, int_mask)


def _plain_unmask_onepass_quant(y, w, int_mask, seeds, signs, base=0,
                                n_valid=None):
    return _plain_onepass_quant(
        _plain_unmask_stack(y, seeds, signs, base, n_valid), w, int_mask)


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


# Seeds and signs are staged in the kernels' shared memory, 16 bytes a
# term (96 KB at this limit; the launchers opt in above 48 KB).
MAX_MASK_TERMS = 6144


def _check_mask_args(seeds, signs, rows, device):
    """``seeds``/``signs``: int64 ``(rows, R)`` (``(R,)`` when ``rows`` is
    None) on ``device``; raises on anything the kernels do not take."""
    for name, t in (("seeds", seeds), ("signs", signs)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int64:
            raise TypeError(f"{name} must be an int64 tensor, got "
                            f"{getattr(t, 'dtype', type(t))}")
    R = seeds.shape[-1] if seeds.dim() else 0
    want = (R,) if rows is None else (rows, R)
    for name, t in (("seeds", seeds), ("signs", signs)):
        if tuple(t.shape) != want or R < 1:
            raise ValueError(f"{name} must be {want} with R >= 1, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, rows on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (rows or 1) * R > MAX_MASK_TERMS:
        raise ValueError(f"{rows or 1} x {R} mask terms exceed "
                         f"{MAX_MASK_TERMS}")


def _check_lanes(base, n_valid, N):
    """``(base, n_valid)`` of a masked launch over N lanes, n_valid None
    meaning N; raises on what the kernels do not take. ``base`` is a
    multiple of SUBTILE, as ``shard_align`` makes every shard's, so the
    quantisers' subtiles are the row's; the PRG's counter is 32 bits."""
    base = operator.index(base)
    n_valid = N if n_valid is None else operator.index(n_valid)
    if base < 0 or base % SUBTILE:
        raise ValueError(f"base must be a non-negative multiple of {SUBTILE}"
                         f", got {base}")
    if n_valid < 0:
        raise ValueError(f"n_valid must be >= 0, got {n_valid}")
    if base + N > 1 << 32:
        raise ValueError(f"lanes {base}..{base + N - 1} pass the PRG's "
                         "32-bit counter")
    return base, n_valid


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} (cudaGetLastError)")


class _Workspace:
    """The quantised kernels' workspace on one device: three rows of a
    uint32 word a subtile (arrival counts, the absmax's bits, generations),
    which every launch leaves ready for the next (the first two rows at 0).
    ``words`` is the tensor the next launch uses, ``kept`` the smaller ones
    it replaced, ``stream`` the stream of the last launch issued outside a
    graph capture."""

    __slots__ = ("words", "kept", "stream")

    def __init__(self, words):
        self.words, self.kept, self.stream = words, [], None


_WORKSPACE = {}


def _workspace(device, n):
    """The workspace's three rows' addresses for ``n`` lanes on ``device``
    (the current CUDA device), made with ``torch.zeros`` on the first call
    and grown to at least twice its size when a call needs more; the C
    entries allocate nothing.

    * Growing never frees: a CUDA graph captured before holds the old
      tensor's address, so the old tensor is kept in ``kept`` and the
      graph's replays go on using it, left ready by each replay.
    * Growing inside a graph capture raises, because the zeros would be
      written only when the graph replays: make one call at that size (or
      more) before capturing.
    * A call on another stream than the last call's first waits for that
      stream (``wait_stream``), so calls issued on two streams never use
      the words at once. A graph replay is not ordered so: replay a graph
      that holds these kernels on the stream of the other calls, or when
      none is running.
    """
    need = -(-n // SUBTILE)
    ws = _WORKSPACE.get(device)
    capturing = torch.cuda.is_current_stream_capturing()
    if ws is None or ws.words.shape[1] < need:
        if capturing:
            raise RuntimeError(
                f"the quantised kernels' workspace must grow to {need} "
                "subtiles inside a CUDA graph capture: make one call at "
                "this size before capturing")
        words = torch.zeros(
            (3, need if ws is None else max(need, 2 * ws.words.shape[1])),
            dtype=torch.int32, device=device)
        if ws is None:
            ws = _WORKSPACE[device] = _Workspace(words)
        else:
            ws.kept.append(ws.words)
            ws.words = words
    if not capturing:
        stream = torch.cuda.current_stream(device)
        if ws.stream is not None and ws.stream != stream:
            stream.wait_stream(ws.stream)
        ws.stream = stream
    return [row.data_ptr() for row in ws.words]


_PLAN_OPS = ("fused.agg", "fused.agg_quant", "fused.unmask_agg",
             "fused.unmask_agg_quant")
_PLAN_FORMS = ("lanes", "rows")


def launch_plan(name: str, n: int, terms: int = 0) -> dict:
    """The kernel that the launcher of ``name`` (one of ``_PLAN_OPS``) runs
    at ``n`` lanes of 16-byte aligned rows on the current CUDA device, with
    ``terms`` (P·R) staged mask terms for the masked ones (rows with no
    lane of padding): its form (one
    lane a thread, or rows over warps), whether a thread takes four lanes,
    its grid, and for a quantised form whether
    every block waits for its subtile's scale (``together``) or the last
    block of a subtile writes its codes."""
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong(),
           ctypes.c_int()]
    _raise_on(_lib().fused_plan(_PLAN_OPS.index(name), n, terms,
                                *map(ctypes.byref, out)), "fused_plan")
    form, vec, threads, blocks, together = (v.value for v in out)
    return {"form": _PLAN_FORMS[form], "vec": bool(vec), "threads": threads,
            "blocks": blocks, "together": bool(together)}


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
        words = _workspace(x.device, N)
        rc = lib.fused_agg_quant_launch(
            x.data_ptr(), w.data_ptr(), None if m is None else m.data_ptr(),
            mean.data_ptr(), codes.data_ptr(), scales.data_ptr(), *words, P,
            N, _stream(x))
    _raise_on(rc, "fused.agg_quant")
    aggregate_quantize_flat.launches += 1
    return mean, codes, scales


def apply_mask_flat(buf, seeds, signs):
    """Seal a flat fp32 buffer: ``bits(buf) + Σ_j signs[j]·PRG(seeds[j], l)``
    mod 2^32 at every lane ``l``; one kernel launch -> (N,) fp32 bits.

    ``seeds``/``signs``: int64 ``(R,)`` on the buffer's device. Exact
    inverse: the same call with ``-signs``.
    """
    if buf.dim() != 1 or buf.shape[0] < 1 or buf.dtype != torch.float32:
        raise ValueError(f"expected a non-empty (N,) fp32 buffer, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    if not buf.is_contiguous():
        raise ValueError("buf must be contiguous")
    _check_mask_args(seeds, signs, None, buf.device)
    if buf.device.type == "cpu":
        return _plain_mask(buf, seeds, signs)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    lib = _lib()
    out = torch.empty_like(buf)
    with torch.cuda.device(buf.device):
        rc = lib.fused_mask_launch(buf.data_ptr(), seeds.data_ptr(),
                                   signs.data_ptr(), seeds.shape[0],
                                   out.data_ptr(), buf.shape[0], _stream(buf))
    _raise_on(rc, "fused.mask")
    apply_mask_flat.launches += 1
    return out


def unmask_aggregate_flat(y, w, int_mask=None, *, seeds, signs, base=0,
                          n_valid=None):
    """Fused unmask→aggregate: ``y (P, N)`` sealed rows, ``seeds``/``signs``
    int64 ``(P, R)`` -> mean (N,) in one kernel launch, bit for bit
    :func:`aggregate_flat_onepass` on the unsealed rows.

    ``y`` may be one shard of longer rows, as the reference's kernel takes
    it: lane ``l`` is the rows' lane ``base + l`` (its PRG counter; a
    multiple of SUBTILE), and lanes at or past ``n_valid`` of the whole rows
    (None: N) are padding, never sealed, aggregated as they are."""
    y, w, m = _check_args(y, w, int_mask)
    _check_mask_args(seeds, signs, y.shape[0], y.device)
    P, N = y.shape
    base, n_valid = _check_lanes(base, n_valid, N)
    if y.device.type == "cpu":
        check_aggregation_weights(w)
        return _plain_unmask_onepass(y, w, m, seeds, signs, base, n_valid)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    lib = _lib()
    out = torch.empty((N,), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        rc = lib.fused_unmask_agg_launch(
            y.data_ptr(), w.data_ptr(), None if m is None else m.data_ptr(),
            seeds.data_ptr(), signs.data_ptr(), seeds.shape[1], base, n_valid,
            out.data_ptr(), P, N, _stream(y))
    _raise_on(rc, "fused.unmask_agg")
    unmask_aggregate_flat.launches += 1
    return out


def unmask_aggregate_quantize_flat(y, w, int_mask=None, *, seeds, signs,
                                   base=0, n_valid=None):
    """Fused unmask→aggregate→quantize: one kernel launch -> (mean, int8
    codes, scales), bit for bit :func:`aggregate_quantize_flat` on the
    unsealed rows. ``base`` and ``n_valid`` as for
    :func:`unmask_aggregate_flat`."""
    y, w, m = _check_args(y, w, int_mask)
    _check_mask_args(seeds, signs, y.shape[0], y.device)
    P, N = y.shape
    base, n_valid = _check_lanes(base, n_valid, N)
    if y.device.type == "cpu":
        check_aggregation_weights(w)
        return _plain_unmask_onepass_quant(y, w, m, seeds, signs, base,
                                           n_valid)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    lib = _lib()
    mean = torch.empty((N,), dtype=torch.float32, device=y.device)
    codes = torch.empty((N,), dtype=torch.int8, device=y.device)
    scales = torch.empty((-(-N // SUBTILE),), dtype=torch.float32,
                         device=y.device)
    with torch.cuda.device(y.device):
        words = _workspace(y.device, N)
        rc = lib.fused_unmask_agg_quant_launch(
            y.data_ptr(), w.data_ptr(), None if m is None else m.data_ptr(),
            seeds.data_ptr(), signs.data_ptr(), seeds.shape[1], base,
            n_valid, mean.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            *words, P, N, _stream(y))
    _raise_on(rc, "fused.unmask_agg_quant")
    unmask_aggregate_quantize_flat.launches += 1
    return mean, codes, scales


# ---------------------------------------------------------------------------
# Sharded variants: the same one-pass aggregation per model-axis shard
# ---------------------------------------------------------------------------
#
# The reference runs these under ``shard_map`` over a jax mesh, with a VMEM
# tile chosen per shard (``tile_for``, a TPU budget that has no counterpart
# here: the launchers pick their grids from N). Here a mesh is a tuple of
# devices (``repro_torch.sharding``; one device may stand in it k times): N
# is padded to ``shard_align(N, k)`` and cut into k contiguous
# ``(P, local_n)`` shards, shard r is copied to ``mesh[r]`` and aggregated
# there by the one-shard kernels (the masked ones at ``base = r·local_n``
# with the global ``n_valid``), and the shards' outputs are gathered on the
# mesh's first device. Each output lane is the same function of the same
# inputs as on one device, and every shard is whole subtiles, so means,
# codes and scales equal one call's bit for bit.


def shard_align(n: int, shards: int) -> int:
    """Padded total length so each of ``shards`` equal contiguous
    model-axis shards is a SUBTILE multiple.

    Padding only at the global tail would misalign per-shard subtile
    boundaries; aligning every shard keeps the global SUBTILE grid
    identical to the single-device layout, so per-SUBTILE quantization
    scales — and therefore int8 codes — stay bit-identical."""
    per = -(-n // (shards * SUBTILE)) * SUBTILE
    return shards * per


def _mesh_devices(mesh):
    """The devices of a mesh: a ``FlatShardings`` (its ``mesh``) or a
    sequence of devices."""
    return tuple(torch.device(d) for d in getattr(mesh, "mesh", mesh))


def shard_chunk(x, r: int, k: int, device=None):
    """``(base, x_r)``: lanes ``[base, base + local_n)`` of ``x`` (its last
    dimension of N lanes), ``local_n = shard_align(N, k) / k`` and ``base =
    r·local_n``, as a new tensor on ``device`` (None: ``x``'s) with the
    lanes past N zero: shard r of k. Only bits are copied (a sealed stack
    comes as its int32 view)."""
    N = x.shape[-1]
    local_n = shard_align(N, k) // k
    lo = min(N, r * local_n)
    hi = min(N, lo + local_n)
    xr = torch.zeros(x.shape[:-1] + (local_n,), dtype=x.dtype,
                     device=x.device if device is None else device)
    xr[..., :hi - lo] = x[..., lo:hi]
    return r * local_n, xr


def _pad_sharded(x, int_mask, devices):
    """``[(base, x_r, mask_r)]``: the ``(P, N)`` stack (and its mask) as
    k shards (:func:`shard_chunk`), shard r on ``devices[r]``."""
    k = len(devices)
    shards = []
    for r, dev in enumerate(devices):
        base, xr = shard_chunk(x, r, k, dev)
        mr = None if int_mask is None else shard_chunk(int_mask, r, k,
                                                       dev)[1]
        shards.append((base, xr, mr))
    return shards


def _on(t, devices):
    """``t`` on each distinct device of ``devices``, copied once each."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = t.to(d)
    return out


def _gather(outs, devices, N):
    """The shards' ``mean`` (or ``(mean, codes, scales)``) gathered on the
    mesh's first device and trimmed to N lanes and ceil(N/SUBTILE)
    subtiles."""
    home = devices[0]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(home) for o in outs])[:N]
    mean, codes, scales = (torch.cat([o[i].to(home) for o in outs])
                           for i in range(3))
    return mean[:N], codes[:N], scales[:-(-N // SUBTILE)]


def _world_chunk(x, int_mask, mesh):
    """This rank's ``(base, x_r, mask_r)`` of :func:`_pad_sharded`, where
    ``mesh`` is a world's ``FlatShardings``."""
    base, xr = shard_chunk(x, mesh.rank, mesh.n_shards)
    mr = None if int_mask is None else shard_chunk(int_mask, mesh.rank,
                                                   mesh.n_shards)[1]
    return base, xr, mr


def _world_gather(out, mesh, N):
    """Every rank's chunk result gathered over the model axis's group, on
    every rank, trimmed as :func:`_gather` trims."""
    from repro_torch import collectives
    if isinstance(out, torch.Tensor):
        return collectives.all_gather(out, mesh.group)[:N]
    mean, codes, scales = (collectives.all_gather(o, mesh.group)
                           for o in out)
    return mean[:N], codes[:N], scales[:-(-N // SUBTILE)]


def _sharded_onepass(x, w, int_mask, mesh, quantize):
    x, w, m = _check_args(x, w, int_mask)
    agg = aggregate_quantize_flat if quantize else aggregate_flat_onepass
    if getattr(mesh, "group", None) is not None:       # a world
        _, xr, mr = _world_chunk(x, m, mesh)
        return _world_gather(agg(xr, w, mr), mesh, x.shape[1])
    devices = _mesh_devices(mesh)
    ws = _on(w, devices)
    outs = [agg(xr, ws[xr.device], mr)
            for _, xr, mr in _pad_sharded(x, m, devices)]
    return _gather(outs, devices, x.shape[1])


def aggregate_flat_onepass_sharded(x, w, int_mask=None, *, mesh):
    """Sharded :func:`aggregate_flat_onepass` over ``mesh`` (a
    ``FlatShardings`` or a sequence of devices): one launch a shard, the
    mean (N,) gathered on the mesh's first device, bit for bit one call's
    (the weighted mean is elementwise over N)."""
    return _sharded_onepass(x, w, int_mask, mesh, quantize=False)


def aggregate_quantize_flat_sharded(x, w, int_mask=None, *, mesh):
    """Sharded fused aggregate→quantize.

    Per-shard lengths are SUBTILE-aligned (:func:`shard_align`), so the
    global subtile grid — and with it codes and scales — is bit-identical
    to :func:`aggregate_quantize_flat` on one device; trailing pad
    subtiles are sliced off before returning.
    """
    return _sharded_onepass(x, w, int_mask, mesh, quantize=True)


def _sharded_unmask(y, w, int_mask, seeds, signs, mesh, quantize):
    y, w, m = _check_args(y, w, int_mask)
    _check_mask_args(seeds, signs, y.shape[0], y.device)
    N = y.shape[1]
    agg = (unmask_aggregate_quantize_flat if quantize
           else unmask_aggregate_flat)
    if getattr(mesh, "group", None) is not None:       # a world
        base, yr, mr = _world_chunk(y.view(torch.int32), m, mesh)
        out = agg(yr.view(torch.float32), w, mr, seeds=seeds, signs=signs,
                  base=base, n_valid=N)
        return _world_gather(out, mesh, N)
    devices = _mesh_devices(mesh)
    ws, sd, sg = (_on(t, devices) for t in (w, seeds, signs))
    outs = []
    for base, yr, mr in _pad_sharded(y.view(torch.int32), m, devices):
        dev = yr.device
        outs.append(agg(yr.view(torch.float32), ws[dev], mr, seeds=sd[dev],
                        signs=sg[dev], base=base, n_valid=N))
    return _gather(outs, devices, N)


def unmask_aggregate_flat_sharded(y, w, int_mask=None, *, seeds, signs,
                                  mesh):
    """Sharded :func:`unmask_aggregate_flat`: shard r holds the rows' lanes
    ``[r·local_n, (r+1)·local_n)`` and unmasks them at ``base = r·local_n``
    against the global ``n_valid = N``, so it subtracts exactly the words
    the one-device sealer added, and its zero padding stays zeros. Mean
    bit for bit the plain sharded path's and one call's."""
    return _sharded_unmask(y, w, int_mask, seeds, signs, mesh,
                           quantize=False)


def unmask_aggregate_quantize_flat_sharded(y, w, int_mask=None, *, seeds,
                                           signs, mesh):
    """Sharded :func:`unmask_aggregate_quantize_flat`."""
    return _sharded_unmask(y, w, int_mask, seeds, signs, mesh,
                           quantize=True)


aggregate_flat_onepass.launches = 0
aggregate_quantize_flat.launches = 0
apply_mask_flat.launches = 0
unmask_aggregate_flat.launches = 0
unmask_aggregate_quantize_flat.launches = 0
