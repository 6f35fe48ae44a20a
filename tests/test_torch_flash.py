"""The PyTorch package's flash attention (kernel B9's wrapper; on CPU
tensors the plain version that the CUDA kernel is held against on the card)
against the reference package's Pallas kernel run in interpret mode and its
full-softmax oracle, plus ROADMAP C3: the reference's tiling raises at
lengths its own dispatch admits, and the port is exact there.

Tolerances: fp32 ``rtol = atol = 3e-5``, that of the reference's own kernel
tests (``tests/test_kernels.py``); bf16 ``rtol = 1e-2, atol = 1e-4``, within
theirs (``3e-2``): every version rounds an fp32 result to bf16, so two differ
by at most one bf16 step (2^-7 of the value) where their fp32 sums straddle a
rounding point, while the outputs are about 0.02 in size.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.kernels import KERNELS, ref
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bshd,
)
from repro_torch.models import layers as L
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-4)}


def _qkv(B, Hq, Hkv, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]


def _both(arrays, dtype):
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,S,hd", [
    (2, 4, 2, 256, 64),      # GQA group 2, B > 1
    (1, 8, 8, 128, 32),      # MHA
    (2, 4, 1, 256, 128),     # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference_kernel_and_oracle(B, Hq, Hkv, S, hd, dtype,
                                                   causal):
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, Hq, Hkv, S, hd, seed=S + Hq + hd),
                                    dtype)
    got = flash_attention(q, k, v, causal=causal)
    assert got.shape == (B, Hq, S, hd) and got.dtype == q.dtype
    pallas = jflash(jq, jk, jv, causal=causal, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])
    # the port's oracle is the plain version itself
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=causal))


def _online_softmax(q, k, v, causal, acc_dtype, block=16, p_terms=0):
    """Attention by online softmax over blocks of keys, its running sum kept
    in ``acc_dtype`` between blocks and cast to bf16 at the end: in fp32 the
    fp32 kernel's arithmetic, in bf16 a kernel that has lost precision.
    ``p_terms`` 1 or 2 is the bf16 kernel's: scores pre-scaled into the log2
    domain, ``l`` summed from the fp32 p, and ``P . V`` of p rounded to one
    bf16 (1) or split into ``hi = bf16(p)`` and ``lo = bf16(p - hi)`` (2),
    bf16 products summed in fp32 as the tensor cores do."""
    g = q.shape[1] // k.shape[1]
    S, hd = q.shape[2], q.shape[3]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(g, 1) for t in (k, v))
    scale = hd ** -0.5 * (math.log2(math.e) if p_terms else 1.0)
    exp = torch.exp2 if p_terms else torch.exp
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape, dtype=acc_dtype)
    for j in range(0, S, block):
        s = (qf @ kf[:, :, j:j + block].transpose(-1, -2)) * scale
        if causal:
            visible = (torch.arange(j, min(S, j + block))[None]
                       <= torch.arange(S)[:, None])
            s = torch.where(visible, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        p = exp(s - m_new[..., None])
        alpha = exp(m - m_new)
        l = l * alpha + p.sum(-1)
        if p_terms:
            hi = p.bfloat16().float()
            terms = [hi, (p - hi).bfloat16().float()][:p_terms]
            pv = sum(t @ vf[:, :, j:j + block] for t in terms)
        else:
            pv = p @ vf[:, :, j:j + block]
        acc = (acc.float() * alpha[..., None] + pv).to(acc_dtype)
        m = m_new
    return (acc.float() / torch.clamp_min(l, 1e-30)[..., None]).bfloat16()


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_tolerance_rejects_sums_kept_in_bf16(causal):
    """The bf16 tolerance passes the kernel's arithmetic (sums in fp32) and
    fails the same loop with its running sum rounded to bf16."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(1, 8, 2, 256, 64, seed=7))
    want = _f32(ref.flash_attention_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(
        _f32(_online_softmax(q, k, v, causal, torch.float32)), want,
        **TOL["bfloat16"])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(
            _f32(_online_softmax(q, k, v, causal, torch.bfloat16)), want,
            **TOL["bfloat16"])


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_tolerance_needs_p_in_two_terms(causal, hd):
    """The bf16 kernel's tile loop (64 keys a tile, P split in two bf16
    terms) passes the bf16 tolerance; the same loop with P rounded to one
    bf16, as a plain tensor-core flash kernel does, fails it."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(1, 8, 2, 256, hd, seed=7))
    want = _f32(ref.flash_attention_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(
        _f32(_online_softmax(q, k, v, causal, torch.float32, block=64,
                             p_terms=2)), want, **TOL["bfloat16"])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(
            _f32(_online_softmax(q, k, v, causal, torch.float32, block=64,
                                 p_terms=1)), want, **TOL["bfloat16"])


@pytest.mark.parametrize("causal", [True, False])
def test_bshd_layout_equals_bhsd(causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 6, 3, 77, 32, seed=3))
    want = flash_attention(q, k, v, causal=causal)
    got = flash_attention_bshd(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(), causal=causal)
    assert got.shape == (2, 77, 6, 32)
    assert torch.equal(got.transpose(1, 2), want)


@pytest.mark.parametrize("S", [640, 768])
def test_c3_reference_raises_where_the_port_is_exact(S):
    """ROADMAP C3: ``layers.attention`` admits any S % 128 == 0, but the
    reference's flash wrapper asserts S % min(512, S) == 0. At such S the
    port's flash path equals its plain attention and the oracle."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 2, 1, S, 64, seed=S), "float32")
    with pytest.raises(AssertionError):
        jflash(jq, jk, jv, causal=True, interpret=True)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True)
    got = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-5, atol=3e-5)

    jcfg = jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b")).with_(
        use_flash=True)
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    rng = np.random.default_rng(S)
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    p = {name: (rng.standard_normal(shape) * d ** -0.5).astype(np.float32)
         for name, shape in (("wq", (d, cfg.n_heads * hd)),
                             ("wk", (d, cfg.n_kv_heads * hd)),
                             ("wv", (d, cfg.n_kv_heads * hd)),
                             ("wo", (cfg.n_heads * hd, d)))}
    x = rng.standard_normal((1, S, d)).astype(np.float32)
    with pytest.raises(AssertionError):
        JL.attention({k_: jnp.asarray(a) for k_, a in p.items()},
                     jnp.asarray(x), jcfg)
    tp = {k_: torch.from_numpy(a) for k_, a in p.items()}
    flash, _ = L.attention(tp, torch.from_numpy(x), cfg.with_(use_flash=True))
    plain, _ = L.attention(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), rtol=3e-5,
                               atol=3e-5)


def test_wrapper_rejects_what_no_version_takes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 16, 32, seed=0))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(q, k[:, :1].expand(1, 3, 16, 32), v, causal=True)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(q, k[:, :, :8], v[:, :, :8])
    with pytest.raises(TypeError, match="mixed"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="empty"):
        flash_attention(q[:, :, :0], k[:, :, :0], v[:, :, :0])
    # neither the CPU nor a CUDA device: raises, never falls back
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_registered_with_its_source_and_counts_no_cpu_launch():
    meta = KERNELS["flash_attention"]
    assert meta["wrapper"] is flash_attention and meta["route"] == "cuda"
    assert os.path.isfile(os.path.join(REPO, meta["source"]))
    path, line = meta["replaces"].split(":")
    with open(os.path.join(REPO, path)) as fh:
        assert "pl.pallas_call(" in fh.readlines()[int(line) - 1]
    before = flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 64, seed=1))
    flash_attention(q, k, v)
    flash_attention_bshd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2))
    assert flash_attention.launches == before


def test_cuda_source_keeps_its_contract():
    """What the CPU can check of the CUDA source: bf16 on the tensor cores
    through wgmma beside the fp32 entry point, IEEE division, the
    reference's mask value, round-to-nearest bf16 stores, accurate exp, the
    launch error returned, the causal loop stopping at the diagonal."""
    from repro_torch.kernels import build

    src = open(os.path.join(build.CSRC, "flash_attention.cu")).read()
    for needle in ("wgmma.mma_async", "cp.async",
                   'extern "C" int flash_attention_bf16_launch',
                   'extern "C" int flash_attention_launch',
                   "__fdiv_rn", "-1e30f", "__float2bfloat16_rn", "exp2f(",
                   "cudaGetLastError", "min(S, (qb + 1) * BQ)",
                   "min(S, q0 + BQ)", "h / group"):
        assert needle in src, needle
    assert "__expf" not in src and "-use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path("flash_attention").name.startswith(
        "libflash_attention_")


def _c_params(src, name):
    """Kinds of the parameters of ``extern "C" int name(...)`` in the
    source: pointer, long long* (the strides), int or float."""
    head = src[src.index(f'extern "C" int {name}('):]
    kinds = []
    for param in head[head.index("(") + 1:head.index(")")].split(","):
        flat = param.replace(" ", "")
        kinds.append("pointer" if "void*" in flat else
                     "long long*" if "longlong*" in flat else
                     param.split()[0])
    return kinds


def test_ctypes_binding_matches_the_c_entry_points(monkeypatch):
    """The wrapper's ctypes argument types follow each entry point's C
    parameters one for one (a pointer or an int in the wrong place is cut
    or misread silently)."""
    import ctypes
    import types

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    names = ("flash_attention_launch", "flash_attention_bf16_launch")
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                    for n in names})
    monkeypatch.setattr(build, "load", lambda name: fake)
    monkeypatch.setattr(fa, "_LIB", None)
    fa._lib()
    src = open(os.path.join(build.CSRC, "flash_attention.cu")).read()
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_float: "float",
             ctypes.POINTER(ctypes.c_longlong): "long long*"}
    for name in names:
        fn = getattr(fake, name)
        assert [kinds[t] for t in fn.argtypes] == _c_params(src, name), name
        assert fn.restype is ctypes.c_int
