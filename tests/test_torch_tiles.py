"""The PyTorch package's per-leaf kernels and their public wrappers (on CPU
tensors: the plain versions that the CUDA kernels of ``csrc/aggregate.cu``
and ``csrc/quantize.cu`` are held against on the card) against the
reference package's Pallas kernels run in interpret mode and its oracles.

Tolerances: fp32 means ``rtol = atol = 1e-5`` (summation order differs
between XLA and PyTorch); bf16 means at most one bf16 step apart (both
round an fp32 sum that may differ in its last bits); integer leaves equal.
Codes and scales equal the reference's op-by-op ``ref.quantize_ref`` bit
for bit, and are at most one ulp (scales) or one step (codes) from its
jitted Pallas quantiser, which divides by 127 as a reciprocal multiply
(ROADMAP C1). Dequantised values equal the reference's bit for bit.
Inputs come from ``numpy.random.default_rng``; the reference's Pallas
kernels cost about a second a call in interpret mode, so the grids are small.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quantize import quantize_tiles as j_quantize_tiles
from repro.models.tasks import cnn_task as jax_cnn_task
from repro_torch.engine.flat import params_from_numpy, params_to_numpy
from repro_torch.kernels import (KERNELS, aggregate_flat, aggregate_pytree,
                                 dequantize_flat, quantize_flat,
                                 quantized_delta_pull, quantized_delta_push)
from repro_torch.kernels import aggregate as tagg
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref
from test_torch_threads import one_torch_thread  # noqa: F401

TILE = 16384
TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a, dtype):
    """One numpy fp32 array as the same values in both packages, rounded
    to ``dtype`` by each (both round to nearest even, so the bits agree)."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _to_np(t):
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _bf16_steps(a, b):
    """How many bf16 steps apart two bf16 arrays (as fp32 numpy) lie."""
    def ordered(v):
        bits = (v.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return np.abs(ordered(a) - ordered(b))


def _assert_means(got, want, dtype):
    got, want = _to_np(got), _to_np(want)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        assert _bf16_steps(got, want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------- aggregate


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("P,N", [(1, 5000), (4, 3 * TILE - 5)])
def test_aggregate_flat_matches_reference_kernel_and_oracle(P, N, dtype):
    rng = np.random.default_rng(P * 7 + N)
    x = (rng.standard_normal((P, N)) * 2).astype(np.float32)
    w = (rng.random(P) + 0.25).astype(np.float32)
    tx, jx = _pair(x, dtype)
    got = aggregate_flat(tx, torch.from_numpy(w))
    assert got.dtype == DTYPES[dtype][0] and got.shape == (N,)
    _assert_means(got, jops.aggregate_flat(jx, jnp.asarray(w),
                                           interpret=True), dtype)
    _assert_means(got, jref.aggregate_ref(jx, jnp.asarray(w)), dtype)
    # host weights of any kind, as the reference takes them
    assert torch.equal(got, aggregate_flat(tx, [float(v) for v in w]))


def _tree_models(dtype, P, seed):
    """P models of a tree with a float matrix, a long float vector, a 0-dim
    float leaf (MF's ``mu``) and an integer leaf whose means land on .5."""
    rng = np.random.default_rng(seed)
    models = []
    for p in range(P):
        models.append({
            "w": (rng.standard_normal(TILE + 129) * 2).astype(np.float32),
            "b": (rng.standard_normal((37, 11)) * 0.5).astype(np.float32),
            "mu": np.asarray(3.0 + p, np.float32),
            "step": np.asarray([7 + p, 100 + p, -3 - p, 12345], np.int32),
        })
    tdt, jdt = DTYPES[dtype]
    tm = [{k: (torch.from_numpy(v).to(tdt) if v.dtype == np.float32
               else torch.from_numpy(v)) for k, v in m.items()}
          for m in models]
    jm = [{k: (jnp.asarray(v).astype(jdt) if v.dtype == np.float32
               else jnp.asarray(v)) for k, v in m.items()} for m in models]
    return tm, jm


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_aggregate_pytree_matches_reference(dtype):
    """Every leaf in its own dtype and shape; integer leaves equal the
    reference's, half-to-even included (P = 2: 7.5 -> 8, 100.5 -> 100,
    -3.5 -> -4); the 0-dim leaf stays 0-dim."""
    tm, jm = _tree_models(dtype, 2, seed=1)
    w = [1.0, 1.0]
    got = aggregate_pytree(tm, w)
    want = jops.aggregate_pytree(jm, jnp.asarray(w), interpret=True)
    assert got["step"].dtype == torch.int32
    assert got["step"].tolist() == [8, 100, -4, 12345]
    np.testing.assert_array_equal(got["step"].numpy(),
                                  np.asarray(want["step"]))
    assert got["mu"].shape == () and float(got["mu"]) == 3.5
    for k in ("w", "b", "mu"):
        assert got[k].dtype == tm[0][k].dtype
        assert tuple(got[k].shape) == tuple(want[k].shape)
        _assert_means(got[k], want[k], dtype)


def test_aggregate_pytree_weighted_matches_oracle():
    """Unequal weights over four models, against the reference's oracle
    leaf by leaf; equal integer leaves come back exactly."""
    tm, jm = _tree_models("float32", 4, seed=2)
    for m in tm:
        m["step"] = torch.tensor([7, 12345], dtype=torch.int32)
    w = np.asarray([0.5, 1.0, 2.0, 0.25], np.float32)
    got = aggregate_pytree(tm, w)
    assert got["step"].tolist() == [7, 12345]
    for k in ("w", "b", "mu"):
        stacked = jnp.stack([jnp.ravel(m[k]) for m in jm])
        want = jref.aggregate_ref(stacked, jnp.asarray(w))
        np.testing.assert_allclose(got[k].reshape(-1).numpy(),
                                   np.asarray(want), **TOL)


def test_aggregate_weight_check_and_shapes():
    x = torch.ones((2, 10))
    for bad in ([0.0, 0.0], torch.tensor([1.0, -1.0])):
        with pytest.raises(ValueError, match="positive total"):
            aggregate_flat(x, bad)
        with pytest.raises(ValueError, match="positive total"):
            aggregate_pytree([{"a": x[0]}, {"a": x[1]}], bad)
    with pytest.raises(ValueError):
        tagg.aggregate_tiles(torch.ones((2, 10)), torch.ones(3))
    with pytest.raises(ValueError):
        tagg.aggregate_tiles(torch.ones((2, 0)), torch.ones(2))
    with pytest.raises(ValueError, match="unsupported device"):
        tagg.aggregate_tiles(torch.ones((2, 4), device="meta"),
                             torch.ones(2, device="meta"))


# ----------------------------------------------------------------- quantize


def _delta(N, seed):
    """Normals with a per-tile magnitude drawn from [1e-3, 10]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(N).astype(np.float32)
    mags = rng.uniform(1e-3, 10.0, -(-N // TILE)).astype(np.float32)
    return x * np.repeat(mags, TILE)[:N]


@pytest.mark.parametrize("N", [100, TILE, 3 * TILE + 3])
def test_quantize_flat_bit_exact_to_oracle_within_a_step_of_kernel(N):
    x = _delta(N, seed=N)
    codes, scales = quantize_flat(torch.from_numpy(x))
    assert codes.dtype == torch.int8 and codes.shape == (N,)
    assert scales.dtype == torch.float32 and scales.shape == (-(-N // TILE),)
    pad = (-N) % TILE
    want_q, want_s = jref.quantize_ref(jnp.pad(jnp.asarray(x), (0, pad)))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_q)[:N])
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
    # the reference's own B7 (jitted: a reciprocal multiply, ROADMAP C1)
    kq, ks = jops.quantize_flat(jnp.asarray(x), interpret=True)
    ulps = np.abs(scales.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(ks).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    steps = np.abs(codes.numpy().astype(np.int32)
                   - np.asarray(kq).astype(np.int32))
    assert steps.max() <= 1


@pytest.mark.parametrize("N", [TILE + 1, 3 * TILE + 5])
def test_quantize_flat_nonfinite_lanes_match_reference(N):
    """A NaN at a lane of tile 0, +Inf of tile 1 and -Inf of tile 2 (as
    many as N has): scale NaN, Inf, Inf and every code of those tiles 0, in
    the port as in the reference's oracle and its Pallas kernel (interpret
    mode); the other tiles as in the test above."""
    x = _delta(N, seed=N + 1)
    planted = []
    for t, v in enumerate((np.nan, np.inf, -np.inf)):
        if t * TILE < N:
            x[min(t * TILE + 1000, N - 1)] = v
            planted.append(t)
    codes, scales = quantize_flat(torch.from_numpy(x))
    pad = (-N) % TILE
    want_q, want_s = jref.quantize_ref(jnp.pad(jnp.asarray(x), (0, pad)))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_q)[:N])
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
    kq, ks = j_quantize_tiles(jnp.pad(jnp.asarray(x), (0, pad)),
                              interpret=True)
    kq, ks = np.asarray(kq)[:N], np.asarray(ks)
    for t in range(-(-N // TILE)):
        got_q = codes.numpy()[t * TILE:(t + 1) * TILE]
        if t in planted:
            want = np.nan if t == 0 else np.inf
            np.testing.assert_array_equal(scales.numpy()[t], want)
            np.testing.assert_array_equal(ks[t], want)
            assert not got_q.any() and not kq[t * TILE:(t + 1) * TILE].any()
        else:
            assert abs(int(scales.numpy().view(np.int32)[t])
                       - int(ks.view(np.int32)[t])) <= 1
            assert np.abs(got_q.astype(np.int32)
                          - kq[t * TILE:(t + 1) * TILE]).max() <= 1


def test_quantize_bf16_input_is_its_fp32_widening():
    x = _delta(TILE + 77, seed=4)
    tb, jb = _pair(x, "bfloat16")
    codes, scales = quantize_flat(tb)
    want_q, want_s = quantize_flat(tb.to(torch.float32))
    assert torch.equal(codes, want_q) and torch.equal(scales, want_s)
    pad = (-x.shape[0]) % TILE
    jq, js = jref.quantize_ref(jnp.pad(jb.astype(jnp.float32), (0, pad)))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jq)[:x.shape[0]])


def test_ragged_tail_quantises_as_zero_padding():
    """Lanes past N count as exact zeros: the last scale comes from the
    real lanes only, as the reference's padded call gives it."""
    x = _delta(TILE + 10, seed=5)
    x[TILE:] *= 1e-3
    _, scales = quantize_flat(torch.from_numpy(x))
    want = torch.clamp_min(torch.from_numpy(x[TILE:]).abs().max(), 1e-12) \
        / torch.full((), 127.0)
    assert scales[1] == want
    _, js = j_quantize_tiles(jnp.pad(jnp.asarray(x), (0, TILE - 10)),
                             interpret=True)
    assert abs(int(scales.numpy().view(np.int32)[1])
               - int(np.asarray(js).view(np.int32)[1])) <= 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [None, 1000, 2 * TILE + 3, 3 * TILE])
def test_dequantize_flat_bit_exact(dtype, n):
    """``n=`` trims; an ``n`` past the codes reads the zero padding up to
    the end of the last tile, as the reference's padded call does."""
    N = 2 * TILE + 3
    codes, scales = quantize_flat(torch.from_numpy(_delta(N, seed=6)))
    got = dequantize_flat(codes, scales, n=n, dtype=DTYPES[dtype][0])
    want = jops.dequantize_flat(jnp.asarray(codes.numpy()),
                                jnp.asarray(scales.numpy()), n=n,
                                dtype=DTYPES[dtype][1], interpret=True)
    assert got.dtype == DTYPES[dtype][0]
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_to_np(got), _to_np(want))


def test_quantize_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        quantize_flat(torch.ones((2, 3)))
    with pytest.raises(ValueError):
        quantize_flat(torch.ones((0,)))
    q = torch.zeros((TILE + 1,), dtype=torch.int8)
    with pytest.raises(ValueError):                 # one scale short
        dequantize_flat(q, torch.ones((1,)))
    with pytest.raises(ValueError):                 # codes not int8
        dequantize_flat(q.to(torch.int32), torch.ones((2,)))
    with pytest.raises(ValueError, match="unsupported device"):
        quantize_flat(torch.ones((8,), device="meta"))


# -------------------------------------------------- push/pull on real trees


def _cnn_trees():
    """The paper CNN's tree from the reference's init (7 fp32 leaves,
    136,672 parameters) and a second tree beside it."""
    theta = jax.tree.map(np.asarray, jax_cnn_task().init_params(0))
    rng = np.random.default_rng(8)
    base = jax.tree.map(
        lambda a: (a * np.float32(0.95) + rng.standard_normal(a.shape)
                   .astype(np.float32) * np.float32(0.01)), theta)
    return theta, base


def test_delta_push_pull_on_cnn_tree_matches_reference():
    """Push: codes and scales of every leaf equal ``ref.quantize_ref`` of
    its fp32 delta bit for bit, and within a step / an ulp of the
    reference's push. Pull of the port's codes equals the reference's pull
    of the same codes bit for bit, and lands within half a step of θ."""
    theta, base = _cnn_trees()
    t_theta, t_base = params_from_numpy(theta, "cpu"), \
        params_from_numpy(base, "cpu")
    codes, scales = quantized_delta_push(t_theta, t_base)
    jcodes, jscales = jops.quantized_delta_push(theta, base, interpret=True)
    assert sum(c.numel() for c in codes.values()) == 136672
    back = quantized_delta_pull(codes, scales, t_base)
    jback = jops.quantized_delta_pull(
        {k: jnp.asarray(v.numpy()) for k, v in codes.items()},
        {k: jnp.asarray(v.numpy()) for k, v in scales.items()}, base,
        interpret=True)
    for k in theta:
        d = (theta[k].astype(np.float32) - base[k].astype(np.float32)).ravel()
        pad = (-d.shape[0]) % TILE
        want_q, want_s = jref.quantize_ref(jnp.pad(jnp.asarray(d), (0, pad)))
        assert codes[k].shape == (d.shape[0],) and codes[k].dtype == torch.int8
        np.testing.assert_array_equal(codes[k].numpy(),
                                      np.asarray(want_q)[:d.shape[0]])
        np.testing.assert_array_equal(scales[k].numpy(), np.asarray(want_s))
        assert np.abs(codes[k].numpy().astype(np.int32)
                      - np.asarray(jcodes[k]).astype(np.int32)).max() <= 1
        assert np.abs(scales[k].numpy().view(np.int32).astype(np.int64)
                      - np.asarray(jscales[k]).view(np.int32)
                      .astype(np.int64)).max() <= 1
        assert back[k].dtype == t_theta[k].dtype
        assert tuple(back[k].shape) == theta[k].shape
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
        err = np.abs(back[k].numpy() - theta[k]).max()
        assert err <= float(scales[k].max()) * 0.5 * 1.001


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_delta_pull_of_a_mixed_tree_matches_reference(dtype):
    """A tree with a ragged long leaf, a small leaf and a 0-dim leaf: pull
    equals the reference's pull of the same codes bit for bit, in the
    leaves' own dtype."""
    rng = np.random.default_rng(9)
    raw = {"w": rng.standard_normal(TILE + 129).astype(np.float32),
           "b": np.linspace(-2, 2, 257).astype(np.float32),
           "mu": np.asarray(3.0, np.float32)}
    t_theta = {k: _pair(v, dtype)[0] for k, v in raw.items()}
    j_theta = {k: _pair(v, dtype)[1] for k, v in raw.items()}
    t_base = {k: (v.to(torch.float32) * 0.8 + 0.05).to(v.dtype)
              for k, v in t_theta.items()}
    j_base = {k: _pair(params_to_numpy(v), dtype)[1]
              for k, v in t_base.items()}
    codes, scales = quantized_delta_push(t_theta, t_base)
    back = quantized_delta_pull(codes, scales, t_base)
    jback = jops.quantized_delta_pull(
        {k: jnp.asarray(v.numpy()) for k, v in codes.items()},
        {k: jnp.asarray(v.numpy()) for k, v in scales.items()}, j_base,
        interpret=True)
    assert set(back) == set(raw) and back["mu"].shape == ()
    for k in raw:
        assert back[k].dtype == t_theta[k].dtype
        np.testing.assert_array_equal(_to_np(back[k]), _to_np(jback[k]))
        d = (t_theta[k].to(torch.float32) - t_base[k].to(torch.float32))
        want_q, want_s = ref.quantize_ref(tquant._pad(d.reshape(-1)))
        assert torch.equal(codes[k], want_q[:d.numel()])
        assert torch.equal(scales[k], want_s)


# ----------------------------------------------------------------- registry


def test_registry_names_the_three_reference_kernels_and_cpu_launches_none():
    repo = os.path.join(os.path.dirname(__file__), "..")
    want = {"aggregate.agg": ("aggregate.cu", "src/repro/kernels/aggregate.py:41"),
            "quantize.quant": ("quantize.cu", "src/repro/kernels/quantize.py:45"),
            "quantize.dequant": ("quantize.cu",
                                 "src/repro/kernels/quantize.py:66")}
    for name, (src, replaces) in want.items():
        meta = KERNELS[name]
        assert meta["route"] == "cuda" and meta["replaces"] == replaces
        assert meta["source"].endswith("kernels/csrc/" + src)
        assert os.path.isfile(os.path.join(repo, meta["source"]))
        path, line = replaces.split(":")
        with open(os.path.join(repo, path)) as fh:
            assert "pl.pallas_call(" in fh.readlines()[int(line) - 1]
    before = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    x = torch.ones((3, 100))
    aggregate_flat(x, [1.0, 1.0, 1.0])
    codes, scales = quantize_flat(x[0])
    dequantize_flat(codes, scales)
    assert before == {n: k["wrapper"].launches for n, k in KERNELS.items()}
    assert KERNELS["aggregate.agg"]["wrapper"] is tagg.aggregate_tiles
    assert KERNELS["quantize.quant"]["wrapper"] is tquant.quantize_tiles
    assert KERNELS["quantize.dequant"]["wrapper"] is tquant.dequantize_tiles


@pytest.mark.parametrize("source", ["aggregate", "quantize"])
def test_cuda_sources_keep_their_exactness_contract(source):
    """What the CPU can check of the CUDA sources: IEEE division, fused
    multiply-add in row order or one rounded product, half-to-even
    rounding, bf16 stored by round-to-nearest-even, a plain C interface
    that reports the launch's error, and no fast math."""
    from repro_torch.kernels import build
    src = open(os.path.join(build.CSRC, f"{source}.cu")).read()
    for header in ("chunk.cuh", "common.cuh"):
        assert f'#include "{header}"' in src, header
        src += open(os.path.join(build.CSRC, header)).read()
    needles = ['extern "C"', "cudaGetLastError", "__float2bfloat16_rn",
               f"int {source}_launch("]
    if source == "aggregate":
        needles += ["__fdiv_rn", "__fmaf_rn", "__fadd_rn"]
    else:
        needles += ["__fdiv_rn(max_nan(absmax, 1e-12f), 127.0f)", "rintf",
                    "__fmul_rn", "int dequantize_launch("]
    for needle in needles:
        assert needle in src, needle
    assert "roundf" not in src.replace("never `roundf`", "")
    assert "-use_fast_math" not in " ".join(build.NVCC_FLAGS)
    assert build.library_path(source).name.startswith(f"lib{source}_")
