"""The PyTorch package's aggregation wrappers (on CPU tensors: the plain
versions that the CUDA kernels are held against on the card) against the
reference package's Pallas kernels run in interpret mode and its fused jnp
paths.

Tolerances: the mean ``rtol = atol = 1e-6`` (summation order differs
between XLA and PyTorch). Quantisation is elementwise after the absmax, so
the *reference's* mean fed to the port's quantiser must give
``ref.quantize_ref``'s codes bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.engine.flat import FlatModel, FlatSpec
from repro_torch.kernels import KERNELS, fused, ref
from repro_torch.kernels.ops import aggregate_flatmodel
from repro_torch.utils.pytree import tree_weighted_mean
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = [(1, 5000), (3, 16384), (3, 20000), (16, 40001)]   # ragged N too


def _inputs(P, N, seed, n_int=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, N)).astype(np.float32)
    w = (rng.random(P) + 0.5).astype(np.float32)
    mask = np.zeros(N, np.bool_)
    if n_int:
        x[:, :n_int] = rng.integers(0, 50, (P, n_int)).astype(np.float32)
        mask[:n_int] = True
    return x, w, mask


@pytest.mark.parametrize("P,N", SHAPES)
@pytest.mark.parametrize("n_int", [0, 37])
def test_onepass_matches_pallas_interpret_and_jnp(P, N, n_int):
    x, w, mask = _inputs(P, N, seed=P * 1000 + N, n_int=n_int)
    tmask = torch.from_numpy(mask) if n_int else None
    got = fused.aggregate_flat_onepass(
        torch.from_numpy(x), torch.from_numpy(w), tmask).numpy()
    pallas = np.asarray(jfused.aggregate_flat_onepass(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask, jnp.float32),
        interpret=True))
    fusedjnp = np.asarray(jops._jnp_onepass(N, bool(n_int))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask)))
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, fusedjnp, **TOL)
    if n_int:                     # integer lanes hold whole numbers
        assert np.all(got[:n_int] == np.rint(got[:n_int]))


@pytest.mark.parametrize("P,N", SHAPES)
def test_quantize_matches_pallas_interpret_and_jnp(P, N):
    x, w, mask = _inputs(P, N, seed=7 * P + N)
    mean, codes, scales = fused.aggregate_quantize_flat(
        torch.from_numpy(x), torch.from_numpy(w))
    pm, pq, ps = jfused.aggregate_quantize_flat(
        jnp.asarray(x), jnp.asarray(w), None, interpret=True)
    jm, jq, js = jops._jnp_onepass_quant(N, False)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask))
    n_sub = -(-N // fused.SUBTILE)
    assert codes.dtype == torch.int8 and codes.shape == (N,)
    assert scales.shape == (n_sub,) == tuple(np.asarray(ps).shape)
    assert torch.equal(mean, fused.aggregate_flat_onepass(
        torch.from_numpy(x), torch.from_numpy(w)))
    for m, q, s in ((pm, pq, ps), (jm, jq, js)):
        np.testing.assert_allclose(mean.numpy(), np.asarray(m), **TOL)
        # scales: one ulp apart at most (the reference's jitted paths
        # multiply by a reciprocal where the oracle divides)
        np.testing.assert_allclose(scales.numpy(), np.asarray(s), rtol=3e-7)
        # a mean that differs in the last bits may move a code by one step
        dq = np.abs(codes.numpy().astype(np.int32)
                    - np.asarray(q).astype(np.int32))
        assert dq.max() <= 1 and (dq != 0).mean() < 1e-3


@pytest.mark.parametrize("N", [16384, 20000, 3 * 16384 + 5])
def test_reference_mean_through_port_quantiser_is_bit_identical(N):
    """Feed the reference's own mean to the port's quantiser: codes and
    scales equal ``ref.quantize_ref`` (the reference's oracle) bit for bit."""
    x, w, mask = _inputs(4, N, seed=N)
    jmean = jops._jnp_onepass(N, False)(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(mask))
    pad = (-N) % fused.SUBTILE
    want_q, want_s = jref.quantize_ref(jnp.pad(jmean, (0, pad)))
    got_q, got_s = fused._plain_quantize(torch.from_numpy(np.array(jmean)))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q)[:N])
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # and the port's oracle equals the reference's on an aligned vector
    v = np.array(jnp.pad(jmean, (0, pad)))
    tq, ts = ref.quantize_ref(torch.from_numpy(v))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(
        ref.dequantize_ref(tq, ts).numpy(),
        np.asarray(jref.dequantize_ref(want_q, want_s)))


# A NaN, a +Inf and a -Inf mean planted at one lane of subtiles 0, 1 and 2
# (as many as N has): the reference (jnp.max, then an int8 cast of a NaN
# quotient) gives a NaN subtile scale NaN and every code 0, an Inf subtile
# scale Inf and every code 0 (finite / Inf is 0, Inf / Inf is NaN).
NONFINITE = (np.nan, np.inf, -np.inf)


def _plant_nonfinite(x):
    """Row 0 of ``x`` gets NONFINITE's values at lane 1000 of each subtile
    (the last lane where a subtile is shorter); returns the subtiles."""
    N = x.shape[1]
    planted = []
    for s, v in enumerate(NONFINITE):
        if s * fused.SUBTILE < N:
            x[0, min(s * fused.SUBTILE + 1000, N - 1)] = v
            planted.append(s)
    return planted


def _quantised(masked, x, w, seed):
    """(mean, codes, scales) of the port's and of the reference's Pallas
    kernel (interpret mode) on the stack ``x``, sealed first if
    ``masked``."""
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if not masked:
        return (fused.aggregate_quantize_flat(tx, tw),
                jfused.aggregate_quantize_flat(jnp.asarray(x), jnp.asarray(w),
                                               None, interpret=True))
    P = x.shape[0]
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**32, (P, 2), dtype=np.uint64).astype(np.uint32)
    signs = np.where(rng.random((P, 2)) < 0.5, -1, 1).astype(np.int32)
    ts, tg = (torch.from_numpy(a.astype(np.int64)) for a in (seeds, signs))
    ty = torch.stack([fused.apply_mask_flat(tx[p], ts[p], tg[p])
                      for p in range(P)])
    return (fused.unmask_aggregate_quantize_flat(ty, tw, seeds=ts, signs=tg),
            jfused.unmask_aggregate_quantize_flat(
                jnp.asarray(ty.numpy()), jnp.asarray(w), None, seeds=seeds,
                signs=signs, interpret=True))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N,nonfinite", [(16385, False), (16385, True),
                                         (3 * 16384 + 5, True)])
def test_quantised_kernels_at_a_subtile_edge_and_nonfinite_lanes(
        N, nonfinite, masked):
    """B2 and B5's CPU versions against the reference's Pallas kernels at
    one lane past a subtile, and with NaN and +-Inf means: the planted
    subtiles' scales NaN or Inf and their codes 0 in both packages; the
    other subtiles as in ``test_quantize_matches_pallas_interpret_and_jnp``
    (ROADMAP C1); codes and scales bit for bit the port's oracle on its own
    mean."""
    x, w, _ = _inputs(3, N, seed=N + nonfinite)
    planted = _plant_nonfinite(x) if nonfinite else []
    (mean, codes, scales), (jm, jq, js) = _quantised(masked, x, w, seed=N)
    jm, jq, js = np.asarray(jm), np.asarray(jq), np.asarray(js)
    np.testing.assert_allclose(mean.numpy(), jm, **TOL)     # NaN, Inf equal
    oq, os_ = fused._plain_quantize(mean)
    assert torch.equal(codes, oq)
    np.testing.assert_array_equal(scales.numpy(), os_.numpy())
    S = fused.SUBTILE
    for s in range(-(-N // S)):
        got_q, want_q = codes.numpy()[s * S:(s + 1) * S], jq[s * S:(s + 1) * S]
        if s in planted:
            want = np.nan if s == 0 else np.inf
            np.testing.assert_array_equal(scales.numpy()[s], want)
            np.testing.assert_array_equal(js[s], want)
            assert not got_q.any() and not want_q.any()
        else:
            np.testing.assert_allclose(scales.numpy()[s], js[s], rtol=3e-7)
            assert np.abs(got_q.astype(np.int32) - want_q).max() <= 1


def test_pad_lanes_are_exact_zeros():
    """A ragged last subtile quantises as if padded with zeros: its scale
    comes from the real lanes only."""
    x, w, _ = _inputs(2, 16384 + 10, seed=3)
    x[:, 16384:] *= 1e-3
    _, codes, scales = fused.aggregate_quantize_flat(
        torch.from_numpy(x), torch.from_numpy(w))
    mean = fused.aggregate_flat_onepass(torch.from_numpy(x),
                                        torch.from_numpy(w))
    tail = mean[16384:]
    want = torch.clamp_min(tail.abs().max(), 1e-12) / torch.full((), 127.0)
    assert scales[1] == want
    assert int(codes[16384:].abs().max()) == 127


def test_aggregate_ref_matches_reference_oracle():
    x, w, _ = _inputs(5, 4096, seed=1)
    got = ref.aggregate_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jref.aggregate_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, **TOL)
    assert ref.TILE == jref.TILE == fused.SUBTILE == jfused.SUBTILE


def _int_models():
    mk = lambda w, s: {"w": torch.full((300,), w),           # noqa: E731
                       "step": torch.tensor(s, dtype=torch.int32)}
    return [mk(1.0, [7, 100]), mk(0.0, [8, 101])]


@pytest.mark.parametrize("quantize", [False, True])
def test_aggregate_flatmodel_integer_leaves(quantize):
    out = aggregate_flatmodel(_int_models(), [1.0, 1.0], quantize=quantize,
                              device="cpu")
    got = (out[0] if quantize else out).tree
    assert got["step"].dtype == torch.int32
    assert got["step"].tolist() == [8, 100]       # round-half-even, not floor
    np.testing.assert_allclose(got["w"].numpy(), 0.5)
    jmodels = [{"w": jnp.asarray(m["w"].numpy()),
                "step": jnp.asarray(m["step"].numpy())} for m in _int_models()]
    jgot = jops.aggregate_flatmodel(jmodels, [1.0, 1.0], use_kernel=True,
                                    interpret=True).tree
    assert jgot["step"].tolist() == got["step"].tolist()


def test_aggregate_flatmodel_contract_matches_reference():
    """FlatModels and trees mixed, explicit spec, quantize tuple."""
    rng = np.random.default_rng(5)
    trees = [{"a": rng.standard_normal((33, 7)).astype(np.float32),
              "b": rng.standard_normal((20000,)).astype(np.float32)}
             for _ in range(3)]
    w = [0.5, 1.0, 2.0]
    tt = [{k: torch.from_numpy(v) for k, v in t.items()} for t in trees]
    spec = FlatSpec.from_tree(tt[0])
    mixed = [FlatModel.pack(tt[0], spec), tt[1], FlatModel.pack(tt[2], spec)]
    fm, codes, scales = aggregate_flatmodel(mixed, w, spec=spec,
                                            quantize=True, device="cpu")
    plain = aggregate_flatmodel(mixed, w, device="cpu")
    assert isinstance(fm, FlatModel) and fm.spec == spec
    assert torch.equal(fm.buffer, plain.buffer)
    assert codes.shape == (spec.n,) and codes.dtype == torch.int8
    assert scales.shape == (-(-spec.n // fused.SUBTILE),)
    jt = [{k: jnp.asarray(v) for k, v in t.items()} for t in trees]
    jfm, jq, js = jops.aggregate_flatmodel(jt, w, quantize=True,
                                           use_kernel=True, interpret=True)
    np.testing.assert_allclose(fm.buffer.numpy(), np.asarray(jfm.buffer), **TOL)
    want = tree_weighted_mean(tt, w)
    for k in want:
        np.testing.assert_allclose(fm.tree[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5)
    # default weights are uniform
    uni = aggregate_flatmodel(tt, device="cpu")
    np.testing.assert_allclose(
        uni.buffer.numpy(),
        aggregate_flatmodel(tt, [1, 1, 1], device="cpu").buffer.numpy())


def test_zero_weight_raises_on_every_path():
    from repro_torch.models.tasks import cnn_task
    task = cnn_task(device="cpu", cnn_image=(8, 8, 3))
    params = task.init_params(0)
    models = [params, params]
    x = torch.ones((2, 8))
    zero = torch.zeros((2,))
    with pytest.raises(ValueError):
        tree_weighted_mean(models, [0.0, 0.0])
    with pytest.raises(ValueError):
        aggregate_flatmodel(models, [0.0, 0.0], device="cpu")
    with pytest.raises(ValueError):
        aggregate_flatmodel(models, [0.0, 0.0], quantize=True, device="cpu")
    with pytest.raises(ValueError):
        task.aggregate(models, [0.0, -0.0])
    with pytest.raises(ValueError):
        task.aggregate_sequential(models, [0.0, 0.0])
    with pytest.raises(ValueError):
        fused.aggregate_flat_onepass(x, zero)
    with pytest.raises(ValueError):
        fused.aggregate_quantize_flat(x, zero)


@pytest.mark.parametrize("wrapper", [fused.aggregate_flat_onepass,
                                     fused.aggregate_quantize_flat])
def test_wrappers_refuse_what_the_kernels_do_not_take(wrapper):
    x, w = torch.ones((3, 64)), torch.ones((3,))
    with pytest.raises(TypeError):
        wrapper(x.double(), w)
    with pytest.raises(TypeError):
        wrapper(x, w, torch.zeros(64))                 # float mask
    with pytest.raises(ValueError):
        wrapper(x, torch.ones((4,)))
    with pytest.raises(ValueError):
        wrapper(x.t().contiguous().t(), w)             # not contiguous
    with pytest.raises(ValueError):
        wrapper(x, w, torch.zeros(63, dtype=torch.bool))
    with pytest.raises(ValueError):
        wrapper(torch.ones((64,)), w)
    with pytest.raises(ValueError):
        aggregate_flatmodel([{"w": torch.ones(4, device="meta")}], [1.0],
                            device="cpu")              # model elsewhere


def test_cpu_calls_launch_no_kernel_and_registry_is_complete():
    """On CPU tensors the wrappers take the plain version: the launch
    counts stay where they were. Every kernel is registered with its
    source and the reference kernel it replaces (a ``pl.pallas_call``, or
    for the seal the reference's jitted ``apply_mask_flat``)."""
    import os
    before = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    x, w, _ = _inputs(3, 1000, seed=0)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    terms = torch.ones((3, 2), dtype=torch.int64)
    fused.aggregate_flat_onepass(tx, tw)
    fused.aggregate_quantize_flat(tx, tw)
    fused.apply_mask_flat(tx[0], terms[0], terms[0])
    fused.unmask_aggregate_flat(tx, tw, seeds=terms, signs=terms)
    fused.unmask_aggregate_quantize_flat(tx, tw, seeds=terms, signs=terms)
    q = torch.ones((1, 2, 8, 32))
    KERNELS["flash_attention"]["wrapper"](q, q, q)
    KERNELS["aggregate.agg"]["wrapper"](tx, tw)
    codes, scales = KERNELS["quantize.quant"]["wrapper"](tx[0])
    KERNELS["quantize.dequant"]["wrapper"](codes, scales)
    assert before == {n: k["wrapper"].launches for n, k in KERNELS.items()}
    assert set(KERNELS) == {"fused.agg", "fused.agg_quant", "fused.mask",
                            "fused.unmask_agg", "fused.unmask_agg_quant",
                            "aggregate.agg", "quantize.quant",
                            "quantize.dequant", "flash_attention"}
    repo = os.path.join(os.path.dirname(__file__), "..")
    for name, meta in KERNELS.items():
        assert meta["route"] == "cuda"
        assert os.path.isfile(os.path.join(repo, meta["source"]))
        path, line = meta["replaces"].split(":")
        with open(os.path.join(repo, path)) as fh:
            text = fh.readlines()[int(line) - 1]
        want = ("def apply_mask_flat(" if name == "fused.mask"
                else "pl.pallas_call(")
        assert want in text, (name, text)


def test_cuda_source_keeps_its_exactness_contract():
    """What the CPU can check of the CUDA source: IEEE division and
    half-to-even rounding intrinsics, one definition of the mean's per-row
    step and of its finish (shared by B1, B2, B4 and B5 through
    ``weighted_mean_lane`` and by the kernel for few lanes), the quantised
    forms' last-block phase and the absmax that keeps a NaN, no
    fast-math."""
    import os

    from repro_torch.kernels import build
    src = open(os.path.join(build.CSRC, "fused_agg.cu")).read()
    common = open(os.path.join(build.CSRC, "common.cuh")).read()
    for needle in ("__fdiv_rn", "rintf", "__fmaf_rn", "weighted_mean_lane",
                   'extern "C"', "cudaGetLastError",
                   # the masked kernels: uint32 ring arithmetic, the PRG's
                   # constants, B4's and B5's means reached through
                   # SealedRows, the kernel for few lanes, and the staged
                   # terms' shared-memory opt-in
                   "uint32_t", "0x7FEB352Du", "0x846CA68Bu", "SealedRows",
                   "__uint_as_float", "fused_unmask_rows_kernel",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize",
                  "attr.sharedSizeBytes + smem",
                   "fused_mask_launch", "fused_unmask_agg_launch",
                   "fused_unmask_agg_quant_launch",
                   # the quantised forms' second phase: the means are made
                   # visible before the arrival is counted, read back
                   # coherently, and the count and absmax are left at 0;
                   # blocks wait for their subtile only in a cooperative
                   # launch of a grid that fits on the card
                   '#include "common.cuh"', "__threadfence();",
                   "atomicMax(q.absmax + t.s, __float_as_uint(amax))",
                   "atomicAdd(q.arrived + t.s, 1u)", "q.arrived[t.s] = 0u;",
                   "atomicExch(q.absmax + t.s, 0u)", "__ldcg(", "max_nan(",
                   "cudaLaunchAttributeCooperative",
                   "cudaOccupancyMaxActiveBlocksPerMultiprocessor"):
        assert needle in src, needle
    # the absmax keeps a NaN and a NaN quotient is code 0, as the
    # reference's jnp.max and int8 cast give them
    for needle in ("max.NaN.f32", "__fdiv_rn(max_nan(absmax, 1e-12f), 127.0f)",
                   "if (isnan(q)) return 0;"):
        assert needle in common, needle
    assert "fmaxf(amax" not in src + common
    # one definition of the per-row step and of the finish, so every
    # aggregation kernel's mean is the same bit for bit
    assert src.count("float mean_step(") == 1
    assert src.count("float finish_lane(") == 1
    assert src.count("__fmaf_rn(") == 1          # inside mean_step only
    assert src.count("float weighted_mean_lane(") == 1
    assert "roundf" not in src.replace("never `roundf`", "")
    assert "-use_fast_math" not in " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path("fused_agg").name.startswith("libfused_agg_")


def _fused_c_params(src, name):
    """Kinds of the parameters of ``int name(...)`` in ``fused_agg.cu``'s
    ``extern "C"`` block: pointer, int or long long."""
    head = src[src.index(f"int {name}("):]
    kinds = []
    for param in head[head.index("(") + 1:head.index(")")].split(","):
        kinds.append("pointer" if "*" in param else
                     "long long" if "long long" in param else
                     param.split()[0])
    return kinds


def test_fused_ctypes_binding_matches_the_c_entry_points(monkeypatch):
    """The wrappers' ctypes argument types follow the C parameters of the
    five launch entry points and the launch plan's one for one (a pointer
    or a 64-bit count in an int's place is cut or misread silently)."""
    import ctypes
    import os
    import types

    from repro_torch.kernels import build
    names = ("fused_agg_launch", "fused_agg_quant_launch", "fused_mask_launch",
             "fused_unmask_agg_launch", "fused_unmask_agg_quant_launch",
             "fused_plan")
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                    for n in names})
    monkeypatch.setattr(build, "load", lambda name: fake)
    monkeypatch.setattr(fused, "_LIB", None)
    fused._lib()
    src = open(os.path.join(build.CSRC, "fused_agg.cu")).read()
    block = src[src.index('extern "C" {'):]
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_longlong: "long long"}
    for name in names:
        fn = getattr(fake, name)
        assert [kinds[t] for t in fn.argtypes] == _fused_c_params(
            block, name), name
        assert fn.restype is ctypes.c_int
        assert _fused_c_params(block, name)[-1] == "pointer"   # stream, out


class _FakeStream:
    """Stands in for a CUDA stream: records the streams it waited for."""

    def __init__(self, name):
        self.name, self.waited = name, []

    def wait_stream(self, other):
        self.waited.append(other.name)


def test_quant_workspace_keeps_what_a_graph_holds_and_orders_streams(
        monkeypatch):
    """The quantised kernels' workspace (its logic, on CPU tensors): made
    at zero, grown to at least twice its size with the smaller tensor kept
    (a graph captured before holds its address), never grown inside a
    graph capture, and a call on another stream than the last waits for
    that stream; calls inside a capture neither wait nor move it."""
    state = {"stream": _FakeStream("a"), "capturing": False}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: state["stream"])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    monkeypatch.setattr(fused, "_WORKSPACE", {})
    dev = torch.device("cpu")
    S = fused.SUBTILE

    first = fused._workspace(dev, 3 * S)
    ws = fused._WORKSPACE[dev]
    assert ws.words.shape == (3, 3) and not ws.words.any()
    assert first == [row.data_ptr() for row in ws.words]
    assert fused._workspace(dev, 2 * S + 1) == first        # no growth
    old = ws.words
    grown = fused._workspace(dev, 4 * S)
    assert ws.words.shape == (3, 6) and not ws.words.any()
    assert ws.kept == [old] and grown != first
    assert fused._workspace(dev, 7 * S) != grown and ws.words.shape[1] == 12
    assert len(ws.kept) == 2

    a, b, c = state["stream"], _FakeStream("b"), _FakeStream("c")
    state["stream"] = b
    fused._workspace(dev, S)
    assert b.waited == ["a"] and ws.stream is b
    fused._workspace(dev, S)
    assert b.waited == ["a"]                                # same stream
    state.update(stream=c, capturing=True)
    fused._workspace(dev, S)
    assert c.waited == [] and ws.stream is b
    with pytest.raises(RuntimeError, match="before capturing"):
        fused._workspace(dev, 13 * S)
    assert ws.words.shape[1] == 12 and len(ws.kept) == 2
    state.update(stream=a, capturing=False)
    fused._workspace(dev, S)
    assert a.waited == ["b"] and ws.stream is a
