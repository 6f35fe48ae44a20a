"""Secure aggregation in the PyTorch package against the reference.

Four layers, as in the reference's own tests:

* primitives — the port's PRG (plain PyTorch, int64 holding uint32) equals
  ``repro.secureagg.prg.prg_word`` bit for bit at the extremes of the seed
  and counter range; Shamir shares and the masker's seed matrices are equal
  across the two packages;
* sealing — the port's ``apply_mask_flat`` (on CPU tensors: the plain
  version that the CUDA kernel is held against on the card) equals the
  reference's jitted one bit for bit, on inputs full of NaN payloads,
  signalling NaNs and subnormals; a buffer sealed by either package
  unseals in the other to the original bits;
* aggregation — the fused unmask→aggregate(→quantize) against the
  reference's Pallas kernels in interpret mode (mean ``rtol = atol =
  1e-6``; codes and scales as ``tests/test_torch_kernels.py`` states them),
  and bit-identical to the port's plain aggregation of the unsealed rows;
* protocol — masked sessions of the port follow the reference's trajectory
  exactly, wedges included: the port is held to parity with the reference
  here, not to liveness.

Every case is deterministic: inputs come from numpy with fixed seeds.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.fault as jfault
import repro_torch.sim.fault as tfault
from repro.config import ModestConfig as JModestConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core.tasks import AbstractTask as JAbstractTask
from repro.data import make_classification_task as j_make_classification_task
from repro.engine.flat import FlatModel as JFlatModel
from repro.engine.flat import FlatSpec as JFlatSpec
from repro.kernels import fused as jfused
from repro.models.tasks import cnn_task as jax_cnn_task
from repro.secureagg import PairwiseMasker as JPairwiseMasker
from repro.secureagg import prg as jprg
from repro.secureagg import shamir as jshamir
from repro.sim.runner import ModestSession as JModestSession
from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.core import messages as M
from repro_torch.core.node import ModestNode
from repro_torch.core.tasks import AbstractTask
from repro_torch.data import make_classification_task
from repro_torch.engine.flat import FlatModel, FlatSpec, params_from_numpy
from repro_torch.kernels import KERNELS, fused
from repro_torch.kernels.ops import (aggregate_flatmodel,
                                     masked_aggregate_flatmodel)
from repro_torch.models.tasks import cnn_task
from repro_torch.secureagg import PairwiseMasker, SealedModel, threshold
from repro_torch.secureagg import prg, shamir
from repro_torch.sim.clock import Simulator
from repro_torch.sim.network import Network
from repro_torch.sim.runner import ModestSession
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
EDGE = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
# fp32 bit patterns a sealed buffer may hold: quiet NaN with payload,
# signalling NaN, smallest subnormals, -0, infinities
ODD_BITS = [0x7FC00001, 0x7F800001, 0xFFBFFFFF, 0x00000001, 0x807FFFFF,
            0x80000000, 0x7F800000, 0xFF800000]


def _bits_buffer(n, seed):
    """(n,) uint32 of random bits with the odd patterns sprinkled in."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    bits[rng.choice(n, len(ODD_BITS), replace=False)] = ODD_BITS
    return bits


def _terms(R, seed):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**32, R, dtype=np.uint64).astype(np.uint32)
    seeds[:min(R, 2)] = [0xFFFFFFFF, 0x7FFFFFFF][:min(R, 2)]
    signs = np.where(rng.random(R) < 0.5, -1, 1).astype(np.int32)
    signs[0] = -1
    return seeds, signs


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _u32(t):
    return np.asarray(t).view(np.uint32)


# --------------------------------------------------------------- primitives


def test_prg_equals_reference_bit_for_bit():
    """Every (seed, counter) pair of a grid that holds the extremes of the
    uint32 range: the int64 arithmetic keeps the low 32 bits exact."""
    rng = np.random.default_rng(0)
    seeds = EDGE + [int(v) for v in rng.integers(0, 2**32, 24,
                                                 dtype=np.uint64)]
    lanes = EDGE + [2**31 + 1] + [int(v) for v in rng.integers(
        0, 2**32, 24, dtype=np.uint64)]
    want = np.array([[jprg.prg_word(s, c) for c in lanes] for s in seeds],
                    np.int64)
    got = fused._plain_prg(_t(seeds)[:, None], _t(lanes)[None, :])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(prg.prg_word(s, c) == want[i, j]
               for i, s in enumerate(seeds) for j, c in enumerate(lanes))
    dev = jfused._prg_u32(jnp.asarray(np.array(seeds, np.uint32))[:, None],
                          jnp.asarray(np.array(lanes, np.uint32))[None, :])
    np.testing.assert_array_equal(np.asarray(dev).astype(np.int64), want)


def _kernel_form_prg(seeds, lanes):
    """The PRG as ``kernels/csrc/fused_agg.cu`` runs it, on int64 tensors
    that hold uint32 values: each term staged with its key xs16(seed *
    MIX1), each lane with its key xs16(ctr), a word starting from the xor
    of the two keys (a logical shift distributes over xor)."""
    mix1, mix2 = fused._PRG_MIX1, fused._PRG_MIX2

    def xs(x, k):
        return x ^ (x >> k)

    x = fused._mul32(xs(lanes, 16) ^ xs(fused._mul32(seeds, mix1), 16), mix1)
    x = fused._mul32(xs(x, 15), mix2)
    x = (xs(x, 16) + seeds) & fused.MASK32
    x = fused._mul32(xs(x, 16), mix1)
    x = fused._mul32(xs(x, 15), mix2)
    return xs(x, 16)


_EDGE_U32 = [0, 1, 2**15, 2**16 - 1, 2**16, 2**31, 2**32 - 1]


def test_kernel_form_of_the_prg_equals_both_packages_bit_for_bit():
    """The staged form of the PRG that the CUDA kernels run, against
    ``repro_torch.secureagg.prg.prg_word`` and the reference's
    ``prg_word``, at seeds and counters on the edges of the uint32 range
    and of the shifts' halves, and at seeded random ones."""
    rng = np.random.default_rng(1)
    seeds = _EDGE_U32 + [int(v) for v in rng.integers(0, 2**32, 40,
                                                      dtype=np.uint64)]
    lanes = _EDGE_U32 + [int(v) for v in rng.integers(0, 2**32, 40,
                                                      dtype=np.uint64)]
    got = _kernel_form_prg(_t(seeds)[:, None], _t(lanes)[None, :])
    assert got.dtype == torch.int64
    want = [[jprg.prg_word(s, c) for c in lanes] for s in seeds]
    assert got.tolist() == want
    assert got.tolist() == [[prg.prg_word(s, c) for c in lanes]
                            for s in seeds]


def _kernel_form_mask_sum(seeds, signs, lanes):
    """``mask_sum`` as the CUDA kernels run it over R terms: a -1 sign as
    0xFFFFFFFF, four terms at a time into four sums, the rest into the
    first, and the sums added pairwise at the end (mod 2^32)."""
    seeds, signs = seeds & fused.MASK32, signs & fused.MASK32
    m = [torch.zeros_like(lanes) for _ in range(4)]

    def add(i, j):
        word = _kernel_form_prg(seeds[j], lanes)
        m[i] = (m[i] + fused._mul32(word, signs[j])) & fused.MASK32

    R, j = seeds.shape[0], 0
    while j + 3 < R:
        for i in range(4):
            add(i, j + i)
        j += 4
    for j in range(j, R):
        add(0, j)
    return ((m[0] + m[1]) + (m[2] + m[3])) & fused.MASK32


@pytest.mark.parametrize("R", [1, 3, 4, 5, 17])
def test_kernel_form_of_the_mask_sum_equals_both_packages_bit_for_bit(R):
    """The kernels' sum of R signed words (across the four-term unroll and
    its tail) against the port's plain mask words and the reference's
    ``prg_word`` summed with its signs, mod 2^32."""
    seeds, signs = _terms(R, seed=40 + R)
    lanes = _EDGE_U32 + list(range(2, 9))
    got = _kernel_form_mask_sum(_t(seeds), _t(signs), _t(lanes))
    plain = fused._plain_mask_words(_t(seeds)[None], _t(signs)[None],
                                    _t(lanes))[0]
    assert got.tolist() == plain.tolist()
    assert got.tolist() == [sum(int(g) * jprg.prg_word(int(s), c)
                                for s, g in zip(seeds, signs)) % 2**32
                            for c in lanes]


def test_cuda_prg_keeps_the_staged_form():
    """The CUDA source stages each term's key xs16(seed * kPrgMix1) and
    starts a word from the xor of the lane's key and the term's: the form
    ``_kernel_form_prg`` holds against both packages."""
    import os

    from repro_torch.kernels import build
    src = open(os.path.join(build.CSRC, "fused_agg.cu")).read()
    for needle in ("xs<16>(seed * kPrgMix1)", "(lkey ^ t[i].key) * kPrgMix1",
                   "xs<15>(x[i]) * kPrgMix2", "xs<16>(x[i]) + t[i].seed",
                   "xs<16>(x[i]) * kPrgMix1", "x[i] = xs<16>(x[i]);",
                   "return t.sign * x[0];", "m[i] += t[i].sign * x[i];",
                   "return xs<16>(ctr);"):
        assert needle in src, needle


def test_mul32_keeps_the_low_bits_near_the_top_of_the_range():
    a = _t([0xFFFFFFFF, 0xFFFFFFFE, 0x80000001, 12345, 0])
    for b in (0xFFFFFFFF, 0x846CA68B, 0x7FEB352D, 1):
        want = [(int(v) * b) % 2**32 for v in a]
        assert fused._mul32(a, b).tolist() == want
        assert fused._mul32(a, torch.full_like(a, b)).tolist() == want


def test_shamir_dh_and_masker_equal_across_packages():
    for secret, owner, k, n, t in ((prg.round_secret(42, "n3", 9), "n3", 9,
                                    5, 4), (0xFFFFFFFF, "a", 1, 10, 6)):
        shares = shamir.split(secret, owner, k, n, t)
        assert shares == jshamir.split(secret, owner, k, n, t)
        assert shamir.reconstruct(shares[1:], t) == secret
        assert jshamir.reconstruct(shares[1:], t) == secret
    assert [threshold(s) for s in (1, 2, 3, 4, 5, 10)] == [1, 2, 3, 3, 4, 6]
    roster = tuple(str(i) for i in range(10))
    tm, jm = PairwiseMasker(7), JPairwiseMasker(7)
    for sender in ("0", "4", "9"):
        assert tm.secret(sender, 3) == jm.secret(sender, 3)
        assert tm.seeds_row(tm.secret(sender, 3), sender, 3, roster) == \
            jm.seeds_row(jm.secret(sender, 3), sender, 3, roster)
        assert tm.make_shares(sender, 3, roster) == \
            jm.make_shares(sender, 3, roster)
    sealed = [SealedModel("bytes", None, s, 3, roster, 8) for s in roster[:4]]
    jsealed = [dataclasses.replace(s) for s in sealed]
    secrets = {s: tm.secret(s, 3) for s in roster}
    ts, tg = tm.unmask_matrices(sealed, secrets)
    js, jg = jm.unmask_matrices(jsealed, secrets)
    assert ts.dtype == js.dtype and tg.dtype == jg.dtype
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tg, jg)


# ------------------------------------------------------------------ sealing


@pytest.mark.parametrize("N", [136672, 4099])
@pytest.mark.parametrize("R", [1, 10])
def test_apply_mask_equals_reference_and_inverts(N, R):
    bits = _bits_buffer(N, seed=N + R)
    seeds, signs = _terms(R, seed=R)
    buf = torch.from_numpy(bits.copy()).view(torch.float32)
    sealed = fused.apply_mask_flat(buf, _t(seeds), _t(signs))
    want = jfused.apply_mask_flat(jnp.asarray(bits.view(np.float32)), seeds,
                                  signs)
    assert sealed.dtype == torch.float32 and sealed.shape == (N,)
    np.testing.assert_array_equal(_u32(sealed), _u32(want))
    assert (_u32(sealed) != bits).mean() > 0.99
    back = fused.apply_mask_flat(sealed, _t(seeds), -_t(signs))
    np.testing.assert_array_equal(_u32(back), bits)


def _spec_pair():
    """The same small model in both packages: an awkward total and an
    integer leaf."""
    tree = {"w": np.zeros((123, 7), np.float32),
            "b": np.zeros((11,), np.float32),
            "steps": np.zeros((3,), np.int32)}
    return (FlatSpec.from_tree({k: torch.from_numpy(v)
                                for k, v in tree.items()}),
            JFlatSpec.from_tree(tree))


def test_sealed_buffers_cross_between_packages():
    """The port seals exactly as the reference does, and a buffer sealed
    by one unseals in the other to the original bits (odd patterns
    included)."""
    tspec, jspec = _spec_pair()
    assert tspec.n == jspec.n
    bits = _bits_buffer(tspec.n, seed=1)
    roster = ("a", "b", "c", "d")
    tm, jm = PairwiseMasker(3), JPairwiseMasker(3)
    for sender in roster:
        tfm = FlatModel(torch.from_numpy(bits.copy()).view(torch.float32),
                        tspec)
        jfm = JFlatModel(jnp.asarray(bits.view(np.float32)), jspec)
        ts = tm.seal(tfm, sender, 5, roster, tspec.nbytes)
        js = jm.seal(jfm, sender, 5, roster, jspec.nbytes)
        assert ts.kind == js.kind == "flat" and ts.nbytes == js.nbytes
        np.testing.assert_array_equal(_u32(ts.payload.buffer),
                                      _u32(js.payload.buffer))
        sk = tm.secret(sender, 5)
        # reference-sealed -> port unseal, and port-sealed -> reference
        j2t = dataclasses.replace(ts, payload=FlatModel(torch.from_numpy(
            np.array(js.payload.buffer)), tspec))
        t2j = dataclasses.replace(js, payload=JFlatModel(jnp.asarray(
            ts.payload.buffer.numpy()), jspec))
        np.testing.assert_array_equal(
            _u32(tm.unseal_flat(j2t, sk).buffer), bits)
        np.testing.assert_array_equal(
            _u32(jm.unseal_flat(t2j, sk).buffer), bits)
    x = np.float32(3.25)
    ts, js = tm.seal(x, "b", 4, roster, 4), jm.seal(x, "b", 4, roster, 4)
    assert ts.kind == "scalar" and ts.payload == js.payload
    assert tm.unseal_scalar(ts, tm.secret("b", 4)) == x


# ------------------------------------------------------------- aggregation


def _sealed_stack(P, N, n_int, seed):
    """Plain rows x, weights, integer mask, and the rows sealed with
    per-row (P, P) seeds/signs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, N)).astype(np.float32)
    w = (rng.random(P) + 0.5).astype(np.float32)
    mask = np.zeros(N, np.bool_)
    if n_int:
        x[:, N - n_int:] = rng.integers(0, 50, (P, n_int)).astype(np.float32)
        mask[N - n_int:] = True
    seeds = rng.integers(0, 2**32, (P, P), dtype=np.uint64).astype(np.uint32)
    signs = np.where(rng.random((P, P)) < 0.5, -1, 1).astype(np.int32)
    y = np.stack([np.array(jfused.apply_mask_flat(jnp.asarray(x[p]),
                                                  seeds[p], signs[p]))
                  for p in range(P)])
    return x, w, mask, y, seeds, signs


@pytest.mark.parametrize("P,N,n_int", [(3, 5000, 0), (4, 3001, 37),
                                       (2, 16384 + 100, 5)])
def test_unmask_aggregate_matches_pallas_interpret(P, N, n_int):
    x, w, mask, y, seeds, signs = _sealed_stack(P, N, n_int, seed=P * N)
    tm = torch.from_numpy(mask) if n_int else None
    ty, tw = torch.from_numpy(y), torch.from_numpy(w)
    kw = dict(seeds=_t(seeds), signs=_t(signs))
    mean = fused.unmask_aggregate_flat(ty, tw, tm, **kw)
    qmean, codes, scales = fused.unmask_aggregate_quantize_flat(ty, tw, tm,
                                                                **kw)
    jkw = dict(seeds=seeds, signs=signs, interpret=True)
    jmask = jnp.asarray(mask, jnp.float32)
    pm = jfused.unmask_aggregate_flat(jnp.asarray(y), jnp.asarray(w), jmask,
                                      **jkw)
    qm, qq, qs = jfused.unmask_aggregate_quantize_flat(
        jnp.asarray(y), jnp.asarray(w), jmask, **jkw)
    np.testing.assert_allclose(mean.numpy(), np.asarray(pm), **TOL)
    np.testing.assert_allclose(qmean.numpy(), np.asarray(qm), **TOL)
    # scales one ulp apart at most, codes one step (ROADMAP C1: the
    # reference's jitted division by 127 is a reciprocal multiply)
    np.testing.assert_allclose(scales.numpy(), np.asarray(qs), rtol=3e-7)
    dq = np.abs(codes.numpy().astype(np.int32)
                - np.asarray(qq).astype(np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() < 1e-3
    # within the port: masked == plain on the unsealed rows, bit for bit
    tx = torch.from_numpy(x)
    assert torch.equal(mean, fused.aggregate_flat_onepass(tx, tw, tm))
    pmean, pcodes, pscales = fused.aggregate_quantize_flat(tx, tw, tm)
    assert torch.equal(qmean, pmean) and torch.equal(qmean, mean)
    assert torch.equal(codes, pcodes) and torch.equal(scales, pscales)
    if n_int:
        tail = mean[N - n_int:]
        assert torch.equal(tail, torch.round(tail))


def _sealed_models(spec, masker, s=5, round_k=7, seed=0):
    rng = np.random.default_rng(seed)
    roster = tuple(f"n{i}" for i in range(s))
    models = []
    for _ in range(s):
        buf = rng.standard_normal(spec.n).astype(np.float32)
        buf[spec.int_mask] = rng.integers(0, 9, int(spec.int_mask.sum()))
        models.append(FlatModel(torch.from_numpy(buf), spec))
    sealed = [masker.seal(m, roster[i], round_k, roster, spec.nbytes)
              for i, m in enumerate(models)]
    secrets = {nid: masker.secret(nid, round_k) for nid in roster}
    return models, sealed, secrets


@pytest.mark.parametrize("quantize", [False, True])
def test_masked_aggregate_flatmodel_bit_identical_to_plain(quantize):
    """The acceptance invariant of the reference, restated for the port:
    with every sender present the masked path returns the plain path's
    mean, codes and scales bit for bit."""
    spec, _ = _spec_pair()
    masker = PairwiseMasker(0)
    models, sealed, secrets = _sealed_models(spec, masker)
    weights = list(np.random.default_rng(1).random(len(models)) + 0.1)
    seeds, signs = masker.unmask_matrices(sealed, secrets)
    plain = aggregate_flatmodel(models, weights, spec=spec,
                                quantize=quantize, device="cpu")
    masked = masked_aggregate_flatmodel(
        [sm.payload for sm in sealed], weights, seeds=seeds, signs=signs,
        spec=spec, quantize=quantize, device="cpu")
    if quantize:
        assert isinstance(masked[0], FlatModel) and masked[0].spec == spec
        for a, b in zip(plain, masked):
            a, b = getattr(a, "buffer", a), getattr(b, "buffer", b)
            assert torch.equal(a, b)
    else:
        assert torch.equal(plain.buffer, masked.buffer)
    with pytest.raises(ValueError):                 # weights first
        masked_aggregate_flatmodel([sm.payload for sm in sealed],
                                   [0.0] * len(sealed), seeds=seeds,
                                   signs=signs, device="cpu")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    y, w = torch.ones((3, 64)), torch.ones((3,))
    s = torch.ones((3, 2), dtype=torch.int64)
    with pytest.raises(TypeError):
        fused.unmask_aggregate_flat(y, w, seeds=s.int(), signs=s)
    with pytest.raises(ValueError):
        fused.unmask_aggregate_flat(y, w, seeds=s[:2], signs=s[:2])
    with pytest.raises(ValueError):
        fused.unmask_aggregate_quantize_flat(y, w, seeds=s, signs=s[:, :1])
    with pytest.raises(ValueError):
        fused.unmask_aggregate_flat(y, w, seeds=s.t().contiguous().t(),
                                    signs=s)
    with pytest.raises(ValueError):
        fused.unmask_aggregate_flat(y, w, seeds=s.to("meta"), signs=s)
    big = torch.ones((3, fused.MAX_MASK_TERMS), dtype=torch.int64)
    with pytest.raises(ValueError):
        fused.unmask_aggregate_flat(y, w, seeds=big, signs=big)
    r = torch.ones((2,), dtype=torch.int64)
    with pytest.raises(TypeError):
        fused.apply_mask_flat(y[0], r.int(), r)
    with pytest.raises(TypeError):
        fused.apply_mask_flat(y[0], [1, 2], r)          # tensors only
    with pytest.raises(ValueError):
        fused.apply_mask_flat(y[0], r[0], r[0])          # 0-dim
    with pytest.raises(ValueError):
        fused.apply_mask_flat(y, r, r)                  # not (N,)
    with pytest.raises(ValueError):
        fused.apply_mask_flat(y[0], r, torch.ones((3,), dtype=torch.int64))
    with pytest.raises(ValueError):
        fused.apply_mask_flat(y[0].double().float()[::2], r, r)


def test_cpu_calls_launch_no_kernel():
    before = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    x, w, mask, y, seeds, signs = _sealed_stack(2, 300, 3, seed=0)
    kw = dict(seeds=_t(seeds), signs=_t(signs))
    fused.apply_mask_flat(torch.from_numpy(x[0]), _t(seeds[0]), _t(signs[0]))
    fused.unmask_aggregate_flat(torch.from_numpy(y), torch.from_numpy(w),
                                **kw)
    fused.unmask_aggregate_quantize_flat(torch.from_numpy(y),
                                         torch.from_numpy(w), **kw)
    assert before == {n: k["wrapper"].launches for n, k in KERNELS.items()}


# ----------------------------------------------------------------- protocol

N_NODES = 16
_MCFG = dict(n_nodes=N_NODES, sample_size=4, n_aggregators=2,
             success_fraction=0.75, ping_timeout=1.0, activity_window=20,
             secure_agg="masked")


def _random_schedule(seed, F):
    """``tests/test_secureagg_conformance.py``'s schedule, built from the
    fault module ``F`` of either package."""
    r = random.Random(seed)
    rules = [F.Drop(p=r.uniform(0.05, 0.2)),
             F.Jitter(max_delay=r.uniform(0.05, 0.4)),
             F.Duplicate(p=r.uniform(0.05, 0.3), gap=r.uniform(0.05, 0.3)),
             F.AggregatorKill(round_k=r.randint(3, 8),
                              rejoin_after=r.uniform(5, 15))]
    if r.random() < 0.5:
        t0 = r.uniform(20, 60)
        rules.append(F.Partition(groups=(tuple(str(i) for i in
                                               range(r.randint(2, 6))),),
                                 t0=t0, t1=t0 + r.uniform(3, 10)))
    if r.random() < 0.5:
        t0 = r.uniform(10, 80)
        rules.append(F.Straggler(nodes=r.randint(1, 3),
                                 factor=r.uniform(2, 6),
                                 t0=t0, t1=t0 + r.uniform(5, 20)))
    return F.FaultSchedule(rules=tuple(rules), seed=seed)


def _session(pkg, seed, fault):
    """That file's ``_session``, in either package."""
    if pkg == "jax":
        return JModestSession(n_nodes=N_NODES, mcfg=JModestConfig(**_MCFG),
                              task=JAbstractTask(model_bytes_=100_000),
                              seed=seed, fault=fault)
    return ModestSession(n_nodes=N_NODES, mcfg=ModestConfig(**_MCFG),
                         task=AbstractTask(model_bytes_=100_000), seed=seed,
                         fault=fault, device="cpu")


def _arm_sniffer(session):
    """Send-time wire tap: records every plaintext model payload."""
    leaks = []
    orig = session.net.send

    def send(src, dst, msg):
        name = type(msg).__name__
        model = getattr(msg, "model", None)
        if model is not None and name == "AggregateMsg":
            leaks.append((src, dst, name, "bare AggregateMsg"))
        if name == "MaskedModelMsg" and not isinstance(model.params,
                                                       SealedModel):
            leaks.append((src, dst, name, "unsealed params"))
        orig(src, dst, msg)

    session.net.send = send
    return leaks


def _trajectory(session, result):
    return {"rt": result.round_times, "usage": result.usage,
            "fault": result.fault_stats,
            "secagg": {nid: list(n.secagg_log)
                       for nid, n in session.nodes.items()},
            "aborts": {nid: n.secagg_aborts
                       for nid, n in session.nodes.items()}}


@pytest.mark.parametrize("seed", [0, 568, 35158])
def test_masked_session_trajectory_equals_reference(seed):
    """The reference's conformance session under its random fault
    schedule. At 568 and 35158 the reference wedges (no round in the final
    third): the port must wedge the same way, so equality with the
    reference is asserted and completion is not."""
    ref = _session("jax", seed % 7, _random_schedule(seed, jfault))
    want = _trajectory(ref, ref.run(150.0))
    sess = _session("torch", seed % 7, _random_schedule(seed, tfault))
    leaks = _arm_sniffer(sess)
    got = _trajectory(sess, sess.run(150.0))
    assert got == want
    assert leaks == []
    logs = [e for log in got["secagg"].values() for e in log]
    assert logs and all(margin >= 0 for _, _, _, margin in logs)


def test_plain_config_pays_zero_secure_cost():
    mcfg = ModestConfig(**dict(_MCFG, secure_agg=None))
    s = ModestSession(n_nodes=N_NODES, mcfg=mcfg, task=AbstractTask(100_000),
                      seed=0, device="cpu")
    assert s.run(60.0).rounds_completed > 10
    for kind in ("ShareMsg", "MaskedModelMsg", "UnmaskReq", "UnmaskShareMsg"):
        assert s.net.msgs_by_type.get(kind, 0) == 0
    assert all(n._masker is None for n in s.nodes.values())


def _bare_secure_node():
    mcfg = ModestConfig(n_nodes=4, sample_size=2, n_aggregators=1,
                        success_fraction=1.0, ping_timeout=1.0,
                        secure_agg="masked")
    sim = Simulator()
    net = Network(sim, 4)
    node = ModestNode("0", sim, net, mcfg, TrainConfig(),
                      AbstractTask(model_bytes_=1000))
    node.bootstrap(["0", "1", "2", "3"])
    return sim, net, node


def test_aggregator_never_unmasks_below_threshold():
    """Sealed models arrive but the roster's shares do not: the aggregator
    aborts (bounded re-polls) and never aggregates; late shares then
    complete the round."""
    sim, net, node = _bare_secure_node()
    masker = PairwiseMasker(0)
    roster = ("1", "2", "3")
    k_train, k_agg = 4, 5
    for sender in ("1", "2"):
        sm = masker.seal(None, sender, k_train, roster, 1000)
        node.receive(M.MaskedModelMsg(
            sender=sender, round_k=k_agg,
            model=M.ModelPayload(params=sm, nbytes=1000), roster=roster))
    assert k_agg not in node._agg_models_done
    sim.run(until=node.SA_UNMASK_TIMEOUT_MULT * node.timeout
            * (node.SA_MAX_TRIES + 1))
    assert k_agg not in node._agg_models_done
    assert node.secagg_aborts >= 1 and node.secagg_log == []
    node._sa_pending.add(k_agg)
    for owner in ("1", "2"):
        for member, share in masker.make_shares(owner, k_train,
                                                roster).items():
            node.receive(M.UnmaskShareMsg(
                sender=member, round_k=k_train,
                shares=((owner, share[0], share[1]),)))
    assert k_agg in node._agg_models_done
    assert node.secagg_log == [(k_agg, 3, 2, node.secagg_log[0][3])]
    assert node.secagg_log[0][3] >= 0


def test_mixed_rows_unseal_exactly():
    """Cold path: sealed rows mixed with a plain row unseal one by one and
    aggregate to the plain mean — scalars (AbstractTask) and flat models."""
    _, _, node = _bare_secure_node()
    masker = node._masker
    roster = ("1", "2")
    vals = {"1": np.float32(1.5), "2": np.float32(2.5)}
    models = [M.ModelPayload(params=masker.seal(vals[s], s, 3, roster, 4))
              for s in roster]
    models.append(M.ModelPayload(params=np.float32(3.0)))
    secrets = {s: masker.secret(s, 3) for s in roster}
    out = node._sa_aggregate(models, secrets)
    assert out.params == np.mean([1.5, 2.5, 3.0]).astype(np.float32)

    spec, _ = _spec_pair()
    flat, sealed, secrets = _sealed_models(spec, masker, s=2, round_k=3)

    class FlatEngine:                   # what a learning task's engine does
        def aggregate(self, models, weights=None):
            return aggregate_flatmodel(models, weights, spec=spec,
                                       device="cpu")

    node.engine = FlatEngine()
    rows = [M.ModelPayload(params=sm) for sm in sealed]
    rows.append(M.ModelPayload(params=flat[0]))
    got = node._sa_aggregate(rows, secrets).params
    want = aggregate_flatmodel(flat + [flat[0]], spec=spec, device="cpu")
    assert torch.equal(got.buffer, want.buffer)


def _cnn_session(pkg, init=None, n=8):
    kw = dict(n_nodes=n, sample_size=3, n_aggregators=2,
              success_fraction=1.0, ping_timeout=1.0, secure_agg="masked")
    if pkg == "torch":
        task = cnn_task(device="cpu")
        task.init_params = lambda seed=0: params_from_numpy(init, "cpu")
        return ModestSession(
            n_nodes=n, mcfg=ModestConfig(**kw),
            tcfg=TrainConfig(batch_size=20), task=task,
            data=make_classification_task(n, samples_per_node=30, iid=False,
                                          alpha=0.5, seed=0),
            seed=0, eval_every_rounds=5, engine="batched", device="cpu")
    return JModestSession(
        n_nodes=n, mcfg=JModestConfig(**kw), tcfg=JTrainConfig(batch_size=20),
        task=jax_cnn_task(),
        data=j_make_classification_task(n, samples_per_node=30, iid=False,
                                        alpha=0.5, seed=0),
        seed=0, eval_every_rounds=5, engine="batched")


def test_masked_cnn_session_matches_reference():
    """The paper CNN at full width, masked, 8 nodes in cohorts of 3, from
    the reference's initial weights: the port's trajectory (round times,
    bytes, every node's secure-aggregation log) equals the reference's,
    accuracy at every evaluated round is within 0.02 (the tolerance of
    ``test_cnn_session_matches_reference_and_engines_agree``), nothing
    plain goes on the wire, and every aggregation went through the fused
    unmask-aggregate of sealed rows."""
    jsess = _cnn_session("jax")
    init = jax.tree.map(np.asarray, jsess.task.init_params(0))
    ref = jsess.run(20.0)
    sess = _cnn_session("torch", init)
    leaks = _arm_sniffer(sess)
    calls = []
    inner = sess.engine.aggregate_masked

    def aggregate_masked(models, seeds, signs, weights=None):
        calls.append(len(models))
        assert all(isinstance(m, FlatModel) for m in models)
        return inner(models, seeds, signs, weights)

    sess.engine.aggregate_masked = aggregate_masked
    res = sess.run(20.0)
    assert res.rounds_completed == ref.rounds_completed >= 10
    assert res.round_times == ref.round_times and res.usage == ref.usage
    logs = {nid: n.secagg_log for nid, n in sess.nodes.items()}
    assert logs == {nid: n.secagg_log for nid, n in jsess.nodes.items()}
    flat_logs = [e for log in logs.values() for e in log]
    assert flat_logs and all(margin >= 0 for _, _, _, margin in flat_logs)
    assert leaks == []
    n_agg = sum(len(n.agg_log) for n in sess.nodes.values())
    assert len(calls) == len(flat_logs) == n_agg
    acc = {}
    for key, r in (("port", res), ("ref", ref)):
        acc[key] = {h["round"]: h["accuracy"] for h in r.history
                    if "accuracy" in h}
    assert acc["port"].keys() == acc["ref"].keys() and acc["port"]
    for k in acc["port"]:
        assert abs(acc["port"][k] - acc["ref"][k]) < 0.02, (k, acc)
    assert abs(res.final_metrics["loss"] - ref.final_metrics["loss"]) < 0.02
