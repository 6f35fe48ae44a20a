"""The PyTorch package's sharded FlatModel path (the counterpart of
``tests/test_sharded.py``), on the CPU.

A mesh here is a tuple of devices, and one device may stand in it k times:
k chunks of the CPU run the very code that k cards would (pad to
``shard_align``, split N, one launch a shard at its lane ``base``, gather
on the first device), through the kernels' plain versions. Held here:

* ``shard_align`` equals the reference's; the ``FlatShardings`` layouts;
  the engine mesh and ``make_engine("sharded")``'s fallback on one device;
* mean, codes and scales at 1, 2, 4 and 8 chunks equal one call's bit for
  bit, plain and masked, with an integer leaf;
* B4/B5's lane ``base`` and global ``n_valid`` against the reference:
  exact where the reference's arithmetic is exact (the ring unmask, and a
  mean that is one row's values).

A ``MeshEngine`` session on 4 chunks against the batched engine's is in
``test_torch_sharded_session.py`` (a file of its own, so that a run that
spreads test files over workers can spread the two).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused as jfused
from repro_torch.core.tasks import AbstractTask
from repro_torch.engine import (BatchedEngine, FlatModel, FlatSpec,
                                MeshEngine, SequentialEngine, make_engine)
from repro_torch.kernels import fused
from repro_torch.kernels.ops import (aggregate_flatmodel,
                                     masked_aggregate_flatmodel)
from repro_torch.models.tasks import cnn_task
from repro_torch.sharding import FlatPlacement, FlatShardings
from test_torch_threads import one_torch_thread  # noqa: F401

SUBTILE = fused.SUBTILE
CHUNKS = (1, 2, 4, 8)
TOL = dict(rtol=1e-6, atol=1e-6)


def _cpu_mesh(k):
    return (torch.device("cpu"),) * k


# ---------------------------------------------------------------------------
# shard_align, layouts, mesh, engine selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", CHUNKS)
@pytest.mark.parametrize("n", [1, 100, SUBTILE, 8 * SUBTILE - 1, 136672])
def test_shard_align(n, shards):
    total = fused.shard_align(n, shards)
    assert total == jfused.shard_align(n, shards)
    per = total // shards
    assert total >= n
    assert per % SUBTILE == 0                 # every shard subtile-aligned
    assert total - n < shards * SUBTILE       # minimal padding


def test_flat_shardings_layouts():
    """``FlatSpec.sharding`` on a mesh of CPU chunks: N carries the model
    axis, rows are whole, every buffer lives on the mesh's first device;
    hashable, and equal for equal meshes."""
    spec = cnn_task(device="cpu").flat_spec
    fs = spec.sharding(("cpu",) * 4)
    assert isinstance(fs, FlatShardings) and fs.n_shards == 4
    assert fs.mesh == _cpu_mesh(4) and fs.model_axis == "model"
    assert fs.vec == FlatPlacement(fs.mesh, ("model",))
    assert fs.stack.spec == (None, "model") and fs.pop == fs.stack
    assert fs.replicated.spec == () and fs.replicated.home == fs.mesh[0]
    assert hash(fs) == hash(spec.sharding(_cpu_mesh(4)))
    assert fs == spec.sharding(_cpu_mesh(4)) != spec.sharding(_cpu_mesh(2))
    assert {fs: 1}[spec.sharding(["cpu"] * 4)] == 1          # cacheable
    assert spec.sharding(("cpu",), model_axis="m").vec.spec == ("m",)
    with pytest.raises(ValueError, match="row_axis"):
        spec.sharding(_cpu_mesh(2), row_axis="data")
    with pytest.raises(ValueError, match="at least one"):
        spec.sharding(())


def test_engine_mesh_none_on_fewer_than_two_cards(monkeypatch):
    import repro_torch.launch.mesh as lm

    assert lm.make_engine_mesh("cpu") is None
    monkeypatch.setattr(lm.torch.cuda, "device_count", lambda: 1)
    assert lm.make_engine_mesh() is None
    assert lm.make_engine_mesh("cuda:0") is None
    # more than one card: all of them, from the one asked for (no device
    # state is touched to build the tuple)
    monkeypatch.setattr(lm.torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(lm.torch.cuda, "current_device", lambda: 0)
    assert lm.make_engine_mesh() == tuple(torch.device("cuda", i)
                                          for i in range(4))
    assert [d.index for d in lm.make_engine_mesh("cuda:2")] == [2, 3, 0, 1]
    assert lm.make_engine_mesh("cpu") is None


def test_make_engine_sharded_selection():
    """On one device (here the CPU) "sharded" falls back to the batched
    engine, as the reference's does; a byte-only task has nothing to
    shard. ``MeshEngine`` is built on an explicit mesh of chunks."""
    task = cnn_task(device="cpu")
    assert type(make_engine("sharded", task, device="cpu")) is BatchedEngine
    assert isinstance(make_engine("sharded", AbstractTask(1000),
                                  device="cpu"), SequentialEngine)
    eng = MeshEngine(task, ("cpu",) * 4)
    assert isinstance(eng, BatchedEngine) and eng.name == "sharded"
    assert eng.shardings == task.flat_spec.sharding(_cpu_mesh(4))
    assert eng.mesh == _cpu_mesh(4) and eng.shardings.n_shards == 4
    with pytest.raises(ValueError, match="mesh starts at"):
        MeshEngine(task, ("meta", "cpu"))


# ---------------------------------------------------------------------------
# chunks against one call, bit for bit
# ---------------------------------------------------------------------------


def _flat_stack(N, P=3, R=3, seed=0, n_int=3):
    """P FlatModels of a spec with a float leaf and an int32 leaf (N lanes
    in all), their sealed copies, and the seeds and signs that unseal
    them."""
    rng = np.random.default_rng(seed)
    spec = FlatSpec.from_tree({"w": torch.zeros(N - n_int),
                               "step": torch.zeros(n_int, dtype=torch.int32)})
    bufs = rng.standard_normal((P, N)).astype(np.float32)
    bufs[:, spec.int_mask] = rng.integers(0, 50, (P, n_int))
    seeds = rng.integers(0, 2**32, (P, R), dtype=np.uint64).astype(np.int64)
    signs = np.where(rng.random((P, R)) < 0.5, -1, 1).astype(np.int64)
    models = [FlatModel(torch.from_numpy(b.copy()), spec) for b in bufs]
    sealed = [FlatModel(fused.apply_mask_flat(
        m.buffer, torch.from_numpy(seeds[p]), torch.from_numpy(signs[p])),
        spec) for p, m in enumerate(models)]
    weights = list(rng.random(P) + 0.5)
    return spec, models, sealed, seeds, signs, weights


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("k", CHUNKS)
@pytest.mark.parametrize("N", [100, SUBTILE, 8 * SUBTILE - 1, 136672])
def test_chunks_equal_one_call_bit_for_bit(N, k):
    """``shardings=`` on k CPU chunks: mean, codes and scales equal one
    call's bit for bit, plain and masked (and masked equal plain)."""
    spec, models, sealed, seeds, signs, w = _flat_stack(N, seed=N + k)
    fs = spec.sharding(_cpu_mesh(k))
    kw = dict(spec=spec, device="cpu")
    mk = dict(kw, seeds=seeds, signs=signs)
    one = aggregate_flatmodel(models, w, quantize=True, **kw)
    one = (one[0].buffer, one[1], one[2])
    assert one[2].shape == (-(-N // SUBTILE),)
    got = aggregate_flatmodel(models, w, quantize=True, shardings=fs, **kw)
    assert _same((got[0].buffer, got[1], got[2]), one)
    got = masked_aggregate_flatmodel(sealed, w, quantize=True, shardings=fs,
                                     **mk)
    assert _same((got[0].buffer, got[1], got[2]), one)
    assert torch.equal(aggregate_flatmodel(models, w, shardings=fs,
                                           **kw).buffer, one[0])
    assert torch.equal(masked_aggregate_flatmodel(sealed, w, shardings=fs,
                                                  **mk).buffer, one[0])
    ints = one[0][torch.from_numpy(spec.int_mask)]    # rounded in-kernel
    assert ints.shape == (3,) and torch.equal(ints, torch.round(ints))


def test_sharded_calls_refuse_a_mesh_elsewhere():
    spec, models, _, _, _, w = _flat_stack(100)
    with pytest.raises(ValueError, match="mesh starts at"):
        aggregate_flatmodel(models, w, spec=spec, device="cpu",
                            shardings=spec.sharding(("meta", "cpu")))


def test_shards_see_the_global_n_valid():
    """B4/B5 on one shard of longer rows. The last real shard of
    N = 3·SUBTILE − 100 over 2 shards (base 2·SUBTILE) holds 100 pad lanes
    in its first subtile: unmasked at the global ``n_valid`` they stay
    zeros, and the shard's mean, codes and scales are the whole call's;
    with every lane of the shard taken as sealed (an ``n_valid`` past the
    shard, what a kernel that ignored it would do) the pad lanes take mask
    words and that subtile's scale is wrong. At N = 11,173 over 8 shards,
    shards 1-7 are all padding: zeros, codes 0, the scale of zeros."""
    N, k = 3 * SUBTILE - 100, 2
    spec, models, sealed, seeds, signs, w = _flat_stack(N, seed=7)
    x = torch.stack([m.buffer for m in models])
    y = torch.stack([m.buffer for m in sealed])
    tw = torch.tensor(w, dtype=torch.float32)
    m = spec.int_mask_on("cpu")
    kw = dict(seeds=torch.from_numpy(seeds), signs=torch.from_numpy(signs))
    whole = fused.aggregate_quantize_flat(x, tw, m)
    shards = fused._pad_sharded(y.view(torch.int32), m, _cpu_mesh(k))
    base, yr, mr = shards[1]
    assert base == 2 * SUBTILE and yr.shape == (3, 2 * SUBTILE)
    yr = yr.view(torch.float32)
    mean, codes, scales = fused.unmask_aggregate_quantize_flat(
        yr, tw, mr, base=base, n_valid=N, **kw)
    live = N - base
    assert torch.equal(mean[:live], whole[0][base:])
    assert torch.equal(codes[:live], whole[1][base:])
    assert not mean[live:].any() and not codes[live:].any()
    assert torch.equal(scales[0], whole[2][2])
    assert torch.equal(fused.unmask_aggregate_flat(
        yr, tw, mr, base=base, n_valid=N, **kw), mean)
    wrong = fused.unmask_aggregate_quantize_flat(         # every lane
        yr, tw, mr, base=base, n_valid=base + yr.shape[1], **kw)  # sealed
    assert torch.equal(wrong[0][:live], mean[:live])
    assert not torch.equal(wrong[2][0], scales[0])

    N, k = 11173, 8
    spec, models, sealed, seeds, signs, w = _flat_stack(N, seed=8)
    y = torch.stack([m.buffer for m in sealed])
    tw = torch.tensor(w, dtype=torch.float32)
    kw = dict(seeds=torch.from_numpy(seeds), signs=torch.from_numpy(signs))
    zero_scale = fused._plain_quantize(torch.zeros(SUBTILE))[1]
    for base, yr, mr in fused._pad_sharded(y.view(torch.int32),
                                           spec.int_mask_on("cpu"),
                                           _cpu_mesh(k))[1:]:
        mean, codes, scales = fused.unmask_aggregate_quantize_flat(
            yr.view(torch.float32), tw, mr, base=base, n_valid=N, **kw)
        assert not mean.any() and not codes.any()
        assert torch.equal(scales, zero_scale)


def test_wrappers_refuse_a_base_the_kernels_do_not_take():
    spec, _, sealed, seeds, signs, w = _flat_stack(100)
    y = torch.stack([m.buffer for m in sealed])
    tw = torch.tensor(w, dtype=torch.float32)
    kw = dict(seeds=torch.from_numpy(seeds), signs=torch.from_numpy(signs))
    for fn in (fused.unmask_aggregate_flat,
               fused.unmask_aggregate_quantize_flat):
        for bad in (dict(base=SUBTILE // 2), dict(base=-SUBTILE),
                    dict(base=1 << 32), dict(n_valid=-1),
                    dict(base=1.0 * SUBTILE)):
            with pytest.raises((ValueError, TypeError)):
                fn(y, tw, **kw, **bad)


# ---------------------------------------------------------------------------
# the reference's base and n_valid, exactly
# ---------------------------------------------------------------------------


def _sealed_shards(N, k, P=3, R=2, seed=0):
    """A stack sealed by the reference (real lanes only), padded to
    ``shard_align(N, k)``, with its weights, mask, seeds and signs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, N)).astype(np.float32)
    x[:, N - 7:] = rng.integers(0, 50, (P, 7))
    mask = np.zeros(N, np.float32)
    mask[N - 7:] = 1
    w = (rng.random(P) + 0.5).astype(np.float32)
    seeds = rng.integers(0, 2**32, (P, R), dtype=np.uint64).astype(np.uint32)
    signs = np.where(rng.random((P, R)) < 0.5, -1, 1).astype(np.int32)
    total = fused.shard_align(N, k)
    y = np.zeros((P, total), np.float32)
    y[:, :N] = np.stack([np.asarray(jfused.apply_mask_flat(
        jnp.asarray(x[p]), seeds[p], signs[p])) for p in range(P)])
    m = np.zeros(total, np.float32)
    m[:N] = mask
    return y, w, m, seeds, signs, total // k


@pytest.mark.parametrize("N,k", [(3 * SUBTILE - 100, 2), (5000, 4),
                                 (8 * SUBTILE - 1, 8)])
def test_plain_unmask_equals_reference_unmask_bits(N, k):
    """Each shard's rows unsealed by the port's plain unmask at
    ``base = r·local_n, n_valid = N`` equal the reference's ``_unmask_bits``
    with the same global counters, bit for bit (pad lanes pass as zeros)."""
    y, _, _, seeds, signs, local_n = _sealed_shards(N, k, seed=N)
    ts = torch.from_numpy(seeds.astype(np.int64))
    tg = torch.from_numpy(signs.astype(np.int64))
    for r in range(k):
        base = r * local_n
        yr = np.ascontiguousarray(y[:, base:base + local_n])
        lanes = jnp.asarray(np.arange(base, base + local_n,
                                      dtype=np.uint32))[None]
        want = np.asarray(jfused._unmask_bits(
            jnp.asarray(yr), jnp.asarray(seeds), jnp.asarray(signs), lanes,
            N)).view(np.int32)
        got = fused._plain_unmask_stack(torch.from_numpy(yr), ts, tg, base, N)
        assert np.array_equal(got.view(torch.int32).numpy(), want), r


def _ref_shard_call(yr, w, mr, seeds, signs, base, N):
    """The reference's B4 and B5 on one shard at a non-zero base, in
    interpret mode (one grid step a subtile)."""
    args = (jnp.asarray(yr), jnp.asarray(w), jnp.asarray(mr),
            jnp.asarray(seeds), jnp.asarray(signs),
            jnp.full((1, 1), base, jnp.uint32))
    kw = dict(tile=SUBTILE, n_valid=N, interpret=True)
    return (np.asarray(jfused._unmask_tiles(*args, **kw)),
            tuple(np.asarray(a) for a in
                  jfused._unmask_quant_tiles(*args, **kw)))


def test_unmask_at_base_equals_reference_pallas_interpret():
    """B4 and B5 at ``base = 2·SUBTILE`` (the last real shard of
    N = 3·SUBTILE − 100 over 2 shards, 100 pad lanes), P = 3, R = 2,
    against the reference's ``_unmask_tiles`` / ``_unmask_quant_tiles``
    run in interpret mode at the same base.

    Exact: with one row's weight 1 and the others' 0, the mean is that
    row's unsealed lanes whatever the order of summation, so the mean,
    codes and scales of each row in turn equal the reference's bit for
    bit. With real weights the mean is held at ``rtol = atol = 1e-6``
    (XLA sums in another order) and codes and scales as in
    ``test_torch_secureagg.py`` (ROADMAP C1: within one ulp and one step).
    """
    N, k = 3 * SUBTILE - 100, 2
    y, w, m, seeds, signs, local_n = _sealed_shards(N, k, seed=1)
    base = local_n
    yr = np.ascontiguousarray(y[:, base:])
    mr = m[base:]
    ty, tm = torch.from_numpy(yr), torch.from_numpy(mr.astype(np.uint8))
    kw = dict(seeds=torch.from_numpy(seeds.astype(np.int64)),
              signs=torch.from_numpy(signs.astype(np.int64)), base=base,
              n_valid=N)

    def port(weights):
        tw = torch.from_numpy(weights)
        return (fused.unmask_aggregate_flat(ty, tw, tm, **kw).numpy(),
                tuple(a.numpy() for a in fused.unmask_aggregate_quantize_flat(
                    ty, tw, tm, **kw)))

    for p in range(y.shape[0]):
        one_hot = np.eye(y.shape[0], dtype=np.float32)[p]
        want_mean, want_q = _ref_shard_call(yr, one_hot, mr, seeds, signs,
                                            base, N)
        got_mean, got_q = port(one_hot)
        assert np.array_equal(got_mean, want_mean), p
        for got, want in zip(got_q, want_q):
            assert np.array_equal(got, want), p
        assert not got_mean[N - base:].any()          # pad lanes: zeros

    want_mean, (qm, qq, qs) = _ref_shard_call(yr, w, mr, seeds, signs, base,
                                              N)
    got_mean, (gm, gq, gs) = port(w)
    np.testing.assert_allclose(got_mean, want_mean, **TOL)
    np.testing.assert_array_equal(gm, got_mean)
    np.testing.assert_allclose(gs, qs, rtol=3e-7)
    dq = np.abs(gq.astype(np.int32) - qq.astype(np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() < 1e-3
