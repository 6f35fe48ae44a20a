"""The PyTorch task against the reference ``JaxTask``: same parameters
(taken from the reference's init through ``params_from_numpy``), same
client shard, same seeds -> loss, local training, evaluation within
``rtol = atol = 1e-5`` (fp32; reduction order and convolution algorithms
differ between XLA and PyTorch)."""

import jax
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.data.loader import ClientDataset as JClient
from repro.engine.lowering import masked_loss_for as j_masked_loss_for
from repro.models.tasks import cnn_task as jax_cnn_task
from repro_torch.config import TrainConfig
from repro_torch.data.loader import ClientDataset
from repro_torch.engine.flat import params_from_numpy, params_to_numpy
from repro_torch.engine.lowering import (masked_loss_for, stacked_grads_for,
                                         stacked_metrics_for)
from repro_torch.models.tasks import TorchTask, cnn_task
from repro_torch.utils.pytree import tree_map
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(image, **tkw):
    """(reference task, port task) with equal configs."""
    jt = jax_cnn_task(JTrainConfig(**tkw) if tkw else None, cnn_image=image)
    tt = cnn_task(TrainConfig(**tkw) if tkw else None, device="cpu",
                  cnn_image=image)
    return jt, tt


def _shard(image, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + image).astype(np.float32)
    y = rng.integers(0, 10, n)
    return JClient(x, y), ClientDataset(x, y)


def _carry(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _assert_trees_close(tparams, jparams, **tol):
    got = params_to_numpy(tparams)
    for k in jparams:
        np.testing.assert_allclose(got[k], np.asarray(jparams[k]),
                                   err_msg=k, **(tol or TOL))


@pytest.mark.parametrize("image", [(8, 8, 3), (12, 12, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_matches_reference(image, masked):
    jt, tt = _pair(image)
    jp = jt.init_params(1)
    tp = _carry(jp)
    jc, tc = _shard(image, 20, seed=4)
    mask = None
    if masked:
        mask = np.ones(20, np.float32)
        mask[13:] = 0.0
    jl, jm = jt.model.loss_fn(jp, jt._to_batch(jc.x, jc.y, mask))
    tl, tm = tt.model.loss_fn(tp, tt._to_batch(tc.x, tc.y, mask))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert set(tm) == set(jm) == {"loss", "accuracy"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    # the cohort lowering's per-model loss is the same number
    jl2 = j_masked_loss_for(jt)(jp, jt._to_batch(
        jc.x, jc.y, np.ones(20, np.float32) if mask is None else mask))
    tl2 = masked_loss_for(tt)(tp, tt._to_batch(
        tc.x, tc.y, np.ones(20, np.float32) if mask is None else mask))
    np.testing.assert_allclose(float(tl2), float(jl2), **TOL)


def test_all_masked_batch_is_zero_loss_not_nan():
    _, tt = _pair((8, 8, 3))
    _, tc = _shard((8, 8, 3), 6, seed=0)
    loss, m = tt.model.loss_fn(tt.init_params(0), tt._to_batch(
        tc.x, tc.y, np.zeros(6, np.float32)))
    assert float(loss) == 0.0 and float(m["accuracy"]) == 0.0


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw", "yogi"])
def test_local_train_matches_reference(opt, clip):
    # adamw at its customary 1e-3: its update m/(sqrt(v)+eps) is of size
    # lr whatever the gradient's size, so fp noise on near-zero gradients
    # is carried at the scale of lr itself
    lr = 0.001 if opt == "adamw" else 0.01
    tkw = dict(optimizer=opt, lr=lr, momentum=0.9, grad_clip=clip,
               weight_decay=0.01 if opt in ("sgd", "adamw") else 0.0)
    image = (8, 8, 3)
    jt, tt = _pair(image, **tkw)
    jp = jt.init_params(2)
    jc, tc = _shard(image, 50, seed=8)          # 20 + 20 + masked tail of 10
    jout = jt.local_train(jp, jc, batch_size=20, epochs=2, seed=3)
    tout = tt.local_train(_carry(jp), tc, batch_size=20, epochs=2, seed=3)
    _assert_trees_close(tout, jout)
    # the step moved the weights by far more than the tolerance
    moved = max(float(np.abs(np.asarray(jout[k]) - np.asarray(jp[k])).max())
                for k in jp)
    assert moved > 1e-3


def test_local_train_matches_reference_other_image_and_full_width():
    for image, n in (((12, 12, 3), 30), ((32, 32, 3), 25)):
        jt, tt = _pair(image)                    # the paper's momentum setup
        jp = jt.init_params(0)
        jc, tc = _shard(image, n, seed=1)
        jout = jt.local_train(jp, jc, batch_size=20, epochs=1, seed=5)
        tout = tt.local_train(_carry(jp), tc, batch_size=20, epochs=1, seed=5)
        _assert_trees_close(tout, jout)


def test_padded_batches_equal_reference():
    jt, tt = _pair((8, 8, 3))
    jc, tc = _shard((8, 8, 3), 25, seed=2)
    jb = jt._padded_batches(jc, 20, seed=9, epochs=2)
    tb = tt._padded_batches(tc, 20, seed=9, epochs=2)
    assert len(jb) == len(tb) == 4
    assert [int(m.sum()) for _, _, m in tb] == [20, 5, 20, 5]
    for (jx, jy, jm), (tx, ty, tm) in zip(jb, tb):
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jy, ty)
        np.testing.assert_array_equal(jm, tm)
    assert tt.train_time(tc, batch_size=20) == jt.train_time(jc, batch_size=20)


@pytest.mark.parametrize("image", [(8, 8, 3), (12, 12, 3)])
def test_evaluate_and_evaluate_many_match_reference(image):
    jt, tt = _pair(image)
    jtest, ttest = _shard(image, 100, seed=3)    # 64 + a padded batch of 36
    jmodels = [jt.init_params(s) for s in range(3)]
    tmodels = [_carry(p) for p in jmodels]
    jmany = jt.evaluate_many(jmodels, jtest)
    tmany = tt.evaluate_many(tmodels, ttest)
    assert len(tmany) == 3
    for jp, tp, jm, tm in zip(jmodels, tmodels, jmany, tmany):
        one_j, one_t = jt.evaluate(jp, jtest), tt.evaluate(tp, ttest)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(one_t[k], one_j[k], **TOL)
            np.testing.assert_allclose(tm[k], jm[k], **TOL)
            np.testing.assert_allclose(tm[k], one_t[k], **TOL)
    assert tt.evaluate_many([], ttest) == []


def test_stacked_lowering_equals_per_model_gradients():
    """The hand-written grouped lowering gives each model the gradient of
    its own ``loss_fn``, in the port and in the reference (1e-5)."""
    image = (8, 8, 3)
    jt, tt = _pair(image)
    S, B = 3, 10
    jps = [jt.init_params(s) for s in range(S)]
    tps = [_carry(p) for p in jps]
    rng = np.random.default_rng(0)
    xb = rng.normal(size=(S, B) + image).astype(np.float32)
    yb = rng.integers(0, 10, (S, B))
    mb = np.ones((S, B), np.float32)
    mb[1, 6:] = 0.0
    stacked = tree_map(lambda *ls: torch.stack(ls), *tps)
    args = (stacked, torch.from_numpy(xb), torch.from_numpy(yb),
            torch.from_numpy(mb))
    fast = stacked_grads_for(tt)(*args)
    jloss, tloss = j_masked_loss_for(jt), masked_loss_for(tt)
    for s in range(S):
        want = jax.grad(jloss)(jps[s], jt._to_batch(xb[s], yb[s], mb[s]))
        own = torch.func.grad(tloss)(tps[s], tt._to_batch(xb[s], yb[s], mb[s]))
        for k in want:
            np.testing.assert_allclose(fast[k][s].numpy(),
                                       np.asarray(want[k]), err_msg=k, **TOL)
            np.testing.assert_allclose(fast[k][s].numpy(), own[k].numpy(),
                                       err_msg=k, **TOL)
    # evaluation sweep: the stacked form agrees with the per-model metrics
    batch = tt._to_batch(xb[0], yb[0])
    with torch.no_grad():
        mf = stacked_metrics_for(tt)(stacked, batch)
    for s in range(S):
        one = tt._eval(tps[s], batch)
        for k in one:
            np.testing.assert_allclose(float(mf[k][s]), float(one[k]), **TOL)


def test_odd_image_floors_like_the_reference_pool():
    """30x30 is not divisible by 4: both packages floor in the pools."""
    image = (30, 30, 3)
    jt, tt = _pair(image)
    jp = jt.init_params(0)
    jc, tc = _shard(image, 12, seed=0)
    jl, _ = jt.model.loss_fn(jp, jt._to_batch(jc.x, jc.y))
    tl, _ = tt.model.loss_fn(_carry(jp), tt._to_batch(tc.x, tc.y))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_init_params_are_seeded_and_shaped_like_the_reference():
    jt, tt = _pair((8, 8, 3))
    a, b, c = tt.init_params(0), tt.init_params(0), tt.init_params(1)
    jp = jt.init_params(0)
    assert sorted(a) == sorted(jp)
    for k in a:
        assert tuple(a[k].shape) == jp[k].shape and a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["conv1"], c["conv1"])
    assert float(a["b1"].abs().sum()) == 0.0
    assert abs(float(a["conv1"].std()) - 0.1) < 0.02
    assert isinstance(tt, TorchTask) and tt.supports_cohort
    assert tt.name == "paper-cnn" and tt.device == torch.device("cpu")
