"""The PyTorch package's compute engine: the batched-vs-sequential
differentials inside the port (as the reference's tests/test_engine.py runs
them inside the reference), and the port's batched engine against the
reference's batched engine from the same parameters.

Tolerances: trajectories of a few optimizer steps at ``< 5e-4`` (the
reference's own bound for batched vs sequential), one-epoch results across
the two packages at ``rtol = atol = 1e-5``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data.loader import ClientDataset as JClient
from repro.engine import BatchedEngine as JBatchedEngine
from repro.models.tasks import cnn_task as jax_cnn_task
from repro_torch.config import TrainConfig
from repro_torch.core.tasks import AbstractTask
from repro_torch.data.loader import ClientDataset
from repro_torch.engine import (BatchedEngine, FlatModel, SequentialEngine,
                                make_engine)
from repro_torch.engine.flat import params_from_numpy
from repro_torch.models.tasks import cnn_task
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401

IMAGE = (12, 12, 3)


@pytest.fixture(scope="module")
def task():
    return cnn_task(device="cpu", cnn_image=IMAGE)


def _clients(sizes, image=IMAGE, seed=0, cls=ClientDataset):
    rng = np.random.default_rng(seed)
    return [cls(rng.normal(size=(n,) + image).astype(np.float32),
                rng.integers(0, 10, n)) for n in sizes]


@pytest.fixture(scope="module")
def small_clients():
    return _clients((25, 40, 15))           # ragged, full, tail-only mixes


def _max_err(a, b):
    return max(float((x.to(torch.float32) - y.to(torch.float32)).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _train_cohort(engine, params, clients, *, tag=1, seed=11, epochs=1):
    for i, c in enumerate(clients):
        engine.submit(str(i), tag, params, c, batch_size=20, epochs=epochs,
                      seed=seed)
    return [engine.result(str(i), tag, params, c, batch_size=20,
                          epochs=epochs, seed=seed)
            for i, c in enumerate(clients)]


@pytest.mark.parametrize("opt", ["momentum", "sgd", "adamw", "yogi"])
def test_cohort_matches_sequential_fp32(small_clients, opt):
    task = cnn_task(TrainConfig(optimizer=opt, lr=0.002, momentum=0.9,
                                grad_clip=1.0 if opt == "sgd" else 0.0),
                    device="cpu", cnn_image=IMAGE)
    params = task.init_params(0)
    engine = BatchedEngine(task)
    seq = [task.local_train(params, c, batch_size=20, epochs=1, seed=11)
           for c in small_clients]
    got = _train_cohort(engine, params, small_clients)
    # whole cohort ran on the first demand (grouped into step-count
    # buckets: clients with 2 training steps vs the 15-sample 1-stepper)
    assert engine.jobs_run == 3 and engine.flushes == 2
    for s, g in zip(seq, got):
        assert isinstance(g, FlatModel)
        assert _max_err(s, g.tree) < 5e-4
        assert _max_err(params, g.tree) > 1e-4          # it did train


def test_cohort_matches_sequential_full_width():
    task = cnn_task(device="cpu")
    clients = _clients((25, 40), image=(32, 32, 3))
    params = task.init_params(0)
    engine = BatchedEngine(task)
    got = _train_cohort(engine, params, clients)
    assert engine.jobs_run == 2 and engine.flushes == 1
    for c, g in zip(clients, got):
        want = task.local_train(params, c, batch_size=20, epochs=1, seed=11)
        assert g.buffer.shape == (136672,)
        assert _max_err(want, g.tree) < 5e-4


def test_cohort_matches_sequential_bf16(task, small_clients):
    """bf16 tier: the sequential path re-rounds params to bf16 every step
    while the engine trains in fp32 and rounds once at the boundary, so
    the tolerance is the bf16 resolution, not fp32's."""
    params = tree_map(lambda l: l.to(torch.bfloat16), task.init_params(0))
    engine = BatchedEngine(task)
    seq = task.local_train(params, small_clients[0], batch_size=20,
                           epochs=1, seed=3)
    got = engine.result("0", 1, params, small_clients[0], batch_size=20,
                        epochs=1, seed=3)
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(got.tree))
    assert got.wire_bytes == task.flat_spec.nbytes // 2
    assert _max_err(seq, got.tree) < 0.05


def test_cohort_multi_epoch_parity(task, small_clients):
    params = task.init_params(0)
    engine = BatchedEngine(task)
    seq = task.local_train(params, small_clients[0], batch_size=20,
                           epochs=3, seed=5)
    got = engine.result("0", 2, params, small_clients[0], batch_size=20,
                        epochs=3, seed=5)
    assert _max_err(seq, got.tree) < 1e-3


def test_masked_tail_does_not_upweight(task):
    """The ragged tail must contribute each sample once: training on a
    27-sample client (20 + masked 7) equals training on the same batches
    built by hand — and differs from replicating the tail."""
    client = _clients((27,), seed=7)[0]
    params = task.init_params(1)
    batches = task._padded_batches(client, 20, seed=9)
    assert [int(m.sum()) for _, _, m in batches] == [20, 7]
    opt_state = task._opt.init(params)
    want = params
    for bx, by, bm in batches:
        want, opt_state, _ = task._step(want, opt_state,
                                        task._to_batch(bx, by, bm))
    got = task.local_train(params, client, batch_size=20, seed=9)
    assert _max_err(want, got) < 1e-6
    engine_got = BatchedEngine(task).result("0", 1, params, client,
                                            batch_size=20, epochs=1, seed=9)
    assert _max_err(want, engine_got.tree) < 5e-4
    # replicating the 7 tail samples to fill the batch (all-ones mask over
    # the padded rows: 7 + 7 + 6) upweights some and gives another result
    opt_state = task._opt.init(params)
    old = params
    for bx, by, _ in batches:
        old, opt_state, _ = task._step(
            old, opt_state, task._to_batch(bx, by, np.ones(20, np.float32)))
    assert _max_err(old, got) > 1e-6


def test_inactive_rows_keep_params_and_state():
    """Per-row ``active`` gating: an inactive row's params and optimizer
    state pass through the step untouched, an active row's move."""
    from repro_torch.engine.cohort import _cohort_ops
    task = cnn_task(TrainConfig(optimizer="adamw", lr=0.01), device="cpu",
                    cnn_image=(8, 8, 3))
    opt, step = _cohort_ops(task)
    assert _cohort_ops(task)[1] is step                 # cached on the task
    spec = task.flat_spec
    buf = torch.stack([spec.pack(task.init_params(s)) for s in range(2)])
    state = opt.init(buf)
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.normal(size=(2, 6, 8, 8, 3)).astype(np.float32))
    yb = torch.from_numpy(rng.integers(0, 10, (2, 6)))
    mb = torch.ones((2, 6))
    nbuf, nstate = step(buf, state, xb, yb, mb, torch.tensor([True, False]))
    assert torch.equal(nbuf[1], buf[1]) and not torch.equal(nbuf[0], buf[0])
    assert nstate["count"].tolist() == [1.0, 0.0]
    assert float(nstate["mu"][1].abs().sum()) == 0.0
    assert float(nstate["mu"][0].abs().sum()) > 0.0
    assert not nbuf.requires_grad


def test_cohort_odd_image_shape(task):
    """Spatial sizes not divisible by 4 floor in the pools, in the stacked
    lowering as in the model's own."""
    for hw in (20, 30):
        tk = cnn_task(device="cpu", cnn_image=(hw, hw, 3))
        c = _clients((12,), image=(hw, hw, 3))[0]
        params = tk.init_params(0)
        got = BatchedEngine(tk).result("0", 1, params, c, batch_size=8,
                                       epochs=1, seed=1)
        want = tk.local_train(params, c, batch_size=8, epochs=1, seed=1)
        assert _max_err(want, got.tree) < 5e-4


def test_cohort_empty_shard_is_a_noop(task):
    empty = ClientDataset(np.zeros((0,) + IMAGE, np.float32),
                          np.zeros((0,), np.int64))
    params = task.init_params(0)
    eng = BatchedEngine(task)
    got = eng.result("0", 1, params, empty, batch_size=20, epochs=1, seed=0)
    assert _max_err(params, got.tree) == 0.0
    assert eng.jobs_run == 0


def test_cohort_result_falls_back_on_unknown_params(task, small_clients):
    """A result() whose θ was never submitted (e.g. racing aggregators)
    still trains correctly via the fallback path."""
    params = task.init_params(0)
    other = tree_map(lambda l: l + 0.01, params)
    engine = BatchedEngine(task)
    engine.submit("0", 1, params, small_clients[0], batch_size=20,
                  epochs=1, seed=2)
    got = engine.result("0", 1, other, small_clients[0], batch_size=20,
                        epochs=1, seed=2)
    want = task.local_train(other, small_clients[0], batch_size=20,
                            epochs=1, seed=2)
    assert _max_err(want, FlatModel.pack(got, task.flat_spec).tree) < 5e-4
    assert engine.fallbacks == 1


def test_lookup_identity_then_value(task, small_clients):
    """Results are keyed by the identity of the submitted params; an equal
    copy (a racing aggregator's numerically equal θ) still hits the cache
    by value, and a changed hyperparameter does not."""
    params = task.init_params(0)
    copy = tree_map(lambda l: l.clone(), params)
    engine = BatchedEngine(task)
    engine.plan_cohort(1, ["0", "1", "ghost"], params, batch_size=20,
                       epochs=1, seed=4)
    assert engine._queue == []                       # no client registered
    engine.register_client("0", small_clients[0])
    engine.register_client("1", small_clients[1])
    engine.plan_cohort(1, ["0", "1", "ghost"], params, batch_size=20,
                       epochs=1, seed=4)
    assert [j.node_id for j in engine._queue] == ["0", "1"]
    a = engine.result("0", 1, params, small_clients[0], batch_size=20,
                      epochs=1, seed=4)
    assert engine.flushes == 1 and engine.jobs_run == 2   # both 2-steppers
    b = engine.result("1", 1, copy, small_clients[1], batch_size=20,
                      epochs=1, seed=4)
    assert engine.jobs_run == 2                      # value hit: no new job
    assert isinstance(a, FlatModel) and isinstance(b, FlatModel)
    engine.submit("0", 2, params, small_clients[0], batch_size=20,
                  epochs=1, seed=4)
    c = engine.result("0", 2, params, small_clients[0], batch_size=20,
                      epochs=1, seed=5)
    # a demand with another seed never takes the cached seed-4 result: it
    # is trained alone on the sequential path, same math
    assert engine.jobs_run == 3 and isinstance(c, dict)
    want = task.local_train(params, small_clients[0], batch_size=20,
                            epochs=1, seed=5)
    assert _max_err(want, c) == 0.0


def test_stale_round_jobs_are_pruned(task, small_clients):
    engine = BatchedEngine(task)
    params = task.init_params(0)
    engine.submit("0", 1, params, small_clients[0], batch_size=20,
                  epochs=1, seed=1)
    engine.submit("0", 3, params, small_clients[0], batch_size=20,
                  epochs=1, seed=3)
    assert [j.tag for j in engine._queue] == [3]
    # plans more than a few rounds stale are dropped by _gc
    engine.register_client("9", small_clients[1])
    engine.plan_cohort(4, ["9"], params, batch_size=20, epochs=1, seed=0)
    engine.submit("0", 20, params, small_clients[0], batch_size=20,
                  epochs=1, seed=0)
    assert sorted(j.tag for j in engine._queue) == [20]


def test_evaluate_many_matches_evaluate(task):
    test = _clients((100,), seed=3)[0]
    models = [task.init_params(s) for s in range(3)]
    many = BatchedEngine(task).evaluate_models(
        [models[0], FlatModel.pack(models[1], task.flat_spec), models[2]],
        test)
    for p, m in zip(models, many):
        one = SequentialEngine(task).evaluate_models([p], test)[0]
        for k in one:
            assert abs(one[k] - m[k]) < 2e-3, (k, one[k], m[k])


def test_engine_aggregate_paths_agree(task):
    models = [task.init_params(s) for s in range(4)]
    flat = BatchedEngine(task).aggregate(models)
    tree = SequentialEngine(task).aggregate(models)
    assert isinstance(flat, FlatModel) and isinstance(tree, dict)
    assert _max_err(flat.tree, tree) < 1e-6


def test_make_engine_selection(task):
    assert isinstance(make_engine(None, task, device="cpu"), BatchedEngine)
    assert isinstance(make_engine(None, AbstractTask(1000), device="cpu"),
                      SequentialEngine)
    assert isinstance(make_engine("sequential", task, device="cpu"),
                      SequentialEngine)
    assert isinstance(make_engine("batched", AbstractTask(1000),
                                  device="cpu"),
                      SequentialEngine)      # no cohort surface -> fallback
    with pytest.raises(ValueError):
        make_engine("warp", task, device="cpu")
    # "sharded" on one device (the CPU here) falls back to the batched
    # engine, as the reference's does (tests/test_torch_sharded.py)
    assert type(make_engine("sharded", task, device="cpu")) is BatchedEngine
    assert isinstance(make_engine("sharded", AbstractTask(1000),
                                  device="cpu"), SequentialEngine)
    with pytest.raises(ValueError, match="lives on"):
        make_engine(None, task, device="meta")


def test_port_batched_matches_reference_batched():
    """Same params (from the reference's init), same shards, same seeds:
    the port's batched engine against the reference's, rtol=atol=1e-5."""
    jtask = jax_cnn_task(cnn_image=IMAGE)
    ttask = cnn_task(device="cpu", cnn_image=IMAGE)
    jparams = jtask.init_params(0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    sizes = (25, 40, 15)
    jclients = _clients(sizes, cls=JClient)
    tclients = _clients(sizes)
    jeng, teng = JBatchedEngine(jtask), BatchedEngine(ttask)
    for i, c in enumerate(jclients):
        jeng.submit(str(i), 1, jparams, c, batch_size=20, epochs=1, seed=11)
    jgot = [jeng.result(str(i), 1, jparams, c, batch_size=20, epochs=1,
                        seed=11) for i, c in enumerate(jclients)]
    tgot = _train_cohort(teng, tparams, tclients)
    assert (teng.flushes, teng.jobs_run) == (jeng.flushes, jeng.jobs_run)
    for j, t in zip(jgot, tgot):
        np.testing.assert_allclose(t.buffer.numpy(), np.asarray(j.buffer),
                                   rtol=1e-5, atol=1e-5)
    # and their aggregates
    jagg = jeng.aggregate(jgot, [1.0, 2.0, 0.5])
    tagg = teng.aggregate(tgot, [1.0, 2.0, 0.5])
    np.testing.assert_allclose(tagg.buffer.numpy(), np.asarray(jagg.buffer),
                               rtol=1e-5, atol=1e-5)
