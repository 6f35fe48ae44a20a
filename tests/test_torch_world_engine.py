"""The sharded engine across ranks: ``MeshEngine`` in a 4-rank world.

``tests/sharded_child.py``'s session (the paper CNN on 8 nodes in cohorts
of 3) runs on a 4-rank gloo world, plain and masked, through
``make_engine("sharded")``: every rank runs the session's event loop and
holds the lane chunk (``shard_align``) of the ``(S, N)`` parameter and
optimizer-state buffers; a step gathers the parameters and updates the
rank's chunk; aggregation runs on each rank's chunk and is gathered.

Held bit for bit to the port's batched engine in this process: rounds,
round times, bytes, history, every aggregation's mean, the final model,
and the fused aggregate→quantize mean, codes and scales of
``sharded_child.fingerprint``'s five models, plain and masked. Held to the
reference's batched session (from the reference's initial weights, which
the port's runs start from too) within the session tolerance of
``test_torch_session.py``: the event trajectory exactly, accuracy and loss
at every evaluated round within 0.02.
"""

import jax
import numpy as np
import pytest
import torch

import torch_world_bodies as bodies
from repro.config import ModestConfig as JModestConfig
from repro.config import TrainConfig as JTrainConfig
from repro.data import make_classification_task as j_make_classification_task
from repro.models.tasks import cnn_task as jax_cnn_task
from repro.sim.runner import ModestSession as JModestSession
from repro_torch.engine import BatchedEngine
from repro_torch.kernels.fused import shard_align
from repro_torch.launch.world import run_world
from test_torch_threads import one_torch_thread  # noqa: F401

DURATION = 30.0
RANKS = 4


@pytest.fixture(scope="module")
def runs():
    """The reference's batched session, the port's batched sessions and a
    4-rank world's sharded sessions, plain and masked, all from the
    reference's initial weights."""
    ref, init = {}, None
    for secure_agg in (None, "masked"):
        jsess = JModestSession(
            n_nodes=8, mcfg=JModestConfig(n_nodes=8, sample_size=3,
                                          n_aggregators=1,
                                          secure_agg=secure_agg),
            tcfg=JTrainConfig(batch_size=10, seed=0), task=jax_cnn_task(),
            data=j_make_classification_task(8, seed=0), seed=0,
            eval_every_rounds=5, engine="batched")
        init = jax.tree.map(np.asarray, jsess.task.init_params(0))
        ref[secure_agg] = jsess.run(DURATION)
    world = run_world(bodies.session_body, RANKS,
                      args=(init, (None, "masked"), DURATION),
                      device="cpu", threads=1, quiet=True, timeout=170.0)
    local = {}
    for secure_agg in (None, "masked"):
        session = bodies.cnn_session("batched", secure_agg, init)
        assert type(session.engine) is BatchedEngine
        means = []
        for name in ("aggregate", "aggregate_masked"):
            inner = getattr(session.engine, name)

            def call(*a, _inner=inner, **kw):
                got = _inner(*a, **kw)
                means.append(got.buffer.clone())
                return got

            setattr(session.engine, name, call)
        res = session.run(DURATION)
        plain, masked = bodies.quantized_aggregates(session.task, None)
        local[secure_agg] = (session, res, means, plain, masked)
    return ref, world, local


@pytest.mark.parametrize("case", [0, 1], ids=["plain", "masked"])
def test_world_session_equals_batched_bit_for_bit(runs, case):
    _, world, local = runs
    session, res, means, plain, masked = local[(None, "masked")[case]]
    last = max(session._eval_models)
    spec = session.task.flat_spec
    local_n = shard_align(spec.n, RANKS) // RANKS
    for rank in world:
        got = rank[case]
        assert got["n_shards"] == RANKS and got["flushes"] > 0
        assert got["rounds"] == res.rounds_completed >= 5
        assert got["round_times"] == res.round_times
        assert got["total_bytes"] == res.usage["total_bytes"]
        assert got["history"] == res.history
        # the optimizer state a rank holds: its lane chunk alone
        assert got["state_lanes"] and all(
            s == (3, local_n) for s in got["state_lanes"].values())
        assert local_n * RANKS < 2 * spec.n
        assert got["digest"] == world[0][case]["digest"]
    t = world[0][case]["tensors"]
    assert torch.equal(t["final"], session._eval_models[last].buffer)
    assert len(t["means"]) == len(means) > 0
    for g, w in zip(t["means"], means):
        assert torch.equal(g, w)
    for got, want in zip(t["plain"] + t["masked"], plain + masked):
        assert torch.equal(got, want)
    for got, want in zip(t["masked"], t["plain"]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", [0, 1], ids=["plain", "masked"])
def test_world_session_within_tolerance_of_reference(runs, case):
    refs, world, _ = runs
    ref = refs[(None, "masked")[case]]
    got = world[0][case]
    assert got["rounds"] == ref.rounds_completed
    assert got["total_bytes"] == ref.usage["total_bytes"]
    assert got["round_times"] == ref.round_times
    assert len(got["history"]) == len(ref.history) > 0
    for h, w in zip(got["history"], ref.history):
        assert h.keys() == w.keys()
        for k in w:
            if k in ("accuracy", "loss"):
                assert abs(h[k] - w[k]) < 0.02, (k, h, w)
            else:
                assert h[k] == w[k], (k, h, w)
