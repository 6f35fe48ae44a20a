"""The PyTorch package's ``MeshEngine`` on the CPU: a MoDeST session with
the engine mesh as 4 chunks of the CPU (the counterpart of a session on 4
cards) reproduces the batched engine's, plain and masked.

A mesh here is a tuple of devices, and one device may stand in it k times:
k chunks of the CPU run the very code that k cards would. The rest of the
sharded path is held in ``test_torch_sharded.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.data import make_classification_task
from repro_torch.engine import BatchedEngine, FlatModel, MeshEngine
from repro_torch.kernels import KERNELS
from repro_torch.kernels.ops import aggregate_flatmodel
from repro_torch.models.tasks import cnn_task
from repro_torch.sim.runner import ModestSession
from test_torch_threads import one_torch_thread  # noqa: F401


def _cpu_mesh(k):
    return (torch.device("cpu"),) * k


# ---------------------------------------------------------------------------
# a MeshEngine session against the batched engine
# ---------------------------------------------------------------------------


def _cnn_session(engine, secure_agg, monkeypatch=None, chunks=4):
    """8 nodes of the paper CNN in cohorts of 3, on the CPU; with
    ``engine="sharded"`` the engine mesh is ``chunks`` chunks of the CPU."""
    if monkeypatch is not None:
        import repro_torch.launch.mesh as lm
        monkeypatch.setattr(lm, "make_engine_mesh",
                            lambda device=None: _cpu_mesh(chunks))
    n = 8
    return ModestSession(
        n_nodes=n, mcfg=ModestConfig(n_nodes=n, sample_size=3,
                                     n_aggregators=2, success_fraction=1.0,
                                     ping_timeout=1.0, secure_agg=secure_agg),
        tcfg=TrainConfig(batch_size=20), task=cnn_task(device="cpu"),
        data=make_classification_task(n, samples_per_node=30, iid=False,
                                      alpha=0.5, seed=0),
        seed=0, eval_every_rounds=5, engine=engine, device="cpu")


def _record(engine):
    calls = []
    for name in ("aggregate", "aggregate_masked"):
        inner = getattr(engine, name)

        def call(*a, _inner=inner, **kw):
            out = _inner(*a, **kw)
            calls.append(out)
            return out

        setattr(engine, name, call)
    return calls


@pytest.mark.parametrize("secure_agg", [None, "masked"])
def test_mesh_engine_session_equals_batched(secure_agg, monkeypatch):
    """``ModestSession(engine="sharded")`` on a mesh of 4 CPU chunks builds
    a ``MeshEngine``, and its session equals the batched engine's: rounds,
    bytes and history, every aggregate, the final model, and the codes and
    scales of a quantised aggregation of the last cohort, bit for bit."""
    batched = _cnn_session("batched", secure_agg)
    sharded = _cnn_session("sharded", secure_agg, monkeypatch)
    assert type(batched.engine) is BatchedEngine
    assert isinstance(sharded.engine, MeshEngine)
    assert sharded.engine.shardings.n_shards == 4
    got_calls, want_calls = _record(sharded.engine), _record(batched.engine)
    rb, rs = batched.run(20.0), sharded.run(20.0)
    assert rs.rounds_completed == rb.rounds_completed >= 5
    assert rs.usage["total_bytes"] == rb.usage["total_bytes"]
    assert rs.round_times == rb.round_times and rs.history == rb.history
    assert len(got_calls) == len(want_calls) > 0
    for got, want in zip(got_calls, want_calls):
        assert torch.equal(got.buffer, want.buffer)
    last = max(batched._eval_models)
    assert torch.equal(sharded._eval_models[last].buffer,
                       batched._eval_models[last].buffer)
    assert not any(k["wrapper"].launches for k in KERNELS.values())

    spec = sharded.task.flat_spec
    rng = np.random.default_rng(0)
    models = [FlatModel(torch.from_numpy(rng.standard_normal(spec.n).astype(
        np.float32)), spec) for _ in range(5)]
    weights = list(rng.random(5) + 0.1)
    quantized = [aggregate_flatmodel(models, weights, spec=spec,
                                     quantize=True, device="cpu",
                                     shardings=getattr(e, "shardings", None))
                 for e in (sharded.engine, batched.engine)]
    for got, want in zip(*quantized):
        assert torch.equal(getattr(got, "buffer", got),
                           getattr(want, "buffer", want))
