"""Sessions of the PyTorch package: the host-side copies of the simulator
and the protocol core reproduce the reference's pinned golden trajectories
byte for byte, the CNN session agrees with the reference's, a serving
deployment attaches its fabric, and the sharded engine falls back to the
batched session on one device, as the reference's does.
Secure aggregation is held in ``test_torch_secureagg.py``."""

import hashlib
import json

import jax
import numpy as np
import pytest

from repro.config import ModestConfig as JModestConfig
from repro.config import TrainConfig as JTrainConfig
from repro.data import make_classification_task as j_make_classification_task
from repro.models.tasks import cnn_task as jax_cnn_task
from repro.sim.runner import ModestSession as JModestSession
from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.data import make_classification_task
from repro_torch.engine.flat import params_from_numpy
from repro_torch.models.tasks import cnn_task
from repro_torch.sim.runner import (DSGDSession, GossipSession, ModestSession,
                                    fedavg_session)
from repro_torch.traces import diurnal_profile
from test_determinism import GOLDEN as REF_GOLDEN
from test_torch_threads import one_torch_thread  # noqa: F401

SESSIONS = {"ModestSession": ModestSession, "DSGDSession": DSGDSession,
            "GossipSession": GossipSession}
GOLDEN = {cls.__name__: v for cls, v in REF_GOLDEN.items()}


def _fingerprint(result) -> str:
    blob = json.dumps({"rt": result.round_times, "hist": result.history,
                       "usage": result.usage, "churn": result.churn_events},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _got(res):
    return (res.rounds_completed, res.usage["total_bytes"], _fingerprint(res))


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_golden_seed_snapshot(name):
    sess = SESSIONS[name](profile=diurnal_profile(n=24, seed=3), device="cpu")
    assert _got(sess.run(180.0)) == GOLDEN[name]


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_heap_queue_matches_golden(name, monkeypatch):
    import repro_torch.sim.runner as runner_mod
    from repro_torch.sim.clock import Simulator

    monkeypatch.setattr(runner_mod, "Simulator",
                        lambda: Simulator(queue="heap"))
    sess = SESSIONS[name](profile=diurnal_profile(n=24, seed=3), device="cpu")
    assert _got(sess.run(180.0)) == GOLDEN[name]


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_larger_population_matches_reference_run(name):
    """A 64-node, 240 s run with fault and serve off against the same run
    of the reference package, made here side by side."""
    import repro.sim.runner as jrunner
    from repro.traces import diurnal_profile as j_diurnal_profile

    ref = getattr(jrunner, name)(
        profile=j_diurnal_profile(n=64, seed=5)).run(240.0)
    sess = SESSIONS[name](profile=diurnal_profile(n=64, seed=5), fault=None,
                          serve=None, device="cpu")
    res = sess.run(240.0)
    assert _got(res) == _got(ref) and res.rounds_completed > 3
    assert res.train_node_seconds == ref.train_node_seconds
    assert res.serving is None and res.fault_stats == {}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_same_seed_same_trajectory(name):
    def run():
        sess = SESSIONS[name](profile=diurnal_profile(n=16, seed=1),
                              device="cpu")
        res = sess.run(150.0)
        return (_fingerprint(res), res.rounds_completed,
                round(res.train_node_seconds, 9))

    assert run() == run()


def test_fedavg_and_fault_schedule_match_reference():
    """The fixed-aggregator emulation and a fault-injected run give the
    reference's trajectory (same seeds, byte-only task)."""
    from repro.sim.fault import Drop as JDrop
    from repro.sim.fault import FaultSchedule as JFaultSchedule
    from repro.sim.runner import fedavg_session as j_fedavg_session
    from repro.traces import diurnal_profile as j_diurnal_profile
    from repro_torch.sim.fault import Drop, FaultSchedule

    ref = j_fedavg_session(profile=j_diurnal_profile(n=16, seed=2)).run(120.0)
    got = fedavg_session(profile=diurnal_profile(n=16, seed=2),
                         device="cpu").run(120.0)
    assert _got(got) == _got(ref)
    ref = JModestSession(profile=j_diurnal_profile(n=16, seed=2),
                         fault=JFaultSchedule(rules=(JDrop(p=0.1),),
                                              seed=7)).run(120.0)
    got = ModestSession(profile=diurnal_profile(n=16, seed=2),
                        fault=FaultSchedule(rules=(Drop(p=0.1),), seed=7),
                        device="cpu").run(120.0)
    assert _got(got) == _got(ref) and got.fault_stats == ref.fault_stats
    assert got.fault_stats


def _cnn_session(pkg, engine, init=None):
    n = 6
    if pkg == "torch":
        task = cnn_task(device="cpu")
        if init is not None:            # start from the reference's weights
            task.init_params = lambda seed=0: params_from_numpy(init, "cpu")
        return ModestSession(
            n_nodes=n, mcfg=ModestConfig(n_nodes=n, sample_size=3,
                                         n_aggregators=2,
                                         success_fraction=1.0,
                                         ping_timeout=1.0),
            tcfg=TrainConfig(batch_size=20), task=task,
            data=make_classification_task(n, samples_per_node=30, iid=False,
                                          alpha=0.5, seed=0),
            seed=0, eval_every_rounds=5, engine=engine, device="cpu")
    return JModestSession(
        n_nodes=n, mcfg=JModestConfig(n_nodes=n, sample_size=3,
                                      n_aggregators=2, success_fraction=1.0,
                                      ping_timeout=1.0),
        tcfg=JTrainConfig(batch_size=20), task=jax_cnn_task(),
        data=j_make_classification_task(n, samples_per_node=30, iid=False,
                                        alpha=0.5, seed=0),
        seed=0, eval_every_rounds=5, engine=engine)


def test_cnn_session_matches_reference_and_engines_agree():
    """The CNN session of the reference's engine test, at full width on
    the CPU, started from the reference's initial weights (init bits are
    not shared across packages): the port's event trajectory (rounds,
    bytes, round times) equals the reference's exactly, and accuracy at
    every evaluated round is within 0.02, batched and sequential alike."""
    jsess = _cnn_session("jax", "batched")
    init = jax.tree.map(np.asarray, jsess.task.init_params(0))
    ref = jsess.run(25.0)
    sess = _cnn_session("torch", "batched", init)
    rb = sess.run(25.0)
    rs = _cnn_session("torch", "sequential", init).run(25.0)
    assert rb.rounds_completed == rs.rounds_completed == ref.rounds_completed
    assert rb.usage["total_bytes"] == rs.usage["total_bytes"] \
        == ref.usage["total_bytes"]
    assert rb.round_times == ref.round_times
    assert sess.engine.jobs_run > 0 and sess.engine.flushes > 0
    acc = {}
    for key, res in (("b", rb), ("s", rs), ("ref", ref)):
        acc[key] = {h["round"]: h["accuracy"] for h in res.history
                    if "accuracy" in h}
    assert acc["b"].keys() == acc["s"].keys() == acc["ref"].keys() and acc["b"]
    for k in acc["b"]:
        assert abs(acc["b"][k] - acc["s"][k]) < 0.02, (k, acc)
        assert abs(acc["b"][k] - acc["ref"][k]) < 0.02, (k, acc)
    assert abs(rb.final_metrics["loss"] - ref.final_metrics["loss"]) < 0.02


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_serve_attaches_a_fabric_and_sharded_runs_batched(name):
    """A ``ServeConfig`` attaches a ``ServingFabric`` (replica and client
    endpoints on the session's network), ``serve=None`` builds nothing,
    and ``engine="sharded"`` on one device runs the batched session: the
    same engine selection and the same trajectory."""
    from repro_torch.serve import ServeConfig, ServingFabric

    cls = SESSIONS[name]
    kw = dict(profile=diurnal_profile(n=8, seed=0), device="cpu")
    sess = cls(serve=ServeConfig(n_replicas=3), **kw)
    assert isinstance(sess.serving, ServingFabric)
    assert [r.node_id for r in sess.serving.replicas] == ["8", "9", "10"]
    assert len(sess.net.nodes) == 8 + 3 + 8     # population, replicas, clients
    sharded = cls(engine="sharded", **kw)
    batched = cls(engine="batched", **kw)
    assert type(sharded.engine) is type(batched.engine)
    assert _got(sharded.run(60.0)) == _got(batched.run(60.0))
    plain = cls(serve=None, **kw)
    assert plain.serving is None and len(plain.net.nodes) == 8
