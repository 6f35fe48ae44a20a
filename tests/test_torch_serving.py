"""The serving fabric of the PyTorch package (``repro_torch.serve``): the
cases of ``test_serve.py`` mirrored on the port, held to the reference.

The unit layer drives one replica directly on a Simulator + Network pair,
the same script in both packages, and compares their counters and
responses exactly. The integration layer attaches deployments to the
port's sessions: ``SessionResult.serving`` equals the reference's dict
exactly at the same seed, and with the checkpoint spool the served
parameters are bit-equal to the training side's at the installed round.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.messages as JM
import repro.serve as jserve
import repro.sim.clock as jclock
import repro.sim.network as jnetwork
import repro.sim.runner as jrunner
import repro.traces as jtraces
import repro_torch.core.messages as TM
import repro_torch.serve as tserve
import repro_torch.sim.clock as tclock
import repro_torch.sim.network as tnetwork
import repro_torch.sim.runner as trunner
import repro_torch.traces as ttraces
from repro_torch.serve import (SERVE_REGIMES, MethodConfig,
                               RequestLoadDriver, ServeConfig)
from repro_torch.sim.runner import DSGDSession, GossipSession, ModestSession
from repro_torch.traces import diurnal_profile
from test_torch_threads import one_torch_thread  # noqa: F401

PKGS = {"ref": (JM, jserve, jclock, jnetwork),
        "port": (TM, tserve, tclock, tnetwork)}
SESSIONS = ("ModestSession", "DSGDSession", "GossipSession")

# ------------------------------------------------------------- unit harness


class _Sink:
    """Query-client stand-in: records every response delivered to it."""

    def __init__(self, node_id):
        self.node_id = node_id
        self.online = True
        self.got = []

    def receive(self, msg):
        self.got.append(msg)


class _Fabric:
    frontier = 0

    def load_snapshot(self, msg):
        return msg.model


class _Rig:
    """One replica and one sink on a fresh simulator, in package ``pkg``."""

    def __init__(self, pkg, speed=0.05, **method):
        self.M, serve, clock, network = PKGS[pkg]
        self.sim = clock.Simulator()
        net = network.Network(self.sim, 4, contention=False)
        self.sink = _Sink("0")
        net.register(self.sink)
        self.rep = serve.ServingReplica("1", self.sim, net,
                                        (serve.MethodConfig(**method),),
                                        speed, _Fabric())
        net.register(self.rep)

    def snapshot(self, k):
        self.rep.receive(self.M.SnapshotMsg(
            sender="0", round_k=k, model=self.M.ModelPayload(nbytes=1000)))

    def request(self, t, i, method="predict"):
        msg = self.M.RequestMsg(sender="0", req_id=i, method=method)
        self.sim.schedule(t, lambda: self.rep.receive(msg))

    def outcome(self):
        r = self.rep
        return {"dropped": [(m.req_id, m.dropped, m.round_k)
                            for m in self.sink.got],
                "counters": (r.dropped_admission, r.dropped_deadline,
                             r.dropped_unloaded, r.batches, r.items_served,
                             r.snapshots_installed,
                             r.stale_snapshots_dropped, r.round),
                "installs": r.install_log, "now": self.sim.now}


def _both(script, speed=0.05, **method):
    """Run ``script(rig)`` in both packages; the port's outcome must equal
    the reference's. Returns the port's rig."""
    out = {}
    for pkg in ("ref", "port"):
        rig = _Rig(pkg, speed, **method)
        script(rig)
        out[pkg] = (rig, rig.outcome())
    assert out["port"][1] == out["ref"][1]
    return out["port"][0]


def test_unloaded_rejection():
    def script(rig):
        rig.request(0.0, 0)
        rig.sim.run(10.0)

    rig = _both(script)
    assert rig.rep.dropped_unloaded == 1
    assert [m.dropped for m in rig.sink.got] == ["unloaded"]


def test_admission_drop_beyond_queue_depth():
    def script(rig):
        rig.snapshot(1)
        for i in range(12):  # 4 dispatch immediately, 4 queue, 4 rejected
            rig.request(0.0, i)
        rig.sim.run(30.0)

    rig = _both(script, max_batch=4, max_queue=4, batch_wait_s=0.01)
    assert rig.rep.dropped_admission == 4
    assert rig.rep.items_served == 8
    assert len([m for m in rig.sink.got if not m.dropped]) == 8


def test_deadline_drop_while_busy():
    # batch runs ~1.2 s; the two overflow requests expire at 0.1 s
    def script(rig):
        rig.snapshot(1)
        for i in range(4):
            rig.request(0.0, i)
        rig.sim.run(30.0)

    rig = _both(script, speed=1.0, max_batch=2, deadline_s=0.1,
                cost_base=1.0, cost_per_item=0.1)
    assert rig.rep.dropped_deadline == 2
    assert rig.rep.items_served == 2
    assert sorted(m.dropped for m in rig.sink.got) == ["", "", "deadline",
                                                       "deadline"]


def test_batching_never_exceeds_max_batch():
    def script(rig):
        rig.snapshot(1)
        for i in range(17):
            rig.request(0.001 * i, i)
        rig.sim.run(60.0)

    rig = _both(script, max_batch=3, max_queue=64, batch_wait_s=0.02)
    assert rig.rep.items_served == 17
    assert rig.rep.batches >= -(-17 // 3)               # >= ceil(17/3)
    assert rig.rep.items_served <= rig.rep.batches * 3


def test_unknown_method_rejected():
    def script(rig):
        rig.snapshot(1)
        rig.request(0.0, 0, method="embed")
        rig.sim.run(10.0)

    rig = _both(script, name="predict")
    assert rig.rep.dropped_admission == 1
    assert [m.dropped for m in rig.sink.got] == ["admission"]


def test_snapshot_install_is_monotone():
    def script(rig):
        rig.snapshot(3)
        rig.snapshot(2)           # reordered/duplicated late copy
        assert rig.rep.round == 3 and rig.rep.stale_snapshots_dropped == 1
        rig.snapshot(5)

    rig = _both(script)
    assert rig.rep.round == 5
    assert rig.rep.snapshots_installed == 2
    assert [k for k, _ in rig.rep.install_log] == [3, 5]


def test_replica_routing_order():
    class _Net:
        def latency(self, src, dst):
            return {"10": 0.5, "11": 0.05, "12": 0.2}[dst]

    sim = tclock.Simulator()
    reps = [_Sink("10"), _Sink("11"), _Sink("12")]
    client = _Sink("0")
    near = RequestLoadDriver(sim, ServeConfig(routing="nearest"),
                             [client], reps, _Net(), seed=0)
    assert near._replica_order(client) == ["11", "12", "10"]
    rr = RequestLoadDriver(sim, ServeConfig(routing="round_robin"),
                           [client], reps, _Net(), seed=0)
    assert rr._replica_order(client) == ["10", "11", "12"]


# ------------------------------------------------------------- integration


def _serve_session(name="ModestSession", cfg=None, n=16, seed=1,
                   duration=120.0, pkg="port"):
    """A diurnal session with a deployment; ``cfg`` is a function of the
    package's serve module (the default: ``ServeConfig()``)."""
    runner, serve, traces = ((trunner, tserve, ttraces) if pkg == "port"
                             else (jrunner, jserve, jtraces))
    kw = {"device": "cpu"} if pkg == "port" else {}
    sess = getattr(runner, name)(
        profile=traces.diurnal_profile(n=n, seed=seed),
        serve=(cfg or (lambda s: s.ServeConfig()))(serve), **kw)
    res = sess.run(duration)
    return sess, res


@pytest.mark.parametrize("name", SESSIONS)
def test_serve_end_to_end(name):
    sess, res = _serve_session(name)
    _, ref = _serve_session(name, pkg="ref")
    s = res.serving
    assert s == ref.serving                       # exact, every key
    assert res.round_times == ref.round_times
    assert s["requests"] > 0
    assert s["served"] > 0
    assert s["lost"] == 0
    assert s["p50_latency_s"] is not None
    assert s["p99_latency_s"] >= s["p50_latency_s"]
    assert s["snapshots_published"] >= 1
    assert s["snapshot_bytes"] > 0
    assert s["staleness_mean_rounds"] is not None
    # every replica eventually holds some published round
    assert all(r >= 1 for r in s["replica_rounds"])


def test_serving_metrics_deterministic():
    _, r1 = _serve_session(duration=90.0)
    _, r2 = _serve_session(duration=90.0)
    assert r1.serving == r2.serving


@pytest.mark.parametrize("name", SESSIONS)
def test_serve_none_is_structurally_absent(name):
    sess = getattr(trunner, name)(profile=diurnal_profile(n=8, seed=0),
                                  serve=None, device="cpu")
    assert sess.serving is None
    assert {n.node_id for n in sess.net.nodes.values()} == set(sess.nodes)
    res = sess.run(30.0)
    assert res.serving is None


def test_flash_crowd_regime():
    cfg = lambda s: s.SERVE_REGIMES["flash_crowd"](16, 1, 120.0)  # noqa
    sess, res = _serve_session(cfg=cfg)
    s = res.serving
    assert s == _serve_session(cfg=cfg, pkg="ref")[1].serving
    assert s["requests"] > 0 and s["served"] > 0
    assert s["p99_latency_s"] is not None
    # higher per-client rate than the steady regime at the same scale
    steady = _serve_session(
        cfg=lambda s: s.SERVE_REGIMES["steady"](16, 1, 120.0))[1]
    assert s["requests"] > steady.serving["requests"]
    assert set(SERVE_REGIMES) == set(jserve.SERVE_REGIMES)


def test_nearest_routing_session():
    cfg = lambda s: s.ServeConfig(routing="nearest", n_replicas=3)  # noqa
    sess, res = _serve_session(cfg=cfg, duration=90.0)
    assert res.serving["served"] > 0
    assert res.serving == _serve_session(cfg=cfg, duration=90.0,
                                         pkg="ref")[1].serving


def test_publish_every_thins_snapshots():
    sess, res = _serve_session(cfg=lambda s: s.ServeConfig(publish_every=5))
    s = res.serving
    rounds = [k for k, _ in sess.serving.replicas[0].install_log]
    assert all(k == 1 or k % 5 == 0 for k in rounds)
    assert s["frontier_round"] > max(rounds) - 5 - 1


def test_serve_config_validation():
    with pytest.raises(ValueError):
        ServeConfig(n_replicas=0)
    with pytest.raises(ValueError):
        ServeConfig(publish_every=0)
    with pytest.raises(ValueError):
        ServeConfig(routing="random")
    with pytest.raises(ValueError):
        MethodConfig(max_batch=0)
    with pytest.raises(ValueError):
        MethodConfig(deadline_s=0.0)


def test_scenario_matrix_serve_axis():
    import repro.eval as jeval
    from repro_torch.eval import scenario_matrix
    kw = dict(algos=("modest", "dsgd"), regimes=("diurnal",),
              serve=(None, "steady"), n=12, seeds=(0,), duration=60.0)
    out = scenario_matrix(device="cpu", **kw)
    ref = jeval.scenario_matrix(**kw)
    wall = ("wall_s", "events_per_s")
    assert [{k: v for k, v in r.items() if k not in wall}
            for r in out["rows"]] == [
        {k: v for k, v in r.items() if k not in wall} for r in ref["rows"]]
    assert (out["summary"], out["ratios"]) == (ref["summary"], ref["ratios"])
    served_rows = [r for r in out["rows"] if r.get("serve") == "steady"]
    assert len(served_rows) == 2
    for row in served_rows:
        assert row["requests"] > 0
        assert row["p50_latency_s"] is not None
        assert row["p99_latency_s"] is not None
        assert row["snapshot_mb"] > 0
    assert "diurnal+serve:steady" in out["ratios"]
    assert "diurnal" in out["ratios"]


# ----------------------------------------------- checkpoint spool round-trip


def test_snapshot_spool_restore_equivalence(tmp_path):
    """Snapshot-publish → replica-restore equivalence: with the spool
    enabled the served model is exactly the training-side model at the
    replica's installed round (leaf-wise bit-equal, on the training side's
    device, identical eval); the spool changes no served metric; and
    ``restore_shardings`` moves the restored leaves."""
    from repro_torch.config import ModestConfig, TrainConfig
    from repro_torch.data import make_classification_task
    from repro_torch.engine.flat import as_tree
    from repro_torch.models.tasks import cnn_task
    from repro_torch.utils.pytree import tree_leaves, tree_map

    n = 8
    task = cnn_task(device="cpu")
    data = make_classification_task(n, samples_per_node=20, iid=True, seed=0)

    def session(spool_dir):
        cfg = ServeConfig(n_replicas=1, rate_per_client=0.02,
                          spool_dir=spool_dir)
        return ModestSession(
            n_nodes=n, mcfg=ModestConfig(n_nodes=n, sample_size=3,
                                         n_aggregators=1,
                                         success_fraction=1.0),
            tcfg=TrainConfig(batch_size=10), task=task, data=data, seed=0,
            serve=cfg, device="cpu")

    sess = session(str(tmp_path))
    # record the training-side params the session hands to the fabric
    recorded = {}
    fabric = sess.serving
    orig_on_round = fabric.on_round

    def on_round(k, params, src):
        if params is not None:
            recorded[k] = tree_map(torch.clone, as_tree(params))
        orig_on_round(k, params, src)

    fabric.on_round = on_round
    res = sess.run(30.0)

    replica = fabric.replicas[0]
    assert replica.round >= 1
    assert replica.round in recorded, (replica.round, sorted(recorded))
    served = replica.params.params
    train_side = recorded[replica.round]
    s_leaves, t_leaves = tree_leaves(served), tree_leaves(train_side)
    assert len(s_leaves) == len(t_leaves)
    for s, t in zip(s_leaves, t_leaves):
        assert s.device == t.device and s.dtype == t.dtype
        assert torch.equal(s, t)
    # and the served model evaluates identically to the training frontier
    assert task.evaluate(served, data.test) == task.evaluate(train_side,
                                                             data.test)
    spooled = sorted(p.name for p in tmp_path.glob("round_*.npz"))
    assert len(spooled) == fabric.snapshots_published
    assert f"round_{replica.round:06d}.npz" in spooled
    # the spool is transparent: the same session without it serves alike
    plain = session(None).run(30.0)
    assert plain.serving == res.serving
    assert plain.round_times == res.round_times
    # restore_shardings is threaded into checkpoint.restore
    fabric.cfg = dataclasses.replace(fabric.cfg, restore_shardings="meta")
    moved = fabric.load_snapshot(TM.SnapshotMsg(
        sender="0", round_k=replica.round,
        model=TM.ModelPayload(params=served)))
    assert all(x.is_meta for x in tree_leaves(moved.params))
    assert np.isfinite(res.final_metrics["loss"])
