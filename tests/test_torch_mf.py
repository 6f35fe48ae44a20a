"""The paper's MF task in the PyTorch package against the reference's:
the model, the task's training and evaluation, the stacked cohort
lowering, sessions (plain and masked) and the training launcher.

Parameters are taken from the reference's init through
``params_from_numpy`` (``jax.random`` bits are not reproducible in torch).
Tiers: event trajectories, round times and byte counts exact; losses,
gradients, trained parameters and metrics ``rtol = atol = 1e-5``; the
stacked lowering against per-model autograd in the port ``1e-6``.
"""

import csv
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.runner as jrunner
from repro.config import ModestConfig as JModestConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.data import make_mf_task as j_make_mf_task
from repro.launch import train as jtrain
from repro.models import mf as jmf
from repro.models.tasks import mf_task as jax_mf_task
from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import make_mf_task
from repro_torch.engine.flat import params_from_numpy, params_to_numpy
from repro_torch.engine.lowering import stacked_grads_for, stacked_metrics_for
from repro_torch.launch import train
from repro_torch.models import build
from repro_torch.models import mf
from repro_torch.models.tasks import mf_task
from repro_torch.sim.runner import ModestSession
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
USERS, ITEMS = 16, 120


def _jparams(seed=0, **cfg):
    task = jax_mf_task(mf_users=USERS, mf_items=ITEMS, **cfg)
    return jax.tree.map(np.asarray, task.init_params(seed))


def _perturbed(seed):
    """Reference init with random biases and mu, so every leaf matters."""
    p = _jparams(seed)
    rng = np.random.default_rng(seed)
    p["b_user"] = rng.normal(0, 0.3, USERS).astype(np.float32)
    p["b_item"] = rng.normal(0, 0.3, ITEMS).astype(np.float32)
    p["mu"] = np.asarray(2.5 + seed, np.float32)
    return p


def _batch(seed, B=24, masked=True):
    rng = np.random.default_rng(100 + seed)
    pairs = np.stack([rng.integers(0, USERS, B), rng.integers(0, ITEMS, B)],
                     axis=1).astype(np.int32)
    y = rng.uniform(1, 5, B).astype(np.float32)
    mask = (rng.random(B) < 0.7).astype(np.float32) if masked else None
    return pairs, y, mask


def test_config_model_and_layout_match_reference():
    cfg, jcfg = get_config("paper-mf"), j_get_config("paper-mf")
    for f in ("name", "family", "mf_users", "mf_items", "mf_dim",
              "param_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f)
    task = mf_task(device="cpu", mf_users=USERS, mf_items=ITEMS)
    jtask = jax_mf_task(mf_users=USERS, mf_items=ITEMS)
    spec, jspec = task.flat_spec, jtask.flat_spec
    assert (spec.n, spec.offsets, spec.shapes) == \
        (jspec.n, jspec.offsets, jspec.shapes)
    assert spec.nbytes == jspec.nbytes and not spec.has_int
    assert task.tcfg.optimizer == "sgd" and task.tcfg.lr == 0.2
    p = build(cfg.with_(mf_users=USERS, mf_items=ITEMS)).init(
        torch.Generator().manual_seed(0), "cpu")
    assert p["mu"].shape == () and float(p["mu"]) == 3.0
    assert p["users"].shape == (USERS, 20) and p["items"].dtype == torch.float32


@pytest.mark.parametrize("masked", [False, True])
def test_loss_metrics_and_grads_match_reference(masked):
    jp = _perturbed(1)
    pairs, y, mask = _batch(1, masked=masked)
    jbatch = {"x": jnp.asarray(pairs), "y": jnp.asarray(y)}
    tbatch = {"x": torch.from_numpy(pairs), "y": torch.from_numpy(y)}
    if masked:
        jbatch["mask"], tbatch["mask"] = jnp.asarray(mask), \
            torch.from_numpy(mask)
    cfg = get_config("paper-mf")
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmf.loss_fn(p, None, jbatch), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, "cpu").items()}
    tl, tm = mf.loss_fn(tp, cfg, tbatch)
    grads = dict(zip(sorted(tp), torch.autograd.grad(
        tl, [tp[k] for k in sorted(tp)])))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    assert set(tm) == {"loss", "mse"} == set(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), **TOL)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg[k]), **TOL)


def test_local_train_and_evaluate_match_reference():
    data = make_mf_task(USERS, n_items=ITEMS, seed=3)
    jdata = j_make_mf_task(USERS, n_items=ITEMS, seed=3)
    np.testing.assert_array_equal(data.clients[2].x, jdata.clients[2].x)
    task = mf_task(device="cpu", mf_users=USERS, mf_items=ITEMS)
    jtask = jax_mf_task(mf_users=USERS, mf_items=ITEMS)
    jp = _perturbed(2)
    for c in (0, 5):
        got = task.local_train(params_from_numpy(jp, "cpu"), data.clients[c],
                               batch_size=16, epochs=2, seed=c)
        want = jtask.local_train(jax.tree.map(jnp.asarray, jp),
                                 jdata.clients[c], batch_size=16, epochs=2,
                                 seed=c)
        for k, v in params_to_numpy(got).items():
            np.testing.assert_allclose(v, np.asarray(want[k]), **TOL)
    got = task.evaluate(params_from_numpy(jp, "cpu"), data.test)
    want = jtask.evaluate(jax.tree.map(jnp.asarray, jp), jdata.test)
    assert set(got) == set(want) == {"loss", "mse"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    many = task.evaluate_many([params_from_numpy(_perturbed(s), "cpu")
                               for s in (2, 3)], data.test)
    np.testing.assert_allclose(many[0]["mse"], want["mse"], **TOL)


def test_stacked_lowering_equals_per_model_autograd():
    """Three models of different weights, each on its own masked batch:
    the stacked gradient of model s equals autograd of model s's own loss;
    the stacked metrics on a shared batch equal each model's ``loss_fn``."""
    task = mf_task(device="cpu", mf_users=USERS, mf_items=ITEMS)
    trees = [params_from_numpy(_perturbed(s), "cpu") for s in range(3)]
    batches = [_batch(10 + s) for s in range(3)]
    stacked = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    xb = torch.stack([torch.from_numpy(b[0]) for b in batches])
    yb = torch.stack([torch.from_numpy(b[1]) for b in batches])
    mb = torch.stack([torch.from_numpy(b[2]) for b in batches])
    got = stacked_grads_for(task)(stacked, xb, yb, mb)
    for s, tree in enumerate(trees):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tree.items()}
        loss, _ = task.model.loss_fn(leaves, {"x": xb[s], "y": yb[s],
                                              "mask": mb[s]})
        want = torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)])
        for k, g in zip(sorted(leaves), want):
            assert got[k].shape == stacked[k].shape
            torch.testing.assert_close(got[k][s], g, rtol=1e-6, atol=1e-6)
    pairs, y, _ = _batch(20, masked=False)
    shared = {"x": torch.from_numpy(pairs), "y": torch.from_numpy(y)}
    with torch.no_grad():
        ms = stacked_metrics_for(task)(stacked, shared)
        for s, tree in enumerate(trees):
            one = task.model.loss_fn(tree, shared)[1]
            for k in ("loss", "mse"):
                torch.testing.assert_close(ms[k][s], one[k], rtol=1e-6,
                                           atol=1e-6)


def _mf_session(pkg, engine, init=None, secure_agg=None, n=12):
    mkw = dict(n_nodes=n, sample_size=4, n_aggregators=2,
               success_fraction=1.0, ping_timeout=1.0, secure_agg=secure_agg)
    if pkg == "torch":
        task = mf_task(device="cpu", mf_users=n, mf_items=ITEMS)
        if init is not None:            # start from the reference's weights
            task.init_params = lambda seed=0: params_from_numpy(init, "cpu")
        return ModestSession(
            n_nodes=n, mcfg=ModestConfig(**mkw),
            tcfg=TrainConfig(batch_size=20), task=task,
            data=make_mf_task(n, n_items=ITEMS, seed=0), seed=0,
            eval_every_rounds=5, engine=engine, device="cpu")
    return jrunner.ModestSession(
        n_nodes=n, mcfg=JModestConfig(**mkw), tcfg=JTrainConfig(batch_size=20),
        task=jax_mf_task(mf_users=n, mf_items=ITEMS),
        data=j_make_mf_task(n, n_items=ITEMS, seed=0), seed=0,
        eval_every_rounds=5, engine=engine)


@pytest.mark.parametrize("secure_agg", [None, "masked"])
def test_mf_session_trajectory_equals_reference(secure_agg):
    """Rounds, bytes, round times (the order of round completions) and
    every node's aggregation log (and, masked, its unmask log) equal the
    reference's exactly, for the batched and the sequential engine; the MSE
    at every evaluated round within 1e-4 (thirty rounds of float summation
    apart). Sealing takes flat models, which only the batched engine
    hands it, in both packages: the masked session runs batched twice."""
    jsess = _mf_session("jax", "batched", secure_agg=secure_agg)
    init = jax.tree.map(np.asarray, jsess.task.init_params(0))
    ref = jsess.run(30.0)
    sess = _mf_session("torch", "batched", init, secure_agg)
    rb = sess.run(30.0)
    rs = _mf_session("torch", "batched" if secure_agg else "sequential",
                     init, secure_agg).run(30.0)
    assert rb.rounds_completed == rs.rounds_completed == ref.rounds_completed
    assert rb.rounds_completed > 10
    assert rb.usage == rs.usage == ref.usage
    assert rb.round_times == rs.round_times == ref.round_times
    assert rb.trainings_completed == ref.trainings_completed
    assert sess.engine.jobs_run > sess.engine.flushes > 0
    for nid, node in sess.nodes.items():
        assert len(node.agg_log) == len(jsess.nodes[nid].agg_log)
        if secure_agg:
            assert node.secagg_log == jsess.nodes[nid].secagg_log
    mse = {key: {h["round"]: h["mse"] for h in res.history}
           for key, res in (("b", rb), ("s", rs), ("ref", ref))}
    assert mse["b"].keys() == mse["s"].keys() == mse["ref"].keys()
    for k in mse["ref"]:
        assert abs(mse["b"][k] - mse["ref"][k]) < 1e-4, (k, mse)
        assert abs(mse["s"][k] - mse["ref"][k]) < 1e-4, (k, mse)


def _csv(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


@pytest.mark.parametrize("algo", ["modest", "fedavg", "dsgd"])
def test_train_launcher_csv_equals_reference(algo, tmp_path, monkeypatch):
    """``main([... "--task", "mf", "--device", "cpu"])`` writes the CSV of
    the reference launcher's ``run_sim``: the same rows, rounds and times;
    the session's rounds and total bytes are the reference's."""
    argv = ["--task", "mf", "--algo", algo, "--nodes", "12", "--duration",
            "20", "--eval-every", "4", "--sample-size", "4"]
    seen = {}
    for cls in (jrunner.ModestSession, jrunner.DSGDSession):
        def run(self, duration, _orig=cls.run):
            seen["ref"] = _orig(self, duration)
            return seen["ref"]
        monkeypatch.setattr(cls, "run", run)
    monkeypatch.setattr(sys, "argv", ["train"] + argv
                        + ["--out", str(tmp_path / "ref.csv")])
    jtrain.main()
    got = train.main(argv + ["--device", "cpu", "--out",
                             str(tmp_path / "port.csv")])
    ref = seen["ref"]
    assert got.rounds_completed == ref.rounds_completed > 0
    assert got.usage["total_bytes"] == ref.usage["total_bytes"]
    rows, ref_rows = _csv(tmp_path / "port.csv"), _csv(tmp_path / "ref.csv")
    assert len(rows) == len(ref_rows) > 0
    assert list(rows[0]) == list(ref_rows[0])
    for a, b in zip(rows, ref_rows):
        assert (a["algo"], a["t"], a["round"]) == \
            (b["algo"], b["t"], b["round"]) == (algo, b["t"], b["round"])
        assert np.isfinite(float(a["mse"]))


@pytest.mark.parametrize("algo,every", [("modest", "1"), ("fedavg", "3"),
                                        ("dsgd", "1")])
def test_train_launcher_ckpt_equals_reference(algo, every, tmp_path,
                                               monkeypatch):
    """``--ckpt PATH --ckpt-every K`` writes the reference launcher's file at
    the same argv and seed, both sessions starting from the reference's
    initial weights: the same npz keys, shapes and dtypes, the same meta
    (``round``, ``algo``, ``task``), values within ``rtol = atol = 1e-5``.
    D-SGD has no aggregate to save, in either launcher."""
    import repro_torch.models.tasks as tasks_mod

    init = jax.tree.map(np.asarray, jax_mf_task(
        mf_users=12, mf_items=500).init_params(0))
    make = tasks_mod.mf_task

    def mf_task_from_reference_init(**kw):
        task = make(**kw)
        task.init_params = lambda seed=0: params_from_numpy(init, "cpu")
        return task

    monkeypatch.setattr(tasks_mod, "mf_task", mf_task_from_reference_init)
    argv = ["--task", "mf", "--algo", algo, "--nodes", "12", "--duration",
            "15", "--eval-every", "4", "--sample-size", "4",
            "--ckpt-every", every]
    ref, port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--ckpt", ref, "--out", str(tmp_path / "ref.csv")])
    jtrain.main()
    got = train.main(argv + ["--ckpt", port, "--device", "cpu", "--out",
                             str(tmp_path / "port.csv")])
    assert got.rounds_completed > 3
    if algo == "dsgd":
        assert not any(tmp_path.glob("*.npz"))
        return
    with np.load(ref) as a, np.load(port) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(init)
        for k in a.files:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape)
            np.testing.assert_allclose(b[k], a[k], **TOL)
        assert any(not np.array_equal(b[k], init[k]) for k in b.files)
    metas = []
    for path in (ref, port):
        with open(path[:-4] + ".meta.json") as fh:
            metas.append(json.load(fh))
    assert metas[0] == metas[1]
    assert metas[1]["algo"] == algo and metas[1]["task"] == "mf"
    assert metas[1]["round"] >= int(every)


@pytest.mark.parametrize("argv,item", [
    (["--mode", "mesh", "--devices", "3"], "divisible")])
def test_train_launcher_refuses_what_the_package_lacks(argv, item, capsys):
    """The mesh form needs the device count to be a multiple of
    ``--model-parallel`` (2 by default): 3 devices make no mesh."""
    with pytest.raises(SystemExit, match=item):
        train.main(argv + ["--device", "cpu", "--nodes", "4"])


@pytest.mark.parametrize("option", [["--sample-frac", "0.5"],
                                    ["--mesh-shape", "2x2"],
                                    ["--dtype", "bfloat16"]])
def test_train_launcher_rejects_options_nothing_reads(option, capsys):
    """Options that the reference launcher does not parse either (its
    docstring's ``--sample-frac`` among them) are an error rather than a
    silent no-op."""
    with pytest.raises(SystemExit):
        train.main(["--task", "mf", "--device", "cpu", "--nodes", "4"]
                   + option)
    assert "unrecognized arguments" in capsys.readouterr().err


def test_train_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--task", "mf", "--nodes", "4", "--duration", "1"])
