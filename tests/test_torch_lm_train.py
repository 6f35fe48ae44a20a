"""Training the dense LMs in the PyTorch package against the reference:
the masked loss and its gradients, the stacked cohort lowering, the
evaluation sweep, MoDeST sessions on the other engines, the training
launcher with ``--task lm``, bf16 parameters through the fp32 flat buffer, and
training with ``use_flash`` refused (ROADMAP C5).

A reduced TinyLlama at a small width (d_model 64, 2 query heads and 1 KV
head of 32, d_ff 128, vocab 64, 16 tokens) keeps the file well under a
minute on the CPU. Parameters are taken from the reference's init through
``params_from_numpy`` (``jax.random`` bits are not reproducible in torch).
Tiers: event trajectories, round times and byte counts exact; losses,
gradients, trained parameters and metrics ``rtol = atol = 1e-5``; the
stacked lowering against per-model autograd in the port ``1e-6``; bf16
parameters: the flat round trip bit for bit, one step of the flat route
within one bf16 step of the reference's, bf16 gradients within a relative
L2 distance of 2^-5 (``BF16_GRAD_REL_L2``). The plain and masked sessions
against the reference's are in ``test_torch_lm_session.py`` (a file of its
own, so that a run that spreads test files over workers can spread the
two).
"""

import csv
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.runner as jrunner
from repro.config import ModestConfig as JModestConfig
from repro.config import TrainConfig as JTrainConfig
from repro.data import make_lm_task as j_make_lm_task
from repro.launch import train as jtrain
from repro.models.tasks import lm_task as jax_lm_task
from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.data import make_lm_task
from repro_torch.engine import cohort, lowering
from repro_torch.engine.flat import (FlatModel, params_from_numpy,
                                     params_to_numpy)
from repro_torch.engine.lowering import stacked_grads_for, stacked_metrics_for
from repro_torch.launch import train
from repro_torch.models.tasks import lm_task
from repro_torch.sim.runner import ModestSession
from repro_torch.utils.pytree import tree_flatten, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
             vocab=64)
T = 16                                  # tokens a sample


def _jtask(**cfg):
    return jax_lm_task(**SMALL, **cfg)


def _task(**cfg):
    return lm_task(device="cpu", **SMALL, **cfg)


def _jparams(seed=0, **cfg):
    return jax.tree.map(np.asarray, _jtask(**cfg).init_params(seed))


def _batch(seed, B=6, masked=True):
    rng = np.random.default_rng(100 + seed)
    x = rng.integers(0, SMALL["vocab"], (B, T)).astype(np.int32)
    y = rng.integers(0, SMALL["vocab"], (B, T)).astype(np.int32)
    mask = (rng.random(B) < 0.7).astype(np.float32) if masked else None
    if masked:
        mask[0] = 1.0
    return x, y, mask


def _leaves(tree):
    return tree_flatten(tree)[0]


def test_task_layout_and_batches_match_reference():
    """``lm_task`` builds the reduced dense config the reference builds,
    with the same flat layout (read from the meta device: no weights), SGD
    at lr 0.05, and token batches whose row mask spans the sequence."""
    task, jtask = _task(), _jtask()
    assert task.cfg.family == "dense" and task.cfg.n_layers == 2
    for f in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab", "param_dtype", "remat", "use_flash"):
        assert getattr(task.cfg, f) == getattr(jtask.cfg, f), f
    spec, jspec = task.flat_spec, jtask.flat_spec
    assert (spec.n, spec.offsets, spec.shapes, spec.nbytes) == \
        (jspec.n, jspec.offsets, jspec.shapes, jspec.nbytes)
    assert task.tcfg.optimizer == "sgd" and task.tcfg.lr == 0.05
    assert task.model_bytes() == jtask.model_bytes()
    x, y, mask = _batch(0)
    b, jb = task._to_batch(x, y, mask), jtask._to_batch(x, y, mask)
    assert sorted(b) == sorted(jb) == ["labels", "mask", "tokens"]
    for k in b:
        assert tuple(b[k].shape) == jb[k].shape
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    assert sorted(task._to_batch(x, y)) == ["labels", "tokens"]


def test_full_width_layout_needs_no_weights():
    """TinyLlama's full widths at 2 layers: 219,162,624 lanes in 12 leaves
    (438 MB of bf16 on the wire), laid out without drawing a weight."""
    task = lm_task(reduce=False, n_layers=2, device="cpu")
    spec = task.flat_spec
    assert spec.n == 219_162_624 and len(spec.shapes) == 12
    assert spec.nbytes == 2 * spec.n and set(spec.dtypes) == {torch.bfloat16}
    assert spec.shapes == _jtask_full_shapes()


def _jtask_full_shapes():
    return jax_lm_task(reduce=False, n_layers=2).flat_spec.shapes


@pytest.mark.parametrize("masked", [True, False])
def test_masked_loss_and_grads_match_reference(masked):
    jtask, task = _jtask(), _task()
    jp = _jparams(3)
    x, y, mask = _batch(1, masked=masked)
    (jloss, _), jg = jax.value_and_grad(jtask.model.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jtask._to_batch(x, y, mask))
    params = params_from_numpy(jp, "cpu")
    leaves, treedef = tree_flatten(params)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    loss, _ = task.model.loss_fn(treedef.unflatten(leaves),
                                 task._to_batch(x, y, mask))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for g, jgl in zip(grads, _leaves(jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(g.numpy(), jgl, **TOL)


def test_stacked_lowering_equals_per_model_autograd():
    """Three models of different weights, each on its own masked batch: the
    stacked gradient of model s equals autograd of model s's own loss; the
    stacked metrics on a shared batch equal each model's ``loss_fn``."""
    task = _task()
    trees = [params_from_numpy(_jparams(s), "cpu") for s in range(3)]
    batches = [_batch(10 + s) for s in range(3)]
    stacked = tree_map(lambda *ls: torch.stack(ls), *trees)
    xb, yb, mb = (torch.stack([torch.from_numpy(b[i]) for b in batches])
                  for i in range(3))
    got = _leaves(stacked_grads_for(task)(stacked, xb, yb, mb))
    for s, tree in enumerate(trees):
        leaves, treedef = tree_flatten(tree)
        leaves = [l.clone().requires_grad_(True) for l in leaves]
        loss, _ = task.model.loss_fn(treedef.unflatten(leaves),
                                     task._to_batch(*batches[s]))
        for g, want in zip(got, torch.autograd.grad(loss, leaves)):
            assert g.shape[1:] == want.shape
            torch.testing.assert_close(g[s], want, rtol=1e-6, atol=1e-6)
    x, y, _ = _batch(20, masked=False)
    shared = task._to_batch(x, y)
    with torch.no_grad():
        ms = stacked_metrics_for(task)(stacked, shared)
        for s, tree in enumerate(trees):
            one = task.model.loss_fn(tree, shared)[1]
            torch.testing.assert_close(ms["loss"][s], one["loss"], rtol=1e-6,
                                       atol=1e-6)


def test_cohort_step_is_one_vmapped_pass():
    """The engine's step over an (S, N) buffer: one SGD step of each row,
    each equal to that model's own step at 1e-6, with the stacked loss
    built once a task (the cached cohort ops)."""
    task = _task()
    opt, step = cohort._cohort_ops(task)
    assert cohort._cohort_ops(task)[1] is step
    spec = task.flat_spec
    trees = [params_from_numpy(_jparams(s), "cpu") for s in range(2)]
    buf = torch.stack([spec.pack(t) for t in trees])
    batches = [_batch(30 + s) for s in range(2)]
    xb, yb, mb = (torch.stack([torch.from_numpy(b[i]) for b in batches])
                  for i in range(3))
    new, _ = step(buf, opt.init(buf), xb, yb, mb,
                  torch.ones(2, dtype=torch.bool))
    for s, tree in enumerate(trees):
        want, _, _ = task._step(tree, task._opt.init(tree),
                                task._to_batch(*batches[s]))
        torch.testing.assert_close(new[s], spec.pack(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("chunk_bytes", [None, 1])
def test_evaluate_many_matches_reference(chunk_bytes, monkeypatch):
    """The stacked evaluation sweep of four models over a 70-sample test
    set (a padded last batch) equals the reference's; a chunked model
    axis (one model a chunk) changes no value."""
    if chunk_bytes is not None:
        monkeypatch.setattr(lowering, "EVAL_LOGIT_BYTES", chunk_bytes)
    jtask, task = _jtask(), _task()
    data = make_lm_task(2, samples_per_node=4, seq_len=T + 1,
                        vocab=SMALL["vocab"], test_size=70, seed=5)
    jdata = j_make_lm_task(2, samples_per_node=4, seq_len=T + 1,
                           vocab=SMALL["vocab"], test_size=70, seed=5)
    np.testing.assert_array_equal(data.test.x, jdata.test.x)
    jps = [_jparams(s) for s in range(4)]
    want = jtask.evaluate_many([jax.tree.map(jnp.asarray, p) for p in jps],
                               jdata.test)
    models = [params_from_numpy(p, "cpu") for p in jps]
    models[1] = FlatModel.pack(models[1], task.flat_spec)
    got = task.evaluate_many(models, data.test)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss"}
        np.testing.assert_allclose(g["loss"], w["loss"], **TOL)
    np.testing.assert_allclose(task.evaluate(models[2], data.test)["loss"],
                               want[2]["loss"], **TOL)


def _session(pkg, engine, init=None, secure_agg=None, n=8):
    mkw = dict(n_nodes=n, sample_size=4, n_aggregators=2,
               success_fraction=1.0, ping_timeout=1.0, secure_agg=secure_agg)
    dkw = dict(samples_per_node=12, seq_len=T + 1, vocab=SMALL["vocab"],
               iid=False, seed=0)
    if pkg == "torch":
        task = _task()
        if init is not None:            # start from the reference's weights
            task.init_params = lambda seed=0: params_from_numpy(init, "cpu")
        return ModestSession(
            n_nodes=n, mcfg=ModestConfig(**mkw),
            tcfg=TrainConfig(batch_size=8), task=task,
            data=make_lm_task(n, **dkw), seed=0, eval_every_rounds=2,
            engine=engine, device="cpu")
    return jrunner.ModestSession(
        n_nodes=n, mcfg=JModestConfig(**mkw), tcfg=JTrainConfig(batch_size=8),
        task=_jtask(), data=j_make_lm_task(n, **dkw), seed=0,
        eval_every_rounds=2, engine=engine)


@pytest.mark.parametrize("engine", ["sequential", "sharded"])
def test_other_engines_train_the_lm_like_the_batched(engine):
    """The sequential engine (per-node ``local_train``) and ``sharded``
    (the batched engine, below two cards) train the LM task to the batched
    engine's trajectory."""
    init = _jparams(0)
    rb = _session("torch", "batched", init).run(6.0)
    rs = _session("torch", engine, init).run(6.0)
    assert rb.rounds_completed == rs.rounds_completed > 2
    assert rb.usage == rs.usage and rb.round_times == rs.round_times
    for a, b in zip(rb.history, rs.history):
        np.testing.assert_allclose(a["loss"], b["loss"], **TOL)


def _csv(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def test_train_launcher_lm_csv_equals_reference(tmp_path, monkeypatch):
    """``main([... "--task", "lm", "--device", "cpu"])`` writes the CSV of
    the reference launcher's ``run_sim`` (reduced TinyLlama on the
    synthetic Markov text), both sessions starting from the reference's
    initial weights: the same rows, rounds and times, losses at 1e-5; the
    session's rounds and total bytes are the reference's; and ``--ckpt``
    saves the aggregated model as the reference does."""
    import repro_torch.models.tasks as tasks_mod

    init = jax.tree.map(np.asarray, jax_lm_task().init_params(0))
    make = tasks_mod.lm_task

    def lm_task_from_reference_init(*a, **kw):
        task = make(*a, **kw)
        task.init_params = lambda seed=0: params_from_numpy(init, "cpu")
        return task

    monkeypatch.setattr(tasks_mod, "lm_task", lm_task_from_reference_init)
    argv = ["--task", "lm", "--arch", "tinyllama-1.1b", "--nodes", "4",
            "--duration", "6", "--eval-every", "2", "--sample-size", "2",
            "--batch-size", "16"]
    seen = {}

    def run(self, duration, _orig=jrunner.ModestSession.run):
        seen["ref"] = _orig(self, duration)
        return seen["ref"]

    monkeypatch.setattr(jrunner.ModestSession, "run", run)
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--out", str(tmp_path / "ref.csv"), "--ckpt",
        str(tmp_path / "ref.npz"), "--ckpt-every", "2"])
    jtrain.main()
    got = train.main(argv + ["--device", "cpu", "--out",
                             str(tmp_path / "port.csv"), "--ckpt",
                             str(tmp_path / "port.npz"), "--ckpt-every", "2"])
    ref = seen["ref"]
    assert got.rounds_completed == ref.rounds_completed > 2
    assert got.usage["total_bytes"] == ref.usage["total_bytes"]
    rows, ref_rows = _csv(tmp_path / "port.csv"), _csv(tmp_path / "ref.csv")
    assert len(rows) == len(ref_rows) > 0
    assert list(rows[0]) == list(ref_rows[0])
    for a, b in zip(rows, ref_rows):
        assert (a["algo"], a["t"], a["round"]) == (b["algo"], b["t"],
                                                   b["round"])
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), **TOL)
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") \
            as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape)
            np.testing.assert_allclose(b[k], a[k], **TOL)


def _bf16_spacing(m):
    """The distance between neighbouring bf16 values at magnitude ``m``
    (8 significant bits)."""
    m = np.maximum(np.abs(m), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# bf16 gradients of one step, relative L2 distance from the reference's,
# per leaf: both packages round the activations to bf16, in different
# places; measured 0.006-0.016 at this config over three seeds
BF16_GRAD_REL_L2 = 2.0 ** -5


def test_bf16_flat_round_trip_and_one_step():
    """bf16 leaves through the fp32 flat buffer: pack then unpack gives the
    leaves back bit for bit, and the buffer equals the reference's. One
    step of the flat route — the gradient packed to fp32, the SGD update
    on the fp32 buffer, the cast back to bf16 — lands within one bf16 step
    of the reference's bf16 step on every parameter, given the reference's
    own gradient: one step at the largest magnitude the lane's step
    touches (the parameter, its update, either result), since the
    reference rounds the update to bf16 before adding it and the flat
    route rounds once. The port's own bf16 gradients, sequential and stacked,
    are within ``BF16_GRAD_REL_L2`` of the reference's on every leaf."""
    from repro import optim as joptim

    jtask, task = _jtask(param_dtype="bfloat16"), _task(
        param_dtype="bfloat16")
    jp = _jparams(4, param_dtype="bfloat16")
    params = params_from_numpy(jp, "cpu")
    spec = task.flat_spec
    assert set(spec.dtypes) == {torch.bfloat16}
    buf = spec.pack(params)
    jbuf = np.asarray(jtask.flat_spec.pack(jax.tree.map(jnp.asarray, jp)))
    np.testing.assert_array_equal(buf.numpy(), jbuf)
    for a, b in zip(_leaves(spec.unpack(buf)), _leaves(params)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))

    x, y, mask = _batch(7)
    jparams = jax.tree.map(jnp.asarray, jp)
    jg = jax.grad(lambda p, b: jtask.model.loss_fn(p, b)[0])(
        jparams, jtask._to_batch(x, y, mask))
    upd, _ = jtask._opt.update(jg, jtask._opt.init(jparams), jparams)
    want = _leaves(jax.tree.map(np.asarray,
                                joptim.apply_updates(jparams, upd)))
    opt, _ = cohort._cohort_ops(task)
    g32 = spec.pack_stacked(tree_map(lambda t: t[None], params_from_numpy(
        jax.tree.map(np.asarray, jg), "cpu")))
    step, _ = opt.update(g32, opt.init(buf[None]), buf[None])
    moved = 0
    for w, got, p0, u in zip(want, _leaves(spec.unpack(buf + step[0])),
                             _leaves(params), _leaves(spec.unpack_stacked(
                                 step))):
        assert got.dtype == torch.bfloat16
        g, w = got.float().numpy(), np.asarray(w, np.float32)
        big = np.maximum.reduce([np.abs(p0.float().numpy()),
                                 np.abs(u[0].float().numpy()), np.abs(g),
                                 np.abs(w)])
        assert (np.abs(g - w) <= _bf16_spacing(big)).all()
        moved += int((g != p0.float().numpy()).sum())
    assert moved > 0                            # the step moved weights

    leaves, treedef = tree_flatten(params)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    loss, _ = task.model.loss_fn(treedef.unflatten(leaves),
                                 task._to_batch(x, y, mask))
    seq = torch.autograd.grad(loss, leaves)
    stacked = _leaves(stacked_grads_for(task)(
        tree_map(lambda t: t[None], params), torch.from_numpy(x)[None],
        torch.from_numpy(y)[None], torch.from_numpy(mask)[None]))
    for a, b, w in zip(seq, stacked, _leaves(jax.tree.map(
            lambda t: np.asarray(t, np.float32), jg))):
        assert a.dtype == b.dtype == torch.bfloat16
        assert _rel_l2(a.float().numpy(), w) < BF16_GRAD_REL_L2
        assert _rel_l2(b[0].float().numpy(), w) < BF16_GRAD_REL_L2


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_training_with_flash_raises(engine):
    """C5: training never takes the flash path. With ``use_flash=True``
    the LM task's step raises ``NotImplementedError`` on the CPU too,
    rather than training through the plain attention."""
    task = _task(use_flash=True)
    params = params_from_numpy(_jparams(0), "cpu")
    x, y, mask = _batch(0)
    if engine == "sequential":
        with pytest.raises(NotImplementedError, match="use_flash"):
            task._step(params, task._opt.init(params),
                       task._to_batch(x, y, mask))
    else:
        stacked = tree_map(lambda t: t[None], params)
        with pytest.raises(NotImplementedError, match="use_flash"):
            stacked_grads_for(task)(stacked, torch.from_numpy(x)[None],
                                    torch.from_numpy(y)[None],
                                    torch.from_numpy(mask)[None])
    # evaluation (no gradient) still runs the model's forward
    with torch.no_grad():
        assert torch.isfinite(task.model.loss_fn(
            params, task._to_batch(x, y))[0])


def test_lm_task_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_task(**SMALL)


def test_params_to_numpy_round_trip():
    task = _task()
    p = task.init_params(1)
    back = params_from_numpy(params_to_numpy(p), "cpu")
    for a, b in zip(_leaves(p), _leaves(back)):
        assert torch.equal(a, b)
