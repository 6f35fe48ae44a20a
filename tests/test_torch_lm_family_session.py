"""MoDeST sessions that train the MoE family in the PyTorch package
against the reference's, and the audio and vlm tasks, which the
reference's sessions cannot train (ROADMAP C11). RWKV-6's session is in
``test_torch_lm_family_session_rwkv.py``, Hymba's plain and masked ones in
``test_torch_lm_family_session_hybrid.py`` (files of their own, so that a
run that spreads test files over workers can spread them); they share
this file's helpers.

Each family runs its reduced config at a small width (d_model 64, 2 query
heads and 1 KV head of 32, d_ff 128, vocab 64, 16 tokens; the MoE's experts
ff 32) on the batched engine. Parameters are taken from the reference's
init through ``params_from_numpy``. Tiers: rounds, round times, byte
counts, trainings and every node's aggregation (masked: unmask) log
exact; the evaluated metrics (the MoE's ``aux_loss`` too) and the last
evaluated model's parameters ``rtol = atol = 1e-5``.
"""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.runner as jrunner
import repro_torch.sim.runner as trunner
from repro.config import ModestConfig as JModestConfig
from repro.config import TrainConfig as JTrainConfig
from repro.data import make_lm_task as j_make_lm_task
from repro.models.tasks import lm_task as jax_lm_task
from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.data import make_lm_task
from repro_torch.engine.flat import FlatModel, as_buffer, params_from_numpy
from repro_torch.models.tasks import lm_task
from repro_torch.sim.runner import ModestSession
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

SMALL = dict(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
             vocab=64)
EXTRA = {"qwen3-moe-30b-a3b": dict(moe_d_ff_expert=32)}
T = 16                                  # tokens a sample
SIM_SECONDS = 6.0                       # 6-8 rounds, 3-4 evaluated


def _kw(arch):
    return dict(SMALL, **EXTRA.get(arch, {}))


@functools.lru_cache(maxsize=None)
def _task(pkg, arch):
    """One task a package and arch for the whole file: a session's
    compiled steps (the reference's jits, the port's vmapped loss) are
    cached on its task and serve the next session."""
    if pkg == "torch":
        return lm_task(arch, device="cpu", **_kw(arch))
    return jax_lm_task(arch, **_kw(arch))


def _init(arch):
    """The reference's initial parameters of ``arch``, numpy (its init
    under ``jax.jit``, as ``init_params(0)`` draws them)."""
    jtask = _task("jax", arch)
    return jax.tree.map(np.asarray, jax.jit(jtask.model.init)(
        jax.random.key(0)))


def _session(pkg, arch, init=None, secure_agg=None, n=8):
    """A session of ``arch``; ``init`` (numpy) is its initial model."""
    mkw = dict(n_nodes=n, sample_size=4, n_aggregators=2,
               success_fraction=1.0, ping_timeout=1.0, secure_agg=secure_agg)
    dkw = dict(samples_per_node=12, seq_len=T + 1, vocab=SMALL["vocab"],
               iid=False, seed=0)
    task = _task(pkg, arch)
    if pkg == "torch":
        if init is not None:            # start from the reference's weights
            task.init_params = lambda seed=0: params_from_numpy(init, "cpu")
        return ModestSession(
            n_nodes=n, mcfg=ModestConfig(**mkw),
            tcfg=TrainConfig(batch_size=8), task=task,
            data=make_lm_task(n, **dkw), seed=0, eval_every_rounds=2,
            engine="batched", device="cpu")
    if init is not None:
        task.init_params = lambda seed=0: jax.tree.map(jnp.asarray, init)
    return jrunner.ModestSession(
        n_nodes=n, mcfg=JModestConfig(**mkw), tcfg=JTrainConfig(batch_size=8),
        task=task, data=j_make_lm_task(n, **dkw), seed=0,
        eval_every_rounds=2, engine="batched")


def _run(pkg, arch, init=None, secure_agg=None):
    sess = _session(pkg, arch, init, secure_agg)
    return sess, sess.run(SIM_SECONDS)


def _same_events(sess, got, jsess, ref, secure_agg):
    assert got.rounds_completed == ref.rounds_completed >= 4
    assert got.usage == ref.usage
    assert got.round_times == ref.round_times
    assert got.trainings_completed == ref.trainings_completed
    assert sess.engine.jobs_run > sess.engine.flushes > 0
    assert sess.engine.fallbacks == 0
    for nid, node in sess.nodes.items():
        assert len(node.agg_log) == len(jsess.nodes[nid].agg_log)
        if secure_agg:
            assert node.secagg_log == jsess.nodes[nid].secagg_log
    assert len(ref.history) == len(got.history) > 2
    for h, jh in zip(got.history, ref.history):
        assert h.keys() == jh.keys() and h["round"] == jh["round"]
        assert h["t"] == jh["t"]


def check_session_equals_reference(arch, secure_agg):
    """Rounds, round times, bytes and every node's aggregation log exact
    (masked: its unmask log too); every evaluated metric at every
    evaluated round and the last evaluated model within 1e-5; the cohorts
    ran batched. Shared with ``test_torch_lm_family_session_hybrid.py``."""
    init = _init(arch)
    jsess, ref = _run("jax", arch, init, secure_agg)
    sess, got = _run("torch", arch, init, secure_agg)
    _same_events(sess, got, jsess, ref, secure_agg)
    for h, jh in zip(got.history, ref.history):
        if arch.startswith("qwen3-moe"):
            assert "aux_loss" in h
        for key in jh:
            np.testing.assert_allclose(h[key], jh[key], **TOL)
    last = max(sess._eval_models)
    assert last == max(jsess._eval_models)
    np.testing.assert_allclose(
        as_buffer(sess._eval_models[last], sess.task.flat_spec).numpy(),
        np.asarray(jsess._eval_models[last].buffer), **TOL)


def test_moe_session_equals_reference():
    check_session_equals_reference("qwen3-moe-30b-a3b", None)


def test_session_holds_its_evaluation_snapshots_and_a_bounded_rest(
        monkeypatch):
    """Where a session's flat fp32 models live: at each new round the
    models alive (gc-tracked fp32 storages made during the run, an (S, N)
    stack counted as S) are the runner's evaluation snapshots, one an
    evaluated round and kept until ``run`` ends to be evaluated lazily, as
    the reference's runner keeps them (``src/repro/sim/runner.py``,
    ``_eval_models``), plus a rest in flight (cohorts in training, models
    on the wire) that does not grow with the session."""
    arch = "qwen3-moe-30b-a3b"
    N = _task("torch", arch).flat_spec.n

    def storages():
        out = {}
        for o in gc.get_objects():
            if issubclass(type(o), torch.Tensor) and \
                    o.dtype == torch.float32:
                st = o.untyped_storage()
                if st.nbytes() and st.nbytes() % (4 * N) == 0:
                    out[st.data_ptr()] = (st.nbytes() // (4 * N), o)
        return out

    gc.collect()
    before = storages()         # kept alive: no address of them is reused
    seen = []
    inner = trunner.ModestSession._on_aggregate

    def on_aggregate(self, k, params, node):
        new = k > self._latest_round_seen
        inner(self, k, params, node)
        if new:
            gc.collect()
            alive = {p: n for p, (n, _) in storages().items()
                     if p not in before}
            held = {as_buffer(m, self.task.flat_spec).untyped_storage()
                    .data_ptr() for m in self._eval_models.values()}
            seen.append((k, len(self._eval_models), sum(alive.values()),
                         held <= set(alive)))

    monkeypatch.setattr(trunner.ModestSession, "_on_aggregate", on_aggregate)
    sess = _session("torch", arch)
    sess.run(3 * SIM_SECONDS)
    assert len(seen) >= 20
    for k, snaps, alive, held in seen:
        assert held and snaps == k // 2          # evaluated every 2 rounds
    rest = [alive - snaps for _, snaps, alive, _ in seen]
    half = len(rest) // 2
    assert 0 < max(rest[half:]) <= max(rest[:half]) <= 3 * 4, rest


@pytest.mark.parametrize("arch,key", [("whisper-large-v3", "frames"),
                                      ("llava-next-mistral-7b",
                                       "image_embeds")])
def test_c11_audio_and_vlm_tasks_raise_at_their_first_step(arch, key):
    """ROADMAP C11: the reference's task batches hold tokens, labels and a
    mask, while Whisper's loss reads ``frames`` and LLaVA's
    ``image_embeds``. Both packages build the task, pack and aggregate it
    alike, and raise ``KeyError`` naming the key at the first training
    step of a session and at the first evaluation."""
    jtask, task = _task("jax", arch), _task("torch", arch)
    assert task.flat_spec.shapes == jtask.flat_spec.shapes
    assert task.model_bytes() == jtask.model_bytes()
    jps = [jax.tree.map(np.asarray, jtask.init_params(s)) for s in range(2)]
    want = jtask.aggregate([jax.tree.map(jnp.asarray, p) for p in jps],
                           [1.0, 3.0])
    got = task.aggregate([params_from_numpy(p, "cpu") for p in jps],
                         [1.0, 3.0])
    assert isinstance(got, FlatModel)
    np.testing.assert_allclose(got.buffer.numpy(), np.asarray(want.buffer),
                               **TOL)

    for pkg in ("jax", "torch"):
        with pytest.raises(KeyError, match=key):
            _session(pkg, arch).run(4.0)
    data = make_lm_task(2, samples_per_node=4, seq_len=T + 1,
                        vocab=SMALL["vocab"], test_size=8, seed=0)
    jdata = j_make_lm_task(2, samples_per_node=4, seq_len=T + 1,
                           vocab=SMALL["vocab"], test_size=8, seed=0)
    with pytest.raises(KeyError, match=key):
        jtask.evaluate(jax.tree.map(jnp.asarray, jps[0]), jdata.test)
    with pytest.raises(KeyError, match=key):
        task.evaluate(params_from_numpy(jps[0], "cpu"), data.test)
