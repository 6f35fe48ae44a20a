"""Plain and masked MoDeST sessions that train a dense LM in the PyTorch
package against the reference's (the rest of LM training is held in
``test_torch_lm_train.py``).

A reduced TinyLlama at a small width (d_model 64, 2 query heads and 1 KV
head of 32, d_ff 128, vocab 64, 16 tokens). Parameters are taken from the
reference's init through ``params_from_numpy`` (``jax.random`` bits are
not reproducible in torch). Tiers: event trajectories, round times and
byte counts exact; losses and trained parameters ``rtol = atol = 1e-5``.
"""

import jax
import numpy as np
import pytest

import repro.sim.runner as jrunner
from repro.config import ModestConfig as JModestConfig
from repro.config import TrainConfig as JTrainConfig
from repro.data import make_lm_task as j_make_lm_task
from repro.models.tasks import lm_task as jax_lm_task
from repro_torch.config import ModestConfig, TrainConfig
from repro_torch.data import make_lm_task
from repro_torch.engine.flat import as_buffer, params_from_numpy
from repro_torch.models.tasks import lm_task
from repro_torch.sim.runner import ModestSession
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
             vocab=64)
T = 16                                  # tokens a sample


def _jtask(**cfg):
    return jax_lm_task(**SMALL, **cfg)


def _task(**cfg):
    return lm_task(device="cpu", **SMALL, **cfg)


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


@pytest.mark.parametrize("secure_agg", [None, "masked"])
def test_lm_session_equals_reference(secure_agg):
    """Rounds, round times, bytes and every node's aggregation log (masked:
    its unmask log) exact; the loss at every evaluated round and the last
    evaluated model's parameters within 1e-5; the cohorts ran batched."""
    jsess = _session("jax", "batched", secure_agg=secure_agg)
    init = jax.tree.map(np.asarray, jsess.task.init_params(0))
    ref = jsess.run(10.0)
    sess = _session("torch", "batched", init, secure_agg)
    got = sess.run(10.0)
    assert got.rounds_completed == ref.rounds_completed >= 6
    assert got.usage == ref.usage
    assert got.round_times == ref.round_times
    assert got.trainings_completed == ref.trainings_completed
    assert sess.engine.jobs_run > sess.engine.flushes > 0
    assert sess.engine.fallbacks == 0
    for nid, node in sess.nodes.items():
        assert len(node.agg_log) == len(jsess.nodes[nid].agg_log)
        if secure_agg:
            assert node.secagg_log == jsess.nodes[nid].secagg_log
    loss = {key: {h["round"]: h["loss"] for h in res.history}
            for key, res in (("port", got), ("ref", ref))}
    assert loss["port"].keys() == loss["ref"].keys() and len(loss["ref"]) > 2
    for k in loss["ref"]:
        np.testing.assert_allclose(loss["port"][k], loss["ref"][k], **TOL)
    last = max(sess._eval_models)
    assert last == max(jsess._eval_models)
    want = np.asarray(jsess._eval_models[last].buffer)
    np.testing.assert_allclose(
        as_buffer(sess._eval_models[last], sess.task.flat_spec).numpy(), want,
        **TOL)
