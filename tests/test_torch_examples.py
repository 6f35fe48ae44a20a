"""The PyTorch package's examples (``examples/torch_*.py``) against the
reference's (``examples/*.py``), run on the CPU.

Tiers:

* **Exact** for the host-only twins (``churn_resilience``,
  ``trace_replay``): at their defaults they print the reference's text
  byte for byte (byte-only tasks, pure-Python event loop).
* For the twins that train (``train_lm``, ``quickstart``; and
  ``compare_fl_dl`` in ``test_torch_examples_compare.py``), started from the reference's initial weights
  (``params_from_numpy``; ``jax.random`` bits are not reproducible in
  torch): every round count, parameter count and byte figure printed is
  identical, and every accuracy and loss agrees within ``TOL`` of the
  printed value.
* ``serve_batch`` delegates to ``repro_torch.launch.serve``, which
  ``test_torch_serve.py`` holds to the reference: here it exits 0 and
  prints the launcher's lines.
"""

import importlib.util
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro_torch.engine.flat import params_from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = os.path.join(REPO, "examples")
TOL = 2e-3                      # of a printed accuracy or loss


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(capsys, fn, argv, monkeypatch):
    """What ``fn()`` prints with ``sys.argv[1:] == argv``."""
    monkeypatch.setattr(sys, "argv", ["example"] + list(argv))
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*", text)]


def _from_reference_init(make, init):
    """Wrap a task factory so that every task it makes starts from the
    reference's initial weights ``init`` (a tree of numpy arrays)."""
    def factory(*args, **kw):
        task = make(*args, **kw)
        task.init_params = lambda seed=0: params_from_numpy(init, task.device)
        return task
    return factory


def _same_lines(got: str, want: str, loose: set):
    """Line by line, word by word: equal, except that a number in a column
    named by ``loose`` (its index among the line's numbers) may differ by
    ``TOL``."""
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl), (got, want)
    for g, w in zip(gl, wl):
        gn, wn = _numbers(g), _numbers(w)
        assert re.sub(r"-?\d+\.?\d*", "#", g) == re.sub(r"-?\d+\.?\d*", "#",
                                                        w), (g, w)
        assert len(gn) == len(wn), (g, w)
        for i, (a, b) in enumerate(zip(gn, wn)):
            if (w.split()[0] if w.split() else "", i) in loose:
                # printed decimals: 0.222 against 0.224 is within 2e-3
                assert round(abs(a - b), 9) <= TOL, (g, w)
            else:
                assert a == b, (g, w)


# ---------------------------------------------------------------------------
# host-only twins: the exact tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["churn_resilience", "trace_replay"])
def test_host_only_twin_prints_the_reference_text(name, capsys, monkeypatch):
    want = _printed(capsys, _load(name).main, [], monkeypatch)
    twin = _load(f"torch_{name}")
    got = _printed(capsys, lambda: twin.main(["--device", "cpu"]), [],
                   monkeypatch)
    assert got == want
    assert "rounds" in got


def test_host_only_twins_default_to_the_card():
    import torch

    from repro_torch.traces import homogeneous_profile
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load("torch_churn_resilience").run()
    with pytest.raises(RuntimeError, match="CUDA"):
        _load("torch_trace_replay").run_profile(homogeneous_profile(4))


# ---------------------------------------------------------------------------
# twins that train
# ---------------------------------------------------------------------------


def test_train_lm_twin_matches_reference(capsys, monkeypatch):
    """The LM session at a small size: the model line and rounds exact,
    the test losses within ``TOL``, bytes and overhead exact."""
    from repro.models.tasks import lm_task as jax_lm_task
    from repro.config import TrainConfig as JTrainConfig

    args = ["--nodes", "4", "--layers", "1", "--d-model", "64", "--vocab",
            "256", "--seq-len", "16", "--duration", "20"]
    want = _printed(capsys, _load("train_lm").main, args, monkeypatch)
    jtask = jax_lm_task("tinyllama-1.1b", reduce=True, n_layers=1,
                        d_model=64, vocab=256, d_ff=256,
                        tcfg=JTrainConfig(optimizer="sgd", lr=0.1,
                                          batch_size=8))
    init = jax.tree.map(np.asarray, jtask.init_params(0))
    twin = _load("torch_train_lm")
    monkeypatch.setattr(twin, "lm_task",
                        _from_reference_init(twin.lm_task, init))
    got = _printed(capsys, lambda: twin.main(args + ["--device", "cpu"]),
                   [], monkeypatch)
    # a curve line's numbers: t, round, loss (the third)
    _same_lines(got, want, {("t=", 2)})
    assert "test_loss=" in got and got.startswith("model: 1L d=64")


def _quickstart_reference(duration):
    """The reference's quickstart session (``examples/quickstart.py``,
    lines 20-31) run for ``duration`` simulated seconds."""
    from repro.config import ModestConfig, TrainConfig
    from repro.data import make_classification_task
    from repro.models.tasks import cnn_task
    from repro.sim.runner import ModestSession

    n = 12
    data = make_classification_task(n, samples_per_node=40, iid=False, seed=0)
    session = ModestSession(
        n_nodes=n,
        mcfg=ModestConfig(n_nodes=n, sample_size=4, n_aggregators=2,
                          success_fraction=1.0, ping_timeout=1.0),
        tcfg=TrainConfig(batch_size=20),
        task=cnn_task(),
        data=data,
        seed=0,
        eval_every_rounds=10,
    )
    return session, session.run(duration)


def test_quickstart_twin_matches_reference(capsys, monkeypatch):
    """At 10 simulated seconds: rounds, round times, usage and the history's
    rounds exact, accuracies within ``TOL``; the twin's report prints the
    reference's lines."""
    jsess, ref = _quickstart_reference(10.0)
    init = jax.tree.map(np.asarray, jsess.task.init_params(0))
    twin = _load("torch_quickstart")
    monkeypatch.setattr(twin, "cnn_task",
                        _from_reference_init(twin.cnn_task, init))
    session, res = twin.run(10.0, device="cpu")
    assert res.rounds_completed == ref.rounds_completed >= 10
    assert res.round_times == ref.round_times
    assert res.usage == ref.usage
    acc = [(h["t"], h["round"], h["accuracy"]) for h in res.history
           if "accuracy" in h]
    jacc = [(h["t"], h["round"], h["accuracy"]) for h in ref.history
            if "accuracy" in h]
    assert [a[:2] for a in acc] == [a[:2] for a in jacc] and acc
    for (_, _, a), (_, _, b) in zip(acc, jacc):
        assert abs(a - b) <= TOL
    assert session.engine.jobs_run > session.engine.flushes > 0
    capsys.readouterr()
    twin.report(res)
    text = capsys.readouterr().out
    assert text.startswith(f"rounds completed: {ref.rounds_completed}\n")
    assert "accuracy curve (sim-time, round, acc):" in text
    assert f"total={ref.usage['total_bytes'] / 1e6:.1f}MB" in text


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------


def test_serve_batch_twin_delegates_to_the_launcher():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "torch_serve_batch.py"),
         "--device", "cpu", "--new-tokens", "2"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[serve] arch=tinyllama-1.1b device=cpu "
                               "devices=1 batch=4 prefill(32 toks)=")
    assert re.fullmatch(r"\[serve\] sample output ids: \[\d+, \d+\]",
                        lines[1])
