"""The PyTorch package's ``examples/torch_compare_fl_dl.py`` against the
reference's ``examples/compare_fl_dl.py`` on the CPU: FedAvg, D-SGD and
MoDeST train the paper's CNN from the reference's initial weights. Tier
as in ``test_torch_examples.py``: rounds and byte figures printed are
identical, final accuracies within ``TOL`` of the printed value. A file of
its own, so that the test runners spread it beside the other examples'.
"""

import jax
import numpy as np

from test_torch_examples import (TOL, _from_reference_init, _load,  # noqa: F401
                                 _printed, _same_lines)
from test_torch_threads import one_torch_thread  # noqa: F401


def test_compare_fl_dl_twin_matches_reference(capsys, monkeypatch):
    """FedAvg, D-SGD and MoDeST at ``--nodes 8 --duration 20``: rounds and
    bytes identical, final accuracies within ``TOL``, the ratio line
    identical."""
    from repro.models.tasks import cnn_task as jax_cnn_task

    args = ["--nodes", "8", "--duration", "20"]
    want = _printed(capsys, _load("compare_fl_dl").main, args, monkeypatch)
    init = jax.tree.map(np.asarray, jax_cnn_task().init_params(0))
    twin = _load("torch_compare_fl_dl")
    monkeypatch.setattr(twin, "cnn_task",
                        _from_reference_init(twin.cnn_task, init))
    got = _printed(capsys, lambda: twin.main(args + ["--device", "cpu"]),
                   [], monkeypatch)
    # the second number of an algorithm's row is its final accuracy
    _same_lines(got, want, {(a, 1) for a in ("fedavg", "dsgd", "modest")})
    assert len(got.splitlines()) == 6
