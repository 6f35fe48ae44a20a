"""The PyTorch package stands alone: it imports neither ``jax`` nor the
reference package ``repro`` — checked at run time in a fresh interpreter
and in the source text (the package, ``chip_smoke.py``, ``fused_times.py``
and the examples ``examples/torch_*.py``)."""

import glob
import os
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "src", "repro_torch")

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)(\s|\.|,|$)|from\s+(jax|repro)(\s|\.))", re.M)


def _py_files():
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py", "fused_times.py")]
    out += glob.glob(os.path.join(REPO, "examples", "torch_*.py"))
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _submodules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_submodule_imports_without_jax_or_repro():
    mods = _submodules()
    assert "repro_torch.kernels.fused" in mods
    assert "repro_torch.sim.runner" in mods and len(mods) > 40
    assert "repro_torch.core.strategy" in mods
    assert "repro_torch.launch.dryrun" in mods
    code = (
        "import importlib, sys\n"
        f"mods = {mods!r}\n"
        "import repro_torch\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'jaxlib' or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", _py_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_no_jax_and_no_reference_package(path):
    with open(path) as fh:
        text = fh.read()
    hit = _FORBIDDEN.search(text)
    assert hit is None, f"{path}: {hit.group(0)!r}"


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "from repro import optim", "from repro.sim import runner",
                "import repro", "    import repro.kernels"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.sim import runner",
               "from repro_torch import optim", "# import jaxtyping"):
        assert not _FORBIDDEN.search(ok), ok


def test_numerics_are_set_by_the_package():
    import torch

    import repro_torch  # noqa: F401
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_entry_points_default_to_the_card_and_raise_without_one():
    """device=None means cuda: on a machine without a card every entry
    point raises instead of carrying on on the CPU."""
    import torch

    from repro_torch.config import ModestConfig
    from repro_torch.core.tasks import AbstractTask
    from repro_torch.engine.cohort import make_engine
    from repro_torch.eval import Scenario, run_scenario, scenario_matrix
    from repro_torch.kernels.ops import aggregate_flatmodel
    from repro_torch.models.tasks import cnn_task
    from repro_torch.sim.runner import ModestSession

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn_task()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(None, AbstractTask(1000))
    with pytest.raises(RuntimeError, match="CUDA"):
        aggregate_flatmodel([{"w": torch.ones(4)}], [1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        ModestSession(n_nodes=4, mcfg=ModestConfig(n_nodes=4),
                      task=AbstractTask(1000))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(Scenario(algo="modest", regime="diurnal", n=4,
                              duration=1.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        scenario_matrix(algos=("dsgd",), regimes=("homogeneous",), n=4,
                        duration=1.0)
