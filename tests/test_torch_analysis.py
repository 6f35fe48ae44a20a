"""Tests for ``repro_torch.analysis`` — the package's own copy of the
determinism/protocol-safety linter and of the shadow-mode same-timestamp
conflict detector.

1. **Rule fixtures** — the reference linter's cases (``tests/test_analysis.py``)
   run against this linter, DL005 and DL001 also in torch's spelling:
   flagged inside a loop body, clean at setup time, waived with a reason.
2. **Package gate** — ``lint_paths(["src/repro_torch"])``: zero unwaived
   findings, every waiver carries a reason; the CLI's exit codes.
3. **Race detector** — a synthetic same-timestamp conflict is caught; the
   package's golden MoDeST and Gossip sessions are conflict-free and
   reproduce ``tests/test_determinism.py::GOLDEN`` with the instrument
   attached.
"""

import hashlib
import json
import os
import textwrap

import pytest

from repro_torch.analysis.config import AnalysisConfig, load_config
from repro_torch.analysis.lint import (Finding, format_findings, lint_paths,
                                       lint_source, parse_waivers)
from repro_torch.analysis.races import RaceDetector, run_shadow_check
from repro_torch.analysis.rules import RULES
from test_determinism import GOLDEN as REF_GOLDEN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src", "repro_torch")
ALL = ("DL001", "DL002", "DL003", "DL004", "DL005")
GOLDEN = {cls.__name__: v for cls, v in REF_GOLDEN.items()}


def _findings(src: str, *rules: str):
    return lint_source(textwrap.dedent(src), rules=rules or ALL)


def _rules(findings):
    return sorted({f.rule for f in findings if not f.waived})


def _case(body: str, want, rules=()):
    assert _rules(_findings(body, *rules)) == want, body


# --------------------------------------------------------------------------
# DL001 — unseeded / module-global RNG, numpy and torch
# --------------------------------------------------------------------------

DL001_CASES = {
    "stdlib_random": ("""
        import random
        def pick(xs):
            return random.choice(xs)
    """, ["DL001"]),
    "numpy_module_rng_through_alias": ("""
        import numpy as np
        def draw():
            return np.random.rand(3)
    """, ["DL001"]),
    "from_import_alias": ("""
        from numpy.random import shuffle
        def mix(xs):
            shuffle(xs)
    """, ["DL001"]),
    "seeded_generator": ("""
        import numpy as np
        def draw(seed):
            rng = np.random.default_rng(seed)
            return rng.integers(0, 10, size=3)
    """, []),
    "local_random_instance": ("""
        import random
        def pick(xs, seed):
            return random.Random(seed).choice(xs)
    """, []),
    "torch_manual_seed": ("""
        import torch
        def setup(seed):
            torch.manual_seed(seed)
    """, ["DL001"]),
    "torch_cuda_manual_seed_all": ("""
        import torch
        def setup(seed):
            torch.cuda.manual_seed_all(seed)
    """, ["DL001"]),
    "torch_randn_global": ("""
        import torch
        def init(shape):
            return torch.randn(shape)
    """, ["DL001"]),
    "torch_randint_from_import": ("""
        from torch import randint
        def draw(n):
            return randint(0, 10, (n,))
    """, ["DL001"]),
    "torch_randperm_in_loop": ("""
        import torch
        def order(groups):
            for g in groups:
                g.perm = torch.randperm(len(g))
    """, ["DL001"]),
    "torch_inplace_sampler": ("""
        def init(w):
            w.normal_(0.0, 0.02)
    """, ["DL001"]),
    "torch_draws_with_generator": ("""
        import torch
        def init(shape, seed):
            g = torch.Generator().manual_seed(seed)
            w = torch.randn(shape, generator=g)
            w.uniform_(-1.0, 1.0, generator=g)
            return w, torch.bernoulli(w.sigmoid(), generator=g)
    """, []),
}


@pytest.mark.parametrize("name", sorted(DL001_CASES))
def test_dl001(name):
    body, want = DL001_CASES[name]
    _case(body, want)


# --------------------------------------------------------------------------
# DL002 — wall clock
# --------------------------------------------------------------------------


@pytest.mark.parametrize("expr,want", [
    ("time.time()", ["DL002"]), ("time.perf_counter()", ["DL002"]),
    ("time.monotonic()", ["DL002"]), ("datetime.datetime.now()", ["DL002"]),
    ("time.sleep(0.1)", [])])
def test_dl002(expr, want):
    _case(f"""
        import datetime
        import time
        def stamp():
            return {expr}
    """, want)


# --------------------------------------------------------------------------
# DL003 — order-sensitive iteration over unordered collections
# --------------------------------------------------------------------------

DL003_CASES = {
    "for_over_set_literal_name": ("""
        def fan_out(sim):
            pending = {"a", "b", "c"}
            for nid in pending:
                sim.schedule(0.0, nid)
    """, ["DL003"]),
    "for_over_set_call": ("""
        def fan_out(sim, ids):
            alive = set(ids)
            for nid in alive:
                sim.schedule(0.0, nid)
    """, ["DL003"]),
    "self_attr_set_across_methods": ("""
        class Tracker:
            def __init__(self):
                self.live = set()
            def drain(self, sim):
                for nid in self.live:
                    sim.schedule(0.0, nid)
    """, ["DL003"]),
    "list_of_set": ("""
        def freeze(ids):
            s = frozenset(ids)
            return list(s)
    """, ["DL003"]),
    "sorted_fold_exempt": ("""
        def fan_out(sim, ids):
            alive = set(ids)
            for nid in sorted(alive):
                sim.schedule(0.0, nid)
    """, []),
    "sum_genexp_exempt": ("""
        def total(weights):
            live = set(weights)
            return sum(w for w in live)
    """, []),
    "dict_iteration_clean": ("""
        def fan_out(sim, ids):
            alive = {nid: None for nid in ids}
            for nid in alive:
                sim.schedule(0.0, nid)
    """, []),
    "sort_key_id": ("""
        def order(objs):
            return sorted(objs, key=id)
    """, ["DL003"]),
    "sort_key_lambda_id": ("""
        def order(objs):
            return sorted(objs, key=lambda o: (id(o), 0))
    """, ["DL003"]),
}


@pytest.mark.parametrize("name", sorted(DL003_CASES))
def test_dl003(name):
    body, want = DL003_CASES[name]
    _case(body, want)


# --------------------------------------------------------------------------
# DL004 — fault-interception bypass
# --------------------------------------------------------------------------


@pytest.mark.parametrize("call,want", [
    ("node.receive(msg)", ["DL004"]), ("net._dispatch(msg)", ["DL004"]),
    ("net.send(msg.sender, msg.dst, msg)", [])])
def test_dl004(call, want):
    _case(f"""
        def deliver(node, net, msg):
            {call}
    """, want, ("DL004",))


# --------------------------------------------------------------------------
# DL005 — torch tracing hazards
# --------------------------------------------------------------------------

DL005_CASES = {
    # self written inside a function handed to torch.func / torch.compile
    "self_store_in_compiled_method": ("""
        import torch
        class Engine:
            @torch.compile
            def step(self, x):
                self.last = x
                return x * 2
    """, ["DL005"]),
    "self_store_under_compile_with_options": ("""
        import torch
        class Engine:
            @torch.compile(mode="reduce-overhead")
            def step(self, x):
                self.last = x
                return x
    """, ["DL005"]),
    "self_store_under_partial_grad": ("""
        from functools import partial
        import torch
        class Engine:
            @partial(torch.func.grad, argnums=1)
            def loss(self, p, x):
                self.seen = x
                return (p * x).sum()
    """, ["DL005"]),
    "self_store_in_fn_handed_to_vmap_grad": ("""
        import torch
        class Engine:
            def build(self):
                def loss(p, x):
                    self.last = x
                    return (p * x).sum()
                return torch.func.vmap(torch.func.grad(loss))
    """, ["DL005"]),
    "self_method_handed_to_compile": ("""
        import torch
        class Engine:
            def _step(self, x):
                self.calls += 1
                return x
            def build(self):
                return torch.compile(self._step)
    """, ["DL005"]),
    "aug_assign_in_vmapped_fn": ("""
        from torch.func import vmap
        class Stats:
            def build(self):
                def f(x):
                    self.total += x.sum()
                    return x
                return vmap(f)
    """, ["DL005"]),
    "self_store_outside_trace_clean": ("""
        class Engine:
            def step(self, x):
                self.last = x
                return x
    """, []),
    "pure_fn_handed_to_vmap_grad_clean": ("""
        import torch
        def make(loss_fn):
            def loss(p, x):
                return loss_fn(p, x)
            return torch.func.vmap(torch.func.grad(loss))
    """, []),
    # built inside a loop body
    "vmap_in_loop": ("""
        import torch
        def train(fns, xs):
            for fn in fns:
                xs = torch.func.vmap(fn)(xs)
            return xs
    """, ["DL005"]),
    "grad_from_import_in_while": ("""
        from torch.func import grad
        def train(fn, p, n):
            while n:
                p = p - grad(fn)(p)
                n -= 1
            return p
    """, ["DL005"]),
    "torch_vmap_in_loop": ("""
        import torch
        def train(fns, xs):
            for fn in fns:
                xs = torch.vmap(fn)(xs)
            return xs
    """, ["DL005"]),
    "compile_in_loop": ("""
        import torch
        def train(step, batches):
            for b in batches:
                fast = torch.compile(step)
                fast(b)
    """, ["DL005"]),
    "cuda_graph_in_loop": ("""
        import torch
        def replay(steps):
            for s in steps:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    s()
                g.replay()
    """, ["DL005"]),
    "graphed_callables_in_loop": ("""
        import torch
        def train(models, xs):
            for m in models:
                torch.cuda.make_graphed_callables(m, (xs,))
    """, ["DL005"]),
    "kernel_library_loaded_in_loop": ("""
        from repro_torch.kernels import build
        def run(names):
            for n in names:
                lib = build.load(n)
                lib.launch()
    """, ["DL005"]),
    "vmap_grad_at_setup_clean": ("""
        import torch
        def make_step(loss):
            return torch.func.vmap(torch.func.grad(loss))
    """, []),
    "compile_and_library_at_setup_clean": ("""
        import torch
        from repro_torch.kernels import build
        _LIB = None
        def lib():
            global _LIB
            if _LIB is None:
                _LIB = build.load("fused_agg")
            return _LIB
        def make(step):
            return torch.compile(step)
    """, []),
    "loop_inside_traced_fn_clean": ("""
        import torch
        def make(layers):
            def loss(p, x):
                for i in range(layers):
                    x = x @ p[i]
                return x.sum()
            return torch.func.grad(loss)
    """, []),
    "jax_spelling_no_longer_a_builder": ("""
        import jax
        def train(fns, xs):
            for fn in fns:
                xs = jax.jit(fn)(xs)
            return xs
    """, []),
}


@pytest.mark.parametrize("name", sorted(DL005_CASES))
def test_dl005(name):
    body, want = DL005_CASES[name]
    _case(body, want, ("DL005",))


@pytest.mark.parametrize("rule,line", [
    ("DL005", "        xs = torch.func.vmap(fn)(xs)  # noqa: "
              "DL005(one model a call, built per family by design)"),
    ("DL001", "        xs = torch.randn(3)  # noqa: "
              "DL001(display-only noise, never simulated)")])
def test_torch_spelling_waived_with_a_reason(rule, line):
    src = ("import torch\ndef train(fns, xs):\n    for fn in fns:\n"
           + line + "\n    return xs\n")
    fs = lint_source(src, rules=(rule,))
    assert len(fs) == 1 and fs[0].waived and fs[0].rule == rule
    bare = lint_source(src.replace(
        line, line[:line.index("(", line.index("noqa"))]), rules=(rule,))
    assert len(bare) == 1 and not bare[0].waived and bare[0].malformed_waiver


# --------------------------------------------------------------------------
# waivers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("line,want", [
    ("x = 1  # noqa: DL002(timing display)", {"DL002": "timing display"}),
    ("x = 1  # noqa: DL002", {"DL002": None}),
    ("x = 1  # noqa: DL002(a), DL005(b)", {"DL002": "a", "DL005": "b"}),
    ("x = 1  # noqa", {}),
    ("x = 1", {})])
def test_parse_waivers(line, want):
    assert parse_waivers(line) == want


@pytest.mark.parametrize("comment,waived,malformed", [
    ("# noqa: DL002(bench timing display)", True, False),
    ("# noqa: DL002", False, True),
    ("# noqa", False, False),
    ("# noqa: DL001(wrong rule)", False, False)])
def test_waiver_applies_only_with_its_rule_and_a_reason(comment, waived,
                                                        malformed):
    fs = _findings(f"""
        import time
        def stamp():
            return time.time()  {comment}
    """)
    assert len(fs) == 1
    assert fs[0].waived is waived and fs[0].malformed_waiver is malformed
    if waived:
        assert fs[0].waiver_reason == "bench timing display"
    if malformed:
        assert "reason required" in fs[0].message


def test_format_findings_counts():
    out = format_findings([
        Finding("a.py", 1, 0, "DL001", "m"),
        Finding("b.py", 2, 0, "DL002", "m", waived=True,
                waiver_reason="r")])
    assert "1 finding(s), 1 waived" in out


# --------------------------------------------------------------------------
# path scoping
# --------------------------------------------------------------------------


def _seed_tree(root, pkg):
    sim = root / "src" / pkg / "sim"
    core = root / "src" / pkg / "core"
    eng = root / "src" / pkg / "engine"
    bench = root / "benchmarks"
    for d in (sim, core, eng, bench):
        d.mkdir(parents=True, exist_ok=True)
    (sim / "bad_rng.py").write_text("import torch\nx = torch.rand(3)\n")
    (core / "clocky.py").write_text("import time\nx = time.time()\n")
    (sim / "fanout.py").write_text(textwrap.dedent("""
        def fan_out(sim, ids):
            live = set(ids)
            for nid in live:
                sim.schedule(0.0, nid)
    """))
    (eng / "loop.py").write_text(textwrap.dedent("""
        import torch
        def train(fns, xs):
            for fn in fns:
                xs = torch.compile(fn)(xs)
    """))
    (bench / "bench.py").write_text("import time\nx = time.time()\n")


def test_path_scoping_over_seeded_tree(tmp_path):
    """Four seeded violations land in scope; the benchmark wall-clock is
    excluded by DL002's default scope; a sibling package named like the
    reference is outside every scope."""
    (tmp_path / "pyproject.toml").write_text("")
    _seed_tree(tmp_path, "repro_torch")
    _seed_tree(tmp_path, "repro")
    config = AnalysisConfig(str(tmp_path))
    fs = lint_paths([str(tmp_path / "src"), str(tmp_path / "benchmarks")],
                    config=config)
    assert {(f.path, f.rule) for f in fs} == {
        ("src/repro_torch/sim/bad_rng.py", "DL001"),
        ("src/repro_torch/core/clocky.py", "DL002"),
        ("src/repro_torch/sim/fanout.py", "DL003"),
        ("src/repro_torch/engine/loop.py", "DL005"),
    }


def test_default_scopes_point_at_the_package():
    for r in RULES.values():
        assert r.paths and all(p.startswith("src/repro_torch")
                               for p in r.paths), r.id
    assert RULES["DL002"].exclude == ("src/repro_torch/utils/logging.py",
                                      "benchmarks")
    assert RULES["DL004"].paths == tuple(
        f"src/repro_torch/{d}" for d in ("sim", "core", "secureagg", "serve"))
    assert RULES["DL004"].exclude == ("src/repro_torch/sim/network.py",)
    assert RULES["DL005"].paths == ("src/repro_torch/engine",
                                    "src/repro_torch/kernels")


def test_pyproject_override_narrows_scope(tmp_path):
    (tmp_path / "pyproject.toml").write_text(textwrap.dedent("""
        [tool.repro-torch-analysis.DL002]
        paths = ["src/repro_torch/sim"]
    """))
    _seed_tree(tmp_path, "repro_torch")
    config = load_config(str(tmp_path))
    assert config.scopes["DL002"].paths == ("src/repro_torch/sim",)
    fs = lint_paths([str(tmp_path / "src")], config=config)
    assert not any(f.rule == "DL002" for f in fs)
    assert any(f.rule == "DL001" for f in fs)


def test_reference_section_is_not_read(tmp_path):
    """Only ``[tool.repro-torch-analysis]`` overrides this linter: the
    reference's ``[tool.repro-analysis]`` section leaves its defaults."""
    (tmp_path / "pyproject.toml").write_text(textwrap.dedent("""
        [tool.repro-analysis.DL002]
        paths = ["src/repro_torch/sim"]
    """))
    config = load_config(str(tmp_path))
    assert config.scopes["DL002"].paths == RULES["DL002"].paths


def test_repo_pyproject_leaves_the_defaults():
    config = load_config(SRC)
    assert config.root == REPO
    for rid, r in RULES.items():
        assert (config.scopes[rid].paths, config.scopes[rid].exclude) == (
            r.paths, r.exclude)


# --------------------------------------------------------------------------
# the package gate
# --------------------------------------------------------------------------


def test_package_is_lint_clean_and_every_waiver_has_a_reason():
    fs = lint_paths([SRC], config=load_config(SRC))
    unwaived = [f for f in fs if not f.waived]
    assert unwaived == [], "\n" + format_findings(fs)
    for f in fs:
        assert f.waiver_reason and f.waiver_reason.strip(), f.location()


def test_cli_exit_codes(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["lint", SRC]) == 0
    assert main([SRC]) == 0                      # lint is the default
    _seed_tree(tmp_path, "repro_torch")
    (tmp_path / "pyproject.toml").write_text("")
    assert main(["lint", str(tmp_path / "src")]) == 1
    assert main(["lint", "--format", "json", str(tmp_path / "src")]) == 1
    assert main(["explain"]) == 0
    assert main(["explain", "DL005"]) == 0
    assert main(["explain", "DL999"]) == 2
    assert main([]) == 2
    out = capsys.readouterr().out
    assert "torch tracing hazard" in out


def test_cli_races_is_clean_on_the_package_sessions(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["races", "--device", "cpu", "--n", "12",
                 "--duration", "60"]) == 0
    out = capsys.readouterr().out
    for name in ("ModestSession", "DSGDSession", "GossipSession"):
        assert f"[races] {name} n=12" in out
    assert out.count("-> clean") == 3


# --------------------------------------------------------------------------
# race detector
# --------------------------------------------------------------------------


class _FakeNode:
    def __init__(self):
        self.counter = 0


class _FakeSession:
    """Bare-simulator harness the detector duck-types against."""

    def __init__(self):
        from repro_torch.sim.clock import Simulator
        self.sim = Simulator()
        self.nodes = {"0": _FakeNode()}


def _two_writes(first, second):
    sess = _FakeSession()
    det = RaceDetector()
    det.attach(sess)
    node = sess.nodes["0"]
    sess.sim.schedule(1.0, lambda: setattr(node, "counter", first))
    sess.sim.schedule(1.0, lambda: setattr(node, "counter", second))
    sess.sim.run(until=2.0)
    return det, det.report()


def test_synthetic_same_timestamp_conflict_is_caught():
    _, report = _two_writes(1, 2)
    assert not report.clean and len(report.conflicts) == 1
    c = report.conflicts[0]
    assert c.key == ("round", "0", "counter")
    assert c.value_first == (1,) and c.value_second == (2,)
    assert "seq order" in c.describe()


def test_idempotent_double_write_is_not_a_conflict():
    _, report = _two_writes(5, 5)
    assert report.clean


def test_detector_is_single_use():
    det = RaceDetector()
    det.attach(_FakeSession())
    with pytest.raises(RuntimeError):
        det.attach(_FakeSession())


def test_link_lint_findings_marks_dl003_sites():
    det, report = _two_writes(1, 2)
    fake = [Finding(os.path.basename(__file__), 1, 0, "DL003", "m")]
    det.link_lint_findings(report, fake)
    assert report.conflicts[0].dl003_linked


@pytest.mark.parametrize("sub", ["sim", "core"])
def test_sim_and_core_never_import_analysis(sub):
    """Zero-cost proof, structural half: nothing under sim/ or core/
    references the instrument, which is installed from outside."""
    root = os.path.join(SRC, sub)
    files = [os.path.join(d, f) for d, _, fs in os.walk(root)
             for f in fs if f.endswith(".py")]
    assert files
    for fp in files:
        with open(fp) as fh:
            assert "repro_torch.analysis" not in fh.read(), fp


def _fingerprint(result) -> str:
    blob = json.dumps({"rt": result.round_times, "hist": result.history,
                       "usage": result.usage, "churn": result.churn_events},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _golden(name):
    from repro_torch.sim.runner import GossipSession, ModestSession
    from repro_torch.traces import diurnal_profile
    cls = {"ModestSession": ModestSession, "GossipSession": GossipSession}
    return lambda: cls[name](profile=diurnal_profile(n=24, seed=3),
                             device="cpu")


@pytest.mark.parametrize("name", ["ModestSession", "GossipSession"])
def test_golden_session_clean_and_byte_identical_under_instrument(name):
    """The pinned golden rows: the session run with and without the
    detector gives the reference's fingerprint, and shows no seq-order
    conflict."""
    report, identical = run_shadow_check(_golden(name), 180.0,
                                         fingerprint=_fingerprint)
    det = RaceDetector()
    sess = _golden(name)()
    det.attach(sess)
    res = sess.run(180.0)
    rounds, total_bytes, fp = GOLDEN[name]
    assert _fingerprint(res) == fp
    assert (res.rounds_completed, res.usage["total_bytes"]) == (
        rounds, total_bytes)
    assert identical
    assert report.clean, report.summary()
    assert det.report().clean
    assert report.events_observed > 1000           # it actually watched
    if name == "ModestSession":
        assert fp == "559411b78f352123"
