"""Rule catalog: the determinism / protocol-safety contracts each DLxxx
rule protects, as data.

The linter (``repro_torch.analysis.lint``) implements the detection logic;
this module is the single place where a rule's identity — id, title, the
contract it guards, and the default path scope it applies to — lives, so
the CLI ``explain`` output and the per-path config draw from one source.

Path scopes are prefix matches against the repo-relative posix path of
the linted file. ``paths`` = where the rule fires; ``exclude`` = carve-
outs (e.g. the network fabric itself is exempt from the interception-
bypass rule — it *is* the interception point). Both are overridable from
``pyproject.toml`` ``[tool.repro-torch-analysis]`` (see
``repro_torch.analysis.config``). A prefix matches whole path components,
so ``src/repro_torch`` never reaches a sibling package and the scopes of
another package's linter never reach this one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

PACKAGE = "src/repro_torch"


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    contract: str                    # the invariant this rule protects
    rationale: str                   # why violating it breaks the invariant
    paths: Tuple[str, ...] = (PACKAGE,)
    exclude: Tuple[str, ...] = field(default_factory=tuple)


RULES = {
    "DL001": Rule(
        id="DL001",
        title="unseeded / module-global RNG in simulation-semantics code",
        contract=(
            "Every trajectory is a pure function of (seed, schedule): all "
            "randomness is drawn from a session-owned "
            "np.random.default_rng(seed) in simulator event order, and "
            "every tensor draw from an explicit torch.Generator."
        ),
        rationale=(
            "Module-level np.random.* / stdlib random.* draws, and torch "
            "draws without generator= (or torch.manual_seed), consume a "
            "process-global stream whose state depends on import order and "
            "whatever ran before the session — the same seed then replays "
            "a different trajectory and the golden tests go flaky."
        ),
    ),
    "DL002": Rule(
        id="DL002",
        title="wall-clock read in simulation-semantics code",
        contract=(
            "Simulated time is Simulator.now, advanced only by the event "
            "queue; nothing semantic may observe host wall-clock."
        ),
        rationale=(
            "time.time()/datetime.now()/perf_counter() values differ per "
            "run and per machine; any one of them feeding an event delay, "
            "an RNG seed or a recorded metric makes trajectories "
            "irreproducible. Timing *display* (benchmarks, progress "
            "logging) is fine — allow-list the path or waive the line."
        ),
        exclude=(f"{PACKAGE}/utils/logging.py", "benchmarks"),
    ),
    "DL003": Rule(
        id="DL003",
        title="order-sensitive iteration over an unordered collection",
        contract=(
            "Event tie-breaking is (time, seq) with seq = schedule-call "
            "order; flow sets are insertion-ordered dicts so tie-breaking "
            "is deterministic by construction. Anything feeding the event "
            "queue, an RNG draw, a digest or a float accumulation must "
            "iterate in a deterministic order."
        ),
        rationale=(
            "CPython set/frozenset iteration order over str keys depends "
            "on PYTHONHASHSEED: a for-loop over a set that schedules "
            "events or consumes RNG yields a different seq assignment / "
            "stream position per process. Sorting by id() is the same "
            "hazard (object addresses). Membership tests and order-"
            "insensitive folds (any/all/min/max/sum/len) are fine; "
            "sorted(s) is the canonical fix."
        ),
    ),
    "DL004": Rule(
        id="DL004",
        title="message delivery bypassing the fault-interception point",
        contract=(
            "Network.send is the single interception point: every WAN "
            "message consults FaultInjector.transit, so a fault schedule "
            "sees ALL protocol traffic."
        ),
        rationale=(
            "Calling node.receive(...) directly, or reaching into "
            "Network._dispatch, delivers a message the fault fabric never "
            "saw — a blind spot where Drop/Duplicate/Partition rules "
            "silently do not apply and conformance schedules stop "
            "covering the code path."
        ),
        paths=(f"{PACKAGE}/sim", f"{PACKAGE}/core", f"{PACKAGE}/secureagg",
               f"{PACKAGE}/serve"),
        exclude=(f"{PACKAGE}/sim/network.py",),
    ),
    "DL005": Rule(
        id="DL005",
        title="torch tracing hazard (state leak / per-iteration rebuild)",
        contract=(
            "Engine hot loops build once and replay: the cohort step is "
            "built once a task (engine/cohort.py::_cohort_ops) and "
            "replayed every batch; functions handed to torch.func or "
            "torch.compile are pure, and torch.func transforms, compiled "
            "functions, CUDA graphs and kernel libraries are built at "
            "setup time, not per iteration."
        ),
        rationale=(
            "Assigning to self.* inside a function handed to torch.func "
            "(vmap/grad) or torch.compile stores a batched or traced "
            "tensor — or a value captured once at trace time — into "
            "long-lived state (a stale constant, or a tensor of the wrong "
            "shape); building torch.func.vmap/grad, torch.compile, a CUDA "
            "graph or loading a kernel library inside a loop body "
            "re-traces, re-compiles or re-captures per iteration, turning "
            "the hot path into a compile loop."
        ),
        paths=(f"{PACKAGE}/engine", f"{PACKAGE}/kernels"),
    ),
}


def rule(rule_id: str) -> Rule:
    return RULES[rule_id]
