"""AST linter for the package's determinism / protocol-safety contracts.

One pass per file: imports are resolved to canonical dotted names
(``np.random.rand`` -> ``numpy.random.rand``) so aliasing cannot dodge a
rule, then a single visitor applies every DLxxx rule active for the
file's path (scoping: ``repro_torch.analysis.config``).

Rules (catalog + contracts: ``repro_torch.analysis.rules``):

* **DL001** — module-global RNG draw (``random.*``, ``np.random.*``
  except the seeded constructors), or a torch draw from the process-global
  generator: ``torch.manual_seed`` (and its ``torch.random`` /
  ``torch.cuda`` spellings), ``torch.rand``/``randn``/``randint``/
  ``randperm``/``normal``/``bernoulli``/``multinomial`` and the in-place
  samplers (``t.normal_()``, ``t.uniform_()``, ...) called without
  ``generator=``.
* **DL002** — wall-clock read (``time.time``, ``datetime.now``,
  ``perf_counter``...) outside allow-listed timing/display paths.
* **DL003** — order-sensitive iteration over an unordered collection:
  ``for``/comprehension/``list()``/``tuple()``/``enumerate()`` over a
  set-typed expression, or sorting keyed on ``id()``. Order-insensitive
  folds (``sorted``/``min``/``max``/``sum``/``any``/``all``/``len``/
  set-to-set) are exempt.
* **DL004** — delivery bypassing the fault-interception point: direct
  ``*.receive(...)`` / ``*._dispatch(...)`` calls outside the fabric.
* **DL005** — torch tracing hazards: ``self.*`` assignment inside a
  function handed to ``torch.func`` or ``torch.compile`` (as decorator or
  argument; a state leak), or building ``torch.func.vmap``/``grad``/
  ``grad_and_value``, ``torch.vmap``, ``torch.compile``, a CUDA graph
  (``torch.cuda.CUDAGraph``, ``make_graphed_callables``) or loading a
  kernel library (``repro_torch.kernels.build.load``) inside a loop body
  (a per-iteration re-trace / re-compile).

Waiver grammar — a finding is waived by a same-line comment carrying a
**reason**::

    t0 = time.time()   # noqa: DL002(wall-clock timing display only)

Several waivers may share one comment: ``# noqa: DL002(...), DL005(...)``.
A reason is mandatory: ``# noqa: DL002`` alone is *malformed* and the
finding stays unwaived (the acceptance gate requires every waiver to say
why). Blanket ``# noqa`` without codes never waives a DL rule.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.config import AnalysisConfig, load_config

__all__ = ["Finding", "lint_source", "lint_paths", "format_findings"]


# --------------------------------------------------------------------------
# findings + waivers
# --------------------------------------------------------------------------


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    waived: bool = False
    waiver_reason: Optional[str] = None
    malformed_waiver: bool = False

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


_NOQA_RE = re.compile(r"#\s*noqa:\s*(?P<body>.*)$")
_WAIVER_RE = re.compile(r"DL(?P<num>\d{3})\s*(?:\((?P<reason>[^)]*)\))?")


def parse_waivers(line: str) -> Dict[str, Optional[str]]:
    """``{rule_id: reason-or-None}`` for one source line. ``None`` reason
    means the waiver is malformed (reason missing/empty)."""
    m = _NOQA_RE.search(line)
    if not m:
        return {}
    out: Dict[str, Optional[str]] = {}
    for w in _WAIVER_RE.finditer(m.group("body")):
        reason = (w.group("reason") or "").strip()
        out["DL" + w.group("num")] = reason or None
    return out


# --------------------------------------------------------------------------
# name resolution
# --------------------------------------------------------------------------

_STDLIB_RANDOM_DRAWS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "expovariate",
    "betavariate", "triangular", "seed", "getrandbits", "vonmisesvariate",
    "paretovariate", "weibullvariate", "lognormvariate", "binomialvariate",
}

# numpy.random names that *construct a seeded generator* rather than draw
# from the module-global stream.
_NP_SEEDED_OK = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator", "PCG64",
    "PCG64DXSM", "Philox", "MT19937", "SFC64", "RandomState",
}

_WALLCLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.clock_gettime",
    "time.clock_gettime_ns", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.datetime.today",
    "datetime.date.today",
}

# torch draws from the process-global generator unless ``generator=`` is
# passed; the seeding calls reset that global stream
_TORCH_GLOBAL_SEEDING = {
    "torch.manual_seed", "torch.random.manual_seed", "torch.seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
}
_TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
}
# tensor methods that sample in place (``t.normal_()``); without a
# generator they draw from the global stream
_TORCH_INPLACE_DRAWS = {
    "normal_", "uniform_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
}

# functions handed to these are traced: ``self`` must not be written there
_TRACERS = {
    "torch.func.vmap", "torch.func.grad", "torch.func.grad_and_value",
    "torch.func.vjp", "torch.func.jvp", "torch.func.jacrev",
    "torch.func.jacfwd", "torch.func.hessian", "torch.func.functionalize",
    "torch.vmap", "torch.compile",
}
# built once at setup time, never inside a loop body
_BUILDERS = _TRACERS | {
    "torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph",
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
    "repro_torch.kernels.build.load",
}

_ORDER_INSENSITIVE_CALLS = {
    "sorted", "min", "max", "sum", "len", "any", "all", "set", "frozenset",
}

_SET_METHODS = {"union", "intersection", "difference", "symmetric_difference",
                "copy"}


class _Imports:
    """Alias -> canonical dotted module/object name."""

    def __init__(self) -> None:
        self.names: Dict[str, str] = {}

    def collect(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.names[(a.asname or a.name.split(".")[0])] = (
                        a.name if a.asname else a.name.split(".")[0])
                    if a.asname is None and "." in a.name:
                        # `import jax.numpy` binds `jax`; the full path is
                        # reachable through attribute resolution anyway.
                        self.names[a.name.split(".")[0]] = a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:
                    continue                    # relative: out of scope
                for a in node.names:
                    self.names[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, if the base
        name is an import alias; bare builtins resolve to themselves."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.names.get(node.id, node.id)
        parts.append(base)
        return ".".join(reversed(parts))


# --------------------------------------------------------------------------
# set-typed symbol inference (module-wide, syntactic)
# --------------------------------------------------------------------------


def _is_set_expr(node: ast.AST, set_names: Set[str], set_attrs: Set[str],
                 depth: int = 0) -> bool:
    """Syntactically set-typed? Conservative, intraprocedural: literals,
    set()/frozenset() calls, set-method chains, unions of set-typed
    operands, and names/attributes recorded as set-assigned anywhere in
    the module (over-approximate by design — a shared name used as a set
    in one scope marks it everywhere)."""
    if depth > 8:
        return False
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in (
                "set", "frozenset"):
            return True
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _SET_METHODS
                and _is_set_expr(node.func.value, set_names, set_attrs,
                                 depth + 1)):
            return True
        return False
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (_is_set_expr(node.left, set_names, set_attrs, depth + 1)
                or _is_set_expr(node.right, set_names, set_attrs, depth + 1))
    if isinstance(node, ast.Name):
        return node.id in set_names
    if isinstance(node, ast.Attribute):
        return (isinstance(node.value, ast.Name)
                and node.value.id == "self" and node.attr in set_attrs)
    return False


def _collect_set_symbols(tree: ast.AST) -> Tuple[Set[str], Set[str]]:
    names: Set[str] = set()
    attrs: Set[str] = set()
    # two sweeps so `a = set(); b = a` style chains resolve one level deep
    for _ in range(2):
        for node in ast.walk(tree):
            value = None
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, list(node.targets)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AnnAssign):
                # dataclass-style `x: frozenset = ...`-less annotation
                ann = node.annotation
                if (isinstance(ann, ast.Name)
                        and ann.id in ("set", "frozenset")):
                    value, targets = ast.Set(elts=[]), [node.target]
            if value is None:
                continue
            if not _is_set_expr(value, names, attrs):
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                elif (isinstance(t, ast.Attribute)
                      and isinstance(t.value, ast.Name)
                      and t.value.id == "self"):
                    attrs.add(t.attr)
    return names, attrs


# --------------------------------------------------------------------------
# the visitor
# --------------------------------------------------------------------------


def _callable_name(arg: ast.AST, imports: "_Imports") -> Optional[str]:
    """The def a tracer's argument names: ``f``, ``self.f``, or the first
    argument of ``functools.partial(f, ...)``."""
    if isinstance(arg, ast.Name):
        return arg.id
    if (isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name)
            and arg.value.id == "self"):
        return arg.attr
    if (isinstance(arg, ast.Call) and arg.args
            and imports.resolve(arg.func) in ("functools.partial",
                                              "partial")):
        return _callable_name(arg.args[0], imports)
    return None


def _collect_traced_names(tree: ast.AST, imports: "_Imports") -> Set[str]:
    """Names of the defs handed to a tracer as an argument anywhere in the
    module (``torch.func.vmap(torch.func.grad(loss))`` marks ``loss``).
    Module-wide and by name, over-approximate like the set inference: a
    def of the same name elsewhere in the module counts as traced too."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and imports.resolve(node.func) in _TRACERS):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                name = _callable_name(arg, imports)
                if name is not None:
                    names.add(name)
    return names


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, imports: _Imports,
                 set_names: Set[str], set_attrs: Set[str],
                 active: Sequence[str],
                 traced_names: Optional[Set[str]] = None):
        self.path = path
        self.imports = imports
        self.set_names = set_names
        self.set_attrs = set_attrs
        self.active = set(active)
        self.traced_names = traced_names or set()
        self.findings: List[Finding] = []
        self._loop_depth = 0
        self._traced_depth = 0          # inside a def handed to a tracer
        self._order_exempt: Set[int] = set()

    # -- helpers -----------------------------------------------------------

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        if rule in self.active:
            self.findings.append(Finding(
                self.path, getattr(node, "lineno", 0),
                getattr(node, "col_offset", 0), rule, message))

    def _resolved(self, func: ast.AST) -> Optional[str]:
        return self.imports.resolve(func)

    def _is_set(self, node: ast.AST) -> bool:
        return (id(node) not in self._order_exempt
                and _is_set_expr(node, self.set_names, self.set_attrs))

    def _exempt(self, node: ast.AST) -> None:
        self._order_exempt.add(id(node))
        # exempting a comprehension argument exempts its iterable too:
        # sum(x for x in s) is an order-insensitive fold over s.
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            for gen in node.generators:
                self._order_exempt.add(id(gen.iter))

    def _is_builder(self, func: ast.AST) -> bool:
        # short forms (`from torch.func import vmap`) resolve to the
        # canonical names through the import table
        return self._resolved(func) in _BUILDERS

    def _is_tracer(self, func: ast.AST) -> bool:
        return self._resolved(func) in _TRACERS

    def _decorator_is_traced(self, dec: ast.AST) -> bool:
        if isinstance(dec, ast.Call):
            # @torch.compile(mode=...) / @partial(torch.func.grad, ...)
            name = self._resolved(dec.func)
            if name in ("functools.partial", "partial") and dec.args:
                return self._is_tracer(dec.args[0])
            return self._is_tracer(dec.func)
        return self._is_tracer(dec)

    # -- imports / functions ----------------------------------------------

    def _visit_def(self, node) -> None:
        traced = (node.name in self.traced_names
                  or any(self._decorator_is_traced(d)
                         for d in node.decorator_list))
        if traced:
            self._traced_depth += 1
            # a traced function body starts a fresh loop context: loops
            # *inside* a traced function run within one trace
            saved_loops, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        if traced:
            self._traced_depth -= 1
            self._loop_depth = saved_loops

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    # -- DL005a: tracer leak ----------------------------------------------

    def _check_self_store(self, node, targets) -> None:
        if self._traced_depth <= 0:
            return
        for t in targets:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                self._flag("DL005", node,
                           f"assignment to self.{t.attr} inside a function "
                           "handed to torch.func / torch.compile leaks a "
                           "batched or traced value into long-lived state "
                           "(wrong shape / stale constant)")

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_self_store(node, node.targets)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_self_store(node, [node.target])
        self.generic_visit(node)

    # -- loops (DL003 iteration + DL005b context) -------------------------

    def _visit_loop(self, node) -> None:
        if isinstance(node, ast.For) and self._is_set(node.iter):
            self._flag("DL003", node.iter,
                       "iteration over a set/frozenset: order depends on "
                       "PYTHONHASHSEED; sort it (sorted(...)) or keep an "
                       "insertion-ordered dict")
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            if not isinstance(node, ast.SetComp) and self._is_set(gen.iter):
                self._flag("DL003", gen.iter,
                           "comprehension over a set/frozenset escapes its "
                           "nondeterministic order into an ordered result; "
                           "sort the iterable")
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_SetComp = _visit_comp

    # -- calls ------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = self._resolved(node.func)

        # order-insensitive folds exempt their direct arguments (DL003)
        if (isinstance(node.func, ast.Name)
                and node.func.id in _ORDER_INSENSITIVE_CALLS):
            for arg in node.args:
                self._exempt(arg)

        # DL003: materializing a set into an ordered sequence
        if isinstance(node.func, ast.Name) and node.func.id in (
                "list", "tuple", "enumerate"):
            for arg in node.args[:1]:
                if self._is_set(arg):
                    self._flag(
                        "DL003", arg,
                        f"{node.func.id}() over a set/frozenset freezes a "
                        "PYTHONHASHSEED-dependent order into a sequence; "
                        "sort first")

        # DL003: sorting keyed on object identity
        if (isinstance(node.func, ast.Name)
                and node.func.id in ("sorted", "min", "max")):
            for kw in node.keywords:
                if kw.arg == "key" and self._key_uses_id(kw.value):
                    self._flag("DL003", kw.value,
                               f"{node.func.id}(..., key=id) orders by "
                               "object address — nondeterministic across "
                               "runs; key on stable identity instead")

        # DL001: module-global RNG draws
        if name:
            parts = name.split(".")
            if (parts[0] == "random" and len(parts) == 2
                    and parts[1] in _STDLIB_RANDOM_DRAWS):
                self._flag("DL001", node,
                           f"stdlib {name}() draws from the process-global "
                           "RNG; draw from a session-owned "
                           "np.random.default_rng(seed) in event order")
            elif (name.startswith("numpy.random.")
                    and parts[-1] not in _NP_SEEDED_OK):
                self._flag("DL001", node,
                           f"module-global numpy RNG draw {name}(); use a "
                           "session-owned default_rng(seed) so the "
                           "trajectory stays a pure function of the seed")
            elif name in _TORCH_GLOBAL_SEEDING:
                self._flag("DL001", node,
                           f"{name}() reseeds torch's process-global "
                           "generator; draw from an explicit "
                           "torch.Generator().manual_seed(seed) instead")
            elif name in _TORCH_DRAWS and not self._has_generator(node):
                self._flag("DL001", node,
                           f"{name}() without generator= draws from torch's "
                           "process-global generator; pass an explicit "
                           "torch.Generator")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _TORCH_INPLACE_DRAWS
                and not self._has_generator(node)):
            self._flag("DL001", node,
                       f".{node.func.attr}() without generator= samples from "
                       "torch's process-global generator; pass an explicit "
                       "torch.Generator")

        # DL002: wall clock
        if name in _WALLCLOCK:
            self._flag("DL002", node,
                       f"{name}() reads host wall-clock in simulation-"
                       "semantics code; simulated time is Simulator.now "
                       "(waive with a reason if this is timing display)")

        # DL004: interception-point bypass
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "receive", "_dispatch"):
            self._flag("DL004", node,
                       f"direct .{node.func.attr}(...) call bypasses "
                       "Network.send -> FaultInjector.transit — the fault "
                       "fabric never sees this delivery")

        # DL005b: building a transform, a compiled function, a CUDA graph
        # or a kernel library inside a Python loop
        if self._loop_depth > 0 and self._is_builder(node.func):
            self._flag("DL005", node,
                       f"{name}(...) built inside a loop body re-traces / "
                       "re-compiles / re-captures per iteration; hoist it "
                       "to setup time")

        self.generic_visit(node)

    @staticmethod
    def _has_generator(node: ast.Call) -> bool:
        return any(kw.arg == "generator" for kw in node.keywords)

    @staticmethod
    def _key_uses_id(key: ast.AST) -> bool:
        if isinstance(key, ast.Name) and key.id == "id":
            return True
        if isinstance(key, ast.Lambda):
            for sub in ast.walk(key.body):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id == "id"):
                    return True
        return False


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

_ALL_RULES = ("DL001", "DL002", "DL003", "DL004", "DL005")


def lint_source(source: str, path: str = "<string>",
                rules: Sequence[str] = _ALL_RULES) -> List[Finding]:
    """Lint one source blob with an explicit rule set (no path scoping);
    waivers on the findings' lines are applied."""
    tree = ast.parse(source, filename=path)
    imports = _Imports()
    imports.collect(tree)
    set_names, set_attrs = _collect_set_symbols(tree)
    v = _Visitor(path, imports, set_names, set_attrs, rules,
                 _collect_traced_names(tree, imports))
    v.visit(tree)
    lines = source.splitlines()
    for f in v.findings:
        waivers = parse_waivers(lines[f.line - 1]) if (
            0 < f.line <= len(lines)) else {}
        if f.rule in waivers:
            reason = waivers[f.rule]
            if reason is None:
                f.malformed_waiver = True
                f.message += "  [waiver rejected: reason required — use "
                f.message += f"`# noqa: {f.rule}(why)`]"
            else:
                f.waived = True
                f.waiver_reason = reason
    v.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return v.findings


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith((".", "__pycache")))
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames) if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def lint_paths(paths: Sequence[str],
               config: Optional[AnalysisConfig] = None) -> List[Finding]:
    """Lint files/trees with per-path rule scoping from the repo config."""
    config = config or load_config(paths[0] if paths else ".")
    findings: List[Finding] = []
    for fp in _iter_py_files(paths):
        active = config.active_rules(fp)
        if not active:
            continue
        with open(fp, encoding="utf-8") as fh:
            src = fh.read()
        for f in lint_source(src, path=config.rel(fp), rules=active):
            findings.append(f)
    return findings


def format_findings(findings: Sequence[Finding], *,
                    show_waived: bool = False) -> str:
    lines = []
    for f in findings:
        if f.waived and not show_waived:
            continue
        tag = " [waived: %s]" % f.waiver_reason if f.waived else ""
        lines.append(f"{f.location()}: {f.rule} {f.message}{tag}")
    unwaived = sum(1 for f in findings if not f.waived)
    waived = sum(1 for f in findings if f.waived)
    lines.append(f"{unwaived} finding(s), {waived} waived")
    return "\n".join(lines)
