"""Per-path configuration for ``repro_torch.analysis``.

Defaults live in :mod:`repro_torch.analysis.rules` (each rule carries its
own path scope); ``pyproject.toml`` overrides them under a section of
this package's own, ``[tool.repro-torch-analysis]``, and nothing else is
read::

    [tool.repro-torch-analysis]
    # override a rule's scope (prefix match on repo-relative posix paths)
    [tool.repro-torch-analysis.DL002]
    paths = ["src/repro_torch"]
    exclude = ["src/repro_torch/utils/logging.py", "benchmarks"]

TOML parsing is version-gated: ``tomllib`` (3.11+), else ``tomli`` if
present, else the embedded defaults are used unchanged — the linter must
run in minimal containers without growing a dependency.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.analysis.rules import RULES, Rule

try:                                    # 3.11+
    import tomllib as _toml
except ImportError:                     # pragma: no cover - version dependent
    try:
        import tomli as _toml          # type: ignore[no-redef]
    except ImportError:
        _toml = None

SECTION = "repro-torch-analysis"


@dataclass(frozen=True)
class RuleScope:
    paths: Tuple[str, ...]
    exclude: Tuple[str, ...]

    def applies(self, rel_path: str) -> bool:
        p = rel_path.replace(os.sep, "/")
        if not any(p == pre or p.startswith(pre.rstrip("/") + "/")
                   for pre in self.paths):
            return False
        return not any(p == ex or p.startswith(ex.rstrip("/") + "/")
                       for ex in self.exclude)


def _default_scopes() -> Dict[str, RuleScope]:
    return {rid: RuleScope(r.paths, r.exclude) for rid, r in RULES.items()}


class AnalysisConfig:
    """Resolved rule scopes + the repo root all paths are relative to."""

    def __init__(self, root: str,
                 scopes: Optional[Dict[str, RuleScope]] = None):
        self.root = os.path.abspath(root)
        self.scopes = scopes or _default_scopes()

    def rel(self, path: str) -> str:
        ap = os.path.abspath(path)
        if ap.startswith(self.root + os.sep):
            ap = ap[len(self.root) + 1:]
        return ap.replace(os.sep, "/")

    def active_rules(self, path: str) -> Tuple[str, ...]:
        rel = self.rel(path)
        return tuple(rid for rid, scope in self.scopes.items()
                     if scope.applies(rel))


def _find_root(start: str) -> str:
    """Nearest ancestor containing pyproject.toml or .git; else start."""
    d = os.path.abspath(start)
    while True:
        if (os.path.exists(os.path.join(d, "pyproject.toml"))
                or os.path.exists(os.path.join(d, ".git"))):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start)
        d = parent


def load_config(start: str = ".") -> AnalysisConfig:
    """Config for the repo containing ``start``: embedded rule defaults,
    overridden by ``[tool.repro-torch-analysis]`` when pyproject.toml is
    readable and a TOML parser is available."""
    root = _find_root(start)
    scopes = _default_scopes()
    pp = os.path.join(root, "pyproject.toml")
    if _toml is not None and os.path.exists(pp):
        with open(pp, "rb") as fh:
            data = _toml.load(fh)
        section = data.get("tool", {}).get(SECTION, {})
        for rid, override in section.items():
            if rid not in scopes or not isinstance(override, dict):
                continue
            base = scopes[rid]
            scopes[rid] = RuleScope(
                tuple(override.get("paths", base.paths)),
                tuple(override.get("exclude", base.exclude)))
    return AnalysisConfig(root, scopes)


def default_rule(rule_id: str) -> Rule:
    return RULES[rule_id]
