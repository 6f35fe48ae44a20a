"""Determinism & protocol-safety static analysis of this package.

Two instruments guard the contracts every golden/conformance test rests
on (tie-break pinning, RNG purity, the single fault-interception point,
build-once cohort steps):

* :mod:`repro_torch.analysis.lint` — AST rules DL001–DL005 with a
  ``# noqa: DLxxx(reason)`` waiver grammar and per-path scoping from
  ``pyproject.toml`` (``[tool.repro-torch-analysis]``).
  CLI: ``python -m repro_torch.analysis lint src/repro_torch``.
* :mod:`repro_torch.analysis.races` — a shadow-mode simulator instrument
  that records per-handler write sets and flags equal-timestamp event
  pairs whose outcome only *happens* to be deterministic.
  CLI: ``python -m repro_torch.analysis races``.

Nothing under ``sim/`` or ``core/`` imports this package: the instrument
is installed from outside.
"""

from repro_torch.analysis.lint import (Finding, format_findings, lint_paths,
                                       lint_source)
from repro_torch.analysis.races import RaceDetector

__all__ = ["Finding", "format_findings", "lint_paths", "lint_source",
           "RaceDetector"]
