"""CLI: ``python -m repro_torch.analysis [lint] paths...`` (lint),
``python -m repro_torch.analysis races`` (shadow-mode conflict check over
the package's MoDeST, D-SGD and Gossip sessions) and
``python -m repro_torch.analysis explain [DLxxx...]`` (the rule catalog).

    PYTHONPATH=src python -m repro_torch.analysis lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis races --device cpu

Exit codes: 0 = clean (no unwaived findings / zero conflicts and
byte-identical instrumented trajectory), 1 = violations, 2 = usage.
The sessions of ``races`` carry byte-size payloads only; like every entry
point of the package they run on the card unless ``--device`` names
another.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.config import load_config
from repro_torch.analysis.lint import format_findings, lint_paths
from repro_torch.analysis.races import run_shadow_check
from repro_torch.analysis.rules import PACKAGE, RULES


def _cmd_lint(args) -> int:
    config = load_config(args.paths[0])
    findings = lint_paths(args.paths, config=config)
    if args.format == "json":
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        print(format_findings(findings, show_waived=args.show_waived))
    return 1 if any(not f.waived for f in findings) else 0


def _cmd_races(args) -> int:
    # Imported lazily: lint mode must not pay (or require) the simulator.
    from repro_torch.sim.runner import (DSGDSession, GossipSession,
                                        ModestSession)
    from repro_torch.traces import diurnal_profile

    lint_index = lint_paths([PACKAGE]) if args.link_lint else []
    ok = True
    for cls in (ModestSession, DSGDSession, GossipSession):
        def factory(cls=cls):
            return cls(profile=diurnal_profile(n=args.n, seed=args.seed),
                       device=args.device)

        report, identical = run_shadow_check(factory, args.duration)
        if args.link_lint:
            from repro_torch.analysis.races import RaceDetector
            RaceDetector().link_lint_findings(report, lint_index)
        status = ("clean" if report.clean else "CONFLICTS") + (
            "" if identical else " / TRAJECTORY DIVERGED")
        print(f"[races] {cls.__name__} n={args.n} seed={args.seed} "
              f"dur={args.duration}: {report.summary().splitlines()[0]}"
              f" -> {status}")
        for line in report.summary().splitlines()[1:]:
            print("  " + line)
        ok = ok and report.clean and identical
    return 0 if ok else 1


def _cmd_explain(args) -> int:
    for rid in (args.rules or sorted(RULES)):
        r = RULES.get(rid.upper())
        if r is None:
            print(f"unknown rule {rid!r}", file=sys.stderr)
            return 2
        print(f"{r.id} — {r.title}\n  contract: {r.contract}\n"
              f"  rationale: {r.rationale}\n  scope: {list(r.paths)}"
              f" (exclude {list(r.exclude)})\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="determinism & protocol-safety static analysis")
    sub = ap.add_subparsers(dest="cmd")

    lint = sub.add_parser("lint", help="AST lint (default command)")
    lint.add_argument("paths", nargs="+")
    lint.add_argument("--format", choices=("text", "json"), default="text")
    lint.add_argument("--show-waived", action="store_true")

    races = sub.add_parser(
        "races", help="shadow-mode same-timestamp conflict check over the "
                      "golden diurnal sessions")
    races.add_argument("--n", type=int, default=24)
    races.add_argument("--seed", type=int, default=3)
    races.add_argument("--duration", type=float, default=180.0)
    races.add_argument("--link-lint", action="store_true",
                       help="cross-reference conflicts with DL003 findings")
    races.add_argument("--device", default=None,
                       help="torch device of the sessions (default: cuda)")

    explain = sub.add_parser("explain", help="print the rule catalog")
    explain.add_argument("rules", nargs="*")

    argv = list(sys.argv[1:] if argv is None else argv)
    # default command: `python -m repro_torch.analysis src/repro_torch`
    if argv and argv[0] not in ("lint", "races", "explain", "-h", "--help"):
        argv = ["lint"] + argv
    args = ap.parse_args(argv)
    if args.cmd == "lint":
        return _cmd_lint(args)
    if args.cmd == "races":
        return _cmd_races(args)
    if args.cmd == "explain":
        return _cmd_explain(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:        # `... | head` closed the pipe; not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
