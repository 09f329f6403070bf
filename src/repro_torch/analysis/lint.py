"""CLI: ``python -m repro_torch.analysis.lint src/repro_torch [--strict]``.

Runs every rule over the given paths, prints findings as
``file:line  rule-id  message  (hint)``, writes the machine-readable
report to ``results/torch/lint_report.json`` (override with ``--json``;
``results/lint_report.json`` is the JAX package's linter's), and in
``--strict`` mode exits non-zero when any unsuppressed finding remains —
the gate.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Sequence

from repro_torch.analysis.framework import (
    Finding,
    Rule,
    load_files,
    report_dict,
    run_rules,
    write_report,
)
from repro_torch.analysis.rules_events import EmitSiteRule
from repro_torch.analysis.rules_lifecycle import FailClosedExceptRule, PinBalanceRule
from repro_torch.analysis.rules_metrics import MetricDriftRule
from repro_torch.analysis.rules_purity import DevicePathPurityRule, NondeterminismRule

ALL_RULES = (
    EmitSiteRule,
    PinBalanceRule,
    FailClosedExceptRule,
    MetricDriftRule,
    NondeterminismRule,
    DevicePathPurityRule,
)
DEFAULT_REPORT = "results/torch/lint_report.json"


def build_rules(only: Sequence[str] = ()) -> List[Rule]:
    rules = [cls() for cls in ALL_RULES]
    if only:
        rules = [r for r in rules if r.rule_id in only]
    return rules


def lint_paths(paths: Sequence[str], only: Sequence[str] = ()) -> List[Finding]:
    """Library entry: all findings (suppressed ones included)."""
    return run_rules(load_files(paths), build_rules(only))


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.lint", description=__doc__)
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument(
        "--strict",
        action="store_true",
        help="exit non-zero on any unsuppressed finding (the gate)",
    )
    ap.add_argument(
        "--rules",
        default="",
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--json",
        default=DEFAULT_REPORT,
        help="machine-readable report path ('' to skip)",
    )
    args = ap.parse_args(argv)

    rules = build_rules([r for r in args.rules.split(",") if r])
    files = load_files(args.paths)
    findings = run_rules(files, rules)
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]

    for f in active:
        print(f"{f.location()}  {f.rule}  {f.message}  ({f.hint})")

    if args.json:
        write_report(Path(args.json), report_dict(args.paths, rules, findings))

    print(
        f"lint: {len(files)} files, {len(active)} findings, "
        f"{len(suppressed)} suppressed"
        + (f" -> {args.json}" if args.json else "")
    )
    if args.strict and active:
        print("lint: STRICT — unsuppressed findings fail the gate", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
