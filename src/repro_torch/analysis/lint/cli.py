"""CLI for repro-lint: ``python -m repro_torch.analysis.lint [paths] [--strict]``.

Prints a per-rule summary table, the violation list, and (on GitHub
Actions) appends the same table to ``$GITHUB_STEP_SUMMARY`` so the CI job
page shows which invariant broke without digging through logs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.lint.core import (FILE_ALLOWLIST, RULES, Violation,
                                      lint_paths)
from repro_torch.analysis.lint import rules as _rules  # noqa: F401  (registers)

#: default scan root: the ``repro_torch`` package this linter lives in.
DEFAULT_ROOT = Path(__file__).resolve().parents[2]


def _rule_table(violations: List[Violation]) -> List[tuple]:
    counts = {rid: 0 for rid in sorted(RULES)}
    for v in violations:
        counts[v.rule] = counts.get(v.rule, 0) + 1
    return [(rid, RULES[rid][0] if rid in RULES else "(parse error)", n)
            for rid, n in sorted(counts.items())]


def _markdown_summary(violations: List[Violation], n_files: int) -> str:
    lines = ["## repro-lint invariants", "",
             f"Scanned {n_files} file(s); "
             f"**{len(violations)} violation(s)**.", "",
             "| rule | invariant | violations |",
             "| --- | --- | ---: |"]
    for rid, title, n in _rule_table(violations):
        lines.append(f"| {rid} | {title} | {n} |")
    if violations:
        lines += ["", "```"]
        lines += [v.format() for v in violations[:50]]
        if len(violations) > 50:
            lines.append(f"... and {len(violations) - 50} more")
        lines.append("```")
    return "\n".join(lines) + "\n"


def run(argv: Optional[List[str]] = None) -> int:
    """Run the linter; returns the number of violations found."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repro-lint: AST invariant checker (rules R002, R004-R006)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help=f"files or trees to lint (default: {DEFAULT_ROOT})")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on any violation (CI mode)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, (title, _) in sorted(RULES.items()):
            print(f"{rid}  {title}")
        for (suffix, rid), reason in sorted(FILE_ALLOWLIST.items()):
            print(f"allow  {rid} {suffix}: {reason}")
        return 0

    rule_ids = ([r.strip() for r in args.rules.split(",") if r.strip()]
                if args.rules else None)
    if rule_ids:
        unknown = [r for r in rule_ids if r not in RULES]
        if unknown:
            ap.error(f"unknown rule(s): {unknown}; known: {sorted(RULES)}")
    paths = args.paths or [DEFAULT_ROOT]
    violations = lint_paths(paths, rules=rule_ids)
    n_files = sum(1 for p in paths for _ in
                  ([p] if Path(p).is_file() else Path(p).rglob("*.py")))

    if args.format == "json":
        print(json.dumps({
            "files": n_files,
            "violations": [vars(v) for v in violations],
            "by_rule": {rid: n for rid, _, n in _rule_table(violations)},
        }, indent=2))
    else:
        for v in violations:
            print(v.format())
        print(f"repro-lint: {len(violations)} violation(s) in "
              f"{n_files} file(s) "
              f"[{', '.join(f'{rid}:{n}' for rid, _, n in _rule_table(violations))}]")

    summary_path = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary_path:
        with open(summary_path, "a") as fh:
            fh.write(_markdown_summary(violations, n_files))
    return len(violations)


def main(argv: Optional[List[str]] = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    n = run(args)
    raise SystemExit(1 if n and "--strict" in args else 0)
