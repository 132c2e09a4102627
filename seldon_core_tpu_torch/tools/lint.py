"""Invariant linter CLI (``seldon_core_tpu_torch/analysis``).

Port of ``seldon_core_tpu/tools/lint.py``:

    python -m seldon_core_tpu_torch.tools.lint [paths...]
        [--rules commit-point,RD001,...] [--json]
        [--baseline FILE | --no-baseline] [--write-baseline FILE]
        [--list-rules]

Exit codes: 0 = clean (no non-baselined findings), 1 = findings,
2 = usage / IO error. Default path is the ``seldon_core_tpu_torch``
package; the default baseline is ``lint-baseline-torch.json`` next to
pyproject.toml (the repo root), when present.

Pure stdlib — safe for CI preflight and the tier-1 guard test (no torch
import, runs in well under a second on this tree).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from seldon_core_tpu_torch.analysis import (
    Baseline,
    lint_paths,
    rule_catalogue,
)

BASELINE_NAME = "lint-baseline-torch.json"


def repo_root_for(path: str) -> str:
    """Nearest ancestor holding pyproject.toml (else the path itself) —
    finding paths are reported relative to it, which is what keeps the
    checked-in baseline stable regardless of the invoking cwd."""
    d = os.path.abspath(path if os.path.isdir(path) else os.path.dirname(path))
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        nd = os.path.dirname(d)
        if nd == d:
            return os.path.abspath(path if os.path.isdir(path) else os.path.dirname(path))
        d = nd


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m seldon_core_tpu_torch.tools.lint",
        description="AST invariant linter: commit-point, registry-drift, "
        "phase-registry",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files/dirs to lint (default: the seldon_core_tpu_torch package)",
    )
    ap.add_argument(
        "--rules",
        default="",
        help="comma-separated pass names or rule ids (e.g. "
        "'commit-point,RD001'); default: all",
    )
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--baseline",
        default=None,
        help=f"baseline file of accepted findings (default: {BASELINE_NAME} "
        "at the repo root, when present)",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore any baseline (report every finding)",
    )
    ap.add_argument(
        "--write-baseline",
        default=None,
        metavar="FILE",
        help="write current findings as the new baseline and exit 0",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalogue"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for pass_name, rules in rule_catalogue().items():
            print(pass_name)
            for rid, desc in rules.items():
                print(f"  {rid}  {desc}")
        return 0

    paths = args.paths
    if not paths:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        paths = [pkg]
    for p in paths:
        if not os.path.exists(p):
            print(f"lint: no such path: {p}", file=sys.stderr)
            return 2
    root = repo_root_for(paths[0])

    rules = [r for r in args.rules.split(",") if r.strip()] or None
    try:
        findings = lint_paths(paths, root=root, rules=rules)
    except ValueError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        Baseline.from_findings(findings).dump(args.write_baseline)
        print(
            f"lint: wrote {len(findings)} finding(s) to {args.write_baseline}"
        )
        return 0

    baseline = Baseline()
    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline:
        candidate = os.path.join(root, BASELINE_NAME)
        if os.path.exists(candidate):
            baseline_path = candidate
    if baseline_path is not None and not args.no_baseline:
        try:
            baseline = Baseline.load(baseline_path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"lint: cannot load baseline {baseline_path}: {e}", file=sys.stderr)
            return 2

    new, baselined, stale = baseline.split(findings)

    if args.json:
        print(
            json.dumps(
                {
                    "version": 1,
                    "findings": [f.to_dict() for f in new],
                    "baselined": [f.to_dict() for f in baselined],
                    "stale_baseline_entries": stale,
                    "counts": {
                        "new": len(new),
                        "baselined": len(baselined),
                        "stale_baseline_entries": len(stale),
                    },
                },
                indent=2,
            )
        )
        return 1 if new else 0

    for f in new:
        print(f.render())
    if baselined:
        print(f"lint: {len(baselined)} baselined finding(s) suppressed")
    for e in stale:
        print(
            "lint: stale baseline entry (matched nothing): "
            f"{e['rule']} {e['path']} {e['symbol']}",
            file=sys.stderr,
        )
    if new:
        print(f"lint: {len(new)} finding(s)", file=sys.stderr)
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
