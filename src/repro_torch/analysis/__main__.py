"""CLI for the port's static invariant analyzer.

Exit status is 0 when every violation is suppressed or baselined, 1
otherwise, 2 when ``--rules`` selects no rule.

Examples::

    python -m repro_torch.analysis                     # the port's tree
    python -m repro_torch.analysis --rules RA3         # one family
    python -m repro_torch.analysis src/repro_torch/eig # one subtree
    python -m repro_torch.analysis --list-rules        # rule table
    python -m repro_torch.analysis --update-baseline   # grandfather it
"""
from __future__ import annotations

import argparse
import json
import sys

from .engine import (DEFAULT_BASELINE, analyze_paths, baseline_key,
                     default_roots, load_baseline, write_baseline)
from .rules import NO_COUNTERPART, all_rules, rules_matching


def _list_rules() -> None:
    rows = [(r.id, r) for r in all_rules()]
    rows += [(rid, None) for rid in NO_COUNTERPART]
    for rid, rule in sorted(rows, key=lambda row: row[0]):
        if rule is None:
            title, why = NO_COUNTERPART[rid]
            print(f"{rid}  no counterpart in the port "
                  f"(reference: {title})")
            print(f"       {why}")
            print()
            continue
        print(f"{rule.id}  {rule.title}  [{', '.join(rule.kinds)}]")
        for line in (type(rule).__doc__ or "").strip().splitlines():
            print(f"       {line.strip()}")
        print()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant analyzer of the port (see rules "
                    "with --list-rules)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: src/repro_torch, "
                         "chip_smoke.py, the kernel tools, "
                         "tests/test_torch_*.py)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule/family selectors, e.g. "
                         "'RA2' or 'RA101,RA3'")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file of grandfathered violations")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report baselined violations too")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current tree")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore the mtime cache for this run")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        _list_rules()
        return 0

    if args.rules:
        selectors = [s.strip() for s in args.rules.split(",") if s.strip()]
        rules = rules_matching(selectors)
        if not rules:
            print(f"error: no rules match {args.rules!r}", file=sys.stderr)
            return 2
    else:
        rules = all_rules()

    paths = args.paths or default_roots()
    violations = analyze_paths(paths, rules, use_cache=not args.no_cache,
                               explicit_fixtures=bool(args.paths))

    if args.update_baseline:
        path = write_baseline(violations, args.baseline)
        print(f"baseline: {len(violations)} entr"
              f"{'y' if len(violations) == 1 else 'ies'} -> {path}")
        return 0

    baseline = set() if args.no_baseline else load_baseline(args.baseline)
    fresh = [v for v in violations if baseline_key(v) not in baseline]
    grandfathered = len(violations) - len(fresh)

    if args.as_json:
        print(json.dumps({
            "violations": [
                {"rule": v.rule, "path": v.path, "line": v.line,
                 "message": v.message} for v in fresh],
            "grandfathered": grandfathered,
        }, indent=1))
    else:
        for v in fresh:
            print(v.format())
        tail = f" ({grandfathered} baselined)" if grandfathered else ""
        print(f"repro_torch.analysis: {len(fresh)} violation"
              f"{'' if len(fresh) == 1 else 's'}{tail}, "
              f"{len(rules)} rules")
    return 1 if fresh else 0


if __name__ == "__main__":
    raise SystemExit(main())
