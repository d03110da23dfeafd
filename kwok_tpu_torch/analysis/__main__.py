"""kwoklint CLI: ``python -m kwok_tpu_torch.analysis [paths]``.

The port's counterpart of ``python -m kwok_tpu.analysis``: the same flags
and exit codes (0 = clean, 1 = unsuppressed findings, 2 = usage error),
the port's rule pack, and ``kwok_tpu_torch`` as the default path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kwok_tpu_torch.analysis.core import Analyzer, all_rules

#: disclosed runtime budget (the reference's): the whole rule pack must
#: stay comfortably interactive
BUDGET_S = 30.0


def repo_root() -> str:
    """The tree kwoklint ships in: two levels above this package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kwok_tpu_torch.analysis",
        description="kwoklint: concurrency + kernel-purity static analysis",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to analyze (default: the kwok_tpu_torch package)",
    )
    parser.add_argument(
        "--rule", action="append", default=None,
        help="run only this rule (repeatable)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text"
    )
    parser.add_argument(
        "--jsonl", action="store_true",
        help="machine-readable output: one JSON object per finding, then "
        "one {\"summary\": ...} line (overrides --format)",
    )
    parser.add_argument(
        "--timings", action="store_true",
        help="per-rule timing footer (text mode; always present in "
        "--jsonl summaries)",
    )
    parser.add_argument(
        "--root", default=None,
        help="repo root for relative paths + docs (default: autodetected)",
    )
    args = parser.parse_args(argv)

    root = os.path.abspath(args.root) if args.root else repo_root()
    rules = all_rules(root)
    if args.list_rules:
        for r in rules:
            print(f"{r.name:22s} {r.description}")
        return 0
    if args.rule:
        known = {r.name for r in rules}
        bad = set(args.rule) - known
        if bad:
            print(
                f"unknown rule(s): {', '.join(sorted(bad))} "
                f"(known: {', '.join(sorted(known))})",
                file=sys.stderr,
            )
            return 2
        rules = [r for r in rules if r.name in set(args.rule)]

    paths = args.paths or [os.path.join(root, "kwok_tpu_torch")]
    paths = [os.path.abspath(p) for p in paths]
    for p in paths:
        if not os.path.exists(p):
            print(f"no such path: {p}", file=sys.stderr)
            return 2

    analyzer = Analyzer(root, rules)
    findings, suppressed = analyzer.run(paths)
    timings = analyzer.timings
    total = sum(timings.values())
    if args.jsonl:
        for f in findings:
            print(json.dumps(vars(f), sort_keys=True))
        print(json.dumps({"summary": {
            "findings": len(findings),
            "suppressed": suppressed,
            "timings_s": {k: round(v, 4) for k, v in timings.items()},
            "total_s": round(total, 4),
            "budget_s": BUDGET_S,
        }}, sort_keys=True))
    elif args.format == "json":
        print(json.dumps(
            {
                "findings": [vars(f) for f in findings],
                "suppressed": suppressed,
                "timings_s": {k: round(v, 4) for k, v in timings.items()},
                "total_s": round(total, 4),
                "budget_s": BUDGET_S,
            },
            indent=1,
        ))
    else:
        for f in findings:
            print(f.format())
        tail = f"{len(findings)} finding(s), {suppressed} suppressed"
        print(f"kwoklint: {tail}" if findings else f"kwoklint: clean ({tail})")
        if args.timings:
            for name, secs in sorted(
                timings.items(), key=lambda kv: -kv[1]
            ):
                print(f"  {name:22s} {secs:7.3f}s")
            print(
                f"  {'total':22s} {total:7.3f}s "
                f"(budget {BUDGET_S:.0f}s)"
            )
        if total > BUDGET_S:
            print(
                f"kwoklint: WARNING: analysis took {total:.1f}s, over the "
                f"{BUDGET_S:.0f}s budget",
                file=sys.stderr,
            )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
