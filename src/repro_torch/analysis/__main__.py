"""CLI for the port's fslint: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean; 1 findings, unused suppressions, or stale baseline
entries; 2 usage error.  ``--format=json`` prints one machine-readable
object (what CI archives); the default human format prints one
``path:line:col: [rule] message`` line per finding, ruff/gcc style.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import DEFAULT_BASELINE, run
from .registry import RULES, active_rules


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files/directories/globs to analyze (repo-relative; default: "
        "the port's tree)",
    )
    ap.add_argument("--format", choices=("human", "json"), default="human")
    ap.add_argument(
        "--select",
        help="comma-separated rule names to run (default: all)",
    )
    ap.add_argument(
        "--no-scope",
        action="store_true",
        help="apply selected rules to every analyzed file, ignoring per-rule "
        "path scopes (fixture/debug use)",
    )
    ap.add_argument(
        "--baseline",
        default=str(DEFAULT_BASELINE),
        help="baseline JSON (pass '' to disable baseline subtraction)",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite the baseline to accept every current finding (a "
        "deliberate act: the diff shows exactly what debt was taken on)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    args = ap.parse_args(argv)
    # register the rules before --select or --list-rules reads the registry
    # (the JAX package's CLI checked --select first and, in a fresh
    # interpreter, called every rule unknown)
    from . import rules as _rules  # noqa: F401

    if args.list_rules:
        for r in RULES.values():
            print(f"{r.name:16s} {r.description}")
            for pat in r.scope:
                print(f"{'':16s}   scope: {pat}")
        return 0

    select = args.select.split(",") if args.select else None
    try:
        active_rules(select)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2

    baseline = Path(args.baseline) if args.baseline else None
    result = run(
        args.paths or None,
        select=select,
        ignore_scope=args.no_scope,
        # when rewriting the baseline, capture ALL current findings — the old
        # baseline must not subtract entries out of the rewrite
        baseline=None if args.write_baseline else baseline,
    )

    if args.write_baseline:
        if baseline is None:
            print("--write-baseline needs --baseline", file=sys.stderr)
            return 2
        entries = [
            {"rule": f.rule, "path": f.path, "message": f.message}
            for f in result.findings
        ]
        baseline.write_text(
            json.dumps({"version": 1, "findings": entries}, indent=1) + "\n"
        )
        print(f"wrote {len(entries)} baseline entries to {baseline}")
        return 0

    if args.format == "json":
        print(json.dumps(result.as_dict(), indent=1))
    else:
        for f in result.findings:
            print(f.render())
        for s in result.unused_suppressions:
            print(
                f"{s.path}:{s.line}:1: [unused-suppression] disable="
                f"{','.join(s.rules)} suppressed nothing — delete it"
            )
        for fp in result.stale_baseline:
            print(f"baseline: stale entry {fp!r} — finding no longer exists")
        n = len(result.findings)
        print(
            f"fslint: {result.files_scanned} files, "
            f"{len(result.rules_run)} rules, {n} finding(s), "
            f"{len(result.unused_suppressions)} unused suppression(s), "
            f"{len(result.stale_baseline)} stale baseline entr(ies)"
        )
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
