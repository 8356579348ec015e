"""radoslint command line.

    python -m ceph_tpu_torch.tools.radoslint ceph_tpu_torch/ [--json]
        [--baseline F] [--write-baseline] [--changed-only] [--rules a,b] [--list-rules]

Exit codes: 0 clean (no non-baselined findings), 1 findings, 2 usage.
The baseline defaults to the nearest `.radoslint-baseline.json` found
walking up from the first scanned path, so the committed repo-root
baseline applies no matter where the tool is launched from.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ceph_tpu_torch.tools.radoslint import core


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="radoslint",
        description="AST-based asyncio/lockdep sanitizer suite")
    p.add_argument("paths", nargs="*", default=["ceph_tpu_torch"],
                   help="files or directories to lint "
                        "(default: ceph_tpu_torch)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings on stdout")
    p.add_argument("--baseline", metavar="FILE",
                   help="baseline file of grandfathered findings "
                        "(default: nearest .radoslint-baseline.json)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings as the new baseline")
    p.add_argument("--changed-only", action="store_true",
                   help="per-file rules only on files changed vs git "
                        "HEAD (project rules always see the full tree)")
    p.add_argument("--rules", metavar="LIST",
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="list rule ids with their rationale and exit")
    p.add_argument("--root", metavar="DIR",
                   help="directory finding paths are relative to "
                        "(default: cwd)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # loads the checker modules (fills core.RULES) as a side effect
    from ceph_tpu_torch.tools.radoslint import (checkers, lifetimes,  # noqa: F401
                                          lockorder, project)
    if args.list_rules:
        for r in sorted(core.RULES.values(), key=lambda r: r.id):
            print(f"{r.id} ({r.kind})")
            print(f"    {r.doc}\n")
        return 0
    if args.write_baseline and (args.rules or args.changed_only):
        # a restricted run sees a subset of findings; writing it out
        # would silently drop every grandfathered entry the run never
        # produced — the ratchet must be regenerated from a full run
        print("radoslint: --write-baseline requires a full run "
              "(drop --rules/--changed-only)", file=sys.stderr)
        return 2
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    root = os.path.abspath(args.root or os.getcwd())
    for p in args.paths:
        if not os.path.exists(p):
            print(f"radoslint: no such path: {p}", file=sys.stderr)
            return 2
    try:
        findings = core.run_lint(args.paths, root=root, rules=rules,
                                 changed_only=args.changed_only)
    except ValueError as e:
        print(f"radoslint: {e}", file=sys.stderr)
        return 2
    baseline_path = args.baseline or core.find_baseline(
        args.paths[0] if args.paths else root)
    if args.write_baseline:
        target = args.baseline or baseline_path or \
            os.path.join(root, core.BASELINE_NAME)
        n = core.write_baseline(target, findings)
        print(f"radoslint: wrote {n} finding(s) to {target}")
        return 0
    baseline: set[str] = set()
    if baseline_path and os.path.isfile(baseline_path):
        baseline = core.load_baseline(baseline_path)
    fresh = [f for f in findings if f.key not in baseline]
    stale = sorted(baseline - {f.key for f in findings})
    if args.json:
        print(json.dumps({
            "findings": [f.to_dict() for f in fresh],
            "baselined": len(findings) - len(fresh),
            "stale_baseline_entries": stale,
            "rules": sorted(rules or core.RULES),
        }, indent=1))
    else:
        for f in fresh:
            print(f.render())
        grand = len(findings) - len(fresh)
        summary = (f"radoslint: {len(fresh)} finding(s)"
                   + (f", {grand} baselined" if grand else ""))
        if stale:
            summary += (f"; {len(stale)} baseline entr"
                        f"{'y is' if len(stale) == 1 else 'ies are'} "
                        f"stale (fixed — shrink the baseline)")
        print(summary)
    return 1 if fresh else 0
