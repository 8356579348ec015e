"""radoslint-tool — subcommand front end for the sanitizer suite.

The ec_tool-shaped companion to `python -m ceph_tpu_torch.tools.radoslint`:
where the module entry point is the CI gate (one flat invocation, exit
code is the verdict), this tool is the operator surface — subcommands
for inspecting rules, ratcheting the baseline, and explaining a single
finding class, mirroring ceph-erasure-code-tool's
`test-plugin-exists`/`calc-chunk-size` style:

  check [paths...] [--json] [--changed-only] [--rules LIST]
      run the suite; exit 0 clean / 1 findings (same gate as the
      module entry point)
  rules
      one line per registered rule: id, kind
  explain <rule-id>
      the full rationale for one rule (what bug class it makes
      unrepresentable, and what to write instead)
  baseline show
      print the committed baseline entries
  baseline write [paths...]
      regenerate the baseline from current findings (grandfathering)
  baseline prune [paths...]
      drop stale entries (findings since fixed) — the ratchet: the
      baseline only ever shrinks

The paths default to `ceph_tpu_torch`. The tool holds no kernel and
touches no device, so no command of it takes `device`.
"""
from __future__ import annotations

import argparse
import os
import sys

from ceph_tpu_torch.tools.radoslint import cli, core


def _baseline_path(args) -> str:
    start = args.paths[0] if getattr(args, "paths", None) else os.getcwd()
    return getattr(args, "baseline", None) or core.find_baseline(start) \
        or os.path.join(os.getcwd(), core.BASELINE_NAME)


def cmd_check(args) -> int:
    argv = list(args.paths)
    if args.json:
        argv.append("--json")
    if args.changed_only:
        argv.append("--changed-only")
    if args.rules:
        argv += ["--rules", args.rules]
    if args.baseline:
        argv += ["--baseline", args.baseline]
    return cli.main(argv)


def cmd_rules(args) -> int:
    for r in sorted(core.RULES.values(), key=lambda r: r.id):
        print(f"{r.id} ({r.kind})")
    return 0


def cmd_explain(args) -> int:
    r = core.RULES.get(args.rule)
    if r is None:
        print(f"radoslint-tool: unknown rule {args.rule!r} "
              f"(see `rules`)", file=sys.stderr)
        return 2
    print(f"{r.id} ({r.kind})\n\n{r.doc}")
    return 0


def cmd_baseline_show(args) -> int:
    path = _baseline_path(args)
    if not os.path.isfile(path):
        print(f"radoslint-tool: no baseline at {path}", file=sys.stderr)
        return 1
    entries = sorted(core.load_baseline(path))
    for e in entries:
        print(e)
    print(f"{len(entries)} baselined finding(s) in {path}")
    return 0


def cmd_baseline_write(args) -> int:
    path = _baseline_path(args)
    # keys must be relative to the BASELINE's directory, not the cwd,
    # or a run from a subdirectory writes keys a repo-root gate run
    # can never match
    findings = core.run_lint(args.paths, root=os.path.dirname(path)
                             or os.getcwd())
    n = core.write_baseline(path, findings)
    print(f"wrote {n} finding(s) to {path}")
    return 0


def cmd_baseline_prune(args) -> int:
    path = _baseline_path(args)
    if not os.path.isfile(path):
        print(f"radoslint-tool: no baseline at {path}", file=sys.stderr)
        return 1
    old = core.load_baseline(path)
    live = {f.key for f in core.run_lint(args.paths,
                                         root=os.path.dirname(path)
                                         or os.getcwd())}
    kept = old & live
    stale = sorted(old - live)
    core.write_baseline(path, kept)
    for e in stale:
        print(f"pruned (fixed): {e}")
    print(f"baseline: {len(old)} -> {len(kept)} entr"
          f"{'y' if len(kept) == 1 else 'ies'}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="radoslint-tool")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("check")
    s.add_argument("paths", nargs="*", default=["ceph_tpu_torch"])
    s.add_argument("--json", action="store_true")
    s.add_argument("--changed-only", action="store_true")
    s.add_argument("--rules")
    s.add_argument("--baseline")
    s.set_defaults(fn=cmd_check)

    s = sub.add_parser("rules")
    s.set_defaults(fn=cmd_rules)

    s = sub.add_parser("explain")
    s.add_argument("rule")
    s.set_defaults(fn=cmd_explain)

    s = sub.add_parser("baseline")
    bsub = s.add_subparsers(dest="bcmd", required=True)
    for name, fn in (("show", cmd_baseline_show),
                     ("write", cmd_baseline_write),
                     ("prune", cmd_baseline_prune)):
        b = bsub.add_parser(name)
        if name != "show":
            b.add_argument("paths", nargs="*", default=["ceph_tpu_torch"])
        b.add_argument("--baseline")
        b.set_defaults(fn=fn)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
