"""radoslint core: finding model, suppressions, baseline, rule registry.

The lockdep-shaped half of the reference's race tooling
(src/common/lockdep.cc) enforces ordering invariants at runtime; this
suite enforces the asyncio equivalents *statically*, before the code
ever runs. The machinery is deliberately small:

  * `Finding` — one defect at `path:line:rule-id`, rendered human or
    JSON; `key` is the stable identity the baseline stores.
  * suppressions — `# radoslint: disable=<rule>[,rule]` on the line (or
    any line of a multi-line statement), `disable-next=` for the line
    below, `disable-file=` anywhere for the whole module. `all` matches
    every rule. Suppressions are for *justified* exceptions; new code
    should fix, not disable.
  * baseline — a committed JSON list of grandfathered finding keys.
    `--write-baseline` regenerates it; the CI gate fails on any finding
    not in it, so the file can only shrink (ratchet, not whitelist).
  * rules — registered by the checker modules; `kind` is "file" (pure
    per-module AST visit) or "project" (needs the whole file set, e.g.
    registry cross-checks).
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
import subprocess
from typing import Callable, Iterable

BASELINE_NAME = ".radoslint-baseline.json"
#: the port's own cache name: the reference's linter, with other rule
#: sources (another `_rules_hash`), writes its own at the same root
CACHE_NAME = ".radoslint_torch_cache.json"

#: modules parsed since import — the cache test's instrument: a warm
#: full-tree run must not move it
PARSE_COUNT = 0


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str                  # root-relative posix path
    line: int
    rule: str
    message: str
    end_line: int = 0          # suppression range only; not identity

    @property
    def key(self) -> str:
        return f"{self.path}:{self.line}:{self.rule}: {self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


_SUPPRESS_RE = re.compile(
    r"#\s*radoslint:\s*(disable(?:-next|-file)?)=([A-Za-z0-9_\-, ]+)")


class SourceFile:
    """One parsed module plus its suppression map."""

    def __init__(self, abspath: str, path: str, source: str):
        global PARSE_COUNT
        PARSE_COUNT += 1
        self.abspath = abspath
        self.path = path            # root-relative, posix separators
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.file_disables: set[str] = set()
        self.line_disables: dict[int, set[str]] = {}
        for lineno, text in enumerate(source.splitlines(), 1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            mode, rules = m.group(1), {
                r.strip() for r in m.group(2).split(",") if r.strip()}
            if mode == "disable-file":
                self.file_disables |= rules
            elif mode == "disable-next":
                self.line_disables.setdefault(lineno + 1, set()).update(rules)
            else:
                self.line_disables.setdefault(lineno, set()).update(rules)

    def suppressed(self, rule: str, line: int, end_line: int = 0) -> bool:
        if {"all", rule} & self.file_disables:
            return True
        for ln in range(line, max(end_line, line) + 1):
            if {"all", rule} & self.line_disables.get(ln, set()):
                return True
        return False


class Rule:
    """One registered checker. file rules get a SourceFile per call;
    project rules get the whole list once."""

    def __init__(self, rule_id: str, kind: str, doc: str, fn: Callable):
        assert kind in ("file", "project")
        self.id = rule_id
        self.kind = kind
        self.doc = doc
        self.fn = fn


RULES: dict[str, Rule] = {}


def rule(rule_id: str, kind: str, doc: str):
    """Decorator registering a checker function as a rule."""
    def wrap(fn):
        RULES[rule_id] = Rule(rule_id, kind, doc, fn)
        return fn
    return wrap


# -- file collection ---------------------------------------------------------

def collect_files(paths: Iterable[str], root: str) -> list[SourceFile]:
    """Load every .py under `paths` (files or directories) as
    SourceFiles with root-relative display paths. Unparseable files
    become a synthetic `parse-error` finding via run_lint."""
    seen: dict[str, str] = {}
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            seen[p] = p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            for f in filenames:
                if f.endswith(".py"):
                    ap = os.path.join(dirpath, f)
                    seen[ap] = ap
    out = []
    for ap in sorted(seen):
        rel = os.path.relpath(ap, root).replace(os.sep, "/")
        with open(ap, "r", encoding="utf-8") as fh:
            out.append((ap, rel, fh.read()))
    return out


def git_changed_files(root: str) -> set[str] | None:
    """Root-relative paths touched vs HEAD (worktree + index +
    untracked); None when git is unavailable (fail open: lint all).

    `git diff --name-only` reports paths relative to the repo
    TOP-LEVEL while findings are relative to `root` (which may be a
    subdirectory), so every reported path is re-anchored; entries
    outside `root` are dropped."""
    changed: set[str] = set()
    try:
        top = subprocess.run(["git", "rev-parse", "--show-toplevel"],
                             cwd=root, capture_output=True, text=True,
                             timeout=30)
        if top.returncode != 0:
            return None
        toplevel = top.stdout.strip()

        def add(ln: str, base: str) -> None:
            rel = os.path.relpath(os.path.join(base, ln), root)
            if not rel.startswith(".."):
                changed.add(rel.replace(os.sep, "/"))

        # --name-status (with rename detection) instead of --name-only:
        # a DELETED file must not reach the analyzer at all, and a
        # RENAME must contribute only its NEW name — --name-only lists
        # both sides, handing collect_files a path that no longer
        # exists (and the per-file filter a key nothing matches)
        diff = subprocess.run(["git", "diff", "--name-status", "-M",
                               "HEAD"], cwd=root, capture_output=True,
                              text=True, timeout=30)
        if diff.returncode != 0:
            return None
        for ln in diff.stdout.splitlines():
            parts = ln.rstrip().split("\t")
            if len(parts) < 2 or not parts[0]:
                continue
            status = parts[0][0]
            if status == "D":
                continue                    # gone: nothing to lint
            # R<score>/C<score> report "old<TAB>new": the surviving
            # name is the last column either way
            add(parts[-1], toplevel)
        # untracked files are cwd-relative, not toplevel-relative
        others = subprocess.run(["git", "ls-files", "--others",
                                 "--exclude-standard"], cwd=root,
                                capture_output=True, text=True,
                                timeout=30)
        if others.returncode != 0:
            return None
        for ln in others.stdout.splitlines():
            if ln.strip():
                add(ln.strip(), root)
    except (OSError, subprocess.SubprocessError):
        return None
    return changed


# -- baseline ----------------------------------------------------------------

def find_baseline(start: str) -> str | None:
    """Walk upward from `start` for a committed baseline file."""
    d = os.path.abspath(start)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    while True:
        cand = os.path.join(d, BASELINE_NAME)
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def load_baseline(path: str) -> set[str]:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return set(data.get("findings", []))


def write_baseline(path: str, findings: Iterable[Finding | str]) -> int:
    """Accepts Finding objects or pre-rendered baseline keys."""
    keys = sorted(f.key if isinstance(f, Finding) else str(f)
                  for f in findings)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"tool": "radoslint", "version": 1, "findings": keys},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    return len(keys)


# -- findings cache ----------------------------------------------------------
#
# The full-tree gate runs inside tier-1 on every test invocation, and
# re-parsing ~170 modules to reach the same zero findings is pure waste.
# The cache keys each file's POST-SUPPRESSION findings per rule by a
# content hash (mtime/size are recorded for humans but identity is the
# bytes — tmp-dir tests rewrite files faster than mtime granularity),
# and the project-rule results by a whole-tree stamp. Any edit to the
# linter itself (rules-hash over the package sources) invalidates
# everything. A warm run with no edits parses NOTHING (PARSE_COUNT is
# the proof the cache test pins).

def _rules_hash() -> str:
    h = hashlib.sha256()
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    for fn in sorted(os.listdir(pkg_dir)):
        if fn.endswith(".py"):
            h.update(fn.encode())
            with open(os.path.join(pkg_dir, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _load_cache(root: str, rhash: str) -> dict:
    path = os.path.join(root, CACHE_NAME)
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if data.get("version") == 1 and data.get("rules_hash") == rhash:
            return data
    except (OSError, ValueError):
        pass
    return {"version": 1, "rules_hash": rhash, "files": {},
            "project": {}}


def _save_cache(root: str, cache: dict) -> None:
    path = os.path.join(root, CACHE_NAME)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(cache, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


# -- the lint run ------------------------------------------------------------

def run_lint(paths: Iterable[str], root: str | None = None,
             rules: Iterable[str] | None = None,
             changed_only: bool = False,
             use_cache: bool = True) -> list[Finding]:
    """Run the suite: per-file rules on each module (restricted to
    changed files in changed-only mode), then project rules over the
    full set (cross-file consistency needs the whole picture even for
    an incremental run). Suppressions apply to both. Results come from
    the findings cache wherever file bytes and linter sources are
    unchanged; pass use_cache=False to force a cold run."""
    # load the checker modules so their @rule decorators run
    from ceph_tpu_torch.tools.radoslint import (checkers, lifetimes,  # noqa: F401
                                          lockorder, project)
    root = os.path.abspath(root or os.getcwd())
    wanted = set(rules) if rules is not None else set(RULES)
    unknown = wanted - set(RULES)
    if unknown:
        raise ValueError(f"unknown rule(s): {sorted(unknown)}")
    file_rules = sorted(rid for rid in wanted
                        if RULES[rid].kind == "file")
    proj_rules = sorted(rid for rid in wanted
                        if RULES[rid].kind == "project")
    raw = collect_files(paths, root)
    cache = _load_cache(root, _rules_hash()) if use_cache else \
        {"version": 1, "files": {}, "project": {}}
    dirty = False

    changed = git_changed_files(root) if changed_only else None
    findings: list[Finding] = []
    parsed: dict[str, SourceFile | None] = {}   # None = syntax error

    def ensure_parsed(ap: str, rel: str, src: str,
                      entry: dict) -> SourceFile | None:
        nonlocal dirty
        if rel in parsed:
            return parsed[rel]
        try:
            sf = SourceFile(ap, rel, src)
        except SyntaxError as e:
            sf = None
            if entry["parse_error"] is None:
                entry["parse_error"] = [e.lineno or 0,
                                        f"cannot parse: {e.msg}"]
                dirty = True
        parsed[rel] = sf
        return sf

    # -- per-file phase ------------------------------------------------------
    entries: dict[str, dict] = {}
    for ap, rel, src in raw:
        h = hashlib.sha256(src.encode("utf-8", "replace")).hexdigest()
        entry = cache["files"].get(rel)
        if entry is None or entry.get("hash") != h:
            try:
                st = os.stat(ap)
                mtime, size = st.st_mtime, st.st_size
            except OSError:
                mtime, size = 0, len(src)
            entry = {"hash": h, "mtime": mtime, "size": size,
                     "parse_error": None, "rules": {}}
            cache["files"][rel] = entry
            dirty = True
            # a changed file must establish parseability now even when
            # out of changed-only scope: parse-error findings have
            # always covered the whole collected set
            ensure_parsed(ap, rel, src, entry)
        entries[rel] = entry
        if entry["parse_error"] is not None:
            ln, msg = entry["parse_error"]
            findings.append(Finding(rel, ln, "parse-error", msg))
            continue
        if changed is not None and rel not in changed:
            continue
        missing = [rid for rid in file_rules
                   if rid not in entry["rules"]]
        if missing:
            sf = ensure_parsed(ap, rel, src, entry)
            if sf is None:
                ln, msg = entry["parse_error"]
                findings.append(Finding(rel, ln, "parse-error", msg))
                continue
            for rid in missing:
                kept = [f for f in RULES[rid].fn(sf)
                        if not sf.suppressed(f.rule, f.line, f.end_line)]
                entry["rules"][rid] = [
                    [f.line, f.message, f.end_line] for f in kept]
                dirty = True
        for rid in file_rules:
            findings.extend(
                Finding(rel, ln, rid, msg, end_line=el)
                for ln, msg, el in entry["rules"][rid])

    # -- project phase -------------------------------------------------------
    if proj_rules:
        stamp = hashlib.sha256()
        for ap, rel, src in raw:
            stamp.update(rel.encode())
            stamp.update(entries[rel]["hash"].encode())
        stamp = stamp.hexdigest()
        pcache = cache["project"]
        if pcache.get("stamp") != stamp:
            pcache = cache["project"] = {"stamp": stamp, "rules": {}}
            dirty = True
        missing = [rid for rid in proj_rules
                   if rid not in pcache["rules"]]
        if missing:
            files = [sf for ap, rel, src in raw
                     if (sf := ensure_parsed(ap, rel, src,
                                             entries[rel])) is not None]
            by_path = {sf.path: sf for sf in files}
            for rid in missing:
                kept = []
                for f in RULES[rid].fn(files):
                    sf = by_path.get(f.path)
                    if sf is not None and sf.suppressed(
                            f.rule, f.line, f.end_line):
                        continue
                    kept.append([f.path, f.line, f.message, f.end_line])
                pcache["rules"][rid] = kept
                dirty = True
        for rid in proj_rules:
            findings.extend(
                Finding(p, ln, rid, msg, end_line=el)
                for p, ln, msg, el in pcache["rules"][rid])

    if use_cache and dirty:
        _save_cache(root, cache)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings
