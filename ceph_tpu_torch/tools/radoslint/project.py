"""Project-wide consistency rules: checks that need the whole file set.

registry-consistency is the ceph-dencoder-style cross-check: the message
registry (msg/messages.py), the frame tag space (msg/frames.py), and the
dispatcher handlers scattered across daemons must agree — a message type
nobody handles is dead wire protocol, a duplicate type id is silent
misdecoding waiting for the first collision.

decl-use is the declared-but-dead lint: config options nobody reads,
perf counters nobody increments, tracer spans opened and never finished.
All three rot the observability surface — an operator tunes a knob that
does nothing, or graphs a counter that is forever zero.
"""
from __future__ import annotations

import ast
import re

from ceph_tpu_torch.tools.radoslint.checkers import (dotted, terminal_name,
                                               walk_shallow)
from ceph_tpu_torch.tools.radoslint.core import Finding, SourceFile, rule


# -- registry-consistency ----------------------------------------------------

def _message_decls(sf: SourceFile) -> list[tuple[str, int, int, str]]:
    """(name, type_id, line, kind) for every message declared in a
    messages module: `X = _simple(0xNN, "X")` and `class X(Message)`
    bodies with a TYPE attribute."""
    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                terminal_name(node.value.func) == "_simple" and \
                len(node.value.args) >= 2 and \
                isinstance(node.value.args[0], ast.Constant) and \
                isinstance(node.value.args[1], ast.Constant):
            tid = node.value.args[0].value
            sname = node.value.args[1].value
            var = node.targets[0].id if node.targets and \
                isinstance(node.targets[0], ast.Name) else sname
            out.append((var if isinstance(var, str) else sname,
                        tid, node.lineno, "simple"))
            if isinstance(var, str) and var != sname:
                out.append((f"{var}!={sname}", tid, node.lineno,
                            "name-mismatch"))
        elif isinstance(node, ast.ClassDef):
            bases = {terminal_name(b) for b in node.bases}
            tid = None
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and stmt.targets and \
                        isinstance(stmt.targets[0], ast.Name) and \
                        stmt.targets[0].id == "TYPE" and \
                        isinstance(stmt.value, ast.Constant):
                    tid = stmt.value.value
            if "Message" in bases and tid:
                registered = any(terminal_name(d) == "register_message"
                                 for d in node.decorator_list)
                out.append((node.name, tid, node.lineno,
                            "class" if registered else "unregistered"))
    return out


@rule("registry-consistency", "project",
      "cross-checks the wire registry the way ceph-dencoder checks "
      "dencoders: every message in msg/messages.py must have a unique "
      "type id, a registered decode path, and at least one sender or "
      "dispatcher handler elsewhere in the tree; msg/frames.py frame "
      "tags must be collision-free. A dead or colliding registry entry "
      "is a protocol bug that no unit test exercises.")
def check_registry(files: list[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    msgs = [sf for sf in files if sf.path.endswith("msg/messages.py")]
    frames = [sf for sf in files if sf.path.endswith("msg/frames.py")]
    for sf in msgs:
        decls = _message_decls(sf)
        seen: dict[int, str] = {}
        for name, tid, line, kind in decls:
            if kind == "name-mismatch":
                var, sname = name.split("!=", 1)
                out.append(Finding(
                    sf.path, line, "registry-consistency",
                    f"message bound to {var} but registered as "
                    f"{sname!r}: decode will materialize a class the "
                    f"rest of the code never names"))
                continue
            if kind == "unregistered":
                out.append(Finding(
                    sf.path, line, "registry-consistency",
                    f"Message subclass {name} (TYPE={tid:#x}) is never "
                    f"passed to register_message: peers sending it get "
                    f"'unknown message type' on decode"))
            if tid in seen:
                out.append(Finding(
                    sf.path, line, "registry-consistency",
                    f"message type id {tid:#x} of {name} collides with "
                    f"{seen[tid]}: the decode registry can hold only "
                    f"one"))
            else:
                seen[tid] = name
            # whole-word only: a bare substring test counts MPing as
            # used wherever MPingReply appears, masking dead messages
            pat = re.compile(rf"\b{re.escape(name)}\b")
            refs = sum(1 for other in files
                       if other.path != sf.path
                       and pat.search(other.source))
            if refs == 0 and kind != "name-mismatch":
                out.append(Finding(
                    sf.path, line, "registry-consistency",
                    f"message type {name} (TYPE={tid:#x}) is never sent "
                    f"or handled anywhere outside its declaration — "
                    f"dead wire protocol"))
    for sf in frames:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef) and node.name == "Tag":
                vals: dict[int, str] = {}
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign) and stmt.targets and \
                            isinstance(stmt.targets[0], ast.Name) and \
                            isinstance(stmt.value, ast.Constant) and \
                            isinstance(stmt.value.value, int):
                        tag, val = stmt.targets[0].id, stmt.value.value
                        if val in vals:
                            out.append(Finding(
                                sf.path, stmt.lineno,
                                "registry-consistency",
                                f"frame tag {tag}={val} collides with "
                                f"{vals[val]}"))
                        else:
                            vals[val] = tag
    return out


# -- decl-use ----------------------------------------------------------------

_PERF_METHODS = {"inc", "dec", "tinc", "avg_add", "hist_add", "time"}


def _const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _collect_decl_use(files: list[SourceFile]):
    """One pass over every module collecting declarations and uses."""
    opt_decls: dict[str, tuple[str, int]] = {}
    cfg_uses: list[tuple[str, str, int]] = []      # (name, path, line)
    perf_decls: dict[str, tuple[str, int]] = {}
    perf_used: set[str] = set()
    # every string constant's positions, for dynamic-use fallbacks
    const_sites: dict[str, set[tuple[str, int, int]]] = {}
    prefix_consts: set[str] = set()

    for sf in files:
        # PerfCounters subclasses (the pull-model logger mirrors, e.g.
        # copytrack/loopprof): `self.add("x")` declares a counter and
        # `self.set("x", v)` / `self.inc("x")` uses it, even though the
        # receiver is `self` rather than a *perf*-named handle
        for cls in ast.walk(sf.tree):
            if not (isinstance(cls, ast.ClassDef)
                    and any("PerfCounters" in (terminal_name(b) or "")
                            for b in cls.bases)):
                continue
            for node in ast.walk(cls):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and dotted(node.func.value) == "self"
                        and node.args):
                    continue
                name = _const_str(node.args[0])
                if name is None:
                    continue
                if node.func.attr == "add" and name not in perf_decls:
                    perf_decls[name] = (sf.path, node.args[0].lineno)
                elif node.func.attr in _PERF_METHODS | {"set"}:
                    perf_used.add(name)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                const_sites.setdefault(node.value, set()).add(
                    (sf.path, node.lineno, node.col_offset))
                if node.value.endswith("_") and len(node.value) >= 4:
                    # slicing/startswith prefixes: evidence of dynamic
                    # access over a whole option family
                    prefix_consts.add(node.value)
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if terminal_name(fn) == "Option" and node.args:
                name = _const_str(node.args[0])
                if name is not None and name not in opt_decls:
                    opt_decls[name] = (sf.path, node.args[0].lineno)
            elif isinstance(fn, ast.Attribute):
                recv = (dotted(fn.value) or "").lower()
                if fn.attr in ("get", "set", "rm") and node.args and \
                        ("config" in recv or "conf" in recv
                         or recv == "cfg"):
                    name = _const_str(node.args[0])
                    if name is not None:
                        cfg_uses.append((name, sf.path, node.lineno))
                elif fn.attr == "add_observer" and node.args and \
                        isinstance(node.args[0], (ast.Tuple, ast.List)):
                    for el in node.args[0].elts:
                        name = _const_str(el)
                        if name is not None:
                            cfg_uses.append((name, sf.path, el.lineno))
                elif fn.attr == "add" and node.args and \
                        ("perf" in recv or recv in ("pc", "counters")):
                    name = _const_str(node.args[0])
                    if name is not None and name not in perf_decls:
                        perf_decls[name] = (sf.path, node.args[0].lineno)
                elif fn.attr in _PERF_METHODS and node.args:
                    name = _const_str(node.args[0])
                    if name is not None:
                        perf_used.add(name)
                elif fn.attr == "set" and node.args:
                    name = _const_str(node.args[0])
                    if name is not None and "perf" in recv:
                        perf_used.add(name)
    return (opt_decls, cfg_uses, perf_decls, perf_used, const_sites,
            prefix_consts)


def _span_leaks(sf: SourceFile) -> list[Finding]:
    """start_span() handles that are never finish()ed nor escape the
    function (returned, stored, passed on) leak silently: the span
    never reaches the collector, so `trace dump` has a hole exactly
    where the interesting op was."""
    out = []
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        opens: dict[str, ast.Assign] = {}
        for node in walk_shallow(fn):
            if isinstance(node, ast.Assign) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    isinstance(node.value, ast.Call) and \
                    terminal_name(node.value.func) == "start_span":
                opens[node.targets[0].id] = node
        if not opens:
            continue
        closed: set[str] = set()
        for node in walk_shallow(fn):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id in opens and \
                        node.func.attr == "finish":
                    closed.add(node.func.value.id)
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id in opens:
                        closed.add(arg.id)        # escapes: callee owns it
            elif isinstance(node, (ast.Return, ast.Yield)) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in opens:
                closed.add(node.value.id)
            elif isinstance(node, ast.Assign) and node not in opens.values():
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name) and sub.id in opens:
                        closed.add(sub.id)        # aliased/stored
        for var, assign in opens.items():
            if var not in closed:
                out.append(Finding(
                    sf.path, assign.lineno, "decl-use",
                    f"span handle {var!r} from start_span() is never "
                    f"finish()ed (or handed off): the span never "
                    f"reaches the collector — finish it or use `with "
                    f"tracer.span(...)`",
                    end_line=assign.end_lineno or 0))
    return out


@rule("decl-use", "project",
      "declared-but-dead observability surface: config options nobody "
      "reads (or reads of options nobody declares), perf counters "
      "declared but never incremented, tracer spans opened but never "
      "finished. Dynamic access is honored: an option family read via "
      "a computed name counts as used when a '<prefix>_' string "
      "constant matching it exists.")
def check_decl_use(files: list[SourceFile]) -> list[Finding]:
    (opt_decls, cfg_uses, perf_decls, perf_used, const_sites,
     prefix_consts) = _collect_decl_use(files)
    out: list[Finding] = []
    used_names = {n for n, _, _ in cfg_uses}
    for name, (path, line) in sorted(opt_decls.items()):
        if name in used_names:
            continue
        # equal string constant anywhere but the declaration itself
        other = {s for s in const_sites.get(name, ())
                 if s[0] != path or s[1] != line}
        if other:
            continue
        if any(name.startswith(p) for p in prefix_consts):
            continue            # dynamic family access (observer loops)
        out.append(Finding(
            path, line, "decl-use",
            f"config option {name!r} is declared but never read — dead "
            f"knob (an operator tuning it changes nothing)"))
    for name, path, line in sorted(set(cfg_uses)):
        if name not in opt_decls:
            out.append(Finding(
                path, line, "decl-use",
                f"config option {name!r} is read but never declared: "
                f"Config.get raises ConfigError at runtime"))
    for name, (path, line) in sorted(perf_decls.items()):
        if name in perf_used:
            continue
        other = {s for s in const_sites.get(name, ())
                 if s[0] != path or s[1] != line}
        if other:
            continue
        if any(name.startswith(p) for p in prefix_consts):
            continue
        out.append(Finding(
            path, line, "decl-use",
            f"perf counter {name!r} is declared but never "
            f"incremented/set — it graphs as forever-zero"))
    for sf in files:
        out.extend(_span_leaks(sf))
    return out


# -- report-export-consistency ------------------------------------------------

def _logger_decls(files: list[SourceFile]) -> dict[str, tuple[str, int]]:
    """Every perf-logger NAME the process-wide collection can hold:
    `coll.create("x")`, `PerfCounters("x")`, and `super().__init__("x")`
    inside a PerfCounters subclass (the pull-model mirrors). Dynamic
    names (f-strings like f"osd.{whoami}") are invisible here — fine,
    extra_loggers entries are literal process-wide logger names."""
    decls: dict[str, tuple[str, int]] = {}

    def note(node: ast.Call) -> None:
        name = _const_str(node.args[0]) if node.args else None
        if name is not None and name not in decls:
            decls[name] = (sf.path, node.lineno)

    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if terminal_name(fn) == "PerfCounters":
                note(node)
            elif isinstance(fn, ast.Attribute) and fn.attr == "create" \
                    and "coll" in (dotted(fn.value) or "").lower():
                note(node)
            elif isinstance(fn, ast.Attribute) and \
                    fn.attr == "__init__" and \
                    isinstance(fn.value, ast.Call) and \
                    terminal_name(fn.value.func) == "super":
                note(node)
    return decls


@rule("report-export-consistency", "project",
      "every logger name in an MgrClient `extra_loggers=` tuple must "
      "match a PerfCounters logger declared somewhere in the tree: the "
      "report path looks the name up in the process-wide collection "
      "and SILENTLY skips a miss, so a typo'd or renamed logger's "
      "counters never reach the mgr aggregation or the /metrics "
      "exporter family list — the dashboard just loses the family.")
def check_report_export(files: list[SourceFile]) -> list[Finding]:
    decls = _logger_decls(files)
    out: list[Finding] = []
    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg != "extra_loggers" or \
                        not isinstance(kw.value, (ast.Tuple, ast.List)):
                    continue
                for el in kw.value.elts:
                    name = _const_str(el)
                    if name is not None and name not in decls:
                        out.append(Finding(
                            sf.path, el.lineno,
                            "report-export-consistency",
                            f"extra_loggers entry {name!r} names a perf "
                            f"logger never declared anywhere "
                            f"(coll.create/PerfCounters): the MgrClient "
                            f"report merge skips unknown loggers "
                            f"silently, so its counters never appear "
                            f"in the exporter's /metrics families"))
    return out
