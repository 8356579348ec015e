"""Lock-ordering rules: the static half of asynclockdep.

The reference's src/common/lockdep.cc learns lock-acquisition order at
runtime and aborts on the first cycle; these rules prove the same
invariant over the AST before the code ever runs, paired with the
runtime recorder in utils/sanitizer.py exactly the way the view rules
pair with the buffer generation guards.

  * `lock-order-cycle` (project): every function contributes the order
    in which it acquires tracked locks (`with`/`async with` on
    lock/semaphore/throttle-named objects), including acquisitions made
    by callees it invokes WHILE holding — resolved conservatively to
    same-class methods and same-module functions. A cycle in the merged
    order graph is a latent deadlock, reported once with the witness
    rendered edge by edge (who acquires what after what, and where).
  * `await-in-gate` (file): awaiting an UNBOUNDED external event — a
    QoS/reservation grant, a queue get, a bare future/reply — while
    holding a write gate (`block_writes`..`unblock_writes`) or an
    `obj_lock` freezes client IO behind an arbiter that may be busy
    arbitrating the very writes it just froze. Bounded waits
    (`asyncio.wait_for`, an explicit `timeout=`) stay legal: a deadline
    turns a deadlock into a retryable stall.

Both rules are precision-tuned like the rest of the suite: name
qualification keeps `A._lock` and `B._lock` distinct, and receivers
that cannot be resolved statically contribute nothing rather than
guesses.
"""
from __future__ import annotations

import ast

from ceph_tpu_torch.tools.radoslint.checkers import (dotted, terminal_name,
                                               walk_shallow)
from ceph_tpu_torch.tools.radoslint.core import Finding, SourceFile, rule

# -- what counts as a tracked lock -------------------------------------------

#: a with/async-with context expr is a tracked acquisition when the
#: terminal identifier contains one of these (matching what the runtime
#: recorder tracks: TrackedLock, asyncio/threading locks, semaphores,
#: Throttles, write gates)
_LOCKISH = ("lock", "mutex", "sem", "throttle", "gate")


def _lock_terminal(expr: ast.AST) -> str | None:
    """Terminal identifier of a lock-ish context expr, else None.
    `with self._lock:` -> '_lock'; `async with self.obj_lock(oid):` ->
    'obj_lock' (the factory names the lock family)."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    term = terminal_name(expr)
    low = term.lower()
    if any(p in low for p in _LOCKISH):
        return term
    return None


def _qualify(expr: ast.AST, module: str, cls: str | None) -> str | None:
    """Stable identity for a lock acquisition site, or None when the
    receiver cannot be resolved statically (a parameter's attribute
    could belong to any class — guessing would alias unrelated locks
    and manufacture cycles).

      self._lock            -> '<module>.<Class>._lock'
      module-level `_lock`  -> '<module>._lock'
      cls._instance_lock    -> '<module>.<Class>._instance_lock'
    """
    term = _lock_terminal(expr)
    if term is None:
        return None
    if isinstance(expr, ast.Call):
        expr = expr.func
    if isinstance(expr, ast.Name):
        return f"{module}.{term}"
    if isinstance(expr, ast.Attribute):
        recv = dotted(expr.value)
        if recv in ("self", "cls") and cls is not None:
            return f"{module}.{cls}.{term}"
    return None


# -- per-function acquisition model ------------------------------------------

class _FuncModel:
    """What one function does to tracked locks: `edges` are in-function
    ordered pairs (held, acquired, line); `acquires` is every lock the
    body takes; `calls` records resolvable callees invoked while
    holding, so closure() can charge their acquisitions to the
    caller's held set."""

    __slots__ = ("key", "path", "edges", "acquires", "calls")

    def __init__(self, key: str, path: str):
        self.key = key
        self.path = path
        self.edges: list[tuple[str, str, int]] = []
        self.acquires: set[str] = set()
        #: (held lock names at call site, callee key, line)
        self.calls: list[tuple[tuple[str, ...], str, int]] = []


def _module_name(sf: SourceFile) -> str:
    return sf.path[:-3].replace("/", ".") if sf.path.endswith(".py") \
        else sf.path.replace("/", ".")


def _callee_key(call: ast.Call, module: str,
                cls: str | None) -> str | None:
    """Resolve a call to a function key this analysis models:
    `self.meth()`/`cls.meth()` -> same class; bare `fn()` -> same
    module. Anything else (other objects, imports) is out of scope —
    their lock identities would be unresolvable anyway."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        if fn.value.id in ("self", "cls") and cls is not None:
            return f"{module}.{cls}.{fn.attr}"
        return None
    if isinstance(fn, ast.Name):
        return f"{module}.{fn.id}"
    return None


class _AcqVisitor(ast.NodeVisitor):
    """Build one function's _FuncModel: walk its body (not nested
    defs), tracking the stack of locks held via with/async-with."""

    def __init__(self, model: _FuncModel, module: str, cls: str | None):
        self.m = model
        self.module = module
        self.cls = cls
        self.held: list[str] = []

    def _visit_with(self, node: ast.With | ast.AsyncWith) -> None:
        taken = []
        for item in node.items:
            name = _qualify(item.context_expr, self.module, self.cls)
            if name is None:
                continue
            for h in self.held:
                if h != name:
                    self.m.edges.append((h, name, node.lineno))
            self.m.acquires.add(name)
            self.held.append(name)
            taken.append(name)
        for stmt in node.body:
            self.visit(stmt)
        for _ in taken:
            self.held.pop()

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def visit_Call(self, node: ast.Call) -> None:
        key = _callee_key(node, self.module, self.cls)
        if key is not None:
            self.m.calls.append((tuple(self.held), key, node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):      # nested defs run elsewhere
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _collect_models(files: list[SourceFile]) -> dict[str, _FuncModel]:
    models: dict[str, _FuncModel] = {}
    for sf in files:
        module = _module_name(sf)
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            cls = None
            # find the enclosing class by scanning top-level classes:
            # methods are direct children of a ClassDef body
            for outer in sf.tree.body:
                if isinstance(outer, ast.ClassDef) and \
                        node in outer.body:
                    cls = outer.name
                    break
            key = f"{module}.{cls}.{node.name}" if cls \
                else f"{module}.{node.name}"
            m = models.get(key)
            if m is None:
                m = models[key] = _FuncModel(key, sf.path)
            v = _AcqVisitor(m, module, cls)
            for stmt in node.body:
                v.visit(stmt)
    return models


def _closure(models: dict[str, _FuncModel]) -> dict[str, set[str]]:
    """key -> every lock the function acquires transitively (own
    acquisitions plus resolvable callees'), memoized with a recursion
    guard so mutual recursion terminates."""
    memo: dict[str, set[str]] = {}

    def go(key: str, seen: frozenset) -> set[str]:
        if key in memo:
            return memo[key]
        m = models.get(key)
        if m is None:
            return set()
        if key in seen:
            return set(m.acquires)
        acc = set(m.acquires)
        seen = seen | {key}
        for _, callee, _ in m.calls:
            acc |= go(callee, seen)
        memo[key] = acc
        return acc

    for key in models:
        go(key, frozenset())
    return memo


@rule("lock-order-cycle", "project",
      "the static lockdep (src/common/lockdep.cc): every function "
      "contributes the order it acquires tracked locks (with/async "
      "with on lock/semaphore/throttle/gate-named objects), including "
      "acquisitions by same-class/same-module callees invoked while "
      "holding; a cycle in the merged acquisition-order graph means "
      "two call paths take the same locks in opposite orders — a "
      "deadlock waiting for the right interleaving. Pick one global "
      "order and restructure the odd path out (witness rendered edge "
      "by edge).")
def check_lock_order_cycle(files: list[SourceFile]) -> list[Finding]:
    models = _collect_models(files)
    closure = _closure(models)
    # merged order graph: (before, after) -> first witness
    edges: dict[tuple[str, str], tuple[str, int, str]] = {}
    for m in models.values():
        for before, after, line in m.edges:
            edges.setdefault((before, after),
                             (m.path, line,
                              f"{m.key} acquires {after} while "
                              f"holding {before}"))
        for held, callee, line in m.calls:
            if not held:
                continue
            for after in sorted(closure.get(callee, ())):
                for before in held:
                    if before == after:
                        continue
                    edges.setdefault(
                        (before, after),
                        (m.path, line,
                         f"{m.key} calls {callee} (which acquires "
                         f"{after}) while holding {before}"))
    succ: dict[str, set[str]] = {}
    for before, after in edges:
        succ.setdefault(before, set()).add(after)

    findings: list[Finding] = []
    reported: set[frozenset] = set()
    for start in sorted(succ):
        # DFS from each node; a back-edge onto the path is a cycle
        path: list[str] = []
        on_path: dict[str, int] = {}
        visited: set[str] = set()

        def dfs(node: str) -> None:
            if node in on_path:
                ring = path[on_path[node]:]
                cyc_edges = [(ring[i], ring[(i + 1) % len(ring)])
                             for i in range(len(ring))]
                key = frozenset(cyc_edges)
                if key in reported:
                    return
                reported.add(key)
                witnesses = [edges[e] for e in cyc_edges]
                wpath, wline, _ = min(witnesses)
                findings.append(Finding(
                    wpath, wline, "lock-order-cycle",
                    "lock-order cycle " + " -> ".join(ring + [ring[0]])
                    + ": " + "; ".join(
                        f"{desc} ({p}:{ln})"
                        for p, ln, desc in witnesses)))
                return
            if node in visited:
                return
            visited.add(node)
            on_path[node] = len(path)
            path.append(node)
            for nxt in sorted(succ.get(node, ())):
                dfs(nxt)
            path.pop()
            del on_path[node]

        dfs(start)
    return findings


# -- rule: await-in-gate -----------------------------------------------------

#: holding one of these means client writes are frozen behind us
_GATE_TERMS = ("obj_lock", "write_gate")
#: awaited calls whose terminal name marks an unbounded external event
_UNBOUNDED_CALL_TERMS = ("get", "wait", "acquire", "join")
#: substrings marking grant/reservation arbiters (a QoS grant can be
#: arbitrarily delayed by the very writes the gate froze)
_GRANT_PARTS = ("grant", "reserve")
#: bare awaited names that are somebody else's promise to answer
_FUTURE_PARTS = ("fut", "waiter", "reply")


def _unbounded_await(node: ast.Await) -> str | None:
    """Description of why this await is unbounded, else None."""
    val = node.value
    if isinstance(val, ast.Call):
        fn = val.func
        term = terminal_name(fn)
        low = term.lower()
        if term == "wait_for" or any(
                kw.arg == "timeout" for kw in val.keywords):
            return None                     # deadline provided
        if term in _UNBOUNDED_CALL_TERMS and isinstance(
                fn, ast.Attribute):
            recv = dotted(fn.value) or terminal_name(fn.value)
            if term == "wait" and terminal_name(fn.value) == "asyncio":
                return None                 # asyncio.wait(timeout=...)
            return f"{recv}.{term}() can park forever"
        if any(p in low for p in _GRANT_PARTS):
            return (f"{dotted(fn) or term}() waits on a grant the "
                    f"arbiter may never issue while writes are frozen")
        return None
    term = terminal_name(val)
    if any(p in term.lower() for p in _FUTURE_PARTS):
        return f"bare await of {term} has no deadline"
    return None


class _GateVisitor(ast.NodeVisitor):
    """Track gate depth from `with ...obj_lock...:` blocks and
    block_writes/unblock_writes pairs in linear statement sequences;
    flag unbounded awaits while gated."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: list[Finding] = []
        self.gate: list[str] = []

    def _flag(self, node: ast.Await, why: str) -> None:
        self.findings.append(Finding(
            self.sf.path, node.lineno, "await-in-gate",
            f"awaiting an unbounded event while holding "
            f"{self.gate[-1]}: {why} — client writes stay frozen "
            f"behind it; wrap in asyncio.wait_for or pass timeout=",
            end_line=getattr(node, "end_lineno", 0) or 0))

    def _scan_gated(self, stmt: ast.stmt) -> None:
        for n in walk_shallow(stmt):
            if isinstance(n, ast.Await):
                why = _unbounded_await(n)
                if why is not None:
                    self._flag(n, why)

    def _visit_with(self, node: ast.With | ast.AsyncWith) -> None:
        gated = False
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                expr = expr.func
            term = terminal_name(expr).lower()
            if any(g in term for g in _GATE_TERMS):
                self.gate.append(terminal_name(expr))
                gated = True
                break
        for stmt in node.body:
            self.visit(stmt)
        if gated:
            self.gate.pop()

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def _visit_body(self, body: list[ast.stmt]) -> None:
        """Linear block_writes()..unblock_writes() region tracking in
        one statement sequence."""
        gated_here = False
        for stmt in body:
            opens = closes = False
            for n in walk_shallow(stmt):
                if isinstance(n, ast.Call):
                    t = terminal_name(n.func)
                    if t == "block_writes":
                        opens = True
                    elif t == "unblock_writes":
                        closes = True
            if gated_here and not closes:
                self._scan_gated(stmt)
            else:
                self.visit(stmt)
            if opens and not closes:
                self.gate.append("a write gate (block_writes)")
                gated_here = True
            elif closes and gated_here:
                self.gate.pop()
                gated_here = False
        if gated_here:
            self.gate.pop()

    def visit_FunctionDef(self, node):
        self._visit_body(node.body)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_If(self, node: ast.If) -> None:
        self._visit_body(node.body)
        self._visit_body(node.orelse)

    def visit_Try(self, node: ast.Try) -> None:
        self._visit_body(node.body)
        for h in node.handlers:
            self._visit_body(h.body)
        self._visit_body(node.orelse)
        self._visit_body(node.finalbody)

    def _visit_loop(self, node) -> None:
        self._visit_body(node.body)
        self._visit_body(node.orelse)

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def visit_Await(self, node: ast.Await) -> None:
        if self.gate:
            why = _unbounded_await(node)
            if why is not None:
                self._flag(node, why)
        self.generic_visit(node)


@rule("await-in-gate", "file",
      "awaiting an unbounded external event — a QoS/reservation "
      "grant, queue get, semaphore acquire, bare future/reply — while "
      "holding a write gate (block_writes..unblock_writes) or an "
      "obj_lock. The gate freezes client writes; the awaited arbiter "
      "may be waiting on those very writes to drain, which is a "
      "deadlock with extra steps. Always bound the wait: "
      "asyncio.wait_for(...) or timeout=, so a stuck grant becomes a "
      "retryable abort instead of a frozen PG.")
def check_await_in_gate(sf: SourceFile) -> list[Finding]:
    v = _GateVisitor(sf)
    v.visit(sf.tree)
    return v.findings
