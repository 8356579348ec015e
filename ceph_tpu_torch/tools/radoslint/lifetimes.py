"""Zero-copy lifetime & cross-shard dataflow rules: the interlock
static half.

The messenger and the offload service buy their speed by replacing
copies with MEMORYVIEWS over buffers that get *recycled* — `Frame.read`
segments window the receive body, offload staging pages are reused warm
across batches, bufferlist fragments alias caller arrays — and the
reactor's ShardPool puts mutable service state (`shared()` objects, the
offload device topology) in reach of N OS threads at once. Both
disciplines were hand-audited; these rules make the audit mechanical,
the way `loop-affinity` froze the reactor's loop-handle discipline:

  * `view-escape` — a view derived from a pooled/recycled source
    (staging pages via `get_staging`, frame `segments`, raw
    `memoryview(...)` windows) must not be STORED on an object/
    container or RETURNED without materialization: once it outlives
    its dispatch scope, nothing ties its lifetime to the buffer's
    recycle point, and the first reuse rewrites bytes under it.
  * `view-across-await` — holding a RECYCLED-source view (staging
    pages, frame segments) across an `await`: the suspension is
    exactly where another task can recycle the buffer, so the resumed
    code reads the next batch's bytes. Materialize before suspending,
    or re-derive the view after.
  * `shard-shared-mutation` — attribute/container writes to a
    ShardPool `shared()` object outside a lock-scoped `with` block.
    `shared()` state is the one thing multiple reactor threads touch
    by design (device topology, breakers, mesh caches); every mutation
    must sit under the object's lock or cross a threadsafe seam —
    this generalizes `loop-affinity` from loop-API calls to data.
  * `proc-shared-state` — thread-backed conveniences reaching into a
    PROCESS-backed pool (`ProcShardPool`): mutating a `shared()`
    result (cross-process memory doesn't exist — no lock fixes it) or
    handing `run_on()` a closure/coroutine whose captured parent state
    cannot cross the interpreter boundary. The marshalling rule the
    process-per-shard runtime enforces at runtime, caught statically.

All four are local-dataflow rules (per function scope, no
cross-function propagation) tuned for precision: a finding means the
pattern is textually present, not merely possible. Designed-in
zero-copy contracts (e.g. `Frame._parse_segments` returning views the
caller refcounts) carry justified `# radoslint: disable=` comments.
"""
from __future__ import annotations

import ast

from ceph_tpu_torch.tools.radoslint.checkers import (_FUNCS, _looks_like_lock,
                                               dotted, terminal_name)
from ceph_tpu_torch.tools.radoslint.core import Finding, SourceFile, rule

#: call attrs that hand out a window onto a RECYCLED pool (the staging
#: slot API); results must never escape the dispatch scope
_POOLED_CALL_ATTRS = {"get_staging"}
#: attribute names whose subscripts/iteration yield receive-buffer
#: views (frame segments over the rx body)
_SEGMENT_ATTRS = {"segments"}
#: wrapping a view in any of these materializes (or intentionally
#: re-owns) the bytes — the escape hatch the rules push toward
_MATERIALIZERS = {"bytes", "bytearray", "tobytes", "copy", "deepcopy",
                  "array", "asarray", "concatenate", "frombuffer",
                  "list", "hexlify", "join", "guard_view"}


def _is_materialized(node: ast.AST) -> bool:
    """True when `node` wraps its operand in a copying constructor
    (`bytes(v)`, `np.array(v)`, `v.tobytes()`) — or the sanitizer's
    generation guard, which re-ties the view to the recycle point."""
    if isinstance(node, ast.Call):
        return terminal_name(node.func) in _MATERIALIZERS
    return False


def _source_label(node: ast.AST) -> str | None:
    """Classify an expression as a pooled-view producer.

    Returns "staging" (recycled pool), "frame-seg" (receive-buffer
    window), "view" (raw memoryview window), or None. Recycled sources
    ("staging"/"frame-seg") additionally feed `view-across-await`.
    """
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _POOLED_CALL_ATTRS:
            return "staging"
        if isinstance(fn, ast.Name) and fn.id == "memoryview":
            return "view"
        return None
    if isinstance(node, ast.Subscript):
        if terminal_name(node.value) in _SEGMENT_ATTRS:
            return "frame-seg"
        # a slice of a producer is a window over the same pool
        return _source_label(node.value)
    return None


_RECYCLED = {"staging", "frame-seg"}


def _iter_functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class _EventVisitor(ast.NodeVisitor):
    """Linearize one function body into a source-order event stream:

      ("bind", name, label, lineno)   tracked-view binding
      ("unbind", name)                name rebound to something clean
      ("use", name, lineno)           Load of a tracked-candidate name
      ("await", lineno)               suspension point

    An Await's OPERAND is visited before the await event is emitted, so
    `await f(view)` orders the use before the suspension (handing a
    view INTO an awaited call is fine; resuming with it is not).
    Nested function bodies are skipped — their views live a different
    lifetime."""

    def __init__(self):
        self.events: list[tuple] = []

    def run(self, fn: ast.AST) -> list[tuple]:
        for stmt in fn.body:
            self.visit(stmt)
        return self.events

    def visit_FunctionDef(self, node):          # skip nested scopes
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Await(self, node: ast.Await):
        self.generic_visit(node)
        self.events.append(("await", node.lineno))

    def visit_Assign(self, node: ast.Assign):
        self.visit(node.value)                  # uses in the RHS first
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            lbl = _source_label(node.value)
            if lbl is None and isinstance(node.value, ast.Subscript) and \
                    isinstance(node.value.value, ast.Name):
                # slice of a (possibly tracked) name: resolved later
                self.events.append(("bind-slice", name,
                                    node.value.value.id, node.lineno))
                return
            if lbl is not None and not _is_materialized(node.value):
                self.events.append(("bind", name, lbl, node.lineno))
            else:
                self.events.append(("unbind", name))
        else:
            for t in node.targets:
                self.visit(t)

    def visit_For(self, node: ast.For):
        self.visit(node.iter)
        if isinstance(node.target, ast.Name) and \
                terminal_name(node.iter) in _SEGMENT_ATTRS:
            self.events.append(("bind", node.target.id, "frame-seg",
                                node.lineno))
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load):
            self.events.append(("use", node.id, node.lineno))


@rule("view-across-await", "file",
      "a view over a RECYCLED buffer (staging page, frame segment) "
      "used after an `await` that follows its derivation: the "
      "suspension point is exactly where another task can complete a "
      "batch and recycle the source, so the resumed code reads the "
      "next batch's bytes. Materialize before suspending, finish with "
      "the view first, or re-derive it after the await.")
def check_view_across_await(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    for fn in _iter_functions(sf.tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        events = _EventVisitor().run(fn)
        bound: dict[str, tuple[str, int, int]] = {}  # name->(lbl,pos,line)
        flagged: set[str] = set()
        awaits: list[int] = []
        for pos, ev in enumerate(events):
            kind = ev[0]
            if kind == "await":
                awaits.append(pos)
            elif kind == "bind":
                _, name, lbl, line = ev
                if lbl in _RECYCLED:
                    bound[name] = (lbl, pos, line)
                else:
                    bound.pop(name, None)
            elif kind == "bind-slice":
                _, name, src, line = ev
                ent = bound.get(src)
                if ent is not None:
                    bound[name] = (ent[0], pos, line)
                else:
                    bound.pop(name, None)
            elif kind == "unbind":
                bound.pop(ev[1], None)
            elif kind == "use":
                _, name, line = ev
                ent = bound.get(name)
                if ent is None or name in flagged:
                    continue
                lbl, bpos, bline = ent
                if any(bpos < a < pos for a in awaits):
                    flagged.add(name)
                    out.append(Finding(
                        sf.path, line, "view-across-await",
                        f"{lbl} view {name!r} (derived at line {bline}) "
                        f"used after an await: the source buffer can be "
                        f"recycled while this coroutine is suspended — "
                        f"materialize before the await or re-derive the "
                        f"view after it"))
    return out


# -- rule: view-escape --------------------------------------------------------

def _stmt_walk(stmts):
    """Source-order walk over every node of a statement list, skipping
    nested function bodies."""
    stack = list(reversed(list(stmts)))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, _FUNCS):
            stack.extend(reversed(list(ast.iter_child_nodes(n))))


def _value_label(node: ast.AST, tracked: dict) -> str | None:
    """Label of an expression: a producer, a tracked name, or a slice
    of a tracked name (still a window over the same pool)."""
    lbl = _source_label(node)
    if lbl is not None:
        return lbl
    if isinstance(node, ast.Name):
        ent = tracked.get(node.id)
        return ent if isinstance(ent, str) else None
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        ent = tracked.get(node.value.id)
        return ent if isinstance(ent, str) else None
    return None


@rule("view-escape", "file",
      "a memoryview over a pooled/recycled buffer (offload staging "
      "pages via get_staging, frame `segments` windows, raw "
      "memoryview(...) slices) stored on an object attribute, appended "
      "to a container reachable through an attribute, or returned from "
      "the deriving scope. Nothing ties the escaped view's lifetime to "
      "the buffer's recycle point: the next batch/frame rewrites the "
      "bytes under it and the corruption surfaces stripes later. "
      "Materialize (`bytes(v)`, `.tobytes()`) before storing, or keep "
      "the view inside its dispatch scope. Designed-in zero-copy "
      "returns (refcounted fresh buffers) carry a justified "
      "`# radoslint: disable=view-escape`.")
def check_view_escape(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    for fn in _iter_functions(sf.tree):
        tracked: dict[str, str] = {}          # name -> label
        for node in _stmt_walk(fn.body):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
                lbl = _value_label(val, tracked)
                if isinstance(tgt, ast.Name):
                    if lbl is not None and not _is_materialized(val):
                        tracked[tgt.id] = lbl
                    else:
                        tracked.pop(tgt.id, None)     # rebound clean
                elif lbl is not None and not _is_materialized(val) and (
                        isinstance(tgt, ast.Attribute) or
                        (isinstance(tgt, ast.Subscript) and
                         isinstance(tgt.value, ast.Attribute))):
                    # `self.x = v` / `self.cache[k] = v` escape; a
                    # LOCAL container (`out[i] = v`) stays in scope —
                    # its own escape is the function's return contract
                    base = tgt if isinstance(tgt, ast.Attribute) \
                        else tgt.value
                    where = dotted(base) or "container"
                    out.append(Finding(
                        sf.path, node.lineno, "view-escape",
                        f"{lbl} view stored on {where}: it outlives "
                        f"its dispatch scope while the source buffer "
                        f"gets recycled — materialize with bytes()/"
                        f".tobytes() or keep the view local",
                        end_line=node.end_lineno or 0))
            elif isinstance(node, ast.For) and \
                    isinstance(node.target, ast.Name) and \
                    terminal_name(node.iter) in _SEGMENT_ATTRS:
                tracked[node.target.id] = "frame-seg"
            elif isinstance(node, ast.Expr) and \
                    isinstance(node.value, ast.Call):
                call = node.value
                if isinstance(call.func, ast.Attribute) and \
                        call.func.attr in ("append", "add") and \
                        isinstance(call.func.value, ast.Attribute) and \
                        len(call.args) == 1:
                    lbl = _value_label(call.args[0], tracked)
                    if lbl is not None and \
                            not _is_materialized(call.args[0]):
                        where = dotted(call.func.value) or "container"
                        out.append(Finding(
                            sf.path, node.lineno, "view-escape",
                            f"{lbl} view appended to {where}: the "
                            f"container outlives the dispatch scope "
                            f"while the source buffer gets recycled — "
                            f"materialize before storing",
                            end_line=node.end_lineno or 0))
            elif isinstance(node, ast.Return) and node.value is not None:
                lbl = _value_label(node.value, tracked)
                if lbl is not None and not _is_materialized(node.value):
                    out.append(Finding(
                        sf.path, node.lineno, "view-escape",
                        f"{lbl} view returned from {fn.name}(): the "
                        f"caller holds a window onto a buffer this "
                        f"scope no longer controls — materialize, or "
                        f"document the refcount contract with a "
                        f"justified disable",
                        end_line=node.end_lineno or 0))
    return out


# -- rule: shard-shared-mutation ----------------------------------------------

_MUTATORS = {"append", "add", "update", "setdefault", "pop", "remove",
             "clear", "extend", "insert", "discard"}


def _with_is_locked(node: ast.With | ast.AsyncWith) -> bool:
    for item in node.items:
        expr = item.context_expr
        if _looks_like_lock(expr):
            return True
        if isinstance(expr, ast.Call) and _looks_like_lock(expr.func):
            return True
    return False


def _shared_bindings(stmts):
    """(names, dotted-paths) bound from `<pool>.shared(...)` calls in a
    statement list."""
    names: set[str] = set()
    paths: set[str] = set()
    for node in _stmt_walk(stmts):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Attribute) \
                and node.value.func.attr == "shared":
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                names.add(tgt.id)
            else:
                d = dotted(tgt)
                if d is not None:
                    paths.add(d)
    return names, paths


@rule("shard-shared-mutation", "file",
      "attribute or container mutation of a ShardPool shared() object "
      "outside a lock-scoped `with`: shared() state (offload device "
      "topology, breakers, mesh caches) is touched by every reactor "
      "thread in the pool, and an unlocked write races the other "
      "shards — torn breaker state, lost mesh-cache entries. Mutate "
      "under the object's lock (`with topo.lock:`) or marshal through "
      "a threadsafe seam (run_on / call_soon_threadsafe). The data "
      "half of the loop-affinity discipline.")
def check_shard_shared_mutation(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    # class-level: `self._topo = pool.shared(...)` in ANY method (the
    # real offload shape binds in __init__, mutates in routing methods)
    # marks that self-path shared for every method of the class
    class_paths: dict[ast.AST, set[str]] = {}
    for cls in ast.walk(sf.tree):
        if isinstance(cls, ast.ClassDef):
            paths: set[str] = set()
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    _, p = _shared_bindings(item.body)
                    paths |= {x for x in p if x.startswith("self.")}
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    class_paths[item] = paths
    for fn in _iter_functions(sf.tree):
        shared_names, shared_paths = _shared_bindings(fn.body)
        shared_paths = shared_paths | class_paths.get(fn, set())
        if not shared_names and not shared_paths:
            continue

        def receiver(expr: ast.AST) -> str | None:
            """The tracked shared object an attribute chain hangs off:
            `topo.states` -> 'topo'; `self._topo.mesh` -> 'self._topo'
            when `self._topo = pool.shared(...)` was seen."""
            d = dotted(expr)
            if d is None:
                return None
            if d.split(".")[0] in shared_names:
                return d.split(".")[0]
            for sp in shared_paths:
                if d == sp or d.startswith(sp + "."):
                    return sp
            return None

        def walk(stmts, locked: bool):
            for node in stmts:
                if isinstance(node, _FUNCS):
                    continue
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    walk(node.body, locked or _with_is_locked(node))
                    continue
                if isinstance(node, (ast.Assign, ast.AugAssign)) \
                        and not locked:
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for tgt in targets:
                        if not isinstance(tgt, (ast.Attribute,
                                                ast.Subscript)):
                            continue
                        if isinstance(tgt, ast.Attribute) and \
                                "lock" in tgt.attr.lower():
                            continue        # installing the lock itself
                        recv = receiver(tgt.value)
                        if recv is not None:
                            out.append(Finding(
                                sf.path, node.lineno,
                                "shard-shared-mutation",
                                f"write to shared() object {recv!r} "
                                f"outside its lock: every reactor "
                                f"thread in the pool sees this state — "
                                f"mutate under `with {recv}.lock:` or "
                                f"cross a threadsafe seam",
                                end_line=node.end_lineno or 0))
                elif isinstance(node, ast.Expr) and not locked and \
                        isinstance(node.value, ast.Call) and \
                        isinstance(node.value.func, ast.Attribute) and \
                        node.value.func.attr in _MUTATORS:
                    recv = receiver(node.value.func.value)
                    if recv is not None:
                        out.append(Finding(
                            sf.path, node.lineno, "shard-shared-mutation",
                            f"{node.value.func.attr}() mutates shared() "
                            f"object {recv!r} outside its lock — mutate "
                            f"under `with {recv}.lock:` or cross a "
                            f"threadsafe seam",
                            end_line=node.end_lineno or 0))
                for blk in ("body", "orelse", "finalbody"):
                    part = getattr(node, blk, None)
                    if part and isinstance(part, list) and \
                            part and isinstance(part[0], ast.stmt):
                        walk(part, locked)
                for h in getattr(node, "handlers", []):
                    walk(h.body, locked)

        walk(fn.body, False)
    return out


# -- rule: proc-shared-state --------------------------------------------------

def _proc_pool_bindings(stmts):
    """(names, dotted-paths) bound from `ProcShardPool(...)` calls in a
    statement list."""
    names: set[str] = set()
    paths: set[str] = set()
    for node in _stmt_walk(stmts):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.value, ast.Call) \
                and terminal_name(node.value.func) == "ProcShardPool":
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                names.add(tgt.id)
            else:
                d = dotted(tgt)
                if d is not None:
                    paths.add(d)
    return names, paths


@rule("proc-shared-state", "file",
      "thread-backed pool conveniences reaching into a PROCESS-backed "
      "reactor pool: mutating the result of a ProcShardPool "
      "`shared()`, or handing a `run_on()` closure/coroutine (which "
      "captures parent-process state) to one. Cross-process memory "
      "does not exist — the \"shared\" object is a parent-local "
      "orphan the workers never see, and a closure cannot be shipped "
      "to another interpreter. Marshal explicit JSON through the "
      "control channel (`pool.call()` / `pool.config_set()` / "
      "`pool.boot_osd()`), or let state flow over the cluster's own "
      "wire protocol. The runtime raises on both; this rule catches "
      "the pattern before it runs.")
def check_proc_shared_state(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    # class-level: `self._pool = ProcShardPool(...)` in any method
    # marks that self-path process-backed for every method; shared()
    # results bound off it anywhere are tracked class-wide too (the
    # shard-shared-mutation shape, minus the lock escape — a lock
    # doesn't span processes)
    class_pools: dict[ast.AST, set[str]] = {}
    class_shared: dict[ast.AST, set[str]] = {}
    for cls in ast.walk(sf.tree):
        if isinstance(cls, ast.ClassDef):
            paths: set[str] = set()
            methods = [item for item in cls.body
                       if isinstance(item, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
            for item in methods:
                _, p = _proc_pool_bindings(item.body)
                paths |= {x for x in p if x.startswith("self.")}
            # second pass: `self.X = self._pool.shared(...)` bound in
            # any method (the __init__-binds / method-mutates shape) is
            # proc-shared for every method of the class
            shared: set[str] = set()
            for item in methods:
                for node in _stmt_walk(item.body):
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1 \
                            and isinstance(node.value, ast.Call) \
                            and isinstance(node.value.func,
                                           ast.Attribute) \
                            and node.value.func.attr == "shared":
                        recv = dotted(node.value.func.value)
                        if recv is not None and recv in paths:
                            d = dotted(node.targets[0])
                            if d is not None and d.startswith("self."):
                                shared.add(d)
            for item in methods:
                class_pools[item] = paths
                class_shared[item] = shared

    for fn in _iter_functions(sf.tree):
        pool_names, pool_paths = _proc_pool_bindings(fn.body)
        pool_paths = pool_paths | class_pools.get(fn, set())
        if not pool_names and not pool_paths:
            continue

        def is_pool(expr: ast.AST) -> bool:
            d = dotted(expr)
            return d is not None and (d in pool_names or d in pool_paths)

        def is_pool_shared_call(expr: ast.AST) -> bool:
            return isinstance(expr, ast.Call) \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr == "shared" \
                and is_pool(expr.func.value)

        # names/paths bound from `<procpool>.shared(...)`
        shared_names: set[str] = set()
        shared_paths: set[str] = set(class_shared.get(fn, set()))
        for node in _stmt_walk(fn.body):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and is_pool_shared_call(node.value):
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    shared_names.add(tgt.id)
                else:
                    d = dotted(tgt)
                    if d is not None:
                        shared_paths.add(d)

        def shared_receiver(expr: ast.AST) -> str | None:
            if is_pool_shared_call(expr):
                return "shared() result"
            d = dotted(expr)
            if d is None:
                return None
            if d.split(".")[0] in shared_names:
                return d.split(".")[0]
            for sp in shared_paths:
                if d == sp or d.startswith(sp + "."):
                    return sp
            return None

        for node in _stmt_walk(fn.body):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    if not isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        continue
                    recv = shared_receiver(tgt.value)
                    if recv is not None and not is_pool_shared_call(
                            node.value):
                        out.append(Finding(
                            sf.path, node.lineno, "proc-shared-state",
                            f"write to process-backed pool shared() "
                            f"object {recv!r}: worker processes share "
                            f"no memory with this one — the mutation "
                            f"is a parent-local orphan. Marshal it "
                            f"through the control channel "
                            f"(pool.call/config_set)",
                            end_line=node.end_lineno or 0))
            elif isinstance(node, ast.Expr) and \
                    isinstance(node.value, ast.Call) and \
                    isinstance(node.value.func, ast.Attribute):
                call = node.value
                if call.func.attr in _MUTATORS:
                    recv = shared_receiver(call.func.value)
                    if recv is not None:
                        out.append(Finding(
                            sf.path, node.lineno, "proc-shared-state",
                            f"{call.func.attr}() mutates process-"
                            f"backed pool shared() object {recv!r}: "
                            f"no worker process will ever see it — "
                            f"marshal through the control channel",
                            end_line=node.end_lineno or 0))
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "run_on" and \
                    is_pool(node.func.value) and \
                    any(isinstance(a, (ast.Call, ast.Lambda))
                        for a in node.args):
                out.append(Finding(
                    sf.path, node.lineno, "proc-shared-state",
                    f"run_on() hands a closure/coroutine built in "
                    f"THIS process to a process-backed pool: its "
                    f"captured state cannot cross the interpreter "
                    f"boundary — use "
                    f"{dotted(node.func.value)}.call(index, request) "
                    f"with JSON-marshalled arguments",
                    end_line=node.end_lineno or 0))
    return out
