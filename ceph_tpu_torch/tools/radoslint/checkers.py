"""Per-file AST checkers: the asyncio failure modes this codebase has
actually shipped (the r05 bench tail's "Task was destroyed but it is
pending", daemons wedging on teardown, event-loop stalls behind sync
syscalls). Each rule is tuned for high precision over recall — a lint
gate that cries wolf gets disabled, and then enforces nothing.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ceph_tpu_torch.tools.radoslint.core import Finding, SourceFile, rule


# -- shared AST helpers ------------------------------------------------------

def dotted(node: ast.AST) -> str | None:
    """'a.b.c' for pure Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> str:
    """Last identifier of a Name/Attribute chain ('' when neither)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def walk_shallow(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a subtree without descending into nested function bodies
    (their code runs at some other time, in some other context)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, _FUNCS):
            stack.extend(ast.iter_child_nodes(n))


def _subtree_has(stmts, *types) -> ast.AST | None:
    for stmt in stmts:
        if isinstance(stmt, types):
            return stmt
        for n in walk_shallow(stmt):
            if isinstance(n, types):
                return n
    return None


class _AsyncScopeVisitor(ast.NodeVisitor):
    """Base visitor tracking whether the innermost function is async.
    Lambdas count as sync scopes (their bodies may run in executors)."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: list[Finding] = []
        self._scopes: list[bool] = []

    @property
    def in_async(self) -> bool:
        return bool(self._scopes) and self._scopes[-1]

    def visit_FunctionDef(self, node):
        self._scopes.append(False)
        self.generic_visit(node)
        self._scopes.pop()

    def visit_Lambda(self, node):
        self._scopes.append(False)
        self.generic_visit(node)
        self._scopes.pop()

    def visit_AsyncFunctionDef(self, node):
        self._scopes.append(True)
        self.generic_visit(node)
        self._scopes.pop()

    def report(self, node: ast.AST, rule_id: str, message: str) -> None:
        self.findings.append(Finding(
            self.sf.path, getattr(node, "lineno", 0), rule_id, message,
            end_line=getattr(node, "end_lineno", 0) or 0))


# -- rule: detached-task -----------------------------------------------------

_SPAWN_ATTRS = {"create_task", "ensure_future"}
#: receivers that own their children's lifecycle (structured concurrency)
_OWNING_RECEIVERS = {"tg", "taskgroup", "group", "nursery"}


def _is_task_spawn(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _SPAWN_ATTRS:
        recv = terminal_name(fn.value).lower()
        return recv not in _OWNING_RECEIVERS
    return isinstance(fn, ast.Name) and fn.id == "ensure_future"


@rule("detached-task", "file",
      "create_task/ensure_future whose handle is dropped on the floor: "
      "nobody awaits it, cancels it, or even holds a strong reference "
      "(the loop keeps only a weak one), so daemon teardown cannot reap "
      "it and loop close destroys it pending — the messenger "
      "_dispatch_loop leak class. Store the handle, await it, or "
      "register it with a tracked reap set.")
def check_detached_task(sf: SourceFile) -> list[Finding]:
    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Expr) and \
                isinstance(node.value, ast.Call) and \
                _is_task_spawn(node.value):
            name = dotted(node.value.func) or "create_task"
            out.append(Finding(
                sf.path, node.lineno, "detached-task",
                f"task from {name}(...) is discarded — store/await the "
                f"handle or add it to a tracked reap set",
                end_line=node.end_lineno or 0))
    return out


# -- rule: blocking-in-coroutine ---------------------------------------------

_BLOCKING_DOTTED = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "os.system": "use the offload service or run_in_executor",
    "os.popen": "use the offload service or run_in_executor",
    "os.wait": "use asyncio subprocess APIs",
}
_SUBPROCESS_FNS = {"run", "call", "check_call", "check_output", "Popen",
                   "getoutput", "getstatusoutput"}


class _BlockingVisitor(_AsyncScopeVisitor):

    def visit_Call(self, node: ast.Call):
        if self.in_async:
            d = dotted(node.func)
            if d in _BLOCKING_DOTTED:
                self.report(node, "blocking-in-coroutine",
                            f"{d}() blocks the event loop inside a "
                            f"coroutine — {_BLOCKING_DOTTED[d]}")
            elif d is not None and d.startswith("subprocess.") and \
                    d.split(".")[-1] in _SUBPROCESS_FNS:
                self.report(node, "blocking-in-coroutine",
                            f"{d}() blocks the event loop inside a "
                            f"coroutine — use asyncio.create_subprocess_* "
                            f"or run_in_executor")
            elif isinstance(node.func, ast.Name) and node.func.id == "open":
                self.report(node, "blocking-in-coroutine",
                            "sync file I/O (open) inside a coroutine "
                            "stalls every task on the loop — move it to "
                            "run_in_executor or the offload service")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "result" and not node.args and \
                    isinstance(node.func.value, ast.Call) and \
                    terminal_name(node.func.value.func) == "submit":
                self.report(node, "blocking-in-coroutine",
                            ".submit(...).result() synchronously waits on "
                            "an executor inside a coroutine — await "
                            "run_in_executor / wrap_future instead")
        self.generic_visit(node)


@rule("blocking-in-coroutine", "file",
      "sync blocking calls (time.sleep, subprocess, sync file I/O, "
      "executor .result()) inside `async def` stall the whole event "
      "loop: every connection, heartbeat, and op on the daemon freezes "
      "behind one syscall. Route bulk work through the offload service "
      "or loop.run_in_executor; sleep with asyncio.sleep.")
def check_blocking(sf: SourceFile) -> list[Finding]:
    v = _BlockingVisitor(sf)
    v.visit(sf.tree)
    return v.findings


# -- rule: await-under-lock --------------------------------------------------

def _looks_like_lock(expr: ast.AST) -> bool:
    term = terminal_name(expr).lower()
    return "lock" in term or "mutex" in term


class _AwaitUnderLockVisitor(_AsyncScopeVisitor):

    def visit_With(self, node: ast.With):
        if self.in_async:
            for item in node.items:
                if _looks_like_lock(item.context_expr):
                    hit = _subtree_has(node.body, ast.Await, ast.AsyncFor,
                                       ast.AsyncWith)
                    if hit is not None:
                        name = dotted(item.context_expr) or "lock"
                        self.report(
                            node, "await-under-lock",
                            f"await at line {hit.lineno} while holding "
                            f"sync lock {name!r}: the lock pins the event "
                            f"loop thread across a suspension point — "
                            f"every other task contending it deadlocks "
                            f"the loop. Use asyncio.Lock + `async with`, "
                            f"or release before awaiting")
                    break
        self.generic_visit(node)


@rule("await-under-lock", "file",
      "the lockdep analog (src/common/lockdep.cc): holding a "
      "threading.Lock across an `await` inside a coroutine. The await "
      "suspends with the lock held on the loop thread; any other "
      "coroutine (or executor callback) that tries to take it blocks "
      "the only thread that could ever release it. asyncio.Lock with "
      "`async with`, or drop the lock before suspending.")
def check_await_under_lock(sf: SourceFile) -> list[Finding]:
    v = _AwaitUnderLockVisitor(sf)
    v.visit(sf.tree)
    return v.findings


# -- rule: loop-affinity -----------------------------------------------------

_LOOP_ATTRS = {"_loop", "loop"}
_LOOP_UNSAFE = {"call_soon", "call_later", "call_at", "create_task"}


class _LoopAffinityVisitor(_AsyncScopeVisitor):
    """Driving ANOTHER object's event-loop handle with a non-threadsafe
    primitive: `svc._loop.call_soon(...)` / `conn.loop.create_task(...)`
    where the receiver is not `self`. Under the sharded reactor the
    other object's loop is routinely a different shard's, and
    call_soon/create_task from a foreign thread corrupts the loop's
    ready queue (asyncio only checks with debug mode on). `self._loop.X`
    stays legal — an object drives its own loop from its own methods —
    and the threadsafe seams (call_soon_threadsafe,
    run_coroutine_threadsafe) are exactly what the rule pushes toward."""

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _LOOP_UNSAFE \
                and isinstance(fn.value, ast.Attribute) \
                and fn.value.attr in _LOOP_ATTRS:
            # `self._loop.X` is the object driving its OWN loop (legal);
            # `self.svc._loop.X` is driving the loop of an object we
            # merely hold a reference to — foreign, flagged
            owner = dotted(fn.value.value)
            if owner is not None and owner != "self":
                self.report(
                    node, "loop-affinity",
                    f"{owner}.{fn.value.attr}.{fn.attr}(...) drives "
                    f"another object's event loop without the "
                    f"threadsafe handoff: under the sharded reactor "
                    f"{owner}'s loop can be a different shard's thread, "
                    f"and {fn.attr} from a foreign thread corrupts the "
                    f"loop's ready queue — use "
                    f"{owner}.{fn.value.attr}.call_soon_threadsafe or "
                    f"asyncio.run_coroutine_threadsafe")
        self.generic_visit(node)


@rule("loop-affinity", "file",
      "cross-shard loop discipline (the sharded reactor's lockdep): "
      "loop-bound objects (OffloadService, Throttle waiters, messenger "
      "connections) belong to exactly one shard, and scheduling onto "
      "ANOTHER object's loop handle via call_soon/call_later/call_at/"
      "create_task is only safe from that loop's own thread. Foreign "
      "owners must cross through call_soon_threadsafe / "
      "run_coroutine_threadsafe (or reactor.ShardPool.run_on), which "
      "are loop-safe from any thread.")
def check_loop_affinity(sf: SourceFile) -> list[Finding]:
    v = _LoopAffinityVisitor(sf)
    v.visit(sf.tree)
    return v.findings


# -- rule: cancellation-swallow ----------------------------------------------

_CANCEL_NAMES = {"BaseException", "CancelledError",
                 "asyncio.CancelledError"}


def _catches_cancel(handler_type: ast.AST | None) -> bool:
    if handler_type is None:                    # bare except
        return True
    if isinstance(handler_type, ast.Tuple):
        return any(_catches_cancel(e) for e in handler_type.elts)
    return dotted(handler_type) in _CANCEL_NAMES


def _suppresses_cancel(call: ast.Call) -> bool:
    d = dotted(call.func)
    if d is None or d.split(".")[-1] != "suppress":
        return False
    return any(_catches_cancel(a) for a in call.args)


class _CancelSwallowVisitor(_AsyncScopeVisitor):

    def visit_Try(self, node: ast.Try):
        if self.in_async and _subtree_has(
                node.body, ast.Await, ast.AsyncFor, ast.AsyncWith):
            for handler in node.handlers:
                if not _catches_cancel(handler.type):
                    continue
                # the first handler wide enough to take CancelledError
                # shadows every later one — only it matters
                if _subtree_has(handler.body, ast.Raise) is None:
                    what = (dotted(handler.type) if handler.type is not None
                            and not isinstance(handler.type, ast.Tuple)
                            else "a clause catching CancelledError")
                    self.report(
                        handler, "cancellation-swallow",
                        f"coroutine catches {what} around an await "
                        f"without re-raising: task.cancel() (daemon "
                        f"teardown) silently no-ops and the task keeps "
                        f"running — re-raise CancelledError (utils."
                        f"async_util.reap does this correctly)")
                break
        self.generic_visit(node)

    def visit_With(self, node: ast.With):
        if self.in_async:
            for item in node.items:
                if isinstance(item.context_expr, ast.Call) and \
                        _suppresses_cancel(item.context_expr) and \
                        _subtree_has(node.body, ast.Await, ast.AsyncFor,
                                     ast.AsyncWith):
                    self.report(
                        node, "cancellation-swallow",
                        "contextlib.suppress over CancelledError around "
                        "an await eats the reaper's own cancellation — "
                        "use utils.async_util.reap")
                    break
        self.generic_visit(node)


@rule("cancellation-swallow", "file",
      "a coroutine that catches CancelledError (bare except, "
      "BaseException, an explicit CancelledError clause, or "
      "contextlib.suppress) around an await and does not re-raise "
      "breaks daemon teardown: stop() cancels the task, the task eats "
      "it and keeps running. Plain `except Exception` is fine — since "
      "3.8 CancelledError derives from BaseException and sails past it.")
def check_cancellation_swallow(sf: SourceFile) -> list[Finding]:
    v = _CancelSwallowVisitor(sf)
    v.visit(sf.tree)
    return v.findings
