"""Shared asyncio lifecycle helpers: cancellation-correct task reaping.

Every daemon in this stack ends the same way: cancel background tasks,
await them, swallow the expected CancelledError. Hand-rolled versions of
that dance keep re-growing the same two bugs radoslint's
cancellation-swallow rule exists for:

  * `except (asyncio.CancelledError, Exception): pass` swallows OUR OWN
    cancellation too — a teardown coroutine that is itself cancelled
    (test timeout, parent daemon dying) silently keeps running instead
    of unwinding, which is exactly how half-dead daemons linger;
  * `Task.cancelling()` is 3.11+; calling it on 3.10 raises
    AttributeError from inside the except handler (seen latent in the
    messenger's transport close path).

`reap()` centralizes the correct version: cancel the task, await it,
swallow only the CancelledError that belongs to the reaped task, and
re-raise when the *current* task is the one being cancelled.

The port's copy of ceph_tpu/utils/async_util.py (jax-free; the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
from typing import Iterable


def being_cancelled() -> bool:
    """True when the current task has a pending cancellation request.

    Uses Task.cancelling() on 3.11+; on 3.10 there is no reliable
    signal, so this degrades to False (matching the historical swallow
    behavior instead of crashing on a missing attribute)."""
    task = asyncio.current_task()
    if task is None:
        return False
    cancelling = getattr(task, "cancelling", None)
    if cancelling is None:
        return False
    return bool(cancelling())


async def reap(task: asyncio.Task | None) -> None:
    """Cancel `task` and await its completion.

    Swallows the task's own CancelledError and logged-elsewhere
    exceptions (the task already ran its error handling; reapers only
    care that it is DONE), but re-raises when the reaping task is
    itself being cancelled — teardown must stay cancellable."""
    if task is None:
        return
    task.cancel()
    try:
        # shield: a cancel aimed at US must not be delivered by
        # cancelling `task` (Task.cancel() cancels the awaited future —
        # without the shield that IS `task`, which then finishes
        # cancelled and makes our own cancellation indistinguishable
        # from the reaped task's on 3.10, where being_cancelled() is
        # blind). With the shield, `task.done()` is a reliable witness.
        await asyncio.shield(task)
    except asyncio.CancelledError:
        # two sources: the reaped task finishing cancelled (swallow) or
        # our own wait being interrupted (propagate). If the reaped
        # task is not done, the cancellation was ours.
        if being_cancelled() or not task.done():
            raise
    except Exception:
        pass


async def reap_all(tasks: Iterable[asyncio.Task | None]) -> None:
    """Cancel every task first (concurrent teardown), then await each.

    Cancellation-complete: when the reaping task is ITSELF cancelled
    mid-loop, the first reap() re-raises — the old version then skipped
    the remaining tasks, leaving them cancelled-but-never-awaited, i.e.
    pending at loop close ("Task was destroyed but it is pending!", the
    messenger _pump sub-task flavor of the teardown tail spam). Our
    own CancelledError is held until every task has been awaited, then
    re-raised — teardown stays cancellable without abandoning work."""
    live = [t for t in tasks if t is not None]
    for t in live:
        t.cancel()
    interrupted: asyncio.CancelledError | None = None
    for t in live:
        try:
            await reap(t)
        # deferred re-raise below, once every task is done — not a
        # swallow
        # radoslint: disable-next=cancellation-swallow
        except asyncio.CancelledError as e:
            interrupted = e          # finish reaping before unwinding
            if not t.done():
                # our own cancel interrupted THIS task's reap — await it
                # through (it is already cancelled); a repeated cancel
                # during the retry abandons it as the last resort
                try:
                    await reap(t)
                # radoslint: disable-next=cancellation-swallow
                except asyncio.CancelledError:
                    pass
    if interrupted is not None:
        raise interrupted


async def drain(task: asyncio.Task | None) -> None:
    """Await `task` WITHOUT cancelling it — for work that must complete
    (a detached close(), an in-flight commit), where cancelling would
    leave shared state half-torn-down. Same cancellation contract as
    reap(): the task's own failure/cancellation is swallowed, our own
    cancellation propagates."""
    if task is None:
        return
    try:
        # shield, for two reasons: cancelling US must not collaterally
        # cancel the task we promised to await WITHOUT cancelling, and
        # (as in reap) it keeps `task.done()` a reliable witness of
        # whose CancelledError this is on 3.10.
        await asyncio.shield(task)
    except asyncio.CancelledError:
        if being_cancelled() or not task.done():
            raise
    except Exception:
        pass


async def drain_all(tasks: Iterable[asyncio.Task | None]) -> None:
    """drain() each task; like reap_all, our own cancellation is held
    until every task was awaited (abandoning the tail leaks it)."""
    interrupted: asyncio.CancelledError | None = None
    for t in list(tasks):
        try:
            await drain(t)
        # deferred re-raise below, once every task was awaited
        # radoslint: disable-next=cancellation-swallow
        except asyncio.CancelledError as e:
            interrupted = e
            if t is not None and not t.done():
                # finish waiting out the interrupted task; a repeated
                # cancel during the retry abandons it as the last resort
                try:
                    await drain(t)
                # radoslint: disable-next=cancellation-swallow
                except asyncio.CancelledError:
                    pass
    if interrupted is not None:
        raise interrupted


async def bounded_stop(coro, timeout: float) -> bool:
    """Await a teardown coroutine under a deadline WITHOUT leaking it.

    The old pattern — `asyncio.wait_for(daemon.stop(), 20)` inside
    `except Exception: pass` — cancels a slow stop() halfway through
    its own reaping and abandons it, leaving connection/dispatch tasks
    pending at loop close ("Task was destroyed but it is pending!").
    Here the timeout instead REAPS the
    half-finished teardown (cancel + await), so everything it owns is
    done before we return. Returns True when the stop completed
    cleanly, False on timeout or failure."""
    task = asyncio.get_running_loop().create_task(coro)
    try:
        await asyncio.wait_for(asyncio.shield(task), timeout)
        return True
    except asyncio.TimeoutError:
        # the reap gets its own deadline: a stop() that swallows the
        # injected cancel (or whose finally awaits a wedged peer) must
        # not hang teardown forever — abandoning it, and eating one
        # destroyed-pending report, is the last resort
        try:
            await asyncio.wait_for(reap(task), timeout)
        except asyncio.TimeoutError:
            pass
        return False
    except asyncio.CancelledError:
        await reap(task)
        raise
    except Exception:
        return False


# -- executor-backed file I/O -------------------------------------------------
# Sync open()/read()/write() inside a coroutine stalls the whole event
# loop behind one syscall (radoslint: blocking-in-coroutine). The CLI
# tools route one-shot blob I/O through the default executor instead.

async def read_file(path: str) -> bytes:
    def _read() -> bytes:
        with open(path, "rb") as f:
            return f.read()
    return await asyncio.get_running_loop().run_in_executor(None, _read)


async def write_file(path: str, data: bytes) -> None:
    def _write() -> None:
        with open(path, "wb") as f:
            f.write(data)
    await asyncio.get_running_loop().run_in_executor(None, _write)
