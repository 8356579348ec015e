"""Async completion API over the Objecter — the librados AIO /
neorados role.

Re-creation of the reference's async client surfaces:
  * `AioCompletion` (src/librados/AioCompletionImpl.h: is_complete /
    wait_for_complete / get_return_value / callbacks) wrapping an
    in-flight op;
  * dispatch returns IMMEDIATELY with a completion; results and errors
    surface when awaited (neorados' asio-future style collapsed onto
    asyncio);
  * an in-flight throttle caps CONCURRENTLY EXECUTING ops the way
    the Objecter's op budget does (objecter_inflight_ops / Throttle in
    src/osdc/Objecter.h); submission itself never blocks — a producer
    issuing unbounded fire-and-forget ops should interleave
    `aio_flush()` to bound its queue;
  * `aio_flush` (rados_aio_flush) waits for everything outstanding on
    the ioctx.

The port's copy of ceph_tpu/rados/aio.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
from typing import Any, Callable

from ceph_tpu_torch.utils import tracer


class AioCompletion:
    """One in-flight async op (AioCompletionImpl)."""

    def __init__(self):
        self._fut: asyncio.Future = asyncio.get_running_loop(
        ).create_future()
        self._callbacks: list[Callable[["AioCompletion"], None]] = []

    # -- producer side -------------------------------------------------------

    def _finish(self, result: Any = None,
                error: BaseException | None = None) -> None:
        if self._fut.done():
            return
        if error is not None:
            self._fut.set_exception(error)
            # mark retrieved: a fire-and-forget op that fails must not
            # spam "Future exception was never retrieved" at GC —
            # wait_for_complete still re-raises from the future
            self._fut.exception()
        else:
            self._fut.set_result(result)
        for cb in self._callbacks:
            try:
                cb(self)
            except Exception:
                pass

    # -- consumer side -------------------------------------------------------

    def is_complete(self) -> bool:
        return self._fut.done()

    async def wait_for_complete(self) -> Any:
        """Await the result (raises the op's error, like
        get_return_value returning rc<0)."""
        return await asyncio.shield(self._fut)

    def get_return_value(self) -> Any:
        """Result of a COMPLETED op (ValueError while in flight)."""
        if not self._fut.done():
            raise ValueError("operation still in flight")
        return self._fut.result()

    def add_callback(self, fn: Callable[["AioCompletion"], None]) -> None:
        """rados_aio_set_complete_callback: fires at completion (or
        immediately if already complete)."""
        if self._fut.done():
            fn(self)
        else:
            self._callbacks.append(fn)


class AioDispatcher:
    """Per-client submission engine: throttle + task tracking.

    Attached lazily to a RadosClient; IoCtx.aio_* routes through it."""

    MAX_INFLIGHT = 64          # objecter_inflight_ops-lite

    def __init__(self, max_inflight: int | None = None):
        self._throttle = asyncio.Semaphore(
            max_inflight or self.MAX_INFLIGHT)
        self._inflight: set[asyncio.Task] = set()

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def submit(self, coro) -> AioCompletion:
        comp = AioCompletion()

        async def run():
            acquired = False
            try:
                # the task inherits the submitter's trace context, so an
                # aio op traced from application code stays one trace;
                # this span additionally shows throttle-queue wait
                # (elided on unsampled traces — rados_op covers it)
                with tracer.span_sampled_only("aio_op", "client"):
                    await self._throttle.acquire()
                    acquired = True
                    comp._finish(await coro)
            except asyncio.CancelledError as e:
                # record the op as failed, then PROPAGATE: swallowing
                # here made flush()/teardown cancellation a silent no-op
                # (the task kept running to loop close)
                comp._finish(error=e)
                raise
            except Exception as e:
                comp._finish(error=e)
            finally:
                if acquired:
                    self._throttle.release()
        t = asyncio.get_running_loop().create_task(run())
        self._inflight.add(t)
        t.add_done_callback(self._inflight.discard)
        return comp

    async def flush(self) -> None:
        """Wait for every outstanding op (rados_aio_flush). Errors stay
        in their completions — flush itself never raises."""
        while self._inflight:
            await asyncio.gather(*list(self._inflight),
                                 return_exceptions=True)
