"""Cancellable timers (Catalyst ``Scheduled`` equivalent).

The reference's ``ThreadContext.schedule(delay[, interval]) -> Scheduled`` backs
every election timeout and heartbeat.  State-machine TTL timers do NOT use this:
they are log-time driven (see server/state_machine.py), matching the reference's
deterministic timer discipline (SURVEY.md §5.9)."""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable

from .tasks import spawn

logger = logging.getLogger(__name__)


class Scheduled:
    """Handle for a scheduled (optionally repeating) callback on the event loop.

    Must be constructed inside a running event loop.  Async callbacks run in a
    detached (but strongly-referenced) task so that ``cancel()`` only cancels
    the pending timer, never an in-flight callback — an election-timer callback
    that resets its own timer must not cancel itself.  For repeating timers a
    new invocation is skipped while the previous one is still running, so slow
    callbacks (e.g. keep-alives during leader loss) never pile up.
    """

    def __init__(
        self,
        delay: float,
        interval: float | None,
        callback: Callable[[], Awaitable[None] | None],
    ) -> None:
        self._delay = delay
        self._interval = interval
        self._callback = callback
        self._inflight: asyncio.Task | None = None
        self._task: asyncio.Task | None = spawn(self._run(), name="scheduled-timer")

    async def _run(self) -> None:
        try:
            await asyncio.sleep(self._delay)
            while True:
                self._invoke()
                if self._interval is None:
                    return
                await asyncio.sleep(self._interval)
        except asyncio.CancelledError:
            pass

    def _invoke(self) -> None:
        if self._inflight is not None and not self._inflight.done():
            return  # previous invocation still running - don't overlap
        try:
            result = self._callback()
        except Exception:
            logger.exception("scheduled callback failed")
            return
        if asyncio.iscoroutine(result):
            self._inflight = spawn(self._guard(result), name="scheduled-callback")

    @staticmethod
    async def _guard(coro) -> None:
        try:
            await coro
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("scheduled async callback failed")

    def cancel(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    @property
    def is_done(self) -> bool:
        return self._task is None or self._task.done()


def schedule(delay: float, callback: Callable[[], Awaitable[None] | None]) -> Scheduled:
    return Scheduled(delay, None, callback)


def schedule_repeating(
    delay: float, interval: float, callback: Callable[[], Awaitable[None] | None]
) -> Scheduled:
    return Scheduled(delay, interval, callback)
