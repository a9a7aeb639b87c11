"""Background task spawning with strong references.

``loop.create_task`` holds only a weak reference: a fire-and-forget task can be
garbage-collected mid-execution. ``spawn`` keeps tasks alive until done and
logs unexpected exceptions.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Coroutine

logger = logging.getLogger(__name__)

_BACKGROUND: set[asyncio.Task] = set()


def spawn(coro: Coroutine[Any, Any, Any], name: str | None = None) -> asyncio.Task:
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _BACKGROUND.add(task)
    task.add_done_callback(_finish)
    return task


def _finish(task: asyncio.Task) -> None:
    _BACKGROUND.discard(task)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        # exc_info keeps the traceback in the log record: background
        # failures have no awaiter to re-raise into, so this line is
        # the only place the stack ever surfaces
        logger.error("background task %s failed: %r", task.get_name(),
                     exc, exc_info=exc)
