"""Async open/close lifecycle (Catalyst ``Managed<T>`` equivalent).

Consumed by the reference as ``Managed{open(), isOpen(), close(), isClosed()}``
returning ``CompletableFuture`` (SURVEY.md §2.3); here ``open``/``close`` are
coroutines."""

from __future__ import annotations

import abc
import asyncio
from typing import Any


class Managed(abc.ABC):
    """A resource with an async open/close lifecycle."""

    def __init__(self) -> None:
        self._open = False
        self._lifecycle_lock: asyncio.Lock | None = None

    def _lock(self) -> asyncio.Lock:
        if self._lifecycle_lock is None:
            self._lifecycle_lock = asyncio.Lock()
        return self._lifecycle_lock

    async def open(self) -> "Managed":
        async with self._lock():
            if not self._open:
                await self._do_open()
                self._open = True
        return self

    async def close(self) -> None:
        async with self._lock():
            if self._open:
                self._open = False
                await self._do_close()

    @property
    def is_open(self) -> bool:
        return self._open

    @property
    def is_closed(self) -> bool:
        return not self._open

    async def _do_open(self) -> None:  # pragma: no cover - default no-op
        pass

    async def _do_close(self) -> None:  # pragma: no cover - default no-op
        pass

    async def __aenter__(self) -> Any:
        return await self.open()

    async def __aexit__(self, *exc: object) -> None:
        await self.close()
