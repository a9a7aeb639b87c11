"""Closeable callback registrations (``Listener``/``Listeners``): each
registration is closed on its own, and a closed one receives nothing."""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Generic, Iterator, TypeVar

from .tasks import spawn

T = TypeVar("T")

class Listener(Generic[T]):
    """A single closeable callback registration.

    Callbacks may be sync or async: a coroutine returned by the callback
    is scheduled on the running event loop (event dispatch happens inside
    the session's loop), mirroring the message-bus handler contract —
    without this, an async callback would be silently dropped ("coroutine
    never awaited"), a footgun for an asyncio-first API.
    """

    def __init__(self, callback: Callable[[T], Any], parent: "Listeners[T] | None" = None):
        self._callback = callback
        self._parent = parent
        self._open = True

    def accept(self, event: T) -> Any:
        if not self._open:
            return None
        result = self._callback(event)
        if asyncio.iscoroutine(result):
            # tasks.spawn strong-refs the task until done (the loop
            # keeps only weak refs, so a suspended callback could
            # otherwise be GC'd mid-execution) and logs exceptions
            # (sync callbacks raise into the emitter; async ones cannot).
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                # Off-loop dispatch: there is nowhere to schedule the
                # coroutine. Log-and-drop instead of raising into the
                # emitter (which is usually a transport/session internals
                # path that cannot handle listener failures).
                result.close()
                logging.getLogger(__name__).error(
                    "async listener callback dropped: no running event "
                    "loop at dispatch (register sync callbacks for "
                    "off-loop emitters)")
                return None
            return spawn(result, name="listener-callback")
        return result

    def close(self) -> None:
        if self._open:
            self._open = False
            if self._parent is not None:
                self._parent._remove(self)

    @property
    def is_open(self) -> bool:
        return self._open


class Listeners(Generic[T]):
    """An ordered collection of listeners; iteration-safe under close()."""

    def __init__(self) -> None:
        self._listeners: list[Listener[T]] = []

    def add(self, callback: Callable[[T], Any]) -> Listener[T]:
        listener = Listener(callback, self)
        self._listeners.append(listener)
        return listener

    def _remove(self, listener: Listener[T]) -> None:
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    def accept(self, event: T) -> None:
        for listener in list(self._listeners):
            listener.accept(event)

    def __len__(self) -> int:
        return len(self._listeners)

    def __iter__(self) -> Iterator[Listener[T]]:
        return iter(list(self._listeners))

    def close(self) -> None:
        for listener in list(self._listeners):
            listener.close()
