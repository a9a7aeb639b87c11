"""Client API for the linearizable register (reference
``DistributedAtomicValue.java:38``): get/set/get_and_set/compare_and_set with
optional TTLs, plus ``on_change`` listeners fed by "change" session events
(first local listener submits Listen; last close submits Unlisten)."""

from __future__ import annotations

from typing import Any, Callable

from ..resource.resource import AbstractResource, resource_info
from ..utils.listeners import Listener, Listeners
from . import commands
from .state import AtomicValueState


@resource_info(state_machine=AtomicValueState)
class DistributedAtomicValue(AbstractResource):
    def __init__(self, client: Any) -> None:
        super().__init__(client)
        self._change_listeners = Listeners()
        self._listen_state: dict = {}
        self.session().on_event("change", self._on_change)

    async def get(self) -> Any:
        return await self.submit(commands.Get())

    async def set(self, value: Any, ttl: float | None = None) -> None:
        await self.submit_command(commands.Set(value=value, ttl=ttl))

    async def get_and_set(self, value: Any, ttl: float | None = None) -> Any:
        return await self.submit_command(
            commands.GetAndSet(value=value, ttl=ttl))

    async def compare_and_set(self, expect: Any, update: Any,
                              ttl: float | None = None) -> bool:
        return bool(await self.submit_command(
            commands.CompareAndSet(expect=expect, update=update, ttl=ttl)))

    async def on_change(self, callback: Callable[[Any], Any]) -> Listener:
        """Register a change listener; the first one registers server-side."""
        return await self._tracked_listener(
            self._change_listeners, callback, self._listen_state,
            commands.Listen(), commands.Unlisten)

    def _on_change(self, value: Any) -> None:
        self._change_listeners.accept(value)
