"""Client-side resource virtualization (reference ``InstanceClient.java:35``,
``InstanceSession.java:33``).

``InstanceClient`` implements the RaftClient submit surface but prefixes every
operation with the instance id; ``InstanceSession`` filters the parent
session's events down to this instance (by ``InstanceEvent.resource``).
"""

from __future__ import annotations

from typing import Any, Callable

from ..client.client import ClientSession, RaftClient
from ..protocol.operations import Command, Operation, Query
from ..resource.operations import DeleteCommand
from ..utils.listeners import Listener, Listeners
from .operations import DeleteResource, InstanceCommand, InstanceEvent, InstanceQuery


class InstanceSession:
    """Per-resource view over the parent client session."""

    def __init__(self, instance_id: int, parent: ClientSession) -> None:
        self.id = instance_id
        self.parent = parent
        self._local_listeners: dict[str, Listeners] = {}
        self._parent_listeners: dict[str, Listener] = {}

    @property
    def is_open(self) -> bool:
        return self.parent.is_open

    def on_event(self, event: str, callback: Callable[[Any], Any]) -> Listener:
        listeners = self._local_listeners.get(event)
        if listeners is None:
            listeners = self._local_listeners[event] = Listeners()
            # One parent listener per event name; fans out to local listeners
            # after filtering by instance id (InstanceSession.java handleEvent).
            self._parent_listeners[event] = self.parent.on_event(
                event, lambda message, _e=event: self._handle(_e, message))
        local = listeners.add(callback)
        return local

    def _handle(self, event: str, message: Any) -> None:
        if isinstance(message, InstanceEvent):
            if message.resource != self.id:
                return
            payload = message.message
        else:
            payload = message
        listeners = self._local_listeners.get(event)
        if listeners is not None:
            listeners.accept(payload)

    def publish(self, event: str, message: Any = None) -> None:
        """Local loopback publish: only this node's listeners see it."""
        listeners = self._local_listeners.get(event)
        if listeners is not None:
            listeners.accept(message)

    def on_open(self, callback: Callable[[Any], Any]) -> Listener:
        return self.parent.on_open(callback)

    def on_close(self, callback: Callable[[Any], Any]) -> Listener:
        return self.parent.on_close(callback)

    def close(self) -> None:
        for listener in self._parent_listeners.values():
            listener.close()
        self._parent_listeners.clear()
        self._local_listeners.clear()


class InstanceClient:
    """RaftClient facade routing every op to one resource instance."""

    def __init__(self, instance_id: int, client: RaftClient,
                 on_delete=None) -> None:
        self.instance_id = instance_id
        self.client = client
        self._session = InstanceSession(instance_id, client.session())
        # notifies the owning Atomix facade so its get() singleton cache
        # drops the key — a later get() must create a FRESH resource, not
        # hand back a facade whose server-side instance is gone
        self._on_delete = on_delete

    def session(self) -> InstanceSession:
        return self._session

    def submit_command_nowait(self, operation: Operation) -> Any:
        """Future-returning command submit (the flattened hot path):
        wraps in the instance envelope and stages straight into the
        parent client's micro-batch. Plain commands only — delete
        chaining and queries keep the coroutine path."""
        return self.client.submit_command_nowait(
            InstanceCommand(self.instance_id, operation))

    async def submit(self, operation: Operation) -> Any:
        if isinstance(operation, DeleteCommand):
            # Reference InstanceClient.java:73-75: resource-level delete, then
            # catalog-level DeleteResource.
            result = await self.client.submit(
                InstanceCommand(self.instance_id, operation))
            await self.client.submit(DeleteResource(self.instance_id))
            self._session.close()
            if self._on_delete is not None:
                self._on_delete()
            return result
        if isinstance(operation, Query):
            return await self.client.submit(InstanceQuery(self.instance_id, operation))
        if isinstance(operation, Command):
            return await self.client.submit(InstanceCommand(self.instance_id, operation))
        raise TypeError(f"not an operation: {operation!r}")

    async def close(self) -> None:
        self._session.close()
