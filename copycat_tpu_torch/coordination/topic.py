"""Pub/sub through the replicated log (reference ``DistributedTopic.java:61``).

``sync()`` = ATOMIC (subscribers receive before publish completes);
``async_()`` = SEQUENTIAL."""

from __future__ import annotations

from typing import Any, Callable

from ..resource.consistency import Consistency
from ..resource.resource import AbstractResource, resource_info
from ..utils.listeners import Listener, Listeners
from . import commands as c
from .state import TopicState


@resource_info(state_machine=TopicState)
class DistributedTopic(AbstractResource):
    def __init__(self, client: Any) -> None:
        super().__init__(client)
        self._subscribers = Listeners()
        self._listen_state: dict = {}
        self.session().on_event("message", self._on_message)

    def _on_message(self, message: Any) -> None:
        self._subscribers.accept(message)

    def sync(self) -> "DistributedTopic":
        """Publishes complete only after subscribers received the message."""
        return self.with_consistency(Consistency.ATOMIC)  # type: ignore[return-value]

    def async_(self) -> "DistributedTopic":
        """Publishes complete on commit; delivery is sequential, async."""
        return self.with_consistency(Consistency.SEQUENTIAL)  # type: ignore[return-value]

    async def publish(self, message: Any) -> None:
        await self.submit(c.TopicPublish(message=message))

    async def subscribe(self, callback: Callable[[Any], Any]) -> Listener:
        return await self._tracked_listener(
            self._subscribers, callback, self._listen_state,
            c.TopicListen(), c.TopicUnlisten)
