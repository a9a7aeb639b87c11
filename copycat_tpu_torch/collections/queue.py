"""Async distributed FIFO queue (reference ``DistributedQueue.java:34``).

Peek is a query; poll/element/remove are commands — they mutate or must clean
retained commits (reference QueueCommands note, SURVEY.md §2.1)."""

from __future__ import annotations

from typing import Any

from ..resource.resource import AbstractResource, resource_info
from . import commands as c
from .state import QueueState


@resource_info(state_machine=QueueState)
class DistributedQueue(AbstractResource):
    async def add(self, value: Any) -> bool:
        return bool(await self.submit(c.QueueAdd(value=value)))

    async def offer(self, value: Any) -> bool:
        return bool(await self.submit(c.QueueOffer(value=value)))

    async def peek(self) -> Any:
        return await self.submit(c.QueuePeek())

    async def poll(self) -> Any:
        return await self.submit(c.QueuePoll())

    async def element(self) -> Any:
        """Head of the queue; raises if empty."""
        return await self.submit(c.QueueElement())

    async def remove(self, value: Any = None) -> Any:
        """Remove head (value=None, raises if empty) or a specific value."""
        return await self.submit(c.QueueRemove(value=value))

    async def contains(self, value: Any) -> bool:
        return bool(await self.submit(c.QueueContains(value=value)))

    async def is_empty(self) -> bool:
        return bool(await self.submit(c.QueueIsEmpty()))

    async def size(self) -> int:
        return int(await self.submit(c.QueueSize()))

    async def clear(self) -> None:
        await self.submit(c.QueueClear())
