"""Async distributed set (reference ``DistributedSet.java:35``)."""

from __future__ import annotations

from typing import Any

from ..resource.resource import AbstractResource, resource_info
from . import commands as c
from .state import SetState


@resource_info(state_machine=SetState)
class DistributedSet(AbstractResource):
    async def add(self, value: Any, ttl: float | None = None) -> bool:
        return bool(await self.submit(c.SetAdd(value=value, ttl=ttl)))

    async def remove(self, value: Any) -> bool:
        return bool(await self.submit(c.SetRemove(value=value)))

    async def contains(self, value: Any) -> bool:
        return bool(await self.submit(c.SetContains(value=value)))

    async def is_empty(self) -> bool:
        return bool(await self.submit(c.SetIsEmpty()))

    async def size(self) -> int:
        return int(await self.submit(c.SetSize()))

    async def clear(self) -> None:
        await self.submit(c.SetClear())
