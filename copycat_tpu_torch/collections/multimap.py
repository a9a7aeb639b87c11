"""Async distributed multimap (reference ``DistributedMultiMap.java:35``):
key -> set of values."""

from __future__ import annotations

from typing import Any

from ..resource.resource import AbstractResource, resource_info
from . import commands as c
from .state import MultiMapState


@resource_info(state_machine=MultiMapState)
class DistributedMultiMap(AbstractResource):
    async def is_empty(self) -> bool:
        return bool(await self.submit(c.MultiMapIsEmpty()))

    async def size(self, key: Any = None) -> int:
        """Global size, or per-key value count when ``key`` given
        (reference ``MultiMapState.java:169-185``)."""
        return int(await self.submit(c.MultiMapSize(key=key)))

    async def contains_key(self, key: Any) -> bool:
        return bool(await self.submit(c.MultiMapContainsKey(key=key)))

    async def contains_entry(self, key: Any, value: Any) -> bool:
        return bool(await self.submit(c.MultiMapContainsEntry(key=key, value=value)))

    async def contains_value(self, value: Any) -> bool:
        return bool(await self.submit(c.MultiMapContainsValue(value=value)))

    async def put(self, key: Any, value: Any, ttl: float | None = None) -> bool:
        return bool(await self.submit(c.MultiMapPut(key=key, value=value, ttl=ttl)))

    async def get(self, key: Any) -> list:
        return list(await self.submit(c.MultiMapGet(key=key)))

    async def remove(self, key: Any, value: Any = None) -> Any:
        if value is None:
            return await self.submit(c.MultiMapRemove(key=key))
        return bool(await self.submit(c.MultiMapRemoveEntry(key=key, value=value)))

    async def clear(self) -> None:
        await self.submit(c.MultiMapClear())
