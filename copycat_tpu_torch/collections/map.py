"""Async distributed map (reference ``DistributedMap.java:54``): the full
Map surface incl. TTL variants of every write."""

from __future__ import annotations

from typing import Any

from ..resource.resource import AbstractResource, resource_info
from . import commands as c
from .state import MapState


@resource_info(state_machine=MapState)
class DistributedMap(AbstractResource):
    async def is_empty(self) -> bool:
        return bool(await self.submit(c.MapIsEmpty()))

    async def size(self) -> int:
        return int(await self.submit(c.MapSize()))

    async def contains_key(self, key: Any) -> bool:
        return bool(await self.submit(c.MapContainsKey(key=key)))

    async def contains_value(self, value: Any) -> bool:
        return bool(await self.submit(c.MapContainsValue(value=value)))

    async def get(self, key: Any) -> Any:
        return await self.submit(c.MapGet(key=key))

    async def get_or_default(self, key: Any, default: Any) -> Any:
        return await self.submit(c.MapGetOrDefault(key=key, default=default))

    async def put(self, key: Any, value: Any, ttl: float | None = None) -> Any:
        return await self.submit(c.MapPut(key=key, value=value, ttl=ttl))

    async def put_if_absent(self, key: Any, value: Any, ttl: float | None = None) -> Any:
        return await self.submit(c.MapPutIfAbsent(key=key, value=value, ttl=ttl))

    async def remove(self, key: Any) -> Any:
        return await self.submit(c.MapRemove(key=key))

    async def remove_if_present(self, key: Any, value: Any) -> bool:
        return bool(await self.submit(c.MapRemoveIfPresent(key=key, value=value)))

    async def replace(self, key: Any, value: Any, ttl: float | None = None) -> Any:
        return await self.submit(c.MapReplace(key=key, value=value, ttl=ttl))

    async def replace_if_present(self, key: Any, expect: Any, value: Any,
                                 ttl: float | None = None) -> bool:
        return bool(await self.submit(
            c.MapReplaceIfPresent(key=key, expect=expect, value=value, ttl=ttl)))

    async def clear(self) -> None:
        await self.submit(c.MapClear())
