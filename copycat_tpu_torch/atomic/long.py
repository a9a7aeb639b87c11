"""Distributed counter (reference ``DistributedAtomicLong.java:29``).

Arithmetic is implemented CLIENT-SIDE as an optimistic compare-and-set retry
loop over the underlying atomic value — exactly the reference's ``updateValue``
recursion — exercising the linearizable CAS path under contention (this is
BASELINE config #1)."""

from __future__ import annotations

from typing import Any

from ..resource.resource import resource_info
from . import commands
from .state import AtomicValueState
from .value import DistributedAtomicValue


@resource_info(state_machine=AtomicValueState)
class DistributedAtomicLong(DistributedAtomicValue):
    _UNSET = object()

    def __init__(self, client: Any) -> None:
        super().__init__(client)
        self._raw: Any = self._UNSET  # last observed raw value (None = unset register)

    async def get(self) -> int:
        self._raw = await super().get()
        return int(self._raw) if self._raw is not None else 0

    async def set(self, value: int, ttl: float | None = None) -> None:
        await super().set(int(value), ttl)
        self._raw = int(value)

    async def _update(self, delta: int) -> tuple[int, int]:
        """CAS-retry loop; returns (old, new).  CAS runs against the RAW
        register value so the unset (None) register reads as 0 but still
        compare-and-sets correctly. Submits the CAS directly through the
        flattened facade lane (one coroutine frame fewer per op than
        going through :meth:`compare_and_set` — this loop IS the spi
        bench's hot path)."""
        if self._raw is self._UNSET:
            await self.get()
        while True:
            expect_raw = self._raw
            old = int(expect_raw) if expect_raw is not None else 0
            update = old + delta
            if await self.submit_command(
                    commands.CompareAndSet(expect_raw, update, None)):
                self._raw = update
                return old, update
            await self.get()  # refresh and retry

    async def add_and_get(self, delta: int) -> int:
        return (await self._update(delta))[1]

    async def get_and_add(self, delta: int) -> int:
        return (await self._update(delta))[0]

    async def increment_and_get(self) -> int:
        return await self.add_and_get(1)

    async def decrement_and_get(self) -> int:
        return await self.add_and_get(-1)

    async def get_and_increment(self) -> int:
        return await self.get_and_add(1)

    async def get_and_decrement(self) -> int:
        return await self.get_and_add(-1)
