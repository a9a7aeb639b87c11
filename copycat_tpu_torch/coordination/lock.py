"""Distributed mutex (reference ``DistributedLock.java:58``).

The grant is delivered as a session EVENT, not the command response: the
client registers a waiter future and completes it when the matching "lock"
event arrives. Events carry the waiter id (the Lock commit's index, also the
command result) so out-of-FIFO timeout events resolve the RIGHT waiter."""

from __future__ import annotations

import asyncio
from typing import Any

from ..resource.resource import AbstractResource, resource_info
from ..utils.tasks import spawn
from . import commands as c
from .state import LockState


@resource_info(state_machine=LockState)
class DistributedLock(AbstractResource):
    def __init__(self, client: Any) -> None:
        super().__init__(client)
        self._waiters: dict[int, asyncio.Future] = {}
        # Grants can arrive BEFORE the submit response that tells us our id
        # (events-before-response for LINEARIZABLE commands): buffer them.
        self._early_events: dict[int, bool] = {}
        # Submits that failed after the server may have committed them: their
        # grant (if any) will arrive under an id we never learned.
        self._orphaned = 0
        self._inflight = 0
        self.session().on_event("lock", self._on_lock_event)

    def _on_lock_event(self, event: dict) -> None:
        waiter_id, acquired = int(event["id"]), bool(event["acquired"])
        fut = self._waiters.pop(waiter_id, None)
        if fut is None:
            self._early_events[waiter_id] = acquired
            self._reap_orphans()
        elif not fut.done():
            fut.set_result(acquired)
        elif acquired:
            # Grant landed on an abandoned waiter (lock() task cancelled while
            # awaiting): release immediately so other clients can proceed.
            spawn(self.submit(c.Unlock()))

    def _reap_orphans(self) -> None:
        """Discard buffered events belonging to failed submits (releasing any
        grant among them). Only safe when no submit is in flight — then every
        buffered event is provably unclaimable."""
        while self._orphaned and not self._inflight and self._early_events:
            _, acquired = self._early_events.popitem()
            self._orphaned -= 1
            if acquired:
                spawn(self.submit(c.Unlock()))

    async def _submit_lock(self, timeout: float) -> asyncio.Future:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._inflight += 1
        try:
            waiter_id = int(await self.submit(c.Lock(timeout=timeout)))
        except BaseException:
            self._inflight -= 1
            self._orphaned += 1
            self._reap_orphans()
            raise
        self._inflight -= 1
        if waiter_id in self._early_events:
            fut.set_result(self._early_events.pop(waiter_id))
        else:
            self._waiters[waiter_id] = fut
        self._reap_orphans()
        return fut

    async def lock(self) -> None:
        """Acquire, waiting as long as it takes."""
        fut = await self._submit_lock(-1)
        acquired = await fut
        assert acquired, "unbounded lock() resolved False"

    async def try_lock(self, timeout: float | None = None) -> bool:
        """Immediate attempt (timeout=None/0) or bounded wait (timeout>0).
        Timeouts are measured in replicated log time: they may fire later than
        wall clock, never earlier (reference tryLock Javadoc)."""
        fut = await self._submit_lock(timeout or 0)
        return await fut

    async def unlock(self) -> None:
        await self.submit(c.Unlock())
