"""Distributed leader election (reference ``DistributedLeaderElection.java:66``).

``on_election(cb)`` — the first local listener submits Listen; the "elect"
event carries the EPOCH (= the winning Listen's commit index), which doubles
as a fencing token validated with ``is_leader(epoch)``."""

from __future__ import annotations

import asyncio
from typing import Any, Callable

from ..resource.resource import AbstractResource, resource_info
from ..utils.listeners import Listener, Listeners
from . import commands as c
from .state import LeaderElectionState


@resource_info(state_machine=LeaderElectionState)
class DistributedLeaderElection(AbstractResource):
    def __init__(self, client: Any) -> None:
        super().__init__(client)
        self._listeners = Listeners()
        self._listening = False
        # Serializes Listen/Unlisten transitions: without it, an on_election
        # racing a resign() sees _listening still True mid-Unlisten and never
        # re-submits Listen (same gate as AbstractResource._tracked_listener).
        self._gate = asyncio.Lock()
        self.session().on_event("elect", self._on_elect)

    def _on_elect(self, epoch: int) -> None:
        self._listeners.accept(epoch)

    async def on_election(self, callback: Callable[[int], Any]) -> Listener:
        """Register for leadership; ``callback(epoch)`` fires when this
        instance becomes leader."""
        # The callback must be registered BEFORE the submit: with ATOMIC
        # consistency the "elect" event reaches us before the Listen response
        # (events-before-response, reference Consistency.java:157-176).
        listener = self._listeners.add(callback)
        try:
            async with self._gate:
                if not self._listening:
                    await self.submit(c.ElectionListen())
                    self._listening = True  # flips only on success
        except BaseException:
            listener.close()  # roll back so a retry re-submits
            raise
        return listener

    async def resign(self) -> None:
        """Give up leadership / candidacy (submits Unlisten)."""
        async with self._gate:
            if self._listening:
                await self.submit(c.ElectionUnlisten())
                self._listening = False

    async def is_leader(self, epoch: int) -> bool:
        """Validate a fencing token against current leadership."""
        return bool(await self.submit(c.ElectionIsLeader(epoch=epoch)))
