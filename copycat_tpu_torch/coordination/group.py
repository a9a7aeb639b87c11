"""Group membership with remote execution (reference
``DistributedMembershipGroup.java:95``, ``GroupMember.java:31``).

Member id = the member's instance-session id.  Remote execution ships a
REGISTERED CALLBACK NAME + args through the log (the reference serialized
``Runnable`` closures — deliberately not reproduced; SURVEY.md §7.2 step 6):
the target member must have registered the name with ``handler()``."""

from __future__ import annotations

from typing import Any, Callable

from ..resource.resource import AbstractResource, resource_info
from ..utils.listeners import Listener, Listeners
from . import commands as c
from .state import MembershipGroupState


class GroupMember:
    """Handle for executing callbacks on a remote member."""

    def __init__(self, group: "DistributedMembershipGroup", member_id: int) -> None:
        self._group = group
        self.id = member_id

    async def execute(self, callback: str, *args: Any) -> bool:
        return bool(await self._group.submit(
            c.GroupExecute(member=self.id, callback=callback, args=list(args))))

    async def schedule(self, delay: float, callback: str, *args: Any) -> bool:
        return bool(await self._group.submit(
            c.GroupSchedule(member=self.id, delay=delay,
                            callback=callback, args=list(args))))


@resource_info(state_machine=MembershipGroupState)
class DistributedMembershipGroup(AbstractResource):
    def __init__(self, client: Any) -> None:
        super().__init__(client)
        self._join_listeners = Listeners()
        self._leave_listeners = Listeners()
        self._handlers: dict[str, Callable[..., Any]] = {}
        session = self.session()
        session.on_event("join", lambda m: self._join_listeners.accept(GroupMember(self, m)))
        session.on_event("leave", lambda m: self._leave_listeners.accept(m))
        session.on_event("execute", self._on_execute)

    def _on_execute(self, payload: Any) -> None:
        callback, args = payload
        handler = self._handlers.get(callback)
        if handler is not None:
            handler(*(args or []))

    def handler(self, name: str, fn: Callable[..., Any]) -> None:
        """Register a callback invocable by other members."""
        self._handlers[name] = fn

    async def join(self) -> GroupMember:
        """Join; this member's id is its instance-session id."""
        await self.submit(c.GroupJoin())
        return GroupMember(self, self.session().id)

    async def leave(self) -> None:
        await self.submit(c.GroupLeave())

    async def members(self) -> list[GroupMember]:
        ids = await self.submit(c.GroupListen())
        return [GroupMember(self, m) for m in ids]

    def member(self, member_id: int) -> GroupMember:
        return GroupMember(self, member_id)

    def on_join(self, callback: Callable[[GroupMember], Any]) -> Listener:
        return self._join_listeners.add(callback)

    def on_leave(self, callback: Callable[[int], Any]) -> Listener:
        return self._leave_listeners.add(callback)
