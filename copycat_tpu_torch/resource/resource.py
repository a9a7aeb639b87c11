"""Client-side resource base classes (reference ``Resource.java:41``,
``AbstractResource.java:42``, ``ResourceInfo.java:31``, ``Resources.java:27``).
"""

from __future__ import annotations

from typing import Any, Callable, TypeVar

from ..protocol.operations import Command, Operation, Query
from .consistency import Consistency
from .operations import DeleteCommand, ResourceCommand, ResourceQuery

R = TypeVar("R", bound="Resource")


def resource_info(state_machine: type) -> Callable[[type], type]:
    """Binds a resource class to its server state machine class (the
    reference's ``@ResourceInfo(stateMachine=...)`` annotation)."""

    def bind(cls: type) -> type:
        cls.__resource_state_machine__ = state_machine
        return cls

    return bind


def resource_state_machine_of(resource_type: type) -> type:
    """Walks the MRO for the bound state machine (``Resources.getInfo``)."""
    for cls in resource_type.__mro__:
        machine = cls.__dict__.get("__resource_state_machine__")
        if machine is not None:
            return machine
    raise ValueError(f"{resource_type.__qualname__} has no @resource_info binding")


class Resource:
    """A distributed object replicated via the cluster (reference
    ``Resource.java:41-78``): consistency config, session identity, delete."""

    def __init__(self, client: Any) -> None:
        # ``client`` is a RaftClient-shaped object - normally an InstanceClient
        # (manager layer) so every op is routed to this resource's instance.
        self.client = client
        self._consistency = Consistency.ATOMIC
        # wire-level consistency strings, cached per facade: the enum
        # mapping lookups are per-op costs on the submit hot path
        self._write_cl = self._consistency.write_consistency().value
        self._read_cl = self._consistency.read_consistency().value

    def with_consistency(self, consistency: Consistency) -> "Resource":
        self._consistency = consistency
        self._write_cl = consistency.write_consistency().value
        self._read_cl = consistency.read_consistency().value
        return self

    @property
    def consistency(self) -> Consistency:
        return self._consistency

    def session(self) -> Any:
        return self.client.session()

    async def delete(self) -> None:
        """Delete the resource's replicated state."""
        await self.client.submit(DeleteCommand())


class AbstractResource(Resource):
    """Wraps every submitted op in Resource{Command,Query} with the configured
    consistency (reference ``AbstractResource.submit:73,88``)."""

    async def submit(self, operation: Operation) -> Any:
        if isinstance(operation, Query):
            return await self.client.submit(
                ResourceQuery(operation, self._read_cl))
        if isinstance(operation, Command):
            return await self.client.submit(
                ResourceCommand(operation, self._write_cl))
        raise TypeError(f"not an operation: {operation!r}")

    def submit_command(self, operation: Operation) -> Any:
        """Awaitable command submit with the submit chain flattened: when
        the client exposes the future-returning fast lane
        (``submit_command_nowait``), the whole facade→instance→client
        chain runs synchronously and the caller awaits ONE future — the
        per-op coroutine frames were a measured share of the public SPI
        plane's per-core ceiling (PERF.md round 6)."""
        nowait = getattr(self.client, "submit_command_nowait", None)
        command = ResourceCommand(operation, self._write_cl)
        if nowait is None:  # custom client shims: keep the coroutine path
            return self.client.submit(command)
        return nowait(command)

    async def _tracked_listener(self, listeners: Any, callback: Callable,
                                state: dict, listen_op: Operation,
                                unlisten_op_factory: Callable[[], Operation]):
        """First-listener-registers / last-close-unregisters pattern
        (reference ``DistributedAtomicValue.onChange`` et al.): the first local
        listener submits ``listen_op`` server-side; closing the last one
        submits the unlisten op in the background."""
        import asyncio

        from ..utils.tasks import spawn

        # Serialize listen/unlisten transitions: without the lock a failed
        # Listen would leave ``listening`` wedged True, and a background
        # Unlisten could race a new Listen submitted right after last-close.
        gate: asyncio.Lock = state.setdefault("gate", asyncio.Lock())
        # Register the local callback BEFORE submitting Listen: with ATOMIC
        # consistency the first event can arrive before the Listen response
        # (events-before-response, reference Consistency.java:157-176).
        listener = listeners.add(callback)
        try:
            async with gate:
                if not state.get("listening"):
                    await self.submit(listen_op)  # flag flips only on success
                    state["listening"] = True
        except BaseException:
            listener.close()  # roll back so a retry re-submits
            raise
        original_close = listener.close

        async def unlisten_if_idle() -> None:
            async with gate:
                if len(listeners) == 0 and state.get("listening"):
                    await self.submit(unlisten_op_factory())
                    state["listening"] = False

        def close_and_maybe_unlisten() -> None:
            original_close()
            if len(listeners) == 0 and state.get("listening"):
                spawn(unlisten_if_idle(), name="resource-unlisten")

        listener.close = close_and_maybe_unlisten  # type: ignore[method-assign]
        return listener
