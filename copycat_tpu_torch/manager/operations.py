"""Catalog + envelope operations (reference serializer ids 30-38).

- Catalog ops manage the name->resource registry: ``GetResource`` (id 35,
  LINEARIZABLE), ``CreateResource`` (36, carries the state-machine class as a
  registered class reference, cf. ``CreateResource.java:55-66``),
  ``DeleteResource`` (37), ``ResourceExists`` (38, LINEARIZABLE query).
- Envelope ops route an operation to a resource instance: ``InstanceCommand``
  (30) / ``InstanceQuery`` (31); ``InstanceEvent`` (32) routes session events
  back, filtered client-side by instance id.

All are generic field-list serializable (``Message``), so the native
codec walks instance envelopes — the wrapper around every routed op —
entirely in C.
"""

from __future__ import annotations

from typing import Any

from ..io.serializer import serialize_with
from ..protocol.messages import Message
from ..protocol.operations import Command, CommandConsistency, Persistence, Query, QueryConsistency


class KeyOperation(Message):
    """Base for catalog ops addressing a resource by name (``KeyOperation.java``)."""

    _fields = ("key",)

    def __init__(self, key: str = "") -> None:
        self.key = key


@serialize_with(35)
class GetResource(KeyOperation, Command):
    """Get-or-create the resource and attach (at most) one instance per client
    session; returns the instance id."""

    _fields = ("key", "state_machine")

    def __init__(self, key: str = "", state_machine: type | None = None) -> None:
        super().__init__(key)
        self.state_machine = state_machine

    def consistency(self) -> CommandConsistency:
        return CommandConsistency.LINEARIZABLE


@serialize_with(36)
class CreateResource(GetResource):
    """Like GetResource but always creates a fresh instance (unique session)."""


@serialize_with(37)
class DeleteResource(Message, Command):
    """Deletes a resource's replicated state entirely (by instance id)."""

    _fields = ("instance_id",)

    def __init__(self, instance_id: int = 0) -> None:
        self.instance_id = instance_id

    def persistence(self) -> Persistence:
        return Persistence.PERSISTENT


@serialize_with(38)
class ResourceExists(KeyOperation, Query):
    def consistency(self) -> QueryConsistency:
        return QueryConsistency.LINEARIZABLE


class InstanceOperation(Message):
    """Envelope (instance id, inner operation)."""

    _fields = ("resource", "operation")

    def __init__(self, resource: int = 0, operation: Any = None) -> None:
        self.resource = resource
        self.operation = operation


@serialize_with(30)
class InstanceCommand(InstanceOperation, Command):
    def consistency(self) -> CommandConsistency | None:
        if isinstance(self.operation, Command):
            return self.operation.consistency()
        return CommandConsistency.LINEARIZABLE

    def persistence(self) -> Persistence:
        if isinstance(self.operation, Command):
            return self.operation.persistence()
        return Persistence.PERSISTENT


@serialize_with(31)
class InstanceQuery(InstanceOperation, Query):
    def consistency(self) -> QueryConsistency | None:
        if isinstance(self.operation, Query):
            return self.operation.consistency()
        return QueryConsistency.LINEARIZABLE


@serialize_with(32)
class InstanceEvent(Message):
    """Event payload envelope: (instance id, message) (``InstanceEvent.java``)."""

    _fields = ("resource", "message")

    def __init__(self, resource: int = 0, message: Any = None) -> None:
        self.resource = resource
        self.message = message
