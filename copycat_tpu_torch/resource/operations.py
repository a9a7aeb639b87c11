"""Operation envelopes (reference ``ResourceCommand``/``ResourceQuery``/
``ResourceOperation``, serializer ids 28/29/33; ``DeleteCommand`` from
``ResourceStateMachine.java:53``).

The wrapper carries (inner operation, consistency).  The inner operation's own
consistency — when it declares one by overriding ``consistency()`` to a
non-None value — overrides the wrapper's (reference ``ResourceCommand.java:40``).
"""

from __future__ import annotations

from typing import Any

from ..io.serializer import serialize_with
from ..protocol.messages import Message
from ..protocol.operations import Command, CommandConsistency, Persistence, Query, QueryConsistency


class ResourceOperation(Message):
    """Mixin for envelope ops: (operation, consistency-value).

    Serialization is the generic field list (byte-identical to the
    former hand-written write/read) so the native codec walks the
    envelope in C instead of calling back into Python per wrapped op —
    the envelope wraps EVERY resource op, so this is the difference
    between the codec fast path covering ~all of a command batch or
    almost none of it."""

    _fields = ("operation", "_consistency")

    def __init__(self, operation: Any = None, consistency: str | None = None) -> None:
        self.operation = operation
        self._consistency = consistency


@serialize_with(28)
class ResourceCommand(ResourceOperation, Command):
    """Wraps a resource command with the resource's write consistency."""

    def consistency(self) -> CommandConsistency:
        # An inner op that OVERRIDES consistency() declares its own level
        # (the reference's "non-null overrides the wrapper" rule).
        if isinstance(self.operation, Command) \
                and type(self.operation).consistency is not Command.consistency:
            inner = self.operation.consistency()
            if inner is not None:
                return inner
        if self._consistency is not None:
            return CommandConsistency(self._consistency)
        return CommandConsistency.LINEARIZABLE

    def persistence(self) -> Persistence:
        if isinstance(self.operation, Command):
            return self.operation.persistence()
        return Persistence.PERSISTENT


@serialize_with(29)
class ResourceQuery(ResourceOperation, Query):
    """Wraps a resource query with the resource's read consistency."""

    def consistency(self) -> QueryConsistency:
        if isinstance(self.operation, Query) \
                and type(self.operation).consistency is not Query.consistency:
            inner = self.operation.consistency()
            if inner is not None:
                return inner
        if self._consistency is not None:
            return QueryConsistency(self._consistency)
        return QueryConsistency.LINEARIZABLE


@serialize_with(34)
class DeleteCommand(Message, Command):
    """Deletes the resource's replicated state (reference
    ``ResourceStateMachine.java:53``)."""

    _fields = ()
