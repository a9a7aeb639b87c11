"""Atomic value operation catalog (reference ``AtomicValueCommands.java``,
serializer ids 50-55).  ``ValueCommand.persistence()`` is PERSISTENT iff a TTL
is set, EPHEMERAL otherwise — TTL-less writes are droppable once superseded."""

from __future__ import annotations

from ..io.serializer import serialize_with
from ..protocol.messages import Message
from ..protocol.operations import Command, Persistence, Query


class ValueCommand(Message, Command):
    def persistence(self) -> Persistence:
        return Persistence.PERSISTENT if getattr(self, "ttl", None) else Persistence.EPHEMERAL


@serialize_with(50)
class Get(Message, Query):
    _fields = ()


@serialize_with(51)
class Set(ValueCommand):
    _fields = ("value", "ttl")


@serialize_with(52)
class CompareAndSet(ValueCommand):
    _fields = ("expect", "update", "ttl")


@serialize_with(53)
class GetAndSet(ValueCommand):
    _fields = ("value", "ttl")


@serialize_with(54)
class Listen(Message, Command):
    _fields = ()


@serialize_with(55)
class Unlisten(Message, Command):
    _fields = ()
