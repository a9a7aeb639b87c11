"""Collection operation catalogs.

Serializer id blocks follow the reference exactly (SURVEY.md §2.1):
map 60-72 (``MapCommands.java``), multimap 75-84 (``MultiMapCommands.java``),
queue 90-99 (``QueueCommands.java``), set 100-105 (``SetCommands.java``).

``TtlCommand.persistence()`` is PERSISTENT iff ttl>0; removals and clears are
always PERSISTENT (they are tombstones until compaction).
"""

from __future__ import annotations

from ..io.serializer import serialize_with
from ..protocol.messages import Message
from ..protocol.operations import Command, Persistence, Query


class TtlCommand(Message, Command):
    def persistence(self) -> Persistence:
        return Persistence.PERSISTENT if getattr(self, "ttl", None) else Persistence.EPHEMERAL


class Tombstone(Message, Command):
    def persistence(self) -> Persistence:
        return Persistence.PERSISTENT


# ---------------------------------------------------------------------------
# map (60-72)
# ---------------------------------------------------------------------------


@serialize_with(60)
class MapContainsKey(Message, Query):
    _fields = ("key",)


@serialize_with(61)
class MapContainsValue(Message, Query):
    _fields = ("value",)


@serialize_with(62)
class MapPut(TtlCommand):
    _fields = ("key", "value", "ttl")


@serialize_with(63)
class MapPutIfAbsent(TtlCommand):
    _fields = ("key", "value", "ttl")


@serialize_with(64)
class MapGet(Message, Query):
    _fields = ("key",)


@serialize_with(65)
class MapGetOrDefault(Message, Query):
    _fields = ("key", "default")


@serialize_with(66)
class MapRemove(Tombstone):
    _fields = ("key",)


@serialize_with(67)
class MapRemoveIfPresent(Tombstone):
    _fields = ("key", "value")


@serialize_with(68)
class MapReplace(TtlCommand):
    _fields = ("key", "value", "ttl")


@serialize_with(69)
class MapReplaceIfPresent(TtlCommand):
    _fields = ("key", "expect", "value", "ttl")


@serialize_with(70)
class MapIsEmpty(Message, Query):
    _fields = ()


@serialize_with(71)
class MapSize(Message, Query):
    _fields = ()


@serialize_with(72)
class MapClear(Tombstone):
    _fields = ()


# ---------------------------------------------------------------------------
# multimap (75-84)
# ---------------------------------------------------------------------------


@serialize_with(75)
class MultiMapContainsKey(Message, Query):
    _fields = ("key",)


@serialize_with(76)
class MultiMapContainsEntry(Message, Query):
    _fields = ("key", "value")


@serialize_with(77)
class MultiMapContainsValue(Message, Query):
    _fields = ("value",)


@serialize_with(78)
class MultiMapPut(TtlCommand):
    _fields = ("key", "value", "ttl")


@serialize_with(79)
class MultiMapGet(Message, Query):
    _fields = ("key",)


@serialize_with(80)
class MultiMapRemove(Tombstone):
    _fields = ("key",)


@serialize_with(81)
class MultiMapRemoveEntry(Tombstone):
    _fields = ("key", "value")


@serialize_with(82)
class MultiMapIsEmpty(Message, Query):
    _fields = ()


@serialize_with(83)
class MultiMapSize(Message, Query):
    _fields = ("key",)  # None = global size (MultiMapState.java:169-185)


@serialize_with(84)
class MultiMapClear(Tombstone):
    _fields = ()


# ---------------------------------------------------------------------------
# queue (90-99)
# ---------------------------------------------------------------------------


@serialize_with(90)
class QueueAdd(Message, Command):
    _fields = ("value",)


@serialize_with(91)
class QueueOffer(Message, Command):
    _fields = ("value",)


@serialize_with(92)
class QueuePeek(Message, Query):
    _fields = ()


@serialize_with(93)
class QueuePoll(Tombstone):
    # Mutates (dequeues + cleans) - a Command despite being a "read"
    # (reference QueueCommands: Peek is a Query but Poll/Element are Commands).
    _fields = ()


@serialize_with(94)
class QueueElement(Tombstone):
    _fields = ()


@serialize_with(95)
class QueueRemove(Tombstone):
    _fields = ("value",)  # value None = remove head


@serialize_with(96)
class QueueContains(Message, Query):
    _fields = ("value",)


@serialize_with(97)
class QueueIsEmpty(Message, Query):
    _fields = ()


@serialize_with(98)
class QueueSize(Message, Query):
    _fields = ()


@serialize_with(99)
class QueueClear(Tombstone):
    _fields = ()


# ---------------------------------------------------------------------------
# set (100-105)
# ---------------------------------------------------------------------------


@serialize_with(100)
class SetAdd(TtlCommand):
    _fields = ("value", "ttl")


@serialize_with(101)
class SetRemove(Tombstone):
    _fields = ("value",)


@serialize_with(102)
class SetContains(Message, Query):
    _fields = ("value",)


@serialize_with(103)
class SetIsEmpty(Message, Query):
    _fields = ()


@serialize_with(104)
class SetSize(Message, Query):
    _fields = ()


@serialize_with(105)
class SetClear(Tombstone):
    _fields = ()
