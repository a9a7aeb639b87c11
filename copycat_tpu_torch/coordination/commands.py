"""Coordination operation catalogs.

Serializer id blocks per the reference (SURVEY.md §2.1): message bus 85-89
(``MessageBusCommands.java``), leader election 110-112
(``LeaderElectionCommands``), lock 115-116 (``LockCommands.java``), membership
group 120-123 (``MembershipGroupCommands.java``), topic 125-127
(``TopicCommands.java``).

Deliberate change from the reference: group remote execution ships a
REGISTERED CALLBACK NAME + args instead of a serialized closure
(``MembershipGroupCommands.java:85`` logs ``Runnable`` objects — a misfeature;
see SURVEY.md §7.2 step 6).
"""

from __future__ import annotations

from ..io.serializer import serialize_with
from ..protocol.messages import Message as _M
from ..protocol.operations import Command, CommandConsistency, Persistence, Query


class Tombstone(_M, Command):
    def persistence(self) -> Persistence:
        return Persistence.PERSISTENT


# -- message bus (85-89) ----------------------------------------------------


@serialize_with(85)
class BusJoin(_M, Command):
    _fields = ("address",)


@serialize_with(86)
class BusLeave(Tombstone):
    _fields = ()


@serialize_with(87)
class BusRegister(_M, Command):
    _fields = ("topic",)


@serialize_with(88)
class BusUnregister(Tombstone):
    _fields = ("topic",)


@serialize_with(89)
class ConsumerInfo(_M):
    """Event payload: a consumer's (topic, address) (``MessageBusCommands``)."""

    _fields = ("topic", "address")


# -- leader election (110-112) ----------------------------------------------


@serialize_with(110)
class ElectionListen(_M, Command):
    def consistency(self) -> CommandConsistency:
        return CommandConsistency.LINEARIZABLE

    _fields = ()


@serialize_with(111)
class ElectionUnlisten(Tombstone):
    def consistency(self) -> CommandConsistency:
        return CommandConsistency.LINEARIZABLE

    _fields = ()


@serialize_with(112)
class ElectionIsLeader(_M, Query):
    """Fencing-token validation: is `epoch` still the current leadership?"""

    _fields = ("epoch",)


# -- lock (115-116) ----------------------------------------------------------


@serialize_with(115)
class Lock(_M, Command):
    # timeout: <0 wait forever, 0 immediate try, >0 queued with deadline.
    _fields = ("timeout",)

    def consistency(self) -> CommandConsistency:
        return CommandConsistency.LINEARIZABLE


@serialize_with(116)
class Unlock(Tombstone):
    _fields = ()

    def consistency(self) -> CommandConsistency:
        return CommandConsistency.LINEARIZABLE


# -- membership group (120-123) ---------------------------------------------


@serialize_with(120)
class GroupJoin(_M, Command):
    _fields = ()


@serialize_with(121)
class GroupLeave(Tombstone):
    _fields = ()


@serialize_with(122)
class GroupListen(_M, Command):
    _fields = ()


@serialize_with(123)
class GroupSchedule(_M, Command):
    """Remote execution on a member: (member id, delay, callback name, args)."""

    _fields = ("member", "delay", "callback", "args")


@serialize_with(119)
class GroupExecute(_M, Command):
    _fields = ("member", "callback", "args")


# -- topic (125-127) ---------------------------------------------------------


@serialize_with(125)
class TopicListen(_M, Command):
    _fields = ()


@serialize_with(126)
class TopicUnlisten(Tombstone):
    _fields = ()


@serialize_with(127)
class TopicPublish(_M, Command):
    _fields = ("message",)
