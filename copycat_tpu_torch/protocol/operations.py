"""Operation model (Copycat ``Operation``/``Command``/``Query`` equivalent).

Levels mirror the reference exactly (consumed at ``Consistency.java:60-176``):

- Command consistency: ``NONE`` (complete on commit, events async),
  ``SEQUENTIAL`` (events sequentially consistent), ``LINEARIZABLE`` (events
  reach subscribers before the command response completes).
- Query consistency: ``CAUSAL``, ``SEQUENTIAL``, ``BOUNDED_LINEARIZABLE``
  (leader lease), ``LINEARIZABLE`` (leader confirms with a quorum round).
- Persistence: ``PERSISTENT`` (tombstone — must survive until explicitly
  cleaned) vs ``EPHEMERAL`` (droppable once superseded), the log-compaction
  contract every reference state machine is written against (SURVEY.md §5.4).
"""

from __future__ import annotations

import enum


class CommandConsistency(enum.Enum):
    NONE = "none"
    SEQUENTIAL = "sequential"
    LINEARIZABLE = "linearizable"


class QueryConsistency(enum.Enum):
    CAUSAL = "causal"
    SEQUENTIAL = "sequential"
    BOUNDED_LINEARIZABLE = "bounded_linearizable"
    LINEARIZABLE = "linearizable"


class Persistence(enum.Enum):
    # PERSISTENT entries are tombstones: compaction must retain them until the
    # state machine cleans them. EPHEMERAL entries may be dropped as soon as
    # they are applied on all servers and superseded.
    PERSISTENT = "persistent"
    EPHEMERAL = "ephemeral"


class Operation:
    """Base class for all replicated operations (serializable)."""

    __slots__ = ()


class Command(Operation):
    """A state-mutating operation, replicated through the log."""

    __slots__ = ()

    def consistency(self) -> CommandConsistency:
        return CommandConsistency.LINEARIZABLE

    def persistence(self) -> Persistence:
        return Persistence.PERSISTENT


class Query(Operation):
    """A read-only operation, served outside the log per its consistency."""

    __slots__ = ()

    def consistency(self) -> QueryConsistency:
        return QueryConsistency.LINEARIZABLE
