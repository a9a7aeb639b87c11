"""User-facing consistency levels (reference ``Consistency.java:45-176``).

Each level maps to a (command consistency, query consistency) pair exactly as
the reference documents:

- NONE       -> (NONE, CAUSAL): fastest; events async, reads may be stale
- PROCESS    -> (SEQUENTIAL, CAUSAL): per-process sequential events
- SEQUENTIAL -> (SEQUENTIAL, SEQUENTIAL): global sequential order
- ATOMIC     -> (LINEARIZABLE, BOUNDED_LINEARIZABLE): linearizable writes with
  events delivered before the command response completes; leases bound reads
"""

from __future__ import annotations

import enum

from ..protocol.operations import CommandConsistency, QueryConsistency


class Consistency(enum.Enum):
    NONE = "none"
    PROCESS = "process"
    SEQUENTIAL = "sequential"
    ATOMIC = "atomic"

    def write_consistency(self) -> CommandConsistency:
        return _WRITE[self]

    def read_consistency(self) -> QueryConsistency:
        return _READ[self]


_WRITE = {
    Consistency.NONE: CommandConsistency.NONE,
    Consistency.PROCESS: CommandConsistency.SEQUENTIAL,
    Consistency.SEQUENTIAL: CommandConsistency.SEQUENTIAL,
    Consistency.ATOMIC: CommandConsistency.LINEARIZABLE,
}

_READ = {
    Consistency.NONE: QueryConsistency.CAUSAL,
    Consistency.PROCESS: QueryConsistency.CAUSAL,
    Consistency.SEQUENTIAL: QueryConsistency.SEQUENTIAL,
    Consistency.ATOMIC: QueryConsistency.BOUNDED_LINEARIZABLE,
}
