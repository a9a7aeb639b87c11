"""The Copycat-equivalent operation model and wire protocol.

``operations`` defines ``Command``/``Query`` with the exact consistency and
persistence levels the reference consumes (SURVEY.md §2.3: Command consistency
NONE/SEQUENTIAL/LINEARIZABLE, Query consistency CAUSAL/SEQUENTIAL/
BOUNDED_LINEARIZABLE/LINEARIZABLE, persistence PERSISTENT/EPHEMERAL).

``messages`` defines the client<->server session protocol and the
server<->server Raft RPCs.
"""

from .operations import (
    Command,
    CommandConsistency,
    Operation,
    Persistence,
    Query,
    QueryConsistency,
)
from .messages import (
    AppendRequest,
    AppendResponse,
    CommandRequest,
    CommandResponse,
    JoinRequest,
    JoinResponse,
    KeepAliveRequest,
    KeepAliveResponse,
    LeaveRequest,
    LeaveResponse,
    ProtocolError,
    PublishRequest,
    PublishResponse,
    QueryRequest,
    QueryResponse,
    RegisterRequest,
    RegisterResponse,
    UnregisterRequest,
    UnregisterResponse,
    VoteRequest,
    VoteResponse,
)

__all__ = [
    "Operation",
    "Command",
    "Query",
    "CommandConsistency",
    "QueryConsistency",
    "Persistence",
    "RegisterRequest",
    "RegisterResponse",
    "KeepAliveRequest",
    "KeepAliveResponse",
    "UnregisterRequest",
    "UnregisterResponse",
    "CommandRequest",
    "CommandResponse",
    "QueryRequest",
    "QueryResponse",
    "PublishRequest",
    "PublishResponse",
    "VoteRequest",
    "VoteResponse",
    "AppendRequest",
    "AppendResponse",
    "JoinRequest",
    "JoinResponse",
    "LeaveRequest",
    "LeaveResponse",
    "ProtocolError",
]
