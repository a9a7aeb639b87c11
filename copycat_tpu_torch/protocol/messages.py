"""Wire protocol: client<->server session messages + server<->server Raft RPCs.

Reconstructed from the API the reference consumes from the external Copycat jar
(SURVEY.md §2.3 "Client runtime" / "Session protocol" / "Raft server core").
Serialization ids 200-229 (the reference's op catalogs use 28-127; protocol
messages lived in the external jar, so this block is new).

Every response carries ``error`` (string) — ``NOT_LEADER`` additionally carries
a ``leader`` hint so clients re-route; this is the uniform alternative to
exception marshalling across transports.
"""

from __future__ import annotations

from typing import Any, ClassVar

from ..io.buffer import BufferInput, BufferOutput
from ..io.serializer import Serializer, serialize_with
from ..utils.fields import compile_field_init

# Error codes carried in response.error
NOT_LEADER = "NOT_LEADER"
NO_LEADER = "NO_LEADER"
UNKNOWN_SESSION = "UNKNOWN_SESSION"
INTERNAL = "INTERNAL"
APPLICATION = "APPLICATION"  # state-machine raised; message in error_detail


class ProtocolError(Exception):
    def __init__(self, code: str, detail: str = "", leader: Any = None):
        super().__init__(f"{code}: {detail}" if detail else code)
        self.code = code
        self.detail = detail
        self.leader = leader


class Message:
    """Field-list serialization base: subclasses declare ``_fields``.

    Subclasses that declare ``_fields`` without their own ``__init__``
    get one COMPILED for them (NamedTuple-style): direct attribute
    assignments instead of a per-field ``kwargs.get`` + ``setattr``
    loop. Messages are constructed per op on the session hot path, so
    the generic loop was a measured share of the SPI plane's per-op
    cost (PERF.md round 6).

    ``_optional`` marks that many TRAILING fields as wire-optional: a
    trailing run of ``None`` values is omitted from the encoding, and a
    reader that runs out of buffer fills the rest with ``None``. That
    makes a new trailing field (the tracing plane's ``trace``) free on
    the wire when unused — frames stay byte-identical to the
    pre-tracing schema (the golden differential in
    tests/test_trace_plane.py). The omission is only decodable when the
    message ends its buffer, so optional fields are restricted to
    TOP-LEVEL RPC messages (one frame = one message); never mark a
    message that nests inside another object graph."""

    _fields: ClassVar[tuple[str, ...]] = ()
    _optional: ClassVar[int] = 0

    def __init__(self, **kwargs: Any) -> None:
        for name in self._fields:
            setattr(self, name, kwargs.get(name))

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        fields = cls.__dict__.get("_fields")
        if fields is None or "__init__" in cls.__dict__:
            return
        compile_field_init(cls, fields)

    def write_object(self, buf: BufferOutput, serializer: Serializer) -> None:
        fields = self._fields
        n = len(fields)
        opt = self._optional
        while opt and getattr(self, fields[n - 1]) is None:
            n -= 1
            opt -= 1
        for name in fields[:n]:
            serializer.write_object(getattr(self, name), buf)

    def read_object(self, buf: BufferInput, serializer: Serializer) -> None:
        fields = self._fields
        required = len(fields) - self._optional
        for i, name in enumerate(fields):
            if i >= required and buf.remaining == 0:
                setattr(self, name, None)
            else:
                setattr(self, name, serializer.read_object(buf))

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._fields)
        return f"{type(self).__name__}({inner})"


# Marker read by serialize_with: classes inheriting these exact function
# objects serialize as a plain field list, which the native codec
# (io/codec.py) can walk entirely in C.
Message.write_object._generic_fields = True
Message.read_object._generic_fields = True


class Response(Message):
    """Base response: ``error`` is an error code, ``leader`` a routing hint."""

    @property
    def ok(self) -> bool:
        return not getattr(self, "error", None)

    def raise_if_error(self) -> "Response":
        error = getattr(self, "error", None)
        if error:
            raise ProtocolError(error, getattr(self, "error_detail", "") or "",
                                getattr(self, "leader", None))
        return self


# ---------------------------------------------------------------------------
# Client <-> server session protocol
# ---------------------------------------------------------------------------


@serialize_with(200)
class RegisterRequest(Message):
    _fields = ("client_id", "timeout")


@serialize_with(201)
class RegisterResponse(Response):
    # session_id doubles as the registering entry's log index (stamped
    # with the group count on a multi-group server — docs/SHARDING.md).
    # groups: the server's Raft group count; >1 switches the client into
    # multi-group mode (per-group read indices + event channels).
    _fields = ("error", "error_detail", "leader", "session_id", "timeout",
               "members", "groups")


@serialize_with(202)
class KeepAliveRequest(Message):
    # command_seq: highest command sequence the client has a response for.
    # event_index: highest event index the client has processed.
    # unsubscribe (optional trailing, omitted when None): instance ids
    # whose edge subscriptions (docs/EDGE_READS.md) the client dropped
    # (LRU eviction) — the serving member retires them from its
    # subscriber registry. Member-local, never replicated.
    _fields = ("session_id", "command_seq", "event_index", "unsubscribe")
    _optional = 1


@serialize_with(203)
class KeepAliveResponse(Response):
    _fields = ("error", "error_detail", "leader", "members")


@serialize_with(204)
class UnregisterRequest(Message):
    _fields = ("session_id",)


@serialize_with(205)
class UnregisterResponse(Response):
    _fields = ("error", "error_detail", "leader")


@serialize_with(206)
class CommandRequest(Message):
    # seq: client-assigned sequence for exactly-once application.
    # trace: per-request trace id (utils/tracing.py) — None when tracing
    # is disabled; a non-None id asks the server to record spans for it.
    _fields = ("session_id", "seq", "operation", "trace")


@serialize_with(207)
class CommandResponse(Response):
    # index: log index at which the command applied (the linearization point).
    # event_index: highest event index published to this session at the time.
    _fields = ("error", "error_detail", "leader", "index", "event_index", "result")


@serialize_with(208)
class QueryRequest(Message):
    # index: client's high-water commit index for SEQUENTIAL/CAUSAL reads.
    # subscribe (optional trailing, omitted when None): truthy asks the
    # serving member to register this session as an edge-delta
    # subscriber for the resources the read touches and seed the reply's
    # ``edge`` field (docs/EDGE_READS.md); unsubscribed planes stay
    # byte-identical.
    _fields = ("session_id", "index", "operation", "consistency",
               "subscribe")
    _optional = 1


@serialize_with(209)
class QueryResponse(Response):
    # edge (optional trailing, omitted when None): edge replica seeds
    # ``[(instance_id, version, state), ...]`` answering a subscribing
    # read (docs/EDGE_READS.md).
    _fields = ("error", "error_detail", "leader", "index", "result",
               "edge")
    _optional = 1


@serialize_with(224)
class CommandBatchRequest(Message):
    """Micro-batched commands: one transport message carrying many
    sequenced commands from one session (the client's same-turn submits
    coalesce; the reference's per-command RPC framing pays per-message
    overhead the batch amortizes). ``entries`` = [(seq, operation), ...]
    in seq order. ``trace`` as on CommandRequest (one id per batch)."""

    _fields = ("session_id", "entries", "trace")


@serialize_with(225)
class CommandBatchResponse(Response):
    """Per-command outcomes: ``entries`` = [(seq, index, result,
    error_code, error_detail), ...]; ``event_index`` as CommandResponse."""

    _fields = ("error", "error_detail", "leader", "event_index", "entries")


@serialize_with(226)
class QueryBatchRequest(Message):
    """Micro-batched reads of ONE consistency level: the server performs
    the consistency gate (leadership confirmation / applied-index wait)
    once for the whole batch — for LINEARIZABLE reads that amortizes a
    quorum round over N queries. ``operations`` positional.
    ``subscribe`` as on QueryRequest (optional trailing)."""

    _fields = ("session_id", "index", "consistency", "operations",
               "subscribe")
    _optional = 1


@serialize_with(227)
class QueryBatchResponse(Response):
    """``entries`` positional with the request: [(result, error_code,
    error_detail), ...]. ``edge`` as on QueryResponse (optional
    trailing)."""

    _fields = ("error", "error_detail", "leader", "index", "entries",
               "edge")
    _optional = 1


@serialize_with(210)
class PublishRequest(Message):
    """Server -> client event push (session event channel).

    ``events`` is a list of (event_name, payload) applied at ``index``;
    ``prev_event_index`` lets the client detect gaps and request a replay via
    keep-alive acks.

    ``group`` scopes the event channel on a multi-group server: each
    group's replica of a session numbers its own event stream, and the
    client tracks ``event_index`` per group (None = single-group, the
    legacy scalar channel).

    ``trace`` (optional trailing, omitted when None): the trace id of
    the applied command whose events this push delivers, so the client
    records a ``client.event`` span on the same causal timeline.

    ``deltas`` (optional trailing, omitted when None): edge state
    deltas ``[(instance_id, version, state), ...]`` for resources this
    session subscribed to (docs/EDGE_READS.md). Deltas are join-
    semilattice merges client-side (max version wins), so they need no
    position in the event channel's gap/replay machinery: a delta-only
    push carries ``event_index=None`` and the client acks its current
    position untouched. ``state=None`` retires the replica entry (the
    resource was deleted or stopped being edge-servable).
    """

    _fields = ("session_id", "event_index", "prev_event_index", "events",
               "group", "trace", "deltas")
    _optional = 2


@serialize_with(211)
class PublishResponse(Response):
    _fields = ("error", "error_detail", "event_index")


# ---------------------------------------------------------------------------
# Server <-> server Raft RPCs
# ---------------------------------------------------------------------------


@serialize_with(216)
class VoteRequest(Message):
    # group: the Raft group this RPC belongs to on a multi-group server
    # (docs/SHARDING.md); None = the single-group plane, byte-identical
    # to the pre-sharding wire shape. Same field on Append/Install.
    _fields = ("term", "candidate", "last_log_index", "last_log_term",
               "group")


@serialize_with(217)
class VoteResponse(Response):
    _fields = ("error", "error_detail", "term", "voted")


@serialize_with(218)
class AppendRequest(Message):
    # global_index: minimum replicated index across all members — followers may
    # compact cleaned entries up to it (SURVEY.md §5.4 compaction contract).
    # fill_to: end of the index window this append covers; entries omitted from
    # the window were cleaned+compacted (effects superseded) — the follower
    # gap-fills those slots and never applies them, mirroring the reference's
    # replay-after-compaction semantics.
    # trace: optional trailing (omitted when None — the untraced wire is
    # byte-identical to the pre-tracing schema): ``(trace id, entry
    # index)`` when this window carries a traced entry to quorum, so the
    # follower records its ingest+fsync span under the same causal
    # timeline and marks the entry for event-push attribution
    # (docs/OBSERVABILITY.md "Cluster-wide causal tracing").
    _fields = ("term", "leader", "prev_index", "prev_term", "entries", "commit_index",
               "global_index", "fill_to", "group", "trace")
    _optional = 1


@serialize_with(219)
class AppendResponse(Response):
    # last_index: follower's last log index after the append (for next_index
    # fast rewind on failure).
    _fields = ("error", "error_detail", "term", "success", "last_index")


@serialize_with(212)
class InstallRequest(Message):
    """Leader -> follower snapshot-install stream (docs/DURABILITY.md).

    Sent when a follower's ``next_index`` has fallen behind the leader's
    prefix-truncated log: the newest snapshot's payload is chunked and
    streamed over the peer connection's correlated multiplexing (up to
    the replication pipeline's depth of chunks in flight).  ``index`` is
    the snapshot's applied index, ``snap_term`` the term of the entry at
    that index (the follower's log restarts just past it), ``total`` the
    full payload length in bytes, ``offset`` this chunk's byte position,
    ``data`` the chunk, and ``done`` marks the final (empty) frame that
    asks the follower to assemble + restore.
    """

    _fields = ("term", "leader", "index", "snap_term", "total", "offset",
               "data", "done", "group")


@serialize_with(213)
class InstallResponse(Response):
    # offset: chunk acks echo the chunk's offset; a failed final assembly
    # reports the first missing byte offset as a diagnostic. The leader's
    # retry contract is WHOLE-RETRY (the follower clears its assembly
    # buffer on failure) — offset is informational, not a resume cursor.
    # last_index: the follower's log tail after a completed install.
    _fields = ("error", "error_detail", "term", "success", "offset",
               "last_index")


@serialize_with(228)
class ProxyRequest(Message):
    """Server -> server ingress forwarding on a multi-group server
    (docs/SHARDING.md): the member holding a client's connection routes
    each staged sub-request to the owning group's leader. ``kind`` names
    the staging entry point (``register`` / ``keepalive`` /
    ``unregister`` / ``commands`` / ``query``); ``payload`` is the
    kind-specific tuple. Responses travel as :class:`ProxyResponse` with
    the kind-specific ``result`` payload, plus the uniform
    error/leader-hint fields so the ingress can retry toward the
    group's current leader.

    ``trace`` (optional trailing on both directions, omitted when
    None): the originating trace id — the owning group's leader records
    its append/quorum/apply spans under it, and the response echoes it
    so the hop stays correlated even when responses are inspected off
    the connection's multiplexing.
    """

    _fields = ("group", "kind", "payload", "trace")
    _optional = 1


@serialize_with(229)
class ProxyResponse(Response):
    _fields = ("error", "error_detail", "leader", "result", "trace")
    _optional = 1


@serialize_with(220)
class JoinRequest(Message):
    _fields = ("member",)


@serialize_with(221)
class JoinResponse(Response):
    _fields = ("error", "error_detail", "leader", "members")


@serialize_with(222)
class LeaveRequest(Message):
    _fields = ("member",)


@serialize_with(223)
class LeaveResponse(Response):
    _fields = ("error", "error_detail", "leader", "members")
