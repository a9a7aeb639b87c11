"""Server-side sessions: exactly-once command application + event push queues.

The replicated part of a session (id, applied sequences, response cache, event
queue) is computed identically on every server during apply, so a new leader
can resume event delivery after failover.  Only the leader actually *sends*
events (the connection is leader-local, non-replicated state).

Reference behaviors mirrored (SURVEY.md §2.3 "Session protocol"): session id =
registering entry's log index; exactly-once via (session, seq) response
caching; ordered event channel with acks; OPEN/EXPIRED/CLOSED lifecycle that
fans out to state machines (``ResourceManager.java:238-266``).
"""

from __future__ import annotations

import enum
from typing import Any, Callable


class SessionState(enum.Enum):
    OPEN = "open"
    EXPIRED = "expired"
    CLOSED = "closed"


class EventBatch:
    """Events published while applying one entry; one push unit."""

    __slots__ = ("event_index", "prev_event_index", "events")

    def __init__(self, event_index: int, prev_event_index: int, events: list[tuple[str, Any]]):
        self.event_index = event_index
        self.prev_event_index = prev_event_index
        self.events = events


class ServerSession:
    """One client session as seen by a server."""

    def __init__(self, session_id: int, client_id: str, timeout: float) -> None:
        self.id = session_id
        self.client_id = client_id
        self.timeout = timeout
        self.state = SessionState.OPEN

        # --- replicated state (deterministic across servers) ---
        self.command_high = 0  # highest command seq applied
        self.responses: dict[int, tuple[int, Any, str | None]] = {}  # seq -> (index, result, error)
        self.event_index = 0  # last event index assigned
        self.event_ack_index = 0  # highest event index acked by the client
        self.event_queue: list[EventBatch] = []  # unacked batches, ordered
        self.last_keepalive_time = 0.0  # logical clock of last keep-alive entry

        # --- leader-local state (not replicated) ---
        self.connection: Any = None  # client's connection for event push
        self.last_contact = 0.0  # leader wall clock of last request
        self.command_futures: dict[int, Any] = {}  # seq -> future (leader only)
        # Leader-side command sequencing: commands are appended to the log in
        # client seq order; out-of-order arrivals (concurrent submits racing
        # over reconnects) park in pending_ops until the gap fills.
        self.next_append_seq = 0  # 0 = uninitialized on this leader
        self.pending_ops: dict[int, Any] = {}  # seq -> operation awaiting append
        # Multi-group block staging (RaftGroup.command_block): the commit
        # future of the newest append block for this session in this
        # group, so a resent sub-block racing its first attempt can ride
        # the pending commit instead of mis-reading "pruned".
        self.last_block_future: Any = None

        # --- apply-time scratch ---
        self._current_events: list[tuple[str, Any]] = []
        self._event_listener: Callable[[ServerSession], None] | None = None

    # -- event publication (called by state machines during apply) ---------

    def publish(self, event: str, message: Any = None) -> None:
        if self.state is not SessionState.OPEN:
            return
        self._current_events.append((event, message))

    def commit_events(self) -> EventBatch | None:
        """Seal events published during the current apply into a batch."""
        if not self._current_events:
            return None
        prev = self.event_index
        self.event_index = prev + 1
        batch = EventBatch(self.event_index, prev, self._current_events)
        self._current_events = []
        self.event_queue.append(batch)
        return batch

    def ack_events(self, event_index: int) -> None:
        if event_index > self.event_ack_index:
            self.event_ack_index = event_index
            self.event_queue = [b for b in self.event_queue if b.event_index > event_index]

    # -- exactly-once bookkeeping -----------------------------------------

    def cache_response(self, seq: int, index: int, result: Any, error: str | None) -> None:
        self.command_high = max(self.command_high, seq)
        self.responses[seq] = (index, result, error)

    def cached_response(self, seq: int) -> tuple[int, Any, str | None] | None:
        return self.responses.get(seq)

    def ack_commands(self, command_seq: int) -> None:
        """Client confirmed receipt of responses up to command_seq; prune."""
        for seq in [s for s in self.responses if s <= command_seq]:
            del self.responses[seq]

    # -- snapshot round-trip (crash-recovery plane) ------------------------

    def snapshot_dict(self) -> dict:
        """The REPLICATED half of this session as a serializer-writable
        dict (leader-local state — connection, futures, pending ops — is
        deliberately absent: it is rebuilt by live traffic, the same
        contract as leader failover)."""
        return {
            "id": self.id,
            "client_id": self.client_id,
            "timeout": self.timeout,
            "state": self.state.value,
            "command_high": self.command_high,
            "responses": {seq: list(r) for seq, r in self.responses.items()},
            "event_index": self.event_index,
            "event_ack_index": self.event_ack_index,
            "event_queue": [
                (b.event_index, b.prev_event_index, list(b.events))
                for b in self.event_queue],
            "last_keepalive_time": self.last_keepalive_time,
        }

    @classmethod
    def from_snapshot(cls, data: dict) -> "ServerSession":
        session = cls(data["id"], data["client_id"], data["timeout"])
        session.state = SessionState(data["state"])
        session.command_high = data["command_high"]
        session.responses = {seq: tuple(r)
                             for seq, r in data["responses"].items()}
        session.event_index = data["event_index"]
        session.event_ack_index = data["event_ack_index"]
        session.event_queue = [
            EventBatch(ei, prev, [tuple(e) for e in events])
            for ei, prev, events in data["event_queue"]]
        session.last_keepalive_time = data["last_keepalive_time"]
        return session

    # -- lifecycle ---------------------------------------------------------

    @property
    def is_open(self) -> bool:
        return self.state is SessionState.OPEN

    def expire(self) -> None:
        self.state = SessionState.EXPIRED

    def close(self) -> None:
        if self.state is SessionState.OPEN:
            self.state = SessionState.CLOSED

    def __repr__(self) -> str:
        return f"ServerSession(id={self.id}, state={self.state.value})"
