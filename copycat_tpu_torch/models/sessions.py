"""Sessions for the direct device path (torch).

Counterpart of ``copycat_tpu/models/sessions.py``. A crashed client must
not wedge a lock or a leadership slot: session death is a deterministic,
replicated event applied through the log. The host driving the batch is
the session authority. A :class:`DeviceSessionRegistry` hangs off
``RaftGroups``; clients open :class:`DeviceSession`\\ s whose ids double as
the lock-holder and election-candidate ids. Liveness is keep-alives
measured in engine rounds (the logical clock, never wall time). On expiry
(or graceful close) the registry submits cleanup ops THROUGH THE LOG —
``OP_LOCK_CANCEL`` + ``OP_LOCK_RELEASE`` for every lock interest,
``OP_ELECT_RESIGN`` for every election interest — so recovery is totally
ordered with every concurrent grant or acquire. Cleanup ops are no-ops
when the session turned out not to hold or queue anything.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .raft_groups import RaftGroups


class SessionExpiredError(RuntimeError):
    """The session missed its keep-alives; its locks/leaderships have been
    (or are being) released through the log. Open a new session."""


class DeviceSession:
    """One device-path client identity.

    ``session.id`` is the int the facades use as lock-holder id and
    election-candidate id, so every replicated interest of this client is
    keyed by it: replicated state is keyed by sessions.
    """

    def __init__(self, registry: "DeviceSessionRegistry", sid: int) -> None:
        self.id = sid
        self._registry = registry
        self.expired = False
        self.closed = False

    def keep_alive(self) -> None:
        if self.expired or self.closed:
            raise SessionExpiredError(f"session {self.id} is dead")
        self._registry.keep_alive(self.id)

    def close(self) -> None:
        """Graceful close: same deterministic fan-out as expiry, now."""
        if not (self.expired or self.closed):
            self._registry._terminate(self.id, graceful=True)

    def bind(self, group: int, kind: str) -> None:
        """Declare a lock/election interest in ``group`` (facades call this
        so death cleanup knows where to fan out)."""
        self._registry.bind(self.id, group, kind)


class DeviceSessionRegistry:
    """Host-side session table + expiry fan-out for one RaftGroups batch."""

    #: Session ids start here so they can NEVER collide with manually
    #: chosen holder/candidate ids of session-less facades — a collision
    #: would let one session's expiry release a lock a different, live
    #: client holds under the same int. Manual ids must stay below this.
    SESSION_ID_BASE = 1 << 30

    def __init__(self, groups: "RaftGroups",
                 timeout_rounds: int = 100) -> None:
        self._groups = groups
        self.timeout_rounds = timeout_rounds
        self._next_id = self.SESSION_ID_BASE
        self._sessions: dict[int, DeviceSession] = {}
        self._last_seen: dict[int, int] = {}        # sid -> round
        # sid -> set of (group, kind) with kind in {"lock", "election"}
        self._interests: dict[int, set[tuple[int, str]]] = {}
        self._pinned: dict[int, int] = {}           # sid -> in-flight calls
        self._cleanup_tags: set[int] = set()        # fan-out op tags to reap
        #: (group, opcode, sid) cleanup ops awaiting a bulk drive: monotone
        #: engines refuse queue-managed submits, so their expiry fan-out is
        #: staged here and committed by the sessioned bulk client's next
        #: flush (``models/session_client.py``), log-ordered there like any
        #: other op
        self.pending_cleanup: list[tuple[int, int, int]] = []

    # -- lifecycle ---------------------------------------------------------

    def open_session(self) -> DeviceSession:
        sid = self._next_id
        self._next_id += 1
        session = DeviceSession(self, sid)
        self._sessions[sid] = session
        self._last_seen[sid] = self._groups.rounds
        self._interests[sid] = set()
        return session

    def keep_alive(self, sid: int) -> None:
        if sid in self._sessions:
            self._last_seen[sid] = self._groups.rounds

    def bind(self, sid: int, group: int, kind: str) -> None:
        """Record that ``sid`` may hold/queue state of ``kind`` in
        ``group``; cleanup on death covers every bound interest (cleanup
        ops are no-ops for interests that turned out inactive)."""
        interests = self._interests.get(sid)
        if interests is not None:
            interests.add((group, kind))

    def pin(self, sid: int) -> None:
        """Exempt ``sid`` from expiry while one of its own calls is in
        flight: a client blocked inside run_until IS alive (driving the
        very rounds that would otherwise expire it), and expiring it
        mid-call would release its lock while reporting the call a
        success."""
        self._pinned[sid] = self._pinned.get(sid, 0) + 1

    def unpin(self, sid: int) -> None:
        n = self._pinned.get(sid, 0) - 1
        if n <= 0:
            self._pinned.pop(sid, None)
            self.keep_alive(sid)  # the call just finished: it was alive
        else:
            self._pinned[sid] = n

    # -- expiry ------------------------------------------------------------

    def tick(self) -> None:
        """Called once per engine round (from ``RaftGroups.step_round``):
        expire sessions whose last keep-alive is older than the timeout."""
        now = self._groups.rounds
        for sid, seen in list(self._last_seen.items()):
            if now - seen > self.timeout_rounds and sid not in self._pinned:
                self._terminate(sid, graceful=False)
        # Reap resolved cleanup-op results: nothing else pops these tags,
        # and a long-lived batch with session churn must stay bounded.
        if self._cleanup_tags:
            results = self._groups.results
            self._cleanup_tags = {
                t for t in self._cleanup_tags
                if results.pop(t, None) is None}

    def _terminate(self, sid: int, graceful: bool) -> None:
        session = self._sessions.pop(sid, None)
        self._last_seen.pop(sid, None)
        interests = self._interests.pop(sid, set())
        if session is None:
            return
        if graceful:
            session.closed = True
        else:
            session.expired = True
        from ..ops import apply as ops
        for group, kind in sorted(interests):
            if kind == "lock":
                # CANCEL dequeues a waiting interest; RELEASE frees a held
                # one (granting the next waiter). Both are log-ordered
                # with every concurrent grant, so there is no window in
                # which a racing grant can leak to the dead session: if
                # the grant commits first, the RELEASE behind it frees it.
                self._submit_cleanup(group, ops.OP_LOCK_CANCEL, sid)
                self._submit_cleanup(group, ops.OP_LOCK_RELEASE, sid)
            elif kind == "election":
                self._submit_cleanup(group, ops.OP_ELECT_RESIGN, sid)

    def _submit_cleanup(self, group: int, opcode: int, sid: int) -> None:
        # Cleanup fan-out is lock and election ops only, disjoint from the
        # value pool by construction: the bulk client's edge cache observes
        # only sessioned chunks, which is sound while that holds.
        if self._groups.config.monotone_tag_accept:
            self.pending_cleanup.append((group, opcode, sid))
        else:
            self._cleanup_tags.add(self._groups.submit(group, opcode, sid))
