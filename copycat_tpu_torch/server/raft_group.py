"""RaftGroup: one Raft consensus group inside a (possibly multi-group) server.

The multi-raft keyspace-sharding refactor (docs/SHARDING.md) moved every
piece of per-group mutable state out of ``RaftServer`` into this class:
term, vote, log, commit/apply cursors, role, election/heartbeat timers,
the replication streams, the session plane, the snapshot store and the
apply loop all live HERE, once per group. ``RaftServer`` (server/raft.py)
keeps what is genuinely shared — the transport, the peer connection pool,
the ingress routing/proxy plane, and the stats surface — and hosts N of
these objects. With ``groups=1`` (the default, and the forced shape under
``COPYCAT_MULTI_GROUP=0``) exactly one group exists and every method in
this file behaves bit-identically to the pre-refactor single-group
server: wire messages carry ``group=None``, event gating/session staging
take the legacy branches, and the election timer keeps the legacy
``uniform(T, 2T)`` distribution.

Multi-group additions are deliberately concentrated:

- every server<->server RPC this group sends stamps ``group=`` so the
  server-side dispatch can demultiplex per-group streams over the same
  correlated peer connections;
- ``_reset_election_timer`` biases the timeout by this member's
  deterministic preference rank for the group (seed-spread leadership:
  member ``g % N`` fires first and wins at boot; on leader loss the next
  live rank tends to win — rebalance-on-timeout);
- ``command_block``/``keepalive_local``/``register_local``/
  ``serve_query`` are the group-scoped staging entry points the
  multi-group ingress (local or proxied) calls — they accept the GAPPED
  per-group seq subsequences hash routing produces, where the legacy
  handlers require the dense single-group sequence;
- ``_seal_and_push`` gates event push on ``session.connection`` instead
  of leadership when multi-group: the member holding the client's
  connection (the ingress) pushes events from its own follower apply,
  because the group's leader may be a different member.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import time
from typing import Any

from ..io.serializer import Serializer
from ..io.transport import Address, Connection, TransportError
from ..protocol import messages as msg
from ..protocol.operations import Command, CommandConsistency, QueryConsistency
from ..utils import knobs
from ..utils.scheduled import Scheduled
from ..utils.tasks import spawn
from ..utils.tracing import TRACER
from .log import (
    CommandEntry,
    ConfigurationEntry,
    Entry,
    KeepAliveEntry,
    NoOpEntry,
    RegisterEntry,
    UnregisterEntry,
)
from .session import ServerSession, SessionState
from .snapshot import SnapshotStore, write_atomic
from .state_machine import Commit, StateMachine, StateMachineExecutor

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

#: edge delta record state marking a version-refresh (the resource is
#: unchanged at the record's version — docs/EDGE_READS.md); the client
#: bumps the entry's version/TTL without touching its state
_EDGE_REFRESH = ("r", None)

logger = logging.getLogger(__name__)


def dispatch_vector_rows(engine: Any, window: Any, rows: list
                         ) -> tuple[list, str | None]:
    """ONE engine round for ``rows`` (staged vector-lane tuples, clock
    first): drain the window's in-flight generator chains so device-op
    order follows the log, marshal the rows into ``run_vector`` columns,
    dispatch. Returns ``(raws, pump_error)`` — a barrier or pump failure
    yields empty ``raws`` with the error set, for the caller's explicit
    per-entry failure branch (:meth:`RaftGroup._finalize_vector_run`).
    The ONE marshalling of the staged row shape, shared by the per-group
    lane (``RaftGroup._apply_vector_run``) and the server's fused
    cross-group dispatch (``RaftServer._flush_fused_engine``)."""
    if window is not None and window.busy:
        try:
            window.barrier()
        except Exception as e:  # noqa: BLE001 — fail rows, not hang
            logger.exception("window drain before vector dispatch failed")
            return [], str(e)
    n = len(rows)
    groups_idx = [0] * n
    opc = [0] * n
    av = [0] * n
    bv = [0] * n
    cv = [0] * n
    for k, (_clock, _e, _s, machine, _i, _op, spec) in enumerate(rows):
        groups_idx[k] = machine._group
        opc[k], av[k], bv[k], cv[k] = spec[0], spec[1], spec[2], spec[3]
    try:
        return engine.run_vector(groups_idx, opc, av, bv, cv), None
    except Exception as e:  # liveness failure: fail loudly, not hang
        logger.exception("vector pump failed; failing %d rows", n)
        return [], str(e)


class _EntryCtx:
    """Per-entry execution context for windowed applies.

    While entered, session publishes are buffered (replayed in log order
    at the entry's finalization) and the executor context's clock/index
    are pinned to the ENTRY's values — a deferred chain resumes after
    later entries advanced the clock, and timers it schedules must use the
    entry's log time on every server or TTL firing order would diverge
    between replicas with different commit-batch boundaries.
    """

    __slots__ = ("raft", "index", "clock", "touched", "buffer", "trace",
                 "_prev_touched", "_prev_buffer", "_prev_index",
                 "_prev_clock")

    def __init__(self, raft: "RaftGroup", entry: Entry,
                 trace: int | None = None) -> None:
        self.raft = raft
        self.index = entry.index
        # _apply_entry already advanced context.clock to this entry
        self.clock = raft.context.clock
        self.touched: set = set()
        self.buffer: list = []
        # originating trace id for event-push attribution at
        # finalization (the causal-tracing plane; None when untraced)
        self.trace = trace

    def __enter__(self) -> "_EntryCtx":
        r = self.raft
        self._prev_touched = r._touched_sessions
        self._prev_buffer = r._publish_buffer
        self._prev_index = r.context.index
        self._prev_clock = r.context.clock
        r._touched_sessions = self.touched
        r._publish_buffer = self.buffer
        r.context.index = self.index
        r.context.clock = self.clock
        return self

    def __exit__(self, *exc) -> None:
        r = self.raft
        r._touched_sessions = self._prev_touched
        r._publish_buffer = self._prev_buffer
        r.context.index = self._prev_index
        r.context.clock = self._prev_clock

    def replay(self) -> None:
        """Flush buffered publishes into the session event queues."""
        for orig, event, message, session in self.buffer:
            orig(event, message)
            self.touched.add(session)
        self.buffer.clear()


class _PeerStream:
    """Leader-side state for one follower's pipelined replication stream.

    The pipeline keeps up to ``COPYCAT_REPL_DEPTH`` append windows in
    flight over the peer connection's correlated multiplexing; this
    object tracks the in-flight accounting (windows + entries, the
    backpressure currency), the rewind ``epoch`` (bumped whenever a
    consistency check fails or a window is lost, so acks from the
    abandoned stream can no longer steer the send cursor), and the
    adaptive window size between ``floor`` and ``ceiling``: an ack
    latency spiking well past the EWMA baseline (a congested or slow
    follower) halves the window toward the floor; acks near baseline
    grow it additively back toward the ceiling — AIMD, the classic
    shape for a windowed stream sharing a link. The baseline is an
    EWMA, not an all-time best: a persistent RTT shift (link weather, a
    follower moving racks) re-baselines within ~10 acks instead of
    reading as congestion forever.
    """

    __slots__ = ("window", "floor", "ceiling", "inflight_windows",
                 "inflight_entries", "epoch", "backoff", "ack_ewma_ms",
                 "floor_hits", "tasks")

    def __init__(self, ceiling: int) -> None:
        self.ceiling = max(1, ceiling)
        self.floor = max(1, self.ceiling // 8)
        self.window = self.ceiling  # start wide; congestion shrinks it
        self.inflight_windows = 0
        self.inflight_entries = 0
        self.epoch = 0
        self.backoff = False  # driver sleeps one beat before resuming
        self.ack_ewma_ms = 0.0
        #: times congestion drove the window down TO its floor — a
        #: cumulative counter because the pinned state itself is
        #: transient (AIMD regrows once the EWMA re-baselines) and a
        #: sampled gauge would miss it; the health plane's
        #: window-collapse detector judges deltas of this
        self.floor_hits = 0
        self.tasks: set[asyncio.Task] = set()

    def observe_ack(self, lat_ms: float) -> None:
        if self.ack_ewma_ms == 0.0:
            self.ack_ewma_ms = lat_ms
        if lat_ms > 4.0 * max(self.ack_ewma_ms, 0.1):
            shrunk = max(self.floor, self.window // 2)
            if shrunk <= self.floor and self.window > self.floor:
                self.floor_hits += 1
            self.window = shrunk
        elif self.window < self.ceiling:
            self.window = min(self.ceiling,
                              self.window + max(1, self.ceiling // 8))
        self.ack_ewma_ms += 0.1 * (lat_ms - self.ack_ewma_ms)


class RaftGroup:
    """One Raft group: per-group consensus + session + apply state.

    Shared services (transport, peer connections, knob-derived config,
    the storage object) are reached through ``self.server``; everything
    mutable per group lives on this object.
    """

    def __init__(self, server: Any, group_id: int,
                 state_machine: StateMachine, metrics: Any) -> None:
        self.server = server
        self.group_id = group_id
        self.address: Address = server.address
        self.members: list[Address] = list(server.boot_members)
        # wire tag: None on the single-group plane so every message is
        # byte-identical to the pre-refactor server; the group id otherwise
        self.wire_group: int | None = None if server.single else group_id
        self.name = (server.name if server.single
                     else f"{server.name}-g{group_id}")

        self.log = server.storage.build_log(
            name=f"{self.name}-{self.address.port}")
        self.term = 0
        self.voted_for: Address | None = None
        self.commit_index = 0
        self.last_applied = 0
        self.global_index = 0

        self.role = FOLLOWER
        self.leader_address: Address | None = None

        self.state_machine = state_machine
        self.executor = StateMachineExecutor(log=self.log)
        self.context = self.executor.context
        self.context.logger = logging.getLogger(
            f"{self.name}-{self.address.port}")
        state_machine.init(self.executor)

        self.sessions: dict[int, ServerSession] = {}
        self.context.sessions = self.sessions

        # leader volatile state
        self.next_index: dict[Address, int] = {}
        self.match_index: dict[Address, int] = {}
        self._last_quorum_contact: dict[Address, float] = {}
        self._replication_events: dict[Address, asyncio.Event] = {}
        self._replication_tasks: dict[Address, asyncio.Task] = {}
        self._peer_streams: dict[Address, _PeerStream] = {}
        self._expiring_sessions: set[int] = set()

        # apply-side bookkeeping
        self._commit_futures: dict[int, asyncio.Future] = {}
        self._event_pushes: set[asyncio.Task] = set()
        self._touched_sessions: set[ServerSession] = set()
        self._applied_event = asyncio.Event()
        self._publish_buffer: list | None = None
        self._window_pending_seqs: set[tuple[int, int]] = set()
        self._advance_scheduled = False  # single-member deferred commit
        # parallel-apply dependency tracking: resource keys / session
        # ids with vector rows staged (locally or in the server's fused
        # collector) whose device effects have not been dispatched yet;
        # _stage_rows counts them so the contiguous plane (which tracks
        # no keys) still bounds pending fused rows correctly
        self._stage_keys: set = set()
        self._stage_sessions: set[int] = set()
        self._stage_rows = 0

        self._election_timer: Scheduled | None = None
        self._leader_timer: Scheduled | None = None
        # index of the entry this member appended on taking leadership:
        # until it has applied through it, its session table may lack a
        # session its log registers (see _session_missing)
        self._term_start = 0

        # read pump windows (per group: the gate is per-group leadership)
        self._read_windows: dict[str, list] = {}
        self._read_flush_scheduled = False

        # Edge read tier (docs/EDGE_READS.md): member-local subscriber
        # registry next to the event channels — resource id -> {session
        # id -> subscribed instance ids} plus the per-session reverse
        # map for death cleanup. NEVER replicated: only the member
        # holding a session's connection registers (it is the one that
        # can push), and a lost registry (failover, restart) degrades to
        # the client's staleness-gate re-seed, not to a wrong read.
        self._edge_subs: dict[int, dict[int, set[int]]] = {}
        self._edge_sessions: dict[int, set[int]] = {}
        self._edge_dirty: dict[int, int | None] = {}  # rid -> trace|None
        self._edge_flush_scheduled = False
        self._edge_pushes: set[asyncio.Task] = set()
        # delta-publication coalescing: a hot write stream batches this
        # long per flush, so fan-out cost is pushes-per-interval per
        # subscriber, not per commit (state-based merge makes the
        # coalescing free — subscribers converge on the latest state)
        self._edge_flush_s = max(
            0.0, knobs.get_float("COPYCAT_EDGE_FLUSH_MS")) / 1e3

        # Per-group metric objects on this group's registry (the SERVER
        # registry itself when single-group, so names/values are
        # bit-identical; a private registry merged under a group= label
        # into the stats surface otherwise).
        self.metrics = metrics
        m = metrics
        self._m_apply_entry = m.counter("applies_per_entry")
        self._m_append_entries = m.histogram("append_batch_entries")
        self._m_heartbeats = m.counter("append_heartbeats")
        self._m_vector_refused = m.counter("vector_classify_refused")
        self._m_single_lane = m.counter("commands_single_lane")
        self._m_fast_lane = m.counter("commands_fast_lane")
        self._m_general_lane = m.counter("commands_general_lane")
        self._m_keepalive_ms = m.histogram("keepalive_latency_ms")
        self._m_append_block = m.histogram("append_block_entries")
        self._m_vector_runs = m.counter("vector_runs")
        self._m_vector_ops = m.counter("vector_ops")
        self._m_run_length = m.histogram("apply_run_length")
        # Dependency-classified parallel apply (docs/SHARDING.md "Apply
        # ordering"): committed-window shape, runs spanning ineligible
        # entries, and conflict-forced flushes. Pre-created so the
        # family is present (count 0) in every snapshot the CI asserts.
        self._m_apply_window = m.histogram("apply.window_entries")
        self._m_apply_spans = m.counter("apply.parallel_spans")
        self._m_apply_conflicts = m.counter("apply.conflict_flushes")
        self._m_query_windows = m.counter("query_windows")
        self._m_query_ops = m.counter("query_ops")
        self._m_query_window_ops = m.histogram("query_window_ops")
        self._m_query_gate_saved = m.counter("query_gate_rounds_saved")
        self._m_query_device = m.counter("query_ops_device_lane")
        self._m_query_per_op = m.counter("query_ops_per_op_lane")
        self._m_query_level = {
            c.value: m.counter("query_reads", consistency=c.value)
            for c in QueryConsistency}
        self._m_repl_windows = m.counter("repl.windows_sent")
        self._m_repl_entries = m.counter("repl.entries_sent")
        self._m_repl_window_entries = m.histogram("repl.window_entries")
        self._m_repl_ack_ms = m.histogram("repl.ack_ms")
        self._m_repl_rewinds = m.counter("repl.rewinds")
        self._m_repl_stalls = m.counter("repl.stalls")
        self._m_repl_backpressure = m.counter("repl.backpressure_waits")
        self._m_repl_inflight_windows = m.gauge("repl.windows_inflight")
        self._m_repl_inflight_entries = m.gauge("repl.entries_inflight")
        self._m_snap_taken = m.counter("snap.snapshots_taken")
        self._m_snap_bytes = m.counter("snap.snapshot_bytes")
        self._m_snap_ms = m.histogram("snap.snapshot_ms")
        self._m_snap_trunc = m.counter("snap.truncated_entries")
        self._m_snap_chunks_sent = m.counter("snap.install_chunks_sent")
        self._m_snap_chunks_recv = m.counter("snap.install_chunks_received")
        self._m_snap_installs_sent = m.counter("snap.installs_sent")
        self._m_snap_installs_recv = m.counter("snap.installs_received")
        self._m_snap_install_fail = m.counter("snap.install_failures")
        self._m_snap_restores = m.counter("snap.restores")
        self._m_snap_restore_ms = m.histogram("snap.restore_ms")
        self._m_snap_meta_fallback = m.counter("snap.meta_fallbacks")
        self._m_snap_capture_fail = m.counter("snap.capture_failures")
        # Edge read tier (docs/EDGE_READS.md): subscription registry +
        # delta publication accounting. Pre-created so the family is
        # present (count 0) in every snapshot the CI asserts.
        self._m_edge_subs = m.gauge("edge.subscriptions")
        self._m_edge_subscribes = m.counter("edge.subscribes")
        self._m_edge_unsubscribes = m.counter("edge.unsubscribes")
        self._m_edge_deltas = m.counter("edge.deltas_sent")
        self._m_edge_flushes = m.counter("edge.delta_flushes")
        self._m_edge_retired = m.counter("edge.entries_retired")
        # Per-phase commit-latency attribution (docs/OBSERVABILITY.md
        # "Cluster-wide causal tracing"): fed ONLY by traced requests —
        # the client's trace flag is the sampling switch, so the
        # untraced hot path never touches these. Pre-created so the
        # family is present (count 0) in every snapshot the CI asserts.
        self._m_lat_append = m.histogram("latency.append_ms")
        self._m_lat_quorum = m.histogram("latency.quorum_ms")
        self._m_lat_fsync = m.histogram("latency.fsync_ms")
        self._m_lat_apply = m.histogram("latency.apply_ms")
        self._m_lat_respond = m.histogram("latency.respond_ms")
        self._m_lat_commit = m.histogram("latency.commit_ms")
        self._m_lat_event_push = m.histogram("latency.event_push_ms")
        self._m_lat_follower = m.histogram("latency.follower_append_ms")

        # causal-tracing bookkeeping (all empty unless requests carry a
        # trace id — the disabled hot path pays empty-dict truthiness
        # checks only): watch = appended-index -> (trace, t_append) for
        # the quorum.wait split (popped the instant commit covers it);
        # window marks = appended-index -> trace for stamping
        # replication windows, retained until EVERY member has the
        # entry (pruned at global_index — a commit-time pop would stop
        # stamping windows to stragglers, losing exactly the laggy
        # members' spans); commit_t = trace -> instant the commit
        # boundary (incl. fsync) covered it, read by the awaiting
        # coroutine for the apply span; entry marks = log index ->
        # trace, consumed by the apply loop to stamp event pushes.
        self._trace_watch: dict[int, tuple[int, float]] = {}
        self._trace_window_marks: dict[int, int] = {}
        self._trace_commit_t: dict[int, float] = {}
        self._trace_entry_marks: dict[int, int] = {}
        self._member = str(self.address)
        self._trace_slow_ms = knobs.get_float("COPYCAT_TRACE_SLOW_MS")

        # health-plane fsync accounting (utils/health.py): cheap EWMA +
        # per-window max over the commit-boundary fsyncs, fed only when
        # the server's health plane is on (COPYCAT_HEALTH=0 keeps the
        # bare log.sync() calls — the A/B discipline)
        self._fsync_count = 0
        self._fsync_last_ms = 0.0
        self._fsync_ewma_ms = 0.0
        self._fsync_recent_max_ms = 0.0

        # crash-recovery plane (per group: own snapshot store + meta file)
        self._snapshots: SnapshotStore | None = None
        if self.storage.directory:
            self._snapshots = SnapshotStore(
                self.storage.directory, f"{self.name}-{self.address.port}")
        self._snap_index = 0
        self._snap_supported = True
        self._installing: dict | None = None
        self._install_term_cache: tuple[int, int] | None = None
        self._recovery_replay_s = 0.0
        self._recovery_boot_last = 0

        self._load_meta()
        self._boot_recover()
        self._recovery_boot_last = (
            self.log.last_index if self.log.last_index > self.last_applied
            else 0)

    # ------------------------------------------------------------------
    # shared-config delegation (live reads: tests flip these on the
    # server mid-run and the next operation must see the change)
    # ------------------------------------------------------------------

    @property
    def storage(self):
        return self.server.storage

    @property
    def election_timeout(self) -> float:
        return self.server.election_timeout

    @property
    def heartbeat_interval(self) -> float:
        return self.server.heartbeat_interval

    @property
    def session_timeout(self) -> float:
        return self.server.session_timeout

    @property
    def _closing(self) -> bool:
        return self.server._closing

    @property
    def _repl_pipeline(self) -> bool:
        return self.server._repl_pipeline

    @property
    def _repl_window(self) -> int:
        return self.server._repl_window

    @property
    def _repl_depth(self) -> int:
        return self.server._repl_depth

    @property
    def _repl_max_inflight(self) -> int:
        return self.server._repl_max_inflight

    @property
    def _strict_invariants(self) -> bool:
        return self.server._strict_invariants

    @property
    def _vector_pump(self) -> bool:
        return self.server._vector_pump

    @property
    def _read_pump(self) -> bool:
        return self.server._read_pump

    @property
    def _parallel_apply(self) -> bool:
        return self.server._parallel_apply

    @property
    def _apply_fuse(self) -> bool:
        return self.server._apply_fuse

    @property
    def _snap_enabled(self) -> bool:
        return self.server._snap_enabled

    @property
    def _snap_every(self) -> int:
        return self.server._snap_every

    @property
    def _snap_retain(self) -> int:
        return self.server._snap_retain

    @property
    def _snap_chunk(self) -> int:
        return self.server._snap_chunk

    @property
    def _fsync_on_commit(self) -> bool:
        return self.server._fsync_on_commit

    @property
    def _snap_serializer(self) -> Serializer:
        return self.server._snap_serializer

    async def _peer_connection(self, peer: Address) -> Connection | None:
        return await self.server._peer_connection(peer)

    # ------------------------------------------------------------------
    # lifecycle (driven by the server's open/close)
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._become_follower(self.term, None, reset_timer=True)

    def shutdown(self) -> None:
        """Cancel timers/streams and fail everything pending (the group
        half of the server's ``_do_close``); the log closes here too."""
        self.server.drop_fused(self)
        self._cancel_timers()
        self._stop_replication()
        self._trace_clear()
        for task in list(self._edge_pushes):
            task.cancel()
        self._edge_pushes.clear()
        self._edge_subs.clear()
        self._edge_sessions.clear()
        self._edge_dirty.clear()
        for fut in self._commit_futures.values():
            if not fut.done():
                fut.set_exception(
                    msg.ProtocolError(msg.NO_LEADER, "server closed"))
        self._commit_futures.clear()
        for items in self._read_windows.values():
            for _, _, _, fut in items:
                if not fut.done():
                    fut.set_result((0, None, msg.NO_LEADER, "server closed"))
        self._read_windows.clear()
        self.log.close()

    def _cancel_timers(self) -> None:
        if self._election_timer is not None:
            self._election_timer.cancel()
            self._election_timer = None
        if self._leader_timer is not None:
            self._leader_timer.cancel()
            self._leader_timer = None

    # ------------------------------------------------------------------
    # persistence of (term, voted_for)
    # ------------------------------------------------------------------

    @property
    def _meta_path(self) -> str | None:
        if self.storage.directory:
            return os.path.join(
                self.storage.directory,
                f"{self.name}-{self.address.port}.meta")
        return None

    def _persist_meta(self) -> None:
        # tmp + fsync + atomic rename: a torn (term, voted_for) write is a
        # Raft SAFETY hazard — a lost vote record lets this server vote
        # twice in the same term after a restart, electing two leaders.
        path = self._meta_path
        if path:
            write_atomic(path, json.dumps(
                {"term": self.term,
                 "voted_for": str(self.voted_for) if self.voted_for else None}
            ).encode())

    def _load_meta(self) -> None:
        path = self._meta_path
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                meta = json.load(f)
            self.term = int(meta.get("term", 0))
            voted = meta.get("voted_for")
            self.voted_for = Address.parse(voted) if voted else None
        except (json.JSONDecodeError, ValueError, KeyError, OSError) as e:
            # A corrupt/truncated meta file (a torn write from a pre-atomic
            # version, or disk damage) must not kill the boot: fall back to
            # zero-state — conservative for elections (this server may
            # re-vote in a term it already voted in, which the atomic
            # writer above makes vanishingly unlikely to matter) — and
            # leave a loud trail: log, counter, and a flight-recorder note
            # when the device telemetry hub is reachable.
            logger.warning("%s meta file %s corrupt (%s); booting with "
                           "zero vote state", self.name, path, e)
            self._m_snap_meta_fallback.inc()
            self._flight_note("meta_corrupt", path=path, error=str(e))
            self.term = 0
            self.voted_for = None

    def _trace_span(self, trace: int, name: str, t0: float, t1: float,
                    hist=None, **meta: Any) -> None:
        """Record one server-side span under ``trace`` — tagged with
        this member + group so the cross-member assembly can attribute
        it — and feed the matching ``latency.*`` phase histogram."""
        TRACER.span(trace, name, t0, t1, member=self._member,
                    group=self.group_id, **meta)
        if hist is not None:
            hist.record((t1 - t0) * 1e3)

    def _trace_note_slow(self, trace: int, t0: float, t1: float) -> None:
        """Slow-trace exemplar: a traced request whose server residency
        exceeded ``COPYCAT_TRACE_SLOW_MS`` lands in the device-plane
        flight recorder, next to whatever fault caused it."""
        ms = (t1 - t0) * 1e3
        if ms >= self._trace_slow_ms:
            self._flight_note("slow_trace", trace=trace,
                              ms=round(ms, 3))

    def _trace_clear(self) -> None:
        """Drop causal-tracing bookkeeping (leadership loss/shutdown:
        the awaiting coroutines are failing with NOT_LEADER and nothing
        will consume the watches)."""
        self._trace_watch.clear()
        self._trace_window_marks.clear()
        self._trace_commit_t.clear()
        self._trace_entry_marks.clear()

    def _flight_note(self, kind: str, **fields) -> None:
        """Best-effort note in the device-plane flight recorder (the ring
        ``testing/nemesis.py`` faults also land in), so a recovery anomaly
        sits next to whatever fault caused it in one /flight dump. With
        the health plane on, the note also lands in the durable black-box
        so it survives a crash — all via the server's ``health_note``
        (one implementation of the hub-else-blackbox + spill wiring)."""
        self.server.health_note(
            kind, group=None if self.server.single else self.group_id,
            **fields)

    def _note_fsync(self, ms: float) -> None:
        """Health-plane fsync accounting: last/max/EWMA of the
        commit-boundary fsync latency (the fsync-spike detector's
        input; ``fsync_recent_max`` is consumed by ``health_sample``)."""
        self._fsync_count += 1
        self._fsync_last_ms = ms
        if ms > self._fsync_recent_max_ms:
            self._fsync_recent_max_ms = ms
        self._fsync_ewma_ms = (
            ms if self._fsync_ewma_ms == 0.0
            else self._fsync_ewma_ms + 0.1 * (ms - self._fsync_ewma_ms))

    def _sync_log(self) -> None:
        """Commit-boundary ``log.sync()`` with health-plane latency
        accounting; COPYCAT_HEALTH=0 keeps the bare sync (not even the
        clock reads) — the A/B lane."""
        if not self.server._health_enabled:
            self.log.sync()
            return
        t0 = time.perf_counter()
        self.log.sync()
        self._note_fsync((time.perf_counter() - t0) * 1e3)

    # ------------------------------------------------------------------
    # snapshot capture / restore (crash-recovery plane)
    # ------------------------------------------------------------------

    def _wire_session(self, session: ServerSession) -> None:
        """Route the session's publish through touched-session tracking /
        the windowed-apply publish buffer (installed at register-apply
        time AND at snapshot restore — restored sessions must publish
        exactly like never-crashed ones)."""
        original_publish = session.publish

        def tracked_publish(event: str, message: Any = None,
                            _orig=original_publish, _s=session) -> None:
            buf = self._publish_buffer
            if buf is not None:
                # windowed apply: buffered, replayed in log order at the
                # entry's finalization (chains complete out of order)
                buf.append((_orig, event, message, _s))
            else:
                _orig(event, message)
                self._session_touched(_s)

        session.publish = tracked_publish  # type: ignore[method-assign]

    def _snapshot_payload(self) -> bytes | None:
        """Serialize the full replicated image at ``last_applied``, or
        ``None`` when the state machine opts out of snapshotting."""
        machine_state = self.state_machine.snapshot_state()
        if machine_state is NotImplemented:
            if self._snap_supported:
                self._snap_supported = False
                logger.info(
                    "%s state machine %s does not support snapshots; "
                    "staying on the replay-only recovery path", self.name,
                    type(self.state_machine).__name__)
            return None
        payload = {
            "version": 1,
            "index": self.last_applied,
            "term": self.log.term_at(self.last_applied) or self.term,
            "clock": self.context.clock,
            "members": [str(m) for m in self.members],
            "sessions": [s.snapshot_dict() for s in self.sessions.values()],
            "machine": machine_state,
        }
        return self._snap_serializer.write(payload)

    def _take_snapshot(self) -> bool:
        """Capture + persist one snapshot at ``last_applied``, then release
        the log prefix behind it (keeping ``COPYCAT_SNAPSHOT_RETAIN``
        entries so slightly-lagging followers avoid an install)."""
        index = self.last_applied
        t0 = time.perf_counter()
        try:
            data = self._snapshot_payload()
            if data is None:
                return False
            self._snapshots.save(index, data)
            self._snapshots.gc(keep=2)
            self._snap_index = index
            self._m_snap_taken.inc()
            self._m_snap_bytes.inc(len(data))
            self._m_snap_ms.record((time.perf_counter() - t0) * 1e3)
            released = self.log.truncate_prefix(index - self._snap_retain)
            self._m_snap_trunc.inc(released)
        except Exception:  # noqa: BLE001 - capture must never kill apply
            # serialization bugs AND storage I/O (disk full, EIO on the
            # tmp write/rename, segment deletion): the apply/commit path
            # that called us must keep running either way
            logger.exception("%s snapshot capture at %d failed", self.name,
                             index)
            self._m_snap_capture_fail.inc()
            self._flight_note("snapshot_failed", index=index)
            return False
        logger.debug("%s snapshot at %d (%d bytes, %d entries released)",
                     self.name, index, len(data), released)
        return True

    def _maybe_snapshot(self) -> None:
        if (self._snap_enabled and self._snap_supported
                and self._snapshots is not None
                and self.last_applied - self._snap_index >= self._snap_every):
            # staged-but-undispatched fused vector rows are device
            # effects the image at last_applied must include — drain
            # the collector before capturing (a no-op when empty)
            self.server.flush_fused()
            self._take_snapshot()

    def _boot_recover(self) -> None:
        """Load the newest valid snapshot and restore state at boot, so the
        log tail — not the whole history — is all that replays (recovery
        time bounded by the snapshot cadence).  With COPYCAT_SNAPSHOTS=0
        this is a no-op: the replay-only path, bit-identically."""
        if not self._snap_enabled or self._snapshots is None:
            return
        snap = self._snapshots.newest()
        if snap is None:
            return
        index, data = snap
        try:
            payload = self._snap_serializer.read(data)
            self._restore_snapshot(payload)
        except Exception:  # noqa: BLE001 - fall back to full replay
            logger.exception("%s snapshot restore at %d failed; falling "
                             "back to full replay", self.name, index)
            self._flight_note("snapshot_restore_failed", index=index)
            # scrub anything a partial restore touched before replaying
            # from zero — replaying onto half-restored sessions/clock
            # would silently diverge this member (the machine hooks are
            # ordered to mutate last, see _restore_snapshot)
            self.sessions.clear()
            self.context.clock = 0.0
            self.last_applied = 0
            self.commit_index = 0
            self._snap_index = 0

    def _restore_snapshot(self, payload: dict) -> None:
        """Install one decoded snapshot image (boot recovery and the
        follower side of install streaming share this path)."""
        t0 = time.perf_counter()
        index = payload["index"]
        term = payload["term"]
        # vector rows parked in the server's fused collector belong to
        # entries the image (index > last_applied) already covers —
        # dispatch them against the PRE-restore state they were staged
        # on, or they would double-apply on top of the restored image
        # at the end-of-turn tick (a no-op at boot / when empty)
        self.server.flush_fused()
        # decode EVERYTHING decodable into locals before the first
        # mutation of self, so a malformed image fails fast with this
        # server still pristine (the boot path then falls back to full
        # replay cleanly; the install path refuses the chunk)
        members = [Address.parse(m) for m in payload["members"]]
        restored = [ServerSession.from_snapshot(s)
                    for s in payload["sessions"]]
        self.context.clock = payload["clock"]
        if members:
            self.members = members
        # session plane: replicated halves restored, publish re-wired; the
        # dict object is shared with context.sessions — mutate in place
        self.sessions.clear()
        for session in restored:
            self._wire_session(session)
            self.sessions[session.id] = session
        self.state_machine.restore_state(payload["machine"], self.sessions)
        # log alignment: keep a matching tail, otherwise restart past the
        # snapshot boundary (Raft snapshot-install rule)
        log = self.log
        if log.last_index > index and log.term_at(index) in (0, term) \
                and log.first_index <= index + 1:
            if log.prefix_index < index - self._snap_retain:
                self._m_snap_trunc.inc(
                    log.truncate_prefix(index - self._snap_retain))
        elif log.last_index != index or log.term_at(index) not in (0, term) \
                or log.first_index > index + 1:
            log.reset_to(index, term)
        self.last_applied = index
        self.commit_index = max(self.commit_index, index)
        self._snap_index = index
        self._m_snap_restores.inc()
        self._m_snap_restore_ms.record((time.perf_counter() - t0) * 1e3)
        self._applied_event.set()

    # ------------------------------------------------------------------
    # membership views
    # ------------------------------------------------------------------

    @property
    def peers(self) -> list[Address]:
        return [m for m in self.members if m != self.address]

    @property
    def quorum(self) -> int:
        return len(self.members) // 2 + 1

    # ------------------------------------------------------------------
    # role transitions
    # ------------------------------------------------------------------

    def _become_follower(self, term: int, leader: Address | None,
                         reset_timer: bool = True) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_meta()
        was_leader = self.role == LEADER
        self.role = FOLLOWER
        if leader is not None:
            self.leader_address = leader
        if was_leader:
            self._stop_replication()
            self._fail_pending(msg.NOT_LEADER)
            self._expiring_sessions.clear()
        if reset_timer:
            self._reset_election_timer()

    def _reset_election_timer(self) -> None:
        if self._election_timer is not None:
            self._election_timer.cancel()
        base = self.election_timeout
        if self.server.single:
            timeout = random.uniform(base, base * 2)
        else:
            # Leadership spread (docs/SHARDING.md): the member at this
            # group's deterministic preference rank fires FIRST — rank 0
            # (member ``g % N`` over the sorted member list) draws from
            # [0.6T, T), strictly below everyone else's [T, 2T), so at
            # boot every member wins ~G/N groups without coordination.
            # Higher ranks add a per-rank offset, so on leader loss the
            # next LIVE rank tends to win (rebalance-on-timeout). Ranks
            # are unique per group — no two members share a band, which
            # keeps split votes as unlikely as the legacy distribution.
            ranked = sorted(self.members, key=lambda a: (a.host, a.port))
            n = len(ranked)
            try:
                rank = (ranked.index(self.address)
                        - self.group_id) % n
            except ValueError:  # joining: not in members yet
                rank = n
            if rank == 0:
                timeout = random.uniform(base * 0.6, base)
            else:
                timeout = (random.uniform(base, base * 2)
                           + base * 0.3 * rank)
        self._election_timer = Scheduled(timeout, None, self._start_election)

    async def _start_election(self) -> None:
        if self._closing or self.role == LEADER:
            return
        self.role = CANDIDATE
        self.term += 1
        self.voted_for = self.address
        self.leader_address = None
        self._persist_meta()
        term = self.term
        self.metrics.counter("raft_elections_started").inc()
        logger.debug("%s starting election for term %d", self.name, term)
        self._reset_election_timer()  # re-elect if this round stalls

        votes = 1  # self
        if votes >= self.quorum:
            self._become_leader()
            return

        async def request_vote(peer: Address) -> bool:
            conn = await self._peer_connection(peer)
            if conn is None:
                return False
            try:
                response = await asyncio.wait_for(
                    conn.send(msg.VoteRequest(
                        term=term, candidate=self.address,
                        last_log_index=self.log.last_index,
                        last_log_term=self.log.term_at(self.log.last_index),
                        group=self.wire_group)),
                    self.election_timeout)
            except (TransportError, OSError, asyncio.TimeoutError):
                return False
            if response.term is not None and response.term > self.term:
                self._become_follower(response.term, None)
                return False
            return bool(response.voted) and response.term == term

        tasks = [spawn(request_vote(p), name="request-vote")
                 for p in self.peers]
        for fut in asyncio.as_completed(tasks):
            granted = await fut
            if self.role != CANDIDATE or self.term != term:
                break
            if granted:
                votes += 1
                if votes >= self.quorum:
                    self._become_leader()
                    break
        for t in tasks:
            if not t.done():
                t.cancel()

    def _become_leader(self) -> None:
        if self.role == LEADER:
            return
        self.role = LEADER
        self.leader_address = self.address
        self.metrics.counter("raft_leader_transitions").inc()
        logger.info("%s elected leader for term %d", self.name, self.term)
        if self._election_timer is not None:
            self._election_timer.cancel()
            self._election_timer = None
        for peer in self.peers:
            self.next_index[peer] = self.log.last_index + 1
            self.match_index[peer] = 0
            self._replication_events[peer] = asyncio.Event()
            self._replication_tasks[peer] = spawn(
                self._replicate_loop(peer), name=f"replicate-{peer}")
        self._last_quorum_contact = {self.address: time.monotonic()}
        # Reset every open session's contact clock: last_contact is
        # LEADER-LOCAL wall time (replicated keep-alives advance only the
        # deterministic log clock), so a re-elected leader would otherwise
        # judge staleness from its PREVIOUS term's contacts and expire
        # sessions that kept keep-aliving the interim leader all along —
        # found by the partition+loss soak (tests/test_nemesis_raft.py).
        # Every session gets one full timeout from takeover, the
        # reference's new-leader grace.
        now = time.monotonic()
        for session in self.sessions.values():
            session.last_contact = now
        # Commit an entry from this term immediately (Raft §5.4.2) and advance
        # the state machine clock.
        self._term_start = self._append(NoOpEntry())
        self._leader_timer = Scheduled(self.heartbeat_interval,
                                       self.heartbeat_interval,
                                       self._leader_maintenance)

    def _stop_replication(self) -> None:
        for task in self._replication_tasks.values():
            task.cancel()
        self._replication_tasks.clear()
        self._replication_events.clear()
        # drain the pipelined lanes: in-flight window sends die with the
        # stream (their ack handling is role-gated anyway)
        for ps in self._peer_streams.values():
            for task in list(ps.tasks):
                task.cancel()
        self._peer_streams.clear()
        self._refresh_repl_gauges()
        if self._leader_timer is not None:
            self._leader_timer.cancel()
            self._leader_timer = None

    def _fail_pending(self, code: str) -> None:
        self._trace_clear()
        for fut in self._commit_futures.values():
            if not fut.done():
                fut.set_exception(
                    msg.ProtocolError(code, leader=self.leader_address))
        self._commit_futures.clear()
        for session in self.sessions.values():
            for fut in session.command_futures.values():
                if not fut.done():
                    fut.set_exception(
                        msg.ProtocolError(code, leader=self.leader_address))
            session.command_futures.clear()
            session.pending_ops.clear()
            session.next_append_seq = 0  # re-derive on next leadership

    # ------------------------------------------------------------------
    # leader: append + replication + commit advance
    # ------------------------------------------------------------------

    def _append(self, entry: Entry) -> int:
        entry.term = self.term
        entry.timestamp = time.time()
        index = self.log.append(entry)
        self._signal_replication()
        if len(self.members) == 1:
            # Defer commit advance to the end of the current event-loop
            # turn so a burst of concurrent appends commits and APPLIES as
            # one batch (the device window amortizes engine rounds across
            # the whole batch; multi-member clusters batch naturally via
            # replication acks).
            if not self._advance_scheduled:
                self._advance_scheduled = True
                asyncio.get_running_loop().call_soon(self._advance_deferred)
        return index

    def _advance_deferred(self) -> None:
        self._advance_scheduled = False
        if self.role == LEADER and not self._closing:
            self._advance_commit()

    def _signal_replication(self) -> None:
        for event in self._replication_events.values():
            event.set()

    async def _append_and_wait(self, entry: Entry) -> Any:
        """Append an entry and wait until it is committed and applied."""
        # Register the future before appending: on a single-member cluster
        # the append commits and applies within the same event-loop turn.
        index = self.log.last_index + 1
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._commit_futures[index] = fut
        actual = self._append(entry)
        assert actual == index
        return await fut

    async def _replicate_loop(self, peer: Address) -> None:
        try:
            if self._repl_pipeline:
                await self._replicate_pipelined(peer)
            else:
                await self._replicate_stop_and_wait(peer)
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("replication loop to %s failed", peer)

    # -- stop-and-wait lane (COPYCAT_REPL_PIPELINE=0): one window in
    # -- flight per peer, the pre-pipeline behavior bit-identically —
    # -- the cluster bench's A/B baseline
    async def _replicate_stop_and_wait(self, peer: Address) -> None:
        event = self._replication_events[peer]
        while self.role == LEADER and not self._closing:
            event.clear()
            await self._replicate_once(peer)
            if self.role != LEADER:
                return
            if self.next_index.get(peer, 1) > self.log.last_index:
                try:
                    await asyncio.wait_for(event.wait(),
                                           self.heartbeat_interval)
                except asyncio.TimeoutError:
                    pass

    def _stage_window(self, next_index: int,
                      limit: int) -> tuple[msg.AppendRequest, int, int]:
        """Build one append window [next_index, covered_end] — shared by
        both lanes so their wire shape can never drift apart. The end of
        the covered index range may omit compacted (cleaned) entries:
        they are only ever compacted once replicated to ALL members, so
        the follower already has them (it gap-fills via ``fill_to``)."""
        prev_index = next_index - 1
        entries = self.log.entries_from(next_index, limit=limit)
        covered_end = min(next_index + limit - 1, self.log.last_index)
        trace = None
        if self._trace_window_marks and covered_end >= next_index:
            # this window carries a traced entry toward quorum: stamp
            # ``(trace id, entry index)`` (an OPTIONAL trailing wire
            # field — untraced windows stay byte-identical) so the
            # follower records its ingest under the same causal
            # timeline AND marks the entry for event-push attribution
            # (the connection-holding member pushes from its own apply).
            # Window marks outlive the quorum watch: a straggler whose
            # window is staged after commit still gets the stamp. The
            # field carries ONE (trace, index) pair — when entries of
            # several concurrent traces coalesce into one window, only
            # the first gets follower-side spans (a documented sampling
            # limitation, not a correctness hazard: leader-side phases
            # and the client span always land for every trace).
            trace = next(((t, i) for i, t
                          in self._trace_window_marks.items()
                          if next_index <= i <= covered_end), None)
        request = msg.AppendRequest(
            term=self.term, leader=self.address,
            prev_index=prev_index, prev_term=self.log.term_at(prev_index),
            entries=entries, commit_index=self.commit_index,
            global_index=self.global_index,
            fill_to=covered_end if covered_end >= next_index else None,
            group=self.wire_group, trace=trace)
        if covered_end >= next_index:
            self._m_repl_windows.inc()
            self._m_repl_entries.inc(len(entries))
            self._m_repl_window_entries.record(len(entries))
        return request, prev_index, covered_end

    async def _replicate_once(self, peer: Address) -> None:
        conn = await self._peer_connection(peer)
        if conn is None:
            await asyncio.sleep(self.heartbeat_interval)
            return
        next_index = self.next_index.get(peer, self.log.last_index + 1)
        if next_index <= self.log.prefix_index:
            # the entries this follower needs were released behind a
            # snapshot: stream the snapshot, then resume appending
            await self._install_to_peer(peer, conn)
            return
        request, prev_index, covered_end = self._stage_window(
            next_index, self._repl_window)
        t0 = time.perf_counter()
        try:
            response = await asyncio.wait_for(conn.send(request),
                                              self.election_timeout)
        except (TransportError, OSError, asyncio.TimeoutError):
            self._m_repl_stalls.inc()
            await asyncio.sleep(self.heartbeat_interval)
            return
        if self.role != LEADER:
            return
        if response.term is not None and response.term > self.term:
            self._become_follower(response.term, None)
            return
        self._last_quorum_contact[peer] = time.monotonic()
        self._m_repl_ack_ms.record((time.perf_counter() - t0) * 1e3)
        if response.success:
            match = max(prev_index, covered_end)
            if match > self.match_index.get(peer, 0):
                self.match_index[peer] = match
            self.next_index[peer] = max(self.next_index.get(peer, 1),
                                        match + 1)
            self._advance_commit()
            if self.next_index[peer] <= self.log.last_index:
                self._replication_events[peer].set()  # keep streaming
        else:
            self._m_repl_rewinds.inc()
            hint = (response.last_index
                    if response.last_index is not None else prev_index - 1)
            new_next = max(1, min(prev_index, hint + 1))
            if new_next == next_index:
                # No rewind progress (e.g. follower in a weird state): back
                # off instead of hot-spinning the failure path.
                self._m_repl_stalls.inc()
                await asyncio.sleep(self.heartbeat_interval)
            self.next_index[peer] = new_next
            self._replication_events[peer].set()

    # -- pipelined lane (default): up to REPL_DEPTH windows in flight
    # -- per peer over the transport's correlated multiplexing; acks may
    # -- land out of order, match only moves forward, commit advances
    # -- per ack, a failed consistency check drains + rewinds the stream

    async def _replicate_pipelined(self, peer: Address) -> None:
        event = self._replication_events[peer]
        ps = _PeerStream(self._repl_window)
        self._peer_streams[peer] = ps
        try:
            while self.role == LEADER and not self._closing:
                conn = await self._peer_connection(peer)
                if conn is None:
                    await asyncio.sleep(self.heartbeat_interval)
                    continue
                if ps.backoff:
                    # a lost window or a no-progress rewind: wait one beat
                    # instead of hot-spinning the failure path
                    ps.backoff = False
                    await asyncio.sleep(self.heartbeat_interval)
                    continue
                if self.next_index.get(peer, 1) <= self.log.prefix_index:
                    # follower fell behind the prefix-truncated log: the
                    # append stream cannot serve it — drain in-flight
                    # windows, then stream the snapshot through the same
                    # connection (chunks ride the correlated multiplexing
                    # with the stream's depth + AIMD accounting), and
                    # resume appending where the snapshot ends
                    if ps.inflight_windows:
                        try:
                            await asyncio.wait_for(event.wait(),
                                                   self.heartbeat_interval)
                        except asyncio.TimeoutError:
                            pass
                        continue
                    await self._install_to_peer(peer, conn, ps)
                    continue
                event.clear()
                sent = self._pump_windows(peer, ps, conn)
                if (not sent and not ps.inflight_windows
                        and self.next_index.get(peer, 1)
                        > self.log.last_index):
                    # idle stream: heartbeat cadence keeps the follower's
                    # election timer reset and the leader lease fresh
                    try:
                        await asyncio.wait_for(event.wait(),
                                               self.heartbeat_interval)
                    except asyncio.TimeoutError:
                        self._spawn_window(peer, ps, conn)
                    continue
                # streaming or backpressured: wake on the next ack (the
                # send task sets the event) or new appends
                try:
                    await asyncio.wait_for(event.wait(),
                                           self.heartbeat_interval)
                except asyncio.TimeoutError:
                    pass
        finally:
            self._peer_streams.pop(peer, None)
            for task in list(ps.tasks):
                task.cancel()

    def _pump_windows(self, peer: Address, ps: _PeerStream,
                      conn: Connection) -> bool:
        """Launch append windows until the stream is caught up or the
        in-flight caps (windows, entries) push back; True if any window
        was sent this pump."""
        sent = False
        while (self.role == LEADER and not self._closing
               and ps.inflight_windows < self._repl_depth
               and ps.inflight_entries < self._repl_max_inflight
               and self.next_index.get(peer, 1) <= self.log.last_index):
            self._spawn_window(peer, ps, conn)
            sent = True
        if (self.next_index.get(peer, 1) <= self.log.last_index
                and (ps.inflight_windows >= self._repl_depth
                     or ps.inflight_entries >= self._repl_max_inflight)):
            # entries are waiting but the caps hold them back: a slow
            # follower cannot pin unbounded log memory — count the wait
            self._m_repl_backpressure.inc()
        return sent

    def _spawn_window(self, peer: Address, ps: _PeerStream,
                      conn: Connection) -> None:
        """Stage one append window [next_index, covered_end] and send it
        without awaiting the ack (the ack lands in ``_send_window``).
        The send cursor advances optimistically; a failed consistency
        check or lost window rewinds it (epoch-gated)."""
        next_index = self.next_index.get(peer, self.log.last_index + 1)
        # clamp to the remaining in-flight entry budget so the gauge's
        # documented bound (peers x COPYCAT_REPL_MAX_INFLIGHT) is exact —
        # without it the last window could overshoot by window-1 entries
        limit = min(ps.window,
                    max(1, self._repl_max_inflight - ps.inflight_entries))
        request, prev_index, covered_end = self._stage_window(
            next_index, limit)
        if covered_end >= next_index:
            self.next_index[peer] = covered_end + 1  # optimistic cursor
        ps.inflight_windows += 1
        ps.inflight_entries += max(0, covered_end - prev_index)
        self._refresh_repl_gauges()
        task = spawn(
            self._send_window(peer, ps, conn, request, prev_index,
                              covered_end, ps.epoch, time.perf_counter()),
            name="repl-window")
        ps.tasks.add(task)
        task.add_done_callback(ps.tasks.discard)

    async def _send_window(self, peer: Address, ps: _PeerStream,
                           conn: Connection, request: msg.AppendRequest,
                           prev_index: int, covered_end: int, epoch: int,
                           t0: float) -> None:
        try:
            response = await asyncio.wait_for(conn.send(request),
                                              self.election_timeout)
        except (TransportError, OSError, asyncio.TimeoutError):
            response = None
        finally:
            ps.inflight_windows -= 1
            ps.inflight_entries -= max(0, covered_end - prev_index)
            self._refresh_repl_gauges()
        event = self._replication_events.get(peer)
        try:
            if self._closing or self.role != LEADER:
                return
            if response is None:
                # lost window (dead/slow link): rewind the send cursor to
                # resend from this window's start once the link recovers;
                # acks of the abandoned stream no longer steer the cursor
                if epoch == ps.epoch:
                    ps.epoch += 1
                    ps.backoff = True
                    self._m_repl_stalls.inc()
                    self.next_index[peer] = min(
                        self.next_index.get(peer, 1), prev_index + 1)
                return
            if response.term is not None and response.term > self.term:
                self._become_follower(response.term, None)
                return
            self._last_quorum_contact[peer] = time.monotonic()
            lat_ms = (time.perf_counter() - t0) * 1e3
            self._m_repl_ack_ms.record(lat_ms)
            ps.observe_ack(lat_ms)
            if response.success:
                # acks complete out of order: match only moves FORWARD
                match = max(prev_index, covered_end)
                if match > self.match_index.get(peer, 0):
                    self.match_index[peer] = match
                # a success ack is a safe resume point even from a stale
                # epoch (log matching held at the follower when it acked):
                # this heals the spurious rewind a reordered window causes
                if match + 1 > self.next_index.get(peer, 1):
                    self.next_index[peer] = match + 1
                self._advance_commit()
            else:
                if epoch != ps.epoch:
                    return  # the pipeline already rewound past this one
                ps.epoch += 1  # drain: stale in-flight acks are ignored
                self._m_repl_rewinds.inc()
                hint = (response.last_index
                        if response.last_index is not None
                        else prev_index - 1)
                new_next = max(1, min(prev_index, hint + 1))
                if new_next >= prev_index + 1:
                    # no rewind progress (log base reached and the
                    # follower still refuses): back off a beat
                    ps.backoff = True
                    self._m_repl_stalls.inc()
                self.next_index[peer] = new_next
        finally:
            if event is not None:
                event.set()  # wake the driver: pump more / resume rewind

    def _refresh_repl_gauges(self) -> None:
        self._m_repl_inflight_windows.set(
            sum(ps.inflight_windows for ps in self._peer_streams.values()))
        self._m_repl_inflight_entries.set(
            sum(ps.inflight_entries for ps in self._peer_streams.values()))

    # -- snapshot-install streaming (leader side) ----------------------

    async def _install_to_peer(self, peer: Address, conn: Connection,
                               ps: _PeerStream | None = None) -> bool:
        """Stream the newest snapshot to a follower whose ``next_index``
        fell behind the prefix-truncated log, then point the append
        stream just past the snapshot.  Chunks ride the connection's
        correlated multiplexing — up to the pipeline depth in flight
        (one at a time on the stop-and-wait lane) with each ack feeding
        the stream's AIMD/EWMA accounting.  Any failed or refused chunk
        aborts the attempt; the driver loop retries from scratch on its
        next beat (installs are rare and whole-retry keeps the follower
        assembly state trivial)."""
        snap = (self._snapshots.newest()
                if self._snap_enabled and self._snapshots is not None
                else None)
        if snap is None:
            # a prefix-truncated log with no readable snapshot cannot
            # serve this follower at all — operator-level damage
            logger.error("%s: follower %s needs entries <= %d but no "
                         "valid snapshot exists", self.name, peer,
                         self.log.prefix_index)
            self._m_snap_install_fail.inc()
            await asyncio.sleep(self.heartbeat_interval)
            return False
        index, payload = snap
        # boundary-term lookup without re-decoding the (possibly large)
        # payload on every attempt: cached per snapshot index
        cached = self._install_term_cache
        if cached is not None and cached[0] == index:
            snap_term = cached[1]
        else:
            try:
                snap_term = self._snap_serializer.read(payload)["term"]
            except Exception:  # noqa: BLE001 - corrupt-but-CRC-valid payload
                logger.exception("%s: snapshot %d undecodable", self.name,
                                 index)
                self._m_snap_install_fail.inc()
                await asyncio.sleep(self.heartbeat_interval)
                return False
            self._install_term_cache = (index, snap_term)
        term = self.term
        total = len(payload)
        chunk = self._snap_chunk
        sem = asyncio.Semaphore(self._repl_depth if ps is not None else 1)
        failed = False

        async def send_chunk(offset: int) -> None:
            nonlocal failed
            async with sem:
                if failed or self.role != LEADER or self._closing:
                    failed = True
                    return
                t0 = time.perf_counter()
                try:
                    response = await asyncio.wait_for(
                        conn.send(msg.InstallRequest(
                            term=term, leader=self.address, index=index,
                            snap_term=snap_term, total=total, offset=offset,
                            data=payload[offset:offset + chunk], done=False,
                            group=self.wire_group)),
                        self.election_timeout)
                except (TransportError, OSError, asyncio.TimeoutError):
                    failed = True
                    return
                if response.term is not None and response.term > self.term:
                    self._become_follower(response.term, None)
                    failed = True
                    return
                if not response.success:
                    failed = True
                    return
                self._m_snap_chunks_sent.inc()
                self._last_quorum_contact[peer] = time.monotonic()
                if ps is not None:
                    ps.observe_ack((time.perf_counter() - t0) * 1e3)

        await asyncio.gather(
            *(send_chunk(o) for o in range(0, total, chunk)))
        if not failed and self.role == LEADER and not self._closing:
            # final frame: the follower assembles, CRC-persists, restores
            try:
                response = await asyncio.wait_for(
                    conn.send(msg.InstallRequest(
                        term=term, leader=self.address, index=index,
                        snap_term=snap_term, total=total, offset=total,
                        data=b"", done=True, group=self.wire_group)),
                    self.election_timeout * 4)
            except (TransportError, OSError, asyncio.TimeoutError):
                failed = True
            else:
                if response.term is not None and response.term > self.term:
                    self._become_follower(response.term, None)
                    failed = True
                elif not response.success:
                    failed = True
        if failed or self.role != LEADER:
            self._m_snap_install_fail.inc()
            if ps is not None:
                ps.backoff = True
            else:
                await asyncio.sleep(self.heartbeat_interval)
            return False
        self._m_snap_installs_sent.inc()
        self._last_quorum_contact[peer] = time.monotonic()
        if index > self.match_index.get(peer, 0):
            self.match_index[peer] = index
        self.next_index[peer] = max(self.next_index.get(peer, 1), index + 1)
        logger.info("%s installed snapshot %d on %s (%d bytes)", self.name,
                    index, peer, total)
        self._advance_commit()
        return True

    def _advance_commit(self) -> None:
        if self.role != LEADER:
            return
        matches = sorted(
            [self.log.last_index]
            + [self.match_index.get(p, 0) for p in self.peers],
            reverse=True)
        candidate = matches[self.quorum - 1]
        if candidate > self.commit_index \
                and self.log.term_at(candidate) == self.term:
            if self._strict_invariants:
                # COPYCAT_INVARIANTS=strict: re-verify from first
                # principles that a REAL quorum matches the candidate —
                # the tripwire proving pipelined (out-of-order) acks can
                # never advance commit past actual replication. The raise
                # may land inside a spawned ack task (logged, not fatal),
                # so the violation ALSO counts on the registry — the
                # strict nemesis suite asserts the counter stayed 0.
                support = 1 + sum(1 for p in self.peers
                                  if self.match_index.get(p, 0) >= candidate)
                if support < self.quorum or candidate > self.log.last_index:
                    self.metrics.counter("repl.invariant_violations").inc()
                    logger.critical(
                        "commit invariant violated: candidate %d supported "
                        "by %d/%d (quorum %d, last %d)", candidate, support,
                        len(self.members), self.quorum, self.log.last_index)
                    raise AssertionError(
                        f"commit invariant violated: candidate {candidate} "
                        f"supported by {support}/{len(self.members)} "
                        f"(quorum {self.quorum}, last {self.log.last_index})")
            self.commit_index = candidate
            hit: list[int] = []
            if self._trace_watch:
                # traced entries the quorum just covered: close their
                # quorum.wait span here — the instant commit advanced —
                # and remember the commit instant so the awaiting
                # coroutine can attribute the apply phase separately
                now = time.perf_counter()
                for index in [i for i in self._trace_watch
                              if i <= candidate]:
                    trace, t_append = self._trace_watch.pop(index)
                    self._trace_span(trace, "quorum.wait", t_append, now,
                                     self._m_lat_quorum, index=index)
                    self._trace_commit_t[trace] = now
                    hit.append(trace)
            if self._fsync_on_commit:
                if hit:
                    t_s = time.perf_counter()
                    self.log.sync()
                    t_e = time.perf_counter()
                    if self.server._health_enabled:
                        self._note_fsync((t_e - t_s) * 1e3)
                    for trace in hit:
                        self._trace_span(trace, "group.fsync", t_s, t_e,
                                         self._m_lat_fsync)
                        self._trace_commit_t[trace] = t_e
                else:
                    self._sync_log()  # commit boundary: ack = durable
            self._apply_up_to(self.commit_index)
        # global index: minimum replicated position across all members
        if self.peers:
            self.global_index = min(
                [self.log.last_index]
                + [self.match_index.get(p, 0) for p in self.peers])
        else:
            self.global_index = self.last_applied
        if self._trace_window_marks:
            # every member holds entries <= global_index: no future
            # window will carry them, the stamps can go
            for i in [i for i in self._trace_window_marks
                      if i <= self.global_index]:
                del self._trace_window_marks[i]
        if self.log.cleaned_count > 0:
            self.log.compact(min(self.global_index, self.last_applied))

    # -- leader maintenance: clocks, session expiry --------------------

    def _leader_maintenance(self) -> None:
        if self.role != LEADER or self._closing:
            return
        now_wall = time.time()
        # Advance the deterministic clock when state-machine timers are due.
        deadline = self.executor.next_deadline()
        if deadline is not None and deadline <= now_wall:
            self._append(NoOpEntry())
        # Expire sessions that missed keep-alives (leader wall-clock
        # detector; expiry itself is replicated + deterministic via
        # UnregisterEntry). Each group judges its own replicas: keep-alives
        # fan out to every group, so contacts stay fresh cluster-wide for
        # a live client and every group expires within one timeout of a
        # dead one.
        now = time.monotonic()
        for session in list(self.sessions.values()):
            if session.state is not SessionState.OPEN \
                    or session.id in self._expiring_sessions:
                continue
            last = session.last_contact
            if last and now - last > session.timeout:
                self._expiring_sessions.add(session.id)
                self._append(UnregisterEntry(session_id=session.id,
                                             expired=True))

    def _lease_valid(self) -> bool:
        """True if a quorum acked within the last election timeout (read
        lease)."""
        if len(self.members) == 1:
            return True
        now = time.monotonic()
        fresh = 1 + sum(
            1 for p in self.peers
            if now - self._last_quorum_contact.get(p, 0.0)
            < self.election_timeout)
        return fresh >= self.quorum

    def _confirm_leadership_hook(self):
        """Single-group: route through the server attribute so tests and
        embedders patching ``server._confirm_leadership`` (the classic
        surface) still intercept the gate; the unpatched server delegates
        straight back here."""
        if self.server.single:
            return self.server._confirm_leadership()
        return self._confirm_leadership()

    async def _confirm_leadership(self) -> bool:
        """Full linearizability barrier: round-trip a heartbeat to a
        quorum."""
        if len(self.members) == 1:
            return True
        term = self.term

        async def ping(peer: Address) -> bool:
            conn = await self._peer_connection(peer)
            if conn is None:
                return False
            try:
                response = await asyncio.wait_for(
                    conn.send(msg.AppendRequest(
                        term=term, leader=self.address,
                        prev_index=self.log.last_index,
                        prev_term=self.log.term_at(self.log.last_index),
                        entries=[], commit_index=self.commit_index,
                        group=self.wire_group)),
                    self.election_timeout)
            except (TransportError, OSError, asyncio.TimeoutError):
                return False
            if response.term is not None and response.term > self.term:
                self._become_follower(response.term, None)
                return False
            if response.success:
                self._last_quorum_contact[peer] = time.monotonic()
            return bool(response.success)

        results = await asyncio.gather(*(ping(p) for p in self.peers))
        return (self.role == LEADER and self.term == term
                and 1 + sum(results) >= self.quorum)

    # ------------------------------------------------------------------
    # RPC handlers: raft (requests pre-routed to this group by the
    # server's dispatch on ``request.group``)
    # ------------------------------------------------------------------

    async def _on_vote(self, request: msg.VoteRequest) -> msg.VoteResponse:
        if request.term > self.term:
            # Adopt the term but keep a running election timer: only a
            # granted vote (below) restarts it. A candidate whose log is
            # behind (a member restarted from an old log) would otherwise
            # restart the up-to-date members' timers on every campaign,
            # and as the group's rank-0 member it always times out first:
            # the group would never elect. A deposed leader has no timer
            # running and gets a fresh one.
            self._become_follower(request.term, None,
                                  reset_timer=self.role == LEADER)
        if request.term < self.term:
            return msg.VoteResponse(term=self.term, voted=False)
        up_to_date = (request.last_log_term, request.last_log_index) >= (
            self.log.term_at(self.log.last_index), self.log.last_index)
        if self.voted_for in (None, request.candidate) and up_to_date:
            self.voted_for = request.candidate
            self._persist_meta()
            self._reset_election_timer()
            return msg.VoteResponse(term=self.term, voted=True)
        return msg.VoteResponse(term=self.term, voted=False)

    async def _on_append(self, request: msg.AppendRequest
                         ) -> msg.AppendResponse:
        if request.term < self.term:
            # rejected before recording: appends from deposed leaders must
            # not pollute the append-size histogram / heartbeat counter
            return msg.AppendResponse(term=self.term, success=False,
                                      last_index=self.log.last_index)
        trace_mark = request.trace  # (trace id, traced entry index)
        if type(trace_mark) is not tuple or len(trace_mark) != 2:
            trace_mark = None  # malformed peer payload: ignore, don't die
        trace = trace_mark[0] if trace_mark is not None else None
        t_trace = time.perf_counter() if trace is not None else 0.0
        if request.entries:
            self._m_append_entries.record(len(request.entries))
        else:
            self._m_heartbeats.inc()
        if request.term > self.term or self.role != FOLLOWER:
            self._become_follower(request.term, request.leader)
        else:
            self.leader_address = request.leader
            self._reset_election_timer()

        prev_index = request.prev_index or 0
        if prev_index > 0:
            if prev_index > self.log.last_index:
                return msg.AppendResponse(term=self.term, success=False,
                                          last_index=self.log.last_index)
            local_term = self.log.term_at(prev_index)
            # A term of 0 on either side means "unknown" (slot compacted or
            # gap-filled cluster-wide) — log matching cannot check it;
            # accept.
            if local_term != 0 and (request.prev_term or 0) != 0 \
                    and local_term != request.prev_term \
                    and prev_index > self.last_applied:
                self.log.truncate(prev_index)
                return msg.AppendResponse(term=self.term, success=False,
                                          last_index=self.log.last_index)

        # Block ingest: one conflict scan over the window's prefix that
        # overlaps the local log (skip matches, truncate at the first
        # term conflict, fill compacted slots), then ONE
        # append_replicated_block for the entire new tail — instead of a
        # per-entry get/append_replicated walk (a pipelined leader
        # delivers windows of hundreds of entries back to back, and the
        # per-entry walk was the follower's hottest loop).
        entries = request.entries or []
        log = self.log
        append_from: int | None = None
        for k, entry in enumerate(entries):
            if entry.index > log.last_index:
                append_from = k
                break
            existing = log.get(entry.index)
            if existing is not None:
                if existing.term != entry.term:
                    log.truncate(entry.index)
                    append_from = k
                    break
            elif entry.index > self.last_applied:
                log.set_slot(entry)
        if append_from is not None:
            log.append_replicated_block(entries[append_from:])
            if self._fsync_on_commit:
                # the success ack below is what the leader counts toward
                # quorum commit: it must not rest on page-cache-only
                # bytes, or a cluster-wide power loss could erase an
                # acknowledged commit (a quorum of un-fsynced ackers
                # reboots without the entry and re-elects among
                # themselves) — sync BEFORE acking, per append window
                self._sync_log()

        fill_to = request.fill_to or 0
        if fill_to > self.log.last_index:
            self.log.fill_gap(fill_to)

        if trace is not None and trace_mark[1] > self.last_applied:
            # the window was ACCEPTED (every reject path returned above):
            # mark the traced entry so that, if this member holds the
            # client's connection, its apply attributes the event push —
            # marking before acceptance would let a rejected window's
            # stale mark mis-attribute a different entry later
            self._trace_entry_marks[trace_mark[1]] = trace

        commit = min(request.commit_index or 0, self.log.last_index)
        if commit > self.commit_index:
            self.commit_index = commit
            if self._fsync_on_commit:
                self._sync_log()  # commit boundary: acknowledged = durable
            self._apply_up_to(commit)
        global_index = getattr(request, "global_index", None)
        if global_index:
            self.log.compact(min(global_index, self.last_applied))
        if trace is not None:
            # the window carried a traced entry: this member's ingest
            # (conflict scan + block append + fsync + commit advance) on
            # the originating causal timeline
            self._trace_span(trace, "follower.append", t_trace,
                             time.perf_counter(), self._m_lat_follower,
                             n=len(entries))
        return msg.AppendResponse(term=self.term, success=True,
                                  last_index=self.log.last_index)

    async def _on_install(self, request: msg.InstallRequest
                          ) -> msg.InstallResponse:
        """Follower side of snapshot-install streaming: buffer chunks by
        offset, and on the final frame assemble, persist (atomic +
        CRC-framed, via the local snapshot store when one exists), restore
        the image, and restart the log just past it."""
        if request.term < self.term:
            return msg.InstallResponse(term=self.term, success=False)
        if not self._snap_enabled:
            # COPYCAT_SNAPSHOTS=0 pins this server to the replay-only
            # lane; a mixed-knob cluster surfaces loudly instead of
            # half-restoring
            return msg.InstallResponse(
                term=self.term, success=False, error=msg.INTERNAL,
                error_detail="snapshots disabled on this member")
        if request.term > self.term or self.role != FOLLOWER:
            self._become_follower(request.term, request.leader)
        else:
            self.leader_address = request.leader
            self._reset_election_timer()
        if request.index <= self.last_applied:
            # stale install (we caught up some other way): ack so the
            # leader's cursor advances past it
            return msg.InstallResponse(term=self.term, success=True,
                                       last_index=self.log.last_index)
        buf = self._installing
        if buf is None or buf["index"] != request.index:
            buf = self._installing = {"index": request.index,
                                      "term": request.snap_term,
                                      "total": request.total, "chunks": {}}
        if request.data:
            buf["chunks"][request.offset] = request.data
            self._m_snap_chunks_recv.inc()
        if not request.done:
            return msg.InstallResponse(term=self.term, success=True,
                                       offset=request.offset)
        # final frame: verify the byte range is contiguous and complete
        parts = sorted(buf["chunks"].items())
        pos = 0
        for offset, data in parts:
            if offset != pos:
                break
            pos = offset + len(data)
        if pos != buf["total"]:
            self._installing = None  # whole-retry contract (leader side)
            return msg.InstallResponse(term=self.term, success=False,
                                       offset=pos)
        payload_bytes = b"".join(data for _, data in parts)
        self._installing = None
        try:
            payload = self._snap_serializer.read(payload_bytes)
            if self._snapshots is not None:
                self._snapshots.save(request.index, payload_bytes)
                self._snapshots.gc(keep=2)
            self._restore_snapshot(payload)
        except Exception as e:  # noqa: BLE001 - refuse, don't die
            logger.exception("%s: snapshot install at %d failed",
                             self.name, request.index)
            self._flight_note("install_failed", index=request.index)
            self._m_snap_install_fail.inc()
            return msg.InstallResponse(term=self.term, success=False,
                                       error=msg.INTERNAL,
                                       error_detail=str(e))
        self._m_snap_installs_recv.inc()
        self._flight_note("snapshot_installed", index=request.index)
        logger.info("%s restored installed snapshot at %d", self.name,
                    request.index)
        return msg.InstallResponse(term=self.term, success=True,
                                   last_index=self.log.last_index)

    # ------------------------------------------------------------------
    # RPC handlers: session protocol (legacy single-group entry points —
    # the server delegates straight here when ``groups == 1``; the
    # multi-group ingress uses the *_local / command_block / serve_query
    # staging methods below instead)
    # ------------------------------------------------------------------

    def _not_leader(self, response_type: type) -> Any:
        return response_type(
            error=msg.NOT_LEADER if self.leader_address else msg.NO_LEADER,
            leader=self.leader_address)

    def _session_missing(self, response_type: type) -> Any:
        """The answer of a leader that holds no open session under the
        id asked for. A member restarted from its log replays only what
        it commits, so until this leader has applied through its term's
        first entry a session its log registers may not be in its table
        yet: it answers as a member not yet leader, and the caller
        retries. After that the session is unknown, and expired."""
        if self.last_applied < self._term_start:
            return self._not_leader(response_type)
        return response_type(error=msg.UNKNOWN_SESSION)

    async def _on_register(self, connection: Connection,
                           request: msg.RegisterRequest
                           ) -> msg.RegisterResponse:
        if self.role != LEADER:
            response = self._not_leader(msg.RegisterResponse)
            response.members = self.members
            return response
        timeout = request.timeout or self.session_timeout
        try:
            index, sid, _ = await self._append_and_wait(
                RegisterEntry(client_id=request.client_id, timeout=timeout))
        except msg.ProtocolError as e:
            return msg.RegisterResponse(error=e.code, leader=e.leader,
                                        members=self.members)
        session = self.sessions.get(sid)
        if session is not None:
            session.connection = connection
            session.last_contact = time.monotonic()
        return msg.RegisterResponse(session_id=sid, timeout=timeout,
                                    members=self.members,
                                    groups=self.server.num_groups)

    async def _on_keepalive(self, connection: Connection,
                            request: msg.KeepAliveRequest
                            ) -> msg.KeepAliveResponse:
        if self.role != LEADER:
            response = self._not_leader(msg.KeepAliveResponse)
            response.members = self.members
            return response
        session = self.sessions.get(request.session_id)
        if session is None or session.state is not SessionState.OPEN:
            response = self._session_missing(msg.KeepAliveResponse)
            response.members = self.members
            return response
        session.connection = connection
        session.last_contact = time.monotonic()
        if getattr(request, "unsubscribe", None):
            # member-local edge bookkeeping (docs/EDGE_READS.md): the
            # client's LRU evictions ride the keep-alive, never the log
            self.edge_unsubscribe(request.session_id, request.unsubscribe)
        t0 = time.perf_counter()
        try:
            await self._append_and_wait(KeepAliveEntry(
                session_id=request.session_id,
                command_seq=request.command_seq or 0,
                event_index=request.event_index or 0))
        except msg.ProtocolError as e:
            return msg.KeepAliveResponse(error=e.code, leader=e.leader,
                                         members=self.members)
        self._m_keepalive_ms.record((time.perf_counter() - t0) * 1e3)
        # Resend any event batches the client is missing.
        self._flush_events(session)
        return msg.KeepAliveResponse(members=self.members)

    async def _on_unregister(self, request: msg.UnregisterRequest
                             ) -> msg.UnregisterResponse:
        if self.role != LEADER:
            return self._not_leader(msg.UnregisterResponse)
        if request.session_id in self.sessions:
            try:
                await self._append_and_wait(
                    UnregisterEntry(session_id=request.session_id,
                                    expired=False))
            except msg.ProtocolError as e:
                return msg.UnregisterResponse(error=e.code, leader=e.leader)
        return msg.UnregisterResponse()

    async def _on_command(self, connection: Connection,
                          request: msg.CommandRequest) -> msg.CommandResponse:
        if self.role != LEADER:
            return self._not_leader(msg.CommandResponse)
        session = self.sessions.get(request.session_id)
        if session is None or session.state is not SessionState.OPEN:
            return self._session_missing(msg.CommandResponse)
        session.connection = connection
        session.last_contact = time.monotonic()
        seq = request.seq
        self._m_single_lane.inc()
        trace = request.trace
        t0 = time.perf_counter() if trace is not None else 0.0

        staged, payload = self._stage_command(session, seq, request.operation)
        if staged == "done":
            index, result, error = payload
            if trace is not None:
                self._trace_span(trace, "group.cached", t0,
                                 time.perf_counter(), seq=seq)
            return self._command_response(session, index, result, error)
        if staged == "err":
            code, detail = payload
            return msg.CommandResponse(error=code, error_detail=detail)
        fut = payload
        if trace is not None:
            t1 = time.perf_counter()
            self._trace_span(trace, "group.append", t0, t1,
                             self._m_lat_append, seq=seq)
        try:
            index, result, error = await fut
        except msg.ProtocolError as e:
            return msg.CommandResponse(error=e.code, leader=e.leader)
        finally:
            if session.command_futures.get(seq) is fut:
                del session.command_futures[seq]
        if trace is not None:
            # coarse commit span (append -> commit+apply): the per-seq
            # lane stages through futures whose log index is unknown
            # here, so the quorum/apply split rides the block lanes
            self._trace_span(trace, "group.commit", t1,
                             time.perf_counter(), self._m_lat_commit,
                             index=index)
        return self._command_response(session, index, result, error)

    def _stage_command(self, session: ServerSession, seq: int,
                       operation: Any) -> tuple[str, Any]:
        """Dedup/enqueue one sequenced command; returns
        ``("done", (index, result, error))`` for a cache hit,
        ``("err", (code, detail))`` for a pruned duplicate, or
        ``("wait", future)`` once the command rides the log."""
        # Exactly-once: already applied -> cached response.
        cached = session.cached_response(seq)
        if cached is not None:
            return "done", cached
        if seq <= session.command_high:
            return "err", (msg.INTERNAL,
                           f"response for seq {seq} already pruned")
        # Already in flight (resubmission) -> share the future.
        fut = session.command_futures.get(seq)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            session.command_futures[seq] = fut
            # Append in client seq order: concurrent submits can arrive
            # reordered (independent RPCs over reconnects); applying seq N
            # after N+1 would silently drop the write.
            if session.next_append_seq == 0:
                session.next_append_seq = session.command_high + 1
            if seq < session.next_append_seq:
                # already appended (a fast-lane block or earlier stage
                # still in flight): apply resolves the future from the
                # log; parking it in pending_ops would strand it there
                # forever (the drain walk never revisits passed seqs)
                # and re-appending would double-apply
                return "wait", fut
            session.pending_ops[seq] = operation
            while session.next_append_seq in session.pending_ops:
                next_seq = session.next_append_seq
                session.next_append_seq += 1
                self._append(CommandEntry(
                    session_id=session.id, seq=next_seq,
                    operation=session.pending_ops.pop(next_seq)))
        return "wait", fut

    async def _on_command_batch(self, connection: Connection,
                                request: msg.CommandBatchRequest
                                ) -> msg.CommandBatchResponse:
        """Micro-batched commands: stage EVERY entry first (one append
        burst → one apply window on the device executor), then await the
        outcomes in seq order. Per-entry results/errors travel in the
        response's ``entries``; session-fatal conditions ride the
        response-level error like the single-command path."""
        if self.role != LEADER:
            return self._not_leader(msg.CommandBatchResponse)
        session = self.sessions.get(request.session_id)
        if session is None or session.state is not SessionState.OPEN:
            return self._session_missing(msg.CommandBatchResponse)
        session.connection = connection
        session.last_contact = time.monotonic()
        entries = request.entries or []
        trace = request.trace
        t0 = time.perf_counter() if trace is not None else 0.0
        # FAST LANE: a fresh contiguous seq run with nothing pending
        # stages as one append block behind ONE commit future — no
        # per-seq futures, no per-entry dedup dict walks; responses read
        # back from the session's (replicated) response cache. Anything
        # irregular — duplicates, seq gaps, ops already in flight — takes
        # the general per-entry staging below, which shares futures and
        # serves cached responses (exactly-once unchanged).
        n = len(entries)
        if (n and not session.pending_ops and not session.command_futures
                and entries[0][0] == session.command_high + 1
                and session.next_append_seq in (0, entries[0][0])
                # contiguity at C speed: a listcomp + range compare beats
                # the per-entry Python walk on 1k-op batches
                and [e[0] for e in entries]
                == list(range(entries[0][0], entries[0][0] + n))):
            self._m_fast_lane.inc(n)
            return await self._command_batch_fast(session, entries, trace, t0)
        self._m_general_lane.inc(n)
        staged = [(seq, *self._stage_command(session, seq, op))
                  for seq, op in entries]
        if trace is not None:
            t1 = time.perf_counter()
            self._trace_span(trace, "group.append", t0, t1,
                             self._m_lat_append, n=n)
        entries = []
        for seq, kind, payload in staged:
            if kind == "done":
                index, result, error = payload
                entries.append((seq, index, result,
                                msg.APPLICATION if error else None, error))
            elif kind == "err":
                code, detail = payload
                entries.append((seq, 0, None, code, detail))
            else:
                fut = payload
                try:
                    index, result, error = await fut
                    entries.append((seq, index, result,
                                    msg.APPLICATION if error else None,
                                    error))
                except msg.ProtocolError as e:
                    if e.code in (msg.NOT_LEADER, msg.NO_LEADER):
                        # promote routing failures to the RESPONSE level:
                        # the client's _request retry loop re-routes and
                        # resends the whole batch (seq dedup makes the
                        # resend exactly-once), matching the
                        # single-command path's transparent failover
                        return msg.CommandBatchResponse(
                            error=e.code, leader=e.leader,
                            error_detail=e.detail)
                    entries.append((seq, 0, None, e.code, e.detail))
                finally:
                    if session.command_futures.get(seq) is fut:
                        del session.command_futures[seq]
        if trace is not None:
            self._trace_span(trace, "group.commit", t1,
                             time.perf_counter(), self._m_lat_commit, n=n)
        return msg.CommandBatchResponse(event_index=session.event_index,
                                        entries=entries)

    async def _command_batch_fast(self, session: ServerSession,
                                  entries: list, trace: int | None = None,
                                  t0: float = 0.0
                                  ) -> msg.CommandBatchResponse:
        """Stage a fresh contiguous command run as one append block.

        Inlines ``_append``'s per-entry tail (term/timestamp stamp + log
        append) and pays replication signalling and the single-member
        deferred commit advance ONCE for the block. The await is a single
        commit future on the block's LAST index: every earlier entry
        applies first (in-order apply), so when it resolves the whole
        run's responses are in the session cache."""
        term = self.term
        sid = session.id
        now = time.time()
        index = self.log.append_block(
            [CommandEntry(term, now, sid, seq, op) for seq, op in entries])
        self._m_append_block.record(len(entries))
        session.next_append_seq = entries[0][0] + len(entries)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._commit_futures[index] = fut
        self._signal_replication()
        if len(self.members) == 1 and not self._advance_scheduled:
            self._advance_scheduled = True
            asyncio.get_running_loop().call_soon(self._advance_deferred)
        if trace is not None:
            t1 = time.perf_counter()
            self._trace_span(trace, "group.append", t0, t1,
                             self._m_lat_append, index=index,
                             n=len(entries))
            # quorum.wait / group.fsync close in _advance_commit the
            # instant the commit boundary covers this block; the apply
            # loop stamps event pushes via the per-index marks
            self._trace_watch[index] = (trace, t1)
            self._trace_window_marks[index] = trace
            for i in range(index - len(entries) + 1, index + 1):
                self._trace_entry_marks[i] = trace
        try:
            await fut
        except msg.ProtocolError as e:
            if trace is not None:
                self._trace_watch.pop(index, None)
                self._trace_commit_t.pop(trace, None)
                for i in range(index - len(entries) + 1, index + 1):
                    self._trace_entry_marks.pop(i, None)
            if e.code in (msg.NOT_LEADER, msg.NO_LEADER):
                # same promotion as the general path: the client's
                # _request loop re-routes and resends the whole batch
                # (server-side seq dedup makes the resend exactly-once)
                return msg.CommandBatchResponse(
                    error=e.code, leader=e.leader, error_detail=e.detail)
            return msg.CommandBatchResponse(
                event_index=session.event_index,
                entries=[(seq, 0, None, e.code, e.detail)
                         for seq, _ in entries])
        if trace is not None:
            t2 = time.perf_counter()
            t_commit = self._trace_commit_t.pop(trace, t1)
            self._trace_span(trace, "apply", t_commit, t2,
                             self._m_lat_apply, index=index)
        if self._event_pushes:
            # Events-before-response (reference Consistency.java:157-176):
            # the general path gates each LINEARIZABLE response on its
            # apply's event-push acks inside _complete_command; this lane
            # has no per-seq futures, so gate the block response on the
            # pushes outstanding at commit — a superset of the ones this
            # block's applies spawned — under the same 1 s cap. Empty in
            # the listener-free steady state, so the fast path pays one
            # set check.
            t_push = time.perf_counter() if trace is not None else 0.0
            try:
                await asyncio.wait_for(
                    asyncio.gather(*list(self._event_pushes),
                                   return_exceptions=True), 1.0)
            except asyncio.TimeoutError:
                pass
            if trace is not None:
                self._trace_span(trace, "event.push", t_push,
                                 time.perf_counter(),
                                 self._m_lat_event_push)
        responses = session.responses
        out = []
        for seq, _ in entries:
            cached = responses.get(seq)
            if cached is None:
                # applied without caching: the session died mid-block
                out.append((seq, 0, None, msg.UNKNOWN_SESSION,
                            "session expired before apply"))
            else:
                idx, result, error = cached
                out.append((seq, idx, result,
                            msg.APPLICATION if error else None, error))
        if trace is not None:
            t3 = time.perf_counter()
            self._trace_span(trace, "respond", t2, t3, self._m_lat_respond)
            # stale per-entry marks (entries the vector lane applied or
            # a session death skipped) must not leak
            for i in range(index - len(entries) + 1, index + 1):
                self._trace_entry_marks.pop(i, None)
            self._trace_note_slow(trace, t0, t3)
        return msg.CommandBatchResponse(event_index=session.event_index,
                                        entries=out)

    def _command_response(self, session: ServerSession, index: int,
                          result: Any,
                          error: str | None) -> msg.CommandResponse:
        if error:
            return msg.CommandResponse(error=msg.APPLICATION,
                                       error_detail=error, index=index,
                                       event_index=session.event_index)
        return msg.CommandResponse(index=index, result=result,
                                   event_index=session.event_index)

    # ------------------------------------------------------------------
    # multi-group staging entry points (docs/SHARDING.md): the ingress —
    # local demux or the proxy handler at this group's leader — speaks
    # these instead of the legacy handlers. They accept the GAPPED
    # per-group seq subsequences hash routing produces: delivery order
    # per (session, group) is serialized by the ingress's proxy chain,
    # so appending in arrival order preserves the client's seq order.
    # ------------------------------------------------------------------

    def register_local(self, client_id: str, timeout: float,
                       session_id: int | None = None):
        """Append one RegisterEntry (optionally with a pre-assigned
        global session id — the fan-out from the id-allocating group 0);
        resolves to ``(index, sid, error)``."""
        return self._append_and_wait(
            RegisterEntry(client_id=client_id, timeout=timeout,
                          session_id=session_id))

    def keepalive_local(self, session_id: int, command_seq: int,
                        event_index: int):
        """Append one KeepAliveEntry for this group's session replica
        (``event_index`` is this GROUP's event channel position)."""
        session = self.sessions.get(session_id)
        if session is not None:
            session.last_contact = time.monotonic()
        return self._append_and_wait(KeepAliveEntry(
            session_id=session_id, command_seq=command_seq,
            event_index=event_index))

    def unregister_local(self, session_id: int):
        return self._append_and_wait(
            UnregisterEntry(session_id=session_id, expired=False))

    async def command_block(self, session_id: int, entries: list,
                            trace: int | None = None
                            ) -> tuple[list | None, tuple | None]:
        """Stage one routed (possibly gapped) command sub-block on this
        group's leader; returns ``(per_entry_outcomes, None)`` or
        ``(None, (code, detail, leader))`` for a response-level failure.
        ``trace`` is the originating trace id from the ingress (carried
        by ProxyRequest when proxied): the full per-phase decomposition
        — group.append / quorum.wait / group.fsync / apply / respond —
        records under it on THIS member.

        The dedup walk mirrors ``_stage_command`` minus the dense-seq
        parking: seqs the routing assigned to OTHER groups never arrive
        here, so "the gap will fill" never holds — instead, in-order
        delivery per (session, group) is the ingress's proxy-chain
        contract, and anything below the appended high-water that is not
        cached or in flight is a duplicate."""
        t0 = time.perf_counter() if trace is not None else 0.0
        if self.role != LEADER:
            return None, (msg.NOT_LEADER if self.leader_address
                          else msg.NO_LEADER, "", self.leader_address)
        session = self.sessions.get(session_id)
        if session is None or session.state is not SessionState.OPEN:
            missing = self._session_missing(msg.ProxyResponse)
            return None, (missing.error, "", missing.leader)
        session.last_contact = time.monotonic()
        if session.next_append_seq == 0:
            session.next_append_seq = session.command_high + 1
        done: dict[int, tuple] = {}      # seq -> (index, result, error)
        errs: dict[int, tuple] = {}      # seq -> (code, detail)
        waits: dict[int, asyncio.Future] = {}
        fresh: list = []
        for seq, op in entries:
            cached = session.cached_response(seq)
            if cached is not None:
                done[seq] = cached
            elif seq in session.command_futures:
                waits[seq] = session.command_futures[seq]
            elif seq >= session.next_append_seq:
                fresh.append((seq, op))
            elif session.last_block_future is not None \
                    and not session.last_block_future.done():
                # appended by an earlier block still in flight (a client
                # resend racing its first attempt): ride that block's
                # commit and read the cache afterwards
                waits[seq] = None
            else:
                errs[seq] = (msg.INTERNAL,
                             f"response for seq {seq} already pruned")
        self._m_fast_lane.inc(len(fresh))
        block_fut: asyncio.Future | None = None
        index = 0
        t1 = t0
        if fresh:
            term = self.term
            now = time.time()
            index = self.log.append_block(
                [CommandEntry(term, now, session_id, seq, op)
                 for seq, op in fresh])
            self._m_append_block.record(len(fresh))
            session.next_append_seq = fresh[-1][0] + 1
            block_fut = asyncio.get_running_loop().create_future()
            self._commit_futures[index] = block_fut
            session.last_block_future = block_fut
            self._signal_replication()
            if len(self.members) == 1 and not self._advance_scheduled:
                self._advance_scheduled = True
                asyncio.get_running_loop().call_soon(self._advance_deferred)
            if trace is not None:
                t1 = time.perf_counter()
                self._trace_span(trace, "group.append", t0, t1,
                                 self._m_lat_append, index=index,
                                 n=len(fresh))
                self._trace_watch[index] = (trace, t1)
                self._trace_window_marks[index] = trace
                for i in range(index - len(fresh) + 1, index + 1):
                    self._trace_entry_marks[i] = trace
        pending = session.last_block_future
        try:
            if block_fut is not None:
                await block_fut
            elif waits and pending is not None and not pending.done():
                await asyncio.shield(pending)
            for seq, fut in waits.items():
                if fut is not None:
                    await fut
        except msg.ProtocolError as e:
            if trace is not None and fresh:
                self._trace_watch.pop(index, None)
                self._trace_commit_t.pop(trace, None)
                for i in range(index - len(fresh) + 1, index + 1):
                    self._trace_entry_marks.pop(i, None)
            return None, (e.code, e.detail, e.leader)
        t2 = 0.0
        if trace is not None:
            t2 = time.perf_counter()
            if fresh:
                t_commit = self._trace_commit_t.pop(trace, t1)
                self._trace_span(trace, "apply", t_commit, t2,
                                 self._m_lat_apply, index=index)
            else:
                # nothing appended (pure dedup/in-flight waits): the
                # coarse commit span is all there is to attribute
                self._trace_span(trace, "group.commit", t0, t2,
                                 self._m_lat_commit)
        responses = session.responses
        out = []
        for seq, _ in entries:
            if seq in errs:
                code, detail = errs[seq]
                out.append((seq, 0, None, code, detail))
                continue
            cached = done.get(seq) or responses.get(seq)
            if cached is None:
                out.append((seq, 0, None, msg.UNKNOWN_SESSION,
                            "session expired before apply"))
            else:
                idx, result, error = cached
                out.append((seq, idx, result,
                            msg.APPLICATION if error else None, error))
        if trace is not None:
            t3 = time.perf_counter()
            self._trace_span(trace, "respond", t2, t3, self._m_lat_respond)
            if fresh:
                for i in range(index - len(fresh) + 1, index + 1):
                    self._trace_entry_marks.pop(i, None)
            self._trace_note_slow(trace, t0, t3)
        return out, None

    async def serve_query(self, session_id: int, client_index: int,
                          consistency: QueryConsistency, operations: list
                          ) -> tuple[int, list | None, tuple | None]:
        """Serve routed reads on this group (leader for linearizable
        levels, any member for sequential/causal): returns
        ``(served_index, entries, None)`` — entries positional
        ``(result, code, detail)`` — or ``(0, None, (code, detail,
        leader))`` for a request-level refusal."""
        self._m_query_level[consistency.value].inc(len(operations))
        if not self._read_pump:
            request = msg.QueryBatchRequest(
                session_id=session_id, index=client_index,
                consistency=consistency.value, operations=operations)
            response = await self._query_batch_direct(request, consistency)
            if response.error:
                return 0, None, (response.error, response.error_detail or "",
                                 getattr(response, "leader", None))
            return response.index or 0, response.entries, None
        self._m_query_ops.inc(len(operations))
        futs = [self._stage_read(consistency, session_id, client_index, op)
                for op in operations]
        outs = await asyncio.gather(*futs)
        entries = []
        index = 0
        for served_index, result, code, detail in outs:
            if code in (msg.NOT_LEADER, msg.NO_LEADER):
                return 0, None, (code, detail or "", self.leader_address)
            if code and code != msg.APPLICATION:
                return 0, None, (code, detail or "", None)
            entries.append((result, code, detail) if code
                           else (result, None, None))
            index = max(index, served_index)
        return index, entries, None

    # ------------------------------------------------------------------
    # queries: gate + read pump
    # ------------------------------------------------------------------

    async def _gate_query(self, consistency: QueryConsistency,
                          client_index: int) -> tuple[str, str] | None:
        """Consistency-dependent serving precondition; (code, detail) on
        refusal, None once this server may serve at ``last_applied``."""
        if consistency in (QueryConsistency.LINEARIZABLE,
                           QueryConsistency.BOUNDED_LINEARIZABLE):
            if self.role != LEADER:
                return (msg.NOT_LEADER, "")
            if consistency is QueryConsistency.LINEARIZABLE:
                if not await self._confirm_leadership_hook():
                    return (msg.NOT_LEADER, "")
            elif not self._lease_valid():
                if not await self._confirm_leadership_hook():
                    return (msg.NOT_LEADER, "")
            # Serve at the latest committed state.
            await self._wait_applied(self.commit_index)
        else:
            # SEQUENTIAL / CAUSAL: any server, at or after the client's
            # index.
            ok = await self._wait_applied(client_index or 0,
                                          timeout=self.election_timeout * 4)
            if not ok:
                return (msg.INTERNAL, "state lagging behind client index")
        # ``last_applied`` may cover vector rows parked in the server's
        # fused collector — the per-op read lanes behind this gate serve
        # at ``last_applied``, so those device effects must land first
        # (the read WINDOW flushes in ``run_query_window``; a free no-op
        # when nothing is staged)
        self.server.flush_fused()
        return None

    def _edge_seed_response(self, request: Any, response: Any,
                            operations: list) -> Any:
        """Answer a subscribing read (``request.subscribe``, the
        optional trailing field — docs/EDGE_READS.md): register the
        session's edge subscriptions and stamp the seed records onto
        the response's ``edge`` field. A no-op on refusals and on the
        unsubscribed plane (the response stays byte-identical)."""
        if getattr(request, "subscribe", None) and response.ok:
            seeds = self.edge_register(request.session_id, operations,
                                       response.index or 0)
            if seeds:
                response.edge = seeds
        return response

    async def _on_query(self, request: msg.QueryRequest) -> msg.QueryResponse:
        consistency = QueryConsistency(request.consistency or "linearizable")
        self._m_query_level[consistency.value].inc()
        if not self._read_pump:
            return self._edge_seed_response(
                request, await self._query_direct(request, consistency),
                [request.operation])
        self._m_query_ops.inc()
        fut = self._stage_read(consistency, request.session_id,
                               request.index or 0, request.operation)
        index, result, code, detail = await fut
        if code in (msg.NOT_LEADER, msg.NO_LEADER):
            return self._not_leader(msg.QueryResponse)
        if code == msg.APPLICATION:
            return msg.QueryResponse(error=msg.APPLICATION,
                                     error_detail=detail, index=index)
        if code:
            return msg.QueryResponse(error=code, error_detail=detail)
        return self._edge_seed_response(
            request, msg.QueryResponse(index=index, result=result),
            [request.operation])

    async def _query_direct(self, request: msg.QueryRequest,
                            consistency: QueryConsistency
                            ) -> msg.QueryResponse:
        """The per-op read lane (COPYCAT_SERVER_READ_PUMP=0): gate and
        execute this request alone — the pre-pump server bit-identically,
        the readmix A/B baseline."""
        refused = await self._gate_query(consistency, request.index or 0)
        if refused is not None:
            code, detail = refused
            if code == msg.NOT_LEADER:
                return self._not_leader(msg.QueryResponse)
            return msg.QueryResponse(error=code, error_detail=detail)
        session = self.sessions.get(request.session_id)
        commit = Commit(self.last_applied, session, self.context.clock,
                        request.operation, None)
        try:
            result = self.executor.execute(commit)
        except Exception as e:  # noqa: BLE001 - application errors cross
            return msg.QueryResponse(error=msg.APPLICATION,
                                     error_detail=str(e),
                                     index=self.last_applied)
        finally:
            commit.close()
        return msg.QueryResponse(index=self.last_applied, result=result)

    async def _on_query_batch(self, request: msg.QueryBatchRequest
                              ) -> msg.QueryBatchResponse:
        """Batched reads of one consistency level: the gate (leadership
        confirmation / applied wait) runs ONCE for the whole batch — a
        quorum round amortized over N linearizable reads. With the read
        pump on, the batch joins the server-wide per-consistency read
        window, sharing that one gate round with every other session's
        same-turn reads and the device-eligible subset of the window's
        tensor evaluation."""
        consistency = QueryConsistency(request.consistency or "linearizable")
        operations = request.operations or []
        self._m_query_level[consistency.value].inc(len(operations))
        if not self._read_pump or not operations:
            return self._edge_seed_response(
                request,
                await self._query_batch_direct(request, consistency),
                operations)
        self._m_query_ops.inc(len(operations))
        idx = request.index or 0
        futs = [self._stage_read(consistency, request.session_id, idx, op)
                for op in operations]
        outs = await asyncio.gather(*futs)
        entries = []
        index = 0
        for served_index, result, code, detail in outs:
            if code in (msg.NOT_LEADER, msg.NO_LEADER):
                return self._not_leader(msg.QueryBatchResponse)
            if code and code != msg.APPLICATION:
                # gate refusal: identical for every entry of this request
                # (they share index + consistency) — response-level, like
                # the per-op lane
                return msg.QueryBatchResponse(error=code, error_detail=detail)
            if code:
                entries.append((None, code, detail))
            else:
                entries.append((result, None, None))
            index = max(index, served_index)
        return self._edge_seed_response(
            request, msg.QueryBatchResponse(index=index, entries=entries),
            operations)

    async def _query_batch_direct(self, request: msg.QueryBatchRequest,
                                  consistency: QueryConsistency
                                  ) -> msg.QueryBatchResponse:
        """Per-op lane for one batch request (pump off / empty batch)."""
        refused = await self._gate_query(consistency, request.index or 0)
        if refused is not None:
            code, detail = refused
            if code == msg.NOT_LEADER:
                return self._not_leader(msg.QueryBatchResponse)
            return msg.QueryBatchResponse(error=code, error_detail=detail)
        session = self.sessions.get(request.session_id)
        entries = []
        for operation in (request.operations or []):
            commit = Commit(self.last_applied, session, self.context.clock,
                            operation, None)
            try:
                entries.append((self.executor.execute(commit), None, None))
            except Exception as e:  # noqa: BLE001 — per-entry app errors
                entries.append((None, msg.APPLICATION, str(e)))
            finally:
                commit.close()
        return msg.QueryBatchResponse(index=self.last_applied,
                                      entries=entries)

    # -- batched read pump (the read window) ---------------------------

    def _stage_read(self, consistency: QueryConsistency, session_id: int,
                    client_index: int, operation: Any) -> asyncio.Future:
        """Stage one read into the current per-consistency read window;
        resolves to ``(index, result, error_code, error_detail)``. The
        window flushes at the end of the event-loop turn (the same
        call_soon coalescing the client micro-batch uses), so reads
        arriving across sessions and requests in one turn share a gate."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._read_windows.setdefault(consistency.value, []).append(
            (session_id, client_index, operation, fut))
        if not self._read_flush_scheduled:
            self._read_flush_scheduled = True
            loop.call_soon(self._launch_read_windows)
        return fut

    def _launch_read_windows(self) -> None:
        self._read_flush_scheduled = False
        windows, self._read_windows = self._read_windows, {}
        for level, items in windows.items():
            if items:
                spawn(self._flush_read_window(QueryConsistency(level), items),
                      name="read-window")

    @staticmethod
    def _resolve_read(fut: asyncio.Future, payload: tuple) -> None:
        if not fut.done():
            fut.set_result(payload)

    async def _flush_read_window(self, consistency: QueryConsistency,
                                 items: list) -> None:
        try:
            await self._run_read_window(consistency, items)
        except Exception as e:  # noqa: BLE001 — no staged read may hang
            logger.exception("read window failed")
            for _, _, _, fut in items:
                self._resolve_read(fut, (0, None, msg.INTERNAL, str(e)))

    async def _run_read_window(self, consistency: QueryConsistency,
                               items: list) -> None:
        """Serve one read window: the consistency gate ONCE, then the
        reads at an applied snapshot — device-eligible reads as tensors
        through one query_step engine round, the rest through the per-op
        executor lane bit-identically."""
        n = len(items)
        self._m_query_windows.inc()
        self._m_query_window_ops.record(n)
        if consistency in (QueryConsistency.LINEARIZABLE,
                           QueryConsistency.BOUNDED_LINEARIZABLE):
            if self.role != LEADER:
                for _, _, _, fut in items:
                    self._resolve_read(fut, (0, None, msg.NOT_LEADER, ""))
                return
            linear = consistency is QueryConsistency.LINEARIZABLE
            if linear or not self._lease_valid():
                ok = await self._confirm_leadership_hook()
            else:
                ok = True
            if not ok:
                for _, _, _, fut in items:
                    self._resolve_read(fut, (0, None, msg.NOT_LEADER, ""))
                return
            if linear:
                # ONE leadership-confirm round served the whole window;
                # the per-op lane pays one per LINEARIZABLE read — the
                # N-1 amortized rounds are the counter the differential
                # test asserts. Bounded windows never count here: the
                # per-op lane's first confirm renews the lease
                # (_last_quorum_contact), so its reads 2..N are
                # confirm-free too — nothing is actually saved. A failed
                # confirm (refused window) amortizes nothing either.
                self._m_query_gate_saved.inc(n - 1)
            await self._wait_applied(self.commit_index)
            # the gate established the linearization point: serve at it
            # regardless of the client's (necessarily older) index
            self._evaluate_reads(items, check_index=False)
            return
        # SEQUENTIAL / CAUSAL: a read whose own index is already applied
        # serves NOW (the per-op lane's latency — no head-of-line wait
        # behind an unrelated session's lagging index); stragglers share
        # one wait on their max index and refuse per-op at timeout.
        applied = self.last_applied
        ready = [it for it in items if not it[1] or it[1] <= applied]
        lagging = [it for it in items if it[1] and it[1] > applied]
        if ready:
            self._evaluate_reads(ready, check_index=True)
        if lagging:
            await self._wait_applied(max(it[1] for it in lagging),
                                     timeout=self.election_timeout * 4)
            self._evaluate_reads(lagging, check_index=True)

    def _evaluate_reads(self, items: list, check_index: bool) -> None:
        """Serve one batch of gated reads at the current applied
        snapshot. ``check_index`` refuses reads still lagging the
        client's index (a timed-out applied wait) exactly like the
        per-op lane's gate."""
        # ``last_applied`` may cover vector rows still parked in the
        # server's fused collector (their device/host effects land at
        # the turn's one engine round) — reads serve AT last_applied, so
        # those effects must land first (free no-op when nothing staged)
        self.server.flush_fused()
        applied = self.last_applied
        clock = self.context.clock
        route = getattr(self.state_machine, "query_route", None)
        rows: list = []  # (future, machine, instance, inner, spec)
        for session_id, client_index, operation, fut in items:
            if check_index and client_index and client_index > applied:
                self._resolve_read(
                    fut, (0, None, msg.INTERNAL,
                          "state lagging behind client index"))
                continue
            rec = route(operation) if route is not None else None
            if rec is not None:
                rows.append((fut, *rec))
                continue
            self._m_query_per_op.inc()
            session = self.sessions.get(session_id)
            commit = Commit(applied, session, clock, operation, None)
            try:
                result = self.executor.execute(commit)
            except Exception as e:  # noqa: BLE001 — app errors cross
                self._resolve_read(
                    fut, (applied, None, msg.APPLICATION, str(e)))
            else:
                self._resolve_read(fut, (applied, result, None, None))
            finally:
                commit.close()
        if rows:
            self._serve_query_rows(rows, applied)

    def _serve_query_rows(self, rows: list, applied: int) -> None:
        """One query_step engine round for every device-eligible read in
        the window (the read analog of ``_apply_vector_run``): stage [N]
        rows, evaluate from the leader lane's applied state, correlate
        results in a single pass — no per-op Commit objects, no per-op
        executor dispatch."""
        m = len(rows)
        self._m_query_device.inc(m)
        engine = self.state_machine.device_engine
        groups = [0] * m
        opc = [0] * m
        av = [0] * m
        bv = [0] * m
        cv = [0] * m
        for i, (_fut, machine, _inst, _op, spec) in enumerate(rows):
            groups[i] = machine._group
            opc[i], av[i], bv[i], cv[i] = spec[0], spec[1], spec[2], spec[3]
        try:
            raws = engine.run_query_vector(groups, opc, av, bv, cv)
        except Exception as e:  # noqa: BLE001 — fail loudly, never hang
            logger.exception("query vector failed; failing %d reads", m)
            for fut, *_rest in rows:
                self._resolve_read(
                    fut, (applied, None, msg.APPLICATION, str(e)))
            return
        for i, (fut, machine, _inst, inner, spec) in enumerate(rows):
            try:
                result = machine.query_finalize(spec[4], inner, raws[i])
            except Exception as e:  # noqa: BLE001 — app errors cross
                self._resolve_read(
                    fut, (applied, None, msg.APPLICATION, str(e)))
            else:
                self._resolve_read(fut, (applied, result, None, None))

    async def _wait_applied(self, index: int,
                            timeout: float | None = None) -> bool:
        deadline = (time.monotonic() + timeout) if timeout else None
        while self.last_applied < index:
            self._applied_event.clear()
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return False
            try:
                await asyncio.wait_for(self._applied_event.wait(), remaining)
            except asyncio.TimeoutError:
                return False
        return True

    # ------------------------------------------------------------------
    # apply loop
    # ------------------------------------------------------------------

    def _apply_up_to(self, commit_index: int) -> None:
        t_replay = time.perf_counter() if self._recovery_boot_last else 0.0
        window = None
        route = None
        if self.last_applied < commit_index:
            begin = getattr(self.state_machine, "begin_window", None)
            if begin is not None:
                window = begin()  # None on the CPU executor
            if window is not None and self._vector_pump:
                route = getattr(self.state_machine, "vector_route", None)
        key_fn = None
        if route is not None:
            self._m_apply_window.record(commit_index - self.last_applied)
            if self._parallel_apply:
                # dependency-classified windows (docs/SHARDING.md "Apply
                # ordering"): runs span ineligible entries on disjoint
                # keys; COPYCAT_PARALLEL_APPLY=0 (or a state machine
                # without apply_key) keeps the contiguous classifier
                key_fn = getattr(self.state_machine, "apply_key", None)
        vrun: list = []  # staged rows: (clock, entry, session, *route rec)
        # Timer deadline for the classify gate, recomputed only after
        # entries that can (un)schedule timers — the per-entry
        # ``next_deadline()`` heap peek was a measured share of the
        # classify walk. A vector run itself never moves it (eligibility
        # excludes TTL ops, and its tick fires nothing by the gate).
        deadline = self.executor.next_deadline() if route is not None else None
        try:
            while self.last_applied < commit_index:
                index = self.last_applied + 1
                entry = self.log.get(index)
                self.last_applied = index
                if entry is None:
                    continue
                if route is not None and type(entry) is CommandEntry:
                    rec = self._vector_classify(entry, route, deadline)
                    if rec is not None:
                        # Advance the log clock AT STAGE TIME: inline
                        # entries applied while this row waits must see
                        # the clock the sequential walk would (timer
                        # gates, commit times); the row carries its own
                        # clock so finalization stamps the sequential
                        # per-entry value even after later entries
                        # advanced the context further.
                        if entry.timestamp > self.context.clock:
                            self.context.clock = entry.timestamp
                        if key_fn is not None:
                            self._stage_keys.add(key_fn(entry.operation))
                            self._stage_sessions.add(entry.session_id)
                        vrun.append((self.context.clock, *rec))
                        continue
                    self._m_vector_refused.inc()
                if vrun or self._stage_rows:
                    # An ineligible entry bounds the staged run — always
                    # on the contiguous plane (key_fn None), only on a
                    # dependency/session/timer conflict on the parallel
                    # plane (a disjoint-key entry is spanned; per-key
                    # FIFO still holds because a colliding entry forces
                    # the dispatch below BEFORE it applies). vrun is
                    # emptied BEFORE the call — if the run raises
                    # (window barrier timeout), replaying it at the next
                    # flush point would double-apply. Its try is
                    # SEPARATE from the bounding entry's: a failed run
                    # must not swallow the entry's apply (last_applied
                    # already advanced past it; skipping it would hang
                    # its commit future and, for a config entry, diverge
                    # this replica's membership view).
                    if key_fn is None or self._apply_conflicts(
                            entry, key_fn, deadline):
                        if key_fn is not None:
                            self._m_apply_conflicts.inc()
                        run, vrun = vrun, []
                        try:
                            self._bound_vector_run(run, window)
                        except Exception:
                            logger.exception(
                                "vector apply failed before index %d", index)
                    else:
                        # spanned: rows are staged locally (vrun) or
                        # parked in the fused collector (_stage_rows) —
                        # the outer guard admits no third case
                        self._m_apply_spans.inc()
                try:
                    self._apply_entry(entry, window)
                except Exception:
                    logger.exception("apply failed at index %d", index)
                if route is not None:
                    deadline = self.executor.next_deadline()
            if vrun:
                try:
                    self._stage_vector_tail(vrun, window)
                except Exception:
                    logger.exception("vector apply failed")
        finally:
            if window is not None:
                try:
                    window.close()
                except Exception:
                    logger.exception("device window close failed")
        if self._recovery_boot_last:
            # boot-tail replay accounting: cumulative apply time until the
            # restart's surviving log tail is fully re-applied — the
            # number the snapshot cadence bounds (snap.recovery_replay_ms)
            self._recovery_replay_s += time.perf_counter() - t_replay
            if self.last_applied >= self._recovery_boot_last:
                self.metrics.gauge("snap.recovery_replay_ms").set(
                    self._recovery_replay_s * 1e3)
                self._recovery_boot_last = 0
        self._applied_event.set()
        self._maybe_snapshot()

    # -- batched server-side pump (the vector lane) --------------------

    # The engine's terminal-refusal sentinel (``ops.apply.FAIL``), as a
    # literal so server/ stays import-independent of the jax-backed ops
    # package. ``_devint`` excludes INT32_MIN from payloads, so no
    # legitimate device result ever collides with it.
    _DEVICE_FAIL = -(2 ** 31)

    def _vector_classify(self, entry: CommandEntry, route: Any,
                         deadline: float | None):
        """One staged row for the vector run, or ``None`` for the
        per-entry path. Eligibility repeats the windowed apply's
        exactly-once guards (duplicates and dead sessions always take
        the general path, which serves cached responses) and refuses
        whenever a state-machine timer would fire within the run (tick
        order must match the per-entry walk on every replica).

        The ``command_high`` dedup is safe against SAME-seq entries
        appearing twice in one classify walk because cross-term
        duplicates (old leader appended, client resent to the new one)
        are always separated in the log by the new leader's takeover
        ``NoOpEntry`` (Raft §5.4.2, ``_become_leader``) — an ineligible
        entry that bounds the run, applying the first instance (and
        advancing ``command_high``) before the resend is classified.
        Same-leader duplicates never double-append at all
        (``_stage_command`` shares the in-flight future).
        ``deadline`` is the caller's cached ``executor.next_deadline()``
        (valid for the whole contiguous classify walk)."""
        session = self.sessions.get(entry.session_id)
        if session is None or session.state is not SessionState.OPEN:
            return None
        seq = entry.seq
        if seq and (seq <= session.command_high
                    or (entry.session_id, seq) in self._window_pending_seqs):
            return None
        rec = route(entry.operation)
        if rec is None:
            return None
        if deadline is not None \
                and deadline <= max(self.context.clock, entry.timestamp):
            return None
        return (entry, session, *rec)

    def _apply_conflicts(self, entry: Entry, key_fn: Any,
                         deadline: float | None) -> bool:
        """Does applying ``entry`` inline conflict with the staged vector
        rows? The monotone-tag gate of the dependency-classified plane
        (docs/SHARDING.md "Apply ordering"): a staged run may be spanned
        by this entry only when the entry provably touches none of the
        run's resources, sessions, or timers — anything else forces the
        staged effects to land FIRST, preserving per-key (and
        per-session) FIFO exactly as the sequential walk would.

        Conflicts, conservatively:
        - timer adjacency: this entry's tick could fire a state-machine
          timer (timers touch arbitrary resources);
        - non-command entries: register/keepalive/unregister/config/noop
          read or mutate session and membership state broadly (and the
          takeover ``NoOpEntry`` flush is what keeps the classify-time
          duplicate-seq argument valid — see ``_vector_classify``);
        - same session: response cache order, keepalive clocks, and the
          cached-response dedup all require per-session FIFO;
        - same or unclassifiable key: ``apply_key`` returns ``None`` for
          catalog ops (create/get/delete reshape the catalog itself) —
          the whole-window barrier."""
        if deadline is not None \
                and deadline <= max(self.context.clock, entry.timestamp):
            return True
        if type(entry) is not CommandEntry:
            return True
        if entry.session_id in self._stage_sessions:
            return True
        key = key_fn(entry.operation)
        return key is None or key in self._stage_keys

    def _bound_vector_run(self, run: list, window: Any) -> None:
        """Dispatch every staged row at a conflict bound: the bounding
        entry applies only after the staged device effects land. On the
        fused plane this forces the SERVER's collector synchronously
        (other groups' staged rows ride along in the same engine round);
        per-group otherwise."""
        if self._apply_fuse:
            if run:
                self._stage_fused(run)
            self.server.flush_fused()
        elif run:
            self._apply_vector_run(run, window)

    def _stage_vector_tail(self, run: list, window: Any) -> None:
        """End-of-window dispatch point: on the fused plane the run
        parks in the server's collector and rides the turn's ONE engine
        round (``RaftServer.flush_fused``); per-group it dispatches
        now."""
        if self._apply_fuse:
            self._stage_fused(run)
        else:
            self._apply_vector_run(run, window)

    def _stage_fused(self, run: list) -> None:
        """Hand one run to the server's cross-group collector.
        ``_stage_rows`` counts this group's parked rows so the next
        ``_apply_up_to`` window still bounds them on conflict (its local
        ``vrun`` starts empty but the dependency sets persist)."""
        self._stage_rows += len(run)
        self.server.stage_vector_run(self, run)

    def _apply_vector_run(self, run: list, window: Any) -> None:
        """Apply one run of vector-eligible commands on the PER-GROUP
        lane (``COPYCAT_APPLY_FUSE=0``): ONE vectorized engine round for
        the whole run (``DeviceEngine.run_vector``), then per-entry
        finalization in log order via :meth:`_finalize_vector_run` —
        with zero generator/window machinery per op. A barrier failure
        is a pump error (rows fail explicitly, futures resolve) instead
        of an exception that would silently drop the run."""
        raws, pump_error = dispatch_vector_rows(
            self.state_machine.device_engine, window, run)
        self._finalize_vector_run(run, raws, pump_error)

    def _finalize_vector_run(self, run: list, raws: list,
                             pump_error: str | None) -> None:
        """Per-entry finalization of one DISPATCHED run in log order —
        response cache, commit futures, held-commit bookkeeping — shared
        by the per-group lane (:meth:`_apply_vector_run`) and the
        server's fused cross-group dispatch (``RaftServer.flush_fused``).

        A failed pump (``pump_error`` set) takes an EXPLICIT per-entry
        failure branch: ``raws`` is never indexed (it is empty then —
        the old guard-path walked ``raws[k]`` behind a short-circuit),
        every entry's future resolves with the error, and the log slot
        is cleaned, so a mid-run engine failure degrades to N failed
        commands instead of N hung futures."""
        n = len(run)
        self._m_vector_runs.inc()
        self._m_vector_ops.inc(n)
        self._m_run_length.record(n)
        log = self.log
        futures = self._commit_futures
        marks = self._trace_entry_marks
        for k, (clock, entry, session, machine, instance, inner, spec) in \
                enumerate(run):
            trace = marks.pop(entry.index, None) if marks else None
            if self._edge_subs:
                # the vector lane mutates device resources too: dirty
                # them for the turn's edge-delta flush (which flushes
                # the fused collector before serializing states)
                self._edge_note_apply(entry, trace)
            if pump_error is not None:
                result, error = None, pump_error
                log.clean(entry.index)
            elif raws[k] == self._DEVICE_FAIL:
                # the tracked fallback lane can surface the engine's
                # refusal sentinel (a group emptied by a config change
                # mid-run); legitimate results never equal it (_devint
                # excludes INT32_MIN), and handing it to vector_finalize
                # would record a refused op as a committed result
                result, error = None, "device refused the operation"
                log.clean(entry.index)
            else:
                # the row's own staged clock (the sequential per-entry
                # value), not the context clock — later entries may have
                # advanced the context past this row's log slot
                commit = Commit(entry.index, instance.session, clock, inner,
                                log)
                try:
                    result: Any = machine.vector_finalize(
                        spec[4], inner, raws[k], commit)
                    error: str | None = None
                except Exception as e:  # noqa: BLE001 — app errors cross
                    result, error = None, str(e)
                    log.clean(entry.index)
            seq = entry.seq
            if seq:
                session.last_keepalive_time = clock
                session.cache_response(seq, entry.index, result, error)
            fut = futures.pop(entry.index, None)
            if fut is not None and not fut.done():
                fut.set_result((entry.index, result, error))
            if seq and session.command_futures:
                self._complete_command(entry, result, error, [])
        # dependency bookkeeping: this run's rows are no longer staged.
        # The collector drains whole (never partially), so a zero count
        # retires the key/session sets; the per-group lane enters with
        # _stage_rows == 0 and clears them here too.
        if self._stage_rows > n:
            self._stage_rows -= n
        else:
            self._stage_rows = 0
            if self._stage_keys:
                self._stage_keys.clear()
            if self._stage_sessions:
                self._stage_sessions.clear()
        self.executor.tick(self.context.clock)  # fires nothing (classify
        # gate: every staged row's clock precedes every pending deadline)

    def _apply_entry(self, entry: Entry, window: Any = None) -> None:
        self._m_apply_entry.inc()
        if (window is not None and window.busy
                and not isinstance(entry, CommandEntry)):
            # Session/config/noop entries read state that in-flight device
            # chains may still mutate — drain the window to stay aligned
            # with the log on every server.
            window.barrier()
        self.context.index = entry.index
        self.context.clock = max(self.context.clock, entry.timestamp)
        # originating trace for this entry, when its staging marked one
        # (empty-dict truthiness is the whole untraced cost): events the
        # apply publishes ride PublishRequest under the same id — popped
        # BEFORE the windowed-lane branch so device-backed applies
        # neither leak marks nor lose event attribution
        marks = self._trace_entry_marks
        trace = marks.pop(entry.index, None) if marks else None
        if window is not None and isinstance(entry, CommandEntry):
            self._apply_command_windowed(entry, window, trace)
            return
        # Reset BEFORE ticking: timer callbacks publish session events too,
        # and those must be sealed/pushed with this entry.
        self._touched_sessions = set()
        self.executor.tick(self.context.clock)

        result: Any = None
        error: str | None = None
        if isinstance(entry, RegisterEntry):
            result = self._apply_register(entry)
        elif isinstance(entry, KeepAliveEntry):
            self._apply_keepalive(entry)
        elif isinstance(entry, UnregisterEntry):
            self._apply_unregister(entry)
        elif isinstance(entry, CommandEntry):
            result, error, _ = self._apply_command(entry)
        elif isinstance(entry, ConfigurationEntry):
            self._apply_configuration(entry)
        elif isinstance(entry, NoOpEntry):
            self.log.clean(entry.index)

        # Seal + push session events produced by this entry.
        pushes = self._seal_and_push(self._touched_sessions, trace)

        fut = self._commit_futures.pop(entry.index, None)
        if fut is not None and not fut.done():
            fut.set_result((entry.index, result, error))
        if isinstance(entry, CommandEntry):
            if self._edge_subs:
                self._edge_note_apply(entry, trace)
            self._complete_command(entry, result, error, pushes)

    def _seal_and_push(self, touched,
                       trace: int | None = None) -> list[asyncio.Task]:
        pushes: list[asyncio.Task] = []
        for session in touched:
            batch = session.commit_events()
            if batch is None:
                continue
            # Single-group: only the leader pushes (it owns the client
            # connection). Multi-group: the member HOLDING the session's
            # connection pushes — that is the ingress, which may be a
            # follower of this group applying the replicated entry; the
            # group's leader has no connection and skips (docs/SHARDING.md
            # "event channels").
            if (self.role == LEADER if self.server.single
                    else session.connection is not None):
                task = self._push_events(session, trace)
                if task is not None:
                    pushes.append(task)
                    self._event_pushes.add(task)
                    task.add_done_callback(self._event_pushes.discard)
        return pushes

    # -- windowed apply (device executor) ------------------------------

    def _apply_command_windowed(self, entry: CommandEntry, window: Any,
                                trace: int | None = None) -> None:
        """Apply one command entry under the device window: the handler may
        return a suspended device-op chain (DeviceJob) that is deferred
        into the shared round pump; its finalization (response cache,
        event seal/push, futures) runs at the entry's log-ordered slot."""
        ctx = _EntryCtx(self, entry, trace)
        window.job_ctx = ctx  # timer chains spawned by tick inherit it
        try:
            with ctx:
                self.executor.tick(self.context.clock)
                result, error, job = self._apply_command(entry, window)
        finally:
            window.job_ctx = None
        if job is not None:
            window.add_job(job, ctx=ctx, on_done=lambda res, exc:
                           self._finalize_deferred(entry, res, exc, ctx))
        else:
            window.add_ready(lambda res, exc:
                             self._finalize_entry(entry, result, error, ctx))

    def _finalize_deferred(self, entry: CommandEntry, result: Any,
                           exc: BaseException | None,
                           ctx: "_EntryCtx") -> None:
        error: str | None = None
        if exc is not None:
            result, error = None, str(exc)
            self.log.clean(entry.index)
        if entry.seq:
            self._window_pending_seqs.discard((entry.session_id, entry.seq))
            session = self.sessions.get(entry.session_id)
            if session is not None:
                session.cache_response(entry.seq, entry.index, result, error)
        self._finalize_entry(entry, result, error, ctx)

    def _finalize_entry(self, entry: CommandEntry, result: Any,
                        error: str | None, ctx: "_EntryCtx") -> None:
        ctx.replay()  # buffered publishes land in log order
        pushes = self._seal_and_push(ctx.touched, ctx.trace)
        fut = self._commit_futures.pop(entry.index, None)
        if fut is not None and not fut.done():
            fut.set_result((entry.index, result, error))
        if self._edge_subs:
            self._edge_note_apply(entry, ctx.trace)
        self._complete_command(entry, result, error, pushes)

    def _session_touched(self, session: ServerSession) -> None:
        self._touched_sessions.add(session)

    def _apply_register(self, entry: RegisterEntry) -> int:
        # Session id: the registering entry's log index on the
        # single-group plane (the reference rule, bit-identical); on the
        # multi-group plane the id-allocating group 0 derives a globally
        # unique id (index stamped with the group count) and the fan-out
        # entries to groups 1..G-1 carry it explicitly, so EVERY group's
        # replica of one client session shares one id (docs/SHARDING.md).
        sid = getattr(entry, "session_id", None)
        if not sid:
            sid = (entry.index if self.server.single
                   else entry.index * self.server.num_groups)
        session = ServerSession(sid, entry.client_id, entry.timeout)
        session.last_keepalive_time = self.context.clock
        # Wire publish -> touched-session tracking for this apply step.
        self._wire_session(session)
        self.sessions[sid] = session
        if self.role == LEADER:
            session.last_contact = time.monotonic()
        if not self.server.single:
            # late-bind the client's connection (docs/SHARDING.md): the
            # ingress member may have touched this session before our
            # follower apply created the replica — the ingress, not the
            # group leader, owns this session's event channel
            conn = self.server._session_conns.get(sid)
            if conn is not None and not conn.closed:
                session.connection = conn
                session.last_contact = time.monotonic()
        self.state_machine.register(session)
        return sid

    def _apply_keepalive(self, entry: KeepAliveEntry) -> None:
        session = self.sessions.get(entry.session_id)
        if session is None:
            return
        session.last_keepalive_time = self.context.clock
        session.ack_commands(entry.command_seq or 0)
        session.ack_events(entry.event_index or 0)
        self.log.clean(entry.index)

    def _apply_unregister(self, entry: UnregisterEntry) -> None:
        session = self.sessions.pop(entry.session_id, None)
        self._expiring_sessions.discard(entry.session_id)
        if self._edge_sessions:
            self._edge_drop_session(entry.session_id)
        if not self.server.single and self.group_id == 0:
            # the metadata group's unregister retires the server-level
            # connection binding (the late-bind map would otherwise pin
            # one entry per session forever)
            self.server._session_conns.pop(entry.session_id, None)
        if session is None:
            self.log.clean(entry.index)
            return
        self.metrics.counter(
            "sessions_expired_total" if entry.expired
            else "sessions_closed_total").inc()
        if entry.expired:
            session.expire()
            self.state_machine.expire(session)
        else:
            session.close()
        self.state_machine.close(session)
        session.state = (SessionState.EXPIRED if entry.expired
                         else SessionState.CLOSED)
        self.log.clean(entry.index)

    def _apply_command(self, entry: CommandEntry,
                       window: Any = None) -> tuple[Any, str | None, Any]:
        """Apply one command; returns ``(result, error, deferred_job)``.

        ``deferred_job`` is non-None only under an open device window, when
        the handler returned a suspended device-op chain: the caller owns
        its response caching and completion (``_finalize_deferred``)."""
        session = self.sessions.get(entry.session_id)
        if session is None or session.state is not SessionState.OPEN:
            self.log.clean(entry.index)
            return None, "session expired or unknown", None
        if (entry.seq and window is not None
                and (entry.session_id, entry.seq)
                in self._window_pending_seqs):
            # duplicate of a command still in flight in this window: settle
            # it first so the cached-response dedup below sees it
            window.barrier()
        if entry.seq and entry.seq <= session.command_high:
            cached = session.cached_response(entry.seq)
            if cached is not None:
                _, result, error = cached
                return result, error, None
            # Duplicate append whose cached response was already pruned; the
            # original apply completed any pending future, so this error
            # result is only ever seen if something is deeply wrong — never
            # a silent success for a skipped write.
            return None, \
                f"duplicate command seq {entry.seq} (response pruned)", None
        session.last_keepalive_time = self.context.clock
        commit = Commit(entry.index, session, self.context.clock,
                        entry.operation, self.log)
        try:
            result, error = self.executor.execute(commit), None
        except Exception as e:  # noqa: BLE001
            result, error = None, str(e)
            self.log.clean(entry.index)
        if getattr(result, "is_device_job", False):
            if window is not None:
                if entry.seq:
                    self._window_pending_seqs.add(
                        (entry.session_id, entry.seq))
                return None, None, result
            # no window open (state machine hosted outside the manager's
            # apply loop): drive the chain alone
            try:
                result, error = result.run(), None
            except Exception as e:  # noqa: BLE001
                result, error = None, str(e)
                self.log.clean(entry.index)
        if entry.seq:
            session.cache_response(entry.seq, entry.index, result, error)
        return result, error, None

    def _apply_configuration(self, entry: ConfigurationEntry) -> None:
        self._adopt_members(entry.members)
        self.log.clean(entry.index)
        if not self.server.single and self.group_id == 0:
            # membership rides the metadata group's log (docs/SHARDING.md):
            # the server propagates the applied view to groups 1..G-1,
            # which adopt it and reconcile their replication streams
            self.server._membership_applied(self.members)

    def _adopt_members(self, members: list[Address]) -> None:
        """Install a membership view and reconcile the leader's
        replication streams (the apply path for this group's own
        ConfigurationEntry, and the propagation path from the metadata
        group on a multi-group server)."""
        self.members = list(members)
        if self.role == LEADER:
            for peer in self.peers:
                if peer not in self._replication_tasks:
                    self.next_index[peer] = self.log.last_index + 1
                    self.match_index[peer] = 0
                    self._replication_events[peer] = asyncio.Event()
                    self._replication_tasks[peer] = spawn(
                        self._replicate_loop(peer),
                        name=f"replicate-{peer}")
            for peer in list(self._replication_tasks):
                if peer not in self.members:
                    self._replication_tasks.pop(peer).cancel()
                    self._replication_events.pop(peer, None)

    def _complete_command(self, entry: CommandEntry, result: Any,
                          error: str | None,
                          pushes: list[asyncio.Task]) -> None:
        session = self.sessions.get(entry.session_id)
        if session is None:
            return
        fut = session.command_futures.get(entry.seq)
        if fut is None or fut.done():
            return
        operation = entry.operation
        consistency = (operation.consistency()
                       if isinstance(operation, Command)
                       else CommandConsistency.LINEARIZABLE)
        payload = (entry.index, result, error)
        if pushes and consistency is CommandConsistency.LINEARIZABLE:
            # Events-before-response: the response releases only after event
            # pushes are acknowledged (reference Consistency.java:157-176).
            async def complete_after_events() -> None:
                try:
                    await asyncio.wait_for(
                        asyncio.gather(*pushes, return_exceptions=True), 1.0)
                except asyncio.TimeoutError:
                    pass
                if not fut.done():
                    fut.set_result(payload)

            spawn(complete_after_events(), name="events-before-response")
        else:
            fut.set_result(payload)

    # ------------------------------------------------------------------
    # event push (connection-holder only; leader == holder when single)
    # ------------------------------------------------------------------

    def _push_events(self, session: ServerSession,
                     trace: int | None = None) -> asyncio.Task | None:
        if session.connection is None or session.connection.closed:
            return None
        return spawn(self._flush_events_async(session, trace),
                     name="event-push")

    def _flush_events(self, session: ServerSession) -> None:
        self._push_events(session)

    async def _flush_events_async(self, session: ServerSession,
                                  trace: int | None = None) -> None:
        conn = session.connection
        if conn is None or conn.closed:
            return
        t0 = time.perf_counter() if trace is not None else 0.0
        pushed = False
        try:
            for batch in list(session.event_queue):
                if batch.event_index <= session.event_ack_index:
                    continue
                try:
                    response = await asyncio.wait_for(
                        conn.send(msg.PublishRequest(
                            session_id=session.id,
                            event_index=batch.event_index,
                            prev_event_index=batch.prev_event_index,
                            events=batch.events,
                            group=self.wire_group, trace=trace)),
                        1.0)
                except (TransportError, OSError, asyncio.TimeoutError):
                    return
                pushed = True
                if response.event_index is not None:
                    session.ack_events(response.event_index)
                    if response.event_index < batch.event_index:
                        # client is behind; caught up on the next pass
                        return
        finally:
            # any completed push (including one before a catching-up
            # early return) is timeline-worthy — an asymmetric trace
            # with a client.event but no event.push reads as a hole
            if trace is not None and pushed:
                self._trace_span(trace, "event.push", t0,
                                 time.perf_counter(),
                                 self._m_lat_event_push)

    # ------------------------------------------------------------------
    # edge read tier: subscriber registry + delta publication
    # (docs/EDGE_READS.md — deltas ride the same PublishRequest plane as
    # the event channels above, pushed by the same connection holder,
    # but need NO position in the gap/replay machinery: the client's
    # join-semilattice merge makes duplicated/reordered/re-delivered
    # deltas converge instead of corrupting)
    # ------------------------------------------------------------------

    def edge_register(self, session_id: int, operations: list,
                      version: int) -> list | None:
        """Register edge subscriptions for a subscribing read served at
        (group-local) ``version`` and build the response's seed records
        ``[(instance_id, version, state), ...]``; ``None`` when this
        member cannot feed deltas (edge tier off, no live session
        connection here, nothing edge-eligible in ``operations``)."""
        if not self.server._edge_enabled:
            return None
        session = self.sessions.get(session_id)
        if session is None or session.connection is None \
                or session.connection.closed:
            return None
        locate = getattr(self.state_machine, "edge_locate", None)
        state_of = getattr(self.state_machine, "edge_state_of", None)
        if locate is None or state_of is None:
            return None
        seeds: list = []
        for op in operations:
            loc = locate(op)
            if loc is None:
                continue
            rid, iid = loc
            try:
                state = state_of(rid)
            except Exception:  # noqa: BLE001 — a seed must never fail a read
                logger.exception("edge seed for resource %d failed", rid)
                continue
            if state is NotImplemented or state is None:
                continue
            self._edge_subs.setdefault(rid, {}).setdefault(
                session_id, set()).add(iid)
            self._edge_sessions.setdefault(session_id, set()).add(rid)
            self._m_edge_subscribes.inc()
            seeds.append((iid, version, state))
        if seeds:
            self._refresh_edge_gauge()
        return seeds or None

    def edge_unsubscribe(self, session_id: int, instance_ids) -> None:
        """Retire a client's evicted instances (the keep-alive's
        ``unsubscribe`` field) from the registry."""
        rids = self._edge_sessions.get(session_id)
        if not rids:
            return
        drop = set(instance_ids)
        removed = 0
        for rid in list(rids):
            subs = self._edge_subs.get(rid)
            iids = subs.get(session_id) if subs else None
            if not iids:
                continue
            n = len(iids)
            iids -= drop
            removed += n - len(iids)
            if not iids:
                subs.pop(session_id, None)
                rids.discard(rid)
                if not subs:
                    self._edge_subs.pop(rid, None)
        if not rids:
            self._edge_sessions.pop(session_id, None)
        if removed:
            self._m_edge_unsubscribes.inc(removed)
            self._refresh_edge_gauge()

    def _edge_drop_session(self, session_id: int) -> None:
        """Session death (close/expiry apply) retires every
        subscription it held."""
        rids = self._edge_sessions.pop(session_id, None)
        if not rids:
            return
        for rid in rids:
            subs = self._edge_subs.get(rid)
            if subs is not None:
                subs.pop(session_id, None)
                if not subs:
                    self._edge_subs.pop(rid, None)
        self._refresh_edge_gauge()

    def _refresh_edge_gauge(self) -> None:
        self._m_edge_subs.set(sum(
            len(iids) for subs in self._edge_subs.values()
            for iids in subs.values()))

    def _edge_note_apply(self, entry: "CommandEntry",
                         trace: int | None = None) -> None:
        """Mark the resource a just-applied command mutated dirty for
        this turn's delta flush. The empty-registry truthiness check at
        every call site is the whole cost when nothing subscribed (and
        with COPYCAT_EDGE_READS=0 nothing ever registers)."""
        key_fn = getattr(self.state_machine, "apply_key", None)
        rid = key_fn(entry.operation) if key_fn is not None else None
        if rid is None:
            # unclassifiable footprint (catalog create/get/delete may
            # reshape any resource): conservatively dirty every
            # subscribed resource — the flush re-reads their states and
            # retires the ones that are gone
            for r in self._edge_subs:
                self._edge_dirty.setdefault(r, trace)
        elif rid in self._edge_subs:
            self._edge_dirty[rid] = trace
        if not self._edge_dirty or self._edge_flush_scheduled:
            return
        self._edge_flush_scheduled = True
        try:
            loop = asyncio.get_running_loop()
            if self._edge_flush_s > 0:
                loop.call_later(self._edge_flush_s, self._edge_flush)
            else:
                loop.call_soon(self._edge_flush)
        except RuntimeError:
            # synchronous replay harness: no loop, nothing to push to
            self._edge_flush_scheduled = False
            self._edge_dirty.clear()

    def _edge_flush(self) -> None:
        """End-of-turn delta publication: serialize each dirty
        resource's post-apply state ONCE and push it to every local
        subscriber. A hot resource written many times in one turn
        coalesces to one delta; versions stamp the group's
        ``last_applied``, so a merging replica may serve any read its
        per-group index admits up to that point (the state of a
        resource at ``last_applied`` IS its state after its own last
        write — later entries in the turn touched other resources)."""
        self._edge_flush_scheduled = False
        if not self._edge_dirty or self._closing:
            self._edge_dirty.clear()
            return
        state_of = getattr(self.state_machine, "edge_state_of", None)
        if state_of is None:
            return
        # staged-but-undispatched fused vector rows are device effects
        # the serialized states must include — and their finalization
        # dirties MORE resources, so the collector must drain BEFORE
        # the dirty set is snapshotted: a fused write landing after the
        # swap would be certified "unchanged" by this flush's refresh
        # records at a version covering it (free no-op when empty)
        self.server.flush_fused()
        dirty, self._edge_dirty = self._edge_dirty, {}
        version = self.last_applied
        # one push carries ONE trace (the first dirty entry's) — the
        # replication-window sampling limitation, documented there
        trace = next((t for t in dirty.values() if t is not None), None)
        pushes: dict[int, list] = {}
        sessions: dict[int, ServerSession] = {}
        for rid in dirty:
            subs = self._edge_subs.get(rid)
            if not subs:
                continue
            try:
                state = state_of(rid)
            except Exception:  # noqa: BLE001 — publication must not wound apply
                logger.exception("edge state for resource %d failed", rid)
                state = None
            if state is NotImplemented:
                state = None
            for sid, iids in list(subs.items()):
                session = self.sessions.get(sid)
                if session is None:
                    continue
                pushes.setdefault(sid, []).extend(
                    (iid, version, state) for iid in iids)
                sessions[sid] = session
            if state is None:
                # resource gone (deleted / stopped being edge-servable):
                # the None deltas above retire the client entries; drop
                # the registry side too
                self._m_edge_retired.inc()
                for sid in list(subs):
                    self.edge_unsubscribe(sid, list(subs.get(sid, ())))
        if not pushes:
            return
        self._m_edge_flushes.inc()
        for sid, recs in pushes.items():
            session = sessions[sid]
            conn = session.connection
            if conn is None or conn.closed:
                # cannot certify delivery for this session any more:
                # retire its subscriptions in this group — a re-bound
                # connection resuming pushes after a gap would certify
                # currency over deltas the gap swallowed (the client
                # TTLs out and re-seeds instead)
                self._edge_drop_session(sid)
                continue
            # version-refresh records for the session's OTHER subscribed
            # resources: this flush touched none of them, so their last
            # certified state is still current at `version` — the
            # explicit per-resource currency certification the client's
            # monotone gate consumes (docs/EDGE_READS.md). Without it a
            # client whose read floor rose (any server read) would
            # stale-reject every warm entry forever.
            dirty_iids = {iid for iid, _, _ in recs}
            for rid in self._edge_sessions.get(sid, ()):
                if rid in dirty:
                    continue
                for iid in self._edge_subs.get(rid, {}).get(sid, ()):
                    if iid not in dirty_iids:
                        recs.append((iid, version, _EDGE_REFRESH))
            self._m_edge_deltas.inc(len(recs))
            task = spawn(self._edge_push(conn, session, recs, trace),
                         name="edge-push")
            self._edge_pushes.add(task)
            task.add_done_callback(self._edge_pushes.discard)

    async def _edge_push(self, conn: Connection, session: ServerSession,
                         recs: list, trace: int | None) -> None:
        try:
            await asyncio.wait_for(conn.send(msg.PublishRequest(
                session_id=session.id, event_index=None,
                prev_event_index=None, events=None,
                group=self.wire_group, trace=trace, deltas=recs)), 1.0)
        except (TransportError, OSError, asyncio.TimeoutError):
            # delivery unknown: stop certifying for this session — its
            # replica TTLs out and re-seeds; resumed pushes over a
            # possibly-lossy gap could otherwise certify stale state
            self._edge_drop_session(session.id)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def health_sample(self) -> dict:
        """One point-in-time sample for the health monitor's detectors
        (``utils/health.py``): cursors, churn counters, replication
        stream windows, fsync latency accounting, and session-plane
        signals. ``fsync_max_ms`` is consume-on-read: the max since the
        previous sample."""
        m = self.metrics
        recent = self._fsync_recent_max_ms
        self._fsync_recent_max_ms = 0.0
        return {
            "role": self.role,
            "term": self.term,
            "commit_index": self.commit_index,
            "last_applied": self.last_applied,
            "log_last_index": self.log.last_index,
            "elections": m.counter("raft_elections_started").value,
            "transitions": m.counter("raft_leader_transitions").value,
            "rewinds": self._m_repl_rewinds.value,
            "stalls": self._m_repl_stalls.value,
            "repl_windows": {str(p): (s.window, s.floor, s.floor_hits)
                             for p, s in self._peer_streams.items()},
            "fsyncs": self._fsync_count,
            "fsync_max_ms": recent,
            "fsync_ewma_ms": self._fsync_ewma_ms,
            "sessions_expired": m.counter("sessions_expired_total").value,
            "event_backlog": sum(len(s.event_queue)
                                 for s in self.sessions.values()),
            "snap_failures": (self._m_snap_capture_fail.value
                              + self._m_snap_install_fail.value),
        }

    def refresh_gauges(self) -> None:
        """Refresh this group's lazy point-in-time gauges (term/role/lag/
        sessions) — the per-group half of the server's
        ``stats_snapshot``."""
        m = self.metrics
        m.gauge("raft_term").set(self.term)
        m.gauge("raft_is_leader").set(1 if self.role == LEADER else 0)
        m.gauge("raft_commit_index").set(self.commit_index)
        m.gauge("raft_last_applied").set(self.last_applied)
        m.gauge("raft_log_last_index").set(self.log.last_index)
        # commit lag: appended-but-uncommitted entries; apply lag:
        # committed-but-unapplied — both 0 in a healthy quiet cluster.
        m.gauge("raft_commit_lag").set(self.log.last_index
                                       - self.commit_index)
        m.gauge("raft_apply_lag").set(self.commit_index - self.last_applied)
        m.gauge("raft_members").set(len(self.members))
        live = 0
        queue_depth = 0
        for session in self.sessions.values():
            if session.state is SessionState.OPEN:
                live += 1
            queue_depth += len(session.event_queue)
        m.gauge("sessions_open").set(live)
        m.gauge("session_event_queue_depth").set(queue_depth)
        # snapshot plane (docs/DURABILITY.md): where the durable image
        # stands relative to the log, and whether any file was skipped
        # for a bad CRC since boot
        m.gauge("snap.last_snapshot_index").set(self._snap_index)
        m.gauge("snap.log_first_index").set(self.log.first_index)
        m.gauge("snap.enabled").set(
            1 if (self._snap_enabled and self._snapshots is not None) else 0)
        if self._snapshots is not None:
            m.gauge("snap.bad_crc_skipped").set(self._snapshots.bad_skipped)
