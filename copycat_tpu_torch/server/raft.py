"""RaftServer: the server plane hosting N Raft groups (Copycat
``CopycatServer`` equivalent, multi-raft edition — docs/SHARDING.md).

Everything per-group — term, vote, log, commit/apply cursors, election
timers, replication streams, the session plane, snapshots, the apply
loop — lives in :class:`copycat_tpu_torch.server.raft_group.RaftGroup`; this
class owns what is genuinely SHARED across groups:

- the transport (one listener, one client, one correlated peer
  connection per member — every group's vote/append/install streams and
  the ingress proxy multiplex over it, demultiplexed by the ``group``
  field on the wire);
- the ingress: client sessions connect to ANY member; commands and
  reads are demultiplexed per group by hash routing
  (``StateMachine.route_group``) and staged locally when this member
  leads the owning group, or forwarded to the group's leader as
  :class:`ProxyRequest` sub-blocks (batching stays global, ordering is
  per-group — the compartmentalization shape);
- the stats surface (per-group registries merge under a ``group=``
  label; ``shard.*`` routing counters live on the server registry).

``groups=1`` — the default, also forced by ``COPYCAT_MULTI_GROUP=0`` —
is the single-group plane: one group, no proxying, wire messages carry
``group=None``, and every request is delegated straight to the group's
legacy handlers, bit-identically to the pre-refactor server. The
delegation properties at the bottom keep the classic single-group
surface (``server.term``, ``server.log``, ``server.sessions``...)
pointing at group 0, so single-group embedders and tests see the
original object shape.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any, Callable

from ..io.serializer import Serializer
from ..io.transport import Address, Connection, Transport, TransportError
from ..protocol import messages as msg
from ..protocol.operations import QueryConsistency
from ..utils import knobs, profiler
from ..utils.health import BlackBox, HealthMonitor
from ..utils.timeseries import SeriesStore
from ..utils.managed import Managed
from ..utils.metrics import MetricsRegistry
from ..utils.tracing import TRACER
from .log import ConfigurationEntry, Storage, StorageLevel
from .raft_group import (  # noqa: F401 - re-exported compat surface
    CANDIDATE,
    FOLLOWER,
    LEADER,
    RaftGroup,
    _EntryCtx,
    _PeerStream,
    dispatch_vector_rows,
)
from .session import SessionState
from .state_machine import StateMachine

__all__ = ["RaftServer", "RaftGroup", "FOLLOWER", "CANDIDATE", "LEADER"]

logger = logging.getLogger(__name__)


class RaftServer(Managed):
    """A Raft replica hosting ``groups`` consensus groups behind one
    transport, one session ingress, and one stats surface."""

    def __init__(
        self,
        address: Address,
        members: list[Address],
        transport: Transport,
        state_machine: StateMachine | Callable[[int], StateMachine],
        storage: Storage | None = None,
        election_timeout: float = 0.5,
        heartbeat_interval: float = 0.1,
        session_timeout: float = 5.0,
        name: str = "raft",
        metrics: MetricsRegistry | None = None,
        groups: int | None = None,
    ) -> None:
        super().__init__()
        self.address = address
        self.boot_members: list[Address] = list(members)
        if address not in self.boot_members:
            self._joining = True
        else:
            self._joining = False
        self.transport = transport
        self.storage = storage or Storage(StorageLevel.MEMORY)
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.session_timeout = session_timeout
        self.name = name

        # Multi-raft keyspace sharding (docs/SHARDING.md): N groups, one
        # server plane. COPYCAT_GROUPS sets the count when the embedder
        # does not; COPYCAT_MULTI_GROUP=0 forces the single-group plane
        # regardless (the sharding A/B knob).
        if groups is None:
            groups = max(1, knobs.get_int("COPYCAT_GROUPS"))
        if not knobs.get_bool("COPYCAT_MULTI_GROUP"):
            groups = 1
        self.num_groups = groups
        self.single = groups == 1

        # knob-derived shared config (live on the server so tests can
        # flip the pump/lane attributes mid-run; groups read through
        # delegation properties)
        self._repl_pipeline = knobs.get_bool("COPYCAT_REPL_PIPELINE")
        self._repl_window = max(1, knobs.get_int("COPYCAT_REPL_WINDOW"))
        self._repl_depth = max(1, knobs.get_int("COPYCAT_REPL_DEPTH"))
        self._repl_max_inflight = max(self._repl_window, knobs.get_int(
            "COPYCAT_REPL_MAX_INFLIGHT",
            default=self._repl_window * self._repl_depth))
        self._strict_invariants = knobs.get_str(
            "COPYCAT_INVARIANTS", default="") == "strict"
        self._vector_pump = knobs.get_bool("COPYCAT_SERVER_VECTOR_PUMP")
        self._read_pump = knobs.get_bool("COPYCAT_SERVER_READ_PUMP")
        self._parallel_apply = knobs.get_bool("COPYCAT_PARALLEL_APPLY")
        self._apply_fuse = knobs.get_bool("COPYCAT_APPLY_FUSE")
        self._snap_enabled = knobs.get_bool("COPYCAT_SNAPSHOTS")
        self._snap_every = max(1, knobs.get_int("COPYCAT_SNAPSHOT_ENTRIES"))
        self._snap_retain = max(0, knobs.get_int(
            "COPYCAT_SNAPSHOT_RETAIN",
            default=max(64, self._repl_max_inflight)))
        self._snap_chunk = max(4096, knobs.get_int("COPYCAT_SNAP_CHUNK"))
        # Standalone ingress/proxy tier (docs/DEPLOYMENT.md): accept
        # ingress-kind ProxyRequests (and bind proxied sessions for
        # event relay) on any plane; `0` restores the in-server ingress
        # path bit-identically (single-group servers then register no
        # ProxyRequest handler at all).
        self._ingress_tier = knobs.get_bool("COPYCAT_INGRESS_TIER")
        # Edge read tier (docs/EDGE_READS.md): `0` keeps the subscriber
        # registry empty — no seeds, no deltas, the server-read plane
        # bit-identically (the A/B discipline's knob, shared with the
        # client side so one env var flips the whole plane)
        self._edge_enabled = knobs.get_bool("COPYCAT_EDGE_READS")
        self._snap_serializer = Serializer()
        self._fsync_on_commit = (
            self.storage.fsync == "commit"
            and self.storage.level is not StorageLevel.MEMORY)

        self._server = transport.server()
        self._client = transport.client()
        self._peer_connections: dict[Address, Connection] = {}
        self._closing = False

        # Server-level registry: shard.* ingress/routing series (the
        # per-group families live on the group registries and merge into
        # the stats surface under group= labels). On the single-group
        # plane the ONE group shares this registry object, so the
        # pre-refactor names/values are preserved exactly.
        self._metrics = metrics or MetricsRegistry()

        # Health plane (docs/OBSERVABILITY.md "Health & diagnosis"):
        # online anomaly detectors at a fixed cadence + the durable
        # black-box spill, created BEFORE the groups so boot-recovery
        # anomalies (corrupt meta, failed restores) already land in the
        # black-box. COPYCAT_HEALTH=0 removes all of it — no monitor
        # task, no health.* keys, no black-box file, no fsync timing —
        # the pre-health plane bit-identically (A/B).
        self._health_enabled = knobs.get_bool("COPYCAT_HEALTH")
        self._proxy_inflight = 0
        self.blackbox: BlackBox | None = None
        self.health: HealthMonitor | None = None
        # Retrospective telemetry (docs/OBSERVABILITY.md "Retrospective
        # telemetry"): the bounded series ring rides the health
        # monitor's cadence — no task of its own — so it exists exactly
        # when BOTH planes are on. COPYCAT_SERIES=0 removes the ring,
        # the /series routes, the series.*/slo.* keys and the slo_burn
        # detector, restoring the pre-series server bit-identically
        # (A/B). Built BEFORE the monitor: the monitor probes `series`
        # at construction to decide whether slo_burn runs.
        self.series: SeriesStore | None = None
        if self._health_enabled and knobs.get_bool("COPYCAT_SERIES"):
            self.series = SeriesStore(node=self.address, role="member",
                                      metrics=self._metrics)
        # Continuous profiling plane (docs/OBSERVABILITY.md
        # "Profiling"): a refcounted process-wide wall-stack sampler +
        # event-loop hold attribution — acquired BEFORE the monitor
        # (it probes `profiler` at construction to decide whether the
        # loop_stall detector runs) and released in _do_close.
        # COPYCAT_PROFILE=0 makes acquire a no-op returning None: no
        # sampler thread, no profile.* keys, no /profile routes (A/B).
        self.profiler = profiler.acquire(self._metrics,
                                         note_fn=self.health_note)
        if self._health_enabled:
            if self.storage.directory:
                self.blackbox = BlackBox(os.path.join(
                    self.storage.directory,
                    f"{self.name}-{self.address.port}.blackbox"))
                if self.blackbox.recovered:
                    self.blackbox.record(
                        "boot",
                        recovered_events=len(self.blackbox.recovered))
            self.health = HealthMonitor(self)

        def build_machine(g: int) -> StateMachine:
            if callable(state_machine) \
                    and not isinstance(state_machine, StateMachine):
                return state_machine(g)
            if g == 0:
                return state_machine
            # a bare instance with >1 groups: construct siblings from the
            # class — machines needing arguments must come via a factory
            return type(state_machine)()

        # Cross-group apply fusion (docs/SHARDING.md "Apply ordering"):
        # groups stage their device-eligible vector runs here instead of
        # paying one engine round each; the collector dispatches ONCE at
        # the end of the event-loop turn with mixed groups_idx rows —
        # one DeviceEngine.run_vector per server turn no matter how many
        # groups' commits advanced. COPYCAT_APPLY_FUSE=0 keeps the
        # per-group dispatch (the A/B lane). All groups share one engine
        # (docs/SHARDING.md), so mixing rows is free; per-group FIFO
        # holds because runs are staged in per-group log order and the
        # engine's stable group sort preserves row order within a group.
        # Initialized BEFORE the groups: boot recovery inside
        # RaftGroup.__init__ reaches flush_fused via _restore_snapshot.
        self._fused_runs: list[tuple[RaftGroup, list]] = []
        self._fuse_scheduled = False
        self._m_apply_fused = self._metrics.counter("apply.fused_dispatches")
        self._m_apply_fused_rows = self._metrics.histogram(
            "apply.fused_rows")
        self._m_apply_fused_groups = self._metrics.histogram(
            "apply.fused_groups")

        self.groups: list[RaftGroup] = []
        for g in range(groups):
            reg = self._metrics if self.single else MetricsRegistry()
            self.groups.append(RaftGroup(self, g, build_machine(g), reg))
        machine_cls = type(self.groups[0].state_machine)
        self._route_group_fn = getattr(machine_cls, "route_group", None)

        # Ingress-side phase histograms of the causal-tracing plane
        # (docs/OBSERVABILITY.md): fed only by traced requests. On the
        # single-group plane the registry is shared with group 0, so
        # the family sits in one snapshot either way.
        self._m_lat_ingress_queue = self._metrics.histogram(
            "latency.ingress_queue_ms")
        self._m_lat_proxy_hop = self._metrics.histogram(
            "latency.proxy_hop_ms")
        if not self.single:
            m = self._metrics
            self._m_shard_local = m.counter("shard.commands_local")
            self._m_shard_proxied = m.counter("shard.commands_proxied")
            self._m_shard_reads_local = m.counter("shard.reads_local")
            self._m_shard_reads_proxied = m.counter("shard.reads_proxied")
            self._m_shard_registers = m.counter("shard.register_fanouts")
            self._m_routed = {
                g: m.counter("shard.routed", group=str(g))
                for g in range(groups)}
        # per-(session, group) in-order dispatch chains: sub-blocks of
        # one session bound for one group leader are delivered strictly
        # in submission order, so the group can append in arrival order
        # (the gapped-staging contract of RaftGroup.command_block)
        self._chains: dict[tuple, asyncio.Future] = {}
        # last known client connection per session (multi-group): group
        # replicas late-bind it when their RegisterEntry applies — the
        # ingress's follower apply can land AFTER the client's first
        # requests touched the (then-nonexistent) replica
        self._session_conns: dict[int, Connection] = {}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def _do_open(self) -> None:
        self._closing = False
        await self._server.listen(self.address, self._accept)
        if self._joining:
            await self._join_cluster()
        for grp in self.groups:
            grp.start()
        if self.health is not None:
            self.health.start()
        logger.info("%s listening at %s (members=%s, groups=%d)", self.name,
                    self.address, self.groups[0].members, self.num_groups)

    async def _do_close(self) -> None:
        self._closing = True
        try:
            # staged-but-undispatched fused rows complete (and ack)
            # before the groups fail whatever else is pending
            self.flush_fused()
        except Exception:  # noqa: BLE001 — close must proceed
            logger.exception("fused apply flush at close failed")
        if self.health is not None:
            self.health.stop()
        for grp in self.groups:
            grp.shutdown()
        await self._server.close()
        await self._client.close()
        self._peer_connections.clear()
        if self.blackbox is not None:
            self.blackbox.close()
        # last release per process stops the sampler + unpatches the
        # loop; _cancel_timers (the SIGKILL-shaped stop) deliberately
        # does NOT release — a crash doesn't run destructors either
        profiler.release(self.profiler, self._metrics)
        self.profiler = None

    def _cancel_timers(self) -> None:
        # crash_server (testing/nemesis.py) calls this for its
        # SIGKILL-shaped stop: the health pump dies with the process too
        # (the black-box file handle is deliberately NOT closed — a
        # crash leaves whatever the last flush wrote, nothing more)
        if self.health is not None:
            self.health.stop()
        for grp in self.groups:
            grp._cancel_timers()

    def _stop_replication(self) -> None:
        for grp in self.groups:
            grp._stop_replication()

    async def leave(self) -> None:
        """Gracefully leave the cluster (reference server leave test
        path). Membership rides the metadata group's log; the applied
        configuration propagates to every group."""
        g0 = self.groups[0]
        if g0.role == LEADER:
            await g0._append_and_wait(ConfigurationEntry(
                members=[m for m in g0.members if m != self.address]))
        else:
            conn = await self._leader_connection()
            if conn is not None:
                response = await conn.send(
                    msg.LeaveRequest(member=self.address))
                response.raise_if_error()

    # ------------------------------------------------------------------
    # connections
    # ------------------------------------------------------------------

    def _accept(self, connection: Connection) -> None:
        # raft RPCs route through the server-level shims below (attribute
        # lookup at call time: nemesis/tests may patch them per instance),
        # which demultiplex on the wire ``group`` field
        connection.handler(msg.VoteRequest, lambda m: self._on_vote(m))
        connection.handler(msg.AppendRequest, lambda m: self._on_append(m))
        connection.handler(msg.InstallRequest,
                           lambda m: self._on_install(m))
        if self.single:
            g0 = self.groups[0]
            connection.handler(
                msg.RegisterRequest,
                lambda m: g0._on_register(connection, m))
            connection.handler(
                msg.KeepAliveRequest,
                lambda m: g0._on_keepalive(connection, m))
            connection.handler(msg.UnregisterRequest, g0._on_unregister)
            connection.handler(
                msg.CommandRequest,
                lambda m: g0._on_command(connection, m))
            connection.handler(
                msg.CommandBatchRequest,
                lambda m: g0._on_command_batch(connection, m))
            connection.handler(msg.QueryRequest, g0._on_query)
            connection.handler(msg.QueryBatchRequest, g0._on_query_batch)
            if self._ingress_tier:
                # standalone ingress proxies (docs/DEPLOYMENT.md) speak
                # ProxyRequest to single-group clusters too; with
                # COPYCAT_INGRESS_TIER=0 the handler is not registered
                # and the pre-deployment wire surface is bit-identical
                connection.handler(
                    msg.ProxyRequest,
                    lambda m: self._on_proxy(connection, m))
        else:
            connection.handler(
                msg.RegisterRequest,
                lambda m: self._ms_register(connection, m))
            connection.handler(
                msg.KeepAliveRequest,
                lambda m: self._ms_keepalive(connection, m))
            connection.handler(msg.UnregisterRequest, self._ms_unregister)
            connection.handler(
                msg.CommandRequest,
                lambda m: self._ms_command(connection, m))
            connection.handler(
                msg.CommandBatchRequest,
                lambda m: self._ms_command_batch(connection, m))
            connection.handler(msg.QueryRequest, self._ms_query)
            connection.handler(msg.QueryBatchRequest, self._ms_query_batch)
            connection.handler(msg.ProxyRequest,
                               lambda m: self._on_proxy(connection, m))
        connection.handler(msg.JoinRequest, self._on_join)
        connection.handler(msg.LeaveRequest, self._on_leave)

    def _group_of(self, request: Any) -> RaftGroup:
        g = getattr(request, "group", None) or 0
        if not 0 <= g < self.num_groups:
            # a mixed-config cluster (different COPYCAT_GROUPS /
            # COPYCAT_MULTI_GROUP per member) must surface loudly at the
            # sender, not as an anonymous IndexError in the handler
            raise msg.ProtocolError(
                msg.INTERNAL,
                f"group {g} not hosted here (this member runs "
                f"{self.num_groups} group(s)) — the group count must be "
                f"uniform across the cluster (docs/SHARDING.md)")
        return self.groups[g]

    async def _on_vote(self, request: msg.VoteRequest) -> msg.VoteResponse:
        return await self._group_of(request)._on_vote(request)

    async def _on_append(self, request: msg.AppendRequest
                         ) -> msg.AppendResponse:
        return await self._group_of(request)._on_append(request)

    async def _on_install(self, request: msg.InstallRequest
                          ) -> msg.InstallResponse:
        return await self._group_of(request)._on_install(request)

    async def _peer_connection(self, peer: Address) -> Connection | None:
        conn = self._peer_connections.get(peer)
        if conn is not None and not conn.closed:
            return conn
        try:
            conn = await self._client.connect(peer)
        except (TransportError, OSError):
            return None
        self._peer_connections[peer] = conn
        return conn

    async def _leader_connection(self) -> Connection | None:
        leader = self.groups[0].leader_address
        if leader is None or leader == self.address:
            return None
        return await self._peer_connection(leader)

    # ------------------------------------------------------------------
    # membership (rides the metadata group's log)
    # ------------------------------------------------------------------

    async def _join_cluster(self) -> None:
        for attempt in range(20):
            for member in self.boot_members:
                if member == self.address:
                    continue
                conn = None
                try:
                    conn = await self._client.connect(member)
                    response = await asyncio.wait_for(
                        conn.send(msg.JoinRequest(member=self.address)), 2.0)
                except (TransportError, OSError, asyncio.TimeoutError):
                    continue
                if response.ok:
                    self._adopt_members(list(response.members))
                    self._joining = False
                    return
                if response.error == msg.NOT_LEADER and response.leader:
                    try:
                        conn2 = await self._client.connect(response.leader)
                        response = await asyncio.wait_for(
                            conn2.send(msg.JoinRequest(member=self.address)),
                            2.0)
                        if response.ok:
                            self._adopt_members(list(response.members))
                            self._joining = False
                            return
                    except (TransportError, OSError, asyncio.TimeoutError):
                        continue
            await asyncio.sleep(0.2)
        raise msg.ProtocolError(msg.NO_LEADER, "unable to join cluster")

    def _adopt_members(self, members: list[Address]) -> None:
        for grp in self.groups:
            grp.members = list(members)

    def _membership_applied(self, members: list[Address]) -> None:
        """Group 0 applied a ConfigurationEntry: propagate the view to
        groups 1..G-1 (multi-group only; see RaftGroup._apply_configuration
        for the single-group/metadata-group behavior)."""
        for grp in self.groups[1:]:
            grp._adopt_members(members)

    async def _on_join(self, request: msg.JoinRequest) -> msg.JoinResponse:
        g0 = self.groups[0]
        if g0.role != LEADER:
            return msg.JoinResponse(error=msg.NOT_LEADER,
                                    leader=g0.leader_address)
        member = request.member
        if member not in g0.members:
            new_members = g0.members + [member]
            await g0._append_and_wait(
                ConfigurationEntry(members=new_members))
        return msg.JoinResponse(members=g0.members)

    async def _on_leave(self, request: msg.LeaveRequest) -> msg.LeaveResponse:
        g0 = self.groups[0]
        if g0.role != LEADER:
            return msg.LeaveResponse(error=msg.NOT_LEADER,
                                     leader=g0.leader_address)
        member = request.member
        if member in g0.members:
            new_members = [m for m in g0.members if m != member]
            await g0._append_and_wait(
                ConfigurationEntry(members=new_members))
        return msg.LeaveResponse(members=g0.members)

    # ------------------------------------------------------------------
    # multi-group ingress: routing, proxying, aggregation
    # (docs/SHARDING.md — only wired when ``groups > 1``)
    # ------------------------------------------------------------------

    def _route(self, operation: Any) -> int:
        """The owning group for one operation: the state machine class's
        ``route_group`` (hash routing over resource keys / instance ids
        for the ResourceManager), deterministic across members and
        restarts; operations without affinity land on group 0."""
        fn = self._route_group_fn
        if fn is None:
            return 0
        g = fn(operation, self.num_groups)
        return g if 0 <= g < self.num_groups else 0

    def _client_index(self, index: Any, g: int) -> int:
        """Extract the client's per-group read high-water from a request
        ``index`` field: multi-group clients send ``{group: index}``."""
        if isinstance(index, dict):
            return index.get(g, 0) or 0
        if g == 0 and isinstance(index, int):
            return index
        return 0

    def _tag_index(self, index: int, g: int) -> int:
        """Stamp a per-group log index with its group so the client can
        keep per-group read cursors: ``index * G + g`` (group 0 keeps
        untagged-compatible residue 0)."""
        return index * self.num_groups + g if index else index

    def _touch_session(self, session_id: int, connection: Connection,
                       now: float) -> None:
        """Attach the client's connection + contact time to every LOCAL
        group replica of the session. The ingress (this member) pushes
        each group's events from its own apply of that group's log —
        replicas that have not applied their RegisterEntry yet are
        attached on the next touch (events meanwhile queue in the
        replicated event queue and flush on the next keep-alive)."""
        g0 = self.groups[0]
        if (session_id in g0.sessions
                or g0.last_applied * self.num_groups < session_id):
            # record for late-binding replicas ONLY while the session is
            # live here or its register has not applied locally yet — a
            # straggler request after the unregister applied would
            # otherwise re-insert and pin its Connection forever (the
            # group-0 unregister apply is the map's removal path)
            self._session_conns[session_id] = connection
        for grp in self.groups:
            session = grp.sessions.get(session_id)
            if session is not None:
                attached = session.connection is not connection
                session.connection = connection
                session.last_contact = now
                if attached and session.event_queue:
                    # events sealed while no (or a dead) connection was
                    # bound: deliver now instead of at the next keep-alive
                    grp._flush_events(session)

    async def _chained(self, key: tuple, thunk: Callable) -> Any:
        """Launch-order gate per (session, group): consecutive
        sub-blocks of one session bound for one group are handed to the
        transport (or the local group's synchronous staging prefix) in
        submission order — which both transports and the handler
        dispatch preserve end to end — WITHOUT serializing the round
        trips, so a session can keep a full pipeline of blocks in
        flight (the ingress stays windowed, not stop-and-wait). During
        a failover window the proxy's retry loop can still reorder
        relative to a later wave; the group's dedup then fails those
        ops LOUDLY (seq-below-cursor errors), never silently
        (docs/SHARDING.md "failover windows")."""
        from ..utils.tasks import spawn

        loop = asyncio.get_running_loop()
        prev = self._chains.get(key)
        gate: asyncio.Future = loop.create_future()
        self._chains[key] = gate
        try:
            if prev is not None:
                await asyncio.shield(prev)
            task = spawn(thunk(), name="dispatch-commands")
        finally:
            # launched (or failed to): the NEXT sub-block may launch;
            # FIFO task scheduling runs the synchronous send/stage
            # prefixes in creation order
            if not gate.done():
                gate.set_result(None)
            if self._chains.get(key) is gate:
                del self._chains[key]
        return await task

    def _trace_span(self, trace: int, name: str, t0: float, t1: float,
                    hist=None, **meta: Any) -> None:
        """Ingress-side causal span (utils/tracing.py vocabulary),
        tagged with this member so the cross-member assembly can place
        the ingress phases, plus the matching ``latency.*`` histogram."""
        TRACER.span(trace, name, t0, t1, member=str(self.address), **meta)
        if hist is not None:
            hist.record((t1 - t0) * 1e3)

    async def _proxy(self, g: int, kind: str, payload: Any,
                     trace: int | None = None) -> msg.ProxyResponse:
        """Dispatch one staged sub-request to group ``g``'s leader —
        locally when this member leads the group, else as a ProxyRequest
        over the peer connection, retrying toward the group's current
        leader view (which updates via the group's own append stream).
        ``trace`` (the originating trace id) rides the ProxyRequest's
        optional trailing field; each wire attempt records a
        ``proxy.hop`` span (failed attempts tagged ``error=``)."""
        # in-flight accounting feeds the health plane's ingress-backlog
        # detector: sub-requests parked in the retry loop (a saturated
        # or unreachable group leader) are exactly the backlog
        self._proxy_inflight += 1
        try:
            return await self._proxy_dispatch(g, kind, payload, trace)
        finally:
            self._proxy_inflight -= 1

    async def _proxy_dispatch(self, g: int, kind: str, payload: Any,
                              trace: int | None = None
                              ) -> msg.ProxyResponse:
        grp = self.groups[g]
        backoff = 0.01
        # the per-try budget must cover COMMIT latency, not just the
        # wire: under window saturation a staged sub-block legitimately
        # waits out the whole replication queue before its outcome
        # exists, and a timeout here CANCELS the in-flight send —
        # re-sending a block whose first copy already appended (found by
        # the sharded bench at full depth: retry storms surfacing as
        # seq-below-cursor errors). Routing refusals (NOT_LEADER) come
        # back fast regardless, so retry responsiveness keeps.
        try_budget = max(self.session_timeout, self.election_timeout * 4)
        deadline = time.monotonic() + max(self.session_timeout,
                                          self.election_timeout * 8)
        while True:
            if self._closing:
                return msg.ProxyResponse(error=msg.NO_LEADER,
                                         error_detail="server closing")
            if grp.role == LEADER:
                return await self._proxy_local(grp, kind, payload, trace)
            leader = grp.leader_address
            response = None
            if leader is not None and leader != self.address:
                conn = await self._peer_connection(leader)
                if conn is not None:
                    t_hop = (time.perf_counter() if trace is not None
                             else 0.0)
                    try:
                        response = await asyncio.wait_for(
                            conn.send(msg.ProxyRequest(
                                group=g, kind=kind, payload=payload,
                                trace=trace)),
                            try_budget)
                    except (TransportError, OSError, asyncio.TimeoutError):
                        response = None
                    if trace is not None:
                        if response is not None:
                            self._trace_span(trace, "proxy.hop", t_hop,
                                             time.perf_counter(),
                                             self._m_lat_proxy_hop,
                                             group=g, to=str(leader))
                        else:
                            # the failed attempt stays on the timeline:
                            # an assembly missing the group-side spans
                            # shows WHERE the request died
                            self._trace_span(trace, "proxy.hop", t_hop,
                                             time.perf_counter(),
                                             self._m_lat_proxy_hop,
                                             group=g, to=str(leader),
                                             error="unreachable")
            if response is not None and response.error not in (
                    msg.NOT_LEADER, msg.NO_LEADER):
                return response
            if time.monotonic() > deadline:
                return (response if response is not None
                        else msg.ProxyResponse(
                            error=msg.NO_LEADER,
                            error_detail=f"group {g} has no reachable "
                                         f"leader"))
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 0.1)

    async def _on_proxy(self, connection: Connection,
                        request: msg.ProxyRequest) -> msg.ProxyResponse:
        trace = request.trace
        kind = request.kind
        grp = self._group_of(request)
        from_ingress = kind.startswith("ingress:")
        if from_ingress:
            # a standalone ingress proxy (docs/DEPLOYMENT.md): same
            # staging entry points, PLUS this member binds the proxied
            # session to the ingress's connection so event pushes flow
            # member -> ingress -> client. The prefix is data, not
            # schema — the wire frames are unchanged.
            if not self._ingress_tier:
                return msg.ProxyResponse(
                    error=msg.INTERNAL,
                    error_detail="ingress tier disabled on this member "
                                 "(COPYCAT_INGRESS_TIER=0)")
            kind = kind[len("ingress:"):]
        response = await self._proxy_local(grp, kind, request.payload,
                                           trace)
        if from_ingress and not response.error:
            self._bind_ingress_session(grp, kind, request.payload,
                                       response, connection)
        if trace is not None:
            response.trace = trace  # echo: the hop stays correlated
        return response

    def _bind_ingress_session(self, grp: RaftGroup, kind: str,
                              payload: Any, response: msg.ProxyResponse,
                              connection: Connection) -> None:
        """Attach an ingress-proxied session to the ingress's peer
        connection on THIS group's replica (the ingress holds the real
        client connection and relays pushes). The binding follows the
        proxy stream: after a leader change the next proxied
        keep-alive/command lands here and re-binds on the new leader —
        events meanwhile queue in the replicated event queue, exactly
        the reconnect contract direct clients get."""
        if kind == "register":
            sid = response.result
        elif kind in ("keepalive", "commands"):
            sid = payload[0]
        elif kind == "unregister":
            return  # the unregister apply removed the session
        else:
            return
        session = grp.sessions.get(sid)
        if session is None:
            return
        attached = session.connection is not connection
        session.connection = connection
        session.last_contact = time.monotonic()
        if (attached or kind == "keepalive") and session.event_queue:
            grp._flush_events(session)

    async def _proxy_local(self, grp: RaftGroup, kind: str, payload: Any,
                           trace: int | None = None) -> msg.ProxyResponse:
        """Serve one staged sub-request on a group this member leads
        (the proxy handler on the receiving leader, and the local
        shortcut at the ingress)."""
        try:
            if kind == "commands":
                session_id, entries = payload
                out, err = await grp.command_block(session_id,
                                                   [tuple(e)
                                                    for e in entries],
                                                   trace)
                if err is not None:
                    code, detail, leader = err
                    return msg.ProxyResponse(error=code, error_detail=detail,
                                             leader=leader)
                return msg.ProxyResponse(result=out)
            if kind == "register":
                client_id, timeout, session_id = payload
                if grp.role != LEADER:
                    return grp._not_leader(msg.ProxyResponse)
                _, sid, _ = await grp.register_local(client_id, timeout,
                                                     session_id)
                return msg.ProxyResponse(result=sid)
            if kind == "keepalive":
                session_id, command_seq, event_index = payload
                if grp.role != LEADER:
                    return grp._not_leader(msg.ProxyResponse)
                session = grp.sessions.get(session_id)
                if session is None \
                        or session.state is not SessionState.OPEN:
                    return grp._session_missing(msg.ProxyResponse)
                await grp.keepalive_local(session_id, command_seq,
                                          event_index)
                return msg.ProxyResponse(result=True)
            if kind == "unregister":
                session_id = payload
                if grp.role != LEADER:
                    return grp._not_leader(msg.ProxyResponse)
                if session_id in grp.sessions:
                    await grp.unregister_local(session_id)
                return msg.ProxyResponse(result=True)
            if kind == "query":
                session_id, client_index, consistency, operations = payload
                index, entries, err = await grp.serve_query(
                    session_id, client_index,
                    QueryConsistency(consistency), list(operations))
                if err is not None:
                    code, detail, leader = err
                    return msg.ProxyResponse(error=code, error_detail=detail,
                                             leader=leader)
                return msg.ProxyResponse(result=(index, entries))
        except msg.ProtocolError as e:
            return msg.ProxyResponse(error=e.code, error_detail=e.detail,
                                     leader=e.leader)
        return msg.ProxyResponse(error=msg.INTERNAL,
                                 error_detail=f"unknown proxy kind {kind!r}")

    # -- session ingress (multi-group handlers) ------------------------

    async def _ms_register(self, connection: Connection,
                           request: msg.RegisterRequest
                           ) -> msg.RegisterResponse:
        timeout = request.timeout or self.session_timeout
        self._m_shard_registers.inc()
        response = await self._proxy(
            0, "register", (request.client_id, timeout, None))
        if response.error:
            return msg.RegisterResponse(error=response.error,
                                        leader=None,
                                        members=self.groups[0].members)
        sid = response.result
        outs = await asyncio.gather(*(
            self._proxy(g, "register", (request.client_id, timeout, sid))
            for g in range(1, self.num_groups)))
        for out in outs:
            if out.error:
                # a keyspace slice has no session: fail the register;
                # the client retries (the orphaned replicas expire by
                # timeout, never having served a command)
                return msg.RegisterResponse(
                    error=out.error, error_detail=out.error_detail,
                    members=self.groups[0].members)
        self._touch_session(sid, connection, time.monotonic())
        return msg.RegisterResponse(session_id=sid, timeout=timeout,
                                    members=self.groups[0].members,
                                    groups=self.num_groups)

    async def _ms_keepalive(self, connection: Connection,
                            request: msg.KeepAliveRequest
                            ) -> msg.KeepAliveResponse:
        sid = request.session_id
        members = self.groups[0].members
        # no local liveness precheck: this member's follower replicas may
        # lag the register apply — each group's LEADER is authoritative
        # (the group-0 proxy outcome decides UNKNOWN_SESSION below)
        self._touch_session(sid, connection, time.monotonic())
        if getattr(request, "unsubscribe", None):
            # member-local edge bookkeeping (docs/EDGE_READS.md): evicted
            # instances retire from whichever group's registry holds them
            for grp in self.groups:
                grp.edge_unsubscribe(sid, request.unsubscribe)
        ev = request.event_index
        seq = request.command_seq or 0

        def ev_for(g: int) -> int:
            if isinstance(ev, dict):
                return ev.get(g, 0) or 0
            return (ev or 0) if g == 0 else 0

        outs = await asyncio.gather(*(
            self._proxy(g, "keepalive", (sid, seq, ev_for(g)))
            for g in range(self.num_groups)))
        if outs[0].error:
            return msg.KeepAliveResponse(error=outs[0].error,
                                         members=members)
        # resend whatever each local replica still holds unacked (the
        # ingress owns every group's event channel for this session)
        for grp in self.groups:
            session = grp.sessions.get(sid)
            if session is not None:
                grp._flush_events(session)
        return msg.KeepAliveResponse(members=members)

    async def _ms_unregister(self, request: msg.UnregisterRequest
                             ) -> msg.UnregisterResponse:
        outs = await asyncio.gather(*(
            self._proxy(g, "unregister", request.session_id)
            for g in range(self.num_groups)))
        first = outs[0]
        if first.error and first.error != msg.UNKNOWN_SESSION:
            return msg.UnregisterResponse(error=first.error,
                                          leader=first.leader)
        return msg.UnregisterResponse()

    async def _dispatch_commands(self, g: int, session_id: int, sub: list,
                                 trace: int | None = None,
                                 t0: float = 0.0) -> Any:
        """One group's command sub-block, in per-(session, group) order;
        returns the tagged per-entry outcomes, or ``(code, detail,
        leader)`` for a response-level failure. When traced, the wait
        from ingress receipt (``t0``) until the dispatch chain released
        this sub-block records as ``ingress.queue``."""
        grp = self.groups[g]
        if grp.role == LEADER:
            self._m_shard_local.inc(len(sub))
        else:
            self._m_shard_proxied.inc(len(sub))
        self._m_routed[g].inc(len(sub))

        async def dispatch() -> msg.ProxyResponse:
            if trace is not None:
                self._trace_span(trace, "ingress.queue", t0,
                                 time.perf_counter(),
                                 self._m_lat_ingress_queue, group=g,
                                 n=len(sub))
            return await self._proxy(g, "commands", (session_id, sub),
                                     trace)

        response = await self._chained((session_id, g), dispatch)
        if response.error:
            return (response.error, response.error_detail or "",
                    response.leader)
        out = response.result or []
        return [(seq, self._tag_index(idx, g), res, code, det)
                for seq, idx, res, code, det in (tuple(e) for e in out)]

    async def _ms_command_batch(self, connection: Connection,
                                request: msg.CommandBatchRequest
                                ) -> msg.CommandBatchResponse:
        sid = request.session_id
        # group leaders are authoritative for session liveness (this
        # member's replicas may lag the register apply); rep0 only feeds
        # the response's event_index when already present
        rep0 = self.groups[0].sessions.get(sid)
        self._touch_session(sid, connection, time.monotonic())
        entries = request.entries or []
        trace = request.trace
        t0 = time.perf_counter() if trace is not None else 0.0
        buckets: dict[int, list] = {}
        for seq, op in entries:
            buckets.setdefault(self._route(op), []).append((seq, op))
        results = await asyncio.gather(*(
            self._dispatch_commands(g, sid, sub, trace, t0)
            for g, sub in buckets.items()))
        merged: dict[int, tuple] = {}
        for res in results:
            if isinstance(res, tuple):  # response-level (code, detail, ...)
                code, detail, leader = res
                return msg.CommandBatchResponse(
                    error=code, error_detail=detail, leader=leader)
            for entry in res:
                merged[entry[0]] = entry
        out = [merged.get(seq, (seq, 0, None, msg.INTERNAL,
                                "sub-block outcome missing"))
               for seq, _ in entries]
        return msg.CommandBatchResponse(
            event_index=rep0.event_index if rep0 is not None else 0,
            entries=out)

    async def _ms_command(self, connection: Connection,
                          request: msg.CommandRequest
                          ) -> msg.CommandResponse:
        sid = request.session_id
        rep0 = self.groups[0].sessions.get(sid)
        self._touch_session(sid, connection, time.monotonic())
        g = self._route(request.operation)
        trace = request.trace
        res = await self._dispatch_commands(
            g, sid, [(request.seq, request.operation)], trace,
            time.perf_counter() if trace is not None else 0.0)
        if isinstance(res, tuple):
            code, detail, leader = res
            return msg.CommandResponse(error=code, error_detail=detail,
                                       leader=leader)
        event_index = rep0.event_index if rep0 is not None else 0
        _, index, result, code, detail = res[0]
        if code:
            return msg.CommandResponse(error=code, error_detail=detail,
                                       index=index,
                                       event_index=event_index)
        return msg.CommandResponse(index=index, result=result,
                                   event_index=event_index)

    async def _serve_reads(self, g: int, session_id: int, index: Any,
                           consistency: QueryConsistency, operations: list
                           ) -> tuple[int, list | None, tuple | None]:
        """Route one group's read bucket: leaders (and, for
        sequential/causal levels, any member — this one) serve locally;
        linearizable levels on remotely-led groups proxy to the leader so
        the reads join ITS read window and share its confirm round."""
        grp = self.groups[g]
        ci = self._client_index(index, g)
        leader_required = consistency in (
            QueryConsistency.LINEARIZABLE,
            QueryConsistency.BOUNDED_LINEARIZABLE)
        if leader_required and grp.role != LEADER:
            self._m_shard_reads_proxied.inc(len(operations))
            response = await self._proxy(
                g, "query",
                (session_id, ci, consistency.value, operations))
            if response.error:
                return 0, None, (response.error,
                                 response.error_detail or "",
                                 response.leader)
            served_index, entries = response.result
            return served_index, entries, None
        self._m_shard_reads_local.inc(len(operations))
        return await grp.serve_query(session_id, ci, consistency,
                                     operations)

    def _ms_edge_seed(self, request: Any, g: int,
                      operations: list, served_index: int) -> list | None:
        """Multi-group edge registration (docs/EDGE_READS.md): the
        ingress (this member) holds the session's connection AND
        applies every group's log, so it both registers and pushes.
        Seeds ride group-LOCAL versions — instance ids are self-routing
        (``iid % groups``), so the client recovers the group."""
        if not getattr(request, "subscribe", None):
            return None
        consistency = QueryConsistency(request.consistency or "linearizable")
        if consistency in (QueryConsistency.LINEARIZABLE,
                           QueryConsistency.BOUNDED_LINEARIZABLE):
            return None  # linearizable levels never serve from the edge
        return self.groups[g].edge_register(
            request.session_id, operations, served_index)

    async def _ms_query(self, request: msg.QueryRequest
                        ) -> msg.QueryResponse:
        consistency = QueryConsistency(request.consistency or "linearizable")
        g = self._route(request.operation)
        served_index, entries, err = await self._serve_reads(
            g, request.session_id, request.index, consistency,
            [request.operation])
        if err is not None:
            code, detail, _leader = err
            if code in (msg.NOT_LEADER, msg.NO_LEADER):
                # the single-group shape: the client treats this as
                # "re-route"; any member can ingress, so no leader pin
                return msg.QueryResponse(error=code)
            return msg.QueryResponse(error=code, error_detail=detail)
        result, code, detail = entries[0]
        tagged = self._tag_index(served_index, g)
        if code:
            return msg.QueryResponse(error=code, error_detail=detail,
                                     index=tagged)
        response = msg.QueryResponse(index=tagged, result=result)
        seeds = self._ms_edge_seed(request, g, [request.operation],
                                   served_index)
        if seeds:
            response.edge = seeds
        return response

    async def _ms_query_batch(self, request: msg.QueryBatchRequest
                              ) -> msg.QueryBatchResponse:
        consistency = QueryConsistency(request.consistency or "linearizable")
        operations = request.operations or []
        buckets: dict[int, list] = {}  # g -> [(pos, op)]
        for pos, op in enumerate(operations):
            buckets.setdefault(self._route(op), []).append((pos, op))
        outs = await asyncio.gather(*(
            self._serve_reads(g, request.session_id, request.index,
                              consistency, [op for _, op in sub])
            for g, sub in buckets.items()))
        entries: list = [None] * len(operations)
        index: dict[int, int] = {}
        edge: list = []
        for (g, sub), (served_index, served, err) in zip(buckets.items(),
                                                         outs):
            if err is not None:
                code, detail, _leader = err
                if code in (msg.NOT_LEADER, msg.NO_LEADER):
                    return msg.QueryBatchResponse(error=code)
                return msg.QueryBatchResponse(error=code,
                                              error_detail=detail)
            if served_index:
                index[g] = served_index
            for (pos, _op), entry in zip(sub, served):
                entries[pos] = tuple(entry)
            seeds = self._ms_edge_seed(request, g, [op for _, op in sub],
                                       served_index)
            if seeds:
                edge.extend(seeds)
        response = msg.QueryBatchResponse(index=index, entries=entries)
        if edge:
            response.edge = edge
        return response

    # ------------------------------------------------------------------
    # cross-group apply fusion (docs/SHARDING.md "Apply ordering")
    # ------------------------------------------------------------------

    def stage_vector_run(self, grp: RaftGroup, run: list) -> None:
        """Stage one group's vector run for the turn's fused dispatch.

        The dispatch runs at the end of the current event-loop turn
        (``call_soon``), so every group whose commit advanced this turn
        contributes rows to ONE engine round; a group that hits a
        dependency conflict before then forces :meth:`flush_fused`
        inline (the staged effects must land before the conflicting
        entry applies)."""
        self._fused_runs.append((grp, run))
        if self._fuse_scheduled:
            return
        self._fuse_scheduled = True
        try:
            asyncio.get_running_loop().call_soon(self._fused_tick)
        except RuntimeError:
            # no running loop (synchronous replay harness): dispatch now
            self.flush_fused()

    def _fused_tick(self) -> None:
        try:
            self.flush_fused()
        except Exception:  # noqa: BLE001 — a loop callback must not raise
            logger.exception("fused apply dispatch failed")

    def flush_fused(self) -> None:
        """Dispatch every staged run as ONE mixed-rows engine round,
        then finalize per group in staging (= per-group log) order.
        Forced synchronously by dependency conflicts, gated reads,
        snapshot captures and server close; otherwise runs once per
        event-loop turn. An empty collector is a free no-op (every
        forced-flush site relies on that).

        The documented architecture shares ONE engine across groups
        (``_manager_factory``), so the partition below is normally a
        single round; an embedder wiring per-group engines still gets
        correct (per-engine) dispatches instead of corrupted mixed
        ``groups_idx`` rows."""
        self._fuse_scheduled = False
        staged, self._fused_runs = self._fused_runs, []
        if not staged:
            return
        engines: list = []   # insertion-ordered; runs stay in log order
        per_engine: dict[int, list] = {}
        for grp, run in staged:
            engine = grp.state_machine.device_engine
            bucket = per_engine.get(id(engine))
            if bucket is None:
                bucket = per_engine[id(engine)] = []
                engines.append(engine)
            bucket.append((grp, run))
        for engine in engines:
            self._flush_fused_engine(engine, per_engine[id(engine)])

    def _flush_fused_engine(self, engine, staged: list) -> None:
        rows = [row for _, run in staged for row in run]
        self._m_apply_fused.inc()
        self._m_apply_fused_rows.record(len(rows))
        self._m_apply_fused_groups.record(
            len({g.group_id for g, _ in staged}))
        # mid-batch forced flushes drain the window's in-flight
        # generator chains from EARLIER entries inside the shared
        # dispatch helper, so each group's device-op order follows its
        # log
        raws, pump_error = dispatch_vector_rows(engine, engine.window,
                                                rows)
        offset = 0
        for grp, run in staged:
            grp._finalize_vector_run(
                run,
                raws[offset:offset + len(run)] if pump_error is None
                else [], pump_error)
            offset += len(run)

    def drop_fused(self, grp: RaftGroup) -> None:
        """Discard ``grp``'s staged rows (group shutdown: its commit
        futures are failing with NO_LEADER and a restart replays the
        uncleaned entries from the log)."""
        if self._fused_runs:
            self._fused_runs = [(g, r) for g, r in self._fused_runs
                                if g is not grp]
        grp._stage_keys.clear()
        grp._stage_sessions.clear()
        grp._stage_rows = 0

    # ------------------------------------------------------------------
    # observability (docs/OBSERVABILITY.md)
    # ------------------------------------------------------------------

    def metrics_server_registry(self) -> MetricsRegistry:
        """The SERVER-level registry object (shared with group 0 on the
        single-group plane) — where the health monitor registers the
        ``health.*`` family, so it rides every snapshot un-labeled."""
        return self._metrics

    def health_sample(self) -> dict:
        """Server-scope sample for the health monitor (the per-group
        half is ``RaftGroup.health_sample``): the ingress/proxy plane's
        backlog signals."""
        return {
            "proxy_inflight": self._proxy_inflight,
            "event_backlog": sum(
                len(s.event_queue) for grp in self.groups
                for s in grp.sessions.values()),
        }

    def series_tick(self) -> None:
        """One retained metric sample if due — called from the health
        monitor's tick (the series plane spawns no task of its own;
        ``utils/timeseries.py``). No-op without a series store."""
        if self.series is not None:
            self.series.maybe_sample(self._series_snapshot)

    def _series_snapshot(self) -> dict:
        """What the series ring retains: the merged raft registry (all
        per-group families under ``group=`` labels plus the server
        families — health.*, slo.*, series.* included), with the lazy
        gauges refreshed so role/term/lag are current at the sample."""
        for grp in self.groups:
            grp.refresh_gauges()
        return self.metrics.snapshot()

    def device_flight(self) -> tuple[Any, int]:
        """``(flight ring, current engine round)`` when the server runs
        the TPU executor with an instantiated, telemetry-enabled engine
        (raw ``_engine`` read — never trigger the lazy jit build);
        ``(None, 0)`` otherwise. All groups share one engine
        (docs/SHARDING.md), so group 0's is THE hub."""
        engine = getattr(self.groups[0].state_machine, "_engine", None)
        groups = getattr(engine, "_groups", None)
        hub = getattr(groups, "telemetry", None)
        if hub is None:
            return None, 0
        return hub.flight, getattr(groups, "rounds", 0)

    def _attach_flight_spill(self) -> None:
        """Lazily wire the flight ring's spill to the black-box (the
        engine is built lazily): nemesis faults, invariant violations
        and telemetry notes recorded into the ring then also survive a
        crash. The ONE place the wiring lives — health_note and the
        monitor's tick both route through here."""
        flight, _ = self.device_flight()
        if flight is not None and flight.spill is None \
                and self.blackbox is not None:
            flight.spill = self.blackbox.spill_event

    def health_note(self, kind: str, group: int | None = None,
                    **fields) -> None:
        """Durable health note: into the device flight ring when an
        engine hub exists (its spill forwards to the black-box), else
        straight to the black-box. Never raises — observability must
        never wound the server."""
        try:
            if group is not None:
                fields["group"] = group
            self._attach_flight_spill()
            flight, rounds = self.device_flight()
            if flight is not None:
                flight.record(kind, rounds, **fields)
            elif self.blackbox is not None:
                self.blackbox.record(kind, **fields)
        except Exception:  # noqa: BLE001
            pass

    @property
    def metrics(self) -> MetricsRegistry:
        """The raft registry: group 0's registry object on the
        single-group plane (bit-identical to the pre-refactor server);
        a merged view — per-group families under ``group=`` labels plus
        the server-level ``shard.*`` series — when multi-group."""
        if self.single:
            return self._metrics
        merged = MetricsRegistry()
        for grp in self.groups:
            merged.merge(grp.metrics, group=str(grp.group_id))
        merged.merge(self._metrics)
        return merged

    def stats_snapshot(self) -> dict:
        """Point-in-time stats for the stats listener / ``copycat-tpu
        stats``: refreshes the lazy gauges (term/role/lag/sessions) then
        returns ``{node, role, term, leader, raft, transport?,
        manager?}`` — plus, multi-group, a ``groups`` section (per-group
        role/term/cursors) and the ``shard.*`` series inside ``raft``
        under the server registry."""
        for grp in self.groups:
            grp.refresh_gauges()
        g0 = self.groups[0]
        if not self.single:
            m = self._metrics
            m.gauge("shard.groups").set(self.num_groups)
            m.gauge("shard.groups_led").set(
                sum(1 for g in self.groups if g.role == LEADER))
        snap: dict = {
            "node": str(self.address),
            "role": g0.role,
            "term": g0.term,
            "leader": str(g0.leader_address) if g0.leader_address else None,
            "raft": self.metrics.snapshot(),
        }
        if not self.single:
            snap["groups"] = {
                str(g.group_id): {
                    "role": g.role,
                    "term": g.term,
                    "leader": (str(g.leader_address)
                               if g.leader_address else None),
                    "commit_index": g.commit_index,
                    "last_applied": g.last_applied,
                    "log_last_index": g.log.last_index,
                    "sessions": sum(
                        1 for s in g.sessions.values()
                        if s.state is SessionState.OPEN),
                } for g in self.groups}
        transport_metrics = getattr(self.transport, "metrics", None)
        if transport_metrics is not None:
            snap["transport"] = transport_metrics.snapshot()
        sm_stats = getattr(g0.state_machine, "stats", None)
        if callable(sm_stats):
            snap["manager"] = sm_stats()
        return snap

    # ------------------------------------------------------------------
    # single-group compatibility surface: the pre-refactor RaftServer
    # exposed its per-group state directly; delegate the classic names
    # to group 0 so single-group embedders/tests keep working. Reads of
    # any OTHER group-0 attribute or method fall through __getattr__.
    # ------------------------------------------------------------------

    @property
    def term(self) -> int:
        return self.groups[0].term

    @term.setter
    def term(self, value: int) -> None:
        self.groups[0].term = value

    @property
    def voted_for(self) -> Address | None:
        return self.groups[0].voted_for

    @voted_for.setter
    def voted_for(self, value: Address | None) -> None:
        self.groups[0].voted_for = value

    @property
    def commit_index(self) -> int:
        return self.groups[0].commit_index

    @commit_index.setter
    def commit_index(self, value: int) -> None:
        self.groups[0].commit_index = value

    @property
    def last_applied(self) -> int:
        return self.groups[0].last_applied

    @last_applied.setter
    def last_applied(self, value: int) -> None:
        self.groups[0].last_applied = value

    @property
    def global_index(self) -> int:
        return self.groups[0].global_index

    @global_index.setter
    def global_index(self, value: int) -> None:
        self.groups[0].global_index = value

    @property
    def role(self) -> str:
        return self.groups[0].role

    @role.setter
    def role(self, value: str) -> None:
        self.groups[0].role = value

    @property
    def leader_address(self) -> Address | None:
        return self.groups[0].leader_address

    @leader_address.setter
    def leader_address(self, value: Address | None) -> None:
        self.groups[0].leader_address = value

    @property
    def members(self) -> list[Address]:
        return self.groups[0].members

    @members.setter
    def members(self, value: list[Address]) -> None:
        for grp in self.groups:
            grp.members = list(value)

    @property
    def log(self):
        return self.groups[0].log

    @property
    def sessions(self) -> dict:
        return self.groups[0].sessions

    @property
    def state_machine(self) -> StateMachine:
        return self.groups[0].state_machine

    @property
    def executor(self):
        return self.groups[0].executor

    @property
    def context(self):
        return self.groups[0].context

    @property
    def _snap_index(self) -> int:
        return self.groups[0]._snap_index

    @_snap_index.setter
    def _snap_index(self, value: int) -> None:
        self.groups[0]._snap_index = value

    def __getattr__(self, item: str):
        # delegation fallback for the classic single-group surface
        # (methods and leader-volatile dicts live on the group now);
        # guarded so a missing attribute during __init__ cannot recurse
        if item.startswith("__"):
            raise AttributeError(item)
        groups = self.__dict__.get("groups")
        if not groups:
            raise AttributeError(item)
        return getattr(groups[0], item)
