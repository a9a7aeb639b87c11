"""The standalone ingress/proxy tier (docs/DEPLOYMENT.md).

:class:`IngressServer` is the server plane's ingress half lifted into
its own wire-facing process — the compartmentalization move (PAPERS.md:
"Scaling Replicated State Machines with Compartmentalization"): client
connections, session fan-out, per-group routing and the global ingress
batching no longer share a GIL with the Raft groups they front, and the
tier scales out independently of write quorums (add ingress processes
without touching the replication plane).

What it does per request, mirroring ``RaftServer``'s multi-group
ingress (``_ms_*`` handlers):

- owns the client connection: registers/keep-alives fan out to every
  group's leader, commands bucket by ``route_group`` into per-group
  sub-blocks dispatched in per-(session, group) submission order,
  reads route to the owning group's leader (or any member for
  sub-linearizable levels);
- forwards each sealed sub-block as a :class:`ProxyRequest` with an
  ``ingress:``-prefixed kind over a correlated peer connection to the
  group's current leader, learning leader views from ``NOT_LEADER``
  hints (the same retry discipline as the in-server proxy);
- relays event pushes: the group leader binds the proxied session to
  the ingress's peer connection (``RaftServer._on_proxy``), pushes
  ``PublishRequest`` frames to the ingress, and the ingress forwards
  them to the client connection it holds — acks travel back the same
  path, so the at-least-once + gap-detect event contract is unchanged;
- rewrites every ``members`` field it returns to the INGRESS tier's
  addresses: clients re-route between ingress proxies on failure and
  never learn (or dial) the Raft members behind the tier.

``COPYCAT_INGRESS_TIER=0`` removes the server-side acceptance of
ingress-kind proxy traffic and pins the in-server ingress path
bit-identically (the A/B knob); topologies built under it deploy no
ingress processes.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable

from ..io.transport import Address, Connection, Transport, TransportError
from ..protocol import messages as msg
from ..protocol.operations import QueryConsistency
from ..utils import knobs, profiler
from ..utils.managed import Managed
from ..utils.metrics import MetricsRegistry
from ..utils.scheduled import Scheduled, schedule_repeating
from ..utils.tasks import spawn
from ..utils.timeseries import SeriesStore
from ..utils.tracing import TRACER

logger = logging.getLogger(__name__)

# Commit-latency floor for command/query forwards. A RESTARTED ingress
# serves sessions that registered through its predecessor — their
# timeouts never replay here, so without a floor the per-try budget
# falls back to the constructor default (5 s) and saturated commit
# latency re-opens the cancel-and-resend retry-storm window. The floor
# is deliberately far above any plausible fsync/replication tail;
# register/keepalive/unregister keep the session-derived budget (they
# are leadership-bound, not commit-bound, and want fast feedback).
_COMMAND_BUDGET_FLOOR_S = 30.0


class IngressServer(Managed):
    """A wire-facing ingress/proxy process fronting a Raft cluster."""

    # StatsListener duck-typing: the routes probe ``state_machine`` /
    # ``health`` / ``blackbox`` with getattr defaults; an ingress has
    # none of them, and must say so with real attributes, not AttributeError
    state_machine = None
    health = None
    blackbox = None

    def __init__(
        self,
        address: Address,
        members: list[Address],
        transport: Transport,
        groups: int = 1,
        tier: list[Address] | None = None,
        route_machine: type | None = None,
        session_timeout: float = 5.0,
        election_timeout: float = 0.5,
        name: str = "ingress",
    ) -> None:
        super().__init__()
        self.address = address
        self.members = list(members)
        self.transport = transport
        self.num_groups = max(1, groups)
        self.tier = list(tier) if tier else [address]
        self.session_timeout = session_timeout
        # The proxy's per-try budget must cover COMMIT latency, not just
        # the wire (the in-server proxy's hard-won lesson: a timeout
        # here CANCELS the in-flight send, and re-sending a block whose
        # first copy already appended is a retry storm — dedup keeps it
        # exactly-once but the duplicate work collapses throughput).
        # The server plane keys that budget off ITS session timeout;
        # the ingress doesn't own sessions, so it tracks the longest
        # timeout a client actually registered and budgets off that.
        self._budget_timeout = session_timeout
        self.election_timeout = election_timeout
        self.name = name
        self._route_group_fn = getattr(route_machine, "route_group", None)

        self._server = transport.server()
        self._client = transport.client()
        self._peer_connections: dict[Address, Connection] = {}
        self._closing = False

        # session_id -> the client connection holding it (event relay
        # target; replaced on reconnect, dropped on unregister)
        self._sessions: dict[int, Connection] = {}
        # per-(session, group) in-order dispatch chains — the same
        # launch-order gate as RaftServer._chained, so a session's
        # sub-blocks for one group reach the leader in submission order
        # while keeping a full pipeline of blocks in flight
        self._chains: dict[tuple, asyncio.Future] = {}
        # per-group leader view, learned from responses/hints
        self._leaders: dict[int, Address | None] = {}
        self._probe_rr = 0
        self._read_rr = 0

        m = self.metrics = MetricsRegistry()
        self._m_sessions = m.gauge("ingress.sessions")
        self._m_commands = m.counter("ingress.commands_forwarded")
        self._m_reads = m.counter("ingress.reads_forwarded")
        self._m_registers = m.counter("ingress.registers")
        self._m_block_ops = m.histogram("ingress.sub_block_ops")
        self._m_events = m.counter("ingress.events_relayed")
        self._m_retries = m.counter("ingress.proxy_retries")
        self._m_reroutes = m.counter("ingress.reroutes")
        # Retrospective telemetry for the proxy tier: the ingress has
        # no health monitor to piggyback, so its series ring runs on
        # one tiny repeating timer (opened/cancelled with the process;
        # skip-if-overlapping like every Scheduled). COPYCAT_SERIES=0
        # removes store, timer and route (A/B).
        self.series = (SeriesStore(node=address, role="ingress",
                                   metrics=m)
                       if knobs.get_bool("COPYCAT_SERIES") else None)
        self._series_timer: Scheduled | None = None
        # Continuous profiling plane (docs/OBSERVABILITY.md
        # "Profiling"): the proxy tier profiles too — the refcounted
        # process-wide sampler, released in _do_close. No flight ring
        # on this tier, so no stall-note callback; holds still surface
        # via profile.hold_* and /profile. COPYCAT_PROFILE=0 -> None:
        # no thread, no keys, no routes (A/B).
        self.profiler = profiler.acquire(m, note_fn=None)
        # Same names/semantics as the server-side ingress phases
        # (docs/OBSERVABILITY.md) so per-tier attribution reads one
        # vocabulary; recorded for EVERY forward on this tier (its whole
        # job is the hop, and the process pays no apply path), where the
        # in-server ingress records them for traced requests only.
        self._m_lat_queue = m.histogram("latency.ingress_queue_ms")
        self._m_lat_hop = m.histogram("latency.proxy_hop_ms")

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def _do_open(self) -> None:
        self._closing = False
        await self._server.listen(self.address, self._accept)
        if self.series is not None:
            self._series_timer = schedule_repeating(
                self.series.interval_s, self.series.interval_s,
                lambda: self.series.maybe_sample(self.metrics.snapshot))
        logger.info("%s listening at %s (fronting %s, %d group(s))",
                    self.name, self.address, self.members, self.num_groups)

    async def _do_close(self) -> None:
        self._closing = True
        if self._series_timer is not None:
            self._series_timer.cancel()
            self._series_timer = None
        await self._server.close()
        await self._client.close()
        self._peer_connections.clear()
        self._sessions.clear()
        self._m_sessions.set(0)
        profiler.release(self.profiler, self.metrics)
        self.profiler = None

    # ------------------------------------------------------------------
    # client side: one handler set per accepted connection
    # ------------------------------------------------------------------

    def _accept(self, connection: Connection) -> None:
        connection.handler(
            msg.RegisterRequest,
            lambda m: self._on_register(connection, m))
        connection.handler(
            msg.KeepAliveRequest,
            lambda m: self._on_keepalive(connection, m))
        connection.handler(msg.UnregisterRequest, self._on_unregister)
        connection.handler(
            msg.CommandRequest,
            lambda m: self._on_command(connection, m))
        connection.handler(
            msg.CommandBatchRequest,
            lambda m: self._on_command_batch(connection, m))
        connection.handler(msg.QueryRequest, self._on_query)
        connection.handler(msg.QueryBatchRequest, self._on_query_batch)

    # ------------------------------------------------------------------
    # member side: leader-seeking proxy forwarding
    # ------------------------------------------------------------------

    async def _peer_connection(self, peer: Address) -> Connection | None:
        conn = self._peer_connections.get(peer)
        if conn is not None and not conn.closed:
            return conn
        try:
            conn = await self._client.connect(peer)
        except (TransportError, OSError):
            return None
        # the event-relay return path: group leaders push PublishRequest
        # frames for sessions this ingress bound over this connection
        conn.handler(msg.PublishRequest, self._relay_publish)
        self._peer_connections[peer] = conn
        return conn

    def _next_member(self) -> Address:
        self._probe_rr += 1
        return self.members[self._probe_rr % len(self.members)]

    def _wire_group(self, g: int) -> int | None:
        # the single-group wire shape carries group=None (docs/SHARDING.md)
        return g if self.num_groups > 1 else None

    async def _proxy(self, g: int, kind: str, payload: Any,
                     trace: int | None = None) -> msg.ProxyResponse:
        """Forward one sealed sub-request to group ``g``'s leader,
        retrying toward the current leader view: ``NOT_LEADER`` hints
        update the view, an unreachable target rotates the probe. Every
        wire attempt records a ``proxy.hop`` sample (failed attempts
        tagged on the trace timeline when tracing)."""
        backoff = 0.01
        base = self._budget_timeout
        if kind in ("commands", "query"):
            base = max(base, _COMMAND_BUDGET_FLOOR_S)
        try_budget = max(base, self.election_timeout * 4)
        deadline = time.monotonic() + max(base,
                                          self.election_timeout * 8)
        first = True
        while True:
            if self._closing:
                return msg.ProxyResponse(error=msg.NO_LEADER,
                                         error_detail="ingress closing")
            if not first:
                self._m_retries.inc()
            first = False
            target = self._leaders.get(g) or self._next_member()
            conn = await self._peer_connection(target)
            response = None
            if conn is not None:
                t_hop = time.perf_counter()
                try:
                    response = await asyncio.wait_for(
                        conn.send(msg.ProxyRequest(
                            group=self._wire_group(g),
                            kind=f"ingress:{kind}", payload=payload,
                            trace=trace)),
                        try_budget)
                except (TransportError, OSError, asyncio.TimeoutError):
                    response = None
                t1 = time.perf_counter()
                self._m_lat_hop.record((t1 - t_hop) * 1e3)
                if trace is not None:
                    TRACER.span(trace, "proxy.hop", t_hop, t1,
                                member=str(self.address), group=g,
                                to=str(target),
                                **({} if response is not None
                                   else {"error": "unreachable"}))
            if response is None:
                # target gone: forget the leader view, probe the tier
                if self._leaders.get(g) == target:
                    self._leaders[g] = None
            elif response.error in (msg.NOT_LEADER, msg.NO_LEADER):
                hint = response.leader
                if hint is not None and hint != target:
                    self._leaders[g] = hint
                    self._m_reroutes.inc()
                    continue  # straight to the hinted leader, no backoff
                self._leaders[g] = hint
            else:
                if self._leaders.get(g) != target:
                    self._leaders[g] = target
                return response
            if time.monotonic() > deadline:
                return (response if response is not None
                        else msg.ProxyResponse(
                            error=msg.NO_LEADER,
                            error_detail=f"group {g}: no reachable leader "
                                         f"behind {self.name}"))
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 0.1)

    async def _proxy_read(self, g: int, payload: Any,
                          consistency: QueryConsistency
                          ) -> msg.ProxyResponse:
        """Reads: linearizable levels go to the group's leader (they
        join its read window and share its confirm round);
        sequential/causal levels rotate across ALL members — any member
        serves them at or after the client's index, so read throughput
        scales with the member tier, not the leader."""
        if consistency in (QueryConsistency.LINEARIZABLE,
                           QueryConsistency.BOUNDED_LINEARIZABLE):
            return await self._proxy(g, "query", payload)
        self._read_rr += 1
        target = self.members[self._read_rr % len(self.members)]
        conn = await self._peer_connection(target)
        if conn is not None:
            t0 = time.perf_counter()
            try:
                response = await asyncio.wait_for(
                    conn.send(msg.ProxyRequest(
                        group=self._wire_group(g), kind="ingress:query",
                        payload=payload)),
                    self._budget_timeout)
            except (TransportError, OSError, asyncio.TimeoutError):
                response = None
            self._m_lat_hop.record((time.perf_counter() - t0) * 1e3)
            if response is not None and not response.error:
                return response
        # lagging/refusing/unreachable member: the leader path settles it
        return await self._proxy(g, "query", payload)

    # ------------------------------------------------------------------
    # event relay (member -> ingress -> client)
    # ------------------------------------------------------------------

    async def _relay_publish(self, request: msg.PublishRequest
                             ) -> msg.PublishResponse:
        conn = self._sessions.get(request.session_id)
        if conn is None or conn.closed:
            # no client connection right now: report no progress; the
            # group keeps the batch queued and retries on the next
            # keep-alive (the same catch-up contract as a direct client)
            return msg.PublishResponse(event_index=request.prev_event_index)
        try:
            response = await asyncio.wait_for(conn.send(request),
                                              self.session_timeout)
        except (TransportError, OSError, asyncio.TimeoutError):
            return msg.PublishResponse(event_index=request.prev_event_index)
        self._m_events.inc()
        return response

    # ------------------------------------------------------------------
    # session ingress (the _ms_* handlers, tier edition)
    # ------------------------------------------------------------------

    def _tier_members(self) -> list[Address]:
        """What clients are told the cluster is: the ingress tier."""
        return list(self.tier)

    def _bind(self, session_id: int, connection: Connection) -> None:
        self._sessions[session_id] = connection
        self._m_sessions.set(len(self._sessions))

    async def _on_register(self, connection: Connection,
                           request: msg.RegisterRequest
                           ) -> msg.RegisterResponse:
        timeout = request.timeout or self.session_timeout
        self._budget_timeout = max(self._budget_timeout, timeout)
        self._m_registers.inc()
        response = await self._proxy(
            0, "register", (request.client_id, timeout, None))
        if response.error:
            return msg.RegisterResponse(error=response.error,
                                        error_detail=response.error_detail,
                                        members=self._tier_members())
        sid = response.result
        outs = await asyncio.gather(*(
            self._proxy(g, "register", (request.client_id, timeout, sid))
            for g in range(1, self.num_groups)))
        for out in outs:
            if out.error:
                return msg.RegisterResponse(
                    error=out.error, error_detail=out.error_detail,
                    members=self._tier_members())
        self._bind(sid, connection)
        return msg.RegisterResponse(session_id=sid, timeout=timeout,
                                    members=self._tier_members(),
                                    groups=self.num_groups)

    async def _on_keepalive(self, connection: Connection,
                            request: msg.KeepAliveRequest
                            ) -> msg.KeepAliveResponse:
        sid = request.session_id
        self._bind(sid, connection)
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
            if outs[0].error == msg.UNKNOWN_SESSION:
                self._sessions.pop(sid, None)
                self._m_sessions.set(len(self._sessions))
            return msg.KeepAliveResponse(error=outs[0].error,
                                         members=self._tier_members())
        return msg.KeepAliveResponse(members=self._tier_members())

    async def _on_unregister(self, request: msg.UnregisterRequest
                             ) -> msg.UnregisterResponse:
        outs = await asyncio.gather(*(
            self._proxy(g, "unregister", request.session_id)
            for g in range(self.num_groups)))
        self._sessions.pop(request.session_id, None)
        self._m_sessions.set(len(self._sessions))
        first = outs[0]
        if first.error and first.error != msg.UNKNOWN_SESSION:
            return msg.UnregisterResponse(error=first.error)
        return msg.UnregisterResponse()

    # -- commands ------------------------------------------------------

    def _route(self, operation: Any) -> int:
        fn = self._route_group_fn
        if fn is None:
            return 0
        g = fn(operation, self.num_groups)
        return g if 0 <= g < self.num_groups else 0

    def _tag_index(self, index: int, g: int) -> int:
        return index * self.num_groups + g if index else index

    def _client_index(self, index: Any, g: int) -> int:
        if isinstance(index, dict):
            return index.get(g, 0) or 0
        if g == 0 and isinstance(index, int):
            return index
        return 0

    async def _chained(self, key: tuple, thunk: Callable) -> Any:
        """Launch-order gate per (session, group) — see
        ``RaftServer._chained``: sub-blocks reach the transport in
        submission order without serializing their round trips."""
        loop = asyncio.get_running_loop()
        prev = self._chains.get(key)
        gate: asyncio.Future = loop.create_future()
        self._chains[key] = gate
        try:
            if prev is not None:
                await asyncio.shield(prev)
            task = spawn(thunk(), name="ingress-dispatch")
        finally:
            if not gate.done():
                gate.set_result(None)
            if self._chains.get(key) is gate:
                del self._chains[key]
        return await task

    async def _dispatch_commands(self, g: int, session_id: int, sub: list,
                                 trace: int | None, t0: float) -> Any:
        """One group's command sub-block in per-(session, group) order;
        returns tagged per-entry outcomes or ``(code, detail, leader)``.
        The wait from ingress receipt until the chain released the
        dispatch records as ``ingress.queue``."""
        self._m_commands.inc(len(sub))
        self._m_block_ops.record(len(sub))

        async def dispatch() -> msg.ProxyResponse:
            t1 = time.perf_counter()
            self._m_lat_queue.record((t1 - t0) * 1e3)
            if trace is not None:
                TRACER.span(trace, "ingress.queue", t0, t1,
                            member=str(self.address), group=g, n=len(sub))
            return await self._proxy(g, "commands", (session_id, sub),
                                     trace)

        response = await self._chained((session_id, g), dispatch)
        if response.error:
            return (response.error, response.error_detail or "", None)
        out = response.result or []
        return [(seq, self._tag_index(idx, g), res, code, det)
                for seq, idx, res, code, det in (tuple(e) for e in out)]

    async def _on_command_batch(self, connection: Connection,
                                request: msg.CommandBatchRequest
                                ) -> msg.CommandBatchResponse:
        sid = request.session_id
        self._bind(sid, connection)
        entries = request.entries or []
        trace = request.trace
        t0 = time.perf_counter()
        buckets: dict[int, list] = {}
        for seq, op in entries:
            buckets.setdefault(self._route(op), []).append((seq, op))
        results = await asyncio.gather(*(
            self._dispatch_commands(g, sid, sub, trace, t0)
            for g, sub in buckets.items()))
        merged: dict[int, tuple] = {}
        for res in results:
            if isinstance(res, tuple):  # response-level (code, detail, _)
                code, detail, _ = res
                # never leak a Raft member as a leader hint: clients
                # re-route WITHIN the ingress tier
                return msg.CommandBatchResponse(
                    error=code, error_detail=detail)
            for entry in res:
                merged[entry[0]] = entry
        out = [merged.get(seq, (seq, 0, None, msg.INTERNAL,
                                "sub-block outcome missing"))
               for seq, _ in entries]
        return msg.CommandBatchResponse(event_index=0, entries=out)

    async def _on_command(self, connection: Connection,
                          request: msg.CommandRequest
                          ) -> msg.CommandResponse:
        sid = request.session_id
        self._bind(sid, connection)
        g = self._route(request.operation)
        res = await self._dispatch_commands(
            g, sid, [(request.seq, request.operation)], request.trace,
            time.perf_counter())
        if isinstance(res, tuple):
            code, detail, _ = res
            return msg.CommandResponse(error=code, error_detail=detail)
        _, index, result, code, detail = res[0]
        if code:
            return msg.CommandResponse(error=code, error_detail=detail,
                                       index=index, event_index=0)
        return msg.CommandResponse(index=index, result=result,
                                   event_index=0)

    # -- reads ---------------------------------------------------------

    async def _serve_reads(self, g: int, session_id: int, index: Any,
                           consistency: QueryConsistency, operations: list
                           ) -> tuple[int, list | None, tuple | None]:
        self._m_reads.inc(len(operations))
        response = await self._proxy_read(
            g, (session_id, self._client_index(index, g),
                consistency.value, operations), consistency)
        if response.error:
            return 0, None, (response.error, response.error_detail or "",
                             None)
        served_index, entries = response.result
        return served_index, entries, None

    async def _on_query(self, request: msg.QueryRequest
                        ) -> msg.QueryResponse:
        consistency = QueryConsistency(request.consistency or "linearizable")
        g = self._route(request.operation)
        served_index, entries, err = await self._serve_reads(
            g, request.session_id, request.index, consistency,
            [request.operation])
        if err is not None:
            code, detail, _ = err
            if code in (msg.NOT_LEADER, msg.NO_LEADER):
                return msg.QueryResponse(error=code)
            return msg.QueryResponse(error=code, error_detail=detail)
        result, code, detail = entries[0]
        tagged = self._tag_index(served_index, g)
        if code:
            return msg.QueryResponse(error=code, error_detail=detail,
                                     index=tagged)
        return msg.QueryResponse(index=tagged, result=result)

    async def _on_query_batch(self, request: msg.QueryBatchRequest
                              ) -> msg.QueryBatchResponse:
        consistency = QueryConsistency(request.consistency or "linearizable")
        operations = request.operations or []
        buckets: dict[int, list] = {}
        for pos, op in enumerate(operations):
            buckets.setdefault(self._route(op), []).append((pos, op))
        outs = await asyncio.gather(*(
            self._serve_reads(g, request.session_id, request.index,
                              consistency, [op for _, op in sub])
            for g, sub in buckets.items()))
        entries: list = [None] * len(operations)
        index: dict[int, int] = {}
        for (g, sub), (served_index, served, err) in zip(buckets.items(),
                                                         outs):
            if err is not None:
                code, detail, _ = err
                if code in (msg.NOT_LEADER, msg.NO_LEADER):
                    return msg.QueryBatchResponse(error=code)
                return msg.QueryBatchResponse(error=code,
                                              error_detail=detail)
            if served_index:
                index[g] = served_index
            for (pos, _op), entry in zip(sub, served):
                entries[pos] = tuple(entry)
        return msg.QueryBatchResponse(index=index, entries=entries)

    # ------------------------------------------------------------------
    # observability (docs/OBSERVABILITY.md; served by StatsListener)
    # ------------------------------------------------------------------

    def healthz_info(self) -> dict:
        """The ``/healthz`` payload: liveness + tier identity, no
        snapshot cost — what the deployment supervisor polls."""
        return {"ok": True, "node": str(self.address), "role": "ingress",
                "sessions": len(self._sessions)}

    def stats_snapshot(self) -> dict:
        snap: dict = {
            "node": str(self.address),
            "role": "ingress",
            "groups": self.num_groups,
            "members": [str(m) for m in self.members],
            "tier": [str(a) for a in self.tier],
            "leaders": {str(g): str(a) for g, a in self._leaders.items()
                        if a is not None},
            "ingress": self.metrics.snapshot(),
        }
        transport_metrics = getattr(self.transport, "metrics", None)
        if transport_metrics is not None:
            snap["transport"] = transport_metrics.snapshot()
        return snap
