"""The client runtime: sessions, exactly-once submission, consistency routing.

Mirrors the consumed Copycat client surface (SURVEY.md §2.3 "Client runtime"):
``submit(Command/Query)`` with consistency-dependent routing (commands and
LINEARIZABLE/BOUNDED queries to the leader; SEQUENTIAL/CAUSAL queries to any
server), ``ConnectionStrategy`` (the reference's AtomixReplica pins its client
to the colocated server — ``CombinedConnectionStrategy``), client-assigned
command sequence numbers for exactly-once application, keep-alives, and the
session event channel (``Session.publish/onEvent`` by event name).
"""

from __future__ import annotations

import asyncio
import itertools
import random
import time
import uuid
from typing import Any, Callable

from ..io.transport import Address, Connection, Transport, TransportError
from ..protocol import messages as msg
from ..protocol.operations import Command, Operation, Query
from ..utils import knobs
from ..utils.listeners import Listener, Listeners
from ..utils.managed import Managed
from ..utils.metrics import MetricsRegistry
from ..utils.scheduled import Scheduled
from ..utils.tasks import spawn
from ..utils.tracing import TRACER

_client_counter = itertools.count()


class ApplicationError(Exception):
    """A state machine raised while applying the operation."""


class SessionExpiredError(Exception):
    """The server expired this client's session (missed keep-alives)."""


class ConnectionStrategy:
    """Orders servers for connection attempts."""

    def order(self, members: list[Address]) -> list[Address]:  # pragma: no cover
        raise NotImplementedError


class AnyConnectionStrategy(ConnectionStrategy):
    def order(self, members: list[Address]) -> list[Address]:
        shuffled = list(members)
        random.shuffle(shuffled)
        return shuffled


class PinnedConnectionStrategy(ConnectionStrategy):
    """Always try a specific server first (the reference replica's
    ``CombinedConnectionStrategy`` — client pinned to the in-process server)."""

    def __init__(self, address: Address) -> None:
        self.address = address

    def order(self, members: list[Address]) -> list[Address]:
        rest = [m for m in members if m != self.address]
        random.shuffle(rest)
        return [self.address] + rest


class ClientSession:
    """Client-side session state + event dispatch (Copycat ``Session``)."""

    def __init__(self, client: "RaftClient") -> None:
        self._client = client
        self.id: int | None = None
        self.timeout = 0.0
        self.state = "closed"  # closed -> open -> expired/closed
        # Per-group event channels (docs/SHARDING.md): a multi-group
        # server numbers each group's event stream independently; the
        # single-group plane lives entirely in key 0 (the legacy scalar,
        # via the ``event_index`` property).
        self._event_indices: dict[int, int] = {}
        self._event_listeners: dict[str, Listeners] = {}
        self._open_listeners = Listeners()
        self._close_listeners = Listeners()

    def on_event(self, event: str, callback: Callable[[Any], Any]) -> Listener:
        return self._event_listeners.setdefault(event, Listeners()).add(callback)

    def on_open(self, callback: Callable[[Any], Any]) -> Listener:
        return self._open_listeners.add(callback)

    def on_close(self, callback: Callable[[Any], Any]) -> Listener:
        return self._close_listeners.add(callback)

    @property
    def event_index(self) -> int:
        return self._event_indices.get(0, 0)

    @event_index.setter
    def event_index(self, value: int) -> None:
        self._event_indices[0] = value

    @property
    def is_open(self) -> bool:
        return self.state == "open"

    @property
    def is_expired(self) -> bool:
        return self.state == "expired"

    def publish(self, event: str, message: Any = None) -> None:
        """Local loopback publish (client-side listeners only)."""
        self._dispatch(event, message)

    def _dispatch(self, event: str, message: Any) -> None:
        listeners = self._event_listeners.get(event)
        if listeners is not None:
            listeners.accept(message)

    def _opened(self) -> None:
        self.state = "open"
        self._open_listeners.accept(self)

    def _expired(self) -> None:
        if self.state != "expired":
            self.state = "expired"
            self._close_listeners.accept(self)

    def _closed(self) -> None:
        if self.state == "open":
            self.state = "closed"
            self._close_listeners.accept(self)


class RaftClient(Managed):
    """Submits commands/queries to a Raft cluster over one live connection."""

    def __init__(
        self,
        members: list[Address],
        transport: Transport,
        session_timeout: float = 5.0,
        connection_strategy: ConnectionStrategy | None = None,
    ) -> None:
        super().__init__()
        self.members = list(members)
        self.transport = transport
        self.session_timeout = session_timeout
        self.strategy = connection_strategy or AnyConnectionStrategy()
        self.client_id = f"client-{uuid.uuid4().hex[:8]}-{next(_client_counter)}"
        # Observability: submit->response latency, retry/re-route and
        # indeterminate-outcome counters (docs/OBSERVABILITY.md). The
        # hot path pays one counter add and, per flushed batch, one
        # histogram record.
        self.metrics = MetricsRegistry()

        self._client = transport.client()
        self._loop: asyncio.AbstractEventLoop | None = None  # pinned at open
        self._connection: Connection | None = None
        self._connected_to: Address | None = None
        self._leader_hint: Address | None = None
        self._session = ClientSession(self)
        self._command_seq = 0
        # Exactly-once bookkeeping: the server may prune its response cache
        # only up to the CONTIGUOUS prefix of completed seqs — a higher seq
        # completing first must not ack a lower seq still being retried.
        self._completed_seqs: set[int] = set()
        self._acked_command_seq = 0
        # High-water applied index seen, per Raft group (sequential
        # consistency). Single-group servers live entirely in key 0 —
        # the legacy scalar; a multi-group server (RegisterResponse
        # ``groups`` > 1) tags response indices with the owning group
        # (``index * G + g``) and reads the whole dict on queries.
        self._indices: dict[int, int] = {}
        self._num_groups = 1
        self._keepalive: Scheduled | None = None
        # Command micro-batching: same-turn submits coalesce into ONE
        # CommandBatchRequest (flushed via call_soon at the end of the
        # event-loop turn); a lone submit still rides CommandRequest.
        self._pending_batch: list = []
        self._batch_scheduled = False
        # Query micro-batching: same-turn reads bucket by consistency
        # level (the server's gate differs per level) and ride one
        # QueryBatchRequest — the linearizable gate's quorum round is
        # amortized over the whole batch.
        self._pending_queries: dict[str, list] = {}
        self._query_flush_scheduled = False
        # Follower read scale-out: SEQUENTIAL/CAUSAL reads round-robin
        # across ALL members instead of pinning the session connection
        # (usually the leader) — any server may serve them at or after
        # the client's index (the server-side client-index wait), so
        # read throughput scales with replicas. Leader fallback on lag
        # refusal / unreachable follower. COPYCAT_CLIENT_FOLLOWER_READS=0
        # restores leader-pinned reads (the scale-out A/B knob).
        self._follower_reads = knobs.get_bool("COPYCAT_CLIENT_FOLLOWER_READS")
        self._read_connections: dict[Address, Connection] = {}
        self._read_rr = 0
        # Edge read tier (docs/EDGE_READS.md): client-local CRDT
        # replicas serving CAUSAL/SEQUENTIAL reads without a server
        # hop, fed by per-resource deltas over the session event
        # channel. COPYCAT_EDGE_READS=0 removes the tier entirely — no
        # replica, no subscribe fields, the server-read plane
        # bit-identically (the A/B discipline).
        self._edge = None
        if knobs.get_bool("COPYCAT_EDGE_READS"):
            from .edge import EdgeReadTier
            self._edge = EdgeReadTier(self)

    # -- lifecycle ---------------------------------------------------------

    def session(self) -> ClientSession:
        return self._session

    @property
    def index(self) -> int:
        return max(self._indices.values(), default=0)

    def _read_index(self) -> Any:
        """The ``index`` field for outgoing reads: the legacy scalar on a
        single-group server, the per-group dict on a multi-group one
        (the server extracts the owning group's entry per routed op)."""
        if self._num_groups == 1:
            return self._indices.get(0, 0)
        return dict(self._indices)

    def _note_index(self, value: Any) -> None:
        """Fold a response index into the per-group high-water map:
        scalars are group-0 (single-group) or group-tagged
        (``idx * G + g``, multi-group); dicts are per-group maps
        (multi-group query batches)."""
        if not value:
            return
        if isinstance(value, dict):
            for g, idx in value.items():
                g = int(g)
                if idx and idx > self._indices.get(g, 0):
                    self._indices[g] = idx
            return
        if self._num_groups > 1:
            g = value % self._num_groups
            idx = value // self._num_groups
        else:
            g, idx = 0, value
        if idx > self._indices.get(g, 0):
            self._indices[g] = idx

    async def _do_open(self) -> None:
        self._loop = asyncio.get_running_loop()
        await self._register()
        interval = max(self._session.timeout / 4.0, 0.05)
        self._keepalive = Scheduled(interval, interval, self._send_keepalive)

    async def _do_close(self) -> None:
        if self._keepalive is not None:
            self._keepalive.cancel()
            self._keepalive = None
        if self._session.is_open and self._session.id is not None:
            try:
                response = await self._request(
                    msg.UnregisterRequest(session_id=self._session.id))
            except (TransportError, OSError, msg.ProtocolError, asyncio.TimeoutError):
                pass
        self._session._closed()
        await self._client.close()
        self._connection = None
        self._read_connections.clear()

    # -- connection management --------------------------------------------

    async def _connect(self) -> Connection:
        if self._connection is not None and not self._connection.closed:
            return self._connection
        candidates: list[Address] = []
        if self._leader_hint is not None:
            candidates.append(self._leader_hint)
        candidates += [a for a in self.strategy.order(self.members) if a not in candidates]
        last_error: Exception | None = None
        for address in candidates:
            try:
                conn = await self._client.connect(address)
            except (TransportError, OSError) as e:
                last_error = e
                continue
            conn.handler(msg.PublishRequest, self._on_publish)
            self._connection = conn
            self._connected_to = address
            return conn
        raise TransportError(f"no reachable server in {self.members}") from last_error

    def _drop_connection(self) -> None:
        conn = self._connection
        self._connection = None
        self._connected_to = None
        if conn is not None and not conn.closed:
            spawn(conn.close(), name="drop-connection")

    async def _request(self, request: Any, leader_required: bool = True,
                       attempts: int = 30,
                       per_try_timeout: float | None = None) -> Any:
        """Send with retry/re-route until a non-routing error or success.

        ``per_try_timeout`` bounds ONE attempt (default: the session
        timeout). Keep-alives pass a fraction of it: an attempt stuck at
        a stale leader (appended, never committable) otherwise burns the
        whole session budget before re-routing — the session then
        expires at the real leader even though the majority was
        reachable all along (found by the partition nemesis once
        new-leader expiry actually worked)."""
        backoff = 0.01
        last: Exception | None = None
        tmo = per_try_timeout if per_try_timeout is not None \
            else self.session_timeout
        for _ in range(attempts):
            try:
                conn = await self._connect()
                response = await asyncio.wait_for(conn.send(request), tmo)
            except (TransportError, OSError, asyncio.TimeoutError) as e:
                last = e
                self.metrics.counter("client_retries").inc()
                # A hinted leader that failed the attempt gets no second
                # pin: _connect prefers the hint, so keeping it after a
                # timeout re-dialed the SAME stuck server every retry —
                # under a partitioned-but-dialable old leader the client
                # never reached the majority side (found by the
                # partition nemesis, tests/test_nemesis_raft.py).
                if self._connected_to is not None \
                        and self._connected_to == self._leader_hint:
                    self._leader_hint = None
                self._drop_connection()
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 0.25)
                continue
            error = getattr(response, "error", None)
            if error in (msg.NOT_LEADER, msg.NO_LEADER):
                self.metrics.counter("client_reroutes").inc()
                self._leader_hint = getattr(response, "leader", None)
                members = getattr(response, "members", None)
                if members:
                    self.members = list(members)
                if leader_required or self._leader_hint is None:
                    self._drop_connection()
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, 0.25)
                    continue
            return response
        raise msg.ProtocolError(msg.NO_LEADER, f"no leader after retries: {last}")

    async def _request_read(self, request: Any) -> Any:
        """Send one SEQUENTIAL/CAUSAL read to the next server round-robin
        (followers included — they serve at or after the client's index
        via the server-side applied wait), falling back to the routed
        leader path when a follower is unreachable, lagging behind the
        client's index, or refuses to serve. Read connections are cached
        separately from the session connection so follower reads never
        steal the event/command channel."""
        members = list(self.members)
        count = len(members)
        for _ in range(count):
            address = members[self._read_rr % count]
            self._read_rr += 1
            conn = self._read_connections.get(address)
            if conn is None or conn.closed:
                try:
                    conn = await self._client.connect(address)
                except (TransportError, OSError):
                    continue
                self._read_connections[address] = conn
            try:
                response = await asyncio.wait_for(
                    conn.send(request), self.session_timeout)
            except (TransportError, OSError, asyncio.TimeoutError):
                self._read_connections.pop(address, None)
                if not conn.closed:
                    spawn(conn.close(), name="drop-read-connection")
                continue
            error = getattr(response, "error", None)
            if error in (msg.NOT_LEADER, msg.NO_LEADER, msg.INTERNAL):
                # lag refusal ("state lagging behind client index") or a
                # server that won't serve: take the leader-routed path
                break
            self.metrics.counter("client_reads_follower_lane").inc()
            return response
        self.metrics.counter("client_reads_leader_fallback").inc()
        return await self._request(request, leader_required=False)

    # -- session protocol --------------------------------------------------

    async def _register(self) -> None:
        response = await self._request(msg.RegisterRequest(
            client_id=self.client_id, timeout=self.session_timeout))
        response.raise_if_error()
        self._session.id = response.session_id
        self._session.timeout = response.timeout or self.session_timeout
        if response.members:
            self.members = list(response.members)
        # multi-group server (docs/SHARDING.md): switch on per-group
        # read indices + event channels for this session's lifetime
        self._num_groups = max(1, getattr(response, "groups", None) or 1)
        self._session._opened()

    async def _send_keepalive(self) -> None:
        if not self._session.is_open:
            return
        unsub = (self._edge.take_unsubscribes()
                 if self._edge is not None else None)
        try:
            session = self._session
            event_index: Any = (session.event_index
                                if self._num_groups == 1
                                else dict(session._event_indices))
            response = await self._request(
                msg.KeepAliveRequest(
                    session_id=session.id,
                    command_seq=self._acked_command_seq,
                    event_index=event_index,
                    unsubscribe=unsub),
                # timeout/4 = the keep-alive interval: a stuck attempt
                # yields to the next tick's re-route, and the floor
                # keeps slow-but-healthy commits (hundreds of ms) from
                # spuriously dropping the shared connection
                per_try_timeout=max(1.0, self._session.timeout / 4.0))
        except (msg.ProtocolError, TransportError, OSError, asyncio.TimeoutError):
            if self._edge is not None:
                # retiring a subscription is idempotent: re-stage for
                # the next tick instead of leaking the registry entry
                self._edge.restage_unsubscribes(unsub)
            return
        if response.error == msg.UNKNOWN_SESSION:
            self._session._expired()
        elif response.ok and response.members:
            self.members = list(response.members)

    async def _on_publish(self, request: msg.PublishRequest) -> msg.PublishResponse:
        session = self._session
        trace = getattr(request, "trace", None)
        t0 = time.perf_counter() if trace is not None else 0.0
        # the event channel is per group on a multi-group server (the
        # response's event_index is the position on THAT group's channel)
        g = getattr(request, "group", None) or 0
        position = session._event_indices.get(g, 0)
        if request.session_id != session.id:
            return msg.PublishResponse(event_index=position)
        deltas = getattr(request, "deltas", None)
        if deltas and self._edge is not None:
            # edge state deltas (docs/EDGE_READS.md): merged BEFORE the
            # event-channel gap check — the CRDT merge needs no position
            self._edge.ingest(deltas, trace)
        if request.event_index is None:
            # delta-only push: the event channel's position is untouched
            return msg.PublishResponse(event_index=position)
        if request.prev_event_index != position:
            # Gap or replay: report our position; the server resends from there.
            return msg.PublishResponse(event_index=position)
        for event, message in request.events or []:
            try:
                session._dispatch(event, message)
            except Exception:  # listener errors must not poison the channel
                pass
        session._event_indices[g] = request.event_index
        if trace is not None:
            # traced event delivery: receipt + listener dispatch on the
            # originating causal timeline (member tag "client")
            TRACER.span(trace, "client.event", t0, time.perf_counter(),
                        group=g, n=len(request.events or ()))
        return msg.PublishResponse(event_index=request.event_index)

    # -- operation submission ---------------------------------------------

    async def submit(self, operation: Operation) -> Any:
        if isinstance(operation, Query):
            return await self._submit_query(operation)
        return await self._submit_command(operation)

    def submit_command_nowait(self, operation: Command) -> "asyncio.Future":
        """Stage one command into the current micro-batch and return its
        future directly (no coroutine frame). The awaitable-returning hot
        path: resource facades flatten their submit chain through this,
        cutting ~4 async frames per op off the public SPI plane."""
        if not self._session.is_open:
            raise SessionExpiredError("session is not open")
        self._command_seq += 1
        seq = self._command_seq
        loop = self._loop  # pinned at open: one lookup per op saved
        fut: asyncio.Future = loop.create_future()
        self._pending_batch.append((seq, operation, fut))
        if not self._batch_scheduled:
            self._batch_scheduled = True
            loop.call_soon(self._launch_batch)
        return fut

    async def _submit_command(self, operation: Command) -> Any:
        return await self.submit_command_nowait(operation)

    def _launch_batch(self) -> None:
        self._batch_scheduled = False
        batch, self._pending_batch = self._pending_batch, []
        if batch:
            spawn(self._flush_batch(batch), name="command-batch")

    def _submit_done(self, t0: float, n: int, trace: int | None) -> None:
        """Per-request latency bookkeeping: one histogram sample per wire
        request (every command in a batch experienced that latency), one
        ``client.submit`` span when tracing."""
        end = time.perf_counter()
        self.metrics.histogram("submit_latency_ms").record((end - t0) * 1e3)
        if trace is not None:
            TRACER.span(trace, "client.submit", t0, end, n=n)

    def _submit_failed(self, e: BaseException, n: int) -> None:
        """A submit whose outcome is UNKNOWN is INDETERMINATE — the
        reference's session-loss command failure. That is exactly the
        routing-exhaustion ProtocolError from ``_request`` (per-attempt
        timeouts are retried internally and surface as NO_LEADER; the
        command may have been appended by a leader we lost)."""
        if isinstance(e, msg.ProtocolError) \
                and e.code in (msg.NO_LEADER, msg.NOT_LEADER):
            self.metrics.counter("commands_indeterminate").inc(n)

    async def _flush_batch(self, batch: list) -> None:
        self.metrics.counter("commands_submitted").inc(len(batch))
        trace = TRACER.new_trace() if TRACER.enabled else None
        t0 = time.perf_counter()
        if len(batch) == 1:
            seq, operation, fut = batch[0]
            try:
                response = await self._request(msg.CommandRequest(
                    session_id=self._session.id, seq=seq,
                    operation=operation, trace=trace))
                result = self._finish(response, seq)
            except BaseException as e:  # noqa: BLE001 — delivered via fut
                self._submit_failed(e, 1)
                if not fut.done():
                    fut.set_exception(e)
                return
            self._submit_done(t0, 1, trace)
            if not fut.done():
                fut.set_result(result)
            return
        try:
            response = await self._request(msg.CommandBatchRequest(
                session_id=self._session.id,
                entries=[(seq, op) for seq, op, _ in batch], trace=trace))
            # batch-level fatal (UNKNOWN_SESSION etc.): _finish raises
            # the right exception type for every entry
            if getattr(response, "error", None):
                self._finish(response, None)
        except BaseException as e:  # noqa: BLE001
            self._submit_failed(e, len(batch))
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            return
        self._submit_done(t0, len(batch), trace)
        resp_entries = response.entries or []
        # positional fast path: the server answers in request order, so
        # the common case correlates by zip — the by-seq dict is built
        # only when shapes/seqs disagree (partial or reordered response).
        # The seq comparison runs as two listcomps + one C-level list
        # compare (measurably cheaper than a per-pair generator walk).
        if len(resp_entries) == len(batch) and \
                [e[0] for e in resp_entries] == [b[0] for b in batch]:
            paired = zip(batch, resp_entries)
        else:
            by_seq = {entry[0]: entry for entry in resp_entries}
            paired = ((b, by_seq.get(b[0])) for b in batch)
        try:
            for (seq, _, fut), entry in paired:
                if entry is None:
                    if not fut.done():
                        fut.set_exception(msg.ProtocolError(
                            msg.INTERNAL,
                            f"seq {seq} missing from batch response"))
                    continue
                _, index, result, code, detail = entry
                # ack BEFORE consulting fut.done(): a caller-cancelled
                # command that succeeded server-side must still advance
                # the contiguous ack prefix, or server response-cache
                # pruning stalls behind it forever
                if code in (None, msg.APPLICATION):
                    self._ack_seq(seq, index)
                if fut.done():
                    continue
                if code == msg.APPLICATION:
                    fut.set_exception(
                        ApplicationError(detail or "application error"))
                elif code:
                    fut.set_exception(msg.ProtocolError(code, detail or ""))
                else:
                    fut.set_result(result)
        except BaseException as e:  # noqa: BLE001 — no caller may hang
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            raise

    def _ack_seq(self, seq: int, index: int | None) -> None:
        """Per-command success bookkeeping (the _finish tail): advance the
        sequential-read index and the contiguous completed-seq prefix the
        keep-alive acks for server response-cache pruning."""
        self._note_index(index)
        # in-order completion (every batch entry in a healthy run): just
        # bump the prefix — the out-of-order set stays untouched/empty
        if seq == self._acked_command_seq + 1 and not self._completed_seqs:
            self._acked_command_seq = seq
            return
        self._completed_seqs.add(seq)
        while self._acked_command_seq + 1 in self._completed_seqs:
            self._acked_command_seq += 1
            self._completed_seqs.discard(self._acked_command_seq)

    async def _submit_query(self, operation: Query) -> Any:
        if not self._session.is_open:
            raise SessionExpiredError("session is not open")
        self.metrics.counter("queries_submitted").inc()
        consistency = operation.consistency().value
        edge = self._edge
        if edge is not None and consistency not in (
                "linearizable", "bounded_linearizable"):
            # edge fast path (docs/EDGE_READS.md): a warm replica
            # serves SYNCHRONOUSLY — no future, no micro-batch flush,
            # no wire round-trip; misses fall through to the staged
            # server path (which subscribes + seeds)
            result = edge.try_serve(operation)
            if result is not edge.MISS:
                return result
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending_queries.setdefault(consistency, []).append(
            (operation, fut))
        if not self._query_flush_scheduled:
            self._query_flush_scheduled = True
            loop.call_soon(self._launch_query_batches)
        return await fut

    def _launch_query_batches(self) -> None:
        self._query_flush_scheduled = False
        pending, self._pending_queries = self._pending_queries, {}
        for consistency, items in pending.items():
            if items:
                spawn(self._flush_query_batch(consistency, items),
                      name="query-batch")

    async def _flush_query_batch(self, consistency: str,
                                 items: list) -> None:
        leader_required = consistency in ("linearizable",
                                          "bounded_linearizable")
        # Edge read tier (docs/EDGE_READS.md): these reads already
        # missed the replica (the fast path in _submit_query serves
        # hits synchronously) — edge-shaped misses carry the
        # `subscribe` flag and route over the SESSION connection (the
        # member that pushes this session's deltas), so the response
        # seeds the replica and later reads stay local.
        edge = self._edge if not leader_required else None
        subscribe = (1 if edge is not None and edge.wants_subscribe(items)
                     else None)
        # every read is tagged with its consistency (the request field);
        # sub-linearizable levels route round-robin across replicas
        # (subscribing reads excepted — deltas flow over the session
        # connection, so the subscription must land on its holder)
        round_robin = (not leader_required and self._follower_reads
                       and subscribe is None and len(self.members) > 1)
        if len(items) == 1:
            operation, fut = items[0]
            request = msg.QueryRequest(
                session_id=self._session.id, index=self._read_index(),
                operation=operation, consistency=consistency,
                subscribe=subscribe)
            try:
                if round_robin:
                    response = await self._request_read(request)
                else:
                    response = await self._request(
                        request, leader_required=leader_required)
                result = self._finish(response, None)
            except BaseException as e:  # noqa: BLE001 — delivered via fut
                if not fut.done():
                    fut.set_exception(e)
                return
            if subscribe is not None and edge is not None:
                edge.seed_response(items, getattr(response, "edge", None))
            if not fut.done():
                fut.set_result(result)
            return
        try:
            request = msg.QueryBatchRequest(
                session_id=self._session.id, index=self._read_index(),
                consistency=consistency,
                operations=[op for op, _ in items],
                subscribe=subscribe)
            if round_robin:
                response = await self._request_read(request)
            else:
                response = await self._request(
                    request, leader_required=leader_required)
            if getattr(response, "error", None):
                self._finish(response, None)  # raises the right exception
        except BaseException as e:  # noqa: BLE001
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(e)
            return
        if subscribe is not None and edge is not None:
            edge.seed_response(items, getattr(response, "edge", None))
        try:
            self._note_index(response.index)
            entries = response.entries or []
            for k, (operation, fut) in enumerate(items):
                if fut.done():
                    continue
                if k >= len(entries):
                    fut.set_exception(msg.ProtocolError(
                        msg.INTERNAL, "missing batch query entry"))
                    continue
                result, code, detail = entries[k]
                if code == msg.APPLICATION:
                    fut.set_exception(
                        ApplicationError(detail or "application error"))
                elif code:
                    fut.set_exception(msg.ProtocolError(code, detail or ""))
                else:
                    fut.set_result(result)
        except BaseException as e:  # noqa: BLE001 — no caller may hang
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(e)
            raise

    def _finish(self, response: Any, seq: int | None) -> Any:
        error = getattr(response, "error", None)
        if error == msg.UNKNOWN_SESSION:
            self._session._expired()
            raise SessionExpiredError("session expired")
        if error == msg.APPLICATION:
            if seq is not None:
                # an application error IS a delivered response: ack the
                # seq or the contiguous ack prefix (and server response-
                # cache pruning) would stall behind it forever
                self._ack_seq(seq, getattr(response, "index", None))
            raise ApplicationError(response.error_detail or "application error")
        response.raise_if_error()
        if seq is not None:
            self._ack_seq(seq, response.index)
        else:
            self._note_index(getattr(response, "index", None))
        return response.result
