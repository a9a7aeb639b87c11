"""Edge read tier: client-local CRDT replicas serving CAUSAL/SEQUENTIAL
reads without a server round-trip (docs/EDGE_READS.md).

The client subscribes to per-resource state deltas over the existing
session event channels (``PublishRequest.deltas``, an optional trailing
wire field) and keeps a replica per queried instance: ``(version,
tagged state)`` where ``version`` is the owning group's applied log
index at publication time. Because the log totally orders versions,
``merge(local, delta) = max-version-wins`` is a join-semilattice merge —
idempotent, commutative, associative — so duplicated, reordered, or
re-delivered-after-failover deltas converge instead of corrupting
(PAPERS.md: "Linearizable State Machine Replication of State-Based
CRDTs without Logs").

Serving is gated twice:

- **monotone/read-your-writes gate**: a replica entry serves only while
  its version is at or past the client's per-group read index — the
  SAME index space server-side sequential reads wait on, so a local
  serve is indistinguishable from a server read at that index (and
  advances the index like one);
- **staleness gate**: an entry that saw no delta or re-seed for
  ``COPYCAT_EDGE_TTL_S`` stops serving — the next read re-seeds from
  the server (which also heals a subscription lost to failover or
  re-route, since the registry is member-local).

Memory is bounded: ``COPYCAT_EDGE_MAX_RESOURCES`` entries, LRU-evicted
back to server reads; evictions unsubscribe via the next keep-alive's
``unsubscribe`` field.

Evaluation is by (state tag, query op type) — machine-class agnostic,
so the CPU and device-backed machines of one resource type share one
evaluator. Ops without an evaluator (or resources the server never
seeds) simply keep the server path.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any

from ..atomic import commands as vc
from ..collections import commands as cc
from ..manager.operations import InstanceQuery
from ..resource.operations import ResourceQuery
from ..utils import knobs
from ..utils.tracing import TRACER

#: sentinel distinguishing "cannot serve" from a served None result
MISS = object()

#: (state tag, inner query op type) -> evaluator over the tagged
#: payload. Each evaluator must return exactly what the server-side
#: handler returns for the same state (the knob-off differential in
#: tests/test_edge_reads.py pins that).
_EVAL = {
    ("val", vc.Get): lambda s, op: s,
    ("map", cc.MapGet): lambda s, op: s.get(op.key),
    ("map", cc.MapGetOrDefault):
        lambda s, op: s[op.key] if op.key in s else op.default,
    ("map", cc.MapContainsKey): lambda s, op: op.key in s,
    ("map", cc.MapContainsValue):
        lambda s, op: any(v == op.value for v in s.values()),
    ("map", cc.MapSize): lambda s, op: len(s),
    ("map", cc.MapIsEmpty): lambda s, op: not s,
    ("set", cc.SetContains): lambda s, op: op.value in s,
    ("set", cc.SetSize): lambda s, op: len(s),
    ("set", cc.SetIsEmpty): lambda s, op: not s,
}


class _Entry:
    """One replica entry. ``version`` is the CERTIFIED version (the
    largest log index the server asserted this entry's state current
    at — the monotone gate's input); ``state_version`` is the version
    of the last STATE record merged. Keeping them separate makes the
    merge a true join in both components: states join by max
    ``state_version``, certification joins by max ``version``, so any
    arrival permutation of the same record set converges identically
    (a refresh arriving before the state deltas it post-dates no
    longer drops them)."""

    __slots__ = ("version", "state_version", "tag", "state", "expires")

    def __init__(self, version: int, tag: str, state: Any,
                 expires: float) -> None:
        self.version = version
        self.state_version = version
        self.tag = tag
        self.state = state
        self.expires = expires


def _split(record: Any) -> tuple[str, Any] | None:
    """Unpack one tagged state payload; ``None`` for the retire form."""
    if record is None:
        return None
    tag, payload = record
    if tag == "set":
        payload = set(payload)
    return tag, payload


class EdgeReadTier:
    """One client's replica store + subscription manager."""

    #: re-exported so the client's fast path never imports this module
    #: at module scope (the manager package import chain would cycle)
    MISS = MISS

    def __init__(self, client: Any) -> None:
        self._client = client
        self._replica: OrderedDict[int, _Entry] = OrderedDict()
        self._pending_unsub: list[int] = []
        # instances whose subscribing reads came back WITHOUT a seed
        # (server declined: not edge-servable, or a seedless ingress
        # tier in front) -> don't re-ask until the deadline, so the
        # follower round-robin isn't permanently pinned to the session
        # connection by hopeless subscribe attempts
        self._no_seed: dict[int, float] = {}
        self._cap = max(1, knobs.get_int("COPYCAT_EDGE_MAX_RESOURCES"))
        self._ttl = knobs.get_float("COPYCAT_EDGE_TTL_S")
        m = client.metrics
        self._m_serves = m.counter("edge.local_serves")
        self._m_fallbacks = m.counter("edge.server_fallbacks")
        self._m_deltas = m.counter("edge.deltas_in")
        self._m_merges = m.counter("edge.merges")
        self._m_seeds = m.counter("edge.seeds")
        self._m_evictions = m.counter("edge.evictions")
        self._m_stale = m.counter("edge.stale_rejections")
        self._m_entries = m.gauge("edge.replica_entries")

    # -- serving -----------------------------------------------------------

    @staticmethod
    def _eligible(operation: Any) -> Any | None:
        """The inner query op when ``operation`` is an edge-shaped read
        (InstanceQuery over ResourceQuery with a known evaluator op
        type), else ``None``."""
        if type(operation) is not InstanceQuery:
            return None
        envelope = operation.operation
        if type(envelope) is not ResourceQuery:
            return None
        return envelope.operation

    def try_serve(self, operation: Any) -> Any:
        """Serve one CAUSAL/SEQUENTIAL read from the replica, or
        :data:`MISS`. A hit records a ``client.edge_serve`` span (its
        assembled trace consists solely of client-side spans — the
        cache-served proof the fanout CI asserts) and advances the
        client's per-group read index to the served version, exactly as
        a server read's response index would."""
        inner = self._eligible(operation)
        if inner is None:
            return MISS
        iid = operation.resource
        entry = self._replica.get(iid)
        if entry is None:
            self._m_fallbacks.inc()
            return MISS
        fn = _EVAL.get((entry.tag, type(inner)))
        if fn is None:
            self._m_fallbacks.inc()
            return MISS
        client = self._client
        groups = client._num_groups
        g = iid % groups
        t0 = time.perf_counter() if TRACER.enabled else 0.0
        if time.monotonic() >= entry.expires \
                or entry.version < client._indices.get(g, 0):
            # staleness gate (no delta/seed for TTL) or monotone/RYW
            # gate (the session observed a newer group index than the
            # replica): fall back, re-seed via the subscribing read
            self._m_stale.inc()
            self._m_fallbacks.inc()
            return MISS
        try:
            result = fn(entry.state, inner)
        except Exception:  # noqa: BLE001 — let the server produce the error
            self._m_fallbacks.inc()
            return MISS
        self._replica.move_to_end(iid)
        self._m_serves.inc()
        # a local serve IS a sequential read at `version`: advance the
        # same per-group high-water a server response index would
        client._note_index(entry.version * groups + g if groups > 1
                           else entry.version)
        if TRACER.enabled:
            TRACER.span(TRACER.new_trace(), "client.edge_serve", t0,
                        time.perf_counter(), member="client", iid=iid)
        return result

    def wants_subscribe(self, items: list) -> bool:
        """True when any remaining read is edge-shaped and not
        negative-cached — the outgoing request then carries
        ``subscribe`` and routes over the session connection (the
        member that can push deltas)."""
        now = time.monotonic()
        return any(
            self._eligible(op) is not None
            and self._no_seed.get(op.resource, 0.0) <= now
            for op, _ in items)

    def seed_response(self, items: list, records: Any) -> None:
        """Install a subscribing read's seeds, and negative-cache the
        edge-shaped instances the server declined to seed (retried
        after one staleness-TTL interval)."""
        seeded = set()
        if records:
            self.seed(records)
            seeded = {iid for iid, _, _ in records}
        retry_at = time.monotonic() + self._ttl
        for op, _ in items:
            if self._eligible(op) is None:
                continue
            if op.resource in seeded:
                self._no_seed.pop(op.resource, None)
            else:
                self._no_seed[op.resource] = retry_at
        if len(self._no_seed) > 4 * self._cap:
            now = time.monotonic()
            self._no_seed = {i: t for i, t in self._no_seed.items()
                             if t > now}

    # -- replica maintenance ----------------------------------------------

    def _adopt(self, iid: int, version: int, tag: str, state: Any) -> None:
        while len(self._replica) >= self._cap:
            evicted, _ = self._replica.popitem(last=False)
            self._pending_unsub.append(evicted)
            self._m_evictions.inc()
        if self._pending_unsub:
            # re-seeded before the eviction's keep-alive went out: the
            # server just re-registered this subscription — retiring it
            # now would starve a LIVE entry of deltas until the TTL
            self._pending_unsub = [x for x in self._pending_unsub
                                   if x != iid]
        self._replica[iid] = _Entry(version, tag, state,
                                    time.monotonic() + self._ttl)
        self._m_entries.set(len(self._replica))

    def _merge(self, iid: int, version: int, record: Any,
               adopt: bool) -> None:
        """join-semilattice merge: max version wins; equal versions are
        idempotent re-applies; ``record=None`` retires the entry; the
        ``("r", None)`` refresh form certifies the entry's existing
        state current at ``version`` (bump version + TTL, keep state)."""
        entry = self._replica.get(iid)
        split = _split(record)
        if split is None:
            if entry is not None:
                del self._replica[iid]
                self._m_entries.set(len(self._replica))
            return
        tag, state = split
        if tag == "r":
            if entry is not None:
                if version > entry.version:
                    entry.version = version
                entry.expires = time.monotonic() + self._ttl
            return
        if entry is None:
            if adopt:
                self._adopt(iid, version, tag, state)
            return  # unadopted delta (evicted/unknown instance): drop
        if version >= entry.state_version:
            entry.state_version = version
            entry.tag = tag
            entry.state = state
            self._m_merges.inc()
        if version > entry.version:
            entry.version = version
        entry.expires = time.monotonic() + self._ttl

    def seed(self, records: Any) -> None:
        """Install the seeds of a subscribing read's response."""
        if not records:
            return
        for iid, version, record in records:
            self._m_seeds.inc()
            self._merge(iid, version or 0, record, adopt=True)

    def ingest(self, deltas: list, trace: int | None = None) -> None:
        """Merge one push's deltas; never adopts (deltas for instances
        the LRU evicted stay dropped until a read re-seeds them)."""
        t0 = time.perf_counter() if trace is not None else 0.0
        self._m_deltas.inc(len(deltas))
        for iid, version, record in deltas:
            self._merge(iid, version or 0, record, adopt=False)
        if trace is not None:
            # delta delivery on the originating write's causal timeline,
            # like `client.event` for session events
            TRACER.span(trace, "client.delta", t0, time.perf_counter(),
                        member="client", n=len(deltas))

    def take_unsubscribes(self) -> list[int] | None:
        """Evicted instance ids staged for the next keep-alive."""
        if not self._pending_unsub:
            return None
        out, self._pending_unsub = self._pending_unsub, []
        return out

    def restage_unsubscribes(self, ids: list[int] | None) -> None:
        """A failed keep-alive re-stages its unsubscribes (retiring a
        subscription is idempotent server-side)."""
        if ids:
            self._pending_unsub.extend(ids)
