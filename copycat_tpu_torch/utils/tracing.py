"""Cluster-wide causal tracing: one trace id carried from the client
submit across every member a request touches (SURVEY.md §5.1 names
tracing a build obligation; the XLA profiler in :mod:`profiling` covers
the device plane — this covers the host request path, now including the
multi-group ingress/proxy/replication hops of docs/SHARDING.md).

Design constraints, in order:

1. **Zero overhead when disabled.** The hot path (client submit, server
   command handlers, the replication window stager, the apply loop) does
   ONE attribute read (``TRACER.enabled`` / ``request.trace is None`` /
   an empty-dict truthiness check) and branches away. No span objects,
   no clock reads, no dict lookups. Verified by the spi + sharded bench
   A/Bs in PERF.md (rounds 7 and 13).
2. **Propagation rides the existing frames — invisibly when off.**
   ``CommandRequest`` / ``CommandBatchRequest`` carry ``trace`` as a
   regular field; the cross-member hops ride
   *optional trailing* fields on ``ProxyRequest`` / ``ProxyResponse`` /
   ``AppendRequest`` / ``PublishRequest`` (protocol/messages.py): the
   field is OMITTED from the wire when ``None``, so with tracing off
   every frame is byte-identical to the pre-tracing plane (the golden
   differential in tests/test_trace_plane.py proves it). The client's
   flag IS the propagation switch: a traced client against untouched
   server configs still yields spans on every member the request
   crossed.
3. **Bounded storage.** Completed spans land in a per-process ring
   (``COPYCAT_TRACE_CAPACITY`` traces, oldest evicted; evicted ids are
   TOMBSTONED so a late remote span can never resurrect a partial
   trace); :meth:`Tracer.dump_slowest` renders the slowest N requests.

Usage::

    from copycat_tpu_torch.utils import tracing

    tracing.enable()                  # or COPYCAT_TRACE=1 in the env
    ... drive requests ...
    print(tracing.TRACER.dump_slowest(5))

Span-name vocabulary (stable API, documented with the phase→histogram
mapping in docs/OBSERVABILITY.md):

- ``client.submit`` — client-side, submit flush -> responses correlated.
- ``ingress.queue`` — multi-group ingress: request receipt -> the
  routed sub-block's dispatch chain released it.
- ``proxy.hop`` — ingress -> owning group leader wire round trip (one
  span per attempt; failed attempts carry ``error=`` meta).
- ``group.append`` — owning leader: receipt -> log append staged.
- ``quorum.wait`` — append staged -> commit index covered the entry.
- ``group.fsync`` — the commit-boundary fsync that made it durable.
- ``apply`` — commit -> state-machine application / engine round done
  (the commit future resolved).
- ``respond`` — apply -> response object built.
- ``group.commit`` — coarse append->commit+apply span on the per-seq
  lanes (single command / general batch), where the commit index is
  not known at staging time.
- ``group.cached`` — exactly-once cache hit served without an append.
- ``follower.append`` — a follower ingesting the replication window
  that carried the traced entry (fsync included).
- ``event.push`` — session event delivery send -> ack.
- ``client.event`` — client-side receipt/dispatch of a traced publish.

Every server-side span is tagged ``member=<address>`` and ``group=<id>``
so the cross-member assembly below can attribute phases. Spans store
``time.perf_counter()`` instants plus a per-process wall-clock anchor
(``wall`` in :meth:`Span.as_dict`): within one process alignment is
exact; across hosts it is as good as the hosts' clock sync, and the
assembly orders causally either way.
"""

from __future__ import annotations

import itertools
import json
import time
from collections import OrderedDict
from typing import Any, Iterable

from . import knobs

_ids = itertools.count(1)

#: perf_counter -> wall-clock anchor for this process: spans are
#: recorded on the monotonic clock (cheap, ordering-safe) and exported
#: with ``wall = start + _WALL_OFFSET`` so rings collected from
#: different processes can be laid on one timeline.
_WALL_OFFSET = time.time() - time.perf_counter()


class Span:
    __slots__ = ("trace_id", "name", "start", "end", "meta")

    def __init__(self, trace_id: int, name: str, start: float, end: float,
                 meta: dict | None = None) -> None:
        self.trace_id = trace_id
        self.name = name
        self.start = start
        self.end = end
        self.meta = meta

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3

    def as_dict(self) -> dict:
        d = {"trace": self.trace_id, "name": self.name,
             "start": round(self.start, 6),
             "wall": round(self.start + _WALL_OFFSET, 6),
             "duration_ms": round(self.duration_ms, 3)}
        if self.meta:
            d.update(self.meta)
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name} trace={self.trace_id} "
                f"{self.duration_ms:.3f}ms)")


class Tracer:
    """Ring-buffered span storage keyed by trace id.

    ``enabled`` is a plain attribute so the disabled check costs one
    LOAD_ATTR; every recording entry point re-checks nothing else.
    """

    #: hard cap on spans recorded per trace id: a request produces ~10
    #: across the cluster, so the cap only bites a peer replaying one id
    #: forever — without it that would grow a server-side list without
    #: bound (spans are recorded for ANY non-None wire id, even with
    #: local tracing off)
    MAX_SPANS_PER_TRACE = 64

    def __init__(self, capacity: int = 512) -> None:
        self.enabled = False
        self.capacity = capacity
        self._traces: "OrderedDict[int, list[Span]]" = OrderedDict()
        # Tombstones for recently-evicted ids: a late span (a straggler
        # ack, a replayed frame) for an evicted trace must be DROPPED,
        # not re-admitted — a resurrected entry holds a partial span
        # list that pollutes dump_slowest with nonsense totals. Bounded
        # at 2x capacity (older tombstones age out; by then the id is
        # process-ancient and a late span for it is noise either way).
        self._tombstones: "OrderedDict[int, None]" = OrderedDict()

    # -- recording ---------------------------------------------------------

    def new_trace(self) -> int:
        """A fresh trace id (call only when ``enabled`` — callers branch
        on the attribute first; ids are process-unique, not global)."""
        return next(_ids)

    def span(self, trace_id: int, name: str, start: float, end: float,
             **meta: Any) -> None:
        """Record one completed span under ``trace_id``.

        Explicit timestamps fit the async call sites (the caller already
        holds t0 from before its awaits). Accepts any trace id —
        including one minted by a REMOTE client and carried in a frame —
        except ids evicted from this ring (tombstoned: late spans for
        them are dropped, never resurrected as partial traces).
        """
        spans = self._traces.get(trace_id)
        if spans is None:
            if trace_id in self._tombstones:
                return
            if len(self._traces) >= self.capacity:
                evicted, _ = self._traces.popitem(last=False)
                self._tombstones[evicted] = None
                if len(self._tombstones) > 2 * self.capacity:
                    self._tombstones.popitem(last=False)
            spans = self._traces[trace_id] = []
        if len(spans) < self.MAX_SPANS_PER_TRACE:
            spans.append(Span(trace_id, name, start, end, meta or None))

    # -- reading -----------------------------------------------------------

    def traces(self) -> dict[int, list[Span]]:
        return dict(self._traces)

    def spans_for(self, trace_id: int) -> list[Span]:
        return list(self._traces.get(trace_id, ()))

    def slowest(self, n: int = 10) -> list[tuple[int, float, list[Span]]]:
        """The slowest ``n`` traces as ``(trace_id, total_ms, spans)``,
        total = wall span from first start to last end."""
        scored = []
        for trace_id, spans in self._traces.items():
            total = (max(s.end for s in spans)
                     - min(s.start for s in spans)) * 1e3
            scored.append((trace_id, total, spans))
        scored.sort(key=lambda t: t[1], reverse=True)
        return scored[:n]

    def dump_slowest(self, n: int = 10, as_json: bool = False) -> str:
        slow = self.slowest(n)
        if as_json:
            return json.dumps([
                {"trace": trace_id, "total_ms": round(total, 3),
                 "spans": [s.as_dict() for s in spans],
                 **({"profile": prof} if (prof := self._profile_window(
                     spans)) else {})}
                for trace_id, total, spans in slow])
        lines = []
        for trace_id, total, spans in slow:
            lines.append(f"trace {trace_id}: {total:.3f} ms total")
            t0 = min(s.start for s in spans)
            for s in sorted(spans, key=lambda s: s.start):
                meta = (" " + " ".join(f"{k}={v}" for k, v in s.meta.items())
                        if s.meta else "")
                lines.append(f"  +{(s.start - t0) * 1e3:8.3f} ms "
                             f"{s.name:<16} {s.duration_ms:8.3f} ms{meta}")
            prof = self._profile_window(spans)
            if prof:
                top = prof["stacks"][0]
                lines.append(f"  profile: {prof['samples']} sample(s) in "
                             f"the window, hottest "
                             f"{top['stack'].rsplit(';', 1)[-1]} "
                             f"(x{top['count']})")
        return "\n".join(lines) if lines else "(no traces recorded)"

    @staticmethod
    def _profile_window(spans: list) -> dict | None:
        """The continuous profiler's top stacks over this trace's wall
        window (utils/profiler.py) — a slow trace names the code the
        process was ACTUALLY running while it was slow, not just its
        own spans. Empty/absent when the plane is off or no sample
        landed in the window."""
        from . import profiler  # lazy: tracing must not require the plane

        prof = profiler.PROFILER
        if prof is None:
            return None
        try:
            w0 = min(s.start for s in spans) + _WALL_OFFSET
            w1 = max(s.end for s in spans) + _WALL_OFFSET
            window = prof.window_top(w0, w1, top=3)
            return window if window["samples"] else None
        except Exception:  # noqa: BLE001 - never wound the dump
            return None

    def clear(self) -> None:
        self._traces.clear()
        self._tombstones.clear()


#: the per-process tracer every layer records into (client + server in
#: one process share it, so in-process tests see end-to-end traces; over
#: TCP each process keeps its own ring, correlated by trace id).
TRACER = Tracer(capacity=max(16, knobs.get_int("COPYCAT_TRACE_CAPACITY")))

if knobs.get_bool("COPYCAT_TRACE"):
    TRACER.enabled = True


def enable() -> None:
    TRACER.enabled = True


def disable() -> None:
    TRACER.enabled = False


def now() -> float:
    return time.perf_counter()


# ---------------------------------------------------------------------------
# Cross-member assembly: lay the spans collected from every member's
# ring (`/traces/<id>` on the stats listener, or the shared in-process
# ring filtered by the `member` tag) on one causal timeline, decide
# completeness, and extract the critical path.
# ---------------------------------------------------------------------------

#: span names that prove a group actually served a routed sub-request —
#: the completeness check looks for one of these after every dispatch
GROUP_PHASES = frozenset((
    "group.append", "group.commit", "group.cached", "quorum.wait",
    "apply", "respond"))


def _norm_span(raw: Any) -> dict:
    """One span as an assembly row: accepts a :class:`Span` or the
    ``as_dict``/JSON shape served by ``/traces/<id>``."""
    if isinstance(raw, Span):
        d = raw.as_dict()
    else:
        d = dict(raw)
    d.setdefault("member", "client")
    d.setdefault("wall", d.get("start", 0.0))
    return d


def assemble_trace(trace_id: int, spans_by_member: dict[str, Iterable],
                   failed_members: Iterable[str] = ()) -> dict:
    """Assemble one cross-member causal timeline.

    ``spans_by_member`` maps a member label to the spans fetched from
    that member's ring (Span objects or ``/traces/<id>`` dicts); members
    whose fetch FAILED go in ``failed_members`` — their absence marks
    the assembly ``incomplete`` rather than silently dropping it.

    Returns ``{trace, members, spans, e2e_ms, incomplete,
    incomplete_why, critical_path, critical_path_ms}`` — spans sorted by
    wall start with ``offset_ms`` relative to the earliest, the critical
    path as innermost-cover segments over the full wall interval (their
    durations sum to ``e2e_ms`` by construction), and completeness
    decided both structurally (a dispatched sub-block with no group-side
    phase landed) and operationally (an unreachable member).
    """
    seen: set = set()
    spans: list[dict] = []
    for member, raw_spans in spans_by_member.items():
        for raw in raw_spans:
            d = _norm_span(raw)
            if d.get("trace") not in (None, trace_id):
                continue
            key = (d["member"], d["name"], round(d["wall"], 6),
                   d.get("duration_ms"))
            if key in seen:  # in-process rings served by N listeners
                continue
            seen.add(key)
            spans.append(d)
    failed = sorted(set(failed_members))
    if not spans:
        return {"trace": trace_id, "members": [], "spans": [],
                "e2e_ms": 0.0, "incomplete": True,
                "incomplete_why": (["no spans landed"]
                                   + [f"member {m} unreachable"
                                      for m in failed]),
                "critical_path": [], "critical_path_ms": 0.0}
    spans.sort(key=lambda d: (d["wall"], -d.get("duration_ms", 0.0)))
    t0 = spans[0]["wall"]
    t1 = max(d["wall"] + d.get("duration_ms", 0.0) / 1e3 for d in spans)
    for d in spans:
        d["offset_ms"] = round((d["wall"] - t0) * 1e3, 3)

    why: list[str] = [f"member {m} unreachable" for m in failed]
    # structural completeness: every routed dispatch must be answered by
    # a group-side phase for the same group — a proxy hop (or a queued
    # sub-block) with no trace of the owning group's work is the
    # partition-in-flight signature
    served_groups = {d.get("group") for d in spans
                     if d["name"] in GROUP_PHASES}
    for d in spans:
        g = d.get("group")
        if d["name"] == "proxy.hop":
            if g in served_groups:
                continue  # a retry served it: an errored attempt alone
                # does not make the assembly incomplete
            if "error" in d:
                why.append(f"proxy hop to group {g} failed ({d['error']})")
            else:
                why.append(f"no group-side spans for proxied group {g}")
        elif d["name"] == "ingress.queue" and g not in served_groups:
            hops = [h for h in spans
                    if h["name"] == "proxy.hop" and h.get("group") == g]
            if not hops:
                why.append(f"sub-block for group {g} dispatched but "
                           f"never served")

    critical = _critical_path(spans, t0, t1)
    return {
        "trace": trace_id,
        "members": sorted({d["member"] for d in spans}),
        "spans": spans,
        "e2e_ms": round((t1 - t0) * 1e3, 3),
        "incomplete": bool(why),
        "incomplete_why": why,
        "critical_path": critical,
        "critical_path_ms": round(sum(c["duration_ms"] for c in critical),
                                  3),
    }


def _critical_path(spans: list[dict], t0: float, t1: float) -> list[dict]:
    """Innermost-cover decomposition of ``[t0, t1]``: at every instant
    the critical path charges the ACTIVE span that started last (the
    most specific phase — a ``quorum.wait`` inside a ``client.submit``
    wins the interval it covers); instants no span covers are charged to
    the most recent enclosing span, so the segment durations always sum
    to the end-to-end wall time."""
    if t1 <= t0:
        return []
    edges = sorted({t0, t1}
                   | {d["wall"] for d in spans}
                   | {d["wall"] + d.get("duration_ms", 0.0) / 1e3
                      for d in spans})
    edges = [e for e in edges if t0 <= e <= t1]
    segments: list[dict] = []
    last_owner: dict | None = None
    for lo, hi in zip(edges, edges[1:]):
        if hi - lo <= 0:
            continue
        mid = (lo + hi) / 2
        active = [d for d in spans
                  if d["wall"] <= mid
                  < d["wall"] + d.get("duration_ms", 0.0) / 1e3]
        owner = (max(active, key=lambda d: d["wall"]) if active
                 else last_owner)
        if owner is None:
            continue
        last_owner = owner
        if segments and segments[-1]["_owner"] is owner \
                and abs(segments[-1]["_end"] - lo) < 1e-9:
            segments[-1]["duration_ms"] += (hi - lo) * 1e3
            segments[-1]["_end"] = hi
            continue
        segments.append({"name": owner["name"],
                         "member": owner["member"],
                         "group": owner.get("group"),
                         "offset_ms": round((lo - t0) * 1e3, 3),
                         "duration_ms": (hi - lo) * 1e3,
                         "_owner": owner, "_end": hi})
    for seg in segments:
        seg["duration_ms"] = round(seg["duration_ms"], 3)
        del seg["_owner"], seg["_end"]
    return segments


def render_waterfall(assembly: dict) -> str:
    """The human rendering of one assembled trace: spans in causal
    order, one line each, critical-path phases starred; incomplete
    assemblies carry a loud banner (they are rendered, never dropped)."""
    lines = [f"trace {assembly['trace']}: {assembly['e2e_ms']:.3f} ms "
             f"end-to-end across {len(assembly['members'])} member(s) "
             f"({', '.join(assembly['members'])})"]
    if assembly["incomplete"]:
        lines.append("  !! INCOMPLETE ASSEMBLY: "
                     + "; ".join(assembly["incomplete_why"]))
    crit = {(c["name"], c["member"]) for c in assembly["critical_path"]}
    crit_ms = {}
    for c in assembly["critical_path"]:
        key = (c["name"], c["member"])
        crit_ms[key] = crit_ms.get(key, 0.0) + c["duration_ms"]
    for d in assembly["spans"]:
        key = (d["name"], d["member"])
        star = "*" if key in crit else " "
        g = f" g={d['group']}" if d.get("group") is not None else ""
        extra = (f"  [critical {crit_ms[key]:.3f} ms]"
                 if star == "*" else "")
        lines.append(
            f" {star} +{d['offset_ms']:9.3f} ms  {d['name']:<16} "
            f"{d.get('duration_ms', 0.0):9.3f} ms  "
            f"{d['member']}{g}{extra}")
    lines.append(f"  critical path: {assembly['critical_path_ms']:.3f} ms "
                 f"over {len(assembly['critical_path'])} segment(s)")
    return "\n".join(lines)
