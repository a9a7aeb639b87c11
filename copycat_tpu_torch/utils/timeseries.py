"""Retrospective telemetry: on-member time-series retention and the
cluster-merged timeline (docs/OBSERVABILITY.md "Retrospective
telemetry").

The observability stack before this module judged the *present* —
``/stats`` is a point-in-time snapshot, ``--watch`` computes deltas only
while an operator is looking, and the health detectors keep a short
window of private evidence. The moment an incident ends, the data that
explains it is gone: ``doctor`` can say "group 0 is stalled *now*" but
not "fsync latency started climbing 40 s before the stall". This module
is the retention tier, three pieces:

- **:class:`SeriesStore`** — a bounded, delta-encoded ring of periodic
  metric-registry samples: counters are stored as per-interval deltas
  (the rate signal an operator actually wants), gauges are sampled
  as-is, histograms sample their running p50/p99 plus a delta-encoded
  count. On members the store is driven off the existing
  :class:`~copycat_tpu_torch.utils.health.HealthMonitor` cadence — no new
  task is spawned; the ingress tier runs one tiny repeating timer and
  the supervisor samples inside its existing health watch.
  ``COPYCAT_SERIES_INTERVAL_S`` / ``COPYCAT_SERIES_WINDOW`` bound the
  retention; ``COPYCAT_SERIES=0`` removes the plane — no store, no
  ``series.*`` keys, no ``/series`` route — restoring the pre-series
  server bit-identically (the standing A/B discipline).
- **Timeline assembly** — :func:`assemble_timeline` /
  :func:`render_timeline`: pure functions merging every member's
  ``/series`` + ``/flight`` + ``/health`` payloads into one cluster
  timeline: per-member metric sparklines time-aligned on a common
  grid, with flight-recorder faults, black-box crash tails, health
  findings and elections/restarts as event marks. Unreachable members
  mark the assembly ``incomplete=true`` with reasons — the trace
  assembly's semantics: partial timelines render, never drop.
- **Live dashboard** — :func:`render_top`: one ``copycat-tpu top``
  frame (per-group role/term/commit rate, lane mix, replication
  in-flight, worst health verdict) from the same ``/stats`` +
  ``/health`` payloads, refreshed in place by the CLI.

Retrospective onset detection for ``doctor --last N`` lives here too
(:func:`series_onsets`): "which retained series started breaching, and
when" — the time-correlation the present-tense findings cannot make.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Iterable

from . import knobs

#: eight-level unicode sparkline ramp (min → max over the rendered row)
SPARK = "▁▂▃▄▅▆▇█"

#: the curated series the timeline renders when ``--names`` is not
#: given: commit progress, election activity, backlog, and the health +
#: SLO verdict gauges — the signals every incident review starts from
DEFAULT_TIMELINE_PREFIXES = (
    "raft_commit_index", "raft_elections_started", "raft_commit_lag",
    "health.status", "slo.",
)


def series_sort_key(key: str) -> tuple:
    """Label-aware ordering: ``name{label}`` variants sort WITH their
    family (name first, then label set, then any histogram sub-key),
    not after every unlabeled name — ASCII ``{`` > letters, so a plain
    sort scatters per-group (``group=``) series away from their
    siblings. Numeric label values compare numerically (``group=2``
    before ``group=10``), so a wide multi-group render stays in shard
    order instead of lexicographic order."""
    brace = key.find("{")
    if brace < 0:
        return (key, (), "")
    end = key.find("}", brace)
    if end < 0:
        return (key, (), "")
    labels = []
    for part in key[brace + 1:end].split(","):
        name, _, value = part.partition("=")
        labels.append((name, (0, int(value)) if value.isdigit()
                       else (1, value)))
    return (key[:brace], tuple(labels), key[end + 1:])


def flatten_registry(snap: dict) -> tuple[dict, set]:
    """Flatten one metric-registry snapshot (``MetricsRegistry.
    snapshot()``) into numeric series, returning ``(values,
    gauge_keys)``. Histogram summaries expand to ``<name>.p50`` /
    ``<name>.p99`` (sampled like gauges) plus ``<name>.count``
    (cumulative, delta-encoded like a counter); the ``_gauge_keys``
    hint and ``uptime_s`` are dropped (wall time is the sample axis,
    not a series)."""
    gauges = set(snap.get("_gauge_keys", ()))
    values: dict = {}
    gauge_keys: set = set()
    for key, v in snap.items():
        if key in ("_gauge_keys", "uptime_s"):
            continue
        if isinstance(v, dict):
            if "count" in v and "mean" in v:  # histogram summary
                for q in ("p50", "p99"):
                    if q in v:
                        values[f"{key}.{q}"] = v[q]
                        gauge_keys.add(f"{key}.{q}")
                values[f"{key}.count"] = v["count"]
            continue
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, (int, float)):
            values[key] = v
            if key in gauges:
                gauge_keys.add(key)
    return values, gauge_keys


class SeriesStore:
    """The bounded, delta-encoded ring of periodic metric samples.

    One store per process role (member / ingress / supervisor), fed by
    that role's existing cadence via :meth:`maybe_sample` — the store
    itself never spawns a task. Counters land as per-interval deltas
    (sample N holds "how much this counter moved since sample N-1"),
    gauges as sampled values; eviction is oldest-first at
    ``COPYCAT_SERIES_WINDOW`` samples, so memory is bounded by
    ``window x live-series-count`` regardless of uptime."""

    def __init__(self, node: Any = "", role: str = "member",
                 interval_s: float | None = None,
                 window: int | None = None,
                 metrics: Any = None) -> None:
        self.node = str(node)
        self.role = role
        self.interval_s = max(0.05, interval_s if interval_s is not None
                              else knobs.get_float(
                                  "COPYCAT_SERIES_INTERVAL_S"))
        self.window = max(2, window if window is not None
                          else knobs.get_int("COPYCAT_SERIES_WINDOW"))
        self._samples: deque = deque(maxlen=self.window)
        self._prev_raw: dict = {}
        # next-due monotonic deadline: tolerant of the driving cadence's
        # jitter (a tick landing 1 ms early must not halve the rate)
        self._next_due = 0.0
        self.samples_taken = 0
        self.evictions = 0
        self._m_samples = self._m_evictions = self._m_names = None
        if metrics is not None:
            # the series.* self-family rides the host registry — and is
            # therefore itself sampled into the ring, like every family
            self._m_samples = metrics.counter("series.samples")
            self._m_evictions = metrics.counter("series.evictions")
            self._m_names = metrics.gauge("series.names")

    def maybe_sample(self, snap_fn: Callable[[], dict]) -> bool:
        """Called from the host's cadence (the health monitor tick, the
        ingress timer, the supervisor watch): takes a sample when
        ``interval_s`` has elapsed since the last one, else no-ops.
        ``snap_fn`` is only invoked when a sample is due — a store on a
        faster cadence than its interval pays nothing on skipped
        ticks."""
        now = time.monotonic()
        if now < self._next_due:
            return False
        # re-anchor on the schedule, not on `now`: drift-free when the
        # driving cadence matches interval_s, catch-up-free when the
        # host stalled for many intervals
        self._next_due = max(self._next_due + self.interval_s,
                             now + self.interval_s / 2)
        try:
            snap = snap_fn()
        except Exception:  # noqa: BLE001 - observability must never wound
            return False
        self.ingest(snap)
        return True

    def ingest(self, snap: dict, t: float | None = None) -> None:
        """Delta-encode one registry snapshot into the ring (exposed
        for tests and for bench, which samples at scenario boundaries
        rather than on a timer)."""
        flat, gauge_keys = flatten_registry(snap)
        values: dict = {}
        prev = self._prev_raw
        raw: dict = {}
        for key, v in flat.items():
            if key in gauge_keys:
                values[key] = v
            else:
                # counter: per-interval delta; a counter first seen this
                # sample contributes 0 (its history starts now)
                values[key] = v - prev.get(key, v)
                raw[key] = v
        self._prev_raw = raw
        if len(self._samples) == self._samples.maxlen:
            self.evictions += 1
            if self._m_evictions is not None:
                self._m_evictions.inc()
        self._samples.append(
            (round(time.time() if t is None else t, 3), values))
        self.samples_taken += 1
        if self._m_samples is not None:
            self._m_samples.inc()
        if self._m_names is not None:
            self._m_names.set(len(values))

    # -- query side --------------------------------------------------------

    def rows(self) -> list[tuple[float, dict]]:
        """The retained ``(wall_t, values)`` rows oldest-first — the
        in-process read the SLO detector judges without paying the JSON
        payload shape."""
        return list(self._samples)

    def payload(self, since: float | None = None,
                names: Iterable[str] | None = None) -> dict:
        """The ``/series`` JSON payload: retained samples, optionally
        windowed to ``t > since`` (wall seconds) and filtered to series
        whose flat name starts with any ``names`` prefix (labels
        included in the match, so ``raft_commit_index`` matches every
        ``raft_commit_index{group=}`` variant)."""
        prefixes = tuple(p for p in (names or ()) if p)
        rows = []
        for t, values in self._samples:
            if since is not None and t <= since:
                continue
            if prefixes:
                values = {k: v for k, v in values.items()
                          if any(k.startswith(p) for p in prefixes)}
            rows.append({"t": t, "values": values})
        return {
            "node": self.node,
            "role": self.role,
            "interval_s": self.interval_s,
            "window": self.window,
            "now": round(time.time(), 3),
            "samples_taken": self.samples_taken,
            "evictions": self.evictions,
            "samples": rows,
        }

    def render_text(self, since: float | None = None,
                    names: Iterable[str] | None = None) -> str:
        """The ``/series.txt`` human rendering: one sparkline row per
        retained series, family-sorted."""
        payload = self.payload(since=since, names=names)
        rows = payload["samples"]
        header = (f"{self.role} {self.node}: {len(rows)} sample(s), "
                  f"interval {self.interval_s}s, window {self.window}")
        if not rows:
            return header + "\n(no samples retained)\n"
        keys = sorted({k for r in rows for k in r["values"]},
                      key=series_sort_key)
        lines = [header]
        for key in keys:
            vals = [r["values"].get(key) for r in rows]
            present = [v for v in vals if v is not None]
            lines.append(f"{key:<52} {sparkline(vals):<{self.window}} "
                         f"min {min(present):g} max {max(present):g}")
        return "\n".join(lines) + "\n"


def sparkline(values: list) -> str:
    """Scale a row of samples onto the eight-level ramp (``None`` =
    a gap, rendered as a space). A flat row renders at the floor — the
    interesting signal is variation, not magnitude."""
    present = [v for v in values if v is not None]
    if not present:
        return ""
    lo, hi = min(present), max(present)
    span = hi - lo
    out = []
    for v in values:
        if v is None:
            out.append(" ")
        elif span <= 0:
            out.append(SPARK[0])
        else:
            out.append(SPARK[int((v - lo) / span * (len(SPARK) - 1))])
    return "".join(out)


def resample(samples: list[dict], key: str, t0: float, t1: float,
             buckets: int) -> list:
    """Bucket one member's retained series onto a common time grid
    (mean per bucket, ``None`` for empty buckets) — what time-aligns
    sparklines across members whose sample clocks are not in phase."""
    if buckets <= 0 or t1 <= t0:
        return []
    sums = [0.0] * buckets
    counts = [0] * buckets
    width = (t1 - t0) / buckets
    for row in samples:
        t = row.get("t", 0.0)
        v = row.get("values", {}).get(key)
        if v is None or t < t0 or t > t1:
            continue
        i = min(buckets - 1, int((t - t0) / width))
        sums[i] += v
        counts[i] += 1
    return [sums[i] / counts[i] if counts[i] else None
            for i in range(buckets)]


# ---------------------------------------------------------------------------
# the cluster-merged timeline
# ---------------------------------------------------------------------------

#: flight/black-box kinds the timeline renders as event marks (anything
#: else — raw telemetry notes — would drown the marks that matter)
_EVENT_KINDS = ("fault", "boot", "health", "invariant_violation",
                "slow_trace", "loop_stall")


def _event_detail(ev: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in ev.items()
                    if k not in ("seq", "t", "round", "kind", "recovered"))


def _member_events(member: str, payload: dict) -> list[dict]:
    """Event marks for one member: flight-ring events, black-box events
    (the crash-surviving superset — recovered tails included), and
    election spikes derived from the retained series (any interval
    where the elections counter moved)."""
    events: list[dict] = []
    seen: set = set()
    flight = payload.get("flight") or {}
    blackbox = flight.get("blackbox") or {}
    for ev in list(flight.get("events") or ()) \
            + list(blackbox.get("events") or ()):
        kind = ev.get("kind", "")
        if kind not in _EVENT_KINDS:
            continue
        detail = _event_detail(ev)
        dedup = (ev.get("t"), kind, detail)
        if dedup in seen:  # ring events spill into the black-box too
            continue
        seen.add(dedup)
        events.append({"t": ev.get("t", 0.0), "member": member,
                       "kind": kind, "detail": detail,
                       "recovered": bool(ev.get("recovered"))})
    series = payload.get("series") or {}
    for row in series.get("samples", ()):
        for key, v in row.get("values", {}).items():
            if key.startswith("raft_elections_started") and v:
                events.append({"t": row["t"], "member": member,
                               "kind": "election",
                               "detail": f"+{int(v)} election(s)"
                               + (key[key.find("{"):]
                                  if "{" in key else "")})
    return events


def assemble_timeline(members: dict[str, dict],
                      failed_members: Iterable[str] = (),
                      last_s: float = 60.0,
                      names: Iterable[str] | None = None,
                      buckets: int = 60) -> dict:
    """Merge per-member ``/series`` + ``/flight`` + ``/health``
    payloads into one cluster timeline.

    ``members`` maps a member address to ``{"series": <//series JSON>,
    "flight": <//flight JSON>, "health": <//health JSON>}`` (any value
    may be ``None`` when that route failed); addresses whose fan-out
    failed entirely go in ``failed_members``. Either kind of gap marks
    the timeline ``incomplete=true`` with reasons — the trace
    assembly's semantics: partial timelines render, never drop."""
    failed = sorted(set(failed_members))
    incomplete_why = [f"member {m} unreachable" for m in failed]
    prefixes = tuple(p for p in (names or DEFAULT_TIMELINE_PREFIXES) if p)
    # the grid end: the freshest clock any member reported (their
    # /series `now`), so a quiet cluster still renders a full window
    t1 = 0.0
    for payload in members.values():
        series = (payload or {}).get("series") or {}
        t1 = max(t1, series.get("now", 0.0))
        for row in series.get("samples", ()):
            t1 = max(t1, row.get("t", 0.0))
    if t1 <= 0.0:
        t1 = time.time()
    t0 = t1 - max(1.0, last_s)
    buckets = max(4, min(int(buckets), 240))

    events: list[dict] = []
    member_series: dict[str, dict] = {}
    member_roles: dict[str, str] = {}
    for addr in sorted(members):
        payload = members[addr] or {}
        series = payload.get("series")
        health = payload.get("health") or {}
        member = series.get("node") if series else None
        member = member or health.get("node") or addr
        member_roles[member] = (health.get("role")
                                or (series or {}).get("role") or "?")
        if series is None:
            incomplete_why.append(
                f"member {member} serves no /series "
                f"(COPYCAT_SERIES=0 or a pre-series build)")
        rows = [r for r in (series or {}).get("samples", ())
                if t0 <= r.get("t", 0.0) <= t1]
        keys = sorted(
            {k for r in rows for k in r["values"]
             if any(k.startswith(p) for p in prefixes)},
            key=series_sort_key)
        member_series[member] = {
            key: resample(rows, key, t0, t1, buckets) for key in keys}
        events.extend(e for e in _member_events(member, payload)
                      if t0 <= e["t"] <= t1 or e.get("recovered"))
    events.sort(key=lambda e: (e["t"], e["member"], e["kind"]))
    return {
        "window_s": round(t1 - t0, 3),
        "t0": round(t0, 3),
        "t1": round(t1, 3),
        "buckets": buckets,
        "members": sorted(member_series),
        "roles": member_roles,
        "incomplete": bool(incomplete_why),
        "incomplete_why": incomplete_why,
        "series": member_series,
        "events": events,
    }


def render_timeline(timeline: dict) -> str:
    """The human rendering: a window banner, per-member time-aligned
    sparklines (one common grid — column K is the same instant on every
    row), then the merged event marks in time order. Incomplete
    timelines carry a loud banner — rendered, never dropped."""
    t0, t1 = timeline["t0"], timeline["t1"]
    lines = [f"cluster timeline: {len(timeline['members'])} member(s), "
             f"window {timeline['window_s']:.0f}s "
             f"({time.strftime('%H:%M:%S', time.localtime(t0))} -> "
             f"{time.strftime('%H:%M:%S', time.localtime(t1))})"]
    if timeline["incomplete"]:
        lines.append("!! INCOMPLETE: "
                     + "; ".join(timeline["incomplete_why"]))
    for member in timeline["members"]:
        role = timeline.get("roles", {}).get(member, "?")
        lines.append(f"{member} [{role}]")
        rows = timeline["series"].get(member, {})
        if not rows:
            lines.append("  (no series retained in the window)")
        for key in sorted(rows, key=series_sort_key):
            vals = rows[key]
            present = [v for v in vals if v is not None]
            span = (f"min {min(present):g} max {max(present):g}"
                    if present else "no data")
            lines.append(f"  {key:<36} {sparkline(vals)}  {span}")
    lines.append(f"events ({len(timeline['events'])}):")
    if not timeline["events"]:
        lines.append("  (none in the window)")
    for ev in timeline["events"]:
        mark = time.strftime("%H:%M:%S", time.localtime(ev["t"]))
        rec = " (recovered)" if ev.get("recovered") else ""
        lines.append(f"  {mark} +{max(0.0, ev['t'] - t0):6.1f}s "
                     f"{ev['member']:<22} {ev['kind']:<10} "
                     f"{ev['detail']}{rec}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the live dashboard (`copycat-tpu top`)
# ---------------------------------------------------------------------------


def _flatten_numeric(snap: dict, prefix: str = "") -> dict:
    """Flatten a stats snapshot to dotted numeric keys (histogram
    summaries expand to .count/.mean/.p50/.p99/.max; ``_gauge_keys``
    hints are dropped). One home: the CLI's ``stats --watch`` renderer
    and the ``top`` dashboard both read it."""
    out: dict = {}
    for k, v in snap.items():
        if k == "_gauge_keys":
            continue
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            if "count" in v and "mean" in v:  # histogram summary
                for q in ("count", "mean", "p50", "p99", "max"):
                    if q in v:
                        out[f"{key}.{q}"] = v[q]
            else:
                out.update(_flatten_numeric(v, f"{key}."))
        elif isinstance(v, bool):
            out[key] = int(v)
        elif isinstance(v, (int, float)):
            out[key] = v
    return out


def _rate(flat: dict, prev: dict | None, prefix: str, dt: float) -> float:
    """Aggregate delta/sec across every flat key in one family —
    ``prefix`` matches the unlabeled key AND its ``{group=}`` labeled
    variants, so the same arithmetic serves single- and multi-group
    members."""
    if not prev or dt <= 0:
        return 0.0
    total = 0.0
    for key, v in flat.items():
        if key.startswith(prefix) and key in prev:
            total += (v - prev[key]) / dt
    return total


def _lane_mix(flat: dict, prev: dict | None, dt: float) -> str:
    fast = _rate(flat, prev, "raft.commands_fast_lane", dt)
    general = _rate(flat, prev, "raft.commands_general_lane", dt)
    single = _rate(flat, prev, "raft.commands_single_lane", dt)
    total = fast + general + single
    if total <= 0:
        return "-"
    return (f"{100 * fast / total:.0f}/{100 * general / total:.0f}"
            f"/{100 * single / total:.0f}%")


def render_top(members: dict[str, dict], failed: Iterable[str] = (),
               prev: dict | None = None, dt: float = 0.0
               ) -> tuple[str, dict]:
    """One ``copycat-tpu top`` frame from per-member ``/stats`` +
    ``/health`` payloads: cluster banner (worst health verdict first —
    the one line an operator reads), then one row per member with
    per-group role/term/commit rate, the command lane mix
    (fast/general/single %), and replication in-flight. Returns
    ``(frame, state)`` where ``state`` feeds the next frame's rates.
    Unreachable members render as rows, never drop."""

    statuses = []
    state: dict = {}
    rows: list[str] = []
    for addr in sorted(members):
        payload = members[addr] or {}
        stats = payload.get("stats") or {}
        health = payload.get("health") or {}
        status = health.get("status", "unknown")
        statuses.append(status)
        flat = _flatten_numeric(stats)
        state[addr] = flat
        mprev = (prev or {}).get(addr)
        node = stats.get("node", addr)
        groups = stats.get("groups") or {}
        inflight = sum(v for k, v in flat.items()
                       if k.startswith("raft.repl.windows_inflight"))
        if groups:
            led = sum(1 for g in groups.values()
                      if g.get("role") == "leader")
            role = f"{led}/{len(groups)} led"
        else:
            role = stats.get("role", "?")
        # rates need two polls — the first frame says so instead of
        # rendering a misleading 0.0/s
        if mprev and dt > 0:
            r = _rate(flat, mprev, "raft.raft_commit_index", dt)
            commit = f"{r:>9.1f}/s"
        else:
            commit = f"{'-':>11}"
        rows.append(f"  {node:<22} {role:<10} t{stats.get('term', 0):<5} "
                    f"{commit}  "
                    f"{_lane_mix(flat, mprev, dt):<12} "
                    f"infl {inflight:<5} {status}")
        for gid in sorted(groups, key=lambda s: int(s)):
            g = groups[gid]
            g_rate = _rate(flat, mprev, f"groups.{gid}.commit_index", dt)
            rows.append(f"    group {gid}: {g.get('role', '?'):<9} "
                        f"t{g.get('term', 0):<5} "
                        f"commit {g.get('commit_index', 0)} "
                        f"({g_rate:+.1f}/s) lag "
                        f"{g.get('log_last_index', 0) - g.get('commit_index', 0)}")
    for addr in sorted(set(failed)):
        statuses.append("unreachable")
        rows.append(f"  {addr:<22} UNREACHABLE")
    verdict = "unknown"
    for s in ("critical", "warn", "unreachable", "ok"):
        if s in statuses:
            verdict = s
            break
    banner = (f"=== cluster top {time.strftime('%H:%M:%S')} — "
              f"{len(members)}/{len(members) + len(set(failed))} "
              f"member(s) up, worst health: {verdict.upper()} ===")
    header = (f"  {'member':<22} {'role':<10} {'term':<6} "
              f"{'commit/s':>9}  {'lanes f/g/s':<12} {'repl':<10} health")
    return "\n".join([banner, header] + rows), state


def top_payload(members: dict[str, dict], failed: Iterable[str] = (),
                prev: dict | None = None, dt: float = 0.0
                ) -> tuple[dict, dict]:
    """The machine-readable sibling of :func:`render_top` (parity with
    ``timeline --json``): one frame as JSON — per-member role/term/
    health/commit-rate plus per-group cursors — for the CI smoke and
    any scripted poll, so nobody scrapes the text dashboard. Returns
    ``(payload, state)``; rates need two polls, so a first frame (no
    ``prev``) carries ``commit_rate: null``, never a misleading 0.0.
    Unreachable members land in ``failed`` as rows of their own —
    reported, never dropped."""

    statuses: list[str] = []
    state: dict = {}
    out_members: dict = {}
    for addr in sorted(members):
        payload = members[addr] or {}
        stats = payload.get("stats") or {}
        health = payload.get("health") or {}
        status = health.get("status", "unknown")
        statuses.append(status)
        flat = _flatten_numeric(stats)
        state[addr] = flat
        mprev = (prev or {}).get(addr)
        node = str(stats.get("node", addr))
        groups = stats.get("groups") or {}
        have_rates = bool(mprev) and dt > 0
        row: dict = {
            "role": stats.get("role", "?"),
            "term": stats.get("term", 0),
            "health": status,
            "inflight": sum(v for k, v in flat.items()
                            if k.startswith("raft.repl.windows_inflight")),
            "commit_rate": round(_rate(flat, mprev,
                                       "raft.raft_commit_index", dt), 3)
            if have_rates else None,
            "groups": {},
        }
        if groups:
            row["groups_led"] = sum(1 for g in groups.values()
                                    if g.get("role") == "leader")
        for gid in sorted(groups, key=lambda s: int(s)):
            g = groups[gid]
            row["groups"][gid] = {
                "role": g.get("role", "?"),
                "term": g.get("term", 0),
                "commit_index": g.get("commit_index", 0),
                "lag": (g.get("log_last_index", 0)
                        - g.get("commit_index", 0)),
                "commit_rate": round(_rate(flat, mprev,
                                           f"groups.{gid}.commit_index",
                                           dt), 3)
                if have_rates else None,
            }
        out_members[node] = row
    failed_rows = sorted(set(failed))
    statuses += ["unreachable"] * len(failed_rows)
    verdict = "unknown"
    for s in ("critical", "warn", "unreachable", "ok"):
        if s in statuses:
            verdict = s
            break
    return ({"now": round(time.time(), 3),
             "members": out_members,
             "failed": failed_rows,
             "worst_health": verdict}, state)


# ---------------------------------------------------------------------------
# retrospective onset detection (`doctor --last N`)
# ---------------------------------------------------------------------------


def series_onsets(series_payload: dict, prefixes: Iterable[str],
                  factor: float = 3.0, cap: int = 8) -> list[dict]:
    """Scan one member's retained window for series that *started
    breaching*: the earliest sample where a series exceeded ``factor``
    x its window median (or simply became non-zero when the median is
    zero — the election/violation counters' shape). Returns rows of
    ``{key, t, ago_s, value, median}``, newest-breach last, at most
    ``cap`` — what lets ``doctor --last N`` say "fsync latency started
    climbing 40 s before the stall" instead of only grading the
    present."""
    rows = (series_payload or {}).get("samples") or []
    now = (series_payload or {}).get("now") or time.time()
    prefixes = tuple(prefixes)
    by_key: dict[str, list] = {}
    for row in rows:
        for key, v in row.get("values", {}).items():
            if any(key.startswith(p) for p in prefixes):
                by_key.setdefault(key, []).append((row["t"], v))
    onsets = []
    for key, points in by_key.items():
        values = sorted(v for _, v in points)
        median = values[len(values) // 2]
        threshold = factor * median if median > 0 else 0
        onset = None
        for t, v in points:
            if v > threshold:
                onset = (t, v)
                break
        if onset is None:
            continue
        # a series ALWAYS above threshold has no onset in the window —
        # it was already breaching when retention began; say so rather
        # than claiming the window's first sample is the start
        began = onset[0] > points[0][0]
        onsets.append({"key": key, "t": onset[0],
                       "ago_s": round(max(0.0, now - onset[0]), 1),
                       "value": onset[1], "median": median,
                       "from_window_start": not began})
    onsets.sort(key=lambda o: o["t"])
    return onsets[:cap]


__all__ = [
    "SeriesStore", "assemble_timeline", "render_timeline", "render_top",
    "top_payload", "series_onsets", "series_sort_key", "sparkline",
    "flatten_registry", "resample", "DEFAULT_TIMELINE_PREFIXES",
]
