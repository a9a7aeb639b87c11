"""Cluster health plane: online anomaly detectors, the durable
black-box, and the cross-member ``doctor`` assembly
(docs/OBSERVABILITY.md "Health & diagnosis").

The *recording* tiers — the metrics substrate, the device-plane
flight recorder, cross-member causal tracing — existed, but nothing in
the tree *interpreted* them: an operator staring at ``/stats`` on
three members had to correlate leader churn, commit stalls, fsync
spikes and ingress backlog by hand. This module is the interpretation
layer, three pieces:

- **Detectors + :class:`HealthMonitor`** — a small library of host-side
  anomaly detectors evaluated on metric-registry deltas at a fixed
  cadence (``COPYCAT_HEALTH_INTERVAL_S``). Each detector grades one
  failure signature ``ok``/``warn``/``critical`` and attaches the
  evidence series it judged, so the ``/health`` verdict explains
  itself. The monitor feeds the ``health.*`` metric family and spills
  non-ok findings into the black-box.
- **:class:`BlackBox`** — the flight recorder's crash-surviving on-disk
  spill: a CRC-framed append-only ring in the storage directory
  (``server/snapshot.py``'s framing discipline, one frame per event,
  two rotated generations bounded by ``COPYCAT_BLACKBOX_BYTES``). Boot
  reloads the previous life's events tagged ``recovered=true``, so
  post-SIGKILL forensics see exactly the events leading up to death.
  Records are flushed per event: a SIGKILL loses nothing (page cache
  survives process death); power-loss durability is bounded by the
  storage fsync policy like everything else host-side.
- **Doctor assembly** — :func:`assemble_doctor_report` /
  :func:`render_doctor_report`: pure functions correlating the
  ``/health`` + ``/flight`` + ``/stats`` payloads fanned out from every
  member (``copycat-tpu doctor``) into a root-cause report — "group 0
  commit stalled 4.1s: follower local:6002 fsync spike (disk),
  replication window pinned at floor". Unreachable members mark the
  report ``incomplete=true`` with reasons, mirroring the trace
  assembly's semantics — partial reports render, never drop.

``COPYCAT_HEALTH=0`` removes the whole plane — no monitor task, no
black-box file, no ``health.*`` keys, no fsync timing — restoring the
pre-health server bit-identically (the standing A/B discipline).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Any, Iterable

from . import knobs
from .scheduled import Scheduled, schedule_repeating
from .timeseries import series_onsets

logger = logging.getLogger(__name__)

OK, WARN, CRITICAL = "ok", "warn", "critical"
_RANK = {OK: 0, WARN: 1, CRITICAL: 2}


def worst(grades: Iterable[str]) -> str:
    """The worst severity in ``grades`` (``ok`` when empty)."""
    top = OK
    for g in grades:
        if _RANK.get(g, 0) > _RANK[top]:
            top = g
    return top


class Finding:
    """One detector's graded verdict for one scope (a group, or the
    server when ``group`` is ``None``) with the evidence series that
    produced it."""

    __slots__ = ("detector", "severity", "reason", "group", "evidence")

    def __init__(self, detector: str, severity: str, reason: str = "",
                 group: int | None = None,
                 evidence: dict[str, list] | None = None) -> None:
        self.detector = detector
        self.severity = severity
        self.reason = reason
        self.group = group
        self.evidence = evidence or {}

    def as_dict(self) -> dict:
        d = {"detector": self.detector, "severity": self.severity,
             "reason": self.reason, "evidence": self.evidence}
        if self.group is not None:
            d["group"] = self.group
        return d


# ---------------------------------------------------------------------------
# detectors: each grades ONE failure signature over a window of samples
# ---------------------------------------------------------------------------

#: a history row is ``(t_monotonic, sample_dict)``; samples come from
#: ``RaftGroup.health_sample()`` (group scope) or
#: ``RaftServer.health_sample()`` (server scope)
History = "deque[tuple[float, dict]]"


def _series(history, key: str) -> list:
    return [s.get(key, 0) for _, s in history]


class Detector:
    """Base: subclasses set ``name``/``scope`` and implement
    :meth:`evaluate` over one scope's sample window."""

    name = "detector"
    scope = "group"  # or "server"

    def evaluate(self, history, group: int | None) -> Finding:
        raise NotImplementedError

    def _finding(self, severity: str, reason: str, group: int | None,
                 **evidence) -> Finding:
        return Finding(self.name, severity, reason, group,
                       {k: v for k, v in evidence.items()})


class LeaderChurnDetector(Detector):
    """Elections + leader transitions per window above the churn bound:
    the election-instability signature (partitions, overloaded members,
    mistimed election timeouts)."""

    name = "leader_churn"

    def __init__(self) -> None:
        self.warn_at = max(1, knobs.get_int("COPYCAT_HEALTH_CHURN_WARN"))

    def evaluate(self, history, group):
        elections = _series(history, "elections")
        transitions = _series(history, "transitions")
        churn = (elections[-1] - elections[0]) \
            + (transitions[-1] - transitions[0])
        if churn >= 2 * self.warn_at:
            sev = CRITICAL
        elif churn >= self.warn_at:
            sev = WARN
        else:
            return self._finding(OK, "", group)
        return self._finding(
            sev, f"{churn} elections/transitions in the last "
                 f"{len(history)} samples (warn at {self.warn_at})",
            group, elections=elections, transitions=transitions)


class CommitStallDetector(Detector):
    """The commit index frozen behind the log tail for longer than the
    stall bound; lag GROWING meanwhile (appends still landing with no
    quorum to commit them — the partitioned-leader signature) grades
    critical."""

    name = "commit_stall"

    def __init__(self) -> None:
        self.stall_s = knobs.get_float("COPYCAT_HEALTH_STALL_S")

    def evaluate(self, history, group):
        t_last, last = history[-1]
        commit = last.get("commit_index", 0)
        lag = last.get("log_last_index", 0) - commit
        if lag <= 0:
            return self._finding(OK, "", group)
        # how long has commit sat at exactly this value with lag open?
        stalled_since = t_last
        lag_at_start = lag
        for t, s in reversed(history):
            if s.get("commit_index", 0) != commit \
                    or s.get("log_last_index", 0) <= commit:
                break
            stalled_since = t
            lag_at_start = s.get("log_last_index", 0) - commit
        stalled = t_last - stalled_since
        if stalled < self.stall_s:
            return self._finding(OK, "", group)
        growing = lag > lag_at_start
        sev = CRITICAL if growing else WARN
        detail = "and growing" if growing else "frozen"
        return self._finding(
            sev, f"commit stalled {stalled:.1f}s at index {commit} with "
                 f"{lag} uncommitted entries ({detail})",
            group, commit_index=_series(history, "commit_index"),
            log_last_index=_series(history, "log_last_index"))


class WindowCollapseDetector(Detector):
    """A replication stream's AIMD window collapsing to its floor (the
    congested/slow-follower signature). Judged on the stream's
    cumulative floor-hit counter, not the sampled window value — the
    pinned state is transient by design (AIMD regrows once its EWMA
    re-baselines) and a gauge would miss it. Rewinds landing in the
    same window grade critical (divergence storms, not just
    congestion)."""

    name = "window_collapse"

    def evaluate(self, history, group):
        _, first = history[0]
        _, last = history[-1]
        now: dict = last.get("repl_windows", {})
        before: dict = first.get("repl_windows", {})
        rewinds = _series(history, "rewinds")
        rewind_delta = rewinds[-1] - rewinds[0]
        collapsed = sorted(
            peer for peer, wf in now.items()
            if wf[2] > before.get(peer, (0, 0, 0))[2])
        pinned = sorted(peer for peer, wf in now.items()
                        if wf[0] <= wf[1])
        if not collapsed and not (pinned and rewind_delta > 0):
            return self._finding(OK, "", group)
        peers = sorted(set(collapsed) | set(pinned))
        sev = CRITICAL if rewind_delta > 0 else WARN
        tail = f", {rewind_delta} rewinds" if rewind_delta else ""
        return self._finding(
            sev, f"replication window collapsed to floor for "
                 f"{', '.join(peers)}{tail}",
            group, peers=peers, rewinds=rewinds,
            windows={p: list(wf) for p, wf in now.items()})


class FsyncSpikeDetector(Detector):
    """Commit-boundary fsync latency spiking past the pre-window EWMA
    baseline: the slow/failing-disk signature. Judged against the
    baseline at the window START, so a sustained slow disk cannot hide
    by dragging the EWMA up to meet itself."""

    name = "fsync_spike"

    def __init__(self) -> None:
        self.factor = knobs.get_float("COPYCAT_HEALTH_FSYNC_FACTOR")

    def evaluate(self, history, group):
        _, first = history[0]
        _, last = history[-1]
        if last.get("fsyncs", 0) <= first.get("fsyncs", 0):
            return self._finding(OK, "", group)  # no fsyncs this window
        # baseline: the EARLIEST learned EWMA in the window — not
        # blindly sample 0, which is 0.0 on a server whose monitor
        # started ticking before its first commit fsync (the detector
        # would then sit blind for a whole window's worth of samples)
        learned = next((s.get("fsync_ewma_ms", 0.0) for _, s in history
                        if s.get("fsync_ewma_ms", 0.0) > 0.0), 0.0)
        if learned <= 0.0:
            return self._finding(OK, "", group)  # baseline not learned yet
        # the 1 ms noise floor: page-cache fsyncs baseline in the tens
        # of microseconds, where scheduler jitter alone is a 4x "spike"
        # — a real disk problem clears 4 ms without help
        baseline = max(learned, 1.0)
        recent = max(_series(history, "fsync_max_ms"))
        if recent >= 3 * self.factor * baseline:
            sev = CRITICAL
        elif recent >= self.factor * baseline:
            sev = WARN
        else:
            return self._finding(OK, "", group)
        return self._finding(
            sev, f"fsync {recent:.1f}ms vs {baseline:.2f}ms baseline "
                 f"({recent / baseline:.0f}x)",
            group, fsync_max_ms=_series(history, "fsync_max_ms"),
            fsync_ewma_ms=_series(history, "fsync_ewma_ms"))


class SessionExpiryDetector(Detector):
    """Session expiries per window above the storm bound: clients dying
    en masse, or keep-alives not getting through (an ingress or
    partition symptom seen from the session plane)."""

    name = "session_expiry"

    def __init__(self) -> None:
        self.warn_at = max(1, knobs.get_int("COPYCAT_HEALTH_EXPIRY_WARN"))

    def evaluate(self, history, group):
        expired = _series(history, "sessions_expired")
        delta = expired[-1] - expired[0]
        if delta >= 3 * self.warn_at:
            sev = CRITICAL
        elif delta >= self.warn_at:
            sev = WARN
        else:
            return self._finding(OK, "", group)
        return self._finding(
            sev, f"{delta} sessions expired in the last "
                 f"{len(history)} samples (warn at {self.warn_at})",
            group, sessions_expired=expired)


class SnapshotFailureDetector(Detector):
    """Snapshot capture or install failures since the window start:
    each one silently degrades recovery (longer replays, installs
    falling back) long before anything else looks wrong."""

    name = "snapshot_failure"

    def evaluate(self, history, group):
        failures = _series(history, "snap_failures")
        delta = failures[-1] - failures[0]
        if delta == 0:
            return self._finding(OK, "", group)
        sev = CRITICAL if delta >= 3 else WARN
        return self._finding(
            sev, f"{delta} snapshot capture/install failure(s)",
            group, snap_failures=failures)


class IngressBacklogDetector(Detector):
    """Server-scope: the ingress/proxy plane backing up — in-flight
    proxied sub-requests plus undelivered session events growing past
    the queue bound (a saturated or unreachable group leader seen from
    the ingress side)."""

    name = "ingress_backlog"
    scope = "server"

    def __init__(self) -> None:
        self.warn_at = max(1, knobs.get_int("COPYCAT_HEALTH_QUEUE_WARN"))

    def evaluate(self, history, group):
        depth = [s.get("proxy_inflight", 0) + s.get("event_backlog", 0)
                 for _, s in history]
        now = depth[-1]
        growing = len(depth) >= 2 and now > depth[0]
        if now >= 4 * self.warn_at:
            sev = CRITICAL
        elif now >= self.warn_at and growing:
            sev = WARN
        else:
            return self._finding(OK, "", group)
        return self._finding(
            sev, f"ingress backlog at {now} "
                 f"({'growing' if growing else 'flat'}, warn at "
                 f"{self.warn_at})",
            group, backlog=depth)


class SloBurnDetector(Detector):
    """Error-budget burn against the operator's service objectives
    (``COPYCAT_SLO_P99_MS`` latency, ``COPYCAT_SLO_AVAIL``
    availability), judged over the RETAINED series window
    (``utils/timeseries.py``) — minutes of history, not the monitor's
    short evidence deque — and exported as the ``slo.*`` gauge family.

    Availability: an interval burns budget when any group's commit sat
    frozen behind its log tail across the sample (lag open, commit not
    advancing — the cluster could not serve that group). Burn rate is
    the window error rate over the objective's error budget; sustained
    burn >= 1x eats the whole budget, >= 10x is the classic fast-burn
    page. Latency: the fraction of ACTIVE intervals (commit-latency
    histogram advanced) whose sampled p99 exceeded the objective —
    needs tracing on, since ``latency.commit_ms`` only advances for
    traced requests.

    Constructed only when the host server carries a series store
    (``COPYCAT_SERIES=1`` + health plane on), so the off-plane stays
    bit-identical."""

    name = "slo_burn"
    scope = "server"

    def __init__(self, server: Any) -> None:
        self.server = server
        raw_p99 = knobs.get_raw("COPYCAT_SLO_P99_MS")
        raw_avail = knobs.get_raw("COPYCAT_SLO_AVAIL")
        self.p99_ms = float(raw_p99) if raw_p99 else None
        self.avail = float(raw_avail) if raw_avail else None
        # slo.* gauges exist only for objectives the operator actually
        # set: an unconfigured detector leaves the registry untouched
        m = server.metrics_server_registry()
        self._m: dict = {}
        if self.p99_ms is not None:
            self._m["p99_objective_ms"] = m.gauge("slo.p99_objective_ms")
            self._m["p99_observed_ms"] = m.gauge("slo.p99_observed_ms")
            self._m["p99_burn"] = m.gauge("slo.p99_burn")
            self._m["p99_objective_ms"].set(self.p99_ms)
        if self.avail is not None:
            self._m["avail_objective"] = m.gauge("slo.avail_objective")
            self._m["avail_observed"] = m.gauge("slo.avail_observed")
            self._m["avail_burn"] = m.gauge("slo.avail_burn")
            self._m["avail_objective"].set(self.avail)

    def evaluate(self, history, group):
        store = getattr(self.server, "series", None)
        if store is None or (self.p99_ms is None and self.avail is None):
            return self._finding(OK, "", group)
        rows = store.rows()
        if len(rows) < 2:
            return self._finding(OK, "", group)
        sev = OK
        reasons: list[str] = []
        evidence: dict = {}
        if self.avail is not None:
            bad = 0
            stuck_series: list[int] = []
            lag_keys = sorted({k for _, v in rows for k in v
                               if k.split("{", 1)[0] == "raft_commit_lag"})
            for i in range(1, len(rows)):
                prev_v, cur = rows[i - 1][1], rows[i][1]
                stuck = any(
                    cur.get(lk, 0) > 0
                    and cur.get(lk.replace("raft_commit_lag",
                                           "raft_commit_index", 1), 0)
                    <= prev_v.get(lk.replace("raft_commit_lag",
                                             "raft_commit_index", 1), 0)
                    for lk in lag_keys)
                stuck_series.append(1 if stuck else 0)
                bad += 1 if stuck else 0
            total = len(rows) - 1
            error_rate = bad / total
            observed = 1.0 - error_rate
            burn = error_rate / max(1e-9, 1.0 - self.avail)
            self._m["avail_observed"].set(round(observed, 6))
            self._m["avail_burn"].set(round(burn, 3))
            if burn >= 1.0:
                sev = worst((sev, CRITICAL if burn >= 10.0 else WARN))
                reasons.append(
                    f"availability burn {burn:.1f}x budget (observed "
                    f"{100 * observed:.2f}% vs objective "
                    f"{100 * self.avail:.2f}% over {total} intervals)")
                evidence["unavailable_intervals"] = stuck_series[-30:]
        if self.p99_ms is not None:
            judged = violations = 0
            worst_p99 = 0.0
            p99_series: list[float] = []
            for i in range(1, len(rows)):
                cur = rows[i][1]
                if not any(v > 0 for k, v in cur.items()
                           if k.startswith("latency.commit_ms")
                           and k.endswith(".count")):
                    continue
                judged += 1
                p = max((v for k, v in cur.items()
                         if k.startswith("latency.commit_ms")
                         and k.endswith(".p99")), default=0.0)
                p99_series.append(round(p, 3))
                worst_p99 = max(worst_p99, p)
                if p > self.p99_ms:
                    violations += 1
            if judged:
                frac = violations / judged
                self._m["p99_observed_ms"].set(round(worst_p99, 3))
                self._m["p99_burn"].set(round(frac, 3))
                if frac >= 0.1:
                    sev = worst((sev, CRITICAL if frac >= 0.5 else WARN))
                    reasons.append(
                        f"commit p99 {worst_p99:.1f}ms breached the "
                        f"{self.p99_ms:.0f}ms objective in "
                        f"{100 * frac:.0f}% of {judged} active intervals")
                    evidence["commit_p99_ms"] = p99_series[-30:]
        if sev == OK:
            return self._finding(OK, "", group)
        return self._finding(sev, "; ".join(reasons), group, **evidence)


class LoopStallDetector(Detector):
    """Event-loop holds over ``COPYCAT_PROFILE_HOLD_MS``, judged on the
    per-window max hold with the holding frame as evidence — the
    profiling plane's runtime complement to the copycheck loop-blocking
    rule. A hold at the threshold grades ``warn``; 5x the threshold
    grades ``critical`` (a 500ms+ hold under the default freezes
    heartbeats and elections alike).

    Reads the profiler's bounded hold ring over the evidence window's
    actual span (the history deque's timestamps), so one old hold ages
    out of the verdict exactly like every delta detector's evidence.
    Constructed only when the host carries a profiler
    (``COPYCAT_PROFILE=1``), keeping the off-plane detector set — and
    every ``health.*`` key — bit-identical.

    In-process multi-server clusters share one process-wide profiler,
    so every co-resident member's detector sees the same holds: honest
    for a process-level property (the loop and the GIL are shared)."""

    name = "loop_stall"
    scope = "server"

    def __init__(self, server: Any) -> None:
        self.server = server
        self.hold_ms = max(1.0,
                           knobs.get_float("COPYCAT_PROFILE_HOLD_MS"))

    def evaluate(self, history, group):
        prof = getattr(self.server, "profiler", None)
        if prof is None:
            return self._finding(OK, "", group)
        lookback = 30.0
        if len(history) >= 2:
            lookback = max(1.0, history[-1][0] - history[0][0])
        holds = prof.holds_since(time.time() - lookback)
        if not holds:
            return self._finding(OK, "", group)
        worst_hold = max(holds, key=lambda h: h["ms"])
        sev = (CRITICAL if worst_hold["ms"] >= 5 * self.hold_ms
               else WARN)
        return self._finding(
            sev,
            f"event loop held {worst_hold['ms']:.0f}ms by "
            f"{worst_hold['frame']} ({len(holds)} hold(s) >= "
            f"{self.hold_ms:.0f}ms in {lookback:.0f}s)",
            group,
            max_hold_ms=worst_hold["ms"],
            frames=[h["frame"] for h in holds[-5:]],
            stack=worst_hold.get("stack", ""))


GROUP_DETECTORS = (LeaderChurnDetector, CommitStallDetector,
                   WindowCollapseDetector, FsyncSpikeDetector,
                   SessionExpiryDetector, SnapshotFailureDetector)
SERVER_DETECTORS = (IngressBacklogDetector,)
#: the catalog of detector names (docs/OBSERVABILITY.md) — slo_burn
#: and loop_stall construct with the host server, so they ride
#: neither class tuple
DETECTOR_NAMES = tuple(d.name for d in GROUP_DETECTORS
                       + SERVER_DETECTORS) \
    + (SloBurnDetector.name, LoopStallDetector.name)


# ---------------------------------------------------------------------------
# the monitor: cadence sampling + evaluation + exposition
# ---------------------------------------------------------------------------


class HealthMonitor:
    """Samples a :class:`RaftServer`'s groups at a fixed cadence,
    evaluates every detector on the windows, and keeps the last verdict
    for the ``/health`` route. Constructed only when ``COPYCAT_HEALTH``
    is on — its absence IS the A/B off-plane."""

    def __init__(self, server: Any, interval: float | None = None,
                 window: int | None = None) -> None:
        self.server = server
        self.interval = (interval if interval is not None
                         else knobs.get_float("COPYCAT_HEALTH_INTERVAL_S"))
        self.window = max(2, window if window is not None
                          else knobs.get_int("COPYCAT_HEALTH_WINDOW"))
        self.group_detectors = [cls() for cls in GROUP_DETECTORS]
        self.server_detectors = [cls() for cls in SERVER_DETECTORS]
        if getattr(server, "series", None) is not None:
            # SLO burn judges the RETAINED series window, so it exists
            # exactly when the series plane does — COPYCAT_SERIES=0
            # keeps the detector set (and every health.* key)
            # bit-identical to the pre-series plane
            self.server_detectors.append(SloBurnDetector(server))
        if getattr(server, "profiler", None) is not None:
            # loop_stall judges the profiler's hold ring, so it exists
            # exactly when the profiling plane does — COPYCAT_PROFILE=0
            # keeps the detector set (and every health.* key)
            # bit-identical to the pre-profiler plane
            self.server_detectors.append(LoopStallDetector(server))
        self._history: dict[int, deque] = {}
        self._server_history: deque = deque(maxlen=self.window)
        self._timer: Scheduled | None = None
        self._last_severity: dict[tuple, str] = {}
        self._last_tick = 0.0
        self.ticks = 0
        self.last_verdict: dict | None = None
        m = server.metrics_server_registry()
        self._m_checks = m.counter("health.checks")
        self._m_findings = {sev: m.counter("health.findings", severity=sev)
                            for sev in (WARN, CRITICAL)}
        self._m_status = m.gauge("health.status")
        self._m_detector = {
            d.name: m.gauge("health.detector_status", detector=d.name)
            for d in self.group_detectors + self.server_detectors}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._timer is None:
            self._timer = schedule_repeating(self.interval, self.interval,
                                             self.tick)

    def stop(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    # -- sampling + evaluation ---------------------------------------------

    def verdict(self) -> dict:
        """The current verdict for the ``/health`` route: re-evaluates
        at most once per half-cadence, serving the cached verdict to
        faster pollers. Every tick APPENDS a sample to the
        count-bounded evidence deques — an unthrottled 5 Hz probe would
        shrink every delta detector's lookback from ~window x interval
        to ~window/5 seconds, so observing health would suppress it."""
        now = time.monotonic()
        if self.last_verdict is None \
                or now - self._last_tick >= self.interval / 2:
            return self.tick()
        return self.last_verdict

    def tick(self) -> dict:
        """Sample every group + the server plane, evaluate all
        detectors, update the ``health.*`` family, spill newly non-ok
        findings to the black-box, and return (and keep) the verdict."""
        now = time.monotonic()
        self._last_tick = now
        self.server._attach_flight_spill()
        # the retrospective-telemetry ring rides THIS cadence — the
        # series plane spawns no task of its own (utils/timeseries.py)
        tick_series = getattr(self.server, "series_tick", None)
        if tick_series is not None:
            tick_series()
        findings: list[Finding] = []
        for grp in self.server.groups:
            hist = self._history.get(grp.group_id)
            if hist is None:
                hist = self._history[grp.group_id] = deque(
                    maxlen=self.window)
            hist.append((now, grp.health_sample()))
            for det in self.group_detectors:
                findings.append(det.evaluate(hist, grp.group_id))
        self._server_history.append((now, self.server.health_sample()))
        for det in self.server_detectors:
            findings.append(det.evaluate(self._server_history, None))
        self.ticks += 1
        self._m_checks.inc()
        verdict = self._fold(findings)
        self.last_verdict = verdict
        return verdict

    def _fold(self, findings: list[Finding]) -> dict:
        by_detector: dict[str, dict] = {}
        reasons: list[str] = []
        group_status: dict[int, str] = {}
        for f in findings:
            entry = by_detector.setdefault(
                f.detector, {"status": OK, "groups": {}})
            scope = {"status": f.severity}
            if f.severity != OK:
                scope["reason"] = f.reason
                scope["evidence"] = f.evidence
                where = (f"group {f.group}" if f.group is not None
                         else "server")
                reasons.append(f"{where}: {f.reason} [{f.detector}]")
                self._m_findings[f.severity].inc()
                key = (f.detector, f.group)
                if self._last_severity.get(key, OK) != f.severity:
                    # spill TRANSITIONS, not every tick — the black-box
                    # ring must survive a long outage without the storm
                    # evicting its own onset
                    self.server.health_note(
                        "health", detector=f.detector,
                        severity=f.severity, group=f.group,
                        reason=f.reason)
            self._last_severity[(f.detector, f.group)] = f.severity
            entry["groups"][("server" if f.group is None
                             else str(f.group))] = scope
            entry["status"] = worst((entry["status"], f.severity))
            if f.group is not None:
                group_status[f.group] = worst(
                    (group_status.get(f.group, OK), f.severity))
        status = worst(e["status"] for e in by_detector.values())
        self._m_status.set(_RANK[status])
        for name, entry in by_detector.items():
            self._m_detector[name].set(_RANK[entry["status"]])
        g0 = self.server.groups[0]
        return {
            "status": status,
            "node": str(self.server.address),
            "role": g0.role,
            "term": g0.term,
            "ticks": self.ticks,
            "checked_at": round(time.time(), 3),
            "reasons": reasons,
            "detectors": by_detector,
            "groups": {str(g): s for g, s in sorted(group_status.items())},
        }


# ---------------------------------------------------------------------------
# the durable black-box
# ---------------------------------------------------------------------------


class BlackBox:
    """Crash-surviving flight-recorder spill: one CRC-framed record per
    event appended to ``<path>``, rotated to ``<path>.1`` past
    ``max_bytes`` (two generations = a bounded on-disk ring). Reads
    distrust everything past the first torn frame, same discipline as
    the log segments."""

    def __init__(self, path: str, max_bytes: int | None = None,
                 recovered_cap: int = 512) -> None:
        self.path = path
        self.max_bytes = max(4096, max_bytes if max_bytes is not None
                             else knobs.get_int("COPYCAT_BLACKBOX_BYTES"))
        self._seq = 0
        self._live: deque = deque(maxlen=recovered_cap)
        self.torn = 0
        #: previous lives' events, oldest first, each tagged
        #: ``recovered=True`` — what post-SIGKILL forensics read
        self.recovered: list[dict] = []
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._load(recovered_cap)
        self._fh = open(self.path, "ab")

    # -- write path --------------------------------------------------------

    def record(self, kind: str, **fields) -> dict:
        self._seq += 1
        event = {"seq": self._seq, "t": round(time.time(), 3),
                 "kind": kind, **fields}
        self._append(event)
        self._live.append(event)
        return event

    def spill_event(self, event: dict) -> None:
        """Spill hook for a :class:`~copycat_tpu_torch.models.telemetry.
        FlightRecorder`: persists the ring event as-is (it already
        carries seq/t/kind)."""
        self._append(event)

    def _append(self, event: dict) -> None:
        from ..server.snapshot import frame

        try:
            payload = json.dumps(event, default=str).encode()
            if self._fh.tell() + len(payload) > self.max_bytes:
                self._rotate()
            self._fh.write(frame(payload))
            # flush, no fsync: a SIGKILL cannot lose page-cache bytes;
            # power-loss durability is the storage fsync policy's job
            self._fh.flush()
        except (OSError, ValueError):  # pragma: no cover - disk full/EIO
            logger.warning("black-box append to %s failed", self.path,
                           exc_info=True)

    def _rotate(self) -> None:
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "ab")

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:  # pragma: no cover
            pass

    # -- read path ---------------------------------------------------------

    def _load(self, cap: int) -> None:
        from ..server.snapshot import _HEADER, MAGIC, unframe

        events: list[dict] = []
        for path in (self.path + ".1", self.path):
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            off = 0
            torn_here = False
            while off < len(data):
                # the length field sits right after the frame magic —
                # derived from the imported constants so the framing
                # has exactly one definition (server/snapshot.py)
                length = int.from_bytes(
                    data[off + len(MAGIC):off + len(MAGIC) + 8], "little")
                payload = unframe(data[off:off + _HEADER + length])
                if payload is None:
                    # torn/corrupt frame: distrust everything after it
                    self.torn += 1
                    torn_here = True
                    break
                try:
                    event = json.loads(payload)
                except ValueError:
                    self.torn += 1
                    torn_here = True
                    break
                event["recovered"] = True
                events.append(event)
                off += _HEADER + length
            if torn_here and path == self.path:
                # THIS life appends to this file: truncate the torn
                # tail first, or everything we write lands after
                # garbage and the NEXT boot's scan (which stops at the
                # first bad frame) would silently discard this whole
                # life's forensics
                try:
                    with open(path, "r+b") as f:
                        f.truncate(off)
                except OSError:  # pragma: no cover - disk trouble
                    pass
        self.recovered = events[-cap:]

    def events(self) -> list[dict]:
        """Recovered (previous lives) then live events, in order."""
        return self.recovered + list(self._live)

    def summary(self) -> dict:
        return {"path": self.path, "recovered_events": len(self.recovered),
                "live_events": len(self._live), "torn_frames": self.torn}


# ---------------------------------------------------------------------------
# the doctor: cross-member correlation into a root-cause report
# ---------------------------------------------------------------------------

#: detector -> the cause phrasing the doctor report uses when the
#: finding explains a commit stall on the same group
_CAUSE_PHRASES = {
    "fsync_spike": "slow disk (fsync spike)",
    "window_collapse": "replication window collapsed",
    "leader_churn": "election instability (leader churn)",
}

#: the retained series the doctor's retrospective scans for anomaly
#: onsets — the families whose "when did it start" answers root-cause
#: questions (lag/elections = consensus, latency./repl. = data plane,
#: slo. = the burn itself)
_RETRO_PREFIXES = ("raft_commit_lag", "raft_elections_started",
                   "latency.", "repl.", "slo.")


def _member_label(member: str, payload: dict | None) -> str:
    """A member's stable identity: the raft node address its ``/health``
    payload self-reports (the label every OTHER member's evidence uses
    — peer lists, leader fields), falling back to the fetch address."""
    return ((payload or {}).get("health") or {}).get("node") or member


def _member_findings(members: dict[str, dict]) -> list[dict]:
    """Flatten every member's ``/health`` payload into rows of
    ``{member, detector, group, severity, reason}`` (non-ok only),
    labeled by node identity so cross-member evidence (a leader's
    pinned-peer list) matches."""
    rows: list[dict] = []
    for key, payload in members.items():
        member = _member_label(key, payload)
        health = (payload or {}).get("health") or {}
        for name, entry in (health.get("detectors") or {}).items():
            for scope, info in (entry.get("groups") or {}).items():
                if info.get("status", OK) == OK:
                    continue
                rows.append({
                    "member": member, "detector": name,
                    "group": None if scope == "server" else int(scope),
                    "severity": info.get("status"),
                    "reason": info.get("reason", ""),
                    "evidence": info.get("evidence", {}),
                })
    return rows


def _invariant_counts(members: dict[str, dict]) -> dict[str, int]:
    """Total invariant violations per member from its ``/stats``
    snapshot (server ``repl.invariant_violations`` + every
    ``device.invariant_violations{kind=}`` series)."""
    out: dict[str, int] = {}
    for key, payload in members.items():
        member = _member_label(key, payload)
        total = 0
        stats = (payload or {}).get("stats") or {}
        raft = stats.get("raft") or {}
        for key, value in raft.items():
            if key.startswith("repl.invariant_violations") \
                    and isinstance(value, (int, float)):
                total += int(value)
        device = ((stats.get("manager") or {}).get("device")
                  or {}) if isinstance(stats.get("manager"), dict) else {}
        for key, value in device.items():
            if key.startswith("device.invariant_violations") \
                    and isinstance(value, (int, float)):
                total += int(value)
        if total:
            out[member] = total
    return out


def assemble_doctor_report(members: dict[str, dict],
                           failed_members: Iterable[str] = (),
                           slowest_traces: list | None = None) -> dict:
    """Correlate the per-member payloads into one root-cause report.

    ``members`` maps a member address to
    ``{"health": <//health JSON>, "flight": <//flight JSON>,
    "stats": <//stats JSON>}`` (any value may be ``None`` when that
    route failed); addresses whose fan-out failed entirely go in
    ``failed_members`` and mark the report ``incomplete=true`` with
    reasons — mirroring the trace assembly's semantics, partial reports
    render, never drop.

    The correlation: every commit stall is matched with candidate
    causes from the SAME group on ANY member (fsync spikes = disk,
    window collapse = replication, leader churn = elections,
    unreachable members = partition), crash recoveries surface the
    black-box events leading up to death, and invariant-counter
    violations always rank first.
    """
    failed = sorted(set(failed_members))
    rows = _member_findings(members)
    causes: list[dict] = []

    # stall notes from the profiling plane: recent loop_stall flight /
    # black-box events per member, heaviest hold first — the "which
    # code held the loop" evidence the commit_stall / fsync_spike
    # causes cite below when the notes fall inside the report's
    # lookback (~2 profile windows)
    stall_notes: dict[str, list[dict]] = {}
    now = time.time()
    for key, payload in sorted(members.items()):
        member = _member_label(key, payload)
        flight = (payload or {}).get("flight") or {}
        events = list(flight.get("events", ()))
        events += ((flight.get("blackbox") or {}).get("events") or [])
        notes = [e for e in events
                 if e.get("kind") == "loop_stall"
                 and not e.get("recovered")
                 and isinstance(e.get("t"), (int, float))
                 and now - e["t"] <= 240.0]
        if notes:
            notes.sort(key=lambda e: -float(e.get("hold_ms", 0.0)))
            stall_notes[member] = notes

    # 1. invariant violations: a safety counter that moved outranks any
    #    performance symptom
    for member, count in sorted(_invariant_counts(members).items()):
        causes.append({
            "severity": CRITICAL, "group": None,
            "symptom": f"{count} invariant violation(s) on {member}",
            "cause": "safety invariant violated — inspect /flight on "
                     f"{member}",
            "members": [member], "detectors": ["invariants"],
        })

    # 2. commit stalls, matched with same-group causes across members
    stalls = [r for r in rows if r["detector"] == "commit_stall"]
    explained: set[tuple] = set()
    for stall in stalls:
        g = stall["group"]
        support = [r for r in rows
                   if r["group"] == g and r["detector"] in _CAUSE_PHRASES]
        cause_bits: list[str] = []
        cause_members: list[str] = [stall["member"]]
        cause_detectors = ["commit_stall"]
        for r in support:
            phrase = _CAUSE_PHRASES.get(r["detector"])
            if phrase is None:
                continue
            cause_bits.append(f"{r['member']}: {phrase} — {r['reason']}")
            cause_members.append(r["member"])
            cause_detectors.append(r["detector"])
            explained.add((r["member"], r["detector"], r["group"]))
        if failed:
            cause_bits.append(
                "unreachable member(s) " + ", ".join(failed)
                + " (partition or crash)")
        causes.append({
            "severity": stall["severity"], "group": g,
            "symptom": f"group {g} {stall['reason']} "
                       f"(on {stall['member']})",
            "cause": ("; ".join(cause_bits) if cause_bits
                      else "no co-located cause found — suspect quorum "
                           "loss (partition) or a dead peer"),
            "members": sorted(set(cause_members)),
            "detectors": sorted(set(cause_detectors)),
        })
        explained.add((stall["member"], "commit_stall", g))

    # 3. replication-window collapses matched with the slow peer's own
    #    fsync findings: "replication to X collapsed — X reports a
    #    fsync spike (disk)" is the cross-member attribution a single
    #    member's /stats can never make
    for r in rows:
        if r["detector"] != "window_collapse" \
                or (r["member"], "window_collapse", r["group"]) in explained:
            continue
        pinned_peers = set(r.get("evidence", {}).get("peers", ()))
        disk = [f for f in rows
                if f["detector"] == "fsync_spike"
                and f["member"] in pinned_peers]
        if not disk:
            continue
        bits = [f"{f['member']}: fsync spike (disk) — {f['reason']}"
                for f in disk]
        causes.append({
            "severity": worst([r["severity"]]
                              + [f["severity"] for f in disk]),
            "group": r["group"],
            "symptom": f"group {r['group']} replication collapsed on "
                       f"{r['member']}: {r['reason']}",
            "cause": "; ".join(bits),
            "members": sorted({r["member"]} | {f["member"] for f in disk}),
            "detectors": ["window_collapse", "fsync_spike"],
        })
        explained.add((r["member"], "window_collapse", r["group"]))
        for f in disk:
            explained.add((f["member"], "fsync_spike", f["group"]))

    # 4. unreachable members are a symptom in their own right (crash,
    #    partition, or a dead stats listener), not just missing data
    for member in failed:
        causes.append({
            "severity": WARN, "group": None,
            "symptom": f"{member} unreachable",
            "cause": "member crashed, partitioned away, or its stats "
                     "listener is down — the report is missing its "
                     "side of the story",
            "members": [member], "detectors": ["fanout"],
        })

    # 5. crash recoveries: a member whose flight ring carries recovered
    #    black-box events died recently — surface what preceded death
    for key, payload in sorted(members.items()):
        member = _member_label(key, payload)
        flight = (payload or {}).get("flight") or {}
        bb = flight.get("blackbox") or {}
        recovered = [e for e in flight.get("events", ())
                     if e.get("recovered")] or bb.get("recovered", [])
        if not recovered:
            continue
        tail = recovered[-3:]
        kinds = ", ".join(e.get("kind", "?") for e in tail)
        causes.append({
            "severity": WARN, "group": None,
            "symptom": f"{member} recovered from a crash "
                       f"({len(recovered)} black-box events from the "
                       f"previous life)",
            "cause": f"black-box tail before death: {kinds}",
            "members": [member], "detectors": ["blackbox"],
            "events": tail,
        })

    # 6. remaining standalone findings (churn with no stall, expiry
    #    storms, snapshot failures, ingress backlog...)
    for r in rows:
        if (r["member"], r["detector"], r["group"]) in explained:
            continue
        if r["detector"] == "commit_stall":
            continue
        where = f"group {r['group']}" if r["group"] is not None \
            else "server"
        causes.append({
            "severity": r["severity"], "group": r["group"],
            "symptom": f"{r['member']} {where}: {r['reason']}",
            "cause": {"leader_churn":
                      "election instability — check connectivity "
                      "between members and election timeouts",
                      "fsync_spike": "slow disk on this member",
                      "window_collapse":
                      "slow or unreachable follower(s)",
                      "session_expiry":
                      "clients dying or keep-alives not landing",
                      "snapshot_failure":
                      "snapshot plane degraded — recovery will replay",
                      "ingress_backlog":
                      "group leaders saturated or unreachable from "
                      "this ingress",
                      "slo_burn":
                      "SLO error budget burning faster than the "
                      "objective allows — see the retained window "
                      "(doctor --last N / copycat-tpu timeline)",
                      "loop_stall":
                      "synchronous code holding the event loop — the "
                      "cited frame blocked heartbeats, elections and "
                      "appends alike (copycat-tpu profile for the "
                      "full flame)"
                      }.get(r["detector"], r["detector"]),
            "members": [r["member"]], "detectors": [r["detector"]],
        })

    # 7. members whose status is not a graded severity — "disabled"
    #    (COPYCAT_HEALTH=0) or "unknown" (health route unreadable) —
    #    must not read as healthy: zero checks ran there, so a stalled
    #    cluster would render a clean OK verdict
    statuses = {key: ((m or {}).get("health") or {})
                .get("status", "unknown") for key, m in members.items()}
    for key, status in sorted(statuses.items()):
        if status in _RANK:
            continue
        member = _member_label(key, members.get(key))
        causes.append({
            "severity": WARN, "group": None,
            "symptom": f"{member} health status {status!r}",
            "cause": "no detectors ran on this member (health plane "
                     "disabled or /health unreadable) — its side of "
                     "the story is ungraded, not healthy",
            "members": [member], "detectors": ["health_plane"],
        })

    # the profiling plane's citation: a commit stall or fsync spike
    # whose members carry stall notes inside the lookback gets the top
    # holding frames attached — symptom, disk and the blocking CODE in
    # one cause row (what no single detector can say alone)
    for c in causes:
        if not set(c["detectors"]) & {"commit_stall", "fsync_spike"}:
            continue
        frames = []
        for m in c["members"]:
            for note in stall_notes.get(m, ())[:3]:
                frames.append({"member": m,
                               "frame": note.get("frame", "?"),
                               "hold_ms": note.get("hold_ms")})
        if frames:
            c["profile_frames"] = frames

    causes.sort(key=lambda c: -_RANK.get(c["severity"], 0))
    verdict = worst(s for s in statuses.values() if s in _RANK)
    if causes:
        verdict = worst([verdict] + [c["severity"] for c in causes])
    report = {
        "verdict": verdict,
        "members": sorted(members),
        "incomplete": bool(failed),
        "incomplete_why": [f"member {m} unreachable" for m in failed],
        "causes": causes,
        "member_status": {_member_label(m, p):
                          ((p or {}).get("health") or {})
                          .get("status", "unknown")
                          for m, p in sorted(members.items())},
    }
    if slowest_traces:
        report["slowest_traces"] = [
            {"trace": t.get("trace"), "total_ms": t.get("total_ms")}
            for t in slowest_traces[:3]]

    # 8. retrospective (doctor --last N): members whose payloads carry a
    #    retained /series window get their anomaly ONSETS scanned —
    #    "commit lag started climbing 40 s ago" time-correlates the
    #    causes above instead of only grading the present. Members
    #    without series (plane off, pre-series build, no --last) simply
    #    contribute nothing — the section is additive, never required.
    retrospect: dict[str, list] = {}
    for key, payload in sorted(members.items()):
        series = (payload or {}).get("series")
        if not series:
            continue
        onsets = series_onsets(series, _RETRO_PREFIXES)
        if onsets:
            retrospect[_member_label(key, payload)] = onsets
    if retrospect:
        report["retrospect"] = retrospect
        for c in causes:
            notes = []
            for m in c["members"]:
                for o in retrospect.get(m, ())[:2]:
                    start = ("window start"
                             if o.get("from_window_start")
                             else f"{o['ago_s']:.0f}s ago")
                    notes.append(f"{m}: {o['key']} rose to "
                                 f"{o['value']:g} from {start} "
                                 f"(window median {o['median']:g})")
            if notes:
                c["retrospect"] = notes
    return report


def render_doctor_report(report: dict) -> str:
    """The human rendering: verdict banner, per-member one-liners, then
    the ranked root-cause list (incomplete reports carry a loud banner
    — rendered, never dropped)."""
    lines = [f"cluster verdict: {report['verdict'].upper()} "
             f"across {len(report['members'])} member(s)"]
    if report["incomplete"]:
        lines.append("!! INCOMPLETE: "
                     + "; ".join(report["incomplete_why"]))
    for member, status in report["member_status"].items():
        lines.append(f"  {member:<24} {status}")
    if not report["causes"]:
        lines.append("no anomalies detected")
    for i, c in enumerate(report["causes"], 1):
        g = f" [group {c['group']}]" if c.get("group") is not None else ""
        lines.append(f"{i}. {c['severity'].upper()}{g} {c['symptom']}")
        lines.append(f"   cause: {c['cause']}")
        for f in c.get("profile_frames", ()):
            hold = f.get("hold_ms")
            held = f" ({hold:g} ms)" if isinstance(hold, (int, float)) \
                else ""
            lines.append(f"   held by: {f['member']}: "
                         f"{f['frame']}{held}")
        for note in c.get("retrospect", ()):
            lines.append(f"   onset: {note}")
    for t in report.get("slowest_traces", ()):
        lines.append(f"   slow trace {t['trace']}: {t['total_ms']} ms")
    retrospect = report.get("retrospect") or {}
    if retrospect:
        lines.append("retrospective (retained series onsets):")
        for member, onsets in retrospect.items():
            for o in onsets:
                start = ("breaching since window start"
                         if o.get("from_window_start")
                         else f"started {o['ago_s']:.0f}s ago")
                lines.append(f"  {member:<24} {o['key']} -> "
                             f"{o['value']:g} ({start}; window median "
                             f"{o['median']:g})")
    return "\n".join(lines)
