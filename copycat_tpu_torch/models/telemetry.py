"""Host side of the device-plane flight recorder (numpy).

The port's copy of ``copycat_tpu/models/telemetry.py``. With
``Config.telemetry`` on, the consensus step returns a
:class:`~copycat_tpu_torch.ops.consensus.DeviceTelemetry` block of
per-group reductions (elections, leader changes, term bumps, leaderless
rounds, commit advance, applies by pool, ring pressure, submit
rejections, vote splits, outbox drain and drop) with its outputs. This
module turns the fetched deltas into three host surfaces:

- :class:`DeviceTelemetryHub` — a ``MetricsRegistry`` holding the
  ``device.*`` metric family, plus per-group cumulative arrays for shard
  attribution;
- :class:`FlightRecorder` — a bounded ring of timestamped events: one per
  fetch that observed protocol activity, and every invariant violation;
- :class:`InvariantMonitor` — online safety checks on every fetch: commit
  totals and per-group commit indexes monotone, leader-term monotonicity
  at election rounds (a newly elected leader's term is above every leader
  term its group showed before; raw lane terms are not the witness, as a
  snapshot install can lower a deposed candidate's term), a
  leaderless-fraction bound, and a sampled watch-list verifying at most
  one leader per (group, term). Violations count in
  ``device.invariant_violations{kind=...}``, land in the flight ring, and
  raise under ``COPYCAT_INVARIANTS=strict``.

``COPYCAT_INVARIANTS`` modes: unset/``observe`` — check and count;
``strict`` — check and raise :class:`InvariantViolation`; ``off``/``0``
— skip the checks (the metrics still flow). Setting
``COPYCAT_INVARIANTS`` (or ``COPYCAT_TELEMETRY=1``) also turns telemetry
on in engines whose ``Config`` left it off.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any

import numpy as np

from ..ops.apply import NUM_POOLS
from ..utils import knobs
from ..utils.metrics import MetricsRegistry

#: pool-id → label for the ``device.applies{pool=...}`` family (the
#: trailing bucket collects NoOps + config entries — POOL_NONE).
POOL_NAMES = ("value", "map", "set", "queue", "lock", "election",
              "multimap", "topic", "noop")
assert len(POOL_NAMES) == NUM_POOLS + 1

#: invariant check kinds (registered eagerly, so every hub has the same
#: metric key set)
INVARIANT_KINDS = ("commit_monotone", "term_monotone",
                   "leaderless_bound", "leader_per_term")

_COUNTERS = ("device.rounds", "device.elections_started",
             "device.leader_changes", "device.term_bumps",
             "device.leaderless_rounds", "device.commit_advance",
             "device.submit_rejections", "device.vote_splits",
             "device.events_drained", "device.events_dropped")
_GAUGES = ("device.leaderless_groups", "device.term_max",
           "device.commit_total", "device.ring_occupancy_max",
           "device.ring_occupancy_mean")

class InvariantViolation(AssertionError):
    """A device-plane safety invariant failed under
    ``COPYCAT_INVARIANTS=strict``."""


def invariants_mode() -> str:
    """Resolve ``COPYCAT_INVARIANTS`` to ``off`` | ``observe`` |
    ``strict`` (unset defaults to ``observe``)."""
    raw = knobs.get_str("COPYCAT_INVARIANTS", default="observe").strip().lower()
    if raw in ("0", "off", "none", "disabled"):
        return "off"
    if raw == "strict":
        return "strict"
    return "observe"


def telemetry_env_enabled() -> bool:
    """True when the environment opts device telemetry IN for engines
    whose Config left it off: ``COPYCAT_TELEMETRY=1`` or an explicit
    ``COPYCAT_INVARIANTS`` mode that needs the data (observe/strict)."""
    if knobs.get_str("COPYCAT_TELEMETRY", default="").strip().lower() in (
            "1", "on", "true", "yes"):
        return True
    inv = knobs.get_raw("COPYCAT_INVARIANTS")
    if inv is None:
        return False
    return invariants_mode() != "off"


class FlightRecorder:
    """Bounded ring of device-plane events (telemetry spikes, injected
    faults, invariant violations) with host timestamps and engine round
    numbers — the correlation surface: a fault event and the election
    burst it caused sit adjacent in one dump."""

    def __init__(self, capacity: int = 256) -> None:
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._seq = 0
        #: optional durable spill (``utils/health.py::BlackBox``): when
        #: the server's health plane wires it, every ring event is also
        #: appended to the crash-surviving on-disk black-box. ``None``
        #: keeps the ring memory-only.
        self.spill = None

    def record(self, kind: str, round_no: int, **fields) -> dict:
        self._seq += 1
        event = {"seq": self._seq, "t": round(time.time(), 3),
                 "round": int(round_no), "kind": kind, **fields}
        self._ring.append(event)
        if self.spill is not None:
            try:
                self.spill(event)
            except Exception:  # noqa: BLE001 - spill must never wound
                pass
        return event

    def events(self) -> list[dict]:
        return list(self._ring)

    def render_json(self) -> str:
        return json.dumps({"events": self.events()})

    def render_text(self) -> str:
        lines = []
        for ev in self._ring:
            extra = " ".join(f"{k}={v}" for k, v in ev.items()
                             if k not in ("seq", "t", "round", "kind"))
            lines.append(f"#{ev['seq']:<5} r{ev['round']:<8} "
                         f"{ev['kind']:<10} {extra}")
        return "\n".join(lines) + ("\n" if lines else "(no events)\n")


class InvariantMonitor:
    """Online device-plane safety checks fed one fetched telemetry
    block at a time (see the module docstring for the exact invariants
    and why leader terms — not raw lane terms — witness term
    monotonicity)."""

    WATCH = 16          # sampled groups on the per-term leader watch-list
    TERMS_PER_GROUP = 128  # per watched group: term→leader memory cap

    def __init__(self, num_groups: int, metrics: MetricsRegistry,
                 flight: FlightRecorder, mode: str | None = None,
                 leaderless_max: float | None = None) -> None:
        self.mode = mode if mode is not None else invariants_mode()
        self.violations = 0
        self._metrics = metrics
        self._flight = flight
        self._G = num_groups
        if leaderless_max is None:
            leaderless_max = knobs.get_float("COPYCAT_INVARIANT_LEADERLESS_MAX")
        self.leaderless_max = leaderless_max
        # evenly spread deterministic watch-list (no RNG)
        n = min(self.WATCH, num_groups)
        self._watch = np.unique(np.linspace(
            0, max(0, num_groups - 1), num=max(1, n)).astype(np.int64))
        self._leaders: dict[int, dict[int, int]] = {
            int(g): {} for g in self._watch}
        self.reset()

    def reset(self) -> None:
        """Drop monotonicity baselines (call after restoring an older
        checkpoint into the engine — state legitimately moved backward)."""
        self._commit_total = -1
        self._last_commit = np.full(self._G, -1, np.int64)
        self._last_leader_term = np.full(self._G, -1, np.int64)
        for d in self._leaders.values():
            d.clear()

    # -- checks ------------------------------------------------------------

    def _violate(self, kind: str, round_no: int, detail: str) -> None:
        self.violations += 1
        self._metrics.counter("device.invariant_violations",
                              kind=kind).inc()
        self._flight.record("violation", round_no, check=kind,
                            detail=detail)
        if self.mode == "strict":
            raise InvariantViolation(
                f"device invariant {kind} violated at round {round_no}: "
                f"{detail}")

    def observe(self, commit_max: np.ndarray, leader_lane: np.ndarray,
                leader_term: np.ndarray, leaderless: np.ndarray,
                leader_changes: np.ndarray, round_no: int) -> None:
        """Check one fetched round's derived values ([G] each)."""
        if self.mode == "off":
            return
        commit_max = np.asarray(commit_max, np.int64)
        leader_term = np.asarray(leader_term, np.int64)
        leader_changes = np.asarray(leader_changes, np.int64)
        total = int(commit_max.sum())
        if total < self._commit_total:
            self._violate(
                "commit_monotone", round_no,
                f"commit total regressed {self._commit_total} -> {total}")
        self._commit_total = max(self._commit_total, total)
        bad = np.flatnonzero(commit_max < self._last_commit)
        if bad.size:
            g = int(bad[0])
            self._violate(
                "commit_monotone", round_no,
                f"group {g} commit regressed "
                f"{int(self._last_commit[g])} -> {int(commit_max[g])} "
                f"(+{bad.size - 1} more)")
        np.maximum(self._last_commit, commit_max, out=self._last_commit)

        # Term monotonicity is checked at ELECTION rounds only: a newly
        # elected leader's term must be strictly above every leader term
        # the group has shown before (its voters' quorum intersects any
        # earlier leader's vote quorum). Between elections the max-over-
        # lanes VIEW may legitimately regress — a higher-term leader
        # stepping down (CheckQuorum) can leave a stale lower-term
        # zombie as the only visible leader — so ungated rounds only
        # advance the baseline, never judge it.
        has = leader_term >= 0
        won = has & (leader_changes > 0)
        bad = np.flatnonzero(won & (leader_term <= self._last_leader_term))
        if bad.size:
            g = int(bad[0])
            self._violate(
                "term_monotone", round_no,
                f"group {g} elected a leader at term "
                f"{int(leader_term[g])} <= previously observed leader "
                f"term {int(self._last_leader_term[g])} "
                f"(+{bad.size - 1} more)")
        np.maximum(self._last_leader_term,
                   np.where(has, leader_term, -1),
                   out=self._last_leader_term)

        frac = float(np.asarray(leaderless).sum()) / max(1, self._G)
        if frac > self.leaderless_max + 1e-9:
            self._violate(
                "leaderless_bound", round_no,
                f"leaderless fraction {frac:.3f} > bound "
                f"{self.leaderless_max:.3f}")

        lanes = np.asarray(leader_lane, np.int64)
        for g in self._watch:
            gi = int(g)
            t, lane = int(leader_term[gi]), int(lanes[gi])
            if t < 0 or lane < 0:
                continue
            seen = self._leaders[gi]
            prev = seen.get(t)
            if prev is not None and prev != lane:
                self._violate(
                    "leader_per_term", round_no,
                    f"group {gi} term {t}: leaders {prev} and {lane}")
            elif prev is None:
                if len(seen) >= self.TERMS_PER_GROUP:
                    del seen[min(seen)]
                seen[t] = lane

    def summary(self) -> dict:
        return {"mode": self.mode, "violations": self.violations,
                "watched_groups": [int(g) for g in self._watch],
                "leaderless_max": self.leaderless_max}


class DeviceTelemetryHub:
    """Folds fetched :class:`DeviceTelemetry` deltas into the
    ``device.*`` metric family, the flight ring, and the invariant
    monitor. One hub per engine (``RaftGroups.telemetry``)."""

    #: per-group cumulative series kept for shard attribution
    PER_GROUP = ("elections_started", "leader_changes", "commit_advance",
                 "leaderless", "applies_total")

    def __init__(self, num_groups: int, flight_capacity: int = 256,
                 mode: str | None = None) -> None:
        self.num_groups = num_groups
        self.registry = MetricsRegistry()
        self.flight = FlightRecorder(flight_capacity)
        self.monitor = InvariantMonitor(num_groups, self.registry,
                                        self.flight, mode=mode)
        self._rounds = 0
        self._occ_sum = 0.0
        self._occ_max = 0
        self.per_group = {name: np.zeros(num_groups, np.int64)
                          for name in self.PER_GROUP}
        # eager key creation: every hub has the same metric key set
        for name in _COUNTERS:
            # copycheck: ignore[metric-registry] names from _COUNTERS (each in the device.* catalog)
            self.registry.counter(name)
        for name in _GAUGES:
            # copycheck: ignore[metric-registry] names from _GAUGES (each in the device.* catalog)
            self.registry.gauge(name)
        for pool in POOL_NAMES:
            self.registry.counter("device.applies", pool=pool)
        for kind in INVARIANT_KINDS:
            self.registry.counter("device.invariant_violations", kind=kind)

    # -- ingestion ---------------------------------------------------------

    def ingest(self, tel: Any, round_no: int) -> None:
        """Fold ONE fetched round's telemetry deltas in. ``tel`` is a
        ``DeviceTelemetry`` of host (numpy) leaves — exactly what the
        drivers' output fetch hands ``RaftGroups._harvest``."""
        m = self.registry
        self._rounds += 1
        m.counter("device.rounds").inc()

        elections = np.asarray(tel.elections_started, np.int64)
        changes = np.asarray(tel.leader_changes, np.int64)
        leaderless = np.asarray(tel.leaderless, np.int64)
        advance = np.asarray(tel.commit_advance, np.int64)
        applies = np.asarray(tel.applies, np.int64)      # [G, pools]
        rejections = int(np.asarray(tel.submit_rejections,
                                    np.int64).sum())
        dropped = int(np.asarray(tel.events_dropped, np.int64).sum())

        n_elections = int(elections.sum())
        n_changes = int(changes.sum())
        n_leaderless = int(leaderless.sum())
        n_advance = int(advance.sum())
        m.counter("device.elections_started").inc(n_elections)
        m.counter("device.leader_changes").inc(n_changes)
        m.counter("device.term_bumps").inc(
            int(np.asarray(tel.term_bumps, np.int64).sum()))
        m.counter("device.leaderless_rounds").inc(n_leaderless)
        m.counter("device.commit_advance").inc(n_advance)
        m.counter("device.submit_rejections").inc(rejections)
        m.counter("device.vote_splits").inc(
            int(np.asarray(tel.vote_splits, np.int64).sum()))
        m.counter("device.events_drained").inc(
            int(np.asarray(tel.events_drained, np.int64).sum()))
        m.counter("device.events_dropped").inc(dropped)
        per_pool = applies.sum(axis=0)
        for k, pool in enumerate(POOL_NAMES):
            if per_pool[k]:
                m.counter("device.applies", pool=pool).inc(int(per_pool[k]))

        occ = int(np.asarray(tel.ring_occ_max).max(initial=0))
        self._occ_max = max(self._occ_max, occ)
        self._occ_sum += occ
        m.gauge("device.leaderless_groups").set(n_leaderless)
        m.gauge("device.term_max").set(
            int(np.asarray(tel.term_max).max(initial=0)))
        m.gauge("device.commit_total").set(
            int(np.asarray(tel.commit_max, np.int64).sum()))
        m.gauge("device.ring_occupancy_max").set(self._occ_max)
        m.gauge("device.ring_occupancy_mean").set(
            round(self._occ_sum / self._rounds, 4))

        self.per_group["elections_started"] += elections
        self.per_group["leader_changes"] += changes
        self.per_group["commit_advance"] += advance
        self.per_group["leaderless"] += leaderless
        self.per_group["applies_total"] += applies.sum(axis=1)

        if n_elections or n_changes or n_leaderless \
                or rejections or dropped:
            self.flight.record(
                "telemetry", round_no, elections=n_elections,
                leader_changes=n_changes, leaderless_groups=n_leaderless,
                commit_advance=n_advance, submit_rejections=rejections,
                events_dropped=dropped)

        self.monitor.observe(tel.commit_max, tel.leader_lane,
                             tel.leader_term, leaderless, changes,
                             round_no)

    def ingest_stacked(self, tels: Any, first_round: int) -> None:
        """Fold a fused program's stacked ``[W, G]`` telemetry (deep
        scan / harvested per-round stash) in round order."""
        w = int(np.asarray(tels.elections_started).shape[0])
        for i in range(w):
            self.ingest(
                type(tels)(*(np.asarray(leaf)[i] for leaf in tels)),
                first_round + i)

    # -- exposition --------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``device.*`` family as a snapshot dict (its
        ``_gauge_keys`` name the gauges)."""
        return self.registry.snapshot()

    def per_group_totals(self) -> dict:
        """Cumulative per-group arrays (copies) — the shard-attribution
        feed for per-shard roll-ups."""
        return {k: v.copy() for k, v in self.per_group.items()}

    def shard_snapshots(self, n_shards: int) -> list[dict]:
        """Split the per-group cumulative telemetry into ``n_shards``
        contiguous group blocks (how a 1D ``('groups',)`` mesh lays
        shards out) and return one snapshot per shard."""
        snaps = []
        for shard, idx in enumerate(
                np.array_split(np.arange(self.num_groups), n_shards)):
            snap = {f"device.{name}": int(arr[idx].sum())
                    for name, arr in self.per_group.items()}
            snap["shard"] = shard
            snap["groups"] = int(idx.size)
            snaps.append(snap)
        return snaps
