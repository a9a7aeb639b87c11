"""Central registry for every ``COPYCAT_*`` environment knob.

The port's copy of the reference registry
(``copycat_tpu/utils/knobs.py``), cut to the knobs the port's modules
read: every env knob the server, its host planes and the device plane
read is declared HERE, once, with a typed default and a one-line doc —
and read through the typed getters below. A knob no module reads is not
declared (``tests/test_torch_package.py`` holds that).
``python -m copycat_tpu_torch.utils.knobs`` prints the tables.

Getters read ``os.environ`` live (no caching): tests and benches
monkeypatch knobs mid-process and expect the next server/client built
to see the change.

Call sites whose default is computed (e.g. ``COPYCAT_SNAPSHOT_RETAIN``
defaults to ``max(64, repl max-inflight)``) pass ``default=`` at the
call; the registry carries a ``default_doc`` string so the tables still
document the rule. Boolean knobs normalize: ``0 / false / off / no /
none`` and the empty string are off, anything else set is on.

This module is import-light on purpose (stdlib ``os`` only).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

_FALSY = ("", "0", "false", "off", "no", "none")


@dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "int" | "float" | "str" | "bool" | "raw"
    default: Any  # typed default; None = computed at the call site / unset
    doc: str  # one-line effect (the README table cell)
    section: str
    default_doc: str | None = None  # README text for computed defaults
    choices: tuple[str, ...] | None = None

    def default_text(self) -> str:
        if self.default_doc is not None:
            return self.default_doc
        if self.default is None:
            return "unset"
        if self.kind == "bool":
            return "1" if self.default else "0"
        return str(self.default) or "(empty)"


REGISTRY: dict[str, Knob] = {}

# README section order; every knob names one of these.
SECTIONS = (
    ("server", "Server planes (vector + read pump)"),
    ("replication", "Replication pipeline"),
    ("durability", "Snapshots & durability"),
    ("observability", "Observability & invariants"),
    ("client", "Client"),
    ("verdict", "Linearizability verdict runner"),
    ("platform", "Device probe"),
    ("deploy", "Deployment plane"),
    ("bench", "Bench scenarios"),
)
_SECTION_KEYS = tuple(key for key, _ in SECTIONS)


def _knob(name: str, kind: str, default: Any, doc: str, *, section: str,
          default_doc: str | None = None,
          choices: tuple[str, ...] | None = None) -> None:
    assert name not in REGISTRY, f"duplicate knob {name}"
    assert section in _SECTION_KEYS, f"unknown section {section!r} ({name})"
    REGISTRY[name] = Knob(name, kind, default, doc, section, default_doc,
                          choices)


# --- server planes ---------------------------------------------------------
_knob("COPYCAT_GROUPS", "int", 1,
      "Raft groups per server (keyspace shards, docs/SHARDING.md); >1 "
      "spreads leadership and routes resources by hash", section="server")
_knob("COPYCAT_MULTI_GROUP", "bool", True,
      "`0` forces the single-group plane regardless of `COPYCAT_GROUPS` "
      "(the sharding A/B)", section="server")
_knob("COPYCAT_SERVER_VECTOR_PUMP", "bool", True,
      "`0` restores the per-op command apply lane (the spi A/B)",
      section="server")
_knob("COPYCAT_SERVER_READ_PUMP", "bool", True,
      "`0` restores the per-op read lane (the readmix A/B)",
      section="server")
_knob("COPYCAT_PARALLEL_APPLY", "bool", True,
      "`0` restores the contiguous-run vector classifier — runs no "
      "longer span ineligible entries on disjoint keys (the "
      "dependency-classified parallel-apply A/B, docs/SHARDING.md)",
      section="server")
_knob("COPYCAT_APPLY_FUSE", "bool", True,
      "`0` restores one engine dispatch per group per run — staged "
      "vector runs no longer fuse across groups into one device round "
      "per server turn (the cross-group fusion A/B)", section="server")

# --- replication -----------------------------------------------------------
_knob("COPYCAT_REPL_PIPELINE", "bool", True,
      "`0` restores stop-and-wait replication (the A/B lane)",
      section="replication")
_knob("COPYCAT_REPL_WINDOW", "int", 64,
      "append window size: pipeline initial/ceiling AND the stop-and-wait "
      "window", section="replication")
_knob("COPYCAT_REPL_DEPTH", "int", 8,
      "max append windows in flight per peer", section="replication")
_knob("COPYCAT_REPL_MAX_INFLIGHT", "int", None, default_doc="window×depth",
      doc="max entries in flight per peer (slow-follower memory bound)",
      section="replication")

# --- durability ------------------------------------------------------------
_knob("COPYCAT_SNAPSHOTS", "bool", True,
      "`0` restores replay-only recovery bit-identically (the A/B lane)",
      section="durability")
_knob("COPYCAT_SNAPSHOT_ENTRIES", "int", 1024,
      "applied entries between snapshots (bounds recovery replay)",
      section="durability")
_knob("COPYCAT_SNAPSHOT_RETAIN", "int", None,
      default_doc="max(64, repl max-inflight)",
      doc="entries kept behind the snapshot so lagging-but-healthy "
          "followers avoid an install", section="durability")
_knob("COPYCAT_SNAP_CHUNK", "int", 262144,
      "install-stream chunk bytes", section="durability")

# --- observability ---------------------------------------------------------
_knob("COPYCAT_TRACE", "bool", False,
      "per-request tracing (`utils/tracing.py`); zero-cost when off",
      section="observability")
_knob("COPYCAT_TRACE_CAPACITY", "int", 512,
      "traces held in the per-process ring before oldest-first eviction "
      "(evicted ids are tombstoned, never resurrected)",
      section="observability")
_knob("COPYCAT_TRACE_SLOW_MS", "float", 100.0,
      "traced requests slower than this land a `slow_trace` exemplar in "
      "the device-plane flight recorder", section="observability")
_knob("COPYCAT_TELEMETRY", "bool", False,
      "compile the device telemetry block into engines whose `Config` "
      "left it off", section="observability")
_knob("COPYCAT_INVARIANTS", "str", None, default_doc="unset (= observe)",
      choices=("observe", "strict", "off"),
      doc="invariant monitors, device + server: `observe` counts "
          "violations, `strict` raises, `off` skips checks; setting any "
          "mode also enables device telemetry", section="observability")
_knob("COPYCAT_INVARIANT_LEADERLESS_MAX", "float", 1.0,
      "max leaderless-group fraction per fetched round before the "
      "monitor trips", section="observability")
_knob("COPYCAT_HEALTH", "bool", True,
      "`0` disables the health plane (online anomaly detectors, the "
      "`/health` verdict, the durable black-box spill) — the A/B knob "
      "restoring the pre-health plane bit-identically",
      section="observability")
_knob("COPYCAT_HEALTH_INTERVAL_S", "float", 1.0,
      "detector cadence: seconds between health-monitor samples",
      section="observability")
_knob("COPYCAT_HEALTH_WINDOW", "int", 30,
      "samples retained per evidence series (the detector lookback "
      "window)", section="observability")
_knob("COPYCAT_HEALTH_CHURN_WARN", "int", 3,
      "elections + leader transitions per window that grade "
      "leader-churn `warn` (2x grades `critical`)",
      section="observability")
_knob("COPYCAT_HEALTH_STALL_S", "float", 2.0,
      "seconds the commit index may sit frozen behind the log tail "
      "before commit-stall grades `warn` (growing lag grades "
      "`critical`)", section="observability")
_knob("COPYCAT_HEALTH_FSYNC_FACTOR", "float", 4.0,
      "fsync latency vs the pre-window EWMA baseline that grades "
      "fsync-spike `warn` (3x the factor grades `critical`)",
      section="observability")
_knob("COPYCAT_HEALTH_QUEUE_WARN", "int", 64,
      "ingress/event backlog depth that grades ingress-backlog `warn` "
      "when still growing (4x grades `critical`)",
      section="observability")
_knob("COPYCAT_HEALTH_EXPIRY_WARN", "int", 3,
      "session expiries per window that grade expiry-storm `warn` "
      "(3x grades `critical`)", section="observability")
_knob("COPYCAT_BLACKBOX_BYTES", "int", 262144,
      "black-box spill bytes per generation (two generations kept; "
      "the crash-surviving flight-recorder ring on disk)",
      section="observability")
_knob("COPYCAT_SERIES", "bool", True,
      "`0` disables the retrospective-telemetry plane (the on-member "
      "time-series ring, the `/series` routes, the `series.*`/`slo.*` "
      "families) — the A/B knob restoring the pre-series plane "
      "bit-identically; on members the ring rides the health-monitor "
      "cadence, so `COPYCAT_HEALTH=0` also removes it",
      section="observability")
_knob("COPYCAT_SERIES_INTERVAL_S", "float", 1.0,
      "seconds between retained metric samples (`utils/timeseries.py`; "
      "sampling piggybacks the host cadence, so the effective interval "
      "is at least the health/watch cadence)", section="observability")
_knob("COPYCAT_SERIES_WINDOW", "int", 300,
      "samples retained per process before oldest-first eviction — "
      "the `/series` lookback is `interval x window` seconds",
      section="observability")
_knob("COPYCAT_SLO_P99_MS", "float", None,
      default_doc="unset (= no latency objective)",
      doc="commit-latency p99 objective in ms: the `slo_burn` detector "
          "grades intervals whose sampled `latency.commit_ms` p99 "
          "exceeds it (needs tracing on — the histogram only advances "
          "for traced requests)", section="observability")
_knob("COPYCAT_SLO_AVAIL", "float", None,
      default_doc="unset (= no availability objective)",
      doc="availability objective as a fraction (e.g. `0.999`): an "
          "interval counts unavailable when a group's commit sat "
          "frozen behind its log tail; the `slo_burn` detector grades "
          "the error-budget burn rate over the retained window",
      section="observability")
_knob("COPYCAT_PROFILE", "bool", True,
      "`0` disables the continuous profiling plane (the process-wide "
      "wall-stack sampler, event-loop hold attribution, the "
      "`/profile` routes, the `profile.*` family and the `loop_stall` "
      "detector) — the A/B knob restoring the pre-profiler process "
      "bit-identically: no sampler thread, no keys, no routes",
      section="observability")
_knob("COPYCAT_PROFILE_HZ", "float", 19.0,
      "wall-stack samples per second (`utils/profiler.py`; "
      "deliberately off-cadence from the 1 Hz health/series timers so "
      "samples don't alias the periodic work they profile)",
      section="observability")
_knob("COPYCAT_PROFILE_HOLD_MS", "float", 100.0,
      "event-loop hold threshold in ms: a callback/task step holding "
      "the loop at least this long records a hold (the `loop_stall` "
      "evidence, a flight-recorder stall note, and the "
      "`profile.hold_*` series); 5x grades `critical`",
      section="observability")
_knob("COPYCAT_PROFILE_WINDOW_S", "int", 120,
      "seconds of folded-stack aggregate retained in the profile ring "
      "before oldest-first eviction — the `/profile` lookback "
      "(`?since=` windows within it)", section="observability")

# --- client ----------------------------------------------------------------
_knob("COPYCAT_CLIENT_FOLLOWER_READS", "bool", True,
      "`0` pins sub-linearizable reads back to the leader connection",
      section="client")
_knob("COPYCAT_EDGE_READS", "bool", True,
      "`0` removes the edge read tier (client-local CRDT replicas "
      "serving CAUSAL/SEQUENTIAL reads; docs/EDGE_READS.md) — every "
      "read pays the server round-trip, bit-identically to the "
      "pre-edge plane", section="client")
_knob("COPYCAT_EDGE_MAX_RESOURCES", "int", 1024,
      "client-side edge replica cap (LRU eviction back to server "
      "reads; evicted instances unsubscribe via the next keep-alive)",
      section="client")
_knob("COPYCAT_EDGE_TTL_S", "float", 5.0,
      "edge staleness gate: a replica entry older than this (no delta, "
      "no re-seed) stops serving locally and the next read re-seeds "
      "from the server", section="client")
_knob("COPYCAT_EDGE_FLUSH_MS", "float", 10.0,
      "server-side delta-publication coalescing interval: dirty "
      "resources batch for this long before one push per subscriber "
      "(state-based merge makes coalescing free); `0` flushes every "
      "event-loop turn", section="client")

# --- verdict ---------------------------------------------------------------
_knob("COPYCAT_VERDICT_GROUPS", "int", 10000,
      "groups in the verdict engine", section="verdict")
_knob("COPYCAT_VERDICT_SAMPLE", "int", 99,
      "groups whose histories are recorded and checked", section="verdict")
_knob("COPYCAT_VERDICT_ROUNDS", "int", 1000,
      "engine rounds driven under nemesis", section="verdict")
_knob("COPYCAT_VERDICT_SEED", "int", 42, "workload/nemesis RNG seed",
      section="verdict")
_knob("COPYCAT_VERDICT_OP_EVERY", "int", 1,
      "rounds between recorded ops per sampled group", section="verdict")
_knob("COPYCAT_VERDICT_INFLIGHT", "int", 4,
      "bounded client concurrency per sampled group", section="verdict")
_knob("COPYCAT_VERDICT_CHURN", "bool", True,
      "`0` disables membership churn during recording", section="verdict")
_knob("COPYCAT_VERDICT_DEEP", "bool", True,
      "`0` skips the deep-plane (monotone-tag pipelined) block",
      section="verdict")
_knob("COPYCAT_VERDICT_DEEP_GROUPS", "int", 2000,
      "groups in the deep-plane block", section="verdict")
_knob("COPYCAT_VERDICT_DEEP_SAMPLE", "int", 48,
      "sampled groups in the deep-plane block", section="verdict")
_knob("COPYCAT_VERDICT_DEEP_EPOCHS", "int", 40,
      "fault epochs in the deep-plane block", section="verdict")

# --- platform --------------------------------------------------------------
_knob("COPYCAT_DEVICE_TIMEOUT", "float", 120.0,
      "seconds per device probe (`utils/platform.py`) before declaring "
      "the card unreachable", section="platform")
_knob("COPYCAT_DEVICE_PROBES", "int", 5,
      "device probe attempts before exiting 2", section="platform")
_knob("COPYCAT_BENCH_DEVICE_TIMEOUT", "float", 120.0,
      "probe timeout for bench runs (a failed probe exits 2; the port "
      "never falls back to the CPU)", section="platform")
_knob("COPYCAT_ENTRY_DEVICE_TIMEOUT", "float", 120.0,
      "probe timeout for `python -m copycat_tpu_torch.graft_entry` (a "
      "failed probe exits 2)", section="platform")

# --- deployment plane ------------------------------------------------------
_knob("COPYCAT_INGRESS_TIER", "bool", True,
      "`0` removes the standalone ingress/proxy tier: members refuse "
      "ingress-kind proxy traffic (single-group servers register no "
      "ProxyRequest handler), topologies/benches deploy no ingress "
      "processes — the in-server ingress path bit-identically "
      "(docs/DEPLOYMENT.md)", section="deploy")
_knob("COPYCAT_DEPLOY_HEALTH_INTERVAL_S", "float", 1.0,
      "supervisor `/healthz` poll cadence per child process",
      section="deploy")
_knob("COPYCAT_DEPLOY_RESTART_BACKOFF_S", "float", 0.5,
      "initial restart backoff after a child crash (doubles per "
      "consecutive crash)", section="deploy")
_knob("COPYCAT_DEPLOY_RESTART_MAX_S", "float", 8.0,
      "restart backoff ceiling", section="deploy")
_knob("COPYCAT_DEPLOY_GRACE_S", "float", 5.0,
      "seconds between SIGTERM and SIGKILL at teardown",
      section="deploy")

# --- bench scenarios -------------------------------------------------------
_knob("COPYCAT_BENCH_COMPARTMENT_MEMBERS", "int", 3,
      "Raft member processes in the compartment scenario",
      section="bench")
_knob("COPYCAT_BENCH_COMPARTMENT_TIERS", "str", "1,2,4",
      "comma-separated ingress-tier widths the compartment scenario "
      "sweeps (processes per width)", section="bench")
_knob("COPYCAT_BENCH_COMPARTMENT_GROUPS", "int", 4,
      "Raft groups in the compartment scenario", section="bench")
_knob("COPYCAT_BENCH_COMPARTMENT_CLIENTS", "int", 8,
      "concurrent TCP clients in the compartment scenario",
      section="bench")
_knob("COPYCAT_BENCH_COMPARTMENT_OPS", "int", 600,
      "commands per client per burst in the compartment scenario",
      section="bench")
_knob("COPYCAT_BENCH_COMPARTMENT_BURSTS", "int", 3,
      "measured bursts (best-of) per tier width", section="bench")
_knob("COPYCAT_BENCH_COMPARTMENT_KEYS", "int", 1_000_000,
      "zipfian keyspace size in the compartment scenario (the "
      "million-key shape)", section="bench")
_knob("COPYCAT_BENCH_COMPARTMENT_ZIPF", "float", 0.9,
      "zipf skew exponent for the compartment scenario's key draw",
      section="bench")
_knob("COPYCAT_BENCH_COMPARTMENT_STORAGE", "str", "disk",
      choices=("memory", "mapped", "disk"),
      doc="member log storage level in the compartment scenario (real "
          "fsync by default)", section="bench")
_knob("COPYCAT_BENCH_COMPARTMENT_NEMESIS", "bool", True,
      "`0` skips the process-level nemesis phase (kill -9 a member + "
      "an ingress proxy mid-load, zero lost acknowledged writes)",
      section="bench")
_knob("COPYCAT_BENCH_CLUSTER_STORAGE", "str", "memory",
      choices=("memory", "mapped", "disk"),
      doc="log storage level for the cluster scenario (the durability "
          "A/B; the bench's `--storage` sets it)", section="bench")
_knob("COPYCAT_BENCH_CLUSTER_MEMBERS", "int", 3,
      "cluster scenario member count", section="bench")
_knob("COPYCAT_BENCH_CLUSTER_CLIENTS", "int", 4,
      "concurrent clients in the cluster scenario", section="bench")
_knob("COPYCAT_BENCH_CLUSTER_OPS", "int", 1500,
      "ops per client per burst in the cluster scenario", section="bench")
_knob("COPYCAT_BENCH_CLUSTER_BURSTS", "int", 5,
      "bursts (best-of) in the cluster scenario", section="bench")
_knob("COPYCAT_BENCH_CLUSTER_DELAY_MS", "float", 2.0,
      "nemesis wire latency per leg, ms", section="bench")
_knob("COPYCAT_BENCH_SHARDED_GROUPS", "int", 4,
      "Raft groups in the sharded scenario (1 = the single-group A/B "
      "baseline; the bench's `--groups` sets it)", section="bench")
_knob("COPYCAT_BENCH_SHARDED_CLIENTS", "int", 12,
      "concurrent public-API clients in the sharded scenario",
      section="bench")
_knob("COPYCAT_BENCH_SHARDED_OPS", "int", 1200,
      "commands per client per burst in the sharded scenario",
      section="bench")
_knob("COPYCAT_BENCH_SHARDED_BURSTS", "int", 5,
      "measured bursts (best-of) in the sharded scenario",
      section="bench")
_knob("COPYCAT_BENCH_SHARDED_KEYS", "int", 1024,
      "zipfian keyspace size in the sharded scenario", section="bench")
_knob("COPYCAT_BENCH_SHARDED_ZIPF", "float", 0.9,
      "zipf skew exponent for the sharded scenario's key draw",
      section="bench")
_knob("COPYCAT_BENCH_SHARDED_TRACE", "bool", False,
      "`1` drives one traced client wave after the timed bursts and "
      "embeds the assembled cross-member waterfall + `latency.*` phase "
      "histograms in the `--metrics-json` artifact", section="bench")
_knob("COPYCAT_BENCH_SHARDED_DELAY_MS", "float", 100.0,
      "nemesis wire latency per leg, ms (cross-region shape: the "
      "bounded replication window caps a single ordered log at "
      "max-inflight/RTT — the cap sharding multiplies)",
      section="bench")
_knob("COPYCAT_BENCH_RECOVERY_OPS", "int", 6000,
      "committed entries before the recovery scenario's catch-up",
      section="bench")
_knob("COPYCAT_BENCH_RECOVERY_STORAGE", "str", "disk",
      choices=("memory", "mapped", "disk"),
      doc="log storage level for the recovery scenario (the bench's "
          "`--storage` sets it)", section="bench")
_knob("COPYCAT_BENCH_RECOVERY_SNAP_ENTRIES", "int", 512,
      "snapshot cadence the recovery scenario pins", section="bench")
_knob("COPYCAT_BENCH_RECOVERY_CLIENTS", "int", 4,
      "concurrent clients in the recovery scenario", section="bench")
_knob("COPYCAT_BENCH_FANOUT_READERS", "str", "8,32,128",
      "comma-separated reader-session counts the fanout scenario "
      "sweeps", section="bench")
_knob("COPYCAT_BENCH_FANOUT_WRITERS", "int", 2,
      "writer sessions in the fanout scenario", section="bench")
_knob("COPYCAT_BENCH_FANOUT_KEYS", "int", 16,
      "counter resources the fanout scenario reads/writes",
      section="bench")
_knob("COPYCAT_BENCH_FANOUT_READS", "int", 50,
      "reads per reader session per burst in the fanout scenario",
      section="bench")
_knob("COPYCAT_BENCH_FANOUT_BURSTS", "int", 3,
      "measured bursts (best-of) per reader count", section="bench")
_knob("COPYCAT_BENCH_FANOUT_ZIPF", "float", 0.9,
      "zipf skew exponent for the fanout scenario's key draw",
      section="bench")


# --- typed getters ---------------------------------------------------------


def _lookup(name: str) -> Knob:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name} is not a registered knob — declare it in "
            f"copycat_tpu_torch/utils/knobs.py") from None


def get_raw(name: str) -> str | None:
    """The raw env value, or ``None`` when unset. For tri-state knobs
    where *set at all* is meaningful (``COPYCAT_INVARIANTS``)."""
    _lookup(name)
    return os.environ.get(name)


def get_str(name: str, default: str | None = None) -> str:
    knob = _lookup(name)
    value = os.environ.get(name)
    if value is None:
        value = default if default is not None else knob.default
    if value is None:
        raise ValueError(f"{name} has no registered default; pass default=")
    return value


def get_int(name: str, default: int | None = None) -> int:
    knob = _lookup(name)
    value = os.environ.get(name)
    if value is not None:
        return int(value)
    if default is not None:
        return default
    if knob.default is None:
        raise ValueError(f"{name} has no registered default; pass default=")
    return int(knob.default)


def get_float(name: str, default: float | None = None) -> float:
    knob = _lookup(name)
    value = os.environ.get(name)
    if value is not None:
        return float(value)
    if default is not None:
        return default
    if knob.default is None:
        raise ValueError(f"{name} has no registered default; pass default=")
    return float(knob.default)


def get_bool(name: str, default: bool | None = None) -> bool:
    knob = _lookup(name)
    value = os.environ.get(name)
    if value is None:
        if default is not None:
            return default
        if knob.default is None:
            raise ValueError(
                f"{name} has no registered default; pass default=")
        return bool(knob.default)
    return value.strip().lower() not in _FALSY


def overrides() -> dict[str, str]:
    """Every registered knob explicitly set in the environment, with its
    raw value — the knob snapshot ``bench.py --metrics-json`` embeds so
    artifacts from different runs are comparable (an artifact whose knobs
    differ is a different experiment, not a regression)."""
    return {name: os.environ[name] for name in sorted(REGISTRY)
            if name in os.environ}


# --- tables -----------------------------------------------------

def render_markdown() -> str:
    """One markdown table per section, straight from the registry."""
    lines: list[str] = []
    for key, title in SECTIONS:
        knobs = [k for k in REGISTRY.values() if k.section == key]
        if not knobs:
            continue
        lines.append(f"### {title}")
        lines.append("")
        lines.append("| knob | default | effect |")
        lines.append("|---|---|---|")
        for k in knobs:  # registration order == doc order
            doc = k.doc
            if k.choices:
                doc += " (" + "/".join(f"`{c}`" for c in k.choices) + ")"
            lines.append(f"| `{k.name}` | `{k.default_text()}` | {doc} |")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def main() -> None:
    print(render_markdown(), end="")


if __name__ == "__main__":
    main()
