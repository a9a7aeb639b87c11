"""The port's replicated host-plane bench scenarios
(``copycat_tpu_torch/bench.py`` ``run_cluster``, ``run_sharded``,
``run_recovery``) against the reference's, on the CPU at the reference's
CI smoke settings.

Each scenario runs once a side for the file, both through the same knobs
(every one set here, none left to its default): the reference's in a
worker process started with the session's first port file
(``torch_reference.LONG_RUNS``), the port's in the tests' process with an
exactly-once hook (``check``) that records what the scenario read back.
The results must carry the reference's keys less ``vs_baseline``, every
``METRICS_SNAPSHOTS`` family the reference's keys, and equal fields where
they do not depend on timing; both sides must pass the gates the
reference's CI smokes assert. No timing is compared.
"""

import gc
import json
import os
import tempfile

import pytest

pytest.importorskip("torch")

from copycat_tpu_torch import bench  # noqa: E402
from copycat_tpu_torch.utils import platform, profiler, tracing  # noqa: E402

from torch_reference import (  # noqa: E402,F401
    LONG_RUNS,
    SUITE_AHEAD,
    release_jax_programs,
)

#: the reference's CI smoke settings (``.github/workflows/ci.yml``)
KNOBS = {
    "cluster": {"COPYCAT_BENCH_CLUSTER_STORAGE": "memory",
                "COPYCAT_BENCH_CLUSTER_MEMBERS": "3",
                "COPYCAT_BENCH_CLUSTER_CLIENTS": "4",
                "COPYCAT_BENCH_CLUSTER_OPS": "200",
                "COPYCAT_BENCH_CLUSTER_BURSTS": "2",
                "COPYCAT_BENCH_CLUSTER_DELAY_MS": "0.2",
                "COPYCAT_REPL_PIPELINE": "1"},
    "sharded": {"COPYCAT_BENCH_SHARDED_GROUPS": "2",
                "COPYCAT_BENCH_CLUSTER_MEMBERS": "3",
                "COPYCAT_BENCH_SHARDED_CLIENTS": "4",
                "COPYCAT_BENCH_SHARDED_OPS": "80",
                "COPYCAT_BENCH_SHARDED_BURSTS": "2",
                "COPYCAT_BENCH_SHARDED_KEYS": "1024",
                "COPYCAT_BENCH_SHARDED_ZIPF": "0.9",
                "COPYCAT_BENCH_SHARDED_DELAY_MS": "0.5",
                "COPYCAT_BENCH_SHARDED_TRACE": "1"},
    "recovery": {"COPYCAT_BENCH_RECOVERY_OPS": "1500",
                 "COPYCAT_BENCH_RECOVERY_SNAP_ENTRIES": "200",
                 "COPYCAT_BENCH_RECOVERY_STORAGE": "disk",
                 "COPYCAT_BENCH_RECOVERY_CLIENTS": "4"},
}
SCENARIOS = tuple(KNOBS)
DETERMINISTIC = {
    "cluster": ("metric", "unit", "repl_pipeline", "repl_window",
                "repl_depth", "delay_ms_per_leg", "clients", "storage_level",
                "fsync", "snapshots_enabled", "reps_n"),
    "sharded": ("metric", "unit", "groups", "groups_led", "routing_mix",
                "delay_ms_per_leg", "clients", "zipf_s", "keys",
                "repl_max_inflight", "reps_n"),
    "recovery": ("metric", "unit", "storage_level", "snapshot_entries",
                 "seeded_ops"),
}
ARTIFACT_KEYS = {"scenario", "meta", "metrics", "series", "profile"}


#: registry series created at their first event (a client's retry or
#: reroute, a member's election or leader change) or at the first tick of
#: the once-a-second series sampler (``sessions_expired_total``, read as
#: 0): whether one exists at the end of a run is timing
EVENT_SERIES = {"client_retries", "client_reroutes",
                "raft_elections_started", "raft_leader_transitions",
                "sessions_expired_total"}


def family_keys(snapshot: dict) -> set:
    """The series of a metrics family: its keys, and for a nested
    registry ``key/name`` for each series in it, without labels (a
    labelled series such as ``raft_elections_started{group=1}`` exists
    only once its event has happened, which is timing), less
    :data:`EVENT_SERIES`."""
    names = set()
    for k, v in snapshot.items():
        names.add(k)
        if isinstance(v, dict) and "count" not in v:
            names.update(f"{k}/{n.split('{')[0]}" for n in v)
    return {n for n in names if n.split("/")[-1] not in EVENT_SERIES}


def reference_scenario(scenario: str) -> dict:
    """The reference's ``run_<scenario>`` at the tests' knobs, set before
    its bench is imported; its temp directories go to a directory of
    their own, and the GC tuning and knobs it leaves behind are undone
    after. Returns its result, its metrics snapshots (as JSON) and
    whether its temp directories were all removed."""
    saved = gc.get_threshold()
    scratch = tempfile.mkdtemp(prefix="ref-bench-")
    with pytest.MonkeyPatch.context() as mp:
        for name, value in KNOBS[scenario].items():
            mp.setenv(name, value)
        mp.setattr(tempfile, "tempdir", scratch)
        from copycat_tpu import bench as ref
        ref.METRICS_SNAPSHOTS.clear()
        try:
            result = getattr(ref, f"run_{scenario}")()
            metrics = json.loads(json.dumps(ref.METRICS_SNAPSHOTS))
        finally:
            gc.unfreeze()
            gc.set_threshold(*saved)
    left = os.listdir(scratch)
    if not left:
        os.rmdir(scratch)
    return {"result": result, "metrics": metrics, "left": left}


@pytest.fixture(scope="module")
def reference():
    return {s: SUITE_AHEAD.get(f"bench_{s}", reference_scenario, s)
            for s in SCENARIOS}


_FILE = os.path.basename(__file__)
for _test in ("test_result_keys_are_the_references",
              "test_metrics_families_have_the_references_keys",
              "test_deterministic_fields_equal_the_references",
              "test_both_pass_the_ci_smoke_gate",
              "test_metrics_json_has_the_references_artifact_keys"):
    LONG_RUNS[f"{_FILE}::{_test}"] = [
        (f"bench_{s}", reference_scenario, (s,)) for s in SCENARIOS]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's three scenarios at the same knobs, with what each
    ``check`` hook saw, the metrics snapshots and the temp directories
    they left."""
    out = {}
    for scenario in SCENARIOS:
        scratch = tmp_path_factory.mktemp(f"port-{scenario}")
        seen = []

        async def check(run):
            if scenario == "recovery":
                seen.append((run.snapshots, run.per_client,
                             run.leader.commit_index,
                             run.joiner.last_applied,
                             dict(run.joiner.state_machine.data),
                             dict(run.leader.state_machine.data)))
            else:
                seen.append((run.values, [dict(s.state_machine.data)
                                          for s in run.servers]
                             if scenario == "cluster" else run.expected))

        with pytest.MonkeyPatch.context() as mp:
            for name, value in KNOBS[scenario].items():
                mp.setenv(name, value)
            mp.setattr(tempfile, "tempdir", str(scratch))
            bench.METRICS_SNAPSHOTS.clear()
            result = getattr(bench, f"run_{scenario}")(check=check)
        out[scenario] = {"result": result, "seen": seen,
                         "metrics": json.loads(json.dumps(
                             bench.METRICS_SNAPSHOTS)),
                         "left": os.listdir(scratch)}
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_result_keys_are_the_references(scenario, reference, port):
    want = set(reference[scenario]["result"]) - {"vs_baseline"}
    assert set(port[scenario]["result"]) == want
    assert set(port[scenario]["metrics"]) == set(
        reference[scenario]["metrics"])


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_metrics_families_have_the_references_keys(scenario, reference,
                                                   port):
    want, got = reference[scenario]["metrics"], port[scenario]["metrics"]
    for family in want:
        assert family_keys(got[family]) == family_keys(want[family]), family


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_deterministic_fields_equal_the_references(scenario, reference,
                                                   port):
    got, want = port[scenario]["result"], reference[scenario]["result"]
    for key in DETERMINISTIC[scenario]:
        assert got[key] == want[key], key
    assert got["value"] > 0
    if scenario == "sharded":
        for key in ("members", "phases", "incomplete"):
            assert got["trace"][key] == want["trace"][key], key
        assert set(got["per_group_commit"]) == set(want["per_group_commit"])
    if scenario in ("cluster", "recovery"):
        assert set(got["snap"]) == set(want["snap"])
    if scenario == "recovery":
        for key in ("installs_sent", "snap.install_failures"):
            assert got["snap"].get(key, got.get(key)) == \
                want["snap"].get(key, want.get(key)), key


def _ci_gate(scenario: str, snap: dict, metrics: dict) -> None:
    """What the reference's CI smoke asserts on the scenario's artifact."""
    if scenario == "cluster":
        assert snap["unit"] == "ops/sec" and snap["value"] > 0
        assert snap["repl_pipeline"] is True
        raft = metrics["server"]["raft"]
        assert raft["repl.windows_sent"] > 0
        assert raft["repl.entries_sent"] > 0
        assert raft["repl.window_entries"]["count"] > 0
        assert raft["repl.ack_ms"]["count"] > 0
        for key in ("repl.rewinds", "repl.stalls",
                    "repl.backpressure_waits", "repl.windows_inflight",
                    "repl.entries_inflight"):
            assert key in raft, key
        assert 0 <= raft["repl.windows_inflight"] <= 16
    elif scenario == "sharded":
        assert snap["unit"] == "ops/sec" and snap["value"] > 0
        assert snap["groups"] == 2
        led = snap["groups_led"]
        assert sum(led.values()) == 2 and len(led) == 3, led
        commits = snap["per_group_commit"]
        assert set(commits) == {"0", "1"}
        assert all(v > 0 for v in commits.values())
        mix = snap["routing_mix"]
        assert set(mix) == {"0", "1"}
        assert sum(mix.values()) >= 4 * 80 * 2, mix
        raft = metrics["server"]["raft"]
        assert raft["shard.groups"] == 2
        assert "raft_commit_index{group=0}" in raft
        assert "raft_commit_index{group=1}" in raft
        tr = snap["trace"]
        assert len(tr["members"]) >= 2
        assert len(tr["phases"]) >= 6
        assert tr["incomplete"] is False
        assert tr["e2e_ms"] > 0
        assert abs(tr["critical_path_ms"] - tr["e2e_ms"]) \
            <= 0.1 * tr["e2e_ms"], tr
        for phase in ("group.append", "quorum.wait", "apply", "respond",
                      "client.submit"):
            assert phase in tr["phases"], phase
        assert "critical path" in tr["waterfall"]
        assert raft["latency.append_ms{group=0}"]["count"] > 0
        assert raft["latency.quorum_ms{group=0}"]["count"] > 0
        assert raft["latency.apply_ms{group=0}"]["count"] > 0
        ingress = metrics["ingress"]["raft"]
        assert ingress["latency.ingress_queue_ms"]["count"] >= 2
        assert ingress["latency.proxy_hop_ms"]["count"] >= 1
    else:
        assert snap["unit"] == "x" and snap["value"] > 0
        assert snap["installs_sent"] >= 1
        fam = snap["snap"]
        assert fam["snap.snapshots_taken"] > 0
        assert fam["snap.snapshot_bytes"] > 0
        assert fam["snap.truncated_entries"] > 0
        assert fam["snap.install_chunks_sent"] >= 1
        assert fam["snap.install_failures"] == 0
        joiner = metrics["joiner"]["raft"]
        assert joiner["snap.installs_received"] >= 1
        assert joiner["snap.restores"] >= 1


@pytest.mark.parametrize("side", ["reference", "port"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_both_pass_the_ci_smoke_gate(scenario, side, reference, port):
    run = (reference if side == "reference" else port)[scenario]
    _ci_gate(scenario, run["result"], run["metrics"])


@pytest.mark.parametrize("side", ["reference", "port"])
def test_temp_directories_are_removed(side, reference, port):
    run = (reference if side == "reference" else port)["recovery"]
    assert run["left"] == []


def test_cluster_every_counter_reads_back_every_write(port):
    """Each client's key took every one of its increments once, read back
    through the public API, and a quorum of the members holds it."""
    (values, datas), = port["cluster"]["seen"]
    total = 2 * 200
    assert values == {f"k{i}": total for i in range(4)}
    assert sum(all(d.get(f"k{i}") == total for i in range(4))
               for d in datas) >= 2


def test_sharded_committed_writes_are_every_write_once(port, reference):
    """The keys the scenario read back equal their committed increments;
    those total the 4 × 80 × 2 timed writes and the traced wave's one a
    group, which is also the routing mix the reference counted."""
    (values, expected), = port["sharded"]["seen"]
    assert values and all(values[k] == expected[k] for k in values)
    assert sum(expected.values()) == 4 * 80 * 2 + 2
    assert sum(reference["sharded"]["result"]["routing_mix"].values()) \
        == sum(port["sharded"]["result"]["routing_mix"].values())


def test_recovery_joiner_catches_up_in_both_passes(port, reference):
    passes = port["recovery"]["seen"]
    assert [p[0] for p in passes] == [True, False]
    for _, per_client, commit, applied, joined, led in passes:
        assert per_client == 1500 // 4
        assert applied >= commit >= 1500
        assert {k: joined[k] for k in led} == led
        assert led == {f"k{i}": per_client for i in range(4)}
    got = port["recovery"]["result"]
    assert got["commit_index"] == passes[0][2]
    assert got["leader_first_index_snapshot"] > 1
    assert reference["recovery"]["result"]["commit_index"] >= 1500


def test_scenarios_leave_the_process_as_found(port):
    assert gc.get_threshold() != (100_000, 50, 100)
    assert gc.get_freeze_count() == 0
    assert not tracing.TRACER.enabled
    for name in ("COPYCAT_SNAPSHOTS", "COPYCAT_SNAPSHOT_ENTRIES",
                 "COPYCAT_SNAPSHOT_RETAIN"):
        assert name not in os.environ
    assert profiler.PROFILER is None


def test_metrics_json_has_the_references_artifact_keys(tmp_path, reference,
                                                       monkeypatch, capsys):
    """``main`` runs ``cluster`` on the CPU at ``--storage memory`` and
    writes the reference's result keys with the artifact's own."""
    for name, value in KNOBS["cluster"].items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("COPYCAT_BENCH_CLUSTER_STORAGE", "disk")
    path = tmp_path / "cluster.json"
    bench.main(["--scenario", "cluster", "--device", "cpu", "--storage",
                "memory", "--metrics-json", str(path)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    artifact = json.loads(path.read_text())
    want = set(reference["cluster"]["result"]) - {"vs_baseline"}
    assert set(result) == want
    assert set(artifact) == want | ARTIFACT_KEYS
    assert artifact["scenario"] == "cluster"
    assert artifact["storage_level"] == "memory"
    assert set(artifact["metrics"]) == {"server", "client"}
    assert artifact["meta"]["host"]["device"] == "cpu"
    assert profiler.PROFILER is None


def test_main_exits_2_without_a_card_and_never_runs(monkeypatch):
    monkeypatch.setattr(platform, "_PROBE_CODE", "raise SystemExit(1)")
    monkeypatch.setenv("COPYCAT_DEVICE_PROBES", "1")
    ran = []
    for name in ("run_cluster", "run_sharded", "run_recovery",
                 "run_fanout"):
        monkeypatch.setattr(bench, name, lambda *a, **kw: ran.append(kw))
    for scenario in (*SCENARIOS, "fanout"):
        with pytest.raises(SystemExit) as exc:
            bench.main(["--scenario", scenario])
        assert exc.value.code == 2
    assert ran == []
