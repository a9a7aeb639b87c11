"""The port's perf-regression gate (``copycat_tpu_torch/testing/
bench_gate.py``): the reference's cases (``tests/test_bench_gate.py``) on
the port's module, goldens under ``tmp_path``; ``--golden`` required in
place of the reference's committed window; and the two gates side by
side on the same artifacts and goldens."""

import json

import pytest

from copycat_tpu.testing import bench_gate as ref_gate
from copycat_tpu_torch.testing import bench_gate


def _artifact(scenario="spi", value=10000.0, unit="ops/sec", **meta):
    return {"scenario": scenario, "value": value, "unit": unit,
            "meta": meta or {"git_sha": "abc", "host": {"cpus": 2}}}


def _golden(value=10000.0, tolerance=0.25, scenario="spi",
            unit="ops/sec"):
    return {"tolerance": tolerance,
            "scenarios": {scenario: {"value": value, "unit": unit,
                                     "recorded": {}}}}


def test_gate_passes_inside_the_window():
    ok, line = bench_gate.gate_artifact(_artifact(value=8000), _golden())
    assert ok and "ok 8,000.0" in line
    ok, _ = bench_gate.gate_artifact(_artifact(value=7500.0), _golden())
    assert ok  # exactly on the floor passes


def test_gate_fails_below_the_floor():
    ok, line = bench_gate.gate_artifact(_artifact(value=7000), _golden())
    assert not ok
    assert "REGRESSION" in line and "floor 7,500.0" in line


def test_gate_flags_stale_baseline_above_the_window():
    ok, line = bench_gate.gate_artifact(_artifact(value=20000), _golden())
    assert ok  # a win never fails the gate...
    assert "stale" in line  # ...but the window should be refreshed


def test_gate_missing_baseline_and_unit_change():
    ok, line = bench_gate.gate_artifact(
        _artifact(scenario="novel"), _golden())
    assert not ok and "--update-golden" in line
    ok, line = bench_gate.gate_artifact(
        _artifact(unit="reads/sec"), _golden())
    assert not ok and "unit changed" in line


def test_gate_degraded_mismatch_skips_the_floor():
    """A ``"degraded": true`` artifact graded against a non-degraded
    window is a different experiment: marked degraded_mismatch, the floor
    SKIPPED — even a value far below it is no regression."""
    art = _artifact(value=500.0)  # 20x below the 7,500 floor
    art["degraded"] = True
    ok, line = bench_gate.gate_artifact(art, _golden())
    assert ok, line
    assert "degraded_mismatch" in line and "skipped" in line
    assert "REGRESSION" not in line
    # ...and the mirror: a healthy run against a degraded window
    golden = _golden(value=500.0)
    golden["scenarios"]["spi"]["degraded"] = True
    ok, line = bench_gate.gate_artifact(_artifact(value=9000.0), golden)
    assert ok and "degraded_mismatch" in line
    assert "stale" not in line  # a lane change is not a perf win
    # matching degraded lanes still grade normally
    art2 = _artifact(value=300.0)  # below the 375 floor
    art2["degraded"] = True
    ok, line = bench_gate.gate_artifact(art2, golden)
    assert not ok and "REGRESSION" in line


def test_update_golden_records_the_degraded_lane(tmp_path):
    golden_path = str(tmp_path / "baseline.json")
    artifact_path = str(tmp_path / "a.json")
    art = _artifact(value=500.0)
    art["degraded"] = True
    with open(artifact_path, "w") as f:
        json.dump(art, f)
    assert bench_gate.main([artifact_path, "--golden", golden_path,
                            "--update-golden"]) == 0
    golden = json.load(open(golden_path))
    assert golden["scenarios"]["spi"]["degraded"] is True
    # the freshly recorded degraded window gates its own artifact green
    assert bench_gate.main([artifact_path, "--golden", golden_path]) == 0


def test_gate_rejects_empty_headline():
    ok, line = bench_gate.gate_artifact(
        {"scenario": "spi", "value": 0, "unit": "ops/sec"}, _golden())
    assert not ok and "no positive headline" in line


def test_update_golden_records_value_and_meta(tmp_path, capsys):
    golden_path = str(tmp_path / "baseline.json")
    artifact_path = str(tmp_path / "a.json")
    with open(artifact_path, "w") as f:
        json.dump(_artifact(value=12345.0), f)
    rc = bench_gate.main([artifact_path, "--golden", golden_path,
                          "--update-golden"])
    assert rc == 0
    golden = json.load(open(golden_path))
    assert golden["scenarios"]["spi"]["value"] == 12345.0
    assert golden["scenarios"]["spi"]["recorded"]["git_sha"] == "abc"
    # the freshly recorded window gates its own artifact green
    assert bench_gate.main([artifact_path, "--golden", golden_path]) == 0
    # and a regressed rerun red, printing the update command
    with open(artifact_path, "w") as f:
        json.dump(_artifact(value=3000.0), f)
    capsys.readouterr()
    assert bench_gate.main([artifact_path, "--golden", golden_path]) == 1
    out = capsys.readouterr().out
    assert (f"python -m copycat_tpu_torch.testing.bench_gate {artifact_path}"
            f" --golden {golden_path} --update-golden") in out


def test_golden_is_required(tmp_path, capsys):
    """No default golden: the reference's committed window holds the
    reference's CPU numbers, no baseline for the port. Leaving
    ``--golden`` out is a usage error (exit 2), and the help says why."""
    artifact_path = str(tmp_path / "a.json")
    with open(artifact_path, "w") as f:
        json.dump(_artifact(), f)
    for argv in ([artifact_path], [artifact_path, "--update-golden"]):
        with pytest.raises(SystemExit) as exc:
            bench_gate.main(argv)
        assert exc.value.code == 2
        assert "--golden" in capsys.readouterr().err
    assert not hasattr(bench_gate, "DEFAULT_GOLDEN")
    with pytest.raises(SystemExit):
        bench_gate.main(["--help"])
    assert "no baseline for the port" in " ".join(
        capsys.readouterr().out.split())


def test_gate_tolerates_series_and_metrics_payloads(tmp_path):
    """Artifacts carry the run's retained /series windows next to the
    metrics snapshots; the gate grades the headline value identically
    and never commits either bulky payload into the golden."""
    artifact = _artifact(value=8000)
    artifact["metrics"] = {"server": {"raft_term": 1}}
    artifact["series"] = {"server": {"node": "n", "role": "member",
                                     "samples": [{"t": 1.0,
                                                  "values": {"x": 1}}]}}
    ok, line = bench_gate.gate_artifact(artifact, _golden())
    assert ok and "ok 8,000.0" in line
    golden_path = tmp_path / "golden.json"
    golden = bench_gate.load_golden(str(golden_path))
    bench_gate.update_golden([artifact], golden)
    entry = golden["scenarios"]["spi"]
    assert "series" not in entry and "metrics" not in entry


def _regressed_on_another_host():
    art = _artifact(value=100.0, git_sha="abc",
                    host={"hostname": "b", "machine": "x", "cpus": 8})
    golden = _golden()
    golden["scenarios"]["spi"]["recorded"] = {
        "host": {"hostname": "a", "machine": "x", "cpus": 2}}
    return art, golden


def _degraded(value):
    art = _artifact(value=value)
    art["degraded"] = True
    return art


DIFFERENTIAL = {
    "inside": (_artifact(value=8000), _golden()),
    "on_the_floor": (_artifact(value=7500.0), _golden()),
    "regression": (_artifact(value=7000), _golden()),
    "regression_other_host": _regressed_on_another_host(),
    "stale": (_artifact(value=20000), _golden()),
    "missing": (_artifact(scenario="novel"), _golden()),
    "unit": (_artifact(unit="reads/sec"), _golden()),
    "degraded_mismatch": (_degraded(500.0), _golden()),
    "empty": ({"scenario": "spi", "value": 0, "unit": "ops/sec"}, _golden()),
    "no_value": ({"scenario": "x"}, _golden()),
    "tolerance": (_artifact(value=9000), _golden(tolerance=0.05)),
    "recovery_x": (_artifact(scenario="recovery", value=2.5, unit="x"),
                   _golden(value=4.0, scenario="recovery", unit="x")),
}


@pytest.mark.parametrize("case", DIFFERENTIAL)
def test_gate_judges_as_the_reference(case):
    artifact, golden = DIFFERENTIAL[case]
    assert bench_gate.gate_artifact(artifact, golden) == \
        ref_gate.gate_artifact(artifact, golden)


def test_update_golden_writes_the_references_bytes(tmp_path):
    """``--update-golden`` over the same artifacts, into an existing
    golden and a new one, writes byte-equal files through both gates, and
    gating against them returns the same code."""
    arts = []
    for i, (scenario, unit, value) in enumerate((
            ("fanout", "reads/sec", 13568.9), ("cluster", "ops/sec", 10942.5),
            ("sharded", "ops/sec", 8985.1), ("recovery", "x", 2.536))):
        art = {**_artifact(scenario, value, unit), "metrics": {"s": {}},
               "series": {}}
        if i == 3:
            art["degraded"] = True
        path = tmp_path / f"{scenario}.json"
        path.write_text(json.dumps(art))
        arts.append(str(path))
    seed = json.dumps({"tolerance": 0.1, "scenarios": {
        "spi": {"value": 1.0, "unit": "ops/sec", "recorded": {}}}})
    for start in (None, seed):
        goldens = []
        for name, gate in (("port", bench_gate), ("ref", ref_gate)):
            golden = tmp_path / f"{name}-{start is None}.json"
            if start is not None:
                golden.write_text(start)
            assert gate.main([*arts, "--golden", str(golden),
                              "--update-golden"]) == 0
            goldens.append(golden.read_bytes())
        assert goldens[0] == goldens[1]
        for gate in (bench_gate, ref_gate):
            assert gate.main([*arts, "--golden", str(golden)]) == 0
    halved = tmp_path / "halved.json"
    halved.write_text(json.dumps({**json.loads(open(arts[1]).read()),
                                  "value": 10942.5 / 2}))
    assert bench_gate.main([str(halved), "--golden", str(golden)]) == \
        ref_gate.main([str(halved), "--golden", str(golden)]) == 1
