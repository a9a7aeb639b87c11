"""The port's public-API bench scenarios (``copycat_tpu_torch/bench.py``
``run_spi``, ``run_readmix``, ``run_apply`` and ``main``'s
``--metrics-json``) against the reference's, on the CPU at a small size.

Each scenario runs once a side for the file: the reference's at the
tests' size through its knobs, the port's with the same parameters on
``device="cpu"`` and an exactly-once hook (``check``) that reads every
counter and records every answer. The result keys must be the
reference's less ``vs_baseline``, and the fields that do not depend on
timing must be equal; the hooks' findings must show every write applied
once and every read equal to the write before it. The reference's three
scenarios run in a worker process started with the session's first port
file (``torch_reference.LONG_RUNS``), so its knobs and the GC tuning it
leaves behind never touch the tests' process.
"""

import gc
import json
import os
from collections import Counter

import pytest

pytest.importorskip("torch")

from copycat_tpu_torch import bench  # noqa: E402
from copycat_tpu_torch.utils import platform, profiler, tracing  # noqa: E402

from torch_reference import (  # noqa: E402,F401
    LONG_RUNS,
    SUITE_AHEAD,
    release_jax_programs,
)

SPI = dict(instances=16, bursts=2)
APPLY = dict(groups=2, sessions=4, ops=8, bursts=2, keys=16)
REFERENCE_KNOBS = {
    "COPYCAT_BENCH_SPI_INSTANCES": "16", "COPYCAT_BENCH_SPI_BURSTS": "2",
    "COPYCAT_BENCH_APPLY_GROUPS": "2", "COPYCAT_BENCH_APPLY_SESSIONS": "4",
    "COPYCAT_BENCH_APPLY_OPS": "8", "COPYCAT_BENCH_APPLY_BURSTS": "2",
    "COPYCAT_BENCH_APPLY_KEYS": "16"}
SCENARIOS = ("spi", "readmix", "apply")
DETERMINISTIC = ("metric", "unit", "on_device_instances", "pipeline_depth",
                 "read_level", "groups", "sessions", "keys")
ARTIFACT_KEYS = {"scenario", "meta", "metrics", "series", "profile"}


def reference_scenarios() -> dict:
    """The reference's three scenarios at the tests' size, through its
    knobs; the knobs and the GC tuning its scenarios leave behind are
    undone after."""
    saved = gc.get_threshold()
    with pytest.MonkeyPatch.context() as mp:
        for name, value in REFERENCE_KNOBS.items():
            mp.setenv(name, value)
        from copycat_tpu import bench as ref
        try:
            return {"spi": ref.run_spi(), "readmix": ref.run_readmix(),
                    "apply": ref.run_apply()}
        finally:
            gc.unfreeze()
            gc.set_threshold(*saved)


@pytest.fixture(scope="module")
def reference():
    """The reference's three scenarios, once for the file."""
    return SUITE_AHEAD.get("bench_api", reference_scenarios)


_FILE = os.path.basename(__file__)
for _test in ("test_result_keys_are_the_references",
              "test_deterministic_fields_equal_the_references",
              "test_metrics_json_has_the_references_artifact_keys"):
    LONG_RUNS[f"{_FILE}::{_test}"] = [("bench_api", reference_scenarios, ())]


@pytest.fixture(scope="module")
def port():
    """The port's three scenarios at the same size, with what each
    ``check`` hook saw: the final counter values, the reads, the
    writes."""
    seen = {}

    async def spi(run):
        seen["spi"] = ([await c.get() for c in run.counters], run.expected)

    async def readmix(run):
        seen["readmix"] = (run.answers, [await c.get() for c in run.counters],
                           run.bursts)

    async def apply(run):
        finals = [await h.get() for h in run.handles[0]]
        seen["apply"] = (run.writes, finals)

    results = {
        "spi": bench.run_spi(**SPI, device="cpu", check=spi),
        "readmix": bench.run_readmix(**SPI, device="cpu", check=readmix),
        "apply": bench.run_apply(**APPLY, device="cpu", check=apply)}
    return results, seen


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_result_keys_are_the_references(scenario, reference, port):
    want = set(reference[scenario]) - {"vs_baseline"}
    assert set(port[0][scenario]) == want
    if scenario == "apply":
        assert set(port[0]["apply"]["apply"]) == set(
            reference["apply"]["apply"])


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_deterministic_fields_equal_the_references(scenario, reference,
                                                   port):
    got, want = port[0][scenario], reference[scenario]
    for key in DETERMINISTIC:
        assert got.get(key) == want.get(key), key
    for key in ("value", "reps_min", "reps_max"):
        assert got[key] > 0
    assert got["reps_n"] == want["reps_n"] == 2


def test_spi_every_counter_reads_bursts_times_waves(port):
    finals, expected = port[1]["spi"]
    assert expected == SPI["bursts"]
    assert finals == [expected] * SPI["instances"]
    assert port[0]["spi"]["engine_rounds"] > 0


def test_readmix_every_read_equals_the_write_before_it(port):
    answers, finals, bursts = port[1]["readmix"]
    assert len(answers) == SPI["instances"] * bursts
    for i, written, reads in answers:
        assert len(reads) == bench.READMIX_READS
        assert reads == [written] * len(reads), (i, written, reads)
    per_instance = Counter(i for i, _, _ in answers)
    assert set(per_instance.values()) == {bursts}
    assert sorted(w for i, w, _ in answers if i == 0) == [1, 2]
    assert finals == [bursts] * SPI["instances"]


def test_apply_writes_form_one_chain_per_key(port):
    """Each key's ``get_and_set`` returns are the values written before
    them: the register's initial ``None`` and every write but the last
    one applied, each once — so every write is applied exactly once —
    and the last applied is what the key reads."""
    writes, finals = port[1]["apply"]
    elig = APPLY["sessions"] - max(1, round(APPLY["sessions"] * 0.25))
    per_burst = elig * APPLY["ops"]
    assert len(writes) == elig * (APPLY["ops"] // 2) + APPLY["bursts"] * \
        per_burst
    for key in range(APPLY["keys"]):
        mine = [(v, old) for k, v, old in writes if k == key]
        if not mine:
            assert finals[key] is None
            continue
        returned = Counter(old for _, old in mine)
        written = Counter([None] + [v for v, _ in mine])
        written[finals[key]] -= 1
        assert returned == +written, key


def test_scenarios_leave_the_process_as_found(port):
    assert gc.get_threshold() != (100_000, 50, 100)
    assert gc.get_freeze_count() == 0
    assert not tracing.TRACER.enabled
    assert profiler.PROFILER is None


@pytest.mark.parametrize("level", ["sequential", "linearizable"])
def test_readmix_read_levels_on_the_cpu(level):
    answers = []

    async def check(run):
        answers.extend(run.answers)

    out = bench.run_readmix(4, 1, reads=2, read_level=level, device="cpu",
                            check=check)
    assert out["read_level"] == level
    assert out["metric"].endswith(f"_4_device_instances_{level}")
    assert sorted(answers) == [(i, 1, [1, 1]) for i in range(4)]


def test_spi_string_payload_takes_the_host_shadow():
    seen = {}

    async def check(run):
        seen["maps"] = [await m.get("k") for m in run.counters]

    out = bench.run_spi(4, 2, payload="str", device="cpu", check=check)
    assert out["metric"] == \
        "spi_client_visible_ops_per_sec_4_device_instances_shadow"
    assert out["payload"] == "str"
    assert sorted(seen["maps"]) == [f"v{n}" for n in range(5, 9)]


def test_metrics_json_has_the_references_artifact_keys(tmp_path, reference,
                                                       capsys):
    path = tmp_path / "spi.json"
    bench.main(["--scenario", "spi", "--device", "cpu", "--instances", "16",
                "--bursts", "2", "--metrics-json", str(path)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    artifact = json.loads(path.read_text())
    want = set(reference["spi"]) - {"vs_baseline"}
    assert set(result) == want
    assert set(artifact) == want | ARTIFACT_KEYS
    assert artifact["scenario"] == "spi"
    assert set(artifact["metrics"]) == {"server", "client"}
    assert set(artifact["meta"]) == {"git_sha", "recorded_at", "knobs",
                                     "host"}
    assert artifact["meta"]["host"]["device"] == "cpu"
    assert artifact["meta"]["host"]["card"] is None
    assert profiler.PROFILER is None


def test_metrics_json_of_an_engine_scenario_has_no_metrics(tmp_path):
    path = tmp_path / "counter.json"
    bench.main(["--scenario", "counter", "--device", "cpu", "--groups", "8",
                "--rounds", "2", "--repeats", "1", "--metrics-json",
                str(path)])
    artifact = json.loads(path.read_text())
    assert artifact["scenario"] == "counter"
    assert artifact["metrics"] == {} and artifact["series"] == {}


def test_main_exits_2_without_a_card_and_never_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(platform, "_PROBE_CODE", "raise SystemExit(1)")
    monkeypatch.setenv("COPYCAT_DEVICE_PROBES", "1")
    ran = []
    for name in ("run_spi", "run_readmix", "run_apply"):
        monkeypatch.setattr(bench, name, lambda *a, **kw: ran.append(kw))
    for scenario in SCENARIOS:
        with pytest.raises(SystemExit) as exc:
            bench.main(["--scenario", scenario])
        assert exc.value.code == 2
    assert ran == []
