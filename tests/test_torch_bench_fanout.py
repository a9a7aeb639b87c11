"""The port's edge-read bench scenario (``copycat_tpu_torch/bench.py``
``run_fanout``) against the reference's, on the CPU at the reference's CI
smoke settings (readers 4 and 16, 20 reads each, 2 bursts), with
``COPYCAT_EDGE_READS`` on and off.

Each lane runs once a side for the file, through the same knobs: the
reference's in a worker process (``torch_reference.LONG_RUNS``), the
port's here with a hook (``check``) that reads every counter back after
the writers stop. The results must carry the reference's keys less
``vs_baseline``, the metrics families the reference's keys, and equal
fields where they do not depend on timing (the trace proof's spans and
members included); both sides must pass the gate the reference's CI
smoke asserts; and the counters must hold every committed write once.
No timing is compared.
"""

import gc
import json
import os

import pytest

pytest.importorskip("torch")

from copycat_tpu_torch import bench  # noqa: E402
from copycat_tpu_torch.atomic import DistributedAtomicLong  # noqa: E402
from copycat_tpu_torch.utils import tracing  # noqa: E402

from torch_reference import (  # noqa: E402,F401
    LONG_RUNS,
    SUITE_AHEAD,
    release_jax_programs,
)

KNOBS = {"COPYCAT_BENCH_FANOUT_READERS": "4,16",
         "COPYCAT_BENCH_FANOUT_WRITERS": "2",
         "COPYCAT_BENCH_FANOUT_KEYS": "16",
         "COPYCAT_BENCH_FANOUT_READS": "20",
         "COPYCAT_BENCH_FANOUT_BURSTS": "2",
         "COPYCAT_BENCH_FANOUT_ZIPF": "0.9"}
LANES = {"on": "1", "off": "0"}
DETERMINISTIC = ("metric", "unit", "edge_reads", "readers", "writers",
                 "keys", "reps_n")


def reference_fanout(lane: str) -> dict:
    """The reference's ``run_fanout`` with edge reads ``lane``, its knobs
    set before its bench is imported; the GC tuning it leaves behind is
    undone after. Its result and metrics snapshots (as JSON)."""
    saved = gc.get_threshold()
    with pytest.MonkeyPatch.context() as mp:
        for name, value in {**KNOBS,
                            "COPYCAT_EDGE_READS": LANES[lane]}.items():
            mp.setenv(name, value)
        from copycat_tpu import bench as ref
        ref.METRICS_SNAPSHOTS.clear()
        try:
            result = ref.run_fanout()
            metrics = json.loads(json.dumps(ref.METRICS_SNAPSHOTS))
        finally:
            gc.unfreeze()
            gc.set_threshold(*saved)
    return {"result": result, "metrics": metrics}


@pytest.fixture(scope="module")
def reference():
    return {lane: SUITE_AHEAD.get(f"bench_fanout_{lane}", reference_fanout,
                                  lane) for lane in LANES}


_FILE = os.path.basename(__file__)
for _test in ("test_result_keys_are_the_references",
              "test_deterministic_fields_equal_the_references",
              "test_both_pass_the_ci_smoke_gate"):
    LONG_RUNS[f"{_FILE}::{_test}"] = [
        (f"bench_fanout_{lane}", reference_fanout, (lane,))
        for lane in LANES]


@pytest.fixture(scope="module")
def port():
    """The port's two lanes at the same knobs, with what each ``check``
    hook saw: every counter's value, the committed writes and the server
    reads of each burst."""
    out = {}
    for lane, value in LANES.items():
        seen = {}

        async def check(run):
            # a fresh handle reads through the server (SEQUENTIAL
            # replicas are the readers', not the writers')
            ctrs = run.writer_ctrs[0]
            seen["values"] = [await c.get() for c in ctrs]
            seen["writes"] = run.writes
            seen["server_reads"] = run.server_reads
            assert all(isinstance(c, DistributedAtomicLong) for c in ctrs)

        with pytest.MonkeyPatch.context() as mp:
            for name, v in {**KNOBS, "COPYCAT_EDGE_READS": value}.items():
                mp.setenv(name, v)
            bench.METRICS_SNAPSHOTS.clear()
            result = bench.run_fanout(check=check)
        out[lane] = {"result": result, "seen": seen,
                     "metrics": json.loads(json.dumps(
                         bench.METRICS_SNAPSHOTS))}
    return out


@pytest.mark.parametrize("lane", LANES)
def test_result_keys_are_the_references(lane, reference, port):
    want, got = reference[lane], port[lane]
    assert set(got["result"]) == set(want["result"]) - {"vs_baseline"}
    assert set(got["metrics"]) == set(want["metrics"]) == {
        "server", "edge_clients"}
    assert set(got["metrics"]["edge_clients"]) == set(
        want["metrics"]["edge_clients"])
    assert set(got["metrics"]["server"]) == set(want["metrics"]["server"])
    edge = {k for k in want["metrics"]["server"]["raft"]
            if k.startswith("edge.")}
    assert {k for k in got["metrics"]["server"]["raft"]
            if k.startswith("edge.")} == edge


@pytest.mark.parametrize("lane", LANES)
def test_deterministic_fields_equal_the_references(lane, reference, port):
    got, want = port[lane]["result"], reference[lane]["result"]
    for key in DETERMINISTIC:
        assert got[key] == want[key], key
    assert set(got["sweep"]) == set(want["sweep"]) == {"4", "16"}
    for count in got["sweep"]:
        assert set(got["sweep"][count]) == set(want["sweep"][count])
        assert len(got["sweep"][count]["reps"]) == 2
    assert got["trace"] == want["trace"]
    assert got["value"] > 0


def _ci_gate(snap: dict, metrics: dict, edge_on: bool) -> None:
    """The reference CI smoke's assertions on the artifact (the edge
    lane), or what the knob-off lane shows instead: no client replica
    and no trace proof."""
    assert snap["unit"] == "reads/sec" and snap["value"] > 0
    assert snap["edge_reads"] is edge_on
    agg = metrics["edge_clients"]
    raft = metrics["server"]["raft"]
    if not edge_on:
        assert not agg.get("edge.local_serves")
        assert snap["trace"] is None
        assert snap["sweep"]["16"]["server_reads_last_rep"] > 0
        return
    assert agg["edge.local_serves"] > 0
    assert agg["edge.deltas_in"] > 0
    assert agg["edge.seeds"] > 0
    for key in ("edge.server_fallbacks", "edge.merges", "edge.evictions",
                "edge.stale_rejections"):
        assert key in agg, key
    assert raft["edge.subscribes"] > 0
    assert raft["edge.deltas_sent"] > 0
    assert raft["edge.delta_flushes"] > 0
    assert "edge.subscriptions" in raft
    tr = snap["trace"]
    assert tr is not None, "cache-served trace proof missing"
    assert tr["client_only"] is True
    assert tr["spans"] == ["client.edge_serve"]
    assert tr["members"] == ["client"]


@pytest.mark.parametrize("side", ["reference", "port"])
@pytest.mark.parametrize("lane", LANES)
def test_both_pass_the_ci_smoke_gate(lane, side, reference, port):
    run = (reference if side == "reference" else port)[lane]
    _ci_gate(run["result"], run["metrics"], lane == "on")


@pytest.mark.parametrize("lane", LANES)
def test_counters_hold_every_committed_write_once(lane, port):
    seen = port[lane]["seen"]
    assert len(seen["values"]) == 16
    assert seen["writes"] > 0
    assert sum(seen["values"]) == seen["writes"]


def test_edge_reads_take_load_off_the_server(port):
    """With the edge tier on, the warm burst's server reads at each
    reader count are fewer than its cold burst's, and fewer than the
    knob-off lane's, where every read pays the server."""
    on, off = port["on"]["seen"]["server_reads"], \
        port["off"]["seen"]["server_reads"]
    assert set(on) == set(off) == {4, 16}
    for count in on:
        cold, warm = on[count]
        assert warm < cold, (count, on[count])
        assert warm < min(off[count]), (count, on[count], off[count])
    assert port["off"]["result"]["sweep"]["16"]["server_reads_last_rep"] \
        == off[16][-1]


def test_fanout_leaves_the_process_as_found(port):
    assert gc.get_threshold() != (100_000, 50, 100)
    assert gc.get_freeze_count() == 0
    assert not tracing.TRACER.enabled
