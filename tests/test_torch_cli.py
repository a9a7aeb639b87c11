"""The port's operator CLI (``copycat_tpu_torch/cli.py``).

- Differential, exact: the watch renderers (``_render_watch``,
  ``_render_header``, ``_render_traces_watch``) and the address check
  (``_bad_addresses``) of both packages on the same snapshot dicts and
  trace bodies, text equal (the clock in a frame's first line pinned).
- Port copies of the reference's CLI cases (``test_stats_surface.py``,
  ``test_series_surface.py``, ``test_doctor.py``) on the port's own
  server stack; and the port's own rules: ``lint`` runs the port's
  copycheck over the port's tree (exit 0 on it, 1 on a copy with a
  seeded finding, 2 for ``--update-golden``) without importing torch,
  and ``profile --device`` reads a torch Chrome trace.
"""

import argparse
import asyncio
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

from copycat_tpu import cli as ref_cli  # noqa: E402
from copycat_tpu_torch import cli  # noqa: E402
from copycat_tpu_torch.atomic import DistributedAtomicLong  # noqa: E402
from copycat_tpu_torch.io.local import (  # noqa: E402
    LocalServerRegistry,
    LocalTransport,
)
from copycat_tpu_torch.io.transport import Address  # noqa: E402
from copycat_tpu_torch.manager.atomix import (  # noqa: E402
    AtomixClient,
    AtomixServer,
)
from copycat_tpu_torch.server.stats import StatsListener  # noqa: E402
from copycat_tpu_torch.testing.counter_machine import ClusterAdd  # noqa: E402
from copycat_tpu_torch.utils import tracing  # noqa: E402
from copycat_tpu_torch.utils.health import (  # noqa: E402
    assemble_doctor_report,
    render_doctor_report,
)

from helpers import arun, async_test  # noqa: E402
from torch_port_fixtures import create_cluster  # noqa: E402
from torch_reference import release_jax_programs  # noqa: E402,F401


ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _release(release_jax_programs):
    yield


def _ns(**kw):
    return type("A", (), kw)()


async def _running_server(port: int = 16_223):
    """One port AtomixServer (local raft transport, a real TCP stats
    port) plus a client that drove some public-API traffic through it."""
    registry = LocalServerRegistry()
    transport = LocalTransport(registry)
    addr = Address("127.0.0.1", port)
    server = AtomixServer(addr, [addr], transport, session_timeout=30.0,
                          stats_port=0)
    await server.open()
    client = AtomixClient([addr], transport, session_timeout=30.0)
    await client.open()
    counter = await client.get("hits", DistributedAtomicLong)
    await counter.increment_and_get()
    await asyncio.gather(*(counter.increment_and_get() for _ in range(8)))
    return server, client


# ---------------------------------------------------------------------------
# the renderers against the reference's, on the same inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def live_inputs():
    """A port server's stats snapshot before and after traffic, and its
    ``/traces`` body with tracing on: the renderers' real inputs."""
    async def run():
        server, client = await _running_server(16_224)
        tracing.TRACER.clear()
        tracing.enable()
        try:
            before = server.server.stats_snapshot()
            counter = await client.get("hits", DistributedAtomicLong)
            await asyncio.gather(*(counter.increment_and_get()
                                   for _ in range(6)))
            after = server.server.stats_snapshot()
            traces = tracing.TRACER.dump_slowest(20, as_json=True)
        finally:
            tracing.disable()
            await client.close()
            await server.close()
        return before, after, traces.encode()

    return arun(run(), timeout=60)


SNAPSHOTS = {
    "labeled": {"node": "n", "raft": {
        "raft_term{group=0}": 3, "raft_term{group=1}": 4,
        "query_reads{consistency=causal}": 5, "query_windows": 2}},
    "numeric_labels": {"node": "n", "raft": {
        f"raft_term{{group={g}}}": 1 for g in (10, 2, 1, 0)}},
    "nested_strings": {"node": "n", "role": "follower",
                       "groups": {"0": {"role": "leader", "leader": "l:1",
                                        "commit_index": 5}}},
    "histograms": {"node": "n", "_gauge_keys": ["x"], "ok": True,
                   "lat": {"count": 3, "mean": 1.5, "p50": 1.0, "p99": 2.0,
                           "max": 2.5}, "rate": 0.125, "none": None},
}


@pytest.fixture
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:00:00")


@pytest.mark.parametrize("name", [*SNAPSHOTS, "live"])
def test_render_watch_and_header_equal_the_reference(name, frozen_clock,
                                                     live_inputs):
    if name == "live":
        prev_snap, snap = live_inputs[:2]
    else:
        snap = SNAPSHOTS[name]
        prev_snap = json.loads(json.dumps(snap))
        for v in prev_snap.get("raft", {}):
            prev_snap["raft"][v] -= 1
    for prev, dt in ((None, 0.0), (cli._flatten_numeric(prev_snap), 0.5)):
        assert cli._render_watch(snap, prev, dt) == \
            ref_cli._render_watch(snap, prev, dt)
    lines, ref_lines = [], []
    cli._render_header(snap, lines, "p.")
    ref_cli._render_header(snap, ref_lines, "p.")
    assert lines == ref_lines
    assert cli._flatten_numeric(snap) == ref_cli._flatten_numeric(snap)


TRACE_BODIES = [
    [{"trace": 7, "total_ms": 12.5, "spans": [
        {"name": "group.append", "group": 1, "member": "a:1",
         "duration_ms": 2.0},
        {"name": "group.append", "group": 1, "member": "a:1",
         "duration_ms": 0.5},
        {"name": "apply", "group": 10, "duration_ms": 3.0},
        {"name": "apply", "group": 2, "duration_ms": 4.0},
        {"name": "respond", "duration_ms": 0.25}]},
     {"trace": 9, "total_ms": 3.0, "spans": []}],
    [],
]


@pytest.mark.parametrize("body", range(len(TRACE_BODIES) + 1))
@pytest.mark.parametrize("prev_ids", [None, set(), {7}])
@pytest.mark.parametrize("slowest", [1, 8])
def test_render_traces_watch_equals_the_reference(body, prev_ids, slowest,
                                                  frozen_clock, live_inputs):
    raw = (live_inputs[2] if body == len(TRACE_BODIES)
           else json.dumps(TRACE_BODIES[body]).encode())
    assert cli._render_traces_watch(raw, prev_ids, slowest) == \
        ref_cli._render_traces_watch(raw, prev_ids, slowest)


@pytest.mark.parametrize("addresses", [
    ["127.0.0.1:1"], ["localhost"], ["a:1", "b", "c:x", "d:2"], [],
    ["[::1]:80", "host:"]])
def test_bad_addresses_equals_the_reference(addresses, capsys):
    rc = cli._bad_addresses(addresses)
    out = capsys.readouterr()
    ref_rc = ref_cli._bad_addresses(addresses)
    ref_out = capsys.readouterr()
    assert (rc, out.out, out.err) == (ref_rc, ref_out.out, ref_out.err)


# ---------------------------------------------------------------------------
# test_stats_surface.py's CLI cases
# ---------------------------------------------------------------------------


def test_cli_stats_what_all(capsys):
    async def run():
        server, client = await _running_server(16_225)
        port = server.stats.port
        try:
            counter = await client.get("hits", DistributedAtomicLong)
            await asyncio.gather(*(counter.get() for _ in range(4)))
            rc = await asyncio.to_thread(
                cli._stats, _ns(address=f"127.0.0.1:{port}", what="all"))
            assert rc == 0
        finally:
            await client.close()
            await server.close()

    asyncio.run(asyncio.wait_for(run(), 110))
    out = capsys.readouterr().out
    assert "=== stats ===" in out
    assert '"query_windows"' in out
    assert '"apply.parallel_spans"' in out
    assert '"apply.fused_dispatches"' in out
    assert '"edge.subscriptions"' in out
    assert '"edge.deltas_sent"' in out
    assert "=== metrics ===" in out
    assert "copycat_query_windows" in out
    assert "copycat_apply_fused_dispatches" in out
    assert "copycat_edge_subscriptions" in out
    assert "=== flight ===" in out


def test_cli_stats_verb(capsys):
    async def run():
        server, client = await _running_server(16_226)
        port = server.stats.port
        try:
            for what in ("stats", "metrics"):
                rc = await asyncio.to_thread(
                    cli._stats, _ns(address=f"127.0.0.1:{port}", what=what))
                assert rc == 0
        finally:
            await client.close()
            await server.close()

    asyncio.run(asyncio.wait_for(run(), 110))
    out = capsys.readouterr().out
    assert '"raft_is_leader": 1' in out or '"raft_is_leader": 1.0' in out
    assert "copycat_raft_term" in out


def test_cli_stats_unreachable(capsys):
    rc = cli._stats(_ns(address="127.0.0.1:1", what="stats"))
    assert rc == 1
    assert "--stats-port" in capsys.readouterr().err


def test_watch_renderer_keeps_labeled_series_distinct():
    snap = json.loads(json.dumps(SNAPSHOTS["labeled"]))
    prev = cli._flatten_numeric(snap)
    assert "raft.raft_term{group=0}" in prev
    assert "raft.raft_term{group=1}" in prev
    snap["raft"]["raft_term{group=1}"] = 6
    frame = cli._render_watch(snap, prev, 1.0)
    lines = [ln for ln in frame.splitlines() if "raft_term" in ln]
    assert len(lines) == 2
    g0 = next(ln for ln in lines if "{group=0}" in ln)
    g1 = next(ln for ln in lines if "{group=1}" in ln)
    assert "+2.0/s" in g1 and "/s" not in g0
    keys = [ln.split()[0] for ln in frame.splitlines() if "query" in ln]
    assert keys == ["raft.query_reads{consistency=causal}",
                    "raft.query_windows"]


def test_watch_renderer_orders_numeric_labels_numerically():
    snap = SNAPSHOTS["numeric_labels"]
    prev = cli._flatten_numeric(snap)
    frame = cli._render_watch(snap, prev, 1.0)
    keys = [ln.split()[0] for ln in frame.splitlines()
            if "raft_term" in ln]
    assert keys == [f"raft.raft_term{{group={g}}}" for g in (0, 1, 2, 10)]
    frame0 = cli._render_watch(snap, None, 0.0)
    assert [ln.split()[0] for ln in frame0.splitlines()
            if "raft_term" in ln] == keys


def test_watch_renderer_shows_apply_family_deltas():
    snap = {"node": "n", "raft": {
        "apply.parallel_spans{group=0}": 4, "apply.fused_dispatches": 7}}
    prev = cli._flatten_numeric(snap)
    snap["raft"]["apply.fused_dispatches"] = 10
    frame = cli._render_watch(snap, prev, 1.0)
    assert "raft.apply.parallel_spans{group=0}" in frame
    fused = next(ln for ln in frame.splitlines()
                 if "apply.fused_dispatches" in ln)
    assert "+3.0/s" in fused


def test_watch_renderer_shows_nested_group_strings():
    frame = cli._render_watch(SNAPSHOTS["nested_strings"], None, 0.0)
    assert "groups.0.role: leader" in frame
    assert "groups.0.leader: l:1" in frame
    assert "groups.0.commit_index" in frame


# ---------------------------------------------------------------------------
# test_series_surface.py's and test_doctor.py's CLI cases
# ---------------------------------------------------------------------------


async def _traffic(cluster) -> None:
    client = await cluster.client()
    await client.submit(ClusterAdd(key="k", delta=1))


def test_cli_timeline_verb_json_and_text(capsys, monkeypatch):
    monkeypatch.setenv("COPYCAT_SERIES_INTERVAL_S", "0.05")

    async def run():
        cluster = await create_cluster(1)
        try:
            await _traffic(cluster)
            server = cluster.servers[0]
            server.series_tick()
            await asyncio.sleep(0.06)
            server.series_tick()
            listener = await StatsListener(server, port=0).open()
            try:
                addr = f"127.0.0.1:{listener.port}"
                rc = await asyncio.to_thread(
                    cli._timeline, _ns(addresses=[addr], last=60.0,
                                       names=None, json=True))
                assert rc == 0
                timeline = json.loads(capsys.readouterr().out)
                assert timeline["members"] == [str(server.address)]
                assert timeline["incomplete"] is False
                assert timeline["series"][timeline["members"][0]]
                rc = await asyncio.to_thread(
                    cli._timeline, _ns(addresses=[addr], last=60.0,
                                       names="raft_commit_index",
                                       json=False))
                assert rc == 0
                out = capsys.readouterr().out
                assert "cluster timeline" in out
                assert "raft_commit_index" in out
            finally:
                await listener.close()
        finally:
            await cluster.close()

    arun(run(), timeout=120)
    rc = cli._timeline(_ns(addresses=["127.0.0.1:1"], last=60.0,
                           names=None, json=True))
    assert rc == 1
    assert "--stats-port" in capsys.readouterr().err


@pytest.mark.parametrize("as_json", [False, True], ids=["once", "json"])
def test_cli_top_one_shot(as_json, capsys):
    async def run():
        cluster = await create_cluster(1)
        try:
            await _traffic(cluster)
            listener = await StatsListener(cluster.servers[0],
                                           port=0).open()
            try:
                addr = f"127.0.0.1:{listener.port}"
                rc = await asyncio.to_thread(
                    cli._top, _ns(addresses=[addr, "127.0.0.1:1"],
                                  watch=0.1, once=not as_json,
                                  json=as_json))
                assert rc == 0
                out = capsys.readouterr().out
                member = str(cluster.servers[0].address)
                if as_json:
                    frame = json.loads(out)
                    assert frame["failed"] == ["127.0.0.1:1"]
                    row = frame["members"][member]
                    assert row["role"] in ("leader", "follower",
                                           "candidate")
                    assert row["commit_rate"] is None
                    assert frame["worst_health"] in (
                        "ok", "warn", "critical", "unreachable")
                else:
                    assert "cluster top" in out
                    assert member in out
                    assert "UNREACHABLE" in out
            finally:
                await listener.close()
        finally:
            await cluster.close()

    arun(run(), timeout=120)
    rc = cli._top(_ns(addresses=["127.0.0.1:1"], watch=0.1,
                      once=not as_json, json=as_json))
    assert rc == 1


def test_cli_parser_registers_new_verbs_and_doctor_last(capsys):
    for argv in (["timeline"], ["top"]):
        with pytest.raises(SystemExit):
            cli.main(argv)  # addresses are required
        capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        cli.main(["doctor", "--last", "nope", "127.0.0.1:1"])
    assert e.value.code == 2
    capsys.readouterr()


def test_doctor_cli_all_unreachable_is_one_line_error(capsys):
    rc = cli._doctor(argparse.Namespace(
        addresses=["127.0.0.1:1", "127.0.0.1:2"], slowest=3, json=False))
    assert rc == 1
    err = capsys.readouterr().err
    assert "none of 2 member(s) reachable" in err
    assert "--stats-port" in err


def test_doctor_and_trace_cli_render_against_live_cluster(capsys):
    """``collect_doctor`` and the rendered report (the reference's case),
    then the ``doctor`` and ``trace`` verbs themselves on a traced
    write."""
    async def scenario():
        cluster = await create_cluster(1)
        listener = await StatsListener(cluster.servers[0], port=0).open()
        addr = f"127.0.0.1:{listener.port}"
        tracing.TRACER.clear()
        tracing.enable()
        try:
            await _traffic(cluster)
            members, failed, traces = await cli.collect_doctor([addr])
            report = assemble_doctor_report(members, failed, traces)
            print(render_doctor_report(report))
            for fn, args in (
                    (cli._doctor, argparse.Namespace(
                        addresses=[addr], slowest=3, json=True)),
                    (cli._trace, argparse.Namespace(
                        addresses=[addr], slowest=3, json=False))):
                assert await asyncio.to_thread(fn, args) == 0
        finally:
            tracing.disable()
            await listener.close()
            await cluster.close()

    arun(scenario(), timeout=120)
    out = capsys.readouterr().out
    assert "cluster verdict" in out
    assert '"verdict"' in out
    assert "end-to-end" in out and "critical path" in out


def test_stats_cli_bad_address_is_actionable(capsys):
    rc = cli._stats(argparse.Namespace(address="localhost", what="stats",
                                       watch=None))
    assert rc == 1
    assert "expected host:port" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


#: Run in a fresh interpreter: the port's ``lint`` over its own tree, then
#: which heavy modules it imported (none may be).
_LINT_PROBE = """
import json, sys
from copycat_tpu_torch import cli
try:
    cli.main(["lint", "--strict", "--no-cache"])
except SystemExit as e:
    code = e.code
print(json.dumps({"code": code, "imported": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("torch", "jax", "numpy", "copycat_tpu"))}))
"""


@pytest.fixture(scope="module")
def lint_probe():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", _LINT_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


def test_lint_strict_exits_0_on_the_ports_tree(lint_probe):
    assert json.loads(lint_probe[-1])["code"] == 0
    status = lint_probe[-2]
    assert status.startswith("copycheck: ok") and " 0 finding(s)" in status


def test_lint_imports_no_torch(lint_probe):
    """``lint`` is pure stdlib and AST: after a whole run, neither torch
    nor the reference package (nor numpy or jax) is in ``sys.modules``."""
    assert json.loads(lint_probe[-1])["imported"] == []


def test_lint_strict_exits_1_on_a_copy_with_a_seeded_finding(tmp_path):
    for rel in ("copycat_tpu_torch", "docs", "tests/golden"):
        shutil.copytree(ROOT / rel, tmp_path / rel,
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "_build"))
    for rel in ("chip_smoke.py", "ab_quorum_kernels.py"):
        shutil.copy(ROOT / rel, tmp_path / rel)
    client = tmp_path / "copycat_tpu_torch" / "client" / "client.py"
    client.write_text(client.read_text() + (
        "\n\nasync def _seeded(loop, coro):\n    loop.create_task(coro)\n"))
    proc = subprocess.run(
        [sys.executable, "-m", "copycat_tpu_torch.cli", "lint", "--strict",
         "--no-cache"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    found = [line for line in proc.stdout.splitlines()
             if line.startswith("copycat_tpu_torch/")]
    assert len(found) == 1 and "orphan-task" in found[0] \
        and "[_seeded]" in found[0]
    assert "copycheck: FAIL" in proc.stdout


def test_lint_update_golden_is_refused(capsys):
    golden = ROOT / "tests" / "golden" / "wire_schema.json"
    before = golden.read_text()
    with pytest.raises(SystemExit) as e:
        cli.main(["lint", "--update-golden"])
    assert e.value.code == 2
    assert "belongs to the reference package" in capsys.readouterr().err
    assert golden.read_text() == before


def test_every_other_verb_of_the_reference_parses(capsys):
    for verb in ("stats", "trace", "doctor", "timeline", "top", "profile",
                 "cluster", "serve"):
        with pytest.raises(SystemExit) as e:
            cli.main([verb, "--help"])
        assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        cli.main(["lint", "--help"])
    assert e.value.code == 0
    assert "--write-baseline" in capsys.readouterr().out


def _torch_trace(path, kernels: dict) -> None:
    """A Chrome trace as ``torch.profiler`` writes it: every process named
    ``python3``, the card's lane labelled ``GPU 0``, host spans on
    another pid."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 0,
         "args": {"labels": "GPU 0"}},
        {"ph": "X", "name": "aten::add", "pid": 1, "ts": 0, "dur": 900},
    ]
    for name, durs in kernels.items():
        events += [{"ph": "X", "name": name, "pid": 0, "ts": i, "dur": d}
                   for i, d in enumerate(durs)]
    path.mkdir(parents=True)
    (path / "trace.json").write_text(json.dumps({"traceEvents": events}))


def test_profile_device_reads_a_torch_chrome_trace(tmp_path, capsys):
    _torch_trace(tmp_path / "20260101-000000-1", {
        "void admit_submits_kernel<3, false>(int const*)": [4, 6],
        "ack_commit_kernel(AckIn, AckOut, int, int, int, int)": [3]})
    args = dict(addresses=[], device=str(tmp_path), top=20, last=None,
                diff=None)
    assert cli._profile(argparse.Namespace(json=False, **args)) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["op", "total_ms", "count"]
    assert "admit_submits_kernel" in out[1] and out[1].split()[-2:] == [
        "0.010", "2"]
    assert "ack_commit_kernel" in out[2]
    assert "aten::add" not in "\n".join(out)
    assert cli._profile(argparse.Namespace(json=True, **args)) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["count"] for r in rows] == [2, 1]
    # no session, or no device lane: one line and exit 1
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli._profile(argparse.Namespace(
        json=False, **{**args, "device": str(empty)})) == 1
    assert "no trace sessions" in capsys.readouterr().err
    # no address and no --device: exit 2
    assert cli._profile(argparse.Namespace(
        json=False, **{**args, "device": None})) == 2


@async_test(timeout=60)
async def test_cluster_verbs_name_an_unreachable_supervisor(capsys):
    for action in ("status", "kill-member"):
        rc = await asyncio.to_thread(cli._cluster, argparse.Namespace(
            action=action, address="127.0.0.1:1", json=False,
            name="member-0"))
        assert rc == 1
        assert "cannot reach the supervisor" in capsys.readouterr().err
