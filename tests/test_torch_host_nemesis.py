"""The port's host-plane nemeses (``copycat_tpu_torch/testing/nemesis.py``):
``crash_server``, ``SlowDiskNemesis``, ``LoopHoldNemesis`` and
``StorageNemesis``.

- Differential, exact: ``StorageNemesis(seed=0)`` of both packages on
  byte-identical copies of a log directory a port server wrote (disk and
  mapped segments, snapshots, the vote-state meta file), for each of the
  five ``STORAGE_FAULTS``: the files are byte-equal afterwards, and a
  port ``RaftServer`` recovering from its copy holds the same committed
  entries (byte for byte), machine state and applied index as a
  reference ``RaftServer`` recovering from the other.
- Port copies of one reference case per nemesis on the port's own
  stack: the restart-recovery differential of ``test_recovery.py``
  (a clean ``crash_server``, and one under ``StorageNemesis``), the
  slow-disk grading of ``test_health.py`` and the loop-hold attribution
  of ``test_profile_surface.py``; and the faults' flight-recorder marks
  in a device server's engine (``executor="tpu"``, on the CPU).
"""

import asyncio
import json
import os
import pathlib
import shutil

import pytest

pytest.importorskip("torch")

from copycat_tpu.io.local import (  # noqa: E402
    LocalServerRegistry as RefRegistry,
    LocalTransport as RefTransport,
)
from copycat_tpu.io.serializer import Serializer as RefSerializer  # noqa: E402
from copycat_tpu.server.log import (  # noqa: E402
    Storage as RefStorage,
    StorageLevel as RefLevel,
)
from copycat_tpu.server.raft import RaftServer as RefRaftServer  # noqa: E402
from copycat_tpu.testing import nemesis as ref_nemesis  # noqa: E402
from copycat_tpu.testing.counter_machine import (  # noqa: E402
    CounterMachine as RefCounterMachine,
)
from copycat_tpu_torch import cli  # noqa: E402
from copycat_tpu_torch.atomic import DistributedAtomicLong  # noqa: E402
from copycat_tpu_torch.io.local import (  # noqa: E402
    LocalServerRegistry,
    LocalTransport,
)
from copycat_tpu_torch.io.serializer import Serializer  # noqa: E402
from copycat_tpu_torch.io.transport import Address  # noqa: E402
from copycat_tpu_torch.manager.atomix import (  # noqa: E402
    AtomixClient,
    AtomixServer,
)
from copycat_tpu_torch.manager.device_executor import (  # noqa: E402
    DeviceEngineConfig,
)
from copycat_tpu_torch.ops import apply as ap  # noqa: E402
from copycat_tpu_torch.server.log import Storage, StorageLevel  # noqa: E402
from copycat_tpu_torch.server.stats import StatsListener  # noqa: E402
from copycat_tpu_torch.testing.counter_machine import (  # noqa: E402
    ClusterAdd,
    ClusterGet,
    CounterMachine,
)
from copycat_tpu_torch.testing.nemesis import (  # noqa: E402
    STORAGE_FAULTS,
    LoopHoldNemesis,
    SlowDiskNemesis,
    StorageNemesis,
    crash_server,
)
from copycat_tpu_torch.utils import profiler  # noqa: E402
from copycat_tpu_torch.utils.timeseries import assemble_timeline  # noqa: E402

from helpers import arun, async_test  # noqa: E402
from torch_port_fixtures import (  # noqa: E402
    create_cluster,
    server_for,
)
from torch_reference import release_jax_programs  # noqa: E402,F401

LEVELS = (StorageLevel.DISK, StorageLevel.MAPPED)


@pytest.fixture(scope="module", autouse=True)
def _release(release_jax_programs):
    yield


def _storage(level, directory, pkg_storage=Storage):
    return pkg_storage(level, str(directory), max_entries_per_segment=16)


def _norm(obj):
    if isinstance(obj, dict):
        return tuple(sorted((repr(k), _norm(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_norm(x) for x in obj)
    return repr(obj)


def fingerprint(server, serializer, from_index=None) -> dict:
    """A server's replicated state, comparable across packages: its log
    entries serialized by its own package, its machine's snapshot image,
    its session table and applied index."""
    log = server.log
    start = log.first_index if from_index is None else max(
        log.first_index, from_index)
    entries = [None if log.get(i) is None else serializer.write(log.get(i))
               for i in range(start, log.last_index + 1)]
    return {"log_start": start, "log_last": log.last_index, "log": entries,
            "machine": _norm(server.state_machine.snapshot_state()),
            "sessions": sorted((sid, _norm(s.snapshot_dict()))
                               for sid, s in server.sessions.items()),
            "last_applied": server.last_applied}


# ---------------------------------------------------------------------------
# StorageNemesis against the reference's, on one directory's two copies
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def crashed_dirs(tmp_path_factory):
    """For each storage level, the directory of a port member crashed
    mid-append (``crash_server``) after snapshots were taken: segments,
    ``.snap`` files and the ``.meta`` vote state, as a crash leaves them;
    and the member's port (its files are named after its address)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COPYCAT_SNAPSHOTS", "1")
        mp.setenv("COPYCAT_SNAPSHOT_ENTRIES", "20")
        mp.setenv("COPYCAT_SNAPSHOT_RETAIN", "4")
        for level in LEVELS:
            base = tmp_path_factory.mktemp(f"written-{level.value}")
            dirs = [base / f"m{i}" for i in range(3)]

            async def run():
                cluster = await create_cluster(
                    3, storage_factory=lambda i: _storage(level, dirs[i]))
                try:
                    client = await cluster.client(session_timeout=30)
                    for i in range(45):
                        await client.submit(ClusterAdd(key=f"k{i % 7}",
                                                       delta=i))
                    victim = next(s for s in cluster.servers
                                  if s is not cluster.leader)
                    burst = [asyncio.ensure_future(client.submit(
                        ClusterAdd(key=f"b{i}", delta=1))) for i in range(8)]
                    await asyncio.sleep(0)
                    await crash_server(victim)
                    await asyncio.gather(*burst)
                    return (dirs[cluster.servers.index(victim)],
                            victim.address.port)
                finally:
                    await cluster.close()

            out[level] = arun(run(), timeout=60)
            names = os.listdir(out[level][0])
            assert any(n.endswith(".snap") for n in names), names
            assert any(n.endswith(".meta") for n in names), names
    return out


def _files(directory) -> dict:
    return {path.name: path.read_bytes()
            for path in sorted(pathlib.Path(directory).iterdir())}


async def _recover(directory, level, port_no: int) -> tuple[dict, dict]:
    """A port and a reference ``RaftServer`` at the crashed member's
    address booted from the two copies (never opened: the boot recovers
    snapshot + log), fingerprinted."""
    addr = Address("local", port_no)
    port = server_for(addr, [addr], LocalServerRegistry(),
                      storage=_storage(level, directory / "port"))
    from copycat_tpu.io.transport import Address as RefAddress

    ref_addr = RefAddress("local", port_no)
    ref = RefRaftServer(ref_addr, [ref_addr],
                        RefTransport(RefRegistry(), local_address=ref_addr),
                        RefCounterMachine(),
                        storage=_storage(RefLevel(level.value),
                                         directory / "ref", RefStorage),
                        election_timeout=0.2, heartbeat_interval=0.04)
    try:
        return fingerprint(port, Serializer()), fingerprint(
            ref, RefSerializer())
    finally:
        for server in (port, ref):
            server.log.close()


@pytest.mark.parametrize("level", LEVELS, ids=lambda lv: lv.value)
@pytest.mark.parametrize("fault", STORAGE_FAULTS)
def test_storage_faults_equal_the_reference(fault, level, crashed_dirs,
                                            tmp_path):
    assert STORAGE_FAULTS == ref_nemesis.STORAGE_FAULTS
    written, port_no = crashed_dirs[level]
    for side in ("port", "ref"):
        shutil.copytree(written, tmp_path / side)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    port_nem = StorageNemesis(str(tmp_path / "port"), seed=0)
    ref_nem = ref_nemesis.StorageNemesis(str(tmp_path / "ref"), seed=0)
    hit = port_nem.inject(fault)
    ref_hit = ref_nem.inject(fault)
    assert hit is not None and ref_hit is not None
    assert os.path.basename(hit) == os.path.basename(ref_hit)
    assert [(f, os.path.basename(p)) for f, p in port_nem.injected] == \
        [(f, os.path.basename(p)) for f, p in ref_nem.injected]
    mutated = _files(tmp_path / "port")
    assert mutated == _files(tmp_path / "ref")
    assert mutated != _files(written)  # the fault landed
    mine, theirs = arun(_recover(tmp_path, level, port_no), timeout=60)
    assert mine == theirs
    assert mine["last_applied"] > 0


# ---------------------------------------------------------------------------
# test_recovery.py: the restart-recovery differential (crash_server, and
# crash_server + StorageNemesis)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", [None, "partial_frame"],
                         ids=["crash_server", "storage_nemesis"])
def test_restart_recovery_differential(tmp_path, monkeypatch, fault):
    """Kill a follower mid-append, tear what the crash left behind,
    reboot it from snapshot + log tail: once re-converged it matches a
    member that never crashed."""
    monkeypatch.setenv("COPYCAT_SNAPSHOTS", "1")
    monkeypatch.setenv("COPYCAT_SNAPSHOT_ENTRIES", "20")
    monkeypatch.setenv("COPYCAT_SNAPSHOT_RETAIN", "4")
    level = StorageLevel.DISK
    dirs = [tmp_path / f"m{i}" for i in range(3)]

    async def run() -> None:
        cluster = await create_cluster(
            3, storage_factory=lambda i: _storage(level, dirs[i]))
        try:
            client = await cluster.client(session_timeout=30)
            for i in range(30):
                await client.submit(ClusterAdd(key=f"k{i % 7}", delta=i))
            leader = cluster.leader
            victim = next(s for s in cluster.servers if s is not leader)
            vic = cluster.servers.index(victim)
            burst = [asyncio.ensure_future(
                client.submit(ClusterAdd(key=f"burst{i}", delta=i)))
                for i in range(8)]
            await asyncio.sleep(0)
            await crash_server(victim)
            assert not victim.is_open
            await asyncio.gather(*burst)  # a quorum of 2 still commits
            if fault is not None:
                assert StorageNemesis(str(dirs[vic])).inject(fault)
            for i in range(20):
                await client.submit(ClusterAdd(key=f"post{i % 5}", delta=i))

            reborn = server_for(
                victim.address, [s.address for s in cluster.servers],
                cluster.registry, storage=_storage(level, dirs[vic]))
            cluster.servers[vic] = reborn
            assert reborn.last_applied > 0  # booted from the snapshot
            await reborn.open()
            deadline = asyncio.get_running_loop().time() + 10
            while True:
                leader = cluster.leader
                if leader is not None and all(
                        s.last_applied >= leader.last_applied
                        for s in cluster.servers) \
                        and leader.commit_index == leader.log.last_index:
                    break
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.02)
            healthy = next(s for s in cluster.servers
                           if s is not reborn and s is not leader)
            ser = Serializer()
            start = max(reborn.log.first_index, healthy.log.first_index)
            a = fingerprint(reborn, ser, start)
            b = fingerprint(healthy, ser, start)
            assert (a["machine"], a["sessions"], a["last_applied"]) == \
                (b["machine"], b["sessions"], b["last_applied"])
            assert await client.submit(ClusterGet(key="post4")) == \
                sum(range(4, 20, 5))
        finally:
            await cluster.close()

    arun(run(), timeout=120)


# ---------------------------------------------------------------------------
# test_health.py: a slow disk grades an fsync spike
# ---------------------------------------------------------------------------


def test_slow_disk_grades_fsync_spike(monkeypatch, tmp_path):
    monkeypatch.setenv("COPYCAT_INVARIANTS", "strict")

    async def run():
        cluster = await create_cluster(
            3, storage_factory=lambda i: Storage(
                StorageLevel.DISK, str(tmp_path / str(i)),
                max_entries_per_segment=32))
        try:
            client = await cluster.client()
            leader = cluster.leader
            for i in range(10):
                await client.submit(ClusterAdd(key=f"w{i}", delta=i))
            baseline_ms = leader.groups[0]._fsync_ewma_ms
            assert baseline_ms > 0.0
            leader.health.tick()
            delay_s = max(0.05, baseline_ms * 10.0 / 1e3)
            slow = SlowDiskNemesis(leader, delay_s=delay_s)
            slow.install()
            try:
                for i in range(3):
                    await client.submit(ClusterAdd(key=f"s{i}", delta=i))
            finally:
                slow.remove()
            assert all(g.log.sync.__name__ == "sync" for g in leader.groups)
            v = leader.health.tick()
            f = v["detectors"]["fsync_spike"]["groups"]["0"]
            assert f["status"] in ("warn", "critical")
            assert "baseline" in f["reason"]
            assert max(f["evidence"]["fsync_max_ms"]) >= delay_s * 1e3
        finally:
            await cluster.close()

    arun(run(), timeout=120)


# ---------------------------------------------------------------------------
# test_profile_surface.py: an event-loop hold named over the wire
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_profiler():
    """A crashed server leaks its refcounted profiler on purpose (SIGKILL
    semantics): start from the unpatched shape."""
    with profiler._ACQUIRE_LOCK:
        leaked, profiler.PROFILER = profiler.PROFILER, None
    if leaked is not None:
        leaked.stop()
    yield


def test_loop_hold_named_in_finding_profile_and_timeline(
        monkeypatch, tmp_path, capsys, fresh_profiler):
    monkeypatch.setenv("COPYCAT_PROFILE_HZ", "97")
    monkeypatch.setenv("COPYCAT_PROFILE_HOLD_MS", "30")
    frame = "nemesis._nemesis_synchronous_hold"

    async def run():
        cluster = await create_cluster(
            3, storage_factory=lambda i: Storage(
                StorageLevel.DISK, str(tmp_path / str(i)),
                max_entries_per_segment=64))
        listeners = []
        try:
            client = await cluster.client()
            await client.submit(ClusterAdd(key="k", delta=1))
            for s in cluster.servers:
                listeners.append(await StatsListener(s, port=0).open())
            addrs = [f"127.0.0.1:{ln.port}" for ln in listeners]
            # 0.3 s holds: the finding names the longest hold in its window,
            # and a slow disk's own writes (the black-box spill) can hold
            # the loop for over 0.1 s on a loaded host
            nemesis = LoopHoldNemesis(cluster.servers[0], delay_s=0.3)
            for _ in range(3):
                nemesis.inject()
                await asyncio.sleep(0.35)
            assert nemesis.injected == 3
            leader = cluster.leader
            leader.health.tick()
            await asyncio.sleep(0.05)
            stall = leader.health.tick()["detectors"]["loop_stall"][
                "groups"]["server"]
            assert stall["status"] in ("warn", "critical")
            assert frame in stall["reason"]
            rc = await asyncio.to_thread(cli._profile, type("A", (), dict(
                addresses=addrs, last=None, top=10, json=True, diff=None,
                device=None))())
            assert rc == 0
            merged = json.loads(capsys.readouterr().out)
            assert merged["incomplete"] is False
            assert len(merged["members"]) == 3
            assert merged["holds"][0]["frame"] == frame
            table = profiler.frame_table(
                [(s["stack"], s["count"]) for s in merged["stacks"]],
                top=10, skip=2)
            assert frame in [r["frame"] for r in table]
            members, failed = await cli.collect_timeline(addrs)
            assert not failed
            timeline = assemble_timeline(members, failed_members=failed,
                                         last_s=60)
            assert any("_nemesis_synchronous_hold" in e["detail"]
                       for e in timeline["events"]
                       if e["kind"] == "loop_stall")
        finally:
            for ln in listeners:
                await ln.close()
            await cluster.close()

    arun(run(), timeout=180)


# ---------------------------------------------------------------------------
# the faults in a device server's flight recorder
# ---------------------------------------------------------------------------


@async_test(timeout=120)
async def test_faults_land_in_the_device_engines_flight_recorder(tmp_path):
    """On a server whose machine runs the device engine with telemetry,
    ``SlowDiskNemesis`` and ``LoopHoldNemesis`` record their faults in the
    engine's flight ring (what ``stats --what flight`` prints); a
    multi-group server's machine is a factory, and there is no hub."""
    addr = Address("local", 7)
    registry = LocalServerRegistry()
    server = AtomixServer(
        addr, [addr], LocalTransport(registry), election_timeout=0.2,
        heartbeat_interval=0.04, session_timeout=10.0, executor="tpu",
        storage=Storage(StorageLevel.DISK, str(tmp_path / "log")),
        engine_config=DeviceEngineConfig(
            capacity=8, num_peers=3, log_slots=16, submit_slots=4,
            resource=ap.ResourceConfig.counters_only(), telemetry=True,
            device="cpu"))
    await server.open()
    client = AtomixClient([addr], LocalTransport(registry),
                          session_timeout=10.0)
    await client.open()
    try:
        counter = await client.get("n", DistributedAtomicLong)
        assert await counter.add_and_get(1) == 1
        slow = SlowDiskNemesis(server.server, delay_s=0.01)
        slow.install()
        try:
            assert await counter.add_and_get(1) == 2
        finally:
            slow.remove()
        hold = LoopHoldNemesis(server.server, delay_s=0.02)
        hold.inject()
        assert await counter.add_and_get(1) == 3
        flight = server.server.state_machine._engine._groups.telemetry.flight
        faults = [(e["fault"], e["delay_s"]) for e in flight.events()
                  if e["kind"] == "fault"]
        assert faults == [("slow_disk", 0.01), ("loop_hold", 0.02)]
        assert "fault=slow_disk" in flight.render_text()
    finally:
        await client.close()
        await server.close()
    registry = LocalServerRegistry()
    multi = server_for(addr, [addr], registry, machine=lambda: (
        lambda g: CounterMachine()), groups=2)
    assert SlowDiskNemesis(multi)._hub() is None
    assert LoopHoldNemesis(multi)._hub() is None


# ---------------------------------------------------------------------------
# a member restarted behind the others must not hold back an election
# ---------------------------------------------------------------------------


def test_stale_restarted_member_does_not_block_an_election(tmp_path):
    """Multi-group members draw rank-banded election timers: a group's
    rank-0 member always times out first. Crash it, commit past it,
    crash the group's leader, and reboot the stale member: its vote
    requests (refused: its log is behind) must not restart the
    up-to-date member's timer, or the stale member campaigns first
    forever and the group never elects (what the compartment nemesis hit
    on the card's host)."""
    from copycat_tpu_torch.server.raft import LEADER

    def factory():
        return lambda g: CounterMachine()

    async def run():
        cluster = await create_cluster(
            3, storage_factory=lambda i: _storage(StorageLevel.DISK,
                                                  tmp_path / str(i)),
            machine=factory, groups=2)
        try:
            client = await cluster.client(session_timeout=30)
            ranked = sorted(cluster.servers,
                            key=lambda s: (s.address.host, s.address.port))
            g = 1
            stale = ranked[g % 3]   # rank 0 for group g
            keys = [k for k in (f"k{i}" for i in range(64))
                    if CounterMachine.route_group(
                        ClusterAdd(key=k, delta=0), 2) == g]
            for k in keys[:4]:
                await client.submit(ClusterAdd(key=k, delta=1))
            await crash_server(stale)
            for k in keys[4:12]:
                await client.submit(ClusterAdd(key=k, delta=1))
            deadline = asyncio.get_running_loop().time() + 10
            while True:
                leader = next((s for s in cluster.servers if s.is_open
                               and s.groups[g].role == LEADER), None)
                if leader is not None:
                    break
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.02)
            survivor = next(s for s in cluster.servers
                            if s is not stale and s is not leader)
            i = cluster.servers.index(stale)
            reborn = server_for(
                stale.address, [s.address for s in cluster.servers],
                cluster.registry, machine=factory, groups=2,
                storage=_storage(StorageLevel.DISK, tmp_path / str(i)))
            cluster.servers[i] = reborn
            # the leader dies as the stale member comes back: both
            # survivors start from the leader's term, and the stale one's
            # timer is the group's fastest
            await crash_server(leader)
            assert reborn.groups[g].log.last_index \
                < survivor.groups[g].log.last_index
            await reborn.open()
            deadline = asyncio.get_running_loop().time() + 8
            while not any(s.groups[g].role == LEADER
                          for s in (reborn, survivor)):
                assert asyncio.get_running_loop().time() < deadline, (
                    "group never elected: terms "
                    f"{reborn.groups[g].term}/{survivor.groups[g].term}")
                await asyncio.sleep(0.05)
            assert survivor.groups[g].role == LEADER
            assert await client.submit(ClusterGet(key=keys[4])) == 1
        finally:
            await cluster.close()

    arun(run(), timeout=90)


def test_restarted_leader_does_not_expire_sessions_it_has_not_applied(
        tmp_path, monkeypatch):
    """A member restarted from its log knows only the sessions it has
    applied. Crash every member and reboot them: the new leader, asked
    about a live session before it has applied its log, must answer as
    a member not yet leader (the client retries), never UNKNOWN_SESSION
    (the client would drop a session the cluster still holds); then the
    client's session goes on serving."""
    from copycat_tpu_torch.protocol import messages as msg
    from copycat_tpu_torch.server import raft_group

    answers = []

    async def run():
        cluster = await create_cluster(
            3, storage_factory=lambda i: _storage(StorageLevel.DISK,
                                                  tmp_path / str(i)))
        try:
            client = await cluster.client(session_timeout=30)
            for _ in range(5):
                await client.submit(ClusterAdd(key="a", delta=1))
            sid = client._session.id
            addrs = [s.address for s in cluster.servers]
            for s in cluster.servers:
                await crash_server(s)
            real = raft_group.RaftGroup._become_leader

            def become_leader(group):
                real(group)

                async def ask():
                    answers.append((group.last_applied, group._term_start,
                                    (await group._on_keepalive(
                                        None, msg.KeepAliveRequest(
                                            session_id=sid, command_seq=0,
                                            event_index=0))).error))
                asyncio.ensure_future(ask())

            monkeypatch.setattr(raft_group.RaftGroup, "_become_leader",
                                become_leader)
            reborn = [server_for(a, addrs, cluster.registry,
                                 storage=_storage(StorageLevel.DISK,
                                                  tmp_path / str(i)))
                      for i, a in enumerate(addrs)]
            assert all(r.last_applied == 0 for r in reborn)
            cluster.servers[:] = reborn
            await asyncio.gather(*(r.open() for r in reborn))
            assert await client.submit(ClusterAdd(key="a", delta=1)) == 6
            assert client._session.is_open
        finally:
            await cluster.close()

    arun(run(), timeout=60)
    applied, term_start, error = answers[0]
    assert applied < term_start
    assert error in (msg.NOT_LEADER, msg.NO_LEADER)
