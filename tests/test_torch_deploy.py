"""The port's deployment plane (``copycat_tpu_torch/deploy/``), its
counter machine and its packaged server, on the port's own stack.

- Differential, exact: ``TopologySpec.local`` of both packages on the
  same ports renders the same argv once ``copycat_tpu`` reads
  ``copycat_tpu_torch`` (and the port's never names the reference's
  package); ``ClusterAdd``/``ClusterGet`` serialize to the same bytes in
  both packages, and each decodes the other's frames into its own
  classes.
- Port copies of the reference's oracle scripts: every case of
  ``test_deploy.py``, ``test_standalone_server.py`` and
  ``test_cluster_processes.py`` (those two as one case: three packaged
  servers in their own interpreters), and a small ``compartment`` run
  (``bench.run_compartment``) that loses no acknowledged write.

Four tests spawn OS processes: the supervisor's two, the packaged
servers and the compartment run.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import tempfile

import pytest

pytest.importorskip("torch")

from copycat_tpu.deploy import topology as ref_topology  # noqa: E402
from copycat_tpu.io.serializer import Serializer as RefSerializer  # noqa: E402
from copycat_tpu.testing import counter_machine as ref_counter  # noqa: E402
from copycat_tpu_torch.atomic import (  # noqa: E402
    DistributedAtomicLong,
    DistributedAtomicValue,
)
from copycat_tpu_torch.client.client import (  # noqa: E402
    PinnedConnectionStrategy,
    RaftClient,
)
from copycat_tpu_torch.deploy import topology  # noqa: E402
from copycat_tpu_torch.deploy.ingress import IngressServer  # noqa: E402
from copycat_tpu_torch.deploy.supervisor import (  # noqa: E402
    CONFIG_ERROR,
    RUNNING,
    Supervisor,
)
from copycat_tpu_torch.deploy.topology import (  # noqa: E402
    TopologySpec,
    allocate_ports,
    load_machine,
)
from copycat_tpu_torch.io.local import (  # noqa: E402
    LocalServerRegistry,
    LocalTransport,
)
from copycat_tpu_torch.io.serializer import (  # noqa: E402
    Serializer,
    serialize_with,
)
from copycat_tpu_torch.io.tcp import TcpTransport  # noqa: E402
from copycat_tpu_torch.io.transport import Address, TransportError  # noqa: E402
from copycat_tpu_torch.manager.atomix import AtomixClient  # noqa: E402
from copycat_tpu_torch.protocol import messages as msg  # noqa: E402
from copycat_tpu_torch.protocol.messages import Message  # noqa: E402
from copycat_tpu_torch.protocol.operations import Command  # noqa: E402
from copycat_tpu_torch.server.raft import LEADER, RaftServer  # noqa: E402
from copycat_tpu_torch.testing.counter_machine import (  # noqa: E402
    ClusterAdd,
    ClusterGet,
    CounterMachine,
)

from helpers import async_test  # noqa: E402
from torch_reference import (  # noqa: E402,F401
    no_leaked_profiler,
    release_jax_programs,
)

MACHINE_SPEC = "copycat_tpu_torch.testing.counter_machine:counter_machine"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _release(release_jax_programs):
    yield


@serialize_with(951)
class Poke(Message, Command):
    """Publishes a session event from the owning group's apply."""

    _fields = ("key", "payload")


class PokeCounterMachine(CounterMachine):
    def configure(self, executor) -> None:
        super().configure(executor)
        executor.register(Poke, self.poke)

    def poke(self, commit) -> str:
        commit.session.publish("poked", commit.operation.payload)
        commit.clean()
        return "poked"


# ---------------------------------------------------------------------------
# the differentials: topology argv and counter-machine frames
# ---------------------------------------------------------------------------


def _spec_pair(monkeypatch, tmp_path, **kw):
    """Both packages' ``TopologySpec.local`` on the same ports and base
    directory."""
    ports = allocate_ports(2 * (kw.get("members", 3)
                                + kw.get("ingresses", 1)))
    monkeypatch.setattr(topology, "allocate_ports", lambda n, h: ports)
    monkeypatch.setattr(ref_topology, "allocate_ports", lambda n, h: ports)
    base = str(tmp_path / "topology")
    machine = kw.pop("machine", None)
    port = TopologySpec.local(base_dir=base, machine=machine, **kw)
    ref = ref_topology.TopologySpec.local(
        base_dir=base, machine=machine and machine.replace(
            "copycat_tpu_torch.", "copycat_tpu."), **kw)
    return port, ref


def _renamed(text: str) -> str:
    return text.replace("copycat_tpu.", "copycat_tpu_torch.")


@pytest.mark.parametrize("shape", [
    dict(members=3, ingresses=1, groups=1),
    dict(members=3, ingresses=2, groups=4, storage="mapped",
         machine=MACHINE_SPEC),
    dict(members=1, ingresses=0, storage="memory", machine=MACHINE_SPEC),
    dict(members=5, ingresses=4, groups=2, control_port=4_321),
], ids=["default", "tier2-groups4", "one-member", "wide"])
def test_topology_argv_equals_the_reference_after_the_rename(
        shape, monkeypatch, tmp_path):
    port, ref = _spec_pair(monkeypatch, tmp_path, **dict(shape))
    assert len(port.children()) == len(ref.children())
    for mine, theirs in zip(port.children(), ref.children()):
        assert mine.argv() == [_renamed(a) for a in theirs.argv()]
        # the port spawns its own child, never the reference's
        assert mine.argv()[2] == "copycat_tpu_torch.deploy.child"
        assert not any(a.startswith("copycat_tpu.") or ":copycat_tpu."
                       in a for a in mine.argv())
    assert port.to_json() == _renamed(ref.to_json())
    assert port.stats_addrs() == ref.stats_addrs()
    assert port.client_addrs() == ref.client_addrs()


FRAMES = [("k", 1), ("user:123456", -7), ("ключ", 2 ** 40), ("", 0)]


@pytest.mark.parametrize("key,delta", FRAMES)
def test_counter_frames_equal_the_reference(key, delta):
    """Serializer ids 940/941 bind to each package's own classes: the same
    bytes on the wire, and each package decodes the other's frames into
    its own types."""
    for cls, ref_cls, kw in (
            (ClusterAdd, ref_counter.ClusterAdd, dict(key=key, delta=delta)),
            (ClusterGet, ref_counter.ClusterGet, dict(key=key))):
        wire = Serializer().write(cls(**kw))
        ref_wire = RefSerializer().write(ref_cls(**kw))
        assert wire == ref_wire
        got, ref_got = Serializer().read(ref_wire), RefSerializer().read(wire)
        assert type(got) is cls and type(ref_got) is ref_cls
        assert all(getattr(got, f) == v == getattr(ref_got, f)
                   for f, v in kw.items())


def test_counter_machine_routes_as_the_reference():
    keys = [f"user:{i}" for i in range(64)] + ["", "ключ"]
    for groups in (1, 2, 4, 7):
        assert [CounterMachine.route_group(ClusterAdd(key=k, delta=0),
                                           groups) for k in keys] == \
            [ref_counter.CounterMachine.route_group(
                ref_counter.ClusterAdd(key=k, delta=0), groups)
             for k in keys]


# ---------------------------------------------------------------------------
# topology specs (test_deploy.py, pure units)
# ---------------------------------------------------------------------------


def test_allocate_ports_unique_and_bindable():
    ports = allocate_ports(20)
    assert len(set(ports)) == 20
    s = socket.socket()
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", ports[0]))
    finally:
        s.close()


def test_topology_spec_local_shape():
    spec = TopologySpec.local(members=3, ingresses=2, groups=4,
                              storage="mapped", machine=MACHINE_SPEC)
    assert [m.name for m in spec.members] == \
        ["member-0", "member-1", "member-2"]
    assert [i.name for i in spec.ingresses] == ["ingress-0", "ingress-1"]
    ports = [m.address.rsplit(":", 1)[1] for m in spec.members]
    ports += [str(m.stats_port) for m in spec.members]
    ports += [i.address.rsplit(":", 1)[1] for i in spec.ingresses]
    ports += [str(i.stats_port) for i in spec.ingresses]
    assert len(set(ports)) == len(ports)
    assert spec.client_addrs() == spec.ingress_addrs()
    bare = TopologySpec.local(members=3, ingresses=0)
    assert bare.client_addrs() == bare.member_addrs()
    dirs = {m.log_dir for m in spec.members}
    assert len(dirs) == 3
    assert all(d.startswith(spec.base_dir) for d in dirs)
    assert set(spec.stats_addrs()) == {
        "member-0", "member-1", "member-2", "ingress-0", "ingress-1"}
    again = TopologySpec.from_json(spec.to_json())
    assert again.to_json() == spec.to_json()


def test_member_and_ingress_argv_shape():
    spec = TopologySpec.local(members=2, ingresses=1, groups=2,
                              machine=MACHINE_SPEC)
    argv = spec.members[0].argv()
    assert argv[2:4] == ["copycat_tpu_torch.deploy.child", "member"]
    assert spec.members[0].address in argv
    assert argv.count(spec.members[0].address) == 1
    assert "--machine" in argv
    iargv = spec.ingresses[0].argv()
    assert iargv[2:4] == ["copycat_tpu_torch.deploy.child", "ingress"]
    assert ",".join(spec.member_addrs()) in iargv


def test_load_machine_contract():
    assert load_machine(None) is None
    assert load_machine("") is None
    fn = load_machine(MACHINE_SPEC)
    assert isinstance(fn(0), CounterMachine)
    with pytest.raises(ValueError, match="expected module.path:factory"):
        load_machine("no-colon")
    with pytest.raises(ValueError, match="no attribute"):
        load_machine("copycat_tpu_torch.testing.counter_machine:missing")
    with pytest.raises(ImportError):
        load_machine("copycat_tpu_torch.not_a_module:thing")


# ---------------------------------------------------------------------------
# the standalone ingress tier, in-process (local transport)
# ---------------------------------------------------------------------------


async def _local_cluster(groups: int, machine_cls=CounterMachine,
                         n: int = 3):
    registry = LocalServerRegistry()
    addrs = [Address("local", p) for p in
             range(18500 + groups * 10, 18500 + groups * 10 + n)]
    servers = [
        RaftServer(addr, addrs,
                   LocalTransport(registry, local_address=addr),
                   (lambda g: machine_cls()), groups=groups,
                   election_timeout=0.2, heartbeat_interval=0.04,
                   session_timeout=30.0)
        for addr in addrs]
    await asyncio.gather(*(s.open() for s in servers))
    deadline = asyncio.get_running_loop().time() + 15
    while asyncio.get_running_loop().time() < deadline:
        led = {g.group_id for s in servers for g in s.groups
               if g.role == LEADER}
        if len(led) == groups:
            return registry, servers
        await asyncio.sleep(0.02)
    raise TimeoutError("not every group elected a leader")


async def _ingress_tier(registry, servers, groups: int, width: int = 1,
                        machine_cls=CounterMachine, base_port: int = 18900):
    tier_addrs = [Address("local", base_port + i) for i in range(width)]
    ingresses = [
        IngressServer(addr, [s.address for s in servers],
                      LocalTransport(registry, local_address=addr),
                      groups=groups, tier=tier_addrs,
                      route_machine=machine_cls,
                      session_timeout=30.0, election_timeout=0.2,
                      name=f"ingress-{i}")
        for i, addr in enumerate(tier_addrs)]
    await asyncio.gather(*(i.open() for i in ingresses))
    return ingresses


async def _close_all(*nodes) -> None:
    for node in nodes:
        try:
            await asyncio.wait_for(node.close(), 10)
        except (Exception, asyncio.TimeoutError):
            pass


@async_test(timeout=120)
async def test_ingress_routes_commands_and_reads_exactly_once():
    registry, servers = await _local_cluster(groups=4)
    ingresses = await _ingress_tier(registry, servers, groups=4, width=1)
    client = RaftClient([ingresses[0].address], LocalTransport(registry),
                        session_timeout=30.0)
    try:
        await client.open()
        keys = [f"key-{i}" for i in range(24)]
        for rep in range(2):
            out = await asyncio.gather(*(
                client.submit(ClusterAdd(key=k, delta=1)) for k in keys))
            assert out == [rep + 1] * len(keys), out
        got = await asyncio.gather(*(client.submit(ClusterGet(key=k))
                                     for k in keys))
        assert got == [2] * len(keys), got
        assert set(client.members) == {ingresses[0].address}
        forwarded = ingresses[0].metrics.counter(
            "ingress.commands_forwarded").value
        assert forwarded == 2 * len(keys)
        for s in servers:
            merged: dict = {}
            for g in s.groups:
                merged.update(g.state_machine.data)
            for k in keys:
                assert merged.get(k) == 2, (str(s.address), k)
    finally:
        await _close_all(client, *ingresses, *servers)


@async_test(timeout=120)
async def test_ingress_relays_session_events():
    registry, servers = await _local_cluster(
        groups=2, machine_cls=PokeCounterMachine)
    ingresses = await _ingress_tier(registry, servers, groups=2, width=1,
                                    machine_cls=PokeCounterMachine)
    client = RaftClient([ingresses[0].address], LocalTransport(registry),
                        session_timeout=30.0)
    try:
        await client.open()
        got: list = []
        client.session().on_event("poked", got.append)
        keys = []
        g_seen = set()
        i = 0
        while len(g_seen) < 2:
            k = f"evt{i}"
            g = CounterMachine.route_group(ClusterAdd(key=k, delta=0), 2)
            if g not in g_seen:
                g_seen.add(g)
                keys.append(k)
            i += 1
        for k in keys:
            assert await client.submit(Poke(key=k, payload=k)) == "poked"
        deadline = asyncio.get_running_loop().time() + 10
        while asyncio.get_running_loop().time() < deadline \
                and len(got) < 2:
            await asyncio.sleep(0.02)
        assert sorted(got) == sorted(keys), got
        assert ingresses[0].metrics.counter(
            "ingress.events_relayed").value >= 2
    finally:
        await _close_all(client, *ingresses, *servers)


@async_test(timeout=180)
async def test_ingress_failover_midbatch_exactly_once():
    registry, servers = await _local_cluster(groups=2)
    ingresses = await _ingress_tier(registry, servers, groups=2, width=2)
    client = RaftClient([i.address for i in ingresses],
                        LocalTransport(registry), session_timeout=30.0,
                        connection_strategy=PinnedConnectionStrategy(
                            ingresses[0].address))
    try:
        await client.open()
        assert client._connected_to == ingresses[0].address
        keys = [f"fk{i}" for i in range(120)]
        futs = {k: client.submit_command_nowait(ClusterAdd(key=k, delta=1))
                for k in keys}
        await asyncio.sleep(0)
        await ingresses[0].close()
        acked: dict[str, int] = {}
        indet: dict[str, int] = {}
        for k, fut in futs.items():
            try:
                await asyncio.wait_for(fut, 30)
                acked[k] = 1
            except asyncio.TimeoutError:
                indet[k] = 1
            except msg.ProtocolError as e:
                assert e.code in (msg.NO_LEADER, msg.NOT_LEADER), e.code
                indet[k] = 1
        follow_up = await client.submit(ClusterAdd(key="after", delta=1))
        assert follow_up == 1
        assert client._connected_to == ingresses[1].address
        for k in keys:
            v = await client.submit(ClusterGet(key=k))
            lo = acked.get(k, 0)
            hi = lo + indet.get(k, 0)
            assert lo <= v <= hi, (k, v, lo, hi)
        assert acked, "kill window swallowed the whole batch"
    finally:
        await _close_all(client, *ingresses, *servers)


# ---------------------------------------------------------------------------
# COPYCAT_INGRESS_TIER=0: the in-server ingress plane, pinned
# ---------------------------------------------------------------------------


@async_test(timeout=60)
async def test_ingress_tier_knob_off_single_group_has_no_proxy_handler(
        monkeypatch):
    monkeypatch.setenv("COPYCAT_INGRESS_TIER", "0")
    registry, servers = await _local_cluster(groups=1)
    transport = LocalTransport(registry)
    try:
        conn = await transport.client().connect(servers[0].address)
        with pytest.raises(TransportError, match="no handler"):
            await conn.send(msg.ProxyRequest(
                group=None, kind="ingress:register",
                payload=("cid", 5.0, None)))
    finally:
        await _close_all(*servers)


@async_test(timeout=60)
async def test_ingress_tier_knob_off_multi_group_refuses(monkeypatch):
    monkeypatch.setenv("COPYCAT_INGRESS_TIER", "0")
    registry, servers = await _local_cluster(groups=2)
    transport = LocalTransport(registry)
    try:
        conn = await transport.client().connect(servers[0].address)
        response = await conn.send(msg.ProxyRequest(
            group=0, kind="ingress:register", payload=("cid", 5.0, None)))
        assert response.error == msg.INTERNAL
        assert "ingress tier disabled" in response.error_detail
    finally:
        await _close_all(*servers)


@async_test(timeout=60)
async def test_ingress_tier_knob_off_in_server_path_unchanged(monkeypatch):
    monkeypatch.setenv("COPYCAT_INGRESS_TIER", "0")
    registry, servers = await _local_cluster(groups=2)
    client = RaftClient([s.address for s in servers],
                        LocalTransport(registry), session_timeout=30.0)
    try:
        await client.open()
        for rep in range(2):
            out = await asyncio.gather(*(
                client.submit(ClusterAdd(key=f"d{i}", delta=1))
                for i in range(8)))
            assert out == [rep + 1] * 8, out
    finally:
        await _close_all(client, *servers)


# ---------------------------------------------------------------------------
# the supervisor against real OS processes
# ---------------------------------------------------------------------------


@async_test(timeout=600)
async def test_supervisor_restarts_sigkilled_children_and_clients_survive(
        tmp_path):
    """SIGKILL the ingress proxy a client is pinned to AND a Raft member;
    zero lost acknowledged writes, both corpses restarted. Disk storage:
    a MEMORY member restarts blank and could elect a leader missing an
    acked entry."""
    spec = TopologySpec.local(members=3, ingresses=2, groups=1,
                              storage="disk", machine=MACHINE_SPEC,
                              base_dir=str(tmp_path))
    sup = Supervisor(spec)
    await sup.open()
    client = None
    try:
        await sup.wait_healthy(timeout=240)
        addrs = [Address.parse(a) for a in spec.client_addrs()]
        client = RaftClient(addrs, TcpTransport(), session_timeout=60.0,
                            connection_strategy=PinnedConnectionStrategy(
                                addrs[0]))
        await client.open()
        acked = 0
        for _ in range(5):
            await client.submit(ClusterAdd(key="n", delta=1))
            acked += 1

        futs = [client.submit_command_nowait(ClusterAdd(key="n", delta=1))
                for _ in range(40)]
        await asyncio.sleep(0)
        ok, detail = sup.kill("ingress-0")
        assert ok, detail
        indet = 0
        for fut in futs:
            try:
                await asyncio.wait_for(fut, 60)
                acked += 1
            except asyncio.TimeoutError:
                indet += 1
            except msg.ProtocolError as e:
                assert e.code in (msg.NO_LEADER, msg.NOT_LEADER), e.code
                indet += 1

        ok, detail = sup.kill("member-1")
        assert ok, detail
        await client.submit(ClusterAdd(key="n", delta=1))
        acked += 1

        v = await client.submit(ClusterGet(key="n"))
        assert acked <= v <= acked + indet, (v, acked, indet)

        deadline = asyncio.get_running_loop().time() + 90
        while asyncio.get_running_loop().time() < deadline:
            children = sup.status()["children"]
            if all(children[n]["state"] == RUNNING and children[n]["pid"]
                   and children[n]["restarts"] >= 1
                   for n in ("ingress-0", "member-1")):
                break
            await asyncio.sleep(0.25)
        children = sup.status()["children"]
        for name in ("ingress-0", "member-1"):
            assert children[name]["state"] == RUNNING, children[name]
            assert children[name]["restarts"] >= 1, children[name]
        # the children are the port's: no reference module on any argv
        assert all(c.argv()[2] == "copycat_tpu_torch.deploy.child"
                   for c in spec.children())
    finally:
        if client is not None:
            await _close_all(client)
        await sup.close()


@async_test(timeout=300)
async def test_supervisor_config_error_is_terminal(tmp_path):
    """Exit code 2 (a port that can never bind) is a CONFIG error: the
    supervisor surfaces it and never crash-loops the child."""
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    spec = TopologySpec.local(members=1, ingresses=0, storage="memory",
                              machine=MACHINE_SPEC, base_dir=str(tmp_path))
    spec.members[0].address = f"127.0.0.1:{port}"
    spec.members[0].peers = [f"127.0.0.1:{port}"]
    sup = Supervisor(spec)
    await sup.open()
    try:
        child = sup._children["member-0"]
        deadline = asyncio.get_running_loop().time() + 240
        while child.state != CONFIG_ERROR:
            assert asyncio.get_running_loop().time() < deadline, child.state
            await asyncio.sleep(0.2)
        assert child.last_exit == 2
        assert child.restarts == 0
        assert sup.healthz_info()["ok"] is False
    finally:
        await sup.close()
        blocker.close()


@async_test(timeout=60)
async def test_deploy_tier_healthz_identity_and_series_route():
    from copycat_tpu_torch.deploy.supervisor import ControlListener
    from copycat_tpu_torch.server.stats import StatsListener, fetch_stats

    registry, servers = await _local_cluster(groups=1)
    ingresses = await _ingress_tier(registry, servers, groups=1)
    spec = TopologySpec.local(members=1, ingresses=0, storage="memory",
                              machine=MACHINE_SPEC)
    sup = Supervisor(spec)  # never opened: no children, just the surface
    listeners = [await StatsListener(ingresses[0], port=0).open(),
                 await ControlListener(sup, port=0).open()]
    try:
        roles = set()
        for ln in listeners:
            hz = json.loads(await fetch_stats(
                f"127.0.0.1:{ln.port}", "/healthz"))
            assert hz["uptime_s"] >= 0.0
            assert "git_sha" in hz
            series = json.loads(await fetch_stats(
                f"127.0.0.1:{ln.port}", "/series"))
            assert series["window"] >= 2
            roles.add(series["role"])
        assert roles == {"ingress", "supervisor"}
    finally:
        for ln in listeners:
            await ln.close()
        await _close_all(*ingresses, *servers)


# ---------------------------------------------------------------------------
# the packaged server in its own interpreters
# (test_standalone_server.py + test_cluster_processes.py)
# ---------------------------------------------------------------------------


@async_test(timeout=300)
async def test_packaged_servers_serve_remote_clients_and_survive_a_kill():
    """Three ``python -m copycat_tpu_torch.cli serve`` processes (fresh
    interpreters, fresh serializer registries): a remote client over TCP
    sets and reads a ``DistributedAtomicValue`` (the server must register
    the resource catalog to decode it) and counts a
    ``DistributedAtomicLong``; one server process is SIGKILLed and the
    count goes on through the failover."""
    addrs = [f"127.0.0.1:{p}" for p in allocate_ports(3)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    logs = [tempfile.NamedTemporaryFile("w+b", suffix=f".{i}.log")
            for i in range(3)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "copycat_tpu_torch.cli", "serve",
         addrs[i], *[a for j, a in enumerate(addrs) if j != i]],
        env=env, stdout=logs[i], stderr=subprocess.STDOUT)
        for i in range(3)]
    try:
        client = (AtomixClient.builder([Address.parse(a) for a in addrs])
                  .with_transport(TcpTransport()).build())
        for _ in range(60):
            try:
                await asyncio.wait_for(client.open(), 15)
                break
            except Exception:
                if all(p.poll() is not None for p in procs):
                    logs[0].seek(0)
                    pytest.fail("all servers died: " + logs[0].read()
                                .decode(errors="replace")[-600:])
                await asyncio.sleep(1)
        else:
            pytest.fail("client never connected to the cluster")

        value = await client.get("value", DistributedAtomicValue)
        await value.set("hello")
        assert await value.get() == "hello"
        counter = await client.get("hits", DistributedAtomicLong)
        for want in range(1, 6):
            assert await asyncio.wait_for(
                counter.increment_and_get(), 30) == want

        procs[0].kill()
        procs[0].wait(timeout=10)
        deadline = asyncio.get_running_loop().time() + 90
        want = 6
        while want <= 10:
            try:
                got = await asyncio.wait_for(
                    counter.increment_and_get(), 20)
                assert got == want, (got, want)
                want += 1
            except AssertionError:
                raise
            except Exception:
                if asyncio.get_running_loop().time() > deadline:
                    raise
                await asyncio.sleep(1)  # the failover window: retry
        await client.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        for f in logs:
            f.close()


# ---------------------------------------------------------------------------
# the bench's compartment scenario, cut small
# ---------------------------------------------------------------------------


def test_compartment_loses_no_acknowledged_write(monkeypatch, tmp_path):
    """``run_compartment`` at tier 1, 2 clients × 50 ops, one burst,
    memory storage, no nemesis: a supervised topology of OS processes
    whose read-back finds every acknowledged write (and no duplicate)."""
    from copycat_tpu_torch import bench

    for knob, value in (("TIERS", "1"), ("CLIENTS", "2"), ("OPS", "50"),
                        ("BURSTS", "1"), ("STORAGE", "memory"),
                        ("NEMESIS", "0")):
        monkeypatch.setenv(f"COPYCAT_BENCH_COMPARTMENT_{knob}", value)
    monkeypatch.setenv("TMPDIR", str(tmp_path))  # the topology's base dir
    bench.METRICS_SNAPSHOTS.clear()
    out = bench.run_compartment()
    assert out["lost_acked_writes"] == 0
    (width,) = out["widths"]
    assert width["width"] == 1 and width["lost_acked_writes"] == 0
    assert width["acked_ops"] + width["indeterminate_ops"] == 100
    assert out["metric"] == "compartment_committed_ops_per_sec_3_members" \
                            "_4_groups"
    assert "vs_baseline" not in out and "nemesis" not in out
    attribution = bench.METRICS_SNAPSHOTS["compartment"]["1"]["ingress-0"]
    assert attribution["ingress.commands_forwarded"] >= 100
