"""The port's own server stack: ``copycat_tpu_torch``'s ``AtomixServer(...,
executor="tpu")``, ``AtomixClient`` and ``LocalTransport``, with the device
engine on the CPU (``DeviceEngineConfig(device="cpu")``).

Port copies of the reference's server-level oracle scripts, with their
asserted answers: ``test_executor_parity.py`` (both executors, every
case), ``test_device_window.py`` (SPI batching, TTL under a window),
``test_device_window_interleave.py``, ``test_spi_vector_pump.py``,
``test_spi_read_pump.py`` and ``test_device_recovery.py``. No object of
``copycat_tpu`` takes part in them.

Each script's engine provisions the pools that script touches, at the
reference's sizes (the pools it does not touch are compiled out): the
placement rule (``device_machine_for``) and every overflow threshold are
the reference's, and a round costs the CPU less.

Then the differential: one seeded random script over longs, values with
CAS, maps, sets, queues, a lock hand-off and an election succession goes
from one client, one op in flight, through the reference's single-server
``AtomixServer(executor="tpu")`` and through the port's; every answer and
every event must be equal.
"""

import asyncio
import itertools
import random
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from copycat_tpu_torch.atomic import (  # noqa: E402
    DistributedAtomicLong,
    DistributedAtomicValue,
)
from copycat_tpu_torch.collections import (  # noqa: E402
    DistributedMap,
    DistributedMultiMap,
    DistributedQueue,
    DistributedSet,
)
from copycat_tpu_torch.coordination import (  # noqa: E402
    DistributedLeaderElection,
    DistributedLock,
)
from copycat_tpu_torch.io.local import (  # noqa: E402
    LocalServerRegistry,
    LocalTransport,
    NetworkNemesis,
)
from copycat_tpu_torch.io.transport import Address  # noqa: E402
from copycat_tpu_torch.manager.atomix import (  # noqa: E402
    AtomixClient,
    AtomixServer,
)
from copycat_tpu_torch.manager.device_executor import (  # noqa: E402
    DeviceEngineConfig,
)
from copycat_tpu_torch.models import BulkSessionClient, RaftGroups  # noqa: E402
from copycat_tpu_torch.models.session_client import (  # noqa: E402
    CommandIndeterminateError,
)
from copycat_tpu_torch.ops import apply as ap  # noqa: E402
from copycat_tpu_torch.ops.consensus import Config  # noqa: E402
from copycat_tpu_torch.resource.consistency import Consistency  # noqa: E402
from copycat_tpu_torch.server.log import Storage, StorageLevel  # noqa: E402

from helpers import async_test  # noqa: E402
from torch_reference import release_jax_programs  # noqa: E402,F401

EXECUTORS = ("cpu", "tpu")
_PORTS = itertools.count(52_000)
_POOLS = ("map_slots", "set_slots", "queue_slots", "wait_slots",
          "listener_slots", "event_slots", "multimap_slots", "topic_slots")


def next_ports(n):
    return [Address("local", next(_PORTS)) for _ in range(n)]


def pools(*names):
    """The reference's pool sizes for ``names``, every other pool out."""
    full = ap.ResourceConfig()
    return ap.ResourceConfig(**{p: getattr(full, p) if p in names else 0
                                for p in _POOLS})


def engine(capacity, *names, **kw):
    return DeviceEngineConfig(capacity=capacity, num_peers=3, log_slots=32,
                              resource=pools(*names), device="cpu", **kw)


VALUES = engine(8)
MAPS = engine(8, "map_slots")
LOCKS = engine(8, "wait_slots", "event_slots")
ELECTIONS = engine(8, "listener_slots", "event_slots")


async def _cluster(executor, config, n=3, n_clients=1):
    registry = LocalServerRegistry()
    addrs = next_ports(n)
    servers = [
        AtomixServer(a, addrs, LocalTransport(registry),
                     election_timeout=0.2, heartbeat_interval=0.04,
                     session_timeout=10.0, executor=executor,
                     engine_config=config)
        for a in addrs
    ]
    await asyncio.gather(*(s.open() for s in servers))
    clients = []
    for _ in range(n_clients):
        client = AtomixClient(addrs, LocalTransport(registry),
                              session_timeout=10.0)
        await client.open()
        clients.append(client)
    return servers, clients


async def _teardown(nodes):
    for node in nodes:
        try:
            await asyncio.wait_for(node.close(), 5)
        except (Exception, asyncio.TimeoutError):
            pass


def _device_kinds(server):
    return sorted(type(h.state_machine).__name__
                  for h in server.server.state_machine.resources.values())


# -- test_executor_parity.py --------------------------------------------------


async def _value_and_long(client):
    value = await client.get("val", DistributedAtomicValue)
    assert await value.get() is None
    await value.set(41)
    assert await value.get() == 41
    assert await value.compare_and_set(41, 42)
    assert not await value.compare_and_set(41, 43)
    assert await value.get_and_set(7) == 42
    await value.set("a string")
    assert await value.get() == "a string"
    assert await value.compare_and_set("a string", 99)
    assert await value.get() == 99
    await value.set(None)
    assert await value.get() is None
    counter = await client.get("ctr", DistributedAtomicLong)
    assert await counter.increment_and_get() == 1
    assert await counter.add_and_get(9) == 10
    assert await counter.get_and_add(5) == 10
    assert await counter.get() == 15
    assert await counter.decrement_and_get() == 14
    return ["DeviceAtomicValueState"] * 2


async def _map_overflow(client):
    m = await client.get("m", DistributedMap)
    n = 40
    for k in range(n):
        assert await m.put(k, k * 10) is None
    assert await m.size() == n
    for k in range(n):
        assert await m.get(k) == k * 10
    await m.put("skey", [1, 2, 3])
    assert await m.get("skey") == [1, 2, 3]
    assert await m.put(5, "now a string") == 50
    assert await m.get(5) == "now a string"
    assert await m.contains_value("now a string")
    assert await m.contains_value(70)
    assert not await m.contains_value(50)
    assert await m.put_if_absent(5, 1) == "now a string"
    assert await m.replace_if_present(5, "now a string", 500)
    assert await m.get(5) == 500
    assert await m.remove(5) == 500
    assert await m.get(5) is None
    assert await m.remove_if_present(7, 70)
    assert await m.size() == n - 1
    await m.clear()
    assert await m.is_empty()
    return ["DeviceMapState"]


async def _set_and_queue(client):
    s = await client.get("s", DistributedSet)
    for v in range(30):
        assert await s.add(v)
    assert not await s.add(3)
    assert await s.size() == 30
    assert await s.contains(29)
    assert await s.remove(29)
    assert not await s.contains(29)
    assert await s.add("str-member")
    assert await s.contains("str-member")
    assert await s.size() == 30
    q = await client.get("q", DistributedQueue)
    for v in range(25):
        assert await q.offer(v)
    await q.offer("tail-str")
    assert await q.size() == 26
    assert await q.peek() == 0
    for v in range(25):
        assert await q.poll() == v
    assert await q.poll() == "tail-str"
    assert await q.poll() is None
    for v in (1, 2, 3, 4):
        await q.offer(v)
    assert await q.remove(3) is True
    assert await q.contains(2)
    assert not await q.contains(3)
    assert [await q.poll() for _ in range(3)] == [1, 2, 4]
    return ["DeviceQueueState", "DeviceSetState"]


async def _multimap(client):
    mm = await client.get("mm", DistributedMultiMap)
    for k in range(5):
        for v in range(5):
            assert await mm.put(k, v * 10)
    assert not await mm.put(0, 0)
    assert await mm.size() == 25
    assert await mm.size(2) == 5
    assert sorted(await mm.get(3)) == [0, 10, 20, 30, 40]
    assert await mm.put("sk", "sv")
    assert await mm.contains_entry("sk", "sv")
    assert await mm.contains_value("sv")
    assert await mm.remove(1, 10)
    assert not await mm.contains_entry(1, 10)
    removed = await mm.remove(4)
    assert sorted(removed) == [0, 10, 20, 30, 40]
    assert not await mm.contains_key(4)
    assert await mm.size() == 20
    await mm.clear()
    assert await mm.is_empty()
    return ["DeviceMultiMapState"]


PARITY = {
    "value_and_long": (_value_and_long, VALUES),
    "map_overflow_and_mixed_payloads": (_map_overflow, MAPS),
    "set_and_queue_overflow": (_set_and_queue,
                               engine(8, "set_slots", "queue_slots")),
    "multimap_overflow_and_mixed_payloads": (
        _multimap, engine(8, "multimap_slots")),
}


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("script", list(PARITY))
@async_test(timeout=180)
async def test_parity_script(script, executor):
    """The reference's parity scripts, one client, three servers; on the
    device executor every resource is a device machine."""
    run, config = PARITY[script]
    servers, (client,) = await _cluster(executor, config)
    try:
        kinds = await run(client)
        if executor == "tpu":
            for s in servers:
                assert _device_kinds(s) == kinds
    finally:
        await _teardown([client] + servers)


@pytest.mark.parametrize("executor", EXECUTORS)
@async_test(timeout=180)
async def test_lock_contention_and_session_release(executor):
    servers, (c1, c2) = await _cluster(executor, LOCKS, n_clients=2)
    try:
        l1 = await c1.get("lk", DistributedLock)
        l2 = await c2.get("lk", DistributedLock)
        await l1.lock()
        assert not await l2.try_lock()
        waiter = asyncio.ensure_future(l2.lock())
        await asyncio.sleep(0.3)
        assert not waiter.done()
        await l1.unlock()
        await asyncio.wait_for(waiter, 15)
        await l2.unlock()
        await l1.lock()
        waiter2 = asyncio.ensure_future(l2.lock())
        await asyncio.sleep(0.3)
        await c1.close()
        await asyncio.wait_for(waiter2, 15)
        await l2.unlock()
        if executor == "tpu":
            assert _device_kinds(servers[0]) == ["DeviceLockState"]
    finally:
        await _teardown([c1, c2] + servers)


@pytest.mark.parametrize("executor", EXECUTORS)
@async_test(timeout=180)
async def test_election_succession_and_fencing(executor):
    servers, (c1, c2) = await _cluster(executor, ELECTIONS, n_clients=2)
    try:
        e1 = await c1.get("el", DistributedLeaderElection)
        e2 = await c2.get("el", DistributedLeaderElection)
        epochs1: list[int] = []
        epochs2: list[int] = []
        await e1.on_election(epochs1.append)
        await e2.on_election(epochs2.append)
        for _ in range(100):
            if epochs1:
                break
            await asyncio.sleep(0.05)
        assert epochs1, "first listener was not elected"
        assert await e1.is_leader(epochs1[0])
        assert not await e1.is_leader(epochs1[0] + 999)
        await c1.close()
        for _ in range(200):
            if epochs2:
                break
            await asyncio.sleep(0.05)
        assert epochs2, "successor was not promoted"
        assert await e2.is_leader(epochs2[0])
        assert not await e2.is_leader(epochs1[0])
        if executor == "tpu":
            assert _device_kinds(servers[0]) == ["DeviceLeaderElectionState"]
    finally:
        await _teardown([c1, c2] + servers)


@async_test(timeout=300)
async def test_differential_map_sequences():
    rng = random.Random(1234)
    script = [(rng.choice(["put", "get", "remove", "pia", "rip", "size"]),
               rng.randrange(24), rng.randrange(100)) for _ in range(60)]

    async def run(executor):
        servers, (client,) = await _cluster(executor, MAPS)
        try:
            m = await client.get("diff", DistributedMap)
            out = []
            for op, k, v in script:
                if op == "put":
                    out.append(await m.put(k, v))
                elif op == "get":
                    out.append(await m.get(k))
                elif op == "remove":
                    out.append(await m.remove(k))
                elif op == "pia":
                    out.append(await m.put_if_absent(k, v))
                elif op == "rip":
                    out.append(await m.remove_if_present(k, v))
                elif op == "size":
                    out.append(await m.size())
            return out
        finally:
            await _teardown([client] + servers)

    assert await run("cpu") == await run("tpu")


@async_test(timeout=180)
async def test_device_group_reuse_after_delete():
    servers, (client,) = await _cluster("tpu", MAPS)
    try:
        first = await client.get("reuse-seed", DistributedMap)
        await first.put(1, 111)
        await first.delete()
        maps = []
        for i in range(8):
            m = await client.get(f"reuse-{i}", DistributedMap)
            await m.put(i + 100, i)
            maps.append(m)
        assert _device_kinds(servers[0]) == ["DeviceMapState"] * 8
        for m in maps:
            assert await m.get(1) is None
        for i, m in enumerate(maps):
            assert await m.get(i + 100) == i
    finally:
        await _teardown([client] + servers)


@async_test(timeout=180)
async def test_deleted_group_is_released_once():
    """A client's delete reaches the device machine twice (its
    DeleteCommand, then the catalog's DeleteResource): the group must go
    back to the allocator once, so the next two resources get two groups
    and keep their values apart. (The reference releases it twice and
    hands one group to both; ROADMAP Queue 3.)"""
    server, (client,) = await _node(VALUES)
    try:
        first = await client.get("gone", DistributedAtomicLong)
        await first.increment_and_get()
        await first.delete()
        eng = server.server.state_machine.device_engine
        assert eng._free == [0]
        b = await client.get("b", DistributedAtomicLong)
        d = await client.get("d", DistributedAtomicLong)
        mgr = server.server.state_machine
        assert sorted(h.state_machine._group
                      for h in mgr.resources.values()) == [0, 1]
        assert await b.add_and_get(5) == 5
        assert await d.add_and_get(7) == 7
        assert [await b.get(), await d.get()] == [5, 7]
    finally:
        await _teardown([client, server])


def test_each_package_decodes_its_own_types():
    """The native codec keeps its registries in C statics: each package
    loads its own copy, so one process holding both decodes each
    package's messages into that package's classes."""
    from copycat_tpu.io.serializer import Serializer as RefSerializer
    from copycat_tpu.protocol import messages as ref_messages
    from copycat_tpu_torch.io import codec
    from copycat_tpu_torch.io.serializer import Serializer
    from copycat_tpu_torch.protocol import messages

    ref_wire = RefSerializer().write(ref_messages.KeepAliveRequest(5, 6, 7))
    wire = Serializer().write(messages.KeepAliveRequest(5, 6, 7))
    assert wire == ref_wire
    got = Serializer().read(ref_wire)
    ref_got = RefSerializer().read(wire)
    assert type(got) is messages.KeepAliveRequest
    assert type(ref_got) is ref_messages.KeepAliveRequest
    assert (got.session_id, got.command_seq, got.event_index) == (5, 6, 7)
    if codec.codec() is not None:
        from copycat_tpu.io import codec as ref_codec
        assert codec.codec() is not ref_codec.codec()


# -- single-server scripts: test_device_window.py, _interleave.py ------------


async def _node(config, n_clients=1, storage=None, registry=None, addr=None,
                **server_kw):
    registry = registry or LocalServerRegistry()
    addrs = [addr] if addr is not None else next_ports(1)
    server = AtomixServer(addrs[0], addrs, LocalTransport(registry),
                          election_timeout=0.2, heartbeat_interval=0.04,
                          session_timeout=10.0, executor="tpu",
                          engine_config=config, storage=storage,
                          **server_kw)
    await server.open()
    clients = []
    for _ in range(n_clients):
        c = AtomixClient(addrs, LocalTransport(registry),
                         session_timeout=10.0)
        await c.open()
        clients.append(c)
    return server, clients


@async_test(timeout=300)
async def test_spi_batching_end_to_end():
    server, (client,) = await _node(engine(64))
    try:
        n = 24
        counters = await asyncio.gather(
            *(client.get(f"ctr{i}", DistributedAtomicLong) for i in range(n)))
        eng = server.server.state_machine.device_engine
        r0 = eng._groups.rounds
        reps = 4
        for _ in range(reps):
            got = await asyncio.gather(
                *(c.increment_and_get() for c in counters))
        assert got == [reps] * n
        rounds = eng._groups.rounds - r0
        assert rounds < 3 * n * reps / 2, f"{rounds} rounds for {n*reps} ops"
        assert eng._next_group >= n
    finally:
        await _teardown([client, server])


@async_test(timeout=300)
async def test_ttl_under_window_still_fires():
    server, (client,) = await _node(engine(64, "map_slots"))
    try:
        m = await client.get("ttlmap", DistributedMap)
        await m.put(1, 100, ttl=0.3)
        assert await m.get(1) == 100
        await asyncio.sleep(0.9)
        await m.put(2, 200)
        assert await m.get(1) is None
        assert await m.get(2) == 200
    finally:
        await _teardown([client, server])


INTERLEAVE = engine(32, "map_slots", "set_slots", "queue_slots",
                    "wait_slots", "event_slots")


@async_test(timeout=180)
async def test_delete_mid_burst_barriers_then_group_reuses_clean():
    server, (client,) = await _node(INTERLEAVE)
    try:
        m = await client.get("m1", DistributedMap)
        await asyncio.gather(*(m.put(i, i * 10) for i in range(6)))
        await asyncio.gather(m.put(100, 1), m.put(101, 2), m.delete(),
                             return_exceptions=True)
        m2 = await client.get("m1", DistributedMap)
        assert await m2.size() == 0
        await m2.put(7, 70)
        assert await m2.get(7) == 70
        assert _device_kinds(server) == ["DeviceMapState"]
    finally:
        await _teardown([client, server])


@async_test(timeout=180)
async def test_lock_handoff_within_one_window():
    server, (c1, c2) = await _node(INTERLEAVE, 2)
    try:
        l1 = await c1.get("lk", DistributedLock)
        l2 = await c2.get("lk", DistributedLock)
        await l1.lock()
        waiter = asyncio.ensure_future(l2.lock())
        await asyncio.sleep(0.2)
        assert not waiter.done()
        await l1.unlock()
        await asyncio.wait_for(waiter, 15)
        await l2.unlock()
        await l1.lock()
        await l1.unlock()
    finally:
        await _teardown([c1, c2, server])


@async_test(timeout=180)
async def test_listener_ordered_against_same_window_set():
    server, (c1, c2) = await _node(INTERLEAVE, 2)
    try:
        v1 = await c1.get("val", DistributedAtomicValue)
        v2 = await c2.get("val", DistributedAtomicValue)
        seen: list = []
        await v1.on_change(seen.append)
        await v2.set(1)
        for _ in range(50):
            if seen:
                break
            await asyncio.sleep(0.05)
        assert seen and seen[-1] == 1, seen
        await v2.set(2)
        for _ in range(50):
            if seen[-1] == 2:
                break
            await asyncio.sleep(0.05)
        assert seen[-1] == 2, seen
    finally:
        await _teardown([c1, c2, server])


@async_test(timeout=240)
async def test_mixed_resource_storm_in_shared_windows():
    server, (client,) = await _node(INTERLEAVE)
    try:
        counters = await asyncio.gather(
            *(client.get(f"n{i}", DistributedAtomicLong) for i in range(8)))
        maps = await asyncio.gather(
            *(client.get(f"mp{i}", DistributedMap) for i in range(4)))
        sets_ = await asyncio.gather(
            *(client.get(f"st{i}", DistributedSet) for i in range(4)))
        queues = await asyncio.gather(
            *(client.get(f"q{i}", DistributedQueue) for i in range(4)))
        for rep in range(3):
            ops = []
            ops += [c.increment_and_get() for c in counters]
            ops += [m.put(rep, rep * 7) for m in maps]
            ops += [s.add(rep) for s in sets_]
            ops += [q.offer(rep) for q in queues]
            await asyncio.wait_for(asyncio.gather(*ops), 60)
        got = await asyncio.gather(*(c.get() for c in counters))
        assert got == [3] * 8
        for m in maps:
            assert await m.size() == 3
        for s in sets_:
            assert await s.size() == 3
        for q in queues:
            assert [await q.poll() for _ in range(3)] == [0, 1, 2]
        assert _device_kinds(server) == sorted(
            ["DeviceAtomicValueState"] * 8 + ["DeviceMapState"] * 4
            + ["DeviceSetState"] * 4 + ["DeviceQueueState"] * 4)
    finally:
        await _teardown([client, server])


# -- test_spi_vector_pump.py ---------------------------------------------------

PUMPS = engine(16)


async def _spi_node(registry, **lanes):
    (addr,) = next_ports(1)
    server = AtomixServer(addr, [addr], LocalTransport(registry),
                          election_timeout=0.5, heartbeat_interval=0.1,
                          session_timeout=20.0, executor="tpu",
                          engine_config=PUMPS)
    for lane, on in lanes.items():
        setattr(server.server, lane, on)
    await server.open()
    client = AtomixClient([addr], LocalTransport(registry),
                          session_timeout=20.0)
    await client.open()
    return server, client


def _vector_script(seed, n_waves, wave):
    rng = random.Random(seed)
    return [[(rng.randrange(4), rng.randrange(4), rng.randrange(5),
              rng.randrange(5)) for _ in range(wave)]
            for _ in range(n_waves)]


async def _run_vector_script(client, waves):
    values = [await client.get(f"v{i}", DistributedAtomicValue)
              for i in range(4)]
    events: list = []
    listener = await values[3].on_change(lambda v: events.append((3, v)))
    for i, v in enumerate(values):
        await v.set(i)
    results = []
    for ops in waves:
        async def one(target, kind, a, b):
            v = values[target]
            if kind == 0:
                await v.set(a)
                return ("set", None)
            if kind == 1:
                return ("cas", await v.compare_and_set(a, b))
            if kind == 2:
                return ("gas", await v.get_and_set(a))
            return ("get", await v.get())
        results.append(await asyncio.gather(*(one(*op) for op in ops)))
    finals = [await v.get() for v in values]
    listener.close()
    await asyncio.sleep(0.05)
    return results, events, finals


@async_test(timeout=300)
async def test_vector_pump_bit_identical_to_per_op_path():
    waves = _vector_script(seed=42, n_waves=6, wave=32)
    histories = []
    for pump in (True, False):
        server, client = await _spi_node(LocalServerRegistry(),
                                         _vector_pump=pump)
        try:
            histories.append(await _run_vector_script(client, waves))
        finally:
            await _teardown([client, server])
    (res_on, ev_on, fin_on), (res_off, ev_off, fin_off) = histories
    assert res_on == res_off
    assert ev_on == ev_off
    assert fin_on == fin_off
    cas = [r[1] for wave in res_on for r in wave if r[0] == "cas"]
    assert True in cas and False in cas


@async_test(timeout=300)
async def test_vector_pump_exactly_once_under_duplicate_delivery():
    registry = LocalServerRegistry()
    nemesis = registry.attach_nemesis(NetworkNemesis(seed=7))
    server, client = await _spi_node(registry, _vector_pump=True)
    try:
        counter = await client.get("c", DistributedAtomicLong)
        await counter.increment_and_get()
        nemesis.set_loss(response=0.3)
        acked = 0
        for _ in range(40):
            await counter.increment_and_get()
            acked += 1
        nemesis.heal()
        assert await counter.get() == acked + 1
        assert nemesis.dropped_responses > 0, "nemesis never fired"
    finally:
        nemesis.heal()
        await _teardown([client, server])


@async_test(timeout=300)
async def test_vector_pump_partition_mid_batch_no_duplicate_applies():
    registry = LocalServerRegistry()
    nemesis = registry.attach_nemesis(NetworkNemesis(seed=11))
    server, client = await _spi_node(registry, _vector_pump=True)
    try:
        counter = await client.get("c", DistributedAtomicLong)
        await counter.increment_and_get()
        acked = 0

        async def storm(n):
            nonlocal acked
            for _ in range(n):
                await asyncio.wait_for(counter.increment_and_get(), 60)
                acked += 1

        task = asyncio.ensure_future(storm(30))
        await asyncio.sleep(0.02)
        nemesis.set_loss(request=0.4, response=0.4)
        await asyncio.sleep(0.3)
        nemesis.heal()
        await asyncio.wait_for(task, 120)
        assert await counter.get() == acked + 1
    finally:
        nemesis.heal()
        await _teardown([client, server])


@pytest.fixture()
def deep_rg():
    rg = RaftGroups(8, 3, log_slots=32, submit_slots=4, seed=13,
                    config=Config(monotone_tag_accept=True), device="cpu")
    rg.wait_for_leaders()
    return rg


def test_flush_pre_dispatch_error_restores_pending(deep_rg):
    client = BulkSessionClient(deep_rg)
    s = client.open_session()
    seqs = s.submit_batch([0] * 4, ap.OP_LONG_ADD, 1)
    real_drive = client._driver.drive
    client._driver.drive = lambda *a, **k: (_ for _ in ()).throw(
        ValueError("accumulators too skewed"))
    with pytest.raises(ValueError):
        client.flush()
    assert len(s._pending) == 1
    for q in seqs:
        assert int(q) not in s._results
    client._driver.drive = real_drive
    assert client.flush() == 4
    assert list(s.results_window(int(seqs[0]), 4)) == [1, 2, 3, 4]


def test_flush_timeout_marks_indeterminate(deep_rg):
    client = BulkSessionClient(deep_rg)
    s = client.open_session()
    seqs = s.submit_batch([1] * 3, ap.OP_LONG_ADD, 1)
    client._driver.drive = lambda *a, **k: (_ for _ in ()).throw(
        TimeoutError("drive abandoned"))
    with pytest.raises(TimeoutError):
        client.flush()
    assert not s._pending
    with pytest.raises(CommandIndeterminateError):
        s.result(int(seqs[0]))


def test_events_delivered_until_close(deep_rg):
    client = BulkSessionClient(deep_rg)
    watcher = client.open_session()
    worker = client.open_session()
    group = 2
    got: list = []
    watcher.on_event(group, got.append)
    worker.submit(group, ap.OP_TOPIC_LISTEN, worker.id)
    worker.submit(group, ap.OP_TOPIC_PUB, 41)
    watcher.close()
    client.flush()
    assert [e.arg for e in got] == [41]
    assert watcher.id not in client._sessions


# -- test_spi_read_pump.py ------------------------------------------------------


def _read_script(seed, n_rounds, wave):
    rng = random.Random(seed)
    rounds = []
    for _ in range(n_rounds):
        writes = [(rng.randrange(4), rng.randrange(3), rng.randrange(5),
                   rng.randrange(5)) for _ in range(wave // 4)]
        reads = [rng.randrange(4) for _ in range(wave)]
        rounds.append((writes, reads))
    return rounds


async def _run_read_script(client, rounds):
    values = [await client.get(f"v{i}", DistributedAtomicValue)
              for i in range(4)]
    values[1].with_consistency(Consistency.SEQUENTIAL)
    values[2]._read_cl = "linearizable"
    events: list = []
    listener = await values[3].on_change(lambda v: events.append(v))
    for i, v in enumerate(values):
        await v.set(i)
    results = []
    indices = []
    for writes, reads in rounds:
        async def one_write(target, kind, a, b):
            v = values[target]
            try:
                if kind == 0:
                    await v.set(a)
                    return ("set", None)
                if kind == 1:
                    return ("cas", await v.compare_and_set(a, b))
                return ("gas", await v.get_and_set(a))
            except Exception as e:  # noqa: BLE001 — error surfaces compare
                return ("err", type(e).__name__, str(e))

        async def one_read(target):
            try:
                return ("get", await values[target].get())
            except Exception as e:  # noqa: BLE001
                return ("err", type(e).__name__, str(e))

        results.append(await asyncio.gather(
            *(one_write(*w) for w in writes)))
        results.append(await asyncio.gather(*(one_read(t) for t in reads)))
        indices.append(client.client.index)
    finals = [await v.get() for v in values]
    listener.close()
    await asyncio.sleep(0.05)
    return results, indices, finals, events


@async_test(timeout=300)
async def test_read_pump_bit_identical_to_per_op_path():
    waves = _read_script(seed=7, n_rounds=5, wave=32)
    histories = []
    metrics = []
    for pump in (True, False):
        server, client = await _spi_node(LocalServerRegistry(),
                                         _read_pump=pump)
        try:
            histories.append(await _run_read_script(client, waves))
            metrics.append(server.server.metrics.snapshot())
        finally:
            await _teardown([client, server])
    on, off = histories
    assert on[0] == off[0]
    assert on[1] == off[1]
    assert on[2] == off[2]
    assert on[3] == off[3]
    snap_on, snap_off = metrics
    assert snap_on["query_windows"] > 0
    assert snap_on["query_ops_device_lane"] > 0
    assert snap_off["query_windows"] == 0


@async_test(timeout=300)
async def test_linearizable_window_pays_one_confirm_round():
    server, client = await _spi_node(LocalServerRegistry(), _read_pump=True)
    try:
        raft = server.server
        values = [await client.get(f"v{i}", DistributedAtomicValue)
                  for i in range(4)]
        for v in values:
            v._read_cl = "linearizable"
            await v.set(9)
        confirms = [0]
        real_confirm = raft._confirm_leadership

        async def counting_confirm():
            confirms[0] += 1
            return await real_confirm()

        raft._confirm_leadership = counting_confirm
        saved0 = raft.metrics.counter("query_gate_rounds_saved").value
        windows0 = raft.metrics.counter("query_windows").value
        n = 24
        got = await asyncio.gather(*(values[i % 4].get() for i in range(n)))
        assert got == [9] * n
        assert confirms[0] == 1
        assert raft.metrics.counter("query_windows").value == windows0 + 1
        assert raft.metrics.counter(
            "query_gate_rounds_saved").value - saved0 == n - 1
    finally:
        await _teardown([client, server])


@async_test(timeout=300)
async def test_cross_session_reads_share_one_window():
    registry = LocalServerRegistry()
    server, client_a = await _spi_node(registry, _read_pump=True)
    client_b = AtomixClient([server.server.address],
                            LocalTransport(registry), session_timeout=20.0)
    await client_b.open()
    try:
        raft = server.server
        va = await client_a.get("shared", DistributedAtomicValue)
        vb = await client_b.get("shared", DistributedAtomicValue)
        await va.set(5)
        windows0 = raft.metrics.counter("query_windows").value
        got = await asyncio.gather(va.get(), vb.get(), va.get(), vb.get())
        assert got == [5, 5, 5, 5]
        assert raft.metrics.counter("query_windows").value - windows0 <= 2
    finally:
        await _teardown([client_b, client_a, server])


@async_test(timeout=120)
async def test_read_pump_env_knob(monkeypatch):
    registry = LocalServerRegistry()
    monkeypatch.setenv("COPYCAT_SERVER_READ_PUMP", "0")
    (addr,) = next_ports(1)
    server = AtomixServer(addr, [addr], LocalTransport(registry),
                          session_timeout=20.0)
    assert server.server._read_pump is False
    monkeypatch.delenv("COPYCAT_SERVER_READ_PUMP")
    (addr2,) = next_ports(1)
    server2 = AtomixServer(addr2, [addr2], LocalTransport(registry),
                           session_timeout=20.0)
    assert server2.server._read_pump is True


def test_drive_query_vector_matches_per_op_serve():
    rg = RaftGroups(8, 3, log_slots=32, submit_slots=4, seed=3,
                    device="cpu")
    rg.wait_for_leaders()
    for g in range(8):
        rg.run_until([rg.submit(g, ap.OP_LONG_ADD, g + 1)])
    groups = np.concatenate([np.full(g + 1, g) for g in range(8)])
    got = rg.drive_query_vector(groups, ap.OP_VALUE_GET)
    want = np.array([rg.serve_query(int(g), ap.OP_VALUE_GET)
                     for g in groups])
    assert (got == want).all(), (got, want)
    got_atomic = rg.drive_query_vector(groups, ap.OP_VALUE_GET, atomic=True)
    assert (got_atomic == want).all()


def test_drive_query_vector_refuses_writes():
    rg = RaftGroups(2, 3, log_slots=32, submit_slots=4, seed=4,
                    device="cpu")
    rg.wait_for_leaders()
    with pytest.raises(ValueError, match="not read-only"):
        rg.drive_query_vector([0], ap.OP_LONG_ADD, 1)


@async_test(timeout=300)
async def test_follower_reads_round_robin(monkeypatch):
    monkeypatch.setenv("COPYCAT_EDGE_READS", "0")
    registry = LocalServerRegistry()
    addrs = next_ports(3)
    servers = [
        AtomixServer(a, addrs, LocalTransport(registry, local_address=a),
                     election_timeout=0.3, heartbeat_interval=0.05,
                     session_timeout=20.0)
        for a in addrs
    ]
    await asyncio.gather(*(s.open() for s in servers))
    client = AtomixClient(addrs, LocalTransport(registry),
                          session_timeout=20.0)
    await client.open()
    try:
        assert client.client._follower_reads is True
        v = await client.get("v", DistributedAtomicValue)
        v.with_consistency(Consistency.SEQUENTIAL)
        await v.set(7)
        for _ in range(9):
            assert await v.get() == 7
        snap = client.client.metrics.snapshot()
        assert snap.get("client_reads_follower_lane", 0) >= 3, snap
        served = [s.server.metrics.counter(
            "query_reads", consistency="sequential").value
            for s in servers]
        assert sum(1 for n in served if n > 0) >= 2, served
    finally:
        await _teardown([client] + servers)


@async_test(timeout=120)
async def test_follower_reads_env_knob(monkeypatch):
    from copycat_tpu_torch.client.client import RaftClient

    monkeypatch.setenv("COPYCAT_CLIENT_FOLLOWER_READS", "0")
    registry = LocalServerRegistry()
    c = RaftClient([Address("127.0.0.1", 1)], LocalTransport(registry))
    assert c._follower_reads is False
    monkeypatch.delenv("COPYCAT_CLIENT_FOLLOWER_READS")
    c2 = RaftClient([Address("127.0.0.1", 1)], LocalTransport(registry))
    assert c2._follower_reads is True


@async_test(timeout=300)
async def test_read_pump_error_surfaces_match():
    from copycat_tpu_torch.atomic import commands as vc
    from copycat_tpu_torch.manager.operations import InstanceQuery
    from copycat_tpu_torch.resource.operations import ResourceQuery

    outcomes = []
    for pump in (True, False):
        server, client = await _spi_node(LocalServerRegistry(),
                                         _read_pump=pump)
        try:
            v = await client.get("doomed", DistributedAtomicValue)
            await v.set(1)
            instance_id = v.client.instance_id
            await v.delete()
            try:
                await client.client.submit(InstanceQuery(
                    instance_id, ResourceQuery(vc.Get(), "sequential")))
                outcomes.append(("ok",))
            except Exception as e:  # noqa: BLE001 — the surface under test
                outcomes.append((type(e).__name__, str(e)))
        finally:
            await _teardown([client, server])
    assert outcomes[0] == outcomes[1], outcomes
    assert outcomes[0][0] == "ApplicationError"


# -- test_device_recovery.py ----------------------------------------------------


@pytest.mark.parametrize("level", [StorageLevel.DISK, StorageLevel.MAPPED])
@async_test(timeout=300)
async def test_restart_replays_log_into_fresh_device_engine(tmp_path, level):
    config = engine(16, "map_slots")
    (addr,) = next_ports(1)
    server, (client,) = await _node(
        config, addr=addr,
        storage=Storage(level, str(tmp_path), max_entries_per_segment=16))
    ctr = await client.get("ctr", DistributedAtomicLong)
    for _ in range(5):
        await ctr.increment_and_get()
    m = await client.get("m", DistributedMap)
    await m.put(1, 11)
    await m.put(2, 22)
    await m.remove(1)
    v = await client.get("v", DistributedAtomicValue)
    await v.set(99)
    eng = server.server.state_machine.device_engine
    assert eng._next_group >= 3
    await _teardown([client, server])

    server2, (client2,) = await _node(
        config, addr=addr,
        storage=Storage(level, str(tmp_path), max_entries_per_segment=16))
    try:
        ctr2 = await client2.get("ctr", DistributedAtomicLong)
        assert await ctr2.get() == 5
        assert await ctr2.increment_and_get() == 6
        m2 = await client2.get("m", DistributedMap)
        assert await m2.get(2) == 22
        assert await m2.get(1) is None
        assert await m2.size() == 1
        v2 = await client2.get("v", DistributedAtomicValue)
        assert await v2.get() == 99
        eng2 = server2.server.state_machine.device_engine
        assert eng2 is not eng
        assert _device_kinds(server2) == [
            "DeviceAtomicValueState", "DeviceAtomicValueState",
            "DeviceMapState"]
    finally:
        await _teardown([client2, server2])


# -- the differential against the reference's server -------------------------

def _differential_script(seed, n=60):
    """``n`` random ops over two longs, a value (CAS), a map, a set and a
    queue — keys past the pools' 16 slots, so both placements are hit —
    with a lock hand-off after a third and an election succession after
    two thirds."""
    rng = np.random.default_rng(seed)
    kinds = ["long_add", "long_get", "value_set", "value_cas", "value_gas",
             "value_get", "map_put", "map_get", "map_remove", "map_pia",
             "map_size", "set_add", "set_contains", "set_remove", "queue_offer",
             "queue_poll", "queue_peek", "queue_size"]
    script = []
    for i in range(n):
        if i == n // 3:
            script.append(("lock_handoff", 0, 0))
        if i == 2 * n // 3:
            script.append(("election_succession", 0, 0))
        script.append((str(rng.choice(kinds)), int(rng.integers(24)),
                       int(rng.integers(-9, 100))))
    return script


async def _run_differential(pkg, script):
    """Run ``script`` through ``pkg``'s single-server
    ``AtomixServer(executor="tpu")`` (``pkg`` is either package's module
    namespace); returns every answer, every event in arrival order (epochs
    by rank: the values are CPU-log indexes, which keep-alive timing
    moves) and the server's resource placement."""
    registry = pkg.LocalServerRegistry()
    addr = pkg.Address("local", next(_PORTS))
    server = pkg.AtomixServer(addr, [addr], pkg.LocalTransport(registry),
                              election_timeout=0.2, heartbeat_interval=0.04,
                              session_timeout=10.0, executor="tpu",
                              engine_config=pkg.engine)
    await server.open()
    client = pkg.AtomixClient([addr], pkg.LocalTransport(registry),
                              session_timeout=10.0)
    await client.open()
    events: list = []
    epochs: dict = {}

    def epoch_rank(e):
        return epochs.setdefault(e, len(epochs))

    try:
        longs = [await client.get(f"l{i}", pkg.DistributedAtomicLong)
                 for i in range(2)]
        value = await client.get("v", pkg.DistributedAtomicValue)
        await value.on_change(lambda v: events.append(("value", v)))
        m = await client.get("m", pkg.DistributedMap)
        s = await client.get("s", pkg.DistributedSet)
        q = await client.get("q", pkg.DistributedQueue)
        out = []
        for kind, k, v in script:
            if kind == "long_add":
                out.append(await longs[k % 2].add_and_get(v))
            elif kind == "long_get":
                out.append(await longs[k % 2].get())
            elif kind == "value_set":
                out.append(await value.set(v % 5))
            elif kind == "value_cas":
                out.append(await value.compare_and_set(k % 5, v % 5))
            elif kind == "value_gas":
                out.append(await value.get_and_set(v % 5))
            elif kind == "value_get":
                out.append(await value.get())
            elif kind == "map_put":
                out.append(await m.put(k, v))
            elif kind == "map_get":
                out.append(await m.get(k))
            elif kind == "map_remove":
                out.append(await m.remove(k))
            elif kind == "map_pia":
                out.append(await m.put_if_absent(k, v))
            elif kind == "map_size":
                out.append(await m.size())
            elif kind == "set_add":
                out.append(await s.add(k))
            elif kind == "set_contains":
                out.append(await s.contains(k))
            elif kind == "set_remove":
                out.append(await s.remove(k))
            elif kind == "queue_offer":
                out.append(await q.offer(v))
            elif kind == "queue_poll":
                out.append(await q.poll())
            elif kind == "queue_peek":
                out.append(await q.peek())
            elif kind == "queue_size":
                out.append(await q.size())
            elif kind == "lock_handoff":
                first = await client.create("lk", pkg.DistributedLock)
                second = await client.create("lk", pkg.DistributedLock)
                await first.lock()
                out.append(await second.try_lock())
                waiter = asyncio.ensure_future(second.lock())
                waiter.add_done_callback(
                    lambda _f: events.append(("lock", "granted")))
                await asyncio.sleep(0.1)
                out.append(waiter.done())
                await first.unlock()
                events.append(("lock", "released"))
                await asyncio.wait_for(waiter, 15)
                out.append(await first.try_lock())
                await second.unlock()
                out.append(await first.try_lock())
            else:
                first = await client.create("el", pkg.DistributedLeaderElection)
                second = await client.create("el",
                                             pkg.DistributedLeaderElection)
                got = {1: [], 2: []}
                await first.on_election(got[1].append)
                await second.on_election(got[2].append)
                for _ in range(100):
                    if got[1]:
                        break
                    await asyncio.sleep(0.02)
                events.append(("elected", 1, [epoch_rank(e) for e in got[1]]))
                out.append(await first.is_leader(got[1][0]))
                await first.resign()
                for _ in range(100):
                    if got[2]:
                        break
                    await asyncio.sleep(0.02)
                events.append(("elected", 2, [epoch_rank(e) for e in got[2]]))
                out += [await second.is_leader(got[2][0]),
                        await second.is_leader(got[1][0]),
                        got[2][0] > got[1][0]]
        await asyncio.sleep(0.05)
        kinds = sorted(type(h.state_machine).__name__
                       for h in server.server.state_machine.resources.values())
        return out, events, kinds
    finally:
        await _teardown([client, server])


@async_test(timeout=300)
async def test_differential_against_the_reference_server():
    """One seeded script, one client, one op in flight, through the
    reference's ``AtomixServer(executor="tpu")`` and the port's: equal
    answers, equal events, equal placement (every resource a device
    machine). Both engines at the shape of the reference's
    ``test_executor_parity.py`` (every pool), whose programs the
    reference has compiled before this file runs."""
    from copycat_tpu import atomic as r_atomic
    from copycat_tpu import collections as r_coll
    from copycat_tpu import coordination as r_coord
    from copycat_tpu.io import local as r_local
    from copycat_tpu.io.transport import Address as RAddress
    from copycat_tpu.manager import atomix as r_atomix
    from copycat_tpu.manager.device_executor import (
        DeviceEngineConfig as RDeviceEngineConfig)

    ref = SimpleNamespace(
        LocalServerRegistry=r_local.LocalServerRegistry,
        LocalTransport=r_local.LocalTransport, Address=RAddress,
        AtomixServer=r_atomix.AtomixServer,
        AtomixClient=r_atomix.AtomixClient,
        DistributedAtomicLong=r_atomic.DistributedAtomicLong,
        DistributedAtomicValue=r_atomic.DistributedAtomicValue,
        DistributedMap=r_coll.DistributedMap,
        DistributedSet=r_coll.DistributedSet,
        DistributedQueue=r_coll.DistributedQueue,
        DistributedLock=r_coord.DistributedLock,
        DistributedLeaderElection=r_coord.DistributedLeaderElection,
        engine=RDeviceEngineConfig(capacity=8, num_peers=3, log_slots=32))
    port = SimpleNamespace(
        LocalServerRegistry=LocalServerRegistry,
        LocalTransport=LocalTransport, Address=Address,
        AtomixServer=AtomixServer, AtomixClient=AtomixClient,
        DistributedAtomicLong=DistributedAtomicLong,
        DistributedAtomicValue=DistributedAtomicValue,
        DistributedMap=DistributedMap, DistributedSet=DistributedSet,
        DistributedQueue=DistributedQueue, DistributedLock=DistributedLock,
        DistributedLeaderElection=DistributedLeaderElection,
        engine=DeviceEngineConfig(capacity=8, num_peers=3, log_slots=32,
                                  device="cpu"))
    script = _differential_script(seed=2024)
    want = await _run_differential(ref, script)
    got = await _run_differential(port, script)
    assert got[0] == want[0], "answers differ"
    assert got[1] == want[1], "events differ"
    assert got[2] == want[2]
    assert want[2] == sorted(
        ["DeviceAtomicValueState"] * 3 + ["DeviceMapState", "DeviceSetState",
                                          "DeviceQueueState"]
        + ["DeviceLockState"] + ["DeviceLeaderElectionState"])
    assert ("lock", "granted") in want[1] and len(want[1]) > 3
