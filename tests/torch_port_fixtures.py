"""A Raft cluster of the port's own server stack for the port's tests.

The port's counterpart of ``raft_fixtures.create_cluster``: N
``copycat_tpu_torch`` ``RaftServer``s over the port's in-memory
``LocalTransport``, each hosting the port's keyed counter machine
(``testing/counter_machine.py``: ``ClusterAdd`` writes, ``ClusterGet``
reads), and ``RaftClient``s on the same registry. No object of
``copycat_tpu`` takes part.
"""

from __future__ import annotations

import asyncio
import itertools

from copycat_tpu_torch.client.client import RaftClient
from copycat_tpu_torch.io.local import LocalServerRegistry, LocalTransport
from copycat_tpu_torch.io.transport import Address
from copycat_tpu_torch.server.log import Storage, StorageLevel
from copycat_tpu_torch.server.raft import LEADER, RaftServer
from copycat_tpu_torch.testing.counter_machine import CounterMachine

_PORTS = itertools.count(46_000)


def next_ports(n: int) -> list[Address]:
    return [Address("local", next(_PORTS)) for _ in range(n)]


class Cluster:
    def __init__(self, servers: list, registry: LocalServerRegistry) -> None:
        self.servers = servers
        self.registry = registry
        self.clients: list[RaftClient] = []

    @property
    def leader(self) -> RaftServer | None:
        return next((s for s in self.servers
                     if s.is_open and s.role == LEADER), None)

    async def await_leader(self, timeout: float = 10.0) -> RaftServer:
        deadline = asyncio.get_running_loop().time() + timeout
        while asyncio.get_running_loop().time() < deadline:
            if self.leader is not None:
                return self.leader
            await asyncio.sleep(0.02)
        raise TimeoutError("no leader elected")

    async def client(self, session_timeout: float = 10.0) -> RaftClient:
        client = RaftClient([s.address for s in self.servers],
                            LocalTransport(self.registry),
                            session_timeout=session_timeout)
        await client.open()
        self.clients.append(client)
        return client

    async def close(self) -> None:
        for node in [*self.clients, *self.servers]:
            try:
                await asyncio.wait_for(node.close(), 5)
            except (Exception, asyncio.TimeoutError):
                pass


def server_for(addr: Address, addrs: list, registry, storage=None,
               machine=CounterMachine, **kw) -> RaftServer:
    """One port ``RaftServer`` at ``addr`` (the test cadence: election
    0.2 s, heartbeat 0.04 s)."""
    kw = {"election_timeout": 0.2, "heartbeat_interval": 0.04,
          "session_timeout": 10.0, **kw}
    return RaftServer(addr, addrs,
                      LocalTransport(registry, local_address=addr),
                      machine(), storage=storage or Storage(
                          StorageLevel.MEMORY), **kw)


async def create_cluster(n: int = 3, storage_factory=None,
                         machine=CounterMachine, **kw) -> Cluster:
    registry = LocalServerRegistry()
    addrs = next_ports(n)
    servers = [server_for(a, addrs, registry,
                          storage_factory(i) if storage_factory else None,
                          machine, **kw)
               for i, a in enumerate(addrs)]
    await asyncio.gather(*(s.open() for s in servers))
    cluster = Cluster(servers, registry)
    await cluster.await_leader()
    return cluster
