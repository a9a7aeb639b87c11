"""Cluster facade (reference ``Atomix.java:58``, ``AtomixClient.java:35``,
``AtomixReplica.java:45``, ``AtomixServer.java:40``).

- :class:`Atomix` — ``exists/get/create/close`` over a RaftClient
- :class:`AtomixClient` — stateless node (client only)
- :class:`AtomixReplica` — client + server in one process, client pinned to the
  colocated server (the reference's CombinedTransport/ConnectionStrategy)
- :class:`AtomixServer` — standalone server (no client facade)

Configuration is via typed keyword arguments plus a chained ``Builder`` for
API parity with the reference's ``builder()`` surface (SURVEY.md §5.6).
"""

from __future__ import annotations

from typing import Any, Type, TypeVar

from ..utils import knobs

from ..client.client import PinnedConnectionStrategy, RaftClient
from ..io.transport import Address, Transport
from ..resource.resource import Resource, resource_state_machine_of
from ..server.log import Storage
from ..server.raft import RaftServer
from ..utils.managed import Managed
from .instance import InstanceClient
from .operations import CreateResource, GetResource, ResourceExists
from .state import ResourceManager

# Register the built-in resource library with the serializer. The wire
# protocol carries class REFERENCES by registry id (the documented
# deviation from the reference's Class.forName — serializer.py), so a
# server must know the whole catalog before the first client names a
# resource class it never imported itself. Single-process tests import
# everything anyway; a standalone `copycat-server` would otherwise fail
# to decode GetResource("x", DistributedAtomicValue) from a remote
# client ("unknown class id" — found driving the packaged server +
# client examples cross-process).
from .. import atomic as _atomic  # noqa: F401,E402
from .. import collections as _collections  # noqa: F401,E402
from .. import coordination as _coordination  # noqa: F401,E402

R = TypeVar("R", bound=Resource)


def _manager_factory(executor: str, engine_config: Any,
                     groups: int | None) -> tuple[Any, int]:
    """Resolve the group count (constructor arg > COPYCAT_GROUPS, gated
    by COPYCAT_MULTI_GROUP) and build the per-group ResourceManager
    factory — one manager per Raft group, sharing ONE device engine so
    every group's device-backed resources ride the same [G×P] tensor
    plane (docs/SHARDING.md)."""
    if groups is None:
        groups = max(1, knobs.get_int("COPYCAT_GROUPS"))
    if not knobs.get_bool("COPYCAT_MULTI_GROUP"):
        groups = 1
    if groups == 1:
        return ResourceManager(executor=executor,
                               engine_config=engine_config), 1
    shared_engine = None
    if executor == "tpu":
        from .device_executor import DeviceEngine
        shared_engine = DeviceEngine(engine_config)

    def factory(g: int) -> ResourceManager:
        return ResourceManager(executor=executor,
                               engine_config=engine_config,
                               group_id=g, num_groups=groups,
                               engine=shared_engine)

    return factory, groups


class Atomix(Managed):
    """Async facade over the resource catalog."""

    def __init__(self, client: RaftClient) -> None:
        super().__init__()
        self.client = client
        self._resources: dict[str, Resource] = {}  # get() singleton cache per node

    async def exists(self, key: str) -> bool:
        return bool(await self.client.submit(ResourceExists(key)))

    @staticmethod
    async def _build_facade(instance: InstanceClient, resource_type: type,
                            factory: Any):
        """Build (factory or reflective constructor) + validate a facade.

        On a bad factory the LOCAL instance state is closed (listener
        wrappers); the server-side virtual session is reclaimed when the
        parent client session closes or times out — the same fate as any
        abandoned instance in the reference (there is deliberately no
        instance-close catalog op; see manager/operations.py)."""
        build = factory if factory is not None else resource_type
        try:
            resource = build(instance)
            if not isinstance(resource, resource_type):
                raise TypeError(
                    f"factory built {type(resource).__name__}, not a "
                    f"{resource_type.__name__}")
        except BaseException:
            try:
                await instance.close()
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
            raise
        return resource

    async def get(self, key: str, resource_type: Type[R],
                  factory: Any = None) -> R:
        """Singleton-per-node resource handle (reference ``Atomix.get:205-208``).

        ``factory`` (reference's ``Atomix.get(key, type, factory)``
        overload) builds the client-side facade from its
        ``InstanceClient`` instead of the reflective one-arg constructor
        — for subclassed/wrapped resources; the replicated state machine
        still resolves from ``resource_type``. The built object must be
        a ``resource_type`` instance (the singleton cache's type check
        stays meaningful). The node-local singleton wins, as in the
        reference: on a cache hit the EXISTING facade is returned and
        ``factory`` is not invoked — pass the factory at first get (or
        use :meth:`create`) when a custom facade matters."""
        cached = self._resources.get(key)
        if cached is not None:
            if not isinstance(cached, resource_type):
                raise ValueError(
                    f"resource '{key}' already open as {type(cached).__name__}")
            return cached
        machine = resource_state_machine_of(resource_type)
        instance_id = await self.client.submit(GetResource(key, machine))
        resource = await self._build_facade(
            InstanceClient(instance_id, self.client,
                           on_delete=lambda: self._evict(key, instance_id)),
            resource_type, factory)
        self._resources[key] = resource
        return resource

    def _evict(self, key: str, instance_id: int) -> None:
        """Drop the get() singleton for a deleted resource (only if the
        cache still holds THAT instance — a re-created resource under the
        same key must not be evicted by a stale facade's delete)."""
        cached = self._resources.get(key)
        if cached is not None and getattr(cached.client, "instance_id",
                                          None) == instance_id:
            del self._resources[key]

    async def create(self, key: str, resource_type: Type[R],
                     factory: Any = None) -> R:
        """Fresh instance with its own virtual session per call
        (reference ``Atomix.create:303-306``; ``factory`` per the
        ``create(key, type, factory)`` overload — see :meth:`get`)."""
        machine = resource_state_machine_of(resource_type)
        instance_id = await self.client.submit(CreateResource(key, machine))
        return await self._build_facade(
            InstanceClient(instance_id, self.client), resource_type, factory)

    async def _do_open(self) -> None:
        await self.client.open()

    async def _do_close(self) -> None:
        self._resources.clear()
        await self.client.close()


class _Builder:
    """Chained builder for API parity with the reference."""

    def __init__(self, cls: type, address: Address | None, members: list[Address]) -> None:
        self._cls = cls
        self._kwargs: dict[str, Any] = {"address": address, "members": members}

    def with_transport(self, transport: Transport) -> "_Builder":
        self._kwargs["transport"] = transport
        return self

    def with_storage(self, storage: Storage) -> "_Builder":
        self._kwargs["storage"] = storage
        return self

    def with_election_timeout(self, timeout: float) -> "_Builder":
        self._kwargs["election_timeout"] = timeout
        return self

    def with_heartbeat_interval(self, interval: float) -> "_Builder":
        self._kwargs["heartbeat_interval"] = interval
        return self

    def with_session_timeout(self, timeout: float) -> "_Builder":
        self._kwargs["session_timeout"] = timeout
        return self

    def with_stats_port(self, port: int,
                        host: str = "127.0.0.1") -> "_Builder":
        """Enable the HTTP stats listener (``server/stats.py``): JSON
        snapshot at ``/stats``, Prometheus text at ``/metrics``, slow
        traces at ``/traces``. Port 0 binds an ephemeral port (read it
        back from ``.stats.port``). Binds loopback by default — the
        surface is unauthenticated; widen ``host`` deliberately."""
        self._kwargs["stats_port"] = port
        self._kwargs["stats_host"] = host
        return self

    def with_groups(self, groups: int) -> "_Builder":
        """Host N Raft groups (keyspace shards) behind this server —
        docs/SHARDING.md. Default: ``COPYCAT_GROUPS`` (1). Must be
        uniform across the cluster."""
        self._kwargs["groups"] = groups
        return self

    def with_executor(self, executor: str,
                      engine_config: Any | None = None) -> "_Builder":
        """Select the resource executor: ``"cpu"`` (default) or ``"tpu"``
        — the vectorized device engine behind the same resource API
        (SURVEY.md §7.1; mirror of ``withStateMachine``,
        ``AtomixReplica.java:374``), on ``engine_config.device`` (``cuda``
        by default). Must be uniform across the cluster."""
        self._kwargs["executor"] = executor
        if engine_config is not None:
            self._kwargs["engine_config"] = engine_config
        return self

    def build(self) -> Any:
        kwargs = dict(self._kwargs)
        if self._cls is AtomixClient:
            kwargs.pop("address", None)
            kwargs.pop("storage", None)
            kwargs.pop("election_timeout", None)
            kwargs.pop("heartbeat_interval", None)
            kwargs.pop("executor", None)
            kwargs.pop("engine_config", None)
            kwargs.pop("stats_port", None)
            kwargs.pop("stats_host", None)
            kwargs.pop("groups", None)
        return self._cls(**kwargs)


class AtomixClient(Atomix):
    """Stateless node: pure client (reference ``AtomixClient.java``)."""

    def __init__(self, members: list[Address], transport: Transport,
                 session_timeout: float = 5.0) -> None:
        super().__init__(RaftClient(members, transport, session_timeout=session_timeout))

    @staticmethod
    def builder(members: list[Address]) -> _Builder:
        return _Builder(AtomixClient, None, members)


class AtomixReplica(Atomix):
    """Stateful node: embedded server + client pinned to it
    (reference ``AtomixReplica.java:45``, ``build():355-379``)."""

    def __init__(
        self,
        address: Address,
        members: list[Address],
        transport: Transport,
        storage: Storage | None = None,
        election_timeout: float = 0.5,
        heartbeat_interval: float = 0.1,
        session_timeout: float = 5.0,
        executor: str = "cpu",
        engine_config: Any | None = None,
        stats_port: int | None = None,
        stats_host: str = "127.0.0.1",
        groups: int | None = None,
    ) -> None:
        machine, groups = _manager_factory(executor, engine_config, groups)
        self.server = RaftServer(
            address, members, transport, machine,
            storage=storage,
            election_timeout=election_timeout, heartbeat_interval=heartbeat_interval,
            session_timeout=session_timeout, groups=groups)
        client = RaftClient(
            list(members), transport, session_timeout=session_timeout,
            connection_strategy=PinnedConnectionStrategy(address))
        super().__init__(client)
        self.address = address
        self._stats_port = stats_port
        self._stats_host = stats_host
        self.stats: Any = None

    @staticmethod
    def builder(address: Address, members: list[Address]) -> _Builder:
        return _Builder(AtomixReplica, address, members)

    async def _do_open(self) -> None:
        # Server first, then the client session (reference AtomixReplica.open).
        self.server.state_machine.prewarm()
        await self.server.open()
        try:
            if self._stats_port is not None:
                from ..server.stats import StatsListener
                self.stats = await StatsListener(
                    self.server, host=self._stats_host,
                    port=self._stats_port).open()
            await self.client.open()
        except BaseException:
            # a failed stats bind / client open must not leak the opened
            # server: Managed never marked US open, so the caller's
            # close() would be a no-op
            if self.stats is not None:
                await self.stats.close()
                self.stats = None
            await self.server.close()
            raise

    async def _do_close(self) -> None:
        self._resources.clear()
        await self.client.close()
        if self.stats is not None:
            await self.stats.close()
            self.stats = None
        await self.server.close()


class AtomixServer(Managed):
    """Standalone server hosting the ResourceManager (no client facade).

    ``executor="tpu"`` keeps the reference's name so its scripts run
    unchanged: in the port it means the device engine
    (``manager/device_executor.py``), which runs the torch ``RaftGroups``
    on ``engine_config.device`` — ``cuda`` unless the
    :class:`~copycat_tpu_torch.manager.device_executor.DeviceEngineConfig`
    names another device, raising without a card."""

    def __init__(
        self,
        address: Address,
        members: list[Address],
        transport: Transport,
        storage: Storage | None = None,
        election_timeout: float = 0.5,
        heartbeat_interval: float = 0.1,
        session_timeout: float = 5.0,
        executor: str = "cpu",
        engine_config: Any | None = None,
        stats_port: int | None = None,
        stats_host: str = "127.0.0.1",
        groups: int | None = None,
        state_machine: Any | None = None,
        name: str = "raft",
    ) -> None:
        super().__init__()
        if state_machine is None:
            machine, groups = _manager_factory(executor, engine_config,
                                               groups)
        else:
            # a custom machine (instance or per-group factory) instead
            # of the ResourceManager catalog — what the deployment
            # plane's machine-spec children host (docs/DEPLOYMENT.md);
            # the group count resolves inside RaftServer as usual
            machine = state_machine
        self.server = RaftServer(
            address, members, transport, machine,
            storage=storage,
            election_timeout=election_timeout, heartbeat_interval=heartbeat_interval,
            session_timeout=session_timeout, groups=groups, name=name)
        self.address = address
        self._stats_port = stats_port
        self._stats_host = stats_host
        self.stats: Any = None

    @staticmethod
    def builder(address: Address, members: list[Address]) -> _Builder:
        return _Builder(AtomixServer, address, members)

    async def _do_open(self) -> None:
        prewarm = getattr(self.server.state_machine, "prewarm", None)
        if callable(prewarm):
            prewarm()
        await self.server.open()
        if self._stats_port is not None:
            from ..server.stats import StatsListener
            try:
                self.stats = await StatsListener(
                    self.server, host=self._stats_host,
                    port=self._stats_port).open()
            except BaseException:
                await self.server.close()  # no leaked half-open node
                raise

    async def _do_close(self) -> None:
        if self.stats is not None:
            await self.stats.close()
            self.stats = None
        await self.server.close()

    async def leave(self) -> None:
        await self.server.leave()
