"""In-memory transport (Catalyst ``LocalTransport``/``LocalServerRegistry``).

Hosts N logical nodes in one process — the substrate for the entire test
pyramid, exactly as in the reference where every multi-node test runs a real
Raft cluster over ``LocalTransport`` (reference ``AbstractServerTest.java:53-57``,
SURVEY.md §4).  Messages are round-tripped through the serializer on every hop
so wire-format bugs surface in unit tests, not just over TCP.
"""

from __future__ import annotations

import asyncio
import random
from typing import Any, Callable, Iterable

from ..utils.metrics import MetricsRegistry
from .serializer import Serializer
from .transport import (
    Address,
    Client,
    Connection,
    ConnectionClosedError,
    Server,
    Transport,
    TransportError,
)


class NetworkNemesis:
    """Fault plan for a :class:`LocalServerRegistry` network: partitions,
    one-directional blocks, message loss and delay.

    The reference's server tests run real consensus over a fake network
    they control (``AbstractServerTest.java:53-57``) and the project
    claims Jepsen-tested behavior (reference ``README.md:8``); this is
    the control plane that lets the HOST stack (asyncio Raft + SPI) be
    driven through the same fault envelope the device plane's
    ``deliver`` masks provide (SURVEY.md §5.3).

    Semantics (evaluated per message, so live connections are affected):

    - ``partition(sides...)``: only endpoints within the same side can
      exchange messages. Endpoints with no address (anonymous clients)
      or outside every side reach everyone — the Jepsen client model.
    - ``block(src, dst)``: one-directional edge cut (asymmetric
      partitions — the classic stale-leader-lease trap).
    - ``set_loss(request=, response=)``: independent drop probabilities
      for the request leg and the response leg. A dropped RESPONSE means
      the handler RAN but the sender sees a transport error — the
      at-most-once ambiguity exactly-once machinery must survive.
    - ``set_delay(min_s, max_s)``: uniform per-message latency.

    Faults surface to senders as :class:`TransportError` (what a real
    dead/slow link produces through the TCP transport's timeouts).
    """

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)
        self._sides: list[frozenset[Address]] = []
        self._blocked: set[tuple[Address, Address]] = set()
        self._request_loss = 0.0
        self._response_loss = 0.0
        self._delay = (0.0, 0.0)
        #: counters for test assertions / soak reports
        self.delivered = 0
        self.dropped_requests = 0
        self.dropped_responses = 0

    # -- fault plan -------------------------------------------------------

    def partition(self, *sides: Iterable[Address]) -> None:
        """Replace the current partition with ``sides`` (each an iterable
        of addresses); messages flow only within a side."""
        self._sides = [frozenset(s) for s in sides]

    def block(self, src: Address, dst: Address) -> None:
        """Cut the ``src -> dst`` direction only."""
        self._blocked.add((src, dst))

    def set_loss(self, request: float = 0.0, response: float = 0.0) -> None:
        self._request_loss = request
        self._response_loss = response

    def set_delay(self, min_s: float = 0.0, max_s: float | None = None
                  ) -> None:
        """Uniform per-message delay in [min_s, max_s]; ``set_delay(x)``
        means a fixed ``x``-second delay."""
        if max_s is None:
            max_s = min_s
        if min_s < 0 or max_s < min_s:
            raise ValueError(f"bad delay range [{min_s}, {max_s}]")
        self._delay = (min_s, max_s)

    def heal(self) -> None:
        """Clear every fault (partitions, blocks, loss, delay)."""
        self._sides = []
        self._blocked.clear()
        self._request_loss = self._response_loss = 0.0
        self._delay = (0.0, 0.0)

    # -- per-message evaluation ------------------------------------------

    def allowed(self, src: Address | None, dst: Address | None) -> bool:
        if src is not None and dst is not None:
            if (src, dst) in self._blocked:
                return False
            # endpoints listed in some side may only talk within their
            # side; anything unlisted (anonymous clients, unnamed nodes)
            # reaches everyone — the Jepsen client model
            src_side = next((i for i, s in enumerate(self._sides)
                             if src in s), None)
            dst_side = next((i for i, s in enumerate(self._sides)
                             if dst in s), None)
            if src_side is not None and dst_side is not None \
                    and src_side != dst_side:
                return False
        return True

    def delay_s(self) -> float:
        lo, hi = self._delay
        return self._rng.uniform(lo, hi) if hi > 0 else 0.0

    def drop_request(self, src: Address | None, dst: Address | None) -> bool:
        if not self.allowed(src, dst):
            self.dropped_requests += 1
            return True
        if self._request_loss and self._rng.random() < self._request_loss:
            self.dropped_requests += 1
            return True
        return False

    def drop_response(self, src: Address | None, dst: Address | None) -> bool:
        # the response leg travels dst -> src
        if not self.allowed(dst, src):
            self.dropped_responses += 1
            return True
        if self._response_loss and self._rng.random() < self._response_loss:
            self.dropped_responses += 1
            return True
        return False


class LocalServerRegistry:
    """Shared address -> listening-server map (one per simulated network)."""

    def __init__(self) -> None:
        self._servers: dict[Address, "LocalServer"] = {}
        self.nemesis: NetworkNemesis | None = None

    def attach_nemesis(self, nemesis: NetworkNemesis | None = None
                       ) -> NetworkNemesis:
        """Install (and return) a fault plan every connection on this
        network consults per message."""
        self.nemesis = nemesis or NetworkNemesis()
        return self.nemesis

    def register(self, address: Address, server: "LocalServer") -> None:
        self._servers[address] = server

    def unregister(self, address: Address) -> None:
        self._servers.pop(address, None)

    def lookup(self, address: Address) -> "LocalServer | None":
        return self._servers.get(address)


class LocalConnection(Connection):
    """One endpoint of an in-memory duplex channel."""

    def __init__(self, serializer: Serializer,
                 registry: "LocalServerRegistry | None" = None,
                 local_address: Address | None = None,
                 remote_address: Address | None = None,
                 metrics: MetricsRegistry | None = None) -> None:
        super().__init__()
        self._serializer = serializer
        self._registry = registry
        self.local_address = local_address
        self.remote_address = remote_address
        self.peer: "LocalConnection | None" = None
        m = metrics if metrics is not None else MetricsRegistry()
        self._m_bytes_out = m.counter("bytes_out")
        self._m_frames_out = m.counter("frames_out")
        self._m_bytes_in = m.counter("bytes_in")
        self._m_frames_in = m.counter("frames_in")

    async def send(self, message: Any) -> Any:
        peer = self.peer
        if self.closed or peer is None or peer.closed:
            raise ConnectionClosedError("connection closed")
        nem = self._registry.nemesis if self._registry is not None else None
        if nem is not None:
            d = nem.delay_s()
            if d:
                await asyncio.sleep(d)
            if nem.drop_request(self.local_address, self.remote_address):
                raise TransportError(
                    f"nemesis: request {self.local_address} -> "
                    f"{self.remote_address} dropped")
        # Round-trip through the wire format for fidelity with real transports.
        wire = self._serializer.write(message)
        self._m_frames_out.inc()
        self._m_bytes_out.inc(len(wire))
        peer._m_frames_in.inc()
        peer._m_bytes_in.inc(len(wire))
        delivered = peer._serializer.read(wire)
        try:
            result = await peer._handle(delivered)
        except TransportError:
            raise
        except Exception as exc:
            # Same marshalling contract as TcpConnection: handler errors cross
            # the transport as TransportError("Type: message").
            raise TransportError(f"{type(exc).__name__}: {exc}") from exc
        if nem is not None:
            # symmetric per-message delay: the response leg pays the same
            # latency draw as the request leg (a real network delays both
            # directions), and pays it BEFORE the drop evaluation — a
            # dropped response still spent its wire time
            d = nem.delay_s()
            if d:
                await asyncio.sleep(d)
        if nem is not None and nem.drop_response(self.local_address,
                                                 self.remote_address):
            # the handler RAN; only the reply is lost — the sender must
            # treat the op's fate as unknown (at-most-once ambiguity)
            raise TransportError(
                f"nemesis: response {self.remote_address} -> "
                f"{self.local_address} dropped")
        if nem is not None:
            nem.delivered += 1
        if result is None:
            return None
        # response leg: the peer SENDS, we receive — counted like the
        # request leg so cross-transport attribution (local vs tcp in
        # the spi bench) compares like with like
        wire = peer._serializer.write(result)
        peer._m_frames_out.inc()
        peer._m_bytes_out.inc(len(wire))
        self._m_frames_in.inc()
        self._m_bytes_in.inc(len(wire))
        return self._serializer.read(wire)

    async def close(self) -> None:
        peer = self.peer
        self._fire_close()
        if peer is not None and not peer.closed:
            peer._fire_close()


class LocalClient(Client):
    def __init__(self, registry: LocalServerRegistry, serializer: Serializer,
                 local_address: Address | None = None,
                 metrics: MetricsRegistry | None = None) -> None:
        self._registry = registry
        self._serializer = serializer
        self._local_address = local_address
        self._metrics = metrics
        self._connections: list[LocalConnection] = []

    async def connect(self, address: Address) -> Connection:
        server = self._registry.lookup(address)
        if server is None or server.closed:
            raise TransportError(f"no server listening at {address}")
        nem = self._registry.nemesis
        if nem is not None and not nem.allowed(self._local_address, address):
            raise TransportError(
                f"nemesis: dial {self._local_address} -> {address} blocked")
        if self._metrics is not None:
            self._metrics.counter("connects").inc()
        local = LocalConnection(self._serializer, self._registry,
                                self._local_address, address, self._metrics)
        remote = LocalConnection(server._serializer, self._registry,
                                 address, self._local_address,
                                 server._metrics)
        local.peer = remote
        remote.peer = local
        self._connections.append(local)
        local.on_close(lambda c: self._connections.remove(c) if c in self._connections else None)
        # Give the server a chance to register handlers before first send.
        server._accept(remote)
        await asyncio.sleep(0)
        return local

    async def close(self) -> None:
        for conn in list(self._connections):
            await conn.close()
        self._connections.clear()


class LocalServer(Server):
    def __init__(self, registry: LocalServerRegistry, serializer: Serializer,
                 metrics: MetricsRegistry | None = None) -> None:
        self._registry = registry
        self._serializer = serializer
        self._metrics = metrics
        self._address: Address | None = None
        self._on_connect: Callable[[Connection], None] | None = None
        self._connections: list[LocalConnection] = []
        self.closed = False

    async def listen(self, address: Address, on_connect: Callable[[Connection], None]) -> None:
        self._address = address
        self._on_connect = on_connect
        self._registry.register(address, self)

    def _accept(self, connection: LocalConnection) -> None:
        assert self._on_connect is not None
        self._connections.append(connection)
        connection.on_close(
            lambda c: self._connections.remove(c) if c in self._connections else None
        )
        self._on_connect(connection)

    async def close(self) -> None:
        self.closed = True
        if self._address is not None:
            self._registry.unregister(self._address)
        for conn in list(self._connections):
            await conn.close()
        self._connections.clear()


class LocalTransport(Transport):
    def __init__(self, registry: LocalServerRegistry,
                 serializer: Serializer | None = None,
                 local_address: Address | None = None) -> None:
        self._registry = registry
        self._serializer = serializer or Serializer()
        # The identity this node's DIALS carry (partition membership for
        # client-side connections). Servers are identified by the address
        # they listen on; anonymous transports (no local_address) reach
        # every side of a partition — the Jepsen client model.
        self._local_address = local_address
        #: shared by every endpoint this transport hands out
        self.metrics = MetricsRegistry()

    def client(self) -> Client:
        return LocalClient(self._registry, Serializer(),
                           self._local_address, self.metrics)

    def server(self) -> Server:
        return LocalServer(self._registry, Serializer(), self.metrics)
