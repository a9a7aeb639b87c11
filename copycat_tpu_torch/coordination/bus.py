"""Direct node-to-node message bus (reference ``DistributedMessageBus.java:74``).

Only MEMBERSHIP and the consumer REGISTRY go through the Raft log; message
payloads travel over DIRECT transport connections between buses (the
reference dials raw Catalyst connections; here the same Transport SPI).  In
the TPU design this is the host-side DCN path (SURVEY.md §5.8).
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Any, Callable

from ..io.serializer import serialize_with
from ..io.transport import Address, Connection, Transport, TransportError
from ..protocol.messages import Message as _WireMessage
from ..resource.resource import AbstractResource, resource_info
from . import commands as c
from .state import MessageBusState


@serialize_with(108)
class Message(_WireMessage):
    """(topic, body) value type (reference ``Message.java:30``)."""

    _fields = ("topic", "body")

    def __init__(self, topic: str = "", body: Any = None) -> None:
        self.topic = topic
        self.body = body


class MessageProducer:
    """Round-robins messages over the topic's consumer addresses."""

    def __init__(self, bus: "DistributedMessageBus", topic: str) -> None:
        self._bus = bus
        self.topic = topic
        self._rr = itertools.count()

    async def send(self, body: Any) -> Any:
        addresses = self._bus._consumers.get(self.topic)
        if not addresses:
            raise TransportError(f"no consumers for topic '{self.topic}'")
        address = addresses[next(self._rr) % len(addresses)]
        connection = await self._bus._connection_to(address)
        return await connection.send(Message(self.topic, body))

    async def close(self) -> None:
        pass


class MessageConsumer:
    """A registered handler for one topic on this bus node."""

    def __init__(self, bus: "DistributedMessageBus", topic: str,
                 handler: Callable[[Any], Any]) -> None:
        self._bus = bus
        self.topic = topic
        self.handler = handler

    async def close(self) -> None:
        await self._bus._unregister_consumer(self)


@resource_info(state_machine=MessageBusState)
class DistributedMessageBus(AbstractResource):
    def __init__(self, client: Any) -> None:
        super().__init__(client)
        self._transport: Transport | None = None
        self._server = None
        self._address: Address | None = None
        self._consumers: dict[str, list[Address]] = {}  # replicated registry view
        self._local_consumers: dict[str, MessageConsumer] = {}
        self._connections: dict[Address, Connection] = {}
        session = self.session()
        session.on_event("register", self._on_register)
        session.on_event("unregister", self._on_unregister)

    # -- registry events ---------------------------------------------------

    def _on_register(self, info: c.ConsumerInfo) -> None:
        self._consumers.setdefault(info.topic, []).append(info.address)

    def _on_unregister(self, info: c.ConsumerInfo) -> None:
        addresses = self._consumers.get(info.topic)
        if addresses and info.address in addresses:
            addresses.remove(info.address)
            if not addresses:
                del self._consumers[info.topic]

    # -- lifecycle ---------------------------------------------------------

    async def open(self, address: Address, transport: Transport) -> "DistributedMessageBus":
        """Start this bus node: listen for direct connections + join the
        replicated registry (reference ``open(Address)``)."""
        self._transport = transport
        self._address = address
        self._server = transport.server()
        await self._server.listen(address, self._accept)
        snapshot = await self.submit(c.BusJoin(address=address))
        for topic, addresses in (snapshot or {}).items():
            self._consumers.setdefault(topic, []).extend(addresses)
        return self

    async def close_bus(self) -> None:
        await self.submit(c.BusLeave())
        for connection in list(self._connections.values()):
            await connection.close()
        self._connections.clear()
        if self._server is not None:
            await self._server.close()
            self._server = None

    def _accept(self, connection: Connection) -> None:
        connection.handler(Message, self._on_message)

    async def _on_message(self, message: Message) -> Any:
        consumer = self._local_consumers.get(message.topic)
        if consumer is None:
            raise TransportError(f"no consumer for topic '{message.topic}'")
        result = consumer.handler(message.body)
        if asyncio.iscoroutine(result):
            result = await result
        return result

    # -- producers/consumers ----------------------------------------------

    async def producer(self, topic: str) -> MessageProducer:
        return MessageProducer(self, topic)

    async def consumer(self, topic: str, handler: Callable[[Any], Any]) -> MessageConsumer:
        if self._address is None:
            raise RuntimeError("open(address, transport) the bus first")
        consumer = MessageConsumer(self, topic, handler)
        self._local_consumers[topic] = consumer
        await self.submit(c.BusRegister(topic=topic))
        return consumer

    async def _unregister_consumer(self, consumer: MessageConsumer) -> None:
        if self._local_consumers.get(consumer.topic) is consumer:
            del self._local_consumers[consumer.topic]
            await self.submit(c.BusUnregister(topic=consumer.topic))

    # -- direct connections ------------------------------------------------

    async def _connection_to(self, address: Address) -> Connection:
        connection = self._connections.get(address)
        if connection is not None and not connection.closed:
            return connection
        assert self._transport is not None
        connection = await self._transport.client().connect(address)
        self._connections[address] = connection
        return connection
