"""Async transport SPI (Catalyst ``Transport``/``Client``/``Server``/``Connection``).

The reference's seam (SURVEY.md §5.8): ``Transport{client(), server()}``,
``Client.connect(Address) -> Connection``, ``Server.listen(Address, on_connect)``,
``Connection.send(msg) -> response`` / ``Connection.handler(type, fn)``.
Implementations: :mod:`local` (in-memory, the test substrate) and :mod:`tcp`
(asyncio streams over real sockets — the reference's NettyTransport role).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

from .serializer import serialize_with
from .buffer import BufferInput, BufferOutput


class TransportError(Exception):
    pass


class ConnectionClosedError(TransportError):
    pass


@serialize_with(12)
@dataclass(frozen=True)
class Address:
    """A host:port endpoint (Catalyst ``Address`` equivalent)."""

    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"

    @staticmethod
    def parse(value: str) -> "Address":
        host, _, port = value.rpartition(":")
        return Address(host, int(port))

    def write_object(self, buf: BufferOutput, serializer: Any) -> None:
        buf.write_utf8(self.host)
        buf.write_i32(self.port)

    def read_object(self, buf: BufferInput, serializer: Any) -> None:
        object.__setattr__(self, "host", buf.read_utf8())
        object.__setattr__(self, "port", buf.read_i32())


Handler = Callable[[Any], Awaitable[Any]]


class Connection(abc.ABC):
    """A bidirectional message channel with request/response correlation.

    ``send`` delivers a message to the peer and resolves with the peer handler's
    return value.  A handler exception crosses the transport as
    ``TransportError("Type: message")`` — identically on every transport, so
    code written against LocalTransport behaves the same over TCP.  Handlers are
    registered per message type; dispatch walks the MRO so a handler registered
    on a base class sees subclasses too.
    """

    def __init__(self) -> None:
        self._handlers: dict[type, Handler] = {}
        self._close_listeners: list[Callable[["Connection"], None]] = []
        self.closed = False

    def handler(self, msg_type: type, fn: Handler) -> None:
        self._handlers[msg_type] = fn

    def on_close(self, fn: Callable[["Connection"], None]) -> None:
        self._close_listeners.append(fn)

    def _dispatch_handler(self, message: Any) -> Handler | None:
        for cls in type(message).__mro__:
            fn = self._handlers.get(cls)
            if fn is not None:
                return fn
        return None

    async def _handle(self, message: Any) -> Any:
        fn = self._dispatch_handler(message)
        if fn is None:
            raise TransportError(f"no handler for {type(message).__name__}")
        return await fn(message)

    def _fire_close(self) -> None:
        if not self.closed:
            self.closed = True
            for fn in list(self._close_listeners):
                fn(self)

    @abc.abstractmethod
    async def send(self, message: Any) -> Any: ...

    @abc.abstractmethod
    async def close(self) -> None: ...


class Client(abc.ABC):
    @abc.abstractmethod
    async def connect(self, address: Address) -> Connection: ...

    @abc.abstractmethod
    async def close(self) -> None: ...


class Server(abc.ABC):
    @abc.abstractmethod
    async def listen(self, address: Address, on_connect: Callable[[Connection], None]) -> None: ...

    @abc.abstractmethod
    async def close(self) -> None: ...


class Transport(abc.ABC):
    """Factory for clients and servers sharing one substrate."""

    @abc.abstractmethod
    def client(self) -> Client: ...

    @abc.abstractmethod
    def server(self) -> Server: ...
