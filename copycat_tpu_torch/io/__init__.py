"""I/O substrate (Catalyst equivalent): serialization + pluggable async transport.

Mirrors the consumed Catalyst API surface (SURVEY.md §2.3): ``Serializer`` with
a ``@SerializeWith(id=...)`` type-id registry, ``BufferInput/Output`` typed
binary buffers, ``Transport{client(), server()}`` with async connect/listen/
send/handler, and the in-memory ``LocalTransport``/``LocalServerRegistry`` used
by every reference test.
"""

from .buffer import BufferInput, BufferOutput
from .serializer import Serializer, serialize_with, CatalystSerializable
from .transport import Address, Transport, Client, Server, Connection, TransportError
from .local import LocalTransport, LocalServerRegistry

__all__ = [
    "BufferInput",
    "BufferOutput",
    "Serializer",
    "serialize_with",
    "CatalystSerializable",
    "Address",
    "Transport",
    "Client",
    "Server",
    "Connection",
    "TransportError",
    "LocalTransport",
    "LocalServerRegistry",
]
