"""TCP transport over asyncio streams (the reference's NettyTransport role).

Frames: ``[u32 length][u8 kind][u64 correlation id][payload]`` where kind is
REQUEST / RESPONSE / ERROR.  Payloads are serialized with the shared type-id
serializer, so anything that crosses LocalTransport crosses TCP identically.
This is the DCN/gRPC-role host-side transport of the TPU design (SURVEY.md
§5.8): client sessions and cross-slice traffic ride here, while intra-step
quorum traffic rides ICI collectives inside the compiled engine.

Burst handoff: the read loop drains whole socket reads and walks EVERY
complete frame in one pass — through the native codec's
``decode_frames`` (C: header walk + per-frame payload decode in one
call) when the extension is built, else a Python ``struct`` walk. A
burst of N frames costs one ``read()`` await + one frame walk instead
of 2N ``readexactly`` awaits, which is where the per-message asyncio
scheduling cost of the old loop lived. Handlers still run as
independent tasks (a burst must not serialize request handling — a
blocking command must never delay a keep-alive sharing its connection).
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, Callable

from ..utils.metrics import MetricsRegistry
from ..utils.tasks import spawn
from .codec import codec
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

_HEADER = struct.Struct(">IBQ")
_REQUEST, _RESPONSE, _ERROR = 0, 1, 2


class TcpConnection(Connection):
    def __init__(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
        serializer: Serializer, metrics: MetricsRegistry | None = None,
    ) -> None:
        super().__init__()
        self._reader = reader
        self._writer = writer
        self._serializer = serializer
        self._next_id = 0
        self._pending: dict[int, asyncio.Future] = {}
        # Transport-shared registry (TcpTransport.metrics); the counter
        # objects are cached so the read/write loops pay one attr + int
        # add per event, never a registry lookup.
        m = metrics if metrics is not None else MetricsRegistry()
        self._m_bytes_in = m.counter("bytes_in")
        self._m_bytes_out = m.counter("bytes_out")
        self._m_frames_in = m.counter("frames_in")
        self._m_frames_out = m.counter("frames_out")
        self._m_burst = m.histogram("read_burst_frames")
        self._reader_task = spawn(self._read_loop(), name="tcp-read-loop")

    def _walk_frames(self, buf: bytes | bytearray) -> tuple[list, int]:
        """Every complete frame in ``buf`` as ``(kind, corr, message,
        ok)`` records plus the bytes consumed. The C walk handles the
        whole burst in one call; any frame it cannot express (>64-bit
        ints, unregistered types, torn payload) re-runs the burst in
        Python, where per-frame decode errors become error records so
        one bad frame fails one request, not the connection."""
        c = codec()
        if c is not None:
            try:
                frames, consumed = c.decode_frames(buf)
                return [(k, co, m, True) for k, co, m in frames], consumed
            except Exception:
                pass
        frames: list = []
        pos = 0
        n = len(buf)
        while pos + _HEADER.size <= n:
            length, kind, corr = _HEADER.unpack_from(buf, pos)
            end = pos + _HEADER.size + length
            if end > n:
                break
            # bytes() copy: the read loop hands a mutable bytearray, and
            # decoded byte-typed fields must stay `bytes` downstream
            payload = bytes(buf[pos + _HEADER.size:end])
            try:
                frames.append((kind, corr, self._serializer.read(payload),
                               True))
            except Exception as exc:  # noqa: BLE001 — marshalled per frame
                frames.append((kind, corr, exc, False))
            pos = end
        return frames, pos

    async def _read_loop(self) -> None:
        # bytearray accumulation: `+=` is amortized O(n) and `del` of the
        # consumed prefix is linear, so a frame spanning many 64 KiB
        # reads costs one pass — bytes concatenation per chunk re-copied
        # the whole pending frame every read (quadratic in frame size)
        buf = bytearray()
        try:
            while True:
                chunk = await self._reader.read(1 << 16)
                if not chunk:
                    break
                self._m_bytes_in.inc(len(chunk))
                buf += chunk
                frames, consumed = self._walk_frames(buf)
                if consumed:
                    del buf[:consumed]
                if frames:
                    self._m_frames_in.inc(len(frames))
                    self._m_burst.record(len(frames))
                for kind, corr, message, ok in frames:
                    if kind == _REQUEST:
                        if ok:
                            spawn(self._serve(corr, message),
                                  name="tcp-serve")
                        else:  # decode error: fail THIS request only
                            self._write_error(corr, message)
                    else:
                        future = self._pending.pop(corr, None)
                        if future is not None and not future.done():
                            if not ok:
                                future.set_exception(TransportError(
                                    f"{type(message).__name__}: {message}"))
                            elif kind == _ERROR:
                                future.set_exception(TransportError(message))
                            else:
                                future.set_result(message)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            self._abort()

    async def _serve(self, corr: int, message: Any) -> None:
        try:
            result = await self._handle(message)
            self._write_message(_RESPONSE, corr, result)
        except Exception as exc:  # marshal handler errors back to the caller
            self._write_error(corr, exc)

    def _write_error(self, corr: int, exc: Any) -> None:
        try:
            self._write_message(_ERROR, corr,
                                f"{type(exc).__name__}: {exc}")
        except Exception:
            pass

    def _write_frame(self, kind: int, corr: int, payload: bytes) -> None:
        if self.closed:
            raise ConnectionClosedError("connection closed")
        self._m_frames_out.inc()
        self._m_bytes_out.inc(_HEADER.size + len(payload))
        self._writer.write(_HEADER.pack(len(payload), kind, corr) + payload)

    def _write_message(self, kind: int, corr: int, message: Any) -> None:
        """Frame + encode in one C pass when the codec is available (the
        header pack and bytes concat disappear into ``encode_frames``)."""
        if self.closed:
            raise ConnectionClosedError("connection closed")
        c = codec()
        if c is not None:
            try:
                data = c.encode_frames([(kind, corr, message)])
                self._writer.write(data)
                # count AFTER the write: a raising write falls through to
                # the Python path, which counts the frame itself — counting
                # first would tally one logical frame twice
                self._m_frames_out.inc()
                self._m_bytes_out.inc(len(data))
                return
            except Exception:  # Fallback etc. — the Python path decides
                pass
        self._write_frame(kind, corr, self._serializer.write(message))

    async def send(self, message: Any) -> Any:
        if self.closed:
            raise ConnectionClosedError("connection closed")
        self._next_id += 1
        corr = self._next_id
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[corr] = future
        try:
            self._write_message(_REQUEST, corr, message)
            await self._writer.drain()
            return await future
        finally:
            # A caller-side cancellation (asyncio.wait_for timeout around
            # send — the replication and leadership-confirm paths) must
            # not strand the correlation in _pending until the connection
            # closes: pipelined peers issue thousands of correlated sends
            # per connection, and each stranded future is leaked memory
            # plus a slot the late response will never find. After a
            # normal response the read loop already popped corr — no-op.
            self._pending.pop(corr, None)

    def _abort(self) -> None:
        for future in self._pending.values():
            if not future.done():
                future.set_exception(ConnectionClosedError("connection closed"))
        self._pending.clear()
        self._fire_close()

    async def close(self) -> None:
        if not self.closed:
            self._fire_close()
            self._reader_task.cancel()
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionResetError, OSError):
                pass
        self._abort()


class TcpClient(Client):
    def __init__(self, serializer_factory: Callable[[], Serializer],
                 metrics: MetricsRegistry | None = None) -> None:
        self._serializer_factory = serializer_factory
        self._metrics = metrics
        self._connections: list[TcpConnection] = []

    async def connect(self, address: Address) -> Connection:
        reader, writer = await asyncio.open_connection(address.host, address.port)
        if self._metrics is not None:
            self._metrics.counter("connects").inc()
        conn = TcpConnection(reader, writer, self._serializer_factory(),
                             self._metrics)
        self._connections.append(conn)
        conn.on_close(lambda c: self._connections.remove(c) if c in self._connections else None)
        return conn

    async def close(self) -> None:
        for conn in list(self._connections):
            await conn.close()
        self._connections.clear()


class TcpServer(Server):
    def __init__(self, serializer_factory: Callable[[], Serializer],
                 metrics: MetricsRegistry | None = None) -> None:
        self._serializer_factory = serializer_factory
        self._metrics = metrics
        self._server: asyncio.AbstractServer | None = None
        self._connections: list[TcpConnection] = []

    async def listen(self, address: Address, on_connect: Callable[[Connection], None]) -> None:
        def accept(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
            if self._metrics is not None:
                self._metrics.counter("accepts").inc()
            conn = TcpConnection(reader, writer, self._serializer_factory(),
                                 self._metrics)
            self._connections.append(conn)
            conn.on_close(
                lambda c: self._connections.remove(c) if c in self._connections else None
            )
            on_connect(conn)

        self._server = await asyncio.start_server(accept, address.host, address.port)

    async def close(self) -> None:
        for conn in list(self._connections):
            await conn.close()
        self._connections.clear()
        if self._server is not None:
            self._server.close()
            # Python >=3.12 wait_closed() also waits for client handlers; all
            # connections are already closed above, but guard with a timeout in
            # case a transport lingers in the event loop.
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except (TimeoutError, asyncio.TimeoutError):
                pass


class TcpTransport(Transport):
    """Real-network transport; drop-in for LocalTransport."""

    def __init__(self) -> None:
        self._factory = Serializer
        #: shared by every connection this transport hands out
        #: (bytes/frames in/out, read-burst histogram, connects/accepts)
        self.metrics = MetricsRegistry()

    def client(self) -> Client:
        return TcpClient(self._factory, self.metrics)

    def server(self) -> Server:
        return TcpServer(self._factory, self.metrics)
