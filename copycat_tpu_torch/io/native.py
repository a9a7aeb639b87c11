"""Native TCP transport: C++ epoll event loop behind the Transport SPI.

The reference's default transport is Netty — a native-backed event-loop
(`AtomixClient.java:136-144` loads it reflectively). Here the equivalent
runtime component is real native code (``native/copycat_native.cpp``): an
epoll thread owns the sockets and parses the shared wire format
``[u32 len][u8 kind][u64 corr][payload]`` — byte-identical to
:mod:`copycat_tpu_torch.io.tcp`, so native and asyncio endpoints interoperate.
Python only exchanges complete frames with the loop via ctypes
(no pybind11 in the image; plain C ABI).

``NativeTcpTransport`` is a drop-in for ``TcpTransport``; if the shared
library can't be built (no toolchain), importing still works and
``native_available()`` returns False — callers fall back to asyncio TCP.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import pathlib
import subprocess
import threading
from typing import Any, Callable

from ..utils.metrics import MetricsRegistry
from ..utils.tasks import spawn
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

logger = logging.getLogger(__name__)

_REQUEST, _RESPONSE, _ERROR = 0, 1, 2
_ETYPE_ACCEPT, _ETYPE_FRAME, _ETYPE_CLOSE, _ETYPE_CONNECT = 1, 2, 3, 4

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libcopycat_native.so"

_lib: ctypes.CDLL | None = None
_lib_err: str | None = None


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        src = _NATIVE_DIR / "copycat_native.cpp"
        if (not _LIB_PATH.exists()
                or _LIB_PATH.stat().st_mtime < src.stat().st_mtime):
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.cn_new.restype = ctypes.c_void_p
        lib.cn_start.argtypes = [ctypes.c_void_p]
        lib.cn_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int]
        lib.cn_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.cn_send.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_uint8, ctypes.c_uint64,
                                ctypes.c_char_p, ctypes.c_int]
        lib.cn_poll.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_char_p, ctypes.c_int]
        lib.cn_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.cn_shutdown.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as exc:  # toolchain missing — degrade gracefully
        _lib_err = str(exc)
    return _lib


def native_available() -> bool:
    return _load() is not None


class _NativeLoop:
    """Owns one C++ epoll loop + the Python-side poller thread."""

    def __init__(self, metrics: MetricsRegistry | None = None) -> None:
        lib = _load()
        if lib is None:
            raise TransportError(f"native transport unavailable: {_lib_err}")
        m = metrics if metrics is not None else MetricsRegistry()
        self.metrics = m
        self._m_bytes_in = m.counter("bytes_in")
        self._m_bytes_out = m.counter("bytes_out")
        self._m_frames_in = m.counter("frames_in")
        self._m_frames_out = m.counter("frames_out")
        self._m_burst = m.histogram("read_burst_frames")
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.cn_new())
        if lib.cn_start(self._handle) != 0:
            raise TransportError("failed to start native loop thread")
        self._cap = 1 << 20
        self._buf = ctypes.create_string_buffer(self._cap)
        self._routes: dict[int, Callable[[int, int, int, bytes], None]] = {}
        self._accepts: dict[int, Callable[[int], None]] = {}
        self._aio: asyncio.AbstractEventLoop | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poller, daemon=True,
                                        name="copycat-native-poll")
        self._thread.start()

    def bind_asyncio(self, loop: asyncio.AbstractEventLoop) -> None:
        self._aio = loop

    #: max events drained per poller wake — bounds the latency one
    #: burst handoff can add to the event at the back of the queue
    BURST_MAX = 256

    def _poller(self) -> None:
        conn = ctypes.c_int()
        etype = ctypes.c_int()
        kind = ctypes.c_uint8()
        corr = ctypes.c_uint64()

        def poll_one(timeout_ms: int):
            """One cn_poll; None when idle, else the event tuple."""
            while True:
                n = self._lib.cn_poll(self._handle, timeout_ms,
                                      ctypes.byref(conn), ctypes.byref(etype),
                                      ctypes.byref(kind), ctypes.byref(corr),
                                      self._buf, self._cap)
                if n == -1:
                    return None
                if n == -2:  # grow and re-poll; the event was kept queued
                    self._cap = max(self._cap * 2, int(corr.value) + 1)
                    self._buf = ctypes.create_string_buffer(self._cap)
                    continue
                payload = self._buf.raw[:n] if n > 0 else b""
                return (conn.value, etype.value, kind.value,
                        int(corr.value), payload)

        while not self._stop.is_set():
            ev = poll_one(100)
            if ev is None:
                continue
            # Burst handoff: drain everything already queued in the C
            # loop (zero-timeout polls) and cross the thread boundary
            # ONCE — one call_soon_threadsafe per burst instead of per
            # frame kept the poller from scheduling N asyncio callbacks
            # for an N-frame read burst.
            burst = [ev]
            while len(burst) < self.BURST_MAX:
                ev = poll_one(0)
                if ev is None:
                    break
                burst.append(ev)
            self._dispatch_burst(burst)

    def _dispatch_burst(self, burst: list) -> None:
        # poller-thread-only counters (the asyncio side owns the _out
        # pair, so no counter is shared across threads)
        frames = [p for _, etype, _, _, p in burst if etype == _ETYPE_FRAME]
        if frames:
            self._m_frames_in.inc(len(frames))
            self._m_burst.record(len(frames))
            self._m_bytes_in.inc(sum(len(p) for p in frames))
        aio = self._aio
        if aio is None or aio.is_closed():
            return
        # Route lookups must happen IN the asyncio thread: an ACCEPT's
        # callback (which registers the route) and the first FRAME arrive
        # back-to-back from the poller, and in-burst order is preserved
        # by delivering the whole burst inside one loop callback.
        def deliver() -> None:
            for conn, etype, kind, corr, payload in burst:
                # per-event isolation: one raising callback must not drop
                # the rest of the burst (the per-frame call_soon design
                # isolated failures for free; the burst handoff must too)
                try:
                    if etype == _ETYPE_ACCEPT:
                        fn = self._accepts.get(corr)  # corr = listener conn
                        if fn is not None:
                            fn(conn)
                        continue
                    route = self._routes.get(conn)
                    if route is not None:
                        route(etype, kind, corr, payload)
                except Exception:
                    logger.exception(
                        "native poller: event callback failed "
                        "(conn=%d etype=%d)", conn, etype)

        try:
            aio.call_soon_threadsafe(deliver)
        except RuntimeError:  # loop shut down mid-poll
            pass

    # thin C wrappers -----------------------------------------------------
    # The ints below are loop-assigned conn ids (generation-safe), not raw
    # fds: the kernel reuses fd numbers, ids are never reused.
    def listen(self, address: Address) -> int:
        conn = self._lib.cn_listen(self._handle, address.host.encode(),
                                   address.port)
        if conn < 0:
            raise TransportError(f"cannot listen on {address}")
        return conn

    def connect(self, address: Address) -> int:
        conn = self._lib.cn_connect(self._handle, address.host.encode(),
                                    address.port)
        if conn < 0:
            raise TransportError(f"cannot connect to {address}")
        return conn

    def send(self, conn: int, kind: int, corr: int, payload: bytes) -> None:
        if self._lib.cn_send(self._handle, conn, kind, corr, payload,
                             len(payload)) != 0:
            raise ConnectionClosedError("connection closed")
        self._m_frames_out.inc()
        self._m_bytes_out.inc(len(payload))

    def close_conn(self, conn: int) -> None:
        self._lib.cn_close_conn(self._handle, conn)

    def shutdown(self) -> None:
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join(timeout=2)
            self._lib.cn_shutdown(self._handle)


class NativeConnection(Connection):
    """Frame-level I/O lives in C++; request/response correlation here."""

    def __init__(self, loop: _NativeLoop, fd: int, serializer: Serializer,
                 awaits_connect: bool = False) -> None:
        super().__init__()
        self._loop = loop
        self._fd = fd
        self._serializer = serializer
        self._next_id = 0
        self._pending: dict[int, asyncio.Future] = {}
        # Client side: connects are nonblocking in C; completion (or
        # refusal) arrives as an event, awaited before connect() returns
        # so the fail-fast contract of TcpTransport is preserved.
        self._ready: asyncio.Future | None = (
            asyncio.get_running_loop().create_future() if awaits_connect
            else None)
        loop._routes[fd] = self._on_event

    def _on_event(self, etype: int, kind: int, corr: int,
                  payload: bytes) -> None:
        if etype == _ETYPE_CONNECT:
            if self._ready is not None and not self._ready.done():
                self._ready.set_result(True)
            return
        if etype == _ETYPE_CLOSE:
            self._abort()
            return
        if kind == _REQUEST:
            spawn(self._serve(corr, payload), name="native-serve")
            return
        future = self._pending.pop(corr, None)
        if future is not None and not future.done():
            if kind == _ERROR:
                future.set_exception(
                    TransportError(self._serializer.read(payload)))
            else:
                future.set_result(self._serializer.read(payload))

    async def _serve(self, corr: int, payload: bytes) -> None:
        try:
            result = await self._handle(self._serializer.read(payload))
            self._loop.send(self._fd, _RESPONSE, corr,
                            self._serializer.write(result))
        except Exception as exc:
            try:
                self._loop.send(self._fd, _ERROR, corr, self._serializer.write(
                    f"{type(exc).__name__}: {exc}"))
            except Exception:
                pass

    async def send(self, message: Any) -> Any:
        if self.closed:
            raise ConnectionClosedError("connection closed")
        self._next_id += 1
        corr = self._next_id
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[corr] = future
        try:
            self._loop.send(self._fd, _REQUEST, corr,
                            self._serializer.write(message))
            return await future
        finally:
            # Same stranded-correlation guard as TcpConnection.send: a
            # cancelled/timed-out send must not leak its slot in
            # _pending until the connection closes.
            self._pending.pop(corr, None)

    def _abort(self) -> None:
        self._loop._routes.pop(self._fd, None)
        if self._ready is not None and not self._ready.done():
            self._ready.set_exception(
                ConnectionClosedError("connect failed"))
        for future in self._pending.values():
            if not future.done():
                future.set_exception(ConnectionClosedError("connection closed"))
        self._pending.clear()
        self._fire_close()

    async def close(self) -> None:
        if not self.closed:
            self._loop.close_conn(self._fd)
            self._abort()


class NativeTcpClient(Client):
    def __init__(self, loop: _NativeLoop) -> None:
        self._loop = loop
        self._connections: list[NativeConnection] = []

    async def connect(self, address: Address) -> Connection:
        aio = asyncio.get_running_loop()
        self._loop.bind_asyncio(aio)
        self._loop.metrics.counter("connects").inc()
        # Resolve on the asyncio resolver (thread pool) so a slow DNS
        # lookup never blocks the event loop; C gets a numeric host.
        import socket
        infos = await aio.getaddrinfo(address.host or "127.0.0.1",
                                      address.port, family=socket.AF_INET,
                                      type=socket.SOCK_STREAM)
        numeric = Address(infos[0][4][0], address.port)
        fd = self._loop.connect(numeric)
        conn = NativeConnection(self._loop, fd, Serializer(),
                                awaits_connect=True)
        try:
            await conn._ready  # fail-fast: refused connects raise here
        except ConnectionClosedError as exc:
            raise TransportError(f"cannot connect to {address}") from exc
        self._connections.append(conn)
        conn.on_close(lambda c: self._connections.remove(c)
                      if c in self._connections else None)
        return conn

    async def close(self) -> None:
        for conn in list(self._connections):
            await conn.close()
        self._connections.clear()


class NativeTcpServer(Server):
    def __init__(self, loop: _NativeLoop) -> None:
        self._loop = loop
        self._listener: int | None = None
        self._connections: list[NativeConnection] = []

    async def listen(self, address: Address,
                     on_connect: Callable[[Connection], None]) -> None:
        aio = asyncio.get_running_loop()
        self._loop.bind_asyncio(aio)
        if address.host:
            import socket
            infos = await aio.getaddrinfo(address.host, address.port,
                                          family=socket.AF_INET,
                                          type=socket.SOCK_STREAM)
            address = Address(infos[0][4][0], address.port)
        self._listener = self._loop.listen(address)

        def accept(fd: int) -> None:
            self._loop.metrics.counter("accepts").inc()
            conn = NativeConnection(self._loop, fd, Serializer())
            self._connections.append(conn)
            conn.on_close(lambda c: self._connections.remove(c)
                          if c in self._connections else None)
            on_connect(conn)

        self._loop._accepts[self._listener] = accept

    async def close(self) -> None:
        for conn in list(self._connections):
            await conn.close()
        self._connections.clear()
        if self._listener is not None:
            self._loop._accepts.pop(self._listener, None)
            self._loop.close_conn(self._listener)
            self._listener = None


class NativeTcpTransport(Transport):
    """Drop-in for ``TcpTransport`` with the I/O path in C++."""

    def __init__(self) -> None:
        self.metrics = MetricsRegistry()
        self._loop = _NativeLoop(self.metrics)

    def client(self) -> Client:
        return NativeTcpClient(self._loop)

    def server(self) -> Server:
        return NativeTcpServer(self._loop)

    def shutdown(self) -> None:
        """Stop the epoll thread (call when done with the transport)."""
        self._loop.shutdown()
