"""Opt-in live stats surface: an HTTP listener over a running server.

The observability plane's exposition layer (docs/OBSERVABILITY.md): a
tiny dependency-free HTTP/1.1 responder on asyncio streams (the stats
port must work even when the cluster transport is LocalTransport or the
native loop — it is always a real TCP socket, so ``curl`` and Prometheus
can scrape a test cluster).

Routes:

- ``/stats`` (also ``/`` and ``/stats.json``) — the full JSON snapshot
  (``RaftServer.stats_snapshot()``: node/role/term/leader + raft,
  transport and manager registries).
- ``/metrics`` — Prometheus text exposition: the raft registry under
  ``copycat_*``, the transport's under ``copycat_transport_*``, the
  resource manager's under ``copycat_manager_*``.
- ``/health`` — the health plane's verdict (``utils/health.py``): a
  fresh detector evaluation — status/reasons/per-group breakdown with
  the evidence series attached; ``{"status": "disabled"}`` under
  ``COPYCAT_HEALTH=0``.
- ``/healthz`` — minimal liveness: 200 + role/term only, no snapshot
  cost — safe for high-frequency probes.
- ``/traces`` — JSON dump of the slowest traced requests
  (``utils/tracing.py``); ``/traces.txt`` for the human rendering.
- ``/traces/<id>`` — THIS member's spans for one trace id: the
  collection route ``copycat-tpu trace`` fans out across members to
  assemble the cross-member causal waterfall.
- ``/flight`` — the device-plane flight recorder (telemetry spikes,
  injected faults, invariant violations in one fault-correlated ring —
  ``models/telemetry.py``); ``/flight.txt`` for the human rendering.
  Active when the server runs the TPU executor with telemetry on
  (``COPYCAT_TELEMETRY=1`` / ``DeviceEngineConfig(telemetry=True)``).
  With the health plane on, also carries the durable black-box
  (``utils/health.py``): the previous life's events reloaded at boot
  and tagged ``recovered=true`` — what post-SIGKILL forensics read.
- ``/series`` — the retrospective-telemetry ring
  (``utils/timeseries.py``): the host's retained metric samples,
  windowable with ``?since=<wall seconds>`` and filterable with
  ``?names=<prefix,prefix>``; ``/series.txt`` renders sparklines.
  Served by every process role (member, ingress, supervisor) — what
  ``copycat-tpu timeline`` merges. Absent under ``COPYCAT_SERIES=0``
  (the pre-series surface, bit-identical).

Enable with ``AtomixServer(..., stats_port=N)`` /
``copycat-server --stats-port N``; read with ``copycat-tpu stats
<host:port>`` or anything that speaks HTTP.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any

from ..utils.buildinfo import healthz_identity
from ..utils.metrics import MetricsRegistry
from ..utils.tracing import TRACER

logger = logging.getLogger(__name__)


def _series_query(query: str) -> tuple[float | None, list[str] | None]:
    """Parse ``?since=<wall seconds>&names=<prefix,prefix>`` for the
    ``/series`` routes; malformed values degrade to the unfiltered
    window rather than a 500 (observability never wounds)."""
    since: float | None = None
    names: list[str] | None = None
    for part in query.split("&"):
        key, _, value = part.partition("=")
        if key == "since" and value:
            try:
                since = float(value)
            except ValueError:
                pass
        elif key == "names" and value:
            names = [n for n in value.split(",") if n]
    return since, names


def _profile_query(query: str) -> tuple[float | None, int | None]:
    """Parse ``?since=<wall seconds>&top=<K>`` for the ``/profile``
    routes; malformed values degrade to the unfiltered window rather
    than a 500 (observability never wounds)."""
    since: float | None = None
    top: int | None = None
    for part in query.split("&"):
        key, _, value = part.partition("=")
        if key == "since" and value:
            try:
                since = float(value)
            except ValueError:
                pass
        elif key == "top" and value:
            try:
                top = max(1, int(value))
            except ValueError:
                pass
    return since, top


class StatsListener:
    """Serves one RaftServer's observability surface over HTTP.

    Binds loopback by default: the surface is unauthenticated (and
    ``/traces`` carries operation metadata), so exposure beyond the
    host is an explicit choice (``--stats-host`` /
    ``with_stats_port(port, host=...)``)."""

    def __init__(self, raft_server: Any, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self._raft = raft_server
        self._host = host
        self._port = port
        self._server: asyncio.AbstractServer | None = None

    @property
    def port(self) -> int:
        """The bound port (resolves ``port=0`` to the ephemeral pick)."""
        if self._server is not None and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self._port

    async def open(self) -> "StatsListener":
        self._server = await asyncio.start_server(
            self._serve, self._host, self._port)
        logger.info("stats listener on %s:%d", self._host, self.port)
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except (TimeoutError, asyncio.TimeoutError):
                pass
            self._server = None

    # -- request handling --------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await asyncio.wait_for(reader.readline(), 5.0)
            parts = request_line.decode("latin-1").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # drain headers (ignored; routes take only query params)
            while True:
                line = await asyncio.wait_for(reader.readline(), 5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            raw_path, _, query = path.partition("?")
            body, ctype = self._route(raw_path, query)
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                + f"Content-Type: {ctype}\r\n".encode()
                + f"Content-Length: {len(body)}\r\n".encode()
                + b"Connection: close\r\n\r\n" + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionResetError, OSError,
                asyncio.IncompleteReadError):
            pass
        except Exception:
            logger.exception("stats request failed")
            try:
                writer.write(b"HTTP/1.1 500 Internal Server Error\r\n"
                             b"Content-Length: 0\r\nConnection: close\r\n\r\n")
                await writer.drain()
            except Exception:
                pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _route(self, path: str, query: str = "") -> tuple[bytes, str]:
        if path == "/metrics":
            return self._prometheus().encode(), "text/plain; version=0.0.4"
        if path == "/healthz":
            # minimal liveness: role/term only, no snapshot refresh, no
            # registry walk — safe to poll at any frequency (the
            # deployment supervisor's watch cadence). Non-member hosts
            # (the standalone ingress tier) provide their own payload.
            # Every role's payload carries uptime_s + git_sha
            # (utils/buildinfo.py): a restarted or half-rolled child is
            # distinguishable from one that was healthy all along.
            info = getattr(self._raft, "healthz_info", None)
            if callable(info):
                payload = dict(info())
            else:
                g0 = self._raft.groups[0]
                payload = {
                    "ok": True, "node": str(self._raft.address),
                    "role": g0.role, "term": g0.term,
                }
            payload.update(healthz_identity())
            return json.dumps(payload).encode(), "application/json"
        if path == "/health":
            # the health plane's verdict (docs/OBSERVABILITY.md "Health
            # & diagnosis"): rate-limited re-evaluation — at most one
            # fresh tick per half-cadence, so a high-frequency probe
            # cannot flood the evidence windows and shrink every delta
            # detector's lookback (observing health must not suppress it)
            monitor = getattr(self._raft, "health", None)
            if monitor is None:
                body = json.dumps({
                    "status": "disabled",
                    "node": str(self._raft.address),
                    "note": "health plane off (COPYCAT_HEALTH=0)"})
            else:
                body = json.dumps(monitor.verdict())
            return body.encode(), "application/json"
        if path == "/traces":
            return TRACER.dump_slowest(20, as_json=True).encode(), \
                "application/json"
        if path == "/traces.txt":
            return TRACER.dump_slowest(20).encode(), "text/plain"
        if path.startswith("/traces/"):
            # the cross-member collection route: THIS member's spans for
            # one trace id (`copycat-tpu trace` fans this out to every
            # member and assembles the causal waterfall — utils/tracing
            # `assemble_trace`); unknown/evicted ids serve an empty span
            # list, which the assembler marks incomplete, never drops
            try:
                trace_id = int(path.rsplit("/", 1)[1])
            except ValueError:
                return (json.dumps({"error": "trace id must be an int"})
                        .encode(), "application/json")
            spans = [s.as_dict() for s in TRACER.spans_for(trace_id)]
            return (json.dumps({
                "trace": trace_id,
                "member": str(self._raft.address),
                "spans": spans,
            }).encode(), "application/json")
        if path == "/flight":
            # the in-memory ring (when a telemetry-enabled engine runs)
            # PLUS the durable black-box: recovered events from the
            # previous life ride under "blackbox" tagged recovered=true
            # — the post-SIGKILL forensics surface `doctor` correlates
            hub = self._device_hub()
            payload: dict = {"events": (hub.flight.events()
                                        if hub is not None else [])}
            if hub is None:
                payload["note"] = ("device-plane telemetry disabled "
                                   "(COPYCAT_TELEMETRY=1 or "
                                   "DeviceEngineConfig(telemetry=True))")
            blackbox = getattr(self._raft, "blackbox", None)
            if blackbox is not None:
                payload["blackbox"] = {
                    **blackbox.summary(),
                    "recovered": blackbox.recovered,
                    "events": blackbox.events(),
                }
            return json.dumps(payload).encode(), "application/json"
        if path == "/flight.txt":
            hub = self._device_hub()
            body = (hub.flight.render_text() if hub is not None
                    else "device-plane telemetry disabled\n")
            blackbox = getattr(self._raft, "blackbox", None)
            if blackbox is not None and blackbox.recovered:
                body += (f"--- black-box: {len(blackbox.recovered)} "
                         f"recovered event(s) from the previous life ---\n")
                for ev in blackbox.recovered:
                    extra = " ".join(f"{k}={v}" for k, v in ev.items()
                                     if k not in ("seq", "t", "kind",
                                                  "recovered"))
                    body += (f"#{ev.get('seq', '?'):<5} "
                             f"{ev.get('kind', '?'):<12} {extra}\n")
            return body.encode(), "text/plain"
        store = getattr(self._raft, "series", None)
        if path in ("/series", "/series.txt") and store is not None:
            # the retrospective-telemetry ring (utils/timeseries.py):
            # ?since=<wall s> windows, ?names=<prefix,...> filters —
            # what `copycat-tpu timeline` fans out for. When the plane
            # is off the path falls through to the unknown-route error:
            # /series is ABSENT, not empty (the A/B surface).
            since, names = _series_query(query)
            if path == "/series":
                return (json.dumps(store.payload(since=since, names=names))
                        .encode(), "application/json")
            return (store.render_text(since=since, names=names).encode(),
                    "text/plain")
        prof = getattr(self._raft, "profiler", None)
        if path in ("/profile", "/profile.txt") and prof is not None:
            # the continuous profiling plane (utils/profiler.py):
            # folded wall stacks + loop holds, ?since=<wall s> windows,
            # ?top=<K> truncation — what `copycat-tpu profile` fans out
            # and merges. /profile.txt is pure flamegraph.pl collapsed
            # lines. COPYCAT_PROFILE=0 falls through to the
            # unknown-route error: ABSENT, not empty (the A/B surface).
            since, top = _profile_query(query)
            if path == "/profile":
                payload = prof.payload(since=since, top=top)
                payload["node"] = str(self._raft.address)
                return (json.dumps(payload).encode(), "application/json")
            return (prof.render_text(since=since, top=top).encode(),
                    "text/plain")
        if path in ("/", "/stats", "/stats.json"):
            return json.dumps(self._raft.stats_snapshot()).encode(), \
                "application/json"
        routes = ["/stats", "/metrics", "/health", "/healthz", "/traces",
                  "/traces.txt", "/traces/<id>", "/flight", "/flight.txt"]
        if store is not None:
            routes += ["/series", "/series.txt"]
        if prof is not None:
            routes += ["/profile", "/profile.txt"]
        return (json.dumps({"error": f"unknown path {path}",
                            "routes": routes}).encode(),
                "application/json")

    def _device_hub(self):
        """The device engine's telemetry hub, when the server runs the
        TPU executor with an instantiated, telemetry-enabled engine.
        Reads the raw ``_engine`` attribute — the ``device_engine``
        property builds the engine lazily, and a stats scrape must
        never trigger a multi-second jit compile."""
        engine = getattr(self._raft.state_machine, "_engine", None)
        groups = getattr(engine, "_groups", None)
        return getattr(groups, "telemetry", None)

    def _prometheus(self) -> str:
        self._raft.stats_snapshot()  # refresh the lazy gauges
        out = [self._raft.metrics.render_prometheus()]
        transport_metrics = getattr(self._raft.transport, "metrics", None)
        if isinstance(transport_metrics, MetricsRegistry):
            out.append(transport_metrics.render_prometheus(
                namespace="copycat_transport"))
        manager_metrics = getattr(self._raft.state_machine, "metrics", None)
        if isinstance(manager_metrics, MetricsRegistry):
            out.append(manager_metrics.render_prometheus(
                namespace="copycat_manager"))
        hub = self._device_hub()
        if hub is not None:
            # device.* sanitizes to copycat_device_* — the device-plane
            # family next to the host families in one scrape
            out.append(hub.registry.render_prometheus(namespace="copycat"))
        return "".join(out)


async def fetch_stats(address: str, path: str = "/stats",
                      timeout: float = 5.0) -> bytes:
    """Minimal HTTP GET against a stats listener (no external deps —
    what ``copycat-tpu stats`` uses). ``address`` is ``host:port``."""
    host, _, port = address.rpartition(":")
    if not port.isdigit():
        # a malformed address must be a one-line actionable error at the
        # CLI, not an int() traceback
        raise RuntimeError(
            f"bad address {address!r} — expected host:port (the "
            f"server's --stats-port endpoint)")
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host or "127.0.0.1", int(port)), timeout)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: {address}\r\n"
                     f"Connection: close\r\n\r\n".encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, OSError):
            pass
    head, _, body = raw.partition(b"\r\n\r\n")
    status = head.split(b"\r\n", 1)[0].split()
    if len(status) < 2 or status[1] != b"200":
        first = head.splitlines()[0] if head else b"(empty response)"
        raise RuntimeError(f"stats fetch failed: {first!r}")
    return body
