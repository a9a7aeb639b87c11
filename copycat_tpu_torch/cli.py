"""Console entry points of the port.

``python -m copycat_tpu_torch.cli serve host:port [peers...]`` runs a
standalone ``AtomixServer`` node (the reference's ``copycat-server``;
the default executor is ``"cpu"``, as there). ``python -m
copycat_tpu_torch.cli <verb>`` is the operator multi-tool, the
reference's ``copycat-tpu``: ``stats <host:port>`` reads a running
server's stats listener (enable with ``serve --stats-port N`` or
``AtomixServer(..., stats_port=N)``; docs/OBSERVABILITY.md), and
``trace``, ``doctor``, ``timeline``, ``top``, ``profile`` and ``cluster
spawn|status|kill-member`` work as the reference's do. ``profile
--device <dir>`` summarizes the torch Chrome traces that
``utils/profiling.py``'s ``trace`` writes, where the reference reads an
xprof capture. ``lint`` runs the port's copy of the copycheck static
analysis (``analysis/``) over the port's own tree; it imports no torch.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import shutil
import signal
import sys
import tempfile

# the stats flattening the watch renderer diffs across polls has one
# home, beside the ``top`` dashboard that reads it too
from .utils.timeseries import _flatten_numeric


def _server_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="copycat-server",
        description="Run a standalone copycat-tpu server node.")
    parser.add_argument("members", nargs="*", default=["127.0.0.1:5001"],
                        metavar="host:port",
                        help="this node's address, then its peers "
                             "(default 127.0.0.1:5001)")
    parser.add_argument("--stats-port", type=int, default=None,
                        metavar="PORT",
                        help="serve /stats (JSON), /metrics (Prometheus), "
                             "/health, /healthz and /traces on this port "
                             "(0 = ephemeral)")
    parser.add_argument("--stats-host", default="127.0.0.1", metavar="HOST",
                        help="stats listener bind host (default loopback; "
                             "the surface is unauthenticated — widen "
                             "deliberately)")
    parser.add_argument("--log-dir", default=None, metavar="DIR",
                        help="Raft log directory (default: a temp dir, "
                             "removed on exit)")
    parser.add_argument("--storage", default="disk",
                        choices=("memory", "mapped", "disk"),
                        help="log storage level (default disk)")
    parser.add_argument("--groups", type=int, default=None, metavar="N",
                        help="Raft groups hosted by this node "
                             "(docs/SHARDING.md; default COPYCAT_GROUPS)")
    parser.add_argument("--machine", default=None, metavar="MOD:FACTORY",
                        help="state-machine factory spec (one machine "
                             "per group; default: the ResourceManager "
                             "catalog) — docs/DEPLOYMENT.md")
    parser.add_argument("--name", default=None, metavar="NAME",
                        help="node name for logs/stats (default raft)")
    return parser


class ConfigError(Exception):
    """A deployment/config problem the operator (or the supervisor)
    must fix — exit code 2, never restarted (docs/DEPLOYMENT.md)."""


async def _open_with_bind_retry(open_fn, attempts: int = 3,
                                delay: float = 0.3) -> None:
    """Open a listener, absorbing TRANSIENT ``EADDRINUSE``: topology
    specs allocate ports with a release-then-rebind probe
    (``deploy/topology.py::allocate_ports``), so another bind(0) user
    can briefly hold our port between the probe and the child's bind.
    One short retry usually clears it; a port that stays taken after
    ``attempts`` IS a config error (docs/DEPLOYMENT.md) and propagates
    so the supervisor stops restarting it."""
    import errno

    for attempt in range(attempts):
        try:
            await open_fn()
            return
        except OSError as e:
            if e.errno != errno.EADDRINUSE or attempt == attempts - 1:
                raise
            await asyncio.sleep(delay * (attempt + 1))


async def _serve(args: argparse.Namespace) -> None:
    from .deploy.topology import load_machine
    from .io.tcp import TcpTransport
    from .io.transport import Address
    from .manager.atomix import AtomixServer
    from .server.log import Storage, StorageLevel

    members = args.members or ["127.0.0.1:5001"]
    try:
        address = Address.parse(members[0])
        member_addrs = [Address.parse(a) for a in members]
    except (ValueError, TypeError) as e:
        raise ConfigError(f"bad member address: {e}") from e

    # An explicit --log-dir is the operator's to keep; the temp-dir
    # default is ours to remove on exit (it used to leak one
    # copycat-tpu-* dir per run).
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="copycat-tpu-")
    own_log_dir = args.log_dir is None
    level = StorageLevel(getattr(args, "storage", None) or "disk")
    if level is StorageLevel.MEMORY:
        storage = Storage(StorageLevel.MEMORY)
    else:
        storage = Storage(level, directory=log_dir,
                          max_entries_per_segment=16)
    try:
        machine = load_machine(getattr(args, "machine", None))
    except (ValueError, ImportError) as e:
        raise ConfigError(f"--machine: {e}") from e
    server = AtomixServer(
        address, member_addrs, TcpTransport(), storage=storage,
        stats_port=args.stats_port, stats_host=args.stats_host,
        groups=getattr(args, "groups", None), state_machine=machine,
        name=getattr(args, "name", None) or "raft")

    # Graceful shutdown: SIGINT/SIGTERM close the node (stats listener,
    # transport, log) instead of dying mid-write with the temp dir
    # leaked; a second SIGINT still kills the process the hard way.
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()

    def _on_signal() -> None:
        stop.set()
        # restore default handling so a SECOND signal kills the process
        # the hard way instead of re-setting an already-set event while
        # a wedged close() burns its timeout
        for s in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(Exception):
                loop.remove_signal_handler(s)

    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError, ValueError):
            loop.add_signal_handler(sig, _on_signal)

    try:
        # inside the try: a failed open (port taken, bad stats bind)
        # must still remove the temp log dir below
        try:
            await _open_with_bind_retry(server.open)
        except OSError as e:
            # a bind that cannot succeed no matter how often the node
            # restarts (port taken, bad stats host) is a CONFIG error:
            # one line + exit 2, so a supervisor knows to stop
            # restarting and surface the spec problem instead
            raise ConfigError(
                f"cannot start at {address}"
                + (f" (stats {args.stats_host}:{args.stats_port})"
                   if args.stats_port is not None else "")
                + f": {e}") from e
        print(f"server listening at {address} (log: {log_dir})", flush=True)
        if server.stats is not None:
            print(f"stats listener on port {server.stats.port} "
                  f"(/stats /metrics /health /healthz /traces)",
                  flush=True)
        await stop.wait()
        print("shutting down...", flush=True)
    finally:
        try:
            await asyncio.wait_for(server.close(), 10)
        except (Exception, asyncio.TimeoutError) as e:
            # teardown-only failure: never mask the primary error (the
            # open/run exception already propagating), but say so in one
            # line instead of swallowing it invisibly
            print(f"copycat-server: close failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
        if own_log_dir:
            shutil.rmtree(log_dir, ignore_errors=True)


def server(argv: list[str] | None = None) -> None:
    """``copycat-server host:port [peers...] [--stats-port N]``

    Exit codes (what the deployment supervisor keys restart policy
    off): 0 = clean shutdown, 2 = config error (bad address/machine
    spec, unbindable port — restarting cannot fix it), 1 = crash. Both
    failure modes print a ONE-LINE diagnosis instead of a traceback."""
    args = _server_parser().parse_args(
        sys.argv[1:] if argv is None else argv)
    try:
        asyncio.run(_serve(args))
    except KeyboardInterrupt:
        pass
    except ConfigError as e:
        print(f"copycat-server: config error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    except Exception as e:  # noqa: BLE001 — a crash, diagnosed in one line
        print(f"copycat-server: fatal: {type(e).__name__}: {e}",
              file=sys.stderr)
        raise SystemExit(1) from None


# ---------------------------------------------------------------------------
# copycat-tpu: the operator multi-tool
# ---------------------------------------------------------------------------


def _series_sort_key(key: str) -> tuple:
    """Label-aware ordering for watch/series renders — the canonical
    implementation lives with the series plane
    (``utils/timeseries.py::series_sort_key``): ``name{label}``
    variants sort WITH their family, numeric label values in numeric
    order (``group=2`` before ``group=10``), so labeled delta rendering
    reads identically to the unlabeled path."""
    from .utils.timeseries import series_sort_key

    return series_sort_key(key)


def _render_header(snap: dict, lines: list, prefix: str = "") -> None:
    """Non-numeric leaves (node/role/leader...), recursively: a
    multi-group server's per-group role/leader strings live in nested
    sections and used to be silently dropped from the watch frame."""
    for k, v in snap.items():
        if k == "_gauge_keys":
            continue
        if isinstance(v, dict):
            if "count" in v and "mean" in v:
                continue  # histogram summary: numeric, handled below
            _render_header(v, lines, f"{prefix}{k}.")
        elif not isinstance(v, (int, float)) or isinstance(v, bool):
            lines.append(f"{prefix}{k}: {v}")


def _render_watch(snap: dict, prev: dict | None, dt: float) -> str:
    """One watch frame: scalar header lines, then every numeric series
    with its value and (from the second poll on) its delta/sec. Series
    are keyed by the FULL flattened name including labels — same-named
    series with different labels (per-group ``group=`` series, the
    per-consistency read mix) stay distinct, each with its own delta."""
    import time as _time

    lines = [f"--- {_time.strftime('%H:%M:%S')} ---"]
    _render_header(snap, lines)
    flat = _flatten_numeric(snap)
    for key in sorted(flat, key=_series_sort_key):
        v = flat[key]
        val = f"{v:.4f}".rstrip("0").rstrip(".") if isinstance(v, float) \
            else str(v)
        line = f"{key:<58} {val:>16}"
        if prev is not None and key in prev and dt > 0:
            rate = (flat[key] - prev[key]) / dt
            if rate:
                line += f"  {rate:+,.1f}/s"
        lines.append(line)
    return "\n".join(lines)


def _render_traces_watch(body: bytes, prev_ids: set | None,
                         slowest: int) -> tuple[str, set]:
    """One ``--watch --what traces`` frame: the slowest-N traces with a
    per-phase breakdown (phase lines keyed ``name{group=,member=}`` and
    ordered with the label-aware family sort, so per-group phases sit
    with their family), NEW-marking traces that appeared since the last
    poll."""
    import time as _time

    traces = json.loads(body)
    ids = {t["trace"] for t in traces}
    lines = [f"--- {_time.strftime('%H:%M:%S')} slowest "
             f"{min(slowest, len(traces))}/{len(traces)} traces ---"]
    for t in traces[:slowest]:
        new = "  NEW" if prev_ids is not None and t["trace"] not in prev_ids \
            else ""
        lines.append(f"trace {t['trace']}  total {t['total_ms']:.3f} ms"
                     f"{new}")
        phases: dict[str, float] = {}
        for s in t.get("spans", ()):
            labels = []
            if s.get("group") is not None:
                labels.append(f"group={s['group']}")
            if s.get("member") is not None:
                labels.append(f"member={s['member']}")
            key = s["name"] + (f"{{{','.join(labels)}}}" if labels else "")
            phases[key] = phases.get(key, 0.0) + s.get("duration_ms", 0.0)
        for key in sorted(phases, key=_series_sort_key):
            lines.append(f"  {key:<58} {phases[key]:>12.3f} ms")
    return "\n".join(lines), ids


def _stats(args: argparse.Namespace) -> int:
    import time

    from .server.stats import fetch_stats

    # ``all`` renders every surface in one shot (JSON snapshot first — it
    # carries all registries, the read-lane family included — then the
    # Prometheus text and the flight ring); its watch mode polls /stats,
    # whose delta renderer already covers every numeric series. Watch
    # mode for ``traces`` polls the JSON route (the slowest-N delta
    # renderer's shape) where one-shot mode prints the text rendering.
    watch = getattr(args, "watch", None)
    path = {"stats": "/stats", "metrics": "/metrics",
            "traces": "/traces" if watch is not None else "/traces.txt",
            "flight": "/flight.txt", "health": "/health",
            "all": "/stats"}[args.what]

    def fetch(p: str = path) -> bytes | None:
        try:
            return asyncio.run(fetch_stats(args.address, p))
        except (OSError, RuntimeError, asyncio.TimeoutError) as e:
            print(f"copycat-tpu stats: cannot read {args.address}{p}: "
                  f"{e}\n(is the server running with --stats-port?)",
                  file=sys.stderr)
            return None

    if watch is None:
        body = fetch()
        if body is None:
            return 1
        if args.what == "all":
            print("=== stats ===")
            print(json.dumps(json.loads(body), indent=2, sort_keys=True))
            for title, p in (("metrics", "/metrics"),
                             ("traces", "/traces.txt"),
                             ("flight", "/flight.txt"),
                             ("health", "/health")):
                extra = fetch(p)
                if extra is not None:
                    print(f"=== {title} ===")
                    print(extra.decode(), end="")
        elif args.what in ("metrics", "traces", "flight"):
            print(body.decode(), end="")
        else:
            print(json.dumps(json.loads(body), indent=2, sort_keys=True))
        return 0

    # --watch N: poll + re-render every N seconds; in stats mode each
    # numeric series shows its delta/sec vs the previous poll (how fast
    # is device.elections_started actually moving?); in traces mode the
    # slowest-N traces with per-phase breakdowns, NEW-marking traces
    # that landed since the last poll. Ctrl-C exits.
    prev: dict | None = None
    prev_ids: set | None = None
    prev_t = 0.0
    failures = 0
    try:
        while True:
            body = fetch()
            if body is None:
                failures += 1
                if failures >= 3:
                    return 1
            else:
                failures = 0
                now = time.monotonic()
                if args.what in ("stats", "all"):
                    snap = json.loads(body)
                    print(_render_watch(snap, prev, now - prev_t),
                          flush=True)
                    prev = _flatten_numeric(snap)
                    prev_t = now
                elif args.what == "traces":
                    frame, prev_ids = _render_traces_watch(
                        body, prev_ids, getattr(args, "slowest", 8))
                    print(frame, flush=True)
                else:
                    print(f"--- {time.strftime('%H:%M:%S')} "
                          f"{args.address}{path} ---", flush=True)
                    print(body.decode(), end="", flush=True)
            time.sleep(watch)
    except KeyboardInterrupt:
        return 0


def _bad_addresses(addresses: list[str]) -> int:
    """Reject malformed ``host:port`` arguments up front with a one-line
    actionable error (0 = all fine). Without this, a forgotten port
    would read as 'member unreachable' and degrade a doctor/trace run
    to an incomplete report with a partition/crash diagnosis — hiding a
    typo behind a scarier story."""
    bad = [a for a in addresses if not a.rpartition(":")[2].isdigit()]
    if bad:
        print(f"copycat-tpu: bad address(es) {', '.join(bad)} — expected "
              f"host:port (the server's --stats-port endpoint)",
              file=sys.stderr)
        return 2
    return 0


def _trace(args: argparse.Namespace) -> int:
    """``copycat-tpu trace addr [addr...]``: assemble cross-member
    causal waterfalls (docs/OBSERVABILITY.md "Cluster-wide causal
    tracing"). The FIRST address seeds the slowest-N trace ids (its
    ``/traces`` ring); every given address is then asked for its local
    spans of each id (``/traces/<id>``) and the merged timeline is
    rendered with the critical path highlighted. A member that cannot
    be reached marks the assembly ``incomplete`` — partial waterfalls
    are rendered, never dropped."""
    from .server.stats import fetch_stats
    from .utils.tracing import assemble_trace, render_waterfall

    rc = _bad_addresses(args.addresses)
    if rc:
        return rc

    async def fetch(address: str, path: str) -> bytes | None:
        try:
            return await fetch_stats(address, path)
        except (OSError, RuntimeError, asyncio.TimeoutError):
            return None

    async def collect():
        seed = await fetch(args.addresses[0], "/traces")
        if seed is None:
            return None
        slowest = json.loads(seed)[:args.slowest]
        # genuinely fan out: every member's /traces/<id> for every
        # slowest id in one gather — a slow/hung member costs one
        # timeout, not one timeout per serial fetch
        ids = [entry["trace"] for entry in slowest]
        bodies = await asyncio.gather(*(
            fetch(address, f"/traces/{trace_id}")
            for trace_id in ids for address in args.addresses))
        n = len(args.addresses)
        return [(trace_id, bodies[k * n:(k + 1) * n])
                for k, trace_id in enumerate(ids)]

    collected = asyncio.run(collect())
    if collected is None:
        print(f"copycat-tpu trace: cannot read {args.addresses[0]}/traces"
              f"\n(is the server running with --stats-port?)",
              file=sys.stderr)
        return 1
    if not collected:
        print("(no traces recorded — run a traced client: COPYCAT_TRACE=1)")
        return 0
    assemblies = []
    for trace_id, bodies in collected:
        spans_by_member: dict = {}
        failed: list = []
        for address, body in zip(args.addresses, bodies):
            if body is None:
                failed.append(address)
                continue
            local = json.loads(body)
            spans_by_member.setdefault(
                local.get("member", address), []).extend(local["spans"])
        assemblies.append(assemble_trace(trace_id, spans_by_member,
                                         failed_members=failed))
    if args.json:
        print(json.dumps(assemblies, indent=2))
        return 0
    for assembly in assemblies:
        print(render_waterfall(assembly))
        print()
    return 0


def _fetch_json_fn():
    """A ``fetch_json(address, path) -> dict | None`` closure over the
    stats fetcher — the shared fan-out primitive of every collection
    verb (trace/doctor/timeline/top)."""
    from .server.stats import fetch_stats

    async def fetch_json(address: str, path: str):
        try:
            return json.loads(await fetch_stats(address, path))
        except (OSError, RuntimeError, ValueError, asyncio.TimeoutError):
            return None

    return fetch_json


def _series_payload(raw: dict | None) -> dict | None:
    """Normalize a fetched ``/series`` body: a member with the series
    plane off answers the unknown-route error payload — that is "no
    series retained" (the assembler marks it incomplete), not a
    series."""
    if isinstance(raw, dict) and "samples" in raw:
        return raw
    return None


async def collect_doctor(addresses: list[str], slowest: int = 3,
                         last_s: float | None = None
                         ) -> tuple[dict, list, list]:
    """The doctor's fan-out (exposed for tests): every member's
    ``/health`` + ``/flight`` + ``/stats`` gathered in parallel, plus
    the slowest traces from the first reachable member. With ``last_s``
    (``doctor --last N``) each member's retained ``/series`` window
    rides along for retrospective time-correlation. Returns
    ``(members, failed, slowest_traces)`` where ``members`` maps each
    REACHED address to its payloads and ``failed`` lists the
    unreachable ones — partial fan-outs assemble an incomplete report,
    never a dropped one."""
    import time

    fetch_json = _fetch_json_fn()
    since = time.time() - last_s if last_s else None

    async def member(address: str):
        paths = ["/health", "/flight", "/stats"]
        if last_s:
            paths.append(f"/series?since={since}")
        payloads = await asyncio.gather(*(fetch_json(address, p)
                                          for p in paths))
        return address, payloads

    rows = await asyncio.gather(*(member(a) for a in addresses))
    members: dict = {}
    failed: list = []
    for address, payloads in rows:
        health, flight, stats = payloads[:3]
        if health is None and flight is None and stats is None:
            failed.append(address)
            continue
        members[address] = {"health": health, "flight": flight,
                            "stats": stats}
        if last_s:
            members[address]["series"] = _series_payload(payloads[3])
    traces: list = []
    for address in members:
        body = await fetch_json(address, "/traces")
        if body is not None:
            traces = sorted(body, key=lambda t: -t.get("total_ms", 0.0)
                            )[:slowest]
            break
    return members, failed, traces


def _doctor(args: argparse.Namespace) -> int:
    """``copycat-tpu doctor addr [addr...]``: fan out to every member's
    stats listener, correlate ``/health`` + ``/flight`` + ``/stats`` +
    slowest traces across members, and render a root-cause report
    (docs/OBSERVABILITY.md "Health & diagnosis"). Unreachable members
    mark the report ``incomplete`` — partial reports render, never
    drop; a fully unreachable cluster is a one-line error + exit 1."""
    from .utils.health import assemble_doctor_report, render_doctor_report

    rc = _bad_addresses(args.addresses)
    if rc:
        return rc
    members, failed, traces = asyncio.run(
        collect_doctor(args.addresses, args.slowest,
                       last_s=getattr(args, "last", None)))
    if not members:
        print(f"copycat-tpu doctor: none of {len(args.addresses)} "
              f"member(s) reachable ({', '.join(args.addresses)})\n"
              f"(are the servers running with --stats-port?)",
              file=sys.stderr)
        return 1
    report = assemble_doctor_report(members, failed_members=failed,
                                    slowest_traces=traces)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_doctor_report(report))
    return 0


async def collect_timeline(addresses: list[str]
                           ) -> tuple[dict, list]:
    """The timeline's fan-out (exposed for tests): every process's
    ``/series`` + ``/flight`` + ``/health`` gathered in parallel.
    Addresses answering NONE of the routes are failed; a reachable
    process without a ``/series`` route (series plane off) stays in the
    merge — the assembler marks the timeline incomplete, never drops
    it."""
    fetch_json = _fetch_json_fn()

    async def member(address: str):
        series, flight, health = await asyncio.gather(
            fetch_json(address, "/series"),
            fetch_json(address, "/flight"),
            fetch_json(address, "/health"))
        return address, series, flight, health

    rows = await asyncio.gather(*(member(a) for a in addresses))
    members: dict = {}
    failed: list = []
    for address, series, flight, health in rows:
        if series is None and flight is None and health is None:
            failed.append(address)
            continue
        members[address] = {"series": _series_payload(series),
                            "flight": flight, "health": health}
    return members, failed


def _timeline(args: argparse.Namespace) -> int:
    """``copycat-tpu timeline addr [addr...]``: fan out to every
    process's stats listener and render ONE merged cluster timeline
    (docs/OBSERVABILITY.md "Retrospective telemetry") — per-member
    metric sparklines time-aligned on a common grid with
    flight-recorder faults, black-box crash tails, health findings and
    elections/restarts as event marks. Unreachable members mark the
    timeline ``incomplete`` — partial timelines render, never drop; a
    fully unreachable cluster is a one-line error + exit 1."""
    from .utils.timeseries import assemble_timeline, render_timeline

    rc = _bad_addresses(args.addresses)
    if rc:
        return rc
    members, failed = asyncio.run(collect_timeline(args.addresses))
    if not members:
        print(f"copycat-tpu timeline: none of {len(args.addresses)} "
              f"member(s) reachable ({', '.join(args.addresses)})\n"
              f"(are the servers running with --stats-port?)",
              file=sys.stderr)
        return 1
    names = ([n for n in args.names.split(",") if n]
             if getattr(args, "names", None) else None)
    timeline = assemble_timeline(members, failed_members=failed,
                                 last_s=args.last, names=names)
    if args.json:
        print(json.dumps(timeline, indent=2))
    else:
        print(render_timeline(timeline))
    return 0


def _top(args: argparse.Namespace) -> int:
    """``copycat-tpu top addr [addr...]``: the timeline's live sibling
    — a cluster-wide dashboard (per-group role/term/commit rate, lane
    mix, replication in-flight, worst health verdict) refreshed in
    place every ``--watch`` seconds (Ctrl-C exits; ``--once`` prints a
    single frame; ``--json`` one machine-readable frame — the CI smoke
    shape, parity with ``timeline --json``). Unreachable members
    render as rows, never drop."""
    import time

    from .utils.timeseries import render_top, top_payload

    rc = _bad_addresses(args.addresses)
    if rc:
        return rc
    fetch_json = _fetch_json_fn()

    async def collect() -> tuple[dict, list]:
        async def member(address: str):
            stats, health = await asyncio.gather(
                fetch_json(address, "/stats"),
                fetch_json(address, "/health"))
            return address, stats, health

        rows = await asyncio.gather(*(member(a) for a in args.addresses))
        members: dict = {}
        failed: list = []
        for address, stats, health in rows:
            if stats is None and health is None:
                failed.append(address)
                continue
            members[address] = {"stats": stats, "health": health}
        return members, failed

    prev: dict | None = None
    prev_t = 0.0
    failures = 0
    try:
        while True:
            members, failed = asyncio.run(collect())
            if not members:
                failures += 1
                if args.once or getattr(args, "json", False) \
                        or failures >= 3:
                    print(f"copycat-tpu top: none of "
                          f"{len(args.addresses)} member(s) reachable "
                          f"({', '.join(args.addresses)})",
                          file=sys.stderr)
                    return 1
            else:
                failures = 0
                now = time.monotonic()
                if getattr(args, "json", False):
                    # --json implies one-shot: a single frame carries
                    # no prior poll, so rates are null, never a
                    # misleading 0.0
                    payload, _ = top_payload(members, failed)
                    print(json.dumps(payload, indent=2))
                    return 0
                frame, state = render_top(members, failed, prev,
                                          now - prev_t if prev else 0.0)
                if args.once:
                    print(frame, flush=True)
                    return 0
                # refresh in place: clear + home, then the new frame
                print(f"\x1b[2J\x1b[H{frame}", flush=True)
                prev, prev_t = state, now
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0


def _profile_device(args: argparse.Namespace) -> int:
    """``copycat-tpu profile --device <trace_dir>``: the device-plane
    side of the one profiling entrypoint — summarize the newest torch
    Chrome trace under ``trace_dir`` (``utils/profiling.py`` ``trace``
    writes one session directory per capture) into per-kernel totals
    on the card's lanes. The helper's actionable errors (no trace
    session, no device lane in the trace) surface as one-line messages
    + exit 1, never tracebacks."""
    from .utils.profiling import summarize_trace

    try:
        rows = summarize_trace(args.device, top=args.top)
    except (FileNotFoundError, RuntimeError) as exc:
        print(f"copycat-tpu profile: {exc}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps([{"op": op, "total_ms": round(ms, 3),
                           "count": n} for op, ms, n in rows], indent=2))
        return 0
    print(f"{'op':<48} {'total_ms':>10} {'count':>7}")
    for op, ms, n in rows:
        print(f"{op:<48} {ms:>10.3f} {n:>7}")
    return 0


def _profile(args: argparse.Namespace) -> int:
    """``copycat-tpu profile addr [addr...]``: fan out to every
    process's ``/profile`` route and merge the folded wall stacks into
    ONE cluster profile (docs/OBSERVABILITY.md "Profiling") — every
    stack prefixed with its member identity, top-K frames ranked with
    self/total percentages, the heaviest event-loop holds below.
    Unreachable members (and members serving no ``/profile`` —
    ``COPYCAT_PROFILE=0`` or a pre-profiler build) mark the merge
    ``incomplete``, never dropped. ``--json`` emits the merge (the
    ``--diff`` baseline shape); ``--diff saved.json`` ranks per-frame
    self%% moves against a saved artifact. ``--device <trace_dir>``
    routes to the device-trace summary instead — host and device
    profiling behind one verb."""
    import time

    from .utils import profiler as profiler_mod

    if getattr(args, "device", None):
        return _profile_device(args)
    if not args.addresses:
        print("copycat-tpu profile: give member stats address(es) for "
              "a host profile, or --device <trace_dir> for a captured "
              "device trace", file=sys.stderr)
        return 2
    rc = _bad_addresses(args.addresses)
    if rc:
        return rc
    fetch_json = _fetch_json_fn()
    path = "/profile"
    if getattr(args, "last", None):
        path += f"?since={time.time() - args.last}"

    async def collect() -> tuple[dict, list]:
        bodies = await asyncio.gather(*(fetch_json(a, path)
                                        for a in args.addresses))
        members: dict = {}
        failed: list = []
        for address, body in zip(args.addresses, bodies):
            if body is None:
                failed.append(address)
            else:
                members[address] = body
        return members, failed

    members, failed = asyncio.run(collect())
    if not members:
        print(f"copycat-tpu profile: none of {len(args.addresses)} "
              f"member(s) reachable ({', '.join(args.addresses)})\n"
              f"(are the servers running with --stats-port?)",
              file=sys.stderr)
        return 1
    profile = profiler_mod.assemble_profile(members, failed_members=failed)
    diff_rows = None
    if getattr(args, "diff", None):
        try:
            with open(args.diff) as f:
                baseline = json.load(f)
        except (OSError, ValueError) as exc:
            print(f"copycat-tpu profile: cannot read baseline "
                  f"{args.diff}: {exc}", file=sys.stderr)
            return 1
        diff_rows = profiler_mod.diff_profiles(profile, baseline,
                                               top=args.top)
    if args.json:
        out = dict(profile)
        if diff_rows is not None:
            out["diff"] = diff_rows
        print(json.dumps(out, indent=2))
        return 0
    print(profiler_mod.render_profile(profile, top=args.top))
    if diff_rows is not None:
        print(f"diff vs {args.diff} (self% deltas, largest move first):")
        for r in diff_rows:
            print(f"  {r['frame']:<52} {r['baseline_self_pct']:>5.1f}% "
                  f"-> {r['self_pct']:>5.1f}%  ({r['delta_pct']:+.1f})")
    return 0


def _cluster(args: argparse.Namespace) -> int:
    """``copycat-tpu cluster <action>`` (docs/DEPLOYMENT.md): ``spawn``
    runs a supervised topology in the foreground — one OS process per
    member and per ingress proxy, real sockets, real fsync, crash
    restarts with backoff; ``status`` renders a running supervisor's
    per-child view from its control listener; ``kill-member`` SIGKILLs
    one child through the same surface (the supervisor restarts it —
    the process-level nemesis, operator edition)."""
    from .server.stats import fetch_stats

    if args.action == "spawn":
        from .deploy.supervisor import run_foreground
        from .deploy.topology import TopologySpec, load_machine
        from .utils import knobs

        try:
            load_machine(args.machine)  # fail fast: exit 2, not a child loop
        except (ValueError, ImportError) as e:
            print(f"copycat-tpu cluster: config error: --machine: {e}",
                  file=sys.stderr)
            return 2
        if args.ingresses and not knobs.get_bool("COPYCAT_INGRESS_TIER"):
            print("copycat-tpu cluster: COPYCAT_INGRESS_TIER=0 — "
                  "deploying no ingress processes (in-server ingress "
                  "path)", flush=True)
            args.ingresses = 0
        spec = TopologySpec.local(
            members=args.members, ingresses=args.ingresses,
            groups=args.groups, base_dir=args.base_dir,
            storage=args.storage, machine=args.machine,
            control_port=args.control_port)
        return run_foreground(spec)

    rc = _bad_addresses([args.address])
    if rc:
        return rc

    def fetch(path: str) -> dict | None:
        try:
            return json.loads(asyncio.run(
                fetch_stats(args.address, path)))
        except (OSError, RuntimeError, ValueError,
                asyncio.TimeoutError) as e:
            print(f"copycat-tpu cluster: cannot reach the supervisor at "
                  f"{args.address}: {e}\n(is `copycat-tpu cluster spawn` "
                  f"running, and is this its control port?)",
                  file=sys.stderr)
            return None

    if args.action == "status":
        snap = fetch("/stats")
        if snap is None:
            return 1
        if args.json:
            print(json.dumps(snap, indent=2, sort_keys=True))
            return 0
        print(f"supervisor pid {snap.get('pid')} — control "
              f"{snap.get('control')}, {snap.get('groups')} group(s)")
        print(f"clients connect to: "
              f"{', '.join(snap.get('client_addrs', ()))}")
        for name, child in snap.get("children", {}).items():
            up = f"pid {child['pid']}" if child.get("pid") else "down"
            print(f"  {name:<12} {child['role']:<8} {child['state']:<13} "
                  f"{up:<10} restarts={child['restarts']} "
                  f"uptime={child['uptime_s']}s stats={child['stats']}")
        return 0

    # kill-member: the write verb — /kill/<name> on the control surface
    out = fetch(f"/kill/{args.name}")
    if out is None:
        return 1
    print(out.get("detail", out))
    return 0 if out.get("ok") else 1


def main(argv: list[str] | None = None) -> None:
    """``copycat-tpu <verb>``: ``stats <host:port>`` reads a running
    server's observability surface; ``trace`` assembles cross-member
    causal waterfalls; ``doctor`` correlates every member's health +
    black-box + traces into a root-cause report; ``cluster`` runs and
    operates a multi-process deployment (docs/DEPLOYMENT.md);
    ``serve`` is ``copycat-server``; ``lint`` runs the copycheck
    static-analysis suite over the port's tree (torch-free —
    docs/ANALYSIS.md)."""
    raw = sys.argv[1:] if argv is None else argv
    if raw and raw[0] == "lint":
        # copycheck owns its own argparse surface (docs/ANALYSIS.md);
        # lazily imported so `lint` never pays for (or requires) torch
        from .analysis.engine import main as lint_main

        raise SystemExit(lint_main(raw[1:]))
    parser = argparse.ArgumentParser(prog="copycat-tpu")
    sub = parser.add_subparsers(dest="verb", required=True)

    stats = sub.add_parser(
        "stats", help="read a running server's stats listener")
    stats.add_argument("address", metavar="host:port",
                       help="the server's --stats-port endpoint")
    stats.add_argument("--what",
                       choices=("stats", "metrics", "traces", "flight",
                                "health", "all"),
                       default="stats",
                       help="stats = JSON snapshot (default), metrics = "
                            "Prometheus text, traces = slowest requests, "
                            "flight = device-plane flight recorder, "
                            "health = the detector verdict, "
                            "all = every surface in one shot (watch mode "
                            "polls the JSON snapshot's delta view)")
    stats.add_argument("--watch", type=float, default=None, metavar="N",
                       help="poll mode: re-render every N seconds; the "
                            "JSON snapshot view shows delta/sec per "
                            "numeric series between polls, the traces "
                            "view the slowest-N traces with per-phase "
                            "breakdowns and NEW markers (Ctrl-C exits)")
    stats.add_argument("--slowest", type=int, default=8, metavar="N",
                       help="traces watch mode: how many of the slowest "
                            "traces to render per poll (default 8)")

    trace = sub.add_parser(
        "trace", help="assemble cross-member causal waterfalls from "
                      "every member's stats listener")
    trace.add_argument("addresses", nargs="+", metavar="host:port",
                       help="stats endpoints of the members to query; "
                            "the first seeds the slowest-trace list, "
                            "unreachable members mark assemblies "
                            "incomplete (never dropped)")
    trace.add_argument("--slowest", type=int, default=3, metavar="N",
                       help="assemble the N slowest traces (default 3)")
    trace.add_argument("--json", action="store_true",
                       help="emit the assemblies as JSON instead of "
                            "the rendered waterfalls")

    doctor = sub.add_parser(
        "doctor", help="correlate every member's /health, /flight and "
                       "/stats into a cross-member root-cause report")
    doctor.add_argument("addresses", nargs="+", metavar="host:port",
                        help="stats endpoints of the members to "
                             "diagnose; unreachable members mark the "
                             "report incomplete (never dropped)")
    doctor.add_argument("--slowest", type=int, default=3, metavar="N",
                        help="slowest traces to attach to the report "
                             "(default 3)")
    doctor.add_argument("--json", action="store_true",
                        help="emit the report as JSON (the CI artifact "
                             "shape) instead of the rendered text")
    doctor.add_argument("--last", type=float, default=None, metavar="N",
                        help="retrospective mode: also pull each "
                             "member's /series for the last N seconds "
                             "and time-correlate retained metrics "
                             "(commit lag, elections, latency, SLO "
                             "burn) with the diagnosed causes")

    timeline = sub.add_parser(
        "timeline", help="merge every member's /series + /flight + "
                         "/health into one time-aligned cluster "
                         "timeline (sparklines + event marks)")
    timeline.add_argument("addresses", nargs="+", metavar="host:port",
                          help="stats endpoints to merge; unreachable "
                               "members mark the timeline incomplete "
                               "(never dropped)")
    timeline.add_argument("--last", type=float, default=60.0,
                          metavar="N",
                          help="window: render the last N seconds "
                               "(default 60; capped by each member's "
                               "retention ring)")
    timeline.add_argument("--names", default=None, metavar="P1,P2",
                          help="comma-separated metric-name prefixes "
                               "to render (default: commit index, "
                               "elections, commit lag, health status, "
                               "slo.*)")
    timeline.add_argument("--json", action="store_true",
                          help="emit the merged timeline as JSON (the "
                               "CI artifact shape) instead of the "
                               "rendered sparklines")

    top = sub.add_parser(
        "top", help="live cluster dashboard: per-member role, commit "
                    "rate, lane mix, replication in-flight and health "
                    "verdict, refreshed in place")
    top.add_argument("addresses", nargs="+", metavar="host:port",
                     help="stats endpoints to watch; unreachable "
                          "members render as rows, never dropped")
    top.add_argument("--watch", type=float, default=2.0, metavar="N",
                     help="refresh every N seconds (default 2; "
                          "Ctrl-C exits)")
    top.add_argument("--once", action="store_true",
                     help="print a single frame and exit (CI / "
                          "non-tty mode; rates need two polls, so a "
                          "single frame shows '-')")
    top.add_argument("--json", action="store_true",
                     help="emit one machine-readable frame and exit "
                          "(parity with `timeline --json`; rates are "
                          "null on a single poll)")

    profile = sub.add_parser(
        "profile", help="merged cluster wall-stack profile: fan out to "
                        "every member's /profile, merge the folded "
                        "stacks into one flame (per-member prefixes), "
                        "rank top frames and event-loop holds; "
                        "--device summarizes a captured torch trace")
    profile.add_argument("addresses", nargs="*", metavar="host:port",
                         help="stats endpoints to merge; unreachable "
                              "members mark the profile incomplete, "
                              "never dropped (omit with --device)")
    profile.add_argument("--last", type=float, default=None, metavar="N",
                         help="window: merge the last N seconds "
                              "(default: each member's full retention "
                              "ring, COPYCAT_PROFILE_WINDOW_S)")
    profile.add_argument("--top", type=int, default=20, metavar="K",
                         help="frames ranked in the table (default 20)")
    profile.add_argument("--json", action="store_true",
                         help="emit the merged profile as JSON (the "
                              "--diff baseline / CI artifact shape)")
    profile.add_argument("--diff", default=None, metavar="BASELINE.json",
                         help="rank per-frame self%% moves against a "
                              "profile saved earlier with --json")
    profile.add_argument("--device", default=None, metavar="TRACE_DIR",
                         help="summarize the newest torch Chrome trace "
                              "under a directory written by "
                              "utils/profiling.py's trace (the kernels "
                              "on the card's lanes) instead of host "
                              "profiling")

    cluster = sub.add_parser(
        "cluster", help="run/operate a multi-process deployment "
                        "(docs/DEPLOYMENT.md)")
    csub = cluster.add_subparsers(dest="action", required=True)
    spawn = csub.add_parser(
        "spawn", help="launch a supervised topology in the foreground "
                      "(one OS process per member + ingress proxy)")
    spawn.add_argument("--members", type=int, default=3, metavar="N",
                       help="Raft member processes (default 3)")
    spawn.add_argument("--ingresses", type=int, default=1, metavar="N",
                       help="standalone ingress/proxy processes fronting "
                            "the members (default 1; 0 = clients dial "
                            "members directly)")
    spawn.add_argument("--groups", type=int, default=1, metavar="G",
                       help="Raft groups per member (docs/SHARDING.md)")
    spawn.add_argument("--storage", default="disk",
                       choices=("memory", "mapped", "disk"),
                       help="member log storage level (default disk)")
    spawn.add_argument("--machine", default=None, metavar="MOD:FACTORY",
                       help="state-machine factory spec for every "
                            "process (default: the ResourceManager "
                            "catalog)")
    spawn.add_argument("--base-dir", default=None, metavar="DIR",
                       help="log dirs + child stdout logs live here "
                            "(default: a /tmp topology dir)")
    spawn.add_argument("--control-port", type=int, default=0,
                       metavar="PORT",
                       help="supervisor control listener port "
                            "(default: ephemeral, printed at boot)")
    status = csub.add_parser(
        "status", help="per-child state from a running supervisor")
    status.add_argument("address", metavar="host:port",
                        help="the supervisor's control listener")
    status.add_argument("--json", action="store_true",
                        help="emit the raw /stats payload")
    killm = csub.add_parser(
        "kill-member", help="SIGKILL one child through the control "
                            "surface (the supervisor restarts it)")
    killm.add_argument("address", metavar="host:port",
                       help="the supervisor's control listener")
    killm.add_argument("name", metavar="NAME",
                       help="child name (see `cluster status`), e.g. "
                            "member-1 or ingress-0")

    serve = sub.add_parser("serve", help="run a standalone server node")
    serve.add_argument("rest", nargs=argparse.REMAINDER)

    args = parser.parse_args(raw)
    if args.verb == "stats":
        raise SystemExit(_stats(args))
    if args.verb == "trace":
        raise SystemExit(_trace(args))
    if args.verb == "doctor":
        raise SystemExit(_doctor(args))
    if args.verb == "timeline":
        raise SystemExit(_timeline(args))
    if args.verb == "top":
        raise SystemExit(_top(args))
    if args.verb == "profile":
        raise SystemExit(_profile(args))
    if args.verb == "cluster":
        raise SystemExit(_cluster(args))
    if args.verb == "serve":
        server(args.rest)


if __name__ == "__main__":
    # `python -m copycat_tpu_torch.cli ...` is the port's `copycat-tpu`
    # (and `... serve ...` its `copycat-server`): the port installs no
    # console scripts, so it runs from a bare checkout
    main()
