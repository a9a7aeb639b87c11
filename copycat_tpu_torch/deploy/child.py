"""Child-process entry point for the deployment plane
(``python -m copycat_tpu_torch.deploy.child {member|ingress} ...``).

One OS process per topology role (docs/DEPLOYMENT.md): ``member`` is
``copycat-server`` (the full Raft node — real sockets, real fsync) with
the deployment flags; ``ingress`` runs a standalone
:class:`~copycat_tpu_torch.deploy.ingress.IngressServer` fronting the member
tier. Both speak the supervisor's exit-code contract: 0 = clean
shutdown, 2 = config error (don't restart — fix the spec), anything
else = crash (restart with backoff).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import signal
import sys


def _ingress_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m copycat_tpu_torch.deploy.child ingress",
        description="Run a standalone ingress/proxy-tier process.")
    parser.add_argument("address", metavar="host:port",
                        help="where clients connect to this proxy")
    parser.add_argument("--members", required=True, metavar="A,B,...",
                        help="comma-separated Raft member addresses this "
                             "proxy fronts")
    parser.add_argument("--peers", default="", metavar="A,B,...",
                        help="the whole ingress tier (self included) — "
                             "advertised to clients as the cluster, so "
                             "they re-route within the tier")
    parser.add_argument("--stats-port", type=int, default=None,
                        metavar="PORT",
                        help="serve /stats /metrics /healthz on this port")
    parser.add_argument("--stats-host", default="127.0.0.1",
                        metavar="HOST")
    parser.add_argument("--groups", type=int, default=1, metavar="N",
                        help="the cluster's Raft group count (must match "
                             "the members')")
    parser.add_argument("--machine", default=None, metavar="MOD:FACTORY",
                        help="machine spec — resolves routing "
                             "(route_group) and registers the workload's "
                             "op types with the serializer")
    parser.add_argument("--name", default="ingress", metavar="NAME")
    return parser


async def _serve_ingress(args: argparse.Namespace) -> None:
    from ..cli import ConfigError
    from ..io.tcp import TcpTransport
    from ..io.transport import Address
    from ..server.stats import StatsListener
    from .ingress import IngressServer
    from .topology import load_machine

    try:
        address = Address.parse(args.address)
        members = [Address.parse(a)
                   for a in args.members.split(",") if a]
        tier = [Address.parse(a) for a in args.peers.split(",") if a]
    except (ValueError, TypeError) as e:
        raise ConfigError(f"bad address: {e}") from e
    if not members:
        raise ConfigError("--members must name at least one Raft member")
    try:
        factory = load_machine(args.machine)
    except (ValueError, ImportError) as e:
        raise ConfigError(f"--machine: {e}") from e
    if factory is None:
        from ..manager.state import ResourceManager
        route_machine: type = ResourceManager
    elif isinstance(factory, type):
        route_machine = factory
    else:
        route_machine = type(factory(0))

    ingress = IngressServer(address, members, TcpTransport(),
                            groups=max(1, args.groups),
                            tier=tier or None,
                            route_machine=route_machine, name=args.name)
    stats: StatsListener | None = None

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()

    def _on_signal() -> None:
        stop.set()
        for s in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(Exception):
                loop.remove_signal_handler(s)

    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError, ValueError):
            loop.add_signal_handler(sig, _on_signal)

    try:
        try:
            from ..cli import _open_with_bind_retry

            await _open_with_bind_retry(ingress.open)
            if args.stats_port is not None:
                stats = await StatsListener(
                    ingress, host=args.stats_host,
                    port=args.stats_port).open()
        except OSError as e:
            raise ConfigError(
                f"cannot start ingress at {address}: {e}") from e
        print(f"ingress listening at {address} "
              f"(fronting {len(members)} member(s), "
              f"{max(1, args.groups)} group(s))", flush=True)
        if stats is not None:
            print(f"stats listener on port {stats.port} "
                  f"(/stats /metrics /healthz)", flush=True)
        await stop.wait()
        print("shutting down...", flush=True)
    finally:
        if stats is not None:
            with contextlib.suppress(Exception):
                await stats.close()
        try:
            await asyncio.wait_for(ingress.close(), 10)
        except (Exception, asyncio.TimeoutError):
            pass


def main(argv: list[str] | None = None) -> None:
    from ..cli import ConfigError

    raw = sys.argv[1:] if argv is None else argv
    if not raw or raw[0] not in ("member", "ingress"):
        print("usage: python -m copycat_tpu_torch.deploy.child "
              "{member|ingress} ...", file=sys.stderr)
        raise SystemExit(2)
    role, rest = raw[0], raw[1:]
    if role == "member":
        # copycat-server IS the member role (same flags, same exit-code
        # contract) — one code path for operators and the supervisor
        from ..cli import server

        server(rest)
        return
    args = _ingress_parser().parse_args(rest)
    try:
        asyncio.run(_serve_ingress(args))
    except KeyboardInterrupt:
        pass
    except ConfigError as e:
        print(f"copycat-ingress: config error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    except Exception as e:  # noqa: BLE001 — a crash, diagnosed in one line
        print(f"copycat-ingress: fatal: {type(e).__name__}: {e}",
              file=sys.stderr)
        raise SystemExit(1) from None


if __name__ == "__main__":
    main()
