"""The deployment supervisor (docs/DEPLOYMENT.md).

Runs a :class:`~copycat_tpu_torch.deploy.topology.TopologySpec` like
production: one OS process per role (members first, then the ingress
tier), each child's stdout/stderr captured to ``<base_dir>/<name>.log``,
a ``/healthz`` watch at ``COPYCAT_DEPLOY_HEALTH_INTERVAL_S``, and a
restart policy keyed off the child exit-code contract
(``copycat_tpu_torch/deploy/child.py``):

- ``0`` — clean shutdown: the child stays down (the operator asked).
- ``2`` — config error: NEVER restarted. A port that cannot bind or a
  machine spec that cannot import fails identically on every attempt;
  the supervisor surfaces the spec problem instead of crash-looping it.
- anything else (crashes, ``kill -9``) — relaunched with exponential
  backoff (``COPYCAT_DEPLOY_RESTART_BACKOFF_S`` doubling to
  ``COPYCAT_DEPLOY_RESTART_MAX_S``; a child that then stays up resets
  the backoff). A running child whose ``/healthz`` fails repeatedly
  after it has once been healthy is killed onto the same path — a
  wedged process is a crash the kernel hasn't noticed yet.

Teardown is the reverse of launch: SIGTERM to the ingress tier first
(stop taking client traffic), then the members, ``COPYCAT_DEPLOY_GRACE_S``
for graceful exits, SIGKILL for whatever remains.

The control surface is a :class:`ControlListener` — the stats listener
plus ``/topology`` (the spec as JSON) and ``/kill/<name>`` (the
process-level nemesis hook / ``copycat-tpu cluster kill-member``). The
supervisor's own ``deploy.*`` registry rides ``/stats`` and
``/metrics`` like every other plane (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import signal
import sys
import time

from ..server.stats import StatsListener, fetch_stats
from ..utils import knobs, profiler
from ..utils.managed import Managed
from ..utils.metrics import MetricsRegistry
from ..utils.tasks import spawn
from ..utils.timeseries import SeriesStore
from .topology import IngressSpec, MemberSpec, TopologySpec

logger = logging.getLogger(__name__)

# Child lifecycle states (Supervisor.status()["children"][name]["state"])
LAUNCHING = "launching"
RUNNING = "running"
BACKOFF = "backoff"
STOPPED = "stopped"  # exit 0 — stays down
CONFIG_ERROR = "config-error"  # exit 2 — never restarted
SPAWN_FAILED = "spawn-failed"  # exec itself failed

# /healthz failures in a row (once ever-healthy) before the supervisor
# kills a wedged-but-alive child onto the restart path
_UNHEALTHY_KILL_AFTER = 3


class _Child:
    """One supervised process and its restart bookkeeping."""

    def __init__(self, spec: MemberSpec | IngressSpec, log_path: str
                 ) -> None:
        self.spec = spec
        self.log_path = log_path
        self.process: asyncio.subprocess.Process | None = None
        self.pid: int | None = None
        self.state = LAUNCHING
        self.restarts = 0
        self.last_exit: int | None = None
        self.started_at = 0.0
        self.ever_healthy = False
        self.healthz: dict | None = None
        self.health_strikes = 0  # consecutive /healthz failures

    @property
    def alive(self) -> bool:
        return self.process is not None and self.process.returncode is None

    def status(self) -> dict:
        return {
            "role": self.spec.role,
            "address": self.spec.address,
            "stats": f"127.0.0.1:{self.spec.stats_port}",
            "state": self.state,
            "pid": self.pid if self.alive else None,
            "restarts": self.restarts,
            "last_exit": self.last_exit,
            "uptime_s": (round(time.monotonic() - self.started_at, 1)
                         if self.alive else 0.0),
            "healthy": self.ever_healthy and self.health_strikes == 0,
            "healthz": self.healthz,
            "log": self.log_path,
        }


class Supervisor(Managed):
    """Launches, watches, restarts and tears down one topology."""

    # StatsListener duck-typing (see IngressServer): the shared routes
    # probe these; a supervisor has none of them
    state_machine = None
    health = None
    blackbox = None
    transport = None

    def __init__(self, spec: TopologySpec) -> None:
        super().__init__()
        self.spec = spec
        self.address = f"supervisor/{os.getpid()}"
        self._children: dict[str, _Child] = {}
        self._monitors: list[asyncio.Task] = []
        self._watch_task: asyncio.Task | None = None
        self._closing = False
        self.control: ControlListener | None = None

        self._backoff0 = knobs.get_float("COPYCAT_DEPLOY_RESTART_BACKOFF_S")
        self._backoff_max = knobs.get_float("COPYCAT_DEPLOY_RESTART_MAX_S")
        self._grace = knobs.get_float("COPYCAT_DEPLOY_GRACE_S")
        self._health_interval = knobs.get_float(
            "COPYCAT_DEPLOY_HEALTH_INTERVAL_S")

        m = self.metrics = MetricsRegistry()
        # retrospective telemetry for the deploy plane: the supervisor's
        # own /series (deploy.* restart/health-check rates over time),
        # sampled inside the EXISTING health watch — no extra task.
        # COPYCAT_SERIES=0 removes the store and the route (A/B).
        self.series = (SeriesStore(node=self.address, role="supervisor",
                                   metrics=m)
                       if knobs.get_bool("COPYCAT_SERIES") else None)
        self._m_children = m.gauge("deploy.children")
        self._m_children_up = m.gauge("deploy.children_up")
        self._m_restarts = m.counter("deploy.restarts")
        self._m_config_errors = m.counter("deploy.config_errors")
        self._m_health_checks = m.counter("deploy.health_checks")
        self._m_health_failures = m.counter("deploy.health_failures")
        self._m_kills = m.counter("deploy.kills")
        # Continuous profiling plane (docs/OBSERVABILITY.md
        # "Profiling"): the supervisor process profiles itself too —
        # refcounted acquire, released in _do_close. No flight ring,
        # so no stall-note callback. COPYCAT_PROFILE=0 -> None (A/B).
        self.profiler = profiler.acquire(m, note_fn=None)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def _do_open(self) -> None:
        self._closing = False
        base = self.spec.base_dir or "."
        self._ensure_base_dir(base)
        # members first: the tier an ingress proxy needs reachable to
        # find a leader; the ingress tier follows in the same pass (its
        # own retry loop tolerates a still-electing member tier)
        for child_spec in self.spec.children():
            child = _Child(child_spec,
                           os.path.join(base, f"{child_spec.name}.log"))
            self._children[child_spec.name] = child
            self._monitors.append(
                spawn(self._run_child(child),
                      name=f"deploy-monitor-{child_spec.name}"))
        self._m_children.set(len(self._children))
        self._watch_task = spawn(self._watch_health(), name="deploy-health")
        self.control = ControlListener(self, port=self.spec.control_port)
        await self.control.open()
        logger.info("supervisor: %d member(s) + %d ingress(es), control "
                    "on port %d", len(self.spec.members),
                    len(self.spec.ingresses), self.control.port)

    async def _do_close(self) -> None:
        self._closing = True
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None
        # teardown is launch reversed: ingress tier first (stop taking
        # client traffic), then the members
        ordered = list(reversed(self.spec.children()))
        for child_spec in ordered:
            child = self._children.get(child_spec.name)
            if child is not None and child.alive:
                with contextlib.suppress(ProcessLookupError):
                    child.process.terminate()
        deadline = time.monotonic() + self._grace
        for child_spec in ordered:
            child = self._children.get(child_spec.name)
            if child is None or child.process is None:
                continue
            budget = max(0.05, deadline - time.monotonic())
            try:
                await asyncio.wait_for(child.process.wait(), budget)
            except asyncio.TimeoutError:
                with contextlib.suppress(ProcessLookupError):
                    child.process.kill()
                await child.process.wait()
        for task in self._monitors:
            task.cancel()
        await asyncio.gather(*self._monitors, return_exceptions=True)
        self._monitors.clear()
        self._m_children_up.set(0)
        if self.control is not None:
            await self.control.close()
            self.control = None
        profiler.release(self.profiler, self.metrics)
        self.profiler = None

    # ------------------------------------------------------------------
    # child launch + crash loop
    # ------------------------------------------------------------------

    def _ensure_base_dir(self, base: str) -> None:
        os.makedirs(base, exist_ok=True)
        for member in self.spec.members:
            os.makedirs(member.log_dir, exist_ok=True)

    def _child_env(self) -> dict:
        env = dict(os.environ)
        # the repo layout must be importable from the child no matter
        # where the supervisor was launched from (tests, bench, a
        # checked-out tree without `pip install -e .`)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        prior = env.get("PYTHONPATH")
        env["PYTHONPATH"] = root + (os.pathsep + prior if prior else "")
        return env

    def _open_log(self, child: _Child) -> int:
        # sync helper on purpose: one O_APPEND open per (re)launch
        return os.open(child.log_path,
                       os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)

    async def _launch(self, child: _Child) -> None:
        log_fd = self._open_log(child)
        try:
            child.process = await asyncio.create_subprocess_exec(
                *child.spec.argv(), stdout=log_fd,
                stderr=asyncio.subprocess.STDOUT, env=self._child_env(),
                start_new_session=True)
        finally:
            os.close(log_fd)
        child.pid = child.process.pid
        child.state = RUNNING
        child.started_at = time.monotonic()
        child.health_strikes = 0
        self._m_children_up.set(self._live_count())
        logger.info("supervisor: launched %s (pid %d) at %s",
                    child.spec.name, child.pid, child.spec.address)

    async def _run_child(self, child: _Child) -> None:
        """The per-child crash loop: launch, wait, classify the exit,
        restart with backoff — or stop, per the exit-code contract."""
        backoff = self._backoff0
        while not self._closing:
            try:
                await self._launch(child)
            except (OSError, ValueError) as e:
                child.state = SPAWN_FAILED
                logger.error("supervisor: cannot spawn %s: %s",
                             child.spec.name, e)
                return
            started = child.started_at
            rc = await child.process.wait()
            child.last_exit = rc
            self._m_children_up.set(self._live_count())
            if self._closing or rc == 0:
                child.state = STOPPED
                return
            if rc == 2:
                # config error (deploy/child.py contract): restarting
                # replays the same failure — surface it instead
                child.state = CONFIG_ERROR
                self._m_config_errors.inc()
                logger.error("supervisor: %s exited with a CONFIG error "
                             "— not restarting (see %s)",
                             child.spec.name, child.log_path)
                return
            uptime = time.monotonic() - started
            if uptime > 10 * max(self._backoff0, 0.05):
                backoff = self._backoff0  # it ran healthy: forgive history
            child.state = BACKOFF
            logger.warning("supervisor: %s exited rc=%s after %.1fs — "
                           "restart in %.2fs", child.spec.name, rc,
                           uptime, backoff)
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, self._backoff_max)
            if self._closing:
                return
            child.restarts += 1
            self._m_restarts.inc()

    def _live_count(self) -> int:
        return sum(1 for c in self._children.values() if c.alive)

    # ------------------------------------------------------------------
    # health watch
    # ------------------------------------------------------------------

    async def _watch_health(self) -> None:
        while not self._closing:
            await asyncio.sleep(self._health_interval)
            if self.series is not None:
                # the deploy plane's series ring rides this cadence
                self.series.maybe_sample(self.metrics.snapshot)
            for child in list(self._children.values()):
                if child.state != RUNNING or not child.alive:
                    continue
                self._m_health_checks.inc()
                try:
                    body = await fetch_stats(
                        f"127.0.0.1:{child.spec.stats_port}", "/healthz",
                        timeout=max(1.0, self._health_interval))
                    child.healthz = json.loads(body)
                    child.ever_healthy = True
                    child.health_strikes = 0
                except (OSError, RuntimeError, ValueError,
                        asyncio.TimeoutError):
                    self._m_health_failures.inc()
                    if not child.ever_healthy:
                        continue  # still booting (imports, elections)
                    child.health_strikes += 1
                    if child.health_strikes >= _UNHEALTHY_KILL_AFTER:
                        # alive but wedged: make it a crash the restart
                        # loop understands
                        logger.warning(
                            "supervisor: %s failed /healthz %d times — "
                            "killing onto the restart path",
                            child.spec.name, child.health_strikes)
                        self.kill(child.spec.name)

    async def wait_healthy(self, timeout: float = 60.0) -> None:
        """Block until every child's ``/healthz`` answers (fresh probes,
        not the watch cadence) — the launch gate benches and tests use
        before opening client load. Raises ``TimeoutError`` with the
        stragglers named."""
        deadline = time.monotonic() + timeout
        pending = set(self._children)
        while pending:
            for name in sorted(pending):
                child = self._children[name]
                if child.state in (CONFIG_ERROR, SPAWN_FAILED):
                    raise RuntimeError(
                        f"{name} cannot become healthy: {child.state} "
                        f"(see {child.log_path})")
                try:
                    body = await fetch_stats(
                        f"127.0.0.1:{child.spec.stats_port}", "/healthz",
                        timeout=2.0)
                    child.healthz = json.loads(body)
                    child.ever_healthy = True
                    pending.discard(name)
                except (OSError, RuntimeError, ValueError,
                        asyncio.TimeoutError):
                    pass
            if not pending:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"children never became healthy: {sorted(pending)}")
            await asyncio.sleep(0.2)

    # ------------------------------------------------------------------
    # control surface
    # ------------------------------------------------------------------

    def kill(self, name: str, sig: int = signal.SIGKILL
             ) -> tuple[bool, str]:
        """Send ``sig`` to a child — the process-level nemesis hook and
        ``copycat-tpu cluster kill-member``. The crash loop notices the
        exit and restarts with backoff (that is the point: the nemesis
        proves re-route AND recovery)."""
        child = self._children.get(name)
        if child is None:
            return False, (f"unknown member {name!r} — topology has "
                           f"{sorted(self._children)}")
        if not child.alive:
            return False, f"{name} is not running (state {child.state})"
        try:
            child.process.send_signal(sig)
        except ProcessLookupError:
            return False, f"{name} already exited"
        self._m_kills.inc()
        return True, f"sent signal {sig} to {name} (pid {child.pid})"

    def status(self) -> dict:
        return {
            "role": "supervisor",
            "pid": os.getpid(),
            "control": (f"127.0.0.1:{self.control.port}"
                        if self.control is not None else None),
            "groups": self.spec.groups,
            "client_addrs": self.spec.client_addrs(),
            "stats_addrs": self.spec.stats_addrs(),
            "children": {name: child.status()
                         for name, child in sorted(self._children.items())},
        }

    # -- StatsListener surface ----------------------------------------

    def healthz_info(self) -> dict:
        up = self._live_count()
        return {"ok": up == len(self._children), "role": "supervisor",
                "children": len(self._children), "children_up": up}

    def stats_snapshot(self) -> dict:
        return {**self.status(), "deploy": self.metrics.snapshot()}


class ControlListener(StatsListener):
    """The supervisor's control surface: every stats route
    (``/stats`` = topology status + the ``deploy.*`` registry,
    ``/metrics``, ``/healthz``) plus ``/topology`` (the exact spec as
    JSON — what ran, reproducibly) and ``/kill/<name>`` (SIGKILL a
    child; the crash loop restarts it). Loopback-bound like the stats
    listener: the surface is unauthenticated and ``/kill`` is a write."""

    def __init__(self, supervisor: Supervisor, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        super().__init__(supervisor, host=host, port=port)
        self._sup = supervisor

    def _route(self, path: str, query: str = "") -> tuple[bytes, str]:
        if path == "/topology":
            return self._sup.spec.to_json().encode(), "application/json"
        if path.startswith("/kill/"):
            name = path[len("/kill/"):]
            ok, detail = self._sup.kill(name)
            return (json.dumps({"ok": ok, "detail": detail}).encode(),
                    "application/json")
        return super()._route(path, query)


def run_foreground(spec: TopologySpec) -> int:
    """``copycat-tpu cluster spawn``'s engine: run the supervised
    topology until SIGINT/SIGTERM, then tear it down. Returns the exit
    code (0 unless the topology could not even start)."""

    async def drive() -> int:
        sup = Supervisor(spec)
        stop = asyncio.Event()
        signals = 0
        loop = asyncio.get_running_loop()

        def _on_signal() -> None:
            # The handlers stay installed through teardown on purpose:
            # children run in their own sessions (start_new_session), so
            # a raw KeyboardInterrupt mid-close would orphan them with
            # nothing left to reap. First signal = graceful teardown;
            # an insistent second signal hard-kills every child NOW and
            # lets the (then-instant) teardown finish.
            nonlocal signals
            signals += 1
            stop.set()
            if signals >= 2:
                for child in sup._children.values():
                    if child.alive:
                        with contextlib.suppress(ProcessLookupError):
                            child.process.kill()

        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError, ValueError):
                loop.add_signal_handler(sig, _on_signal)
        await sup.open()
        try:
            print(f"cluster up: {len(spec.members)} member(s), "
                  f"{len(spec.ingresses)} ingress(es), "
                  f"{spec.groups} group(s)", flush=True)
            print(f"  control: 127.0.0.1:{sup.control.port} "
                  f"(/stats /topology /kill/<name>)", flush=True)
            print(f"  clients connect to: "
                  f"{', '.join(spec.client_addrs())}", flush=True)
            for name, addr in spec.stats_addrs().items():
                print(f"  {name}: stats {addr}", flush=True)
            await stop.wait()
            print("tearing down...", flush=True)
        finally:
            await sup.close()
        return 0

    try:
        return asyncio.run(drive())
    except KeyboardInterrupt:
        return 0
    except Exception as e:  # noqa: BLE001 — one-line diagnosis, exit 1
        print(f"copycat-tpu cluster: fatal: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1


__all__ = ["ControlListener", "Supervisor", "run_foreground"]
