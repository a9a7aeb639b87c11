"""State machine SPI (Copycat ``StateMachine``/``StateMachineExecutor``/``Commit``).

Mirrors the consumed surface (SURVEY.md §2.3 "State machine SPI"):

- ``Commit{index, session, time, operation, clean(), close()}``
- ``StateMachineExecutor.register(op_type, fn)`` + reflective auto-registration:
  any public method whose single parameter is annotated ``Commit[SomeOp]`` is
  registered for ``SomeOp`` (the reference's ``*State`` classes never call
  ``register`` themselves — reflection does it, ``ResourceStateMachine.java:33-42``)
- ``StateMachineExecutor.schedule(delay[, interval]) -> Scheduled`` —
  **log-time driven**: deadlines are measured against the replicated logical
  clock (max entry timestamp applied), so TTLs/lock timeouts fire identically
  on every server (SURVEY.md §5.9).  The leader advances the clock by appending
  NoOp entries when a deadline is due; timers only ever fire during ``tick``.
"""

from __future__ import annotations

import heapq
import inspect
import logging
import typing
from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")


class Commit(Generic[T]):
    """A committed operation handed to a state machine handler."""

    __slots__ = ("index", "session", "time", "operation", "_log", "_cleaned")

    def __init__(self, index: int, session: Any, time: float, operation: T, log: Any = None):
        self.index = index
        self.session = session
        self.time = time
        self.operation = operation
        self._log = log
        self._cleaned = False

    def clean(self) -> None:
        """Mark this commit's effect superseded: the entry may be compacted."""
        if not self._cleaned:
            self._cleaned = True
            if self._log is not None:
                self._log.clean(self.index)

    def close(self) -> None:
        """Release a read-only reference (queries / retained-then-released)."""

    def __repr__(self) -> str:
        return f"Commit(index={self.index}, op={self.operation!r})"


class ScheduledTimer:
    """Deterministic log-time timer handle."""

    __slots__ = ("deadline", "interval", "callback", "cancelled")

    def __init__(self, deadline: float, interval: float | None, callback: Callable[[], None]):
        self.deadline = deadline
        self.interval = interval
        self.callback = callback
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class StateMachineContext:
    """Execution context visible to a state machine during apply."""

    def __init__(self, name: str = "state-machine") -> None:
        self.index = 0  # index of the entry currently being applied
        self.clock = 0.0  # replicated logical time (max entry timestamp)
        self.sessions: dict[int, Any] = {}  # session id -> ServerSession
        self.logger = logging.getLogger(name)


class StateMachineExecutor:
    """Registers operation callbacks and deterministic timers for one machine."""

    def __init__(self, context: StateMachineContext | None = None, log: Any = None) -> None:
        self._context = context or StateMachineContext()
        self._log = log
        self._callbacks: dict[type, Callable[[Commit], Any]] = {}
        self._timers: list[tuple[float, int, ScheduledTimer]] = []
        self._timer_seq = 0

    @property
    def context(self) -> StateMachineContext:
        return self._context

    def logger(self) -> logging.Logger:
        return self._context.logger

    # -- operation registry ------------------------------------------------

    def register(self, op_type: type, callback: Callable[[Commit], Any]) -> "StateMachineExecutor":
        self._callbacks[op_type] = callback
        return self

    def rewrap(self, wrapper: Callable[[Callable], Callable]) -> None:
        """Rewrite every registered callback through ``wrapper`` (the
        device executor wraps generator handlers into batchable jobs)."""
        self._callbacks = {t: wrapper(fn) for t, fn in self._callbacks.items()}

    def callback_for(self, op_type: type) -> Callable[[Commit], Any] | None:
        for cls in op_type.__mro__:
            fn = self._callbacks.get(cls)
            if fn is not None:
                return fn
        return None

    def execute(self, commit: Commit) -> Any:
        fn = self.callback_for(type(commit.operation))
        if fn is None:
            raise ValueError(f"no handler registered for {type(commit.operation).__name__}")
        return fn(commit)

    # -- deterministic timers ---------------------------------------------

    def schedule(
        self, delay: float, callback: Callable[[], None], interval: float | None = None
    ) -> ScheduledTimer:
        timer = ScheduledTimer(self._context.clock + delay, interval, callback)
        self._timer_seq += 1
        heapq.heappush(self._timers, (timer.deadline, self._timer_seq, timer))
        return timer

    def next_deadline(self) -> float | None:
        while self._timers and self._timers[0][2].cancelled:
            heapq.heappop(self._timers)
        return self._timers[0][0] if self._timers else None

    def tick(self, timestamp: float) -> None:
        """Fire all timers with deadline <= timestamp, in deadline order."""
        while self._timers and self._timers[0][0] <= timestamp:
            _, _, timer = heapq.heappop(self._timers)
            if timer.cancelled:
                continue
            try:
                timer.callback()
            except Exception:
                self._context.logger.exception("state machine timer failed")
            if timer.interval is not None and not timer.cancelled:
                timer.deadline += timer.interval
                self._timer_seq += 1
                heapq.heappush(self._timers, (timer.deadline, self._timer_seq, timer))

    def close(self) -> None:
        for _, _, timer in self._timers:
            timer.cancel()
        self._timers.clear()


#: class -> [(method name, Commit[Op] type)] — see _auto_register
_AUTO_REG_TABLES: dict[type, list] = {}


class StateMachine:
    """Base replicated state machine.

    Subclass and either annotate single-parameter methods with ``Commit[Op]``
    (auto-registered, mirroring the reference's reflection) or override
    ``configure`` and call ``executor.register`` explicitly.
    """

    def __init__(self) -> None:
        self.executor: StateMachineExecutor | None = None

    # -- lifecycle ---------------------------------------------------------

    def init(self, executor: StateMachineExecutor) -> None:
        self.executor = executor
        self.configure(executor)
        self._auto_register(executor)

    def configure(self, executor: StateMachineExecutor) -> None:
        """Hook for explicit operation registration."""

    # -- keyspace sharding hook (docs/SHARDING.md) ------------------------

    @classmethod
    def route_group(cls, operation: Any, groups: int) -> int:
        """The Raft group owning ``operation`` on a multi-group server.

        Must be a pure function of the operation and the group count —
        identical on every member and across restarts (the hash-routing
        stability contract). The default pins everything to group 0;
        machines that shard (ResourceManager, bench fixtures) override
        with a stable key hash."""
        return 0

    def _auto_register(self, executor: StateMachineExecutor) -> None:
        # The (method name -> Commit[Op] type) table is a pure function of
        # the CLASS; the signature/type-hint introspection below is
        # expensive (the SPI profile showed ~10% of server wall time spent
        # re-deriving it once per resource INSTANCE at 1k instances), so
        # it is computed once per class and memoized.
        table = _AUTO_REG_TABLES.get(type(self))
        if table is None:
            table = []
            for name in dir(self):
                if name.startswith("_"):
                    continue
                method = getattr(self, name)
                if not inspect.ismethod(method):
                    continue
                try:
                    params = list(
                        inspect.signature(method).parameters.values())
                except (TypeError, ValueError):  # pragma: no cover
                    continue
                if len(params) != 1:
                    continue
                op_type = _commit_op_type(method, params[0])
                if op_type is not None:
                    table.append((name, op_type))
            _AUTO_REG_TABLES[type(self)] = table
        for name, op_type in table:
            if executor.callback_for(op_type) is None:
                executor.register(op_type, getattr(self, name))

    # -- snapshot hooks (crash-recovery plane, docs/DURABILITY.md) --------

    def snapshot_state(self) -> Any:
        """Serializer-writable image of this machine's replicated state at
        the current applied index, or ``NotImplemented`` (the default) when
        the machine cannot be snapshotted — the server then skips snapshot
        capture entirely rather than persist a lossy image.

        Contract for implementers: the returned object must round-trip
        through ``io.serializer.Serializer`` (primitives, containers,
        bytes, registered classes), and machines owning log-time timers
        must include enough information to RE-SCHEDULE them in
        :meth:`restore_state` (deadlines are absolute log-clock values;
        re-schedule with ``deadline - context.clock``)."""
        return NotImplemented

    def restore_state(self, data: Any, sessions: dict[int, Any]) -> None:
        """Rebuild replicated state from a :meth:`snapshot_state` image.
        ``sessions`` is the restored session table (id -> ServerSession) so
        machines tracking sessions can re-bind them by id."""

    # -- session lifecycle hooks (SURVEY.md §3.4) -------------------------

    def register(self, session: Any) -> None:
        """A session opened against this machine."""

    def expire(self, session: Any) -> None:
        """A session timed out (crash suspected) — deterministic on all servers."""

    def close(self, session: Any) -> None:
        """A session closed (gracefully or after expiry)."""


def _commit_op_type(method: Callable, param: inspect.Parameter) -> type | None:
    """Extract ``X`` from a parameter annotated ``Commit[X]``."""
    annotation = param.annotation
    if annotation is inspect.Parameter.empty:
        return None
    if isinstance(annotation, str):
        try:
            hints = typing.get_type_hints(method)
        except Exception:
            return None
        annotation = hints.get(param.name, None)
        if annotation is None:
            return None
    origin = typing.get_origin(annotation)
    if origin is Commit:
        args = typing.get_args(annotation)
        if len(args) == 1 and isinstance(args[0], type):
            return args[0]
    return None
