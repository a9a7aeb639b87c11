"""Server state machine for the atomic value (reference
``AtomicValueState.java:32``): single value + owning commit, TTL expiry via
deterministic log-time timers, "change" events to Listen sessions, careful
clean() of superseded commits."""

from __future__ import annotations

from typing import Any

from ..io.serializer import serialize_with
from ..resource.state_machine import ResourceStateMachine
from ..server.state_machine import Commit
from . import commands


@serialize_with(56)
class AtomicValueState(ResourceStateMachine):
    def __init__(self) -> None:
        super().__init__()
        self.value: Any = None
        self._current: Commit | None = None  # commit owning the live value
        self._timer = None
        self._listeners: dict[int, Commit] = {}  # session id -> Listen commit

    # -- value ops ---------------------------------------------------------

    def get(self, commit: Commit[commands.Get]) -> Any:
        try:
            return self.value
        finally:
            commit.close()

    def set(self, commit: Commit[commands.Set]) -> None:
        self._set_current(commit, commit.operation.value, commit.operation.ttl)

    def get_and_set(self, commit: Commit[commands.GetAndSet]) -> Any:
        previous = self.value
        self._set_current(commit, commit.operation.value, commit.operation.ttl)
        return previous

    def compare_and_set(self, commit: Commit[commands.CompareAndSet]) -> bool:
        op = commit.operation
        if self.value == op.expect:
            self._set_current(commit, op.update, op.ttl)
            return True
        commit.clean()
        return False

    def _set_current(self, commit: Commit, value: Any, ttl: float | None) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._current is not None:
            self._current.clean()  # superseded value's commit is reclaimable
        self._current = commit
        changed = value != self.value
        self.value = value
        if ttl:
            def expire() -> None:
                self._expire_value()

            self._timer = self.executor.schedule(ttl, expire)
        if changed:
            self._publish_change(value)

    def _expire_value(self) -> None:
        if self._current is not None:
            self._current.clean()
            self._current = None
        self.value = None
        self._timer = None
        self._publish_change(None)

    # -- change listeners --------------------------------------------------

    def listen(self, commit: Commit[commands.Listen]) -> None:
        session_id = commit.session.id
        previous = self._listeners.get(session_id)
        if previous is not None:
            previous.clean()
        self._listeners[session_id] = commit

    def unlisten(self, commit: Commit[commands.Unlisten]) -> None:
        previous = self._listeners.pop(commit.session.id, None)
        if previous is not None:
            previous.clean()
        commit.clean()

    def _publish_change(self, value: Any) -> None:
        for listen_commit in list(self._listeners.values()):
            session = listen_commit.session
            if session.is_open:
                session.publish("change", value)

    # -- snapshot hooks (crash-recovery plane, docs/DURABILITY.md) --------
    # The plain register states snapshot as one value. States holding
    # commit references that cannot round-trip — an armed TTL timer or
    # live change listeners — opt out (NotImplemented), keeping the whole
    # server on replay-only recovery instead of a lossy image.

    def edge_state(self) -> Any:
        # the whole register IS the state: one tagged value per delta
        # (docs/EDGE_READS.md) — `Get` evaluates client-side as identity.
        # An armed TTL expires via an executor timer OUTSIDE any command
        # apply, where the delta plane's dirty marking cannot see it —
        # refresh records would certify the expired value indefinitely —
        # so TTL'd state opts out (subscribers are retired), the same
        # rule snapshot_state applies.
        if self._timer is not None:
            return NotImplemented
        return ("val", self.value)

    def snapshot_state(self) -> Any:
        if self._timer is not None or self._listeners:
            return NotImplemented
        return {"value": self.value}

    def restore_state(self, data: Any, sessions: dict) -> None:
        self.value = data["value"]
        if self.value is not None:
            # the owning commit is behind the snapshot boundary (entry
            # already released): a log-less stand-in keeps the
            # retained-commit discipline (clean() is a no-op)
            self._current = Commit(0, None, 0.0, None, None)

    # -- lifecycle ---------------------------------------------------------

    def close(self, session: Any) -> None:
        listen_commit = self._listeners.pop(session.id, None)
        if listen_commit is not None:
            listen_commit.clean()

    def delete(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._current is not None:
            self._current.clean()
            self._current = None
        for listen_commit in self._listeners.values():
            listen_commit.clean()
        self._listeners.clear()
        self.value = None
