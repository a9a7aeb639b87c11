"""Server-side resource state machine base (reference
``ResourceStateMachine.java:30``, ``ResourceStateMachineExecutor.java:41``,
``ResourceCommit.java:33``).

``ResourceStateMachine.init`` wraps the parent executor so envelope commits
(ResourceCommand/ResourceQuery) are unwrapped and dispatched to the handler
registered for the INNER operation type; subclass handlers are auto-registered
by their ``Commit[Op]`` annotations, exactly like the reference's reflection.
"""

from __future__ import annotations

from typing import Any, Callable

from ..server.state_machine import Commit, StateMachine, StateMachineExecutor
from .operations import DeleteCommand, ResourceOperation


class ResourceCommit(Commit):
    """A commit view exposing the INNER operation while delegating index/
    session/time/clean/close to the wrapping commit (``ResourceCommit.java``)."""

    __slots__ = ("_parent",)

    def __init__(self, parent: Commit, operation: Any):
        super().__init__(parent.index, parent.session, parent.time, operation, None)
        self._parent = parent

    def clean(self) -> None:
        self._parent.clean()

    def close(self) -> None:
        self._parent.close()


class ResourceStateMachineExecutor(StateMachineExecutor):
    """Unwraps envelope commits and dispatches by inner operation type."""

    def __init__(self, parent: StateMachineExecutor | None = None) -> None:
        super().__init__(context=parent.context if parent else None,
                         log=parent._log if parent else None)
        self._parent = parent

    def execute(self, commit: Commit) -> Any:
        operation = commit.operation
        if isinstance(operation, ResourceOperation):
            commit = ResourceCommit(commit, operation.operation)
        fn = self.callback_for(type(commit.operation))
        if fn is None:
            raise ValueError(
                f"no handler registered for {type(commit.operation).__name__}")
        return fn(commit)

    def schedule(self, delay: float, callback: Callable[[], None], interval=None):
        if self._parent is not None:
            return self._parent.schedule(delay, callback, interval)
        return super().schedule(delay, callback, interval)


class ResourceStateMachine(StateMachine):
    """Base server-side resource state machine.

    Subclasses define handlers annotated ``Commit[SomeOp]``; ``delete()`` is
    the cleanup hook (cancel timers, clean retained commits) invoked by the
    replicated DeleteCommand (reference ``ResourceStateMachine.init:33-42``).
    """

    def init(self, executor: StateMachineExecutor) -> None:
        if not isinstance(executor, ResourceStateMachineExecutor):
            executor = ResourceStateMachineExecutor(executor)
        self.executor = executor
        executor.register(DeleteCommand, self._on_delete)
        self.configure(executor)
        self._auto_register(executor)

    def _on_delete(self, commit: Commit) -> None:
        try:
            self.delete()
        finally:
            commit.clean()

    def edge_state(self) -> Any:
        """Full replicated state for the edge read tier
        (docs/EDGE_READS.md), as a ``(tag, payload)`` pair the client's
        type-agnostic evaluators understand (``"val"``/``"map"``/
        ``"set"``). Tagged states versioned by the applied log index
        form a join-semilattice (merge = max version), which is what
        makes the client replica safe under duplicated/reordered/
        re-delivered delta delivery. ``NotImplemented`` (the default)
        means this machine's reads are never edge-servable."""
        return NotImplemented

    def delete(self) -> None:
        """Release all replicated state (subclass hook)."""
