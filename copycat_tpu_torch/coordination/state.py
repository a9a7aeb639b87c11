"""Coordination state machines (reference ``LockState.java:33``,
``LeaderElectionState.java:31``, ``MembershipGroupState.java:33``,
``TopicState.java:31``, ``MessageBusState.java:30``)."""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any

from ..io.serializer import serialize_with
from ..resource.state_machine import ResourceStateMachine
from ..server.state_machine import Commit
from . import commands as c


@serialize_with(117)
class LockState(ResourceStateMachine):
    """holder + FIFO wait queue + deterministic timeouts; grant delivered as a
    "lock" session event (reference ``LockState.java:41-66``).

    Capability fix over the reference (SURVEY.md §5.3): the lock IS released
    when the holder's session expires/closes — the reference version never
    re-queued it, wedging the lock forever on client crash."""

    def __init__(self) -> None:
        super().__init__()
        self._holder: Commit | None = None
        self._queue: deque[Commit] = deque()
        self._timers: dict[int, Any] = {}  # commit index -> timer

    def lock(self, commit: Commit[c.Lock]) -> int:
        # The command result is the waiter id (= commit index); every "lock"
        # event carries it so the client resolves the RIGHT waiter even when
        # timeouts fire out of FIFO order (a short try_lock queued behind an
        # unbounded lock can expire before the grant).
        if self._holder is None:
            self._holder = commit
            commit.session.publish("lock", {"id": commit.index, "acquired": True})
            return commit.index
        timeout = commit.operation.timeout
        if timeout == 0:
            commit.session.publish("lock", {"id": commit.index, "acquired": False})
            commit.clean()
            return commit.index
        self._queue.append(commit)
        if timeout and timeout > 0:
            def expire() -> None:
                self._timers.pop(commit.index, None)
                if commit in self._queue:
                    self._queue.remove(commit)
                    commit.session.publish(
                        "lock", {"id": commit.index, "acquired": False})
                    commit.clean()

            self._timers[commit.index] = self.executor.schedule(timeout, expire)
        return commit.index

    def unlock(self, commit: Commit[c.Unlock]) -> None:
        try:
            holder = self._holder
            if holder is None:
                return
            if holder.session.id != commit.session.id:
                raise ValueError("not the lock holder")
            holder.clean()
            self._grant_next()
        finally:
            commit.clean()

    def _grant_next(self) -> None:
        self._holder = None
        while self._queue:
            waiter = self._queue.popleft()
            timer = self._timers.pop(waiter.index, None)
            if timer is not None:
                timer.cancel()
            if waiter.session.is_open:
                self._holder = waiter
                waiter.session.publish("lock", {"id": waiter.index, "acquired": True})
                return
            waiter.clean()

    def close(self, session: Any) -> None:
        # Release on session death (fix over the reference).
        for waiter in [w for w in self._queue if w.session.id == session.id]:
            self._queue.remove(waiter)
            timer = self._timers.pop(waiter.index, None)
            if timer is not None:
                timer.cancel()
            waiter.clean()
        if self._holder is not None and self._holder.session.id == session.id:
            self._holder.clean()
            self._grant_next()

    def delete(self) -> None:
        for timer in self._timers.values():
            timer.cancel()
        self._timers.clear()
        for waiter in self._queue:
            waiter.clean()
        self._queue.clear()
        if self._holder is not None:
            self._holder.clean()
            self._holder = None


@serialize_with(113)
class LeaderElectionState(ResourceStateMachine):
    """leader + FIFO succession of listeners; "elect" event carries the epoch
    (= winning Listen's commit index — a fencing token)
    (reference ``LeaderElectionState.java:36-57,96``)."""

    def __init__(self) -> None:
        super().__init__()
        self._leader: Commit | None = None
        self._listeners: "OrderedDict[int, Commit]" = OrderedDict()  # session id -> Listen

    def listen(self, commit: Commit[c.ElectionListen]) -> None:
        if self._leader is None:
            self._leader = commit
            commit.session.publish("elect", commit.index)
        else:
            previous = self._listeners.get(commit.session.id)
            if previous is not None:
                previous.clean()
            self._listeners[commit.session.id] = commit

    def unlisten(self, commit: Commit[c.ElectionUnlisten]) -> None:
        try:
            session_id = commit.session.id
            waiting = self._listeners.pop(session_id, None)
            if waiting is not None:
                waiting.clean()
            elif self._leader is not None and self._leader.session.id == session_id:
                self._leader.clean()
                self._promote()
        finally:
            commit.clean()

    def is_leader(self, commit: Commit[c.ElectionIsLeader]) -> bool:
        try:
            return self._leader is not None and self._leader.index == commit.operation.epoch
        finally:
            commit.close()

    def _promote(self) -> None:
        self._leader = None
        while self._listeners:
            _, candidate = self._listeners.popitem(last=False)
            if candidate.session.is_open:
                self._leader = candidate
                candidate.session.publish("elect", candidate.index)
                return
            candidate.clean()

    def close(self, session: Any) -> None:
        # Leader failover on session death (reference close:36-49).
        waiting = self._listeners.pop(session.id, None)
        if waiting is not None:
            waiting.clean()
        if self._leader is not None and self._leader.session.id == session.id:
            self._leader.clean()
            self._promote()

    def delete(self) -> None:
        if self._leader is not None:
            self._leader.clean()
            self._leader = None
        for commit in self._listeners.values():
            commit.clean()
        self._listeners.clear()


@serialize_with(124)
class MembershipGroupState(ResourceStateMachine):
    """members keyed by instance-session id; join/leave fan-out events; remote
    execution routes (callback, args) to the target member's session
    (reference ``MembershipGroupState.java:33-95``)."""

    def __init__(self) -> None:
        super().__init__()
        self._members: dict[int, Commit] = {}  # session id -> Join commit
        self._timers: dict[int, Any] = {}

    def join(self, commit: Commit[c.GroupJoin]) -> list[int]:
        session_id = commit.session.id
        if session_id in self._members:
            commit.clean()
        else:
            for member in self._members.values():
                if member.session.is_open:
                    member.session.publish("join", session_id)
            self._members[session_id] = commit
        return list(self._members.keys())

    def leave(self, commit: Commit[c.GroupLeave]) -> None:
        try:
            self._remove_member(commit.session.id)
        finally:
            commit.clean()

    def members_list(self, commit: Commit[c.GroupListen]) -> list[int]:
        try:
            return list(self._members.keys())
        finally:
            commit.clean()

    def execute(self, commit: Commit[c.GroupExecute]) -> bool:
        try:
            op = commit.operation
            member = self._members.get(op.member)
            if member is None or not member.session.is_open:
                return False
            member.session.publish("execute", (op.callback, op.args))
            return True
        finally:
            commit.clean()

    def schedule(self, commit: Commit[c.GroupSchedule]) -> bool:
        op = commit.operation
        member = self._members.get(op.member)
        if member is None:
            commit.clean()
            return False

        def fire() -> None:
            self._timers.pop(commit.index, None)
            target = self._members.get(op.member)
            if target is not None and target.session.is_open:
                target.session.publish("execute", (op.callback, op.args))
            commit.clean()

        self._timers[commit.index] = (
            self.executor.schedule(op.delay or 0.0, fire), commit)
        return True

    def _remove_member(self, session_id: int) -> None:
        member = self._members.pop(session_id, None)
        if member is None:
            return
        member.clean()
        for other in self._members.values():
            if other.session.is_open:
                other.session.publish("leave", session_id)

    def close(self, session: Any) -> None:
        self._remove_member(session.id)

    def delete(self) -> None:
        for timer, pending in self._timers.values():
            timer.cancel()
            pending.clean()  # fire() will never run to clean it
        self._timers.clear()
        for member in self._members.values():
            member.clean()
        self._members.clear()


@serialize_with(128)
class TopicState(ResourceStateMachine):
    """Pub/sub through the log: listeners by session; publish fans out a
    "message" event, pruning closed sessions (reference ``TopicState.java:31``)."""

    def __init__(self) -> None:
        super().__init__()
        self._listeners: dict[int, Commit] = {}

    def listen(self, commit: Commit[c.TopicListen]) -> None:
        previous = self._listeners.get(commit.session.id)
        if previous is not None:
            previous.clean()
        self._listeners[commit.session.id] = commit

    def unlisten(self, commit: Commit[c.TopicUnlisten]) -> None:
        try:
            previous = self._listeners.pop(commit.session.id, None)
            if previous is not None:
                previous.clean()
        finally:
            commit.clean()

    def publish(self, commit: Commit[c.TopicPublish]) -> None:
        try:
            for session_id in list(self._listeners):
                listener = self._listeners[session_id]
                if listener.session.is_open:
                    listener.session.publish("message", commit.operation.message)
                else:
                    del self._listeners[session_id]
                    listener.clean()
        finally:
            commit.clean()

    def close(self, session: Any) -> None:
        listener = self._listeners.pop(session.id, None)
        if listener is not None:
            listener.clean()

    def delete(self) -> None:
        for commit in self._listeners.values():
            commit.clean()
        self._listeners.clear()


@serialize_with(129)
class MessageBusState(ResourceStateMachine):
    """Replicated registry for the out-of-band message bus: member addresses +
    topic consumers; register/unregister broadcast ConsumerInfo events
    (reference ``MessageBusState.java:30``)."""

    def __init__(self) -> None:
        super().__init__()
        self._members: dict[int, Commit] = {}  # session id -> BusJoin commit
        self._topics: dict[str, dict[int, Commit]] = {}  # topic -> session -> Register

    def join(self, commit: Commit[c.BusJoin]) -> dict:
        previous = self._members.get(commit.session.id)
        if previous is not None:
            previous.clean()  # re-join supersedes the old registration
        self._members[commit.session.id] = commit
        # Snapshot: topic -> list of consumer addresses (reference join returns
        # the full registry so a new bus can dial existing consumers).
        snapshot: dict[str, list] = {}
        for topic, registrations in self._topics.items():
            addresses = []
            for session_id in registrations:
                member = self._members.get(session_id)
                if member is not None:
                    addresses.append(member.operation.address)
            snapshot[topic] = addresses
        return snapshot

    def leave(self, commit: Commit[c.BusLeave]) -> None:
        try:
            self._remove(commit.session.id)
        finally:
            commit.clean()

    def register_consumer(self, commit: Commit[c.BusRegister]) -> None:
        topic = commit.operation.topic
        member = self._members.get(commit.session.id)
        if member is None:
            commit.clean()
            raise ValueError("join the bus before registering consumers")
        registrations = self._topics.setdefault(topic, {})
        previous = registrations.get(commit.session.id)
        registrations[commit.session.id] = commit
        if previous is not None:
            # Re-registration: clean the superseded commit and do NOT
            # re-broadcast (clients append addresses blindly).
            previous.clean()
            return
        info = c.ConsumerInfo(topic=topic, address=member.operation.address)
        for other in self._members.values():
            if other.session.is_open:
                other.session.publish("register", info)

    def unregister_consumer(self, commit: Commit[c.BusUnregister]) -> None:
        try:
            topic = commit.operation.topic
            registrations = self._topics.get(topic)
            if registrations is None:
                return
            registration = registrations.pop(commit.session.id, None)
            if registration is not None:
                registration.clean()
                member = self._members.get(commit.session.id)
                if member is not None:
                    info = c.ConsumerInfo(topic=topic, address=member.operation.address)
                    for other in self._members.values():
                        if other.session.is_open:
                            other.session.publish("unregister", info)
            if not registrations:
                self._topics.pop(topic, None)
        finally:
            commit.clean()

    def _remove(self, session_id: int) -> None:
        member = self._members.pop(session_id, None)
        for topic in list(self._topics):
            registrations = self._topics[topic]
            registration = registrations.pop(session_id, None)
            if registration is not None:
                registration.clean()
                if member is not None:
                    info = c.ConsumerInfo(topic=topic, address=member.operation.address)
                    for other in self._members.values():
                        if other.session.is_open:
                            other.session.publish("unregister", info)
            if not registrations:
                self._topics.pop(topic, None)
        if member is not None:
            member.clean()

    def close(self, session: Any) -> None:
        self._remove(session.id)

    def delete(self) -> None:
        for member in self._members.values():
            member.clean()
        self._members.clear()
        for registrations in self._topics.values():
            for commit in registrations.values():
                commit.clean()
        self._topics.clear()
