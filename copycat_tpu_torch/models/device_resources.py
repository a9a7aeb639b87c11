"""Typed client facades over the device consensus path (torch).

Counterpart of ``copycat_tpu/models/device_resources.py``, the same
facades over the port's :class:`~copycat_tpu_torch.models.raft_groups.
RaftGroups`. Copycat's client-side resource classes
(``DistributedAtomicValue.java:38``, ``DistributedAtomicLong.java:29``,
``DistributedMap.java:54``, ``DistributedSet.java:35``,
``DistributedQueue.java:34``, ``DistributedLock.java:58``,
``DistributedLeaderElection.java:66``) wrap a session client and submit
operation objects. Here each facade binds one *group* of a batch and
submits device opcodes; every call is a quorum-committed, linearizable
command applied by the resource kernels (``ops/apply.py``).

Lock grants and election notifications are delivered as *events* (Copycat
pushes session events, ``LockState.java publish("lock", …)``); facades
consume the group's event stream with a private cursor.

Synchronous by design: each call drives the batch loop until its tag
resolves. Batch-parallel use (the bench path) submits raw opcodes across
many groups instead.
"""

from __future__ import annotations

from . import raft_groups
from ..ops import apply as ops

FAIL = ops.FAIL


class DeviceResourceError(RuntimeError):
    """Fixed-capacity device pool overflowed (fall back to the CPU path)."""


def _check_value(v: int) -> int:
    """Device-path payloads must avoid the INT_MIN sentinel (apply.py)."""
    if v == FAIL:
        raise ValueError(
            "INT_MIN is reserved as the device-path FAIL sentinel")
    return v


class DeviceResource:
    """Base: one facade = one group of the batch.

    ``session`` (a :class:`~copycat_tpu_torch.models.sessions.DeviceSession`)
    binds the facade to a device-path client identity: every call
    keep-alives it, a dead session raises instead of operating, and —
    for locks/elections — the session's id is the replicated holder/
    candidate id so crash expiry can release through the log.
    """

    def __init__(self, groups: "raft_groups.RaftGroups", group: int,
                 session=None) -> None:
        self._rg = groups
        self._group = group
        self._session = session
        # Events buffered before this facade existed were addressed to
        # predecessor facades (reference semantic: session events die with
        # the session, ManagedResourceSession.java) — start the cursor past
        # them so e.g. a stale lock grant can never satisfy a new holder.
        # Recovery after restore/event-loss goes through the authoritative
        # registers instead (OP_LOCK_HOLDER / OP_ELECT_LEADER fallbacks).
        evs = groups.events.get(group, [])
        self._ev_last = evs[-1][0] if evs else -1
        # Both read levels ride the query lane (no log append): ATOMIC
        # additionally requires the leader LEASE (quorum-acked latest
        # round — BOUNDED_LINEARIZABLE, Consistency.java:157-176) and
        # escalates to a quorum-committed command when the lease is
        # absent; SEQUENTIAL serves from the leader's applied state.
        self.consistency = "atomic"

    def with_consistency(self, level: str) -> "DeviceResource":
        """Set the read consistency level ('atomic' | 'sequential');
        chainable, mirroring ``Resource.with(Consistency)``."""
        if level not in ("atomic", "sequential"):
            raise ValueError(f"unknown consistency level {level!r}")
        self.consistency = level
        return self

    def _touch(self) -> None:
        if self._session is not None:
            self._session.keep_alive()  # raises when the session is dead

    def _run_until(self, tag: int) -> int:
        """Drive the batch until ``tag`` resolves, with the caller's
        session pinned: a client blocked in its own call is alive, and
        must not be expired by the very rounds its call is driving (the
        commit could otherwise return success AFTER the registry released
        the caller's locks)."""
        registry = self._rg._sessions
        if self._session is not None and registry is not None:
            registry.pin(self._session.id)
            try:
                self._rg.run_until([tag])
            finally:
                registry.unpin(self._session.id)
        else:
            self._rg.run_until([tag])
        return self._rg.results.pop(tag)  # facade path stays bounded

    def _call(self, opcode: int, a: int = 0, b: int = 0, c: int = 0) -> int:
        self._touch()
        return self._run_until(self._rg.submit(self._group, opcode, a, b, c))

    def _read(self, opcode: int, a: int = 0, b: int = 0, c: int = 0) -> int:
        """Route a read-only op by the configured consistency level.

        ATOMIC reads ride the lease-gated query lane (no log append; the
        leader lease certifies BOUNDED_LINEARIZABLE freshness) and
        escalate to a quorum-committed command automatically when the
        lease is absent — the reference's ATOMIC read level
        (``Consistency.java:157-176``)."""
        self._touch()
        level = "atomic" if self.consistency == "atomic" else "sequential"
        return self._run_until(self._rg.submit_query(
            self._group, opcode, a, b, c, consistency=level))

    def _checked(self, *args) -> int:
        result = self._call(*args)
        if result == FAIL:
            raise DeviceResourceError(
                f"device pool overflow/absent for op {args[0]} in group "
                f"{self._group}")
        return result

    def _events(self):
        """Yield this group's events newer than the facade's cursor."""
        for ev in self._rg.events.get(self._group, []):
            if ev[0] > self._ev_last:
                self._ev_last = ev[0]
                yield ev


class DeviceValue(DeviceResource):
    """Linearizable int32 register (DistributedAtomicValue.java:38)."""

    def get(self) -> int:
        return self._read(ops.OP_VALUE_GET)

    def set(self, value: int, ttl: int = 0) -> None:
        self._call(ops.OP_VALUE_SET, value, 0, ttl)

    def compare_and_set(self, expect: int, update: int) -> bool:
        return bool(self._call(ops.OP_VALUE_CAS, expect, update))

    def get_and_set(self, value: int) -> int:
        return self._call(ops.OP_VALUE_GET_AND_SET, value)


class DeviceLong(DeviceResource):
    """Counter (DistributedAtomicLong.java:29). Unlike the reference's
    client-side CAS-retry loop, the add is a single committed command —
    the apply kernel is already atomic in log order."""

    def get(self) -> int:
        return self._read(ops.OP_VALUE_GET)

    def add_and_get(self, delta: int = 1) -> int:
        return self._call(ops.OP_LONG_ADD, delta)

    def get_and_add(self, delta: int = 1) -> int:
        return self.add_and_get(delta) - delta

    def increment_and_get(self) -> int:
        return self.add_and_get(1)

    def decrement_and_get(self) -> int:
        return self.add_and_get(-1)


class DeviceMap(DeviceResource):
    """Fixed-keyspace int32→int32 map (DistributedMap.java:54)."""

    def put(self, key: int, value: int, ttl: int = 0) -> int:
        return self._checked(ops.OP_MAP_PUT, key, _check_value(value), ttl)

    def get(self, key: int) -> int:
        return self._read(ops.OP_MAP_GET, key)

    def get_or_default(self, key: int, default: int) -> int:
        return self._read(ops.OP_MAP_GET_OR_DEFAULT, key, default)

    def put_if_absent(self, key: int, value: int, ttl: int = 0) -> bool:
        return bool(self._checked(ops.OP_MAP_PUT_IF_ABSENT, key,
                                  _check_value(value), ttl))

    def remove(self, key: int) -> int:
        return self._call(ops.OP_MAP_REMOVE, key)

    def remove_if(self, key: int, value: int) -> bool:
        return bool(self._call(ops.OP_MAP_REMOVE_IF, key, value))

    def replace(self, key: int, value: int) -> int | None:
        result = self._call(ops.OP_MAP_REPLACE, key, _check_value(value))
        return None if result == FAIL else result

    def replace_if(self, key: int, expect: int, update: int) -> bool:
        return bool(self._call(ops.OP_MAP_REPLACE_IF, key, expect,
                               _check_value(update)))

    def contains_key(self, key: int) -> bool:
        return bool(self._read(ops.OP_MAP_CONTAINS_KEY, key))

    def contains_value(self, value: int) -> bool:
        return bool(self._read(ops.OP_MAP_CONTAINS_VALUE, value))

    def size(self) -> int:
        return self._read(ops.OP_MAP_SIZE)

    def is_empty(self) -> bool:
        return bool(self._read(ops.OP_MAP_IS_EMPTY))

    def clear(self) -> None:
        self._call(ops.OP_MAP_CLEAR)


class DeviceSet(DeviceResource):
    """Fixed-capacity int32 set (DistributedSet.java:35)."""

    def add(self, value: int, ttl: int = 0) -> bool:
        return bool(self._checked(ops.OP_SET_ADD, _check_value(value), 0,
                                  ttl))

    def remove(self, value: int) -> bool:
        return bool(self._call(ops.OP_SET_REMOVE, value))

    def contains(self, value: int) -> bool:
        return bool(self._read(ops.OP_SET_CONTAINS, value))

    def size(self) -> int:
        return self._read(ops.OP_SET_SIZE)

    def is_empty(self) -> bool:
        return self.size() == 0

    def clear(self) -> None:
        self._call(ops.OP_SET_CLEAR)


class DeviceQueue(DeviceResource):
    """FIFO int32 queue ring (DistributedQueue.java:34 device subset)."""

    def offer(self, value: int) -> bool:
        return bool(self._call(ops.OP_Q_OFFER, _check_value(value)))

    def add(self, value: int) -> None:
        if not self.offer(value):
            raise DeviceResourceError("queue full")

    def poll(self) -> int | None:
        result = self._call(ops.OP_Q_POLL)
        return None if result == FAIL else result

    def peek(self) -> int | None:
        result = self._read(ops.OP_Q_PEEK)
        return None if result == FAIL else result

    def size(self) -> int:
        return self._read(ops.OP_Q_SIZE)

    def is_empty(self) -> bool:
        return self.size() == 0

    def clear(self) -> None:
        self._call(ops.OP_Q_CLEAR)


class DeviceMultiMap(DeviceResource):
    """Fixed-capacity int32 multimap keyed on (key, value) pairs
    (DistributedMultiMap.java:35 / MultiMapState.java:30)."""

    def put(self, key: int, value: int, ttl: int = 0) -> bool:
        return bool(self._checked(ops.OP_MM_PUT, key, _check_value(value),
                                  ttl))

    def remove(self, key: int) -> int:
        """Remove every entry under ``key``; returns the count removed."""
        return self._call(ops.OP_MM_REMOVE, key)

    def remove_entry(self, key: int, value: int) -> bool:
        return bool(self._call(ops.OP_MM_REMOVE_ENTRY, key, value))

    def contains_key(self, key: int) -> bool:
        return bool(self._read(ops.OP_MM_CONTAINS_KEY, key))

    def contains_entry(self, key: int, value: int) -> bool:
        return bool(self._read(ops.OP_MM_CONTAINS_ENTRY, key, value))

    def contains_value(self, value: int) -> bool:
        return bool(self._read(ops.OP_MM_CONTAINS_VALUE, value))

    def count(self, key: int) -> int:
        """Entries under ``key`` (the reference's per-key size,
        MultiMapState.java:169-185)."""
        return self._read(ops.OP_MM_COUNT, key)

    def size(self) -> int:
        return self._read(ops.OP_MM_SIZE)

    def is_empty(self) -> bool:
        return bool(self._read(ops.OP_MM_IS_EMPTY))

    def clear(self) -> None:
        self._call(ops.OP_MM_CLEAR)


class DeviceTopic(DeviceResource):
    """Pub/sub through the log (DistributedTopic.java:61 / TopicState.java:31).

    ``publish`` commits a log entry whose apply fans out ONE broadcast
    event carrying the message; subscribers poll their group's event
    stream. A subscriber receives messages published AFTER its subscribe
    committed (the subscription cursor starts at the current stream
    position) and until unsubscribe — the reference's per-session fan-out
    semantic, with the fan-out itself done client-side at batch scale.
    """

    def __init__(self, groups, group, subscriber_id: int,
                 session=None) -> None:
        super().__init__(groups, group, session)
        self.subscriber_id = subscriber_id
        self._subscribed = False

    def subscribe(self) -> None:
        if self._subscribed:
            return  # idempotent; must not re-drain undelivered messages
        # Snapshot the cursor BEFORE the listen commits: everything
        # harvested after this point is delivered. A message published in
        # the same round but logged before the listen may be delivered
        # spuriously (at-least-once edge); snapshotting AFTER would
        # instead LOSE a message logged after the listen in that round.
        evs = self._rg.events.get(self._group, [])
        if evs:
            self._ev_last = max(self._ev_last, evs[-1][0])
        self._checked(ops.OP_TOPIC_LISTEN, self.subscriber_id)
        self._subscribed = True

    def unsubscribe(self) -> None:
        self._call(ops.OP_TOPIC_UNLISTEN, self.subscriber_id)
        self._subscribed = False

    def publish(self, message: int) -> int:
        """Publish; returns the subscriber count at the publish point."""
        return self._call(ops.OP_TOPIC_PUB, _check_value(message))

    def subscriber_count(self) -> int:
        return self._read(ops.OP_TOPIC_COUNT)

    def poll_messages(self) -> list[int]:
        """Messages broadcast since the last poll (while subscribed)."""
        if not self._subscribed:
            return []
        return [arg for _, code, _t, arg in self._events()
                if code == ops.EV_TOPIC_MSG]


class DeviceLock(DeviceResource):
    """Distributed mutex; grant arrives as a session event
    (DistributedLock.java:58 — completion via event, not command response).

    ``holder_id`` identifies this client in the lock's wait queue — pass a
    ``session`` instead to use the session id (the reference's model:
    lock state keyed by client session, auto-released on session death
    via the registry's log-ordered expiry fan-out)."""

    def __init__(self, groups, group, holder_id: int | None = None,
                 session=None) -> None:
        super().__init__(groups, group, session)
        if session is not None:
            # Death cleanup releases by session.id — a different manual
            # holder_id would silently void the crash-release guarantee.
            if holder_id is not None and holder_id != session.id:
                raise ValueError(
                    "pass either holder_id or session, not both: expiry "
                    "cleanup is keyed by the session id")
            holder_id = session.id
            session.bind(group, "lock")
        elif holder_id is None:
            raise ValueError("DeviceLock needs a holder_id or a session")
        self.holder_id = holder_id
        # grants won via the cancel race (cancel result 2): the grant event
        # still arrives later and must not satisfy a future acquire attempt
        self._swallow_grants = 0

    def _next_grant(self) -> bool:
        for _, code, target, _arg in self._events():
            if code == ops.EV_LOCK_GRANT and target == self.holder_id:
                if self._swallow_grants:
                    self._swallow_grants -= 1
                    continue
                return True
        return False

    def _await_grant(self, deadline_clock: int | None,
                     max_rounds: int = 500) -> bool:
        for i in range(max_rounds):
            self._touch()  # a blocked waiter is alive, not crashed
            if self._next_grant():
                return True
            if i % 20 == 19:
                # authoritative fallback: the replicated holder register is
                # ground truth even if the grant event was lost to outbox
                # overflow; swallow the (possibly still in-flight) event
                if self._call(ops.OP_LOCK_HOLDER) == self.holder_id:
                    self._swallow_grants += 1
                    return True
            if deadline_clock is not None and self._rg.clock >= deadline_clock:
                # Timeout observed: resolve the race through the log — the
                # CANCEL commits in total order with any grant (2 = we won
                # before the cancel applied; the lock is ours).
                if self._call(ops.OP_LOCK_CANCEL, self.holder_id) == 2:
                    self._swallow_grants += 1
                    return True
                return False
            self._rg.step_round()
        raise TimeoutError("no lock grant event")

    def lock(self) -> None:
        result = self._call(ops.OP_LOCK_ACQUIRE, self.holder_id, -1)
        if result == 1:
            return
        if result == 0:  # wait queue full
            raise DeviceResourceError("lock wait queue full")
        granted = self._await_grant(None)
        if not granted:  # unreachable for an untimed wait; fail loudly
            raise DeviceResourceError("lock wait aborted without grant")

    def try_lock(self, timeout: int = 0) -> bool:
        """``timeout`` in logical clock ticks; 0 = immediate."""
        result = self._call(
            ops.OP_LOCK_ACQUIRE, self.holder_id, max(0, timeout))
        if result == 1:
            return True
        if timeout <= 0 or result == 0:
            return False
        return self._await_grant(self._rg.clock + timeout)

    def unlock(self) -> None:
        self._call(ops.OP_LOCK_RELEASE, self.holder_id)


class DeviceElection(DeviceResource):
    """Leader election with epoch fencing tokens
    (DistributedLeaderElection.java:66 — epoch = commit index of the
    winning listen; ``is_leader(epoch)`` validates before fenced actions)."""

    def __init__(self, groups, group, candidate_id: int | None = None,
                 session=None) -> None:
        super().__init__(groups, group, session)
        if session is not None:
            if candidate_id is not None and candidate_id != session.id:
                raise ValueError(
                    "pass either candidate_id or session, not both: expiry "
                    "cleanup is keyed by the session id")
            candidate_id = session.id
            session.bind(group, "election")
        elif candidate_id is None:
            raise ValueError(
                "DeviceElection needs a candidate_id or a session")
        self.candidate_id = candidate_id
        self.epoch: int | None = None
        # promotions won but resigned before ever being polled: the elect
        # event is still in flight and must not satisfy a future listen
        self._swallow_elect = 0
        self._unresolved_polls = 0

    def listen(self) -> int | None:
        """Enter the election; returns the epoch if elected immediately."""
        result = self._checked(ops.OP_ELECT_LISTEN, self.candidate_id)
        if result > 0:
            self.epoch = result
        return self.epoch

    def poll_elected(self) -> int | None:
        """Consume elect events; returns the epoch once this candidate wins."""
        for _, code, target, arg in self._events():
            if code == ops.EV_ELECT and target == self.candidate_id:
                if self._swallow_elect:
                    self._swallow_elect -= 1
                    continue
                self.epoch = arg
        if self.epoch is None:
            # The elect event can be lost to outbox-ring overflow (drop-
            # oldest) or host-buffer trimming; every 20 unresolved polls
            # consult the authoritative replicated leader register instead
            # (mirrors DeviceLock._await_grant's fallback cadence).
            self._unresolved_polls += 1
            if self._unresolved_polls % 20 == 0:
                return self.refresh()
        return self.epoch

    def refresh(self) -> int | None:
        """Authoritative leadership check through the log (survives event
        loss): updates and returns ``epoch`` if this candidate leads now."""
        if self._call(ops.OP_ELECT_LEADER) == self.candidate_id:
            epoch = self._call(ops.OP_ELECT_GET_EPOCH)
            # leader+epoch were two commands; re-verify the pair atomically
            # through the fencing check before trusting it
            if self._call(ops.OP_ELECT_IS_LEADER, self.candidate_id, epoch):
                if self.epoch is None:
                    self._swallow_elect += 1  # elect event may still arrive
                self.epoch = epoch
                return self.epoch
        return None

    def is_leader(self, epoch: int | None = None) -> bool:
        epoch = self.epoch if epoch is None else epoch
        if epoch is None:
            return False
        return bool(self._call(ops.OP_ELECT_IS_LEADER, self.candidate_id,
                               epoch))

    def resign(self) -> bool:
        was_leader = bool(self._call(ops.OP_ELECT_RESIGN, self.candidate_id))
        if was_leader and self.epoch is None:
            # we were promoted but never consumed the elect event
            self._swallow_elect += 1
        self.epoch = None
        return was_leader
