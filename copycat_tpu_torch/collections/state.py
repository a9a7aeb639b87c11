"""Collection state machines (reference ``MapState.java:32``,
``MultiMapState.java:30``, ``QueueState.java:30``, ``SetState.java:32``).

Live state is *retained commits*: each stored value keeps the commit that
created it and cleans it exactly when the effect is superseded (replaced,
removed, expired, cleared) — the log-cleaning discipline that makes
compaction correct (SURVEY.md §5.4)."""

from __future__ import annotations

from collections import deque
from typing import Any

from ..io.serializer import serialize_with
from ..resource.state_machine import ResourceStateMachine
from ..server.state_machine import Commit
from . import commands as c


class _Held:
    """A stored value + its originating commit + optional TTL timer."""

    __slots__ = ("value", "commit", "timer")

    def __init__(self, value: Any, commit: Commit, timer: Any = None):
        self.value = value
        self.commit = commit
        self.timer = timer

    def discard(self) -> None:
        if self.timer is not None:
            self.timer.cancel()
            self.timer = None
        self.commit.clean()


@serialize_with(73)
class MapState(ResourceStateMachine):
    def __init__(self) -> None:
        super().__init__()
        self._map: dict[Any, _Held] = {}

    # -- helpers -----------------------------------------------------------

    def _store(self, key: Any, value: Any, commit: Commit, ttl: float | None) -> None:
        held = _Held(value, commit)
        if ttl:
            def expire() -> None:
                current = self._map.get(key)
                if current is held:
                    del self._map[key]
                    held.commit.clean()

            held.timer = self.executor.schedule(ttl, expire)
        previous = self._map.get(key)
        if previous is not None:
            previous.discard()
        self._map[key] = held

    # -- queries -----------------------------------------------------------

    def contains_key(self, commit: Commit[c.MapContainsKey]) -> bool:
        try:
            return commit.operation.key in self._map
        finally:
            commit.close()

    def contains_value(self, commit: Commit[c.MapContainsValue]) -> bool:
        try:
            return any(h.value == commit.operation.value for h in self._map.values())
        finally:
            commit.close()

    def get(self, commit: Commit[c.MapGet]) -> Any:
        try:
            held = self._map.get(commit.operation.key)
            return held.value if held is not None else None
        finally:
            commit.close()

    def get_or_default(self, commit: Commit[c.MapGetOrDefault]) -> Any:
        try:
            held = self._map.get(commit.operation.key)
            return held.value if held is not None else commit.operation.default
        finally:
            commit.close()

    def is_empty(self, commit: Commit[c.MapIsEmpty]) -> bool:
        try:
            return not self._map
        finally:
            commit.close()

    def size(self, commit: Commit[c.MapSize]) -> int:
        try:
            return len(self._map)
        finally:
            commit.close()

    # -- commands ----------------------------------------------------------

    def put(self, commit: Commit[c.MapPut]) -> Any:
        op = commit.operation
        previous = self._map.get(op.key)
        result = previous.value if previous is not None else None
        self._store(op.key, op.value, commit, op.ttl)
        return result

    def put_if_absent(self, commit: Commit[c.MapPutIfAbsent]) -> Any:
        op = commit.operation
        previous = self._map.get(op.key)
        if previous is not None:
            commit.clean()
            return previous.value
        self._store(op.key, op.value, commit, op.ttl)
        return None

    def remove(self, commit: Commit[c.MapRemove]) -> Any:
        held = self._map.pop(commit.operation.key, None)
        commit.clean()
        if held is None:
            return None
        held.discard()
        return held.value

    def remove_if_present(self, commit: Commit[c.MapRemoveIfPresent]) -> bool:
        op = commit.operation
        held = self._map.get(op.key)
        commit.clean()
        if held is None or held.value != op.value:
            return False
        del self._map[op.key]
        held.discard()
        return True

    def replace(self, commit: Commit[c.MapReplace]) -> Any:
        op = commit.operation
        previous = self._map.get(op.key)
        if previous is None:
            commit.clean()
            return None
        self._store(op.key, op.value, commit, op.ttl)
        return previous.value

    def replace_if_present(self, commit: Commit[c.MapReplaceIfPresent]) -> bool:
        op = commit.operation
        previous = self._map.get(op.key)
        if previous is None or previous.value != op.expect:
            commit.clean()
            return False
        self._store(op.key, op.value, commit, op.ttl)
        return True

    def clear(self, commit: Commit[c.MapClear]) -> None:
        for held in self._map.values():
            held.discard()
        self._map.clear()
        commit.clean()

    def edge_state(self) -> Any:
        # full-state delta (docs/EDGE_READS.md): the v1 granularity is
        # the whole map per delta — the state-based-CRDT model exactly;
        # per-key delta states are the documented future refinement.
        # Armed TTL timers expire outside the apply path (invisible to
        # the delta plane's dirty marking): opt out, like snapshots.
        if any(h.timer is not None for h in self._map.values()):
            return NotImplemented
        return ("map", {k: h.value for k, h in self._map.items()})

    def delete(self) -> None:
        for held in self._map.values():
            held.discard()
        self._map.clear()


@serialize_with(74)
class MultiMapState(ResourceStateMachine):
    """key -> {value -> held} (reference nested Map<Object,Map<Object,Commit>>)."""

    def __init__(self) -> None:
        super().__init__()
        self._map: dict[Any, dict[Any, _Held]] = {}

    def contains_key(self, commit: Commit[c.MultiMapContainsKey]) -> bool:
        try:
            return commit.operation.key in self._map
        finally:
            commit.close()

    def contains_entry(self, commit: Commit[c.MultiMapContainsEntry]) -> bool:
        try:
            values = self._map.get(commit.operation.key)
            return values is not None and commit.operation.value in values
        finally:
            commit.close()

    def contains_value(self, commit: Commit[c.MultiMapContainsValue]) -> bool:
        try:
            return any(commit.operation.value in values for values in self._map.values())
        finally:
            commit.close()

    def put(self, commit: Commit[c.MultiMapPut]) -> bool:
        op = commit.operation
        values = self._map.setdefault(op.key, {})
        if op.value in values:
            commit.clean()
            return False
        held = _Held(op.value, commit)
        if op.ttl:
            def expire() -> None:
                current = self._map.get(op.key, {})
                if current.get(op.value) is held:
                    del current[op.value]
                    if not current:
                        self._map.pop(op.key, None)
                    held.commit.clean()

            held.timer = self.executor.schedule(op.ttl, expire)
        values[op.value] = held
        return True

    def get(self, commit: Commit[c.MultiMapGet]) -> list:
        try:
            return [h.value for h in self._map.get(commit.operation.key, {}).values()]
        finally:
            commit.close()

    def remove(self, commit: Commit[c.MultiMapRemove]) -> list:
        values = self._map.pop(commit.operation.key, None)
        commit.clean()
        if values is None:
            return []
        out = []
        for held in values.values():
            out.append(held.value)
            held.discard()
        return out

    def remove_entry(self, commit: Commit[c.MultiMapRemoveEntry]) -> bool:
        op = commit.operation
        values = self._map.get(op.key)
        commit.clean()
        if values is None or op.value not in values:
            return False
        values.pop(op.value).discard()
        if not values:
            del self._map[op.key]
        return True

    def is_empty(self, commit: Commit[c.MultiMapIsEmpty]) -> bool:
        try:
            return not self._map
        finally:
            commit.close()

    def size(self, commit: Commit[c.MultiMapSize]) -> int:
        try:
            key = commit.operation.key
            if key is not None:
                return len(self._map.get(key, {}))
            return sum(len(v) for v in self._map.values())
        finally:
            commit.close()

    def clear(self, commit: Commit[c.MultiMapClear]) -> None:
        for values in self._map.values():
            for held in values.values():
                held.discard()
        self._map.clear()
        commit.clean()

    def delete(self) -> None:
        for values in self._map.values():
            for held in values.values():
                held.discard()
        self._map.clear()


@serialize_with(106)
class SetState(ResourceStateMachine):
    def __init__(self) -> None:
        super().__init__()
        self._set: dict[Any, _Held] = {}

    def add(self, commit: Commit[c.SetAdd]) -> bool:
        op = commit.operation
        if op.value in self._set:
            commit.clean()
            return False
        held = _Held(op.value, commit)
        if op.ttl:
            def expire() -> None:
                if self._set.get(op.value) is held:
                    del self._set[op.value]
                    held.commit.clean()

            held.timer = self.executor.schedule(op.ttl, expire)
        self._set[op.value] = held
        return True

    def remove(self, commit: Commit[c.SetRemove]) -> bool:
        held = self._set.pop(commit.operation.value, None)
        commit.clean()
        if held is None:
            return False
        held.discard()
        return True

    def contains(self, commit: Commit[c.SetContains]) -> bool:
        try:
            return commit.operation.value in self._set
        finally:
            commit.close()

    def is_empty(self, commit: Commit[c.SetIsEmpty]) -> bool:
        try:
            return not self._set
        finally:
            commit.close()

    def size(self, commit: Commit[c.SetSize]) -> int:
        try:
            return len(self._set)
        finally:
            commit.close()

    def clear(self, commit: Commit[c.SetClear]) -> None:
        for held in self._set.values():
            held.discard()
        self._set.clear()
        commit.clean()

    def edge_state(self) -> Any:
        # TTL'd members expire outside the apply path: opt out (see map)
        if any(h.timer is not None for h in self._set.values()):
            return NotImplemented
        return ("set", list(self._set.keys()))

    def delete(self) -> None:
        for held in self._set.values():
            held.discard()
        self._set.clear()


@serialize_with(107)
class QueueState(ResourceStateMachine):
    """FIFO queue of retained commits (reference ``QueueState.java:30``)."""

    def __init__(self) -> None:
        super().__init__()
        self._queue: deque[_Held] = deque()

    def _enqueue(self, commit: Commit, value: Any) -> bool:
        self._queue.append(_Held(value, commit))
        return True

    def add(self, commit: Commit[c.QueueAdd]) -> bool:
        return self._enqueue(commit, commit.operation.value)

    def offer(self, commit: Commit[c.QueueOffer]) -> bool:
        return self._enqueue(commit, commit.operation.value)

    def peek(self, commit: Commit[c.QueuePeek]) -> Any:
        try:
            return self._queue[0].value if self._queue else None
        finally:
            commit.close()

    def poll(self, commit: Commit[c.QueuePoll]) -> Any:
        commit.clean()
        if not self._queue:
            return None
        held = self._queue.popleft()
        held.discard()
        return held.value

    def element(self, commit: Commit[c.QueueElement]) -> Any:
        commit.clean()
        if not self._queue:
            raise ValueError("queue is empty")
        return self._queue[0].value

    def remove(self, commit: Commit[c.QueueRemove]) -> Any:
        op = commit.operation
        commit.clean()
        if op.value is None:
            if not self._queue:
                raise ValueError("queue is empty")
            held = self._queue.popleft()
            held.discard()
            return held.value
        for held in self._queue:
            if held.value == op.value:
                self._queue.remove(held)
                held.discard()
                return True
        return False

    def contains(self, commit: Commit[c.QueueContains]) -> bool:
        try:
            return any(h.value == commit.operation.value for h in self._queue)
        finally:
            commit.close()

    def is_empty(self, commit: Commit[c.QueueIsEmpty]) -> bool:
        try:
            return not self._queue
        finally:
            commit.close()

    def size(self, commit: Commit[c.QueueSize]) -> int:
        try:
            return len(self._queue)
        finally:
            commit.close()

    def clear(self, commit: Commit[c.QueueClear]) -> None:
        for held in self._queue:
            held.discard()
        self._queue.clear()
        commit.clean()

    def delete(self) -> None:
        for held in self._queue:
            held.discard()
        self._queue.clear()
