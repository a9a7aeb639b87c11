"""Wing & Gong linearizability checker with sequential resource models.

Copycat relies on the external ``atomix-jepsen`` suite for this (its
README); SURVEY.md §4 names an in-tree checker as a build obligation.
This module is a copy of ``copycat_tpu/testing/linearize.py``, so the
port stands alone; the two give the same verdicts. The algorithm is the classic Wing & Gong
search with Lowe's memoization: try every *minimal* pending operation (one
no other op completed before its invocation), advance the sequential model,
and backtrack on result mismatch. Histories record real-time windows
``[invoke, complete]`` in driver rounds; incomplete operations (crashed
clients) may linearize at any point or never.

Models mirror the device kernels' result conventions (``ops/apply.py``)
so recorded raw int results can be checked without translation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class HOp:
    """One operation in a history."""

    op_id: int
    op: tuple              # model operation, e.g. ("cas", expect, update)
    result: int | None     # raw result; None = unknown (never completed)
    invoke: float          # round at submission
    complete: float = math.inf  # round at completion (inf = incomplete)


class RegisterModel:
    """Linearizable int register (device value/long kernel semantics)."""

    init = 0

    @staticmethod
    def apply(state: int, op: tuple) -> tuple[int, int]:
        name = op[0]
        if name == "set":
            return op[1], 0
        if name == "get":
            return state, state
        if name == "cas":
            if state == op[1]:
                return op[2], 1
            return state, 0
        if name == "gas":
            return op[1], state
        if name == "add":
            return state + op[1], state + op[1]
        raise ValueError(f"unknown register op {name}")


class CounterModel(RegisterModel):
    """Alias — add/get over an int (DistributedAtomicLong semantics)."""


class MapModel:
    """int→int map; state is a hashable frozenset of items."""

    init = frozenset()

    @staticmethod
    def apply(state: frozenset, op: tuple):
        d = dict(state)
        name = op[0]
        if name == "put":
            old = d.get(op[1], 0)
            d[op[1]] = op[2]
            return frozenset(d.items()), old
        if name == "get":
            return state, d.get(op[1], 0)
        if name == "remove":
            old = d.pop(op[1], 0)
            return frozenset(d.items()), old
        if name == "contains":
            return state, int(op[1] in d)
        if name == "size":
            return state, len(d)
        raise ValueError(f"unknown map op {name}")


class LockModel:
    """try-lock/unlock histories (synchronous results only)."""

    init = -1  # holder id, -1 = free

    @staticmethod
    def apply(state: int, op: tuple) -> tuple[int, int]:
        name, who = op[0], op[1]
        if name == "acquire":        # try-lock: immediate grant or fail;
            if state in (-1, who):   # re-acquire by the holder is idempotent
                return who, 1        # (device kernel semantics, apply.py)
            return state, 0
        if name == "release":
            if state == who:
                return -1, 1
            return state, 0
        raise ValueError(f"unknown lock op {name}")


@dataclass
class CheckResult:
    ok: bool
    nodes: int
    witness: list[int] = field(default_factory=list)  # linearization order


def check_linearizable(history: list[HOp], model,
                       max_nodes: int = 2_000_000,
                       init_state=None) -> CheckResult:
    """Return whether ``history`` is linearizable w.r.t. ``model``.

    Raises ``RuntimeError`` if the search exceeds ``max_nodes`` (history too
    concurrent to decide) — never returns a false verdict.
    """
    by_id = {h.op_id: h for h in history}
    ids = frozenset(by_id)
    init = model.init if init_state is None else init_state

    def all_incomplete(remaining: frozenset) -> bool:
        # only incomplete ops left — they may never apply
        return all(by_id[i].complete == math.inf for i in remaining)

    if all_incomplete(ids):
        return CheckResult(ok=True, nodes=0, witness=[])

    memo: set = set()
    nodes = 1
    order: list[int] = []

    def candidates(remaining: frozenset, state):
        min_complete = min(by_id[i].complete for i in remaining)
        for i in sorted(remaining):
            h = by_id[i]
            if h.invoke > min_complete:
                continue  # some other op completed before this was invoked
            new_state, res = model.apply(state, h.op)
            if h.result is not None and res != h.result:
                continue
            yield i, remaining - {i}, new_state

    # Explicit stack (NOT recursion: a linearization is one stack frame
    # per op, and deep verdict histories run thousands of ops — Python's
    # recursion limit turned them into spurious 'undecided' groups).
    # Frame = (remaining, state, candidate iterator, owns_order_slot).
    stack = [(ids, init, candidates(ids, init), False)]
    while stack:
        remaining, state, it, owns = stack[-1]
        advanced = False
        for i, nr, ns in it:
            order.append(i)
            if all_incomplete(nr):
                return CheckResult(ok=True, nodes=nodes,
                                   witness=list(order))
            if (nr, ns) in memo:
                order.pop()
                continue
            nodes += 1
            if nodes > max_nodes:
                raise RuntimeError(
                    f"linearizability search exceeded {max_nodes} nodes")
            stack.append((nr, ns, candidates(nr, ns), True))
            advanced = True
            break
        if not advanced:
            memo.add((remaining, state))
            stack.pop()
            if owns:
                order.pop()
    return CheckResult(ok=False, nodes=nodes, witness=[])


def quiescent_segments(history: list[HOp]) -> list[list[HOp]]:
    """Split a history at quiescent cuts — points strictly after every
    earlier op's completion and strictly before every later op's
    invocation, with no incomplete op before the cut. No operation spans
    a cut, so a linearization of the whole history is exactly a
    concatenation of per-segment linearizations (threading the model
    state through): segment-wise checking is sound AND complete. An
    incomplete op (may linearize at any later point, or never) blocks
    every later cut, keeping the suffix one segment."""
    hs = sorted(history, key=lambda h: (h.invoke, h.op_id))
    segments: list[list[HOp]] = []
    current: list[HOp] = []
    hi = -math.inf  # max completion (inf once an incomplete op is seen)
    for h in hs:
        if current and hi < h.invoke:
            segments.append(current)
            current = []
        current.append(h)
        hi = max(hi, h.complete)
    if current:
        segments.append(current)
    return segments


def check_linearizable_windowed(history: list[HOp], model,
                                max_nodes: int = 2_000_000,
                                init_state=None) -> CheckResult:
    """Segment-wise Wing & Gong over quiescent cuts (same verdict as the
    monolithic search, tractable on long low-concurrency histories —
    search cost becomes ~linear in ops instead of exponential windows
    compounding). ``init_state`` starts the model elsewhere than
    ``model.init`` — used by harnesses that fence a history (e.g. the
    deep verdict anchors post-abort segments on a linearizable read)."""
    nodes_total = 0
    state = model.init if init_state is None else init_state
    for seg in quiescent_segments(history):
        res = check_linearizable(seg, model, max_nodes=max_nodes,
                                 init_state=state)
        nodes_total += res.nodes
        if not res.ok:
            return CheckResult(ok=False, nodes=nodes_total,
                               witness=res.witness)
        by_id = {h.op_id: h for h in seg}
        for op_id in res.witness:  # thread the segment's end state
            state, _ = model.apply(state, by_id[op_id].op)
    return CheckResult(ok=True, nodes=nodes_total, witness=[])


def check_map_linearizable(history: list[HOp],
                           max_nodes: int = 2_000_000) -> CheckResult:
    """Map histories decomposed per key (every verdict map op is
    single-key: ``op[1]``), each key checked as an independent object —
    sound and complete by Herlihy & Wing locality — then windowed."""
    # Decompose ONLY when every op is provably single-key — an allowlist,
    # so a future multi-key op (size, contains_value, ...) routes to the
    # sound monolithic fallback by default instead of silently splitting.
    single_key_ops = ("put", "get", "remove", "contains")
    if any(h.op[0] not in single_key_ops for h in history):
        return check_linearizable_windowed(history, MapModel,
                                           max_nodes=max_nodes)
    by_key: dict = {}
    for h in history:
        by_key.setdefault(h.op[1], []).append(h)
    nodes_total = 0
    for key_hist in by_key.values():
        res = check_linearizable_windowed(key_hist, MapModel,
                                          max_nodes=max_nodes)
        nodes_total += res.nodes
        if not res.ok:
            return CheckResult(ok=False, nodes=nodes_total,
                               witness=res.witness)
    return CheckResult(ok=True, nodes=nodes_total, witness=[])
