"""History recorder: concurrent clients over ``RaftGroups`` → checker input.

A copy of ``copycat_tpu/testing/history.py`` for the port's
``RaftGroups``. Wraps the batch driver so each submitted op records its
real-time window:
``invoke`` = driver round at submission, ``complete`` = round its result
was harvested. Ops still pending when the recording ends stay incomplete
(``complete = inf``) — the checker treats them as maybe-applied, exactly
how a Jepsen client handles a crashed request.
"""

from __future__ import annotations

import math

from .linearize import HOp


class HistoryRecorder:
    def __init__(self, rg) -> None:
        self._rg = rg
        self._pending: dict[int, tuple[int, tuple, int]] = {}
        self._done: dict[int, list[HOp]] = {}
        self._pending_per_group: dict[int, int] = {}

    def invoke(self, group: int, opcode: int, model_op: tuple,
               a: int = 0, b: int = 0, c: int = 0,
               query: str | None = None) -> int:
        """Submit a device op and start its history window.

        ``query="atomic"`` routes a read through the lease-gated query
        lane instead of the log (``query="sequential"`` for the plain
        leader-served lane) — the checker then validates the lease reads
        against real time like any other op."""
        if query is not None:
            tag = self._rg.submit_query(group, opcode, a, b, c,
                                        consistency=query)
        else:
            tag = self._rg.submit(group, opcode, a, b, c)
        self._pending[tag] = (group, model_op, self._rg.rounds)
        self._pending_per_group[group] = \
            self._pending_per_group.get(group, 0) + 1
        return tag

    def pending_count(self, group: int) -> int:
        """In-flight recorded ops for ``group`` — drivers bound this like
        a real client's concurrency window (unbounded pipelining under a
        long fault otherwise piles up incomplete ops, which both distorts
        the workload and blows up the checker's search)."""
        return self._pending_per_group.get(group, 0)

    def tick(self, n: int = 1) -> None:
        """Advance the cluster, harvesting completions."""
        for _ in range(n):
            self._rg.step_round()
            self._collect()

    def _collect(self) -> None:
        finished = [t for t in self._pending if t in self._rg.results]
        for tag in finished:
            group, model_op, invoke = self._pending.pop(tag)
            self._pending_per_group[group] -= 1
            self._done.setdefault(group, []).append(HOp(
                op_id=tag, op=model_op, result=self._rg.results[tag],
                invoke=invoke, complete=self._rg.rounds))

    def history(self, group: int) -> list[HOp]:
        """Completed + still-pending ops for one group."""
        out = list(self._done.get(group, []))
        for tag, (g, model_op, invoke) in self._pending.items():
            if g == group:
                out.append(HOp(op_id=tag, op=model_op, result=None,
                               invoke=invoke, complete=math.inf))
        return sorted(out, key=lambda h: (h.invoke, h.op_id))
