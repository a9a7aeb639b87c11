"""``await-tear``: unguarded protected-state writes across suspension
points — interprocedural since copycheck v2.

The asyncio analogue of a race detector, scoped to the whole
server+deploy plane: the Raft transition cores (``server/raft.py``,
``server/raft_group.py`` — any basename mentioning ``raft``) plus the
compartmentalized tiers that now run the same ordering contracts in
their own processes (``deploy/ingress.py``, ``deploy/supervisor.py``).
Single-threaded asyncio removes data races but not *interleavings*:
every true yield point is a window where another coroutine can run a
whole election, append, or snapshot install. A method that (1) reads
protected state, (2) suspends, then (3) writes that state from the
stale read has torn the transition — the leadership-epoch bug class "On
the parallels between Paxos and Raft" catalogs as quorum-era confusion.

Protected state is keyed ``(base, field)`` exactly as the lexical-era
rule established (docs/SHARDING.md): ``term``, ``voted_for``,
``commit_index``, ``last_applied``, and the log tail, on ``self`` or on
any group alias (``grp = self.groups[k]``) — a guard only discharges a
write on the SAME base.

What the call graph adds (:mod:`callgraph`):

- **Suspension precision, both directions.** An ``await`` of a local
  coroutine the graph classifies never-suspends is NOT an interleaving
  point (no false tear); an ``async for``/``async with`` — a suspension
  the lexical rule was blind to, e.g. an async lock acquire hiding in a
  helper-built context manager — IS one (no false clean). Awaits of
  anything unresolvable stay conservatively suspending.
- **Helper effect summaries.** A call to a same-class sync helper
  inlines the helper's protected reads/writes/guards at the call line,
  mapped onto the call-site base — ``self._commit_term(t)`` after an
  await is a write to ``self.term`` even though no attribute store is
  lexically visible, and ``grp._helper()`` tracks under ``grp``.
  Summaries close transitively through sync same-class helpers (depth
  capped); helpers with their own suspension points contribute their
  effects too (the effects still happen — on the far side of THEIR
  awaits, which the call site's await already models conservatively).

The blessed pattern is unchanged — re-validate after the suspension::

    term = self.term
    responses = await gather(...)          # interleaving point
    if self.role != CANDIDATE or self.term != term:
        return                             # epoch guard re-reads state
    self.commit_index = ...                # now safe

The check stays lexical in ORDER (source order, not CFG paths),
deliberately: a guard that only covers one branch still re-reads the
state, and a method complex enough to defeat the lexical view belongs
in the baseline with a justification, not silently passed.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .astutil import iter_async_functions, qualname_map
from .callgraph import CallGraph, FunctionInfo, own_body
from .findings import Finding

PROTECTED_FIELDS = ("term", "voted_for", "commit_index", "last_applied")
LOG_WRITE_METHODS = ("append", "append_replicated_block", "truncate",
                     "truncate_prefix", "reset_to", "compact", "set_commit")
GUARD_FIELDS = PROTECTED_FIELDS + ("role", "log")

#: basenames beyond the raft cores in scope since the deploy plane runs
#: its own ordering contracts cross-process (docs/DEPLOYMENT.md)
DEPLOY_BASENAMES = ("ingress.py", "supervisor.py")

_SUMMARY_DEPTH = 3


def in_scope(path: str) -> bool:
    basename = path.rsplit("/", 1)[-1]
    return "raft" in basename or basename in DEPLOY_BASENAMES


def _base_attr(node: ast.AST) -> tuple[str, str] | None:
    """``<name>.X`` -> ``(name, X)`` for any simple-name base (``self``,
    a group alias like ``grp``/``g0``, ...)."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)):
        return node.value.id, node.attr
    return None


@dataclass
class Effects:
    """Protected-state touches of one function body on ``self``,
    line-erased (used as a summary inlined at call sites)."""

    reads: set[str] = field(default_factory=set)
    writes: set[str] = field(default_factory=set)
    guards: set[str] = field(default_factory=set)

    def merge(self, other: "Effects") -> None:
        self.reads |= other.reads
        self.writes |= other.writes
        self.guards |= other.guards

    def __bool__(self) -> bool:
        return bool(self.reads or self.writes or self.guards)


def _direct_effects(fn: ast.AST) -> Effects:
    """One function's own protected touches on ``self`` (no nested
    defs, no transitive calls)."""
    eff = Effects()
    for node in own_body(fn):
        if isinstance(node, ast.Attribute):
            rec = _base_attr(node)
            if rec is not None and rec[0] == "self" \
                    and rec[1] in PROTECTED_FIELDS:
                if isinstance(node.ctx, (ast.Store, ast.Del)):
                    eff.writes.add(rec[1])
                else:
                    eff.reads.add(rec[1])
            else:
                inner = _base_attr(node.value) \
                    if isinstance(node, ast.Attribute) else None
                if inner == ("self", "log") and isinstance(node.ctx,
                                                           ast.Load):
                    eff.reads.add("log")
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            inner = _base_attr(node.func.value)
            if inner == ("self", "log"):
                if node.func.attr in LOG_WRITE_METHODS:
                    eff.writes.add("log")
                else:
                    eff.reads.add("log")
        elif isinstance(node, (ast.If, ast.While, ast.Assert)):
            for sub in ast.walk(node.test):
                rec = _base_attr(sub)
                if rec is not None and rec[0] == "self" \
                        and rec[1] in PROTECTED_FIELDS + ("role",):
                    eff.guards.add(rec[1])
    return eff


class _SummaryTable:
    """Transitive per-function effect summaries over same-class sync
    calls (depth-capped, cycle-safe)."""

    def __init__(self, graph: CallGraph | None) -> None:
        self.graph = graph
        self._cache: dict[tuple[str, str], Effects] = {}

    def effects(self, info: FunctionInfo, depth: int = 0,
                seen: frozenset = frozenset()) -> Effects:
        if info.key in self._cache:
            return self._cache[info.key]
        eff = _direct_effects(info.node)
        if self.graph is not None and depth < _SUMMARY_DEPTH:
            for node in own_body(info.node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"):
                    continue
                callee = self.graph.resolve_call(info.path, info, node)
                if callee is None or callee.key in seen \
                        or callee.key == info.key:
                    continue
                eff.merge(self.effects(callee, depth + 1,
                                       seen | {info.key}))
        if depth == 0:
            # only COMPLETE summaries are memoized: a summary computed
            # mid-traversal was truncated by the depth cap / cycle set
            # of its caller's frame, and caching it would hide deeper
            # effects from later top-level queries
            self._cache[info.key] = eff
        return eff


class _Events(ast.NodeVisitor):
    """Collect (line-ordered) reads, writes, suspensions and guard tests
    for one async function body, without descending into nested defs.
    Events are keyed ``(base, field)`` so group-state aliases track
    independently of ``self`` and of each other."""

    def __init__(self, path: str, info: FunctionInfo | None,
                 graph: CallGraph | None,
                 summaries: _SummaryTable) -> None:
        self.path = path
        self.info = info
        self.graph = graph
        self.summaries = summaries
        self.reads: list[tuple[int, tuple[str, str]]] = []
        #: writes carry the via label of the helper that hid them (or None)
        self.writes: list[tuple[int, tuple[str, str], str | None]] = []
        self.suspensions: list[int] = []
        self.guards: list[tuple[int, tuple[str, str]]] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass  # nested sync def: its own context

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass  # nested coroutine: analyzed on its own

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def _call_suspends(self, call: ast.Call) -> bool:
        if self.graph is None:
            return True  # no graph: every await is an interleaving point
        return self.graph.suspends(self.path, self.info, call)

    def visit_Await(self, node: ast.Await) -> None:
        if not isinstance(node.value, ast.Call) \
                or self._call_suspends(node.value):
            self.suspensions.append(node.lineno)
        self.generic_visit(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        # an async context manager acquires on entry — a suspension the
        # lexical rule could not see (no Await node)
        self.suspensions.append(node.lineno)
        self.generic_visit(node)

    def visit_AsyncFor(self, node: ast.AsyncFor) -> None:
        self.suspensions.append(node.lineno)
        self.generic_visit(node)

    def _note_test(self, test: ast.AST) -> None:
        for sub in ast.walk(test):
            rec = _base_attr(sub)
            if rec is not None and rec[1] in PROTECTED_FIELDS + ("role",):
                self.guards.append((test.lineno, rec))
            elif isinstance(sub, ast.Attribute):
                inner = _base_attr(sub.value)
                if inner is not None and inner[1] == "log":
                    self.guards.append((test.lineno, (inner[0], "log")))

    def visit_If(self, node: ast.If) -> None:
        self._note_test(node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._note_test(node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._note_test(node.test)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        rec = _base_attr(node)
        if rec is not None and rec[1] in PROTECTED_FIELDS:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self.writes.append((node.lineno, rec, None))
            else:
                self.reads.append((node.lineno, rec))
        else:
            inner = _base_attr(node.value)
            if inner is not None and inner[1] == "log" \
                    and isinstance(node.ctx, ast.Load):
                # <base>.log.last_index / .term_at — a log-tail read
                # (write methods are classified in visit_Call; an extra
                # read note on the same line is harmless)
                self.reads.append((node.lineno, (inner[0], "log")))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # <base>.log.append(...) and friends: log-tail writes; any other
        # <base>.log.X(...) counts as a log read (term_at, last_index...).
        func = node.func
        if isinstance(func, ast.Attribute):
            inner = _base_attr(func.value)
            if inner is not None and inner[1] == "log":
                key = (inner[0], "log")
                if func.attr in LOG_WRITE_METHODS:
                    self.writes.append((node.lineno, key, None))
                else:
                    self.reads.append((node.lineno, key))
            else:
                self._inline_summary(node, func)
        self.generic_visit(node)

    def _inline_summary(self, node: ast.Call, func: ast.Attribute) -> None:
        """``<base>.helper(...)``: inline the helper's protected effect
        summary at the call line, keyed on the call-site base — the
        write ``self._commit_term()`` hides is a write HERE."""
        if self.graph is None or self.info is None:
            return
        rec = _base_attr(func)
        if rec is None:
            return
        base = rec[0]
        # resolve through the method table of the CALLER's class: group
        # aliases (`grp._helper()`) carry RaftGroup methods in the same
        # file, `self._helper()` the enclosing class's — both resolve
        # name-level within the file, which is the honest boundary
        callee = self.graph.resolve_call(
            self.path, self.info, node) if base == "self" else \
            self._resolve_alias_method(func.attr)
        if callee is None:
            return
        eff = self.summaries.effects(callee)
        if not eff:
            return
        via = callee.label
        for f in sorted(eff.reads):
            self.reads.append((node.lineno, (base, f)))
        for f in sorted(eff.writes):
            self.writes.append((node.lineno, (base, f), via))
        for f in sorted(eff.guards):
            self.guards.append((node.lineno, (base, f)))

    def _resolve_alias_method(self, attr: str) -> FunctionInfo | None:
        """A method called through a non-self base (`grp._helper()`):
        resolve by name against ANY class in the same file — the alias
        model the (base,field) tracking already commits to."""
        for info in self.graph.functions.values():
            if info.path == self.path and info.name == attr \
                    and info.class_name is not None:
                return info
        return None


def check_await_tear(tree: ast.Module, path: str,
                     graph: CallGraph | None = None) -> list[Finding]:
    if not in_scope(path):
        return []
    findings: list[Finding] = []
    summaries = _SummaryTable(graph)
    quals = qualname_map(tree)
    for fn, qual in iter_async_functions(tree):
        info = graph.info_for(path, quals.get(fn, fn.name)) \
            if graph is not None else None
        events = _Events(path, info, graph, summaries)
        for stmt in fn.body:
            events.visit(stmt)
        if not events.suspensions:
            continue
        for wline, (base, fld), via in events.writes:
            suspensions_before = [a for a in events.suspensions if a < wline]
            if not suspensions_before:
                continue
            last_suspension = max(suspensions_before)
            stale_read = any(r < last_suspension and key == (base, fld)
                             for r, key in events.reads)
            if not stale_read:
                continue
            guarded = any(last_suspension < g <= wline
                          and gb == base and gf in (fld, "role")
                          for g, (gb, gf) in events.guards)
            if guarded:
                continue
            hidden = f" (write hidden in `{via}`)" if via else ""
            findings.append(Finding(
                rule="await-tear", path=path, line=wline,
                message=(f"write to protected `{base}.{fld}` after a "
                         f"suspension point with no re-validation of "
                         f"`{fld}`/`role` on `{base}` between the "
                         f"interleaving point and the write{hidden} — "
                         f"re-check the epoch before committing the "
                         f"transition"),
                symbol=qual, via=[via] if via else None))
    return findings
