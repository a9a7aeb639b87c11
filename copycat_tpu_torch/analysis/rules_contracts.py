"""Protocol-contract rules: ``durability-order``, ``span-pairing``,
``exit-code``.

Each encodes an invariant earlier changes could only enforce with tests
— the static complement of a runtime contract:

``durability-order`` — the durability guarantee "followers fsync before
ack, leaders fsync at the commit boundary" (docs/DURABILITY.md), checked
statically inside ``RaftGroup``: no code path may resolve a
client-visible commit/command future or build a success append ack
unless *dominated* by the commit-boundary sync (``_sync_log()`` /
``<x>.log.sync()``). Dominance is lexical source order within a method,
closed interprocedurally through same-class call sites: an ack in
``_apply_entry`` is discharged because every chain of callers reaches
it through ``_apply_up_to`` call sites that sit lexically after a
commit-boundary sync. A method also reachable from OUTSIDE the class
(an attr call on a non-self receiver anywhere in the scanned tree)
cannot be proven dominated — conservative by design; the fused-dispatch
seam (``RaftServer.flush_fused`` → ``grp._finalize_vector_run``) is
exactly such a finding and carries its justification in the baseline.
Error resolves are exempt: a payload naming a ``msg.<ERROR_CODE>``
constant (NO_LEADER, INTERNAL, ...) is a failure report, not an ack,
and ``set_exception`` never acks anything.

``span-pairing`` — the causal-trace span discipline (docs/
OBSERVABILITY.md "Span-name vocabulary"): every literal span name at a
``Tracer.span``-family call site (``TRACER.span``, ``self._trace_span``)
must come from the vocabulary table, exactly as metric-registry
validates metric names — an off-vocabulary span silently falls out of
the cross-member assembly, the phase→histogram mapping, and the
critical-path decomposition. Forwarding wrappers (the name argument is
a parameter of the enclosing function) are exempt — their callers are
checked instead. The pairing half polices the family's completed-span
contract: the API records ``(start, end)`` pairs and returns ``None``,
so ``with TRACER.span(...)`` (an "open" that nothing will ever close)
is a finding, as is a span-family call missing its end timestamp; and a
``.timer(...)`` registry call used as a bare statement opens a Timer
context manager nothing ever enters — the histogram records only in
``__exit__``, so the site measures nothing, silently.

``exit-code`` — the supervisor restart policy is KEYED off child exit
codes (docs/DEPLOYMENT.md exit-code table: 0 = clean stay-down, 2 =
config error never restarted, anything else = crash with backoff).
A role main inventing exit code 3 silently lands in the crash-restart
lane — the deploy-plane mains (``deploy/child.py``, the
``copycat-server`` CLI, ``copycat_tpu_torch/cli.py`` in the port) may
only exit with a documented code.
"""

from __future__ import annotations

import ast
import re

from .astutil import (
    const_str,
    dotted_name,
    enclosing_symbol,
    walk_tree,
)
from .findings import Finding

# ---------------------------------------------------------------------------
# durability-order
# ---------------------------------------------------------------------------

DURABILITY_CLASS = "RaftGroup"

#: attribute names whose futures are client-visible acks
ACK_FUTURE_ATTRS = ("_commit_futures", "commit_futures", "command_futures")

#: ``msg.X`` all-caps constants in a resolve payload mark an error
#: resolve (failure report, not an ack) — scoped to the protocol
#: module's receivers, so an unrelated constant in a SUCCESS payload
#: (``cfg.MAX_INFLIGHT``) can't dodge the dominance check
_ERROR_CONST_RE = re.compile(r"^[A-Z][A-Z_0-9]+$")
_ERROR_RECEIVERS = ("msg", "messages")


def _durability_in_scope(path: str) -> bool:
    return "raft" in path.rsplit("/", 1)[-1]


def _contains_error_const(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) \
                and _ERROR_CONST_RE.match(sub.attr) \
                and isinstance(sub.value, ast.Name) \
                and sub.value.id in _ERROR_RECEIVERS:
            return True
    return False


class _MethodFacts:
    """Per-method lexical facts: commit-boundary syncs, ack events, and
    same-class call sites — nested defs/lambdas attribute to the
    enclosing method at their source line (a spawned completion closure
    still acks on behalf of the method that built it)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.sync_lines: list[int] = []
        #: (line, description)
        self.acks: list[tuple[int, str]] = []
        #: (line, callee method name)
        self.calls: list[tuple[int, str]] = []


def _ack_future_names(fn: ast.AST) -> set[str]:
    """Local names bound (anywhere in the method, nested defs included)
    from an expression that touches an ack-future map — ``fut =
    futures.pop(...)`` where ``futures = self._commit_futures``, a
    for-target over ``.values()``, a ``session.command_futures.get``."""
    names: set[str] = set()
    aliases: set[str] = set()

    def touches(expr: ast.AST) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Attribute) \
                    and sub.attr in ACK_FUTURE_ATTRS:
                return True
            if isinstance(sub, ast.Name) and sub.id in aliases:
                return True
        return False

    # two passes so `futures = self._commit_futures; fut = futures.pop()`
    # resolves regardless of visit order
    for _ in (0, 1):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and touches(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        (aliases if isinstance(node.value, ast.Attribute)
                         else names).add(tgt.id)
                        names.add(tgt.id)
            elif isinstance(node, ast.For) and touches(node.iter):
                if isinstance(node.target, ast.Name):
                    names.add(node.target.id)
    return names


def _collect_method_facts(cls: ast.ClassDef) -> dict[str, _MethodFacts]:
    facts: dict[str, _MethodFacts] = {}
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        mf = _MethodFacts(item.name)
        fut_names = _ack_future_names(item)
        for node in ast.walk(item):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = dotted_name(func) or ""
            # commit-boundary syncs: self._sync_log() / <x>.log.sync()
            # / log.sync()
            if name.endswith("._sync_log") or name.endswith("log.sync") \
                    or name == "log.sync":
                mf.sync_lines.append(node.lineno)
                continue
            # ack events
            if isinstance(func, ast.Attribute) \
                    and func.attr == "set_result" \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id in fut_names:
                if not (node.args
                        and _contains_error_const(node.args[0])):
                    mf.acks.append(
                        (node.lineno,
                         f"resolve of commit/command future "
                         f"`{func.value.id}`"))
                continue
            if name.rsplit(".", 1)[-1] == "AppendResponse" and any(
                    kw.arg == "success"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in node.keywords):
                mf.acks.append((node.lineno, "success append ack"))
                continue
            # same-class call sites (incl. inside nested defs/lambdas)
            if isinstance(func, ast.Attribute) \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id == "self":
                mf.calls.append((node.lineno, func.attr))
        facts[item.name] = mf
    return facts


def check_durability_order(tree: ast.Module, path: str,
                           external_attr_calls: set[str] | None = None
                           ) -> list[Finding]:
    if not _durability_in_scope(path):
        return []
    findings: list[Finding] = []
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef) or cls.name != DURABILITY_CLASS:
            continue
        facts = _collect_method_facts(cls)
        callers: dict[str, list[tuple[str, int]]] = {}
        for mf in facts.values():
            for line, callee in mf.calls:
                if callee in facts:
                    callers.setdefault(callee, []).append((mf.name, line))

        def dominated(method: str, at_line: int,
                      seen: frozenset) -> bool:
            """Is source position ``at_line`` in ``method`` lexically
            preceded by a commit-boundary sync, on every chain of
            same-class callers?"""
            mf = facts[method]
            if any(s < at_line for s in mf.sync_lines):
                return True
            if method in seen:
                return False  # recursion: can't prove, stay conservative
            if external_attr_calls and method in external_attr_calls:
                return False  # entered from outside the class somewhere
            sites = callers.get(method)
            if not sites:
                return False  # an entry point (handler/loop): unproven
            return all(
                dominated(caller, line, seen | {method})
                for caller, line in sites)

        for mf in facts.values():
            for line, what in mf.acks:
                if dominated(mf.name, line, frozenset()):
                    continue
                findings.append(Finding(
                    rule="durability-order", path=path, line=line,
                    message=(f"{what} not dominated by the "
                             f"commit-boundary `_sync_log()` — an ack "
                             f"must never outrun the fsync that makes "
                             f"it durable (docs/DURABILITY.md; fix the "
                             f"order, or baseline with the dominance "
                             f"argument the analysis cannot see)"),
                    symbol=f"{cls.name}.{mf.name}"))
    return findings


# ---------------------------------------------------------------------------
# span-pairing
# ---------------------------------------------------------------------------

SPAN_VOCAB_HEADING = "### Span-name vocabulary"
_SPAN_ROW_RE = re.compile(r"^\|\s*`([a-z0-9_.]+)`\s*\|")

#: method names of the completed-span record family; the span NAME is
#: the second positional argument (trace, name, start, end, ...)
SPAN_RECORD_ATTRS = ("span", "_trace_span")
SPAN_NAME_ARG = 1
SPAN_MIN_ARGS = 4


def parse_span_catalog(observability_md: str) -> set[str] | None:
    """Span names from the docs/OBSERVABILITY.md vocabulary table
    (section scoped: the phase→histogram table further down repeats the
    names but is keyed differently), or ``None`` when missing."""
    idx = observability_md.find(SPAN_VOCAB_HEADING)
    if idx < 0:
        return None
    names: set[str] = set()
    section = observability_md[idx + len(SPAN_VOCAB_HEADING):]
    for line in section.splitlines():
        if line.startswith("#"):
            break
        m = _SPAN_ROW_RE.match(line.strip())
        if m:
            names.add(m.group(1))
    return names or None


def _span_family_call(node: ast.Call) -> bool:
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in SPAN_RECORD_ATTRS)


def _enclosing_params(tree: ast.Module, lineno: int) -> set[str]:
    params: set[str] = set()
    for node in walk_tree(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= lineno <= end:
                a = node.args
                for arg in (a.posonlyargs + a.args + a.kwonlyargs):
                    params.add(arg.arg)
    return params


def check_span_contract(tree: ast.Module, path: str,
                        catalog: set[str] | None) -> list[Finding]:
    if path.endswith("utils/tracing.py"):
        return []  # the substrate itself (ring, assembly, renderer)
    findings: list[Finding] = []
    for node in walk_tree(tree):
        # `with TRACER.span(...)`: the record family returns None — the
        # "open" can never be closed (and crashes at runtime)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) \
                        and isinstance(ctx.func, ast.Attribute) \
                        and ctx.func.attr in SPAN_RECORD_ATTRS:
                    findings.append(Finding(
                        rule="span-pairing", path=path, line=ctx.lineno,
                        message=("`with` over a span-record call — the "
                                 "span family records completed "
                                 "(start, end) pairs and returns None; "
                                 "there is nothing to close. Record "
                                 "the span after the timed section with "
                                 "explicit timestamps"),
                        symbol=enclosing_symbol(tree, ctx.lineno)))
        # a `.timer(...)` opened as a bare statement: the Timer context
        # manager only records in __exit__ — this site measures nothing
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "timer" and call.args \
                    and const_str(call.args[0]) is not None:
                findings.append(Finding(
                    rule="span-pairing", path=path, line=call.lineno,
                    message=("`.timer(...)` opened and discarded — the "
                             "Timer records only via __exit__; enter it "
                             "(`with m.timer(...)`) or it measures "
                             "nothing, silently"),
                    symbol=enclosing_symbol(tree, call.lineno)))
        if not isinstance(node, ast.Call) or not _span_family_call(node):
            continue
        symbol = enclosing_symbol(tree, node.lineno)
        if len(node.args) < SPAN_MIN_ARGS:
            # the record family's signature is (trace, name, start,
            # end, ...): a shorter call is missing its timestamps — the
            # span can't represent a completed (start, end) pair
            findings.append(Finding(
                rule="span-pairing", path=path, line=node.lineno,
                message=("span-record call with fewer than 4 positional "
                         "args — the family records completed (trace, "
                         "name, start, end) tuples; a span missing its "
                         "timestamps records nothing pairable"),
                symbol=symbol))
            continue
        name_arg = node.args[SPAN_NAME_ARG]
        if isinstance(name_arg, ast.IfExp) \
                and const_str(name_arg.body) is not None \
                and const_str(name_arg.orelse) is not None:
            candidates = [const_str(name_arg.body),
                          const_str(name_arg.orelse)]
        else:
            candidates = [const_str(name_arg)]
        if candidates[0] is None:
            if isinstance(name_arg, ast.Name) \
                    and name_arg.id in _enclosing_params(tree,
                                                         node.lineno):
                continue  # forwarding wrapper: callers are checked
            findings.append(Finding(
                rule="span-pairing", path=path, line=node.lineno,
                message=("dynamic span name at a span-record site — use "
                         "a literal from the docs/OBSERVABILITY.md "
                         "vocabulary, or suppress with the source of "
                         "the names"),
                symbol=symbol))
            continue
        if catalog is None:
            continue
        for name in candidates:
            if name not in catalog:
                findings.append(Finding(
                    rule="span-pairing", path=path, line=node.lineno,
                    message=(f"span name `{name}` is not in the docs/"
                             f"OBSERVABILITY.md vocabulary — an "
                             f"off-vocabulary span falls out of the "
                             f"cross-member assembly and the "
                             f"phase histograms; document it first"),
                    symbol=symbol))
    return findings


# ---------------------------------------------------------------------------
# exit-code
# ---------------------------------------------------------------------------

EXIT_TABLE_HEADING = "| exit |"
_EXIT_ROW_RE = re.compile(r"^\|\s*(\d+)\s*\|")

#: the generic crash code: "anything else = crash" in the table; the
#: role mains deliberately use 1 for one-line-diagnosed fatals
CRASH_EXIT_CODE = 1

EXIT_SCOPE_SUFFIXES = ("deploy/child.py", "copycat_tpu_torch/cli.py")


def parse_exit_codes(deployment_md: str) -> set[int] | None:
    """Documented exit codes from the docs/DEPLOYMENT.md table (plus the
    generic crash code), or ``None`` when the table is missing."""
    codes: set[int] = set()
    in_table = False
    for line in deployment_md.splitlines():
        stripped = line.strip()
        if stripped.startswith(EXIT_TABLE_HEADING):
            in_table = True
            continue
        if in_table:
            m = _EXIT_ROW_RE.match(stripped)
            if m:
                codes.add(int(m.group(1)))
            elif not stripped.startswith("|"):
                break
    if not codes:
        return None
    codes.add(CRASH_EXIT_CODE)
    return codes


def check_exit_contract(tree: ast.Module, path: str,
                        allowed: set[int] | None) -> list[Finding]:
    if allowed is None or not path.endswith(EXIT_SCOPE_SUFFIXES):
        return []
    findings: list[Finding] = []
    for node in walk_tree(tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func) or ""
        if name not in ("sys.exit", "exit", "SystemExit"):
            continue
        if name == "exit" and not isinstance(node.func, ast.Name):
            continue
        if not node.args:
            continue  # bare exit: code 0
        try:
            # literal_eval covers `sys.exit(-1)` (a UnaryOp, and 255 at
            # the process boundary) alongside plain int constants;
            # strings (`sys.exit("msg")` = code 1, documented crash)
            # and dynamic expressions fall out
            value = ast.literal_eval(node.args[0])
        except (ValueError, SyntaxError):
            continue
        if isinstance(value, int) and not isinstance(value, bool) \
                and value not in allowed:
            findings.append(Finding(
                rule="exit-code", path=path, line=node.lineno,
                message=(f"exit code {value} is outside the "
                         f"documented contract "
                         f"({sorted(allowed)}, docs/DEPLOYMENT.md) — "
                         f"the supervisor's restart policy is keyed "
                         f"off these codes; an undocumented code "
                         f"lands in the crash-restart lane silently"),
                symbol=enclosing_symbol(tree, node.lineno)))
    return findings
