"""The port's copycheck (``copycat_tpu_torch/analysis/``) against the
reference's (``copycat_tpu/analysis/``), rule by rule.

Every case of ``tests/test_copycheck.py`` runs here on both packages: the
same seeded source snippet goes through the reference's rule function and
the port's, and the findings must be equal — rule, path, line, symbol,
message and call chain, with the package prefix of a path
(``copycat_tpu/`` or ``copycat_tpu_torch/``) mapped. Each case also keeps
the reference test's own expectation (how many findings, which symbol), on
both sides.

Where the port departs from the reference on purpose, a case names the
departure and shows both sides: the torch spellings of a device sync and
of a host round-trip, the named jit roots, the metric and exit-code
scopes, the port's baseline and cache, and ``--update-golden`` refused.

The live tree is linted once per module (:func:`live`), and so is a copy
of it with one violation of every rule seeded into the port's own files
(:func:`seeded`): each rule must fire there, where it was seeded, and
nowhere else.
"""

import ast
import collections
import importlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = "copycat_tpu_torch"
REF_PKG = "copycat_tpu"
_MODULES = ("astutil", "findings", "callgraph", "rules_asyncio",
            "rules_await_tear", "rules_contracts", "rules_jit",
            "rules_registries", "rules_wire", "engine")


def _side(pkg: str) -> SimpleNamespace:
    """One package's analysis: its modules by name, and every public name
    of them flat (``A.check_loop_blocking``), plus ``pkg``."""
    side = SimpleNamespace(pkg=pkg, ALL_RULES=importlib.import_module(
        f"{pkg}.analysis").ALL_RULES)
    for name in _MODULES:
        mod = importlib.import_module(f"{pkg}.analysis.{name}")
        setattr(side, name, mod)
        for attr, value in vars(mod).items():
            if not attr.startswith("_") and not hasattr(side, attr):
                setattr(side, attr, value)
    return side


REF = _side(REF_PKG)
PORT = _side(PORT_PKG)
SIDES = (REF, PORT)


def _tree(A, code: str) -> ast.Module:
    """``code`` dedented, ``PKG`` standing for the side's package."""
    return ast.parse(textwrap.dedent(code).replace("PKG", A.pkg))


def _path(A, rel: str) -> str:
    return f"{A.pkg}/{rel}"


def _map(A, text):
    if text is None:
        return None
    return text.replace(f"{A.pkg}/", "<pkg>/").replace(f"{A.pkg}.",
                                                        "<pkg>.")


def _norm(A, findings) -> list:
    """Findings as comparable tuples, the package prefix mapped."""
    return [(f.rule, _map(A, f.path), f.line, f.symbol, _map(A, f.message),
             None if f.via is None else [_map(A, v) for v in f.via])
            for f in findings]


def _graph(A, path: str, code: str):
    tree = _tree(A, code)
    return tree, A.CallGraph.build({path: tree})


CASES: dict = {}


def case(fn):
    """Register ``fn(A) -> observations`` as a differential case: both
    packages must observe the same."""
    CASES[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# loop-blocking
# ---------------------------------------------------------------------------


@case
def loop_blocking_flags_sleep_fsync_and_open(A):
    tree = _tree(A, """
        import time, os

        async def bad(f):
            time.sleep(1)
            os.fsync(3)
            open("/tmp/x")
    """)
    found = A.check_loop_blocking(tree, "pkg/mod.py")
    assert len(found) == 3
    return _norm(A, found)


@case
def loop_blocking_ignores_sync_defs_and_nested_sync_defs(A):
    tree = _tree(A, """
        import time

        def fine():
            time.sleep(1)

        async def outer():
            def helper():
                time.sleep(1)  # judged at helper's call site
            return helper
    """)
    assert A.check_loop_blocking(tree, "pkg/mod.py") == []
    return []


@case
def loop_blocking_allows_asyncio_sleep(A):
    tree = _tree(A, """
        import asyncio

        async def fine():
            await asyncio.sleep(0.1)
    """)
    return _norm(A, A.check_loop_blocking(tree, "pkg/mod.py"))


@case
def loop_blocking_interprocedural_reaches_into_sync_helpers(A):
    tree, graph = _graph(A, "pkg/mod.py", """
        import subprocess

        def run_tool(cmd):
            return subprocess.run(cmd)

        async def pump(cmd):
            return run_tool(cmd)
    """)
    assert A.check_loop_blocking(tree, "pkg/mod.py") == []
    found = A.check_loop_blocking(tree, "pkg/mod.py", graph)
    assert len(found) == 1 and found[0].symbol == "run_tool"
    tree2, graph2 = _graph(A, "pkg/mod.py", """
        import subprocess

        def inner(cmd):
            return subprocess.run(cmd)

        def outer(cmd):
            return inner(cmd)

        async def pump(cmd):
            return outer(cmd)
    """)
    found2 = A.check_loop_blocking(tree2, "pkg/mod.py", graph2)
    assert len(found2) == 1 and found2[0].symbol == "inner"
    return _norm(A, found) + _norm(A, found2)


@case
def loop_blocking_spares_helpers_no_async_def_reaches(A):
    tree, graph = _graph(A, "pkg/mod.py", """
        import subprocess

        def run_tool(cmd):
            return subprocess.run(cmd)

        def sync_caller(cmd):
            return run_tool(cmd)
    """)
    return _norm(A, A.check_loop_blocking(tree, "pkg/mod.py", graph))


@case
def loop_blocking_deploy_plane_blocklist_entries(A):
    tree = _tree(A, """
        import os, socket, shutil, subprocess

        async def bad(a, b, proc):
            os.waitpid(1, 0)
            socket.create_connection(("host", 1))
            shutil.copyfileobj(a, b)
            subprocess.check_output(["x"])
            proc.wait()
    """)
    found = A.check_loop_blocking(tree, "pkg/mod.py")
    assert len(found) == 5
    return _norm(A, found)


@case
def loop_blocking_awaited_wait_is_the_asyncio_form(A):
    tree = _tree(A, """
        import asyncio

        async def fine(proc, cond):
            await proc.wait()
            await asyncio.wait_for(cond.wait(), 1.0)

        async def bad(proc):
            proc.wait()
    """)
    found = A.check_loop_blocking(tree, "pkg/mod.py")
    assert len(found) == 1 and found[0].symbol == "bad"
    return _norm(A, found)


@case
def loop_blocking_skips_nested_defs_inside_reachable_sync_helpers(A):
    tree, graph = _graph(A, "pkg/mod.py", """
        import shutil

        def helper(tmp, bus):
            def on_done():
                shutil.rmtree(tmp)
            bus.subscribe(on_done)

        async def pump(tmp, bus):
            helper(tmp, bus)
    """)
    return _norm(A, A.check_loop_blocking(tree, "pkg/mod.py", graph))


DEVICE_SYNCS = """
    import time, jax, torch

    async def bad(f, stream):
        time.sleep(1)
        jax.device_get(f)
        f.block_until_ready()
        torch.cuda.synchronize()
        stream.synchronize()
"""


def test_divergence_loop_blocking_knows_the_torch_device_syncs():
    """The reference flags its JAX device syncs; the port flags torch's
    (``torch.cuda.synchronize()``, ``.synchronize()`` on any receiver)
    in their place, with the same reason, and the rest alike."""
    ref, port = (sorted(A.check_loop_blocking(_tree(A, DEVICE_SYNCS),
                                              "pkg/mod.py"),
                        key=lambda f: f.line) for A in SIDES)
    assert [f.line for f in ref] == [5, 6, 7]
    assert [f.line for f in port] == [5, 8, 9]
    assert _norm(REF, ref[:1]) == _norm(PORT, port[:1])
    assert "`torch.cuda.synchronize(...)`" in port[1].message
    assert "`.synchronize(...)`" in port[2].message
    assert ref[2].message.replace("block_until_ready", "synchronize") \
        == port[2].message
    # the port's tensor reads are left out on purpose (see the module)
    reads = _tree(PORT, """
        async def reads(x):
            return x.cpu(), x.item(), x.tolist(), x.numpy()
    """)
    assert PORT.check_loop_blocking(reads, "pkg/mod.py") == []
    doc = PORT.rules_asyncio.__doc__
    assert "cannot tell a CUDA tensor from a numpy array" in " ".join(
        doc.split())


# ---------------------------------------------------------------------------
# orphan-task
# ---------------------------------------------------------------------------


@case
def orphan_task_flags_raw_spawns(A):
    tree = _tree(A, """
        import asyncio

        async def bad(loop, coro):
            loop.create_task(coro)
            asyncio.ensure_future(coro)
            asyncio.create_task(coro)
    """)
    found = A.check_orphan_task(tree, "pkg/mod.py")
    assert len(found) == 3
    return _norm(A, found)


@case
def orphan_task_exempts_tasks_module_and_spawn_calls(A):
    tree = _tree(A, """
        from PKG.utils.tasks import spawn

        async def fine(coro):
            spawn(coro, name="x")
    """)
    assert A.check_orphan_task(tree, "pkg/mod.py") == []
    raw = _tree(A, "async def f(loop, c):\n    loop.create_task(c)\n")
    assert A.check_orphan_task(raw, _path(A, "utils/tasks.py")) == []
    return _norm(A, A.check_orphan_task(raw, _path(A, "server/raft.py")))


# ---------------------------------------------------------------------------
# await-tear
# ---------------------------------------------------------------------------

TEAR = """
    class RaftServer:
        async def transition(self, peer):
            term = self.term
            response = await self.send(peer, term)
            self.term = response.term
"""

GUARDED = """
    class RaftServer:
        async def transition(self, peer):
            term = self.term
            response = await self.send(peer, term)
            if self.term != term:
                return
            self.term = response.term
"""

GROUP_TEAR = """
    class RaftServer:
        async def transition(self, peer):
            grp = self.groups[0]
            term = grp.term
            response = await self.send(peer, term)
            grp.term = response.term
"""

GROUP_GUARDED = """
    class RaftServer:
        async def transition(self, peer):
            grp = self.groups[0]
            term = grp.term
            response = await self.send(peer, term)
            if grp.term != term:
                return
            grp.term = response.term
"""

GROUP_CROSS_BASE_GUARD = """
    class RaftServer:
        async def transition(self, peer, other):
            grp = self.groups[0]
            term = grp.term
            response = await self.send(peer, term)
            if other.term != term:
                return
            grp.term = response.term
"""


@case
def await_tear_flags_unguarded_write_after_await(A):
    found = A.check_await_tear(_tree(A, TEAR), "server/raft.py")
    assert len(found) == 1 and found[0].symbol == "RaftServer.transition"
    return _norm(A, found)


@case
def await_tear_accepts_epoch_guard(A):
    return _norm(A, A.check_await_tear(_tree(A, GUARDED), "server/raft.py"))


@case
def await_tear_flags_group_state_write_after_await(A):
    found = A.check_await_tear(_tree(A, GROUP_TEAR), "server/raft_group.py")
    assert len(found) == 1 and "grp.term" in found[0].message
    return _norm(A, found)


@case
def await_tear_accepts_group_state_epoch_guard(A):
    return _norm(A, A.check_await_tear(_tree(A, GROUP_GUARDED),
                                       "server/raft_group.py"))


@case
def await_tear_guard_must_reread_the_same_base(A):
    found = A.check_await_tear(_tree(A, GROUP_CROSS_BASE_GUARD),
                               "server/raft_group.py")
    assert len(found) == 1
    return _norm(A, found)


@case
def await_tear_scope_covers_raft_group_file(A):
    assert A.check_await_tear(_tree(A, GROUP_TEAR), "client/client.py") == []
    return _norm(A, A.check_await_tear(_tree(A, GROUP_TEAR),
                                       "server/raft_group.py"))


@case
def await_tear_accepts_role_guard_and_flags_log_tail(A):
    role_guard = _tree(A, """
        class RaftServer:
            async def ok(self):
                index = self.commit_index
                await self.quorum()
                if self.role != "leader":
                    return
                self.commit_index = index + 1
    """)
    assert A.check_await_tear(role_guard, "server/raft.py") == []
    log_tear = _tree(A, """
        class RaftServer:
            async def bad(self, entries):
                last = self.log.last_index
                await self.quorum()
                self.log.truncate(last)
    """)
    found = A.check_await_tear(log_tear, "server/raft.py")
    assert len(found) == 1 and "self.log" in found[0].message
    return _norm(A, found)


@case
def await_tear_ignores_pre_await_writes_and_other_files(A):
    pre = _tree(A, """
        class RaftServer:
            async def ok(self):
                self.term += 1
                await self.persist()
    """)
    return (_norm(A, A.check_await_tear(pre, "server/raft.py"))
            + _norm(A, A.check_await_tear(_tree(A, TEAR),
                                          "client/client.py")))


HIDDEN_WRITE = """
    class RaftGroup:
        def _commit_term(self, t):
            self.term = t

        async def transition(self, peer):
            term = self.term
            response = await self.send(peer, term)
            self._commit_term(response.term)
"""


@case
def await_tear_interprocedural_flags_write_hidden_in_helper(A):
    tree = _tree(A, HIDDEN_WRITE)
    assert A.check_await_tear(tree, "server/raft_group.py") == []
    graph = A.CallGraph.build({"server/raft_group.py": tree})
    found = A.check_await_tear(tree, "server/raft_group.py", graph)
    assert len(found) == 1 and "write hidden in" in found[0].message
    return _norm(A, found)


@case
def await_tear_interprocedural_guard_still_discharges_hidden_write(A):
    tree = _tree(A, """
        class RaftGroup:
            def _commit_term(self, t):
                self.term = t

            async def transition(self, peer):
                term = self.term
                response = await self.send(peer, term)
                if self.term != term:
                    return
                self._commit_term(response.term)
    """)
    graph = A.CallGraph.build({"server/raft_group.py": tree})
    return _norm(A, A.check_await_tear(tree, "server/raft_group.py", graph))


@case
def await_tear_never_suspending_await_is_not_an_interleaving_point(A):
    tree = _tree(A, """
        class RaftGroup:
            async def _bump(self, x):
                return x + 1

            async def transition(self):
                term = self.term
                term = await self._bump(term)
                self.term = term
    """)
    lexical = A.check_await_tear(tree, "server/raft.py")
    assert len(lexical) == 1
    graph = A.CallGraph.build({"server/raft.py": tree})
    assert A.check_await_tear(tree, "server/raft.py", graph) == []
    return _norm(A, lexical)


@case
def await_tear_async_with_is_a_suspension_point(A):
    tree = _tree(A, """
        class RaftGroup:
            async def transition(self):
                term = self.term
                async with self.gate:
                    self.term = term + 1
    """)
    graph = A.CallGraph.build({"server/raft.py": tree})
    found = A.check_await_tear(tree, "server/raft.py", graph)
    assert len(found) == 1
    return _norm(A, found)


@case
def await_tear_summary_cache_never_keeps_truncated_entries(A):
    tree = _tree(A, """
        class RaftGroup:
            def _w(self):
                self.term = 0

            def _d(self):
                self._w()

            def _c(self):
                self._d()

            def _b(self):
                self._c()

            def _a(self):
                self._b()

            async def deep(self, peer):
                t = self.term
                await self.send(peer)
                self._a()

            async def shallow(self, peer):
                t = self.term
                await self.send(peer)
                self._d()
    """)
    graph = A.CallGraph.build({"server/raft_group.py": tree})
    found = A.check_await_tear(tree, "server/raft_group.py", graph)
    assert [f.symbol for f in found] == ["RaftGroup.shallow"]
    return _norm(A, found)


@case
def callgraph_ambiguous_module_basename_stays_conservative(A):
    raft = _tree(A, """
        from PKG.client import state

        class RaftGroup:
            async def t(self):
                term = self.term
                await state.load()
                self.term = term + 1
    """)
    pure_state = _tree(A, "async def load():\n    return 1\n")
    trees = {"server/raft.py": raft,
             "client/state.py": pure_state,
             "server/state.py": _tree(A, "async def load():\n    return 2\n")}
    found = A.check_await_tear(raft, "server/raft.py",
                               A.CallGraph.build(trees))
    assert len(found) == 1
    unique = A.CallGraph.build({"server/raft.py": raft,
                                "client/state.py": pure_state})
    assert A.check_await_tear(raft, "server/raft.py", unique) == []
    return _norm(A, found)


@case
def await_tear_scope_covers_the_deploy_plane(A):
    out = [_norm(A, A.check_await_tear(_tree(A, TEAR), _path(A, rel)))
           for rel in ("deploy/ingress.py", "deploy/supervisor.py",
                       "deploy/topology.py")]
    assert out[0] and out[1] and out[2] == []
    return out


# ---------------------------------------------------------------------------
# durability-order
# ---------------------------------------------------------------------------

RESOLVE_BEFORE_SYNC = """
    class RaftGroup:
        def on_quorum(self, index, result):
            fut = self._commit_futures.pop(index, None)
            if fut is not None and not fut.done():
                fut.set_result((index, result, None))
            self._sync_log()
"""

RESOLVE_AFTER_SYNC = """
    class RaftGroup:
        def on_quorum(self, index, result):
            self._sync_log()
            fut = self._commit_futures.pop(index, None)
            if fut is not None and not fut.done():
                fut.set_result((index, result, None))
"""


@case
def durability_order_flags_resolve_before_sync(A):
    found = A.check_durability_order(_tree(A, RESOLVE_BEFORE_SYNC),
                                     "server/raft_group.py")
    assert len(found) == 1 and found[0].symbol == "RaftGroup.on_quorum"
    return _norm(A, found)


@case
def durability_order_accepts_resolve_dominated_by_sync(A):
    return _norm(A, A.check_durability_order(_tree(A, RESOLVE_AFTER_SYNC),
                                             "server/raft_group.py"))


@case
def durability_order_dominance_closes_through_class_callers(A):
    src = _tree(A, """
        class RaftGroup:
            def advance(self, index, result):
                self._sync_log()
                self._resolve(index, result)

            def _resolve(self, index, result):
                fut = self._commit_futures.pop(index, None)
                fut.set_result((index, result, None))
    """)
    assert A.check_durability_order(src, "server/raft_group.py") == []
    found = A.check_durability_order(src, "server/raft_group.py",
                                     external_attr_calls={"_resolve"})
    assert len(found) == 1 and found[0].symbol == "RaftGroup._resolve"
    return _norm(A, found)


@case
def durability_order_exempts_error_resolves_and_other_classes(A):
    err = _tree(A, """
        class RaftGroup:
            def reject(self, index):
                fut = self._commit_futures.pop(index, None)
                if fut is not None:
                    fut.set_result((index, None, msg.NO_LEADER))
    """)
    other = _tree(A, RESOLVE_BEFORE_SYNC.replace("RaftGroup",
                                                 "ReadIndexPlane"))
    return (_norm(A, A.check_durability_order(err, "server/raft_group.py"))
            + _norm(A, A.check_durability_order(other,
                                                "server/raft_group.py"))
            + _norm(A, A.check_durability_order(
                _tree(A, RESOLVE_BEFORE_SYNC), "client/client.py")))


@case
def durability_order_flags_undominated_success_append_ack(A):
    tree = _tree(A, """
        class RaftGroup:
            def on_append(self, request):
                self.log.append_replicated_block(request.entries)
                return AppendResponse(term=self.term, success=True)
    """)
    found = A.check_durability_order(tree, "server/raft_group.py")
    assert len(found) == 1 and "success append ack" in found[0].message
    synced = _tree(A, """
        class RaftGroup:
            def on_append(self, request):
                self.log.append_replicated_block(request.entries)
                self._sync_log()
                return AppendResponse(term=self.term, success=True)
    """)
    assert A.check_durability_order(synced, "server/raft_group.py") == []
    return _norm(A, found)


@case
def durability_order_error_exemption_is_msg_scoped(A):
    tree = _tree(A, """
        class RaftGroup:
            def resolve(self, index):
                fut = self._commit_futures.pop(index, None)
                fut.set_result((index, cfg.MAX_INFLIGHT, None))
    """)
    found = A.check_durability_order(tree, "server/raft_group.py")
    assert len(found) == 1
    return _norm(A, found)


# ---------------------------------------------------------------------------
# span-pairing
# ---------------------------------------------------------------------------

SPAN_VOCAB_MD = """
### Span-name vocabulary

| name | phase |
|---|---|
| `quorum.wait` | commit |
| `group.fsync` | commit |
"""


def _catalog(A):
    with open(os.path.join(REPO, "docs", "OBSERVABILITY.md")) as f:
        return A.parse_span_catalog(f.read())


@case
def span_pairing_validates_names_against_the_vocabulary(A):
    catalog = A.parse_span_catalog(SPAN_VOCAB_MD)
    assert catalog == {"quorum.wait", "group.fsync"}
    tree = _tree(A, """
        class G:
            def ok(self, trace, t0, t1):
                self._trace_span(trace, "quorum.wait", t0, t1)

            def bad(self, trace, t0, t1):
                self._trace_span(trace, "quorum.wiat", t0, t1)
    """)
    found = A.check_span_contract(tree, _path(A, "server/raft_group.py"),
                                  catalog)
    assert len(found) == 1 and found[0].symbol == "G.bad"
    return _norm(A, found)


@case
def span_pairing_forwarding_wrappers_and_dynamic_names(A):
    wrapper = _tree(A, """
        class G:
            def _trace_span(self, trace, name, start, end):
                self.tracer.span(trace, name, start, end)
    """)
    assert A.check_span_contract(wrapper, _path(A, "server/raft.py"),
                                 {"quorum.wait"}) == []
    dynamic = _tree(A, """
        class G:
            def record(self, trace, t0, t1):
                self.tracer.span(trace, self.pick_name(), t0, t1)
    """)
    found = A.check_span_contract(dynamic, _path(A, "server/raft.py"),
                                  {"quorum.wait"})
    assert len(found) == 1
    return _norm(A, found)


@case
def span_pairing_flags_with_over_span_and_bare_timer(A):
    tree = _tree(A, """
        class G:
            def timed(self, trace, metrics, t0, t1):
                with self.tracer.span(trace, "quorum.wait", t0, t1):
                    pass
                metrics.timer("commit_ms")
                with metrics.timer("commit_ms"):
                    pass
    """)
    found = A.check_span_contract(tree, _path(A, "server/raft.py"),
                                  {"quorum.wait"})
    assert len(found) == 2
    return _norm(A, found)


@case
def span_pairing_flags_call_missing_timestamps(A):
    tree = _tree(A, """
        class G:
            def bad(self, trace, t0):
                self._trace_span(trace, "quorum.wait", t0)
    """)
    found = A.check_span_contract(tree, _path(A, "server/raft.py"),
                                  {"quorum.wait"})
    assert len(found) == 1 and "fewer than 4" in found[0].message
    return _norm(A, found)


@case
def span_pairing_admits_edge_spans_and_still_fires_uncataloged(A):
    catalog = _catalog(A)
    assert {"client.edge_serve", "client.delta", "quorum.wait"} <= catalog
    tree = _tree(A, """
        class EdgeReadTier:
            def ok(self, tracer, trace, t0, t1):
                tracer.span(trace, "client.edge_serve", t0, t1)
                tracer.span(trace, "client.delta", t0, t1)

            def bad(self, tracer, trace, t0, t1):
                tracer.span(trace, "client.edge_servee", t0, t1)
    """)
    found = A.check_span_contract(tree, _path(A, "client/edge.py"), catalog)
    assert len(found) == 1
    return _norm(A, found)


# ---------------------------------------------------------------------------
# exit-code
# ---------------------------------------------------------------------------


def _exit_codes(A):
    with open(os.path.join(REPO, "docs", "DEPLOYMENT.md")) as f:
        return A.parse_exit_codes(f.read())


@case
def exit_code_contract_flags_undocumented_codes(A):
    codes = _exit_codes(A)
    assert codes == {0, 1, 2}
    tree = _tree(A, """
        import sys

        def main():
            if bad_config():
                sys.exit(2)
            if crashed():
                sys.exit(1)
            sys.exit(3)
    """)
    found = A.check_exit_contract(tree, _path(A, "deploy/child.py"), codes)
    assert len(found) == 1 and "exit code 3" in found[0].message
    assert A.check_exit_contract(tree, _path(A, "bench.py"), codes) == []
    return _norm(A, found)


@case
def exit_code_contract_sees_negative_literals(A):
    tree = _tree(A, """
        import sys

        def main():
            sys.exit(-1)
    """)
    found = A.check_exit_contract(tree, _path(A, "deploy/child.py"),
                                  {0, 1, 2})
    assert len(found) == 1
    s = _tree(A, "import sys\nsys.exit('bad config')\n")
    assert A.check_exit_contract(s, _path(A, "deploy/child.py"),
                                 {0, 1, 2}) == []
    return _norm(A, found)


def test_divergence_exit_code_scope_is_the_ports_cli():
    """The reference's scope names ``copycat_tpu/cli.py``, which
    ``copycat_tpu_torch/cli.py`` does not end with: its rule would pass the
    port's CLI unchecked. The port's scope covers it, and each package's
    rule checks its own CLI alike."""
    codes = _exit_codes(PORT)
    src = "import sys\n\ndef main():\n    sys.exit(3)\n"
    port_cli = "copycat_tpu_torch/cli.py"
    assert REF.check_exit_contract(ast.parse(src), port_cli, codes) == []
    found = PORT.check_exit_contract(ast.parse(src), port_cli, codes)
    assert [(f.line, f.symbol) for f in found] == [(4, "main")]
    assert _norm(PORT, found) == _norm(REF, REF.check_exit_contract(
        ast.parse(src), "copycat_tpu/cli.py", codes))
    assert PORT.check_exit_contract(ast.parse(src), "copycat_tpu/cli.py",
                                    codes) == []


# ---------------------------------------------------------------------------
# knob-registry
# ---------------------------------------------------------------------------

KNOBS_SRC = '_knob("COPYCAT_GOOD", "int", 1, "doc", section="bench")\n'


@case
def knob_registry_flags_direct_reads_and_unregistered_names(A):
    registered = A.parse_knob_registry(KNOBS_SRC)
    assert registered == {"COPYCAT_GOOD"}
    tree = _tree(A, """
        import os
        from PKG.utils import knobs

        a = os.environ.get("COPYCAT_GOOD", "1")
        b = os.getenv("COPYCAT_GOOD")
        c = os.environ["COPYCAT_GOOD"]
        d = knobs.get_int("COPYCAT_MISSING")
    """)
    found = A.check_knob_registry(tree, _path(A, "mod.py"), registered)
    assert len(found) == 4
    return _norm(A, found)


@case
def knob_registry_allows_writes_typed_getters_and_knobs_module(A):
    tree = _tree(A, """
        import os
        from PKG.utils import knobs

        os.environ["COPYCAT_GOOD"] = "0"     # staging env for a child
        v = knobs.get_int("COPYCAT_GOOD")
        w = os.environ.get("OTHER_PREFIX")   # not a knob
    """)
    raw = _tree(A, 'x = os.environ.get("COPYCAT_GOOD")')
    return (_norm(A, A.check_knob_registry(tree, _path(A, "mod.py"),
                                           {"COPYCAT_GOOD"}))
            + _norm(A, A.check_knob_registry(raw, _path(A, "utils/knobs.py"),
                                             {"COPYCAT_GOOD"})))


def test_divergence_knob_registry_is_the_ports_own():
    """The port's engine reads ``copycat_tpu_torch/utils/knobs.py``: its
    knobs (fewer than the reference's), with the graft entry's."""
    trees = {"m.py": ast.parse("x = 1\n")}
    port = PORT.LintContext.build(REPO, trees).knob_names
    ref = REF.LintContext.build(REPO, trees).knob_names
    from copycat_tpu_torch.utils import knobs
    assert port == set(knobs.REGISTRY) and port != ref
    assert "COPYCAT_ENTRY_DEVICE_TIMEOUT" in port
    assert len(port) < len(ref)


# ---------------------------------------------------------------------------
# metric-registry
# ---------------------------------------------------------------------------

CATALOG_MD = """
## Metric name catalog

| name | kind | meaning |
|---|---|---|
| `good_metric` | counter | fine |
| `labeled{lane}` | counter | fine |
"""


@case
def metric_registry_flags_unknown_names_bad_labels_and_dynamic(A):
    catalog = A.parse_metric_catalog(CATALOG_MD)
    assert catalog == {"good_metric": set(), "labeled": {"lane"}}
    tree = _tree(A, """
        m.counter("good_metric")
        m.counter("labeled", lane="fast")
        m.counter("unknown_metric")
        m.counter("labeled", wrong="x")
        m.counter(dynamic_name)
    """)
    found = A.check_metric_registry(tree, _path(A, "mod.py"), catalog)
    assert len(found) == 3
    return _norm(A, found)


@case
def metric_registry_checks_both_branches_of_a_ternary(A):
    catalog = {"a_metric": set(), "b_metric": set()}
    ok = _tree(A, 'm.counter("a_metric" if cond else "b_metric")')
    assert A.check_metric_registry(ok, _path(A, "mod.py"), catalog) == []
    bad = _tree(A, 'm.counter("a_metric" if cond else "nope")')
    found = A.check_metric_registry(bad, _path(A, "mod.py"), catalog)
    assert len(found) == 1
    return _norm(A, found)


def _group(A, key):
    return next(g for g in A.RULE_GROUPS if g.key == key)


def test_divergence_metric_scope_is_the_ports_package():
    """The engine checks metric names only inside its own package: the
    reference's under ``copycat_tpu/`` — so on the port's modules it
    checks nothing — the port's under ``copycat_tpu_torch/``."""
    src = 'm.counter("not_a_metric")\n'
    out = {}
    for A in SIDES:
        ctx = A.LintContext(root=REPO, metric_catalog={"good": set()})
        run = _group(A, "registries").run
        out[A.pkg] = {p: run(p, src, ast.parse(src), ctx)
                      for p in ("copycat_tpu/mod.py",
                                "copycat_tpu_torch/mod.py")}
    assert out[REF_PKG]["copycat_tpu_torch/mod.py"] == []
    assert out[PORT_PKG]["copycat_tpu/mod.py"] == []
    assert _norm(PORT, out[PORT_PKG]["copycat_tpu_torch/mod.py"]) \
        == _norm(REF, out[REF_PKG]["copycat_tpu/mod.py"])
    assert len(out[PORT_PKG]["copycat_tpu_torch/mod.py"]) == 1


# ---------------------------------------------------------------------------
# wire-schema
# ---------------------------------------------------------------------------

WIRE_OK = """
    @serialize_with(200)
    class Ping(Message):
        _fields = ("a", "b")
"""


@case
def wire_schema_detects_drift_reorder_and_duplicate_ids(A):
    golden = {"200": ["Ping", ["a", "b"]]}
    path = _path(A, "protocol/messages.py")
    assert A.check_wire_schema(_tree(A, WIRE_OK), path, golden) == []
    reordered = _tree(A, """
        @serialize_with(200)
        class Ping(Message):
            _fields = ("b", "a")
    """)
    found = A.check_wire_schema(reordered, path, golden)
    assert len(found) == 1 and "--update-golden" in found[0].message
    dup = _tree(A, """
        @serialize_with(200)
        class Ping(Message):
            _fields = ("a",)

        @serialize_with(200)
        class Pong(Message):
            _fields = ("b",)
    """)
    found2 = A.check_wire_schema(dup, path, golden)
    assert any("reused" in f.message for f in found2)
    return _norm(A, found) + _norm(A, found2)


@case
def wire_schema_flags_new_and_removed_ids(A):
    path = _path(A, "protocol/messages.py")
    golden = {"200": ["Ping", ["a", "b"]], "201": ["Pong", ["c"]]}
    found = A.check_wire_schema(_tree(A, WIRE_OK), path, golden)
    assert len(found) == 1 and "disappeared" in found[0].message
    added = _tree(A, WIRE_OK + """
    @serialize_with(202)
    class New(Message):
        _fields = ("x",)
    """)
    found2 = A.check_wire_schema(added, path, {"200": ["Ping", ["a", "b"]]})
    assert len(found2) == 1 and "new" in found2[0].message
    return _norm(A, found) + _norm(A, found2)


def test_wire_golden_matches_the_ports_messages():
    """The port's ``protocol/messages.py`` renders the shared golden byte
    for byte: the two packages speak one wire format."""
    with open(os.path.join(REPO, PORT_PKG, "protocol", "messages.py")) as f:
        rendered = PORT.render_golden(ast.parse(f.read()))
    with open(os.path.join(REPO, "tests", "golden", "wire_schema.json")) as f:
        assert rendered == f.read()


def _runtime_schema() -> dict:
    from copycat_tpu_torch.io import serializer
    from copycat_tpu_torch.protocol import messages as msg
    return {str(type_id): [cls.__name__, list(cls._fields)]
            for type_id, cls in serializer._TYPE_REGISTRY.items()
            if cls.__module__ == msg.__name__
            and issubclass(cls, msg.Message)}


def test_ports_runtime_schema_matches_the_golden():
    """``tests/test_wire_schema.py`` on the port: the classes the port's
    serializer registers at runtime (not the AST view) equal the golden,
    ids in the protocol block 200-229, every response carrying ``error``."""
    from copycat_tpu_torch.protocol import messages as msg
    schema = _runtime_schema()
    with open(os.path.join(REPO, "tests", "golden", "wire_schema.json")) as f:
        assert schema == json.load(f)
    assert all(200 <= int(i) <= 229 for i in schema)
    for cls_name, fields in schema.values():
        if issubclass(getattr(msg, cls_name), msg.Response):
            assert "error" in fields, cls_name


def test_divergence_update_golden_is_refused(capsys):
    """The golden belongs to the reference package: the port's
    ``--update-golden`` exits 2, names the owner, and writes nothing."""
    golden = os.path.join(REPO, "tests", "golden", "wire_schema.json")
    before = (os.stat(golden).st_mtime_ns, open(golden).read())
    assert PORT.engine.main(["--update-golden"]) == 2
    err = capsys.readouterr().err
    assert "refused" in err and "copycat_tpu/protocol/messages.py" in err
    assert "reference package" in err
    assert (os.stat(golden).st_mtime_ns, open(golden).read()) == before
    assert not hasattr(PORT.engine, "update_wire_golden")


# ---------------------------------------------------------------------------
# jit-purity
# ---------------------------------------------------------------------------

IMPURE_OPS = """
    import time

    def helper(x):
        return time.time() + x

    def step(state):
        return helper(state)

    def unrelated():
        return time.time()
"""


@case
def jit_purity_flags_impurity_reachable_from_a_root(A):
    found = A.check_jit_purity(_tree(A, IMPURE_OPS),
                               _path(A, "ops/consensus.py"), {"step"})
    assert len(found) == 1 and found[0].symbol == "helper"
    return _norm(A, found)


@case
def jit_purity_allows_seeded_draws_and_non_ops_files(A):
    opsmod = _tree(A, """
        def step(key):
            return jax.random.split(key)
    """)
    impure = _tree(A, """
        import time, os

        def step(x):
            return time.time(), os.environ["X"], random.random()
    """)
    assert A.check_jit_purity(impure, _path(A, "models/bulk.py"),
                              {"step"}) == []
    found = A.check_jit_purity(impure, _path(A, "ops/consensus.py"),
                               {"step"})
    assert len(found) == 3
    # the port's RNG reason points at a torch.Generator, the rest alike
    return (_norm(A, A.check_jit_purity(opsmod, _path(A, "ops/consensus.py"),
                                        {"step"}))
            + _norm(A, found[:2]))


def test_divergence_jit_roots_are_named():
    """The port has no ``jax.jit`` to collect roots from: its roots are the
    ``ops/`` functions the reference jits that the port defines, each a
    module-level function of the port's ``ops/consensus.py``."""
    roots = set(PORT.JIT_ROOTS)
    assert roots == {"step", "query_step", "deep_step", "deep_scan",
                     "install_snapshots"}
    ref_trees = {rel: ast.parse(open(os.path.join(REPO, rel)).read())
                 for rel in REF.discover(REPO, [os.path.join(REPO, REF_PKG)])}
    assert roots <= REF.collect_jit_roots(ref_trees)
    with open(os.path.join(REPO, PORT_PKG, "ops", "consensus.py")) as f:
        assert roots <= set(PORT.local_functions(ast.parse(f.read())))
    assert PORT.LintContext.build(REPO, {}).jit_roots == roots
    # a root by name, without any jit in sight
    src = _tree(PORT, "import time\n\ndef deep_scan(s):\n    time.sleep(1)\n")
    assert [f.symbol for f in PORT.check_jit_purity(
        src, "copycat_tpu_torch/ops/consensus.py")] == ["deep_scan"]


def test_divergence_host_round_trips_replace_host_callbacks():
    """The reference forbids host callbacks inside a jitted step; the
    port, which has none, forbids a tensor's host round-trips in their
    place: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and
    ``torch.cuda.synchronize()``."""
    src = """
        import torch

        def step(x):
            jax.debug.callback(print, x)
            a = x.sum().item()
            b = x.tolist()
            c = x.cpu()
            d = x.numpy()
            torch.cuda.synchronize()
            return x
    """
    path = "pkg/ops/consensus.py"
    ref = REF.check_jit_purity(_tree(REF, src), path, {"step"})
    port = PORT.check_jit_purity(_tree(PORT, src), path, {"step"})
    assert [f.line for f in ref] == [5]
    assert sorted(f.line for f in port) == [6, 7, 8, 9, 10]
    assert all("host round-trip" in f.message for f in port)


# ---------------------------------------------------------------------------
# engine: suppressions, baseline, cache, CLI
# ---------------------------------------------------------------------------


@case
def suppression_scoping(A):
    src = ("import time\n"
           "async def f():\n"
           "    time.sleep(1)  # copycheck: ignore[loop-blocking] why\n"
           "    # copycheck: ignore[loop-blocking] next line\n"
           "    time.sleep(2)\n"
           "    time.sleep(3)\n")
    sups = A.scan_suppressions(src)
    found = A.check_loop_blocking(ast.parse(src), "m.py")
    suppressed = sorted(f.line for f in found if A.is_suppressed(f, sups))
    assert suppressed == [3, 5]
    other = A.Finding(rule="orphan-task", path="m.py", line=3, message="x")
    wild = A.scan_suppressions("x()  # copycheck: ignore[*] escape hatch\n")
    return [suppressed, A.is_suppressed(other, sups), A.is_suppressed(
        A.Finding(rule="orphan-task", path="m.py", line=1, message="x"),
        wild)]


def _mini_repo(A, root, body):
    """A temp repo shaped like ours: the side's package with its knob
    registry, and one module."""
    pkg = root / A.pkg
    (pkg / "utils").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "utils" / "__init__.py").write_text("")
    (pkg / "utils" / "knobs.py").write_text(KNOBS_SRC)
    (pkg / "mod.py").write_text(body)
    return root


def _tmp(A, tmp_path_factory):
    return tmp_path_factory.mktemp(A.pkg)


SPAWN = "async def f(loop, c):\n    loop.create_task(c)\n"


ENGINE_CASES: dict = {}


def engine_case(fn):
    ENGINE_CASES[fn.__name__] = fn
    return fn


@engine_case
def baseline_carries_findings_and_reports_stale(A, tmp):
    root = _mini_repo(A, tmp, SPAWN)
    result = A.run_lint(root=str(root), use_cache=False)
    assert len(result.findings) == 1
    bl = A.Baseline()
    bl.entries[result.findings[0].identity()] = "kept: test"
    bl.entries[("orphan-task", f"{A.pkg}/gone.py", "f", "old")] = "stale"
    bl_path = str(tmp / "bl.json")
    bl.save(bl_path)
    again = A.run_lint(root=str(root), baseline_path=bl_path,
                       use_cache=False)
    assert again.findings == [] and len(again.baselined) == 1
    return [_norm(A, result.findings), _norm(A, again.baselined),
            [tuple(_map(A, x) for x in k) for k in again.stale_baseline]]


@engine_case
def strict_fails_and_reports_stale_baseline(A, tmp):
    root = _mini_repo(A, tmp, "async def f():\n    pass\n")
    bl = A.Baseline()
    bl.entries[("orphan-task", f"{A.pkg}/gone.py", "f", "old")] = "gone"
    bl_path = str(tmp / "bl.json")
    bl.save(bl_path)
    result = A.run_lint(root=str(root), baseline_path=bl_path,
                        use_cache=False)
    assert result.findings == [] and len(result.stale_baseline) == 1
    strict = A.render_text(result, strict=True)
    assert "copycheck: FAIL" in strict
    assert "copycheck: ok" in A.render_text(result, strict=False)
    # the stale list names the side's own baseline file
    return [_map(A, line) for line in strict.splitlines()
            if "prune them" not in line]


@engine_case
def sarif_emitter_levels_and_suppressions(A, tmp):
    root = _mini_repo(A, tmp, (
        "async def f(loop, c):\n"
        "    loop.create_task(c)\n"
        "    loop.create_task(c)  # copycheck: ignore[orphan-task] test\n"))
    result = A.run_lint(root=str(root), use_cache=False)
    assert len(result.findings) == 1 and len(result.suppressed) == 1
    doc = json.loads(A.render_sarif(result))
    for res in doc["runs"][0]["results"]:
        loc = res["locations"][0]["physicalLocation"]["artifactLocation"]
        loc["uri"] = _map(A, loc["uri"])
        res["partialFingerprints"] = bool(res["partialFingerprints"])
    return doc


def _git(root, *argv):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    *argv], cwd=root, check=True, capture_output=True)


@engine_case
def changed_mode_filters_findings_to_the_diff(A, tmp):
    root = _mini_repo(A, tmp, SPAWN)
    (root / ".gitignore").write_text("_build/\n")
    _git(root, "init", "-q")
    _git(root, "add", "-A")
    _git(root, "commit", "-qm", "seed")
    (root / A.pkg / "fresh.py").write_text(
        "async def g(loop, c):\n    loop.create_task(c)\n")
    full = A.run_lint(root=str(root), use_cache=False)
    diff = A.run_lint(root=str(root), use_cache=False, changed_base="HEAD")
    assert diff.files == full.files
    return [sorted(_map(A, f.path) for f in full.findings),
            [_map(A, p) for p in diff.changed_files],
            _norm(A, diff.findings)]


@engine_case
def changed_mode_uses_merge_base_not_two_dot(A, tmp):
    root = _mini_repo(A, tmp, SPAWN)
    _git(root, "init", "-q", "-b", "main")
    _git(root, "add", "-A")
    _git(root, "commit", "-qm", "seed")
    _git(root, "branch", "feature")
    (root / A.pkg / "mainonly.py").write_text(
        "async def m(loop, c):\n    loop.create_task(c)\n")
    _git(root, "add", "-A")
    _git(root, "commit", "-qm", "main moves on")
    _git(root, "checkout", "-q", "feature")
    (root / A.pkg / "fresh.py").write_text(
        "async def g(loop, c):\n    loop.create_task(c)\n")
    diff = A.run_lint(root=str(root), use_cache=False, changed_base="main")
    return [[_map(A, p) for p in diff.changed_files], _norm(A, diff.findings)]


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_matches_the_reference(name, tmp_path_factory):
    """The engine cases of the reference over a temp repo shaped like each
    package's own."""
    got = [ENGINE_CASES[name](A, _tmp(A, tmp_path_factory)) for A in SIDES]
    assert got[1] == got[0], f"{name}: port {got[1]} != reference {got[0]}"


def test_divergence_baseline_and_cache_are_the_ports(tmp_path):
    """The port's baseline is ``copycat_tpu_torch/analysis/baseline.json``
    (never the reference's ``.copycheck-baseline.json``) and its cache
    lives under ``copycat_tpu_torch/_build/``, which ``.gitignore``
    lists; the cache hits and invalidates as the reference's does."""
    assert PORT.BASELINE_FILE == "copycat_tpu_torch/analysis/baseline.json"
    assert PORT.CACHE_FILE.startswith("copycat_tpu_torch/_build/")
    assert "copycat_tpu_torch/_build/" in open(
        os.path.join(REPO, ".gitignore")).read().split()
    root = _mini_repo(PORT, tmp_path, SPAWN)
    # a baseline at the reference's path is not the port's
    (root / ".copycheck-baseline.json").write_text(json.dumps(
        {"version": 1, "findings": [{
            "rule": "orphan-task", "path": "copycat_tpu_torch/mod.py",
            "symbol": "f", "message": "x", "justification": "y"}]}))
    r1 = PORT.run_lint(root=str(root), use_cache=True)
    assert len(r1.findings) == 1 and r1.stale_baseline == []
    assert not (root / ".copycheck-cache.json").exists()
    cache_path = root / PORT.CACHE_FILE
    assert "copycat_tpu_torch/mod.py" in json.loads(
        cache_path.read_text())["files"]
    r2 = PORT.run_lint(root=str(root), use_cache=True)
    assert [f.to_json() for f in r2.findings] == \
        [f.to_json() for f in r1.findings]
    (root / PORT_PKG / "mod.py").write_text("async def f():\n    pass\n")
    assert PORT.run_lint(root=str(root), use_cache=True).findings == []


def test_engine_cache_invalidates_per_rule_group(tmp_path, monkeypatch):
    """Editing ONE rule module re-lints only its group — every other
    group's cached results survive (the reference's case, on the port)."""
    engine = PORT.engine
    root = _mini_repo(PORT, tmp_path, SPAWN)
    r1 = PORT.run_lint(root=str(root), use_cache=True)
    assert len(r1.findings) == 1
    counts: collections.Counter = collections.Counter()
    for spec in engine.RULE_GROUPS:
        def counted(path, src, tree, ctx, _key=spec.key, _orig=spec.run):
            counts[_key] += 1
            return _orig(path, src, tree, ctx)

        monkeypatch.setattr(spec, "run", counted)
    r2 = PORT.run_lint(root=str(root), use_cache=True)
    assert not counts
    real = engine._analysis_source
    monkeypatch.setattr(
        engine, "_analysis_source",
        lambda mod: real(mod) + ("\n# edited" if mod == "rules_wire.py"
                                 else ""))
    r3 = PORT.run_lint(root=str(root), use_cache=True)
    assert set(counts) == {"wire"}
    assert [f.to_json() for f in r3.findings] == \
        [f.to_json() for f in r2.findings] == \
        [f.to_json() for f in r1.findings]


def test_write_baseline_refuses_changed_scope(capsys):
    with pytest.raises(SystemExit) as exc:
        PORT.engine.main(["--write-baseline", "--changed", "HEAD"])
    assert exc.value.code == 2
    assert "--write-baseline needs the full-tree view" in \
        capsys.readouterr().err


_MODULE_PROBE = """
import json, runpy, sys
sys.argv = ["copycat_tpu_torch.analysis", "--no-cache", sys.argv[1]]
try:
    runpy.run_module("copycat_tpu_torch.analysis", run_name="__main__")
except SystemExit as e:
    code = e.code
print(json.dumps({"code": code, "imported": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("torch", "jax", "numpy", "copycat_tpu"))}))
"""


def test_module_lint_exit_code_on_a_seeded_file(tmp_path):
    """``python -m copycat_tpu_torch.analysis`` on one seeded file exits 1,
    names the rule and imports neither torch nor the reference package
    (the whole tree's exit 0 is ``test_torch_cli.py``'s and
    :func:`test_live_tree_is_clean`'s)."""
    bad = tmp_path / "bad_raft.py"
    bad.write_text(SPAWN)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run(
        [sys.executable, "-c", _MODULE_PROBE, str(bad)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    *report, last = proc.stdout.splitlines()
    assert json.loads(last) == {"code": 1, "imported": []}
    assert any("orphan-task" in line for line in report)


def test_all_rules_have_coverage_here():
    """The port runs the reference's ten rules, and every one of them is
    exercised in this file."""
    assert PORT.ALL_RULES == REF.ALL_RULES
    with open(__file__, encoding="utf-8") as f:
        src = f.read()
    for rule in PORT.ALL_RULES:
        assert rule in src, f"rule {rule} has no fixture coverage"
        assert rule in SEEDED_RULES


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_matches_the_reference(name):
    """The case's snippets through both packages' rules: the same
    findings."""
    got = [CASES[name](A) for A in SIDES]
    assert got[1] == got[0], f"{name}: port {got[1]} != reference {got[0]}"


# ---------------------------------------------------------------------------
# the port's live tree, and a copy of it with every rule seeded
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def live():
    return PORT.run_lint(root=REPO, use_cache=False)


def test_live_tree_is_clean(live):
    assert live.findings == [] and live.parse_errors == []
    assert live.stale_baseline == []
    assert live.files > 100


@pytest.mark.parametrize("rule", REF.ALL_RULES)
def test_live_tree_has_no_finding_of(live, rule):
    assert [f for f in live.findings if f.rule == rule] == []


def test_live_tree_carries_only_justified_baselines(live):
    """What the port keeps rides its own baseline, each entry with its
    argument: the reference's three (ported with their code) and the
    smoke script's profiler window."""
    carried = sorted({(f.rule, f.path, f.symbol) for f in live.baselined})
    assert carried == [
        ("durability-order", "copycat_tpu_torch/server/raft_group.py",
         "RaftGroup._complete_command"),
        ("durability-order", "copycat_tpu_torch/server/raft_group.py",
         "RaftGroup._finalize_vector_run"),
        ("loop-blocking", "chip_smoke.py", "profiling"),
        ("loop-blocking", "copycat_tpu_torch/cli.py", "_serve")]
    with open(os.path.join(REPO, PORT.BASELINE_FILE)) as f:
        baseline = json.load(f)
    for entry in baseline["findings"]:
        assert entry["justification"].strip(), entry
        assert "TODO" not in entry["justification"], entry
    # the suppressed ones: the telemetry hub's two eager-registration loops
    assert sorted((f.path, f.rule) for f in live.suppressed) == [
        ("copycat_tpu_torch/models/telemetry.py", "metric-registry")] * 2


def test_live_tree_scope_is_the_port():
    rels = PORT.discover(REPO)
    assert "chip_smoke.py" in rels and "ab_quorum_kernels.py" in rels
    assert "copycat_tpu_torch/graft_entry.py" in rels
    assert not any(p.startswith(("copycat_tpu/", "tests/")) for p in rels)


def test_catalog_has_no_orphan_entries_in_the_port():
    """Every metric of the shared catalog is one the port records too."""
    with open(os.path.join(REPO, "docs", "OBSERVABILITY.md")) as f:
        catalog = PORT.parse_metric_catalog(f.read())
    used: set[str] = set()
    for rel in PORT.discover(REPO):
        if not rel.startswith(f"{PORT_PKG}/"):
            continue
        with open(os.path.join(REPO, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in PORT.METRIC_METHODS
                    and node.args):
                first = node.args[0]
                for arg in ([first.body, first.orelse]
                            if isinstance(first, ast.IfExp) else [first]):
                    if isinstance(arg, ast.Constant) \
                            and isinstance(arg.value, str):
                        used.add(arg.value)
    from copycat_tpu_torch.models.telemetry import _COUNTERS, _GAUGES
    used |= set(_COUNTERS) | set(_GAUGES)
    assert not set(catalog) - used


#: One violation of every rule, seeded into the port's own files of a copy
#: of the tree: ``rule: (file, anchor, inserted, symbol)``. The text is
#: inserted before ``anchor`` (``None``: appended to the file); the rule
#: must fire on the last line inserted, in ``symbol``.
SEEDED = {
    "loop-blocking": (
        "copycat_tpu_torch/client/client.py", None,
        "\nimport time\n\n\nasync def _seeded_block():\n"
        "    time.sleep(0.01)\n", "_seeded_block"),
    "orphan-task": (
        "copycat_tpu_torch/server/raft.py", None,
        "\n\nasync def _seeded_spawn(loop, coro):\n"
        "    loop.create_task(coro)\n", "_seeded_spawn"),
    "await-tear": (
        "copycat_tpu_torch/server/raft_group.py", "    def _complete_command(",
        "    async def _seeded_tear(self, peer):\n"
        "        term = self.term\n"
        "        response = await self.send(peer, term)\n"
        "        self.term = response.term\n\n",
        "RaftGroup._seeded_tear"),
    "durability-order": (
        "copycat_tpu_torch/server/raft_group.py", "    def _complete_command(",
        "    def _seeded_ack(self, index):\n"
        "        fut = self._commit_futures.pop(index, None)\n"
        "        fut.set_result((index, None, None))\n\n",
        "RaftGroup._seeded_ack"),
    "span-pairing": (
        "copycat_tpu_torch/client/edge.py", None,
        "\n\ndef _seeded_span(tracer, trace, t0, t1):\n"
        "    tracer.span(trace, \"client.edge_servee\", t0, t1)\n",
        "_seeded_span"),
    "exit-code": (
        "copycat_tpu_torch/cli.py", None,
        "\n\ndef _seeded_exit():\n    sys.exit(3)\n", "_seeded_exit"),
    "knob-registry": (
        "copycat_tpu_torch/utils/health.py", None,
        "\n\ndef _seeded_knob():\n"
        "    return os.environ.get(\"COPYCAT_SEEDED\")\n", "_seeded_knob"),
    "metric-registry": (
        "copycat_tpu_torch/models/telemetry.py", None,
        "\n\ndef _seeded_metric(registry):\n"
        "    registry.counter(\"not_a_cataloged_metric\")\n",
        "_seeded_metric"),
    "wire-schema": (
        "copycat_tpu_torch/protocol/messages.py", None,
        "\n\n@serialize_with(230)\nclass _SeededMessage(Message):\n"
        "    _fields = (\"x\",)\n", "<module>"),
    "jit-purity": (
        "copycat_tpu_torch/ops/consensus.py",
        "    submits = _normalize_submits(submits, G, dev)\n",
        "    _seeded = int(submits.valid.sum().item())\n", "step"),
}
SEEDED_RULES = tuple(SEEDED)
#: The files a lint of the port's tree reads.
_TREE = ("copycat_tpu_torch", "chip_smoke.py", "ab_quorum_kernels.py",
         "docs", "tests/golden")


def copy_tree(dest) -> None:
    """The port's tree as the lint sees it, without build outputs."""
    for rel in _TREE:
        src = os.path.join(REPO, rel)
        if os.path.isdir(src):
            shutil.copytree(src, dest / rel, ignore=shutil.ignore_patterns(
                "__pycache__", "_build"))
        else:
            shutil.copy(src, dest / rel)


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A copy of the port's tree with :data:`SEEDED` in it, linted once:
    ``(result, {rule: (path, line)})``."""
    root = tmp_path_factory.mktemp("seeded")
    copy_tree(root)
    where = {}
    for rule, (rel, anchor, text, _) in SEEDED.items():
        path = root / rel
        src = path.read_text()
        if anchor is None:
            at = len(src)
            src += text
        else:
            assert src.count(anchor) == 1, (rule, anchor)
            at = src.index(anchor)
            src = src[:at] + text + src[at:]
        path.write_text(src)
    for rule, (rel, _, text, _) in SEEDED.items():
        lines = (root / rel).read_text().splitlines()
        where[rule] = (rel, lines.index(text.strip("\n").splitlines()[-1])
                       + 1)
    return PORT.run_lint(root=str(root), use_cache=False), where


@pytest.mark.parametrize("rule", SEEDED_RULES)
def test_seeded_violation_fires_in_a_copy_of_the_tree(seeded, rule):
    result, where = seeded
    rel, line = where[rule]
    symbol = SEEDED[rule][3]
    hits = [f for f in result.findings if f.rule == rule]
    assert hits, f"{rule} did not fire on {rel}:{line}"
    assert {f.path for f in hits} == {rel}
    if rule == "wire-schema":
        # the schema is checked as a whole: the new id is named at line 1
        assert ["230" in f.message and "new" in f.message for f in hits] \
            == [True]
    else:
        assert [(f.line, f.symbol) for f in hits] == [(line, symbol)]


def test_seeded_copy_has_no_other_finding(seeded):
    result, _ = seeded
    assert sorted({f.rule for f in result.findings}) == sorted(SEEDED_RULES)
    assert len(result.findings) == len(SEEDED_RULES)
