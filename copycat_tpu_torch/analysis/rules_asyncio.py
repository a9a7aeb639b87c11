"""asyncio hygiene rules: ``loop-blocking`` and ``orphan-task``.

``loop-blocking``: a curated blocklist of calls that stall the event
loop when made from an ``async def`` body. One stalled turn holds every
staged read window and replication ack behind it — the latency hazard
is measured, not theoretical (the read pump coalesces per event-loop
turn). Since copycheck v2 the rule is
**interprocedural**: a blocking call inside a SYNC helper is flagged
when the package call graph (:mod:`callgraph`) proves the helper
reachable from an ``async def`` through resolved sync calls — running a
sync helper inline IS running its blocking call on the loop thread. The
finding lands on the blocking call and carries the call chain from the
async root in its message (and ``via`` metadata). Nested sync defs
inside an async def are still skipped lexically: they are judged where
they're reachable from, not where they're written.

``orphan-task``: ``loop.create_task`` / ``asyncio.ensure_future``
anywhere but ``utils/tasks.py``. The loop holds only a weak reference to
tasks — a fire-and-forget task can be garbage-collected mid-flight, and
an unobserved exception vanishes. ``utils/tasks.spawn`` is the one
blessed spawn point (strong ref until done + error logging), so every
background task in the tree shares its lifecycle guarantees.

The device syncs are the port's spellings: ``torch.cuda.synchronize()``
as a call, and ``.synchronize()`` on any receiver (a stream, an event,
the ``torch.cuda`` module under another name), where the reference lists
``jax.device_get``, ``jax.block_until_ready`` and the
``.block_until_ready()`` method. The implicit syncs of a CUDA tensor —
``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()`` — are left out on
purpose: the same method names read numpy arrays and host tensors
everywhere in the host plane, and the AST cannot tell a CUDA tensor from a
numpy array, so the rule would either flag every host read or guess.
Rather than check them partly, it does not check them at all.
"""

from __future__ import annotations

import ast

from .astutil import (
    body_nodes_excluding_nested_defs,
    dotted_name,
    enclosing_symbol,
    iter_async_functions,
    walk_tree,
)
from .callgraph import CallGraph, awaited_call_nodes, own_body
from .findings import Finding

# Call chains that block the calling thread. Receiver-qualified names
# match exactly ("time.sleep" does not match "asyncio.time.sleep" — the
# chain is rendered from the AST, so aliasing hides from us; the rule is
# a tripwire, not a proof).
BLOCKING_CALLS = {
    "time.sleep": "blocks the event loop; use `await asyncio.sleep(...)`",
    "os.fsync": "synchronous disk flush on the loop thread",
    "os.fdatasync": "synchronous disk flush on the loop thread",
    "os.replace": "synchronous rename on the loop thread",
    "os.waitpid": "blocking child-process wait on the loop thread",
    "subprocess.run": "blocking subprocess wait",
    "subprocess.call": "blocking subprocess wait",
    "subprocess.check_call": "blocking subprocess wait",
    "subprocess.check_output": "blocking subprocess wait",
    "socket.create_connection": "blocking connect on the loop thread; "
                                "use the loop/transport APIs",
    "shutil.rmtree": "synchronous recursive delete on the loop thread",
    "shutil.copyfile": "synchronous file copy on the loop thread",
    "shutil.copytree": "synchronous tree copy on the loop thread",
    "shutil.copyfileobj": "synchronous stream copy on the loop thread",
    "torch.cuda.synchronize": "synchronous device sync on the loop thread",
}

# Method names that block regardless of receiver.
BLOCKING_METHODS = {
    "synchronize": "synchronous device sync on the loop thread",
}

# Method names that block UNLESS the call sits under an ``await``
# (``proc.wait()`` from subprocess.Popen blocks; ``await proc.wait()``
# and ``await wait_for(proc.wait(), t)`` are the asyncio coroutine).
BLOCKING_METHODS_UNLESS_AWAITED = {
    "wait": "blocking wait (Popen.wait / Event.wait) on the loop thread; "
            "await the asyncio form instead",
}

# The builtin ``open``: sync file I/O from a coroutine.
BLOCKING_BUILTINS = {
    "open": "synchronous file open/IO on the loop thread",
}

SPAWN_CALLS = ("create_task", "ensure_future")


def _blocking_reason(node: ast.Call,
                     awaited: set[int] | None = None) -> tuple | None:
    """``(culprit, why)`` when this call matches the blocklist."""
    name = dotted_name(node.func)
    if name in BLOCKING_CALLS:
        return f"`{name}(...)`", BLOCKING_CALLS[name]
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in BLOCKING_METHODS:
            return f"`.{attr}(...)`", BLOCKING_METHODS[attr]
        if attr in BLOCKING_METHODS_UNLESS_AWAITED \
                and not (awaited and id(node) in awaited):
            return (f"`.{attr}(...)`",
                    BLOCKING_METHODS_UNLESS_AWAITED[attr])
    if isinstance(node.func, ast.Name) and node.func.id in BLOCKING_BUILTINS:
        return f"`{node.func.id}(...)`", BLOCKING_BUILTINS[node.func.id]
    return None


def check_loop_blocking(tree: ast.Module, path: str,
                        graph: CallGraph | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for fn, qual in iter_async_functions(tree):
        awaited = awaited_call_nodes(fn)
        for node in body_nodes_excluding_nested_defs(fn):
            if not isinstance(node, ast.Call):
                continue
            hit = _blocking_reason(node, awaited)
            if hit:
                culprit, why = hit
                findings.append(Finding(
                    rule="loop-blocking", path=path, line=node.lineno,
                    message=f"blocking call in async def: {culprit} — {why}",
                    symbol=qual))
    if graph is not None:
        findings += _check_reachable_blocking(tree, path, graph)
    return findings


def _check_reachable_blocking(tree: ast.Module, path: str,
                              graph: CallGraph) -> list[Finding]:
    """Interprocedural half: blocking calls inside SYNC functions of
    this file that the graph proves reachable from an async def."""
    findings: list[Finding] = []
    for (fpath, qual), chain in sorted(graph.async_reachable.items()):
        if fpath != path:
            continue
        info = graph.info_for(fpath, qual)
        if info is None or info.node is None:
            continue
        awaited = awaited_call_nodes(info.node)
        for node in own_body(info.node):
            if not isinstance(node, ast.Call):
                continue
            hit = _blocking_reason(node, awaited)
            if hit:
                culprit, why = hit
                # the example chain rides `via` metadata, NOT the
                # message: finding identity (baseline matching) must not
                # churn when an unrelated edit reroutes the shortest
                # discovered path
                findings.append(Finding(
                    rule="loop-blocking", path=path, line=node.lineno,
                    message=(f"blocking call in a sync helper reachable "
                             f"from an async def: {culprit} — {why}"),
                    symbol=qual, via=list(chain)))
    return findings


def check_orphan_task(tree: ast.Module, path: str) -> list[Finding]:
    if path.endswith("utils/tasks.py"):
        return []  # the blessed spawn point itself
    findings: list[Finding] = []
    for node in walk_tree(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        is_spawn = (
            (isinstance(func, ast.Attribute) and func.attr in SPAWN_CALLS)
            or (isinstance(func, ast.Name) and func.id in SPAWN_CALLS))
        if not is_spawn:
            continue
        findings.append(Finding(
            rule="orphan-task", path=path, line=node.lineno,
            message=("raw task spawn — the loop keeps only a weak ref and "
                     "exceptions vanish; route through `utils/tasks.spawn` "
                     "(returns the task, logs failures, holds a strong ref)"),
            symbol=enclosing_symbol(tree, node.lineno)))
    return findings
