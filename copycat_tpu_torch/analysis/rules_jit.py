"""``jit-purity``: no host effects reachable inside the device step code.

The reference jits its ``[G×P]`` consensus step into one XLA program; the
port runs the same functions eagerly on the card, launching the fused
quorum kernels and torch ops in stream order, and times them under CUDA
graph capture (``chip_smoke.py``). The hazards are the same. A wall clock,
Python or numpy RNG draw or env read inside the step makes it a function
of something other than its inputs (the election-timer draws come in as
arguments, so a step is reproducible bit for bit against the reference),
and under capture it freezes to one number forever. A host round-trip —
``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` or
``torch.cuda.synchronize()`` — stalls the stream every round and cannot
be captured at all. These take the place of the reference's host
callbacks (``jax.debug.callback``, ``jax.pure_callback``,
``io_callback``), which the port has no use for.

Mechanics: the port has no ``jax.jit`` to collect roots from, so the roots
are named (:data:`JIT_ROOTS`): the ``ops/`` functions the reference jits
that the port defines. Within each ``ops/`` module, the rule walks the
local name-level call graph from those roots and flags forbidden calls in
any reachable function. Name-level reachability is deliberately
over-approximate for helpers shared with host-side code — a helper that
must stay host-impure belongs outside ``ops/``; so is the receiver-blind
match of the host round-trip methods, which inside ``ops/`` are called on
tensors alone.
"""

from __future__ import annotations

import ast

from .astutil import dotted_name
from .callgraph import callee_names, local_functions
from .findings import Finding

#: The ``ops/`` functions the reference jits (its ``collect_jit_roots``
#: over ``copycat_tpu/`` also finds ``fused``, ``run``, ``any`` and
#: ``kth_largest_pallas``, which the port does not define), all in
#: ``ops/consensus.py``.
JIT_ROOTS = ("step", "query_step", "deep_step", "deep_scan",
             "install_snapshots")

_ROUND_TRIP = "host round-trip in the device step's hot loop"

FORBIDDEN_CALLS = {
    "time.time": "wall clock freezes to a trace-time constant",
    "time.monotonic": "wall clock freezes to a trace-time constant",
    "time.perf_counter": "wall clock freezes to a trace-time constant",
    "time.sleep": "host sleep inside a traced function",
    "random.random": "Python RNG is trace-time-frozen; pass a "
                     "torch.Generator draw in",
    "random.randint": "Python RNG is trace-time-frozen; pass a "
                      "torch.Generator draw in",
    "random.choice": "Python RNG is trace-time-frozen; pass a "
                     "torch.Generator draw in",
    "os.getenv": "env read freezes to a trace-time constant",
    "os.environ.get": "env read freezes to a trace-time constant",
    "torch.cuda.synchronize": _ROUND_TRIP,
    "np.random.seed": "host RNG state mutation at trace time",
}

#: Method names that copy a tensor to the host, whatever the receiver.
FORBIDDEN_METHODS = {
    "item": _ROUND_TRIP,
    "tolist": _ROUND_TRIP,
    "cpu": _ROUND_TRIP,
    "numpy": _ROUND_TRIP,
}

FORBIDDEN_PREFIXES = {
    "np.random.": "host-side numpy RNG is trace-time-frozen; pass a "
                  "torch.Generator draw in",
    "numpy.random.": "host-side numpy RNG is trace-time-frozen; pass a "
                     "torch.Generator draw in",
}

FORBIDDEN_SUBSCRIPTS = {
    "os.environ": "env read freezes to a trace-time constant",
}


# The name-level resolution machinery this rule pioneered now lives in
# callgraph.py (local_functions / callee_names), where the package-wide
# async call graph builds on the same over-approximation.


def check_jit_purity(tree: ast.Module, path: str,
                     jit_roots=JIT_ROOTS) -> list[Finding]:
    if "/ops/" not in f"/{path}":
        return []
    local = local_functions(tree)
    reachable: set[str] = set()
    frontier = [name for name in local if name in jit_roots]
    while frontier:
        name = frontier.pop()
        if name in reachable:
            continue
        reachable.add(name)
        frontier.extend(c for c in callee_names(local[name])
                        if c in local and c not in reachable)
    findings: list[Finding] = []
    for name in sorted(reachable):
        fn = local[name]
        for node in ast.walk(fn):
            why = None
            culprit = None
            if isinstance(node, ast.Call):
                called = dotted_name(node.func) or ""
                if called in FORBIDDEN_CALLS:
                    why, culprit = FORBIDDEN_CALLS[called], called
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in FORBIDDEN_METHODS):
                    why = FORBIDDEN_METHODS[node.func.attr]
                    culprit = f".{node.func.attr}()"
                else:
                    for prefix, reason in FORBIDDEN_PREFIXES.items():
                        if called.startswith(prefix):
                            why, culprit = reason, called
            elif isinstance(node, ast.Subscript):
                sub = dotted_name(node.value) or ""
                if sub in FORBIDDEN_SUBSCRIPTS:
                    why, culprit = FORBIDDEN_SUBSCRIPTS[sub], sub
            if why:
                findings.append(Finding(
                    rule="jit-purity", path=path, line=node.lineno,
                    message=(f"`{culprit}` reachable from jitted step "
                             f"function `{name}` — {why}"),
                    symbol=name))
    return findings
