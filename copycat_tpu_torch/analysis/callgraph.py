"""Package-wide async call graph + suspension classification.

The v2 substrate under the concurrency rules (docs/ANALYSIS.md): one
graph over every function in the scanned tree, built from the same
name-level resolution machinery the jit-purity walker proved out —
deliberately over-approximate where Python's dynamism hides the callee,
and honest about the boundary:

- a bare ``helper(...)`` resolves to a module-level ``def helper`` in
  the SAME file;
- ``self.helper(...)`` resolves to a method of the enclosing class in
  the same file;
- ``mod.helper(...)`` resolves to module-level ``helper`` in the file a
  ``import ... as mod`` / ``from pkg import mod`` binding names;
- anything else (cross-object attributes, callables in variables,
  dynamic dispatch) does NOT resolve, and every consumer treats an
  unresolved callee conservatively for its own rule (a suspension for
  await-tear, an analysis frontier for loop-blocking reachability).

On top of the graph, two classifications every concurrency rule
consumes:

- **may-suspend**: an ``async def`` may suspend iff its own body holds
  a true yield point — ``async for``/``async with``, ``yield``, an
  ``await`` of anything unresolvable, or an ``await`` of a local
  coroutine that itself may suspend (computed to a fixed point). An
  async def whose every await lands on a never-suspending local helper
  CANNOT interleave — the await-tear rule uses that for precision, both
  ways.
- **async-reachable**: the set of SYNC functions reachable from any
  ``async def`` body through resolved sync calls, each with one example
  call chain. A blocking call inside such a helper stalls the event
  loop exactly like one written inline — the interprocedural
  loop-blocking rule's frontier.

Pure stdlib + ``ast``; the graph never imports the modules it models.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .astutil import qualname_map, walk_tree


def local_functions(tree: ast.Module) -> dict[str, ast.AST]:
    """Module-level function defs by name (the jit walker's view)."""
    return {node.name: node for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}


def callee_names(fn: ast.AST) -> set[str]:
    """Names a function's body could call (name-level, jit-purity's
    over-approximation: plain names count too, for functions passed as
    values like ``lax.scan(body, ...)``)."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name):
                out.add(node.func.id)
            elif isinstance(node.func, ast.Attribute):
                out.add(node.func.attr)
        elif isinstance(node, ast.Name):
            out.add(node.id)
    return out


#: awaits of these dotted tails are ALWAYS suspension points even if a
#: same-named local exists (asyncio primitives shadowed locally would be
#: perverse, but the conservative direction costs nothing)
_ALWAYS_SUSPENDS = ("sleep", "gather", "wait", "wait_for", "shield")


@dataclass
class FunctionInfo:
    path: str               # repo-relative file
    qual: str               # dotted qualname within the file
    name: str               # bare name
    class_name: str | None  # enclosing class (innermost), if a method
    is_async: bool
    node: ast.AST = field(repr=False, default=None)

    @property
    def key(self) -> tuple[str, str]:
        return (self.path, self.qual)

    @property
    def label(self) -> str:
        return f"{self.path}::{self.qual}"


def _module_imports(tree: ast.Module) -> dict[str, str]:
    """``alias -> module basename`` for every import binding in a file
    (``import a.b.c as m`` -> m: c; ``from pkg import mod`` -> mod: mod)."""
    out: dict[str, str] = {}
    for node in walk_tree(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                base = a.name.rsplit(".", 1)[-1]
                out[a.asname or a.name.split(".", 1)[0]] = (
                    base if a.asname else a.name.split(".", 1)[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


def own_body(fn: ast.AST):
    """Every node lexically inside ``fn``, not descending into nested
    defs/lambdas (a nested function is its own execution context)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def awaited_call_nodes(fn: ast.AST) -> set[int]:
    """ids of every Call node lexically under an Await expression in
    ``fn``'s own body — ``await x.wait()`` and
    ``await wait_for(p.wait(), t)`` both cover the inner call, so
    blocking-method heuristics keyed on ambiguous names (``wait``) can
    skip coroutine plumbing."""
    out: set[int] = set()
    for node in own_body(fn):
        if isinstance(node, ast.Await):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    out.add(id(sub))
    return out


class CallGraph:
    """The package-wide graph; build once per lint run over all trees."""

    def __init__(self) -> None:
        self.functions: dict[tuple[str, str], FunctionInfo] = {}
        #: (path, class_name, method name) -> key
        self._methods: dict[tuple[str, str | None, str],
                            tuple[str, str]] = {}
        #: (path, bare name) -> key for module-level defs
        self._module_level: dict[tuple[str, str], tuple[str, str]] = {}
        #: path -> {alias: module basename}
        self._imports: dict[str, dict[str, str]] = {}
        #: module basename -> [paths defining it]
        self._basename_paths: dict[str, list[str]] = {}
        #: attr names called on a NON-self receiver anywhere in the tree
        #: (the durability rule treats such methods as externally
        #: entered — their call sites can't be proven dominated)
        self.external_attr_calls: set[str] = set()
        self.may_suspend: dict[tuple[str, str], bool] = {}
        #: sync fn key -> example chain of labels from an async def
        self.async_reachable: dict[tuple[str, str], list[str]] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, trees: dict[str, ast.Module]) -> "CallGraph":
        g = cls()
        for path, tree in trees.items():
            g._imports[path] = _module_imports(tree)
            base = path.rsplit("/", 1)[-1].removesuffix(".py")
            g._basename_paths.setdefault(base, []).append(path)
            quals = qualname_map(tree)
            classes: dict[ast.AST, str] = {
                n: q for n, q in quals.items() if isinstance(n, ast.ClassDef)}
            for node, qual in quals.items():
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                parts = qual.split(".")
                class_name = None
                if len(parts) > 1:
                    # innermost enclosing class, when the parent qual
                    # names one (methods of nested classes resolve to
                    # the nearest class)
                    parent_qual = ".".join(parts[:-1])
                    for cnode, cqual in classes.items():
                        if cqual == parent_qual:
                            class_name = cnode.name
                            break
                info = FunctionInfo(path=path, qual=qual, name=node.name,
                                    class_name=class_name,
                                    is_async=isinstance(
                                        node, ast.AsyncFunctionDef),
                                    node=node)
                g.functions[info.key] = info
                g._methods.setdefault(
                    (path, class_name, node.name), info.key)
                if len(parts) == 1:
                    g._module_level[(path, node.name)] = info.key
            for node in walk_tree(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and not (isinstance(node.func.value, ast.Name)
                                 and node.func.value.id == "self")):
                    g.external_attr_calls.add(node.func.attr)
        g._classify_suspension()
        g._classify_async_reachability()
        return g

    # -- resolution --------------------------------------------------------

    def resolve_call(self, path: str, caller: FunctionInfo | None,
                     call: ast.Call) -> FunctionInfo | None:
        """Resolve one call site to a FunctionInfo, or ``None`` when the
        callee hides from name-level analysis."""
        func = call.func
        if isinstance(func, ast.Name):
            key = self._module_level.get((path, func.id))
            return self.functions.get(key) if key else None
        if isinstance(func, ast.Attribute) and isinstance(func.value,
                                                          ast.Name):
            recv = func.value.id
            if recv == "self" and caller is not None \
                    and caller.class_name is not None:
                key = self._methods.get(
                    (path, caller.class_name, func.attr))
                return self.functions.get(key) if key else None
            mod = self._imports.get(path, {}).get(recv)
            if mod is not None:
                base = mod.rsplit(".", 1)[-1]
                # basename-level resolution must stay UNIQUE to stay
                # honest: the tree has homonymous modules (state.py,
                # commands.py in several packages), and guessing the
                # wrong one could classify a real suspension point as
                # never-suspending — ambiguity resolves to None, which
                # every consumer treats conservatively
                hits = [key for target in self._basename_paths.get(base, ())
                        if (key := self._module_level.get(
                            (target, func.attr)))]
                if len(hits) == 1:
                    return self.functions.get(hits[0])
        return None

    def info_for(self, path: str, qual: str) -> FunctionInfo | None:
        return self.functions.get((path, qual))

    # -- suspension classification ----------------------------------------

    def _primitive_suspension(self, info: FunctionInfo) -> bool:
        """True yield points that need no graph: async for/with, yield,
        and awaits of anything we can't resolve to a local coroutine."""
        for node in own_body(info.node):
            if isinstance(node, (ast.AsyncFor, ast.AsyncWith, ast.Yield,
                                 ast.YieldFrom)):
                return True
            if isinstance(node, ast.Await):
                if not isinstance(node.value, ast.Call):
                    return True  # awaiting a future/task/variable
                callee = self.resolve_call(info.path, info, node.value)
                if callee is None or not callee.is_async:
                    return True
                tail = (node.value.func.attr
                        if isinstance(node.value.func, ast.Attribute)
                        else getattr(node.value.func, "id", ""))
                if tail in _ALWAYS_SUSPENDS:
                    return True
        return False

    def _classify_suspension(self) -> None:
        suspend = {key: False for key, info in self.functions.items()}
        # reverse awaited-call edges among resolved async defs
        rev: dict[tuple[str, str], set[tuple[str, str]]] = {}
        for key, info in self.functions.items():
            if not info.is_async:
                continue
            if self._primitive_suspension(info):
                suspend[key] = True
                continue
            for node in own_body(info.node):
                if isinstance(node, ast.Await) \
                        and isinstance(node.value, ast.Call):
                    callee = self.resolve_call(info.path, info, node.value)
                    if callee is not None and callee.is_async:
                        rev.setdefault(callee.key, set()).add(key)
        frontier = [k for k, v in suspend.items() if v]
        while frontier:
            key = frontier.pop()
            for caller in rev.get(key, ()):
                if not suspend[caller]:
                    suspend[caller] = True
                    frontier.append(caller)
        self.may_suspend = suspend

    def suspends(self, path: str, caller: FunctionInfo | None,
                 call: ast.Call) -> bool:
        """Would ``await <call>`` yield to the event loop? Unresolved or
        non-async callees: conservatively yes."""
        callee = self.resolve_call(path, caller, call)
        if callee is None or not callee.is_async:
            return True
        tail = (call.func.attr if isinstance(call.func, ast.Attribute)
                else getattr(call.func, "id", ""))
        if tail in _ALWAYS_SUSPENDS:
            return True
        return self.may_suspend.get(callee.key, True)

    # -- async reachability (interprocedural loop-blocking) ----------------

    _REACH_DEPTH = 6

    def _classify_async_reachability(self) -> None:
        reach: dict[tuple[str, str], list[str]] = {}
        frontier: list[tuple[tuple[str, str], list[str], int]] = []
        for key, info in self.functions.items():
            if not info.is_async:
                continue
            for node in own_body(info.node):
                if not isinstance(node, ast.Call):
                    continue
                callee = self.resolve_call(info.path, info, node)
                if callee is not None and not callee.is_async \
                        and callee.key not in reach:
                    chain = [info.label, callee.label]
                    reach[callee.key] = chain
                    frontier.append((callee.key, chain, 1))
        while frontier:
            key, chain, depth = frontier.pop()
            if depth >= self._REACH_DEPTH:
                continue
            info = self.functions[key]
            # own_body here too: a nested def inside a sync helper is a
            # callback, not inline code — it is judged where something
            # actually calls it, exactly like nested defs in async defs
            for node in own_body(info.node):
                if not isinstance(node, ast.Call):
                    continue
                callee = self.resolve_call(info.path, info, node)
                if callee is not None and not callee.is_async \
                        and callee.key not in reach:
                    sub = chain + [callee.label]
                    reach[callee.key] = sub
                    frontier.append((callee.key, sub, depth + 1))
        self.async_reachable = reach
