"""Tiny shared AST helpers for the copycheck rules (stdlib only)."""

from __future__ import annotations

import ast
import weakref
from typing import Iterator

#: :func:`qualname_map` per tree: every rule asks for the enclosing symbol
#: of each finding, and a tree is never edited once parsed.
_QUALS: "weakref.WeakKeyDictionary[ast.AST, dict]" = \
    weakref.WeakKeyDictionary()


def qualname_map(tree: ast.Module) -> dict[ast.AST, str]:
    """Map every function/class node to its dotted qualname (computed once
    a tree; callers must not edit the map)."""
    cached = _QUALS.get(tree)
    if cached is not None:
        return cached
    out: dict[ast.AST, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                out[child] = qual
                visit(child, qual)
            else:
                visit(child, prefix)

    visit(tree, "")
    _QUALS[tree] = out
    return out


def enclosing_symbol(tree: ast.Module, lineno: int) -> str:
    """The qualname of the innermost def/class spanning ``lineno``."""
    best = "<module>"
    best_span = None
    for node, qual in qualname_map(tree).items():
        end = getattr(node, "end_lineno", node.lineno)
        if node.lineno <= lineno <= end:
            span = end - node.lineno
            if best_span is None or span <= best_span:
                best, best_span = qual, span
        # decorated defs report their body lineno; include decorators
        for deco in getattr(node, "decorator_list", []):
            if deco.lineno <= lineno <= getattr(deco, "end_lineno",
                                                deco.lineno):
                return qual
    return best


_NODES: "weakref.WeakKeyDictionary[ast.AST, list]" = \
    weakref.WeakKeyDictionary()


def walk_tree(tree: ast.Module) -> list[ast.AST]:
    """``list(ast.walk(tree))``, in the same order, computed once a tree:
    the rules walk each module several times over."""
    nodes = _NODES.get(tree)
    if nodes is None:
        nodes = _NODES[tree] = list(ast.walk(tree))
    return nodes


def iter_async_functions(
        tree: ast.Module) -> Iterator[tuple[ast.AsyncFunctionDef, str]]:
    quals = qualname_map(tree)
    for node in walk_tree(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node, quals.get(node, node.name)


def body_nodes_excluding_nested_defs(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node lexically inside ``fn``'s own body, *not* descending
    into nested function definitions (a nested sync helper is its own
    execution context — blocking there is the call site's problem)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def dotted_name(node: ast.AST) -> str | None:
    """Render ``a.b.c`` attribute/name chains, else ``None``."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
