"""Registry rules: ``knob-registry`` and ``metric-registry``.

Both rules close the same loop: a name used in code must exist in its
documented registry, so the docs can be *asserted* in sync instead of
hand-maintained.

``knob-registry``:
- any direct ``os.environ.get("COPYCAT_X")`` / ``os.getenv`` /
  ``os.environ["COPYCAT_X"]`` *read* outside ``utils/knobs.py`` is
  flagged — typed access goes through the registry (env *writes* are
  fine: benches stage knobs for servers they build);
- any ``knobs.get_*("COPYCAT_X")`` naming an unregistered knob is
  flagged. The registered set is parsed from ``utils/knobs.py``'s AST
  (the ``_knob("NAME", ...)`` declarations) — linting never imports the
  package.

``metric-registry``: every ``.counter(name) / .gauge(name) /
.histogram(name) / .timer(name)`` call site whose name is a string
literal must use a name from the machine-readable catalog at the bottom
of ``docs/OBSERVABILITY.md``; label kwargs must match the catalog
entry's declared label keys (``query_reads{consistency}``). Dynamic
(non-literal) names can't be checked — they're flagged too, so each one
is either rewritten to a literal or carries an inline suppression
explaining where its names come from.
"""

from __future__ import annotations

import ast
import re

from .astutil import const_str, dotted_name, enclosing_symbol, walk_tree
from .findings import Finding

KNOB_PREFIX = "COPYCAT_"
KNOB_GETTERS = ("get_raw", "get_str", "get_int", "get_float", "get_bool")
METRIC_METHODS = ("counter", "gauge", "histogram", "timer")

# Catalog entries line-match `name` or `name{label,label2}` cells in the
# OBSERVABILITY.md machine catalog table.
CATALOG_ENTRY_RE = re.compile(r"^\|\s*`([A-Za-z0-9_.]+)(\{([A-Za-z0-9_,]+)\})?`\s*\|")
CATALOG_HEADING = "## Metric name catalog"


def parse_knob_registry(knobs_source: str) -> set[str]:
    """Registered knob names from ``utils/knobs.py``'s AST."""
    tree = ast.parse(knobs_source)
    names: set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "_knob" and node.args):
            name = const_str(node.args[0])
            if name:
                names.add(name)
    return names


def parse_metric_catalog(observability_md: str) -> dict[str, set[str]] | None:
    """``{metric name: {label keys}}`` from the OBSERVABILITY.md machine
    catalog section, or ``None`` when the section is missing."""
    idx = observability_md.find(CATALOG_HEADING)
    if idx < 0:
        return None
    catalog: dict[str, set[str]] = {}
    for line in observability_md[idx:].splitlines():
        m = CATALOG_ENTRY_RE.match(line.strip())
        if m:
            labels = set((m.group(3) or "").split(",")) - {""}
            catalog[m.group(1)] = labels
    return catalog


def check_knob_registry(tree: ast.Module, path: str,
                        registered: set[str]) -> list[Finding]:
    if path.endswith("utils/knobs.py"):
        return []
    findings: list[Finding] = []

    def flag(line: int, message: str) -> None:
        findings.append(Finding(
            rule="knob-registry", path=path, line=line, message=message,
            symbol=enclosing_symbol(tree, line)))

    for node in walk_tree(tree):
        # os.environ["COPYCAT_X"] reads (subscript loads)
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and dotted_name(node.value) in ("os.environ", "environ")):
            name = const_str(node.slice)
            if name and name.startswith(KNOB_PREFIX):
                flag(node.lineno,
                     f"direct env read of `{name}` — go through "
                     f"`utils/knobs.py` (`knobs.get_*`)")
        if not isinstance(node, ast.Call):
            continue
        func_name = dotted_name(node.func) or ""
        # os.environ.get("COPYCAT_X", ...) / os.getenv("COPYCAT_X", ...)
        if func_name.endswith("environ.get") or func_name in (
                "os.getenv", "getenv"):
            name = const_str(node.args[0]) if node.args else None
            if name and name.startswith(KNOB_PREFIX):
                flag(node.lineno,
                     f"direct env read of `{name}` — go through "
                     f"`utils/knobs.py` (`knobs.get_*`)")
        # knobs.get_*("COPYCAT_X"): name must be registered
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in KNOB_GETTERS and node.args):
            name = const_str(node.args[0])
            if (name and name.startswith(KNOB_PREFIX)
                    and name not in registered):
                flag(node.lineno,
                     f"`{name}` is not registered in `utils/knobs.py` — "
                     f"declare it (typed default + one-line doc) so the "
                     f"README table stays generated")
    return findings


def check_metric_registry(tree: ast.Module, path: str,
                          catalog: dict[str, set[str]]) -> list[Finding]:
    if path.endswith("utils/metrics.py"):
        return []  # the substrate itself (merge/snapshot plumbing)
    findings: list[Finding] = []
    for node in walk_tree(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in METRIC_METHODS
                and (node.args or node.keywords)):
            continue
        if not node.args:
            continue
        symbol = enclosing_symbol(tree, node.lineno)
        first = node.args[0]
        # `"a" if cond else "b"` picks between two literal names — check
        # both branches instead of flagging the site as dynamic.
        if (isinstance(first, ast.IfExp)
                and const_str(first.body) is not None
                and const_str(first.orelse) is not None):
            candidates = [const_str(first.body), const_str(first.orelse)]
        else:
            candidates = [const_str(first)]
        name = candidates[0]
        if name is None:
            # a non-string constant first arg (e.g. `.timer(3)` on some
            # unrelated object) is not a metric call we can judge
            if not isinstance(node.args[0], ast.Constant):
                findings.append(Finding(
                    rule="metric-registry", path=path, line=node.lineno,
                    message=(f"dynamic metric name passed to "
                             f"`.{node.func.attr}(...)` — use a literal "
                             f"from the docs/OBSERVABILITY.md catalog, or "
                             f"suppress with the source of the names"),
                    symbol=symbol))
            continue
        labels = {kw.arg for kw in node.keywords if kw.arg is not None}
        for name in candidates:
            entry = catalog.get(name)
            if entry is None:
                findings.append(Finding(
                    rule="metric-registry", path=path, line=node.lineno,
                    message=(f"metric `{name}` is not in the "
                             f"docs/OBSERVABILITY.md catalog — document it "
                             f"(name, kind, meaning) before recording it"),
                    symbol=symbol))
                continue
            if labels != entry:
                want = ("{" + ",".join(sorted(entry)) + "}" if entry
                        else "none")
                got = ("{" + ",".join(sorted(labels)) + "}" if labels
                       else "none")
                findings.append(Finding(
                    rule="metric-registry", path=path, line=node.lineno,
                    message=(f"metric `{name}` labels {got} do not match "
                             f"the catalog's {want}"),
                    symbol=symbol))
    return findings
