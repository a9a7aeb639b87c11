"""``wire-schema``: protocol/messages.py frozen against a golden file.

The wire format is *positional*: ``Message.write_object`` emits fields
in ``_fields`` order under a ``@serialize_with(id)`` type id, and the C
codec walks the same order. Reordering a tuple, renaming a field, or
recycling an id is an on-the-wire corruption that every transport and
the native codec will happily ship — the torn-write findings showed
what silently-misparsed frames cost. This rule makes any schema drift a
CI failure instead:

- type ids must be unique across the module;
- every concrete ``Message`` subclass must carry a type id;
- the extracted schema ``{id: [class, [fields...]]}`` must equal the
  committed golden snapshot ``tests/golden/wire_schema.json``.

An *intentional* schema change regenerates the golden in the same PR::

    copycat-tpu lint --update-golden

which rewrites the snapshot from the current source; the diff then
shows the schema change explicitly to whoever reads it. The golden is the
reference package's (``copycat_tpu/protocol/messages.py`` renders it,
with the reference's lint): the port's ``protocol/messages.py`` is held
against the same file, so the two packages stay wire-compatible, and the
port's lint only reads it.
"""

from __future__ import annotations

import ast
import json

from .astutil import const_str
from .findings import Finding

GOLDEN_PATH = "tests/golden/wire_schema.json"
REGEN_HINT = ("if the schema change is intentional, regenerate with "
              "`copycat-tpu lint --update-golden` and commit the diff")


def extract_schema(tree: ast.Module) -> tuple[dict[int, tuple[str, list[str]]],
                                              list[Finding]]:
    """``{type_id: (class_name, fields)}`` plus structural findings
    (duplicate ids, concrete messages without an id)."""
    schema: dict[int, tuple[str, list[str]]] = {}
    problems: list[tuple[int, str]] = []
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        type_id = None
        for deco in node.decorator_list:
            if (isinstance(deco, ast.Call)
                    and isinstance(deco.func, ast.Name)
                    and deco.func.id == "serialize_with" and deco.args
                    and isinstance(deco.args[0], ast.Constant)
                    and isinstance(deco.args[0].value, int)):
                type_id = deco.args[0].value
        fields: list[str] | None = None
        for stmt in node.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "_fields"):
                value = stmt.value
                if isinstance(value, (ast.Tuple, ast.List)):
                    fields = [const_str(e) or "?" for e in value.elts]
        if type_id is None:
            if fields is not None and node.name not in (
                    "Message", "Response"):
                problems.append((
                    node.lineno,
                    f"`{node.name}` declares `_fields` but no "
                    f"`@serialize_with(id)` — it cannot cross the wire"))
            continue
        if type_id in schema:
            problems.append((
                node.lineno,
                f"type id {type_id} reused by `{node.name}` (already "
                f"`{schema[type_id][0]}`) — ids are forever"))
            continue
        schema[type_id] = (node.name, fields or [])
    findings = [Finding(rule="wire-schema", path="", line=line,
                        message=message, symbol="<module>")
                for line, message in problems]
    return schema, findings


def check_wire_schema(tree: ast.Module, path: str,
                      golden: dict | None) -> list[Finding]:
    if not path.endswith("protocol/messages.py"):
        return []
    schema, findings = extract_schema(tree)
    for f in findings:
        f.path = path
    if golden is None:
        findings.append(Finding(
            rule="wire-schema", path=path, line=1,
            message=(f"golden snapshot {GOLDEN_PATH} is missing — "
                     f"{REGEN_HINT}"),
            symbol="<module>"))
        return findings
    current = {str(i): [cls, fields] for i, (cls, fields) in schema.items()}
    for type_id in sorted(set(golden) | set(current), key=int):
        got, want = current.get(type_id), golden.get(type_id)
        if got == want:
            continue
        if want is None:
            msg = (f"type id {type_id} (`{got[0]}`) is new and not in the "
                   f"golden snapshot — {REGEN_HINT}")
        elif got is None:
            msg = (f"type id {type_id} (`{want[0]}`) disappeared from "
                   f"messages.py but is in the golden snapshot — removing "
                   f"a wire message breaks rolling upgrades; {REGEN_HINT}")
        else:
            msg = (f"type id {type_id} drifted from the golden snapshot: "
                   f"golden `{want[0]}{want[1]}` vs source "
                   f"`{got[0]}{got[1]}` — a reorder/rename corrupts the "
                   f"positional wire format; {REGEN_HINT}")
        findings.append(Finding(rule="wire-schema", path=path, line=1,
                                message=msg, symbol="<module>"))
    return findings


def render_golden(tree: ast.Module) -> str:
    schema, _ = extract_schema(tree)
    payload = {str(i): [cls, fields]
               for i, (cls, fields) in sorted(schema.items())}
    return json.dumps(payload, indent=2, sort_keys=False) + "\n"
