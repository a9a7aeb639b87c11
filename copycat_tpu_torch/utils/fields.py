"""Compiled per-class ``__init__`` for field-list serialization bases.

Protocol messages and log entries are constructed per op on the session
hot path; the generic ``for name in _fields: setattr(self, name,
kwargs.get(name))`` loop was a measured share of both construct paths
(PERF.md round 6). This compiles a NamedTuple-style ``__init__`` —
direct attribute assignments, every field defaulting to None — shared by
``protocol.messages.Message`` and ``server.log.Entry``.
"""

from __future__ import annotations


def compile_field_init(cls: type, fields: tuple,
                       head: str = "", body_head: str = "") -> None:
    """Attach a compiled ``__init__(self[, <head>][, f1=None, ...])``.

    ``head`` is extra parameter source inserted after ``self`` (fixed
    leading parameters, e.g. ``", term=0, timestamp=0.0"``);
    ``body_head`` is indented source run before the field assignments
    (e.g. ``"    self.index = 0\\n"``). Field names come from the
    class's own ``_fields`` declaration, never caller input.
    """
    args = "".join(f", {n}=None" for n in fields)
    body = "".join(f"    self.{n} = {n}\n" for n in fields)
    if not (body_head or body):
        body = "    pass\n"
    ns: dict = {}
    exec(f"def __init__(self{head}{args}):\n{body_head}{body}",  # noqa: S102
         ns)
    ns["__init__"].__qualname__ = f"{cls.__qualname__}.__init__"
    cls.__init__ = ns["__init__"]
