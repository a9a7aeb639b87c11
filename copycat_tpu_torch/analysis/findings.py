"""Findings model: one dataclass, inline suppressions, the baseline file.

A finding's *identity* for baseline matching is ``(rule, path, symbol,
message)`` — deliberately line-free, so unrelated edits above a
baselined site don't resurrect it. ``symbol`` is the enclosing
``Class.method`` (or ``<module>``), which keeps identities stable when a
function moves wholesale.

Suppressions are line-scoped: ``# copycheck: ignore[rule]`` (or
``ignore[rule-a,rule-b]``) on the finding's line or the line directly
above it. The baseline file (``copycat_tpu_torch/analysis/baseline.json``)
carries the *intentionally kept* findings, each with a one-line
``justification`` — ``lint --write-baseline`` generates entries, whoever
accepts them fills the why. CI (``--strict``) fails on any finding that is
neither suppressed nor baselined.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field

SUPPRESS_RE = re.compile(r"#\s*copycheck:\s*ignore\[([a-z0-9_,\- *]+)\]")


@dataclass
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    symbol: str = "<module>"
    #: optional call-chain metadata for interprocedural findings (the
    #: labels from the async root to the flagged site). Deliberately
    #: NOT part of identity(): the example chain may reroute under
    #: unrelated edits, and a baselined finding must not resurrect.
    via: list | None = None

    def identity(self) -> tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def render(self) -> str:
        out = f"{self.path}:{self.line}: {self.rule}: {self.message} [{self.symbol}]"
        if self.via:
            out += "\n    via " + " -> ".join(self.via)
        return out

    def to_json(self) -> dict:
        d = asdict(self)
        if d.get("via") is None:
            del d["via"]
        return d


def scan_suppressions(source: str) -> dict[int, set[str]]:
    """Map line number -> set of suppressed rule names (``*`` = all).

    A pragma suppresses its own line and the line below it, so both
    styles read naturally::

        loop.create_task(coro)  # copycheck: ignore[orphan-task] why
        # copycheck: ignore[loop-blocking] shutdown path, loop is done
        shutil.rmtree(tmp)
    """
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        out.setdefault(i + 1, set()).update(rules)
    return out


def is_suppressed(finding: Finding, suppressions: dict[int, set[str]]) -> bool:
    rules = suppressions.get(finding.line)
    if not rules:
        return False
    return "*" in rules or finding.rule in rules


@dataclass
class Baseline:
    """The accepted-findings file: identity -> justification."""

    entries: dict[tuple[str, str, str, str], str] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path, encoding="utf-8") as f:
                raw = json.load(f)
        except FileNotFoundError:
            return cls()
        entries = {}
        for item in raw.get("findings", []):
            key = (item["rule"], item["path"], item.get("symbol", "<module>"),
                   item["message"])
            entries[key] = item.get("justification", "")
        return cls(entries)

    def save(self, path: str) -> None:
        findings = [
            {"rule": rule, "path": p, "symbol": symbol, "message": message,
             "justification": just or "TODO: justify or fix"}
            for (rule, p, symbol, message), just in sorted(self.entries.items())
        ]
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "findings": findings}, f, indent=2,
                      sort_keys=False)
            f.write("\n")

    def match(self, finding: Finding) -> bool:
        return finding.identity() in self.entries

    def stale(self, findings: list[Finding]) -> list[tuple]:
        """Baseline identities that no current finding matches — they
        were fixed (or moved); prune them so the file can't rot."""
        live = {f.identity() for f in findings}
        return [key for key in self.entries if key not in live]
