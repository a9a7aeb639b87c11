"""The copycheck engine: discovery, caching, suppressions, baseline, CLI.

Pure stdlib — parsing is ``ast``, project context (knob registry, metric
catalog, wire golden, span vocabulary, exit-code table) is read as
*text*, never imported, so ``python -m copycat_tpu_torch.cli lint`` runs
in a venv with no torch and touches nothing it checks.

The port's copy lints the port's own tree (:data:`DEFAULT_ROOTS`) against
its own baseline (:data:`BASELINE_FILE`) and knob registry
(``copycat_tpu_torch/utils/knobs.py``); the docs it reads (the metric
catalog, the span vocabulary, the exit-code table) and the wire golden
``tests/golden/wire_schema.json`` are shared with the reference package,
which owns the golden: the port only reads it, and ``--update-golden`` is
refused here (exit 2).

Caching is **per (file, rule group)** since copycheck v2: findings are
memoized in :data:`CACHE_FILE` keyed by the file's content
digest plus one config digest *per rule group* covering exactly that
group's inputs — the rule module sources it runs from, the shared
analysis substrate, and the cross-file inputs it reads (catalog,
golden, knob registry, span vocabulary, the package call graph).
Editing one rule file re-lints that group only; editing a source file
re-lints that file lexically AND the interprocedural groups everywhere
(their results legitimately depend on every file's code — the call
graph is a cross-file input, and the digest says so honestly). The
cache stores RAW findings — suppressions and the baseline are applied
after lookup, so editing the baseline never needs a re-lint.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Callable

from .callgraph import CallGraph
from .findings import Baseline, Finding, is_suppressed, scan_suppressions
from .rules_asyncio import check_loop_blocking, check_orphan_task
from .rules_await_tear import check_await_tear
from .rules_contracts import (
    check_durability_order,
    check_exit_contract,
    check_span_contract,
    parse_exit_codes,
    parse_span_catalog,
)
from .rules_jit import JIT_ROOTS, check_jit_purity
from .rules_registries import (
    check_knob_registry,
    check_metric_registry,
    parse_knob_registry,
    parse_metric_catalog,
)
from .rules_wire import GOLDEN_PATH, check_wire_schema

#: Under the package's build directory, which ``.gitignore`` lists.
CACHE_FILE = "copycat_tpu_torch/_build/copycheck-cache.json"
CACHE_VERSION = 2
#: The port's own accepted findings; ``.copycheck-baseline.json`` at the
#: repo root is the reference's and is never read here.
BASELINE_FILE = "copycat_tpu_torch/analysis/baseline.json"

#: Scanned by default (repo-root-relative): the package (its graft entry,
#: ``graft_entry.py``, included) and the root scripts that drive it on the
#: card. Tests are exercised by pytest, not linted — their fixtures *seed*
#: violations on purpose.
DEFAULT_ROOTS = ("copycat_tpu_torch", "chip_smoke.py", "ab_quorum_kernels.py")

#: The package whose metric call sites the catalog governs.
PACKAGE_PREFIX = "copycat_tpu_torch/"


def _repo_root() -> str:
    # copycat_tpu_torch/analysis/engine.py -> repo root two levels up
    # from the package directory; fall back to cwd for installed trees.
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if os.path.isdir(os.path.join(here, "copycat_tpu_torch")):
        return here
    return os.getcwd()


def _read(path: str) -> str | None:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def _analysis_source(module: str) -> str:
    return _read(os.path.join(os.path.dirname(__file__), module)) or ""


@dataclass
class LintContext:
    root: str
    knob_names: set[str] = field(default_factory=set)
    metric_catalog: dict[str, set[str]] | None = None
    wire_golden: dict | None = None
    jit_roots: set[str] = field(default_factory=set)
    span_catalog: set[str] | None = None
    exit_codes: set[int] | None = None
    graph: CallGraph | None = None
    tree_digest: str = ""
    #: per-rule-group config digests (cache keys); the legacy
    #: all-covering digest stays for compatibility with older callers
    group_digests: dict[str, str] = field(default_factory=dict)
    config_digest: str = ""

    @classmethod
    def build(cls, root: str, trees: dict[str, ast.Module],
              sources: dict[str, str] | None = None) -> "LintContext":
        ctx = cls(root=root)
        knobs_src = _read(os.path.join(root, "copycat_tpu_torch", "utils",
                                       "knobs.py"))
        if knobs_src:
            ctx.knob_names = parse_knob_registry(knobs_src)
        observability = _read(os.path.join(root, "docs", "OBSERVABILITY.md"))
        if observability:
            ctx.metric_catalog = parse_metric_catalog(observability)
            ctx.span_catalog = parse_span_catalog(observability)
        deployment = _read(os.path.join(root, "docs", "DEPLOYMENT.md"))
        if deployment:
            ctx.exit_codes = parse_exit_codes(deployment)
        golden_src = _read(os.path.join(root, GOLDEN_PATH))
        if golden_src:
            try:
                ctx.wire_golden = json.loads(golden_src)
            except ValueError:
                ctx.wire_golden = None
        ctx.jit_roots = set(JIT_ROOTS)
        ctx.graph = CallGraph.build(trees)
        # the interprocedural groups' cross-file input: every scanned
        # file's content (helper summaries/reachability can shift on any
        # edit — the honest invalidation boundary)
        tree_h = hashlib.sha256()
        for rel in sorted(trees):
            src = (sources or {}).get(rel)
            body = src if src is not None else ast.dump(trees[rel])
            tree_h.update(rel.encode())
            tree_h.update(hashlib.sha256(body.encode()).digest())
        ctx.tree_digest = tree_h.hexdigest()
        for spec in RULE_GROUPS:
            h = hashlib.sha256()
            # engine.py is in every group's key: the RuleGroup wiring
            # (scoping lambdas, argument plumbing) lives here, and an
            # edit to it must not reuse findings the old wiring cached
            for module in ("astutil.py", "findings.py",
                           "engine.py") + spec.modules:
                h.update(_analysis_source(module).encode())
                h.update(b"\x00")
            h.update(spec.inputs(ctx).encode())
            ctx.group_digests[spec.key] = h.hexdigest()
        legacy = hashlib.sha256()
        for key in sorted(ctx.group_digests):
            legacy.update(ctx.group_digests[key].encode())
        ctx.config_digest = legacy.hexdigest()
        return ctx


@dataclass
class RuleGroup:
    """One cache bucket: the rule functions that share sources + inputs."""

    key: str
    rules: tuple[str, ...]
    modules: tuple[str, ...]
    run: Callable[[str, str, ast.Module, LintContext], list]
    inputs: Callable[[LintContext], str] = lambda ctx: ""


def _digest_of(value) -> str:
    return hashlib.sha256(repr(sorted(value) if isinstance(value, (set,))
                               else value).encode()).hexdigest()


RULE_GROUPS: tuple[RuleGroup, ...] = (
    RuleGroup(
        key="asyncio",
        rules=("loop-blocking", "orphan-task"),
        modules=("rules_asyncio.py", "callgraph.py"),
        run=lambda path, src, tree, ctx: (
            check_loop_blocking(tree, path, ctx.graph)
            + check_orphan_task(tree, path)),
        # the interprocedural half reads the whole tree's call graph
        inputs=lambda ctx: ctx.tree_digest),
    RuleGroup(
        key="await_tear",
        rules=("await-tear",),
        modules=("rules_await_tear.py", "callgraph.py"),
        run=lambda path, src, tree, ctx: check_await_tear(
            tree, path, ctx.graph),
        inputs=lambda ctx: ctx.tree_digest),
    RuleGroup(
        key="registries",
        rules=("knob-registry", "metric-registry"),
        modules=("rules_registries.py",),
        run=lambda path, src, tree, ctx: (
            check_knob_registry(tree, path, ctx.knob_names)
            # metric-registry is package-scoped: benches/examples at
            # the repo root stage env for servers they build, not
            # metric planes
            + (check_metric_registry(tree, path, ctx.metric_catalog)
               if (ctx.metric_catalog is not None
                   and path.startswith(PACKAGE_PREFIX)) else [])),
        inputs=lambda ctx: (_digest_of(ctx.knob_names)
                            + _digest_of(sorted(
                                (k, tuple(sorted(v)))
                                for k, v in
                                (ctx.metric_catalog or {}).items())))),
    RuleGroup(
        key="wire",
        rules=("wire-schema",),
        modules=("rules_wire.py",),
        run=lambda path, src, tree, ctx: check_wire_schema(
            tree, path, ctx.wire_golden),
        inputs=lambda ctx: json.dumps(ctx.wire_golden, sort_keys=True)),
    RuleGroup(
        key="jit",
        rules=("jit-purity",),
        modules=("rules_jit.py", "callgraph.py"),
        run=lambda path, src, tree, ctx: check_jit_purity(
            tree, path, ctx.jit_roots),
        inputs=lambda ctx: "|".join(sorted(ctx.jit_roots))),
    RuleGroup(
        key="contracts",
        rules=("durability-order", "span-pairing", "exit-code"),
        modules=("rules_contracts.py", "callgraph.py"),
        run=lambda path, src, tree, ctx: (
            check_durability_order(
                tree, path,
                ctx.graph.external_attr_calls if ctx.graph else None)
            + check_span_contract(tree, path, ctx.span_catalog)
            + check_exit_contract(tree, path, ctx.exit_codes)),
        inputs=lambda ctx: (_digest_of(ctx.span_catalog or set())
                            + _digest_of(ctx.exit_codes or set())
                            + ctx.tree_digest)),
)


def lint_file(path: str, source: str, tree: ast.Module,
              ctx: LintContext) -> list[Finding]:
    """All raw findings for one file (suppressions/baseline NOT applied)."""
    findings: list[Finding] = []
    for spec in RULE_GROUPS:
        findings += spec.run(path, source, tree, ctx)
    return findings


def discover(root: str, paths: list[str] | None = None) -> list[str]:
    """Repo-relative .py files to lint, sorted."""
    roots = paths or [os.path.join(root, p) for p in DEFAULT_ROOTS]
    out: set[str] = set()
    for entry in roots:
        if os.path.isfile(entry) and entry.endswith(".py"):
            out.add(os.path.relpath(entry, root))
        elif os.path.isdir(entry):
            for dirpath, dirnames, filenames in os.walk(entry):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for name in filenames:
                    if name.endswith(".py"):
                        out.add(os.path.relpath(
                            os.path.join(dirpath, name), root))
    return sorted(p.replace(os.sep, "/") for p in out)


class _Cache:
    """v2 layout: per file, per rule group —
    ``files[rel] = {digest, groups: {key: {config, findings}}}``."""

    def __init__(self, path: str, enabled: bool) -> None:
        self.path = path
        self.enabled = enabled
        self.dirty = False
        self.data: dict = {}
        if enabled:
            try:
                with open(path, encoding="utf-8") as f:
                    raw = json.load(f)
                if raw.get("version") == CACHE_VERSION:
                    self.data = raw.get("files", {})
            except (OSError, ValueError):
                self.data = {}

    def get(self, rel: str, digest: str, key: str,
            config: str) -> list[Finding] | None:
        entry = self.data.get(rel)
        if not self.enabled or entry is None \
                or entry.get("digest") != digest:
            return None
        group = entry.get("groups", {}).get(key)
        if group is None or group.get("config") != config:
            return None
        return [Finding(**f) for f in group.get("findings", [])]

    def put(self, rel: str, digest: str, key: str, config: str,
            findings: list[Finding]) -> None:
        if not self.enabled:
            return
        entry = self.data.get(rel)
        if entry is None or entry.get("digest") != digest:
            entry = self.data[rel] = {"digest": digest, "groups": {}}
        entry.setdefault("groups", {})[key] = {
            "config": config,
            "findings": [f.to_json() for f in findings]}
        self.dirty = True

    def save(self) -> None:
        if not (self.enabled and self.dirty):
            return
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "w", encoding="utf-8") as f:
                json.dump({"version": CACHE_VERSION, "files": self.data}, f)
        except OSError:
            pass  # a read-only checkout just goes uncached


@dataclass
class LintResult:
    findings: list[Finding]          # actionable (not suppressed/baselined)
    baselined: list[Finding]
    suppressed: list[Finding]
    stale_baseline: list[tuple]
    files: int = 0
    parse_errors: list[str] = field(default_factory=list)
    #: set when --changed BASE filtered the report to touched files
    changed_files: list[str] | None = None


def changed_files_since(root: str, base: str) -> list[str]:
    """Repo-relative .py files touched since ``base``: commits since
    the merge-base (three-dot ``BASE...`` — a branch BEHIND base must
    not inherit files only base's own history changed), staged and
    unstaged edits, and untracked files (a brand-new module must not
    dodge the diff gate)."""
    out: set[str] = set()
    for argv in (["git", "diff", "--name-only", f"{base}...", "--",
                  "*.py"],
                 ["git", "diff", "--name-only", "HEAD", "--", "*.py"],
                 ["git", "ls-files", "--others", "--exclude-standard",
                  "--", "*.py"]):
        proc = subprocess.run(argv, cwd=root, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise SystemExit(
                f"copycheck: --changed {base}: `{' '.join(argv)}` failed: "
                f"{proc.stderr.strip() or proc.stdout.strip()}")
        out.update(line.strip() for line in proc.stdout.splitlines()
                   if line.strip())
    return sorted(out)


def run_lint(root: str | None = None, paths: list[str] | None = None,
             baseline_path: str | None = None,
             use_cache: bool = True,
             changed_base: str | None = None) -> LintResult:
    root = root or _repo_root()
    rels = discover(root, paths)
    sources: dict[str, str] = {}
    trees: dict[str, ast.Module] = {}
    parse_errors: list[str] = []
    for rel in rels:
        src = _read(os.path.join(root, rel))
        if src is None:
            continue
        try:
            trees[rel] = ast.parse(src)
            sources[rel] = src
        except SyntaxError as e:
            parse_errors.append(f"{rel}: {e}")
    ctx = LintContext.build(root, trees, sources)
    cache = _Cache(os.path.join(root, CACHE_FILE), use_cache)
    raw: list[Finding] = []
    for rel, tree in trees.items():
        digest = hashlib.sha256(sources[rel].encode()).hexdigest()
        for spec in RULE_GROUPS:
            config = ctx.group_digests[spec.key]
            cached = cache.get(rel, digest, spec.key, config)
            if cached is None:
                cached = spec.run(rel, sources[rel], tree, ctx)
                cache.put(rel, digest, spec.key, config, cached)
            raw.extend(cached)
    cache.save()

    baseline = Baseline.load(
        baseline_path or os.path.join(root, BASELINE_FILE))
    actionable: list[Finding] = []
    suppressed: list[Finding] = []
    baselined: list[Finding] = []
    suppressions_by_path: dict[str, dict[int, set[str]]] = {}
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        file_suppressions = suppressions_by_path.get(f.path)
        if file_suppressions is None:
            file_suppressions = scan_suppressions(sources.get(f.path, ""))
            suppressions_by_path[f.path] = file_suppressions
        if is_suppressed(f, file_suppressions):
            suppressed.append(f)
        elif baseline.match(f):
            baselined.append(f)
        else:
            actionable.append(f)
    stale = baseline.stale(baselined + actionable)
    changed: list[str] | None = None
    if changed_base is not None:
        changed = changed_files_since(root, changed_base)
        in_diff = set(changed)
        actionable = [f for f in actionable if f.path in in_diff]
        baselined = [f for f in baselined if f.path in in_diff]
        suppressed = [f for f in suppressed if f.path in in_diff]
        # a partial view can't judge the whole baseline: stale entries
        # are only reported for files the diff touched
        stale = [key for key in stale if key[1] in in_diff]
    return LintResult(
        findings=actionable, baselined=baselined, suppressed=suppressed,
        stale_baseline=stale, files=len(trees),
        parse_errors=parse_errors, changed_files=changed)


def write_baseline(result: LintResult, root: str | None = None,
                   baseline_path: str | None = None) -> str:
    root = root or _repo_root()
    path = baseline_path or os.path.join(root, BASELINE_FILE)
    existing = Baseline.load(path)
    merged = Baseline()
    for f in result.baselined:
        merged.entries[f.identity()] = existing.entries.get(f.identity(), "")
    for f in result.findings:
        merged.entries[f.identity()] = ""
    merged.save(path)
    return path


#: Why ``--update-golden`` exits 2 here.
GOLDEN_OWNER = (
    f"copycheck: --update-golden is refused: {GOLDEN_PATH} belongs to the "
    f"reference package (copycat_tpu/protocol/messages.py); regenerate it "
    f"there with `python -m copycat_tpu.analysis --update-golden`. The "
    f"port's protocol/messages.py is checked against it, never written "
    f"into it")


def render_text(result: LintResult, strict: bool) -> str:
    lines: list[str] = []
    for f in result.findings:
        lines.append(f.render())
    for err in result.parse_errors:
        lines.append(f"PARSE ERROR: {err}")
    if result.stale_baseline:
        lines.append("")
        lines.append("stale baseline entries (fixed findings — prune them "
                     f"from {BASELINE_FILE}):")
        for rule, path, symbol, message in result.stale_baseline:
            lines.append(f"  {path} [{symbol}] {rule}: {message[:60]}")
    failed = bool(result.findings or result.parse_errors
                  or (strict and result.stale_baseline))
    status = "FAIL" if failed else "ok"
    lines.append("")
    scope = (f" ({len(result.changed_files)} changed file(s) in scope)"
             if result.changed_files is not None else "")
    lines.append(
        f"copycheck: {status} — {result.files} files{scope}, "
        f"{len(result.findings)} finding(s), "
        f"{len(result.baselined)} baselined, "
        f"{len(result.suppressed)} suppressed"
        + (f", {len(result.stale_baseline)} stale baseline entr(ies)"
           if result.stale_baseline else ""))
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    return json.dumps({
        "findings": [f.to_json() for f in result.findings],
        "baselined": [f.to_json() for f in result.baselined],
        "suppressed": [f.to_json() for f in result.suppressed],
        "stale_baseline": [list(k) for k in result.stale_baseline],
        "files": result.files,
        "parse_errors": result.parse_errors,
        **({"changed_files": result.changed_files}
           if result.changed_files is not None else {}),
    }, indent=2)


def render_sarif(result: LintResult) -> str:
    """SARIF 2.1.0 (the GitHub code-scanning ingestion format): every
    actionable finding at level error; baselined findings ride along
    with an ``external`` suppression and inline-suppressed ones with
    ``inSource``, so the full picture annotates a PR without failing
    files the baseline already argues for."""
    all_rules = sorted({f.rule for f in (result.findings + result.baselined
                                         + result.suppressed)})

    def sarif_result(f: Finding, suppression: str | None) -> dict:
        out = {
            "ruleId": f.rule,
            "level": "error" if suppression is None else "note",
            "message": {"text": f.message
                        + (f" [via {' -> '.join(f.via)}]" if f.via else "")},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(1, f.line)},
                },
            }],
            "partialFingerprints": {
                "copycheckIdentity/v1": hashlib.sha256(
                    "|".join(f.identity()).encode()).hexdigest()},
        }
        if suppression is not None:
            out["suppressions"] = [{"kind": suppression}]
        return out

    results = ([sarif_result(f, None) for f in result.findings]
               + [sarif_result(f, "external") for f in result.baselined]
               + [sarif_result(f, "inSource") for f in result.suppressed])
    return json.dumps({
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "copycheck",
                "informationUri": "docs/ANALYSIS.md",
                "rules": [{"id": r} for r in all_rules],
            }},
            "results": results,
        }],
    }, indent=2)


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="copycat-tpu lint",
        description="copycheck: project-native static analysis "
                    "(docs/ANALYSIS.md)")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: the product "
                             "tree)")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 on any unsuppressed, unbaselined "
                             "finding AND on stale baseline entries (the "
                             "CI gate)")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default="text")
    parser.add_argument("--output", default=None, metavar="PATH",
                        help="write the rendered report to PATH instead "
                             "of stdout (stdout keeps the one-line "
                             "status) — how CI captures the SARIF "
                             "artifact in the gating run")
    parser.add_argument("--changed", default=None, metavar="BASE",
                        help="report findings only on files touched "
                             "since the git rev BASE (analysis still "
                             "runs package-wide — interprocedural "
                             "results need the whole tree)")
    parser.add_argument("--no-cache", action="store_true",
                        help=f"ignore + don't write {CACHE_FILE}")
    parser.add_argument("--baseline", default=None, metavar="PATH",
                        help=f"baseline file (default {BASELINE_FILE})")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept current findings into the baseline "
                             "(fill in the justifications!)")
    parser.add_argument("--update-golden", action="store_true",
                        help=f"refused (exit 2): {GOLDEN_PATH} belongs "
                             f"to the reference package")
    args = parser.parse_args(argv)

    if args.write_baseline and args.changed:
        # write_baseline rebuilds the file from the run's findings; a
        # diff-scoped run would silently drop every entry (and its
        # hand-written justification) outside the diff
        parser.error("--write-baseline needs the full-tree view; "
                     "run it without --changed")

    if args.update_golden:
        print(GOLDEN_OWNER, file=sys.stderr)
        return 2

    result = run_lint(paths=args.paths or None,
                      baseline_path=args.baseline,
                      use_cache=not args.no_cache,
                      changed_base=args.changed)
    if args.write_baseline:
        path = write_baseline(result, baseline_path=args.baseline)
        print(f"baseline written: {path} "
              f"({len(result.findings) + len(result.baselined)} entries)")
        return 0
    if args.format == "json":
        rendered = render_json(result)
    elif args.format == "sarif":
        rendered = render_sarif(result)
    else:
        rendered = render_text(result, args.strict)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(rendered + "\n")
        # keep the human-readable verdict on stdout either way
        print(render_text(result, args.strict).splitlines()[-1])
        print(f"report written: {args.output}")
    else:
        print(rendered)
    if result.findings or result.parse_errors:
        return 1
    if args.strict and result.stale_baseline:
        return 1
    return 0
