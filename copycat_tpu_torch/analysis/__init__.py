"""copycheck — project-native static analysis (docs/ANALYSIS.md), the
port's copy, over the port's own tree.

Ten AST-based rules over a package-wide async call graph
(:mod:`callgraph`), each grounded in a hazard this codebase has
actually hit (flight-recorder findings, the torn-write post-mortem of
the durability work, the ``utils/tasks.py`` weakref note, the deploy
plane's exit-code contract):

- ``loop-blocking`` — event-loop-blocking calls inside ``async def``
  bodies AND inside sync helpers the call graph proves reachable from
  one (latency hazards for the repl/read pumps);
- ``orphan-task`` — raw ``create_task``/``ensure_future`` outside
  ``utils/tasks.spawn`` (the fire-and-forget weakref-GC hazard);
- ``await-tear`` — an unguarded protected-state write after a
  suspension point across the server+deploy plane, interprocedurally:
  awaits of never-suspending helpers don't count, ``async with``/
  ``async for`` and writes hidden in called helpers do (the asyncio
  analogue of a race detector);
- ``durability-order`` — inside ``RaftGroup``, no commit/command future
  resolve or success append ack unless dominated by the commit-boundary
  ``_sync_log`` (the "fsync before ack" guarantee, statically);
- ``span-pairing`` — span-record call sites use vocabulary names from
  ``docs/OBSERVABILITY.md``, never ``with`` over the completed-span
  API, never an unentered ``.timer(...)``;
- ``exit-code`` — deploy-plane mains exit only with the documented
  0/1/2 contract the supervisor's restart policy keys off;
- ``knob-registry`` — every ``COPYCAT_*`` env read goes through
  ``utils/knobs.py``; every knob named is registered;
- ``metric-registry`` — every metric call site uses a name from the
  ``docs/OBSERVABILITY.md`` catalog;
- ``wire-schema`` — ``protocol/messages.py`` type ids unique and
  ``_fields`` orders frozen against ``tests/golden/wire_schema.json``;
- ``jit-purity`` — no ``time``/``random``/``os.environ``/host
  round-trips reachable inside the ``ops/`` step functions the reference
  jits.

Run with ``python -m copycat_tpu_torch.cli lint`` (or ``python -m
copycat_tpu_torch.analysis``); ``--strict`` is the CI gate, ``--format
sarif`` the code-scanning emitter, ``--changed BASE`` the diff mode.
Findings are suppressed inline with ``# copycheck: ignore[rule]`` or
carried (with a justification) in ``copycat_tpu_torch/analysis/
baseline.json``. Pure stdlib + AST: linting never imports torch, the
reference package or the modules it checks.

Where the port departs from the reference's rules, on purpose:

- the device syncs ``loop-blocking`` knows are torch's
  (``torch.cuda.synchronize``, ``.synchronize()``), see
  :mod:`.rules_asyncio`;
- ``jit-purity`` takes its roots from a list (:data:`.rules_jit.JIT_ROOTS`),
  since nothing in the port is jitted, and forbids the host round-trips
  of a tensor where the reference forbids host callbacks;
- the knob registry, the metric scope and the ``exit-code`` scope are
  the port's (``copycat_tpu_torch/utils/knobs.py``,
  ``copycat_tpu_torch/``, ``copycat_tpu_torch/cli.py``), and so is the
  baseline;
- ``--update-golden`` is refused: the wire golden belongs to the
  reference package.
"""

from .engine import LintContext, run_lint  # noqa: F401
from .findings import Finding  # noqa: F401

ALL_RULES = (
    "loop-blocking",
    "orphan-task",
    "await-tear",
    "durability-order",
    "span-pairing",
    "exit-code",
    "knob-registry",
    "metric-registry",
    "wire-schema",
    "jit-purity",
)
