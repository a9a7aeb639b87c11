"""Perf-regression gate over ``python -m copycat_tpu_torch.bench
--metrics-json`` artifacts.

Per scenario, an artifact's headline value is compared against the window
recorded in a golden file: ``floor = baseline x (1 - tolerance)``
(tolerance defaults to 0.25: host jitter, not a quality bar). Below the
floor fails and prints the exact update command; above ``baseline x (1 +
tolerance)`` passes with a "baseline looks stale" note, so that genuine
wins get captured rather than silently widening the window.

The golden records the value PLUS the artifact's ``meta`` block (git SHA,
knob overrides, host fingerprint — ``bench._artifact_meta``), so a miss
can be explained: a different host or knob set is a different experiment,
not a regression. An artifact marked ``"degraded": true`` graded against a
window recorded on the other lane (or the reverse) is skipped, not graded.

There is no default golden. The reference's committed window
(``tests/golden/bench_baseline.json``) holds the reference's CPU numbers,
which are no baseline for the port, and the repository commits no golden
of the port: ``--golden PATH`` is required, and a window is recorded from
the port's own artifacts with ``--update-golden``.

Usage (artifacts are plain JSON)::

    python -m copycat_tpu_torch.testing.bench_gate A.json B.json --golden G.json
    python -m copycat_tpu_torch.testing.bench_gate A.json --golden G.json \\
        --update-golden

Exit codes: 0 every artifact passed (or the golden was updated), 1 a
regression or an ungradable artifact, 2 a usage error.
"""

from __future__ import annotations

import argparse
import json

DEFAULT_TOLERANCE = 0.25


def load_golden(path: str) -> dict:
    try:
        with open(path) as f:
            golden = json.load(f)
    except FileNotFoundError:
        golden = {}
    golden.setdefault("tolerance", DEFAULT_TOLERANCE)
    golden.setdefault("scenarios", {})
    return golden


def gate_artifact(artifact: dict, golden: dict) -> tuple[bool, str]:
    """Judge one artifact against the golden window; returns
    ``(passed, one-line verdict)``."""
    scenario = artifact.get("scenario", "?")
    value = artifact.get("value")
    unit = artifact.get("unit", "?")
    if not isinstance(value, (int, float)) or value <= 0:
        return False, (f"{scenario}: artifact carries no positive "
                       f"headline value ({value!r})")
    entry = golden["scenarios"].get(scenario)
    if entry is None:
        return False, (f"{scenario}: no committed baseline — record one "
                       f"with --update-golden")
    if entry.get("unit") != unit:
        return False, (f"{scenario}: unit changed "
                       f"({entry.get('unit')!r} -> {unit!r}) — the "
                       f"scenario is measuring something else; "
                       f"--update-golden after reviewing")
    art_degraded = bool(artifact.get("degraded"))
    base_degraded = bool(entry.get("degraded"))
    if art_degraded != base_degraded:
        # A "degraded": true artifact ran on a fallback lane — grading it
        # against a window recorded on the other plane compares two
        # different experiments, so the floor is SKIPPED, not graded.
        # Visible, and never a silent pass-through: the verdict carries
        # the mismatch so the log shows which lane ran.
        art_lane = "degraded/CPU-fallback" if art_degraded else \
            "non-degraded"
        base_lane = "degraded/CPU-fallback" if base_degraded else \
            "non-degraded"
        return True, (f"{scenario}: degraded_mismatch — artifact is "
                      f"{art_lane} but the committed window is "
                      f"{base_lane}; device-plane floor skipped (value "
                      f"{value:,.1f} {unit} recorded, not graded). "
                      f"Refresh the window on the matching lane with "
                      f"--update-golden once the lane is stable.")
    tolerance = golden["tolerance"]
    baseline = float(entry["value"])
    floor = baseline * (1.0 - tolerance)
    if value < floor:
        verdict = (f"{scenario}: REGRESSION {value:,.1f} {unit} < "
                   f"floor {floor:,.1f} (baseline {baseline:,.1f} "
                   f"-{tolerance:.0%})")
        rec = (entry.get("recorded") or {}).get("host") or {}
        here = (artifact.get("meta") or {}).get("host") or {}
        probe = ("hostname", "machine", "cpus")
        if rec and here and any(rec.get(k) != here.get(k)
                                for k in probe):
            verdict += (f" — note: baseline was recorded on "
                        f"{rec.get('hostname')}/{rec.get('machine')}/"
                        f"{rec.get('cpus')}cpu, this run is "
                        f"{here.get('hostname')}/{here.get('machine')}/"
                        f"{here.get('cpus')}cpu; a different machine is "
                        f"a different experiment — refresh the baseline "
                        f"on THIS runner before reading this as a "
                        f"regression")
        return False, verdict
    if value > baseline * (1.0 + tolerance):
        return True, (f"{scenario}: ok {value:,.1f} {unit} — ABOVE the "
                      f"+{tolerance:.0%} window (baseline "
                      f"{baseline:,.1f} looks stale; consider "
                      f"--update-golden)")
    return True, (f"{scenario}: ok {value:,.1f} {unit} (baseline "
                  f"{baseline:,.1f}, floor {floor:,.1f})")


def update_golden(artifacts: list[dict], golden: dict) -> dict:
    for artifact in artifacts:
        # only value/unit/meta are recorded — bulky run-local payloads
        # ("metrics" snapshots, retained "series" windows) are tolerated
        # on the artifact but never committed into the golden
        entry = {
            "value": artifact["value"],
            "unit": artifact.get("unit"),
            "recorded": artifact.get("meta", {}),
        }
        if artifact.get("degraded"):
            # record the lane so a later non-degraded run is a
            # degraded_mismatch (skipped), not a spurious "win"
            entry["degraded"] = True
        golden["scenarios"][artifact["scenario"]] = entry
    return golden


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m copycat_tpu_torch.testing.bench_gate",
        description="compare bench --metrics-json artifacts against a "
                    "golden window")
    parser.add_argument("artifacts", nargs="+", metavar="ARTIFACT.json")
    parser.add_argument("--golden", required=True, metavar="PATH",
                        help="baseline file (required: the port commits "
                             "no golden, and the reference's "
                             "tests/golden/bench_baseline.json holds the "
                             "reference's CPU numbers, no baseline for the "
                             "port; record one with --update-golden)")
    parser.add_argument("--update-golden", action="store_true",
                        help="rewrite the baseline entries from these "
                             "artifacts instead of gating")
    args = parser.parse_args(argv)

    artifacts = []
    for path in args.artifacts:
        with open(path) as f:
            artifacts.append(json.load(f))
    golden = load_golden(args.golden)

    if args.update_golden:
        golden = update_golden(artifacts, golden)
        with open(args.golden, "w") as f:
            json.dump(golden, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"bench-gate: baseline updated for "
              f"{', '.join(a['scenario'] for a in artifacts)} "
              f"-> {args.golden}")
        return 0

    failed = False
    for artifact in artifacts:
        ok, line = gate_artifact(artifact, golden)
        print(f"bench-gate: {line}")
        if not ok:
            failed = True
    if failed:
        cmd = ("python -m copycat_tpu_torch.testing.bench_gate "
               + " ".join(args.artifacts) + f" --golden {args.golden}"
               + " --update-golden")
        print(f"bench-gate: FAILED — if the change is intentional and "
              f"reviewed, refresh the window with:\n  {cmd}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
