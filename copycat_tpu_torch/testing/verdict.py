"""Linearizability verdict at bench scale, for the port's engine.

Counterpart of ``copycat_tpu/testing/verdict.py``. A ``RaftGroups``
batch of 10k groups runs under a randomized nemesis (partitions,
single-peer isolation, 30% message loss; period 12 rounds) with client
load and, by default, membership churn (5 peer lanes, 3 initial voters,
lanes 3 and 4 cycled in and out of every sampled group's voter set).
Real-time histories are recorded on a sample of groups across three
resource models (register/counter, map, try-lock) and each is checked
with the Wing & Gong checker (:mod:`.linearize`). A second block drives
the deep (monotone-tag) bulk plane under per-epoch faults, with the
abort-and-recover path, and checks its register histories the same way.

Run: ``python -m copycat_tpu_torch.testing.verdict [--device cpu]`` —
on ``cuda`` unless another device is named. It prints one JSON object
(the reference's keys) and exits 1 if any history is not linearizable.
The ``COPYCAT_VERDICT_*`` knobs (``utils/knobs.py``) set the sizes, as in
the reference; :func:`run_verdict` and :func:`run_deep_verdict` also take
them as arguments. Unlike the reference it writes no artifact file.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from ..models.bulk import BulkDriver
from ..models.raft_groups import RaftGroups
from ..ops import apply as ap
from ..ops.consensus import Config
from ..utils import knobs
from .history import HistoryRecorder
from .linearize import (
    HOp,
    LockModel,
    RegisterModel,
    check_linearizable_windowed,
    check_map_linearizable,
)
from .nemesis import Nemesis

BACKGROUND_PER_ROUND = 500  # untracked load spread over the other groups
NEMESIS_PERIOD = 12
# Membership churn: server join/leave cycling lanes 3 and 4 of every
# sampled group (and 200 background groups) every CHURN_PERIOD rounds.
CHURN_PERIOD = 20
CHURN_CYCLE = (("add", 3), ("add", 4), ("remove", 3), ("remove", 4))
DEEP_OPS_PER_EPOCH = 4          # recorded ops / sampled group / epoch


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _knob(value, name: str, kind=int):
    if value is not None:
        return value
    return knobs.get_bool(name) if kind is bool else knobs.get_int(name)


def _invoke_register(rec: HistoryRecorder, g: int, rng) -> None:
    kind = int(rng.integers(4))
    if kind == 0:
        v = int(rng.integers(1, 50))
        rec.invoke(g, ap.OP_VALUE_SET, ("set", v), a=v)
    elif kind == 1:
        # half the reads ride the lease-gated atomic query lane (no log
        # append): the checker holds them against real time
        query = "atomic" if rng.random() < 0.5 else None
        rec.invoke(g, ap.OP_VALUE_GET, ("get",), query=query)
    elif kind == 2:
        e, u = int(rng.integers(0, 50)), int(rng.integers(1, 50))
        rec.invoke(g, ap.OP_VALUE_CAS, ("cas", e, u), a=e, b=u)
    else:
        d = int(rng.integers(1, 5))
        rec.invoke(g, ap.OP_LONG_ADD, ("add", d), a=d)


def _invoke_map(rec: HistoryRecorder, g: int, rng) -> None:
    kind = int(rng.integers(4))
    k = int(rng.integers(0, 8))
    if kind == 0:
        v = int(rng.integers(1, 99))
        rec.invoke(g, ap.OP_MAP_PUT, ("put", k, v), a=k, b=v)
    elif kind == 1:
        query = "atomic" if rng.random() < 0.5 else None
        rec.invoke(g, ap.OP_MAP_GET, ("get", k), a=k, query=query)
    elif kind == 2:
        rec.invoke(g, ap.OP_MAP_REMOVE, ("remove", k), a=k)
    else:
        rec.invoke(g, ap.OP_MAP_CONTAINS_KEY, ("contains", k), a=k)


def _invoke_lock(rec: HistoryRecorder, g: int, rng) -> None:
    who = int(rng.integers(1, 4))
    if rng.random() < 0.5:
        rec.invoke(g, ap.OP_LOCK_ACQUIRE, ("acquire", who), a=who, b=0)
    else:
        rec.invoke(g, ap.OP_LOCK_RELEASE, ("release", who), a=who)


def _telemetry_summary(rg) -> dict:
    """The run's final ``device.*`` telemetry and the invariant monitor's
    verdict (it observed every fetched round of the run, so 0 violations
    is an online safety witness beside the offline check)."""
    hub = getattr(rg, "telemetry", None)
    if hub is None:
        return {}
    out = {k: v for k, v in hub.snapshot().items()
           if k.startswith("device.") and not isinstance(v, dict)}
    out["invariants"] = hub.monitor.summary()
    return out


def run_verdict(*, groups: int | None = None, sample: int | None = None,
                rounds: int | None = None, seed: int | None = None,
                churn: bool | None = None, op_every: int | None = None,
                inflight: int | None = None,
                device: torch.device | str | None = None) -> dict:
    """The client-plane verdict: queue-managed ops and query-lane reads
    under the nemesis (and churn), histories checked per sampled group."""
    G = _knob(groups, "COPYCAT_VERDICT_GROUPS")
    sample = _knob(sample, "COPYCAT_VERDICT_SAMPLE")
    rounds = _knob(rounds, "COPYCAT_VERDICT_ROUNDS")
    seed = _knob(seed, "COPYCAT_VERDICT_SEED")
    churn = _knob(churn, "COPYCAT_VERDICT_CHURN", bool)
    op_every = max(1, _knob(op_every, "COPYCAT_VERDICT_OP_EVERY"))
    max_inflight = max(1, _knob(inflight, "COPYCAT_VERDICT_INFLIGHT"))

    t0 = time.time()
    if churn:
        rg = RaftGroups(G, 5, log_slots=64, submit_slots=4, seed=seed,
                        config=Config(dynamic_membership=True,
                                      telemetry=True), voters=3,
                        device=device)
    else:
        rg = RaftGroups(G, 3, log_slots=64, submit_slots=4, seed=seed,
                        config=Config(telemetry=True), device=device)
    rg.wait_for_leaders()
    rec = HistoryRecorder(rg)
    nemesis = Nemesis(rg, seed=seed + 1, period=NEMESIS_PERIOD)
    rng = np.random.default_rng(seed + 2)

    # the sample split across the three checked models
    sampled = rng.choice(G, size=sample, replace=False)
    third = sample // 3
    reg_groups = [int(g) for g in sampled[:third]]
    map_groups = [int(g) for g in sampled[third:2 * third]]
    lock_groups = [int(g) for g in sampled[2 * third:]]
    others = np.setdiff1d(np.arange(G), sampled)

    _log(f"verdict: G={G} sample={sample} rounds={rounds} nemesis "
         f"period={NEMESIS_PERIOD} device load={BACKGROUND_PER_ROUND}/round "
         f"on {rg.device}")
    bg_tags: set[int] = set()
    cfg_tags: set[int] = set()
    cfg_submitted = cfg_applied = 0
    churn_step = 0
    for round_no in range(rounds):
        nemesis.tick()
        if churn and round_no % CHURN_PERIOD == CHURN_PERIOD // 2:
            # server join/leave on every sampled group (and a slice of the
            # background) while their histories are recorded
            kind, lane = CHURN_CYCLE[churn_step % len(CHURN_CYCLE)]
            churn_step += 1
            targets = [int(g) for g in sampled]
            targets += [int(g) for g in
                        rng.choice(others, size=min(200, len(others)),
                                   replace=False)]
            for g in targets:
                cfg_tags.add(rg.add_peer(g, lane) if kind == "add"
                             else rg.remove_peer(g, lane))
                cfg_submitted += 1
        # recorded client ops, bounded by the client concurrency window
        if round_no % op_every == 0:
            for gs, invoke in ((reg_groups, _invoke_register),
                               (map_groups, _invoke_map),
                               (lock_groups, _invoke_lock)):
                for g in gs:
                    if rec.pending_count(g) < max_inflight:
                        invoke(rec, g, rng)
        # untracked counter load on the rest of the batch; its results are
        # reaped so rg.results stays bounded
        n_bg = min(BACKGROUND_PER_ROUND, len(others))
        for g in rng.choice(others, size=n_bg, replace=False):
            bg_tags.add(rg.submit(int(g), ap.OP_LONG_ADD, 1))
        rec.tick()
        bg_tags = {t for t in bg_tags if rg.results.pop(t, None) is None}
        done_cfg = {t for t in cfg_tags if t in rg.results}
        cfg_applied += len(done_cfg)
        for t in done_cfg:
            rg.results.pop(t)
        cfg_tags -= done_cfg
        if round_no % 50 == 49:
            _log(f"verdict: round {round_no + 1}/{rounds} "
                 f"fault={nemesis.current} pending={len(rec._pending)}")
    nemesis.heal()
    for _ in range(300):
        if not rec._pending:
            break
        rec.tick()

    checked = failures = undecided = total_ops = total_nodes = 0
    for gs, checker, name in (
            (reg_groups,
             lambda h: check_linearizable_windowed(h, RegisterModel),
             "RegisterModel"),
            (map_groups, check_map_linearizable, "MapModel(per-key)"),
            (lock_groups,
             lambda h: check_linearizable_windowed(h, LockModel),
             "LockModel")):
        for g in gs:
            hist = rec.history(g)
            total_ops += len(hist)
            checked += 1
            try:
                res = checker(hist)
            except RuntimeError as e:
                # search budget exceeded: undecided, never a pass
                undecided += 1
                _log(f"verdict: UNDECIDED group {g} ({name}): {e}")
                continue
            total_nodes += res.nodes
            if not res.ok:
                failures += 1
                _log(f"verdict: VIOLATION group {g} ({name}): {hist}")

    result = {
        "linearizable": failures == 0 and undecided == 0,
        "groups": G,
        "undecided_groups": undecided,
        "sampled_groups": checked,
        "checked_ops": total_ops,
        "rounds": rounds,
        "nemesis": f"partition/isolate/loss, period {NEMESIS_PERIOD}"
                   + (", membership churn" if churn else ""),
        "violations": failures,
        "search_nodes": total_nodes,
        "incomplete_ops": len(rec._pending),
        "wall_s": round(time.time() - t0, 1),
        "seed": seed,
        "device_telemetry": _telemetry_summary(rg),
    }
    if churn:
        result["membership_changes_applied"] = cfg_applied
        result["membership_changes_submitted"] = cfg_submitted
    return result


def run_deep_verdict(*, groups: int | None = None,
                     sample: int | None = None, epochs: int | None = None,
                     seed: int | None = None,
                     device: torch.device | str | None = None) -> dict:
    """The verdict of the deep (monotone-tag) bulk plane.

    Per epoch a fault mask (heal, 30% loss, a two-sided partition or one
    isolated peer) holds for 6-15 rounds of a drive and then heals; every
    sampled group commits a burst of recorded register ops through
    ``BulkDriver.drive``, and every other epoch serves lease-gated atomic
    reads through ``drive_queries``. Real-time windows come from the
    drive's per-op dispatch and resolve rounds. Every 7th epoch the fault
    is held for the whole drive with a small round budget: the drive
    aborts, its burst is recorded as maybe-applied (a crashed client), and
    ``BulkDriver.recover`` fences it. Histories are kept as segments cut
    at each fence by an anchoring atomic read, whose value seeds the next
    segment.
    """
    G = _knob(groups, "COPYCAT_VERDICT_DEEP_GROUPS")
    sample = _knob(sample, "COPYCAT_VERDICT_DEEP_SAMPLE")
    epochs = _knob(epochs, "COPYCAT_VERDICT_DEEP_EPOCHS")
    seed = _knob(seed, "COPYCAT_VERDICT_SEED")

    t0 = time.time()
    rg = RaftGroups(G, 3, log_slots=64, submit_slots=4, seed=seed + 10,
                    config=Config(monotone_tag_accept=True, telemetry=True),
                    device=device)
    rg.wait_for_leaders()
    driver = BulkDriver(rg)
    rng = np.random.default_rng(seed + 11)
    nemesis = Nemesis(rg, seed=seed + 12)

    sampled = [int(g) for g in rng.choice(G, size=sample, replace=False)]
    others = np.setdiff1d(np.arange(G), sampled)
    segments: dict[int, list] = {g: [] for g in sampled}
    cur_ops: dict[int, list] = {g: [] for g in sampled}
    cur_init: dict[int, int] = {g: 0 for g in sampled}
    op_id = [0]
    drive_aborts = anchor_timeouts = 0

    def _epoch_ops():
        """One recorded burst: DEEP_OPS_PER_EPOCH register ops per sampled
        group, then untracked background adds on other groups."""
        gs, ops, av, bv, labels = [], [], [], [], []
        for g in sampled:
            for _ in range(DEEP_OPS_PER_EPOCH):
                kind = int(rng.integers(4))
                if kind == 0:
                    v = int(rng.integers(1, 50))
                    op, a, b, label = ap.OP_VALUE_SET, v, 0, ("set", v)
                elif kind == 1:
                    op, a, b, label = ap.OP_VALUE_GET, 0, 0, ("get",)
                elif kind == 2:
                    e, u = int(rng.integers(0, 50)), int(rng.integers(1, 50))
                    op, a, b, label = ap.OP_VALUE_CAS, e, u, ("cas", e, u)
                else:
                    d = int(rng.integers(1, 5))
                    op, a, b, label = ap.OP_LONG_ADD, d, 0, ("add", d)
                gs.append(g)
                ops.append(op)
                av.append(a)
                bv.append(b)
                labels.append(label)
        n_rec = len(gs)
        bg = rng.choice(others, size=min(400, len(others)), replace=False)
        gs += [int(g) for g in bg]
        ops += [ap.OP_LONG_ADD] * len(bg)
        av += [1] * len(bg)
        bv += [0] * len(bg)
        return (np.asarray(gs), np.asarray(ops), np.asarray(av),
                np.asarray(bv), labels, n_rec)

    def _anchor_reads(fence: int, close: bool) -> None:
        """Atomic reads of every sampled group through the query lane;
        with ``close`` each closes its group's segment and seeds the
        next."""
        nonlocal anchor_timeouts
        try:
            vals = driver.drive_queries(np.asarray(sampled), ap.OP_VALUE_GET,
                                        consistency="atomic", max_rounds=200)
        except TimeoutError:
            anchor_timeouts += 1
            return
        for g, v in zip(sampled, vals):
            op_id[0] += 1
            cur_ops[g].append(HOp(op_id=op_id[0], op=("get",),
                                  result=int(v), invoke=fence,
                                  complete=rg.rounds))
            if close:
                segments[g].append((cur_init[g], cur_ops[g]))
                cur_ops[g] = []
                cur_init[g] = int(v)

    _log(f"deep verdict: G={G} sample={sample} epochs={epochs} x "
         f"{DEEP_OPS_PER_EPOCH} ops/group on {rg.device}")
    heal_mask = nemesis.mask("heal")
    for epoch in range(epochs):
        fault = ("heal", "loss", "partition", "isolate")[int(rng.integers(4))]
        fault_mask = nemesis.mask(fault)
        fault_rounds = int(rng.integers(6, 16))
        schedule = (lambda r, fm=fault_mask, fr=fault_rounds:
                    fm if r % 60 < fr else heal_mask)
        budget = 400
        if epoch % 7 == 6 and fault != "heal":
            # held for the whole drive: liveness is lost by design, and the
            # abort and recover path is what is checked
            schedule = lambda r, fm=fault_mask: fm  # noqa: E731
            budget = 120
        gs, ops, av, bv, labels, n_rec = _epoch_ops()
        base_round = rg.rounds
        try:
            res = driver.drive(gs, ops, av, bv, max_rounds=budget,
                               deliver_schedule=schedule)
        except TimeoutError:
            drive_aborts += 1
            for k in range(n_rec):
                op_id[0] += 1
                cur_ops[int(gs[k])].append(HOp(
                    op_id=op_id[0], op=labels[k], result=None,
                    invoke=base_round, complete=math.inf))
            nemesis.heal()
            driver.recover(settle_rounds=30)
            # fence and anchor: close every group's segment on an atomic
            # read of the state after recovery
            _anchor_reads(rg.rounds, close=True)
            continue
        for k in range(n_rec):
            op_id[0] += 1
            cur_ops[int(gs[k])].append(HOp(
                op_id=op_id[0], op=labels[k],
                result=int(res.results[k]),
                invoke=base_round + int(res.dispatch_round[k]),
                complete=base_round + int(res.resolve_round[k])))
        if epoch % 2 == 1:
            # atomic reads through the query lane; the window spans the
            # whole call, which only widens what the checker allows
            nemesis.heal()  # a static fault would starve the lease gate
            _anchor_reads(rg.rounds, close=False)
        if epoch % 10 == 9:
            _log(f"deep verdict: epoch {epoch + 1}/{epochs} "
                 f"rounds={rg.rounds} aborted={drive_aborts}")
    nemesis.heal()
    for g in sampled:
        segments[g].append((cur_init[g], cur_ops[g]))

    checked = failures = undecided = total_ops = nodes = incomplete = 0
    for g in sampled:
        checked += 1
        bad = und = False
        for init, seg in segments[g]:
            hist = sorted(seg, key=lambda h: (h.invoke, h.op_id))
            total_ops += len(hist)
            incomplete += sum(1 for h in hist if h.result is None)
            try:
                res = check_linearizable_windowed(hist, RegisterModel,
                                                  init_state=init)
            except RuntimeError as e:
                und = True
                _log(f"deep verdict: UNDECIDED group {g}: {e}")
                continue
            nodes += res.nodes
            if not res.ok:
                bad = True
                _log(f"deep verdict: VIOLATION group {g} "
                     f"(segment init={init}): {hist}")
        failures += bad
        undecided += und

    return {
        "linearizable": failures == 0 and undecided == 0,
        "groups": G,
        "sampled_groups": checked,
        "checked_ops": total_ops,
        "incomplete_ops": incomplete,
        "epochs": epochs,
        "aborted_drives": drive_aborts,
        "anchor_timeouts": anchor_timeouts,
        "undecided_groups": undecided,
        "violations": failures,
        "search_nodes": nodes,
        "wall_s": round(time.time() - t0, 1),
        "seed": seed,
        "device_telemetry": _telemetry_summary(rg),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m copycat_tpu_torch.testing.verdict",
        description="Linearizability verdict of the port's engine under "
                    "faults (sizes from the COPYCAT_VERDICT_* knobs).")
    parser.add_argument("--device", default=None,
                        help="device to run on (default: cuda)")
    args = parser.parse_args(argv)
    result = run_verdict(device=args.device)
    if knobs.get_bool("COPYCAT_VERDICT_DEEP"):
        deep = run_deep_verdict(device=args.device)
        result["deep_plane"] = deep
        result["linearizable"] = result["linearizable"] and \
            deep["linearizable"]
    print(json.dumps(result))
    if not result["linearizable"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
