"""``models/bulk.py`` of the torch port against the JAX reference.

The port's ``BulkDriver`` drives a ``ReferenceDrawnGroups`` engine (the
reference's timer draws) beside the reference's ``BulkDriver`` on the
reference's ``RaftGroups`` from the same seed: the classic drive, the
deep drive (per-round dispatch) and the deep drive through ``deep_scan``
must give equal results, rounds, dispatch and resolve rounds, stream
cursors, events, telemetry snapshots and state leaves. Also:
``drive_queries`` at every level, a ``deliver_schedule`` fault that
abandons a drive with ``TimeoutError`` followed by ``recover``, and
queue-managed submits refused on a monotone engine (queries allowed).
Scripts after ``tests/test_bulk_driver.py`` and
``tests/test_monotone_deep.py``; exact, integers only.

Each script's reference side depends on nothing of the port's: it runs
once, in a worker process started with the session's first port file
(``torch_reference.LONG_RUNS``), and records what the port's run of the
same script is then held against, drive by drive
(``torch_reference.Transcript``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401

from copycat_tpu.models import BulkDriver as JaxBulkDriver  # noqa: E402
from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.ops import apply as ap  # noqa: E402

from copycat_tpu_torch.models import BulkDriver  # noqa: E402
from torch_reference import (  # noqa: E402
    DEEP_SHAPE,
    LONG_RUNS,
    SUITE_AHEAD,
    Transcript,
    deep_config,
    port_engine,
    reference_engine,
    snapshot,
    state_leaves,
)

G = DEEP_SHAPE["groups"]


def _driver(rg):
    return JaxBulkDriver if isinstance(rg, JaxRaftGroups) else BulkDriver


def _deliver(rg, mask):
    return jax.numpy.asarray(mask) if isinstance(rg, JaxRaftGroups) else mask


def _drives(rg, check, scan, calls):
    """Run ``calls`` — ``(args, kwargs)`` of ``drive`` — on ``rg``;
    ``check`` sees every drive and the engine after each."""
    driver = _driver(rg)(rg, deep_scan=scan)
    out = []
    for i, (args, kw) in enumerate(calls):
        d = driver.drive(*args, **kw)
        check({"rounds": d.rounds, **{
            name: np.asarray(getattr(d, name)).tolist()
            for name in ("results", "dispatch_round", "resolve_round")}},
            f"drive {i}")
        check(state_leaves(rg), f"after drive {i}")
        out.append(d)
    check((rg.rounds, rg.events), "rounds and events")
    if rg.config.monotone_tag_accept:
        check(np.asarray(rg._stream_count).tolist(), "stream cursors")
    check(snapshot(rg.device_snapshot()), "telemetry")
    return out


def _bursts():
    """Dense bursts, uneven per-group counts, mixed payloads and a lock
    chain whose grant rides the event ring; 9-12 ops in the busiest
    group, so every drive has the same blind-phase shape."""
    g = np.repeat(np.arange(G), 10)
    amounts = np.tile(np.arange(1, 11), G)
    ragged = np.concatenate([np.full(i + 3, i) for i in range(G)])
    ops = np.where(np.arange(g.size) % 2 == 0, ap.OP_LONG_ADD,
                   ap.OP_VALUE_GET)
    lock = [ap.OP_LOCK_ACQUIRE, ap.OP_LOCK_ACQUIRE, ap.OP_LOCK_RELEASE]
    return [((g, ap.OP_LONG_ADD, amounts), {}),
            ((g, ap.OP_LONG_ADD, 1), {}),
            ((ragged, ap.OP_LONG_ADD, 1), {}),
            ((g, ops, 2), {}),
            (([0] * 9, lock + [ap.OP_VALUE_GET] * 6, [1, 2, 1] + [0] * 6,
              [0, -1, 0] + [0] * 6), {})]


def deep_drive(rg, check, scan):
    return _drives(rg, check, scan, _bursts())


def classic_drive(rg, check):
    tag = check(rg.submit(1, ap.OP_LONG_ADD, 500), "tag")
    rg.step_round()
    res = _drives(rg, check, False, _bursts()[:3])
    rg.run_until([tag], max_rounds=10)
    check(dict(rg.results), "results")
    check(state_leaves(rg), "after the queue-managed op")
    return tag, res


def drive_queries(rg, check):
    _drives(rg, check, False, [((np.repeat(np.arange(G), 10),
                                 ap.OP_LONG_ADD, 1), {})])
    reads = np.repeat(np.arange(G), 7)
    for level in ("sequential", "atomic", "causal", "process"):
        got = _driver(rg)(rg).drive_queries(reads, ap.OP_VALUE_GET,
                                            consistency=level)
        check(np.asarray(got).tolist(), level)
        assert (np.asarray(got) == 10).all(), level
        check(rg.rounds, f"rounds after {level}")
    check(state_leaves(rg), "after the reads")
    return reads


def fault_then_recover(rg, check):
    cut = np.zeros((G, 3, 3), bool)
    g = np.repeat(np.arange(G), 10)
    driver = _driver(rg)(rg)
    dl = _deliver(rg, cut)
    with pytest.raises(TimeoutError):
        driver.drive(g, ap.OP_LONG_ADD, 1, max_rounds=12,
                     deliver_schedule=lambda r: dl)
    check(np.asarray(rg._stream_count).tolist(), "abandoned cursors")
    check(state_leaves(rg), "abandoned")
    driver.recover(settle_rounds=10)
    check(np.asarray(rg._stream_count).tolist(), "recovered cursors")
    return _drives(rg, check, False, [((g, ap.OP_LONG_ADD, 1), {})])[0]


def monotone_refuses(rg, check):
    with pytest.raises(NotImplementedError):
        rg.submit(0, ap.OP_LONG_ADD, 1)
    with pytest.raises(NotImplementedError):
        rg.submit_batch(np.arange(4), ap.OP_LONG_ADD, 1)
    _drives(rg, check, False, [((np.zeros(10, int), ap.OP_LONG_ADD, 7),
                                {})])
    # the query lane stays open; an unservable read retries as a query
    tags = check([rg.submit_query(0, ap.OP_VALUE_GET, consistency="atomic")
                  for _ in range(3)], "query tags")
    rg.run_until(tags, max_rounds=60)
    check(dict(rg.results), "results")
    check(state_leaves(rg), "after the reads")
    return tags


# name -> (seed, monotone engine, script arguments)
CASES = {"deep_dispatch": (11, True, ("deep_drive", False)),
         "deep_scan": (11, True, ("deep_drive", True)),
         "classic": (5, False, ("classic_drive",)),
         "queries": (41, True, ("drive_queries",)),
         "fault": (29, True, ("fault_then_recover",)),
         "monotone": (23, True, ("monotone_refuses",))}


def _reference_case(case: str) -> list:
    """The reference's side of ``case``: the state once its leaders are
    elected, then what its script shows."""
    seed, monotone, (script, *args) = CASES[case]
    ref = reference_engine(seed, deep_config(monotone_tag_accept=monotone))
    check = Transcript()
    check(state_leaves(ref), "leaders elected")
    globals()[script](ref, check, *args)
    return check.values


def _port_case(case: str):
    """The port's side of ``case``, held against the reference's record;
    returns the port's engine and what its script returned."""
    seed, monotone, (script, *args) = CASES[case]
    check = Transcript(SUITE_AHEAD.get("bulk", _reference_cases)[case])
    port = port_engine(seed, deep_config(monotone_tag_accept=monotone))
    check(state_leaves(port), "leaders elected")
    out = globals()[script](port, check, *args)
    check.done()
    return port, out


@pytest.mark.parametrize("scan", [False, True], ids=["dispatch", "scan"])
def test_deep_drive_matches_reference(scan):
    port, res = _port_case("deep_scan" if scan else "deep_dispatch")
    want = np.tile(np.cumsum(np.arange(1, 11)), G)
    np.testing.assert_array_equal(res[0].results, want)       # FIFO
    assert any(code == ap.EV_LOCK_GRANT and target == 2
               for _, code, target, _ in port.events.get(0, []))


def test_classic_drive_matches_reference():
    """The classic drive (host-enforced FIFO, one-round-behind harvest)
    on engines without the gate, with a queue-managed op in flight."""
    port, (tag, res) = _port_case("classic")
    assert port.results[tag] >= 500
    assert (np.diff(res[0].results.reshape(G, 10), axis=1)
            == np.arange(2, 11)).all()                         # FIFO


def test_drive_queries_every_level():
    port, reads = _port_case("queries")
    with pytest.raises(ValueError):
        BulkDriver(port).drive_queries(reads, ap.OP_LONG_ADD, 1)
    with pytest.raises(ValueError):
        BulkDriver(port).drive_queries(reads, ap.OP_VALUE_GET,
                                       consistency="nope")


def test_fault_abandons_drive_then_recover():
    """Delivery cut for every round of a drive: both drives raise
    ``TimeoutError`` with the stream cursors resynced; after the heal,
    ``recover`` and a fresh drive agree, and each group's new ops apply
    once, in order."""
    _, res = _port_case("fault")
    assert (np.diff(res.results.reshape(G, 10), axis=1) == 1).all()


def test_monotone_engine_refuses_queue_managed_submits():
    port, tags = _port_case("monotone")
    assert [port.results[t] for t in tags] == [70] * 3
    assert not port._queues


def _reference_cases() -> dict:
    """Every case's reference side, in one worker: they share the
    reference's compiled programs."""
    return {case: _reference_case(case) for case in CASES}


LONG_RUNS.update({f"{os.path.basename(__file__)}::{test}": [
    ("bulk", _reference_cases, ())] for test in (
        "test_deep_drive_matches_reference",
        "test_classic_drive_matches_reference",
        "test_drive_queries_every_level",
        "test_fault_abandons_drive_then_recover",
        "test_monotone_engine_refuses_queue_managed_submits")})
