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
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401

from copycat_tpu.models import BulkDriver as JaxBulkDriver  # noqa: E402
from copycat_tpu.ops import apply as ap  # noqa: E402

from copycat_tpu_torch.models import BulkDriver  # noqa: E402
from torch_reference import (  # noqa: E402
    DEEP_SHAPE,
    assert_same_state,
    deep_config,
    engine_pair,
    snapshot,
)

G = DEEP_SHAPE["groups"]


def _same_drive(a, b, what):
    assert a.rounds == b.rounds, what
    for name in ("results", "dispatch_round", "resolve_round"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=f"{what}: {name}")


def _drives(ref, port, scan, calls):
    """Run ``calls`` — ``(args, kwargs)`` of ``drive`` — on both engines;
    compare every drive and the engines after each."""
    drivers = (JaxBulkDriver(ref, deep_scan=scan),
               BulkDriver(port, deep_scan=scan))
    out = []
    for i, (args, kw) in enumerate(calls):
        a, b = (d.drive(*args, **kw) for d in drivers)
        _same_drive(a, b, f"drive {i}")
        assert_same_state(ref, port, f"after drive {i}")
        out.append(b)
    assert port.rounds == ref.rounds and port.events == ref.events
    if ref.config.monotone_tag_accept:
        np.testing.assert_array_equal(port._stream_count, ref._stream_count)
    assert snapshot(port.device_snapshot()) == snapshot(
        ref.device_snapshot())
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


@pytest.mark.parametrize("scan", [False, True], ids=["dispatch", "scan"])
def test_deep_drive_matches_reference(scan):
    ref, port = engine_pair(seed=11)
    res = _drives(ref, port, scan, _bursts())
    want = np.tile(np.cumsum(np.arange(1, 11)), G)
    np.testing.assert_array_equal(res[0].results, want)       # FIFO
    assert any(code == ap.EV_LOCK_GRANT and target == 2
               for _, code, target, _ in port.events.get(0, []))


def test_classic_drive_matches_reference():
    """The classic drive (host-enforced FIFO, one-round-behind harvest)
    on engines without the gate, with a queue-managed op in flight."""
    ref, port = engine_pair(seed=5, jcfg=deep_config(
        monotone_tag_accept=False))
    tags = [rg.submit(1, ap.OP_LONG_ADD, 500) for rg in (ref, port)]
    for rg in (ref, port):
        rg.step_round()
    res = _drives(ref, port, False, _bursts()[:3])
    for rg, t in zip((ref, port), tags):
        rg.run_until([t], max_rounds=10)
    assert tags[0] == tags[1] and port.results == ref.results
    assert port.results[tags[1]] >= 500
    assert_same_state(ref, port, "after the queue-managed op")
    assert (np.diff(res[0].results.reshape(G, 10), axis=1)
            == np.arange(2, 11)).all()                         # FIFO


def test_drive_queries_every_level():
    ref, port = engine_pair(seed=41)
    _drives(ref, port, False, [((np.repeat(np.arange(G), 10),
                                 ap.OP_LONG_ADD, 1), {})])
    reads = np.repeat(np.arange(G), 7)
    for level in ("sequential", "atomic", "causal", "process"):
        got = [BulkDriver(port).drive_queries(reads, ap.OP_VALUE_GET,
                                              consistency=level),
               JaxBulkDriver(ref).drive_queries(reads, ap.OP_VALUE_GET,
                                                consistency=level)]
        np.testing.assert_array_equal(got[0], got[1], err_msg=level)
        assert (got[0] == 10).all(), level
        assert port.rounds == ref.rounds
    assert_same_state(ref, port, "after the reads")
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
    ref, port = engine_pair(seed=29)
    cut = np.zeros((G, 3, 3), bool)
    g = np.repeat(np.arange(G), 10)
    drivers = (JaxBulkDriver(ref), BulkDriver(port))
    for d, dl in zip(drivers, (jax.numpy.asarray(cut), cut)):
        with pytest.raises(TimeoutError):
            d.drive(g, ap.OP_LONG_ADD, 1, max_rounds=12,
                    deliver_schedule=lambda r, dl=dl: dl)
    np.testing.assert_array_equal(port._stream_count, ref._stream_count)
    assert_same_state(ref, port, "abandoned")
    for d in drivers:
        d.recover(settle_rounds=10)
    np.testing.assert_array_equal(port._stream_count, ref._stream_count)
    res = _drives(ref, port, False, [((g, ap.OP_LONG_ADD, 1), {})])[0]
    assert (np.diff(res.results.reshape(G, 10), axis=1) == 1).all()


def test_monotone_engine_refuses_queue_managed_submits():
    ref, port = engine_pair(seed=23)
    for rg in (ref, port):
        with pytest.raises(NotImplementedError):
            rg.submit(0, ap.OP_LONG_ADD, 1)
        with pytest.raises(NotImplementedError):
            rg.submit_batch(np.arange(4), ap.OP_LONG_ADD, 1)
    _drives(ref, port, False, [((np.zeros(10, int), ap.OP_LONG_ADD, 7),
                                {})])
    # the query lane stays open; an unservable read retries as a query
    tags = [[rg.submit_query(0, ap.OP_VALUE_GET, consistency="atomic")
             for _ in range(3)] for rg in (ref, port)]
    for rg, t in zip((ref, port), tags):
        rg.run_until(t, max_rounds=60)
    assert tags[0] == tags[1] and port.results == ref.results
    assert [port.results[t] for t in tags[1]] == [70] * 3
    assert not port._queues
    assert_same_state(ref, port, "after the reads")
