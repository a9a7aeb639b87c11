"""``models/session_client.py`` of the torch port against the JAX reference.

The scenarios of ``tests/test_session_client.py`` run through both
packages — the reference's ``BulkSessionClient`` on its ``RaftGroups``
and the port's on a ``ReferenceDrawnGroups`` engine from the same seed,
both monotone (deep drives): exactly-once FIFO with the result cache,
interleaved sessions on one group, reads at every consistency level, the
edge cache serving causal reads without an engine round, lock events and
the expiry fan-out through the log, a graceful close, and an abandoned
flush followed by ``recover``. Each scenario's trace of answers, and the
engines' rounds, events, metric counters and state leaves, must be equal;
exact, integers only.

Each scenario's reference side depends on nothing of the port's: it runs
once, in a worker process started with the session's first port file
(``torch_reference.LONG_RUNS``), and its trace and end state come back to
the case, which runs the port's side and compares.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401

from copycat_tpu.models import session_client as jclient  # noqa: E402
from copycat_tpu.models import sessions as jsessions  # noqa: E402
from copycat_tpu.ops import apply as ap  # noqa: E402

from copycat_tpu_torch.models import session_client as tclient  # noqa: E402
from copycat_tpu_torch.models import sessions as tsessions  # noqa: E402
from torch_reference import (  # noqa: E402
    DEEP_SHAPE,
    LONG_RUNS,
    SUITE_AHEAD,
    assert_same_state,
    counters,
    deep_config,
    port_engine,
    reference_engine,
    state_leaves,
)

G, P = DEEP_SHAPE["groups"], DEEP_SHAPE["peers"]


class Package:
    """One package's client module and errors."""

    def __init__(self, client, sessions):
        self.client = client.BulkSessionClient
        self.indeterminate = client.CommandIndeterminateError
        self.expired = sessions.SessionExpiredError


REF = Package(jclient, jsessions)
PORT = Package(tclient, tsessions)


def exactly_once_fifo(rg, pkg, trace):
    client = pkg.client(rg)
    s = client.open_session()
    seqs = s.submit_batch([0] * 10, ap.OP_LONG_ADD, 1)
    extra = s.submit(0, ap.OP_VALUE_GET)
    trace.append(client.flush())
    trace.append(s.results_window(int(seqs[0]), 10).tolist())
    trace.append(s.result(extra))
    trace.append(s.result(extra))          # the cache re-correlates
    trace.append(client.flush())           # nothing pending
    check = s.submit(0, ap.OP_VALUE_GET)
    client.flush()
    trace.append(s.result(check))
    assert trace == [11, list(range(1, 11)), 10, 10, 0, 10]


def interleaved_sessions(rg, pkg, trace):
    client = pkg.client(rg)
    s1, s2 = client.open_session(), client.open_session()
    a = s1.submit_batch([1] * 5, ap.OP_LONG_ADD, 10)
    b = s2.submit_batch([1] * 5, ap.OP_LONG_ADD, 1)
    client.flush()
    read = s1.submit(1, ap.OP_VALUE_GET)
    client.flush()
    trace += [s1.result(read), s1.results_window(int(a[0]), 5).tolist(),
              s2.results_window(int(b[0]), 5).tolist()]
    assert trace[0] == 55
    assert all(np.diff(trace[1]) == 10) and all(np.diff(trace[2]) == 1)


def reads_at_every_level(rg, pkg, trace):
    client = pkg.client(rg)
    s = client.open_session()
    s.submit_batch([2, 2, 2], ap.OP_LONG_ADD, 7)
    client.flush()
    for level in ("atomic", "none", "causal", "process", "sequential",
                  "bounded_linearizable", "linearizable"):
        trace.append(s.query_batch([2] * 3, ap.OP_VALUE_GET,
                                   consistency=level).tolist())
    with pytest.raises(ValueError, match="unknown read consistency"):
        s.query_batch([2], ap.OP_VALUE_GET, consistency="nope")
    assert trace == [[21] * 3] * 7


def edge_cache(rg, pkg, trace):
    client = pkg.client(rg)
    s = client.open_session()
    g = 5
    s.submit(g, ap.OP_LONG_ADD, 4)
    client.flush()
    trace.append(s.query_batch([g], ap.OP_VALUE_GET,
                               consistency="causal").tolist())
    for opcode, a, b in ((ap.OP_LONG_ADD, 3, 0), (ap.OP_VALUE_SET, 9, 0),
                         (ap.OP_VALUE_CAS, 9, 12), (ap.OP_VALUE_CAS, 9, 99),
                         (ap.OP_VALUE_GET_AND_SET, 20, 0)):
        s.submit(g, opcode, a, b)
        client.flush()
        rounds = rg.rounds
        local = s.query_batch([g] * 3, ap.OP_VALUE_GET, consistency="causal")
        assert rg.rounds == rounds, "a causal read drove rounds"
        engine = s.query_batch([g], ap.OP_VALUE_GET,
                               consistency="sequential")
        trace.append((local.tolist(), engine.tolist()))
    edge = client._edge
    trace.append((edge._m_serves.value, edge._m_fallbacks.value,
                  edge._m_merges.value))
    assert [x[0][0] for x in trace[1:6]] == [7, 9, 12, 12, 20]
    assert all(x[0] == x[1] * 3 for x in trace[1:6])


def lock_events_and_expiry(rg, pkg, trace):
    """A dead session's lock passes to the waiter through the log (its
    cleanup rides a later flush), and the grant event reaches the
    waiter's listener."""
    client = pkg.client(rg)
    rg.sessions.timeout_rounds = 20
    g = 3
    holder, waiter = client.open_session(), client.open_session()
    got = []
    waiter.on_event(g, lambda ev: got.append(tuple(ev)))
    t1 = holder.lock_acquire(g)
    client.flush()
    t2 = waiter.lock_acquire(g)
    client.flush()
    trace += [holder.result(t1), waiter.result(t2)]
    client._sessions.pop(holder.id)          # the holder stops flushing
    for _ in range(12):
        waiter.submit_batch([7] * 8, ap.OP_LONG_ADD, 1)
        client.flush()
        q = waiter.submit(g, ap.OP_LOCK_HOLDER)
        client.flush()
        trace.append(waiter.result(q))
        if trace[-1] == waiter.id:
            break
    trace.append(got)
    with pytest.raises(pkg.expired):
        holder.submit(g, ap.OP_VALUE_GET)
    assert trace[:2] == [1, 2] and trace[-2] == waiter.id
    assert any(code == ap.EV_LOCK_GRANT and target == waiter.id
               for _, _, code, target, _ in got)


def graceful_close(rg, pkg, trace):
    client = pkg.client(rg)
    g = 4
    a, b = client.open_session(), client.open_session()
    a.lock_acquire(g)
    b.lock_acquire(g)
    client.flush()
    a.close()
    client.flush()                           # commits the release fan-out
    q = b.submit(g, ap.OP_LOCK_HOLDER)
    client.close()
    trace.append(b.result(q) == b.id)
    assert trace == [True]


def abandoned_flush_then_recover(rg, pkg, trace):
    client = pkg.client(rg)
    s = client.open_session()
    base = s.submit(0, ap.OP_LONG_ADD, 1)
    client.flush()
    trace.append(s.result(base))
    full = rg.deliver
    rg.deliver = full & False                # nothing can commit
    seqs = s.submit_batch([0] * 4, ap.OP_LONG_ADD, 1)
    with pytest.raises(TimeoutError):
        client.flush(max_rounds=40)
    with pytest.raises(pkg.indeterminate):
        s.result(int(seqs[0]))
    rg.deliver = full
    client.recover(settle_rounds=10)
    q = s.submit(0, ap.OP_VALUE_GET)
    client.flush()
    val = s.result(q)
    t = s.submit(0, ap.OP_LONG_ADD, 10)
    client.flush()
    trace += [val, s.result(t)]
    assert 1 <= val <= 5 and trace[-1] == val + 10


def engine_end(rg) -> tuple:
    """What a case holds equal at its end: rounds, events,
    metric counters and state leaves."""
    return rg.rounds, rg.events, counters(rg), state_leaves(rg)


def assert_same_end(want, port, what="end"):
    """The port's engine ended as the reference's did (``want``, its
    :func:`engine_end`)."""
    rounds, events, counts, leaves = want
    assert port.rounds == rounds and port.events == events, what
    assert counters(port) == counts, what
    assert_same_state(leaves, port, what)


SCENARIOS = [exactly_once_fifo, interleaved_sessions, reads_at_every_level,
             edge_cache, lock_events_and_expiry, graceful_close,
             abandoned_flush_then_recover]
CLASSIC = dict(seed=3, monotone=False)


def _reference_run(name: str, seed: int = 11, monotone: bool = True):
    """The reference's side of one scenario: its engine's state when the
    leaders are elected, the scenario's trace, and the engine's end."""
    ref = reference_engine(seed, deep_config(monotone_tag_accept=monotone))
    elected = state_leaves(ref)
    trace = []
    globals()[name](ref, REF, trace)
    return elected, trace, engine_end(ref)


def _port_matches(name: str, seed: int = 11, monotone: bool = True):
    elected, want, end = SUITE_AHEAD.get("session_client",
                                         _reference_runs)[name]
    port = port_engine(seed, deep_config(monotone_tag_accept=monotone))
    assert_same_state(elected, port, "leaders elected")
    trace = []
    globals()[name](port, PORT, trace)
    assert trace == want
    assert_same_end(end, port)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_session_client_scenario_matches_reference(scenario):
    _port_matches(scenario.__name__)


def classic_engine(rg, pkg, trace):
    """``tests/test_session_client.py::test_classic_engine_compat``: the
    client contract on an engine without the monotone gate — the classic
    bulk drive, cleanup through the queue-managed path."""
    client = pkg.client(rg)
    s = client.open_session()
    seqs = s.submit_batch([0] * 6, ap.OP_LONG_ADD, 2)
    client.flush()
    trace.append(s.results_window(int(seqs[0]), 6).tolist())
    t = s.lock_acquire(1)
    client.flush()
    trace.append(s.result(t))
    s.close()                                 # the release rides the queue
    client.flush()
    s2 = client.open_session()
    t2 = s2.lock_acquire(1)
    client.flush()
    trace.append(s2.result(t2))
    assert trace == [[2, 4, 6, 8, 10, 12], 1, 1]


def test_classic_engine_matches_reference():
    _port_matches("classic_engine", **CLASSIC)


def _reference_runs() -> dict:
    """Every scenario's reference side, in one worker: they share the
    reference's compiled programs."""
    runs = {f.__name__: _reference_run(f.__name__) for f in SCENARIOS}
    runs["classic_engine"] = _reference_run("classic_engine", **CLASSIC)
    return runs


LONG_RUNS.update({f"{os.path.basename(__file__)}::{test}": [
    ("session_client", _reference_runs, ())] for test in (
        "test_session_client_scenario_matches_reference",
        "test_classic_engine_matches_reference")})
