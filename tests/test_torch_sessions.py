"""Device sessions of the torch port against the JAX reference.

The four scenarios of ``tests/test_device_sessions.py`` — a crashed lock
holder's lock passing to the next waiter, a crashed queued waiter being
dequeued, a crashed election leader's successor being promoted, and a
graceful close releasing at once — run on the reference's ``RaftGroups``
and on the port's (drawing the reference's timers), through the
reference's own lock and election facades, which drive any engine with
the same ``submit``/``run_until``/``events``/``sessions`` surface. Every
facade answer, every session's fate, the events, the results and the
final state must be equal. The reference's runs depend on nothing of the
port's: they run once, in a worker process started with the session's
first port file (``torch_reference.LONG_RUNS``), and come back to the
cases.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401

from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.models import sessions as jsessions  # noqa: E402
from copycat_tpu.models.device_resources import (  # noqa: E402
    DeviceElection,
    DeviceLock,
)
from copycat_tpu.ops.apply import OP_LOCK_ACQUIRE, ResourceConfig  # noqa
from copycat_tpu.ops.consensus import Config  # noqa: E402

from copycat_tpu_torch.models import sessions as tsessions  # noqa: E402
from torch_reference import (  # noqa: E402
    LONG_RUNS,
    SUITE_AHEAD,
    ReferenceDrawnGroups,
    assert_same_state,
    state_leaves,
)

G, P, L, S = 4, 3, 32, 4
# the pools the scenarios use (value, lock, election, events), so the
# reference's CPU compile stays short
JCFG = Config(resource=ResourceConfig(map_slots=0, set_slots=0,
                                      queue_slots=0, multimap_slots=0,
                                      topic_slots=0))


def crashed_holder(groups, expired, trace):
    s1 = groups.sessions.open_session()
    s2 = groups.sessions.open_session()
    holder = DeviceLock(groups, 0, session=s1)
    waiter = DeviceLock(groups, 0, session=s2)
    holder.lock()
    trace.append(waiter.try_lock())          # held: False
    waiter.lock()                            # s1 expires mid-wait
    trace.append(s1.expired)
    with pytest.raises(expired):
        holder.unlock()
    waiter.unlock()


def crashed_waiter(groups, expired, trace):
    s1 = groups.sessions.open_session()
    s2 = groups.sessions.open_session()
    s3 = groups.sessions.open_session()
    holder = DeviceLock(groups, 1, session=s1)
    dead_waiter = DeviceLock(groups, 1, session=s2)
    live_waiter = DeviceLock(groups, 1, session=s3)
    holder.lock()
    trace.append(dead_waiter._call(OP_LOCK_ACQUIRE, s2.id, -1))   # 2
    for _ in range(30):
        holder._touch()
        groups.step_round()
        s3.keep_alive()
    trace.append(s2.expired)
    holder.unlock()
    live_waiter.lock()
    live_waiter.unlock()


def crashed_leader(groups, expired, trace):
    s1 = groups.sessions.open_session()
    s2 = groups.sessions.open_session()
    e1 = DeviceElection(groups, 2, session=s1)
    e2 = DeviceElection(groups, 2, session=s2)
    epoch1 = e1.listen()
    trace += [epoch1, e2.listen()]
    epoch2 = None
    for _ in range(120):
        groups.step_round()
        s2.keep_alive()
        epoch2 = e2.poll_elected()
        if epoch2:
            break
    trace += [s1.expired, epoch2, e2.is_leader(epoch2),
              e2.is_leader(epoch1)]
    assert epoch2 and epoch2 != epoch1 and not trace[-1]


def graceful_close(groups, expired, trace):
    s1 = groups.sessions.open_session()
    s2 = groups.sessions.open_session()
    holder = DeviceLock(groups, 3, session=s1)
    waiter = DeviceLock(groups, 3, session=s2)
    holder.lock()
    trace.append(waiter.try_lock())
    s1.close()
    waiter.lock()
    waiter.unlock()
    with pytest.raises(expired):
        holder.lock()


SCENARIOS = [crashed_holder, crashed_waiter, crashed_leader, graceful_close]


def _run(groups, scenario, expired):
    groups.sessions.timeout_rounds = (10_000 if scenario is graceful_close
                                      else 25)
    groups.wait_for_leaders()
    trace = []
    scenario(groups, expired, trace)
    return trace


def _reference_runs() -> dict:
    """Every scenario on the reference's engine: its trace, rounds,
    events, results and final state leaves."""
    runs = {}
    for scenario in SCENARIOS:
        ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S, seed=7,
                            config=JCFG)
        trace = _run(ref, scenario, jsessions.SessionExpiredError)
        runs[scenario.__name__] = (trace, ref.rounds, ref.events,
                                   ref.results, state_leaves(ref))
    return runs


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_session_scenario_matches_reference(scenario):
    want, rounds, events, results, leaves = SUITE_AHEAD.get(
        "sessions", _reference_runs)[scenario.__name__]
    port = ReferenceDrawnGroups(G, P, L, S, JCFG, seed=7)
    got = _run(port, scenario, tsessions.SessionExpiredError)
    assert got == want
    assert port.rounds == rounds
    assert port.events == events
    assert port.results == results
    assert_same_state(leaves, port, "end")


LONG_RUNS[f"{os.path.basename(__file__)}::"
          "test_session_scenario_matches_reference"] = [
    ("sessions", _reference_runs, ())]
