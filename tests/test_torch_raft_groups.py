"""The torch ``RaftGroups`` against the JAX reference's ``RaftGroups``.

One request sequence — single submits and batches of ``OP_LONG_ADD`` —
goes to both engines under one partition schedule that isolates each
group's leader for a stretch of rounds, so ops accepted by a deposed
leader are lost and re-submitted. With the reference's timer draws fed
to the port, both engines must agree on every state leaf after every
round; with the port's own generator they must still agree on every
result. Exactly-once holds: each group's results are the prefix sums of
its deltas in submission order, and its final value their total.

A second stream drives every pool under the reference's default
``Config()``: lock and election chains (whose hand-offs arrive as
events), map, queue, set and topic ops. Both engines must give equal
state every round, equal results and equal ``events``; the port's
``RaftGroups()`` defaults to that config.

Each reference side depends on nothing of the port's: it runs once, in a
worker process started with the session's first port file
(``torch_reference.LONG_RUNS``), and records its partition masks and
everything the port's run is then held against, round by round
(``torch_reference.Transcript``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import (  # noqa: E402,F401
    LONG_RUNS,
    SUITE_AHEAD,
    Transcript,
    release_jax_programs,
    state_leaves,
)

from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.ops import apply as jap  # noqa: E402
from copycat_tpu.ops.consensus import Config as JaxConfig  # noqa: E402

import torch_reference  # noqa: E402
from copycat_tpu_torch.models import RaftGroups  # noqa: E402

G, P, L, S = 16, 3, 16, 4
JCFG = JaxConfig(resource=jap.ResourceConfig.counters_only())


class ReferenceDrawnGroups(torch_reference.ReferenceDrawnGroups):
    """The port's engine drawing its election timers exactly as the
    reference's ``RaftGroups`` does from the same seed."""

    def __init__(self, seed=0, jcfg=JCFG):
        super().__init__(G, P, L, S, jcfg, seed=seed)


def _isolate(victims):
    hit = np.arange(P)[None, :] == victims[:, None]
    return ~(hit[:, :, None] | hit[:, None, :]) | (victims < 0)[:, None, None]


def _partition(rg, r, check):
    """The partition schedule: every group's leader isolated in rounds
    5-12 and 20-27, the leaders as the reference's run found them."""
    if r in (5, 20):
        mask = check.given(_isolate(np.asarray(
            [rg.leader(g) for g in range(G)])))
    elif r in (13, 28):
        mask = np.ones((G, P, P), bool)
    else:
        return
    rg.deliver = (jax.numpy.asarray(mask) if isinstance(rg, JaxRaftGroups)
                  else torch.from_numpy(mask))


def _drive(rg, check, compare_state):
    """Submit the request sequence to ``rg`` and step it under the
    partition schedule; ``check`` sees the tags, the state every round
    (with ``compare_state``) and the results. Returns the (group, delta,
    tag) log of what was submitted."""
    rng = np.random.default_rng(3)
    rg.wait_for_leaders()
    submitted = []
    for r in range(60):
        if r < 30:
            if r % 2:
                g = rng.integers(0, G, 6)
                d = rng.integers(1, 9, 6)
                tags = list(rg.submit_batch(g, jap.OP_LONG_ADD, d))
            else:
                g = rng.integers(0, G, 3)
                d = rng.integers(1, 9, 3)
                tags = [rg.submit(int(gi), jap.OP_LONG_ADD, int(di))
                        for gi, di in zip(g, d)]
            check(tags, f"tags round {r}")
            submitted += list(zip(g.tolist(), d.tolist(), tags))
        _partition(rg, r, check)
        rg.step_round()
        if compare_state:
            check(state_leaves(rg), f"round {r}")
    rg.run_until([t for _, _, t in submitted], max_rounds=300)
    check(dict(rg.results), "results")
    return submitted


def _check_exactly_once(rg, submitted):
    totals = {}
    for g, d, tag in submitted:
        totals[g] = totals.get(g, 0) + d
        assert rg.results[tag] == totals[g], (g, tag)
    for g in range(G):
        assert (rg.state.resources.value[g] == totals.get(g, 0)).all()


def _reference_drive(compare_state: bool) -> list:
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S, config=JCFG)
    check = Transcript()
    _check_exactly_once(ref, _drive(ref, check, compare_state))
    return check.values


def test_same_draws_give_the_same_state_every_round():
    port = ReferenceDrawnGroups()
    check = Transcript(SUITE_AHEAD.get("raft_groups", _reference_runs)[
        "same draws"])
    submitted = _drive(port, check, compare_state=True)
    check.done()
    assert port.metrics.counter("ops_resubmitted").value > 0, \
        "no op was lost and retried"
    _check_exactly_once(port, submitted)


def test_own_generator_gives_the_same_results():
    port = RaftGroups(G, P, log_slots=L, submit_slots=S, seed=5,
                      device="cpu")
    check = Transcript(SUITE_AHEAD.get("raft_groups", _reference_runs)[
        "own generator"])
    submitted = _drive(port, check, compare_state=False)
    check.done()
    _check_exactly_once(port, submitted)


def test_membership_opcodes_are_refused():
    rg = RaftGroups(2, 3, device="cpu")
    with pytest.raises(ValueError, match="dynamic_membership"):
        rg.submit(0, jap.OP_CFG_ADD, 1)
    with pytest.raises(ValueError, match="dynamic_membership"):
        rg.submit_batch([0], jap.OP_CFG_REMOVE, 1)


# (opcode, a, b) chains, each submitted to one group in one go
_CHAINS = (
    # lock: 1 takes it, 2 queues forever, release(1) hands it to 2
    # (EV_LOCK_GRANT), release(2) frees it
    ((jap.OP_LOCK_ACQUIRE, 1, -1), (jap.OP_LOCK_ACQUIRE, 2, -1),
     (jap.OP_LOCK_RELEASE, 1, 0), (jap.OP_LOCK_HOLDER, 0, 0),
     (jap.OP_LOCK_RELEASE, 2, 0)),
    # election: 4 wins, 5 listens, 4 resigns (EV_ELECT to 5 with the epoch)
    ((jap.OP_ELECT_LISTEN, 4, 0), (jap.OP_ELECT_LISTEN, 5, 0),
     (jap.OP_ELECT_RESIGN, 4, 0), (jap.OP_ELECT_LEADER, 0, 0),
     (jap.OP_ELECT_RESIGN, 5, 0)),
    ((jap.OP_MAP_PUT, 3, 30), (jap.OP_MAP_GET, 3, 0),
     (jap.OP_MAP_PUT_IF_ABSENT, 3, 31), (jap.OP_MAP_REMOVE, 3, 0)),
    ((jap.OP_Q_OFFER, 7, 0), (jap.OP_Q_OFFER, 8, 0), (jap.OP_Q_POLL, 0, 0),
     (jap.OP_Q_SIZE, 0, 0)),
    ((jap.OP_SET_ADD, 5, 0), (jap.OP_SET_CONTAINS, 5, 0),
     (jap.OP_SET_REMOVE, 5, 0)),
    ((jap.OP_TOPIC_LISTEN, 6, 0), (jap.OP_TOPIC_PUB, 77, 0),
     (jap.OP_TOPIC_UNLISTEN, 6, 0)),
    ((jap.OP_LONG_ADD, 2, 0), (jap.OP_VALUE_GET, 0, 0)),
)


def _all_pool_stream(rg, check):
    """Chains over every pool, three groups a round for 30 rounds under
    the partition schedule; ``check`` sees the tags, the state every
    round and at the end, the results and the events."""
    rg.wait_for_leaders()
    rng = np.random.default_rng(4)
    tags = []
    for r in range(40):
        if r < 30:
            for g in rng.choice(G, 3, replace=False).tolist():
                chain = np.asarray(_CHAINS[rng.integers(len(_CHAINS))])
                if r % 2:
                    got = list(rg.submit_batch(np.full(len(chain), g),
                                               chain[:, 0], chain[:, 1],
                                               chain[:, 2]))
                else:
                    got = [rg.submit(g, *map(int, op)) for op in chain]
                tags += check(got, f"tags round {r}")
        _partition(rg, r, check)
        rg.step_round()
        check(state_leaves(rg), f"round {r}")
    rg.run_until(tags, max_rounds=300)
    rg.run(4)      # followers apply the last commit; events drain
    check(state_leaves(rg), "end")
    check(dict(rg.results), "results")
    check(dict(rg.events), "events")


def _reference_all_pools() -> list:
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S,
                        config=JaxConfig())
    check = Transcript()
    _all_pool_stream(ref, check)
    return check.values


def test_all_pool_stream_gives_the_same_results_and_events():
    jcfg = JaxConfig()
    port = ReferenceDrawnGroups(jcfg=jcfg)
    assert RaftGroups(G, P, device="cpu").config == port.config._replace(
        ring_flow_control=True)
    check = Transcript(SUITE_AHEAD.get("raft_groups", _reference_runs)[
        "all pools"])
    _all_pool_stream(port, check)
    check.done()
    codes = {e[1] for evs in port.events.values() for e in evs}
    assert codes == {jap.EV_LOCK_GRANT, jap.EV_ELECT, jap.EV_TOPIC_MSG}


def _vector_and_rounds(rg, check):
    """``drive_vector`` on every group, then ``step_rounds(8)`` and
    ``step_rounds(1)`` after batches; ``check`` sees the answers, the
    state after each, the rounds and the results."""
    rg.wait_for_leaders()
    rng = np.random.default_rng(8)
    g = np.repeat(np.arange(G), rng.integers(0, S + 1, G))
    d = rng.integers(1, 50, g.size)
    z = np.zeros_like(g)
    got = check(np.asarray(rg.drive_vector(g, z + jap.OP_LONG_ADD, d, z,
                                           z)).tolist(), "drive_vector")
    check(state_leaves(rg), "after drive_vector")
    for n in (8, 1):
        rows = rng.integers(0, G, 10)
        tags = check(list(rg.submit_batch(rows, jap.OP_LONG_ADD, 1)),
                     "tags")
        rg.step_rounds(n)
        check(rg.rounds, f"rounds after step_rounds({n})")
        check(state_leaves(rg), f"after step_rounds({n})")
    rg.run(2)
    check(dict(rg.results), "results")
    return g, d, got, tags


def _reference_vector_and_rounds() -> list:
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S, config=JCFG)
    check = Transcript()
    _vector_and_rounds(ref, check)
    return check.values


def test_drive_vector_and_step_rounds_match_reference():
    """``drive_vector`` returns the reference's results (each group's
    prefix sums, correlated from the step outputs), and ``step_rounds(n)``
    — n rounds, one fetch, the draws taken as the reference's fused
    program takes them — leaves the reference's state, results and round
    count."""
    port = ReferenceDrawnGroups()
    check = Transcript(SUITE_AHEAD.get("raft_groups", _reference_runs)[
        "vector"])
    g, d, got, tags = _vector_and_rounds(port, check)
    check.done()
    totals = np.zeros(G, np.int64)
    for i, (gi, di) in enumerate(zip(g, d)):
        totals[gi] += di
        assert got[i] == totals[gi]
    assert all(t in port.results for t in tags)


def _reference_runs() -> dict:
    """Every case's reference side, in one worker: they share the
    reference's compiled programs."""
    return {"same draws": _reference_drive(True),
            "own generator": _reference_drive(False),
            "all pools": _reference_all_pools(),
            "vector": _reference_vector_and_rounds()}


LONG_RUNS.update({f"{os.path.basename(__file__)}::{test}": [
    ("raft_groups", _reference_runs, ())] for test in (
        "test_same_draws_give_the_same_state_every_round",
        "test_own_generator_gives_the_same_results",
        "test_all_pool_stream_gives_the_same_results_and_events",
        "test_drive_vector_and_step_rounds_match_reference")})
