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
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.ops import apply as jap  # noqa: E402
from copycat_tpu.ops.consensus import Config as JaxConfig  # noqa: E402

import torch_reference  # noqa: E402
from copycat_tpu_torch import convert  # noqa: E402
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


def _partition(engines, r):
    """The partition schedule: every group's leader isolated in rounds
    5-12 and 20-27."""
    if r in (5, 20):
        mask = _isolate(np.asarray([engines[0].leader(g) for g in range(G)]))
    elif r in (13, 28):
        mask = np.ones((G, P, P), bool)
    else:
        return
    engines[0].deliver = jax.numpy.asarray(mask)
    for rg in engines[1:]:
        rg.deliver = torch.from_numpy(mask)


def _same_state(engines, r):
    want = convert.flat_leaves(engines[0].state)
    for rg in engines[1:]:
        got = convert.flat_leaves(rg.state)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w,
                                          err_msg=f"{name} round {r}")


def _drive(engines, compare_state):
    """Submit the same sequence to every engine, step them in lockstep
    under the partition schedule, and return each engine's results plus
    the (group, delta, tag) log of what was submitted."""
    rng = np.random.default_rng(3)
    for rg in engines:
        rg.wait_for_leaders()
    submitted = []
    for r in range(60):
        if r < 30:
            if r % 2:
                g = rng.integers(0, G, 6)
                d = rng.integers(1, 9, 6)
                tags = [rg.submit_batch(g, jap.OP_LONG_ADD, d)
                        for rg in engines]
            else:
                g = rng.integers(0, G, 3)
                d = rng.integers(1, 9, 3)
                tags = [[rg.submit(int(gi), jap.OP_LONG_ADD, int(di))
                         for gi, di in zip(g, d)] for rg in engines]
            for t in tags[1:]:
                assert list(t) == list(tags[0])
            submitted += list(zip(g.tolist(), d.tolist(), list(tags[0])))
        _partition(engines, r)
        for rg in engines:
            rg.step_round()
        if compare_state:
            _same_state(engines, r)
    tags = [t for _, _, t in submitted]
    for rg in engines:
        rg.run_until(tags, max_rounds=300)
    return submitted


def _check_exactly_once(rg, submitted):
    totals = {}
    for g, d, tag in submitted:
        totals[g] = totals.get(g, 0) + d
        assert rg.results[tag] == totals[g], (g, tag)
    for g in range(G):
        assert (rg.state.resources.value[g] == totals.get(g, 0)).all()


def test_same_draws_give_the_same_state_every_round():
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S, config=JCFG)
    port = ReferenceDrawnGroups()
    submitted = _drive([ref, port], compare_state=True)
    assert port.results == ref.results
    assert port.counters["ops_resubmitted"] > 0, "no op was lost and retried"
    _check_exactly_once(port, submitted)
    _check_exactly_once(ref, submitted)


def test_own_generator_gives_the_same_results():
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S, config=JCFG)
    port = RaftGroups(G, P, log_slots=L, submit_slots=S, seed=5,
                      device="cpu")
    submitted = _drive([ref, port], compare_state=False)
    assert port.results == ref.results
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


def test_all_pool_stream_gives_the_same_results_and_events():
    jcfg = JaxConfig()
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S, config=jcfg)
    port = ReferenceDrawnGroups(jcfg=jcfg)
    assert RaftGroups(G, P, device="cpu").config == port.config._replace(
        ring_flow_control=True)
    engines = [ref, port]
    for rg in engines:
        rg.wait_for_leaders()
    rng = np.random.default_rng(4)
    tags = []
    for r in range(40):
        if r < 30:
            for g in rng.choice(G, 3, replace=False).tolist():
                chain = np.asarray(_CHAINS[rng.integers(len(_CHAINS))])
                if r % 2:
                    got = [list(rg.submit_batch(np.full(len(chain), g),
                                                chain[:, 0], chain[:, 1],
                                                chain[:, 2]))
                           for rg in engines]
                else:
                    got = [[rg.submit(g, *map(int, op)) for op in chain]
                           for rg in engines]
                assert got[1] == got[0]
                tags += got[0]
        _partition(engines, r)
        for rg in engines:
            rg.step_round()
        _same_state(engines, r)
    for rg in engines:
        rg.run_until(tags, max_rounds=300)
        rg.run(4)      # followers apply the last commit; events drain
    _same_state(engines, "end")
    assert port.results == ref.results
    assert port.events == ref.events
    codes = {e[1] for evs in port.events.values() for e in evs}
    assert codes == {jap.EV_LOCK_GRANT, jap.EV_ELECT, jap.EV_TOPIC_MSG}


def test_drive_vector_and_step_rounds_match_reference():
    """``drive_vector`` returns the reference's results (each group's
    prefix sums, correlated from the step outputs), and ``step_rounds(n)``
    — n rounds, one fetch, the draws taken as the reference's fused
    program takes them — leaves the reference's state, results and round
    count."""
    assert_same_state = torch_reference.assert_same_state
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S, config=JCFG)
    port = ReferenceDrawnGroups()
    engines = [ref, port]
    for rg in engines:
        rg.wait_for_leaders()
    rng = np.random.default_rng(8)
    g = np.repeat(np.arange(G), rng.integers(0, S + 1, G))
    d = rng.integers(1, 50, g.size)
    z = np.zeros_like(g)
    got = [rg.drive_vector(g, z + jap.OP_LONG_ADD, d, z, z)
           for rg in engines]
    np.testing.assert_array_equal(got[1], got[0])
    totals = np.zeros(G, np.int64)
    for i, (gi, di) in enumerate(zip(g, d)):
        totals[gi] += di
        assert got[1][i] == totals[gi]
    assert_same_state(ref, port, "after drive_vector")
    for n in (8, 1):
        rows = rng.integers(0, G, 10)
        tags = [list(rg.submit_batch(rows, jap.OP_LONG_ADD, 1))
                for rg in engines]
        assert tags[0] == tags[1]
        for rg in engines:
            rg.step_rounds(n)
        assert port.rounds == ref.rounds
        assert_same_state(ref, port, f"after step_rounds({n})")
    for rg in engines:
        rg.run(2)
    assert port.results == ref.results
    assert all(t in port.results for t in tags[0])
