"""Dynamic membership in the torch port against the JAX reference.

``Config(dynamic_membership=True)`` gives each group its own voter set
over the P lanes, changed by single-server ``OP_CFG_ADD`` /
``OP_CFG_REMOVE`` entries through the log (server join and leave).

- The step: G=16 × P=5 groups starting with 3 voters, counter traffic, a
  scripted plan of config submits per group (joins, leaves, a leader
  removing its own lane, two changes in one window, removing the last
  member) under a schedule that isolates leaders and drops messages. With
  the reference's timer draws and ``ring_flow_control`` off, every state
  and output leaf equals the reference's every round, exactly. With flow
  control on, replicas at equal applied index agree.
- ``RaftGroups``: a membership script (join, leave, leader
  self-removal, remove-last failing with ``FAIL``, a partition) through
  ``add_peer``/``remove_peer`` on both engines in lockstep: equal state
  every round, equal results and voter sets; and the reference's
  lease-under-churn scenario (``tests/test_lease_churn.py``: a leader
  islanded with a quorum of its first config but not of its active one
  loses its lease) with equal leases, voter sets, reads and final state.

Each reference side depends on nothing of the port's: it runs once, in a
worker process started with the session's first port file
(``torch_reference.LONG_RUNS``), and records what the port's run is then
held against, round by round (``torch_reference.Transcript``).
"""

import os
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401

from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.ops import apply as jap  # noqa: E402
from copycat_tpu.ops import consensus as jcons  # noqa: E402

from copycat_tpu_torch import bench, convert  # noqa: E402
from copycat_tpu_torch.models import RaftGroups  # noqa: E402
from copycat_tpu_torch.ops import consensus as tcons  # noqa: E402
from torch_reference import (  # noqa: E402
    LONG_RUNS,
    SUITE_AHEAD,
    ReferenceDrawnGroups,
    Transcript,
    assert_same_value,
    isolate,
    state_leaves,
)

G, P, L, S = 16, 5, 16, 4
VOTERS = 3
JCFG = jcons.Config(append_window=S, applies_per_round=S,
                    dynamic_membership=True,
                    resource=jap.ResourceConfig.counters_only())
ADD, REMOVE = jap.OP_CFG_ADD, jap.OP_CFG_REMOVE
LEADER_LANE = -1      # in a plan: remove the group's current leader lane


def _plan(g: int) -> list:
    """Config submits of group ``g``, in order: joins, leaves, a leader
    removing itself, removing down to one member and then the last
    (refused), and a lane out of range (a no-op change)."""
    return [
        [(ADD, 3), (ADD, 4), (REMOVE, 0)],
        [(REMOVE, 1), (REMOVE, 2), (REMOVE, 0)],      # the last: refused
        [(REMOVE, LEADER_LANE), (ADD, 4)],
        [(ADD, 3), (REMOVE, LEADER_LANE), (ADD, P)],
    ][g % 4]


def _deliver(rng, r, lead):
    """Full delivery, but leaders isolated in rounds 24-33 and random loss
    every fifth round."""
    if 24 <= r < 34:
        hit = np.arange(P)[None, :] == lead[:, None]
        return ~(hit[:, :, None] | hit[:, None, :])
    if r % 5 == 0:
        return rng.random((G, P, P)) < 0.75
    return np.ones((G, P, P), bool)


def _run_plans(step_both, rounds=90, seed=0):
    """Drive ``step_both(submits, deliver) -> (outputs, lead)`` for
    ``rounds`` rounds: counter ops in every slot but the first, and in
    slot 0 the next config change of each group's plan until the step
    accepts or refuses it (in even rounds a second one rides slot 1, so
    the one-in-flight guard rejects it). Returns counts of what
    happened."""
    rng = np.random.default_rng(seed)
    plans = {g: list(_plan(g)) for g in range(G)}
    lead = np.full(G, -1)
    seen = dict(accepted_cfg=0, refused=0, rejected_cfg=0)
    tag = 1
    for r in range(rounds):
        op = np.full((G, S), jap.OP_LONG_ADD, np.int32)
        a = rng.integers(1, 5, (G, S)).astype(np.int32)
        valid = rng.random((G, S)) < 0.6
        cfg_g = []
        for g, plan in plans.items():
            if plan and r >= 4:
                kind, lane = plan[0]
                op[g, 0] = kind
                a[g, 0] = max(lead[g], 0) if lane == LEADER_LANE else lane
                valid[g, 0] = True
                cfg_g.append(g)
                if r % 2 == 0 and len(plan) > 1:
                    op[g, 1], a[g, 1] = plan[1]
                    a[g, 1] = max(a[g, 1], 0)
                    valid[g, 1] = True
        tags = np.arange(tag, tag + G * S, dtype=np.int32).reshape(G, S)
        tag += G * S
        sub = dict(opcode=op, a=a, b=np.zeros_like(a), c=np.zeros_like(a),
                   tag=tags, valid=valid)
        out, lead = step_both(sub, _deliver(rng, r, lead))
        acc, refused = np.asarray(out.accepted), np.asarray(out.refused)
        for g in cfg_g:
            if acc[g, 0] or refused[g, 0]:
                plans[g].pop(0)
                seen["accepted_cfg"] += int(acc[g, 0])
                seen["refused"] += int(refused[g, 0])
            else:
                seen["rejected_cfg"] += 1
    return seen


def _draws(key, cfg):
    key_t, key_c = jax.random.split(key)
    return tuple(np.asarray(jax.random.randint(
        k, (G, P), cfg.timer_min, cfg.timer_max)) for k in (key_t, key_c))


def _reference_dynamic_step() -> dict:
    """The reference's side of ``test_dynamic_step_matches_reference``:
    the initial state, and per round the submits, delivery mask, timer
    draws, outputs, state and installed state (or ``None``) as leaves;
    what the plans saw, and the final member words."""
    key = jax.random.PRNGKey(7)
    key, init_key = jax.random.split(key)
    members = np.arange(P) < VOTERS
    jstate = jcons.init_state(G, P, L, init_key, JCFG, members=members)
    jstep = jax.jit(partial(jcons.step, config=JCFG))
    jinstall = jax.jit(partial(jcons.install_snapshots, config=JCFG))
    st = {"j": jstate, "key": key}
    rounds = []

    def step_ref(sub, deliver):
        st["key"], k = jax.random.split(st["key"])
        js, jout = jstep(st["j"], jcons.Submits(**sub), deliver, k)
        installed = (jinstall(js, jout.stale, jout.leader)
                     if np.asarray(jout.stale).any() else None)
        rounds.append((sub, deliver, _draws(k, JCFG),
                       convert.flat_leaves(jout), convert.flat_leaves(js),
                       None if installed is None
                       else convert.flat_leaves(installed)))
        st["j"] = js if installed is None else installed
        return jout, np.asarray(jout.leader)

    seen = _run_plans(step_ref)
    return {"init": convert.flat_leaves(jstate), "rounds": rounds,
            "seen": seen, "member": np.asarray(st["j"].member)}


def test_dynamic_step_matches_reference():
    tcfg = convert.config_to_torch(JCFG)
    assert tcfg.dynamic_membership and not tcfg.ring_flow_control
    ref = SUITE_AHEAD.get("membership", _reference_runs)["step"]
    members = np.arange(P) < VOTERS
    tstate = tcons.init_state(G, P, L, torch.tensor(ref["init"]["timer"]),
                              tcfg, members=members)
    assert_same_value(ref["init"], convert.flat_leaves(tstate), "init")
    rounds = iter(ref["rounds"])
    st = {"t": tstate, "r": 0, "installs": 0}

    def step_both(sub, deliver):
        rsub, rdeliver, draws, jout, js, installed = next(rounds)
        what = f"round {st['r']}"
        assert_same_value(rsub, sub, f"submits {what}")
        np.testing.assert_array_equal(deliver, rdeliver, err_msg=what)
        ts, tout = tcons.step(st["t"], tcons.Submits(**{
            n: torch.from_numpy(v) for n, v in sub.items()}),
            torch.from_numpy(deliver), *map(torch.tensor, draws), tcfg)
        assert_same_value(jout, convert.flat_leaves(tout), f"outputs {what}")
        assert_same_value(js, convert.flat_leaves(ts), f"state {what}")
        assert (installed is not None) == bool(tout.stale.any()), what
        if installed is not None:
            ts = tcons.install_snapshots(ts, tout.stale, tout.leader, tcfg)
            assert_same_value(installed, convert.flat_leaves(ts),
                              f"installed {what}")
            st["installs"] += 1
        st["t"] = ts
        st["r"] += 1
        return tout, tout.leader.numpy()

    seen = _run_plans(step_both)
    assert next(rounds, None) is None and seen == ref["seen"]
    assert seen["refused"] >= G // 4, seen       # every remove-last
    assert seen["accepted_cfg"] > G and seen["rejected_cfg"] > 0, seen
    member = ref["member"]
    np.testing.assert_array_equal(st["t"].member.numpy(), member)
    # groups whose plan completed hold the planned voter sets somewhere
    assert ((member == 0b11110).any(axis=1)[0::4]).all()
    assert ((member == 0b00001).any(axis=1)[1::4]).all()


def test_flow_control_keeps_replicas_equal_under_churn():
    """The port's default step (``ring_flow_control`` on) with membership
    churn: replicas at equal applied index agree every round, and every
    group's plan goes through."""
    cfg = convert.config_to_torch(JCFG)._replace(ring_flow_control=True)
    gen = torch.Generator().manual_seed(3)
    state = tcons.init_state(G, P, L, tcons.draw_timers(G, P, cfg, gen),
                             cfg, members=np.arange(P) < VOTERS)
    box = {"s": state}

    def step_one(sub, deliver):
        s, out = tcons.step(
            box["s"], tcons.Submits(**{n: torch.from_numpy(v)
                                      for n, v in sub.items()}),
            torch.from_numpy(deliver), tcons.draw_timers(G, P, cfg, gen),
            tcons.draw_timers(G, P, cfg, gen), cfg)
        box["s"] = tcons.install_snapshots(s, out.stale, out.leader, cfg)
        assert bench.diverged_lanes(box["s"]) == 0
        return out, out.leader.numpy()

    seen = _run_plans(step_one, rounds=110, seed=1)
    assert seen["refused"] >= G // 4, seen
    assert seen["accepted_cfg"] >= sum(len(_plan(g)) for g in range(G)) \
        - seen["refused"], seen


# ---------------------------------------------------------------------------
# RaftGroups
# ---------------------------------------------------------------------------

RG, RL = 4, 32


def _rounds(rg, check, n, deliver=None):
    for _ in range(n):
        rg.step_round(deliver=deliver)
        check(state_leaves(rg), f"round {rg.rounds}")


def _membership_script(rg, check):
    """Joins, leaves, a leader leaving, the last member's removal refused
    and a partition, through ``add_peer``/``remove_peer``; ``check`` sees
    every value the two engines must agree on (the state every round)."""
    check(state_leaves(rg), "init")
    check(rg.wait_for_leaders().tolist(), "leaders elected")
    leaders = check([rg.leader(g) for g in range(RG)], "leaders")
    adds = [check(rg.submit(g, jap.OP_LONG_ADD, g + 1), "add")
            for g in range(RG)]
    cfg = check([
        rg.add_peer(0, 3), rg.add_peer(0, 4),             # join, serialized
        rg.remove_peer(1, 1), rg.remove_peer(1, 2),
        rg.remove_peer(1, 0),                             # the last: FAIL
        rg.remove_peer(2, leaders[2]),                    # leader leaves
        rg.add_peer(3, 3), rg.remove_peer(3, 0)], "config tags")
    _rounds(rg, check, 12)
    # lanes 1 and 2 cut off: group 0 (voters 0,1,2,3,4 by now) commits
    more = check([rg.submit(g, jap.OP_LONG_ADD, 1) for g in range(RG)],
                 "more")
    _rounds(rg, check, 20, deliver=isolate(RG, P, [1, 2]))
    _rounds(rg, check, 30)
    tags = adds + cfg + more
    rg.run_until(tags, max_rounds=150)
    _rounds(rg, check, 3)
    check(dict(rg.results), "results")
    voters = check([rg.voting_members(g) for g in range(RG)], "voters")
    return leaders, cfg, voters


def _reference_membership_script() -> list:
    ref = JaxRaftGroups(RG, P, log_slots=RL, submit_slots=S, config=JCFG,
                        voters=VOTERS)
    check = Transcript()
    _membership_script(ref, check)
    return check.values


def test_raft_groups_membership_script_matches_reference():
    port = ReferenceDrawnGroups(RG, P, RL, S, JCFG, voters=VOTERS)
    check = Transcript(SUITE_AHEAD.get("membership",
                                       _reference_runs)["script"])
    leaders, cfg, voters = _membership_script(port, check)
    check.done()
    assert port.results[cfg[4]] == jap.FAIL
    assert port.metrics.counter("ops_refused").value == 1
    assert voters[0] == [0, 1, 2, 3, 4]
    assert voters[1] == [0]
    assert leaders[2] not in voters[2] and port.leader(2) != leaders[2]
    assert voters[3] == [1, 2, 3]
    masks = port.config_masks()
    assert [[p for p in range(P) if (m >> p) & 1] for m in masks] == voters


def test_membership_arguments_are_checked():
    static = tcons.Config(resource=tcons.ResourceConfig.counters_only())
    with pytest.raises(ValueError, match="dynamic_membership"):
        RaftGroups(2, 5, config=static, voters=3, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        RaftGroups(2, 5, voters=6, device="cpu")
    dyn = static._replace(dynamic_membership=True)
    rg = RaftGroups(2, 5, config=dyn, voters=3, device="cpu")
    assert rg.state.member.tolist() == [[0b111] * 5] * 2
    with pytest.raises(ValueError, match="outside"):
        rg.add_peer(0, 5)
    with pytest.raises(ValueError, match="outside"):
        rg.submit_batch([0, 1], [jap.OP_LONG_ADD, REMOVE], [1, -1])
    tags = rg.submit_batch([0, 1], REMOVE, [2, 1])    # rows of config ops
    assert len(tags) == 2


def _island(G_, island):
    """Full delivery within ``island`` and within its complement only."""
    lanes = np.arange(P)
    inside = np.isin(lanes, sorted(island))
    return np.broadcast_to(inside[:, None] == inside[None, :], (G_, P, P))


def _lease_churn(rg, set_deliver, trace):
    """The reference's lease-under-churn scenario
    (``tests/test_lease_churn.py``): voters grow to all five lanes, the
    leader is cut off with one companion (a quorum of the first config,
    not of the active one), its lease drops, the majority elects and
    removes both islanders, and atomic reads see the new value."""
    rg.wait_for_leaders()
    for lane in (3, 4):
        rg.run_until([rg.add_peer(g, lane) for g in range(2)])
    rg.run_until([rg.submit(0, jap.OP_VALUE_SET, 111)])
    rg.run(2)
    leader = rg.leader(0)
    companion = next(p for p in (0, 1, 2) if p != leader)
    island = {leader, companion}
    set_deliver(rg, _island(2, island))
    for _ in range(3):
        rg.step_round()
        trace.append(np.asarray(rg.state.lease)[0].tolist())
    for _ in range(60):
        rg.step_round()
        if rg.leader(0) not in island and rg.leader(0) >= 0:
            break
    for lane in sorted(island):
        rg.run_until([rg.remove_peer(0, lane)], max_rounds=120)
    rg.run_until([rg.submit(0, jap.OP_VALUE_SET, 222)], max_rounds=120)
    q = rg.submit_query(0, jap.OP_VALUE_GET, consistency="atomic")
    rg.run_until([q], max_rounds=120)
    trace += [sorted(island), leader, rg.voting_members(0), rg.results[q]]


def _reference_lease_churn() -> tuple:
    """The reference's side of the lease-under-churn scenario: its trace,
    results, rounds and final state leaves."""
    ref = JaxRaftGroups(2, P, log_slots=32, submit_slots=S, seed=3,
                        config=JCFG, voters=VOTERS)
    trace = []
    _lease_churn(ref, lambda e, m: setattr(
        e, "deliver", jax.numpy.asarray(np.ascontiguousarray(m))), trace)
    return trace, ref.results, ref.rounds, state_leaves(ref)


def test_lease_under_membership_churn_matches_reference():
    want, results, rounds, leaves = SUITE_AHEAD.get(
        "membership", _reference_runs)["lease"]
    port = ReferenceDrawnGroups(2, P, 32, S, JCFG, seed=3, voters=VOTERS)
    got = []
    _lease_churn(port, lambda e, m: setattr(
        e, "deliver", torch.from_numpy(np.ascontiguousarray(m))), got)
    assert got == want
    island, leader, voters, read = got[3:]
    assert not any(lease[leader] for lease in got[:3])
    assert set(voters) == {0, 1, 2, 3, 4} - set(island)
    assert read == 222
    assert port.results == results and port.rounds == rounds
    assert_same_value(leaves, state_leaves(port), "end")


def _reference_runs() -> dict:
    """Every case's reference side, in one worker: they share the
    reference's compiled programs."""
    return {"step": _reference_dynamic_step(),
            "script": _reference_membership_script(),
            "lease": _reference_lease_churn()}


LONG_RUNS.update({f"{os.path.basename(__file__)}::{test}": [
    ("membership", _reference_runs, ())] for test in (
        "test_dynamic_step_matches_reference",
        "test_raft_groups_membership_script_matches_reference",
        "test_lease_under_membership_churn_matches_reference")})
