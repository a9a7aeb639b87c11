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
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.ops import apply as jap  # noqa: E402
from copycat_tpu.ops import consensus as jcons  # noqa: E402

from copycat_tpu_torch import bench, convert  # noqa: E402
from copycat_tpu_torch.models import RaftGroups  # noqa: E402
from copycat_tpu_torch.ops import consensus as tcons  # noqa: E402
from torch_reference import (  # noqa: E402
    ReferenceDrawnGroups,
    assert_same_leaves,
    assert_same_state,
    isolate,
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
    return tuple(torch.tensor(np.asarray(jax.random.randint(
        k, (G, P), cfg.timer_min, cfg.timer_max))) for k in (key_t, key_c))


def test_dynamic_step_matches_reference():
    tcfg = convert.config_to_torch(JCFG)
    assert tcfg.dynamic_membership and not tcfg.ring_flow_control
    key = jax.random.PRNGKey(7)
    key, init_key = jax.random.split(key)
    members = np.arange(P) < VOTERS
    jstate = jcons.init_state(G, P, L, init_key, JCFG, members=members)
    tstate = tcons.init_state(G, P, L, torch.tensor(
        np.asarray(jstate.timer)), tcfg, members=members)
    assert_same_leaves(jstate, tstate, "init")
    jstep = jax.jit(partial(jcons.step, config=JCFG))
    jinstall = jax.jit(partial(jcons.install_snapshots, config=JCFG))
    st = {"j": jstate, "t": tstate, "key": key, "r": 0, "installs": 0}

    def step_both(sub, deliver):
        st["key"], k = jax.random.split(st["key"])
        js, jout = jstep(st["j"], jcons.Submits(**sub), deliver, k)
        ts, tout = tcons.step(st["t"], tcons.Submits(**{
            n: torch.from_numpy(v) for n, v in sub.items()}),
            torch.from_numpy(deliver), *_draws(k, JCFG), tcfg)
        assert_same_leaves(jout, tout, f"outputs round {st['r']}")
        assert_same_leaves(js, ts, f"state round {st['r']}")
        if np.asarray(jout.stale).any():
            js = jinstall(js, jout.stale, jout.leader)
            ts = tcons.install_snapshots(ts, tout.stale, tout.leader, tcfg)
            assert_same_leaves(js, ts, f"installed round {st['r']}")
            st["installs"] += 1
        st["j"], st["t"] = js, ts
        st["r"] += 1
        return jout, np.asarray(jout.leader)

    seen = _run_plans(step_both)
    assert seen["refused"] >= G // 4, seen       # every remove-last
    assert seen["accepted_cfg"] > G and seen["rejected_cfg"] > 0, seen
    member = np.asarray(st["j"].member)
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


def _lockstep(engines, fn):
    out = [fn(rg) for rg in engines]
    for o in out[1:]:
        assert o == out[0]
    return out[0]


def _rounds(engines, n, deliver=None):
    for _ in range(n):
        for rg in engines:
            rg.step_round(deliver=deliver)
        assert_same_state(engines[0], engines[1], f"round {engines[0].rounds}")


def test_raft_groups_membership_script_matches_reference():
    ref = JaxRaftGroups(RG, P, log_slots=RL, submit_slots=S, config=JCFG,
                        voters=VOTERS)
    port = ReferenceDrawnGroups(RG, P, RL, S, JCFG, voters=VOTERS)
    engines = [ref, port]
    assert_same_state(ref, port, "init")
    _lockstep(engines, lambda rg: rg.wait_for_leaders().tolist())
    leaders = _lockstep(engines, lambda rg: [rg.leader(g)
                                             for g in range(RG)])
    adds = [_lockstep(engines, lambda rg: rg.submit(g, jap.OP_LONG_ADD,
                                                    g + 1))
            for g in range(RG)]
    cfg = _lockstep(engines, lambda rg: [
        rg.add_peer(0, 3), rg.add_peer(0, 4),             # join, serialized
        rg.remove_peer(1, 1), rg.remove_peer(1, 2),
        rg.remove_peer(1, 0),                             # the last: FAIL
        rg.remove_peer(2, leaders[2]),                    # leader leaves
        rg.add_peer(3, 3), rg.remove_peer(3, 0)])
    _rounds(engines, 12)
    # lanes 1 and 2 cut off: group 0 (voters 0,1,2,3,4 by now) commits
    more = _lockstep(engines, lambda rg: [rg.submit(g, jap.OP_LONG_ADD, 1)
                                          for g in range(RG)])
    _rounds(engines, 20, deliver=isolate(RG, P, [1, 2]))
    _rounds(engines, 30)
    tags = adds + cfg + more
    for rg in engines:
        rg.run_until(tags, max_rounds=150)
    _rounds(engines, 3)
    assert port.results == ref.results
    assert port.results[cfg[4]] == jap.FAIL
    assert port.counters["ops_refused"] == 1
    voters = _lockstep(engines, lambda rg: [rg.voting_members(g)
                                            for g in range(RG)])
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


def test_lease_under_membership_churn_matches_reference():
    runs = []
    for rg, to_dev in (
            (JaxRaftGroups(2, P, log_slots=32, submit_slots=S, seed=3,
                           config=JCFG, voters=VOTERS), jax.numpy.asarray),
            (ReferenceDrawnGroups(2, P, 32, S, JCFG, seed=3, voters=VOTERS),
             torch.from_numpy)):
        trace = []
        _lease_churn(rg, lambda e, m, f=to_dev: setattr(
            e, "deliver", f(np.ascontiguousarray(m))), trace)
        runs.append((rg, trace))
    (ref, want), (port, got) = runs
    assert got == want
    island, leader, voters, read = got[3:]
    assert not any(lease[leader] for lease in got[:3])
    assert set(voters) == {0, 1, 2, 3, 4} - set(island)
    assert read == 222
    assert port.results == ref.results and port.rounds == ref.rounds
    assert_same_state(ref, port, "end")
