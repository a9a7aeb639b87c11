"""The torch consensus step against the JAX reference, leaf by leaf.

Both engines start from one state (the reference's ``init_state``,
converted) and step side by side on the same submits, delivery masks and
election-timer draws (the reference's own draws for each round's key, fed
to the port as inputs). Every ``RaftState`` and ``StepOutputs`` leaf must
be equal — value and dtype — after every round. Covers random partitions,
the lease gate on and off, compact submit leaves and snapshot install on
stale lanes, with counters only and with every resource pool, with and
without ``pool_budgets``.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401

from copycat_tpu.ops import apply as jap  # noqa: E402
from copycat_tpu.ops import consensus as jcons  # noqa: E402

from copycat_tpu_torch import bench, convert  # noqa: E402
from copycat_tpu_torch.ops import apply as tap  # noqa: E402
from copycat_tpu_torch.ops import consensus as tcons  # noqa: E402

G, L, ROUNDS = 64, 16, 40

# opcodes the random submits draw from: mostly counters, plus every other
# value op and a few opcodes of zero-slot pools (which answer FAIL)
_OPS = np.array([jap.OP_LONG_ADD] * 6 + [
    jap.OP_VALUE_SET, jap.OP_VALUE_GET, jap.OP_VALUE_CAS,
    jap.OP_VALUE_GET_AND_SET, jap.OP_NOP, jap.OP_MAP_PUT, jap.OP_Q_POLL,
    jap.OP_LOCK_ACQUIRE, jap.OP_LOCK_RELEASE, jap.OP_ELECT_LISTEN,
    jap.OP_TOPIC_PUB], np.int32)


# every opcode of the catalog, for the all-pool configs
_ALL_OPS = np.array(sorted({v for k, v in vars(jap).items()
                            if k.startswith("OP_")}), np.int32)
# small pools, so the reference's CPU compile stays short
_RC_SMALL = jap.ResourceConfig(map_slots=4, set_slots=3, queue_slots=3,
                               wait_slots=3, listener_slots=3, event_slots=4,
                               multimap_slots=4, topic_slots=3)


def _jax_draws(key, cfg, P):
    """The two timer draws the reference's ``step`` makes from ``key``."""
    key_t, key_c = jax.random.split(key)
    fresh = jax.random.randint(key_t, (G, P), cfg.timer_min, cfg.timer_max)
    cand = jax.random.randint(key_c, (G, P), cfg.timer_min, cfg.timer_max)
    return torch.tensor(np.asarray(fresh)), torch.tensor(np.asarray(cand))


def _submits(rng, r, S, compact, ops=_OPS):
    valid = rng.random((G, S)) < 0.7
    if compact:
        # scalar leaves and the [G,1] tag column (consecutive per slot)
        return dict(opcode=jap.OP_LONG_ADD, a=np.int32(1), b=0, c=0,
                    tag=(np.arange(G, dtype=np.int32)[:, None] * 1000
                         + r * S + 1),
                    valid=valid)
    return dict(
        opcode=rng.choice(ops, (G, S)).astype(np.int32),
        a=rng.integers(-3, 4, (G, S)).astype(np.int32),
        b=rng.integers(-3, 4, (G, S)).astype(np.int32),
        c=rng.integers(0, 4, (G, S)).astype(np.int32),
        tag=(np.arange(G * S, dtype=np.int32).reshape(G, S) + r * G * S + 1),
        valid=valid)


def _deliver(rng, r, P):
    """Full delivery, random message loss, or one isolated lane per group
    held for 14 rounds (long enough for followers to fall off the ring)."""
    if 8 <= r < 22:
        victim = np.asarray(jax.random.randint(jax.random.PRNGKey(99), (G,),
                                               0, P))
        hit = np.arange(P)[None, :] == victim[:, None]
        return ~(hit[:, :, None] | hit[:, None, :])
    if r % 3 == 0:
        return rng.random((G, P, P)) < 0.8
    return np.ones((G, P, P), bool)


def _assert_same(ref, port, what, r):
    want, got = convert.flat_leaves(ref), convert.flat_leaves(port)
    assert want.keys() == got.keys(), what
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None, (what, name, r)
            continue
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (what, name, r)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name} round {r}")


def _full(sub, S):
    """Compact submit leaves as the full ``[G, S]`` arrays the reference's
    ``step`` normalizes them to first (scalars broadcast, a ``[G, 1]`` tag
    column consecutive per slot; full arrays pass through untouched): the
    same step, and one compiled signature of it per config where the
    compact rounds would compile a second."""
    out = {k: np.broadcast_to(np.asarray(v, np.int32), (G, S))
           for k, v in sub.items() if k in ("opcode", "a", "b", "c")}
    tag = np.asarray(sub["tag"], np.int32)
    out["tag"] = (tag + np.arange(S, dtype=np.int32)[None, :]
                  if tag.shape == (G, 1) and S != 1
                  else np.broadcast_to(tag, (G, S)))
    out["valid"] = sub["valid"]
    return out


def _reference_run(P, S, jcfg, ops):
    """The reference's side of :func:`_step_side_by_side`: per round the
    submits (as the port gets them), delivery mask and timer draws, the
    reference's outputs and state, and its state after a snapshot install
    (or ``None``)."""
    key = jax.random.PRNGKey(P * 100 + S)
    key, init_key = jax.random.split(key)
    jstate = jcons.init_state(G, P, L, init_key, jcfg)
    jstep = jax.jit(partial(jcons.step, config=jcfg))
    jinstall = jax.jit(partial(jcons.install_snapshots, config=jcfg))
    rng = np.random.default_rng(P * 10 + S)
    run = [jstate]
    for r in range(ROUNDS):
        key, k = jax.random.split(key)
        sub = _submits(rng, r, S, compact=(r % 5 == 4), ops=ops)
        deliver = _deliver(rng, r, P)
        jstate, jout = jstep(jstate, jcons.Submits(**_full(sub, S)),
                             deliver, k)
        installed = None
        if np.asarray(jout.stale).any():
            installed = jinstall(jstate, jout.stale, jout.leader)
        run.append((sub, deliver, _jax_draws(k, jcfg, P), jout, jstate,
                    installed))
        if installed is not None:
            jstate = installed
    return run


# The counters-only runs are kept for the file's life (a few MB): the
# flow-control case steps the lease case's run (P=3, S=4) again.
_COUNTER_RUNS = {}


def _step_side_by_side(P, S, jcfg, ops=_OPS, flow_control=False):
    """Step both engines ROUNDS rounds from one state; returns the
    commands committed, the snapshot installs and the events drained."""
    tcfg = convert.config_to_torch(jcfg)._replace(
        ring_flow_control=flow_control)
    if jcfg.resource == jap.ResourceConfig.counters_only():
        k = (P, S, jcfg, ops.tobytes())
        if k not in _COUNTER_RUNS:
            _COUNTER_RUNS[k] = _reference_run(P, S, jcfg, ops)
        run = _COUNTER_RUNS[k]
    else:
        run = _reference_run(P, S, jcfg, ops)
    tstate = convert.state_to_torch(run[0], "cpu")
    installs = committed = events = 0
    for r, (sub, deliver, (fresh, cand), jout, jstate, installed) in \
            enumerate(run[1:]):
        tstate, tout = tcons.step(
            tstate, tcons.Submits(**sub), torch.from_numpy(deliver),
            fresh, cand, tcfg)
        _assert_same(jout, tout, "outputs", r)
        _assert_same(jstate, tstate, "state", r)
        committed += int(np.asarray(jout.out_valid).sum())
        events += int(np.asarray(jout.ev_valid).sum())
        if installed is not None:
            tstate = tcons.install_snapshots(tstate, tout.stale, tout.leader,
                                             tcfg)
            _assert_same(installed, tstate, "installed", r)
            installs += 1
    assert committed > 0
    assert installs > 0, "the schedule never left a lane stale"
    return committed, installs, events


@pytest.mark.parametrize("P,S,lease", [(3, 4, True), (5, 16, True),
                                       (3, 16, False), (5, 4, False)])
def test_step_matches_reference(P, S, lease):
    _step_side_by_side(P, S, jcons.Config(
        append_window=S, applies_per_round=S, lease_gated_accept=lease,
        resource=jap.ResourceConfig.counters_only()))


@pytest.mark.parametrize("P,S,rc,budgets", [
    (3, 8, _RC_SMALL, None),
    (3, 8, _RC_SMALL, (2, 3, 1, 2, 2, 1, 2, 1)),
    (5, 4, _RC_SMALL, None),
    (5, 8, _RC_SMALL, (1,) * 8),
    (5, 16, jap.ResourceConfig(), (4, 6, 4, 6, 4, 4, 4, 4)),
], ids=["P3", "P3-budgets", "P5", "P5-tight", "P5-default-pools-mixed"])
def test_step_all_pools_matches_reference(P, S, rc, budgets):
    """Every pool and event source, the sequential apply and the
    partitioned one, under partitions and snapshot installs."""
    _, _, events = _step_side_by_side(P, S, jcons.Config(
        append_window=S, applies_per_round=S, pool_budgets=budgets,
        resource=rc), ops=_ALL_OPS)
    assert events > 0, "no session event was drained"


@pytest.mark.parametrize("budgets", [(4,) * 7, (4,) * 9])
def test_pool_budgets_need_eight_entries(budgets):
    cfg = tcons.Config(pool_budgets=budgets)
    state = tcons.init_state(2, 3, 8, torch.full((2, 3), 5,
                                                 dtype=torch.int32), cfg)
    z = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="8 entries"):
        tcons.step(state, tcons.make_submits(2, 4, "cpu"),
                   tcons.full_delivery(2, 3, "cpu"), z + 5, z + 5, cfg)


def test_ring_flow_control_changes_nothing_until_it_binds():
    """Where no lane's log would run L - 1 entries ahead of its apply,
    the default step (flow control on) is the reference's, leaf for
    leaf."""
    _step_side_by_side(3, 4, jcons.Config(
        append_window=4, applies_per_round=4,
        resource=jap.ResourceConfig.counters_only()), flow_control=True)


def test_ring_flow_control_keeps_replicas_equal():
    """The reference's AppendEntries lets a follower whose apply lags its
    log by L or more overwrite committed entries before applying them, so
    replicas at one applied index come to disagree. On the mixed cell
    under the partition nemesis (G=16 × P=5, L=32) the reference — and
    the port with ``ring_flow_control`` off, equal to it every round —
    diverges; the port's default step keeps every replica pair at equal
    applied index equal, and keeps committing."""
    G_, P, L_, S = 16, 5, 32, 16
    jcfg = jcons.Config(append_window=S, applies_per_round=S,
                        pool_budgets=bench.pool_budgets_for("mixed", S),
                        timer_min=2, timer_max=4,
                        resource=jap.ResourceConfig(multimap_slots=0,
                                                    topic_slots=0))
    ref_mode = convert.config_to_torch(jcfg)
    fixed = ref_mode._replace(ring_flow_control=True)
    key = jax.random.PRNGKey(0)
    key, init_key = jax.random.split(key)
    jstate = jcons.init_state(G_, P, L_, init_key, jcfg)
    states = {cfg: convert.state_to_torch(jstate, "cpu")
              for cfg in (ref_mode, fixed)}
    jstep = jax.jit(partial(jcons.step, config=jcfg))
    jinstall = jax.jit(partial(jcons.install_snapshots, config=jcfg))
    sub = bench.mixed_submits(G_, S, "cpu")
    jsub = jcons.Submits(*(np.ascontiguousarray(x.numpy()) for x in sub))
    delivers = bench.nemesis_delivers(40, G_, P, "cpu")
    diverged = {cfg: 0 for cfg in states}
    applied0 = states[fixed].applied_index.amax(dim=1)
    for r in range(40):
        key, k = jax.random.split(key)
        jstate, jout = jstep(jstate, jsub, delivers[r].numpy(), k)
        jstate = jinstall(jstate, jout.stale, jout.leader)
        key_t, key_c = jax.random.split(k)
        fresh, cand = (torch.tensor(np.asarray(jax.random.randint(
            kk, (G_, P), jcfg.timer_min, jcfg.timer_max)))
            for kk in (key_t, key_c))
        for cfg, st in states.items():
            st, out = tcons.step(st, sub, delivers[r], fresh, cand, cfg)
            states[cfg] = tcons.install_snapshots(st, out.stale, out.leader,
                                                  cfg)
            diverged[cfg] = max(diverged[cfg],
                                bench.diverged_lanes(states[cfg]))
        _assert_same(jstate, states[ref_mode], "reference mode", r)
    assert diverged[ref_mode] > 0, "the reference's fault did not show"
    assert diverged[fixed] == 0
    committed = states[fixed].applied_index.amax(dim=1) - applied0
    assert (committed > 0).all()


def test_a_lane_with_a_full_ring_does_not_stand_for_election():
    """With flow control, a lane whose L ring slots all hold unapplied
    entries does not campaign (a win would append a NoOp over one of
    them); with one slot free it does. The reference's step campaigns
    either way."""
    L_ = 8
    timer = torch.tensor([[1, 9, 9], [1, 9, 9]], dtype=torch.int32)
    fixed = tcons.Config(resource=tap.ResourceConfig.counters_only())
    st = tcons.init_state(2, 3, L_, timer, fixed)
    last = torch.tensor([[L_, 0, 0], [L_ - 1, 0, 0]], dtype=torch.int32)
    st = st._replace(last_index=last)
    args = (st, tcons.make_submits(2, 4, "cpu"),
            tcons.full_delivery(2, 3, "cpu"), timer + 5, timer + 5)
    terms = {}
    for flow in (True, False):
        out, _ = tcons.step(*args, fixed._replace(ring_flow_control=flow))
        terms[flow] = out.term[:, 0].tolist()
    assert terms[True] == [0, 1]        # full ring: no campaign
    assert terms[False] == [1, 1]


def test_current_leader_ties_go_to_first_lane():
    role = torch.tensor([[2, 2, 0], [0, 2, 2], [0, 0, 0]], dtype=torch.int32)
    term = torch.tensor([[3, 3, 1], [1, 4, 4], [2, 2, 2]], dtype=torch.int32)
    z = torch.zeros_like(role)
    st = tcons.RaftState(*([z] * len(tcons.RaftState._fields)))
    lead, active = tcons.current_leader(st._replace(role=role, term=term))
    assert lead.tolist() == [0, 1, -1]
    assert active.tolist() == [True, True, False]


@pytest.mark.parametrize("name", ["monotone_tag_accept", "telemetry"])
def test_unported_config_branches_raise(name):
    """The two branches that raised ``NotImplementedError`` until the deep
    bulk plane was ported now run: a state builds and a step takes them
    (telemetry then fills ``StepOutputs.telemetry``)."""
    cfg = tcons.Config(resource=tap.ResourceConfig.counters_only(),
                       **{name: True})
    timer = torch.full((2, 3), 5, dtype=torch.int32)
    state = tcons.init_state(2, 3, 8, timer, cfg)
    _, out = tcons.step(state, tcons.make_submits(2, 4, "cpu"),
                        tcons.full_delivery(2, 3, "cpu"), timer, timer, cfg)
    assert (out.telemetry is not None) == (name == "telemetry")


def test_every_pool_and_budgets_are_accepted():
    """Every pool, budgets and ``dynamic_membership`` build a state."""
    cfg = convert.config_to_torch(jcons.Config(pool_budgets=(1,) * 8))
    assert cfg.resource == tcons.Config().resource
    state = tcons.init_state(2, 3, 8, torch.full((2, 3), 5,
                                                 dtype=torch.int32), cfg)
    assert state.resources.map_key.shape == (2, 3, 16)
    tcons.init_state(2, 3, 8, torch.full((2, 3), 5, dtype=torch.int32),
                     cfg._replace(dynamic_membership=True))


def test_convert_round_trips_both_ways():
    """Reference state, submits and outputs convert to the port's types
    and back to numpy dicts that rebuild the reference's types, leaf for
    leaf."""
    P, S = 3, 4
    cfg = jcons.Config(resource=jap.ResourceConfig.counters_only())
    key = jax.random.PRNGKey(1)
    jstate = jcons.init_state(G, P, L, key, cfg)
    sub = jcons.make_submits(G, S)
    jstate, jout = jax.jit(partial(jcons.step, config=cfg))(
        jstate, sub, jcons.full_delivery(G, P), key)
    tstate = convert.state_to_torch(jstate, "cpu")
    _assert_same(jstate, tstate, "state", 0)
    _assert_same(jout, convert.outputs_to_torch(jout, "cpu"), "outputs", 0)
    _assert_same(sub, convert.submits_to_torch(sub, "cpu"), "submits", 0)
    back = convert.to_numpy(tstate)
    rebuilt = jcons.RaftState(**{**back, "resources": jap.ResourceState(
        **back["resources"])})
    _assert_same(jstate, rebuilt, "rebuilt", 0)
    assert convert.config_to_torch(cfg)._asdict() == {
        **{k: v for k, v in cfg._asdict().items() if k != "use_pallas"},
        "ring_flow_control": False}
