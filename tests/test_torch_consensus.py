"""The torch consensus step against the JAX reference, leaf by leaf.

Both engines start from one state (the reference's ``init_state``,
converted) and step side by side on the same submits, delivery masks and
election-timer draws (the reference's own draws for each round's key, fed
to the port as inputs). Every ``RaftState`` and ``StepOutputs`` leaf must
be equal — value and dtype — after every round. Covers random partitions,
the lease gate on and off, compact submit leaves and snapshot install on
stale lanes.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from copycat_tpu.ops import apply as jap  # noqa: E402
from copycat_tpu.ops import consensus as jcons  # noqa: E402

from copycat_tpu_torch import convert  # noqa: E402
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


def _jax_draws(key, cfg, P):
    """The two timer draws the reference's ``step`` makes from ``key``."""
    key_t, key_c = jax.random.split(key)
    fresh = jax.random.randint(key_t, (G, P), cfg.timer_min, cfg.timer_max)
    cand = jax.random.randint(key_c, (G, P), cfg.timer_min, cfg.timer_max)
    return torch.tensor(np.asarray(fresh)), torch.tensor(np.asarray(cand))


def _submits(rng, r, S, compact):
    valid = rng.random((G, S)) < 0.7
    if compact:
        # scalar leaves and the [G,1] tag column (consecutive per slot)
        return dict(opcode=jap.OP_LONG_ADD, a=np.int32(1), b=0, c=0,
                    tag=(np.arange(G, dtype=np.int32)[:, None] * 1000
                         + r * S + 1),
                    valid=valid)
    return dict(
        opcode=rng.choice(_OPS, (G, S)).astype(np.int32),
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


@pytest.mark.parametrize("P,S,lease", [(3, 4, True), (5, 16, True),
                                       (3, 16, False), (5, 4, False)])
def test_step_matches_reference(P, S, lease):
    jcfg = jcons.Config(append_window=S, applies_per_round=S,
                        lease_gated_accept=lease,
                        resource=jap.ResourceConfig.counters_only())
    tcfg = convert.config_to_torch(jcfg)
    key = jax.random.PRNGKey(P * 100 + S)
    key, init_key = jax.random.split(key)
    jstate = jcons.init_state(G, P, L, init_key, jcfg)
    tstate = convert.state_to_torch(jstate, "cpu")
    jstep = jax.jit(partial(jcons.step, config=jcfg))
    jinstall = jax.jit(partial(jcons.install_snapshots, config=jcfg))
    rng = np.random.default_rng(P * 10 + S)
    installs = committed = 0
    for r in range(ROUNDS):
        key, k = jax.random.split(key)
        sub = _submits(rng, r, S, compact=(r % 5 == 4))
        deliver = _deliver(rng, r, P)
        jstate, jout = jstep(jstate, jcons.Submits(**sub), deliver, k)
        fresh, cand = _jax_draws(k, jcfg, P)
        tstate, tout = tcons.step(
            tstate, tcons.Submits(**sub), torch.from_numpy(deliver),
            fresh, cand, tcfg)
        _assert_same(jout, tout, "outputs", r)
        _assert_same(jstate, tstate, "state", r)
        committed += int(np.asarray(jout.out_valid).sum())
        if np.asarray(jout.stale).any():
            jstate = jinstall(jstate, jout.stale, jout.leader)
            tstate = tcons.install_snapshots(tstate, tout.stale, tout.leader,
                                             tcfg)
            _assert_same(jstate, tstate, "installed", r)
            installs += 1
    assert committed > 0
    assert installs > 0, "the schedule never left a lane stale"


def test_current_leader_ties_go_to_first_lane():
    role = torch.tensor([[2, 2, 0], [0, 2, 2], [0, 0, 0]], dtype=torch.int32)
    term = torch.tensor([[3, 3, 1], [1, 4, 4], [2, 2, 2]], dtype=torch.int32)
    z = torch.zeros_like(role)
    st = tcons.RaftState(*([z] * len(tcons.RaftState._fields)))
    lead, active = tcons.current_leader(st._replace(role=role, term=term))
    assert lead.tolist() == [0, 1, -1]
    assert active.tolist() == [True, True, False]


@pytest.mark.parametrize("name", ["dynamic_membership", "monotone_tag_accept",
                                  "telemetry"])
def test_unported_config_branches_raise(name):
    cfg = tcons.Config(resource=tap.ResourceConfig.counters_only(),
                       **{name: True})
    timer = torch.full((2, 3), 5, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=name):
        tcons.init_state(2, 3, 8, timer, cfg)


def test_pool_budgets_and_pools_raise():
    rc = convert.config_to_torch(jcons.Config()).resource
    timer = torch.full((2, 3), 5, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="pool_budgets"):
        tcons.init_state(2, 3, 8, timer, tcons.Config(
            resource=rc._replace(**{f: 0 for f in rc._fields}),
            pool_budgets=(1,) * 8))
    with pytest.raises(NotImplementedError, match="map_slots"):
        tcons.init_state(2, 3, 8, timer, tcons.Config(resource=rc))


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
        k: v for k, v in cfg._asdict().items() if k != "use_pallas"}
