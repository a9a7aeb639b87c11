"""``models/device_resources.py`` of the torch port against the JAX
reference: the nine facades and the raw resource ops under them.

Every script of ``tests/test_device_resources.py``,
``tests/test_device_facades.py`` and ``tests/test_device_multimap_topic.py``
runs, as one parametrised case each, on the reference's ``RaftGroups`` and
on the port's (``ReferenceDrawnGroups``: the same timer draws from the same
seed), through each package's own facades. Each script returns what it
observed (results, events, registers) and asserts the reference test's
values; the two packages' observations must be equal, and so must every
state leaf, the rounds and the host event buffers when it ends. Exact,
integers only.

One engine shape and pool config serve the scripts (``SHAPE``, ``JCFG``,
pools cut small so the reference compiles fast; the scripts size their
overflow runs from the config). Four scripts need a config of their own,
as in the reference: the counters-only pools, the one-slot event ring of
the overflow pair, and budgeted pools. Leaders are elected once per
config: each script starts from the two packages' checkpoints of that
state. The lock hand-off through grant events, the election
hand-off and the topic fan-out are among the scripts.

The reference's side of every script depends on nothing of the port's, so
it runs once for the file, in order, in a worker process started with the
session's first port file (``torch_reference.LONG_RUNS``): its
observations, rounds, events and final state come back to each case,
which runs the port's side and compares.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.models import checkpoint as jcheckpoint  # noqa: E402
from copycat_tpu.models import device_resources as jdr  # noqa: E402
from copycat_tpu.ops import apply as ap  # noqa: E402
from copycat_tpu.ops.apply import ResourceConfig  # noqa: E402
from copycat_tpu.ops.consensus import Config  # noqa: E402

from copycat_tpu_torch import convert  # noqa: E402
from copycat_tpu_torch.models import checkpoint as tcheckpoint  # noqa: E402
from copycat_tpu_torch.models import device_resources as tdr  # noqa: E402
from torch_reference import (  # noqa: E402
    LONG_RUNS,
    SUITE_AHEAD,
    ReferenceDrawnGroups,
    as_reference_drawn,
    assert_same_state,
    state_leaves,
)

FAIL = ap.FAIL
SHAPE = dict(groups=4, peers=3, log_slots=64, submit_slots=4)
JCFG = Config(resource=ResourceConfig(
    map_slots=4, set_slots=4, queue_slots=4, wait_slots=4, listener_slots=4,
    event_slots=16, multimap_slots=4, topic_slots=4))


class Package:
    """One package's facades and how a script sets its engine's deliver
    mask."""

    def __init__(self, mod, to_device):
        for name in ("DeviceValue", "DeviceLong", "DeviceMap", "DeviceSet",
                     "DeviceQueue", "DeviceMultiMap", "DeviceTopic",
                     "DeviceLock", "DeviceElection"):
            setattr(self, name, getattr(mod, name))
        self._to_device = to_device

    def set_deliver(self, rg, mask):
        rg.deliver = self._to_device(np.asarray(mask, bool))


REF = Package(jdr, jnp.asarray)
PORT = Package(tdr, torch.from_numpy)


def _engine_key(cfg, shape):
    return cfg, tuple(sorted({**SHAPE, **shape}.items()))


_REF_ELECTED: dict = {}


def reference_engine(cfg=JCFG, seed=5, leaders=True, **shape):
    """The reference's engine. With ``leaders``, every group's leader is
    elected once per config and shape; each later engine is restored from
    the reference's checkpoint of that state."""
    s = {**SHAPE, **shape}
    key = _engine_key(cfg, shape)
    if leaders and key in _REF_ELECTED:
        return jcheckpoint.load_bytes(_REF_ELECTED[key])
    ref = JaxRaftGroups(s["groups"], s["peers"], log_slots=s["log_slots"],
                        submit_slots=s["submit_slots"], seed=seed,
                        config=cfg)
    if leaders:
        ref.wait_for_leaders()
        _REF_ELECTED[key] = jcheckpoint.save_bytes(ref)
    return ref


def reference_scripts() -> dict:
    """The reference's side of every script, in ``SCRIPTS`` order as the
    cases run them: ``elected`` holds, per config and shape, the state
    leaves and engine key right after the election; ``runs`` each
    script's observations, rounds, events and final state leaves."""
    elected, runs = {}, {}
    for script, (cfg, shape, leaders) in SCRIPTS.items():
        key = _engine_key(cfg, shape)
        fresh = leaders and key not in _REF_ELECTED
        ref = reference_engine(cfg, leaders=leaders, **shape)
        if fresh:
            elected[key] = (state_leaves(ref), np.asarray(ref._key))
        want = script(ref, REF)
        runs[script.__name__] = (want, ref.rounds, ref.events,
                                 state_leaves(ref))
    return {"elected": elected, "runs": runs}


_PORT_ELECTED: dict = {}


def port_engine(elected, cfg=JCFG, seed=5, leaders=True, **shape):
    """The port's engine drawing the reference's timers from the same
    seed. With ``leaders``, every group's leader is elected once per
    config and shape, and the state must equal the reference's
    ``elected`` one; each later engine is restored from the port's
    checkpoint of that state, drawing on from the reference's key."""
    s = {**SHAPE, **shape}
    key = _engine_key(cfg, shape)
    if leaders and key in _PORT_ELECTED:
        return as_reference_drawn(
            tcheckpoint.load_bytes(_PORT_ELECTED[key], "cpu"),
            elected[key][1])
    port = ReferenceDrawnGroups(s["groups"], s["peers"], s["log_slots"],
                                s["submit_slots"], cfg, seed=seed)
    if leaders:
        port.wait_for_leaders()
        assert_same_state(elected[key][0], port, "leaders elected")
        _PORT_ELECTED[key] = tcheckpoint.save_bytes(port)
    return port


def run_ops(rg, ops, group=0):
    """Submit (opcode, a, b, c) tuples in order; return their results."""
    tags = [rg.submit(group, *op) for op in ops]
    rg.run_until(tags)
    return [rg.results[t] for t in tags]


def events(rg, group=0, code=None):
    evs = rg.events.get(group, [])
    return [e for e in evs if code is None or e[1] == code]


def leaf(rg, name):
    return convert.flat_leaves(rg.state)[name]


# ---------------------------------------------------------------------------
# test_device_resources.py
# ---------------------------------------------------------------------------

def map_put_get_remove(rg, pk):
    res = run_ops(rg, [
        (ap.OP_MAP_PUT, 7, 100), (ap.OP_MAP_PUT, 7, 200), (ap.OP_MAP_GET, 7),
        (ap.OP_MAP_CONTAINS_KEY, 7), (ap.OP_MAP_CONTAINS_KEY, 8),
        (ap.OP_MAP_CONTAINS_VALUE, 200), (ap.OP_MAP_SIZE,),
        (ap.OP_MAP_REMOVE, 7), (ap.OP_MAP_GET, 7), (ap.OP_MAP_IS_EMPTY,)])
    assert res == [0, 100, 200, 1, 0, 1, 1, 200, 0, 1]
    return res


def map_conditional_ops(rg, pk):
    res = run_ops(rg, [
        (ap.OP_MAP_PUT_IF_ABSENT, 1, 10), (ap.OP_MAP_PUT_IF_ABSENT, 1, 99),
        (ap.OP_MAP_GET, 1), (ap.OP_MAP_REPLACE, 1, 20),
        (ap.OP_MAP_REPLACE, 2, 5), (ap.OP_MAP_REPLACE_IF, 1, 20, 30),
        (ap.OP_MAP_REPLACE_IF, 1, 99, 40), (ap.OP_MAP_GET, 1),
        (ap.OP_MAP_REMOVE_IF, 1, 99), (ap.OP_MAP_REMOVE_IF, 1, 30),
        (ap.OP_MAP_GET_OR_DEFAULT, 1, 77)])
    assert res == [1, 0, 10, 10, FAIL, 1, 0, 30, 0, 1, 77]
    return res


def map_ttl_expiry(rg, pk):
    r1 = run_ops(rg, [(ap.OP_MAP_PUT, 5, 42, 3), (ap.OP_MAP_GET, 5)])
    rg.run(10)
    r2 = run_ops(rg, [(ap.OP_MAP_GET, 5), (ap.OP_MAP_SIZE,),
                      (ap.OP_MAP_CONTAINS_KEY, 5)])
    assert (r1, r2) == ([0, 42], [0, 0, 0])
    return r1 + r2


def map_clear_and_overflow(rg, pk):
    K = rg.config.resource.map_slots
    res = run_ops(rg, [(ap.OP_MAP_PUT, k, k * 10) for k in range(1, K + 1)])
    over = run_ops(rg, [(ap.OP_MAP_PUT, 999, 1)])
    after = run_ops(rg, [(ap.OP_MAP_SIZE,), (ap.OP_MAP_CLEAR,),
                         (ap.OP_MAP_SIZE,), (ap.OP_MAP_PUT, 999, 1)])
    assert res == [0] * K and over == [FAIL]
    assert after[0] == K and after[2] == 0 and after[3] == 0
    return res + over + after


def map_groups_are_isolated(rg, pk):
    t1 = rg.submit(0, ap.OP_MAP_PUT, 1, 111)
    t2 = rg.submit(1, ap.OP_MAP_PUT, 1, 222)
    rg.run_until([t1, t2])
    got = [run_ops(rg, [(ap.OP_MAP_GET, 1)], group=g) for g in range(3)]
    assert got == [[111], [222], [0]]
    return got


def set_semantics(rg, pk):
    res = run_ops(rg, [
        (ap.OP_SET_ADD, 5), (ap.OP_SET_ADD, 5), (ap.OP_SET_ADD, 9),
        (ap.OP_SET_CONTAINS, 5), (ap.OP_SET_CONTAINS, 6), (ap.OP_SET_SIZE,),
        (ap.OP_SET_REMOVE, 5), (ap.OP_SET_REMOVE, 5), (ap.OP_SET_SIZE,),
        (ap.OP_SET_CLEAR,), (ap.OP_SET_SIZE,)])
    assert res == [1, 0, 1, 1, 0, 2, 1, 0, 1, 0, 0]
    return res


def set_ttl(rg, pk):
    r1 = run_ops(rg, [(ap.OP_SET_ADD, 3, 0, 2)])
    rg.run(8)
    r2 = run_ops(rg, [(ap.OP_SET_CONTAINS, 3), (ap.OP_SET_SIZE,)])
    assert (r1, r2) == ([1], [0, 0])
    return r1 + r2


def queue_fifo(rg, pk):
    res = run_ops(rg, [
        (ap.OP_Q_POLL,), (ap.OP_Q_OFFER, 11), (ap.OP_Q_OFFER, 22),
        (ap.OP_Q_OFFER, 33), (ap.OP_Q_PEEK,), (ap.OP_Q_SIZE,),
        (ap.OP_Q_POLL,), (ap.OP_Q_POLL,), (ap.OP_Q_POLL,), (ap.OP_Q_POLL,)])
    assert res == [FAIL, 1, 1, 1, 11, 3, 11, 22, 33, FAIL]
    return res


def queue_full_and_clear(rg, pk):
    Q = rg.config.resource.queue_slots
    res = run_ops(rg, [(ap.OP_Q_OFFER, i) for i in range(Q + 2)])
    after = run_ops(rg, [(ap.OP_Q_CLEAR,), (ap.OP_Q_SIZE,),
                         (ap.OP_Q_OFFER, 7), (ap.OP_Q_POLL,)])
    assert res == [1] * Q + [0, 0] and after == [0, 0, 1, 7]
    return res + after


def lock_grant_queue_release(rg, pk):
    res = run_ops(rg, [
        (ap.OP_LOCK_ACQUIRE, 101, -1), (ap.OP_LOCK_ACQUIRE, 102, -1),
        (ap.OP_LOCK_ACQUIRE, 103, 0), (ap.OP_LOCK_RELEASE, 101),
        (ap.OP_LOCK_RELEASE, 102), (ap.OP_LOCK_RELEASE, 999)])
    grants = [e[2] for e in events(rg, code=ap.EV_LOCK_GRANT)]
    assert res == [1, 2, 0, 1, 1, 0] and grants == [102]
    assert events(rg, code=ap.EV_NONE) == []
    return res + grants


def lock_timeout_waiter_never_granted(rg, pk):
    res = run_ops(rg, [(ap.OP_LOCK_ACQUIRE, 1, -1),
                       (ap.OP_LOCK_ACQUIRE, 2, 3)])
    rg.run(10)
    res += run_ops(rg, [(ap.OP_LOCK_RELEASE, 1)])
    rg.run(10)
    holder = leaf(rg, "resources.lk_holder")[0]
    assert res == [1, 2, 1] and (holder == -1).all()
    assert events(rg, code=ap.EV_LOCK_GRANT) == []
    return res + holder.tolist()


def lock_cancel_orders_with_grant(rg, pk):
    res = run_ops(rg, [
        (ap.OP_LOCK_ACQUIRE, 1, -1), (ap.OP_LOCK_ACQUIRE, 2, -1),
        (ap.OP_LOCK_CANCEL, 2), (ap.OP_LOCK_RELEASE, 1),
        (ap.OP_LOCK_CANCEL, 3)])
    rg.run(10)
    holder = leaf(rg, "resources.lk_holder")[0]
    won = run_ops(rg, [(ap.OP_LOCK_ACQUIRE, 5, -1), (ap.OP_LOCK_CANCEL, 5)])
    assert res == [1, 2, 1, 1, 0] and (holder == -1).all() and won == [1, 2]
    return res + won


def lock_contention_fifo(rg, pk):
    res = run_ops(rg, [(ap.OP_LOCK_ACQUIRE, 10, -1)]
                  + [(ap.OP_LOCK_ACQUIRE, 10 + i, -1) for i in range(1, 5)]
                  + [(ap.OP_LOCK_RELEASE, 10 + i) for i in range(5)])
    grants = [e[2] for e in events(rg, code=ap.EV_LOCK_GRANT)]
    assert res == [1, 2, 2, 2, 2] + [1] * 5 and grants == [11, 12, 13, 14]
    return res + grants


def election_listen_promote_fencing(rg, pk):
    res = run_ops(rg, [(ap.OP_ELECT_LISTEN, 7), (ap.OP_ELECT_LISTEN, 8),
                       (ap.OP_ELECT_LISTEN, 9)])
    epoch7 = res[0]
    assert epoch7 > 0 and res[1:] == [0, 0]
    res += run_ops(rg, [(ap.OP_ELECT_IS_LEADER, 7, epoch7),
                        (ap.OP_ELECT_IS_LEADER, 8, epoch7),
                        (ap.OP_ELECT_RESIGN, 7)])
    elects = events(rg, code=ap.EV_ELECT)
    epoch8 = elects[-1][3]
    res += run_ops(rg, [(ap.OP_ELECT_IS_LEADER, 8, epoch8),
                        (ap.OP_ELECT_IS_LEADER, 7, epoch7),
                        (ap.OP_ELECT_RESIGN, 9), (ap.OP_ELECT_RESIGN, 8)])
    rg.run(10)
    leader = leaf(rg, "resources.el_leader")[0]
    assert res[3:] == [1, 0, 1, 1, 0, 0, 1] and epoch8 > epoch7
    assert [e[2] for e in elects] == [8] and (leader == -1).all()
    return res + [epoch8]


def lock_cancelled_waiters_free_capacity(rg, pk):
    W = rg.config.resource.wait_slots
    res = run_ops(rg, [(ap.OP_LOCK_ACQUIRE, 1, -1)])
    waiters = list(range(10, 10 + W))
    res += run_ops(rg, [(ap.OP_LOCK_ACQUIRE, w, -1) for w in waiters])
    res += run_ops(rg, [(ap.OP_LOCK_ACQUIRE, 99, -1)])
    res += run_ops(rg, [(ap.OP_LOCK_CANCEL, w) for w in waiters])
    res += run_ops(rg, [(ap.OP_LOCK_ACQUIRE, 99, -1), (ap.OP_LOCK_RELEASE, 1)])
    grants = [e[2] for e in events(rg, code=ap.EV_LOCK_GRANT)]
    assert res == [1] + [2] * W + [0] + [1] * W + [2, 1] and grants == [99]
    return res + grants


def lock_acquire_idempotent(rg, pk):
    res = run_ops(rg, [
        (ap.OP_LOCK_ACQUIRE, 1, -1), (ap.OP_LOCK_ACQUIRE, 1, -1),
        (ap.OP_LOCK_ACQUIRE, 2, -1), (ap.OP_LOCK_ACQUIRE, 2, -1),
        (ap.OP_LOCK_HOLDER,), (ap.OP_LOCK_RELEASE, 1), (ap.OP_LOCK_HOLDER,),
        (ap.OP_LOCK_RELEASE, 2), (ap.OP_LOCK_HOLDER,)])
    assert res == [1, 1, 2, 2, 1, 1, 2, 1, -1]
    return res


def election_duplicate_listen(rg, pk):
    epoch7 = run_ops(rg, [(ap.OP_ELECT_LISTEN, 7)])[0]
    res = run_ops(rg, [
        (ap.OP_ELECT_LISTEN, 7), (ap.OP_ELECT_LISTEN, 8),
        (ap.OP_ELECT_LISTEN, 8), (ap.OP_ELECT_LEADER,),
        (ap.OP_ELECT_RESIGN, 7), (ap.OP_ELECT_LEADER,),
        (ap.OP_ELECT_RESIGN, 8), (ap.OP_ELECT_LEADER,)])
    assert epoch7 > 0 and res == [epoch7, 0, 0, 7, 1, 8, 1, -1]
    return res


def value_ttl_survives_failed_cas(rg, pk):
    res = run_ops(rg, [(ap.OP_VALUE_SET, 5, 0, 5), (ap.OP_VALUE_CAS, 7, 9)])
    rg.run(15)
    res += run_ops(rg, [(ap.OP_VALUE_GET,)])
    assert res == [0, 0, 0]
    return res


def counters_only_config(rg, pk):
    res = run_ops(rg, [(ap.OP_LONG_ADD, 5), (ap.OP_LONG_ADD, 5),
                       (ap.OP_VALUE_GET,)])
    res += run_ops(rg, [(ap.OP_MAP_PUT, 1, 2), (ap.OP_SET_ADD, 1),
                        (ap.OP_Q_OFFER, 1)])
    res += run_ops(rg, [(ap.OP_LOCK_ACQUIRE, 7, 0),
                        (ap.OP_LOCK_ACQUIRE, 8, -1), (ap.OP_LOCK_HOLDER,),
                        (ap.OP_LOCK_RELEASE, 7), (ap.OP_LOCK_HOLDER,)])
    epoch = run_ops(rg, [(ap.OP_ELECT_LISTEN, 5)])[0]
    res += run_ops(rg, [(ap.OP_ELECT_LISTEN, 6),
                        (ap.OP_ELECT_IS_LEADER, 5, epoch),
                        (ap.OP_ELECT_RESIGN, 5), (ap.OP_ELECT_LEADER,)])
    assert epoch > 0 and res == [5, 10, 10] + [FAIL] * 3 \
        + [1, 0, 7, 1, -1] + [FAIL, 1, 1, -1]
    return res


def all_pools_converge_under_partitions(rg, pk):
    G, P = rg.num_groups, rg.num_peers
    rng = np.random.default_rng(3)
    ops = [(ap.OP_MAP_PUT, 1, 10), (ap.OP_SET_ADD, 2), (ap.OP_Q_OFFER, 3),
           (ap.OP_LOCK_ACQUIRE, 4, -1), (ap.OP_ELECT_LISTEN, 5),
           (ap.OP_MAP_PUT, 6, 60, 4), (ap.OP_LOCK_RELEASE, 4),
           (ap.OP_VALUE_SET, 8), (ap.OP_Q_POLL,), (ap.OP_MAP_REMOVE, 1)]
    for i, op in enumerate(ops):
        for g in range(G):
            rg.submit(g, *op)
        if i % 3 == 0:
            pk.set_deliver(rg, rng.random((G, P, P)) > 0.3)
        rg.run(4)
    pk.set_deliver(rg, np.ones((G, P, P), bool))
    rg.run(40)
    leaves = convert.flat_leaves(rg.state)
    applied = leaves["applied_index"]
    assert (applied == applied[:, :1]).all()
    for name, arr in leaves.items():
        if name.startswith("resources.") and ".ev_" not in "." + name[10:]:
            assert (arr == arr[:, :1]).all(), name
    return applied.tolist()


def _overflow_setup(rg, pk):
    a, b = pk.DeviceLock(rg, 0, 1), pk.DeviceLock(rg, 0, 2)
    e1, e2 = pk.DeviceElection(rg, 0, 11), pk.DeviceElection(rg, 0, 12)
    a.lock()
    assert e1.listen() is not None and e2.listen() is None
    acquire = rg.submit(0, ap.OP_LOCK_ACQUIRE, 2, -1)
    rg.run_until([acquire])
    assert rg.results.pop(acquire) not in (0, 1)
    return b, e2


def _same_round(rg, ops):
    tags = [rg.submit(0, *op) for op in ops]
    rg.run_until(tags)
    return [rg.results.pop(t) for t in tags]


def lost_lock_grant_recovered(rg, pk):
    b, e2 = _overflow_setup(rg, pk)
    res = _same_round(rg, [(ap.OP_LOCK_RELEASE, 1), (ap.OP_ELECT_RESIGN, 11)])
    rg.run(8)
    evs = events(rg)
    assert res == [1, 1]
    assert any(c == ap.EV_ELECT and t == 12 for _, c, t, _a in evs)
    assert not any(c == ap.EV_LOCK_GRANT for _, c, t, _a in evs)
    out = [b._await_grant(None), b._call(ap.OP_LOCK_HOLDER),
           e2.poll_elected(), e2.is_leader()]
    assert out[:2] == [True, 2] and out[2] is not None and out[3]
    return res + out


def lost_elect_event_recovered(rg, pk):
    b, e2 = _overflow_setup(rg, pk)
    res = _same_round(rg, [(ap.OP_ELECT_RESIGN, 11), (ap.OP_LOCK_RELEASE, 1)])
    rg.run(8)
    evs = events(rg)
    assert res == [1, 1]
    assert any(c == ap.EV_LOCK_GRANT and t == 2 for _, c, t, _a in evs)
    assert not any(c == ap.EV_ELECT for _, c, t, _a in evs)
    epoch = None
    for _ in range(25):
        epoch = e2.poll_elected()
        if epoch is not None:
            break
    out = [epoch, e2.is_leader(epoch), b._await_grant(None)]
    assert epoch is not None and out[1] and out[2]
    return res + out


# ---------------------------------------------------------------------------
# test_device_facades.py
# ---------------------------------------------------------------------------

def value_and_long(rg, pk):
    v = pk.DeviceValue(rg, 0)
    v.set(10)
    out = [v.get(), v.compare_and_set(10, 20), v.compare_and_set(10, 30),
           v.get_and_set(5)]
    n = pk.DeviceLong(rg, 1)
    out += [n.increment_and_get(), n.add_and_get(9), n.get_and_add(5),
            n.decrement_and_get(), n.get()]
    assert out == [10, True, False, 20, 1, 10, 10, 14, 14]
    return out


def map_facade(rg, pk):
    m = pk.DeviceMap(rg, 2)
    out = [m.put(1, 100), m.get(1), m.put_if_absent(1, 999),
           m.put_if_absent(2, 200), m.contains_key(2), m.contains_key(3),
           m.contains_value(200), m.size(), m.replace(1, 111),
           m.replace(42, 1), m.replace_if(1, 111, 112), m.remove(1),
           m.get_or_default(1, 7)]
    m.clear()
    out.append(m.is_empty())
    assert out == [0, 100, False, True, True, False, True, 2, 100, None,
                   True, 112, 7, True]
    return out


def set_queue_facades(rg, pk):
    s = pk.DeviceSet(rg, 3)
    out = [s.add(5), s.add(5), s.contains(5), s.size(), s.remove(5),
           s.is_empty()]
    q = pk.DeviceQueue(rg, 3)
    out.append(q.poll())
    q.add(1)
    out += [q.offer(2), q.peek(), q.size(), q.poll(), q.poll(), q.poll()]
    assert out == [True, False, True, 1, True, True, None, True, 1, 2, 1, 2,
                   None]
    return out


def lock_facade_two_clients(rg, pk):
    a = pk.DeviceLock(rg, 0, holder_id=101)
    b = pk.DeviceLock(rg, 0, holder_id=102)
    a.lock()
    out = [b.try_lock(), b.try_lock(timeout=3)]
    a.unlock()
    out.append(b.try_lock())
    b.unlock()
    assert out == [False, False, True]
    return out


def lock_blocking_handoff(rg, pk):
    """Two holders hand the lock over through the grant event."""
    a = pk.DeviceLock(rg, 0, holder_id=1)
    b = pk.DeviceLock(rg, 0, holder_id=2)
    a.lock()
    tag = rg.submit(0, ap.OP_LOCK_ACQUIRE, 2, -1)
    rg.run_until([tag])
    a.unlock()
    out = [rg.results[tag], b._await_grant(None),
           [e[2] for e in events(rg, code=ap.EV_LOCK_GRANT)]]
    b.unlock()
    assert out == [2, True, [2]]
    return out


def no_stale_grant_after_immediate_grant(rg, pk):
    a = pk.DeviceLock(rg, 0, holder_id=1)
    b = pk.DeviceLock(rg, 0, holder_id=2)
    out = [a.try_lock()]
    a.unlock()
    b.lock()
    out.append(a.try_lock(timeout=5))
    b.unlock()
    assert out == [True, False]
    return out


def election_facade(rg, pk):
    """The election hands off from a resigning leader to its successor."""
    e1 = pk.DeviceElection(rg, 0, candidate_id=11)
    e2 = pk.DeviceElection(rg, 0, candidate_id=22)
    epoch1 = e1.listen()
    out = [epoch1, e1.is_leader(), e2.listen(), e2.is_leader()]
    e1.resign()
    rg.run(10)
    out += [e2.poll_elected(), e2.is_leader(), e1.is_leader(epoch1)]
    assert epoch1 and out[1:4] == [True, None, False]
    assert out[4] is not None and out[5:] == [True, False]
    return out


def sequential_reads_via_query_lane(rg, pk):
    m = pk.DeviceMap(rg, 0).with_consistency("sequential")
    v = pk.DeviceValue(rg, 1).with_consistency("sequential")
    m.put(3, 33)
    v.set(77)
    before = int(leaf(rg, "last_index")[0].max())
    out = [m.get(3), m.get_or_default(9, 42), m.contains_key(3),
           m.contains_key(9), m.size(), v.get()]
    assert out == [33, 42, True, False, 1, 77]
    assert int(leaf(rg, "last_index")[0].max()) == before
    return out + [rg.metrics.counter("queries_served").value]


def query_lane_escalates_without_leader(rg, pk):
    assert rg.leader(0) == -1
    tag = rg.submit_query(0, ap.OP_VALUE_GET)
    rg.step_round()
    escalated = rg.metrics.counter("queries_escalated").value
    rg.run_until([tag])
    assert escalated >= 1 and rg.results[tag] == 0
    return [escalated, rg.results[tag]]


def sequential_reads_are_monotone(rg, pk):
    counter = pk.DeviceLong(rg, 0)
    reader = pk.DeviceLong(rg, 0).with_consistency("sequential")
    seen = []
    for _ in range(10):
        counter.add_and_get(1)
        seen.append(reader.get())
    assert seen == sorted(seen) and seen[-1] == 10
    return seen


def query_lane_rejects_write_opcodes(rg, pk):
    with pytest.raises(ValueError, match="not read-only"):
        rg.submit_query(0, ap.OP_MAP_PUT, 1, 2)
    return []


# ---------------------------------------------------------------------------
# test_device_multimap_topic.py
# ---------------------------------------------------------------------------

def multimap_kernel_semantics(rg, pk):
    mm = pk.DeviceMultiMap(rg, 0)
    out = [mm.is_empty(), mm.put(1, 10), mm.put(1, 11), mm.put(1, 10),
           mm.put(2, 10), mm.size(), mm.count(1), mm.contains_key(1),
           mm.contains_entry(1, 11), mm.contains_entry(2, 11),
           mm.contains_value(10), mm.remove_entry(1, 11),
           mm.remove_entry(1, 11), mm.count(1), mm.remove(1),
           mm.contains_key(1), mm.size()]
    mm.clear()
    out.append(mm.is_empty())
    assert out == [True, True, True, False, True, 3, 2, True, True, False,
                   True, True, False, 1, 1, False, 1, True]
    return out


def multimap_ttl_expiry(rg, pk):
    mm = pk.DeviceMultiMap(rg, 0)
    out = [mm.put(7, 70, ttl=3), mm.contains_entry(7, 70)]
    rg.run(6)
    out += [mm.contains_entry(7, 70), mm.size()]
    for field in ("mm_key", "mm_val", "mm_live", "mm_dl"):
        arr = leaf(rg, f"resources.{field}")
        assert (arr == arr[:, :1]).all(), field
    assert out == [True, True, False, 0]
    return out


def topic_fans_out_to_subscribers(rg, pk):
    """Publishes fan out to the subscribers of the moment, by event."""
    alice = pk.DeviceTopic(rg, 0, subscriber_id=1)
    bob = pk.DeviceTopic(rg, 0, subscriber_id=2)
    alice.subscribe()
    out = [alice.subscriber_count(),
           pk.DeviceTopic(rg, 0, subscriber_id=9).publish(41)]
    rg.run(4)
    out += [alice.poll_messages(), bob.poll_messages()]
    bob.subscribe()
    pub = pk.DeviceTopic(rg, 0, subscriber_id=9)
    out += [bob.subscriber_count(), pub.publish(42), pub.publish(43)]
    rg.run(4)
    out += [alice.poll_messages(), bob.poll_messages()]
    alice.unsubscribe()
    out.append(pub.publish(44))
    rg.run(4)
    out += [alice.poll_messages(), bob.poll_messages()]
    assert out == [1, 1, [41], [], 2, 2, 2, [42, 43], [42, 43], 1, [], [44]]
    return out


def topic_subscribe_idempotent_and_bounded(rg, pk):
    T = rg.config.resource.topic_slots
    t = pk.DeviceTopic(rg, 1, subscriber_id=5)
    t.subscribe()
    t.subscribe()
    out = [t.subscriber_count()]
    for i in range(T - 1):
        pk.DeviceTopic(rg, 1, subscriber_id=10 + i).subscribe()
    full = pk.DeviceTopic(rg, 1, subscriber_id=99)
    out.append(full._call(ap.OP_TOPIC_LISTEN, 99))
    assert out == [1, FAIL]
    return out


def multimap_topic_among_other_pools(rg, pk):
    tags = {
        "add": rg.submit(0, ap.OP_LONG_ADD, 5),
        "mapput": rg.submit(0, ap.OP_MAP_PUT, 1, 100),
        "mmput": rg.submit(0, ap.OP_MM_PUT, 1, 200),
        "sub": rg.submit(0, ap.OP_TOPIC_LISTEN, 3),
        "pub": rg.submit(0, ap.OP_TOPIC_PUB, 77),
        "mmcount": rg.submit(0, ap.OP_MM_COUNT, 1)}
    rg.run_until(list(tags.values()))
    out = {k: rg.results[t] for k, t in tags.items()}
    assert out == dict(add=5, mapput=0, mmput=1, sub=1, pub=1, mmcount=1)
    assert any(c == ap.EV_TOPIC_MSG and a == 77
               for _, c, _t, a in events(rg))
    return out


_OVERFLOW = Config(resource=ResourceConfig(
    map_slots=0, set_slots=0, queue_slots=0, wait_slots=4, listener_slots=4,
    event_slots=1, multimap_slots=0, topic_slots=0))
_BUDGETS = JCFG._replace(applies_per_round=8,
                         pool_budgets=(2, 2, 2, 2, 2, 2, 2, 2))

# script -> (config, shape overrides, leaders elected first)
SCRIPTS = {
    map_put_get_remove: (JCFG, {}, True),
    map_conditional_ops: (JCFG, {}, True),
    map_ttl_expiry: (JCFG, {}, True),
    map_clear_and_overflow: (JCFG, {}, True),
    map_groups_are_isolated: (JCFG, {}, True),
    set_semantics: (JCFG, {}, True),
    set_ttl: (JCFG, {}, True),
    queue_fifo: (JCFG, {}, True),
    queue_full_and_clear: (JCFG, {}, True),
    lock_grant_queue_release: (JCFG, {}, True),
    lock_timeout_waiter_never_granted: (JCFG, {}, True),
    lock_cancel_orders_with_grant: (JCFG, {}, True),
    lock_contention_fifo: (JCFG, {}, True),
    election_listen_promote_fencing: (JCFG, {}, True),
    lock_cancelled_waiters_free_capacity: (JCFG, {}, True),
    lock_acquire_idempotent: (JCFG, {}, True),
    election_duplicate_listen: (JCFG, {}, True),
    value_ttl_survives_failed_cas: (JCFG, {}, True),
    counters_only_config: (Config(resource=ResourceConfig.counters_only()),
                           {}, True),
    all_pools_converge_under_partitions: (JCFG, {}, True),
    lost_lock_grant_recovered: (_OVERFLOW, {}, True),
    lost_elect_event_recovered: (_OVERFLOW, {}, True),
    value_and_long: (JCFG, {}, True),
    map_facade: (JCFG, {}, True),
    set_queue_facades: (JCFG, {}, True),
    lock_facade_two_clients: (JCFG, {}, True),
    lock_blocking_handoff: (JCFG, {}, True),
    no_stale_grant_after_immediate_grant: (JCFG, {}, True),
    election_facade: (JCFG, {}, True),
    sequential_reads_via_query_lane: (JCFG, {}, True),
    query_lane_escalates_without_leader: (JCFG, {}, False),
    sequential_reads_are_monotone: (JCFG, {}, True),
    query_lane_rejects_write_opcodes: (JCFG, {}, False),
    multimap_kernel_semantics: (JCFG, {}, True),
    multimap_ttl_expiry: (JCFG, {}, True),
    topic_fans_out_to_subscribers: (JCFG, {}, True),
    topic_subscribe_idempotent_and_bounded: (JCFG, {}, True),
    multimap_topic_among_other_pools: (_BUDGETS, {"submit_slots": 8}, True),
}


LONG_RUNS[f"{os.path.basename(__file__)}::"
          "test_facade_script_matches_reference"] = [
    ("device_resources", reference_scripts, ())]


@pytest.mark.parametrize("script", list(SCRIPTS), ids=lambda f: f.__name__)
def test_facade_script_matches_reference(script):
    cfg, shape, leaders = SCRIPTS[script]
    ref = SUITE_AHEAD.get("device_resources", reference_scripts)
    port = port_engine(ref["elected"], cfg, leaders=leaders, **shape)
    want, rounds, events_, leaves = ref["runs"][script.__name__]
    got = script(port, PORT)
    assert got == want
    assert port.rounds == rounds and port.events == events_
    assert_same_state(leaves, port, script.__name__)
