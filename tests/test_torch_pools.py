"""The port's resource pools against the JAX reference, kernel by kernel.

Each pool kernel of ``copycat_tpu_torch/ops/apply.py`` runs beside its
reference in ``copycat_tpu/ops/apply.py`` on the same random lanes, once
per opcode of the pool (and once on opcodes drawn from the whole
catalog), three applies in a chain. The lanes hold TTL deadlines on both
sides of ``now``, full tables and full rings, rings that wrap, dead
waiters and listeners inside the window, duplicate keys and pairs, and
``live`` false. Every state leaf, the result and the events must be
equal, value and dtype. The ring helpers, ``push_events_window`` (more
events than the ring holds) and ``apply_window`` (budgets ``(1,)*8``,
mixed and ``(A,)*8``) are held the same way. The reference's side of the
pool kernel chains and of the ``apply_window`` rounds depends on nothing
of the port's: it runs once, in a worker process started with the
session's first port file (``torch_reference.LONG_RUNS``), and comes back
to the cases.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import (  # noqa: E402,F401
    LONG_RUNS,
    SUITE_AHEAD,
    as_numpy,
    release_jax_programs,
)
import jax.numpy as jnp  # noqa: E402

from copycat_tpu.ops import apply as jap  # noqa: E402

from copycat_tpu_torch import convert  # noqa: E402
from copycat_tpu_torch.ops import apply as tap  # noqa: E402

G, P = 32, 3
INT_MAX = np.iinfo(np.int32).max
OPCODES = sorted({v for k, v in vars(jap).items() if k.startswith("OP_")})


def _same(want, got, what):
    """Equal values, dtypes and shapes, leaf by leaf, of two (nested)
    tuples of arrays."""
    if isinstance(want, (tuple, list)):
        assert len(want) == len(got), what
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, f"{what}[{i}]")
        return
    w = np.asarray(want)
    g = got.numpy()
    assert (g.dtype, g.shape) == (w.dtype, w.shape), what
    np.testing.assert_array_equal(g, w, err_msg=what)


def _i(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape).astype(np.int32)


def _deadlines(rng, now, n):
    """TTL deadlines on both sides of ``now``; 0 (no TTL) for 40%."""
    dl = now[..., None] + _i(rng, -2, 3, (G, P, n))
    dl[rng.random((G, P, n)) < 0.4] = 0
    return dl


def _table(rng, n):
    """Slot liveness with a quarter of the lanes full."""
    live = rng.random((G, P, n)) < 0.6
    live[rng.random((G, P)) < 0.25] = True
    return live


def _ring(rng, n, now, forever=False):
    """(ids, deadlines, live, head, size) of a wait/listener ring: heads
    far past n (the ring wraps), a quarter of the lanes full, dead
    entries inside the window."""
    ids = _i(rng, 0, 4, (G, P, n))
    dl = now[..., None] + _i(rng, -2, 4, (G, P, n))
    if forever:
        dl[rng.random((G, P, n)) < 0.3] = INT_MAX
    live = rng.random((G, P, n)) < 0.7
    head = _i(rng, 0, 40, (G, P))
    size = _i(rng, 0, n + 1, (G, P))
    size[rng.random((G, P)) < 0.25] = n
    return ids, dl, live, head, size


# Per pool: (pool id, first opcode, last opcode, random state maker,
# reference kernel under the port's uniform signature).
def _map_state(rng, now, n=5):
    live = _table(rng, n)
    dl = _deadlines(rng, now, n)
    dl[live.all(-1)] = 0                       # full tables stay full
    return (_i(rng, 0, 4, (G, P, n)), _i(rng, -3, 4, (G, P, n)), live, dl)


def _set_state(rng, now, n=4):
    mk, _, live, dl = _map_state(rng, now, n)
    return (mk, live, dl)


def _queue_state(rng, now, n=4):
    size = _i(rng, 0, n + 1, (G, P))
    size[rng.random((G, P)) < 0.25] = n
    return (_i(rng, -5, 6, (G, P, n)), _i(rng, 0, 40, (G, P)), size)


def _lock_state(rng, now, n=4):
    ids, dl, live, head, size = _ring(rng, n, now, forever=True)
    return (_i(rng, -1, 4, (G, P)), ids, dl, live, head, size)


def _elect_state(rng, now, n=4):
    ids, _, live, head, size = _ring(rng, n, now)
    return (_i(rng, -1, 4, (G, P)), _i(rng, 0, 9, (G, P)), ids, live, head,
            size)


def _mm_state(rng, now, n=6):
    live = _table(rng, n)
    dl = _deadlines(rng, now, n)
    dl[live.all(-1)] = 0
    return (_i(rng, 0, 3, (G, P, n)), _i(rng, 0, 3, (G, P, n)), live, dl)


def _topic_state(rng, now, n=4):
    return (_i(rng, 0, 5, (G, P, n)), _table(rng, n))


POOLS = {
    "value": (jap.POOL_VALUE, jap.OP_VALUE_SET, jap.OP_LONG_ADD,
              lambda rng, now: (_i(rng, -3, 4, (G, P)),
                                _deadlines(rng, now, 1)[..., 0]),
              lambda st, op, a, b, c, i, n, lv: jap.apply_value(
                  *st, op, a, b, c, n, lv)),
    "map": (jap.POOL_MAP, jap.OP_MAP_PUT, jap.OP_MAP_CLEAR, _map_state,
            lambda st, op, a, b, c, i, n, lv: jap.apply_map(
                *st, op, a, b, c, n, lv)),
    "set": (jap.POOL_SET, jap.OP_SET_ADD, jap.OP_SET_CLEAR, _set_state,
            lambda st, op, a, b, c, i, n, lv: jap.apply_set(
                *st, op, a, b, c, n, lv)),
    "queue": (jap.POOL_QUEUE, jap.OP_Q_OFFER, jap.OP_Q_CLEAR, _queue_state,
              lambda st, op, a, b, c, i, n, lv: jap.apply_queue(
                  *st, op, a, b, c, n, lv)),
    "lock": (jap.POOL_LOCK, jap.OP_LOCK_ACQUIRE, jap.OP_LOCK_HOLDER,
             _lock_state,
             lambda st, op, a, b, c, i, n, lv: jap.apply_lock(
                 *st, op, a, b, n, lv)),
    "elect": (jap.POOL_ELECT, jap.OP_ELECT_LISTEN, jap.OP_ELECT_GET_EPOCH,
              _elect_state,
              lambda st, op, a, b, c, i, n, lv: jap.apply_elect(
                  *st, op, a, b, i, lv)),
    "multimap": (jap.POOL_MMAP, jap.OP_MM_PUT, jap.OP_MM_CLEAR, _mm_state,
                 lambda st, op, a, b, c, i, n, lv: jap.apply_multimap(
                     *st, op, a, b, c, n, lv)),
    "topic": (jap.POOL_TOPIC, jap.OP_TOPIC_LISTEN, jap.OP_TOPIC_COUNT,
              _topic_state,
              lambda st, op, a, b, c, i, n, lv: jap.apply_topic(
                  *st, op, a, b, n, lv)),
}

CASES = [(name, op) for name, (_, lo, hi, _, _) in POOLS.items()
         for op in range(lo, hi + 1)] + [(name, "any") for name in POOLS]


def _args(rng, opcode, now):
    """Entry fields for one apply: keys/ids small enough to hit often,
    lock timeouts of every kind (-1 forever, 0 try, > 0)."""
    if opcode == "any":
        op = rng.choice(OPCODES, (G, P)).astype(np.int32)
    else:
        op = np.full((G, P), opcode, np.int32)
    a = _i(rng, -1, 5, (G, P))
    b = rng.choice([-1, 0, 1, 2, 3], (G, P)).astype(np.int32)
    c = _i(rng, 0, 4, (G, P))
    index = _i(rng, 1, 60, (G, P))
    live = rng.random((G, P)) < 0.85
    return op, a, b, c, index, now, live


# each pool's reference kernel compiled as one program (the same jnp ops
# as dispatching them one by one, without a small compile for each)
REF_KERNELS = {name: jax.jit(pool[4]) for name, pool in POOLS.items()}


def _reference_chain(pool, opcode):
    """The reference's side of one pool case: the pool state it starts
    from, and per apply the entry's fields and the reference kernel's
    outputs, as numpy."""
    rng = np.random.default_rng(CASES.index((pool, opcode)))
    now = _i(rng, 5, 15, (G, P))
    start = want_st = POOLS[pool][3](rng, now)
    steps = []
    for step in range(3):
        fields = _args(rng, opcode, now + step)
        want = REF_KERNELS[pool](want_st, *fields)
        steps.append((fields, jax.tree.map(np.asarray, want)))
        want_st = want[0]
    return tuple(np.asarray(x) for x in start), steps


def _reference_chains() -> dict:
    """Every pool case's reference side, in one worker."""
    return {case: _reference_chain(*case) for case in CASES}


@pytest.mark.parametrize("pool,opcode", CASES,
                         ids=[f"{p}-{o}" for p, o in CASES])
def test_pool_kernel_matches_reference(pool, opcode):
    pid = POOLS[pool][0]
    start, steps = SUITE_AHEAD.get("pools", _reference_chains)[
        (pool, opcode)]
    got_st = tuple(torch.from_numpy(x) for x in start)
    for step, (fields, want) in enumerate(steps):
        got = tap.POOL_KERNELS[pid](*got_st,
                                    *(torch.from_numpy(x) for x in fields))
        _same(want, got, f"{pool} opcode {opcode} apply {step}")
        got_st = got[0]


@pytest.mark.parametrize("N", [1, 4, 7])
def test_first_true_and_ring_pos_match_reference(N):
    rng = np.random.default_rng(N)
    mask = rng.random((G, P, N)) < 0.3
    mask[:4] = False                             # no hit at all
    _same(jap._first_true(jnp.asarray(mask)),
          tap._first_true(torch.from_numpy(mask)), "first_true")
    head = _i(rng, -5, 50, (G, P))
    _same(jap._ring_pos(jnp.asarray(head), N),
          tap._ring_pos(torch.from_numpy(head), N), "ring_pos")


@pytest.mark.parametrize("N", [1, 3, 8])
def test_ring_compact_matches_reference(N):
    """The stable live-first compaction moves every slot exactly where
    the reference's one-hot permutation does."""
    rng = np.random.default_rng(10 + N)
    head = _i(rng, 0, 30, (G, P))
    size = _i(rng, 0, N + 1, (G, P))
    pos = np.array(jap._ring_pos(jnp.asarray(head), N))
    live_arr = rng.random((G, P, N)) < 0.6
    live_win = live_arr & (pos < size[..., None])
    mask = rng.random((G, P)) < 0.7
    ids, dl = _i(rng, 0, 9, (G, P, N)), _i(rng, -9, 9, (G, P, N))
    args = (mask, head, size, pos, live_arr, live_win, ids, dl)
    want = jap._ring_compact(*(jnp.asarray(x) for x in args))
    got = tap._ring_compact(*(torch.from_numpy(x) for x in args))
    _same(want, got, "ring_compact")


def _window_state(rng, rc):
    res = jap.init_resources(G, P, rc)
    E = rc.event_slots
    tail = _i(rng, 0, 40, (G, P))
    return res._replace(
        ev_code=jnp.asarray(_i(rng, 0, 5, (G, P, E))),
        ev_target=jnp.asarray(_i(rng, -1, 5, (G, P, E))),
        ev_arg=jnp.asarray(_i(rng, 0, 99, (G, P, E))),
        ev_tail=jnp.asarray(tail),
        ev_head=jnp.asarray(np.maximum(tail - _i(rng, 0, E + 1, (G, P)), 0)))


@pytest.mark.parametrize("E,A", [(3, 8), (4, 4), (8, 3)])
def test_push_events_window_matches_reference(E, A):
    """Windows carrying more events than the ring holds keep only the
    last E, as pushing them one at a time would."""
    rng = np.random.default_rng(E * 10 + A)
    rc = jap.ResourceConfig.counters_only()._replace(event_slots=E)
    jres = _window_state(rng, rc)
    tres = convert.resources_to_torch(jres, "cpu")
    for r in range(4):
        mask = rng.random((G, P, A)) < (0.9 if r % 2 else 0.4)
        vals = [_i(rng, -1, 9, (G, P, A)) for _ in range(3)]
        jres = jap.push_events_window(jres, jnp.asarray(mask),
                                      *(jnp.asarray(v) for v in vals))
        tres = tap.push_events_window(tres, torch.from_numpy(mask),
                                      *(torch.from_numpy(v) for v in vals))
        _same(tuple(jres), tuple(tres), f"window {r}")
    assert (np.asarray(jres.ev_tail) - np.asarray(jres.ev_head) == E).any()


# small pools: the reference compiles apply_window once per budget tuple
RC_SMALL = jap.ResourceConfig(map_slots=4, set_slots=3, queue_slots=3,
                              wait_slots=3, listener_slots=3, event_slots=4,
                              multimap_slots=4, topic_slots=3)
A_WIN = 8
WINDOW_BUDGETS = [(1,) * 8, (2, 3, 1, 2, 2, 1, 2, 1), (A_WIN,) * 8]

# The reference's apply_window runs: each budget tuple compiles its own
# program, the full budgets' for tens of seconds, so a session that holds
# the case starts them with its first port file that runs the reference
# (``torch_reference.LONG_RUNS``).


def _reference_windows(budgets):
    """The reference's side of the apply_window case: eight rounds of
    windows drawn from the whole catalog, each a committed prefix of
    random length, the next round's indices following what the reference
    admitted; per round the window's fields and the reference's resource
    state, results and admitted mask after it."""
    rng = np.random.default_rng(sum(budgets))
    ref = jax.jit(jap.apply_window, static_argnums=(8,))
    jres = jap.init_resources(G, P, RC_SMALL)
    shape = (G, P, A_WIN)
    base = np.zeros((G, P), np.int32)
    rounds = []
    for r in range(8):
        op = rng.choice(OPCODES, shape).astype(np.int32)
        a, b = _i(rng, -1, 4, shape), _i(rng, -1, 4, shape)
        c = _i(rng, 0, 4, shape)
        index = base[..., None] + 1 + np.arange(A_WIN, dtype=np.int32)
        now = np.broadcast_to(np.int32(r), shape).copy()
        do = np.arange(A_WIN) < _i(rng, 0, A_WIN + 1, (G, P))[..., None]
        fields = (op, a, b, c, index, now, do)
        jres, jresult, jadm = ref(jres, *fields, budgets)
        rounds.append((fields, jres, jresult, jadm))
        base = base + np.asarray(jadm).sum(-1, dtype=np.int32)
    return as_numpy(rounds)


LONG_RUNS[f"{os.path.basename(__file__)}::"
          "test_apply_window_matches_reference"] = [
    (("apply_window", budgets), _reference_windows, (budgets,))
    for budgets in WINDOW_BUDGETS]
LONG_RUNS[f"{os.path.basename(__file__)}::"
          "test_pool_kernel_matches_reference"] = [
    ("pools", _reference_chains, ())]


@pytest.mark.parametrize("budgets", WINDOW_BUDGETS,
                         ids=["tight", "mixed", "full"])
def test_apply_window_matches_reference(budgets):
    """Eight rounds of windows drawn from the whole catalog, each a
    committed prefix of random length: state, results and the admitted
    mask equal the reference's every round."""
    rounds = SUITE_AHEAD.get(("apply_window", budgets), _reference_windows,
                             budgets)
    tres = convert.resources_to_torch(jap.init_resources(G, P, RC_SMALL),
                                      "cpu")
    deferred = 0
    for r, (fields, jres, jresult, jadm) in enumerate(rounds):
        tres, tresult, tadm = tap.apply_window(
            tres, *(torch.from_numpy(x) for x in fields), budgets)
        _same((tuple(jres), jresult, jadm), (tuple(tres), tresult, tadm),
              f"budgets {budgets} round {r}")
        deferred += int((fields[-1] & ~np.asarray(jadm)).sum())
    assert (deferred > 0) == (budgets != (A_WIN,) * 8)
