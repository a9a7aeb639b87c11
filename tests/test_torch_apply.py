"""``copycat_tpu_torch/ops/apply.py`` against the JAX reference
(``copycat_tpu/ops/apply.py``) through ``apply_entry``.

Every opcode of the catalog goes through ``apply_entry`` on both sides
from the same random lanes, under ``ResourceConfig.counters_only()`` —
TTL'd values with ``now`` on both sides of the deadline, lock holders and
election leaders set and free, lanes live and not — and under the default
``ResourceConfig()`` with every pool, from pools filled by a random run
of the whole catalog. Every resource leaf and the result must be equal.
The event ring (push and drain) is checked the same way with a nonzero
ring. The pool kernels one by one are in ``test_torch_pools.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from copycat_tpu.ops import apply as jap  # noqa: E402

from copycat_tpu_torch import convert  # noqa: E402
from copycat_tpu_torch.ops import apply as tap  # noqa: E402

G, P = 24, 3
OPCODES = sorted({v for k, v in vars(jap).items() if k.startswith("OP_")})


def _same(want, got, what):
    w, g = convert.flat_leaves(want), convert.flat_leaves(got)
    assert w.keys() == g.keys()
    for name in w:
        assert (g[name].dtype, g[name].shape) == (w[name].dtype, w[name].shape)
        np.testing.assert_array_equal(g[name], w[name],
                                      err_msg=f"{what}: {name}")


def _random_resources(rng, rc):
    res = jap.init_resources(G, P, rc)
    now = rng.integers(5, 15, (G, P)).astype(np.int32)
    dl = now + rng.integers(-2, 3, (G, P)).astype(np.int32)
    dl[rng.random((G, P)) < 0.3] = 0            # no TTL
    return res._replace(
        value=jnp.asarray(rng.integers(-9, 10, (G, P)).astype(np.int32)),
        val_dl=jnp.asarray(dl),
        lk_holder=jnp.asarray(rng.integers(-1, 3, (G, P)).astype(np.int32)),
        el_leader=jnp.asarray(rng.integers(-1, 3, (G, P)).astype(np.int32)),
        el_epoch=jnp.asarray(rng.integers(0, 5, (G, P)).astype(np.int32)),
    ), now


def test_catalog_is_mirrored():
    ported = sorted({v for k, v in vars(tap).items() if k.startswith("OP_")})
    assert ported == OPCODES
    assert tap.QUERY_OPCODES == jap.QUERY_OPCODES
    assert (tap.FAIL, tap.NUM_POOLS, tap.POOL_NONE) == (
        jap.FAIL, jap.NUM_POOLS, jap.POOL_NONE)
    ops = torch.tensor(OPCODES + [7, 99], dtype=torch.int32)
    np.testing.assert_array_equal(tap.pool_of(ops).numpy(),
                                  np.asarray(jap.pool_of(jnp.asarray(ops))))


@pytest.mark.parametrize("opcode", OPCODES)
def test_apply_entry_matches_reference(opcode):
    rng = np.random.default_rng(opcode)
    res, now = _random_resources(rng, jap.ResourceConfig.counters_only())
    # a/b small enough to hit the register's value, holder or leader often
    a, b = (rng.integers(-3, 4, (G, P)).astype(np.int32) for _ in range(2))
    c = rng.integers(0, 4, (G, P)).astype(np.int32)          # TTL ticks
    index = rng.integers(1, 50, (G, P)).astype(np.int32)
    live = rng.random((G, P)) < 0.8
    op = np.full((G, P), opcode, np.int32)
    want_res, want = _REF_APPLY_ENTRY(res, op, a, b, c, index, now, live)
    t = [torch.from_numpy(x) for x in (op, a, b, c, index, now, live)]
    got_res, got = tap.apply_entry(convert.resources_to_torch(res, "cpu"), *t)
    _same(want_res, got_res, f"opcode {opcode}")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_event_ring_push_and_drain_match_reference():
    rc = jap.ResourceConfig.counters_only()._replace(event_slots=4)
    rng = np.random.default_rng(7)
    jres = jap.init_resources(G, P, rc)
    tres = convert.resources_to_torch(jres, "cpu")
    for r in range(12):
        mask = rng.random((G, P)) < 0.6
        vals = [rng.integers(0, 9, (G, P)).astype(np.int32) for _ in range(3)]
        jres = jap.push_events(jres, mask, *vals)
        tres = tap.push_events(tres, torch.from_numpy(mask),
                               *(torch.from_numpy(v) for v in vals))
        _same(jres, tres, f"push round {r}")
        if r % 3 == 2:
            lead = rng.random(G) < 0.7
            jres, jout = jap.drain_events(jres, 2, jnp.asarray(lead))
            tres, tout = tap.drain_events(tres, 2, torch.from_numpy(lead))
            _same(jres, tres, f"drain round {r}")
            for w, g in zip(jout, tout):
                assert g.numpy().dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_drain_without_ring_returns_zeros():
    res = tap.init_resources(2, 3, tap.ResourceConfig.counters_only(), "cpu")
    _, out = tap.drain_events(res, 4, torch.ones(2, dtype=torch.bool))
    assert [tuple(x.shape) for x in out] == [(2, 3, 4)] * 5
    assert out[-1].dtype == torch.bool and not out[-1].any()


# the reference's apply_entry compiled as one program per config (the
# same jnp ops as dispatching them one by one, without a small compile
# for each)
_REF_APPLY_ENTRY = jax.jit(jap.apply_entry)


def _filled_pools(rng, rounds=16):
    """Default-size pools after ``rounds`` random entries from the whole
    catalog (keys and ids small, so they collide; TTLs and lock timeouts
    of every kind), applied by the reference; returns (state, now)."""
    res = jap.init_resources(G, P, jap.ResourceConfig())
    for r in range(rounds):
        op = rng.choice(OPCODES, (G, P)).astype(np.int32)
        a = rng.integers(0, 4, (G, P)).astype(np.int32)
        b = rng.choice([-1, 0, 1, 2], (G, P)).astype(np.int32)
        c = rng.integers(0, 4, (G, P)).astype(np.int32)
        index = np.full((G, P), r + 1, np.int32)
        now = np.full((G, P), r // 2, np.int32)
        res, _ = _REF_APPLY_ENTRY(res, op, a, b, c, index, now,
                                  rng.random((G, P)) < 0.9)
    return res, np.full((G, P), rounds // 2, np.int32)


@pytest.mark.parametrize("opcode", OPCODES)
def test_apply_entry_all_pools_matches_reference(opcode):
    rng = np.random.default_rng(1000 + opcode)
    res, now = _filled_pools(rng)
    a = rng.integers(0, 4, (G, P)).astype(np.int32)
    b = rng.choice([-1, 0, 1, 2], (G, P)).astype(np.int32)
    c = rng.integers(0, 4, (G, P)).astype(np.int32)
    index = np.full((G, P), 99, np.int32)
    live = rng.random((G, P)) < 0.8
    op = np.full((G, P), opcode, np.int32)
    want_res, want = _REF_APPLY_ENTRY(res, op, a, b, c, index, now, live)
    t = [torch.from_numpy(x) for x in (op, a, b, c, index, now, live)]
    got_res, got = tap.apply_entry(convert.resources_to_torch(res, "cpu"), *t)
    _same(want_res, got_res, f"opcode {opcode}")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
