"""The query lane of the torch port against the JAX reference.

``query_step`` serves read-only ops from the leader lane's applied pools
with no log append, gated on a current leader that has applied its commit
and committed in its own term (and, for atomic slots, on the lease). It is
held, exactly, against the reference's ``query_step`` on the states a
reference run reaches under partitions (every pool, random read opcodes,
with and without ``atomic``). ``submit_query`` (with its escalation to the
command path), ``serve_query`` and ``drive_query_vector`` give the
reference's results through ``RaftGroups`` in lockstep.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.ops import apply as jap  # noqa: E402
from copycat_tpu.ops import consensus as jcons  # noqa: E402

from copycat_tpu_torch import convert  # noqa: E402
from copycat_tpu_torch.ops import consensus as tcons  # noqa: E402
from torch_reference import (  # noqa: E402
    ReferenceDrawnGroups,
    assert_same_state,
    isolate,
)

G, P, L, S = 16, 3, 16, 8
_RC = jap.ResourceConfig(map_slots=4, set_slots=3, queue_slots=3,
                         wait_slots=3, listener_slots=3, event_slots=4,
                         multimap_slots=4, topic_slots=3)
JCFG = jcons.Config(append_window=S, applies_per_round=S, resource=_RC)
_ALL_OPS = np.array(sorted({v for k, v in vars(jap).items()
                            if k.startswith("OP_")
                            and not k.startswith("OP_CFG")}), np.int32)
_READS = np.array(sorted(jap.QUERY_OPCODES), np.int32)


def _ops(rng, opcodes, width):
    return dict(opcode=rng.choice(opcodes, (G, width)).astype(np.int32),
                a=rng.integers(-1, 4, (G, width)).astype(np.int32),
                b=rng.integers(-1, 4, (G, width)).astype(np.int32),
                c=rng.integers(0, 3, (G, width)).astype(np.int32),
                tag=np.ones((G, width), np.int32),
                valid=rng.random((G, width)) < 0.8)


@pytest.mark.parametrize("atomic", [False, True])
def test_query_step_matches_reference(atomic):
    tcfg = convert.config_to_torch(JCFG)
    key = jax.random.PRNGKey(11)
    key, init_key = jax.random.split(key)
    jstate = jcons.init_state(G, P, L, init_key, JCFG)
    jstep = jax.jit(partial(jcons.step, config=JCFG))
    jquery = jax.jit(partial(jcons.query_step, config=JCFG))
    rng = np.random.default_rng(5)
    served_total = unserved = 0
    for r in range(24):
        key, k = jax.random.split(key)
        deliver = (isolate(G, P, [r % P]) if 8 <= r < 14
                   else rng.random((G, P, P)) < 0.85)
        jstate, _ = jstep(jstate, jcons.Submits(**_ops(rng, _ALL_OPS, S)),
                          deliver, k)
        q = _ops(rng, _READS, 5)
        at = rng.random((G, 5)) < 0.5 if atomic else None
        want = jquery(jstate, jcons.Submits(**q), at)
        got = tcons.query_step(
            convert.state_to_torch(jstate, "cpu"),
            tcons.Submits(**{n: torch.from_numpy(v) for n, v in q.items()}),
            None if at is None else torch.from_numpy(at), tcfg)
        for w, g, name in zip(want, got, ("results", "served")):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, name
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{name} round {r}")
        served = np.asarray(want[1])
        served_total += int(served.sum())
        unserved += int((q["valid"] & ~served).sum())
    assert served_total > 0 and unserved > 0


# the map pool alone for the engine tests, so the reference's CPU compile
# stays short
MAP_CFG = JCFG._replace(resource=jap.ResourceConfig(
    map_slots=4, set_slots=0, queue_slots=0, wait_slots=0, listener_slots=0,
    event_slots=0, multimap_slots=0, topic_slots=0))


def _engines(seed=0):
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=4, config=MAP_CFG,
                        seed=seed)
    port = ReferenceDrawnGroups(G, P, L, 4, MAP_CFG, seed=seed)
    for rg in (ref, port):
        rg.wait_for_leaders()
    return ref, port


def test_query_lane_gives_the_reference_results():
    """Puts through the log, then reads on every query entry point, with
    a partition that makes some reads escalate to the command path."""
    ref, port = _engines()
    engines = (ref, port)
    rng = np.random.default_rng(9)
    tags = []
    for r in range(16):
        g = rng.integers(0, G, 6)
        k = rng.integers(0, 4, 6)
        v = rng.integers(1, 100, 6)
        put = [list(rg.submit_batch(g, jap.OP_MAP_PUT, k, v))
               for rg in engines]
        assert put[0] == put[1]
        gq = rng.integers(0, G, 4)
        kq = rng.integers(0, 4, 4)
        got = [[rg.submit_query(int(a), jap.OP_MAP_GET, int(b),
                                consistency="atomic" if r % 2 else
                                "sequential") for a, b in zip(gq, kq)]
               for rg in engines]
        assert got[0] == got[1]
        tags += put[0] + got[0]
        deliver = isolate(G, P, [1]) if 6 <= r < 10 else None
        for rg in engines:
            rg.step_round(deliver=deliver)
        assert_same_state(ref, port, f"round {r}")
    for rg in engines:
        rg.run_until(tags, max_rounds=100)
    assert port.results == ref.results
    assert port.counters["queries_escalated"] > 0
    assert port.counters["queries_served"] > 0
    rows = np.arange(G).repeat(3)
    keys = np.tile([0, 1, 3], G)
    vec = [rg.drive_query_vector(rows, jap.OP_MAP_GET, keys,
                                 atomic=rows % 2 == 0) for rg in engines]
    np.testing.assert_array_equal(vec[1], vec[0])
    one = [rg.serve_query(5, jap.OP_MAP_SIZE, consistency="atomic")
           for rg in engines]
    assert one[1] == one[0]
    assert_same_state(ref, port, "end")


def test_query_lane_refuses_writes():
    _, port = _engines()
    with pytest.raises(ValueError, match="read-only"):
        port.submit_query(0, jap.OP_MAP_PUT, 1, 2)
    with pytest.raises(ValueError, match="read-only"):
        port.serve_query(0, jap.OP_LONG_ADD, 1)
    with pytest.raises(ValueError, match="read-only"):
        port.drive_query_vector([0, 1], [jap.OP_MAP_GET, jap.OP_Q_POLL])
    with pytest.raises(ValueError, match="consistency"):
        port.submit_query(0, jap.OP_MAP_GET, consistency="linearizable")
