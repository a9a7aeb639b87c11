"""The port's conflict-partitioned apply (``Config.pool_budgets``) against
its own sequential apply, through ``RaftGroups`` on the CPU — the
counterpart of ``tests/test_apply_window.py``.

The partitioned path must be observably identical to the sequential
``apply_entry`` scan: the same per-tag results, the same final resource
state and the same event streams. Budgets only defer entries across
rounds; they never drop or reorder them within a pool.

The sequential drive, the cases' oracle, depends on nothing but its seed:
it runs in a worker process started with the session's first port file
that runs the reference (``torch_reference.LONG_RUNS``), beside the tests
before this file, and its results, resource leaves and events come back.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from copycat_tpu_torch import convert  # noqa: E402
from copycat_tpu_torch.models import RaftGroups  # noqa: E402
from copycat_tpu_torch.ops import apply as ap  # noqa: E402
from copycat_tpu_torch.ops.consensus import Config  # noqa: E402
from torch_reference import LONG_RUNS, SUITE_AHEAD  # noqa: E402


def _drive(config: Config, seed: int) -> RaftGroups:
    """A FIXED step schedule (not run_until): both executions see the same
    round counts, hence the same logical clocks — so TTL deadlines
    (now + c) must come out equal between the two paths."""
    rg = RaftGroups(8, 3, log_slots=32, submit_slots=8, config=config,
                    seed=3, device="cpu")
    rg.wait_for_leaders(max_rounds=60)
    for _ in range(60 - rg.rounds):  # normalize the election warm-up
        rg.step_round()
    rng = np.random.default_rng(seed)
    ops_pool = [
        (ap.OP_LONG_ADD, lambda r: (int(r.integers(1, 5)), 0, 0)),
        (ap.OP_VALUE_SET, lambda r: (int(r.integers(1, 9)), 0,
                                     int(r.integers(0, 6)))),  # TTL'd
        (ap.OP_VALUE_CAS, lambda r: (int(r.integers(0, 3)),
                                     int(r.integers(0, 9)), 0)),
        (ap.OP_MAP_PUT, lambda r: (int(r.integers(0, 6)),
                                   int(r.integers(1, 9)),
                                   int(r.integers(0, 8)))),    # TTL'd
        (ap.OP_MAP_GET, lambda r: (int(r.integers(0, 6)), 0, 0)),
        (ap.OP_MAP_REMOVE, lambda r: (int(r.integers(0, 6)), 0, 0)),
        (ap.OP_SET_ADD, lambda r: (int(r.integers(0, 6)), 0,
                                   int(r.integers(0, 8)))),    # TTL'd
        (ap.OP_SET_REMOVE, lambda r: (int(r.integers(0, 6)), 0, 0)),
        (ap.OP_Q_OFFER, lambda r: (int(r.integers(1, 9)), 0, 0)),
        (ap.OP_Q_POLL, lambda r: (0, 0, 0)),
        (ap.OP_LOCK_ACQUIRE, lambda r: (int(r.integers(1, 4)), -1, 0)),
        (ap.OP_LOCK_RELEASE, lambda r: (int(r.integers(1, 4)), 0, 0)),
        (ap.OP_ELECT_LISTEN, lambda r: (int(r.integers(10, 14)), 0, 0)),
        (ap.OP_ELECT_RESIGN, lambda r: (int(r.integers(10, 14)), 0, 0)),
        (ap.OP_MM_PUT, lambda r: (int(r.integers(0, 3)),
                                  int(r.integers(0, 3)), 0)),
        (ap.OP_MM_REMOVE, lambda r: (int(r.integers(0, 3)), 0, 0)),
        (ap.OP_TOPIC_LISTEN, lambda r: (int(r.integers(1, 4)), 0, 0)),
        (ap.OP_TOPIC_PUB, lambda r: (int(r.integers(1, 99)), 0, 0)),
    ]
    tags = []
    for _ in range(25):  # 25 batches of one op per group, 4 rounds each
        for g in range(8):
            opcode, gen = ops_pool[rng.integers(0, len(ops_pool))]
            a, b, c = gen(rng)
            tags.append(rg.submit(g, opcode, a, b, c))
        for _ in range(4):
            rg.step_round()
    for _ in range(60):  # settle tail: tight budgets drain their backlog
        rg.step_round()
    missing = [t for t in tags if t not in rg.results]
    assert not missing, f"unresolved tags: {missing[:5]}"
    return rg


SEQUENTIAL = Config(applies_per_round=8)


def _observed(rg: RaftGroups) -> tuple:
    """What the cases compare of a drive: its results, every resource
    leaf and its session events."""
    return rg.results, convert.flat_leaves(rg.state.resources), rg.events


def sequential_drive() -> tuple:
    return _observed(_drive(SEQUENTIAL, seed=99))


@pytest.mark.parametrize("budgets", [(2,) * 8, (1, 2, 1, 3, 1, 2, 1, 1)])
def test_partitioned_apply_matches_sequential(budgets):
    partitioned = SEQUENTIAL._replace(pool_budgets=budgets)
    par_results, par_res, par_events = _observed(_drive(partitioned,
                                                        seed=99))
    # the sequential drive both budget cases compare against: one
    # deterministic run, shared (the cases only read it)
    seq_results, seq_res, seq_events = SUITE_AHEAD.get("apply_window",
                                                       sequential_drive)
    assert seq_results == par_results
    # every resource leaf, TTL deadlines and wait/listener rings included
    assert seq_res.keys() == par_res.keys()
    for name in seq_res:
        np.testing.assert_array_equal(seq_res[name], par_res[name],
                                      err_msg=name)
    assert seq_events == par_events     # order included
    assert seq_events, "the stream raised no session event"


LONG_RUNS[f"{os.path.basename(__file__)}::"
          "test_partitioned_apply_matches_sequential"] = [
    ("apply_window", sequential_drive, ())]


def test_tight_budgets_still_apply_everything():
    """Budgets of 1 defer heavily but never drop or reorder."""
    config = Config(applies_per_round=8, pool_budgets=(1,) * 8)
    rg = RaftGroups(4, 3, log_slots=32, submit_slots=8, config=config,
                    device="cpu")
    rg.wait_for_leaders()
    tags = [rg.submit(0, ap.OP_LONG_ADD, 1) for _ in range(24)]
    tags += [rg.submit(0, ap.OP_MAP_PUT, k, k * 2) for k in range(6)]
    rg.run_until(tags, max_rounds=400)
    assert [rg.results[t] for t in tags[:24]] == list(range(1, 25))
    assert [rg.results[t] for t in tags[24:]] == [0] * 6   # no previous
    get = rg.submit(0, ap.OP_MAP_GET, 3)
    rg.run_until([get])
    assert rg.results[get] == 6
