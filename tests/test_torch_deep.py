"""The deep bulk plane's step of the torch port against the JAX reference.

- The monotone tag gate (``Config.monotone_tag_accept``), step by step
  over the scripts of ``tests/test_monotone_deep.py``: a dense stream with
  duplicates and gaps, an election NoOp mid-stream, a leader change that
  loses an uncommitted tail, and a duplicate of committed ops sent after a
  failover (compact submit leaves ride the deep drives of
  ``tests/test_torch_bulk.py``). Every output leaf (the telemetry
  block included) and every state leaf equal every round.
- Every ``DeviceTelemetry`` leaf over 30 rounds under random partitions.
- Telemetry is pure output: the state with it on equals the state with
  it off, and the step calls each fused phase once either way.
- ``deep_step`` (scatter and one-hot forms) and ``deep_scan``: state,
  accumulators, events and telemetry equal to the reference's.

All at G=8 × P=3, L=16, S=4 with one reference config
(``torch_reference.deep_config``); exact, integers only.

The reference's side of each case depends on nothing of the port's: it
runs once, in a worker process started with the session's first port file
(``torch_reference.LONG_RUNS``), and records every leaf the port's run of
the same case is then held against, round by round
(``torch_reference.Transcript``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401

from copycat_tpu.models import bulk as jbulk  # noqa: E402
from copycat_tpu.ops import apply as jap  # noqa: E402
from copycat_tpu.ops import consensus as jcons  # noqa: E402

from copycat_tpu_torch import convert  # noqa: E402
from copycat_tpu_torch.ops import consensus as tcons  # noqa: E402
from torch_reference import (  # noqa: E402
    DEEP_SHAPE,
    LONG_RUNS,
    SUITE_AHEAD,
    Transcript,
    assert_same_leaves,
    deep_config,
    isolate,
    port_engine,
    reference_engine,
    state_leaves,
)

G, P = DEEP_SHAPE["groups"], DEEP_SHAPE["peers"]
L, S = DEEP_SHAPE["log_slots"], DEEP_SHAPE["submit_slots"]


def _empty():
    """An empty round of submits, as the reference's engine builds it."""
    z = np.zeros((G, S), np.int32)
    return jcons.Submits(opcode=z.copy(), a=z.copy(), b=z.copy(),
                         c=z.copy(), tag=z.copy(),
                         valid=np.zeros((G, S), bool))


def _as_numpy(x):
    """Step outputs (either package's) as a dict of numpy arrays by field
    name, nested blocks as dicts."""
    if x is None:
        return None
    if hasattr(x, "_asdict"):
        return {k: _as_numpy(v) for k, v in x._asdict().items()}
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class Lockstep:
    """One engine of a lockstep pair stepped one raw round at a time on
    given submits and delivery: the reference's run (``record`` None)
    records every output and state leaf each round; the port's run of the
    same script is held against that record, leaf by leaf."""

    def __init__(self, seed, record=None):
        self.replay = record is not None
        self.rg = (port_engine if self.replay else reference_engine)(seed)
        self.check = Transcript(record)
        self.check(state_leaves(self.rg), "leaders elected")
        self.rounds = 0

    def window(self, group, tags, opcode=jap.OP_LONG_ADD, a=1):
        sub = _empty()
        for s, t in enumerate(tags):
            sub.opcode[group, s] = opcode
            sub.a[group, s] = a
            sub.tag[group, s] = t
            sub.valid[group, s] = True
        return sub

    def step(self, sub=None, deliver=None):
        rg = self.rg
        sub = _empty() if sub is None else sub
        dl = np.ones((G, P, P), bool) if deliver is None else deliver
        if self.replay:
            fresh, cand = rg._draw_timers()
            rg.state, out = tcons.step(
                rg.state, convert.submits_to_torch(sub._asdict(), "cpu"),
                torch.from_numpy(dl), fresh, cand, rg.config)
        else:
            rg._key, key = jax.random.split(rg._key)
            rg.state, out = rg._step(rg.state, sub, jax.numpy.asarray(dl),
                                     key)
        self.rounds += 1
        self.check(convert.flat_leaves(out), f"outputs round {self.rounds}")
        self.check(state_leaves(rg), f"round {self.rounds}")
        return _as_numpy(out)

    def leader(self, g):
        return self.rg.leader(g)

    def values(self):
        return state_leaves(self.rg)["resources.value"]


def _cut(victims):
    """Delivery with lane ``victims[g]`` of each group g cut off (-1:
    none)."""
    hit = np.arange(P)[None, :] == np.asarray(victims)[:, None]
    return ~(hit[:, :, None] | hit[:, None, :])


def _same(want, got, what):
    """Arrays, or tuples of arrays, equal in value, dtype and shape."""
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert_same_leaves({str(i): x for i, x in enumerate(want)},
                       {str(i): x for i, x in enumerate(got)}, what)


def dense_duplicates_gaps(ls, seen):
    """Tags 1,2 then the duplicates, a gap (4), then 3 with a gap after."""
    for tags in ([1, 2], [1, 2], [4], [3, 5], [3, 4], [5]):
        seen.append(ls.step(ls.window(0, tags))["accepted"][0])


def election_noop_mid_stream(ls, seen):
    for _ in range(4):
        seen.append(ls.step(ls.window(1, [1, 2]))["accepted"][1])
    for _ in range(3):
        ls.step()
    cut = isolate(G, P, [ls.leader(1)])
    for _ in range(12):
        ls.step(deliver=cut)
    for _ in range(10):
        ls.step()
    for _ in range(4):       # the successor, then its duplicate
        seen.append(ls.step(ls.window(1, [3]))["accepted"][1])


def uncommitted_tail_lost(ls, seen):
    """The leader accepts [1,2] in the round it is cut off (its lease is
    last round's) and can never replicate them; the new leader must take
    [1,2] again, and after the heal each applies once."""
    lead = ls.leader(0)
    cut = isolate(G, P, [lead])
    seen.append(ls.step(ls.window(0, [1, 2]), deliver=cut)["accepted"][0])
    for _ in range(14):
        ls.step(deliver=cut)
    for _ in range(6):
        seen.append(ls.step(ls.window(0, [1, 2]), deliver=cut)
                    ["accepted"][0])
    for _ in range(10):
        ls.step()
    seen.append(ls.values()[0])


def committed_dedup_after_failover(ls, seen):
    for _ in range(4):
        seen.append(ls.step(ls.window(0, [1, 2]))["accepted"][0])
    for _ in range(4):
        ls.step()
    cut = isolate(G, P, [ls.leader(0)])
    for _ in range(14):
        ls.step(deliver=cut)
    seen.append(ls.step(ls.window(0, [1, 2]), deliver=cut)["accepted"][0])
    for _ in range(8):
        ls.step()
    seen.append(ls.values()[0])


GATE_SCRIPTS = [dense_duplicates_gaps, election_noop_mid_stream,
                uncommitted_tail_lost, committed_dedup_after_failover]


def _gate(script, record=None):
    ls = Lockstep(seed=7, record=record)
    seen = []
    script(ls, seen)
    return ls, seen


@pytest.mark.parametrize("script", GATE_SCRIPTS, ids=lambda f: f.__name__)
def test_monotone_gate_matches_reference(script):
    ls, seen = _gate(script, SUITE_AHEAD.get("deep", _reference_runs)[
        script.__name__])
    ls.check.done()
    accepted = [x for x in seen if x.dtype == bool]
    assert any(x.any() for x in accepted), "the gate accepted nothing"
    assert any(not x.all() for x in accepted), "the gate rejected nothing"


def _telemetry_partitions(record=None):
    """30 rounds of dense-tag submits under random message loss and a
    stretch where each group's leader is isolated; returns the engine and
    the telemetry block's totals."""
    ls = Lockstep(seed=3, record=record)
    rng = np.random.default_rng(5)
    nxt = np.ones(G, np.int64)
    totals = {}
    for r in range(30):
        if r == 8:
            leaders_cut = _cut([ls.leader(g) for g in range(G)])
        if 8 <= r < 16:
            dl = leaders_cut
        else:
            dl = rng.random((G, P, P)) < 0.85
        sub = _empty()
        sub.opcode[:] = jap.OP_LONG_ADD
        sub.a[:] = 1
        sub.tag[:] = nxt[:, None] + np.arange(S)
        sub.valid[:] = rng.random((G, S)) < 0.7
        out = ls.step(sub, dl)
        nxt += out["accepted"].sum(axis=1)
        for k, v in out["telemetry"].items():
            totals[k] = totals.get(k, 0) + int(np.asarray(v).sum())
    return ls, totals


def test_every_telemetry_leaf_under_partitions():
    """30 rounds of dense-tag submits under random message loss and a
    stretch where each group's leader is isolated: every telemetry leaf
    (and every other leaf) equal, and the block saw elections, leaderless
    rounds, rejections and commits."""
    ls, totals = _telemetry_partitions(SUITE_AHEAD.get(
        "deep", _reference_runs)["telemetry"])
    ls.check.done()
    for k in ("elections_started", "leaderless", "submit_rejections",
              "commit_advance"):
        assert totals[k] > 0, (k, totals)


def _random_round(rng):
    sub = tcons.Submits(
        opcode=torch.from_numpy(rng.choice(
            [jap.OP_LONG_ADD, jap.OP_LOCK_ACQUIRE, jap.OP_LOCK_RELEASE],
            (G, S)).astype(np.int32)),
        a=torch.from_numpy(rng.integers(0, 3, (G, S)).astype(np.int32)),
        b=torch.from_numpy(rng.integers(-1, 1, (G, S)).astype(np.int32)),
        c=torch.zeros((G, S), dtype=torch.int32),
        tag=torch.from_numpy(rng.integers(1, 9, (G, S)).astype(np.int32)),
        valid=torch.from_numpy(rng.random((G, S)) < 0.8))
    draws = [torch.from_numpy(rng.integers(4, 9, (G, P)).astype(np.int32))
             for _ in range(2)]
    return sub, torch.from_numpy(rng.random((G, P, P)) < 0.8), draws


def test_telemetry_is_pure_output(monkeypatch):
    """Telemetry on and off from one state and one set of inputs: equal
    state every round, equal outputs but for the block, one call of each
    fused phase a round either way."""
    calls = {"admit_submits": 0, "ack_commit": 0}
    for name in calls:
        real = getattr(tcons, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tcons, name, counted)
    rng = np.random.default_rng(11)
    cfg = convert.config_to_torch(deep_config())
    timer = torch.from_numpy(rng.integers(4, 9, (G, P)).astype(np.int32))
    on = off = tcons.init_state(G, P, L, timer, cfg)
    for r in range(30):
        sub, dl, (fresh, cand) = _random_round(rng)
        on, out_on = tcons.step(on, sub, dl, fresh, cand, cfg)
        off, out_off = tcons.step(off, sub, dl, fresh, cand,
                                  cfg._replace(telemetry=False))
        assert out_off.telemetry is None and out_on.telemetry is not None
        assert_same_leaves(on, off, f"state round {r}")
        assert_same_leaves(out_on._replace(telemetry=None), out_off,
                           f"outputs round {r}")
    assert calls == {"admit_submits": 60, "ack_commit": 60}


def _dense_windows(base, rounds, rng):
    """Dense per-group tag windows continuing from ``base [G]``, the tag
    leaf compact (``[G,1]``: consecutive from slot 0) as the bulk drive
    stages it."""
    out, nxt = [], base.copy()
    z = np.zeros((G, S), np.int32)
    for _ in range(rounds):
        take = rng.integers(0, S + 1, G)
        out.append(jcons.Submits(
            opcode=z + jap.OP_LONG_ADD,
            a=rng.integers(1, 5, (G, S)).astype(np.int32), b=z, c=z,
            tag=(nxt[:, None] + 1).astype(np.int32),
            valid=np.arange(S)[None, :] < take[:, None]))
        nxt += take
    return out


def _idle():
    z = np.zeros((G, S), np.int32)
    return jcons.Submits(z, z, z, z, np.zeros((G, 1), np.int32),
                         np.zeros((G, S), bool))


# the bulk drives' accumulator width: 9-12 ops a group pad to 16
B = 16


def _accumulators(B):
    return (np.zeros((G, B), np.int32), np.zeros((G, B), bool),
            np.full((G, B), 2 ** 30, np.int32), np.zeros(G, bool))


def _reference_deep_step() -> tuple:
    """The reference's side of the deep_step case: its elected state, and
    per round its state, outputs and accumulators after its deep_step."""
    ref = reference_engine(9)
    elected = state_leaves(ref)
    rng = np.random.default_rng(2)
    base = np.zeros(G, np.int32)
    jprog = jbulk._deep_program(ref.config)
    jacc = _accumulators(B)
    rounds = []
    for r, sub in enumerate(_dense_windows(base, 8, rng)):
        ref._key, key = jax.random.split(ref._key)
        ref.state, *jacc, jout = jprog(ref.state, *jacc, base, np.int32(r),
                                       sub, ref.deliver, key)
        rounds.append((state_leaves(ref), convert.flat_leaves(jout),
                       tuple(np.asarray(x) for x in jacc)))
    return elected, rounds


def test_deep_step_both_forms_match_reference():
    """Eight rounds of dense windows through the reference's deep_step
    (scatter) and the port's in both forms, from one state: equal state,
    accumulators, events and telemetry after every round."""
    elected, rounds = SUITE_AHEAD.get("deep", _reference_runs)["deep_step"]
    port = port_engine(9)
    assert_same_leaves(elected, state_leaves(port), "leaders elected")
    rng = np.random.default_rng(2)
    base = np.zeros(G, np.int32)
    tacc = {oh: convert.deep_to_torch(_accumulators(B), "cpu")
            for oh in (False, True)}
    tstate = {oh: port.state for oh in (False, True)}
    windows = _dense_windows(base, 8, rng)
    assert len(windows) == len(rounds)
    for r, (sub, (jstate, jout, jacc)) in enumerate(zip(windows, rounds)):
        fresh, cand = port._draw_timers()
        for oh in (False, True):
            tstate[oh], *acc, tout = tcons.deep_step(
                tstate[oh], *tacc[oh], torch.from_numpy(base), r,
                convert.submits_to_torch(sub._asdict(), "cpu"),
                port.deliver, fresh, cand, port.config, onehot=oh)
            tacc[oh] = tuple(acc)
            what = f"onehot={oh} round {r}"
            assert_same_leaves(jstate, convert.flat_leaves(tstate[oh]),
                               f"state {what}")
            assert_same_leaves(jout, convert.flat_leaves(tout),
                               f"outputs {what}")
            _same(jacc, tacc[oh], f"accumulators {what}")
    assert rounds[-1][2][1].any(), "no result was accumulated"


def _reference_deep_scan() -> tuple:
    """The reference's side of the deep_scan case: its elected state, and
    the scan's state, accumulators, stacked events and telemetry."""
    ref = reference_engine(13)
    elected = state_leaves(ref)
    rng = np.random.default_rng(4)
    base = np.zeros(G, np.int32)
    windows = _dense_windows(base, 3, rng) + [_idle()] * 3
    stacked = jcons.Submits(*(np.stack(x) for x in zip(*windows)))
    ref._key, key = jax.random.split(ref._key)
    jres = jbulk._deep_scan_program(ref.config)(
        ref.state, *_accumulators(B), base, stacked, ref.deliver, key)
    return elected, (convert.flat_leaves(jres[0]),
                     tuple(np.asarray(x) for x in jres[1:5]),
                     tuple(np.asarray(x) for x in jres[5]),
                     convert.flat_leaves(jres[6]))


def test_deep_scan_matches_reference():
    """A whole blind phase (three dense windows and three settle rounds,
    the bulk drives' shape)
    through the reference's ``deep_scan`` and the port's, with the draws
    taken first: equal state, accumulators, stacked events and stacked
    telemetry."""
    elected, (jstate, jacc, jevents, jtel) = SUITE_AHEAD.get(
        "deep", _reference_runs)["deep_scan"]
    port = port_engine(13)
    assert_same_leaves(elected, state_leaves(port), "leaders elected")
    rng = np.random.default_rng(4)
    base = np.zeros(G, np.int32)
    windows = _dense_windows(base, 3, rng) + [_idle()] * 3
    stacked = jcons.Submits(*(np.stack(x) for x in zip(*windows)))
    tres = tcons.deep_scan(
        port.state, *convert.deep_to_torch(_accumulators(B), "cpu"),
        torch.from_numpy(base), convert.submits_to_torch(
            stacked._asdict(), "cpu"), port.deliver,
        port._draw_rounds(len(windows)), port.config)
    assert_same_leaves(jstate, convert.flat_leaves(tres[0]), "state")
    _same(jacc, tres[1:5], "accumulators")
    _same(jevents, tres[5], "stacked events")
    assert_same_leaves(jtel, convert.flat_leaves(tres[6]),
                       "stacked telemetry")
    assert jacc[1].sum() > 0, "no result was accumulated"


def _reference_runs() -> dict:
    """Every case's reference side, in one worker: they share the
    reference's compiled programs."""
    runs = {f.__name__: _gate(f)[0].check.values for f in GATE_SCRIPTS}
    runs["telemetry"] = _telemetry_partitions()[0].check.values
    runs["deep_step"] = _reference_deep_step()
    runs["deep_scan"] = _reference_deep_scan()
    return runs


LONG_RUNS.update({f"{os.path.basename(__file__)}::{test}": [
    ("deep", _reference_runs, ())] for test in (
        "test_monotone_gate_matches_reference",
        "test_every_telemetry_leaf_under_partitions",
        "test_deep_step_both_forms_match_reference",
        "test_deep_scan_matches_reference")})
