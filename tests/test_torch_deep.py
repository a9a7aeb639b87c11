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
"""

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
    assert_same_leaves,
    assert_same_state,
    deep_config,
    engine_pair,
    isolate,
)

G, P = DEEP_SHAPE["groups"], DEEP_SHAPE["peers"]
L, S = DEEP_SHAPE["log_slots"], DEEP_SHAPE["submit_slots"]


class Lockstep:
    """Both engines stepped one raw round at a time on the same submits
    and delivery; every output and state leaf compared each round."""

    def __init__(self, seed):
        self.ref, self.port = engine_pair(seed)
        self.rounds = 0

    def window(self, group, tags, opcode=jap.OP_LONG_ADD, a=1):
        sub = self.ref._empty_submits()
        for s, t in enumerate(tags):
            sub.opcode[group, s] = opcode
            sub.a[group, s] = a
            sub.tag[group, s] = t
            sub.valid[group, s] = True
        return sub

    def step(self, sub=None, deliver=None):
        ref, port = self.ref, self.port
        sub = ref._empty_submits() if sub is None else sub
        dl = np.ones((G, P, P), bool) if deliver is None else deliver
        ref._key, key = jax.random.split(ref._key)
        ref.state, jout = ref._step(ref.state, sub, jax.numpy.asarray(dl),
                                    key)
        fresh, cand = port._draw_timers()
        port.state, tout = tcons.step(
            port.state, convert.submits_to_torch(sub._asdict(), "cpu"),
            torch.from_numpy(dl), fresh, cand, port.config)
        self.rounds += 1
        assert_same_leaves(jout, tout, f"outputs round {self.rounds}")
        assert_same_state(ref, port, f"round {self.rounds}")
        return convert.to_numpy(tout)

    def leader(self, g):
        return self.ref.leader(g)


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
    seen.append(ls.port.state.resources.value.numpy()[0])


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
    seen.append(ls.port.state.resources.value.numpy()[0])


@pytest.mark.parametrize("script", [
    dense_duplicates_gaps, election_noop_mid_stream,
    uncommitted_tail_lost, committed_dedup_after_failover],
    ids=lambda f: f.__name__)
def test_monotone_gate_matches_reference(script):
    ls = Lockstep(seed=7)
    seen = []
    script(ls, seen)
    accepted = [x for x in seen if x.dtype == bool]
    assert any(x.any() for x in accepted), "the gate accepted nothing"
    assert any(not x.all() for x in accepted), "the gate rejected nothing"


def test_every_telemetry_leaf_under_partitions():
    """30 rounds of dense-tag submits under random message loss and a
    stretch where each group's leader is isolated: every telemetry leaf
    (and every other leaf) equal, and the block saw elections, leaderless
    rounds, rejections and commits."""
    ls = Lockstep(seed=3)
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
        sub = ls.ref._empty_submits()
        sub.opcode[:] = jap.OP_LONG_ADD
        sub.a[:] = 1
        sub.tag[:] = nxt[:, None] + np.arange(S)
        sub.valid[:] = rng.random((G, S)) < 0.7
        out = ls.step(sub, dl)
        nxt += out["accepted"].sum(axis=1)
        for k, v in out["telemetry"].items():
            totals[k] = totals.get(k, 0) + int(np.asarray(v).sum())
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


def test_deep_step_both_forms_match_reference():
    """Eight rounds of dense windows through the reference's deep_step
    (scatter) and the port's in both forms, from one state: equal state,
    accumulators, events and telemetry after every round."""
    ref, port = engine_pair(seed=9)
    rng = np.random.default_rng(2)
    base = np.zeros(G, np.int32)
    jprog = jbulk._deep_program(ref.config)
    jacc = _accumulators(B)
    tacc = {oh: convert.deep_to_torch(_accumulators(B), "cpu")
            for oh in (False, True)}
    tstate = {oh: port.state for oh in (False, True)}
    for r, sub in enumerate(_dense_windows(base, 8, rng)):
        ref._key, key = jax.random.split(ref._key)
        ref.state, *jacc, jout = jprog(ref.state, *jacc, base, np.int32(r),
                                       sub, ref.deliver, key)
        fresh, cand = port._draw_timers()
        for oh in (False, True):
            tstate[oh], *acc, tout = tcons.deep_step(
                tstate[oh], *tacc[oh], torch.from_numpy(base), r,
                convert.submits_to_torch(sub._asdict(), "cpu"),
                port.deliver, fresh, cand, port.config, onehot=oh)
            tacc[oh] = tuple(acc)
            what = f"onehot={oh} round {r}"
            assert_same_leaves(ref.state, tstate[oh], f"state {what}")
            assert_same_leaves(jout, tout, f"outputs {what}")
            _same(tuple(jacc), tacc[oh], f"accumulators {what}")
    assert np.asarray(jacc[1]).any(), "no result was accumulated"


def test_deep_scan_matches_reference():
    """A whole blind phase (three dense windows and three settle rounds,
    the bulk drives' shape)
    through the reference's ``deep_scan`` and the port's, with the draws
    taken first: equal state, accumulators, stacked events and stacked
    telemetry."""
    ref, port = engine_pair(seed=13)
    rng = np.random.default_rng(4)
    base = np.zeros(G, np.int32)
    windows = _dense_windows(base, 3, rng) + [_idle()] * 3
    stacked = jcons.Submits(*(np.stack(x) for x in zip(*windows)))
    ref._key, key = jax.random.split(ref._key)
    jres = jbulk._deep_scan_program(ref.config)(
        ref.state, *_accumulators(B), base, stacked, ref.deliver, key)
    tres = tcons.deep_scan(
        port.state, *convert.deep_to_torch(_accumulators(B), "cpu"),
        torch.from_numpy(base), convert.submits_to_torch(
            stacked._asdict(), "cpu"), port.deliver,
        port._draw_rounds(len(windows)), port.config)
    assert_same_leaves(jres[0], tres[0], "state")
    _same(tuple(jres[1:5]), tres[1:5], "accumulators")
    _same(tuple(jres[5]), tres[5], "stacked events")
    assert_same_leaves(jres[6], tres[6], "stacked telemetry")
    assert np.asarray(jres[2]).sum() > 0, "no result was accumulated"
