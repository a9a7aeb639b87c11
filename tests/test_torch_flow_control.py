"""``Config.ring_flow_control``: the port's ring never overwrites an entry
it has not applied, and no group is left unable to elect or to commit.

The rules (``copycat_tpu_torch/ops/consensus.py``): a follower takes
entries only up to its applied index + L - 1; a leader admits submits only
up to its backpressure floor + L - 2; a winner appends its NoOp in a free
slot, or re-stamps its last entry when that is an uncommitted NoOp; a lane
stands only when it can do one of the two. Under them every lane keeps
``last - applied <= L - 1`` after every round, so the state the earlier
rules could stall in (the most up-to-date lanes each with L unapplied
entries, none of which may stand) is never reached.

No JAX here: these are properties of the port's own step, which with flow
control on departs from the reference by design (the differential tests
turn it off).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from copycat_tpu_torch import bench  # noqa: E402
from copycat_tpu_torch.ops import apply as tap  # noqa: E402
from copycat_tpu_torch.ops import consensus as tcons  # noqa: E402

L = 8
CFG = tcons.Config(resource=tap.ResourceConfig.counters_only(),
                   append_window=4, applies_per_round=4)


def _successive_winners_state():
    """One group, P = 3, L = 8, nothing committed. A leader of term 1
    admitted entries 1..6 (L - 2 past the floor, the admission cap) and
    sent them to lane 1, whose acks were lost; lane 0 then won term 2 and
    lane 1 term 3, each appending a NoOp at index 7 that reached no one.
    Lanes 0 and 1 hold L - 1 unapplied entries ending in an uncommitted
    NoOp; lane 2 heard nothing (last index 0) and voted for lane 1."""
    timer = torch.tensor([[6, 6, 6]], dtype=torch.int32)
    st = tcons.init_state(1, 3, L, timer, CFG)
    op, a, term, tag = (x.clone() for x in (st.log_op, st.log_a,
                                            st.log_term, st.log_tag))
    for lane, noop_term in ((0, 2), (1, 3)):
        for idx in range(1, L - 1):
            op[0, lane, idx - 1] = tap.OP_LONG_ADD
            a[0, lane, idx - 1] = 1
            term[0, lane, idx - 1] = 1
            tag[0, lane, idx - 1] = 100 + idx
        term[0, lane, L - 2] = noop_term           # the NoOp at index 7
    i = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    return st._replace(
        log_op=op, log_a=a, log_term=term, log_tag=tag,
        last_index=i([L - 1, L - 1, 0]), term=i([2, 3, 3]),
        voted_for=i([0, 1, 1]))


def _step(st, gen, submits=None, deliver=None):
    G, P = st.term.shape
    sub = submits if submits is not None else tcons.make_submits(G, 4, "cpu")
    dl = deliver if deliver is not None else tcons.full_delivery(G, P, "cpu")
    st, out = tcons.step(st, sub, dl, tcons.draw_timers(G, P, CFG, gen),
                         tcons.draw_timers(G, P, CFG, gen), CFG)
    return tcons.install_snapshots(st, out.stale, out.leader, CFG), out


def _ring(st):
    """Per lane and ring slot: the absolute index the slot holds (0 where
    the lane's window ``(last - L, last]`` has none) and the entry there,
    as numpy arrays."""
    last = st.last_index.numpy()[..., None]
    j = np.arange(L)
    idx = last - (last - 1 - j) % L
    idx = np.where(idx >= 1, idx, 0)
    return idx, {n: getattr(st, n).numpy() for n in (
        "log_term", "log_op", "log_tag", "log_a", "log_b", "log_c")}


def _same_entry(x, y):
    """Entries equal in op and tag, and in payload for a client entry (a
    NoOp's payload slots keep whatever the ring held there)."""
    same = (x["log_op"] == y["log_op"]) & (x["log_tag"] == y["log_tag"])
    payload = ((x["log_a"] == y["log_a"]) & (x["log_b"] == y["log_b"])
               & (x["log_c"] == y["log_c"]))
    return same & ((x["log_op"] == 0) | payload)


def assert_log_matching(st):
    """Raft's Log Matching over the live windows: two lanes holding an
    entry of the same index and term hold the same entries up to that
    index, as far back as both rings still hold them."""
    idx, f = _ring(st)
    a = {n: v[:, :, None, :] for n, v in f.items()}     # lane p
    b = {n: v[:, None, :, :] for n, v in f.items()}     # lane q
    both = (idx[:, :, None, :] == idx[:, None, :, :]) & (idx[:, :, None] > 0)
    top = np.where(both & (a["log_term"] == b["log_term"]),
                   idx[:, :, None, :], 0).max(axis=-1, keepdims=True)
    bad = both & (idx[:, :, None, :] <= top) & ~_same_entry(a, b)
    assert not bad.any(), np.argwhere(bad)[:5]


def assert_committed_kept(before, st):
    """An entry at or below a lane's commit index keeps its op, tag and
    payload from one round to the next, while the lane's ring holds it."""
    idx0, f0 = _ring(before)
    idx1, f1 = _ring(st)
    commit = before.commit_index.numpy()[..., None]
    held = (idx0 == idx1) & (idx0 > 0) & (idx0 <= commit)
    bad = held & ~_same_entry(f0, f1)
    assert not bad.any(), np.argwhere(bad)[:5]


def test_successive_winners_with_full_rings_elect_and_commit():
    """From the successive-winners state, with every link healed, a leader
    is elected (lane 1: its NoOp has the highest term, and it re-stamps
    it) and a fresh submit commits within 40 rounds, together with the
    six entries before it."""
    st = _successive_winners_state()
    gen = torch.Generator().manual_seed(0)
    leader_at = committed_at = None
    sub = tcons.make_submits(1, 4, "cpu")
    sub = sub._replace(opcode=sub.opcode + tap.OP_LONG_ADD, a=sub.a + 10,
                       tag=sub.tag + 7, valid=sub.valid.clone())
    sub.valid[0, 0] = True
    for r in range(40):
        submit = leader_at is not None and committed_at is None
        st, out = _step(st, gen, sub if submit else None)
        if leader_at is None and int(out.leader[0]) >= 0:
            leader_at = r
            lead = int(out.leader[0])
            assert lead == 1
            # re-stamped in place: index 7 now carries the new term
            assert int(st.last_index[0, lead]) == L - 1
            assert int(st.log_term[0, lead, L - 2]) == int(st.term[0, lead])
        got = out.out_valid & (out.out_tag == 7)
        if got.any():
            committed_at = r
            assert int(out.out_result[got][0]) == 16   # 6 × 1, then + 10
            break
        assert (st.last_index - st.applied_index <= L - 1).all()
    assert leader_at is not None, "no leader was elected"
    assert committed_at is not None, "the fresh submit never committed"


def test_a_winner_re_stamps_its_uncommitted_noop():
    """A lane with L - 1 unapplied entries ending in an uncommitted NoOp
    stands and, winning, gives that NoOp its term in place (index, op,
    tag and time kept); one ending in a client entry does not stand."""
    st = _successive_winners_state()
    timer = torch.tensor([[9, 1, 9]], dtype=torch.int32)
    st = st._replace(timer=timer)
    st2, _ = tcons.step(st, tcons.make_submits(1, 4, "cpu"),
                        tcons.full_delivery(1, 3, "cpu"), timer + 5,
                        timer + 5, CFG)
    assert int(st2.role[0, 1]) == tcons.LEADER
    assert int(st2.last_index[0, 1]) == L - 1
    assert int(st2.log_term[0, 1, L - 2]) == 4
    for name in ("log_op", "log_tag", "log_time"):
        assert int(getattr(st2, name)[0, 1, L - 2]) == \
            int(getattr(st, name)[0, 1, L - 2]), name
    # the same lane with a client entry at index 7 may not stand
    op = st.log_op.clone()
    op[0, 1, L - 2] = tap.OP_LONG_ADD
    st3, _ = tcons.step(st._replace(log_op=op), tcons.make_submits(1, 4,
                                                                   "cpu"),
                        tcons.full_delivery(1, 3, "cpu"), timer + 5,
                        timer + 5, CFG)
    assert int(st3.term[0, 1]) == 3 and int(st3.role[0, 1]) != tcons.LEADER


def test_no_lane_reaches_a_full_ring_under_the_nemesis():
    """G=16 × P=5 with a ring of 8 under full submit load and the partition
    nemesis, with message loss on every third round: after every round
    each lane keeps at most L - 1 unapplied entries (so the state with L
    of them, where no up-to-date lane could stand, is unreachable); a
    lane that may not stand (L - 1 of them, a client entry last) lags its
    group's quorum-th applied index; Log Matching holds and no committed
    entry changes (a re-stamp changes a term only); replicas at equal
    applied index agree; and every group commits."""
    G, P, S = 16, 5, 4
    cfg = CFG._replace(append_window=S, applies_per_round=S, timer_min=2,
                       timer_max=4)
    gen = torch.Generator().manual_seed(1)
    st = tcons.init_state(G, P, L, tcons.draw_timers(G, P, cfg, gen), cfg)
    z = torch.zeros((G, S), dtype=torch.int32)
    sub = tcons.Submits(opcode=z + tap.OP_LONG_ADD, a=z + 1, b=z, c=z,
                        tag=z, valid=torch.ones((G, S), dtype=torch.bool))
    delivers = bench.nemesis_delivers(60, G, P, "cpu")
    rng = np.random.default_rng(1)
    fullest = 0
    for r in range(60):
        dl = delivers[r]
        if r % 3 == 2:
            dl = dl & torch.from_numpy(rng.random((G, P, P)) < 0.7)
        before = st
        st, out = tcons.step(st, sub, dl, tcons.draw_timers(G, P, cfg, gen),
                             tcons.draw_timers(G, P, cfg, gen), cfg)
        st = tcons.install_snapshots(st, out.stale, out.leader, cfg)
        assert_log_matching(st)
        assert_committed_kept(before, st)
        unapplied = st.last_index - st.applied_index
        assert (unapplied <= L - 1).all(), r
        fullest = max(fullest, int(unapplied.max()))
        # the liveness lemma: a lane whose L - 1 unapplied entries end in a
        # client entry (it may not stand) has applied less than its group's
        # quorum-th lane, so such lanes are a minority
        tail = ((st.last_index - 1) % L).long()[..., None]
        client_tail = torch.gather(st.log_op, 2, tail)[..., 0] != 0
        q_applied = st.applied_index.sort(dim=1, descending=True).values[
            :, P // 2]
        blocked = (unapplied == L - 1) & client_tail
        assert (st.applied_index < q_applied[:, None])[blocked].all(), r
        assert bench.diverged_lanes(st) == 0, r
    assert fullest == L - 1, "the rings never filled: the test shows nothing"
    assert (st.applied_index.amax(dim=1) > 0).all()


def test_re_stamping_a_noop_committed_on_a_majority():
    """Lane 0 led term 2: its NoOp at index 7 reached lane 1, so lanes 0
    and 1 (a majority) hold it, and lane 0 committed it; then lane 0 was
    cut off. Lane 1, which never learned of the commit, wins term 3 and
    re-stamps that NoOp. The committed entry keeps its content on every
    lane, Log Matching holds every round, and after healing a fresh
    submit commits on all three lanes alike."""
    st = _successive_winners_state()
    i = lambda *v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    term = st.log_term.clone()
    term[0, 1] = term[0, 0]                    # lane 1 holds lane 0's log
    st = st._replace(log_term=term, term=i(2, 2, 2), voted_for=i(0, 0, 0),
                     commit_index=i(L - 1, 0, 0), timer=i(50, 2, 9))
    gen = torch.Generator().manual_seed(2)
    cut = torch.ones((1, 3, 3), dtype=torch.bool)
    cut[0, 0, 1:] = cut[0, 1:, 0] = False
    sub = tcons.make_submits(1, 4, "cpu")
    sub = sub._replace(opcode=sub.opcode + tap.OP_LONG_ADD, a=sub.a + 10,
                       tag=sub.tag + 7, valid=sub.valid.clone())
    sub.valid[0, 0] = True
    restamped = committed = False
    for r in range(40):
        healed = r >= 10
        before = st
        st, out = _step(st, gen, sub if healed and not committed else None,
                        None if healed else cut)
        assert_log_matching(st)
        assert_committed_kept(before, st)
        if int(out.leader[0]) == 1 and not restamped:
            assert int(st.log_term[0, 1, L - 2]) == 3
            assert int(st.last_index[0, 1]) == L - 1
            restamped = True
        committed |= bool((out.out_valid & (out.out_tag == 7)).any())
    assert restamped, "lane 1 never won term 3"
    assert committed, "the fresh submit never committed"
    assert (st.applied_index == L).all()
    value = st.resources.value.numpy()
    assert (value == value[:, :1]).all() and int(value[0, 0]) == 16
    # lane 0 kept its committed NoOp at index 7, content and all
    assert int(st.log_op[0, 0, L - 2]) == 0 and int(st.log_tag[0, 0, L - 2]) == 0
