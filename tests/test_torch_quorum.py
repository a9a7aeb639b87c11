"""The fused quorum phases of ``copycat_tpu_torch/ops/kernels.py`` against
the JAX reference (``copycat_tpu/ops/consensus.py``).

``admit_submits_plain`` and ``ack_commit_plain`` are held, exactly (int and
bool), against the reference's own phase expressions composed in jnp on
the same numpy-seeded inputs (``copycat_tpu_torch/cases.py``), for P from
3 to 33 (the unrolled kernels' P <= 8, and the edges of the warp tiles that
take wider groups: 16 and 32 lanes a tile, more than 32 lanes a thread)
and the edge cases the inputs carry:

- phase 1, backpressure and admission: reference lines 642-647 (the
  static path's tally), 654 and 708-713 (the static-path admission, with
  no ``dyn`` or monotone-gate branch), and the ``assigned`` output
  (1125);
- phase 3, acks to the commit advance: reference lines 807-838, with the
  tally from the Pallas kernel ``kth_largest_pallas`` in interpret mode
  (the TPU kernel the fused kernels replace) and the reference's
  ``_term_at_2d``;
- both phases under dynamic membership, with ``view`` (``cases.
  member_views``): the reference's ``kth_largest_masked`` over the leader
  lane's members with the per-group quorum ``l_quorum`` (lines 605-611,
  643-644 and 826-829).

Both phases also hold, static at P = 3 and masked at P = 5, on
``cases.EDGE_SHAPES``: the groups, submit rows and ring sizes at the
kernels' boundaries (ragged last tiles and blocks, one slot a thread or
four, rows wider than a warp's step, a ring of one slot).

The reference's expressions run once, in a worker process started with
the session's first port file (``torch_reference.LONG_RUNS``), and their
answers come back to the cases.

The CUDA kernels are held against the plain versions by the ``cuda``-marked
tests at the end, which need no JAX (the reference is imported only where
it is used), so they run where the card is.
"""

import os
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from copycat_tpu_torch import cases  # noqa: E402
from copycat_tpu_torch.ops import kernels  # noqa: E402

try:
    from torch_reference import LONG_RUNS
except ImportError:     # no JAX where the card is: its cases need none
    LONG_RUNS = {}

G, S, L = 300, 16, 16


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, imported only for the tests that use them."""
    pytest.importorskip("jax")
    from copycat_tpu.ops import consensus, pallas_kernels
    return consensus, pallas_kernels


@lru_cache(maxsize=None)
def _compiled(expr):
    """A reference expression (``_ref_admit``, ``_ref_ack``) compiled as
    one program per input shape, the modules, the quorum and the ring size
    static: the same jnp ops as dispatching them one by one, without a
    small compile for each."""
    import jax
    return jax.jit(expr, static_argnums=(0, 2), static_argnames=("ring",))


def _torch(case: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in case.items()}


def _ref_members(ref, view, lead):
    """Reference 605-611: the leader lane's members and their quorum."""
    import jax
    import jax.numpy as jnp
    jcons, _ = ref
    P = view.shape[1]
    view, lead = jnp.asarray(view), jnp.asarray(lead)
    view_quorum = jax.lax.population_count(view) // 2 + 1
    l_view = jcons._peer_view(view, lead)
    l_member = ((l_view[:, None] >> jnp.arange(P)[None, :]) & 1).astype(bool)
    return l_member, jcons._peer_view(view_quorum, lead)


def _ref_admit(ref, c: dict, quorum: int, view=None, *, ring: int = L):
    """Reference 642-647, 654 and 708-713 (the static tally, or with
    ``view`` the masked one), on jnp, with a ring of ``ring`` slots."""
    import jax.numpy as jnp
    jcons, jpk = ref
    applied, lead = jnp.asarray(c["applied"]), jnp.asarray(c["lead"])
    l_last = jnp.asarray(c["l_last"])
    l_applied = jcons._peer_view(applied, lead)
    if view is None:
        q_applied = jpk.kth_largest_pallas(applied, quorum, block=128,
                                           interpret=True)
    else:
        q_applied = jpk.kth_largest_masked(applied,
                                           *_ref_members(ref, view, lead))
    allowed_last = jnp.minimum(l_applied, q_applied) + ring
    valid = jnp.asarray(c["valid"]) & jnp.asarray(c["accept_ok"])[:, None]
    pos = l_last[:, None] + jnp.cumsum(valid.astype(jnp.int32), axis=1)
    accepted = valid & (pos <= allowed_last[:, None])
    slot_s = jnp.where(accepted, (pos - 1) % ring, ring)
    return dict(accepted=accepted, assigned=jnp.where(accepted, pos, 0),
                slot=slot_s,
                l_last=l_last + accepted.sum(axis=1, dtype=jnp.int32))


def _ref_ack(ref, c: dict, quorum: int, view=None, *, ring: int = L):
    """Reference 807-838 (the static path, or with ``view`` the masked
    one), on jnp; also returns the commit candidate, so the test can see
    which edge cases the inputs hit. ``ring`` is unused: the ring's size
    is ``l_log_term``'s."""
    import jax.numpy as jnp
    jcons, jpk = ref
    j = {k: jnp.asarray(v) for k, v in c.items()}
    P = c["recv"].shape[1]
    recv, del_back, term1 = j["recv"], j["del_back"], j["term1"]
    prev, match, l_term = j["prev"], j["match"], j["l_term"]
    active, lead, l_last = j["active"], j["lead"], j["l_last"]
    l_match, l_next, l_commit = j["l_match"], j["l_next"], j["l_commit"]

    ack_seen = (recv | j["reject_term"]) & del_back
    leader_stale = active & jnp.any(ack_seen & (term1 > l_term[:, None]),
                                    axis=1)
    max_ack_term = jnp.max(jnp.where(ack_seen, term1, 0), axis=1)
    ack_success = match & del_back
    ack_match = jnp.where(j["entries_sent"], j["upto"], prev)
    l_match = jnp.where(ack_success, jnp.maximum(l_match, ack_match), l_match)
    l_next = jnp.where(ack_success, l_match + 1, l_next)
    ack_fail = j["ok_term"] & ~match & del_back
    hint = jnp.where(prev <= j["last_index"], prev - 1, j["last_index"])
    l_next = jnp.where(ack_fail,
                       jnp.clip(jnp.minimum(prev, hint + 1), 1, None), l_next)
    peer_ids = jnp.arange(P, dtype=jnp.int32)
    self_lane = peer_ids[None, :] == lead[:, None]
    match_full = jnp.where(self_lane, l_last[:, None], l_match)
    if view is None:
        acked = jnp.sum(ack_success | self_lane, axis=1)
        lease_g = active & ~leader_stale & (acked >= quorum)
        cand_commit = jpk.kth_largest_pallas(match_full, quorum, block=128,
                                             interpret=True)
    else:
        l_member, l_quorum = _ref_members(ref, view, lead)
        acked = jnp.sum((ack_success | self_lane) & l_member, axis=1)
        lease_g = active & ~leader_stale & (acked >= l_quorum)
        cand_commit = jpk.kth_largest_masked(match_full, l_member, l_quorum)
    cand_commit_term = jcons._term_at_2d(j["l_log_term"], l_last,
                                         cand_commit[:, None])[:, 0]
    advance = active & ~leader_stale & (cand_commit > l_commit) \
        & (cand_commit_term == l_term)
    l_commit = jnp.where(advance, cand_commit, l_commit)
    return dict(l_match=l_match, l_next=l_next, leader_stale=leader_stale,
                lease=lease_g, max_ack_term=max_ack_term,
                l_commit=l_commit), cand_commit


def _assert_equal(got, want: dict, int64=()):
    for name, w in want.items():
        g = getattr(got, name).numpy()
        w = np.asarray(w)
        assert g.dtype == (np.int64 if name in int64 else w.dtype), name
        np.testing.assert_array_equal(g, w, err_msg=name)


PHASE_PEERS = [3, 5, 7, 9, 16, 32, 33]
MASKED_PEERS = [3, 5, 7, 9, 16, 32]


def _masked_cases(P):
    rng = np.random.default_rng(20 + P)
    a = cases.admit_case(rng, G, P, S, L)
    a_view = cases.member_views(rng, a["lead"], P)
    k = cases.ack_case(rng, G, P, L)
    k_view = cases.member_views(rng, k["lead"], P)
    return a, a_view, k, k_view


def _edge_cases(G: int, S: int, L_: int) -> dict:
    """Phase inputs at an edge shape: static at P = 3, masked at P = 5."""
    rng = np.random.default_rng(G + 7 * S + 31 * L_)
    out = {}
    for P, masked in ((3, False), (5, True)):
        a = cases.admit_case(rng, G, P, S, L_)
        k = cases.ack_case(rng, G, P, L_)
        if masked:
            a["view"] = cases.member_views(rng, a["lead"], P)
            k["view"] = cases.member_views(rng, k["lead"], P)
        out[P] = a, k
    return out


def _reference_answers() -> dict:
    """Every case's reference answer, as numpy."""
    import jax
    from copycat_tpu.ops import consensus, pallas_kernels
    ref = consensus, pallas_kernels
    out = {}
    for P in PHASE_PEERS:
        quorum = P // 2 + 1
        out["admit", P] = _compiled(_ref_admit)(ref, cases.admit_case(
            np.random.default_rng(P), G, P, S, L), quorum)
        out["ack", P] = _compiled(_ref_ack)(ref, cases.ack_case(
            np.random.default_rng(10 + P), G, P, L), quorum)
    for P in MASKED_PEERS:
        a, a_view, k, k_view = _masked_cases(P)
        out["masked", P] = (_compiled(_ref_admit)(ref, a, 0, a_view),
                            _compiled(_ref_ack)(ref, k, 0, k_view)[0])
    for shape in cases.EDGE_SHAPES:
        for P, (a, k) in _edge_cases(*shape).items():
            a, k = dict(a), dict(k)
            a_view, k_view = a.pop("view", None), k.pop("view", None)
            out["edge", shape, P] = (
                _compiled(_ref_admit)(ref, a, P // 2 + 1, a_view,
                                      ring=shape[2]),
                _compiled(_ref_ack)(ref, k, P // 2 + 1, k_view,
                                    ring=shape[2])[0])
    return jax.tree.map(np.asarray, out)


def _answers(ref):
    from torch_reference import SUITE_AHEAD
    return SUITE_AHEAD.get("quorum", _reference_answers)


@pytest.mark.parametrize("P", PHASE_PEERS)
def test_admit_submits_matches_reference(ref, P):
    quorum = P // 2 + 1
    c = cases.admit_case(np.random.default_rng(P), G, P, S, L)
    want = _answers(ref)["admit", P]
    got = kernels.admit_submits(**_torch(c), quorum=quorum, L=L)
    # the slot is int64 in the port: scatter takes int64 indices
    _assert_equal(got, want, int64=("slot",))
    accepted = np.asarray(want["accepted"])
    offered = c["valid"] & c["accept_ok"][:, None]
    assert not accepted[c["lead"] < 0].any()           # leaderless
    assert offered[1].all() and not accepted[1].any()  # all refused
    assert accepted[2].all()                           # room for every slot
    assert (accepted.sum(1) < offered.sum(1)).any()    # cut mid-window


@pytest.mark.parametrize("P", PHASE_PEERS)
def test_ack_commit_matches_reference(ref, P):
    quorum = P // 2 + 1
    c = cases.ack_case(np.random.default_rng(10 + P), G, P, L)
    want, cand = _answers(ref)["ack", P]
    cand = np.asarray(cand)
    got = kernels.ack_commit(**_torch(c), quorum=quorum)
    _assert_equal(got, want)
    l_last = c["l_last"]
    live = (cand >= 1) & (cand <= l_last) & (cand > l_last - L)
    stale = np.asarray(want["leader_stale"])
    advanced = np.asarray(want["l_commit"]) != c["l_commit"]
    assert not c["active"][0] and not stale[0] and not advanced[0]
    assert cand[1] == 0 and not advanced[1]
    assert 1 <= cand[2] <= l_last[2] - L and not live[2]
    assert stale[3] and not advanced[3]
    assert advanced[4] and want["l_commit"][4] == cand[4] == 2 * L - 3
    assert advanced.any() and (~advanced & live & c["active"]).any()
    # duplicate matchIndex values in the random rows too
    srt = np.sort(c["l_match"], axis=1)
    assert (srt[:, 1:] == srt[:, :-1]).any(axis=1).mean() > 0.3


@pytest.mark.parametrize("P", MASKED_PEERS)
def test_masked_phases_match_reference(ref, P):
    """Both phases with a member view: the masked tally with a per-group
    quorum, the lease over member acks."""
    a, a_view, k, k_view = _masked_cases(P)
    want_admit, want = _answers(ref)["masked", P]
    got = kernels.admit_submits(**_torch(a), quorum=P // 2 + 1, L=L,
                                view=torch.from_numpy(a_view))
    _assert_equal(got, want_admit, int64=("slot",))
    got = kernels.ack_commit(**_torch(k), quorum=P // 2 + 1,
                             view=torch.from_numpy(k_view))
    _assert_equal(got, want)
    # the masked tally differs from the static one somewhere, and a
    # leader outside its own view still commits by its members' acks
    static = kernels.ack_commit(**_torch(k), quorum=P // 2 + 1)
    assert (static.l_commit != got.l_commit).any()
    ld = np.maximum(k["lead"], 0)
    outside = ~((k_view[np.arange(G), ld] >> ld) & 1).astype(bool)
    advanced = np.asarray(want["l_commit"]) != k["l_commit"]
    assert (outside & advanced).any()


@pytest.mark.parametrize("shape", cases.EDGE_SHAPES,
                         ids=lambda s: "G{}-S{}-L{}".format(*s))
def test_admit_submits_edges_match_reference(ref, shape):
    """Phase 1 at the kernels' boundaries, static (P = 3) and masked
    (P = 5): ragged tiles and blocks, one slot a thread or four, rows
    wider than a warp's step, a ring of one slot."""
    G_, S_, L_ = shape
    for P, (a, _) in _edge_cases(*shape).items():
        want = _answers(ref)["edge", shape, P][0]
        got = kernels.admit_submits(**_torch(a), quorum=P // 2 + 1, L=L_)
        _assert_equal(got, want, int64=("slot",))
        accepted = np.asarray(want["accepted"])
        assert accepted.shape == (G_, S_)
        if G_ > 1 and L_ > 1:
            assert accepted.any()


@pytest.mark.parametrize("shape", cases.EDGE_SHAPES,
                         ids=lambda s: "G{}-S{}-L{}".format(*s))
def test_ack_commit_edges_match_reference(ref, shape):
    """Phase 3 at the same shapes, static (P = 3) and masked (P = 5)."""
    G_, _, L_ = shape
    for P, (_, k) in _edge_cases(*shape).items():
        want = _answers(ref)["edge", shape, P][1]
        got = kernels.ack_commit(**_torch(k), quorum=P // 2 + 1)
        _assert_equal(got, want)
        assert got.l_commit.shape == (G_,)


def test_fused_phases_take_the_plain_versions_only_on_cpu():
    a = _torch(cases.admit_case(np.random.default_rng(0), 8, 3, 4, 8))
    k = _torch(cases.ack_case(np.random.default_rng(0), 8, 3, 8))
    before = (kernels.admit_submits.launches, kernels.ack_commit.launches)
    kernels.admit_submits(**a, quorum=2, L=8)
    kernels.ack_commit(**k, quorum=2)
    assert (kernels.admit_submits.launches,
            kernels.ack_commit.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.admit_submits(**{n: t.to("meta") for n, t in a.items()},
                              quorum=2, L=8)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.ack_commit(**{n: t.to("meta") for n, t in k.items()},
                           quorum=2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernels.admit_submits_cuda(**a, quorum=2, L=8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernels.ack_commit_cuda(**k, quorum=2)


def test_ack_commit_checks_raise_on_what_the_kernel_does_not_take():
    """``ack_commit_cuda``'s one-pass checks (``_check_many``) take the
    phase's [G, P] lanes and [G] values as the kernel needs them, and
    raise, naming the input, on a wrong dtype, shape or layout."""
    k = _torch(cases.ack_case(np.random.default_rng(0), 8, 3, 8))
    for specs, shape in ((kernels._ACK_LANES, (8, 3)),
                         (kernels._ACK_GROUPS, (8,))):
        good = [k[name] for name, _ in specs]
        kernels._check_many("ack_commit_cuda", k["recv"], good, specs,
                            shape)
        for i, (name, dtype) in enumerate(specs):
            t = good[i]
            wrong_dtype = t.to(torch.int64)
            wrong_shape = t[:4]
            strided = torch.stack([t, t], -1)[..., 0]
            assert strided.shape == t.shape and not strided.is_contiguous()
            for bad in (wrong_dtype, wrong_shape, strided):
                tensors = good[:i] + [bad] + good[i + 1:]
                with pytest.raises(ValueError, match=name):
                    kernels._check_many("ack_commit_cuda", k["recv"],
                                        tensors, specs, shape)


@pytest.mark.parametrize("P,masked", [(9, False), (16, False), (64, False),
                                      (9, True), (32, True)])
def test_wide_groups_pass_the_size_checks(P, masked):
    """The kernels take any P (a runtime-P instantiation past the unrolled
    ones); only a member view is bounded, by the 32 lanes its int32 word
    names."""
    for what in ("kth_largest_cuda", "admit_submits_cuda",
                 "ack_commit_cuda"):
        kernels._check_sizes(what, P, P // 2 + 1, masked)
        with pytest.raises(ValueError, match="quorum"):
            kernels._check_sizes(what, P, P + 1, masked)


def test_member_views_stop_at_32_lanes():
    with pytest.raises(ValueError, match="int32 bitmask"):
        kernels._check_sizes("admit_submits_cuda", 33, 17, masked=True)
    with pytest.raises(ValueError, match="at least one peer"):
        kernels._check_sizes("ack_commit_cuda", 0, 1)


@pytest.mark.parametrize("P", [3, 8, 9, 16, 33])
def test_dispatch_sends_every_cuda_tensor_to_the_kernel(monkeypatch, P):
    """Whatever P, a tensor on the card reaches the CUDA wrapper and never
    the plain version (the device is faked: this machine may have no
    card)."""
    calls = []
    for name in ("kth_largest", "admit_submits", "ack_commit"):
        monkeypatch.setattr(kernels, f"{name}_plain",
                            lambda *a, name=name, **k: calls.append(
                                ("plain", name)))
        monkeypatch.setattr(kernels, f"{name}_cuda",
                            lambda *a, name=name, **k: calls.append(
                                ("cuda", name)))
    monkeypatch.setattr(kernels, "_on", lambda what, t: "cuda")
    rng = np.random.default_rng(P)
    a = _torch(cases.admit_case(rng, 8, P, 4, 8))
    k = _torch(cases.ack_case(rng, 8, P, 8))
    kernels.kth_largest(a["applied"], P // 2 + 1)
    kernels.admit_submits(**a, quorum=P // 2 + 1, L=8)
    kernels.ack_commit(**k, quorum=P // 2 + 1)
    assert calls == [("cuda", "kth_largest"), ("cuda", "admit_submits"),
                     ("cuda", "ack_commit")]


def test_library_key_covers_the_shared_header(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("#include \"h.cuh\"\n")
    (tmp_path / "h.cuh").write_text("// one")
    first = kernels.library_path(src)
    (tmp_path / "h.cuh").write_text("// two")
    assert kernels.library_path(src) != first


LONG_RUNS.update({f"{os.path.basename(__file__)}::{test}": [
    ("quorum", _reference_answers, ())] for test in (
        "test_admit_submits_matches_reference",
        "test_ack_commit_matches_reference",
        "test_masked_phases_match_reference",
        "test_admit_submits_edges_match_reference",
        "test_ack_commit_edges_match_reference")})


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (P, G) on the card: P = 3, 5, 7, 9 and 16 at G = 10,001; every other
# instantiation of the P <= 8 path, and the warp tiles' edges (16 and 32
# lanes a tile, more than 32 lanes a thread), at G = 1,001, a partial last
# tile and block
CUDA_SHAPES = ([(P, 10_001) for P in (3, 5, 7, 9, 16)]
               + [(P, 1_001) for P in (1, 2, 4, 6, 8, 9, 16, 17, 32, 33)])


@pytest.mark.cuda
@pytest.mark.parametrize("P,groups", CUDA_SHAPES)
def test_admit_submits_cuda_matches_plain(cuda_device, P, groups):
    c = _torch(cases.admit_case(np.random.default_rng(P), groups, P, 16, 64))
    want = kernels.admit_submits_plain(**c, quorum=P // 2 + 1, L=64)
    before = kernels.admit_submits.launches
    got = kernels.admit_submits(**{n: t.to(cuda_device) for n, t in c.items()},
                                quorum=P // 2 + 1, L=64)
    assert kernels.admit_submits.launches == before + 1
    for name, w in want._asdict().items():
        g = getattr(got, name).cpu()
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("P,groups", CUDA_SHAPES)
def test_ack_commit_cuda_matches_plain(cuda_device, P, groups):
    c = _torch(cases.ack_case(np.random.default_rng(P), groups, P, 64))
    want = kernels.ack_commit_plain(**c, quorum=P // 2 + 1)
    on_card = {n: t.to(cuda_device) for n, t in c.items()}
    # the step's ring is a column slice of a wider tensor: rows L+1 apart
    wide = torch.zeros((groups, 65), dtype=torch.int32, device=cuda_device)
    wide[:, :64] = on_card["l_log_term"]
    on_card["l_log_term"] = wide[:, :64]
    before = kernels.ack_commit.launches
    got = kernels.ack_commit(**on_card, quorum=P // 2 + 1)
    assert kernels.ack_commit.launches == before + 1
    for name, w in want._asdict().items():
        g = getattr(got, name).cpu()
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


# the tally alone past 8 peers: CUDA_SHAPES' wide shapes, two lanes a
# thread (64), and more lanes a thread than it keeps in registers (130)
WIDE_TALLY_SHAPES = ([(P, G_) for P, G_ in CUDA_SHAPES if P > 8]
                     + [(64, 1_001), (130, 1_001)])


@pytest.mark.cuda
@pytest.mark.parametrize("P,groups", WIDE_TALLY_SHAPES)
def test_wide_kth_largest_cuda_matches_plain(cuda_device, P, groups):
    """The warp-tile tally equals the plain version bit for bit at k = 1,
    the quorum and P, on rows with duplicates and INT32_MIN lanes."""
    rng = np.random.default_rng(50 + P)
    x = rng.integers(-1000, 1000, (groups, P)).astype(np.int32)
    dup = rng.random(groups) < 0.2
    x[dup] = x[dup, :1]
    x[rng.random((groups, P)) < 0.1] = kernels.INT_MIN
    xc = torch.from_numpy(x).to(cuda_device)
    for k in sorted({1, P // 2 + 1, P}):
        got = kernels.kth_largest_cuda(xc, k).cpu()
        want = kernels.kth_largest_plain(torch.from_numpy(x), k)
        assert got.dtype == want.dtype and torch.equal(got, want), k


def _ring_slice(ring: torch.Tensor, first: int = 0) -> torch.Tensor:
    """The ring as the step hands it over: columns ``first`` .. ``first +
    L - 1`` of a [G, L + 1] tensor, rows L + 1 elements apart."""
    G_, L_ = ring.shape
    wide = torch.zeros((G_, L_ + 1), dtype=ring.dtype, device=ring.device)
    wide[:, first:first + L_] = ring
    return wide[:, first:first + L_]


def _held_to_plain(cuda_device, a: dict, k: dict, P: int, L_: int = 64,
                   misaligned: bool = False) -> None:
    """Both fused kernels on the phases' inputs ``a`` and ``k`` equal their
    plain versions bit for bit, one launch each. The ring is a column slice
    of a wider tensor; ``misaligned`` puts every input one element past
    the start of its storage (``cases.misalign``) and the ring's first
    column at 1."""
    place = cases.misalign if misaligned else (lambda t: t)
    for fn, plain, case, kw in (
            (kernels.admit_submits, kernels.admit_submits_plain, a,
             dict(quorum=P // 2 + 1, L=L_)),
            (kernels.ack_commit, kernels.ack_commit_plain, k,
             dict(quorum=P // 2 + 1))):
        c = _torch(case)
        want = plain(**c, **kw)
        before = fn.launches
        on_card = {n: place(t.to(cuda_device)) for n, t in c.items()
                   if n != "l_log_term"}
        if "l_log_term" in c:
            on_card["l_log_term"] = _ring_slice(
                c["l_log_term"].to(cuda_device), int(misaligned))
        got = fn(**on_card, **kw)
        assert fn.launches == before + 1
        for name, w in want._asdict().items():
            g = getattr(got, name).cpu()
            assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("P,groups", [
    (P, G_) for P, G_ in CUDA_SHAPES if P <= kernels.MAX_MEMBER_LANES])
def test_masked_kernels_cuda_match_plain(cuda_device, P, groups):
    """Both fused kernels with a member view equal their plain versions
    bit for bit."""
    rng = np.random.default_rng(30 + P)
    a = cases.admit_case(rng, groups, P, 16, 64)
    a["view"] = cases.member_views(rng, a["lead"], P)
    k = cases.ack_case(rng, groups, P, 64)
    k["view"] = cases.member_views(rng, k["lead"], P)
    _held_to_plain(cuda_device, a, k, P)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_wide_kernels_cuda_on_ties_and_int_min(cuda_device, masked):
    """At P = 32, one full tile: rows whose lanes all tie, and rows
    carrying INT32_MIN lanes, in both tallies (applied and matchIndex),
    static and with a member view."""
    P, groups = 32, 1_001
    rng = np.random.default_rng(41)
    a = cases.admit_case(rng, groups, P, 16, 64)
    k = cases.ack_case(rng, groups, P, 64)
    for case, lanes in ((a, "applied"), (k, "l_match")):
        x = case[lanes]
        tie = rng.random(groups) < 0.3
        x[tie] = x[tie, :1]
        low = (rng.random((groups, P)) < 0.2) & ~tie[:, None]
        low[rng.random(groups) < 0.1] = True          # whole rows at INT32_MIN
        x[low] = kernels.INT_MIN
        if masked:
            case["view"] = cases.member_views(rng, case["lead"], P)
    _held_to_plain(cuda_device, a, k, P)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", cases.EDGE_SHAPES,
                         ids=lambda s: "G{}-S{}-L{}".format(*s))
def test_edge_shapes_cuda_match_plain(cuda_device, shape):
    """Both fused kernels, static (P = 3) and masked (P = 5), at the
    boundaries of their tiles, blocks, slot steps and ring: equal to their
    plain versions bit for bit, the ring rows L + 1 elements apart."""
    for P, (a, k) in _edge_cases(*shape).items():
        _held_to_plain(cuda_device, a, k, P, shape[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", cases.EDGE_SHAPES,
                         ids=lambda s: "G{}-S{}-L{}".format(*s))
def test_misaligned_inputs_cuda_match_plain(cuda_device, shape):
    """Every input one element past the start of its storage (``valid``'s
    rows off their 4- and 16-byte alignment, so phase 1 takes one slot a
    thread) and the ring a column slice from column 1: the same bits."""
    for P, (a, k) in _edge_cases(*shape).items():
        _held_to_plain(cuda_device, a, k, P, shape[2], misaligned=True)
