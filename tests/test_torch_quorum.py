"""The fused quorum phases of ``copycat_tpu_torch/ops/kernels.py`` against
the JAX reference (``copycat_tpu/ops/consensus.py``).

``admit_submits_plain`` and ``ack_commit_plain`` are held, exactly (int and
bool), against the reference's own phase expressions composed in jnp on
the same numpy-seeded inputs (``copycat_tpu_torch/cases.py``), for P ∈ {3,
5, 7} and the edge cases the inputs carry:

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

The CUDA kernels are held against the plain versions by the ``cuda``-marked
tests at the end, which need no JAX (the reference is imported only where
it is used), so they run where the card is.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from copycat_tpu_torch import cases  # noqa: E402
from copycat_tpu_torch.ops import kernels  # noqa: E402

G, S, L = 300, 16, 16


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, imported only for the tests that use them."""
    pytest.importorskip("jax")
    from copycat_tpu.ops import consensus, pallas_kernels
    return consensus, pallas_kernels


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


def _ref_admit(ref, c: dict, quorum: int, view=None):
    """Reference 642-647, 654 and 708-713 (the static tally, or with
    ``view`` the masked one), on jnp."""
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
    allowed_last = jnp.minimum(l_applied, q_applied) + L
    valid = jnp.asarray(c["valid"]) & jnp.asarray(c["accept_ok"])[:, None]
    pos = l_last[:, None] + jnp.cumsum(valid.astype(jnp.int32), axis=1)
    accepted = valid & (pos <= allowed_last[:, None])
    slot_s = jnp.where(accepted, (pos - 1) % L, L)
    return dict(accepted=accepted, assigned=jnp.where(accepted, pos, 0),
                slot=slot_s,
                l_last=l_last + accepted.sum(axis=1, dtype=jnp.int32))


def _ref_ack(ref, c: dict, quorum: int, view=None):
    """Reference 807-838 (the static path, or with ``view`` the masked
    one), on jnp; also returns the commit candidate, so the test can see
    which edge cases the inputs hit."""
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
                l_commit=l_commit), np.asarray(cand_commit)


def _assert_equal(got, want: dict, int64=()):
    for name, w in want.items():
        g = getattr(got, name).numpy()
        w = np.asarray(w)
        assert g.dtype == (np.int64 if name in int64 else w.dtype), name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("P", [3, 5, 7])
def test_admit_submits_matches_reference(ref, P):
    quorum = P // 2 + 1
    c = cases.admit_case(np.random.default_rng(P), G, P, S, L)
    want = _ref_admit(ref, c, quorum)
    got = kernels.admit_submits(**_torch(c), quorum=quorum, L=L)
    # the slot is int64 in the port: scatter takes int64 indices
    _assert_equal(got, want, int64=("slot",))
    accepted = np.asarray(want["accepted"])
    offered = c["valid"] & c["accept_ok"][:, None]
    assert not accepted[c["lead"] < 0].any()           # leaderless
    assert offered[1].all() and not accepted[1].any()  # all refused
    assert accepted[2].all()                           # room for every slot
    assert (accepted.sum(1) < offered.sum(1)).any()    # cut mid-window


@pytest.mark.parametrize("P", [3, 5, 7])
def test_ack_commit_matches_reference(ref, P):
    quorum = P // 2 + 1
    c = cases.ack_case(np.random.default_rng(10 + P), G, P, L)
    want, cand = _ref_ack(ref, c, quorum)
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


@pytest.mark.parametrize("P", [3, 5, 7])
def test_masked_phases_match_reference(ref, P):
    """Both phases with a member view: the masked tally with a per-group
    quorum, the lease over member acks."""
    rng = np.random.default_rng(20 + P)
    a = cases.admit_case(rng, G, P, S, L)
    a_view = cases.member_views(rng, a["lead"], P)
    want = _ref_admit(ref, a, 0, a_view)
    got = kernels.admit_submits(**_torch(a), quorum=P // 2 + 1, L=L,
                                view=torch.from_numpy(a_view))
    _assert_equal(got, want, int64=("slot",))
    k = cases.ack_case(rng, G, P, L)
    k_view = cases.member_views(rng, k["lead"], P)
    want, cand = _ref_ack(ref, k, 0, k_view)
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


def test_library_key_covers_the_shared_header(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("#include \"h.cuh\"\n")
    (tmp_path / "h.cuh").write_text("// one")
    first = kernels.library_path(src)
    (tmp_path / "h.cuh").write_text("// two")
    assert kernels.library_path(src) != first


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P", [3, 5, 7])
def test_admit_submits_cuda_matches_plain(cuda_device, P):
    c = _torch(cases.admit_case(np.random.default_rng(P), 10_001, P, 16, 64))
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
@pytest.mark.parametrize("P", [3, 5, 7])
def test_ack_commit_cuda_matches_plain(cuda_device, P):
    c = _torch(cases.ack_case(np.random.default_rng(P), 10_001, P, 64))
    want = kernels.ack_commit_plain(**c, quorum=P // 2 + 1)
    on_card = {n: t.to(cuda_device) for n, t in c.items()}
    # the step's ring is a column slice of a wider tensor: rows L+1 apart
    wide = torch.zeros((10_001, 65), dtype=torch.int32, device=cuda_device)
    wide[:, :64] = on_card["l_log_term"]
    on_card["l_log_term"] = wide[:, :64]
    before = kernels.ack_commit.launches
    got = kernels.ack_commit(**on_card, quorum=P // 2 + 1)
    assert kernels.ack_commit.launches == before + 1
    for name, w in want._asdict().items():
        g = getattr(got, name).cpu()
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("P", [3, 5, 7])
def test_masked_kernels_cuda_match_plain(cuda_device, P):
    """Both fused kernels with a member view, and the static path beside
    them, equal their plain versions bit for bit."""
    rng = np.random.default_rng(30 + P)
    a = cases.admit_case(rng, 10_001, P, 16, 64)
    a["view"] = cases.member_views(rng, a["lead"], P)
    k = cases.ack_case(rng, 10_001, P, 64)
    k["view"] = cases.member_views(rng, k["lead"], P)
    for fn, plain, case, kw in (
            (kernels.admit_submits, kernels.admit_submits_plain, a,
             dict(quorum=P // 2 + 1, L=64)),
            (kernels.ack_commit, kernels.ack_commit_plain, k,
             dict(quorum=P // 2 + 1))):
        c = _torch(case)
        want = plain(**c, **kw)
        before = fn.launches
        got = fn(**{n: t.to(cuda_device) for n, t in c.items()}, **kw)
        assert fn.launches == before + 1
        for name, w in want._asdict().items():
            g = getattr(got, name).cpu()
            assert g.dtype == w.dtype and torch.equal(g, w), name
