"""Quorum kernels: Raft's quorum tally, alone and fused into the step.

Raft's quorum median — the k-th largest ``applied_index`` (backpressure
floor) and ``matchIndex`` (commit candidate) across a group's P lanes —
runs twice per consensus round. Counterpart of
``copycat_tpu/ops/pallas_kernels.py``:

- :func:`kth_largest_plain` — masked max-extraction in torch, the plain
  version (``pallas_kernels.kth_largest``);
- :func:`kth_largest_masked` — per-group k over a lane mask, the O(P²)
  rank-select (``pallas_kernels.kth_largest_masked``), used by dynamic
  membership;
- :func:`kth_largest` — the tally alone, the direct counterpart of the
  TPU kernel (``csrc/kth_largest.cu``);
- :func:`admit_submits` — phase 1 of the step: the backpressure tally and
  client admission (``csrc/quorum_phase.cu``);
- :func:`ack_commit` — phase 3 of the step: acks to matchIndex/nextIndex,
  the leader lease and the quorum commit advance
  (``csrc/quorum_phase.cu``).

Under dynamic membership both fused phases take ``view [G, P]`` int32, each
lane's active-config bitmask: the tally then runs over the leader lane's
members with a per-group quorum (``kth_largest_masked``), and the lease
counts member acks only. Without it they tally all P lanes against one
scalar ``quorum``.

Each of the last three dispatches on the device of its tensors: a CPU
tensor takes the plain version (``*_plain``), a CUDA tensor launches the
hand-written kernel (``*_cuda``) or raises; any other device raises. Each
dispatcher's ``launches`` counts its kernel launches.

The kernel libraries are built with ``nvcc`` at first use, one per
``csrc/*.cu`` source (all started at once by :func:`load_libraries`), into
``copycat_tpu_torch/_build/``, keyed on the hash of the source and the
headers beside it, and bound through plain C functions with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import NamedTuple

import torch

INT_MIN = -(2 ** 31)

_PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG_DIR / "csrc"
KTH_SOURCE = CSRC / "kth_largest.cu"
PHASE_SOURCE = CSRC / "quorum_phase.cu"
SOURCES = (KTH_SOURCE, PHASE_SOURCE)
BUILD_DIR = _PKG_DIR / "_build"
NVCC_DEFAULT = pathlib.Path("/usr/local/cuda/bin/nvcc")
MAX_PEERS = 8
MAX_SUBMIT_SLOTS = 256   # admit_submits stages its rows in shared memory
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C entry points and their argument types, by source file name.
ENTRY_POINTS = {
    "kth_largest.cu": {
        "kth_largest_launch": [_PTR, _PTR, _INT, _INT, _INT, _PTR]},
    "quorum_phase.cu": {
        "admit_submits_launch": [_PTR] * 10 + [_INT] * 5 + [_PTR],
        "ack_commit_launch": ([_PTR] * 18 + [ctypes.c_longlong]
                              + [_PTR] * 7 + [_INT] * 4 + [_PTR])},
}

_libs: dict[pathlib.Path, ctypes.CDLL] = {}   # loaded once per source
_entries: dict[str, ctypes._CFuncPtr] = {}    # bound once per entry point


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def kth_largest_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest along axis 1 of ``x [G, P]`` (k is 1-based): k-1
    rounds of removing the first maximum, then the maximum."""
    m = x
    for _ in range(k - 1):
        mx = m.amax(dim=1, keepdim=True)
        is_mx = m == mx
        first = (torch.cumsum(is_mx, dim=1, dtype=torch.int32) == 1) & is_mx
        m = torch.where(first, INT_MIN, m)
    return m.amax(dim=1)


def kth_largest_masked(x: torch.Tensor, mask: torch.Tensor,
                       k: torch.Tensor) -> torch.Tensor:
    """k-th largest of ``x [G, P]`` among ``mask [G, P]`` lanes, with a
    per-group ``k [G]`` (1-based): each lane's tie-broken descending rank,
    and the lane whose rank is k-1 (exactly one while k ≤ member count)."""
    P = x.shape[1]
    xm = torch.where(mask, x, INT_MIN)
    r_val = xm[:, :, None]
    s_val = xm[:, None, :]
    ids = torch.arange(P, dtype=torch.int32, device=x.device)
    r_idx = ids[None, :, None]
    s_idx = ids[None, None, :]
    beats = (s_val > r_val) | ((s_val == r_val) & (s_idx < r_idx))
    rank = beats.sum(dim=2, dtype=torch.int32)
    sel = rank == (k - 1)[:, None]
    return torch.where(sel, xm, 0).sum(dim=1, dtype=torch.int32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of every int32 element (all 32, as
    ``jax.lax.population_count`` counts them), as int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def member_lanes(mask: torch.Tensor, P: int) -> torch.Tensor:
    """Bits 0..P-1 of ``mask [...]`` int32 as a ``[..., P]`` bool."""
    ids = torch.arange(P, dtype=torch.int32, device=mask.device)
    return ((mask[..., None] >> ids) & 1).bool()


def leader_members(view: torch.Tensor, lead: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The leader lane's membership: ``(l_member [G, P] bool, l_quorum
    [G] int32)`` from ``view [G, P]`` at lane ``lead`` (a leaderless
    group's -1 reads lane 0)."""
    g_ids = torch.arange(view.shape[0], device=view.device)
    l_view = view[g_ids, lead.clamp(min=0).long()]
    return (member_lanes(l_view, view.shape[1]),
            popcount(l_view) // 2 + 1)


def term_at_2d(log_term: torch.Tensor, last: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Term lookup on a [G,L] ring at idx [G,P] (0 outside the live window)."""
    L = log_term.shape[-1]
    t = torch.gather(log_term, 1, ((idx - 1) % L).long())
    valid = (idx >= 1) & (idx <= last[:, None]) & (idx > last[:, None] - L)
    return torch.where(valid, t, 0)


class Admission(NamedTuple):
    """What phase 1 admits of a round's submits."""

    accepted: torch.Tensor   # [G,S] bool — the slot enters the leader log
    assigned: torch.Tensor   # [G,S] i32 log index (0 where not accepted)
    slot: torch.Tensor       # [G,S] i64 ring slot (L where not accepted)
    l_last: torch.Tensor     # [G] i32 leader last index after the appends


def admit_submits_plain(applied: torch.Tensor, lead: torch.Tensor,
                        accept_ok: torch.Tensor, valid: torch.Tensor,
                        l_last: torch.Tensor, quorum: int,
                        L: int, view: torch.Tensor | None = None
                        ) -> Admission:
    """Phase 1 of the step in torch: the backpressure floor — the lower of
    the leader's and the quorum-th replica's ``applied [G,P]``, plus the
    ring size L — and the submits ``valid [G,S]`` of groups whose leader
    may accept (``accept_ok [G]``) that fit under it, appended after
    ``l_last [G]``. ``lead [G]`` is -1 for a leaderless group, which reads
    lane 0 (its ``accept_ok`` is False). With ``view`` the quorum-th is
    taken among the leader lane's members, with their quorum
    (reference ``consensus.py:643``)."""
    g_ids = torch.arange(applied.shape[0], device=applied.device)
    l_applied = applied[g_ids, lead.clamp(min=0).long()]
    if view is None:
        q_applied = kth_largest_plain(applied, quorum)
    else:
        q_applied = kth_largest_masked(applied, *leader_members(view, lead))
    allowed_last = torch.minimum(l_applied, q_applied) + L
    valid = valid & accept_ok[:, None]
    pos = l_last[:, None] + torch.cumsum(valid, dim=1, dtype=torch.int32)
    accepted = valid & (pos <= allowed_last[:, None])
    # Accepted slots land at distinct ring slots (consecutive positions
    # inside the backpressure window); rejected slots go to a spill column.
    slot = torch.where(accepted, (pos - 1) % L, L).long()
    return Admission(accepted, torch.where(accepted, pos, 0), slot,
                     l_last + accepted.sum(dim=1, dtype=torch.int32))


class AckCommit(NamedTuple):
    """The leader's view after phase 3."""

    l_match: torch.Tensor       # [G,P] i32 matchIndex
    l_next: torch.Tensor        # [G,P] i32 nextIndex
    leader_stale: torch.Tensor  # [G] bool — an ack carried a higher term
    lease: torch.Tensor         # [G] bool — a same-term ack quorum
    max_ack_term: torch.Tensor  # [G] i32 highest term among the acks
    l_commit: torch.Tensor      # [G] i32 commit index


def ack_commit_plain(*, recv: torch.Tensor, reject_term: torch.Tensor,
                     del_back: torch.Tensor, match: torch.Tensor,
                     entries_sent: torch.Tensor, ok_term: torch.Tensor,
                     upto: torch.Tensor, prev: torch.Tensor,
                     term1: torch.Tensor, last_index: torch.Tensor,
                     l_match: torch.Tensor, l_next: torch.Tensor,
                     lead: torch.Tensor, active: torch.Tensor,
                     l_term: torch.Tensor, l_last: torch.Tensor,
                     l_commit: torch.Tensor, l_log_term: torch.Tensor,
                     quorum: int, view: torch.Tensor | None = None
                     ) -> AckCommit:
    """Phase 3 of the step in torch: the followers' acks (``[G,P]`` lanes
    of phase 2) update the leader's matchIndex/nextIndex; a quorum of
    same-term acks (the leader's own lane included) is the lease; the
    quorum-th matchIndex, with the leader's ``l_last`` in its own lane,
    commits when its term in the leader's ring ``l_log_term [G,L]`` is the
    leader's. ``lead [G]`` is -1 for a leaderless group, which has no self
    lane. With ``view`` the acks and the quorum-th count the leader lane's
    members only, against their quorum (reference ``consensus.py:826-829``).
    """
    P = recv.shape[1]
    ack_seen = (recv | reject_term) & del_back
    leader_stale = active & (ack_seen & (term1 > l_term[:, None])).any(dim=1)
    max_ack_term = torch.where(ack_seen, term1, 0).amax(dim=1)

    ack_success = match & del_back
    ack_match = torch.where(entries_sent, upto, prev)
    l_match = torch.where(ack_success, torch.maximum(l_match, ack_match),
                          l_match)
    l_next = torch.where(ack_success, l_match + 1, l_next)
    ack_fail = ok_term & ~match & del_back
    hint = torch.where(prev <= last_index, prev - 1, last_index)
    l_next = torch.where(ack_fail,
                         torch.minimum(prev, hint + 1).clamp(min=1), l_next)

    peer_ids = torch.arange(P, dtype=torch.int32, device=recv.device)
    self_lane = peer_ids[None, :] == lead[:, None]
    # Leader lease: a quorum of same-term acks this round (self included)
    # with no higher term observed.
    match_full = torch.where(self_lane, l_last[:, None], l_match)
    if view is None:
        acked = (ack_success | self_lane).sum(dim=1, dtype=torch.int32)
        lease_g = active & ~leader_stale & (acked >= quorum)
        cand_commit = kth_largest_plain(match_full, quorum)
    else:
        l_member, l_quorum = leader_members(view, lead)
        acked = ((ack_success | self_lane) & l_member).sum(
            dim=1, dtype=torch.int32)
        lease_g = active & ~leader_stale & (acked >= l_quorum)
        cand_commit = kth_largest_masked(match_full, l_member, l_quorum)
    cand_commit_term = term_at_2d(l_log_term, l_last,
                                  cand_commit[:, None])[:, 0]
    advance = active & ~leader_stale & (cand_commit > l_commit) \
        & (cand_commit_term == l_term)
    l_commit = torch.where(advance, cand_commit, l_commit)
    return AckCommit(l_match, l_next, leader_stale, lease_g, max_ack_term,
                     l_commit)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError(
        "nvcc not found: the CUDA toolkit is needed to build the kernels "
        f"in {CSRC}")


def library_path(source: pathlib.Path = KTH_SOURCE) -> pathlib.Path:
    """Where the built library for ``source`` lives: keyed on the content
    of the source and of the headers beside it, so an edited kernel is
    rebuilt and a stale one never loads."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_libraries(sources=SOURCES) -> list[pathlib.Path]:
    """Compile each source that is not built yet into a shared library,
    one ``nvcc`` per source, all running at once; returns the libraries'
    paths. Each is written under a temporary name and renamed, so a
    concurrent or interrupted build never leaves a partial file where a
    loader looks."""
    outs = [library_path(src) for src in sources]
    todo = [(src, out) for src, out in zip(sources, outs) if not out.exists()]
    if not todo:
        return outs
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {src.name} (rc {proc.returncode})"
                          f":\n{err[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load_library(source: pathlib.Path = KTH_SOURCE) -> ctypes.CDLL:
    """The kernel library for ``source``, built and loaded on first use,
    with its entry points' argument types set (later calls take the loaded
    library without touching a file)."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_libraries((source,))[0]))
        for name, argtypes in ENTRY_POINTS[source.name].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def load_libraries() -> None:
    """Build every kernel source at once and load each library."""
    build_libraries()
    for source in SOURCES:
        load_library(source)


def _entry(source: pathlib.Path, name: str):
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(load_library(source), name)
    return fn


def _launched(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device address, or NULL for an absent optional one."""
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` is, without
    building a ``Stream`` object, which switches the current device)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check(what: str, dev: torch.device, args) -> None:
    """Raise unless every ``(name, tensor, dtype, shape)`` is a contiguous
    tensor of that dtype and shape on ``dev``, a tensor's card."""
    for name, t, dtype, shape in args:
        if t.get_device() != dev.index or t.dtype != dtype \
                or t.shape != shape or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} tensor of "
                f"shape {tuple(shape)} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
                + ("" if t.is_contiguous() else ", not contiguous"))


def _check_sizes(what: str, P: int, quorum: int) -> None:
    if not 1 <= P <= MAX_PEERS:
        raise ValueError(f"{what} takes 1..{MAX_PEERS} peers, got {P}")
    if not 1 <= quorum <= P:
        raise ValueError(f"{what}: quorum {quorum} outside 1..{P}")


# ---------------------------------------------------------------------------
# CUDA wrappers and dispatchers
# ---------------------------------------------------------------------------

def kth_largest_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``x [G, P]`` int32 (contiguous, on the
    card) on the current stream; returns ``[G]`` int32."""
    if x.device.type != "cuda":
        raise ValueError(f"kth_largest_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise ValueError(f"kth_largest_cuda needs int32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"kth_largest_cuda needs [G, P], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("kth_largest_cuda needs a contiguous tensor")
    G, P = x.shape
    _check_sizes("kth_largest_cuda", P, k)
    launch = _entry(KTH_SOURCE, "kth_largest_launch")
    out = torch.empty(G, dtype=torch.int32, device=x.device)
    _launched("kth_largest", launch(x.data_ptr(), out.data_ptr(), G, P, k,
                                    _stream(x)))
    kth_largest.launches += 1
    return out


def admit_submits_cuda(applied: torch.Tensor, lead: torch.Tensor,
                       accept_ok: torch.Tensor, valid: torch.Tensor,
                       l_last: torch.Tensor, quorum: int,
                       L: int, view: torch.Tensor | None = None
                       ) -> Admission:
    """Launch the fused phase-1 kernel (``admit_submits_plain``'s function)
    on the current stream. Every tensor is contiguous on one card."""
    if applied.device.type != "cuda":
        raise ValueError(
            f"admit_submits_cuda needs CUDA tensors, got {applied.device}")
    if applied.dim() != 2 or valid.dim() != 2:
        raise ValueError("admit_submits_cuda needs applied [G, P] and "
                         f"valid [G, S], got {tuple(applied.shape)} and "
                         f"{tuple(valid.shape)}")
    (G, P), S = applied.shape, valid.shape[1]
    _check_sizes("admit_submits_cuda", P, quorum)
    if not 1 <= S <= MAX_SUBMIT_SLOTS:
        raise ValueError(f"admit_submits_cuda takes 1..{MAX_SUBMIT_SLOTS} "
                         f"submit slots, got {S}")
    if L < 1:
        raise ValueError(f"admit_submits_cuda: ring size {L} < 1")
    dev, i32, b8 = applied.device, torch.int32, torch.bool
    _check("admit_submits_cuda", dev, (
        ("applied", applied, i32, (G, P)), ("lead", lead, i32, (G,)),
        ("accept_ok", accept_ok, b8, (G,)), ("valid", valid, b8, (G, S)),
        ("l_last", l_last, i32, (G,)))
        + ((("view", view, i32, (G, P)),) if view is not None else ()))
    launch = _entry(PHASE_SOURCE, "admit_submits_launch")
    accepted = torch.empty((G, S), dtype=b8, device=dev)
    ints = torch.empty(G * S + G, dtype=i32, device=dev)
    assigned, l_last_out = ints[:G * S].view(G, S), ints[G * S:]
    slot = torch.empty((G, S), dtype=torch.int64, device=dev)
    _launched("admit_submits", launch(
        applied.data_ptr(), _ptr(view), lead.data_ptr(),
        accept_ok.data_ptr(), valid.data_ptr(), l_last.data_ptr(),
        accepted.data_ptr(),
        assigned.data_ptr(), slot.data_ptr(), l_last_out.data_ptr(),
        G, P, S, quorum, L, _stream(applied)))
    admit_submits.launches += 1
    return Admission(accepted, assigned, slot, l_last_out)


def ack_commit_cuda(*, recv: torch.Tensor, reject_term: torch.Tensor,
                    del_back: torch.Tensor, match: torch.Tensor,
                    entries_sent: torch.Tensor, ok_term: torch.Tensor,
                    upto: torch.Tensor, prev: torch.Tensor,
                    term1: torch.Tensor, last_index: torch.Tensor,
                    l_match: torch.Tensor, l_next: torch.Tensor,
                    lead: torch.Tensor, active: torch.Tensor,
                    l_term: torch.Tensor, l_last: torch.Tensor,
                    l_commit: torch.Tensor, l_log_term: torch.Tensor,
                    quorum: int, view: torch.Tensor | None = None
                    ) -> AckCommit:
    """Launch the fused phase-3 kernel (``ack_commit_plain``'s function)
    on the current stream. Every tensor is contiguous on one card, except
    ``l_log_term [G, L]``, whose rows need only be dense: the step's ring
    is a column slice of a wider tensor, taken as it is."""
    if recv.device.type != "cuda":
        raise ValueError(
            f"ack_commit_cuda needs CUDA tensors, got {recv.device}")
    if recv.dim() != 2 or l_log_term.dim() != 2:
        raise ValueError("ack_commit_cuda needs [G, P] lanes and a [G, L] "
                         f"ring, got {tuple(recv.shape)} and "
                         f"{tuple(l_log_term.shape)}")
    (G, P), L = recv.shape, l_log_term.shape[1]
    _check_sizes("ack_commit_cuda", P, quorum)
    if L < 1:
        raise ValueError(f"ack_commit_cuda: ring size {L} < 1")
    dev, i32, b8 = recv.device, torch.int32, torch.bool
    ins = (("recv", recv, b8, (G, P)),
           ("reject_term", reject_term, b8, (G, P)),
           ("del_back", del_back, b8, (G, P)), ("match", match, b8, (G, P)),
           ("entries_sent", entries_sent, b8, (G, P)),
           ("ok_term", ok_term, b8, (G, P)), ("upto", upto, i32, (G, P)),
           ("prev", prev, i32, (G, P)), ("term1", term1, i32, (G, P)),
           ("last_index", last_index, i32, (G, P)),
           ("l_match", l_match, i32, (G, P)),
           ("l_next", l_next, i32, (G, P)), ("lead", lead, i32, (G,)),
           ("active", active, b8, (G,)), ("l_term", l_term, i32, (G,)),
           ("l_last", l_last, i32, (G,)), ("l_commit", l_commit, i32, (G,)))
    _check("ack_commit_cuda", dev, ins)
    if view is not None:
        _check("ack_commit_cuda", dev, (("view", view, i32, (G, P)),))
    if l_log_term.device != recv.device or l_log_term.dtype != i32 \
            or l_log_term.shape[0] != G or l_log_term.stride(1) != 1:
        raise ValueError(
            "ack_commit_cuda: l_log_term must be int32 [G, L] on "
            f"{dev} with dense rows; got {l_log_term.dtype} "
            f"{tuple(l_log_term.shape)} strides {l_log_term.stride()} on "
            f"{l_log_term.device}")
    launch = _entry(PHASE_SOURCE, "ack_commit_launch")
    l_match_out, l_next_out = torch.empty((2, G, P), dtype=i32,
                                          device=dev).unbind(0)
    stale, lease = torch.empty((2, G), dtype=b8, device=dev).unbind(0)
    max_ack_term, l_commit_out = torch.empty((2, G), dtype=i32,
                                             device=dev).unbind(0)
    out = AckCommit(l_match_out, l_next_out, stale, lease, max_ack_term,
                    l_commit_out)
    _launched("ack_commit", launch(
        *(t.data_ptr() for _, t, _, _ in ins), l_log_term.data_ptr(),
        l_log_term.stride(0), _ptr(view), *(o.data_ptr() for o in out), G,
        P, quorum, L, _stream(recv)))
    ack_commit.launches += 1
    return out


def _on(what: str, t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{what}: unsupported device {t.device}")


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest along axis 1 of ``x [G, P]``: the plain version on a
    CPU tensor, the CUDA kernel on a CUDA tensor. Any other device raises."""
    if _on("kth_largest", x) == "cpu":
        return kth_largest_plain(x, k)
    return kth_largest_cuda(x, k)


def admit_submits(applied: torch.Tensor, lead: torch.Tensor,
                  accept_ok: torch.Tensor, valid: torch.Tensor,
                  l_last: torch.Tensor, quorum: int, L: int,
                  view: torch.Tensor | None = None) -> Admission:
    """Phase 1 (``admit_submits_plain``): the plain version on CPU
    tensors, the fused CUDA kernel on CUDA tensors."""
    fn = admit_submits_plain if _on("admit_submits", applied) == "cpu" \
        else admit_submits_cuda
    return fn(applied, lead, accept_ok, valid, l_last, quorum, L, view)


def ack_commit(**kw) -> AckCommit:
    """Phase 3 (``ack_commit_plain``, same keyword arguments): the plain
    version on CPU tensors, the fused CUDA kernel on CUDA tensors."""
    fn = ack_commit_plain if _on("ack_commit", kw["recv"]) == "cpu" \
        else ack_commit_cuda
    return fn(**kw)


kth_largest.launches = 0
admit_submits.launches = 0
ack_commit.launches = 0
