"""Random inputs for the fused quorum kernels, with their edge cases.

``tests/test_torch_quorum.py`` feeds them to the JAX reference's phase
expressions and to the plain versions; ``chip_smoke.py`` feeds them to the
CUDA kernels and the plain versions on the card. Each function returns a
dict of numpy arrays named as the keyword arguments of
``ops/kernels.admit_submits_plain`` / ``ack_commit_plain``, made from a
numpy ``Generator``. Values are log indices and terms of the size a run
reaches, so no int32 arithmetic of the step overflows on them.

The first groups of every case are fixed edge rows, so each case holds
them whatever its size (G >= 5):

- ``admit_case``: a leaderless group (``lead = -1``); a group whose
  submits are all refused by backpressure; a group with equal
  ``applied_index`` on every lane;
- ``ack_case``: a leaderless group; a group whose commit candidate is 0;
  a candidate below the ring's live window; ``leader_stale`` from a
  higher-term ack; duplicate ``matchIndex`` values.

The random rows after them mix the same conditions. ``member_views``
gives the dynamic-membership form of either phase its ``view``: the
leader lane's word is one member in group 0, every lane in group 1 and
every lane but the leader in group 2; in the random rows it is any
non-empty set of lanes, without the leader in about a fifth of them.
"""

from __future__ import annotations

import numpy as np


def _kth(x: np.ndarray, k: int) -> np.ndarray:
    return np.sort(x, axis=1)[:, ::-1][:, k - 1]


def admit_case(rng: np.random.Generator, G: int, P: int, S: int,
               L: int) -> dict:
    """Inputs of phase 1 for G groups × P lanes, S submit slots, ring L."""
    quorum = P // 2 + 1
    applied = rng.integers(0, 4 * L, (G, P)).astype(np.int32)
    dup = rng.random(G) < 0.2
    applied[dup] = applied[dup, :1]
    lead = rng.integers(-1, P, G).astype(np.int32)
    accept_ok = (lead >= 0) & (rng.random(G) < 0.9)
    valid = rng.random((G, S)) < 0.7
    # edge rows: leaderless; all refused; equal lanes with room for all
    lead[:3], accept_ok[:3], valid[:3] = (-1, 0, P - 1), (0, 1, 1), True
    applied[2] = applied[2, 0]
    # l_last from the backpressure floor up to past it, so admission is cut
    # anywhere in the window, or refuses every submit
    floor = np.minimum(applied[np.arange(G), np.maximum(lead, 0)],
                       _kth(applied, quorum))
    l_last = (floor + rng.integers(0, L + 3, G)).astype(np.int32)
    l_last[1], l_last[2] = floor[1] + L, floor[2]
    return dict(applied=applied, lead=lead, accept_ok=accept_ok, valid=valid,
                l_last=l_last)


def ack_case(rng: np.random.Generator, G: int, P: int, L: int,
             E: int = 16) -> dict:
    """Inputs of phase 3 for G groups × P lanes and a ring of L slots, with
    an append window of E entries."""
    gp = (G, P)
    l_last = rng.integers(0, 4 * L, G).astype(np.int32)
    lead = rng.integers(-1, P, G).astype(np.int32)
    active = lead >= 0
    l_term = rng.integers(1, 5, G).astype(np.int32)
    # matchIndex from a few values per group (duplicates), some of them
    # below the live window or 0
    choices = np.stack([np.zeros(G), l_last - L - rng.integers(0, 3, G),
                        l_last - rng.integers(0, L, G), l_last], axis=1)
    l_match = np.maximum(choices[np.arange(G)[:, None],
                                 rng.integers(0, 4, gp)], 0).astype(np.int32)
    prev = np.minimum(l_match + rng.integers(-2, 3, gp), l_last[:, None])
    prev = np.maximum(prev, 0).astype(np.int32)
    upto = np.minimum(prev + E, l_last[:, None]).astype(np.int32)
    l_next = (prev + 1).astype(np.int32)
    last_index = np.maximum(prev + rng.integers(-3, 4, gp), 0
                            ).astype(np.int32)
    term1 = (l_term[:, None] + rng.choice([-1, 0, 0, 0, 0, 1], gp)
             ).astype(np.int32)
    flags = {n: rng.random(gp) < p for n, p in (
        ("recv", 0.8), ("reject_term", 0.1), ("del_back", 0.85),
        ("match", 0.75), ("entries_sent", 0.6), ("ok_term", 0.85))}
    l_commit = np.minimum(l_last, rng.integers(0, 4 * L, G)).astype(np.int32)
    # the ring holds mostly the leader's term, so candidates commit
    l_log_term = (l_term[:, None] - (rng.random((G, L)) < 0.2)
                  ).astype(np.int32)

    # edge rows
    lead[0], active[0] = -1, False                        # leaderless
    lead[1], active[1], l_last[1], l_commit[1] = 0, True, 5, 0
    l_match[1], prev[1], upto[1] = 0, 0, 0                # candidate 0
    for f in ("match", "entries_sent"):
        flags[f][1] = False
    lead[2], active[2], l_last[2], l_commit[2] = 1 % P, True, 3 * L, 0
    l_match[2] = L // 2                                   # below the window
    prev[2], upto[2] = L // 2, L // 2
    flags["match"][2] = False
    lead[3], active[3] = 0, True                          # stale leader
    flags["recv"][3], flags["del_back"][3] = True, True
    term1[3] = l_term[3] + 2
    lead[4], active[4], l_last[4], l_commit[4] = 0, True, 2 * L, L
    l_match[4] = 2 * L - 3                                # duplicates
    prev[4], upto[4] = 2 * L - 3, 2 * L - 3
    term1[4] = l_term[4]
    flags["match"][4], flags["del_back"][4] = True, True
    l_log_term[4] = l_term[4]
    return dict(**flags, upto=upto, prev=prev, term1=term1,
                last_index=last_index, l_match=l_match, l_next=l_next,
                lead=lead, active=active, l_term=l_term, l_last=l_last,
                l_commit=l_commit, l_log_term=l_log_term)


def member_views(rng: np.random.Generator, lead: np.ndarray,
                 P: int) -> np.ndarray:
    """Active-config bitmasks ``[G, P]`` int32 over P lanes for the groups
    led by ``lead`` (-1: lane 0 is read)."""
    G = lead.shape[0]
    full = (1 << P) - 1
    views = rng.integers(1, full + 1, (G, P)).astype(np.int32)
    ld = np.maximum(lead, 0)
    rows = np.arange(G)
    outside = rng.random(G) < 0.2
    word = views[rows, ld]
    word = np.where(outside, word & ~(1 << ld), word)
    word = np.where(word == 0, 1 << ((ld + 1) % P), word)   # never empty
    word[0] = 1 << ((ld[0] + 1) % P) if P > 1 else 1        # one member
    word[1] = full                                          # every lane
    word[2] = full & ~(1 << ld[2]) if P > 1 else full       # not the leader
    views[rows, ld] = word
    return views
