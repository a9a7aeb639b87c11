"""Batched Raft consensus: one synchronous round over every group (torch).

Counterpart of ``copycat_tpu/ops/consensus.py``. State is
``[num_groups, num_peers]`` tensors, log rings are ``[G, P, L]``, and one
:func:`step` call advances every group by one round in six phases:

1. inject client submits into the leader log (backpressure, lease gate);
2. AppendEntries leader → followers (log matching, cyclic window copy);
3. acks → matchIndex, quorum commit advance, leader lease;
4. election timers and the RequestVote tally;
5. apply committed entries through the resource kernels (``ops/apply``);
6. drain session events from the leader lane.

Differences from the reference, none of which changes a value:

- The election-timer draws are inputs: ``step`` takes the two ``[G, P]``
  int32 draws ``(fresh, cand)`` and ``init_state`` the initial timers, so
  a caller owns its ``torch.Generator`` and a test can feed the
  reference's draws.
- Phase 1's backpressure tally and admission, and phase 3 from the acks
  to the commit advance, are each one call (``ops/kernels.admit_submits``
  and ``ops/kernels.ack_commit``): the device of the state chooses a
  fused CUDA kernel on a card and its plain version, the reference's
  lines in torch, on the CPU.
- Per-row selects use indexing and ``torch.gather`` where the reference
  used one-hot select-reduces (its gathers were slow on the TPU); the
  selected values are the same.
- ``step`` never synchronises with the host: it branches only on the
  static config and on shapes.

One difference changes values, and only where the reference's own state
goes wrong: ``Config.ring_flow_control`` (on by default) never lets a
lane's ring overwrite an entry it has not applied, and keeps every lane's
unapplied entries at most L - 1 (``last - applied < L`` after every
round). A follower takes from AppendEntries only up to its applied index
+ L - 1; a leader admits submits only up to its backpressure floor
+ L - 2, which keeps a slot free for the NoOp of the next election; a
winner with that slot free appends its NoOp, and a winner whose last
entry is an uncommitted NoOp (the one slot is spent) re-stamps that NoOp
with its own term in place of a new one. A lane stands for election only
when it can do one of the two. So the most up-to-date lanes can always
stand, and the winner's NoOp always fits in its followers' rings: no
group is left unable to elect or to commit (ROADMAP, Queue 3). Re-stamping
changes an entry's term and nothing else: any copy of it that commits is
the same NoOp. The reference
copies up to ``prev + append_window`` whatever the follower has applied,
so a follower whose apply lags its log by L or more (after a partition
heals, or when a new leader sends from its own last index) overwrites
committed entries in its ring before applying them and then applies the
newer entries in their place — replicas at the same applied index then
disagree. With the flag off, ``step`` is the reference's step bit for
bit; ``convert.config_to_torch`` turns it off, so the differential tests
hold that path to the reference.

Every resource pool runs, and ``Config.pool_budgets`` selects the
conflict-partitioned apply (``ops/apply.apply_window``).
``Config.dynamic_membership`` runs the reference's per-group voter sets
(server join and leave through ``OP_CFG_ADD``/``OP_CFG_REMOVE`` entries):
each lane's active view is the latest config entry in its ring, the two
fused phases tally the leader's members against their quorum inside the
kernel, and config changes are serialized at append. :func:`query_step`
serves read-only ops from the leader's applied state without a log
append. ``Config.monotone_tag_accept`` is the bulk plane's dense
per-group tag gate, eager torch ahead of ``admit_submits``;
``Config.telemetry`` adds a :class:`DeviceTelemetry` block of per-group
reductions to the outputs (off, the step is unchanged, launch for
launch). :func:`deep_step` and :func:`deep_scan` accumulate one drive's
results on the device for ``models/bulk.py``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .apply import (
    NUM_POOLS,
    OP_CFG_ADD,
    OP_CFG_REMOVE,
    ResourceConfig,
    ResourceState,
    apply_entry,
    apply_window,
    drain_events,
    init_resources,
    pool_of,
)
from .kernels import (
    ack_commit,
    admit_submits,
    member_lanes,
    popcount,
    term_at_2d,
)

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2


class DeviceTelemetry(NamedTuple):
    """Per-group telemetry deltas of ONE round (``Config.telemetry``).

    Every leaf is ``[G]`` int32 (``applies`` is ``[G, NUM_POOLS+1]``):
    reductions over the peer and slot axes only, so the host sums over G.
    Derived from values the step already computes — no draws, no state
    writes."""

    elections_started: torch.Tensor  # lanes whose timer fired this round
    leader_changes: torch.Tensor     # elections won by a lane other than
    #                                  the round-start leader (or leaderless)
    term_bumps: torch.Tensor         # delta of the group-max term
    leaderless: torch.Tensor         # 1 iff no leader at round start
    commit_advance: torch.Tensor     # delta of the group-max commit index
    commit_max: torch.Tensor         # post-round max commit index
    term_max: torch.Tensor           # post-round max term over lanes
    leader_lane: torch.Tensor        # post-round leader lane (-1 none)
    leader_term: torch.Tensor        # its term (-1 none)
    applies: torch.Tensor            # [G, NUM_POOLS+1] entries applied by
    #                                  the reporting lane, by pool (last
    #                                  column: NoOp and config entries)
    ring_occ_max: torch.Tensor       # max over lanes of last - applied
    submit_rejections: torch.Tensor  # valid slots rejected (requeued)
    vote_splits: torch.Tensor        # 1 iff candidates existed, none won
    events_drained: torch.Tensor     # leader-lane outbox events popped
    events_dropped: torch.Tensor     # outbox drop-oldest overwrites


class RaftState(NamedTuple):
    """Device-resident replicated state for G groups × P peers."""

    term: torch.Tensor          # [G,P] i32
    voted_for: torch.Tensor     # [G,P] i32, -1 = none
    role: torch.Tensor          # [G,P] i32 ∈ {FOLLOWER, CANDIDATE, LEADER}
    leader_hint: torch.Tensor   # [G,P] i32 peer index, -1 = unknown
    timer: torch.Tensor         # [G,P] i32 rounds until election timeout
    clock: torch.Tensor         # [G,P] i32 logical round clock (replicated)
    last_index: torch.Tensor    # [G,P] i32
    commit_index: torch.Tensor  # [G,P] i32
    applied_index: torch.Tensor  # [G,P] i32
    next_index: torch.Tensor    # [G,P,P] i32 (axis1 = owner-as-leader, axis2 = target)
    match_index: torch.Tensor   # [G,P,P] i32
    log_term: torch.Tensor      # [G,P,L] i32 ring
    log_op: torch.Tensor        # [G,P,L] i32 opcode
    log_a: torch.Tensor         # [G,P,L] i32 arg
    log_b: torch.Tensor         # [G,P,L] i32 arg
    log_c: torch.Tensor         # [G,P,L] i32 arg
    log_time: torch.Tensor      # [G,P,L] i32 logical timestamp at append
    log_tag: torch.Tensor       # [G,P,L] i32 host correlation tag
    resources: ResourceState
    lease: torch.Tensor         # [G,P] bool — leader quorum-acked last round
    member: torch.Tensor        # [G,P] i32 voter bitmask (static path: all ones)


class Submits(NamedTuple):
    """Client ops to inject this round, S slots per group. ``valid`` is a
    full ``[G,S]`` bool tensor; the other leaves may be compact: a scalar
    (the same value in every slot) or, for ``tag``, a ``[G,1]`` column
    meaning "this base tag at slot 0, consecutive at later slots"."""

    opcode: Any  # [G,S] i32
    a: Any       # [G,S] i32
    b: Any       # [G,S] i32
    c: Any       # [G,S] i32
    tag: Any     # [G,S] i32
    valid: torch.Tensor   # [G,S] bool


class StepOutputs(NamedTuple):
    accepted: torch.Tensor    # [G,S] bool — submit made it into the leader log
    out_valid: torch.Tensor   # [G,A] bool — a command applied this round
    out_tag: torch.Tensor     # [G,A] i32
    out_result: torch.Tensor  # [G,A] i32
    out_latency: torch.Tensor  # [G,A] i32 rounds from log append to apply
    leader: torch.Tensor      # [G] i32 leader peer at round start (-1 none)
    commit_index: torch.Tensor  # [G] i32 leader commit after the round
    stale: torch.Tensor       # [G,P] bool — lagging beyond ring window
    clock: torch.Tensor       # [G] i32 post-step logical clock
    ev_seq: torch.Tensor      # [G,D] i32
    ev_code: torch.Tensor     # [G,D] i32
    ev_target: torch.Tensor   # [G,D] i32
    ev_arg: torch.Tensor      # [G,D] i32
    ev_valid: torch.Tensor    # [G,D] bool
    assigned: torch.Tensor       # [G,S] i32 (0 where not accepted)
    assigned_term: torch.Tensor  # [G,S] i32
    out_index: torch.Tensor      # [G,A] i32 (0 where not out_valid)
    out_term: torch.Tensor       # [G,A] i32
    leader_term: torch.Tensor    # [G] i32 post-round leader term (-1 none)
    refused: torch.Tensor        # [G,S] bool
    telemetry: Any = None


class Config(NamedTuple):
    """Static step configuration; fields and defaults as the reference's,
    without ``use_pallas`` (the state's device picks the tally), plus
    ``ring_flow_control`` (see the module docstring)."""

    append_window: int = 4    # entries per AppendEntries per round
    applies_per_round: int = 4
    pool_budgets: tuple | None = None
    timer_min: int = 4        # election timeout in rounds (randomized range)
    timer_max: int = 9
    events_per_round: int = 4  # outbox events drained per step
    resource: ResourceConfig = ResourceConfig()
    dynamic_membership: bool = False
    lease_gated_accept: bool = True
    monotone_tag_accept: bool = False
    telemetry: bool = False
    ring_flow_control: bool = True


def draw_timers(num_groups: int, num_peers: int, config: Config,
                generator: torch.Generator) -> torch.Tensor:
    """One ``[G, P]`` int32 draw of election timeouts in
    ``[timer_min, timer_max)`` on the generator's device."""
    return torch.randint(config.timer_min, config.timer_max,
                         (num_groups, num_peers), generator=generator,
                         dtype=torch.int32, device=generator.device)


def init_state(num_groups: int, num_peers: int, log_slots: int,
               timer: torch.Tensor, config: Config = Config(),
               members=None) -> RaftState:
    """Fresh state for G groups on ``timer``'s device; ``timer`` is the
    ``[G, P]`` int32 initial election timeout of every lane. ``members``
    (optional, for ``config.dynamic_membership``): the initial voter set
    as a ``[P]`` or ``[G, P]`` bool mask, the same view in every lane;
    lanes outside it are standbys until an ``OP_CFG_ADD`` brings them
    in."""
    G, P, L = num_groups, num_peers, log_slots
    if tuple(timer.shape) != (G, P) or timer.dtype != torch.int32:
        raise ValueError(f"timer must be [G, P] int32, got "
                         f"{tuple(timer.shape)} {timer.dtype}")
    dev = timer.device
    i32 = dict(dtype=torch.int32, device=dev)

    def z2():
        return torch.zeros((G, P), **i32)

    def zl():
        return torch.zeros((G, P, L), **i32)

    if members is None:
        # every lane, as the int32 word the reference stores: from 32 lanes
        # on all 32 bits (-1), the low 32 bits of 2**P - 1
        full = ((1 << P) - 1) & 0xFFFFFFFF
        member = torch.full((G, P), full - (full >> 31 << 32), **i32)
    else:
        m = torch.as_tensor(members, dtype=torch.bool, device=dev)
        bits = (m.expand(G, P).to(torch.int32)
                << torch.arange(P, **i32)).sum(dim=1, dtype=torch.int32)
        member = bits[:, None].expand(G, P).contiguous()

    return RaftState(
        term=z2(), voted_for=z2() - 1, role=z2() + FOLLOWER,
        leader_hint=z2() - 1, timer=timer.clone(), clock=z2(),
        last_index=z2(), commit_index=z2(), applied_index=z2(),
        next_index=torch.ones((G, P, P), **i32),
        match_index=torch.zeros((G, P, P), **i32),
        log_term=zl(), log_op=zl(), log_a=zl(), log_b=zl(), log_c=zl(),
        log_time=zl(), log_tag=zl(),
        resources=init_resources(G, P, config.resource, device=dev),
        lease=torch.zeros((G, P), dtype=torch.bool, device=dev),
        member=member,
    )


def make_submits(num_groups: int, submit_slots: int,
                 device: torch.device | str) -> Submits:
    G, S = num_groups, submit_slots
    z = torch.zeros((G, S), dtype=torch.int32, device=device)
    return Submits(opcode=z, a=z, b=z, c=z, tag=z,
                   valid=torch.zeros((G, S), dtype=torch.bool, device=device))


def full_delivery(num_groups: int, num_peers: int,
                  device: torch.device | str) -> torch.Tensor:
    return torch.ones((num_groups, num_peers, num_peers), dtype=torch.bool,
                      device=device)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _peer_view(x: torch.Tensor, lead: torch.Tensor) -> torch.Tensor:
    """Select x[g, lead[g], ...] → [G, ...]; ``lead`` is clipped at 0, so a
    leaderless group (-1) reads lane 0 and the caller masks it."""
    g_ids = torch.arange(x.shape[0], device=x.device)
    return x[g_ids, lead.clamp(min=0).long()]


def _term_at_own(log_term: torch.Tensor, last: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Term lookup on each replica's own [G,P,L] ring at idx [G,P]."""
    L = log_term.shape[-1]
    t = torch.gather(log_term, 2, ((idx - 1) % L).long()[..., None])[..., 0]
    valid = (idx >= 1) & (idx <= last) & (idx > last - L)
    return torch.where(valid, t, 0)


def _scatter_lane(x: torch.Tensor, lead: torch.Tensor, active: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """Write new[G,...] into x[G,P,...] at lane (g, lead[g]) where active."""
    P = x.shape[1]
    ids = torch.arange(P, device=x.device)
    lane = (ids[None, :] == lead[:, None]) & active[:, None]
    lane = lane.reshape(lane.shape + (1,) * (x.dim() - 2))
    return torch.where(lane, new.unsqueeze(1), x)


def _slot_write(log: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
    """Masked scatter value[G,P] into log[G,P,L] at slot[G,P]."""
    L = log.shape[-1]
    ids = torch.arange(L, device=log.device)
    hit = (ids[None, None, :] == slot[..., None]) & mask[..., None]
    return torch.where(hit, value[..., None], log)


def install_snapshots(state: RaftState, stale: torch.Tensor,
                      leader: torch.Tensor,
                      config: Config = Config()) -> RaftState:
    """Catch up followers flagged ``stale`` by copying the leader's lane:
    its log ring, indices and resource state, then re-follow the leader
    with a fresh full timeout. Vectorized over all flagged ``[G, P]``
    lanes; no host synchronisation."""
    has = stale & (leader >= 0)[:, None]

    def cp(x: torch.Tensor) -> torch.Tensor:
        lv = _peer_view(x, leader)
        mask = has.reshape(has.shape + (1,) * (x.dim() - 2))
        return torch.where(mask, lv.unsqueeze(1), x)

    lead_col = leader[:, None].expand_as(state.voted_for)
    return state._replace(
        term=cp(state.term),
        voted_for=torch.where(has, lead_col, state.voted_for),
        role=torch.where(has, FOLLOWER, state.role),
        leader_hint=torch.where(has, lead_col, state.leader_hint),
        timer=torch.where(has, config.timer_max, state.timer),
        last_index=cp(state.last_index), commit_index=cp(state.commit_index),
        applied_index=cp(state.applied_index),
        log_term=cp(state.log_term), log_op=cp(state.log_op),
        log_a=cp(state.log_a), log_b=cp(state.log_b), log_c=cp(state.log_c),
        log_time=cp(state.log_time), log_tag=cp(state.log_tag),
        resources=ResourceState(*(cp(x) for x in state.resources)),
        member=cp(state.member),
    )


def current_leader(state: RaftState) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group leader lane and whether one exists: ``(lead [G], active
    [G])``. The highest-term LEADER lane wins, the first on a tie."""
    lead_term = torch.where(state.role == LEADER, state.term, -1)
    lead = torch.argmax(lead_term, dim=1).to(torch.int32)
    active = lead_term.amax(dim=1) >= 0
    return torch.where(active, lead, -1), active


def query_step(state: RaftState, queries: Submits,
               atomic: torch.Tensor | None = None, config: Config = Config()
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Serve read-only ops from the leader's applied state — no log
    append, no state written back.

    A slot is served only where the group has a current leader that has
    applied everything it committed and has committed an entry of its own
    term (a fresh leader's commit index can trail what its predecessor
    served, Raft §8), so reads are sequential: leader-local and monotone
    per group. ``atomic [G,S]`` bool (optional) marks slots that need the
    leader lease as well (bounded-linearizable reads). The pools are the
    leader lane's, broadcast over the S slots as views; the apply kernels
    write nothing in place, and the state they return is dropped.

    Returns ``(results [G,S], served [G,S] bool)``; an unserved slot is
    the caller's to retry or to send through the log.
    """
    G = state.term.shape[0]
    dev = state.term.device
    queries = _normalize_submits(queries, G, dev)
    S = queries.valid.shape[1]
    lead, active = current_leader(state)
    l_applied = _peer_view(state.applied_index, lead)
    l_commit = _peer_view(state.commit_index, lead)
    l_term = _peer_view(state.term, lead)
    l_last = _peer_view(state.last_index, lead)
    l_log_term = _peer_view(state.log_term, lead)
    commit_term = term_at_2d(l_log_term, l_last, l_commit[:, None])[:, 0]
    current = active & (l_applied >= l_commit) & (commit_term == l_term)
    served = queries.valid & current[:, None]
    if atomic is not None:
        leased = state.lease.any(dim=1)
        atomic = torch.as_tensor(atomic, dtype=torch.bool, device=dev)
        served = served & (~atomic | leased[:, None])

    def slots(x: torch.Tensor) -> torch.Tensor:
        lx = _peer_view(x, lead)
        return lx[:, None].expand((G, S) + tuple(lx.shape[1:]))

    lres = ResourceState(*(slots(x) for x in state.resources))
    _, results = apply_entry(
        lres, queries.opcode, queries.a, queries.b, queries.c,
        torch.zeros_like(queries.opcode), slots(state.clock), served)
    return torch.where(served, results, 0), served


def _normalize_submits(submits: Submits, G: int, dev: torch.device
                       ) -> Submits:
    """Expand compact submit leaves to full ``[G, S]`` int32 tensors; the
    ``valid`` mask comes out contiguous, as the admission kernel takes it."""
    S = submits.valid.shape[-1]

    def norm(x):
        x = torch.as_tensor(x, dtype=torch.int32, device=dev)
        return x if tuple(x.shape) == (G, S) else x.expand(G, S)

    tag = torch.as_tensor(submits.tag, dtype=torch.int32, device=dev)
    if tag.dim() == 2 and tuple(tag.shape) == (G, 1) and S != 1:
        tag = tag + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    else:
        tag = norm(tag)
    return Submits(opcode=norm(submits.opcode), a=norm(submits.a),
                   b=norm(submits.b), c=norm(submits.c), tag=tag,
                   valid=torch.as_tensor(submits.valid, dtype=torch.bool,
                                         device=dev).contiguous())


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def step(state: RaftState, submits: Submits, deliver: torch.Tensor,
         fresh: torch.Tensor, cand: torch.Tensor,
         config: Config = Config()) -> tuple[RaftState, StepOutputs]:
    """Advance every group by one synchronous consensus round.

    ``deliver [G,P,P]`` bool masks every exchange (``deliver[g, from,
    to]``). ``fresh`` and ``cand`` are ``[G,P]`` int32 election-timeout
    draws: ``fresh`` re-arms a heartbeat lane's or renewed leader's timer,
    ``cand`` a lane that starts a campaign.
    """
    G, P = state.term.shape
    L = state.log_term.shape[-1]
    E = config.append_window
    A = config.applies_per_round
    quorum = P // 2 + 1
    dev = state.term.device
    i32 = torch.int32
    peer_ids = torch.arange(P, dtype=i32, device=dev)
    g_ids = torch.arange(G, device=dev)

    submits = _normalize_submits(submits, G, dev)

    # Replicated logical clock: +1 per step in every lane.
    clock1 = state.clock + 1

    # Self-delivery is always on (a node talks to itself).
    deliver = deliver | torch.eye(P, dtype=torch.bool, device=dev)[None]

    lead, active = current_leader(state)

    # Dynamic membership views (the static path never reads state.member).
    dyn = config.dynamic_membership
    view = None
    if dyn:
        # Each lane's active config is the latest config entry in its log
        # (adopted at append, reverted by truncation, Raft §4.1), else the
        # applied-prefix mask. Entries in (applied, last] sit at ring slot
        # (idx - 1) % L, so slot s holds index applied + 1 + ((s - applied)
        # % L) inside that window.
        s_m = torch.arange(L, dtype=i32, device=dev)[None, None, :]
        off_m = (s_m - state.applied_index[..., None]) % L
        win_m = off_m < (state.last_index - state.applied_index)[..., None]
        cfg_m = win_m & ((state.log_op == OP_CFG_ADD)
                         | (state.log_op == OP_CFG_REMOVE))      # [G,P,L]
        key_m = torch.where(cfg_m,
                            state.applied_index[..., None] + 1 + off_m, 0)
        best_m = key_m.amax(dim=-1)                              # [G,P]
        latest_mask = torch.where(cfg_m & (key_m == best_m[..., None]),
                                  state.log_a, 0).sum(dim=-1, dtype=i32)
        view = torch.where(best_m > 0, latest_mask, state.member)  # [G,P]
        self_member = ((view >> peer_ids) & 1).bool()           # [G,P]
        view_quorum = popcount(view) // 2 + 1                    # [G,P]
        cfg_inflight = _peer_view(best_m > 0, lead)              # [G]
        l_view = _peer_view(view, lead)                          # [G]
        # which lanes the leader's active config counts
        l_member = member_lanes(l_view, P)                       # [G,P]

    l_term = _peer_view(state.term, lead)          # [G]
    l_last = _peer_view(state.last_index, lead)    # [G]
    l_commit = _peer_view(state.commit_index, lead)
    l_next = _peer_view(state.next_index, lead)    # [G,P]
    l_match = _peer_view(state.match_index, lead)  # [G,P]
    l_log_term = _peer_view(state.log_term, lead)  # [G,L]
    l_log_op = _peer_view(state.log_op, lead)
    l_log_a = _peer_view(state.log_a, lead)
    l_log_b = _peer_view(state.log_b, lead)
    l_log_c = _peer_view(state.log_c, lead)
    l_log_time = _peer_view(state.log_time, lead)
    l_log_tag = _peer_view(state.log_tag, lead)
    l_clock = clock1.amax(dim=1)                   # [G] (identical per lane)

    # ---- phase 1: inject client submits into the leader log ----
    # Backpressure: never let the ring overwrite entries the leader itself
    # or a quorum-th replica still has to apply.
    # Under dynamic membership the tally counts only the leader's members
    # (``view``): non-member lanes never receive entries, so an unmasked
    # tally would wedge backpressure and commit at their floor.
    accept_ok = active
    if config.lease_gated_accept:
        # last round's quorum-ack witness at the leader lane
        accept_ok = active & _peer_view(state.lease, lead)
    valid = submits.valid
    if dyn:
        # Config-change append guard: ONE change in flight per group (two
        # adjacent single-server configs always quorum-intersect; two
        # concurrent ones need not, Raft §4.2), so a config submit is
        # rejected (the host requeues it) while a config entry sits
        # unapplied in the leader's log or another rides earlier in the
        # window, and removing the last member is refused for good. The
        # entry's ``a`` carries the FULL new mask, composed from the
        # leader's view, so any lane adopts a config from one entry.
        valid = valid & accept_ok[:, None]
        is_cfg = (submits.opcode == OP_CFG_ADD) \
            | (submits.opcode == OP_CFG_REMOVE)
        in_range = (submits.a >= 0) & (submits.a < P)
        bit = torch.where(in_range, 1 << submits.a.clamp(0, P - 1), 0)
        new_mask = torch.where(submits.opcode == OP_CFG_ADD,
                               l_view[:, None] | bit,
                               l_view[:, None] & ~bit)             # [G,S]
        first_cfg = (torch.cumsum(is_cfg & valid, dim=1, dtype=i32) == 1) \
            & is_cfg
        may = first_cfg & ~cfg_inflight[:, None]
        refused = is_cfg & valid & may & (new_mask == 0)
        cfg_rejected = is_cfg & valid & ~(may & (new_mask != 0))
        # reject the window's suffix from a rejected config submit, so
        # rejections stay hole-free and per-group FIFO holds
        valid = (valid & (torch.cumsum(cfg_rejected, dim=1, dtype=i32) == 0)
                 ).contiguous()
    if config.monotone_tag_accept:
        # Dense per-group tag gate: a slot is accepted only when its tag
        # is the leader log's max live-ring tag + 1 + its rank among the
        # window's valid slots, so duplicates and gaps are rejected. The
        # rank counts only slots the lease lets through (the reference
        # ANDs accept_ok into valid first). Slot j holds the unique index
        # in (last - L, last] with (idx - 1) % L == j; election NoOps
        # carry tag 0.
        if not dyn:
            valid = valid & accept_ok[:, None]
        j_ids = torch.arange(L, dtype=i32, device=dev)[None, :]
        idx_at = l_last[:, None] - ((l_last[:, None] - (j_ids + 1)) % L)
        in_log = (idx_at >= 1) & (idx_at <= l_last[:, None])
        last_stream = torch.where(in_log, l_log_tag, 0).amax(dim=1)
        vi = valid.to(i32)
        rank = torch.cumsum(vi, dim=1, dtype=i32) - vi
        gate_ok = submits.tag == last_stream[:, None] + 1 + rank
        # suffix-reject from the first gate failure: acceptance stays a
        # hole-free prefix
        gate_fail = valid & ~gate_ok
        valid = (valid & gate_ok
                 & (torch.cumsum(gate_fail, dim=1, dtype=i32) == 0)
                 ).contiguous()
    applied = state.applied_index.contiguous()
    if config.ring_flow_control:
        # the floor counts from applied - 2: client entries fill at most
        # L - 2 slots past it, and one is left for an election's NoOp
        admission = admit_submits(applied - 2, lead, accept_ok, valid,
                                  l_last, quorum, L, view)
    else:
        admission = admit_submits(applied, lead, accept_ok, valid, l_last,
                                  quorum, L, view)
    accepted = admission.accepted
    # Accepted slots land at distinct ring slots, so one scatter per log
    # array writes them all; rejected slots go to a spill column (slot L)
    # that is cut off.
    slot_s = admission.slot                                   # [G,S] i64

    def _inject(log: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        ext = torch.cat([log, log[:, :1]], dim=1)
        return ext.scatter(1, slot_s, vals.expand_as(slot_s))[:, :L]

    l_log_term = _inject(l_log_term, l_term[:, None])
    l_log_op = _inject(l_log_op, submits.opcode)
    l_log_a = _inject(l_log_a, torch.where(is_cfg, new_mask, submits.a)
                      if dyn else submits.a)
    l_log_b = _inject(l_log_b, submits.b)
    l_log_c = _inject(l_log_c, submits.c)
    l_log_time = _inject(l_log_time, l_clock[:, None])
    l_log_tag = _inject(l_log_tag, submits.tag)
    l_last = admission.l_last

    # ---- phase 2: AppendEntries leader → followers ----
    del_fwd = _peer_view(deliver, lead)                      # deliver[g,lead,f]
    del_back = _peer_view(deliver.transpose(1, 2), lead)     # deliver[g,f,lead]
    recv = active[:, None] & (peer_ids[None, :] != lead[:, None]) & del_fwd
    if dyn:
        # leaders replicate only to members of their current config; a
        # re-added lane catches up by rewind or a snapshot install
        recv = recv & l_member

    prev = l_next - 1                                        # [G,P]
    # The leader can only serve entries still in its ring.
    can_serve = prev > l_last[:, None] - L
    stale = recv & ~can_serve
    recv = recv & can_serve
    prev_term = term_at_2d(l_log_term, l_last, prev)
    upto = torch.minimum(prev + E, l_last[:, None])
    if config.ring_flow_control:
        # a follower takes entries only up to its applied index + L - 1,
        # so its ring never overwrites an entry it has not applied yet
        upto = torch.minimum(upto, state.applied_index + (L - 1))

    msg_term = l_term[:, None]
    ok_term = recv & (msg_term >= state.term)
    reject_term = recv & (msg_term < state.term)

    term1 = torch.where(ok_term, msg_term, state.term)
    voted1 = torch.where(ok_term & (msg_term > state.term), -1,
                         state.voted_for)
    role1 = torch.where(ok_term, FOLLOWER, state.role)
    hint1 = torch.where(ok_term, lead[:, None], state.leader_hint)
    heartbeat = ok_term

    f_prev_term = _term_at_own(state.log_term, state.last_index, prev)
    in_window = prev > state.last_index - L
    match = ok_term & (
        (prev == 0)
        | (prev <= state.commit_index)  # committed prefix always matches
        | ((prev <= state.last_index) & in_window
           & (f_prev_term == prev_term)))

    # Entry copy as one masked cyclic-window select per log array: the same
    # absolute index lives in the same ring slot on every replica.
    count = torch.where(match, (upto - prev).clamp(0, E), 0)  # [G,P]
    s_ids = torch.arange(L, dtype=i32, device=dev)[None, None, :]
    win = ((s_ids - prev[..., None]) % L) < count[..., None]   # [G,P,L]

    def _win_copy(follower: torch.Tensor, leader_view: torch.Tensor
                  ) -> torch.Tensor:
        return torch.where(win, leader_view[:, None, :], follower)

    log_term2 = _win_copy(state.log_term, l_log_term)
    log_op2 = _win_copy(state.log_op, l_log_op)
    log_a2 = _win_copy(state.log_a, l_log_a)
    log_b2 = _win_copy(state.log_b, l_log_b)
    log_c2 = _win_copy(state.log_c, l_log_c)
    log_time2 = _win_copy(state.log_time, l_log_time)
    log_tag2 = _win_copy(state.log_tag, l_log_tag)

    entries_sent = match & (upto >= prev + 1)
    last2 = torch.where(entries_sent, upto, state.last_index)
    # Commit advance only after the consistency check passed, capped at
    # the last verified entry (Raft §5.3).
    verified = torch.where(entries_sent, upto, prev)
    commit2 = torch.where(
        match,
        torch.maximum(state.commit_index,
                      torch.minimum(l_commit[:, None], verified)),
        state.commit_index)

    # ---- phase 3: acks → matchIndex/nextIndex, quorum commit advance ----
    l_match, l_next, leader_stale, lease_g, max_ack_term, l_commit = \
        ack_commit(recv=recv, reject_term=reject_term, del_back=del_back,
                   match=match, entries_sent=entries_sent, ok_term=ok_term,
                   upto=upto, prev=prev, term1=term1,
                   last_index=state.last_index.contiguous(),
                   l_match=l_match, l_next=l_next, lead=lead, active=active,
                   l_term=l_term, l_last=l_last, l_commit=l_commit,
                   l_log_term=l_log_term, quorum=quorum, view=view)
    self_lane = peer_ids[None, :] == lead[:, None]

    # Scatter the leader view back into replica lanes.
    sc = ~leader_stale & active
    down = self_lane & leader_stale[:, None]
    term1 = torch.where(
        down, torch.maximum(l_term, max_ack_term)[:, None], term1)
    role1 = torch.where(down, FOLLOWER, role1)
    voted1 = torch.where(down, -1, voted1)
    last2 = _scatter_lane(last2, lead, active, l_last)
    commit2 = _scatter_lane(commit2, lead, sc, l_commit)
    next2 = _scatter_lane(state.next_index, lead, sc, l_next)
    match2 = _scatter_lane(state.match_index, lead, sc, l_match)
    log_term2 = _scatter_lane(log_term2, lead, active, l_log_term)
    log_op2 = _scatter_lane(log_op2, lead, active, l_log_op)
    log_a2 = _scatter_lane(log_a2, lead, active, l_log_a)
    log_b2 = _scatter_lane(log_b2, lead, active, l_log_b)
    log_c2 = _scatter_lane(log_c2, lead, active, l_log_c)
    log_time2 = _scatter_lane(log_time2, lead, active, l_log_time)
    log_tag2 = _scatter_lane(log_tag2, lead, active, l_log_tag)

    # ---- phase 4: election timers + RequestVote tally ----
    is_ldr = role1 == LEADER
    # CheckQuorum: a leader's timer is renewed only by an ack quorum.
    renewed = self_lane & lease_g[:, None]
    timer1 = torch.where(heartbeat | (is_ldr & renewed), fresh,
                         state.timer - 1)
    ldr_down = is_ldr & (timer1 <= 0)
    role1 = torch.where(ldr_down, FOLLOWER, role1)
    is_ldr = is_ldr & ~ldr_down
    timer1 = torch.where(ldr_down, fresh, timer1)
    timeout = ~is_ldr & ~heartbeat & ~ldr_down & (timer1 <= 0)
    if config.ring_flow_control:
        # a lane stands for election only if, winning, it can put a NoOp of
        # its term at most L - 1 past its applied index: in a free slot, or
        # over its own last entry when that is an uncommitted NoOp
        unapplied = last2 - state.applied_index
        tail = ((last2 - 1) % L).long()[..., None]
        tail_noop = (last2 > commit2) \
            & (torch.gather(log_op2, 2, tail)[..., 0] == 0) \
            & (torch.gather(log_tag2, 2, tail)[..., 0] == 0)
        fresh_slot = unapplied < L - 1
        room = fresh_slot | (tail_noop & (unapplied < L))
        timeout = timeout & room
    if dyn:
        # lanes outside their own view never campaign: a removed server
        # must not disrupt the group it left, nor a standby elect itself
        timeout = timeout & self_member

    term_e = torch.where(timeout, term1 + 1, term1)
    voted_e = torch.where(timeout, peer_ids[None, :], voted1)
    role_e = torch.where(timeout, CANDIDATE, role1)
    timer1 = torch.where(timeout, cand, timer1)

    cand_mask = role_e == CANDIDATE
    # A vote needs request AND response delivery; lanes that heard a
    # current leader this round, or are it, ignore RequestVote.
    reach = cand_mask[:, :, None] & deliver & deliver.transpose(1, 2) \
        & ~(heartbeat | is_ldr)[:, None, :]
    v_seen = torch.where(reach, term_e[:, :, None], 0).amax(dim=1)  # [G,V]
    higher = v_seen > term_e
    term_v = torch.maximum(term_e, v_seen)
    voted_v = torch.where(higher, -1, voted_e)
    role_v = torch.where(higher, FOLLOWER, role_e)

    own_last_term = _term_at_own(log_term2, last2, last2)          # [G,P]
    c_lt, c_li = own_last_term[:, :, None], last2[:, :, None]
    v_lt, v_li = own_last_term[:, None, :], last2[:, None, :]
    up_to_date = (c_lt > v_lt) | ((c_lt == v_lt) & (c_li >= v_li))

    elig = reach & (term_e[:, :, None] == term_v[:, None, :]) & up_to_date \
        & ((voted_v[:, None, :] == -1)
           | (voted_v[:, None, :] == peer_ids[None, :, None]))
    choice = torch.where(elig, peer_ids[None, :, None], P).amin(dim=1)  # [G,V]
    voted_v = torch.where(choice < P, choice, voted_v)
    grant = elig & (peer_ids[None, :, None] == choice[:, None, :])
    if dyn:
        # a candidate counts only votes from lanes in ITS view, against
        # that view's quorum (any lane may still grant a vote)
        votes = (grant & member_lanes(view, P)).sum(dim=2, dtype=i32)
        won = (role_v == CANDIDATE) & cand_mask & self_member \
            & (votes >= view_quorum)
    else:
        votes = grant.sum(dim=2, dtype=i32)                         # [G,C]
        won = (role_v == CANDIDATE) & cand_mask & (votes >= quorum)
    if config.ring_flow_control:
        won = won & room

    role_f = torch.where(won, LEADER, role_v)
    hint_f = torch.where(won, peer_ids[None, :], hint1)
    # Winner initializes nextIndex/matchIndex and appends a NoOp of its term
    # (with flow control and no free slot: re-stamps its last entry, an
    # uncommitted NoOp, with its term).
    noop_idx = last2 + 1
    appended = won
    if config.ring_flow_control:
        appended = won & fresh_slot
        noop_idx = torch.where(fresh_slot, noop_idx, last2)
    win_lane = won[:, :, None]
    next2 = torch.where(win_lane, noop_idx[:, :, None] + 1, next2)
    match2 = torch.where(win_lane, 0, match2)
    noop_slot = (noop_idx - 1) % L
    zero2 = torch.zeros_like(term_v)
    log_term2 = _slot_write(log_term2, noop_slot, won, term_v)
    log_op2 = _slot_write(log_op2, noop_slot, appended, zero2)
    log_time2 = _slot_write(log_time2, noop_slot, appended, clock1)
    log_tag2 = _slot_write(log_tag2, noop_slot, appended, zero2)
    last_f = torch.where(won, noop_idx, last2)

    # ---- phase 5: apply committed entries (all replicas, A per round) ----
    idx_all = state.applied_index[..., None] + 1 \
        + torch.arange(A, dtype=i32, device=dev)[None, None, :]   # [G,P,A]
    slot_all = ((idx_all - 1) % L).long()
    do_all = idx_all <= commit2[..., None]

    def ga(log: torch.Tensor) -> torch.Tensor:
        return torch.gather(log, 2, slot_all)

    time_w = ga(log_time2)
    op_w = ga(log_op2)
    a_w = ga(log_a2)
    b_w = ga(log_b2)
    c_w = ga(log_c2)
    resources = state.resources
    if config.pool_budgets is not None:
        if len(config.pool_budgets) != NUM_POOLS:
            raise ValueError(
                f"pool_budgets needs {NUM_POOLS} entries (value, map, set, "
                f"queue, lock, election, multimap, topic), got "
                f"{config.pool_budgets!r}")
        budgets = tuple(max(1, min(int(x), A)) for x in config.pool_budgets)
        resources, res_w, admitted = apply_window(
            resources, op_w, a_w, b_w, c_w, idx_all, time_w, do_all, budgets)
    else:
        res_cols = []
        for i in range(A):
            resources, r = apply_entry(resources, op_w[..., i], a_w[..., i],
                                       b_w[..., i], c_w[..., i],
                                       idx_all[..., i], time_w[..., i],
                                       do_all[..., i])
            res_cols.append(r)
        res_w = torch.stack(res_cols, dim=-1)                      # [G,P,A]
        admitted = do_all
    applied = state.applied_index + admitted.sum(dim=-1, dtype=i32)

    # Config entries take effect on each lane as it applies them, in
    # window order; an entry's ``a`` is the full new mask.
    member2 = state.member
    if dyn:
        cfg_w = (op_w == OP_CFG_ADD) | (op_w == OP_CFG_REMOVE)
        for i in range(A):
            member2 = torch.where(admitted[..., i] & cfg_w[..., i],
                                  a_w[..., i], member2)

    # Reporting lane: the lane with the highest applied_index after this
    # round (the first such lane), so every result is reported at least
    # once, even when the group is leaderless.
    rep = torch.argmax(applied, dim=1)                             # [G]

    def rep3(x: torch.Tensor) -> torch.Tensor:
        return x[g_ids, rep]

    out_valid = rep3(admitted)                                     # [G,A]
    out_tag = torch.where(out_valid, rep3(ga(log_tag2)), 0)
    out_result = torch.where(out_valid, rep3(res_w), 0)
    out_latency = torch.where(out_valid, l_clock[:, None] - rep3(time_w), 0)

    # ---- phase 6: drain session events (leader lane → host) ----
    resources, (ev_seq, ev_code, ev_target, ev_arg, ev_ok) = drain_events(
        resources, config.events_per_round, active)
    lead_ev = active[:, None] & _peer_view(ev_ok, lead)

    if dyn:
        # A leader whose removal has applied steps down once BOTH its
        # applied config and its active view exclude it (a lane that won
        # on an appended-but-unapplied re-ADD keeps leading until it
        # applies); a candidate outside its view stands down.
        out_m2 = ~((member2 >> peer_ids) & 1).bool() & ~self_member
        role_f = torch.where((role_f == LEADER) & out_m2, FOLLOWER, role_f)
        role_f = torch.where((role_f == CANDIDATE) & ~self_member, FOLLOWER,
                             role_f)

    term_f = torch.maximum(term_v, term_e)
    tel = None
    if config.telemetry:
        # reductions over values computed above, per group: no draws, no
        # state writes
        term_max = term_f.amax(dim=1)
        commit_max = commit2.amax(dim=1)
        post_lead_term = torch.where(role_f == LEADER, term_f, -1)
        post_lead = torch.argmax(post_lead_term, dim=1).to(i32)
        post_term = post_lead_term.amax(dim=1)
        rejected = submits.valid & ~accepted
        if dyn:
            rejected = rejected & ~refused
        # entries applied by the reporting lane, by pool
        pool_rep = rep3(pool_of(op_w))                            # [G,A]
        k_ids = torch.arange(NUM_POOLS + 1, dtype=i32, device=dev)
        applies_by_pool = ((pool_rep[..., None] == k_ids)
                           & out_valid[..., None]).sum(dim=1, dtype=i32)
        # outbox heads advance by drain pops or drop-oldest overwrites
        pops = ev_ok.sum(dim=-1, dtype=i32)                       # [G,P]
        head_adv = resources.ev_head - state.resources.ev_head
        tel = DeviceTelemetry(
            elections_started=timeout.sum(dim=1, dtype=i32),
            leader_changes=(won & ((peer_ids[None, :] != lead[:, None])
                                   | ~active[:, None])).sum(dim=1,
                                                            dtype=i32),
            term_bumps=term_max - state.term.amax(dim=1),
            leaderless=(~active).to(i32),
            commit_advance=commit_max - state.commit_index.amax(dim=1),
            commit_max=commit_max,
            term_max=term_max,
            leader_lane=torch.where(post_term >= 0, post_lead, -1),
            leader_term=post_term,
            applies=applies_by_pool,
            ring_occ_max=(last_f - applied).amax(dim=1),
            submit_rejections=rejected.sum(dim=1, dtype=i32),
            vote_splits=(cand_mask.any(dim=1) & ~won.any(dim=1)).to(i32),
            events_drained=lead_ev.sum(dim=1, dtype=i32),
            events_dropped=(head_adv - pops).clamp(min=0).amax(dim=1),
        )

    new_state = RaftState(
        term=term_f, voted_for=voted_v, role=role_f,
        leader_hint=hint_f, timer=timer1, clock=clock1,
        last_index=last_f, commit_index=commit2, applied_index=applied,
        next_index=next2, match_index=match2,
        log_term=log_term2, log_op=log_op2, log_a=log_a2, log_b=log_b2,
        log_c=log_c2, log_time=log_time2,
        log_tag=log_tag2, resources=resources,
        lease=lease_g[:, None].expand(G, P).clone(),
        member=member2)

    outputs = StepOutputs(
        accepted=accepted, out_valid=out_valid, out_tag=out_tag,
        out_result=out_result, out_latency=out_latency, leader=lead,
        commit_index=torch.where(active, l_commit, commit2.amax(dim=1)),
        stale=stale, clock=l_clock,
        ev_seq=_peer_view(ev_seq, lead), ev_code=_peer_view(ev_code, lead),
        ev_target=_peer_view(ev_target, lead),
        ev_arg=_peer_view(ev_arg, lead), ev_valid=lead_ev,
        assigned=admission.assigned,
        assigned_term=torch.where(accepted, l_term[:, None], 0),
        out_index=torch.where(out_valid, rep3(idx_all), 0),
        out_term=torch.where(out_valid, rep3(ga(log_term2)), 0),
        leader_term=torch.where(role_f == LEADER, term_f, -1).amax(dim=1),
        refused=refused if dyn else torch.zeros_like(submits.valid),
        telemetry=tel)
    return new_state, outputs


# ---------------------------------------------------------------------------
# the deep bulk plane: results accumulated on the device
# ---------------------------------------------------------------------------

def deep_step(state: RaftState, resbuf: torch.Tensor, valbuf: torch.Tensor,
              rndbuf: torch.Tensor, evflag: torch.Tensor, base: torch.Tensor,
              rnd: int, submits: Submits, deliver: torch.Tensor,
              fresh: torch.Tensor, cand: torch.Tensor, config: Config,
              onehot: bool = False):
    """One consensus round plus on-device result accumulation.

    The deep drive (``models/bulk.py``) commits dense per-group tag
    streams (``Config.monotone_tag_accept``), so an applied result's
    stream rank is ``out_tag - 1 - base[g]``; each round's results and
    resolve round ``rnd`` land in the carried ``[G, B]`` buffers at that
    rank, and the host fetches them once a drive. ``rndbuf`` keeps the
    earliest resolve round (at-least-once re-reports never inflate a
    latency); ``evflag [G]`` records that a group drained a session
    event. Returns ``(state, resbuf, valbuf, rndbuf, evflag, outputs)``.
    """
    state, out = step(state, submits, deliver, fresh, cand, config)
    return _deep_accumulate(state, resbuf, valbuf, rndbuf, evflag, base,
                            rnd, out, onehot)


def _deep_accumulate(state, resbuf, valbuf, rndbuf, evflag, base, rnd, out,
                     onehot):
    """Scatter one round's applied results into the deep accumulators.
    Reports outside ``[base+1, base+B]`` (earlier drives, election NoOps)
    are dropped: the scatter sends them to a spill column B that is cut
    off; the one-hot form matches no column."""
    B = resbuf.shape[1]
    k = out.out_tag - 1 - base[:, None]
    ok = out.out_valid & (k >= 0) & (k < B)
    if onehot:
        # masked select-reduce over A; ranks are distinct within a
        # group-round, so a sum writes each hit
        cols = torch.arange(B, dtype=torch.int32, device=k.device)
        hit = torch.where(ok, k, -1)[:, :, None] == cols      # [G,A,B]
        any_hit = hit.any(dim=1)
        resbuf = torch.where(any_hit, torch.where(
            hit, out.out_result[:, :, None], 0).sum(dim=1, dtype=torch.int32),
            resbuf)
        rndbuf = torch.where(any_hit, torch.minimum(rndbuf, torch.where(
            hit, rnd, 2 ** 30).amin(dim=1).to(torch.int32)), rndbuf)
        valbuf = valbuf | any_hit
    else:
        kk = torch.where(ok, k, B).long()

        def spill(buf):
            return torch.cat([buf, buf[:, :1]], dim=1)

        resbuf = spill(resbuf).scatter(1, kk, out.out_result)[:, :B]
        rndbuf = spill(rndbuf).scatter_reduce(
            1, kk, torch.full_like(out.out_result, rnd), "amin")[:, :B]
        valbuf = spill(valbuf).scatter(1, kk, True)[:, :B]
    evflag = evflag | out.ev_valid.any(dim=1)
    return state, resbuf, valbuf, rndbuf, evflag, out


def deep_scan(state: RaftState, resbuf: torch.Tensor, valbuf: torch.Tensor,
              rndbuf: torch.Tensor, evflag: torch.Tensor, base: torch.Tensor,
              submits_w: Submits, deliver: torch.Tensor, draws,
              config: Config, onehot: bool = False):
    """A deep drive's whole blind phase: W rounds of :func:`deep_step`
    with the accumulators carried on the device and round w's resolve
    round ``w``. ``submits_w`` leaves are ``[W, ...]`` (round w takes
    ``leaf[w]``) or 0-d (the same every round); ``draws`` holds the W
    ``(fresh, cand)`` timer draws, taken before the first round. No
    host synchronisation inside the loop. Returns ``(state, resbuf,
    valbuf, rndbuf, evflag, evs, tels)``: the five event leaves stacked
    ``[W, G, D]`` and the telemetry stacked ``[W, ...]`` (None when
    ``config.telemetry`` is off)."""
    evs, tels = [], []
    for w, (fresh, cand) in enumerate(draws):
        sub = Submits(*(x[w] if x.dim() else x for x in submits_w))
        state, resbuf, valbuf, rndbuf, evflag, out = deep_step(
            state, resbuf, valbuf, rndbuf, evflag, base, w, sub, deliver,
            fresh, cand, config, onehot)
        evs.append((out.ev_seq, out.ev_code, out.ev_target, out.ev_arg,
                    out.ev_valid))
        tels.append(out.telemetry)
    evs = tuple(torch.stack(x) for x in zip(*evs))
    tel = (DeviceTelemetry(*(torch.stack(x) for x in zip(*tels)))
           if config.telemetry else None)
    return state, resbuf, valbuf, rndbuf, evflag, evs, tel
