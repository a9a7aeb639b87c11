"""Vectorized state-machine apply for every device resource pool (torch).

Counterpart of ``copycat_tpu/ops/apply.py``: the op semantics are data —
an opcode plus three int32 arguments — applied to all groups' replicas at
once with ``torch.where`` masking over the ``[G, P]`` batch. Maps, sets
and multimaps are fixed-slot probe tables; queues, lock waiters and
election listeners are fixed-capacity rings; overflow answers ``FAIL``.
A pool sized 0 answers its opcodes with ``FAIL`` and carries no state.
TTLs and lock timeouts are read lazily against the entry's logical
timestamp, so replica state is a pure function of the applied log.

``apply_entry`` applies one entry per lane through all eight pool
kernels; ``apply_window`` (``Config.pool_budgets``) folds each pool over
only its own entries of a window.

Every leaf is ``[G, P, ...]`` int32 or bool; results keep the reference's
dtype and int32 wraparound. Where the reference selects or moves pool
slots with one-hot reductions, this module uses ``gather``/``scatter`` on
distinct indices (masked lanes go to a discard column), which selects the
same values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT_MIN = -(2 ** 31)
INT_MAX = 2 ** 31 - 1

#: Sentinel returned for failed/absent/overflow results.
FAIL = INT_MIN

# --- opcodes (device-path operation catalog) -------------------------------
OP_NOP = 0

# value / long
OP_VALUE_SET = 1          # a=value, c=ttl ticks (0 = none)
OP_VALUE_GET = 2
OP_VALUE_CAS = 3          # a=expect, b=update -> 1 if swapped else 0
OP_VALUE_GET_AND_SET = 4  # a=update -> previous value
OP_LONG_ADD = 5           # a=delta -> new value (addAndGet)

# map
OP_MAP_PUT = 10
OP_MAP_GET = 11
OP_MAP_REMOVE = 12
OP_MAP_PUT_IF_ABSENT = 13
OP_MAP_GET_OR_DEFAULT = 14
OP_MAP_REMOVE_IF = 15
OP_MAP_REPLACE = 16
OP_MAP_REPLACE_IF = 17
OP_MAP_CONTAINS_KEY = 18
OP_MAP_CONTAINS_VALUE = 19
OP_MAP_SIZE = 20
OP_MAP_IS_EMPTY = 21
OP_MAP_CLEAR = 22

# set
OP_SET_ADD = 30
OP_SET_REMOVE = 31
OP_SET_CONTAINS = 32
OP_SET_SIZE = 33
OP_SET_CLEAR = 34

# queue
OP_Q_OFFER = 40
OP_Q_POLL = 41
OP_Q_PEEK = 42
OP_Q_SIZE = 43
OP_Q_CLEAR = 44

# lock
OP_LOCK_ACQUIRE = 50      # a=holder id, b=timeout ticks (-1 forever, 0 try)
OP_LOCK_RELEASE = 51      # a=holder id -> 1 if released
OP_LOCK_CANCEL = 52       # a=holder id -> 2 already-granted | 1 dequeued | 0 gone
OP_LOCK_HOLDER = 53       # -> current holder id | -1

# leader election (epoch = entry log index)
OP_ELECT_LISTEN = 60      # a=candidate id -> epoch if elected now else 0
OP_ELECT_RESIGN = 61      # a=candidate id
OP_ELECT_IS_LEADER = 62   # a=candidate id, b=epoch -> 0/1
OP_ELECT_LEADER = 63      # -> current leader id | -1
OP_ELECT_GET_EPOCH = 64   # -> current epoch

# multimap
OP_MM_PUT = 70
OP_MM_REMOVE = 71
OP_MM_REMOVE_ENTRY = 72
OP_MM_CONTAINS_KEY = 73
OP_MM_CONTAINS_ENTRY = 74
OP_MM_CONTAINS_VALUE = 75
OP_MM_COUNT = 76
OP_MM_SIZE = 77
OP_MM_IS_EMPTY = 78
OP_MM_CLEAR = 79

# topic pub/sub
OP_TOPIC_LISTEN = 85
OP_TOPIC_UNLISTEN = 86
OP_TOPIC_PUB = 87
OP_TOPIC_COUNT = 88

# cluster membership change (consensus-layer; POOL_NONE here)
OP_CFG_ADD = 90
OP_CFG_REMOVE = 91

#: Read-only opcodes servable on a query lane.
QUERY_OPCODES = frozenset({
    OP_VALUE_GET,
    OP_MAP_GET, OP_MAP_GET_OR_DEFAULT, OP_MAP_CONTAINS_KEY,
    OP_MAP_CONTAINS_VALUE, OP_MAP_SIZE, OP_MAP_IS_EMPTY,
    OP_SET_CONTAINS, OP_SET_SIZE,
    OP_Q_PEEK, OP_Q_SIZE,
    OP_LOCK_HOLDER,
    OP_ELECT_IS_LEADER, OP_ELECT_LEADER, OP_ELECT_GET_EPOCH,
    OP_MM_CONTAINS_KEY, OP_MM_CONTAINS_ENTRY, OP_MM_CONTAINS_VALUE,
    OP_MM_COUNT, OP_MM_SIZE, OP_MM_IS_EMPTY,
    OP_TOPIC_COUNT,
})

# --- event codes (session push, harvested from the leader lane) ------------
EV_NONE = 0
EV_LOCK_GRANT = 1   # target=holder id, arg=1
EV_ELECT = 3        # target=new leader id, arg=epoch
EV_TOPIC_MSG = 4    # target=-1 (broadcast), arg=message


class ResourceConfig(NamedTuple):
    """Fixed device pool sizes. Any size may be 0: the pool then carries
    no state and its ops return ``FAIL``."""

    map_slots: int = 16
    set_slots: int = 16
    queue_slots: int = 16
    wait_slots: int = 8       # lock wait queue (0 = try-lock only)
    listener_slots: int = 8   # election listener queue (0 = no succession)
    event_slots: int = 32     # session-event outbox ring
    multimap_slots: int = 16  # (key, value)-pair probe table
    topic_slots: int = 8      # topic subscriber table

    @classmethod
    def counters_only(cls) -> "ResourceConfig":
        """Value/long registers only — the leanest kernel."""
        return cls(map_slots=0, set_slots=0, queue_slots=0, wait_slots=0,
                   listener_slots=0, event_slots=0, multimap_slots=0,
                   topic_slots=0)


class ResourceState(NamedTuple):
    """Per-group, per-replica resource state; every field is
    ``[G, P, ...]``. Zero-slot pools are zero-width tensors."""

    value: torch.Tensor    # [G,P] i32
    val_dl: torch.Tensor   # [G,P] i32 (0 = no TTL)
    map_key: torch.Tensor  # [G,P,K] i32
    map_val: torch.Tensor  # [G,P,K] i32
    map_live: torch.Tensor  # [G,P,K] bool
    map_dl: torch.Tensor   # [G,P,K] i32
    set_key: torch.Tensor  # [G,P,Ks] i32
    set_live: torch.Tensor  # [G,P,Ks] bool
    set_dl: torch.Tensor   # [G,P,Ks] i32
    q_val: torch.Tensor    # [G,P,Q] i32
    q_head: torch.Tensor   # [G,P] i32
    q_size: torch.Tensor   # [G,P] i32
    lk_holder: torch.Tensor    # [G,P] i32, -1 = free
    lk_wait_id: torch.Tensor   # [G,P,W] i32
    lk_wait_dl: torch.Tensor   # [G,P,W] i32
    lk_wait_live: torch.Tensor  # [G,P,W] bool
    lk_head: torch.Tensor      # [G,P] i32
    lk_size: torch.Tensor      # [G,P] i32
    el_leader: torch.Tensor    # [G,P] i32, -1 = none
    el_epoch: torch.Tensor     # [G,P] i32
    el_id: torch.Tensor        # [G,P,Wl] i32
    el_live: torch.Tensor      # [G,P,Wl] bool
    el_head: torch.Tensor      # [G,P] i32
    el_size: torch.Tensor      # [G,P] i32
    ev_code: torch.Tensor      # [G,P,E] i32
    ev_target: torch.Tensor    # [G,P,E] i32
    ev_arg: torch.Tensor       # [G,P,E] i32
    ev_head: torch.Tensor      # [G,P] i32
    ev_tail: torch.Tensor      # [G,P] i32
    mm_key: torch.Tensor       # [G,P,M] i32
    mm_val: torch.Tensor       # [G,P,M] i32
    mm_live: torch.Tensor      # [G,P,M] bool
    mm_dl: torch.Tensor        # [G,P,M] i32
    tp_id: torch.Tensor        # [G,P,T] i32
    tp_live: torch.Tensor      # [G,P,T] bool


def init_resources(num_groups: int, num_peers: int, rc: ResourceConfig,
                   device: torch.device | str) -> ResourceState:
    G, P = num_groups, num_peers
    i32 = dict(dtype=torch.int32, device=device)

    def z2():
        return torch.zeros((G, P), **i32)

    def zi(n):
        return torch.zeros((G, P, n), **i32)

    def zb(n):
        return torch.zeros((G, P, n), dtype=torch.bool, device=device)

    return ResourceState(
        value=z2(), val_dl=z2(),
        map_key=zi(rc.map_slots), map_val=zi(rc.map_slots),
        map_live=zb(rc.map_slots), map_dl=zi(rc.map_slots),
        set_key=zi(rc.set_slots), set_live=zb(rc.set_slots),
        set_dl=zi(rc.set_slots),
        q_val=zi(rc.queue_slots), q_head=z2(), q_size=z2(),
        lk_holder=z2() - 1, lk_wait_id=zi(rc.wait_slots),
        lk_wait_dl=zi(rc.wait_slots), lk_wait_live=zb(rc.wait_slots),
        lk_head=z2(), lk_size=z2(),
        el_leader=z2() - 1, el_epoch=z2(), el_id=zi(rc.listener_slots),
        el_live=zb(rc.listener_slots), el_head=z2(), el_size=z2(),
        ev_code=zi(rc.event_slots), ev_target=zi(rc.event_slots),
        ev_arg=zi(rc.event_slots), ev_head=z2(), ev_tail=z2(),
        mm_key=zi(rc.multimap_slots), mm_val=zi(rc.multimap_slots),
        mm_live=zb(rc.multimap_slots), mm_dl=zi(rc.multimap_slots),
        tp_id=zi(rc.topic_slots), tp_live=zb(rc.topic_slots),
    )


# ---------------------------------------------------------------------------
# small vectorized helpers over [G,P,N] pools
# ---------------------------------------------------------------------------

def _gather3(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """arr[G,P,N] selected at slot[G,P] -> [G,P]; a slot outside 0..N-1
    selects 0 (False for a bool pool), as the reference's one-hot
    select-reduce does."""
    N = arr.shape[-1]
    if N == 0:
        return torch.zeros(slot.shape, dtype=arr.dtype, device=arr.device)
    inside = (slot >= 0) & (slot < N)
    idx = slot.clamp(0, N - 1).long()[..., None]
    picked = torch.gather(arr, -1, idx)[..., 0]
    return torch.where(inside, picked, torch.zeros_like(picked))


def _scatter3(arr: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
              value) -> torch.Tensor:
    """Masked write of value ([G,P] tensor or a scalar) into arr[G,P,N]
    at slot[G,P]."""
    N = arr.shape[-1]
    ids = torch.arange(N, dtype=torch.int32, device=arr.device)
    hit = (ids[None, None, :] == slot[..., None]) & mask[..., None]
    if isinstance(value, torch.Tensor):
        value = value[..., None]
    return torch.where(hit, value, arr)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _first_true(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(index of the first True along the last axis, any True) for
    mask[G,P,N]: one max-reduce of N - i where mask holds (0 = none)."""
    N = mask.shape[-1]
    ids = torch.arange(N, dtype=torch.int32, device=mask.device)
    best = torch.where(mask, N - ids, 0).amax(dim=-1)
    found = best > 0
    return torch.where(found, N - best, 0), found


def _ring_pos(head: torch.Tensor, n: int) -> torch.Tensor:
    """Position-in-queue of each ring slot: [G,P,N] given head[G,P]."""
    slots = torch.arange(n, dtype=torch.int32, device=head.device)
    return (slots - head[..., None]) % n


def _ring_compact(mask, head, size, pos, live_arr, live_win, *arrays):
    """Stable-compact ring slots where ``mask`` holds; returns (head,
    size, live, [compacted arrays]). FIFO order of live entries is kept:
    each slot's rank is the count of smaller keys (pos for live, N + pos
    for dead), a permutation of 0..N-1 since ring positions are. Lanes
    where ``mask`` is False keep every field."""
    N = arrays[0].shape[-1]
    key = torch.where(live_win, pos, N + pos)
    rank = (key[..., None, :] < key[..., :, None]).sum(
        dim=-1, dtype=torch.int32)                                # [G,P,N]
    count = live_win.sum(dim=-1, dtype=torch.int32)
    m3 = mask[..., None]
    # slot j moves to position rank[j]: distinct targets, so one scatter
    # gives the reference's one-hot [G,P,N,N] select
    dest = rank.long()
    out = [torch.where(m3, torch.empty_like(arr).scatter_(-1, dest, arr), arr)
           for arr in arrays]
    ids = torch.arange(N, dtype=torch.int32, device=mask.device)
    live = torch.where(m3, ids < count[..., None], live_arr)
    head = torch.where(mask, 0, head)
    size = torch.where(mask, count, size)
    return head, size, live, out


# ---------------------------------------------------------------------------
# pool classification
# ---------------------------------------------------------------------------

(POOL_VALUE, POOL_MAP, POOL_SET, POOL_QUEUE, POOL_LOCK, POOL_ELECT,
 POOL_MMAP, POOL_TOPIC) = range(8)
NUM_POOLS = 8
POOL_NONE = NUM_POOLS  # NoOps — applied (indices advance), no pool work

_POOL_RANGES = (
    (OP_VALUE_SET, OP_LONG_ADD, POOL_VALUE),
    (OP_MAP_PUT, OP_MAP_CLEAR, POOL_MAP),
    (OP_SET_ADD, OP_SET_CLEAR, POOL_SET),
    (OP_Q_OFFER, OP_Q_CLEAR, POOL_QUEUE),
    (OP_LOCK_ACQUIRE, OP_LOCK_HOLDER, POOL_LOCK),
    (OP_ELECT_LISTEN, OP_ELECT_GET_EPOCH, POOL_ELECT),
    (OP_MM_PUT, OP_MM_CLEAR, POOL_MMAP),
    (OP_TOPIC_LISTEN, OP_TOPIC_COUNT, POOL_TOPIC),
)


def pool_of(opcode: torch.Tensor) -> torch.Tensor:
    """Map opcodes to pool ids ([G,P] -> [G,P], POOL_NONE for NoOp)."""
    pool = torch.full_like(opcode, POOL_NONE)
    for lo, hi, pid in _POOL_RANGES:
        pool = torch.where((opcode >= lo) & (opcode <= hi), pid, pool)
    return pool


# ---------------------------------------------------------------------------
# per-pool apply kernels
#
# Each kernel applies ONE entry per (group, replica) lane against ONLY its
# pool's arrays. ``apply_entry`` composes all eight for the single-entry
# case; ``apply_window`` folds each pool over its own entries.
# ---------------------------------------------------------------------------

def apply_value(value, val_dl, opcode, a, b, c, now, live):
    """Value/long registers; returns ((value, val_dl), result)."""
    def op(code):
        return live & (opcode == code)

    expired = (val_dl > 0) & (val_dl <= now)
    eff = torch.where(expired, 0, value)  # TTL'd value reads as unset

    is_set = op(OP_VALUE_SET)
    is_get = op(OP_VALUE_GET)
    is_cas = op(OP_VALUE_CAS)
    is_gas = op(OP_VALUE_GET_AND_SET)
    is_add = op(OP_LONG_ADD)
    cas_hit = is_cas & (eff == a)
    # Only ops that actually write may touch value/val_dl — a failed CAS
    # must leave an active TTL intact.
    wrote = is_set | cas_hit | is_gas | is_add
    purge = (is_get | is_cas) & expired  # observed expiry without writing

    new_value = eff
    new_value = torch.where(is_set, a, new_value)
    new_value = torch.where(cas_hit, b, new_value)
    new_value = torch.where(is_gas, a, new_value)
    new_value = torch.where(is_add, eff + a, new_value)
    out_value = torch.where(wrote, new_value,
                            torch.where(purge, 0, value))
    new_dl = torch.where(is_set & (c > 0), now + c, 0)
    out_dl = torch.where(wrote, new_dl, torch.where(purge, 0, val_dl))

    result = torch.zeros_like(opcode)
    result = torch.where(is_get, eff, result)
    result = torch.where(is_cas, _i32(cas_hit), result)
    result = torch.where(is_gas, eff, result)
    result = torch.where(is_add, eff + a, result)
    return (out_value, out_dl), result


def _insert_result(dup, free_any):
    """0 for a duplicate, 1 for an insert, ``FAIL`` when the table is
    full."""
    return torch.where(dup, 0, _i32(torch.where(free_any, 1, INT_MIN)))


def apply_map(mk, mv, ml, mdl, opcode, a, b, c, now, live):
    """Hashed probe-table map; returns ((mk, mv, ml, mdl), result)."""
    def op(code):
        return live & (opcode == code)

    is_map = live & (opcode >= OP_MAP_PUT) & (opcode <= OP_MAP_CLEAR)
    result = torch.zeros_like(opcode)
    if mk.shape[-1] == 0:
        return (mk, mv, ml, mdl), torch.where(is_map, INT_MIN, result)

    now3 = now[..., None]
    m_alive = ml & ((mdl == 0) | (mdl > now3))
    hit = m_alive & (mk == a[..., None])
    hit_idx, hit_any = _first_true(hit)
    free_idx, free_any = _first_true(~m_alive)
    old = torch.where(hit_any, _gather3(mv, hit_idx), 0)

    put = op(OP_MAP_PUT)
    pia = op(OP_MAP_PUT_IF_ABSENT)
    rep = op(OP_MAP_REPLACE)
    repif = op(OP_MAP_REPLACE_IF) & hit_any & (old == b)
    write_new = (put | pia) & ~hit_any           # needs a free slot
    write_over = (put & hit_any) | (rep & hit_any) | repif
    ins_ok = write_new & free_any
    w_idx = torch.where(hit_any, hit_idx, free_idx)
    w_val = torch.where(repif, c, b)
    w_dl = torch.where((put | pia) & (c > 0), now + c, 0)
    do_write = ins_ok | write_over
    mk = _scatter3(mk, w_idx, do_write, a)
    mv = _scatter3(mv, w_idx, do_write, w_val)
    mdl = _scatter3(mdl, w_idx, do_write,
                    torch.where(write_over & ~put, 0, w_dl))
    ml = _scatter3(ml, w_idx, do_write, True)

    rm = op(OP_MAP_REMOVE) | (op(OP_MAP_REMOVE_IF) & (old == b))
    ml = _scatter3(ml, hit_idx, rm & hit_any, False)
    ml = torch.where(op(OP_MAP_CLEAR)[..., None], False, ml)
    # drop expired slots whenever any map op touches the group (lazy
    # purge; just-written slots have dl == 0 or dl > now, so they survive)
    ml = torch.where(is_map[..., None], ml & ((mdl == 0) | (mdl > now3)), ml)

    m_size = m_alive.sum(dim=-1, dtype=torch.int32)
    result = torch.where(put, old, result)
    result = torch.where(put & write_new & ~free_any, INT_MIN, result)
    result = torch.where(pia, _insert_result(hit_any, free_any), result)
    result = torch.where(op(OP_MAP_GET), old, result)
    result = torch.where(op(OP_MAP_GET_OR_DEFAULT),
                         torch.where(hit_any, old, b), result)
    result = torch.where(op(OP_MAP_REMOVE), old, result)
    result = torch.where(op(OP_MAP_REMOVE_IF), _i32(hit_any & (old == b)),
                         result)
    result = torch.where(rep, torch.where(hit_any, old, INT_MIN), result)
    result = torch.where(op(OP_MAP_REPLACE_IF), _i32(repif), result)
    result = torch.where(op(OP_MAP_CONTAINS_KEY), _i32(hit_any), result)
    result = torch.where(op(OP_MAP_CONTAINS_VALUE),
                         _i32((m_alive & (mv == a[..., None])).any(dim=-1)),
                         result)
    result = torch.where(op(OP_MAP_SIZE), m_size, result)
    result = torch.where(op(OP_MAP_IS_EMPTY), _i32(m_size == 0), result)
    return (mk, mv, ml, mdl), result


def apply_set(sk, sl, sdl, opcode, a, b, c, now, live):
    """Probe-table set; returns ((sk, sl, sdl), result)."""
    def op(code):
        return live & (opcode == code)

    is_setop = live & (opcode >= OP_SET_ADD) & (opcode <= OP_SET_CLEAR)
    result = torch.zeros_like(opcode)
    if sk.shape[-1] == 0:
        return (sk, sl, sdl), torch.where(is_setop, INT_MIN, result)

    now3 = now[..., None]
    s_alive = sl & ((sdl == 0) | (sdl > now3))
    s_hit = s_alive & (sk == a[..., None])
    s_hit_idx, s_hit_any = _first_true(s_hit)
    s_free_idx, s_free_any = _first_true(~s_alive)

    add = op(OP_SET_ADD) & ~s_hit_any & s_free_any
    sk = _scatter3(sk, s_free_idx, add, a)
    sdl = _scatter3(sdl, s_free_idx, add, torch.where(c > 0, now + c, 0))
    sl = _scatter3(sl, s_free_idx, add, True)
    srm = op(OP_SET_REMOVE) & s_hit_any
    sl = _scatter3(sl, s_hit_idx, srm, False)
    sl = torch.where(op(OP_SET_CLEAR)[..., None], False, sl)
    sl = torch.where(is_setop[..., None], sl & ((sdl == 0) | (sdl > now3)),
                     sl)
    s_size = s_alive.sum(dim=-1, dtype=torch.int32)
    result = torch.where(op(OP_SET_ADD), _insert_result(s_hit_any,
                                                        s_free_any), result)
    result = torch.where(op(OP_SET_REMOVE), _i32(s_hit_any), result)
    result = torch.where(op(OP_SET_CONTAINS), _i32(s_hit_any), result)
    result = torch.where(op(OP_SET_SIZE), s_size, result)
    return (sk, sl, sdl), result


def apply_queue(qv, qh, qs, opcode, a, b, c, now, live):
    """FIFO ring queue (``qh`` counts absolute pops); returns
    ((qv, qh, qs), result)."""
    def op(code):
        return live & (opcode == code)

    is_q = live & (opcode >= OP_Q_OFFER) & (opcode <= OP_Q_CLEAR)
    result = torch.zeros_like(opcode)
    if qv.shape[-1] == 0:
        return (qv, qh, qs), torch.where(is_q, INT_MIN, result)

    Q = qv.shape[-1]
    offer = op(OP_Q_OFFER)
    can_push = offer & (qs < Q)
    qv = _scatter3(qv, (qh + qs) % Q, can_push, a)
    head_val = _gather3(qv, qh % Q)
    poll = op(OP_Q_POLL) & (qs > 0)
    qs = torch.where(can_push, qs + 1, qs)
    qh = torch.where(poll, qh + 1, qh)
    qs = torch.where(poll, qs - 1, qs)
    qs = torch.where(op(OP_Q_CLEAR), 0, qs)
    result = torch.where(offer, _i32(can_push), result)
    result = torch.where(op(OP_Q_POLL), torch.where(poll, head_val, INT_MIN),
                         result)
    result = torch.where(op(OP_Q_PEEK),
                         torch.where(qs > 0, head_val, INT_MIN), result)
    result = torch.where(op(OP_Q_SIZE), qs, result)
    return (qv, qh, qs), result


def _no_events(opcode, live):
    z = torch.zeros_like(opcode)
    return (torch.zeros_like(live), z, z, z)


def _events(fire, code, target, arg):
    """One event per lane where ``fire``: (mask, code, target, arg)."""
    return (fire, _i32(torch.where(fire, code, 0)),
            torch.where(fire, target, 0), torch.where(fire, arg, 0))


def apply_lock(holder, wid, wdl, wlv, lh, ls, opcode, a, b, now, live):
    """Lock kernel with its wait ring; returns ((holder, wid, wdl, wlv,
    lh, ls), result, (ev_mask, ev_code, ev_target, ev_arg))."""
    def op(code):
        return live & (opcode == code)

    result = torch.zeros_like(opcode)
    acq = op(OP_LOCK_ACQUIRE)
    rel = op(OP_LOCK_RELEASE)
    cxl = op(OP_LOCK_CANCEL)
    held_by_me = holder == a
    grant_now = acq & (holder == -1)
    holder = torch.where(grant_now, a, holder)
    idem = acq & held_by_me          # retried acquire we already won
    do_rel = rel & held_by_me
    W = wid.shape[-1]
    if W == 0:
        holder = torch.where(do_rel, -1, holder)
        result = torch.where(acq, _i32(grant_now | idem), result)
        result = torch.where(cxl, _i32(held_by_me) * 2, result)
        result = torch.where(rel, _i32(do_rel), result)
        result = torch.where(op(OP_LOCK_HOLDER), holder, result)
        return (holder, wid, wdl, wlv, lh, ls), result, \
            _no_events(opcode, live)

    # Lazily expire timed-out waiters, then compact the ring: dead slots
    # (cancelled or expired anywhere in the window) must never wedge
    # capacity. Stable compaction keeps FIFO order.
    is_lock = live & (opcode >= OP_LOCK_ACQUIRE) & (opcode <= OP_LOCK_HOLDER)
    now3 = now[..., None]
    pos = _ring_pos(lh, W)
    in_win = pos < ls[..., None]
    wlv = wlv & ~(is_lock[..., None] & in_win & (wdl <= now3))
    live_win = wlv & in_win
    any_dead = is_lock & (in_win & ~wlv).any(dim=-1)
    lh, ls, wlv, (wid, wdl) = _ring_compact(
        any_dead, lh, ls, pos, wlv, live_win, wid, wdl)

    pos2 = _ring_pos(lh, W)
    in_win2 = pos2 < ls[..., None]
    mine = wlv & in_win2 & (wid == a[..., None])
    queued_me = mine.any(dim=-1)

    want_q = acq & ~grant_now & ~idem & ~queued_me & (b != 0)
    q_ok = want_q & (ls < W)
    q_dl = torch.where(b < 0, INT_MAX, now + b)   # b < 0 waits forever
    tail = (lh + ls) % W
    wid = _scatter3(wid, tail, q_ok, a)
    wdl = _scatter3(wdl, tail, q_ok, q_dl)
    wlv = _scatter3(wlv, tail, q_ok, True)
    ls = torch.where(q_ok, ls + 1, ls)

    # release: hand to the first waiter (ring is compacted: head live)
    next_id = _gather3(wid, lh % W)
    has_next = do_rel & (ls > 0)
    holder = torch.where(do_rel, torch.where(has_next, next_id, -1), holder)
    lh = torch.where(has_next, lh + 1, lh)
    ls = torch.where(has_next, ls - 1, ls)

    # cancel: totally ordered with grants through the log, so the
    # client's timeout decision is race-free (2 = won before cancel)
    already = cxl & held_by_me
    cxl_hit = wlv & in_win2 & (wid == a[..., None])
    cxl_idx, cxl_found = _first_true(cxl_hit)
    wlv = _scatter3(wlv, cxl_idx, cxl & ~already & cxl_found, False)

    result = torch.where(acq, torch.where(grant_now | idem, 1,
                                          _i32(q_ok | queued_me) * 2),
                         result)
    result = torch.where(cxl, torch.where(already, 2, _i32(cxl_found)),
                         result)
    result = torch.where(rel, _i32(do_rel), result)
    result = torch.where(op(OP_LOCK_HOLDER), holder, result)
    # Only queued-waiter grants are asynchronous; an immediate grant or a
    # failure reaches the client as the command's own result.
    events = _events(has_next, EV_LOCK_GRANT, next_id,
                     torch.ones_like(opcode))
    return (holder, wid, wdl, wlv, lh, ls), result, events


def apply_elect(el, ep, eid, elv, eh, es, opcode, a, b, index, live):
    """Leader-election kernel with its listener ring; returns ((el, ep,
    eid, elv, eh, es), result, (ev_mask, ev_code, ev_target, ev_arg))."""
    def op(code):
        return live & (opcode == code)

    result = torch.zeros_like(opcode)
    listen = op(OP_ELECT_LISTEN)
    resign = op(OP_ELECT_RESIGN)
    am_leader = el == a
    vacant = el == -1
    win_now = listen & vacant
    el = torch.where(win_now, a, el)
    ep = torch.where(win_now, index, ep)
    do_res = resign & am_leader
    Wl = eid.shape[-1]
    events = _no_events(opcode, live)
    if Wl == 0:
        el = torch.where(do_res, -1, el)
        result = torch.where(listen, torch.where(
            win_now, index, torch.where(am_leader, ep, INT_MIN)), result)
    else:
        # compact out unlisted waiters (same discipline as the lock ring)
        is_el = live & (opcode >= OP_ELECT_LISTEN) \
            & (opcode <= OP_ELECT_GET_EPOCH)
        e_pos = _ring_pos(eh, Wl)
        e_in = e_pos < es[..., None]
        e_live_win = elv & e_in
        e_dead = is_el & (e_in & ~elv).any(dim=-1)
        eh, es, elv, (eid,) = _ring_compact(
            e_dead, eh, es, e_pos, elv, e_live_win, eid)

        e_pos2 = _ring_pos(eh, Wl)
        e_in2 = e_pos2 < es[..., None]
        listed = (elv & e_in2 & (eid == a[..., None])).any(dim=-1)

        # a retried listen by the sitting leader or a queued waiter is
        # idempotent — no duplicate ring entry
        el_q = listen & ~vacant & ~am_leader & ~listed & (es < Wl)
        tail = (eh + es) % Wl
        eid = _scatter3(eid, tail, el_q, a)
        elv = _scatter3(elv, tail, el_q, True)
        es = torch.where(el_q, es + 1, es)
        el_full = listen & ~vacant & ~am_leader & ~listed & ~el_q

        # resign by the leader promotes the next listener (FIFO
        # succession); by a waiter, it unlists
        succ_id = _gather3(eid, eh % Wl)
        has_succ = do_res & (es > 0)
        el = torch.where(do_res, torch.where(has_succ, succ_id, -1), el)
        ep = torch.where(has_succ, index, ep)
        eh = torch.where(has_succ, eh + 1, eh)
        es = torch.where(has_succ, es - 1, es)
        e_hit = elv & e_in2 & (eid == a[..., None])
        e_idx, e_found = _first_true(e_hit)
        elv = _scatter3(elv, e_idx, resign & ~do_res & e_found, False)

        result = torch.where(listen, torch.where(
            win_now, index, torch.where(
                am_leader, ep, _i32(torch.where(el_full, INT_MIN, 0)))),
            result)
        events = _events(has_succ, EV_ELECT, succ_id, index)
    result = torch.where(resign, _i32(do_res), result)
    result = torch.where(op(OP_ELECT_IS_LEADER), _i32(am_leader & (ep == b)),
                         result)
    result = torch.where(op(OP_ELECT_LEADER), el, result)
    result = torch.where(op(OP_ELECT_GET_EPOCH), ep, result)
    return (el, ep, eid, elv, eh, es), result, events


def apply_multimap(mk, mv, ml, mdl, opcode, a, b, c, now, live):
    """(key, value)-pair probe table; returns ((mk, mv, ml, mdl), result).
    Membership is per (key, value); removal by key drops every pair under
    it."""
    def op(code):
        return live & (opcode == code)

    is_mm = live & (opcode >= OP_MM_PUT) & (opcode <= OP_MM_CLEAR)
    result = torch.zeros_like(opcode)
    if mk.shape[-1] == 0:
        return (mk, mv, ml, mdl), torch.where(is_mm, INT_MIN, result)

    now3 = now[..., None]
    alive = ml & ((mdl == 0) | (mdl > now3))
    key_hit = alive & (mk == a[..., None])
    pair_hit = key_hit & (mv == b[..., None])
    pair_idx, pair_any = _first_true(pair_hit)
    free_idx, free_any = _first_true(~alive)
    key_count = key_hit.sum(dim=-1, dtype=torch.int32)
    total = alive.sum(dim=-1, dtype=torch.int32)

    put = op(OP_MM_PUT) & ~pair_any & free_any
    mk = _scatter3(mk, free_idx, put, a)
    mv = _scatter3(mv, free_idx, put, b)
    mdl = _scatter3(mdl, free_idx, put, torch.where(c > 0, now + c, 0))
    ml = _scatter3(ml, free_idx, put, True)

    # remove-by-key drops EVERY live pair under the key in one pass
    rm_key = op(OP_MM_REMOVE)
    ml = torch.where(rm_key[..., None] & key_hit, False, ml)
    rm_pair = op(OP_MM_REMOVE_ENTRY) & pair_any
    ml = _scatter3(ml, pair_idx, rm_pair, False)
    ml = torch.where(op(OP_MM_CLEAR)[..., None], False, ml)
    # lazy TTL purge on any touch, like the map kernel
    ml = torch.where(is_mm[..., None], ml & ((mdl == 0) | (mdl > now3)), ml)

    result = torch.where(op(OP_MM_PUT), _insert_result(pair_any, free_any),
                         result)
    result = torch.where(rm_key, key_count, result)
    result = torch.where(op(OP_MM_REMOVE_ENTRY), _i32(pair_any), result)
    result = torch.where(op(OP_MM_CONTAINS_KEY), _i32(key_count > 0), result)
    result = torch.where(op(OP_MM_CONTAINS_ENTRY), _i32(pair_any), result)
    result = torch.where(op(OP_MM_CONTAINS_VALUE),
                         _i32((alive & (mv == a[..., None])).any(dim=-1)),
                         result)
    result = torch.where(op(OP_MM_COUNT), key_count, result)
    result = torch.where(op(OP_MM_SIZE), total, result)
    result = torch.where(op(OP_MM_IS_EMPTY), _i32(total == 0), result)
    return (mk, mv, ml, mdl), result


def apply_topic(tid, tlive, opcode, a, b, now, live):
    """Topic subscriber table and publish fan-out; returns ((tid, tlive),
    result, (ev_mask, ev_code, ev_target, ev_arg)). A publish to a
    subscribed topic emits ONE broadcast event (target -1) carrying the
    message."""
    def op(code):
        return live & (opcode == code)

    is_tp = live & (opcode >= OP_TOPIC_LISTEN) & (opcode <= OP_TOPIC_COUNT)
    result = torch.zeros_like(opcode)
    if tid.shape[-1] == 0:
        return (tid, tlive), torch.where(is_tp, INT_MIN, result), \
            _no_events(opcode, live)

    hit = tlive & (tid == a[..., None])
    hit_idx, hit_any = _first_true(hit)
    free_idx, free_any = _first_true(~tlive)
    count = tlive.sum(dim=-1, dtype=torch.int32)

    sub = op(OP_TOPIC_LISTEN) & ~hit_any & free_any
    tid = _scatter3(tid, free_idx, sub, a)
    tlive = _scatter3(tlive, free_idx, sub, True)
    unsub = op(OP_TOPIC_UNLISTEN) & hit_any
    tlive = _scatter3(tlive, hit_idx, unsub, False)

    pub = op(OP_TOPIC_PUB)
    result = torch.where(op(OP_TOPIC_LISTEN),
                         _insert_result(hit_any, free_any), result)
    result = torch.where(op(OP_TOPIC_UNLISTEN), _i32(hit_any), result)
    result = torch.where(pub, count, result)
    result = torch.where(op(OP_TOPIC_COUNT), count, result)
    fan = pub & (count > 0)
    events = _events(fan, EV_TOPIC_MSG, torch.full_like(opcode, -1), a)
    return (tid, tlive), result, events


def push_events(res: ResourceState, ev_mask, ev_code, ev_target, ev_arg,
                ) -> ResourceState:
    """Push one event per lane (where ``ev_mask``) into the outbox ring,
    dropping the oldest on overflow."""
    E = res.ev_code.shape[-1]
    if E == 0:
        return res
    evh, evtl = res.ev_head, res.ev_tail
    overflow = ev_mask & ((evtl - evh) >= E)
    evh = torch.where(overflow, evh + 1, evh)  # drop oldest
    slot = evtl % E
    evc = _scatter3(res.ev_code, slot, ev_mask, ev_code)
    evt = _scatter3(res.ev_target, slot, ev_mask, ev_target)
    eva = _scatter3(res.ev_arg, slot, ev_mask, ev_arg)
    evtl = torch.where(ev_mask, evtl + 1, evtl)
    return res._replace(ev_code=evc, ev_target=evt, ev_arg=eva,
                        ev_head=evh, ev_tail=evtl)


# ---------------------------------------------------------------------------
# the apply kernel
# ---------------------------------------------------------------------------

def _pool_states(res: ResourceState) -> tuple:
    """Each pool's leaves, in pool-id order (``POOL_VALUE`` ..
    ``POOL_TOPIC``)."""
    return ((res.value, res.val_dl),
            (res.map_key, res.map_val, res.map_live, res.map_dl),
            (res.set_key, res.set_live, res.set_dl),
            (res.q_val, res.q_head, res.q_size),
            (res.lk_holder, res.lk_wait_id, res.lk_wait_dl, res.lk_wait_live,
             res.lk_head, res.lk_size),
            (res.el_leader, res.el_epoch, res.el_id, res.el_live, res.el_head,
             res.el_size),
            (res.mm_key, res.mm_val, res.mm_live, res.mm_dl),
            (res.tp_id, res.tp_live))


def _with_pools(res: ResourceState, pools) -> ResourceState:
    """``res`` with every pool's leaves replaced (same order as
    :func:`_pool_states`)."""
    (value, val_dl), (mk, mv, ml, mdl), (sk, sl, sdl), (qv, qh, qs), \
        (holder, wid, wdl, wlv, lh, ls), (el, ep, eid, elv, eh, es), \
        (mmk, mmv, mml, mmdl), (tid, tlv) = pools
    return res._replace(
        value=value, val_dl=val_dl,
        map_key=mk, map_val=mv, map_live=ml, map_dl=mdl,
        set_key=sk, set_live=sl, set_dl=sdl,
        q_val=qv, q_head=qh, q_size=qs,
        lk_holder=holder, lk_wait_id=wid, lk_wait_dl=wdl, lk_wait_live=wlv,
        lk_head=lh, lk_size=ls,
        el_leader=el, el_epoch=ep, el_id=eid, el_live=elv, el_head=eh,
        el_size=es,
        mm_key=mmk, mm_val=mmv, mm_live=mml, mm_dl=mmdl,
        tp_id=tid, tp_live=tlv)


# Each pool kernel behind one signature: (state..., opcode, a, b, c,
# index, now, live) -> (state, result[, events]); by pool id.
POOL_KERNELS = (
    lambda v, dl, op, a, b, c, i, n, lv: apply_value(v, dl, op, a, b, c, n,
                                                     lv),
    lambda mk, mv, ml, md, op, a, b, c, i, n, lv: apply_map(
        mk, mv, ml, md, op, a, b, c, n, lv),
    lambda sk, sl, sd, op, a, b, c, i, n, lv: apply_set(sk, sl, sd, op, a, b,
                                                        c, n, lv),
    lambda qv, qh, qs, op, a, b, c, i, n, lv: apply_queue(qv, qh, qs, op, a,
                                                          b, c, n, lv),
    lambda h, wi, wd, wl, lh, ls, op, a, b, c, i, n, lv: apply_lock(
        h, wi, wd, wl, lh, ls, op, a, b, n, lv),
    lambda el, ep, ei, elv, eh, es, op, a, b, c, i, n, lv: apply_elect(
        el, ep, ei, elv, eh, es, op, a, b, i, lv),
    lambda mk, mv, ml, md, op, a, b, c, i, n, lv: apply_multimap(
        mk, mv, ml, md, op, a, b, c, n, lv),
    lambda ti, tl, op, a, b, c, i, n, lv: apply_topic(ti, tl, op, a, b, n,
                                                      lv),
)
#: the pools whose kernels emit session events
EVENT_POOLS = (POOL_LOCK, POOL_ELECT, POOL_TOPIC)


def apply_entry(
    res: ResourceState,
    opcode: torch.Tensor,  # [G,P] i32
    a: torch.Tensor,       # [G,P] i32
    b: torch.Tensor,       # [G,P] i32
    c: torch.Tensor,       # [G,P] i32
    index: torch.Tensor,   # [G,P] i32 — absolute log index of this entry
    now: torch.Tensor,     # [G,P] i32 — entry's logical timestamp
    live: torch.Tensor,    # [G,P] bool — entry exists and is being applied
) -> tuple[ResourceState, torch.Tensor]:
    """Apply one committed entry per (group, replica) lane through all
    eight pool kernels (an entry belongs to one pool; the others pass
    through unchanged). Returns ``(new_state, result)``, ``result`` the
    int32 command response (meaningful only where ``live``); session
    events are pushed into the state's event ring."""
    pools, result, events = [], None, {}
    for k, st in enumerate(_pool_states(res)):
        out = POOL_KERNELS[k](*st, opcode, a, b, c, index, now, live)
        pools.append(out[0])
        # exactly one pool claims each opcode: results merge by sum
        result = out[1] if result is None else result + out[1]
        if k in EVENT_POOLS:
            events[k] = out[2]
    res = _with_pools(res, pools)

    # grant/elect/topic are mutually exclusive across opcodes: ≤1 event
    ev_lock, ev_el, ev_tp = (events[k] for k in EVENT_POOLS)
    ev_mask = ev_lock[0] | ev_el[0] | ev_tp[0]

    def pick(i):
        return torch.where(ev_lock[0], ev_lock[i],
                           torch.where(ev_el[0], ev_el[i], ev_tp[i]))

    return push_events(res, ev_mask, pick(1), pick(2), pick(3)), result


def push_events_window(res: ResourceState, mask: torch.Tensor,
                       code: torch.Tensor, target: torch.Tensor,
                       arg: torch.Tensor) -> ResourceState:
    """Push a window of per-lane event candidates (``[G,P,A]``, ≤1 event
    per window position, ordered by position = log order) into the outbox
    ring in one scatter per ring array, dropping the oldest entries on
    overflow — the ring the events would leave pushed one at a time."""
    E = res.ev_code.shape[-1]
    if E == 0 or mask.shape[-1] == 0:
        return res
    evh, evtl = res.ev_head, res.ev_tail
    count = mask.sum(dim=-1, dtype=torch.int32)                    # [G,P]
    off = mask.cumsum(dim=-1, dtype=torch.int32) - _i32(mask)      # exclusive
    # If the window carries more events than the ring holds, only the
    # LAST E survive (the drop-oldest outcome of sequential pushes); the
    # survivors land on distinct slots, and every other position goes to
    # a discard column E that is cut off.
    mask = mask & (off >= count[..., None] - E)
    slot = torch.where(mask, (evtl[..., None] + off) % E, E).long()  # [G,P,A]

    def write(ring, vals):
        ext = torch.cat([ring, ring[..., :1]], dim=-1)
        return ext.scatter(-1, slot, vals)[..., :E]

    new_tail = evtl + count
    new_head = torch.maximum(evh, new_tail - E)              # drop-oldest
    return res._replace(
        ev_code=write(res.ev_code, code),
        ev_target=write(res.ev_target, target),
        ev_arg=write(res.ev_arg, arg),
        ev_head=new_head, ev_tail=new_tail)


def _compact(arr: torch.Tensor, dest: torch.Tensor, B: int) -> torch.Tensor:
    """arr[G,P,A] moved to positions ``dest`` ([G,P,A] int64, distinct
    below B, B = discard) of a [G,P,B] tensor; other positions 0."""
    out = arr.new_zeros(arr.shape[:-1] + (B + 1,))
    return out.scatter_(-1, dest, arr)[..., :B]


def _uncompact(by_slot: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """by_slot[G,P,B] read back at positions ``src`` ([G,P,A], B = none →
    0): the inverse of :func:`_compact` at the window positions."""
    ext = torch.cat([by_slot, by_slot.new_zeros(by_slot.shape[:-1] + (1,))],
                    dim=-1)
    return torch.gather(ext, -1, src)


def apply_window(
    res: ResourceState,
    opcode: torch.Tensor,  # [G,P,A] window-position-major entry fields
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    index: torch.Tensor,   # [G,P,A] absolute log indexes (contiguous)
    now: torch.Tensor,     # [G,P,A] entry timestamps
    do: torch.Tensor,      # [G,P,A] bool — within this round's commit budget
    budgets: tuple,        # per-pool applies admitted per round (8, ≥1)
) -> tuple[ResourceState, torch.Tensor, torch.Tensor]:
    """Conflict-partitioned apply of a contiguous window of ≤A entries.

    Entries in different pools commute (disjoint state), so each pool
    folds only ITS entries, compacted to ``budgets[k]`` iterations over
    only that pool's arrays; log order is kept within each pool. The
    admitted window is the longest prefix in which no pool exceeds its
    budget, so a lane never applies entry j before j-1.

    Returns ``(new_res, result [G,P,A], admitted [G,P,A])``, results at
    their window positions; entries not admitted stay pending for the
    next round. Events go back to their window positions and are pushed
    in log order (:func:`push_events_window`).
    """
    A = opcode.shape[-1]
    pool = pool_of(torch.where(do, opcode, -1))  # !do → POOL_NONE
    is_pool = [pool == k for k in range(NUM_POOLS)]

    # Longest prefix in which every pool stays within budget.
    admitted = do
    rank = []
    for k in range(NUM_POOLS):
        cum = is_pool[k].cumsum(dim=-1, dtype=torch.int32)
        rank.append(torch.where(is_pool[k], cum - 1, A))
        if budgets[k] < A:
            admitted = admitted & ~(is_pool[k] & (cum > budgets[k]))
    admitted = admitted.cumprod(dim=-1, dtype=torch.int32).bool()

    fields = (opcode, a, b, c, index, now)
    result = torch.zeros_like(opcode)
    pools, events = [], {}
    for k, st in enumerate(_pool_states(res)):
        B = min(budgets[k], A)
        sel = admitted & is_pool[k]
        if B >= A:
            # the budget covers the window: iterate its positions directly
            pos, live_b, xs = None, sel, fields
        else:
            # pool k's admitted entries hold ranks 0..B-1, distinct
            pos = torch.where(sel, rank[k], B).long()
            live_b = _compact(sel, pos, B)
            xs = tuple(_compact(f, pos, B) for f in fields)
        outs = []
        for i in range(live_b.shape[-1]):
            out = POOL_KERNELS[k](*st, *(x[..., i] for x in xs),
                                  live_b[..., i])
            st = out[0]
            outs.append(out[1:])

        def unpick(per_iter):  # B × [G,P] -> [G,P,A] at window positions
            by_slot = torch.stack(per_iter, dim=-1)
            return by_slot if pos is None else _uncompact(by_slot, pos)

        pools.append(st)
        result = result + unpick([o[0] for o in outs])
        if k in EVENT_POOLS:
            events[k] = [unpick([o[1][j] for o in outs]) for j in range(4)]
    res = _with_pools(res, pools)
    # Merge the event-producing pools by window position (disjoint — an
    # entry belongs to one pool) and push in log order.
    ev = [events[k] for k in EVENT_POOLS]
    res = push_events_window(res, ev[0][0] | ev[1][0] | ev[2][0],
                             *(ev[0][j] + ev[1][j] + ev[2][j]
                               for j in (1, 2, 3)))
    return res, result, admitted


def drain_events(res: ResourceState, n: int, mask: torch.Tensor
                 ) -> tuple[ResourceState, tuple[torch.Tensor, ...]]:
    """Pop up to ``n`` oldest events from each lane's outbox ring where
    ``mask`` ([G] bool — group has an active leader) holds.

    Returns ``(new_state, (seq, code, target, arg, valid))``, each
    ``[G,P,n]``.
    """
    E = res.ev_code.shape[-1]
    G, P = res.ev_head.shape
    dev = res.ev_head.device
    if E == 0 or n == 0:
        z = torch.zeros((G, P, n), dtype=torch.int32, device=dev)
        return res, (z, z, z, z, torch.zeros((G, P, n), dtype=torch.bool,
                                             device=dev))
    evh, evtl = res.ev_head, res.ev_tail
    lane_mask = mask[:, None]
    seqs, codes, targets, args, valids = [], [], [], [], []
    for i in range(n):
        seq = evh + i
        ok = lane_mask & (seq < evtl)
        slot = seq % E
        seqs.append(seq)
        codes.append(torch.where(ok, _gather3(res.ev_code, slot), 0))
        targets.append(torch.where(ok, _gather3(res.ev_target, slot), 0))
        args.append(torch.where(ok, _gather3(res.ev_arg, slot), 0))
        valids.append(ok)
    new_head = torch.where(lane_mask, torch.minimum(evh + n, evtl), evh)
    out = tuple(torch.stack(x, dim=-1) for x in
                (seqs, codes, targets, args, valids))
    return res._replace(ev_head=new_head), out
