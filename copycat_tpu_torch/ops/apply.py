"""Vectorized state-machine apply, the counter slice (torch).

Counterpart of ``copycat_tpu/ops/apply.py`` for the resource layout that
``ResourceConfig.counters_only()`` selects: value/long registers, with
every other pool at zero slots. The full opcode catalog is kept, so a
zero-slot pool answers its opcodes with ``FAIL`` exactly as the reference
does; the lock and election pools keep their holder/leader registers,
which change even with no wait queue. A pool given slots raises
``NotImplementedError`` naming the pool — it never answers wrongly.

Every leaf is ``[G, P, ...]`` int32 or bool; results keep the reference's
dtype and int32 wraparound.
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
    """Fixed device pool sizes. This slice runs pools at 0 slots, apart
    from the event ring; any other pool given slots raises at apply."""

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
              value: torch.Tensor) -> torch.Tensor:
    """Masked write of value[G,P] into arr[G,P,N] at slot[G,P]."""
    N = arr.shape[-1]
    ids = torch.arange(N, dtype=torch.int32, device=arr.device)
    hit = (ids[None, None, :] == slot[..., None]) & mask[..., None]
    return torch.where(hit, value[..., None], arr)


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


def _unported(pool: str, slots: int) -> NotImplementedError:
    return NotImplementedError(
        f"the {pool} pool with {slots} slots is not ported to "
        "copycat_tpu_torch yet; use ResourceConfig.counters_only()")


# ---------------------------------------------------------------------------
# per-pool apply kernels
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
    result = torch.where(is_cas, cas_hit.to(torch.int32), result)
    result = torch.where(is_gas, eff, result)
    result = torch.where(is_add, eff + a, result)
    return (out_value, out_dl), result


def _zero_slot_pool(name, slots, lo, hi, opcode, live):
    """Result of a zero-slot pool: ``FAIL`` for its own opcodes."""
    if slots:
        raise _unported(name, slots)
    hit = live & (opcode >= lo) & (opcode <= hi)
    return torch.where(hit, INT_MIN, torch.zeros_like(opcode))


def apply_map(mk, mv, ml, mdl, opcode, a, b, c, now, live):
    """Hashed probe-table map; returns ((mk, mv, ml, mdl), result)."""
    result = _zero_slot_pool("map", mk.shape[-1], OP_MAP_PUT, OP_MAP_CLEAR,
                             opcode, live)
    return (mk, mv, ml, mdl), result


def apply_set(sk, sl, sdl, opcode, a, b, c, now, live):
    """Probe-table set; returns ((sk, sl, sdl), result)."""
    result = _zero_slot_pool("set", sk.shape[-1], OP_SET_ADD, OP_SET_CLEAR,
                             opcode, live)
    return (sk, sl, sdl), result


def apply_queue(qv, qh, qs, opcode, a, b, c, now, live):
    """FIFO ring queue; returns ((qv, qh, qs), result)."""
    result = _zero_slot_pool("queue", qv.shape[-1], OP_Q_OFFER, OP_Q_CLEAR,
                             opcode, live)
    return (qv, qh, qs), result


def _no_events(opcode, live):
    z = torch.zeros_like(opcode)
    return (torch.zeros_like(live), z, z, z)


def apply_lock(holder, wid, wdl, wlv, lh, ls, opcode, a, b, now, live):
    """Lock register with no wait queue (try-lock only); returns
    ((holder, wid, wdl, wlv, lh, ls), result, (ev_mask, ev_code,
    ev_target, ev_arg))."""
    if wid.shape[-1]:
        raise _unported("lock wait", wid.shape[-1])

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
    holder = torch.where(do_rel, -1, holder)
    result = torch.where(acq, (grant_now | idem).to(torch.int32), result)
    result = torch.where(cxl, held_by_me.to(torch.int32) * 2, result)
    result = torch.where(rel, do_rel.to(torch.int32), result)
    result = torch.where(op(OP_LOCK_HOLDER), holder, result)
    return (holder, wid, wdl, wlv, lh, ls), result, _no_events(opcode, live)


def apply_elect(el, ep, eid, elv, eh, es, opcode, a, b, index, live):
    """Leader-election register with no listener queue; returns
    ((el, ep, eid, elv, eh, es), result, (ev_mask, ev_code, ev_target,
    ev_arg))."""
    if eid.shape[-1]:
        raise _unported("election listener", eid.shape[-1])

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
    el = torch.where(do_res, -1, el)
    result = torch.where(listen, torch.where(
        win_now, index, torch.where(am_leader, ep, INT_MIN)), result)
    result = torch.where(resign, do_res.to(torch.int32), result)
    result = torch.where(op(OP_ELECT_IS_LEADER),
                         (am_leader & (ep == b)).to(torch.int32), result)
    result = torch.where(op(OP_ELECT_LEADER), el, result)
    result = torch.where(op(OP_ELECT_GET_EPOCH), ep, result)
    return (el, ep, eid, elv, eh, es), result, _no_events(opcode, live)


def apply_multimap(mk, mv, ml, mdl, opcode, a, b, c, now, live):
    """(key, value)-pair probe table; returns ((mk, mv, ml, mdl), result)."""
    result = _zero_slot_pool("multimap", mk.shape[-1], OP_MM_PUT,
                             OP_MM_CLEAR, opcode, live)
    return (mk, mv, ml, mdl), result


def apply_topic(tid, tlive, opcode, a, b, now, live):
    """Topic subscriber table; returns ((tid, tlive), result, (ev_mask,
    ev_code, ev_target, ev_arg))."""
    result = _zero_slot_pool("topic", tid.shape[-1], OP_TOPIC_LISTEN,
                             OP_TOPIC_COUNT, opcode, live)
    return (tid, tlive), result, _no_events(opcode, live)


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
    """Apply one committed entry per (group, replica) lane; returns
    ``(new_state, result)``, ``result`` the int32 command response
    (meaningful only where ``live``)."""
    (value, val_dl), r_val = apply_value(
        res.value, res.val_dl, opcode, a, b, c, now, live)
    _, r_map = apply_map(res.map_key, res.map_val, res.map_live, res.map_dl,
                         opcode, a, b, c, now, live)
    _, r_set = apply_set(res.set_key, res.set_live, res.set_dl,
                         opcode, a, b, c, now, live)
    _, r_q = apply_queue(res.q_val, res.q_head, res.q_size,
                         opcode, a, b, c, now, live)
    (holder, *_), r_lock, ev_lock = apply_lock(
        res.lk_holder, res.lk_wait_id, res.lk_wait_dl, res.lk_wait_live,
        res.lk_head, res.lk_size, opcode, a, b, now, live)
    (el, ep, *_), r_el, ev_el = apply_elect(
        res.el_leader, res.el_epoch, res.el_id, res.el_live,
        res.el_head, res.el_size, opcode, a, b, index, live)
    _, r_mm = apply_multimap(res.mm_key, res.mm_val, res.mm_live, res.mm_dl,
                             opcode, a, b, c, now, live)
    _, r_tp, ev_tp = apply_topic(res.tp_id, res.tp_live, opcode, a, b, now,
                                 live)

    # exactly one pool claims each opcode, so results merge by sum of the
    # disjoint contributions
    result = r_val + r_map + r_set + r_q + r_lock + r_el + r_mm + r_tp

    res = res._replace(value=value, val_dl=val_dl, lk_holder=holder,
                       el_leader=el, el_epoch=ep)

    # grant/elect/topic are mutually exclusive across opcodes: ≤1 event
    ev_mask = ev_lock[0] | ev_el[0] | ev_tp[0]

    def pick(i):
        return torch.where(ev_lock[0], ev_lock[i],
                           torch.where(ev_el[0], ev_el[i], ev_tp[i]))

    return push_events(res, ev_mask, pick(1), pick(2), pick(3)), result


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
