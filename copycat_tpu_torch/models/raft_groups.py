"""Host runtime around the batched consensus step (torch).

Counterpart of ``copycat_tpu/models/raft_groups.py``: the host owns G
logical Raft groups living on the device and drives them round by round —
queue client ops, step every group once, harvest per-op results by
correlation tag. Exactly-once holds across leader changes: an accepted op
is re-submitted only on proof that it was lost (see :meth:`_harvest`).

This is the serving core: ``submit``/``submit_batch``, ``step_round``
(with snapshot install for stale followers), ``run``, ``run_until``,
``wait_for_leaders``. The fused multi-round program, the query lane,
vector drives, sessions, telemetry, membership changes, meshes and the
metrics registry are not ported yet.
"""

from __future__ import annotations

from collections import Counter, deque

import numpy as np
import torch

from ..device import resolve_device
from ..ops.apply import OP_CFG_ADD, OP_CFG_REMOVE
from ..ops.consensus import (
    Config,
    RaftState,
    StepOutputs,
    Submits,
    check_config,
    draw_timers,
    full_delivery,
    init_state,
    install_snapshots,
    step,
)


def _group_slot_pack(g: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable per-group slot assignment for ``[N]`` rows: returns
    ``(order, gs, slots)`` such that rows taken in ``order`` land at
    ``(gs[i], slots[i])`` of a ``[G, S]`` buffer, with row order within
    a group preserved."""
    order = np.argsort(g, kind="stable")
    gs = g[order]
    n = gs.size
    first = np.ones(n, bool)
    first[1:] = gs[1:] != gs[:-1]
    starts = np.flatnonzero(first)
    cnt = np.diff(np.append(starts, n))
    slots = np.arange(n) - np.repeat(starts, cnt)
    return order, gs, slots


class RaftGroups:
    """G Raft groups × P peers on one device, stepped round by round.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` to run on the CPU. Election timers come from a
    ``torch.Generator`` on that device seeded with ``seed``. The default
    config is the reference's ``Config()``, which hosts every resource
    pool; lock grants, election hand-offs and topic messages arrive in
    ``events``.
    """

    MAX_EVENTS_PER_GROUP = 4096

    def __init__(
        self,
        num_groups: int,
        num_peers: int = 3,
        log_slots: int = 64,
        submit_slots: int = 4,
        config: Config | None = None,
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> None:
        self.num_groups = num_groups
        self.num_peers = num_peers
        self.log_slots = log_slots
        self.submit_slots = submit_slots
        self.config = config or Config()
        check_config(self.config)
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state: RaftState = init_state(
            num_groups, num_peers, log_slots,
            draw_timers(num_groups, num_peers, self.config, self.generator),
            self.config)
        self.deliver = full_delivery(num_groups, num_peers, self.device)
        self._queues: dict[int, deque] = {}
        self._next_tag = 1
        # tag -> (opcode, a, b, c) of every op not yet answered
        self._inflight_ops: dict[int, tuple[int, int, int, int]] = {}
        # exactly-once retry: an op accepted into a leader log can still be
        # LOST — a partitioned leader's unreplicated tail is overwritten by
        # its successor. The host re-submits only on PROOF of loss: once an
        # entry with term T > term_e applies at index j ≤ idx, the pending
        # placement (idx, term_e) can never be in the committed log.
        # group -> {index -> (tag, append term)} — current placements only
        self._placements: dict[int, dict[int, tuple[int, int]]] = {}
        self._tag_index: dict[int, tuple[int, int]] = {}  # tag -> (group, idx)
        # highest post-round leader term per group: while a placement's
        # append term is older, the op's fate is uncertain and the group's
        # queue is HELD, so per-group FIFO completion holds.
        self._leader_term = np.zeros(num_groups, np.int64)
        self._held: set[int] = set()
        self._pend_min: dict[int, int] = {}
        self.results: dict[int, int] = {}    # tag -> result
        self.rounds = 0
        self.counters: Counter = Counter()   # ops_submitted/_committed/...
        self.clock = 0                       # mirrors the device logical clock
        self.events: dict[int, list[tuple[int, int, int, int]]] = {}
        self._ev_seen: dict[int, int] = {}   # group -> highest seq consumed
        # direct-staged submit buffer (submit_batch fast lane)
        self._staged_sub: Submits | None = None

    # -- op submission ---------------------------------------------------

    def _empty_submits(self) -> Submits:
        G, S = self.num_groups, self.submit_slots
        return Submits(opcode=np.zeros((G, S), np.int32),
                       a=np.zeros((G, S), np.int32),
                       b=np.zeros((G, S), np.int32),
                       c=np.zeros((G, S), np.int32),
                       tag=np.zeros((G, S), np.int32),
                       valid=np.zeros((G, S), bool))

    def submit(self, group: int, opcode: int, a: int = 0, b: int = 0,
               c: int = 0) -> int:
        """Queue one op; returns a correlation tag resolved in ``results``."""
        if opcode in (OP_CFG_ADD, OP_CFG_REMOVE):
            raise ValueError("membership changes need "
                             "Config(dynamic_membership=True)")
        tag = self._next_tag
        self._next_tag += 1
        self._queues.setdefault(group, deque()).append((opcode, a, b, c, tag))
        self._inflight_ops[tag] = (opcode, a, b, c)
        self.counters["ops_submitted"] += 1
        return tag

    def submit_batch(self, groups, opcode, a=0, b=0, c=0) -> np.ndarray:
        """Vectorized bulk submit: queue one op per entry of ``groups``
        (scalars broadcast); returns the correlation tags aligned with the
        input."""
        groups_a = np.asarray(groups, np.int64).ravel()
        n = groups_a.size
        bc = lambda x: np.broadcast_to(  # noqa: E731
            np.asarray(x, np.int64).ravel(), (n,))
        op_a, a_a, b_a, c_a = bc(opcode), bc(a), bc(b), bc(c)
        if np.isin(op_a, (OP_CFG_ADD, OP_CFG_REMOVE)).any():
            raise ValueError("membership changes need "
                             "Config(dynamic_membership=True)")
        tags = np.arange(self._next_tag, self._next_tag + n)
        if n == 0:
            return tags
        self._next_tag += n
        tag_l = tags.tolist()
        g_l = groups_a.tolist()
        op_l, a_l, b_l, c_l = (op_a.tolist(), a_a.tolist(),
                               b_a.tolist(), c_a.tolist())
        self._inflight_ops.update(zip(tag_l, zip(op_l, a_l, b_l, c_l)))
        if not self._stage_direct(groups_a, op_a, a_a, b_a, c_a, tags):
            order = np.argsort(groups_a, kind="stable")
            bounds = np.flatnonzero(np.diff(groups_a[order])) + 1
            for seg in np.split(order, bounds):
                seg_l = seg.tolist()
                q = self._queues.setdefault(g_l[seg_l[0]], deque())
                q.extend((op_l[i], a_l[i], b_l[i], c_l[i], tag_l[i])
                         for i in seg_l)
        self.counters["ops_submitted"] += n
        return tags

    def _drop_placement(self, g: int, idx: int) -> None:
        """Remove one placement; prune empty per-group state and
        re-evaluate the group's hold."""
        pend = self._placements.get(g)
        if pend is None:
            return
        pend.pop(idx, None)
        if not pend:
            del self._placements[g]
            self._pend_min.pop(g, None)
            self._held.discard(g)
        elif g in self._held:
            lt = self._leader_term[g]
            if all(te >= lt for _, te in pend.values()):
                self._held.discard(g)

    def _drain_into(self, queues: dict[int, deque], sub: Submits,
                    skip: set[int] | None = None) -> list[tuple[int, int]]:
        """Pop up to ``submit_slots`` queued ops per group into ``sub``;
        returns the (group, slot) pairs filled."""
        placed: list[tuple[int, int]] = []
        ops: list[int] = []
        avs: list[int] = []
        bvs: list[int] = []
        cvs: list[int] = []
        tgs: list[int] = []
        slots = self.submit_slots
        for g, q in list(queues.items()):
            if skip and g in skip:
                continue
            s = 0
            while q and s < slots:
                opcode, a, b, c, tag = q.popleft()
                ops.append(opcode)
                avs.append(a)
                bvs.append(b)
                cvs.append(c)
                tgs.append(tag)
                placed.append((g, s))
                s += 1
            if not q:
                del queues[g]
        if placed:
            rows = np.fromiter((p[0] for p in placed), np.int64, len(placed))
            cols = np.fromiter((p[1] for p in placed), np.int64, len(placed))
            sub.opcode[rows, cols] = ops
            sub.a[rows, cols] = avs
            sub.b[rows, cols] = bvs
            sub.c[rows, cols] = cvs
            sub.tag[rows, cols] = tgs
            sub.valid[rows, cols] = True
        return placed

    def _build_submits(self) -> Submits:
        if self._staged_sub is not None:
            # consume the direct-staged buffer; ops queued after staging
            # are strictly newer and wait one round
            sub = self._staged_sub
            self._staged_sub = None
            return sub
        sub = self._empty_submits()
        if self._queues:
            self._drain_into(self._queues, sub, skip=self._held or None)
        return sub

    def _stage_direct(self, g: np.ndarray, op, a, b, c,
                      tags: np.ndarray) -> bool:
        """Scatter rows straight into the next round's submit buffer.
        Refused (``False`` — the caller takes the queue path) whenever
        ordering could be observable: queued ops exist, holds are active,
        a buffer is already staged, or a group would overflow its submit
        window."""
        if self._queues or self._held or self._staged_sub is not None:
            return False
        counts = np.bincount(g, minlength=self.num_groups)
        if counts.max(initial=0) > self.submit_slots:
            return False
        order, gs, slots = _group_slot_pack(g)
        sub = self._empty_submits()
        sub.opcode[gs, slots] = op[order]
        sub.a[gs, slots] = a[order]
        sub.b[gs, slots] = b[order]
        sub.c[gs, slots] = c[order]
        sub.tag[gs, slots] = tags[order]
        sub.valid[gs, slots] = True
        self._staged_sub = sub
        return True

    # -- stepping ----------------------------------------------------------

    def _draw_timers(self) -> tuple[torch.Tensor, torch.Tensor]:
        """This round's ``(fresh, cand)`` election-timeout draws."""
        G, P = self.num_groups, self.num_peers
        return (draw_timers(G, P, self.config, self.generator),
                draw_timers(G, P, self.config, self.generator))

    def _to_device(self, sub: Submits) -> Submits:
        return Submits(*(torch.from_numpy(x).to(self.device) for x in sub))

    def step_round(self) -> StepOutputs:
        """Advance every group one round; harvests results into
        ``results``. Returns the round's outputs as numpy arrays."""
        submits = self._build_submits()
        fresh, cand = self._draw_timers()
        self.state, raw = step(self.state, self._to_device(submits),
                               self.deliver, fresh, cand, self.config)
        out = StepOutputs(*(None if x is None else x.cpu().numpy()
                            for x in raw))
        self.rounds += 1
        self.counters["rounds"] += 1
        self._requeue_rejected(submits, out)
        self._harvest(out)
        # Placements are recorded AFTER the harvest: an op that committed
        # in the round it was accepted never enters the retry bookkeeping.
        self._record_assigned(submits, out)
        # Followers lagging beyond the ring window can't be served by
        # AppendEntries: install a snapshot of the leader's lane.
        if out.stale.any():
            self.state = install_snapshots(self.state, raw.stale, raw.leader,
                                           self.config)
        return out

    def _record_assigned(self, submits: Submits, out: StepOutputs) -> None:
        """Remember the (log index, term) each accepted queue-managed op
        landed at (its current placement) for provable-loss retry."""
        if not self._inflight_ops:
            return  # everything accepted this round already resolved
        acc = out.accepted
        if not acc.any():
            return
        gi, si = np.nonzero(acc)
        g_l = gi.tolist()
        tag_l = np.asarray(submits.tag)[gi, si].tolist()
        idx_l = out.assigned[gi, si].tolist()
        trm_l = out.assigned_term[gi, si].tolist()
        for k, tag in enumerate(tag_l):
            if tag in self._inflight_ops:
                g = g_l[k]
                old = self._tag_index.get(tag)
                if old is not None:  # superseded placement (re-accept)
                    self._drop_placement(old[0], old[1])
                te = trm_l[k]
                self._placements.setdefault(g, {})[idx_l[k]] = (tag, te)
                self._tag_index[tag] = (g, idx_l[k])
                if te < self._pend_min.get(g, te + 1):
                    self._pend_min[g] = te
                # the accepting leader may have been deposed in the SAME
                # step: engage the hold here
                if te < self._leader_term[g]:
                    self._held.add(g)

    def _requeue_rejected(self, submits: Submits, out: StepOutputs) -> None:
        """Put slots the step rejected (no leader, no lease, backpressure)
        back at the head of their group's queue, in submission order. The
        static path never refuses a slot for good (``out.refused``)."""
        rejected = submits.valid & ~out.accepted
        if not rejected.any():
            return
        # appendleft in REVERSE slot order so retried ops keep submission order
        for g, s in reversed(list(zip(*np.nonzero(rejected)))):
            self._queues.setdefault(int(g), deque()).appendleft(
                (int(submits.opcode[g, s]), int(submits.a[g, s]),
                 int(submits.b[g, s]), int(submits.c[g, s]),
                 int(submits.tag[g, s])))

    def _harvest(self, out: StepOutputs) -> None:
        self.clock = int(out.clock.max(initial=self.clock))
        lt = out.leader_term
        rose = self._placements and bool((lt > self._leader_term).any())
        np.maximum(self._leader_term, lt, out=self._leader_term,
                   casting="unsafe")
        if rose:  # leader changes are rare; only then re-derive holds
            for g, pend in self._placements.items():
                if any(te < self._leader_term[g] for _, te in pend.values()):
                    self._held.add(g)
        valid = out.out_valid
        if valid.any() and (self._inflight_ops or self._placements):
            gi, ii = np.nonzero(valid)
            g_l = gi.tolist()
            tags_l = out.out_tag[gi, ii].tolist()
            res_l = out.out_result[gi, ii].tolist()
            idx_l = out.out_index[gi, ii].tolist()
            term_l = out.out_term[gi, ii].tolist()
            inflight = self._inflight_ops
            results = self.results
            n_done = 0
            for k, tag in enumerate(tags_l):
                g = g_l[k]
                if self._placements:  # retry bookkeeping only when pending
                    j, T = idx_l[k], term_l[k]
                    pend = self._placements.get(g)
                    at_j = pend.get(j) if pend else None
                    if pend and ((at_j is not None and at_j[1] != T)
                                 or T > self._pend_min.get(g, T)):
                        # provable loss: a pending placement (idx, term_e)
                        # can never commit once (a) an entry with term
                        # T > term_e applied at j <= idx, or (b) THIS
                        # index applied under a different term.
                        lost = sorted(
                            (idx, t) for idx, (t, te) in pend.items()
                            if (idx >= j and te < T)
                            or (idx == j and te != T))
                        # appendleft in reverse idx order: co-lost ops
                        # keep their original relative order in the queue
                        for idx, owner in reversed(lost):
                            self._drop_placement(g, idx)
                            self._tag_index.pop(owner, None)
                            if owner in inflight:
                                self._queues.setdefault(
                                    g, deque()).appendleft(
                                    (*self._inflight_ops[owner], owner))
                                self.counters["ops_resubmitted"] += 1
                        pend = self._placements.get(g)
                        if pend:  # refresh the stale lower bound
                            self._pend_min[g] = min(
                                te for _, te in pend.values())
                if tag and tag in inflight:
                    inflight.pop(tag)
                    if self._tag_index:
                        placed = self._tag_index.pop(tag, None)
                        if placed is not None:
                            self._drop_placement(placed[0], placed[1])
                    results[tag] = res_l[k]
                    n_done += 1
            self.counters["ops_committed"] += n_done
        self._ingest_events(out)

    def _ingest_events(self, out: StepOutputs) -> None:
        """Append this round's drained session events to the host buffer
        (dedup by absolute seq)."""
        ev_valid = out.ev_valid
        if not ev_valid.any():
            return
        for g, i in zip(*np.nonzero(ev_valid)):
            g = int(g)
            s = int(out.ev_seq[g, i])
            if s <= self._ev_seen.get(g, -1):
                continue  # re-delivered after a leader change
            self._ev_seen[g] = s
            evs = self.events.setdefault(g, [])
            evs.append((s, int(out.ev_code[g, i]), int(out.ev_target[g, i]),
                        int(out.ev_arg[g, i])))
            if len(evs) > self.MAX_EVENTS_PER_GROUP:
                del evs[: len(evs) - self.MAX_EVENTS_PER_GROUP]

    def run(self, rounds: int) -> None:
        for _ in range(rounds):
            self.step_round()

    def run_until(self, tags, max_rounds: int = 200) -> None:
        """Step until all given tags have results (or raise)."""
        for _ in range(max_rounds):
            if all(t in self.results for t in tags):
                return
            self.step_round()
        missing = [t for t in tags if t not in self.results]
        raise TimeoutError(
            f"ops not committed after {max_rounds} rounds: {missing}")

    def wait_for_leaders(self, max_rounds: int = 100) -> np.ndarray:
        """Step until every group has a leader; returns leader indices [G]."""
        for _ in range(max_rounds):
            out = self.step_round()
            if (out.leader >= 0).all():
                return out.leader
        raise TimeoutError(
            f"not all groups elected a leader in {max_rounds} rounds")

    # -- inspection --------------------------------------------------------

    def leader(self, group: int) -> int:
        role = self.state.role[group].cpu().numpy()
        term = self.state.term[group].cpu().numpy()
        leaders = np.nonzero(role == 2)[0]
        if len(leaders) == 0:
            return -1
        return int(leaders[np.argmax(term[leaders])])

    def value(self, group: int, peer: int = 0) -> int:
        return int(self.state.resources.value[group, peer])
