"""Host runtime around the batched consensus step (torch).

Counterpart of ``copycat_tpu/models/raft_groups.py``: the host owns G
logical Raft groups living on the device and drives them round by round —
queue client ops, step every group once, harvest per-op results by
correlation tag. Exactly-once holds across leader changes: an accepted op
is re-submitted only on proof that it was lost (see :meth:`_harvest`).

Ported: ``submit``/``submit_batch``, ``step_round`` (with snapshot
install for stale followers, and explicit ``submits``/``deliver``),
``step_rounds`` (n rounds with one fetch), ``run``, ``run_until``,
``wait_for_leaders``; the query lane (``submit_query``, ``serve_query``,
``drive_query_vector``); the one-shot vector pump ``drive_vector``;
membership changes (``voters=``, ``add_peer``, ``remove_peer``,
``voting_members``) under ``Config(dynamic_membership=True)``; device
sessions (``sessions``, ``models/sessions.py``); the metrics registry
(``metrics``); the device telemetry hub (``telemetry``,
``device_snapshot``) under ``Config(telemetry=True)`` or
``COPYCAT_TELEMETRY``; monotone-tag engines, which refuse queue-managed
submits and feed the deep bulk plane (``models/bulk.py``) through the
single-host hooks ``_global_max_int``, ``_stage_acc``, ``_fetch_acc``
and ``_deep_fn``. ``models/checkpoint.py`` saves and restores an engine
(state, delivery mask, generator, the host counters and event buffer).
Meshes and the multi-host hooks are not ported.
"""

from __future__ import annotations

from collections import deque
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..ops.apply import FAIL, OP_CFG_ADD, OP_CFG_REMOVE, QUERY_OPCODES
from ..ops.consensus import (
    LEADER,
    Config,
    RaftState,
    StepOutputs,
    Submits,
    deep_step,
    draw_timers,
    full_delivery,
    init_state,
    install_snapshots,
    query_step,
    step,
)
from ..utils.metrics import MetricsRegistry
from .telemetry import DeviceTelemetryHub, telemetry_env_enabled


def _leaves(tree, kind=torch.Tensor) -> list:
    """The ``kind`` leaves of nested tuples, lists and NamedTuples, in
    order (``None`` leaves skipped)."""
    if isinstance(tree, kind):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x, kind)]
    if tree is None:
        return []
    raise TypeError(f"cannot fetch a {type(tree).__name__}")


def _rebuild(tree, leaves, kind=torch.Tensor):
    """``tree`` with its ``kind`` leaves replaced, in order, by the items
    of the iterator ``leaves``."""
    if isinstance(tree, kind):
        return next(leaves)
    if isinstance(tree, list):
        return [_rebuild(x, leaves, kind) for x in tree]
    if isinstance(tree, tuple):
        vals = [_rebuild(x, leaves, kind) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return None


def fetch(tree):
    """A tree of int32 and bool tensors (nested tuples, lists,
    NamedTuples) as the same tree of numpy arrays, with ONE device-to-host
    copy: every leaf goes into one int32 buffer on its device, which is
    copied (and so synchronised) once and split back into leaves of their
    own dtypes. A list of step outputs fetches as one ``StepOutputs`` of
    ``[n, ...]`` leaves."""
    if isinstance(tree, list) and tree and isinstance(tree[0], StepOutputs):
        tree = _rebuild(tree[0], iter(
            [torch.stack(x) for x in zip(*map(_leaves, tree))]))
    leaves = _leaves(tree)
    for x in leaves:
        if x.dtype not in (torch.int32, torch.bool):
            raise TypeError(f"cannot fetch a tensor of dtype {x.dtype}")
    out = []
    if leaves:
        flat = torch.cat([x.reshape(-1).to(torch.int32)
                          for x in leaves]).cpu()
        at = 0
        for x in leaves:
            v = flat[at:at + x.numel()].reshape(x.shape).numpy()
            out.append(v.astype(bool) if x.dtype == torch.bool else v)
            at += x.numel()
    return _rebuild(tree, iter(out))


def _round_of(outs: StepOutputs, i: int) -> StepOutputs:
    """Round ``i`` of outputs fetched stacked ``[n, ...]``."""
    return _rebuild(outs, iter([x[i] for x in _leaves(outs, np.ndarray)]),
                    np.ndarray)


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
    ``events``. ``voters`` (with ``Config(dynamic_membership=True)``)
    starts each group with lanes ``0..voters-1`` voting and the rest as
    standbys. ``state`` starts the engine from a given state (a restored
    checkpoint's) in place of a fresh one. ``COPYCAT_TELEMETRY=1`` or a
    ``COPYCAT_INVARIANTS`` mode
    turns ``Config.telemetry`` on (it never changes the state's
    evolution).
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
        voters: int | None = None,
        state: RaftState | None = None,
    ) -> None:
        self.num_groups = num_groups
        self.num_peers = num_peers
        self.log_slots = log_slots
        self.submit_slots = submit_slots
        self.config = config or Config()
        if not self.config.telemetry and telemetry_env_enabled():
            self.config = self.config._replace(telemetry=True)
        members = None
        if voters is not None:
            if not 0 < voters <= num_peers:
                raise ValueError(f"voters={voters} outside 1..{num_peers}")
            if voters < num_peers and not self.config.dynamic_membership:
                raise ValueError(
                    "voters < num_peers needs Config(dynamic_membership"
                    "=True): the static step tallies all P lanes")
            if voters < num_peers:
                members = np.arange(num_peers) < voters
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # what the reference's PRNGKey(seed) holds; a checkpoint carries it
        # so either package can rebuild the engine's randomness
        self.key = (0, seed & 0xFFFFFFFF)
        self.state: RaftState = state if state is not None else init_state(
            num_groups, num_peers, log_slots,
            draw_timers(num_groups, num_peers, self.config, self.generator),
            self.config, members=members)
        self.deliver = full_delivery(num_groups, num_peers, self.device)
        self._queues: dict[int, deque] = {}
        self._query_queues: dict[int, deque] = {}
        self._query_atomic: set[int] = set()  # tags needing the lease gate
        self._inflight_queries: set[int] = set()
        self._next_tag = 1
        # tag -> (opcode, a, b, c) of every op not yet answered
        self._inflight_ops: dict[int, tuple[int, int, int, int]] = {}
        self._submit_round: dict[int, int] = {}  # tag -> round submitted
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
        self.metrics = MetricsRegistry()     # ops/sec, latency, ...
        # device-plane flight recorder: folds the step's telemetry deltas
        # into the device.* metrics, the flight ring and the invariant
        # monitor
        self.telemetry = (DeviceTelemetryHub(num_groups)
                          if self.config.telemetry else None)
        # monotone-tag engines: per-group count of stream ops committed so
        # far; the next deep drive's dense tags continue from here
        if self.config.monotone_tag_accept:
            self._stream_count = np.zeros(num_groups, np.int64)
        self.clock = 0                       # mirrors the device logical clock
        self.events: dict[int, list[tuple[int, int, int, int]]] = {}
        self._ev_seen: dict[int, int] = {}   # group -> highest seq consumed
        # direct-staged submit buffer (submit_batch fast lane)
        self._staged_sub: Submits | None = None
        self._sessions = None                # lazy DeviceSessionRegistry

    @property
    def sessions(self):
        """Device-path session registry (keep-alives and expiry fan-out
        through the log — see ``models/sessions.py``)."""
        if self._sessions is None:
            from .sessions import DeviceSessionRegistry
            self._sessions = DeviceSessionRegistry(self)
        return self._sessions

    # -- op submission ---------------------------------------------------

    def _empty_submits(self) -> Submits:
        G, S = self.num_groups, self.submit_slots
        return Submits(opcode=np.zeros((G, S), np.int32),
                       a=np.zeros((G, S), np.int32),
                       b=np.zeros((G, S), np.int32),
                       c=np.zeros((G, S), np.int32),
                       tag=np.zeros((G, S), np.int32),
                       valid=np.zeros((G, S), bool))

    def _check_config_ops(self, opcode, a) -> None:
        """Config submits need dynamic membership and a lane in range —
        otherwise they would commit a no-op entry that resolves as a
        silent success."""
        is_cfg = np.isin(opcode, (OP_CFG_ADD, OP_CFG_REMOVE))
        if not is_cfg.any():
            return
        if not self.config.dynamic_membership:
            raise ValueError("membership changes need "
                             "Config(dynamic_membership=True)")
        bad = is_cfg & ((a < 0) | (a >= self.num_peers))
        if bad.any():
            raise ValueError(f"peer {int(np.asarray(a)[bad].flat[0])} "
                             f"outside 0..{self.num_peers - 1}")

    def _refuse_monotone(self) -> None:
        """Monotone-tag engines accept only the bulk plane's dense tag
        streams: a queue-managed submit (whose retries re-send old tags)
        would be rejected by the device gate forever, so refuse it up
        front. Queries never append and stay allowed."""
        if self.config.monotone_tag_accept:
            raise NotImplementedError(
                "queue-managed submits are incompatible with "
                "Config(monotone_tag_accept=True) engines; drive them "
                "through models.bulk.BulkDriver")

    def submit(self, group: int, opcode: int, a: int = 0, b: int = 0,
               c: int = 0) -> int:
        """Queue one op; returns a correlation tag resolved in ``results``."""
        self._check_config_ops(np.asarray(opcode), np.asarray(a))
        self._refuse_monotone()
        tag = self._next_tag
        self._next_tag += 1
        self._queues.setdefault(group, deque()).append((opcode, a, b, c, tag))
        self._inflight_ops[tag] = (opcode, a, b, c)
        self._submit_round[tag] = self.rounds
        self.metrics.counter("ops_submitted").inc()
        return tag

    def submit_batch(self, groups, opcode, a=0, b=0, c=0) -> np.ndarray:
        """Vectorized bulk submit: queue one op per entry of ``groups``
        (scalars broadcast); returns the correlation tags aligned with the
        input. Unlike the reference, rows may carry ``OP_CFG_ADD`` /
        ``OP_CFG_REMOVE`` (a lane in ``a``) on a dynamic-membership
        engine: a membership change for many groups is one call."""
        groups_a = np.asarray(groups, np.int64).ravel()
        n = groups_a.size
        bc = lambda x: np.broadcast_to(  # noqa: E731
            np.asarray(x, np.int64).ravel(), (n,))
        op_a, a_a, b_a, c_a = bc(opcode), bc(a), bc(b), bc(c)
        self._check_config_ops(op_a, a_a)
        self._refuse_monotone()
        tags = np.arange(self._next_tag, self._next_tag + n)
        if n == 0:
            return tags
        self._next_tag += n
        tag_l = tags.tolist()
        g_l = groups_a.tolist()
        op_l, a_l, b_l, c_l = (op_a.tolist(), a_a.tolist(),
                               b_a.tolist(), c_a.tolist())
        self._inflight_ops.update(zip(tag_l, zip(op_l, a_l, b_l, c_l)))
        self._submit_round.update(dict.fromkeys(tag_l, self.rounds))
        if not self._stage_direct(groups_a, op_a, a_a, b_a, c_a, tags):
            order = np.argsort(groups_a, kind="stable")
            bounds = np.flatnonzero(np.diff(groups_a[order])) + 1
            for seg in np.split(order, bounds):
                seg_l = seg.tolist()
                q = self._queues.setdefault(g_l[seg_l[0]], deque())
                q.extend((op_l[i], a_l[i], b_l[i], c_l[i], tag_l[i])
                         for i in seg_l)
        self.metrics.counter("ops_submitted").inc(n)
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
        a buffer is already staged, the engine is monotone (the deep plane
        owns its streams), or a group would overflow its submit window."""
        if (self._queues or self._held or self._staged_sub is not None
                or self.config.monotone_tag_accept):
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

    def _draw_rounds(self, n: int) -> list:
        """The draws of ``n`` rounds, taken before the first of them."""
        return [self._draw_timers() for _ in range(n)]

    def _to_device(self, sub: Submits) -> Submits:
        return Submits(*(torch.as_tensor(x).to(self.device) for x in sub))

    def step_round(self, submits: Submits | None = None,
                   deliver=None) -> StepOutputs:
        """Advance every group one round; harvests results into
        ``results``. Returns the round's outputs as numpy arrays.

        ``submits`` (numpy or tensor leaves) replaces the queued ops for
        this round — the caller owns them, so rejected slots are not
        requeued — and ``deliver [G,P,P]`` replaces ``self.deliver``."""
        explicit = submits is not None
        if submits is None:
            submits = self._build_submits()
        fresh, cand = self._draw_timers()
        dl = self.deliver if deliver is None else torch.as_tensor(
            deliver).to(self.device)
        with self.metrics.timer("step_wall_ms"):
            self.state, raw = step(self.state, self._to_device(submits), dl,
                                   fresh, cand, self.config)
            out = fetch(raw)        # the copy waits for the device
        self.rounds += 1
        self.metrics.counter("rounds").inc()
        if not explicit:
            self._requeue_rejected(submits, out)
        self._harvest(out)
        # Placements are recorded AFTER the harvest: an op that committed
        # in the round it was accepted never enters the retry bookkeeping.
        if not explicit:
            self._record_assigned(submits, out)
        if self._query_queues:
            self._serve_queries()
        # Followers lagging beyond the ring window can't be served by
        # AppendEntries: install a snapshot of the leader's lane.
        if out.stale.any():
            self.state = install_snapshots(self.state, raw.stale, raw.leader,
                                           self.config)
        if self._sessions is not None:
            self._sessions.tick()
        return out

    def step_rounds(self, n: int) -> None:
        """Advance ``n`` rounds with one fetch: the same as ``n``
        ``step_round()`` calls whose rounds 1..n-1 find the submit queues
        empty. Round 0 drains the queues; rounds 1..n-1 run with no
        submits and advance the commit pipeline of what round 0 accepted.
        The timer draws of all n rounds are taken first, the n steps run
        on the device with no host synchronisation between them, and
        their outputs are stacked there and fetched once. Queries are
        served and a snapshot installed (from the last round's view) after
        the n rounds."""
        if n <= 1:
            for _ in range(n):
                self.step_round()
            return
        submits = self._build_submits()
        draws = self._draw_rounds(n)
        sub = self._to_device(submits)
        empty = Submits(*(torch.zeros_like(x) for x in sub))
        raws = []
        with self.metrics.timer("step_wall_ms"):
            for i, (fresh, cand) in enumerate(draws):
                self.state, raw = step(self.state, sub if i == 0 else empty,
                                       self.deliver, fresh, cand,
                                       self.config)
                raws.append(raw)
            outs = fetch(raws)
        for i in range(n):
            out_i = _round_of(outs, i)
            self.rounds += 1
            self.metrics.counter("rounds").inc()
            if i == 0:
                self._requeue_rejected(submits, out_i)
            self._harvest(out_i)
            if i == 0:
                self._record_assigned(submits, out_i)
            if self._sessions is not None:
                self._sessions.tick()
        if self._query_queues:
            self._serve_queries()
        if outs.stale[-1].any():
            self.state = install_snapshots(
                self.state, raws[-1].stale, raws[-1].leader, self.config)

    # -- the query lane ----------------------------------------------------

    def _run_query(self, sub: Submits, atomic: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        results, served = query_step(
            self.state, self._to_device(sub),
            torch.from_numpy(atomic).to(self.device), self.config)
        both = torch.stack([results, served.to(torch.int32)]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def submit_query(self, group: int, opcode: int, a: int = 0, b: int = 0,
                     c: int = 0, consistency: str = "sequential") -> int:
        """Queue a read-only op on the query lane (no log append).

        ``"sequential"`` serves from the leader's applied state;
        ``"atomic"`` also needs the leader lease (bounded-linearizable
        reads without a log entry). Either escalates to the command path
        when the device cannot serve it. Resolves in ``results`` like
        :meth:`submit`."""
        if opcode not in QUERY_OPCODES:
            raise ValueError(
                f"opcode {opcode} is not read-only; submit it as a command")
        if consistency not in ("sequential", "atomic"):
            raise ValueError(f"unknown query consistency {consistency!r}")
        tag = self._next_tag
        self._next_tag += 1
        self._query_queues.setdefault(group, deque()).append(
            (opcode, a, b, c, tag))
        if consistency == "atomic":
            self._query_atomic.add(tag)
        self._inflight_queries.add(tag)
        self.metrics.counter("queries_submitted").inc()
        return tag

    def serve_query(self, group: int, opcode: int, a: int = 0, b: int = 0,
                    c: int = 0, max_attempts: int = 50,
                    consistency: str = "sequential") -> int:
        """Serve ONE read-only op from the leader's applied state, never
        touching the log: while the group cannot serve it (no leader,
        applied < commit, no lease for an atomic read) the engine only
        steps and retries."""
        if opcode not in QUERY_OPCODES:
            raise ValueError(
                f"opcode {opcode} is not read-only; submit it as a command")
        sub = self._empty_submits()
        sub.opcode[group, 0] = opcode
        sub.a[group, 0] = a
        sub.b[group, 0] = b
        sub.c[group, 0] = c
        sub.valid[group, 0] = True
        atomic = np.zeros_like(sub.valid)
        atomic[group, 0] = consistency == "atomic"
        for _ in range(max_attempts):
            results, served = self._run_query(sub, atomic)
            if served[group, 0]:
                self.metrics.counter("queries_served").inc()
                return int(results[group, 0])
            self.step_round()  # no leader yet / applied < commit: settle
        raise TimeoutError(
            f"group {group} query unservable after {max_attempts} rounds")

    def _serve_queries(self) -> None:
        """Drain the query lane: serve from the leader's applied state; a
        slot the device can't serve escalates to the command path (same
        consistency, one log entry)."""
        sub = self._empty_submits()
        placed = self._drain_into(self._query_queues, sub)
        atomic = np.zeros_like(sub.valid)
        for g, s in placed:
            if int(sub.tag[g, s]) in self._query_atomic:
                atomic[g, s] = True
        results, served = self._run_query(sub, atomic)
        escalated = self.metrics.counter("queries_escalated")
        for g, s in placed:
            tag = int(sub.tag[g, s])
            self._query_atomic.discard(tag)
            if served[g, s]:
                if tag in self._inflight_queries:
                    self._inflight_queries.discard(tag)
                    self.results[tag] = int(results[g, s])
                    self.metrics.counter("queries_served").inc()
                continue
            op = (int(sub.opcode[g, s]), int(sub.a[g, s]),
                  int(sub.b[g, s]), int(sub.c[g, s]))
            escalated.inc()
            if self.config.monotone_tag_accept:
                # the command path is closed on monotone engines (the gate
                # would reject the escalated tag forever): retry on the
                # query lane, servable once a leader and lease settle
                self._query_queues.setdefault(g, deque()).append((*op, tag))
                if atomic[g, s]:
                    self._query_atomic.add(tag)
                continue
            # escalate: a quorum-committed read, at least as strong as the
            # level asked for; it joins the loss-retry protocol
            self._inflight_queries.discard(tag)
            self._queues.setdefault(g, deque()).append((*op, tag))
            self._inflight_ops[tag] = op
            self._submit_round[tag] = self.rounds

    def drive_query_vector(self, groups, opcode, a=0, b=0, c=0,
                           atomic=False,
                           max_attempts: int = 50) -> np.ndarray:
        """One-shot vectorized read: stage ``[N]`` read rows into per-group
        slots of ONE :func:`query_step` evaluation (no log append, no
        tags) and return results aligned with the rows. ``atomic``
        (scalar or ``[N]``) marks rows needing the leader lease. Unserved
        rows retry after a settling :meth:`step_round`. The slot width is
        the next power of two of the widest group's row count."""
        g = np.asarray(groups, np.int64).ravel()
        n = g.size
        out = np.zeros(n, np.int64)
        if n == 0:
            return out
        bc = lambda x: np.broadcast_to(  # noqa: E731
            np.asarray(x, np.int32).ravel(), (n,))
        op_a, a_a, b_a, c_a = bc(opcode), bc(a), bc(b), bc(c)
        bad = ~np.isin(op_a, tuple(QUERY_OPCODES))
        if bad.any():
            raise ValueError(
                f"opcode {int(op_a[bad][0])} is not read-only; submit it "
                "as a command")
        at_a = np.broadcast_to(np.asarray(atomic, bool).ravel(), (n,))
        counts = np.bincount(g, minlength=self.num_groups)
        width = int(counts.max(initial=1))
        S = 1 << (width - 1).bit_length()
        G = self.num_groups
        order, gs, slots = _group_slot_pack(g)
        z = np.zeros((G, S), np.int32)
        sub = Submits(opcode=z.copy(), a=z.copy(), b=z.copy(), c=z.copy(),
                      tag=z.copy(), valid=np.zeros((G, S), bool))
        sub.opcode[gs, slots] = op_a[order]
        sub.a[gs, slots] = a_a[order]
        sub.b[gs, slots] = b_a[order]
        sub.c[gs, slots] = c_a[order]
        sub.valid[gs, slots] = True
        at = np.zeros((G, S), bool)
        at[gs, slots] = at_a[order]
        done = np.zeros(n, bool)
        for _ in range(max_attempts):
            results, served = self._run_query(sub, at)
            hit = served[gs, slots] & ~done[order]
            if hit.any():
                rows = order[hit]
                out[rows] = results[gs[hit], slots[hit]]
                done[rows] = True
                self.metrics.counter("queries_served").inc(int(hit.sum()))
                sub.valid[gs[hit], slots[hit]] = False
            if done.all():
                self.metrics.counter("query_vector_drives").inc()
                return out
            self.step_round()  # no leader yet / applied < commit: settle
        raise TimeoutError(
            f"query vector: {int((~done).sum())}/{n} rows unservable "
            f"after {max_attempts} attempts")

    # -- the vector pump ---------------------------------------------------

    def drive_vector(self, groups, opcode, a, b, c,
                     max_rounds: int = 200) -> np.ndarray | None:
        """One-shot vectorized drive: stage every row straight into the
        next round's submits, step until all rows committed, and correlate
        results from the step outputs in one numpy pass a round — no
        per-op tags tracked. Returns results aligned with the rows, or
        ``None`` when direct staging is refused (queued ops, holds, a
        staged buffer, an overfull group) and the caller must take
        :meth:`submit_batch`. A row refused for good resolves to
        ``FAIL``."""
        g = np.asarray(groups, np.int64)
        n = g.size
        tags = np.arange(self._next_tag, self._next_tag + n)
        if not self._stage_direct(g, np.asarray(opcode, np.int64),
                                  np.asarray(a, np.int64),
                                  np.asarray(b, np.int64),
                                  np.asarray(c, np.int64), tags):
            return None
        self._next_tag += n
        tag0 = tags[0] if n else 0
        res = np.zeros(n, np.int64)
        done = np.zeros(n, bool)
        self.metrics.counter("ops_submitted").inc(n)
        remaining = n
        for _ in range(max_rounds):
            out = self.step_round()
            valid = out.out_valid
            if valid.any():
                gi, ii = np.nonzero(valid)
                t = out.out_tag[gi, ii]
                mine = (t >= tag0) & (t < tag0 + n)
                if mine.any():
                    k = (t[mine] - tag0).astype(np.int64)
                    fresh = ~done[k]
                    k = k[fresh]
                    res[k] = out.out_result[gi, ii][mine][fresh]
                    done[k] = True
                    remaining -= k.size
            if remaining and self.results:
                # rows refused for good were recorded as FAIL by
                # _requeue_rejected: resolve them so the drive returns
                for t in [t for t in self.results if tag0 <= t < tag0 + n]:
                    k = int(t - tag0)
                    v = self.results.pop(t)
                    if not done[k]:
                        res[k] = v
                        done[k] = True
                        remaining -= 1
            if remaining == 0:
                self.metrics.counter("ops_committed").inc(n)
                return res
        raise TimeoutError(
            f"vector drive: {remaining}/{n} rows uncommitted after "
            f"{max_rounds} rounds")

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
        """Put slots the step rejected (no leader, no lease, backpressure,
        a config change in flight) back at the head of their group's
        queue, in submission order. A slot refused for good (a config
        change that would empty the group) fails to the client at once:
        requeued, it would block its group's queue forever."""
        valid = np.asarray(submits.valid)
        refused = out.refused & valid
        if refused.any():
            for g, s in zip(*np.nonzero(refused)):
                tag = int(submits.tag[g, s])
                # recorded for untracked tags too (drive_vector's rows)
                self.results[tag] = FAIL
                self.metrics.counter("ops_refused").inc()
                self._inflight_ops.pop(tag, None)
                self._submit_round.pop(tag, None)
        rejected = valid & ~out.accepted & ~out.refused
        if not rejected.any():
            return
        # appendleft in REVERSE slot order so retried ops keep submission order
        for g, s in reversed(list(zip(*np.nonzero(rejected)))):
            self._queues.setdefault(int(g), deque()).appendleft(
                (int(submits.opcode[g, s]), int(submits.a[g, s]),
                 int(submits.b[g, s]), int(submits.c[g, s]),
                 int(submits.tag[g, s])))

    def _harvest(self, out: StepOutputs) -> None:
        if self.telemetry is not None and out.telemetry is not None:
            self.telemetry.ingest(out.telemetry, self.rounds)
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
            latency = self.metrics.histogram("commit_latency_rounds")
            resubmitted = self.metrics.counter("ops_resubmitted")
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
                                resubmitted.inc()
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
                    at = self._submit_round.pop(tag, None)
                    if at is not None:
                        latency.record(self.rounds - at)
            if n_done:
                self.metrics.counter("ops_committed").inc(n_done)
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

    # -- cluster membership (server join and leave) ------------------------

    def add_peer(self, group: int, peer: int) -> int:
        """Add ``peer``'s lane to ``group``'s voter set: a single-server
        config change through the log. Returns a tag that resolves once
        the entry applies (config changes are serialized per group; an
        early one is rejected and requeued)."""
        return self.submit(group, OP_CFG_ADD, peer)

    def remove_peer(self, group: int, peer: int) -> int:
        """Remove ``peer``'s lane from ``group``'s voter set. Removing the
        last member is refused: the tag resolves to ``FAIL``. A leader
        removing itself commits the change and then steps down."""
        return self.submit(group, OP_CFG_REMOVE, peer)

    @staticmethod
    def _config_mask(member: np.ndarray, applied: np.ndarray,
                     term: np.ndarray, role: np.ndarray) -> int:
        """Freshest applied config bitmask among one group's [P] lanes:
        the current leader's (it serializes config changes), unless a
        higher term exists (a partitioned stale leader), else the
        most-applied lane's."""
        leaders = np.nonzero(role == LEADER)[0]
        if len(leaders):
            lead = int(leaders[np.argmax(term[leaders])])
            if term[lead] == term.max():
                return int(member[lead])
        return int(member[int(np.argmax(applied))])

    def config_masks(self) -> np.ndarray:
        """:meth:`_config_mask` of every group at once, ``[G]`` int."""
        s = self.state
        member, applied, term, role = (
            x.cpu().numpy() for x in (s.member, s.applied_index, s.term,
                                      s.role))
        lead_term = np.where(role == LEADER, term, -1)
        lead = np.argmax(lead_term, axis=1)
        g = np.arange(len(member))
        by_leader = (lead_term[g, lead] >= 0) \
            & (term[g, lead] == term.max(axis=1))
        lane = np.where(by_leader, lead, np.argmax(applied, axis=1))
        return member[g, lane]

    def voting_members(self, group: int) -> list[int]:
        """Current voter lanes of ``group`` (see :meth:`_config_mask`)."""
        s = self.state
        mask = self._config_mask(*(x[group].cpu().numpy() for x in (
            s.member, s.applied_index, s.term, s.role)))
        return [p for p in range(self.num_peers) if (mask >> p) & 1]

    # -- the deep bulk plane's hooks (single host) -------------------------

    def _global_max_int(self, v: int) -> int:
        """Max of ``v`` across processes: ``v`` on one host."""
        return v

    def _stage_acc(self, arr: np.ndarray) -> torch.Tensor:
        """A group-leading host array on the engine's device (a deep
        drive's accumulator)."""
        return torch.from_numpy(arr).to(self.device)

    def _fetch_acc(self, arrays):
        """A tree of group-leading device tensors as numpy, in one copy."""
        return fetch(arrays)

    def _deep_fn(self):
        """:func:`~copycat_tpu_torch.ops.consensus.deep_step` at this
        engine's config (the scatter form)."""
        return partial(deep_step, config=self.config)

    # -- inspection --------------------------------------------------------

    def device_snapshot(self) -> dict:
        """The ``device.*`` telemetry family as a snapshot dict (empty when
        telemetry is off)."""
        if self.telemetry is None:
            return {}
        return self.telemetry.snapshot()

    def leader(self, group: int) -> int:
        role = self.state.role[group].cpu().numpy()
        term = self.state.term[group].cpu().numpy()
        leaders = np.nonzero(role == 2)[0]
        if len(leaders) == 0:
            return -1
        return int(leaders[np.argmax(term[leaders])])

    def value(self, group: int, peer: int = 0) -> int:
        return int(self.state.resources.value[group, peer])
