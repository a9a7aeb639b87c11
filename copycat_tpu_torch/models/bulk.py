"""Pipelined bulk data plane: client-visible throughput at device scale.

Counterpart of ``copycat_tpu/models/bulk.py``. The queue-managed host
runtime (``RaftGroups.submit``/``run_until``) pays Python per op; this
driver schedules with numpy fancy-indexing end to end (no per-op Python)
and keeps the device busy while the host stages the next round.

Safety against the queue-managed path:

- SAFETY is unconditional: an op is re-sent only if its slot was NOT
  accepted into a leader log (classic mode), or the device's tag gate
  rejects every duplicate (deep mode), so nothing applies twice.
- LIVENESS assumes fault-free delivery: an accepted entry lost to a leader
  change never resolves and ``drive`` raises ``TimeoutError`` after
  ``max_rounds``; :meth:`BulkDriver.recover` re-arms the deep plane once
  the faults have healed.

Two modes, chosen by the engine's ``Config``:

- CLASSIC (default engines): FIFO is host-enforced — a small synchronous
  ``accepted`` fetch per round gates the next window; the large outputs
  are harvested one round behind.
- DEEP (``Config.monotone_tag_accept``): FIFO and dedup are enforced by
  the device's tag gate, so the host dispatches blindly with no device
  synchronisation and collects results from on-device ``[G, B]``
  accumulators (``ops/consensus.deep_step``) in one fetch per drive. The
  blind phase's payload goes up in one host-to-device copy; with
  ``deep_scan=True`` the phase is one :func:`deep_scan` call whose draws
  are all taken first.

Transfers: host-to-device copies start from pageable memory with
``non_blocking=True`` (staged at once, with no stream synchronisation);
every harvest packs its tensors into one buffer and makes one blocking
copy (``raft_groups.fetch``), so numpy never reads a buffer the device is
still writing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.apply import QUERY_OPCODES
from ..ops.consensus import Submits, deep_scan, query_step, step
from .raft_groups import fetch as _fetch


def _scatter(G: int, S: int, gi, slots, vals) -> np.ndarray:
    arr = np.zeros((G, S), np.int32)
    arr[gi, slots] = vals
    return arr


def _upload(arrays, device) -> list[torch.Tensor]:
    """Host arrays and scalars (int32-valued or bool) on ``device`` with
    ONE host-to-device copy; bool arrays come back bool."""
    arrays = [np.asarray(a) for a in arrays]
    flat = np.concatenate([a.astype(np.int32).ravel() for a in arrays])
    dev = torch.from_numpy(flat).to(device, non_blocking=True)
    out, at = [], 0
    for a in arrays:
        t = dev[at:at + a.size].reshape(a.shape)
        out.append(t.bool() if a.dtype == bool else t)
        at += a.size
    return out


def stream_count_from_state(state, fetch=_fetch) -> np.ndarray:
    """[G] max live-ring stream tag per group, from the most-advanced
    lane's log: the device's value of the monotone stream cursor
    (``RaftGroups._stream_count``), used to resync after an abandoned
    drive (election NoOps carry tag 0 and never inflate it)."""
    log_tag, last = fetch((state.log_tag, state.last_index))
    G, _, L = log_tag.shape
    lane = last.argmax(axis=1)                       # [G]
    lt = log_tag[np.arange(G), lane]                 # [G,L]
    ll = last[np.arange(G), lane]                    # [G]
    j = np.arange(L)[None, :]
    idx = ll[:, None] - ((ll[:, None] - (j + 1)) % L)
    in_log = (idx >= 1) & (idx <= ll[:, None])
    return np.where(in_log, lt, 0).max(axis=1).astype(np.int64)


def _window_rank(mask: np.ndarray, starts: np.ndarray, counts: np.ndarray,
                 S: int) -> tuple[np.ndarray, np.ndarray]:
    """First <=S True positions per segment, vectorized: ``mask`` lives in
    group-sorted space with segments ``starts``/``counts``; returns
    ``(positions, slots)``, each slot its position's rank among its
    segment's True entries (FIFO: earlier pending ops outrank later
    ones)."""
    mi = mask.astype(np.int64)
    excl = np.cumsum(mi) - mi
    base = np.repeat(excl[starts], counts)
    rank = excl - base
    sel = mask & (rank < S)
    pos = np.flatnonzero(sel)
    return pos, rank[pos]


def _segments(g_arr: np.ndarray):
    """Stable group order of ``g_arr`` and its segments:
    ``(order, g_sorted, starts, counts)``."""
    order = np.argsort(g_arr, kind="stable")
    g_sorted = g_arr[order]
    first = np.ones(g_arr.size, bool)
    first[1:] = g_sorted[1:] != g_sorted[:-1]
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, g_arr.size))
    return order, g_sorted, starts, counts


class BulkResult:
    """Results and client-observed latency percentiles of one drive."""

    __slots__ = ("results", "rounds", "wall_s", "dispatch_round",
                 "resolve_round")

    def __init__(self, results, rounds, wall_s, dispatch_round,
                 resolve_round) -> None:
        self.results = results
        self.rounds = rounds
        self.wall_s = wall_s
        self.dispatch_round = dispatch_round
        self.resolve_round = resolve_round

    def latency_rounds(self) -> np.ndarray:
        """Per-op submit→result latency in driver rounds (client view)."""
        return self.resolve_round - self.dispatch_round + 1

    def latency_percentiles_ms(self, qs=(50, 99)) -> dict:
        lat = self.latency_rounds().astype(np.float64)
        ms_per_round = self.wall_s * 1e3 / max(1, self.rounds)
        return {f"p{q}": float(np.percentile(lat, q)) * ms_per_round
                for q in qs}


class _EventView:
    """Numpy event leaves with the ``ev_*`` names ``_ingest_events``
    reads."""

    __slots__ = ("ev_seq", "ev_code", "ev_target", "ev_arg", "ev_valid")

    def __init__(self, seq, code, target, arg, valid) -> None:
        self.ev_seq, self.ev_code, self.ev_target = seq, code, target
        self.ev_arg, self.ev_valid = arg, valid


class BulkDriver:
    """Vectorized pipelined driver over one :class:`RaftGroups` batch."""

    def __init__(self, rg, *, allow_sessions: bool = False,
                 deep_scan: bool = False) -> None:
        # Device-session engines need the session tick and cleanup routing
        # the raw bulk loop never performs: the sessioned client
        # (models/session_client.BulkSessionClient) takes that duty and
        # opts in.
        if rg._sessions is not None and not allow_sessions:
            raise NotImplementedError(
                "BulkDriver does not pump device sessions; drive session "
                "engines through models.session_client.BulkSessionClient")
        if deep_scan and not rg.config.monotone_tag_accept:
            raise NotImplementedError(
                "deep_scan needs a monotone-tag engine")
        self._scan = deep_scan
        self._rg = rg

    def drive(self, groups, opcode, a=0, b=0, c=0,
              max_rounds: int = 10_000,
              deliver_schedule=None) -> BulkResult:
        """Commit one op per entry of ``groups`` (scalars broadcast) and
        return all results; ops of one group keep submission order.

        Classic engines: each round every group dispatches its first ≤S
        not-yet-ACCEPTED ops in op order, so a rejected op is re-sent
        before any later op of its group. The round's ``accepted`` array
        is fetched synchronously to drive that rule; the result arrays
        are harvested one round behind. Monotone engines take the deep
        drive; ``deliver_schedule(r)`` (deep only) gives round r's
        delivery mask, the fault-injection seam.
        """
        rg = self._rg
        S = rg.submit_slots
        t0 = time.perf_counter()

        g_arr = np.asarray(groups, np.int64).ravel()
        n = g_arr.size
        bc = lambda x: np.broadcast_to(  # noqa: E731
            np.asarray(x, np.int32).ravel(), (n,)).copy()
        op_a, a_a, b_a, c_a = bc(opcode), bc(a), bc(b), bc(c)
        if rg.config.monotone_tag_accept:
            return self._drive_deep(g_arr, op_a, a_a, b_a, c_a,
                                    max_rounds, t0, deliver_schedule)
        if deliver_schedule is not None:
            raise NotImplementedError(
                "deliver_schedule is a deep-drive feature; classic engines "
                "take faults through rg.deliver and step_round")

        order, _, starts, counts = _segments(g_arr)
        # tags are a reserved contiguous block off the engine's counter,
        # so bulk tags never collide with queue-path tags
        tag0 = rg._next_tag
        rg._next_tag += n
        results = np.zeros(n, np.int64)
        resolved = np.zeros(n, bool)
        accepted_ops = np.zeros(n, bool)
        dispatched = np.zeros(n, bool)
        dispatch_round = np.zeros(n, np.int64)
        resolve_round = np.zeros(n, np.int64)

        def build(r: int):
            """First ≤S unaccepted ops per group, in op order."""
            pos, slots = _window_rank(~accepted_ops[order], starts,
                                      counts, S)
            idx = order[pos]
            sub = rg._empty_submits()
            gi = g_arr[idx]
            sub.opcode[gi, slots] = op_a[idx]
            sub.a[gi, slots] = a_a[idx]
            sub.b[gi, slots] = b_a[idx]
            sub.c[gi, slots] = c_a[idx]
            sub.tag[gi, slots] = (tag0 + idx).astype(np.int32)
            sub.valid[gi, slots] = True
            fresh = ~dispatched[idx]
            dispatch_round[idx[fresh]] = r
            dispatched[idx] = True
            return sub, idx, gi, slots

        def harvest(r: int, raw) -> None:
            (ov, tag_np, res_np, *ev), tel = _fetch((
                (raw.out_valid, raw.out_tag, raw.out_result, raw.ev_seq,
                 raw.ev_code, raw.ev_target, raw.ev_arg, raw.ev_valid),
                raw.telemetry if rg.telemetry is not None else None))
            if tel is not None:
                rg.telemetry.ingest(tel, rg.rounds + r)
            if ov.any():
                tags = tag_np[ov]
                vals = res_np[ov]
                keep = (tags >= tag0) & (tags < tag0 + n)
                t = tags[keep] - tag0
                results[t] = vals[keep]
                newly = ~resolved[t]
                resolve_round[t[newly]] = r
                resolved[t] = True
                # a queue-managed op applied during this drive resolves
                # into rg.results, not behind the bulk tag filter
                for tg, vl in zip(tags[~keep].tolist(),
                                  vals[~keep].tolist()):
                    if tg in rg._inflight_ops:
                        rg._inflight_ops.pop(tg)
                        rg._submit_round.pop(tg, None)
                        placed = rg._tag_index.pop(tg, None)
                        if placed is not None:
                            rg._drop_placement(placed[0], placed[1])
                        rg.results[tg] = vl
            # session events drained by this round reach the host buffer
            # (the device pops its ring as it drains)
            rg._ingest_events(_EventView(*ev))

        inflight: list[tuple[int, object]] = []
        r = 0
        while not resolved.all():
            if r > max_rounds:
                missing = int(n - resolved.sum())
                raise TimeoutError(
                    f"bulk drive: {missing} ops unresolved after "
                    f"{max_rounds} rounds (fault-free liveness assumption"
                    f" violated? use the queue-managed path under faults)")
            sub, idx, gi, slots = build(r)
            fresh, cand = rg._draw_timers()
            rg.state, raw = step(rg.state, rg._to_device(sub), rg.deliver,
                                 fresh, cand, rg.config)
            # small synchronous fetch: acceptance gates the next window
            if idx.size:
                acc = raw.accepted.cpu().numpy()
                accepted_ops[idx[acc[gi, slots]]] = True
            # the result arrays: one round behind
            inflight.append((r, raw))
            if len(inflight) > 1:
                harvest(*inflight.pop(0))
            r += 1
            if resolved.all():
                break
            # drain the pipe when nothing is left to dispatch
            if accepted_ops.all() and inflight:
                harvest(*inflight.pop(0))
        while inflight:
            harvest(*inflight.pop(0))
        rg.rounds += r
        rg.metrics.counter("ops_committed").inc(n)
        return BulkResult(results=results, rounds=r,
                          wall_s=time.perf_counter() - t0,
                          dispatch_round=dispatch_round,
                          resolve_round=resolve_round)

    def drive_queries(self, groups, opcode, a=0, b=0, c=0,
                      consistency: str = "sequential",
                      max_rounds: int = 200) -> np.ndarray:
        """Serve one READ per entry of ``groups`` through the query lane
        (no log append, ``ops/consensus.query_step``) and return results
        aligned with the input.

        ``consistency``: ``"sequential"``/``"causal"``/``"process"`` read
        the leader's applied state; ``"atomic"`` also gates each slot on
        the leader lease (bounded-linearizable). Each pass evaluates every
        pending window of ≤S reads per group against one state, with one
        upload and one fetch; unserved slots retry after a settle round.
        Works on classic and monotone engines alike.
        """
        rg = self._rg
        g_arr = np.asarray(groups, np.int64).ravel()
        n = g_arr.size
        if n == 0:
            return np.zeros(0, np.int64)
        bc = lambda x: np.broadcast_to(  # noqa: E731
            np.asarray(x, np.int32).ravel(), (n,)).copy()
        op_a, a_a, b_a, c_a = bc(opcode), bc(a), bc(b), bc(c)
        bad = set(np.unique(op_a).tolist()) - QUERY_OPCODES
        if bad:
            raise ValueError(
                f"opcodes {sorted(bad)} are not read-only; drive them "
                "as commands")
        levels = ("causal", "process", "sequential", "atomic")
        if consistency not in levels:
            raise ValueError(f"consistency {consistency!r}: one of {levels}")

        S, G = rg.submit_slots, rg.num_groups
        order, g_s, starts, counts = _segments(g_arr)
        vals = tuple(x[order] for x in (op_a, a_a, b_a, c_a))
        # burst-uniform payloads travel as scalars
        consts = [np.int32(x[0]) if (x == x[0]).all() else None
                  for x in vals]
        n_var = sum(k is None for k in consts)
        tag0 = torch.zeros((), dtype=torch.int32, device=rg.device)
        results = np.zeros(n, np.int64)
        done = np.zeros(n, bool)
        want_atomic = consistency == "atomic"
        rounds = 0
        while not done.all():
            if rounds > max_rounds:
                raise TimeoutError(
                    f"bulk queries: {int(n - done.sum())} unserved after "
                    f"{max_rounds} passes")
            # queries never write state: every pending window runs against
            # the same state, and all are fetched together
            windows, host = [], []
            shadow = done.copy()
            while not shadow.all():
                pos, slots = _window_rank(~shadow, starts, counts, S)
                gi = g_s[pos]
                valid = np.zeros((G, S), bool)
                valid[gi, slots] = True
                host.append(valid)
                host += [_scatter(G, S, gi, slots, v[pos])
                         for v, k in zip(vals, consts) if k is None]
                windows.append((pos, gi, slots))
                shadow[pos] = True
                rounds += 1
            staged = iter(_upload(
                host + [np.int32(0) if k is None else k for k in consts],
                rg.device))
            staged_w = [[next(staged) for _ in range(1 + n_var)]
                        for _ in windows]
            const_t = [next(staged) for _ in consts]
            raws = []
            for valid, *var in staged_w:
                var = iter(var)
                op, qa, qb, qc = (t if k is not None else next(var)
                                  for t, k in zip(const_t, consts))
                raws.append(query_step(
                    rg.state, Submits(op, qa, qb, qc, tag0, valid),
                    valid if want_atomic else None, rg.config))
            any_miss = False
            for (pos, gi, slots), (res, served) in zip(windows, _fetch(raws)):
                hit = served[gi, slots]
                results[pos[hit]] = res[gi[hit], slots[hit]]
                done[pos[hit]] = True
                any_miss |= not hit.all()
            if any_miss and not done.all():
                # a consensus step only when a slot went unserved (cold
                # lease, fresh leader, apply lag)
                rg.step_round()
                rounds += 1

        out = np.zeros(n, np.int64)
        out[order] = results
        return out

    def recover(self, settle_rounds: int = 30,
                max_rounds: int = 500) -> None:
        """Re-arm the deep plane after an abandoned drive (TimeoutError).

        Call AFTER healing the faults. Two hazards bracket the tag cursor:
        too LOW, an entry replicated to a minority can still commit and
        alias a fresh op's accumulator slot; too HIGH, an isolated
        leader's accepted burst that a post-heal election erases leaves
        the cursor past a ring that reverted, and every later drive is
        gate-rejected. So: settle, wait until every group's lanes converge
        (same last and applied index, a leader present), then take the
        cursor from the device. On dynamic-membership engines removed
        lanes never converge, so the conservative max-resync is kept.
        """
        rg = self._rg
        for _ in range(settle_rounds):
            rg.step_round()
        if rg.config.dynamic_membership:
            self._resync_stream_count()
            return
        POLL_EVERY = 4
        for _ in range(max_rounds):
            last, applied, role = rg._fetch_acc(
                (rg.state.last_index, rg.state.applied_index, rg.state.role))
            mine = bool((last.min(1) == last.max(1)).all()
                        and (applied.min(1) == applied.max(1)).all()
                        and ((role == 2).sum(1) >= 1).all())
            if mine:
                break
            for _ in range(POLL_EVERY):
                rg.step_round()
        else:
            raise TimeoutError(
                "recover: cluster did not converge — heal every fault "
                "before calling recover()")
        rg._stream_count = stream_count_from_state(rg.state,
                                                   fetch=rg._fetch_acc)

    def _resync_stream_count(self) -> None:
        """Raise each group's stream cursor to the max live-ring tag on
        its most-advanced lane: every tag at or below it was consumed."""
        rg = self._rg
        rg._stream_count = np.maximum(
            rg._stream_count,
            stream_count_from_state(rg.state, fetch=rg._fetch_acc))

    def _drive_deep(self, g_arr, op_a, a_a, b_a, c_a,
                    max_rounds: int, t0: float,
                    deliver_schedule=None) -> BulkResult:
        """Zero-sync pipelined drive for monotone-tag engines.

        Phase 1 dispatches every op exactly once, S per group per round,
        then three settle rounds (replicate, commit, report), with no
        device fetch, and harvests the accumulators in one fetch. Phase 2
        (rare: a lease-cold leader, backpressure) re-dispatches each
        group's unresolved suffix: resolution is a per-group prefix (the
        gate makes acceptance a prefix and applies report in log order),
        and re-sending an accepted op is rejected on the device.
        """
        rg = self._rg
        S, G, dev = rg.submit_slots, rg.num_groups, rg.device
        n = g_arr.size

        order, g_s, starts, counts = _segments(g_arr)
        vals = tuple(x[order] for x in (op_a, a_a, b_a, c_a))
        seg_groups = g_s[starts]
        rank = np.arange(n) - np.repeat(starts, counts)
        seg_base = rg._stream_count[seg_groups]            # [nseg]
        tag_end = rg._global_max_int(
            int((seg_base + counts).max(initial=0)) if n else 0)
        if tag_end > np.iinfo(np.int32).max:
            raise OverflowError(
                "per-group stream exceeds int32 tag space")

        # bookkeeping in SORTED space, unsorted at return; every op's
        # dispatch round is fixed by the blind plan
        resolved = np.zeros(n, bool)
        results = np.zeros(n, np.int64)
        dispatch_round = (rank // S).astype(np.int64)
        resolve_round = np.zeros(n, np.int64)

        # on-device accumulators [G, B] keyed by stream rank, B padded to
        # a power of two
        B = rg._global_max_int(int(counts.max(initial=0)))
        if B == 0:
            z = np.zeros(0, np.int64)
            return BulkResult(results=z, rounds=0, wall_s=0.0,
                              dispatch_round=z, resolve_round=z)
        Bpad = 1 << max(0, B - 1).bit_length()
        # a skewed drive (one group with a huge burst on a large engine)
        # would allocate G * Bpad whatever the total: refuse with advice
        if G * Bpad > 64_000_000:
            raise ValueError(
                f"deep drive accumulators would be [{G}, {Bpad}] "
                f"({G * Bpad / 1e6:.0f}M slots) for {n} ops — burst "
                "sizes are too skewed; split the drive into bursts of "
                "similar per-group size")
        resbuf = rg._stage_acc(np.zeros((G, Bpad), np.int32))
        valbuf = rg._stage_acc(np.zeros((G, Bpad), bool))
        rndbuf = rg._stage_acc(np.full((G, Bpad), 2**30, np.int32))
        evflag = rg._stage_acc(np.zeros(G, bool))
        base_dev = rg._stage_acc(rg._stream_count.astype(np.int32))
        _deep = rg._deep_fn()

        # burst-uniform payload leaves travel as scalars
        consts = [np.int32(x[0]) if (x == x[0]).all() else None
                  for x in vals]
        tel_stash: list = []
        ev_stash: list = []
        rounds0 = rg.rounds
        tel_ingested = 0
        r = 0

        def dispatch(sub: Submits) -> None:
            nonlocal r, resbuf, valbuf, rndbuf, evflag
            dl = (rg.deliver if deliver_schedule is None
                  else torch.as_tensor(deliver_schedule(r), dtype=torch.bool,
                                       device=dev))
            fresh, cand = rg._draw_timers()
            (rg.state, resbuf, valbuf, rndbuf, evflag, out) = _deep(
                rg.state, resbuf, valbuf, rndbuf, evflag, base_dev, r, sub,
                dl, fresh, cand)
            # keep only the event (and telemetry) leaves of the round
            ev_stash.append((out.ev_seq, out.ev_code, out.ev_target,
                             out.ev_arg, out.ev_valid))
            if rg.telemetry is not None:
                tel_stash.append(out.telemetry)
            r += 1

        zero = torch.zeros((), dtype=torch.int32, device=dev)
        idle = Submits(zero, zero, zero, zero,
                       torch.zeros((G, 1), dtype=torch.int32, device=dev),
                       torch.zeros((G, S), dtype=torch.bool, device=dev))

        def harvest() -> None:
            """ONE fetch of the accumulators (and the telemetry)."""
            nonlocal evflag, tel_ingested
            res_np, val_np, rnd_np, ev, tels = rg._fetch_acc(
                (resbuf, valbuf, rndbuf, evflag, tel_stash))
            for tel in tels:
                if tel.elections_started.ndim == 2:
                    rg.telemetry.ingest_stacked(tel, rounds0 + tel_ingested)
                    tel_ingested += tel.elections_started.shape[0]
                else:
                    rg.telemetry.ingest(tel, rounds0 + tel_ingested)
                    tel_ingested += 1
            tel_stash.clear()
            colm = np.arange(Bpad)[None, :] < counts[:, None]
            resolved[:] = val_np[seg_groups][colm]
            results[:] = res_np[seg_groups][colm]
            resolve_round[:] = rnd_np[seg_groups][colm]
            if ev.any():
                # rare path (session-event ops in the burst): fetch the
                # stashed per-round event leaves and ingest them with seq
                # dedup; deep_scan's are stacked [W, ...]
                for leaves in rg._fetch_acc(ev_stash):
                    if leaves[0].ndim == 3:
                        for w in range(leaves[0].shape[0]):
                            rg._ingest_events(
                                _EventView(*(x[w] for x in leaves)))
                    else:
                        rg._ingest_events(_EventView(*leaves))
                evflag = torch.zeros(G, dtype=torch.bool, device=dev)
            ev_stash.clear()

        # phase 1: the blind plan — W windows of S ops per group and three
        # settle rounds — staged as one [W, ...] payload in one copy
        windows = int(np.ceil(B / S))
        if self._scan and deliver_schedule is not None:
            raise NotImplementedError(
                "deep_scan runs the blind phase under ONE deliver mask; "
                "per-round deliver_schedule fault injection needs the "
                "dispatch mode (BulkDriver without deep_scan)")
        W = windows + 3
        tag_w = np.zeros((W, G, 1), np.int32)
        valid_w = np.zeros((W, G, S), bool)
        for w in range(windows):
            tag_w[w, seg_groups, 0] = seg_base + w * S + 1
            valid_w[w][seg_groups] = (w * S + np.arange(S))[None, :] \
                < counts[:, None]
        payload = []
        for v, k in zip(vals, consts):
            if k is None:
                k = np.zeros((W, G, S), np.int32)
                k[rank // S, g_s, rank % S] = v
            payload.append(k)
        tag_t, valid_t, *payload_t = _upload([tag_w, valid_w] + payload, dev)
        plan = Submits(*payload_t, tag_t, valid_t)
        if self._scan:
            (rg.state, resbuf, valbuf, rndbuf, evflag, evs, tels) = \
                deep_scan(rg.state, resbuf, valbuf, rndbuf, evflag,
                          base_dev, plan, rg.deliver, rg._draw_rounds(W),
                          rg.config)
            r = W
            ev_stash.append(evs)
            if rg.telemetry is not None:
                tel_stash.append(tels)
        else:
            for w in range(W):
                dispatch(Submits(*(x[w] if x.dim() else x for x in plan)))
        harvest()

        # phase 2: straggler suffixes, each followed by two settle rounds
        while not resolved.all():
            if r > max_rounds:
                missing = int(n - resolved.sum())
                # tags up to the device's ring max were consumed (some
                # abandoned ops may still commit — at-most-once): resync
                # the cursor so later drives start past them
                self._resync_stream_count()
                raise TimeoutError(
                    f"bulk drive (deep): {missing} ops unresolved after "
                    f"{max_rounds} rounds (fault-free liveness assumption"
                    f" violated? use the queue-managed path under faults); "
                    f"stream cursors resynced from the device")
            fu = np.add.reduceat(resolved.astype(np.int64), starts)
            want = np.minimum(counts - fu, S)
            segs = np.flatnonzero(want > 0)
            reps = want[segs]
            offs = np.arange(reps.sum()) \
                - np.repeat(np.cumsum(reps) - reps, reps)
            pos = np.repeat((starts + fu)[segs], reps) + offs
            tagl = np.zeros((G, 1), np.int32)
            tagl[seg_groups[segs], 0] = seg_base[segs] + fu[segs] + 1
            vnp = np.zeros((G, S), bool)
            vnp[seg_groups] = np.arange(S)[None, :] < want[:, None]
            tag_d, valid_d, *var = _upload(
                [tagl, vnp] + [_scatter(G, S, g_s[pos], offs, v[pos])
                               for v, k in zip(vals, consts) if k is None],
                dev)
            var = iter(var)
            dispatch(Submits(*(x if k is not None else next(var)
                               for x, k in zip(plan, consts)),
                             tag_d, valid_d))
            dispatch(idle)
            dispatch(idle)
            harvest()

        if n:
            rg._stream_count[seg_groups] += counts
        rg.rounds += r
        rg.metrics.counter("ops_committed").inc(n)
        out_res = np.zeros(n, np.int64)
        out_dr = np.zeros(n, np.int64)
        out_rr = np.zeros(n, np.int64)
        out_res[order] = results
        out_dr[order] = dispatch_round
        out_rr[order] = resolve_round
        return BulkResult(results=out_res, rounds=r,
                          wall_s=time.perf_counter() - t0,
                          dispatch_round=out_dr, resolve_round=out_rr)


def drive_batch(rg, groups, opcode, a=0, b=0, c=0,
                max_rounds: int = 10_000) -> BulkResult:
    """Module-level convenience: ``BulkDriver(rg).drive(...)``."""
    return BulkDriver(rg).drive(groups, opcode, a, b, c,
                                max_rounds=max_rounds)
