"""Smoke run of copycat_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. card and build — the card's name and power limit, then the kernel
   libraries built from every ``copycat_tpu_torch/csrc/*.cu`` source, one
   ``nvcc`` each, all at once;
2. kernel — each kernel against its plain torch version on the card, bit
   for bit: the quorum tally ``kth_largest`` over G ∈ {10,000, 100,000,
   1,001}, P ∈ {3, 5, 7}, k ∈ {P//2+1, 1, P}, with duplicate rows and
   INT_MIN lanes; the fused phase kernels ``admit_submits`` and
   ``ack_commit`` over the same G and P, and at the mixed bench's shape
   (G=100,000, P=5, S=16, L=32), on ``copycat_tpu_torch/cases.py``'s
   inputs (leaderless groups, commit candidate 0, candidates below the
   ring's window, stale leaders, duplicate matchIndex values, submits all
   refused by backpressure), each static and member-masked (random views
   from one member to every lane, the leader outside its own view); at P
   = 3 and 5 on ``cases.EDGE_SHAPES`` (G = 1, 31, 10,001 and 100,003; S =
   1, 4, 16, 17 and 256; L = 1; and the shapes that take phase 1's four
   slots a thread in tiles of 1, 2, 4 and 32 threads, the last over three
   steps), each aligned and with every input one element past the start
   of its storage; plus the floor-mod and first-index argmax the step
   relies on;
3. counter path — the consensus step on the card (fused kernels) and on
   the CPU (plain versions) from one state and one set of timer draws,
   G=1,000, P=3, L=64, S=16, counters only, 50 rounds under random
   partitions: every state and output leaf equal every round, and one
   launch of each fused kernel per card round;
4. mixed path — the same at G=1,000, P=5, L=32, S=16 with every resource
   pool (``ResourceConfig()``), ``pool_budgets=(4,6,4,6,4,4,4,4)`` and
   opcodes drawn from the whole catalog, 40 rounds, one lane per group
   isolated in rounds 10-29 so that snapshots get installed;
5. membership path — the same at G=10,000 × P=5 with 3 voters, dynamic
   membership, the mixed pools and budgets, L=32, 40 rounds of counter
   traffic beside a scripted churn (add lane 3, add lane 4, remove voter
   1, remove the leader's own lane);
6. counter serve — ``RaftGroups(10_000, 3, log_slots=64,
   submit_slots=16)`` with counters only elects leaders and answers a few
   hundred ``OP_LONG_ADD`` requests, each checked against its running
   sum; the fused kernels' launch counts, zeroed just before, must rise;
7. pool serve — the same engine at the default config (every pool)
   answers map put/get, queue offer/offer/poll, the lock chain (acquire
   1; acquire 2 queued; release 1 hands the lock to 2 with an
   ``EV_LOCK_GRANT`` event) and the election chain (listen 4 wins; listen
   5 waits; resign 4 hands over to 5 with an ``EV_ELECT`` event carrying
   the epoch) on a few hundred groups, each answer and event checked
   against a plain Python model;
8. membership serve — ``RaftGroups`` at BASELINE #5's width (G=100,000 ×
   P=5, 3 voters, L=32, S=16, the mixed config and budgets, flow control
   on): every group adds lanes 3 and 4, then removes lane 0, each change
   one ``submit_batch`` for all groups beside a counter op per group;
   exactly-once counters, every group voting with lanes {1, 2, 3, 4}, no
   diverged replicas, one launch of each fused kernel a round; then the
   member-masked kernels timed on its step's inputs, and a profiler
   window of its rounds;
9. engine extras at G=10,000 × P=5, mixed config: ``step_rounds(8)``
   against eight ``step_round()`` calls on the same draws,
   ``drive_vector`` against the per-group prefix sums, and a crashed lock
   holder's session expiring so that its lock passes to the queued
   waiter;
10. counter bench — the counter bench at full width (G=10,000 × P=3 × L=64
    × S=16), 100 rounds × 3 (the reference runs 200 × 5), one launch of
    each fused kernel per round; each kernel's time per call beside its
    plain version, a library call computing the same function where there
    is one, and its bound — the fused kernels on the inputs the bench's
    step gives them, and on a counter step at the server engine's width
    (G=10,000, L=64, S=4) and at spi's (G=1,024, L=16, S=4); then a short
    ``torch.profiler`` window of the same step: kernel time, the device's
    idle share and launches per round;
11. mixed bench — BASELINE config #5 at full width (G=100,000 × P=5 ×
    L=32 × S=16) under the partition nemesis, budgets 4,6,4,6,4,4,4,4,
    timers 2-4, 100 rounds × 2 repetitions (the reference runs 200 ×
    5): committed ops/s, ms/round, p50/p99 commit latency, one
    launch of each fused kernel per round, and replicas at equal applied
    index holding equal resource leaves; the fused kernels timed on the
    mixed step's inputs; the apply's time per round; a profiler window;
12. short map and lock benches at G=10,000 × P=3 × L=64 with their
    budgets, and a profiler window of the map round;
13. query lane — the ``map_read`` cell (G=10,000 × P=3 × L=64, 16 puts
    through the log and 16 gets through ``query_step`` per group and
    round) at both read levels, every served get checked against the
    value the puts wrote, 30 rounds × 2;
14. elections — the ``election`` cell (G=1,000 × P=3, isolation nemesis
    with period 15, seed 2, 100 rounds × 3), with no term of any group
    led by two lanes;
15. deep path — ``deep_scan`` on the card and on the CPU from one state
    and one set of draws, G=1,000 × P=3, L=64, S=16, counters only,
    telemetry on, the monotone tag gate, 8 windows of dense tags and 3
    settle rounds under random message loss: every state, accumulator,
    event and telemetry leaf equal, one launch of each fused kernel a
    round;
16. host bench — the reference's north-star cell through ``BulkDriver``:
    G=10,000 × P=3 × L=64 × S=16, counters only, 128 ops per group a
    drive (1.28M ops), a warm-up and 5 timed drives in each of the modes
    ``deep``, ``deepscan`` and ``bulk``, and ``queued`` at 16 ops per
    group; after each, every group's counter equals the ops committed to
    it (exactly once), and each fused kernel launched once a round; one
    ``deep`` drive with telemetry on, whose summed ``commit_advance``
    covers the drive with no invariant violation; a profiler window of
    one deep drive (idle share, launches per round);
17. ``host_read`` — 128 reads per group at both read levels, every read
    7; ``session`` — 16 sessions, 128 ops per group a flush, group 0's
    counter exactly once;
18. wide kernels — the warp-tile path (P > 8) of every quorum kernel:
    ``RaftGroups(10_000, 9)`` and ``(10_000, 16)``, and ``(10_000, 9)``
    with 5 voters under dynamic membership adding lane 5, serving a
    counter op per group (S=4); ``admit_submits`` and ``ack_commit``
    against their plain versions on the arguments each serve's step gave
    them, and timed there beside their plain versions and bounds; the
    same on drawn inputs at G = 10,000 (S = 16) and 1,001 (S = 5); at P =
    16 (masked), 32 (static and masked) and 33 (static) on drawn inputs
    alone, timed on those at G = 10,000; and ``kth_largest`` on drawn
    rows, equal to its plain version bit for bit at P = 9, 16, 17, 32,
    33, 64 and 130, G = 10,000 and 1,001, k = 1, P // 2 + 1 and P, and
    timed beside ``torch.topk`` at each of them (G = 10,000, k = P // 2 +
    1);
19. checkpoint — the mixed cell's engine (G=100,000 × P=5, L=32, six
    pools, budgets, flow control) after 20 rounds under the nemesis,
    saved with ``save_bytes`` and loaded onto the card: every leaf equal,
    then 10 more rounds of the original and the restored engine with the
    same deliver masks, every state and output leaf equal (the generator
    restored); the blob's size and the save and load times; a monotone
    engine at the host cell's shape restored between two deep drives,
    its stream cursor rebuilt and the second drive exactly once;
20. facades — value, long, map, set, queue, multimap, topic (a fan-out
    to two subscribers), lock (a two-holder hand-off through the grant
    event) and election (a hand-off on resign), each on its own group of
    one ``RaftGroups(10_000, 3)`` at the default config (S=4), with the
    answers of the reference's facade tests; the fused kernels against
    their plain versions on the arguments of one of its steps;
21. verdict — ``run_verdict`` at the reference's width (G=10,000, 5
    lanes, 3 voters, churn, nemesis period 12) cut to 150 rounds and 30
    sampled groups, then ``run_deep_verdict`` at 2,000 groups cut to 8
    epochs: every history linearizable, no invariant violation; each
    verdict's fused kernels (member-masked under churn, static in the deep
    plane; S=4) against their plain versions on its last step's
    arguments;
22. server — three port ``AtomixServer(executor="tpu")`` in one process
    over the port's ``LocalTransport``, each engine
    ``DeviceEngineConfig(capacity=10_000, num_peers=3, log_slots=64,
    submit_slots=4)`` (every pool, on the card), and two
    ``AtomixClient``s: 1,000 device resources (500 longs, 200 maps, 100
    sets, 100 queues, 50 locks, 50 elections), each a ``Device*State``
    machine on a group below capacity on every server; 200
    ``add_and_get`` on 100 never-set longs (the CAS host path an unset
    register takes), the other longs set to 0, then 10,000 ``add_and_get``
    1,000 in flight (two on each long: the client's CAS-retry loop under
    contention, through the vector pump), 1,000 map puts and
    1,000 gets (the read pump), set adds and contains, queue offers, polls
    and peeks, a lock hand-off between the clients on every lock and a
    succession on every election, each answer and event checked against a
    plain model; server 0's manager snapshot restored into a fresh server
    whose engine reads the same; every engine's replica read through
    ``run_query_vector`` equal to the model; 100 longs deleted and 100
    created on exactly the freed groups, reading 0; one launch of each
    fused kernel per server-engine round, and both against their plain
    versions on the arguments of a server step; a profiler window of the
    server engines' rounds;
23. public_api — the bench's public-API scenarios, each through one port
    ``AtomixServer(executor="tpu")`` and its clients: ``spi`` at its
    defaults (1,000 ``DistributedAtomicLong``s, 5 bursts of one
    ``add_and_get`` each), ``readmix`` (1,000 instances, ``atomic``, 3
    bursts of one write and nine reads each) and ``apply`` at its defaults
    (4 Raft groups on one engine, 24 sessions, 48 ``get_and_set`` each a
    burst over 256 zipfian keys beside host-shadow sets, 5 bursts); every
    counter reads its bursts, every read the write before it, and every
    key's writes form one chain (each applied once); one launch of each
    fused kernel per engine round and none of the tally; both fused
    kernels against their plain versions on each scenario's last step;
    ops/s (reads/s), p50/p99 ms, engine rounds and wall time printed; a
    profiler window of every engine round of an spi run of two bursts;
24. operator — one port ``AtomixServer(executor="tpu")`` over loopback
    TCP with its stats listener and disk storage, the spi engine
    (``DeviceEngineConfig(capacity=1,024, num_peers=3, log_slots=16,
    submit_slots=4)``, counters only) with device telemetry, and one
    ``AtomixClient``: 1,000 ``DistributedAtomicLong``, a burst of
    ``add_and_get(1)`` on each, one under ``SlowDiskNemesis(0.02)``, one
    with a ``LoopHoldNemesis(0.15)`` hold, one under
    ``utils.profiling.trace``, and a traced one on 100 of them, every
    answer checked; then the port's CLI in this process
    (``copycat_tpu_torch.cli.main``) on the stats listener: ``stats
    --what all|flight|health``, ``doctor``, ``trace``, ``timeline``,
    ``top --once``, ``profile`` and ``profile --device``, each exiting 0,
    the flight ring showing both faults and the device profile both fused
    kernels; one launch of each fused kernel per engine round and none of
    the tally, both against their plain versions on the last step;
25. deploy — ``python -m copycat_tpu_torch.bench --scenario
    compartment`` in its own interpreter, at the reference's defaults: a
    supervised topology of OS processes (3 members × 4
    groups serving the counter machine on the host, ingress tiers 1, 2
    and 4), 8 clients × 600 zipfian writes a burst, 3 bursts, disk
    storage, ``kill -9`` of a member and an ingress on the widest tier;
    committed ops/s, the mean ingress queue, proxy retries and acked /
    in-doubt / lost writes per width (host numbers, taken on the card's
    machine); no acknowledged write lost, both corpses restarted.
26. host_scenarios — the bench's ``fanout``, ``cluster``, ``sharded``
    and ``recovery`` in this process at the reference's default widths
    (readers 8, 32 and 128 with edge reads on; 3 members, 4 clients, 2 ms
    a leg; 4 groups, 12 clients, 1,024 zipfian keys, 100 ms a leg; 4
    clients on disk, a snapshot every 512 entries), one timed burst where
    the reference runs 5 (printed): the trace proof and warm reads served
    from the replicas, every key read back once-applied, the joiner at
    the leader's commit index with no failed install; no kernel launched;
    then the port's gate over the four artifacts: recorded into a golden,
    passed against it, and a copy at half the values refused (exit 1);
27. entry — the port's graft entry (``copycat_tpu_torch/graft_entry.py``,
    the reference's ``__graft_entry__.py``): ``fn(*args)``, one consensus
    round at G=256 × P=3, L=32, S=4, once on the card, with one launch of
    each fused kernel and none of the tally, equal on every output and
    state leaf to the same call on the CPU; its wall and CUDA-event time;
    both fused kernels against their plain versions on the arguments the
    call gave them, and timed there beside their bounds; a warm call's
    time and a profiler window of ten calls;
28. lint — ``cli.main(["lint", "--strict", "--no-cache"])``, the port's
    copycheck over this checkout's port tree, on the host: exit 0, with
    its files, findings, baselined and suppressed counts and wall time.

The profile windows' summaries read the window's Chrome trace back
through ``copycat_tpu_torch/utils/profiling.py``. Each phase prints its
wall time. The line before the last is
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import pathlib
import sys
import time
from collections import deque

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
# the profile windows' Chrome traces, each deleted once it is summarised
TRACE_DIR = pathlib.Path(__file__).resolve().parent / "_smoke_traces"
SCALAR_OPS_PER_S = 67e12        # H100 SXM 32-bit rate outside the tensor cores
MIXED = dict(scenario="mixed", groups=100_000, peers=5)
# The host-bound benches, cut in depth so that the script stays inside 60%
# of its limit (PERF.md, Findings): the reference runs each 200 rounds x 5
# repetitions; G, P and L stay the reference's.
COUNTER_ROUNDS, COUNTER_REPEATS = 100, 3
MIXED_ROUNDS, MIXED_REPEATS = 100, 2
SHORT_ROUNDS, SHORT_REPEATS = 20, 2
QUERY_ROUNDS, QUERY_REPEATS = 30, 2
ELECTION_ROUNDS, ELECTION_REPEATS = 100, 3
# The plain versions take 0.1-3 ms a call, a hundred times a kernel's
# time or more: they are timed over fewer calls (100 in a graph, 50
# eager), so that the script, with the wide phase's seven shapes, stays
# inside 60% of its limit (PERF.md, Findings).
PLAIN_GRAPH = dict(calls=20, replays=5)
PLAIN_CALLS = dict(iters=50, warmup=5)


def say(msg: str) -> None:
    print(msg, flush=True)


def say_cut(bench, name: str, rounds: int, repeats: int) -> None:
    """Print how far a bench is cut from the reference's depth."""
    if (rounds, repeats) != (bench.ROUNDS, bench.REPEATS):
        say(f"{name}: cut to {rounds} rounds x {repeats} repetitions (the "
            f"reference runs {bench.ROUNDS} x {bench.REPEATS}); G, P and L "
            "as the reference's")


def time_ms(fn, iters: int = 500, warmup: int = 50) -> float:
    """Time of one eager ``fn()`` call as a caller sees it: CUDA events
    around ``iters`` back-to-back calls after ``warmup`` calls. When the
    host launches slower than the card runs the kernels, this is the
    host's time per launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 100, replays: int = 20) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so no host
    work sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def edge_rows(rng, G: int, P: int) -> np.ndarray:
    """Random int32 rows with duplicate rows and INT_MIN lanes mixed in."""
    x = rng.integers(-(1 << 20), 1 << 20, (G, P)).astype(np.int32)
    dup = rng.random(G) < 0.2
    x[dup] = x[dup, :1]
    x[rng.random((G, P)) < 0.1] = np.iinfo(np.int32).min
    return x


def on_card(case: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in case.items()}


def widen_ring(ring: torch.Tensor, first: int = 0) -> torch.Tensor:
    """The ring as the step hands it over: a column slice of a [G, L+1]
    tensor, rows L+1 elements apart, from column ``first`` (0 or 1)."""
    G, L = ring.shape
    wide = torch.zeros((G, L + 1), dtype=ring.dtype, device=ring.device)
    wide[:, first:first + L] = ring
    return wide[:, first:first + L]


def max_err(got, want, what: str) -> int:
    """Largest |got - want| over every output of a fused kernel; raises
    unless it is 0 with equal dtypes and shapes."""
    worst = 0
    for name, w in want._asdict().items():
        g = getattr(got, name)
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {name} is {g.dtype} "
                                 f"{tuple(g.shape)}, plain {w.dtype} "
                                 f"{tuple(w.shape)}")
        err = int((g.long() - w.long()).abs().max())
        if err:
            raise AssertionError(f"{what}: {name} differs from the plain "
                                 f"version (max |err| {err})")
        worst = max(worst, err)
    return worst


def phase_build(kernels) -> float:
    t0 = time.perf_counter()
    kernels.load_libraries()
    return time.perf_counter() - t0


def phase_kernel(kernels, cases, dev) -> dict:
    rng = np.random.default_rng(0)
    worst = {"kth_largest": 0, "admit_submits": 0, "ack_commit": 0,
             "admit_submits_masked": 0, "ack_commit_masked": 0}
    n = dict.fromkeys(worst, 0)
    fused = []
    for G in (10_000, 100_000, 1_001):
        for P in (3, 5, 7):
            x = torch.from_numpy(edge_rows(rng, G, P)).to(dev)
            for k in sorted({P // 2 + 1, 1, P}):
                got = kernels.kth_largest_cuda(x, k)
                want = kernels.kth_largest_plain(x, k)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                if err or got.dtype != torch.int32:
                    raise AssertionError(
                        f"kernel != plain at G={G} P={P} k={k}: err {err}")
                worst["kth_largest"] = max(worst["kth_largest"], err)
                n["kth_largest"] += 1
            fused.append((G, P) + ((5, 16) if G == 1_001 else (16, 64))
                         + (False,))
    fused.append((100_000, 5, 16, 32, False))   # the mixed bench's shape
    # the boundaries of the P <= 8 kernels' tiles, blocks, slot steps and
    # ring, each aligned and with every input one element past the start of
    # its storage (phase 1 then takes one slot a thread)
    fused += [(G, P, S, L, off) for G, S, L in cases.EDGE_SHAPES
              for P in (3, 5) for off in (False, True)]
    # which of them take four slots a thread on this card, as
    # admit_submits_launch picks (S a multiple of 4, G * S / 4 at least the
    # resident threads): the tile widths S / 4 they reach
    props = torch.cuda.get_device_properties(dev)
    resident = props.multi_processor_count \
        * props.max_threads_per_multi_processor
    tiles = {(min(S // 4, 32), S > 128) for G, S, L in cases.EDGE_SHAPES
             if S % 4 == 0 and G * (S // 4) >= resident}
    want = {(1, False), (2, False), (4, False), (32, True)}
    if not want <= tiles:
        raise AssertionError(f"on {resident} resident threads EDGE_SHAPES "
                             f"take four slots a thread in tiles {tiles}, "
                             f"not all of {want} (threads, several steps)")
    say(f"kernel: on {resident} resident threads EDGE_SHAPES take four "
        f"slots a thread in tiles of {sorted(tiles)} (threads, several "
        "steps)")
    for G, P, S, L, off in fused:
        quorum = P // 2 + 1
        where = f"G={G} P={P} S={S} L={L}" + (", misaligned" if off else "")
        a_np = cases.admit_case(rng, G, P, S, L)
        c_np = cases.ack_case(rng, G, P, L)
        # the static path, then the member-masked one on random views
        # (one member up to every lane, the leader outside its own view)
        for views, tag in ((None, ""), ("views", "_masked")):
            a = on_card(a_np, dev)
            c = on_card(c_np, dev)
            ring = c.pop("l_log_term")
            if views:
                a["view"] = torch.from_numpy(cases.member_views(
                    rng, a_np["lead"], P)).to(dev)
                c["view"] = torch.from_numpy(cases.member_views(
                    rng, c_np["lead"], P)).to(dev)
            if off:
                a = {k: cases.misalign(v) for k, v in a.items()}
                c = {k: cases.misalign(v) for k, v in c.items()}
            c["l_log_term"] = widen_ring(ring, first=int(off))
            got = kernels.admit_submits_cuda(**a, quorum=quorum, L=L)
            want = kernels.admit_submits_plain(**a, quorum=quorum, L=L)
            torch.cuda.synchronize()
            name = "admit_submits" + tag
            worst[name] = max(worst[name], max_err(
                got, want, f"{name} at {where}"))
            got = kernels.ack_commit_cuda(**c, quorum=quorum)
            want = kernels.ack_commit_plain(**c, quorum=quorum)
            torch.cuda.synchronize()
            name = "ack_commit" + tag
            worst[name] = max(worst[name], max_err(
                got, want, f"{name} at {where}"))
            n["admit_submits" + tag] += 1
            n["ack_commit" + tag] += 1
    for name, cnt in n.items():
        say(f"kernel: {name}: {cnt} cases equal to the plain version bit "
            f"for bit (max |err| {worst[name]})")
    m = torch.tensor([-5, -1, 3, 4], dtype=torch.int32, device=dev) % 4
    if m.tolist() != [3, 3, 3, 0]:
        raise AssertionError(f"int32 % is not floor-mod on the card: {m}")
    am = torch.tensor([[1, 3, 3], [2, 2, 2], [-1, -1, 0]], dtype=torch.int32,
                      device=dev).argmax(dim=1)
    if am.tolist() != [1, 0, 2]:
        raise AssertionError(f"argmax ties do not go to the first index: {am}")
    say("kernel: int32 % is floor-mod and argmax ties take the first index")
    return worst


def zero_counts(kernels_by_name: dict) -> None:
    for k in kernels_by_name.values():
        k.launches = 0


def counts(kernels_by_name: dict) -> dict:
    return {name: k.launches for name, k in kernels_by_name.items()}


def phase_path(cons, convert, ks: dict, dev, name: str, P: int, L: int,
               rounds: int, cfg, ops: np.ndarray, G: int = 1_000,
               members=None, churn=None) -> dict:
    """The CUDA step against the CPU step from one state and one set of
    timer draws, S=16, submits drawn from ``ops``; one lane per group
    isolated in rounds 10-29, random message loss otherwise. ``members``
    starts the groups with that voter set; ``churn(r, lead, sub)`` writes
    round r's config submits into ``sub`` (``lead``: the last round's
    leaders)."""
    S = cfg.append_window
    rng = np.random.default_rng(1)

    def draws():
        return rng.integers(cfg.timer_min, cfg.timer_max, (G, P)
                            ).astype(np.int32)

    timer = torch.from_numpy(draws())
    cpu = cons.init_state(G, P, L, timer, cfg, members=members)
    gpu = cons.init_state(G, P, L, timer.to(dev), cfg, members=members)
    member0 = cpu.member.clone()
    victims = rng.integers(0, P, G)
    lead = np.full(G, -1)
    installs = events = refused = 0
    zero_counts(ks)
    for r in range(rounds):
        sub = dict(opcode=rng.choice(ops, (G, S)).astype(np.int32),
                   a=rng.integers(-3, 4, (G, S)).astype(np.int32),
                   b=rng.integers(-3, 4, (G, S)).astype(np.int32),
                   c=rng.integers(0, 4, (G, S)).astype(np.int32),
                   tag=rng.integers(1, 1 << 30, (G, S)).astype(np.int32),
                   valid=rng.random((G, S)) < 0.8)
        if churn is not None:
            churn(r, lead, sub)
        if 10 <= r < 30:   # one lane per group cut off: laggards go stale
            hit = np.arange(P)[None, :] == victims[:, None]
            deliver = ~(hit[:, :, None] | hit[:, None, :])
        else:
            deliver = rng.random((G, P, P)) < 0.9
        fresh, cand = draws(), draws()
        outs = []
        for dv, st in (("cpu", cpu), (dev, gpu)):
            t = {k: torch.from_numpy(v).to(dv) for k, v in sub.items()}
            outs.append(cons.step(
                st, cons.Submits(**t), torch.from_numpy(deliver).to(dv),
                torch.from_numpy(fresh).to(dv),
                torch.from_numpy(cand).to(dv), cfg))
        (cpu, out_c), (gpu, out_g) = outs
        for what, a, b in (("outputs", out_c, out_g), ("state", cpu, gpu)):
            want, got = convert.flat_leaves(a), convert.flat_leaves(b)
            for leaf, w in want.items():
                g = got[leaf]
                if w is None and g is None:
                    continue
                if w.dtype != g.dtype or not np.array_equal(w, g):
                    raise AssertionError(
                        f"{name}: {what}.{leaf} differs at round {r}")
        events += int(out_c.ev_valid.sum())
        refused += int(out_c.refused.sum())
        lead = out_c.leader.numpy()
        if out_c.stale.any():
            cpu = cons.install_snapshots(cpu, out_c.stale, out_c.leader, cfg)
            gpu = cons.install_snapshots(gpu, out_g.stale, out_g.leader, cfg)
            installs += 1
    launched = counts(ks)
    if launched != {"kth_largest": 0, "admit_submits": rounds,
                    "ack_commit": rounds}:
        raise AssertionError(f"{name}: kernel launches {launched} in "
                             f"{rounds} card rounds; want one of each "
                             "fused kernel a round")
    if not installs:
        raise AssertionError(f"{name}: no snapshot was installed")
    changed = float((cpu.member != member0).any(dim=1).float().mean())
    say(f"{name}: CUDA step == CPU step on every leaf for {rounds} rounds "
        f"(G={G} P={P} L={L} S={S}, pools {dict(cfg.resource._asdict())}, "
        f"pool_budgets {cfg.pool_budgets}, dynamic membership "
        f"{cfg.dynamic_membership}, random partitions, {installs} "
        f"snapshot installs, {events} session events drained, {refused} "
        f"config submits refused, voter sets changed in {changed:.3f} of "
        f"the groups); card rounds launched {launched}")
    return {"changed": changed, "launches": launched}


def membership_churn(ap, P: int):
    """Config submits in slot 0 of every group: add lane 3 (rounds 0-9),
    add lane 4 (10-19), remove original voter 1 (20-29), remove the
    leader's own lane (30-39). A submit while a change is in flight is
    rejected; one that is already in effect appends a no-op change."""
    plan = [(ap.OP_CFG_ADD, 3), (ap.OP_CFG_ADD, 4), (ap.OP_CFG_REMOVE, 1),
            (ap.OP_CFG_REMOVE, None)]

    def churn(r, lead, sub):
        kind, lane = plan[min(r // 10, len(plan) - 1)]
        sub["opcode"][:, 0] = kind
        sub["a"][:, 0] = np.maximum(lead, 0) if lane is None else lane
        sub["valid"][:, 0] = True
    return churn


def phase_serve(RaftGroups, cons, ap, ks: dict) -> dict:
    zero_counts(ks)
    t0 = time.perf_counter()
    rg = RaftGroups(10_000, 3, log_slots=64, submit_slots=16,
                    config=cons.Config(
                        resource=ap.ResourceConfig.counters_only()))
    rg.wait_for_leaders()
    rng = np.random.default_rng(2)
    groups = rng.integers(0, 10_000, 300)
    deltas = rng.integers(1, 100, 300)
    tags = list(rg.submit_batch(groups, ap.OP_LONG_ADD, deltas))
    single = [(int(g), int(d)) for g, d in zip(rng.integers(0, 50, 40),
                                               rng.integers(1, 100, 40))]
    tags += [rg.submit(g, ap.OP_LONG_ADD, d) for g, d in single]
    rg.run_until(tags)
    rg.run(3)   # followers learn the final commit index and apply it
    launches = counts(ks)
    dt = time.perf_counter() - t0
    totals: dict[int, int] = {}
    order = list(zip(groups.tolist(), deltas.tolist())) + single
    for (g, d), tag in zip(order, tags):
        totals[g] = totals.get(g, 0) + d
        if rg.results[tag] != totals[g]:
            raise AssertionError(f"serve: tag {tag} on group {g} returned "
                                 f"{rg.results[tag]}, want {totals[g]}")
    values = rg.state.resources.value.cpu().numpy()
    for g, total in totals.items():
        if not (values[g] == total).all():
            raise AssertionError(f"serve: group {g} holds {values[g]}, "
                                 f"want {total}")
    for name in ("admit_submits", "ack_commit"):
        if launches[name] == 0:
            raise AssertionError(f"serve: the {name} kernel never launched")
    say(f"serve: {len(tags)} requests on {len(totals)} of 10000 groups "
        f"answered correctly in {rg.rounds} rounds ({dt:.1f}s); kernel "
        f"launches {launches}")
    return launches


class GroupModel:
    """The plain semantics of the map, queue, lock and election ops for
    one group that starts empty. An election epoch is the log index of
    the entry that set it, which the host does not choose: the model takes
    the device's value where it first sees one, requiring it to grow."""

    def __init__(self, ap):
        self.ap = ap
        self.map: dict[int, int] = {}
        self.queue: deque = deque()
        self.holder, self.waiters = -1, deque()
        self.leader, self.epoch, self.listeners = -1, 0, deque()
        self.events: list = []          # (code, target, arg)

    def _new_epoch(self, got: int) -> int:
        if got <= self.epoch:
            raise AssertionError(f"epoch {got} does not grow past "
                                 f"{self.epoch}")
        self.epoch = got
        return got

    def answer(self, op: int, a: int, b: int, got: int) -> int:
        """The model's answer to (op, a, b); ``got`` is the device's."""
        ap = self.ap
        if op == ap.OP_MAP_PUT:
            prev, self.map[a] = self.map.get(a, 0), b
            return prev
        if op == ap.OP_MAP_GET:
            return self.map.get(a, 0)
        if op == ap.OP_Q_OFFER:
            self.queue.append(a)
            return 1
        if op == ap.OP_Q_POLL:
            return self.queue.popleft() if self.queue else ap.FAIL
        if op == ap.OP_Q_SIZE:
            return len(self.queue)
        if op == ap.OP_LOCK_ACQUIRE:
            if self.holder in (-1, a):
                self.holder = a
                return 1
            if b != 0 and a not in self.waiters:
                self.waiters.append(a)
            return 2 if a in self.waiters else 0
        if op == ap.OP_LOCK_RELEASE:
            if self.holder != a:
                return 0
            self.holder = self.waiters.popleft() if self.waiters else -1
            if self.holder != -1:
                self.events.append((ap.EV_LOCK_GRANT, self.holder, 1))
            return 1
        if op == ap.OP_LOCK_HOLDER:
            return self.holder
        if op == ap.OP_ELECT_LISTEN:
            if self.leader == -1:
                self.leader = a
                return self._new_epoch(got)
            if self.leader == a:
                return self.epoch
            if a not in self.listeners:
                self.listeners.append(a)
            return 0
        if op == ap.OP_ELECT_RESIGN:
            if self.leader != a:
                return 0
            self.leader = self.listeners.popleft() if self.listeners else -1
            if self.leader != -1:
                self.events.append((ap.EV_ELECT, self.leader, None))
            return 1
        if op == ap.OP_ELECT_GET_EPOCH:
            if self.events and self.events[-1][2] is None:
                code, target, _ = self.events[-1]
                self.events[-1] = (code, target, self._new_epoch(got))
            return self.epoch
        if op == ap.OP_ELECT_LEADER:
            return self.leader
        raise ValueError(f"opcode {op} is not modelled")


def pool_chains(ap) -> dict:
    """The op chains the pool serve phase submits, one chain per group."""
    return {
        "map": lambda g: [(ap.OP_MAP_PUT, g % 7, g), (ap.OP_MAP_GET, g % 7, 0),
                          (ap.OP_MAP_PUT, g % 7, g + 1),
                          (ap.OP_MAP_GET, g % 7, 0), (ap.OP_MAP_GET, 99, 0)],
        "queue": lambda g: [(ap.OP_Q_OFFER, g, 0), (ap.OP_Q_OFFER, -g, 0),
                            (ap.OP_Q_POLL, 0, 0), (ap.OP_Q_SIZE, 0, 0)],
        "lock": lambda g: [(ap.OP_LOCK_ACQUIRE, 1, 0),
                           (ap.OP_LOCK_ACQUIRE, 2, -1),
                           (ap.OP_LOCK_RELEASE, 1, 0),
                           (ap.OP_LOCK_HOLDER, 0, 0)],
        "election": lambda g: [(ap.OP_ELECT_LISTEN, 4, 0),
                               (ap.OP_ELECT_LISTEN, 5, 0),
                               (ap.OP_ELECT_RESIGN, 4, 0),
                               (ap.OP_ELECT_GET_EPOCH, 0, 0),
                               (ap.OP_ELECT_LEADER, 0, 0)],
    }


def phase_pool_serve(RaftGroups, ap, ks: dict) -> dict:
    """Requests to every pool kind through the engine at its default
    config, checked answer by answer and event by event."""
    zero_counts(ks)
    t0 = time.perf_counter()
    rg = RaftGroups(10_000, 3, log_slots=64, submit_slots=16)
    if rg.config.resource != ap.ResourceConfig():
        raise AssertionError(f"pool serve: RaftGroups defaults to "
                             f"{rg.config.resource}, not every pool")
    rg.wait_for_leaders()
    rng = np.random.default_rng(4)
    chains = pool_chains(ap)
    kinds = list(chains)
    groups = rng.choice(10_000, 400, replace=False).tolist()
    plan = []                               # (group, kind, ops, tags)
    for i, g in enumerate(groups):
        kind = kinds[i % len(kinds)]
        ops = chains[kind](g)
        if kind == "map":                   # the vectorized submit lane
            arr = np.asarray(ops)
            tags = list(rg.submit_batch(np.full(len(ops), g), arr[:, 0],
                                        arr[:, 1], arr[:, 2]))
        else:
            tags = [rg.submit(g, *op) for op in ops]
        plan.append((g, kind, ops, tags))
    all_tags = [t for *_, tags in plan for t in tags]
    rg.run_until(all_tags)
    rg.run(4)   # followers apply the last commit; events drain
    launches = counts(ks)
    dt = time.perf_counter() - t0
    n_events = 0
    for g, kind, ops, tags in plan:
        model = GroupModel(ap)
        for (op, a, b), tag in zip(ops, tags):
            got = rg.results[tag]
            want = model.answer(op, a, b, got)
            if got != want:
                raise AssertionError(f"pool serve: {kind} op {op}({a}, {b}) "
                                     f"on group {g} answered {got}, the "
                                     f"model {want}")
        events = [e[1:] for e in rg.events.get(g, [])]
        if events != model.events:
            raise AssertionError(f"pool serve: group {g} ({kind}) events "
                                 f"{events}, the model {model.events}")
        n_events += len(events)
    for name in ("admit_submits", "ack_commit"):
        if launches[name] == 0:
            raise AssertionError(f"pool serve: the {name} kernel never "
                                 "launched")
    say(f"pool serve: {len(all_tags)} requests (map, queue, lock and "
        f"election chains) on {len(groups)} of 10000 groups at the default "
        f"config answered as the model does, with {n_events} lock-grant and "
        f"election events, in {rg.rounds} rounds ({dt:.1f}s); kernel "
        f"launches {launches}")
    return launches


def phase_membership_serve(RaftGroups, bench, cons, ap, ks: dict,
                           G: int = 100_000) -> dict:
    """BASELINE #5's width with dynamic membership: every group of G=100,000
    × P=5 (3 voters, L=32, S=16, the mixed config and budgets, flow control
    on) adds lanes 3 and 4, then removes lane 0, one change at a time, each
    submitted for every group as one ``submit_batch`` beside a counter op
    per group. Checks: every counter result is its group's prefix sum
    (exactly once), the most-applied lane holds its group's total, every group
    votes with lanes {1, 2, 3, 4}, replicas at equal applied index agree,
    and each fused kernel launched once a round."""
    P = 5
    cfg = bench.scenario_config("mixed", 16)._replace(
        dynamic_membership=True, ring_flow_control=True)
    zero_counts(ks)
    t0 = time.perf_counter()
    rg = RaftGroups(G, P, log_slots=32, submit_slots=16, config=cfg,
                    voters=3)
    rg.wait_for_leaders()
    rng = np.random.default_rng(6)
    groups = np.arange(G)
    deltas, tags, stages = [], [], []
    for kind, lane in ((ap.OP_CFG_ADD, 3), (ap.OP_CFG_ADD, 4),
                       (ap.OP_CFG_REMOVE, 0)):
        r0, s0 = rg.rounds, time.perf_counter()
        d = rng.integers(1, 100, G)
        both = rg.submit_batch(np.concatenate([groups, groups]),
                               np.repeat([kind, ap.OP_LONG_ADD], G),
                               np.concatenate([np.full(G, lane), d]))
        rg.run_until(both.tolist(), max_rounds=300)
        failed = sum(rg.results[t] == ap.FAIL for t in both[:G].tolist())
        if failed:
            raise AssertionError(f"membership serve: {failed} config "
                                 "changes failed")
        deltas.append(d)
        tags.append(both[G:])
        stages.append((rg.rounds - r0, time.perf_counter() - s0))
    rg.run(3)   # followers apply the last commit
    launches = counts(ks)
    dt = time.perf_counter() - t0
    got = np.stack([[rg.results[t] for t in tg.tolist()] for tg in tags])
    want = np.cumsum(np.stack(deltas), axis=0)
    if not np.array_equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"membership serve: {bad} counter results are "
                             "not their group's prefix sum")
    st = rg.state
    top = st.applied_index.argmax(dim=1)
    values = st.resources.value[torch.arange(G, device=top.device), top]
    if not np.array_equal(values.cpu().numpy(), want[-1]):
        raise AssertionError("membership serve: the most-applied lane of a "
                             "group does not hold its total")
    masks = rg.config_masks()
    wrong = int((masks != 0b11110).sum())
    if wrong:
        raise AssertionError(f"membership serve: {wrong} groups do not vote "
                             "with lanes {1, 2, 3, 4}")
    diverged = bench.diverged_lanes(rg.state)
    if diverged:
        raise AssertionError(f"membership serve: {diverged} replica pairs "
                             "at equal applied index differ")
    if launches != {"kth_largest": 0, "admit_submits": rg.rounds,
                    "ack_commit": rg.rounds}:
        raise AssertionError(f"membership serve: kernel launches {launches} "
                             f"in {rg.rounds} rounds")
    say(f"membership serve: G={G} P={P} (3 voters) L=32 S=16, mixed config, "
        f"flow control on: add lane 3, add lane 4, remove lane 0 with a "
        f"counter op each, rounds (and seconds) per change "
        f"{[(r, round(t, 3)) for r, t in stages]}; {rg.rounds} rounds in "
        f"{dt:.1f}s ({dt / rg.rounds * 1e3:.3f} ms/round, election and host "
        f"bookkeeping included); exactly-once counters, every group votes "
        f"with lanes [1, 2, 3, 4], 0 diverged replica pairs; kernel launches "
        f"{launches} (one of each fused kernel a round)")
    return {"rg": rg, "launches": launches, "rounds": rg.rounds,
            "ms_per_round": dt / rg.rounds * 1e3}


def phase_query_lane(bench, card: str, rounds: int, repeats: int) -> dict:
    """The map_read cell at G=10,000 × P=3 at both read levels: every
    served get reads the value the puts wrote."""
    out = {}
    say_cut(bench, "map_read", rounds, repeats)
    for level in bench.READ_LEVELS:
        zero_counts(bench.KERNELS)
        r = bench.run_map_read(level, rounds=rounds, repeats=repeats)
        if r["wrong_reads"] or not r["served_reads"]:
            raise AssertionError(f"map_read {level}: {r['wrong_reads']} "
                                 f"wrong of {r['served_reads']} served reads")
        if r["launches_per_round"] != {"kth_largest": 0, "admit_submits": 1,
                                       "ack_commit": 1}:
            raise AssertionError(f"map_read {level}: kernel launches per "
                                 f"round {r['launches_per_round']}")
        say(f"map_read {level}: {r['value']:.1f} ops/s (reps "
            f"{r['reps_min']:.1f}..{r['reps_max']:.1f}), "
            f"{r['ms_per_round']:.4f} ms/round, {r['served_reads']} reads "
            f"served in the best rep, 0 wrong, at G={r['shape']['groups']} "
            f"P={r['shape']['peers']} L={r['shape']['log_slots']}, {rounds} "
            f"rounds x {repeats} reps, on {card}")
        say(f"map_read {level}: " + json.dumps(r))
        out[level] = r
    return out


def phase_elections(bench, card: str, rounds: int, repeats: int) -> dict:
    say_cut(bench, "election", rounds, repeats)
    zero_counts(bench.KERNELS)
    r = bench.run_election(rounds=rounds, repeats=repeats)
    if r["two_leaders_in_a_term"] or not r["value"]:
        raise AssertionError(f"election: {r['two_leaders_in_a_term']} "
                             "leader pairs in one term")
    say(f"election: {r['value']:.1f} elections/s (reps "
        f"{r['reps_min']:.1f}..{r['reps_max']:.1f}), "
        f"{r['ms_per_round']:.4f} ms/round at G={r['shape']['groups']} "
        f"P={r['shape']['peers']}, {rounds} rounds x {repeats} reps, no "
        f"term with two leaders in any group, on {card}; kernel launches "
        f"per round {r['launches_per_round']}")
    say("election: " + json.dumps(r))
    return r


def _drive(rg, tags, alive=(), max_rounds: int = 200) -> None:
    """Step until ``tags`` resolve, keeping the ``alive`` sessions alive."""
    for _ in range(max_rounds):
        if all(t in rg.results for t in tags):
            return
        rg.step_round()
        for s in alive:
            s.keep_alive()
    raise TimeoutError(f"{len(tags)} ops did not resolve")


def phase_engine_extras(RaftGroups, bench, convert, ap,
                        G: int = 10_000) -> dict:
    """``step_rounds(8)`` against eight ``step_round()`` calls on the same
    draws, ``drive_vector`` against the per-group prefix sums, and a
    crashed lock holder's lock passing to the next waiter, at G=10,000 ×
    P=5 with the mixed config."""
    P = 5
    cfg = bench.scenario_config("mixed", 16)
    t0 = time.perf_counter()
    a, b = (RaftGroups(G, P, log_slots=32, submit_slots=16, config=cfg,
                       seed=3) for _ in range(2))
    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(G), rng.integers(0, 3, G))
    d = rng.integers(1, 9, rows.size)
    for rg in (a, b):
        rg.wait_for_leaders()
        rg.run(3)
        rg.submit_batch(rows, ap.OP_LONG_ADD, d)
    a.step_rounds(8)
    for _ in range(8):
        out = b.step_round()
        if b.rounds == a.rounds - 7 and not out.accepted.sum() == rows.size:
            raise AssertionError("step_rounds: round 0 rejected a submit")
    want, got = convert.flat_leaves(b.state), convert.flat_leaves(a.state)
    bad = [k for k in want if not np.array_equal(want[k], got[k])]
    if bad or a.results != b.results or a.rounds != b.rounds:
        raise AssertionError(f"step_rounds(8) != 8 x step_round(): {bad[:5]}")
    say(f"step_rounds: step_rounds(8) equals eight step_round() calls on "
        f"every state leaf and every result ({len(a.results)} results)")

    base = a.state.resources.value.amax(dim=1).cpu().numpy()
    rows = np.repeat(np.arange(G), rng.integers(0, 17, G))
    d = rng.integers(1, 9, rows.size)
    z = np.zeros_like(rows)
    res = a.drive_vector(rows, z + ap.OP_LONG_ADD, d, z, z)
    start = np.searchsorted(rows, rows)          # rows are grouped
    csum = np.cumsum(d)
    want = base[rows] + csum - (csum - d)[start]
    if res is None or not np.array_equal(res, want):
        raise AssertionError("drive_vector: results are not the per-group "
                             "prefix sums")
    say(f"drive_vector: {rows.size} rows over {G} groups equal the per-group "
        f"prefix sums")

    reg = a.sessions
    reg.timeout_rounds = 12
    s1, s2 = reg.open_session(), reg.open_session()
    locked = list(range(0, G, 997))
    for g in locked:
        s1.bind(g, "lock")
        s2.bind(g, "lock")
    t1 = [a.submit(g, ap.OP_LOCK_ACQUIRE, s1.id, -1) for g in locked]
    _drive(a, t1, (s1, s2))
    t2 = [a.submit(g, ap.OP_LOCK_ACQUIRE, s2.id, -1) for g in locked]
    _drive(a, t2, (s1, s2))
    if [a.results[t] for t in t1] != [1] * len(locked) \
            or [a.results[t] for t in t2] != [2] * len(locked):
        raise AssertionError("sessions: acquire answers "
                             f"{[a.results[t] for t in t1 + t2]}")
    for _ in range(60):                 # s1 crashes: no more keep-alives
        a.step_round()
        s2.keep_alive()
        granted = [g for g in locked if any(
            e[1] == ap.EV_LOCK_GRANT and e[2] == s2.id
            for e in a.events.get(g, []))]
        if s1.expired and len(granted) == len(locked):
            break
    holders = [a.serve_query(g, ap.OP_LOCK_HOLDER) for g in locked]
    if not s1.expired or holders != [s2.id] * len(locked):
        raise AssertionError(f"sessions: expired {s1.expired}, holders "
                             f"{holders}")
    say(f"sessions: a crashed holder's lock passed to the queued waiter in "
        f"{len(locked)} groups (grant events and holder registers agree); "
        f"the engine phase took {time.perf_counter() - t0:.1f}s")
    return {"rounds": a.rounds}


STEP_FNS = ("admit_submits", "ack_commit")


def step_fns(kernels, seen, what: str) -> tuple[dict, dict]:
    """(kernel, plain, library, bound) of each fused kernel on the
    arguments a step handed it (``seen``, from ``record_inputs``), static
    or member-masked as the step called it; and each kernel's largest
    difference from its plain version on them (raises unless 0)."""
    a_args, a_kw = seen["admit_submits"]
    c_args, c_kw = seen["ack_commit"]
    view = c_kw["view"]
    masked = view is not None
    (G, P), S = a_args[0].shape, a_args[3].shape[1]
    L = c_kw["l_log_term"].shape[1]
    out = kernels.ack_commit_plain(*c_args, **c_kw)
    l_last, lead = c_kw["l_last"], c_kw["lead"]
    self_lane = torch.arange(P, device=lead.device)[None, :] == lead[:, None]
    full = torch.where(self_lane, l_last[:, None], out.l_match)
    cand = (kernels.kth_largest_masked(full, *kernels.leader_members(
        view, lead)) if masked else kernels.kth_largest_plain(
            full, c_kw["quorum"]))
    n_live = int(((cand >= 1) & (cand <= l_last) & (cand > l_last - L)).sum())
    fns = {
        "admit_submits": (
            lambda: kernels.admit_submits_cuda(*a_args, **a_kw),
            lambda: kernels.admit_submits_plain(*a_args, **a_kw), None,
            admit_bound(G, P, S, masked)),
        "ack_commit": (
            lambda: kernels.ack_commit_cuda(*c_args, **c_kw),
            lambda: kernels.ack_commit_plain(*c_args, **c_kw), None,
            ack_bound(G, P, n_live, masked))}
    errs = {name: max_err(kern(), plain(), f"{name}"
                          + (" (masked)" if masked else "") + f" on {what}")
            for name, (kern, plain, _, _) in fns.items()}
    return fns, errs


def masked_fns(kernels, rg) -> dict:
    """(kernel, plain, library, bound) of each fused kernel, masked, on the
    inputs one step of the membership engine ``rg`` gives it."""
    from copycat_tpu_torch.ops import consensus as cons
    seen = record_inputs(cons, STEP_FNS, rg.step_round)
    if seen["admit_submits"][0][7] is None \
            or seen["ack_commit"][1]["view"] is None:
        raise AssertionError("the membership step called the static kernels")
    return step_fns(kernels, seen, "the membership step's inputs")[0]


def bounds(nbytes: int, ops: int) -> dict:
    """The least time of a call: bytes over the memory rate or integer
    operations over the 32-bit rate, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def tally_bound(G: int, P: int) -> dict:
    """Bound of one ``kth_largest`` call: reads [G,P] int32, writes [G]
    int32; a k-th largest of P values compares each of them at least once,
    P operations a group."""
    return bounds(G * P * 4 + G * 4, G * P)


def admit_bound(G: int, P: int, S: int, masked: bool = False) -> dict:
    """Bound of one ``admit_submits`` call. Reads: applied, lead,
    accept_ok, valid, l_last (and the leader lane's 4-byte view word when
    masked); writes: accepted, assigned, slot (int64), l_last. Operations:
    the rank-select's 2·P² compares, about 8 per submit slot (and the
    member masking's 2·P)."""
    return bounds(G * (4 * P + 4 + 1 + S + 4 + 4 * masked)
                  + G * (S + 4 * S + 8 * S + 4),
                  G * (2 * P * P + 8 * S + 2 * P * masked))


def ack_bound(G: int, P: int, n_live: int, masked: bool = False) -> dict:
    """Bound of one ``ack_commit`` call. Reads: six bool and six int32
    [G,P] lanes, five [G] values (and the view word when masked), and one
    ring term for each of the ``n_live`` groups whose candidate lies in
    the live window; writes: two int32 [G,P] lanes, two bool and two int32
    [G] values. Operations: 2·P² compares and about 24 per lane (and the
    masking's 2·P)."""
    return bounds(G * (6 * P + 24 * P + 17 + 4 * masked) + 4 * n_live
                  + G * (8 * P + 10),
                  G * (2 * P * P + 24 * P + 2 * P * masked))


@contextlib.contextmanager
def recording(cons, names):
    """While open, the arguments the consensus step hands each function
    of ``names`` (module attributes of ``cons``) in its last call, by
    name, in the dict it yields."""
    seen = {}
    real = {name: getattr(cons, name) for name in names}

    def recorder(name):
        def call(*args, **kw):
            seen[name] = (args, kw)
            return real[name](*args, **kw)
        return call

    for name in names:
        setattr(cons, name, recorder(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(cons, name, fn)


def record_inputs(cons, names, run) -> dict:
    """The arguments the consensus step hands each function of ``names``
    in its last call while ``run()`` runs."""
    with recording(cons, names) as seen:
        run()
    return seen


def step_inputs(bench, cons, dev, names, **cell) -> dict:
    """The arguments a bench cell's step hands each function of ``names``,
    recorded in the third round after every leader is elected."""
    c, state = bench.setup(rounds=3, device=dev, **cell)

    def run():
        st = state
        for r in range(3):
            st, _ = bench.step_cell(c, st, r)

    return record_inputs(cons, names, run)


def fused_fns(bench, cons, kernels, dev, **cell) -> dict:
    """(kernel, plain, library, bound) of each fused kernel on the inputs
    a bench cell's step gives it."""
    seen = step_inputs(bench, cons, dev, STEP_FNS, **cell)
    return step_fns(kernels, seen, "the bench step's inputs")[0]


def time_fns(fns: dict, per_round: dict, where: str, card: str) -> dict:
    timing = {}
    for name, (kern, plain, library, bound) in fns.items():
        dev_ms = {"ms": graph_ms(kern),
                  "plain_ms": graph_ms(plain, **PLAIN_GRAPH),
                  "library_ms": graph_ms(library) if library else None}
        call_ms = {"call_ms": time_ms(kern),
                   "plain_call_ms": time_ms(plain, **PLAIN_CALLS),
                   "library_call_ms": time_ms(library) if library else None}
        timing[name] = dict(**dev_ms, **bound, **call_ms,
                            launches_per_bench_round=per_round[name])
        say(f"kernel time of {name} at {where} on {card}: device time "
            f"per call (CUDA graph) {dev_ms['ms']:.6f} ms, plain torch "
            f"{dev_ms['plain_ms']:.6f} ms, library {dev_ms['library_ms']}; "
            f"eager call time {call_ms['call_ms']:.6f} ms, plain torch "
            f"{call_ms['plain_call_ms']:.6f} ms, library "
            f"{call_ms['library_call_ms']}; bound {bound['bound_ms']:.7f} ms "
            f"({bound['bound_by']})")
    return timing


def report_bench(name: str, result: dict, card: str) -> None:
    """Print a bench result; raise unless each fused kernel launched once
    a round and the replicas at equal applied index agree."""
    per_round = result["launches_per_round"]
    want = {"kth_largest": 0, "admit_submits": 1, "ack_commit": 1}
    if per_round != want:
        raise AssertionError(f"{name}: kernel launches per round "
                             f"{per_round}; want one of each fused kernel")
    if result["diverged_lanes"]:
        raise AssertionError(f"{name}: {result['diverged_lanes']} replica "
                             "pairs at equal applied index differ")
    sh = result["shape"]
    say(f"{name}: {result['value']:.1f} committed ops/s (reps "
        f"{result['reps_min']:.1f}..{result['reps_max']:.1f}), "
        f"{result['ms_per_round']:.4f} ms/round, p50 "
        f"{result['p50_commit_latency_rounds']} rounds "
        f"({result['p50_commit_latency_ms']:.4f} ms), p99 "
        f"{result['p99_commit_latency_rounds']} rounds "
        f"({result['p99_commit_latency_ms']:.4f} ms) at G={sh['groups']} "
        f"P={sh['peers']} L={sh['log_slots']} S={sh['submit_slots']}, "
        f"{sh['rounds']} rounds x {sh['repeats']} reps, budgets "
        f"{sh['pool_budgets']}, nemesis {sh['nemesis']}, on {card}; kernel "
        f"launches per timed round {per_round}; replicas at equal applied "
        f"index agree")
    say(f"{name}: " + json.dumps(result))


# bench cells whose step gives the static fused kernels the widths of the
# engines behind the server and public-API paths: a server engine's
# (G=10,000, S=4, L=64) and spi's (G=1,024, S=4, L=16), P=3
ENGINE_CELLS = (
    ("server_shape", dict(scenario="counter", groups=10_000, peers=3,
                          log_slots=64, submit_slots=4)),
    ("spi_shape", dict(scenario="counter", groups=1_024, peers=3,
                       log_slots=16, submit_slots=4)))


def phase_bench(bench, cons, kernels, dev, card: str) -> tuple[dict, dict]:
    zero_counts(bench.KERNELS)
    say_cut(bench, "bench", COUNTER_ROUNDS, COUNTER_REPEATS)
    result = bench.run_throughput(rounds=COUNTER_ROUNDS,
                                  repeats=COUNTER_REPEATS)
    report_bench("bench", result, card)

    # kth_largest alone, at the shape of the step's tallies
    G, P, k = 10_000, 3, 2
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 1 << 20, (G, P)).astype(np.int32)
                         ).to(dev)
    fns = {"kth_largest": (
        lambda: kernels.kth_largest_cuda(x, k),
        lambda: kernels.kth_largest_plain(x, k),
        lambda: torch.topk(x, k, dim=1).values[:, -1],
        tally_bound(G, P))}
    # the fused kernels, on the bench step's own inputs
    fns.update(fused_fns(bench, cons, kernels, dev))
    timing = time_fns(fns, result["launches_per_round"], "G=10000 P=3",
                      card)
    # and on the steps of the server's and spi's engine widths
    for key, cell in ENGINE_CELLS:
        shaped = time_fns(
            fused_fns(bench, cons, kernels, dev, **cell),
            result["launches_per_round"],
            "G={groups} P={peers} L={log_slots} S={submit_slots} "
            "(a counter step at the {0} engine's width)".format(
                key.split("_")[0], **cell), card)
        for name, row in shaped.items():
            timing[name][key] = row
    return result, timing


def phase_mixed_bench(bench, cons, ap, kernels, dev, card: str
                      ) -> tuple[dict, dict]:
    """BASELINE config #5 at full width under the nemesis, with the kernel
    counts zeroed just before and read just after; then the fused kernels
    timed on its step's inputs and the apply's time per round."""
    zero_counts(bench.KERNELS)
    t0 = time.perf_counter()
    result = bench.run_throughput(rounds=MIXED_ROUNDS,
                                  repeats=MIXED_REPEATS, **MIXED)
    launches = counts(bench.KERNELS)
    dt = time.perf_counter() - t0
    say_cut(bench, "mixed bench", MIXED_ROUNDS, MIXED_REPEATS)
    report_bench("mixed bench", result, card)
    say(f"mixed bench: {dt:.1f}s in all, election and warm-up included")

    fns = fused_fns(bench, cons, kernels, dev, **MIXED)
    timing = time_fns(fns, result["launches_per_round"],
                      "G=100000 P=5 L=32 S=16 (mixed bench step)", card)

    # the apply phase alone (apply_window on a mixed round's own inputs)
    args, kw = step_inputs(bench, cons, dev, ("apply_window",),
                           **MIXED)["apply_window"]
    apply_ms = time_ms(lambda: ap.apply_window(*args, **kw), iters=10,
                       warmup=3)
    share = apply_ms / result["ms_per_round"]
    say(f"mixed bench: apply_window takes {apply_ms:.3f} ms per round "
        f"(eager, CUDA events), {share:.3f} of the "
        f"{result['ms_per_round']:.3f} ms round, on {card}")
    result["apply_ms"], result["apply_share"] = apply_ms, share
    result["launches"] = launches
    return result, timing


def phase_short_benches(bench, card: str) -> dict:
    """The map and lock cells at the reference's defaults, briefly."""
    out = {}
    for scenario in ("map", "lock"):
        zero_counts(bench.KERNELS)
        result = bench.run_throughput(scenario, rounds=SHORT_ROUNDS,
                                      repeats=SHORT_REPEATS)
        report_bench(f"{scenario} bench", result, card)
        out[scenario] = result
    return out


def phase_profile(bench, dev, card: str, rounds: int = 20,
                  scenario: str = "counter", groups: int = 10_000,
                  peers: int = 3) -> dict:
    """Where a round's time goes: ``rounds`` rounds of a bench cell's step
    (the nemesis and its snapshot installs included) under
    ``torch.profiler``: wall time, summed kernel time, the device's idle
    share, kernel launches per round and the top kernels."""
    cell, state = bench.setup(scenario, groups, peers, rounds=rounds + 5,
                              device=dev)
    box = {"state": state}

    def run(r0, n):
        for r in range(r0, r0 + n):
            box["state"], _ = bench.step_cell(cell, box["state"], r)

    L = state.log_term.shape[-1]
    return profile_rounds(run, rounds, f"{rounds} {scenario} rounds, "
                          f"G={groups} P={peers} L={L} S=16", card)


def profile_rounds(run, rounds: int, what: str, card: str) -> dict:
    """``run(r0, n)`` steps rounds r0..r0+n-1: five warm-up rounds, then
    ``rounds`` under ``torch.profiler``."""
    run(0, 5)
    return profiled(lambda: run(5, rounds), lambda _: rounds, what, card)


@contextlib.contextmanager
def profiling(what: str, card: str):
    """A ``torch.profiler`` window over the body (``utils.profiling.trace``,
    the CUDA activity alone), which stores the number of rounds it ran
    under ``"rounds"`` in the dict this yields; on exit the dict holds
    :func:`profile_summary` of the window, read back from the window's
    Chrome trace by ``utils.profiling.summarize_trace``, and the trace is
    deleted."""
    import shutil

    from copycat_tpu_torch.utils.profiling import trace

    window = {}
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    try:
        with trace(str(TRACE_DIR)):
            t0 = time.perf_counter()
            yield window
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / window["rounds"]
        rounds = window.pop("rounds")
        window.update(profile_summary(rounds, wall_ms, what, card))
    finally:
        shutil.rmtree(TRACE_DIR, ignore_errors=True)


def profiled(fn, rounds_of, what: str, card: str) -> dict:
    """``fn()`` under :func:`profiling`: wall time, summed kernel time, the
    device's idle share and kernel launches, each per round of the
    ``rounds_of(fn())`` rounds it ran, and the top kernels."""
    with profiling(what, card) as window:
        window["rounds"] = rounds_of(fn())
    return window


def profile_summary(rounds: int, wall_ms: float, what: str,
                    card: str) -> dict:
    """The device lanes of the newest trace under ``TRACE_DIR``, through
    ``utils.profiling.summarize_trace``: every kernel, copy and set the
    card ran, summed and counted per round."""
    from copycat_tpu_torch.utils.profiling import summarize_trace

    t0 = time.perf_counter()
    try:
        rows = summarize_trace(str(TRACE_DIR), top=None)
    except RuntimeError as exc:
        say(f"profile: {exc}; idle share not measured")
        return {}
    busy_ms = sum(ms for _, ms, _ in rows) / rounds
    launches = sum(n for _, _, n in rows) / rounds
    say(f"profile ({what}, on {card}, profiler on, CUDA activity): wall "
        f"{wall_ms:.3f} ms/round, kernel time {busy_ms:.3f} ms/round, device "
        f"idle share {1 - busy_ms / wall_ms:.4f}, {launches:.1f} kernel "
        f"launches/round over {rounds} rounds (trace read in "
        f"{time.perf_counter() - t0:.1f}s)")
    for name, ms, n in rows[:8]:
        say(f"profile:   {ms / rounds:.4f} ms/round  x{n // rounds}  "
            f"{name[:90]}")
    return {"wall_ms": wall_ms, "kernel_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "launches": launches}


def profile_serve(rg, ap, card: str, what: str, rounds: int = 10) -> dict:
    """A profiler window of an engine's rounds, a counter op for every
    group each round."""
    G = rg.num_groups

    def run(r0, n):
        for _ in range(n):
            rg.submit_batch(np.arange(G), ap.OP_LONG_ADD, 1)
            rg.step_round()

    return profile_rounds(run, rounds, f"{rounds} {what} rounds, G={G} "
                          f"P={rg.num_peers} L={rg.log_slots} S=16, host "
                          "bookkeeping included", card)


def phase_deep_path(cons, convert, ks: dict, dev, G: int = 1_000,
                    P: int = 3, L: int = 64, S: int = 16,
                    windows: int = 8) -> dict:
    """``deep_scan`` on the card against the CPU from one state and one
    set of draws: leaders elected on the CPU first, then ``windows`` dense
    tag windows (every group's next S tags, random payloads and lengths)
    and 3 settle rounds under random message loss."""
    from copycat_tpu_torch.ops.apply import OP_LONG_ADD, ResourceConfig
    cfg = cons.Config(append_window=S, applies_per_round=S,
                      resource=ResourceConfig.counters_only(),
                      monotone_tag_accept=True, telemetry=True)
    rng = np.random.default_rng(8)

    def draws():
        return torch.from_numpy(rng.integers(cfg.timer_min, cfg.timer_max,
                                             (G, P)).astype(np.int32))

    state = cons.init_state(G, P, L, draws(), cfg)
    empty = cons.make_submits(G, S, "cpu")
    full = cons.full_delivery(G, P, "cpu")
    for _ in range(40):
        state, out = cons.step(state, empty, full, draws(), draws(), cfg)
    if not bool((out.leader >= 0).all()):
        raise AssertionError("deep path: not every group elected a leader")
    W = windows + 3
    take = np.minimum(rng.integers(0, S + 1, (windows, G)), S)
    base = np.cumsum(np.concatenate([np.zeros((1, G), np.int64), take]),
                     axis=0)
    valid = np.zeros((W, G, S), bool)
    valid[:windows] = np.arange(S)[None, None, :] < take[..., None]
    tag = np.zeros((W, G, 1), np.int32)
    tag[:windows, :, 0] = base[:windows] + 1
    sub_np = dict(opcode=np.full((W, G, S), OP_LONG_ADD, np.int32),
                  a=rng.integers(1, 9, (W, G, S)).astype(np.int32),
                  b=np.zeros((W, G, S), np.int32),
                  c=np.zeros((W, G, S), np.int32), tag=tag, valid=valid)
    deliver = rng.random((G, P, P)) < 0.95
    timers = [(draws(), draws()) for _ in range(W)]
    B = 128
    acc = (np.zeros((G, B), np.int32), np.zeros((G, B), bool),
           np.full((G, B), 2 ** 30, np.int32), np.zeros(G, bool))
    runs = {}
    for where in ("cpu", dev):
        st = convert.state_to_torch(convert.to_numpy(state), where)
        if where == dev:
            zero_counts(ks)
        runs[str(where)] = cons.deep_scan(
            st, *convert.deep_to_torch(acc, where),
            torch.zeros(G, dtype=torch.int32, device=where),
            convert.submits_to_torch(sub_np, where),
            torch.from_numpy(deliver).to(where),
            [(f.to(where), c.to(where)) for f, c in timers], cfg)
        if where == dev:
            torch.cuda.synchronize()
            launched = counts(ks)
    want, got = runs["cpu"], runs[str(dev)]
    names = ("state",) + convert.DEEP_ACCUMULATORS + ("events", "telemetry")
    for name, w, g in zip(names, want, got):
        if isinstance(w, tuple) and not hasattr(w, "_fields"):
            w = {str(i): x for i, x in enumerate(w)}
            g = {str(i): x for i, x in enumerate(g)}
        w = {name: w} if isinstance(w, torch.Tensor) else w
        g = {name: g} if isinstance(g, torch.Tensor) else g
        wl, gl = convert.flat_leaves(w), convert.flat_leaves(g)
        for leaf, x in wl.items():
            if x.dtype != gl[leaf].dtype or not np.array_equal(x, gl[leaf]):
                raise AssertionError(f"deep path: {name}.{leaf} differs")
    if launched != {"kth_largest": 0, "admit_submits": W, "ack_commit": W}:
        raise AssertionError(f"deep path: kernel launches {launched} in {W} "
                             "card rounds")
    resolved = int(want[2].sum())
    if resolved == 0:
        raise AssertionError("deep path: no result was accumulated")
    say(f"deep path: deep_scan on the card == on the CPU on every state, "
        f"accumulator, event and telemetry leaf (G={G} P={P} L={L} S={S}, "
        f"{windows} windows + 3 settle rounds, {int(take.sum())} ops sent, "
        f"{resolved} resolved, 5% message loss); card rounds launched "
        f"{launched}")
    return {"launches": launched}


def phase_host_bench(bench, ap, card: str) -> dict:
    """The north-star host cell in four modes, exactly once each, one
    launch of each fused kernel a round; then a telemetry drive and a
    profiler window of one deep drive."""
    out = {}
    one_each = {"kth_largest": 0.0, "admit_submits": 1.0, "ack_commit": 1.0}
    for mode in bench.HOST_MODES:
        zero_counts(bench.KERNELS)
        t0 = time.perf_counter()
        r = bench.run_host(mode)
        launched = counts(bench.KERNELS)
        if r["groups_not_exactly_once"]:
            raise AssertionError(f"host {mode}: {r['groups_not_exactly_once']}"
                                 " groups' counters differ from the ops "
                                 "committed to them")
        if r["launches_per_round"] != one_each:
            raise AssertionError(f"host {mode}: kernel launches per round "
                                 f"{r['launches_per_round']}")
        lat = (f"p50 {r['p50_latency_ms']:.3f} ms, p99 "
               f"{r['p99_latency_ms']:.3f} ms" if "p50_latency_ms" in r
               else f"p50 {r['p50_commit_latency_rounds']} rounds, p99 "
               f"{r['p99_commit_latency_rounds']} rounds")
        say(f"host {mode}: {r['value']:.1f} committed ops/s host-observed "
            f"(reps {r['reps_min']:.1f}..{r['reps_max']:.1f}), {lat}, "
            f"{r['rounds_per_drive']} rounds per drive of "
            f"{r['ops_per_drive']} ops, every group's counter exactly once, "
            f"at G={r['shape']['groups']} P={r['shape']['peers']} "
            f"L={r['shape']['log_slots']} S={r['shape']['submit_slots']}, on "
            f"{card}; launches per round {r['launches_per_round']}, "
            f"{launched} in all ({time.perf_counter() - t0:.1f}s with "
            f"elections)")
        say(f"host {mode}: " + json.dumps(r))
        out[mode] = dict(r, launches=launched)

    r = bench.run_host("deep", repeats=1, telemetry=True)
    tel = r["device_telemetry"]
    violations = sum(v for k, v in tel.items()
                     if k.startswith("device.invariant_violations"))
    committed = 2 * r["ops_per_drive"]      # the warm-up and one drive
    if tel["device.commit_advance"] < committed or violations:
        raise AssertionError(f"host deep telemetry: commit_advance "
                             f"{tel['device.commit_advance']} for "
                             f"{committed} ops, {violations} violations")
    say(f"host deep (telemetry on): {r['value']:.1f} ops/s; device.* "
        f"commit_advance {tel['device.commit_advance']} covers the "
        f"{committed} ops committed, elections "
        f"{tel['device.elections_started']}, submit rejections "
        f"{tel['device.submit_rejections']}, 0 invariant violations, on "
        f"{card}")
    out["telemetry"] = r

    # a profiler window of one deep drive at the cell's width
    G, S = bench.GROUPS, bench.SUBMIT_SLOTS
    rg = bench._host_engine(G, bench.PEERS, S, True, False, None)
    driver = bench.BulkDriver(rg)
    ops = np.repeat(np.arange(G), S * 8)
    driver.drive(ops, ap.OP_LONG_ADD, 1)
    out["profile"] = profiled(
        lambda: driver.drive(ops, ap.OP_LONG_ADD, 1), lambda res: res.rounds,
        f"one deep drive of {ops.size} ops, G={G} P={bench.PEERS} "
        f"L={bench.HOST_LOG_SLOTS} S={S}", card)
    return out


def phase_host_read_session(bench, card: str) -> dict:
    out = {}
    for level in bench.READ_LEVELS:
        r = bench.run_host_read(level)
        if r["wrong_reads"]:
            raise AssertionError(f"host_read {level}: {r['wrong_reads']} "
                                 "reads did not return 7")
        say(f"host_read {level}: {r['value']:.1f} reads/s host-observed "
            f"(reps {r['reps_min']:.1f}..{r['reps_max']:.1f}), "
            f"{r['reads_per_repetition']} reads a repetition, every read 7, "
            f"{r['settle_rounds_per_repetition']} settle rounds a "
            f"repetition, on {card}")
        say(f"host_read {level}: " + json.dumps(r))
        out[level] = r
    zero_counts(bench.KERNELS)
    r = bench.run_session()
    if r["group0_counter"] != r["group0_expected"]:
        raise AssertionError(f"session: group 0 holds {r['group0_counter']},"
                             f" want {r['group0_expected']}")
    say(f"session: {r['value']:.1f} committed session ops/s "
        f"(reps {r['reps_min']:.1f}..{r['reps_max']:.1f}), {r['sessions']} "
        f"sessions, {r['rounds_per_flush']} rounds a flush, group 0 exactly "
        f"once ({r['group0_counter']}), on {card}; launches per round "
        f"{r['launches_per_round']}")
    say("session: " + json.dumps(r))
    out["session"] = r
    return out


WIDE_PEERS = (9, 16)        # past the unrolled instantiations (P <= 8)


def wide_fns(kernels, cases, dev, rng, G: int, P: int, S: int, L: int,
             masked: bool) -> dict:
    """(kernel, plain, library, bound) of the runtime-P instantiation of
    each quorum kernel at ``P`` lanes, on ``phase_kernel``'s inputs; the
    kernels are checked against their plain versions first."""
    quorum = P // 2 + 1
    a_np = cases.admit_case(rng, G, P, S, L)
    c_np = cases.ack_case(rng, G, P, L)
    a, c = on_card(a_np, dev), on_card(c_np, dev)
    c["l_log_term"] = widen_ring(c["l_log_term"])
    if masked:
        a["view"] = torch.from_numpy(cases.member_views(
            rng, a_np["lead"], P)).to(dev)
        c["view"] = torch.from_numpy(cases.member_views(
            rng, c_np["lead"], P)).to(dev)
    out = kernels.ack_commit_plain(**c, quorum=quorum)
    l_last, lead = c["l_last"], c["lead"]
    self_lane = torch.arange(P, device=dev)[None, :] == lead[:, None]
    full = torch.where(self_lane, l_last[:, None], out.l_match)
    cand = (kernels.kth_largest_masked(full, *kernels.leader_members(
        c["view"], lead)) if masked else kernels.kth_largest_plain(
            full, quorum))
    n_live = int(((cand >= 1) & (cand <= l_last) & (cand > l_last - L)).sum())
    fns = {
        "admit_submits": (
            lambda: kernels.admit_submits_cuda(**a, quorum=quorum, L=L),
            lambda: kernels.admit_submits_plain(**a, quorum=quorum, L=L),
            None, admit_bound(G, P, S, masked)),
        "ack_commit": (
            lambda: kernels.ack_commit_cuda(**c, quorum=quorum),
            lambda: kernels.ack_commit_plain(**c, quorum=quorum), None,
            ack_bound(G, P, n_live, masked))}
    if not masked:
        x = torch.from_numpy(edge_rows(rng, G, P)).to(dev)
        fns["kth_largest"] = (
            lambda: kernels.kth_largest_cuda(x, quorum),
            lambda: kernels.kth_largest_plain(x, quorum),
            lambda: torch.topk(x, quorum, dim=1).values[:, -1],
            tally_bound(G, P))
    return fns


def wide_serve(RaftGroups, ap, ks: dict, P: int, voters=None,
               G: int = 10_000) -> tuple[dict, dict]:
    """``RaftGroups(10_000, P)`` on the card (static membership, or
    dynamic with ``voters`` and lane ``voters`` added by every group)
    answering a counter op per group, each checked; the kernel counts are
    zeroed just before and read just after. Returns the counts and the
    fused kernels' arguments in the round that admits the ops."""
    from copycat_tpu_torch.ops import consensus as cons
    from copycat_tpu_torch.ops.consensus import Config
    cfg = Config(resource=ap.ResourceConfig.counters_only(),
                 dynamic_membership=voters is not None)
    zero_counts(ks)
    rg = RaftGroups(G, P, log_slots=64, submit_slots=4, config=cfg,
                    voters=voters)
    rg.wait_for_leaders()
    tags = rg.submit_batch(np.arange(G), ap.OP_LONG_ADD, 3)
    if voters is not None:
        tags = np.concatenate([tags, rg.submit_batch(
            np.arange(G), ap.OP_CFG_ADD, voters)])
    seen = record_inputs(cons, STEP_FNS, rg.step_round)
    rg.run_until(tags.tolist())
    got = np.array([rg.results.pop(int(t)) for t in tags[:G]])
    if (got != 3).any():
        raise AssertionError(f"P={P}: {int((got != 3).sum())} counters "
                             "answered other than 3")
    if voters is not None:
        rg.run(4)
        if not all(voters in rg.voting_members(g) for g in (0, G // 2, G - 1)):
            raise AssertionError(f"P={P}: lane {voters} did not join")
    launched = counts(ks)
    if min(launched["admit_submits"], launched["ack_commit"]) < rg.rounds:
        raise AssertionError(f"P={P}: {launched} launches in {rg.rounds} "
                             "rounds")
    say(f"wide serve: RaftGroups({G}, {P}"
        + (f", voters={voters}, dynamic membership" if voters else "")
        + f") on the card: every counter answered, {rg.rounds} rounds, "
        f"launches {launched}")
    return launched, seen


# (P, member-masked, served): the runtime-P shapes of the wide phase. A
# served shape runs RaftGroups(10_000, P) on the card and is timed on its
# step's inputs; the others (the 16- and 32-lane tiles' edges, and more
# than 32 lanes a thread) are checked and timed on drawn inputs alone.
WIDE_SHAPES = ((9, False, True), (16, False, True), (9, True, True),
               (16, True, False), (32, False, False), (32, True, False),
               (33, False, False))


# P of the tally alone past the unrolled kernels, checked bit for bit at
# every k from 1 to P's edges: the 16- and 32-lane tiles' edges, two lanes
# a thread (64) and more than a thread keeps in registers (130)
TALLY_CHECKS = (9, 16, 17, 32, 33, 64, 130)
# of those, the P timed only on drawn rows (WIDE_SHAPES times the others)
TALLY_TIMED = (17, 64, 130)


def check_wide_tally(kernels, dev) -> dict:
    """``kth_largest_cuda`` equal to ``kth_largest_plain`` bit for bit on
    drawn rows (duplicates, INT32_MIN lanes) at each ``TALLY_CHECKS`` P,
    G = 10,000 and 1,001 (a partial last block), k = 1, P // 2 + 1 and P;
    returns the largest |err| by P (0, or it raises)."""
    rng = np.random.default_rng(17)
    errs = {}
    for P in TALLY_CHECKS:
        for G in (10_000, 1_001):
            x = torch.from_numpy(edge_rows(rng, G, P)).to(dev)
            for k in sorted({1, P // 2 + 1, P}):
                got = kernels.kth_largest_cuda(x, k)
                want = kernels.kth_largest_plain(x, k)
                err = int((got.long() - want.long()).abs().max())
                if err or got.dtype != want.dtype:
                    raise AssertionError(f"kth_largest at P={P}, G={G}, "
                                         f"k={k}: err {err}")
                errs[P] = max(errs.get(P, 0), err)
    say(f"wide tally: kth_largest equal to the plain version bit for bit "
        f"at P = {', '.join(map(str, TALLY_CHECKS))}, G = 10000 and 1001, "
        "k = 1, P // 2 + 1 and P")
    return errs


def phase_wide_kernels(RaftGroups, kernels, cases, ap, ks: dict, dev,
                       card: str, path_launches: dict,
                       G: int = 10_000) -> list[dict]:
    """The runtime-P (P > 8, warp-tile) kernels: ``RaftGroups`` at 9 and
    16 peers, and at 9 with dynamic membership, serving on the card; each
    fused kernel equal to its plain version bit for bit on the arguments
    the serve's step gave it (and timed there), and on drawn inputs at S =
    16 and at G = 1,001 (a partial last tile and block); at 16 (masked),
    32 (static and masked) and 33 peers on the drawn inputs alone, timed
    on those at G = 10,000; ``kth_largest`` (off the path) on drawn
    rows, checked at ``TALLY_CHECKS``' P and timed at the static shapes'
    P. ``path_launches``: each kernel's count on the main path's run (the
    counter serve), read where no serve of this phase runs a P."""
    rng = np.random.default_rng(9)
    L = 64
    rows = []
    tally_errs = check_wide_tally(kernels, dev)
    for P, masked, served in WIDE_SHAPES:
        drawn = (wide_fns(kernels, cases, dev, rng, G, P, 16, L, masked),
                 wide_fns(kernels, cases, dev, rng, 1_001, P, 5, L, masked))
        if served:
            launched, seen = wide_serve(RaftGroups, ap, ks, P,
                                        voters=5 if masked else None, G=G)
            fns, errs = step_fns(kernels, seen, f"the P={P} serve's step")
            if (seen["ack_commit"][1]["view"] is not None) != masked:
                raise AssertionError(f"P={P}: the serve called the wrong "
                                     "form")
            S = seen["admit_submits"][0][3].shape[1]
            inputs = "the serve's step"
        else:           # no serve runs this P: the main path's tally count
            launched = {n: path_launches["kth_largest"] if n == "kth_largest"
                        else 0 for n in ks}
            fns = {n: f for n, f in drawn[0].items() if n != "kth_largest"}
            errs, S, inputs = {}, 16, "drawn inputs"
        for name in drawn[0]:
            for kern, plain, *_ in (d[name] for d in drawn):
                what = f"{name} at P={P}" + (" (masked)" if masked else "")
                got, want = kern(), plain()
                if name == "kth_largest":
                    err = int((got.long() - want.long()).abs().max())
                    if err or got.dtype != want.dtype:
                        raise AssertionError(f"{what}: err {err}")
                else:
                    err = max_err(got, want, what)
                errs[name] = max(errs.get(name, 0), err)
        tag = f"_p{P}" + ("_masked" if masked else "")
        per_round = {n: 1.0 for n in (*fns, "kth_largest")}
        timing = time_fns(fns, per_round, f"G={G} P={P} S={S} L={L} ("
                          + inputs + (", member-masked)" if masked
                                      else ")"), card)
        if not masked:
            errs["kth_largest"] = max(errs["kth_largest"], tally_errs[P])
            fns["kth_largest"] = drawn[0]["kth_largest"]
            timing.update(time_fns({"kth_largest": fns["kth_largest"]},
                                   per_round, f"G={G} P={P} (drawn rows)",
                                   card))
        for name in fns:
            rows.append({
                "name": (name + "_masked" if masked else name) + f"_p{P}",
                "route": "cuda",
                "source": "copycat_tpu_torch/csrc/"
                          + ("kth_largest.cu" if name == "kth_largest"
                             else "quorum_phase.cu"),
                "replaces": "copycat_tpu/ops/pallas_kernels.py:69",
                "launches": launched[name],
                "max_abs_err": errs[name],
                "timed_on": "drawn rows" if name == "kth_largest" else inputs,
                **{k: v for k, v in timing[name].items()
                   if k != "launches_per_bench_round"}})
        say(f"wide kernels{tag}: {sorted(fns)} equal to the plain versions "
            f"bit for bit" + (f" on the serve's step (S={S}) and" if served
                              else "") + f" on drawn inputs at G={G} (S=16) "
            "and G=1001")
    # the tally alone at the P that only check_wide_tally reached: timed
    # beside its plain version and torch.topk on drawn rows, k = P // 2 + 1
    for P in TALLY_TIMED:
        k = P // 2 + 1
        x = torch.from_numpy(edge_rows(rng, G, P)).to(dev)
        timing = time_fns({"kth_largest": (
            lambda: kernels.kth_largest_cuda(x, k),
            lambda: kernels.kth_largest_plain(x, k),
            lambda: torch.topk(x, k, dim=1).values[:, -1],
            tally_bound(G, P))},
            {"kth_largest": 1.0}, f"G={G} P={P} (drawn rows)", card)
        rows.append({
            "name": f"kth_largest_p{P}", "route": "cuda",
            "source": "copycat_tpu_torch/csrc/kth_largest.cu",
            "replaces": "copycat_tpu/ops/pallas_kernels.py:69",
            "launches": path_launches["kth_largest"],
            "max_abs_err": tally_errs[P],
            "timed_on": "drawn rows",
            **{k_: v for k_, v in timing["kth_largest"].items()
               if k_ != "launches_per_bench_round"}})
    return rows


def _same_leaves(a, b, what: str) -> None:
    """Every leaf of two NamedTuples of tensors or arrays equal, value,
    dtype and shape."""
    from copycat_tpu_torch import convert
    la, lb = convert.flat_leaves(a), convert.flat_leaves(b)
    if la.keys() != lb.keys():
        raise AssertionError(f"{what}: the leaves differ")
    for name, x in la.items():
        y = lb[name]
        if (x is None) != (y is None) or x is not None and (
                x.dtype != y.dtype or not np.array_equal(x, y)):
            raise AssertionError(f"{what}: {name} differs")


def phase_checkpoint(RaftGroups, bench, ap, card: str, G: int = 100_000,
                     host_groups: int = 10_000) -> dict:
    """``save_bytes``/``load_bytes`` on the mixed cell's engine at full
    width, the restored engine stepping bit for bit like the original;
    then a monotone engine at the host cell's shape restored between two
    deep drives."""
    from copycat_tpu_torch.models import BulkDriver, checkpoint
    P, L, S = 5, 32, 16
    rg = RaftGroups(G, P, log_slots=L, submit_slots=S, seed=1,
                    config=bench.scenario_config("mixed", S))
    sub = bench.mixed_submits(G, S, rg.device)
    delivers = bench.nemesis_delivers(30, G, P, rg.device)
    for r in range(20):
        rg.step_round(sub, delivers[r])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = checkpoint.save_bytes(rg)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    twin = checkpoint.load_bytes(blob, device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    _same_leaves(rg.state, twin.state, "restored state")
    if not torch.equal(rg.deliver, twin.deliver):
        raise AssertionError("restored deliver differs")
    if (twin.rounds, twin.clock, twin._next_tag) != (
            rg.rounds, rg.clock, rg._next_tag):
        raise AssertionError("restored host counters differ")
    for r in range(20, 30):
        outs = [e.step_round(sub, delivers[r]) for e in (rg, twin)]
        _same_leaves(*outs, f"outputs of round {r}")
        _same_leaves(rg.state, twin.state, f"state after round {r}")
    diverged = bench.diverged_lanes(twin.state)
    if diverged:
        raise AssertionError(f"checkpoint: {diverged} diverged replica pairs")
    mb = len(blob) / 1e6
    say(f"checkpoint: G={G} P={P} L={L} S={S} mixed engine after 20 rounds "
        f"under the nemesis: blob {mb:.1f} MB, save {save_ms:.1f} ms, load "
        f"onto cuda {load_ms:.1f} ms, every leaf equal; 10 more rounds bit "
        f"for bit equal (state and outputs), on {card}")
    del rg, twin, blob

    # the monotone stream cursor across a restore, at the host cell's shape
    rg = bench._host_engine(host_groups, 3, S, True, False, None)
    ops = np.repeat(np.arange(host_groups), 8)
    BulkDriver(rg).drive(ops, ap.OP_LONG_ADD, 1)
    twin = checkpoint.load_bytes(checkpoint.save_bytes(rg), device="cuda")
    if not np.array_equal(twin._stream_count, rg._stream_count) \
            or (twin._stream_count != 8).any():
        raise AssertionError("checkpoint: the stream cursor was not rebuilt")
    res = BulkDriver(twin).drive(ops, ap.OP_LONG_ADD, 1)
    if not (res.results.reshape(-1, 8) == 8 + np.arange(1, 9)).all():
        raise AssertionError("checkpoint: the second deep drive did not "
                             "commit exactly once")
    say(f"checkpoint: monotone engine G={host_groups} P=3 restored between "
        f"two deep drives of {ops.size} ops: stream cursor rebuilt (8 a "
        "group), the second drive exactly once")
    return {"blob_mb": mb, "save_ms": save_ms, "load_ms": load_ms}


def phase_facades(RaftGroups, ap, ks: dict, card: str,
                  G: int = 10_000) -> tuple[dict, dict]:
    """Each of the nine facades scripted on its own groups of one
    G=10,000 × P=3 default-config engine on the card, with the reference
    facade tests' answers; kernel counts zeroed before, read after. Then
    the fused kernels against their plain versions on the arguments of
    the engine's step in the ``DeviceLong`` script."""
    from copycat_tpu_torch.models import device_resources as dr
    from copycat_tpu_torch.ops import consensus as cons
    from copycat_tpu_torch.ops import kernels
    zero_counts(ks)
    rg = RaftGroups(G, 3, log_slots=64, submit_slots=4)
    rg.wait_for_leaders()
    got = {}
    v, n = dr.DeviceValue(rg, 0), dr.DeviceLong(rg, 1)
    v.set(10)
    got["value"] = [v.get(), v.compare_and_set(10, 20),
                    v.compare_and_set(10, 30), v.get_and_set(5)]
    seen = record_inputs(cons, STEP_FNS, lambda: got.update(long=[
        n.increment_and_get(), n.add_and_get(9), n.get_and_add(5),
        n.decrement_and_get(), n.get()]))
    m = dr.DeviceMap(rg, 2)
    got["map"] = [m.put(1, 100), m.get(1), m.put_if_absent(1, 999),
                  m.put_if_absent(2, 200), m.size(), m.replace(1, 111),
                  m.replace(42, 1), m.remove(1), m.get_or_default(1, 7)]
    s = dr.DeviceSet(rg, 3)
    got["set"] = [s.add(5), s.add(5), s.contains(5), s.remove(5),
                  s.is_empty()]
    q = dr.DeviceQueue(rg, 4)
    q.add(1)
    got["queue"] = [q.offer(2), q.peek(), q.size(), q.poll(), q.poll(),
                    q.poll()]
    mm = dr.DeviceMultiMap(rg, 5)
    got["multimap"] = [mm.put(1, 10), mm.put(1, 11), mm.put(1, 10),
                       mm.count(1), mm.remove_entry(1, 11), mm.remove(1),
                       mm.is_empty()]
    alice = dr.DeviceTopic(rg, 6, subscriber_id=1)
    bob = dr.DeviceTopic(rg, 6, subscriber_id=2)
    alice.subscribe()
    bob.subscribe()
    pub = dr.DeviceTopic(rg, 6, subscriber_id=9)
    fan = [pub.publish(42), pub.publish(43)]
    rg.run(4)
    got["topic"] = fan + [alice.poll_messages(), bob.poll_messages()]
    a = dr.DeviceLock(rg, 7, holder_id=1)
    b = dr.DeviceLock(rg, 7, holder_id=2)
    a.lock()
    tag = rg.submit(7, ap.OP_LOCK_ACQUIRE, 2, -1)
    rg.run_until([tag])
    queued = rg.results.pop(tag)
    a.unlock()
    got["lock"] = [queued, b._await_grant(None),
                   [e[2] for e in rg.events.get(7, [])
                    if e[1] == ap.EV_LOCK_GRANT], a.try_lock()]
    b.unlock()
    e1 = dr.DeviceElection(rg, 8, candidate_id=11)
    e2 = dr.DeviceElection(rg, 8, candidate_id=22)
    epoch1 = e1.listen()
    waiting = e2.listen()
    e1.resign()
    rg.run(10)
    epoch2 = e2.poll_elected()
    got["election"] = [epoch1 > 0, waiting, epoch2 is not None
                       and epoch2 > epoch1, e2.is_leader(),
                       e1.is_leader(epoch1)]
    want = {
        "value": [10, True, False, 20], "long": [1, 10, 10, 14, 14],
        "map": [0, 100, False, True, 2, 100, None, 111, 7],
        "set": [True, False, True, True, True],
        "queue": [True, 1, 2, 1, 2, None],
        "multimap": [True, True, False, 2, True, 1, True],
        "topic": [2, 2, [42, 43], [42, 43]],
        "lock": [2, True, [2], False],
        "election": [True, None, True, True, False]}
    if got != want:
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise AssertionError(f"facades: answers differ: {bad}")
    launched = counts(ks)
    if min(launched["admit_submits"], launched["ack_commit"]) < rg.rounds:
        raise AssertionError(f"facades: launches {launched} in {rg.rounds} "
                             "rounds")
    _, errs = step_fns(kernels, seen, "the facades engine's step")
    say(f"facades: value, long, map, set, queue, multimap, topic (fan-out to "
        f"two subscribers), lock (two-holder hand-off by grant event) and "
        f"election (hand-off on resign) answered as the reference's facade "
        f"tests on RaftGroups({G}, 3) on {card}, {rg.rounds} rounds, "
        f"launches {launched}; the fused kernels equal their plain versions "
        f"on its step's arguments")
    return launched, errs


VERDICT = dict(groups=10_000, sample=30, rounds=150)  # the default: 99 x 1000
DEEP_VERDICT = dict(groups=2_000, epochs=8)           # the default: 40 epochs


def phase_verdict(ks: dict, card: str, sizes=(VERDICT, DEEP_VERDICT)
                  ) -> dict:
    """The linearizability verdicts on the card at the reference's width,
    depth cut: the client plane under the nemesis (period 12) and
    membership churn (5 lanes, 3 voters), then the deep plane; a history
    that is not linearizable fails the run. Then each verdict's fused
    kernels against their plain versions on its last step's arguments."""
    from copycat_tpu_torch.ops import consensus as cons
    from copycat_tpu_torch.ops import kernels
    from copycat_tpu_torch.testing import verdict
    out = {}
    for name, run, kw in zip(("verdict", "deep verdict"),
                             (verdict.run_verdict, verdict.run_deep_verdict),
                             sizes):
        zero_counts(ks)
        t0 = time.perf_counter()
        box = {}
        seen = record_inputs(cons, STEP_FNS, lambda: box.update(
            res=run(device="cuda", **kw)))
        res = box["res"]
        secs = time.perf_counter() - t0
        launched = counts(ks)
        inv = res["device_telemetry"]["invariants"]["violations"]
        say(f"{name}: linearizable {res['linearizable']}, checked_ops "
            f"{res['checked_ops']}, violations {res['violations']}, "
            f"undecided {res['undecided_groups']}, invariant violations "
            f"{inv}, {secs:.1f}s, launches {launched}, on {card}")
        say(f"{name}: " + json.dumps(res))
        if not res["linearizable"] or inv:
            raise AssertionError(f"{name}: not linearizable: {res}")
        if min(launched["admit_submits"], launched["ack_commit"]) == 0:
            raise AssertionError(f"{name}: the fused kernels never launched")
        masked = seen["ack_commit"][1]["view"] is not None
        if masked != (name == "verdict"):    # churn: dynamic membership
            raise AssertionError(f"{name}: masked kernels {masked}")
        _, errs = step_fns(kernels, seen, f"the {name}'s last step")
        say(f"{name}: the fused kernels ("
            + ("member-masked" if masked else "static") + ") equal their "
            "plain versions on its last step's arguments")
        out[name] = dict(res, seconds=secs, launches=launched,
                         max_abs_err=errs)
    return out


SERVER_ENGINE = dict(capacity=10_000, num_peers=3, log_slots=64,
                     submit_slots=4)
SERVER_MIX = dict(long=500, map=200, set=100, queue=100, lock=50,
                  election=50)
SERVER_WAVES, SERVER_REUSE = 10, 100    # add_and_get waves, groups reused
SERVER_UNSET = 100                      # longs the never-set wave runs on
SERVER_KINDS = dict(long="DeviceAtomicValueState", map="DeviceMapState",
                    set="DeviceSetState", queue="DeviceQueueState",
                    lock="DeviceLockState",
                    election="DeviceLeaderElectionState")


class ServerCluster:
    """Three port ``AtomixServer``s (executor="tpu", one device engine
    each) and two ``AtomixClient``s in one process over the port's
    ``LocalTransport``."""

    def __init__(self, engine_config) -> None:
        from copycat_tpu_torch.io.local import (LocalServerRegistry,
                                                LocalTransport)
        from copycat_tpu_torch.io.transport import Address
        from copycat_tpu_torch.manager.atomix import (AtomixClient,
                                                      AtomixServer)
        self.config = engine_config
        registry = LocalServerRegistry()
        self.addrs = [Address("local", 9100 + i) for i in range(3)]
        self.servers = [
            AtomixServer(a, self.addrs, LocalTransport(registry),
                         election_timeout=1.0, heartbeat_interval=0.2,
                         session_timeout=120.0, executor="tpu",
                         engine_config=engine_config)
            for a in self.addrs]
        self.clients = [AtomixClient(self.addrs, LocalTransport(registry),
                                     session_timeout=120.0)
                        for _ in range(2)]

    async def open(self) -> None:
        await asyncio.gather(*(s.open() for s in self.servers))
        for c in self.clients:
            await c.open()

    async def close(self) -> None:
        for node in self.clients + self.servers:
            await asyncio.wait_for(node.close(), 30)

    def managers(self) -> list:
        return [s.server.state_machine for s in self.servers]

    def rounds(self) -> list[int]:
        return [m.device_engine._groups.rounds for m in self.managers()]

    async def settle(self) -> None:
        """Wait until every server has applied what any has committed."""
        target = max(s.server.commit_index for s in self.servers)
        for _ in range(3000):
            if min(s.server.last_applied for s in self.servers) >= target:
                return
            await asyncio.sleep(0.02)
        raise AssertionError("server: the followers did not catch up")


def group_of(mgr, key: str) -> int:
    return mgr.resources[mgr.keys[key]].state_machine._group


def replica_reads(mgr, ap, longs: list, puts: list) -> tuple:
    """The longs ``longs`` and the map entries ``puts`` read through the
    manager's engine (``run_query_vector``) on the groups it placed them
    in."""
    eng = mgr.device_engine
    lg = [group_of(mgr, k) for k in longs]
    n = len(lg)
    got_longs = eng.run_query_vector(lg, [ap.OP_VALUE_GET] * n, [0] * n,
                                     [0] * n, [0] * n)
    mg = [group_of(mgr, m) for m, _, _ in puts]
    n = len(mg)
    got_maps = eng.run_query_vector(mg, [ap.OP_MAP_GET] * n,
                                    [k for _, k, _ in puts], [0] * n,
                                    [0] * n)
    return got_longs, got_maps


async def each(coros, chunk: int = 1000) -> list:
    """Await ``coros``, ``chunk`` of them in flight at a time."""
    out = []
    coros = list(coros)
    for i in range(0, len(coros), chunk):
        out += await asyncio.gather(*coros[i:i + chunk])
    return out


async def until(cond, what: str) -> None:
    for _ in range(600):
        if cond():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"server: {what}")


TRAFFIC = ("longs", "maps", "sets", "queues", "locks", "elections")


async def server_traffic(cluster, ap, cons, card: str) -> dict:
    """The ``server`` phase on an open cluster, every answer and event
    checked against a plain Python model: the longs, maps and sets with
    their traffic; server 0's manager snapshot restored into a fresh
    server; the queues, locks and elections with theirs; every replica
    read through its engine; freed groups reused. Each stage's wall
    seconds and engine rounds (all servers) go into ``stages``; also the
    arguments one server-engine step handed the fused kernels (``seen``)
    and a profiler window of the server engines' rounds."""
    from copycat_tpu_torch.atomic import DistributedAtomicLong
    from copycat_tpu_torch.collections import (DistributedMap,
                                               DistributedQueue,
                                               DistributedSet)
    from copycat_tpu_torch.coordination import (DistributedLeaderElection,
                                                DistributedLock)
    from copycat_tpu_torch.manager.atomix import AtomixServer
    from copycat_tpu_torch.io.local import LocalServerRegistry, LocalTransport
    from copycat_tpu_torch.io.transport import Address
    from copycat_tpu_torch.utils.tasks import spawn
    c1, c2 = cluster.clients
    rng = np.random.default_rng(7)
    keys = {kind: [f"{kind}{i}" for i in range(n)]
            for kind, n in SERVER_MIX.items()}
    out = dict(keys=keys, seen=None, profile={}, stages={}, wave_s=[])
    answered = 0

    @contextlib.asynccontextmanager
    async def stage(name: str):
        t, r = time.perf_counter(), sum(cluster.rounds())
        yield
        s, n = out["stages"].get(name, (0.0, 0))
        out["stages"][name] = (round(s + time.perf_counter() - t, 3),
                               n + sum(cluster.rounds()) - r)

    async with stage("create"):
        longs = await each(c1.get(k, DistributedAtomicLong)
                           for k in keys["long"])
        maps = await each(c1.get(k, DistributedMap) for k in keys["map"])
        sets = await each(c1.get(k, DistributedSet) for k in keys["set"])
    model = [0] * len(longs)

    async def long_wave(n: int = len(longs)) -> float:
        """Two ``add_and_get`` racing on each of the first ``n`` longs, all
        in flight at once; returns the wave's wall seconds."""
        nonlocal answered
        t_wave = time.perf_counter()
        amounts = rng.integers(-1000, 1000, n)
        got = await each((lg.add_and_get(int(a)) for lg, a in
                          zip(longs[:n] * 2, np.tile(amounts, 2))),
                         chunk=2 * n)
        answered += len(got)
        for i, a in enumerate(amounts):
            s, a = model[i], int(a)
            pair = sorted((got[i], got[i + n]))
            if pair != sorted((s + a, s + 2 * a)):
                raise AssertionError(f"server: long {i} answered {pair} "
                                     f"after {s} + 2 x {a}")
            model[i] = s + 2 * a
        return round(time.perf_counter() - t_wave, 3)

    async with stage("longs"):
        # a first wave on never-set longs: an add_and_get is the client's
        # CAS-retry loop, and two of them racing on an unset register
        # take the CAS's host path, one device query each (the
        # reference's semantics, met by every fresh long); every other
        # register is then set once, so the waves below take the device
        # path alone
        out["unset_wave_s"] = await long_wave(SERVER_UNSET)
        rest = longs[SERVER_UNSET:]
        if await each(lg.set(0) for lg in rest) != [None] * len(rest):
            raise AssertionError("server: a set answered a value")
        answered += len(rest)
        with recording(cons, STEP_FNS) as seen:
            out["wave_s"].append(await long_wave())
        out["seen"] = dict(seen)
    # a profiler window of whole waves, at least 10 rounds of the three
    # servers' engines; its own stage, since the profiler's tracing and
    # summary cost wall time of their own
    async with stage("profiled waves"):
        r0, a0 = sum(cluster.rounds()), answered
        what = ("the server engines' rounds over whole waves of "
                f"{2 * len(longs)} add_and_get through three servers' "
                f"vector pumps, G={cluster.config.capacity} P=3 L=64 S=4, "
                "every pool")
        with profiling(what, card) as window:
            while (sum(cluster.rounds()) - r0 < 10
                   and len(out["wave_s"]) < SERVER_WAVES):
                out["wave_s"].append(await long_wave())
            window["rounds"] = sum(cluster.rounds()) - r0
        out["profile"] = window
        out["profiled_ops"] = answered - a0
    async with stage("longs"):
        while len(out["wave_s"]) < SERVER_WAVES:
            out["wave_s"].append(await long_wave())
    per_map = 5
    puts = [(keys["map"][i], int(k), int(v)) for i in range(len(maps))
            for k, v in zip(rng.choice(1000, per_map, replace=False),
                            rng.integers(0, 10 ** 6, per_map))]
    by_key = dict(zip(keys["map"], maps))
    async with stage("maps"):
        got = await each(by_key[m].put(k, v) for m, k, v in puts)
        if any(g is not None for g in got):
            raise AssertionError("server: a put of a fresh key returned a "
                                 "value")
        device_reads = [
            s.server.metrics.counter("query_ops_device_lane").value
            for s in cluster.servers]
        got = await each(by_key[m].get(k) for m, k, _ in puts)
        if got != [v for _, _, v in puts]:
            raise AssertionError("server: map gets differ from the puts")
        device_reads = sum(
            s.server.metrics.counter("query_ops_device_lane").value - r
            for s, r in zip(cluster.servers, device_reads))
        if device_reads == 0:
            raise AssertionError("server: no read went through the read "
                                 "pump")
        answered += 2 * len(puts)
    async with stage("sets"):
        adds = await each(s.add(v) for v in (1, 2, 3, 2) for s in sets)
        has = await each(s.contains(v) for v in (3, 4) for s in sets)
        if adds != [True] * (3 * len(sets)) + [False] * len(sets) \
                or has != [True] * len(sets) + [False] * len(sets):
            raise AssertionError("server: set answers differ from the model")
        answered += len(adds) + len(has)
    # server 0's manager snapshot (the catalog and the engine blob, the
    # port's checkpoint) restored into a fresh, unopened server
    await cluster.settle()
    mgr = cluster.managers()[0]
    t_snap = time.perf_counter()
    blob = mgr.snapshot_state()
    if blob is NotImplemented or blob["engine"] is None:
        raise AssertionError("server: the manager did not snapshot")
    spare = Address("local", cluster.addrs[-1].port + 1)
    fresh = AtomixServer(spare, [spare],
                         LocalTransport(LocalServerRegistry()),
                         executor="tpu", engine_config=cluster.config)
    restored = fresh.server.state_machine
    restored.restore_state(blob, {})
    got = replica_reads(restored, ap, keys["long"], puts)
    out["restore_s"] = time.perf_counter() - t_snap
    out["blob_mb"] = len(blob["engine"]) / 2 ** 20
    if got != (model, [v for _, _, v in puts]) \
            or restored.device_engine._groups.device \
            != mgr.device_engine._groups.device \
            or restored.keys != mgr.keys:
        raise AssertionError("server: the restored server reads differ")
    del fresh, restored
    async with stage("create 2"):
        queues = await each(c1.get(k, DistributedQueue)
                            for k in keys["queue"])
        locks = [await each(c.get(k, DistributedLock) for k in keys["lock"])
                 for c in (c1, c2)]
        elects = [await each(c.get(k, DistributedLeaderElection)
                             for k in keys["election"]) for c in (c1, c2)]
    await cluster.settle()
    capacity = cluster.config.capacity
    for m in cluster.managers():
        for kind, names in keys.items():
            for k in names:
                sm = m.resources[m.keys[k]].state_machine
                if type(sm).__name__ != SERVER_KINDS[kind] \
                        or not 0 <= sm._group < capacity:
                    raise AssertionError(
                        f"server: {k} is a {type(sm).__name__} on group "
                        f"{getattr(sm, '_group', None)}")
    async with stage("queues"):
        offers = await each(q.offer(v) for v in (7, 8, 9) for q in queues)
        polls = await each(q.poll() for _ in range(2) for q in queues)
        peeks = await each(q.peek() for q in queues)
        if offers != [True] * (3 * len(queues)) \
                or polls != [7] * len(queues) + [8] * len(queues) \
                or peeks != [9] * len(queues):
            raise AssertionError("server: queue answers differ from the "
                                 "model")
        answered += len(offers) + len(polls) + len(peeks)
    # a lock hand-off on every lock: client 1 holds, client 2 queues, the
    # release grants it to client 2 (the grant event)
    async with stage("locks"):
        await each(lk.lock() for lk in locks[0])
        tries = await each(lk.try_lock() for lk in locks[1])
        waiters = [spawn(lk.lock()) for lk in locks[1]]
        await asyncio.sleep(0.5)
        if any(tries) or any(w.done() for w in waiters):
            raise AssertionError("server: a held lock was granted twice")
        await each(lk.unlock() for lk in locks[0])
        await asyncio.wait_for(asyncio.gather(*waiters), 120)
        held = await each(lk.try_lock() for lk in locks[0])
        await each(lk.unlock() for lk in locks[1])
        if any(held):
            raise AssertionError("server: a handed-off lock was free")
        answered += 6 * len(locks[0])
    # a succession on every election: client 1's candidate wins, client
    # 2's waits, client 1 resigns and client 2's is promoted
    async with stage("elections"):
        epochs = [[[] for _ in elects[0]] for _ in range(2)]
        await each(e.on_election(epochs[0][i].append)
                   for i, e in enumerate(elects[0]))
        await each(e.on_election(epochs[1][i].append)
                   for i, e in enumerate(elects[1]))
        await until(lambda: all(epochs[0]),
                    "a first candidate was not elected")
        if any(epochs[1]):
            raise AssertionError("server: two leaders of one election")
        await each(e.resign() for e in elects[0])
        await until(lambda: all(epochs[1]), "a successor was not promoted")
        fenced = await each(
            e.is_leader(epochs[j][i][0]) for j in (1, 0)
            for i, e in enumerate(elects[1]))
        if fenced != [True] * len(elects[1]) + [False] * len(elects[1]) \
                or any(b[0] <= a[0] for a, b in zip(*epochs)):
            raise AssertionError("server: election epochs differ from the "
                                 "model")
        answered += 5 * len(elects[0])
    # every replica, read through its own engine, equals the model
    await cluster.settle()
    for i, m in enumerate(cluster.managers()):
        if replica_reads(m, ap, keys["long"], puts) != (
                model, [v for _, _, v in puts]):
            raise AssertionError(f"server: engine {i}'s replica differs "
                                 "from the model")
    # group reuse: longs deleted, as many new ones take their groups
    # (on every server) and read 0
    reuse = SERVER_REUSE
    freed = [{group_of(m, k) for k in keys["long"][:reuse]}
             for m in cluster.managers()]
    async with stage("reuse"):
        await asyncio.gather(*(lg.delete() for lg in longs[:reuse]))
        fresh = await asyncio.gather(*(
            c1.get(f"relong{i}", DistributedAtomicLong)
            for i in range(reuse)))
        zeros = await asyncio.gather(*(f.get() for f in fresh))
        await cluster.settle()
    for m, want in zip(cluster.managers(), freed):
        got = {group_of(m, f"relong{i}") for i in range(reuse)}
        if got != want:
            raise AssertionError(f"server: new resources took groups "
                                 f"{sorted(got)}, not the freed "
                                 f"{sorted(want)}")
    if zeros != [0] * reuse:
        raise AssertionError("server: a reused group was not clean")
    st = out["stages"]
    out.update(answered=answered - out.get("profiled_ops", 0),
               traffic_s=sum(st[k][0] for k in TRAFFIC),
               create_s=st["create"][0] + st["create 2"][0],
               reuse_s=st["reuse"][0])
    return out


def phase_server(ks: dict, card: str) -> tuple[dict, dict, dict]:
    """The port's server on the card: three ``AtomixServer(executor=
    "tpu")`` with 10,000-group engines, two clients, 1,000 device
    resources and their traffic, checked against a plain model
    (:func:`server_traffic`); each server-engine round launches each fused
    kernel once, and one server step's arguments hold them against their
    plain versions."""
    from copycat_tpu_torch.manager.device_executor import DeviceEngineConfig
    from copycat_tpu_torch.ops import apply as ap
    from copycat_tpu_torch.ops import consensus as cons
    from copycat_tpu_torch.ops import kernels

    config = DeviceEngineConfig(**SERVER_ENGINE)
    t_phase = time.perf_counter()

    async def run() -> dict:
        cluster = ServerCluster(config)
        t0 = time.perf_counter()
        await cluster.open()
        open_s = time.perf_counter() - t0
        try:
            zero_counts(ks)
            r0 = cluster.rounds()
            out = await server_traffic(cluster, ap, cons, card)
            rounds = [b - a for a, b in zip(r0, cluster.rounds())]
            launched = counts(ks)
            if launched["kth_largest"] or any(
                    launched[n] != sum(rounds) for n in STEP_FNS):
                raise AssertionError(
                    f"server: launches {launched} in {sum(rounds)} engine "
                    f"rounds ({rounds})")
            errs = step_fns(kernels, out["seen"], "a server engine's step")[1]
            return dict(out, rounds=rounds, launches=launched, errs=errs,
                        open_s=open_s)
        finally:
            await cluster.close()

    res = asyncio.run(run())
    res.pop("seen")
    wall = time.perf_counter() - t_phase
    say(f"server: 3 AtomixServer(executor=\"tpu\") x G={config.capacity} "
        f"P=3 L=64 S=4 on {card}; {sum(SERVER_MIX.values())} device "
        f"resources {SERVER_MIX}, created in {res['create_s']:.3f} s; {res['answered']} ops "
        f"answered in {res['traffic_s']:.3f} s outside the profiler window "
        f"({res['answered'] / res['traffic_s']:.1f} client-visible ops/s); "
        f"engine rounds per server {res['rounds']}; launches "
        f"{res['launches']}; every answer and event equal to the model, the "
        f"three replicas equal; {SERVER_REUSE} deletes and creates reusing "
        f"the freed groups clean in {res['reuse_s']:.3f} s; server 0's manager "
        f"snapshot ({res['blob_mb']:.3f} MiB engine blob) restored into a "
        f"fresh server in {res['restore_s']:.3f} s with equal reads; the "
        f"fused kernels equal their plain versions on a server step; "
        f"servers opened in {res['open_s']:.3f} s, phase {wall:.1f} s")
    say("server: (wall s, engine rounds of the three servers) by stage: "
        + json.dumps(res["stages"]) + "; add_and_get waves (s): "
        + json.dumps(res["wave_s"]))
    per_wave = 2 * SERVER_MIX["long"]
    say(f"server: add_and_get on {SERVER_UNSET} never-set longs (the CAS "
        f"host path) {2 * SERVER_UNSET / res['unset_wave_s']:.1f} ops/s "
        f"({2 * SERVER_UNSET} in {res['unset_wave_s']:.3f} s), on set longs "
        f"{per_wave / float(np.median(res['wave_s'])):.1f} ops/s (median of "
        f"{len(res['wave_s'])} waves of {per_wave})")
    return res["launches"], res["errs"], res


PUBLIC_API = (("spi", {}), ("readmix", dict(bursts=3)), ("apply", {}))


async def check_spi(run) -> dict:
    """Every counter reads ``bursts × waves``: each increment applied once."""
    finals = await each(c.get() for c in run.counters)
    bad = [i for i, v in enumerate(finals) if v != run.expected]
    if bad:
        raise AssertionError(f"spi: {len(bad)} counters differ from "
                             f"{run.expected}, first ctr{bad[0]} reads "
                             f"{finals[bad[0]]}")
    return {"checked": len(finals)}


async def check_readmix(run) -> dict:
    """Every read equals the write before it on its instance, every
    instance wrote once a burst (1, 2, ...), and every counter reads
    ``bursts``."""
    writes = {}
    for i, written, reads in run.answers:
        if any(r != written for r in reads):
            raise AssertionError(f"readmix: ctr{i} wrote {written} and "
                                 f"read {reads}")
        writes.setdefault(i, []).append(written)
    want = list(range(1, run.bursts + 1))
    bad = [i for i in range(len(run.counters))
           if sorted(writes.get(i, [])) != want]
    finals = await each(c.get() for c in run.counters)
    bad += [i for i, v in enumerate(finals) if v != run.bursts]
    if bad:
        raise AssertionError(f"readmix: {len(bad)} counters off, first "
                             f"ctr{bad[0]}")
    return {"checked": len(run.answers), "latencies": run.latencies}


async def check_apply(run) -> dict:
    """Each key's ``get_and_set`` returns are its initial ``None`` and
    every value written to it but the last applied, each once (one chain:
    every write applied exactly once), and the key reads the last."""
    from collections import Counter

    finals = await each(h.get() for h in run.handles[0])
    by_key = {}
    for k, v, old in run.writes:
        by_key.setdefault(k, []).append((v, old))
    for k, final in enumerate(finals):
        mine = by_key.get(k, [])
        returned = Counter(old for _, old in mine)
        written = Counter([None] + [v for v, _ in mine])
        written[final] -= 1
        if returned != +written:
            raise AssertionError(f"apply: key k{k}'s writes do not form "
                                 f"one chain ({len(mine)} writes)")
    return {"checked": len(run.writes), "keys": len(finals),
            "latencies": run.latencies}


def phase_public_api(ks: dict, card: str) -> tuple[dict, dict, dict]:
    """The bench's public-API scenarios through the port's
    ``AtomixServer(executor="tpu")`` on the card: ``spi`` at its defaults
    (1,000 ``DistributedAtomicLong``s, 5 bursts), ``readmix`` (1,000
    instances, ``atomic``, 3 bursts) and ``apply`` at its defaults (4
    groups, 24 sessions, 256 zipfian keys); each checked on every counter
    and key (:func:`check_spi`, :func:`check_readmix`,
    :func:`check_apply`). Around each, the kernel counts are zeroed and
    read: each engine round launched each fused kernel once and the tally
    never; the last engine step's arguments hold both against their
    plain versions."""
    from copycat_tpu_torch import bench
    from copycat_tpu_torch.ops import consensus as cons
    from copycat_tpu_torch.ops import kernels

    checks = dict(spi=check_spi, readmix=check_readmix, apply=check_apply)
    launches, errs, out = {}, {}, {}
    for name, kw in PUBLIC_API:
        seen_run = {}

        async def check(run, _name=name):
            seen_run.update(await checks[_name](run), engine=run.engine)

        zero_counts(ks)
        t0 = time.perf_counter()
        with recording(cons, STEP_FNS) as seen:
            result = getattr(bench, f"run_{name}")(check=check, **kw)
        wall = time.perf_counter() - t0
        launched = counts(ks)
        rounds = seen_run["engine"]._groups.rounds
        if launched["kth_largest"] or any(launched[n] != rounds
                                          for n in STEP_FNS):
            raise AssertionError(f"{name}: launches {launched} in {rounds} "
                                 "engine rounds")
        errs[name] = step_fns(kernels, dict(seen), f"a {name} engine's "
                              "step")[1]
        if name == "spi":
            p50, p99 = result["p50_latency_ms"], result["p99_latency_ms"]
        else:
            lat = np.sort(np.asarray(seen_run["latencies"])) * 1e3
            p50, p99 = float(lat[len(lat) // 2]), float(
                lat[int(len(lat) * 0.99)])
        per_round = {n: launched[n] / rounds for n in launched}
        say(f"public_api {name}: {result['value']:.1f} client-visible "
            f"{result['unit']} (best of {result['reps_n']}, reps "
            f"{result['reps_min']:.1f}..{result['reps_max']:.1f}), p50 "
            f"{p50:.3f} ms, p99 {p99:.3f} ms, {rounds} engine rounds, "
            f"launches per round {per_round}, {wall:.1f} s wall, on {card}; "
            f"{seen_run['checked']} answers checked, every one right; the "
            "fused kernels equal their plain versions on its last step")
        say(f"public_api {name}: " + json.dumps(result))
        launches[name] = launched
        out[name] = dict(result=result, p50_ms=p50, p99_ms=p99,
                         rounds=rounds, wall_s=wall)
    # where an spi engine round's time goes: the spi scenario again, two
    # bursts, under the profiler (server open and instance creation
    # included: every engine round of the run)
    box = {}

    async def engine_of(run):
        box["engine"] = run.engine

    what = ("every engine round of an spi run: one server, 1,000 "
            "DistributedAtomicLong, capacity 1,024 P=3 L=16 S=4, counters "
            "only, open, creation and 2 bursts")
    with profiling(what, card) as window:
        bench.run_spi(bursts=2, check=engine_of)
        window["rounds"] = box["engine"]._groups.rounds
    out["spi_profile"] = window
    worst = {n: max(e[n] for e in errs.values()) for n in STEP_FNS}
    return launches, worst, out


# the operator phase: the spi engine (PERF.md §4) on disk storage, served
# over loopback TCP with the stats listener, read through the port's CLI
OPERATOR_ENGINE = dict(capacity=1_024, num_peers=3, log_slots=16,
                       submit_slots=4)
OPERATOR_LONGS, OPERATOR_TRACED = 1_000, 100
OPERATOR_DIR = pathlib.Path(__file__).resolve().parent / "_smoke_operator"


def run_verb(argv: list) -> tuple[int, str, float]:
    """``python -m copycat_tpu_torch.cli <argv>`` in this process: its exit
    code, standard output and wall seconds (each verb runs its own event
    loop, so call this off the server's loop)."""
    import io

    from copycat_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        code = 0
    except SystemExit as exc:
        code = 0 if exc.code is None else exc.code
    return code, out.getvalue(), time.perf_counter() - t0


def operator_verbs(stats: str, trace_dir: str) -> list:
    """The operator's reads of one server, each an argv of the CLI."""
    return [["stats", stats, "--what", "all"],
            ["stats", stats, "--what", "flight"],
            ["stats", stats, "--what", "health"],
            ["doctor", stats], ["trace", stats],
            ["timeline", stats, "--last", "60"], ["top", stats, "--once"],
            ["profile", stats],
            ["profile", "--device", trace_dir, "--top", "1000"]]


async def operator_traffic(device, trace_dir: str, log_dir: str) -> dict:
    """One port ``AtomixServer(executor="tpu")`` over loopback TCP with
    its stats listener, the spi engine with device telemetry, disk
    storage; one ``AtomixClient``: 1,000 ``DistributedAtomicLong``, a
    burst of ``add_and_get(1)`` on each plain, one under
    ``SlowDiskNemesis(0.02)``, one with a ``LoopHoldNemesis(0.15)`` hold,
    one under ``utils.profiling.trace`` (the card's lanes) and a traced
    one on 100 of them; every answer checked against its count. Then
    every operator verb of the port's CLI against the stats listener.
    Returns the burst rates, the verbs' outputs and walls, and the
    engine."""
    from copycat_tpu_torch.atomic import DistributedAtomicLong
    from copycat_tpu_torch.deploy.topology import allocate_ports
    from copycat_tpu_torch.io.tcp import TcpTransport
    from copycat_tpu_torch.io.transport import Address
    from copycat_tpu_torch.manager.atomix import AtomixClient, AtomixServer
    from copycat_tpu_torch.manager.device_executor import DeviceEngineConfig
    from copycat_tpu_torch.ops import apply as ap
    from copycat_tpu_torch.server.log import Storage, StorageLevel
    from copycat_tpu_torch.testing.nemesis import (LoopHoldNemesis,
                                                   SlowDiskNemesis)
    from copycat_tpu_torch.utils import tracing
    from copycat_tpu_torch.utils.profiling import trace

    port, = allocate_ports(1)
    addr = Address("127.0.0.1", port)
    server = AtomixServer(
        addr, [addr], TcpTransport(), election_timeout=0.5,
        heartbeat_interval=0.1, session_timeout=60.0, executor="tpu",
        stats_port=0, storage=Storage(StorageLevel.DISK, directory=log_dir),
        engine_config=DeviceEngineConfig(
            **OPERATOR_ENGINE, resource=ap.ResourceConfig.counters_only(),
            telemetry=True, device=device))
    await server.open()
    client = AtomixClient([addr], TcpTransport(), session_timeout=60.0)
    await client.open()
    raft = server.server
    try:
        longs = await each(client.get(f"op{i}", DistributedAtomicLong)
                           for i in range(OPERATOR_LONGS))
        rates = {}

        async def burst(name: str, want: int, n: int = OPERATOR_LONGS,
                        during=None) -> None:
            t0 = time.perf_counter()
            calls = asyncio.gather(*(c.add_and_get(1) for c in longs[:n]))
            if during is not None:
                during()
            got = await calls
            rates[name] = n / (time.perf_counter() - t0)
            bad = [i for i, v in enumerate(got) if v != want]
            if bad:
                raise AssertionError(
                    f"operator {name}: {len(bad)} answers differ from "
                    f"{want}, first op{bad[0]} -> {got[bad[0]]}")

        await burst("plain", 1)
        slow = SlowDiskNemesis(raft, delay_s=0.02)
        slow.install()
        try:
            await burst("slow_disk", 2)
        finally:
            slow.remove()
        hold = LoopHoldNemesis(raft, delay_s=0.15)
        await burst("loop_hold", 3, during=hold.inject)
        with trace(trace_dir):
            await burst("profiled", 4)
        tracing.TRACER.clear()
        tracing.enable()
        try:
            await burst("traced", 5, n=OPERATOR_TRACED)
        finally:
            tracing.disable()
        finals = await each(c.get() for c in longs)
        want = [5] * OPERATOR_TRACED + [4] * (OPERATOR_LONGS
                                              - OPERATOR_TRACED)
        if finals != want:
            raise AssertionError("operator: a long does not read its "
                                 "bursts")
        stats = f"127.0.0.1:{server.stats.port}"
        verbs = []
        for argv in operator_verbs(stats, trace_dir):
            verbs.append((argv, *await asyncio.to_thread(run_verb, argv)))
        return dict(rates=rates, verbs=verbs,
                    engine=raft.state_machine.device_engine)
    finally:
        try:
            await asyncio.wait_for(client.close(), 10)
        finally:
            await asyncio.wait_for(server.close(), 10)


def check_verbs(verbs: list) -> None:
    """Every verb exited 0; the flight ring holds both injected faults;
    the device profile names both fused kernels."""
    for argv, code, out, _ in verbs:
        if code != 0:
            raise AssertionError(f"operator: `{' '.join(argv)}` exited "
                                 f"{code}: {out[-400:]}")
    flight = next(out for argv, _, out, _ in verbs if argv[-1] == "flight")
    for fault in ("fault=slow_disk", "fault=loop_hold"):
        if fault not in flight:
            raise AssertionError(f"operator: no {fault} in the flight "
                                 f"ring:\n{flight[-600:]}")
    device = next(out for argv, _, out, _ in verbs if "--device" in argv)
    for name in STEP_FNS:
        if name not in device:
            raise AssertionError(f"operator: profile --device lists no "
                                 f"{name} kernel:\n{device[:600]}")


def phase_operator(ks: dict, card: str) -> tuple[dict, dict, dict]:
    """The operator entry points against a device server on the card
    (:func:`operator_traffic`, :func:`check_verbs`). Around the whole
    phase the kernel counts are zeroed and read: one launch of each fused
    kernel per engine round and none of the tally; the last engine
    step's arguments hold both against their plain versions."""
    import shutil

    from copycat_tpu_torch.ops import consensus as cons
    from copycat_tpu_torch.ops import kernels

    trace_dir, log_dir = OPERATOR_DIR / "traces", OPERATOR_DIR / "log"
    shutil.rmtree(OPERATOR_DIR, ignore_errors=True)
    log_dir.mkdir(parents=True)
    try:
        zero_counts(ks)
        t0 = time.perf_counter()
        with recording(cons, STEP_FNS) as seen:
            out = asyncio.run(operator_traffic("cuda", str(trace_dir),
                                               str(log_dir)))
        wall = time.perf_counter() - t0
        launched = counts(ks)
    finally:
        shutil.rmtree(OPERATOR_DIR, ignore_errors=True)
    check_verbs(out["verbs"])
    rounds = out["engine"]._groups.rounds
    if launched["kth_largest"] or any(launched[n] != rounds
                                      for n in STEP_FNS):
        raise AssertionError(f"operator: launches {launched} in {rounds} "
                             "engine rounds")
    errs = step_fns(kernels, dict(seen), "an operator engine's step")[1]
    for argv, code, text, secs in out["verbs"]:
        say(f"operator: `copycat-tpu {' '.join(argv)}` exit {code} in "
            f"{secs:.3f} s, {len(text.splitlines())} lines")
        if "--device" in argv:
            for row in text.splitlines():
                if any(name in row for name in STEP_FNS):
                    say(f"operator: profile --device row: {row.strip()}")
    rates = ", ".join(f"{name} {v:.1f}" for name, v in out["rates"].items())
    per_round = {n: launched[n] / rounds for n in launched}
    say(f"operator: bursts of add_and_get (ops/s): {rates}; {rounds} engine "
        f"rounds, launches per round {per_round}; {wall:.1f} s wall, on "
        f"{card}; every answer right, both faults in the flight ring, both "
        "fused kernels in the device profile and equal to their plain "
        "versions on the last step")
    return launched, errs, dict(rates=out["rates"], rounds=rounds,
                                wall_s=wall)


DEPLOY_DIR = pathlib.Path(__file__).resolve().parent / "_smoke_deploy"
DEPLOY_LIMIT_S = 420       # the scenario takes about a minute on the card's host


def run_deploy_bench(limit_s: float = DEPLOY_LIMIT_S) -> tuple[dict, dict]:
    """``python -m copycat_tpu_torch.bench --scenario compartment
    --metrics-json ...`` in its own interpreter, as an operator runs it
    (the bench probes the card first): its result line and its artifact.
    The topology's directories live under ``DEPLOY_DIR`` (its
    ``TMPDIR``), deleted after. Past ``limit_s`` the bench gets SIGINT,
    which tears the supervised topology down, and the phase fails."""
    import os
    import shutil
    import signal
    import subprocess

    shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    DEPLOY_DIR.mkdir(parents=True)
    artifact, log = DEPLOY_DIR / "compartment.json", DEPLOY_DIR / "bench.log"
    root = str(pathlib.Path(__file__).resolve().parent)
    env = dict(os.environ, TMPDIR=str(DEPLOY_DIR), PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    try:
        with open(log, "wb") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "copycat_tpu_torch.bench",
                 "--scenario", "compartment", "--metrics-json",
                 str(artifact)], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=err)
            try:
                out, _ = proc.communicate(timeout=limit_s)
            except subprocess.TimeoutExpired:
                proc.send_signal(signal.SIGINT)
                try:
                    proc.communicate(timeout=60)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                raise AssertionError(
                    f"deploy: compartment ran past {limit_s} s:\n"
                    + log.read_text(errors="replace")[-3000:])
        if proc.returncode != 0:
            raise AssertionError(
                f"deploy: compartment exited {proc.returncode}:\n"
                + log.read_text(errors="replace")[-3000:])
        for line in log.read_text(errors="replace").splitlines():
            if line.startswith(("bench[compartment]", "supervisor:")):
                say(f"deploy: {line}")
        return (json.loads(out.decode().strip().splitlines()[-1]),
                json.loads(artifact.read_text()))
    finally:
        shutil.rmtree(DEPLOY_DIR, ignore_errors=True)


def phase_deploy(card: str) -> dict:
    """The bench's ``compartment`` scenario at the reference's defaults
    (:func:`run_deploy_bench`): a supervised topology of OS processes (3
    members × 4 groups serving the counter machine on the host, ingress
    tiers 1, 2 and 4), 8 clients × 600 ops a burst, 3 bursts, disk
    storage, the kill -9 nemesis on the widest tier. Fails unless no
    acknowledged write is lost at any width and both corpses restart.
    Host numbers, taken on the card's machine."""
    t0 = time.perf_counter()
    result, artifact = run_deploy_bench()
    wall = time.perf_counter() - t0
    if artifact["meta"]["host"]["device"] != "cuda":
        raise AssertionError("deploy: the bench did not probe the card")
    for w in result["widths"]:
        if w["lost_acked_writes"]:
            raise AssertionError(f"deploy: width {w['width']} lost "
                                 f"{w['lost_acked_writes']} acked writes")
        rows = [a for a in w["ingress_attribution"].values() if a]
        queue = [a["latency.ingress_queue_ms"]["mean"] for a in rows
                 if a.get("latency.ingress_queue_ms")]
        retries = sum(a["ingress.proxy_retries"] or 0 for a in rows)
        say(f"deploy width {w['width']}: {w['ops_per_sec']:.1f} committed "
            f"ops/s (best of {w['reps_n']}, reps {w['reps_min']:.1f}.."
            f"{w['reps_max']:.1f}), mean ingress queue "
            f"{np.mean(queue) if queue else float('nan'):.3f} ms, proxy "
            f"retries {retries}, acked {w['acked_ops']} / in doubt "
            f"{w['indeterminate_ops']} / lost {w['lost_acked_writes']} "
            f"(host numbers, on the machine of {card})")
    nemesis = result.get("nemesis")
    if not nemesis or not nemesis["restored"] or min(
            nemesis["restarts"].values()) < 1:
        raise AssertionError(f"deploy: the nemesis corpses did not both "
                             f"restart: {nemesis}")
    say(f"deploy: nemesis {json.dumps(nemesis)}; {wall:.1f} s wall "
        "(the bench's probe of the card included)")
    say("deploy: " + json.dumps(result))
    return dict(result=result, wall_s=wall)


SCENARIO_DIR = pathlib.Path(__file__).resolve().parent / "_smoke_scenarios"
# The bench's host-plane scenarios at the reference's default widths
# (every knob but the cut one at its default, which is the reference's),
# cut in depth so that the phase stays near 45 s (PERF.md, Findings): one
# timed burst where the reference runs 5; fanout and recovery as the
# reference's (fanout's 3 bursts: its last is the settled warm burst).
HOST_SCENARIOS = (
    ("fanout", {"COPYCAT_EDGE_READS": "1"}),
    ("cluster", {"COPYCAT_BENCH_CLUSTER_BURSTS": "1"}),
    ("sharded", {"COPYCAT_BENCH_SHARDED_BURSTS": "1"}),
    ("recovery", {}),
)
# at most this share of the last fanout burst's reads may reach the
# server: the replica's read-your-writes gate sends a read back to the
# server while a writer's delta is in flight, in the reference as in the
# port, so a few do (PERF.md, Findings)
FANOUT_WARM_SERVER_SHARE = 0.05


@contextlib.contextmanager
def env_set(values: dict):
    """``os.environ`` with ``values`` set, restored after."""
    import os

    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_host_scenario(bench, name: str) -> tuple[dict, dict]:
    """``bench.run_<name>`` with a hook that reads back what the scenario
    wrote: every key of ``cluster`` and ``sharded`` through the public API
    (256 reads in flight), ``fanout``'s counters and server reads,
    ``recovery``'s joiner and leader in each pass."""
    from copycat_tpu_torch.testing.counter_machine import ClusterGet
    from copycat_tpu_torch.utils import knobs

    seen: dict = {"passes": []}

    async def read_back(clients, keys) -> dict:
        got = {}
        for i in range(0, len(keys), 256):
            part = keys[i:i + 256]
            got.update(zip(part, await asyncio.gather(*(
                clients[j % len(clients)].submit(ClusterGet(key=k))
                for j, k in enumerate(part)))))
        return got

    async def check(run):
        if name == "fanout":
            seen.update(values=[await c.get() for c in run.writer_ctrs[0]],
                        writes=run.writes, server_reads=run.server_reads)
        elif name == "recovery":
            seen["passes"].append(dict(
                commit=run.leader.commit_index,
                applied=run.joiner.last_applied,
                joined=dict(run.joiner.state_machine.data),
                led=dict(run.leader.state_machine.data),
                per_client=run.per_client))
        else:
            if name == "cluster":
                total = (knobs.get_int("COPYCAT_BENCH_CLUSTER_OPS")
                         * knobs.get_int("COPYCAT_BENCH_CLUSTER_BURSTS"))
                expected = {f"k{i}": total for i in range(len(run.clients))}
            else:
                expected = dict(run.expected)
            seen.update(expected=expected, values=await read_back(
                run.clients, sorted(expected)))

    bench.METRICS_SNAPSHOTS.clear()
    bench.SERIES_WINDOWS.clear()
    return getattr(bench, f"run_{name}")(check=check), seen


def check_host_scenario(name: str, result: dict, metrics: dict,
                        seen: dict) -> str:
    """Fail unless a host scenario's run holds its gate: for ``fanout``
    the trace proof, the edge tier's serves, warm bursts served from the
    replicas and every write counted once; exactly once for ``cluster``
    and ``sharded``; for ``recovery`` the joiner at the leader's commit
    index in both passes with no failed install. Returns what was
    checked."""
    from copycat_tpu_torch.utils import knobs

    if name == "fanout":
        tr = result["trace"]
        if not (tr and tr["client_only"]
                and tr["spans"] == ["client.edge_serve"]
                and tr["members"] == ["client"]):
            raise AssertionError(f"fanout: no cache-served trace proof: {tr}")
        agg = metrics["edge_clients"]
        if not (agg.get("edge.local_serves") and agg.get("edge.seeds")
                and agg.get("edge.deltas_in")):
            raise AssertionError(f"fanout: the edge tier served nothing: "
                                 f"{agg}")
        per_reader = knobs.get_int("COPYCAT_BENCH_FANOUT_READS")
        for count, per_burst in seen["server_reads"].items():
            if per_burst[-1] > FANOUT_WARM_SERVER_SHARE * count * per_reader:
                raise AssertionError(
                    f"fanout: {per_burst[-1]} of the warm burst's "
                    f"{count * per_reader} reads at {count} readers reached "
                    "the server")
        if sum(seen["values"]) != seen["writes"]:
            raise AssertionError(f"fanout: counters {sum(seen['values'])} "
                                 f"!= {seen['writes']} committed writes")
        return (f"trace proof {tr['spans']} {tr['members']}; server reads a "
                f"burst by reader count {seen['server_reads']}"
                f"; {seen['writes']} committed writes, each counted once")
    if name in ("cluster", "sharded"):
        if seen["values"] != seen["expected"]:
            wrong = {k: (seen["values"].get(k), v)
                     for k, v in seen["expected"].items()
                     if seen["values"].get(k) != v}
            raise AssertionError(f"{name}: read back != written: {wrong}")
        return (f"all {len(seen['values'])} keys read back, "
                f"{sum(seen['values'].values())} writes, each applied once")
    passes = seen["passes"]
    for p in passes:
        if (p["applied"] < p["commit"] or p["joined"] != p["led"]
                or set(p["led"].values()) != {p["per_client"]}):
            raise AssertionError(f"recovery: the joiner missed the leader: "
                                 f"{p}")
    fam = result["snap"]
    if len(passes) != 2 or fam["snap.install_failures"] \
            or result["installs_sent"] < 1:
        raise AssertionError(f"recovery: install failed: {fam}")
    return (f"joiner at the leader's commit index "
            f"{[p['commit'] for p in passes]} in both passes with its state, "
            f"{result['installs_sent']} install(s), 0 failed")


def phase_host_scenarios(ks: dict, card: str) -> dict:
    """The bench's host-plane scenarios (``fanout``, ``cluster``,
    ``sharded``, ``recovery``) at the reference's default widths and cut
    depth (``HOST_SCENARIOS``), each checked by
    :func:`check_host_scenario`; they launch no kernel (the counts read 0
    after). Then the port's gate over their four ``--metrics-json``
    artifacts: recorded into a golden with ``--update-golden``, gated
    again (every line ``ok``), and a copy with every value halved must
    exit 1. Temp directories (the recovery logs, artifacts, golden) live
    under ``SCENARIO_DIR``, deleted after. Host numbers, taken on the
    card's machine."""
    import io
    import os
    import shutil
    import tempfile

    from copycat_tpu_torch import bench
    from copycat_tpu_torch.testing import bench_gate

    shutil.rmtree(SCENARIO_DIR, ignore_errors=True)
    scratch = SCENARIO_DIR / "tmp"
    scratch.mkdir(parents=True)
    saved_tempdir = tempfile.tempdir
    out, paths = {}, []
    t_phase = time.perf_counter()
    try:
        tempfile.tempdir = str(scratch)
        for name, cut in HOST_SCENARIOS:
            for knob, value in cut.items():
                if knob.startswith("COPYCAT_BENCH_"):
                    say(f"host_scenarios {name}: cut to {knob}={value} (the "
                        f"reference's default widths otherwise)")
            zero_counts(ks)
            t0 = time.perf_counter()
            with env_set(cut):
                result, seen = run_host_scenario(bench, name)
                checked = check_host_scenario(
                    name, result, bench.METRICS_SNAPSHOTS, seen)
            wall = time.perf_counter() - t0
            launched = counts(ks)
            if any(launched.values()):
                raise AssertionError(f"{name}: host scenario launched "
                                     f"{launched}")
            if os.listdir(scratch):
                raise AssertionError(f"{name}: left {os.listdir(scratch)}")
            path = SCENARIO_DIR / f"{name}.json"
            bench.write_artifact(str(path), result, name, "cuda")
            paths.append(str(path))
            extra = (f", catch-up {result['catchup_s_snapshot']} s install"
                     f"+tail vs {result['catchup_s_replay']} s replay"
                     if name == "recovery" else "")
            say(f"host_scenarios {name}: {result['value']} {result['unit']}"
                f" ({result['metric']}){extra}, {wall:.1f} s wall (host "
                f"numbers, on the machine of {card}); {checked}")
            say(f"host_scenarios {name}: " + json.dumps(result))
            out[name] = dict(result=result, wall_s=wall)

        golden = str(SCENARIO_DIR / "golden.json")

        def gate(*argv) -> tuple[int, str]:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = bench_gate.main(list(argv))
            return rc, buf.getvalue()

        rc, text = gate(*paths, "--golden", golden, "--update-golden")
        if rc != 0:
            raise AssertionError(f"gate --update-golden exited {rc}: {text}")
        rc, text = gate(*paths, "--golden", golden)
        lines = [ln for ln in text.splitlines() if ln.startswith("bench-gate")]
        if rc != 0 or len(lines) != 4 or not all(": ok " in ln
                                                 for ln in lines):
            raise AssertionError(f"gate exited {rc}: {text}")
        halved = []
        for path in paths:
            art = json.loads(pathlib.Path(path).read_text())
            art["value"] = art["value"] / 2
            half = path.replace(".json", "_halved.json")
            pathlib.Path(half).write_text(json.dumps(art))
            halved.append(half)
        rc_half, text_half = gate(*halved, "--golden", golden)
        if rc_half != 1 or text_half.count("REGRESSION") != 4:
            raise AssertionError(f"gate on halved values exited {rc_half}: "
                                 f"{text_half}")
        say("host_scenarios gate: " + " | ".join(lines))
        say(f"host_scenarios gate: the halved copies exit {rc_half} "
            f"({text_half.count('REGRESSION')} regressions)")
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(SCENARIO_DIR, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    say(f"host_scenarios: {wall:.1f} s wall, the gate included")
    out["wall_s"] = wall
    return out


ENTRY_SHAPE = "G=256 P=3 L=32 S=4 (the graft entry's step)"


def phase_entry(cons, convert, kernels, ks: dict, card: str) -> dict:
    """The port's graft entry (``copycat_tpu_torch/graft_entry.py``):
    ``fn, args = entry()`` on the card, ``fn(*args)`` once with the kernel
    counts zeroed just before and read just after (one launch of each
    fused kernel, none of the tally), its wall and CUDA-event time; every
    output and state leaf equal to the same call on a CPU copy of
    ``args``; both fused kernels against their plain versions on the
    arguments the call gave them, and timed there beside their bounds; a
    warm call's time, and a profiler window of ten calls."""
    from copycat_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    state, submits, *rest = args
    cpu_args = (convert.state_to_torch(convert.to_numpy(state), "cpu"),
                convert.submits_to_torch(convert.to_numpy(submits), "cpu"),
                *(t.cpu() for t in rest))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    zero_counts(ks)
    with recording(cons, STEP_FNS) as seen:
        t0 = time.perf_counter()
        start.record()
        got = fn(*args)
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = counts(ks)
    if launched != {"kth_largest": 0, "admit_submits": 1, "ack_commit": 1}:
        raise AssertionError(f"entry: kernel launches {launched} in one "
                             "call; want one of each fused kernel")
    want = fn(*cpu_args)
    _same_leaves(want[1], got[1], "entry: the outputs on the card and the "
                 "CPU")
    _same_leaves(want[0], got[0], "entry: the state on the card and the CPU")
    fns, errs = step_fns(kernels, dict(seen), "the graft entry's step")
    timing = time_fns(fns, {"admit_submits": 1, "ack_commit": 1},
                      ENTRY_SHAPE, card)
    call_ms = time_ms(lambda: fn(*args), iters=50, warmup=5)
    calls = 10
    profile = profiled(lambda: [fn(*args) for _ in range(calls)],
                       lambda _: calls, f"{calls} calls of the graft "
                       f"entry's fn, {ENTRY_SHAPE}, every pool", card)
    out = dict(launches=launched, errs=errs, timing=timing,
               first_call_wall_ms=wall_ms,
               first_call_event_ms=start.elapsed_time(end),
               warm_call_event_ms=call_ms, profile=profile)
    say(f"entry: fn(*args) on the card == the CPU call on every output and "
        f"state leaf, {ENTRY_SHAPE}; kernel launches {launched}; first "
        f"call {wall_ms:.3f} ms wall, {out['first_call_event_ms']:.3f} ms "
        f"between CUDA events; warm call {call_ms:.4f} ms (CUDA events over "
        f"50 calls); on {card}")
    return out


def phase_lint() -> dict:
    """``cli.main(["lint", "--strict", "--no-cache"])`` on this checkout:
    the port's copycheck over its own tree, on the host. It must exit 0;
    its files, findings, baselined and suppressed counts and wall time are
    printed."""
    import io
    import re

    from copycat_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(["lint", "--strict", "--no-cache"])
            code = 0
        except SystemExit as e:
            code = e.code
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    if code != 0:
        raise AssertionError(f"lint: exit {code}\n{text[-4000:]}")
    status = text.strip().splitlines()[-1]
    m = re.search(r"(\d+) files, (\d+) finding\(s\), (\d+) baselined, "
                  r"(\d+) suppressed", status)
    if m is None or not status.startswith("copycheck: ok"):
        raise AssertionError(f"lint: unexpected status {status!r}")
    out = dict(zip(("files", "findings", "baselined", "suppressed"),
                   map(int, m.groups())), wall_s=wall)
    say(f"lint: exit 0, {out['files']} files, {out['findings']} findings, "
        f"{out['baselined']} baselined, {out['suppressed']} suppressed, "
        f"{wall:.2f} s wall on the card's host")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from copycat_tpu_torch import bench, cases, convert
    from copycat_tpu_torch.device import card_info
    from copycat_tpu_torch.models import RaftGroups
    from copycat_tpu_torch.ops import apply as ap
    from copycat_tpu_torch.ops import consensus as cons
    from copycat_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        say(f"phase {name}: {now - t_lap[0]:.1f}s (at {now - t_start:.1f}s)")
        t_lap[0] = now

    dev = torch.device("cuda")
    card = card_info()
    ks = bench.KERNELS
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    say(f"build: kernel libraries built in {phase_build(kernels):.1f}s")
    lap("build")
    errs = phase_kernel(kernels, cases, dev)
    lap("kernel")
    S = 16
    counter_ops = np.array([ap.OP_LONG_ADD] * 6 + [
        ap.OP_VALUE_SET, ap.OP_VALUE_GET, ap.OP_VALUE_CAS, ap.OP_MAP_PUT],
        np.int32)
    phase_path(cons, convert, ks, dev, "path", 3, 64, 50, cons.Config(
        append_window=S, applies_per_round=S,
        resource=ap.ResourceConfig.counters_only()), counter_ops)
    lap("counter path")
    all_ops = np.array(sorted({v for k, v in vars(ap).items()
                               if k.startswith("OP_")}), np.int32)
    mixed_cfg = cons.Config(append_window=S, applies_per_round=S,
                            pool_budgets=(4, 6, 4, 6, 4, 4, 4, 4))
    phase_path(cons, convert, ks, dev, "mixed path", 5, 32, 40, mixed_cfg,
               all_ops)
    lap("mixed path")
    membership = phase_path(
        cons, convert, ks, dev, "membership path", 5, 32, 40,
        mixed_cfg._replace(resource=bench.RESOURCE_CONFIGS["mixed"],
                           dynamic_membership=True),
        np.array([ap.OP_LONG_ADD], np.int32), G=10_000,
        members=np.arange(5) < 3, churn=membership_churn(ap, 5))
    lap("membership path")
    launches = {"counter_serve": phase_serve(RaftGroups, cons, ap, ks),
                "pool_serve": phase_pool_serve(RaftGroups, ap, ks)}
    lap("counter and pool serves")
    served = phase_membership_serve(RaftGroups, bench, cons, ap, ks)
    launches["membership_serve"] = served["launches"]
    per_round = {name: n / served["rounds"]
                 for name, n in served["launches"].items()}
    masked_timing = time_fns(
        masked_fns(kernels, served["rg"]), per_round,
        "G=100000 P=5 L=32 S=16 (membership serve step, member-masked)",
        card)
    profile_serve(served.pop("rg"), ap, card, "membership serve")
    # the same engine and traffic with static membership, for the
    # launches and kernel time the membership branch adds
    static = RaftGroups(100_000, 5, log_slots=32, submit_slots=16,
                        config=bench.scenario_config("mixed", S))
    static.wait_for_leaders()
    profile_serve(static, ap, card, "static-membership serve")
    del static
    lap("membership serve")
    phase_engine_extras(RaftGroups, bench, convert, ap)
    lap("engine extras")
    _, timing = phase_bench(bench, cons, kernels, dev, card)
    phase_profile(bench, dev, card)
    lap("counter bench")
    mixed, mixed_timing = phase_mixed_bench(bench, cons, ap, kernels, dev,
                                            card)
    launches["mixed_bench"] = mixed.pop("launches")
    phase_profile(bench, dev, card, **MIXED)
    lap("mixed bench")
    phase_short_benches(bench, card)
    phase_profile(bench, dev, card, scenario="map")
    lap("short benches")
    phase_query_lane(bench, card, QUERY_ROUNDS, QUERY_REPEATS)
    lap("query lane")
    phase_elections(bench, card, ELECTION_ROUNDS, ELECTION_REPEATS)
    lap("elections")
    deep = phase_deep_path(cons, convert, ks, dev)
    lap("deep path")
    host = phase_host_bench(bench, ap, card)
    lap("host bench")
    phase_host_read_session(bench, card)
    lap("host_read and session")
    wide_rows = phase_wide_kernels(RaftGroups, kernels, cases, ap, ks, dev,
                                   card, launches["counter_serve"])
    lap("wide kernels")
    phase_checkpoint(RaftGroups, bench, ap, card)
    lap("checkpoint")
    launches["facades"], facade_errs = phase_facades(RaftGroups, ap, ks,
                                                     card)
    lap("facades")
    verdicts = phase_verdict(ks, card)
    lap("verdicts")
    launches["server"], server_errs, _ = phase_server(ks, card)
    lap("server")
    public_launches, public_errs, _ = phase_public_api(ks, card)
    launches.update(public_launches)
    lap("public_api")
    launches["operator"], operator_errs, _ = phase_operator(ks, card)
    lap("operator")
    phase_deploy(card)
    lap("deploy")
    phase_host_scenarios(ks, card)
    lap("host_scenarios")
    entry = phase_entry(cons, convert, kernels, ks, card)
    lap("entry")
    phase_lint()
    lap("lint")
    say(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f}s")
    deep_errs = verdicts["deep verdict"]["max_abs_err"]
    verdict_errs = verdicts["verdict"]["max_abs_err"]
    sources = {"kth_largest": "kth_largest.cu",
               "admit_submits": "quorum_phase.cu",
               "ack_commit": "quorum_phase.cu"}
    rows = [{
        "name": name,
        "route": "cuda",
        "source": f"copycat_tpu_torch/csrc/{src}",
        "replaces": "copycat_tpu/ops/pallas_kernels.py:69",
        "launches": launches["counter_serve"][name],
        "launches_pool_serve": launches["pool_serve"][name],
        "launches_mixed_bench": launches["mixed_bench"][name],
        "launches_per_mixed_round": mixed["launches_per_round"][name],
        "launches_deep_path": deep["launches"][name],
        "launches_host_deep": host["deep"]["launches"][name],
        "launches_per_host_deep_round":
            host["deep"]["launches_per_round"][name],
        "launches_facades": launches["facades"][name],
        "launches_deep_verdict": verdicts["deep verdict"]["launches"][name],
        "launches_server": launches["server"][name],
        "launches_spi": launches["spi"][name],
        "launches_readmix": launches["readmix"][name],
        "launches_apply": launches["apply"][name],
        "launches_operator": launches["operator"][name],
        "launches_entry": entry["launches"][name],
        "max_abs_err": max(errs[name], facade_errs.get(name, 0),
                           deep_errs.get(name, 0), server_errs.get(name, 0),
                           public_errs.get(name, 0),
                           operator_errs.get(name, 0),
                           entry["errs"].get(name, 0)),
        "max_abs_err_facades": facade_errs.get(name),
        "max_abs_err_deep_verdict": deep_errs.get(name),
        "max_abs_err_server": server_errs.get(name),
        "max_abs_err_public_api": public_errs.get(name),
        "max_abs_err_operator": operator_errs.get(name),
        "max_abs_err_entry": entry["errs"].get(name),
        **timing[name],
        "mixed_shape": mixed_timing.get(name),
        "entry_shape": entry["timing"].get(name),
    } for name, src in sources.items()]
    # the member-masked instantiations of the fused kernels, on the
    # membership path (Config.dynamic_membership)
    rows += [{
        "name": f"{name}_masked",
        "route": "cuda",
        "source": "copycat_tpu_torch/csrc/quorum_phase.cu",
        "replaces": "copycat_tpu/ops/pallas_kernels.py:69",
        "launches": launches["membership_serve"][name],
        "launches_membership_path": membership["launches"][name],
        "launches_verdict": verdicts["verdict"]["launches"][name],
        "launches_host_deep": 0,     # the host cells run static membership
        "max_abs_err": max(errs[f"{name}_masked"], verdict_errs[name]),
        "max_abs_err_verdict": verdict_errs[name],
        **masked_timing[name],
    } for name in ("admit_submits", "ack_commit")]
    # the runtime-P instantiations (P > 8)
    rows += wide_rows
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
