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
   from one member to every lane, the leader outside its own view); plus
   the floor-mod and first-index argmax the step relies on;
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
10. counter bench — the counter bench at full size (G=10,000 × P=3 × L=64
    × S=16), one launch of each fused kernel per round; each kernel's time
    per call beside its plain version, a library call computing the same
    function where there is one, and its bound — the fused kernels on the
    inputs the bench's step gives them; then a short ``torch.profiler``
    window of the same step: kernel time, the device's idle share and
    launches per round;
11. mixed bench — BASELINE config #5 at full width (G=100,000 × P=5 ×
    L=32 × S=16) under the partition nemesis, budgets 4,6,4,6,4,4,4,4,
    timers 2-4: committed ops/s, ms/round, p50/p99 commit latency, one
    launch of each fused kernel per round, and replicas at equal applied
    index holding equal resource leaves; the fused kernels timed on the
    mixed step's inputs; the apply's time per round; a profiler window;
12. short map and lock benches at G=10,000 × P=3 × L=64 with their
    budgets, and a profiler window of the map round;
13. query lane — the ``map_read`` cell (G=10,000 × P=3 × L=64, 16 puts
    through the log and 16 gets through ``query_step`` per group and
    round) at both read levels, every served get checked against the
    value the puts wrote;
14. elections — the ``election`` cell (G=1,000 × P=3, isolation nemesis
    with period 15, seed 2, 200 rounds × 5), with no term of any group
    led by two lanes.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import sys
import time
from collections import deque

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12        # H100 SXM 32-bit rate outside the tensor cores
MIXED = dict(scenario="mixed", groups=100_000, peers=5)
MIXED_ROUNDS, MIXED_REPEATS = 200, 5    # the reference's
SHORT_ROUNDS, SHORT_REPEATS = 20, 2
QUERY_ROUNDS, QUERY_REPEATS = 100, 3    # the reference runs 200 x 5
ELECTION_ROUNDS, ELECTION_REPEATS = 200, 5


def say(msg: str) -> None:
    print(msg, flush=True)


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


def widen_ring(ring: torch.Tensor) -> torch.Tensor:
    """The ring as the step hands it over: a column slice of a [G, L+1]
    tensor, rows L+1 elements apart."""
    wide = torch.zeros((ring.shape[0], ring.shape[1] + 1), dtype=ring.dtype,
                       device=ring.device)
    wide[:, :-1] = ring
    return wide[:, :-1]


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
            fused.append((G, P) + ((5, 16) if G == 1_001 else (16, 64)))
    fused.append((100_000, 5, 16, 32))      # the mixed bench's shape
    for G, P, S, L in fused:
        quorum = P // 2 + 1
        where = f"G={G} P={P} S={S} L={L}"
        a_np = cases.admit_case(rng, G, P, S, L)
        c_np = cases.ack_case(rng, G, P, L)
        # the static path, then the member-masked one on random views
        # (one member up to every lane, the leader outside its own view)
        for views, tag in ((None, ""), ("views", "_masked")):
            a = on_card(a_np, dev)
            c = on_card(c_np, dev)
            c["l_log_term"] = widen_ring(c["l_log_term"])
            if views:
                a["view"] = torch.from_numpy(cases.member_views(
                    rng, a_np["lead"], P)).to(dev)
                c["view"] = torch.from_numpy(cases.member_views(
                    rng, c_np["lead"], P)).to(dev)
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


def masked_fns(kernels, rg) -> dict:
    """(kernel, plain, library, bound) of each fused kernel, masked, on the
    inputs one step of the membership engine ``rg`` gives it."""
    from copycat_tpu_torch.ops import consensus as cons
    seen = record_inputs(cons, ("admit_submits", "ack_commit"),
                         rg.step_round)
    a_args, a_kw = seen["admit_submits"]
    c_args, c_kw = seen["ack_commit"]
    view = a_args[7]
    if view is None or c_kw["view"] is None:
        raise AssertionError("the membership step called the static kernels")
    (G, P), S = a_args[0].shape, a_args[3].shape[1]
    L = c_kw["l_log_term"].shape[1]
    out = kernels.ack_commit_plain(*c_args, **c_kw)
    l_last, lead = c_kw["l_last"], c_kw["lead"]
    self_lane = torch.arange(P, device=lead.device)[None, :] == lead[:, None]
    cand = kernels.kth_largest_masked(
        torch.where(self_lane, l_last[:, None], out.l_match),
        *kernels.leader_members(c_kw["view"], lead))
    n_live = int(((cand >= 1) & (cand <= l_last) & (cand > l_last - L)).sum())
    # as the static kernels' bounds, plus the leader lane's 4-byte view
    # word a group and its popcount and member masking
    fns = {
        "admit_submits": (
            lambda: kernels.admit_submits_cuda(*a_args, **a_kw),
            lambda: kernels.admit_submits_plain(*a_args, **a_kw), None,
            bounds(G * (4 * P + 4 + 1 + S + 4 + 4)
                   + G * (S + 4 * S + 8 * S + 4),
                   G * (2 * P * P + 8 * S + 2 * P))),
        "ack_commit": (
            lambda: kernels.ack_commit_cuda(*c_args, **c_kw),
            lambda: kernels.ack_commit_plain(*c_args, **c_kw), None,
            bounds(G * (6 * P + 24 * P + 17 + 4) + 4 * n_live
                   + G * (8 * P + 10),
                   G * (2 * P * P + 24 * P + 2 * P)))}
    for name, (kern, plain, _, _) in fns.items():
        max_err(kern(), plain(), f"{name} (masked) on the membership step's "
                "inputs")
    return fns


def bounds(nbytes: int, ops: int) -> dict:
    """The least time of a call: bytes over the memory rate or integer
    operations over the 32-bit rate, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def record_inputs(cons, names, run) -> dict:
    """The arguments the consensus step hands each function of ``names``
    (module attributes of ``cons``) in its last call while ``run()``
    runs."""
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
        run()
    finally:
        for name, fn in real.items():
            setattr(cons, name, fn)
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
    seen = step_inputs(bench, cons, dev, ("admit_submits", "ack_commit"),
                       **cell)
    a_args, a_kw = seen["admit_submits"]
    (G, P), S = a_args[0].shape, a_args[3].shape[1]
    fns = {}
    # reads: applied, lead, accept_ok, valid, l_last; writes: accepted,
    # assigned, slot (int64), l_last. Operations: the rank-select's 2·P²
    # compares, then about 8 per submit slot.
    fns["admit_submits"] = (
        lambda: kernels.admit_submits_cuda(*a_args, **a_kw),
        lambda: kernels.admit_submits_plain(*a_args, **a_kw),
        None,
        bounds(G * (4 * P + 4 + 1 + S + 4) + G * (S + 4 * S + 8 * S + 4),
               G * (2 * P * P + 8 * S)))
    c_args, c_kw = seen["ack_commit"]
    out = kernels.ack_commit_plain(*c_args, **c_kw)
    (G, P), L = c_kw["recv"].shape, c_kw["l_log_term"].shape[1]
    l_last, lead = c_kw["l_last"], c_kw["lead"]
    self_lane = torch.arange(P, device=dev)[None, :] == lead[:, None]
    cand = kernels.kth_largest_plain(
        torch.where(self_lane, l_last[:, None], out.l_match), P // 2 + 1)
    n_live = int(((cand >= 1) & (cand <= l_last) & (cand > l_last - L)).sum())
    # reads: six bool and six int32 [G,P] lanes, five [G] values, and one
    # ring term for each group whose candidate lies in the live window;
    # writes: two int32 [G,P] lanes, two bool and two int32 [G] values.
    # Operations: 2·P² compares and about 24 per lane.
    fns["ack_commit"] = (
        lambda: kernels.ack_commit_cuda(*c_args, **c_kw),
        lambda: kernels.ack_commit_plain(*c_args, **c_kw),
        None,
        bounds(G * (6 * P + 24 * P + 17) + 4 * n_live + G * (8 * P + 10),
               G * (2 * P * P + 24 * P)))
    for name, (kern, plain, _, _) in fns.items():
        max_err(kern(), plain(), f"{name} on the bench step's inputs")
    return fns


def time_fns(fns: dict, per_round: dict, where: str, card: str) -> dict:
    timing = {}
    for name, (kern, plain, library, bound) in fns.items():
        dev_ms = {"ms": graph_ms(kern), "plain_ms": graph_ms(plain),
                  "library_ms": graph_ms(library) if library else None}
        call_ms = {"call_ms": time_ms(kern), "plain_call_ms": time_ms(plain),
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


def phase_bench(bench, cons, kernels, dev, card: str) -> tuple[dict, dict]:
    zero_counts(bench.KERNELS)
    result = bench.run_throughput()
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
        bounds(G * P * 4 + G * 4, 2 * G * P * P))}
    # the fused kernels, on the bench step's own inputs
    fns.update(fused_fns(bench, cons, kernels, dev))
    timing = time_fns(fns, result["launches_per_round"], "G=10000 P=3",
                      card)
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
    if (MIXED_ROUNDS, MIXED_REPEATS) != (bench.ROUNDS, bench.REPEATS):
        say(f"mixed bench: cut to {MIXED_ROUNDS} rounds x {MIXED_REPEATS} "
            f"repetitions (the reference runs {bench.ROUNDS} x "
            f"{bench.REPEATS}); G, P and L as the reference's")
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
    from torch.profiler import ProfilerActivity, profile

    run(0, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(5, rounds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    evs = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in evs if getattr(e, "device_type", None) == cuda]
    busy_ms = sum(getattr(e, "self_device_time_total", 0)
                  for e in kern) / 1e3 / rounds
    if busy_ms == 0:
        say("profile: the profiler saw no device time; idle share not "
            "measured")
        return {}
    launches = sum(e.count for e in kern) / rounds
    say(f"profile ({what}, on {card}, profiler on): wall "
        f"{wall_ms:.3f} ms/round, kernel time {busy_ms:.3f} ms/round, device "
        f"idle share {1 - busy_ms / wall_ms:.4f}, {launches:.1f} kernel "
        f"launches/round")
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        say(f"profile:   {e.self_device_time_total / 1e3 / rounds:.4f} "
            f"ms/round  x{e.count // rounds}  {e.key[:90]}")
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
    dev = torch.device("cuda")
    card = card_info()
    ks = bench.KERNELS
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    say(f"build: kernel libraries built in {phase_build(kernels):.1f}s")
    errs = phase_kernel(kernels, cases, dev)
    S = 16
    counter_ops = np.array([ap.OP_LONG_ADD] * 6 + [
        ap.OP_VALUE_SET, ap.OP_VALUE_GET, ap.OP_VALUE_CAS, ap.OP_MAP_PUT],
        np.int32)
    phase_path(cons, convert, ks, dev, "path", 3, 64, 50, cons.Config(
        append_window=S, applies_per_round=S,
        resource=ap.ResourceConfig.counters_only()), counter_ops)
    all_ops = np.array(sorted({v for k, v in vars(ap).items()
                               if k.startswith("OP_")}), np.int32)
    mixed_cfg = cons.Config(append_window=S, applies_per_round=S,
                            pool_budgets=(4, 6, 4, 6, 4, 4, 4, 4))
    phase_path(cons, convert, ks, dev, "mixed path", 5, 32, 40, mixed_cfg,
               all_ops)
    membership = phase_path(
        cons, convert, ks, dev, "membership path", 5, 32, 40,
        mixed_cfg._replace(resource=bench.RESOURCE_CONFIGS["mixed"],
                           dynamic_membership=True),
        np.array([ap.OP_LONG_ADD], np.int32), G=10_000,
        members=np.arange(5) < 3, churn=membership_churn(ap, 5))
    launches = {"counter_serve": phase_serve(RaftGroups, cons, ap, ks),
                "pool_serve": phase_pool_serve(RaftGroups, ap, ks)}
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
    phase_engine_extras(RaftGroups, bench, convert, ap)
    _, timing = phase_bench(bench, cons, kernels, dev, card)
    phase_profile(bench, dev, card)
    mixed, mixed_timing = phase_mixed_bench(bench, cons, ap, kernels, dev,
                                            card)
    launches["mixed_bench"] = mixed.pop("launches")
    phase_profile(bench, dev, card, **MIXED)
    phase_short_benches(bench, card)
    phase_profile(bench, dev, card, scenario="map")
    phase_query_lane(bench, card, QUERY_ROUNDS, QUERY_REPEATS)
    phase_elections(bench, card, ELECTION_ROUNDS, ELECTION_REPEATS)
    say(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f}s")
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
        "max_abs_err": errs[name],
        **timing[name],
        "mixed_shape": mixed_timing.get(name),
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
        "max_abs_err": errs[f"{name}_masked"],
        **masked_timing[name],
    } for name in ("admit_submits", "ack_commit")]
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
