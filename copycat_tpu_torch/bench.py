"""Throughput bench: committed ops/sec over batched Raft groups.

Counterpart of ``copycat_tpu/bench.py::run_throughput`` for its engine
scenarios, at the same shapes and in the same units:

- ``counter`` — every submit slot carries ``OP_LONG_ADD``;
- ``map`` — put/get over 10 rotating keys per group (BASELINE config #3);
- ``lock`` — acquire(1), acquire(2, queued), release(1) (grants 2 through
  the event ring), release(2) (BASELINE config #4);
- ``mixed`` — every kernel of BASELINE config #5 in one round (counter,
  map, set, queue, lock chain, election listen/resign) under the
  partition nemesis: in every period of 20 rounds one peer per group is
  isolated for 10, the same schedule each repetition (seed 1), with a
  snapshot install after every round and election timers 2-4;
- ``election`` — forced leader churn (BASELINE config #2): G=1,000 × P=3,
  L=64, counters only, no submits, timers 4-9, the isolation nemesis with
  period 15 and seed 2; reports elections/s (groups whose round-start
  leader changed to a new one) and checks that no group ever has two
  leaders in one term;
- ``map_read`` — BASELINE config #3's get-heavy variant: G=10,000 × P=3,
  L=64, the map pool alone; every round 16 puts per group through the log
  and 16 gets through ``query_step`` (no log append) at ``--read-level
  sequential`` (leader-served) or ``atomic`` (lease-gated); reports ops/s
  (committed puts plus served gets) and checks every served get against
  the value the puts wrote;
- ``host`` — client-visible throughput through the host runtime
  (the reference's ``run_host``): G=10,000 × P=3, L=64, S=16, counters
  only, ``--burst`` ops per group a drive (default S × 8 = 128; S × 1 for
  ``queued``), every op ``OP_LONG_ADD(1)``. ``--mode deep`` (default) and
  ``deepscan`` drive a monotone-tag engine through ``BulkDriver`` (per-
  round dispatch, or the blind phase as one ``deep_scan``), ``bulk`` the
  classic drive, ``queued`` ``submit_batch`` + ``run_until``. Reports
  host-observed committed ops/s, p50/p99 submit→result latency in ms,
  rounds per drive, and checks each group's counter against the ops
  committed to it (exactly once); ``--telemetry`` turns the device
  telemetry on and reports its ``device.*`` snapshot;
- ``host_read`` — client-visible reads (``run_host_read``): one counter
  write of 7 per group, then ``--burst`` reads per group a repetition
  through ``BulkDriver.drive_queries`` at ``--read-level``; every read
  must return 7;
- ``session`` — the sessioned client (``run_session``): ``--sessions``
  sessions (default 16) of one ``BulkSessionClient`` on a monotone engine,
  each owning an equal slice of the groups, ``--burst`` ops per group in
  one flush; reports committed session ops/s and checks group 0's
  counter (exactly once).

Defaults are the reference's: G=10,000 groups × P=3 peers, S=E=A=16
submit slots / append window / applies per round, L=32 log slots for
``mixed`` and 64 otherwise, 200 rounds per repetition, best of 5 after
one warm-up repetition. Each scenario hosts only its pools
(``RESOURCE_CONFIGS``); ``mixed`` and ``lock`` take the conflict-
partitioned apply with the reference's default budgets.

Reported: committed ops/sec (the global applied high-water delta over the
timed rounds, ended by a device synchronise) with the spread of the
repetitions; ms/round; p50/p99 commit latency in rounds (leader-log
append to apply, +1 for the appending round, histogrammed on the device)
and in ms at the measured cadence; launches per timed round of each
quorum kernel (0 on the CPU, where the plain versions run); and
``diverged_lanes``, the replica pairs with equal ``applied_index`` whose
resource leaves differ after the run (must be 0).

    python -m copycat_tpu_torch.bench
        [--scenario counter|map|lock|mixed|election|map_read|host|
                    host_read|session]
        [--read-level sequential|atomic] [--groups N --peers P
        --rounds R --repeats K] [--mode deep|deepscan|bulk|queued]
        [--burst OPS_PER_GROUP] [--telemetry] [--sessions N]

runs on the CUDA card and prints one JSON line naming the card and its
power limit; without a card it raises. ``run_throughput(device="cpu")``
runs it on the CPU for tests, and labels the result ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .device import card_info, resolve_device
from .models import BulkDriver, BulkSessionClient, RaftGroups
from .ops import apply as ap
from .ops import kernels
from .ops.consensus import (
    Config,
    RaftState,
    StepOutputs,
    Submits,
    current_leader,
    draw_timers,
    full_delivery,
    init_state,
    install_snapshots,
    make_submits,
    query_step,
    step,
)

GROUPS, PEERS, SUBMIT_SLOTS = 10_000, 3, 16
KERNELS = {"kth_largest": kernels.kth_largest,
           "admit_submits": kernels.admit_submits,
           "ack_commit": kernels.ack_commit}
ROUNDS, REPEATS = 200, 5
SEED = 0
NEMESIS_PERIOD, NEMESIS_SEED = 20, 1
ELECTION_GROUPS, ELECTION_PERIOD, ELECTION_SEED = 1_000, 15, 2
MAP_VALUE = 7                 # what every map_read put writes
READ_LEVELS = ("sequential", "atomic")

# Each scenario hosts only the pools its groups use (pool state is carried
# through every step).
RESOURCE_CONFIGS = {
    "counter": ap.ResourceConfig.counters_only(),
    "map": ap.ResourceConfig(set_slots=0, queue_slots=0, wait_slots=0,
                             listener_slots=0, event_slots=0,
                             multimap_slots=0, topic_slots=0),
    "lock": ap.ResourceConfig(map_slots=0, set_slots=0, queue_slots=0,
                              listener_slots=0, multimap_slots=0,
                              topic_slots=0),
    # BASELINE config #5: the six original kernels
    "mixed": ap.ResourceConfig(multimap_slots=0, topic_slots=0),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pool_budgets_for(scenario: str, submit_slots: int) -> tuple | None:
    """The reference's default per-pool apply budgets (value, map, set,
    queue, lock, election, multimap, topic); None = the sequential scan."""
    full = max(4, submit_slots)   # = applies_per_round, never a throttle
    return {"mixed": (4, 6, 4, 6, 4, 4, 4, 4),
            "lock": (full,) * ap.NUM_POOLS}.get(scenario)


def scenario_config(scenario: str, submit_slots: int) -> Config:
    """The step config of a scenario: tight election timers (2-4) under the
    ``mixed`` nemesis, 4-9 otherwise."""
    t_min, t_max = (2, 4) if scenario == "mixed" else (4, 9)
    return Config(append_window=max(4, submit_slots),
                  applies_per_round=max(4, submit_slots),
                  pool_budgets=pool_budgets_for(scenario, submit_slots),
                  timer_min=t_min, timer_max=t_max,
                  resource=RESOURCE_CONFIGS[scenario])


def percentiles(hist: np.ndarray, qs) -> list[int]:
    """Percentile values from an exact count histogram (index = value)."""
    total = int(hist.sum())
    if total == 0:
        return [0 for _ in qs]
    cum = np.cumsum(hist)
    return [int(np.searchsorted(cum, q * total)) for q in qs]


def spread(reps: list[float]) -> dict:
    """Per-rep min/median/max."""
    s = sorted(reps)
    return {"reps_min": s[0], "reps_median": s[len(s) // 2],
            "reps_max": s[-1], "reps_n": len(s)}


# ---------------------------------------------------------------------------
# submit patterns (every group submits the same S ops every round)
# ---------------------------------------------------------------------------

def _submits(G: int, S: int, device, opcode, a, b=(0,)) -> Submits:
    """Submits tiling the per-slot patterns across [G, S]; every slot
    valid, tag 1."""
    def tile(pattern):
        row = torch.tensor(pattern, dtype=torch.int32)[torch.arange(S)
                                                       % len(pattern)]
        return row.to(device).expand(G, S)

    ones = torch.ones((G, S), dtype=torch.int32, device=device)
    return Submits(opcode=tile(opcode), a=tile(a), b=tile(b), c=ones * 0,
                   tag=ones, valid=ones.bool())


def counter_submits(G: int, S: int, device) -> Submits:
    """Every slot of every group carries ``addAndGet(1)``."""
    return _submits(G, S, device, [ap.OP_LONG_ADD], [1])


def map_submits(G: int, S: int, device) -> Submits:
    """put/get mix over 10 rotating keys per group (BASELINE config #3)."""
    return _submits(G, S, device, [ap.OP_MAP_PUT, ap.OP_MAP_GET] * 5,
                    [1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 2, 3, 6, 8, 10], [7])


def lock_submits(G: int, S: int, device) -> Submits:
    """acquire(1) → acquire(2, queued) → release(1) [grants 2] →
    release(2): every round drives the grant chain and its event."""
    return _submits(G, S, device,
                    [ap.OP_LOCK_ACQUIRE, ap.OP_LOCK_ACQUIRE,
                     ap.OP_LOCK_RELEASE, ap.OP_LOCK_RELEASE],
                    [1, 2, 1, 2], [-1, -1, 0, 0])


def mixed_submits(G: int, S: int, device) -> Submits:
    """Every resource kernel of BASELINE config #5 in one round: counter,
    map, set, queue, lock grant chain, election listen/resign."""
    return _submits(
        G, S, device,
        [ap.OP_LONG_ADD, ap.OP_MAP_PUT, ap.OP_MAP_GET,
         ap.OP_SET_ADD, ap.OP_SET_REMOVE,
         ap.OP_Q_OFFER, ap.OP_Q_POLL,
         ap.OP_LOCK_ACQUIRE, ap.OP_LOCK_RELEASE,
         ap.OP_ELECT_LISTEN, ap.OP_ELECT_RESIGN,
         ap.OP_LONG_ADD, ap.OP_MAP_PUT,
         ap.OP_Q_OFFER, ap.OP_Q_POLL, ap.OP_MAP_GET],
        [1, 3, 3, 5, 5, 6, 0, 9, 9, 4, 4, 1, 7, 6, 0, 7],
        [0, 5, 0, 0, 0, 0, 0, -1, 0, 0, 0, 0, 8, 0, 0, 0])


SUBMIT_PATTERNS = {
    "counter": counter_submits,
    "map": map_submits,
    "lock": lock_submits,
    "mixed": mixed_submits,
}
SCENARIOS = tuple(SUBMIT_PATTERNS) + ("election", "map_read", "host",
                                      "host_read", "session")
HOST_MODES = ("deep", "deepscan", "bulk", "queued")
HOST_LOG_SLOTS = 64
SESSIONS = 16
HOST_VALUE = 7               # what host_read's one write per group sets


# ---------------------------------------------------------------------------
# the partition nemesis
# ---------------------------------------------------------------------------

def isolation_masks(rounds: int, G: int, P: int, period: int,
                    seed: int) -> np.ndarray:
    """Per-round victim peer per group (-1 = no fault), [R, G] int32: in
    every ``period`` rounds, a fresh victim per group for the first
    half."""
    rng = np.random.default_rng(seed)
    victims = np.full((rounds, G), -1, np.int32)
    for r in range(0, rounds, period):
        victims[r: r + period // 2] = rng.integers(0, P, G, dtype=np.int32)
    return victims


def victim_deliver(victim: torch.Tensor, G: int, P: int) -> torch.Tensor:
    """deliver[G,P,P] isolating ``victim[G]`` (-1 = fully connected)."""
    peers = torch.arange(P, device=victim.device)
    hit = peers[None, :] == victim[:, None]          # [G,P]
    cut = hit[:, :, None] | hit[:, None, :]
    return ~cut | (victim[:, None, None] < 0)


def nemesis_delivers(rounds: int, G: int, P: int, device) -> list:
    """One deliver mask per round of the nemesis schedule; rounds with
    the same victims share one tensor."""
    victims = isolation_masks(rounds, G, P, NEMESIS_PERIOD, NEMESIS_SEED)
    out, last, last_row = [], None, None
    for row in victims:
        if last_row is None or not np.array_equal(row, last_row):
            last = victim_deliver(torch.from_numpy(row).to(device), G, P)
            last_row = row
        out.append(last)
    return out


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    """One scenario at one shape, ready to step."""

    config: Config
    generator: torch.Generator
    submits: Submits
    delivers: list            # deliver[G,P,P] of round r is delivers[r % n]
    nemesis: bool


def elect_all(state: RaftState, empty: Submits, deliver: torch.Tensor,
              generator: torch.Generator, config: Config,
              max_rounds: int = 150):
    """Step with no submits until every group has a leader; returns the
    state and the rounds it took."""
    G, P = state.term.shape
    for r in range(max_rounds):
        fresh = draw_timers(G, P, config, generator)
        cand = draw_timers(G, P, config, generator)
        state, out = step(state, empty, deliver, fresh, cand, config)
        if bool((out.leader >= 0).all()):
            return state, r + 1
    raise RuntimeError("not all groups elected a leader")


def setup(scenario: str = "counter", groups: int = GROUPS,
          peers: int = PEERS, log_slots: int | None = None,
          submit_slots: int = SUBMIT_SLOTS, rounds: int = ROUNDS,
          device: torch.device | str | None = None
          ) -> tuple[Cell, RaftState]:
    """A scenario's cell and its state with every group's leader
    elected."""
    if scenario not in SUBMIT_PATTERNS:
        raise ValueError(f"scenario {scenario!r} is not one of "
                         f"{tuple(SUBMIT_PATTERNS)}")
    dev = resolve_device(device)
    G, P, S = groups, peers, submit_slots
    # the reference's ring: 32 for mixed (it only covers in-flight depth)
    L = log_slots or (32 if scenario == "mixed" else 64)
    config = scenario_config(scenario, S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = init_state(G, P, L, draw_timers(G, P, config, gen), config)
    deliver = full_delivery(G, P, dev)
    t0 = time.perf_counter()
    state, n_elect = elect_all(state, make_submits(G, S, dev), deliver, gen,
                               config)
    log(f"bench[{scenario}]: G={G} P={P} L={L} S={S} device={dev}: all "
        f"leaders elected in {n_elect} rounds "
        f"({time.perf_counter() - t0:.1f}s)")
    nemesis = scenario == "mixed"
    delivers = (nemesis_delivers(rounds, G, P, dev) if nemesis
                else [deliver])
    cell = Cell(config, gen, SUBMIT_PATTERNS[scenario](G, S, dev), delivers,
                nemesis)
    return cell, state


def step_cell(cell: Cell, state: RaftState, r: int
              ) -> tuple[RaftState, StepOutputs]:
    """Round ``r`` of the cell's schedule: one step, then, under the
    nemesis, a snapshot install for every stale follower (a follower cut
    off beyond the ring can never be served by AppendEntries again)."""
    G, P = state.term.shape
    cfg = cell.config
    fresh = draw_timers(G, P, cfg, cell.generator)
    cand = draw_timers(G, P, cfg, cell.generator)
    state, out = step(state, cell.submits,
                      cell.delivers[r % len(cell.delivers)], fresh, cand, cfg)
    if cell.nemesis:
        state = install_snapshots(state, out.stale, out.leader, cfg)
    return state, out


def diverged_lanes(state: RaftState) -> int:
    """Replica pairs (g, p < q) with equal ``applied_index`` whose resource
    leaves differ — the replicated-state guarantee, which must give 0.
    Event-ring heads are left out: lanes drain the ring in lockstep, so
    its head may differ across replicas."""
    applied = state.applied_index
    P = applied.shape[1]
    leaves = [x.reshape(x.shape[0], P, -1) for name, x in
              state.resources._asdict().items() if name != "ev_head"]
    bad = torch.zeros((), dtype=torch.int64, device=applied.device)
    for p in range(P):
        for q in range(p + 1, P):
            differ = torch.zeros_like(applied[:, 0], dtype=torch.bool)
            for x in leaves:
                differ |= (x[:, p] != x[:, q]).any(dim=-1)
            bad += (differ & (applied[:, p] == applied[:, q])).sum()
    return int(bad)


def _timed_reps(name: str, run, state, rounds: int, repeats: int, dev
                ) -> tuple:
    """One warm-up repetition of ``run(state) -> (state, n, extra)``,
    then ``repeats`` timed ones, each ended by reading ``n`` (a device
    synchronise); returns the state, the rates, the best repetition's
    seconds and ``extra``, and the quorum kernels' launches per round of
    the last repetition."""
    state, n, _ = run(state)
    log(f"bench[{name}]: warmup counted {int(n)}")
    rates, best_dt, best_extra, launches = [], None, None, {}
    for rep in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = {k: f.launches for k, f in KERNELS.items()}
        t0 = time.perf_counter()
        state, n, extra = run(state)
        n = int(n)
        dt = time.perf_counter() - t0
        launches = {k: (f.launches - before[k]) / rounds
                    for k, f in KERNELS.items()}
        rates.append(n / dt)
        if best_dt is None or n / dt >= max(rates[:-1], default=0):
            best_dt, best_extra = dt, extra
        log(f"bench[{name}]: rep {rep}: {n} in {dt:.3f}s -> "
            f"{n / dt:,.0f}/s ({dt / rounds * 1e3:.3f} ms/round)")
    return state, rates, best_dt, best_extra, launches


def run_election(groups: int = ELECTION_GROUPS, peers: int = PEERS,
                 rounds: int = ROUNDS, repeats: int = REPEATS,
                 device: torch.device | str | None = None) -> dict:
    """BASELINE config #2: elections completed per second under forced
    leader churn. Every round one peer per group is isolated for the first
    half of each 15-round period (seed 2, the same schedule each
    repetition); no submits. An election counts where a group's
    round-start leader is a lane other than the round before's. Every
    round also checks election safety on the device: no two lanes of a
    group lead in one term, within the round and across rounds."""
    dev = resolve_device(device)
    G, P, L, S = groups, peers, 64, SUBMIT_SLOTS
    config = Config(resource=RESOURCE_CONFIGS["counter"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = init_state(G, P, L, draw_timers(G, P, config, gen), config)
    empty = make_submits(G, S, dev)
    state, n_elect = elect_all(state, empty, full_delivery(G, P, dev), gen,
                               config)
    log(f"bench[election]: G={G} P={P} L={L} device={dev}: all leaders "
        f"elected in {n_elect} rounds")
    victims = isolation_masks(rounds, G, P, ELECTION_PERIOD, ELECTION_SEED)
    delivers = [victim_deliver(torch.from_numpy(v).to(dev), G, P)
                for v in victims]
    max_term = 4 * (rounds * (repeats + 1) + 200)
    # owner[g, t]: the lane seen leading group g in term t (-1 none); the
    # last column takes the writes of lanes that do not lead
    owner = torch.full((G, max_term + 1), -1, dtype=torch.int32, device=dev)
    lanes = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    unsafe = torch.zeros((), dtype=torch.int64, device=dev)

    def run(state):
        nonlocal unsafe
        n = torch.zeros((), dtype=torch.int64, device=dev)
        prev = current_leader(state)[0]
        for r in range(rounds):
            fresh = draw_timers(G, P, config, gen)
            cand = draw_timers(G, P, config, gen)
            state, out = step(state, empty, delivers[r], fresh, cand, config)
            n += ((out.leader >= 0) & (out.leader != prev)).sum()
            prev = out.leader
            # election safety: two lanes leading one term, in this round
            # or against the lane recorded for that term before
            is_ldr = state.role == 2
            idx = torch.where(is_ldr, state.term.clamp(max=max_term - 1),
                              max_term).long()
            seen = owner.gather(1, idx)
            unsafe += (is_ldr & (((seen >= 0) & (seen != lanes))
                                 | (state.term >= max_term))).sum()
            same = is_ldr[:, :, None] & is_ldr[:, None, :] \
                & (state.term[:, :, None] == state.term[:, None, :])
            unsafe += same.sum() - is_ldr.sum()
            owner.scatter_(1, idx, lanes.expand(G, P))
        return state, n, None

    state, rates, dt, _, launches = _timed_reps("election", run, state,
                                                rounds, repeats, dev)
    return {
        "metric": f"elections_per_sec_{G}_groups_under_nemesis",
        "value": max(rates),
        "unit": "elections/sec",
        "scenario": "election",
        "ms_per_round": dt / rounds * 1e3,
        "two_leaders_in_a_term": int(unsafe),
        "launches_per_round": launches,
        **spread(rates),
        "shape": {"groups": G, "peers": P, "log_slots": L, "rounds": rounds,
                  "repeats": repeats, "timers": [config.timer_min,
                                                 config.timer_max],
                  "nemesis": {"period": ELECTION_PERIOD,
                              "seed": ELECTION_SEED}},
        "device": card_info() if dev.type == "cuda" else "cpu",
    }


def run_map_read(read_level: str = "sequential", groups: int = GROUPS,
                 peers: int = PEERS, submit_slots: int = SUBMIT_SLOTS,
                 rounds: int = ROUNDS, repeats: int = REPEATS,
                 device: torch.device | str | None = None) -> dict:
    """BASELINE config #3's get-heavy variant: each round S puts per
    group through the log (keys 1 and 2, value 7) and S gets through the
    query lane (``query_step``: no log append; ``atomic`` gates each get
    on the leader lease). Counts committed entries plus served gets; every
    served get must read the value the puts wrote."""
    if read_level not in READ_LEVELS:
        raise ValueError(f"read level {read_level!r} is not one of "
                         f"{READ_LEVELS}")
    cell, state = setup("map", groups, peers, None, submit_slots, rounds,
                        device)
    dev = state.term.device
    G, P = state.term.shape
    L, S = state.log_term.shape[-1], submit_slots
    puts = _submits(G, S, dev, [ap.OP_MAP_PUT], [1, 2], [MAP_VALUE])
    gets = _submits(G, S, dev, [ap.OP_MAP_GET], [1, 2])
    atomic = (torch.ones((G, S), dtype=torch.bool, device=dev)
              if read_level == "atomic" else None)
    cell = cell._replace(submits=puts)

    def run(state):
        n = torch.zeros((), dtype=torch.int64, device=dev)
        wrong = torch.zeros((), dtype=torch.int64, device=dev)
        served_n = torch.zeros((), dtype=torch.int64, device=dev)
        applied_prev = state.applied_index.amax(dim=1)
        for r in range(rounds):
            state, _ = step_cell(cell, state, r)
            results, served = query_step(state, gets, atomic, cell.config)
            applied_now = state.applied_index.amax(dim=1)
            n += (applied_now - applied_prev).sum() + served.sum()
            served_n += served.sum()
            wrong += (served & (results != MAP_VALUE)).sum()
            applied_prev = applied_now
        return state, n, (served_n, wrong)

    state, rates, dt, (served_n, wrong), launches = _timed_reps(
        f"map_read {read_level}", run, state, rounds, repeats, dev)
    return {
        "metric": f"map_ops_per_sec_{G}_groups_half_{read_level}_reads",
        "value": max(rates),
        "unit": "ops/sec",
        "scenario": "map_read",
        "read_level": read_level,
        "ms_per_round": dt / rounds * 1e3,
        "served_reads": int(served_n),
        "wrong_reads": int(wrong),
        "launches_per_round": launches,
        **spread(rates),
        "shape": {"groups": G, "peers": P, "log_slots": L,
                  "submit_slots": S, "rounds": rounds, "repeats": repeats},
        "device": card_info() if dev.type == "cuda" else "cpu",
    }


def run_throughput(scenario: str = "counter", groups: int = GROUPS,
                   peers: int = PEERS, log_slots: int | None = None,
                   submit_slots: int = SUBMIT_SLOTS, rounds: int = ROUNDS,
                   repeats: int = REPEATS,
                   device: torch.device | str | None = None) -> dict:
    dev = resolve_device(device)
    cell, state = setup(scenario, groups, peers, log_slots, submit_slots,
                        rounds, dev)
    G, P = state.term.shape
    L, S = state.log_term.shape[-1], submit_slots

    # commit-latency histogram: exact integer buckets, the top bucket a
    # saturation catch-all; nemesis entries can wait out isolation windows
    # plus the whole backpressure ring
    max_lat = L + (200 if cell.nemesis else 34)

    def run(state):
        hist = torch.zeros(max_lat, dtype=torch.int64, device=dev)
        n = torch.zeros((), dtype=torch.int64, device=dev)
        applied_prev = state.applied_index.amax(dim=1)
        for r in range(rounds):
            state, out = step_cell(cell, state, r)
            lat = out.out_latency.reshape(-1).clamp(0, max_lat - 1).long()
            hist.scatter_add_(0, lat, out.out_valid.reshape(-1).long())
            applied_now = state.applied_index.amax(dim=1)
            n += (applied_now - applied_prev).sum()
            applied_prev = applied_now
        return state, n, hist

    state, reps, best_dt, hist, launches = _timed_reps(
        scenario, run, state, rounds, repeats, dev)
    best, best_hist = max(reps), hist.cpu().numpy()
    if best_hist[-1]:
        log(f"bench[{scenario}]: WARNING: {int(best_hist[-1])} samples "
            f"saturated the top latency bucket; p99 is a lower bound")
    ms_per_round = best_dt / rounds * 1e3
    # the round that appended+replicated+applied an entry counts too (+1)
    p50_r, p99_r = [p + 1 for p in percentiles(best_hist, (0.50, 0.99))]
    suffix = "" if scenario == "counter" else f"_{scenario}"
    return {
        "metric": f"committed_linearizable_ops_per_sec_{G}_groups{suffix}",
        "value": best,
        "unit": "ops/sec",
        "scenario": scenario,
        "ms_per_round": ms_per_round,
        "p50_commit_latency_rounds": p50_r,
        "p99_commit_latency_rounds": p99_r,
        "p50_commit_latency_ms": p50_r * ms_per_round,
        "p99_commit_latency_ms": p99_r * ms_per_round,
        "launches_per_round": launches,
        "diverged_lanes": diverged_lanes(state),
        **spread(reps),
        "shape": {"groups": G, "peers": P, "log_slots": L,
                  "submit_slots": S, "rounds": rounds, "repeats": repeats,
                  "pool_budgets": cell.config.pool_budgets,
                  "timers": [cell.config.timer_min, cell.config.timer_max],
                  "nemesis": cell.nemesis},
        "device": card_info() if dev.type == "cuda" else "cpu",
    }


# ---------------------------------------------------------------------------
# the host runtime: client-visible throughput
# ---------------------------------------------------------------------------

def host_config(submit_slots: int, monotone: bool,
                telemetry: bool = False) -> Config:
    """The reference's host cells: counters only, append window and
    applies per round max(4, S), no pool budgets."""
    return Config(append_window=max(4, submit_slots),
                  applies_per_round=max(4, submit_slots),
                  resource=RESOURCE_CONFIGS["counter"],
                  monotone_tag_accept=monotone, telemetry=telemetry)


def _host_engine(groups, peers, submit_slots, monotone, telemetry, device
                 ) -> RaftGroups:
    rg = RaftGroups(groups, peers, log_slots=HOST_LOG_SLOTS,
                    submit_slots=submit_slots, seed=SEED,
                    config=host_config(submit_slots, monotone, telemetry),
                    device=resolve_device(device))
    t0 = time.perf_counter()
    rg.wait_for_leaders()
    log(f"bench: G={groups} P={peers} L={HOST_LOG_SLOTS} S={submit_slots} "
        f"device={rg.device}: all leaders elected in {rg.rounds} rounds "
        f"({time.perf_counter() - t0:.1f}s)")
    return rg


def _lead_values(rg: RaftGroups) -> np.ndarray:
    """Each group's counter on its most-applied lane."""
    st = rg.state
    top = st.applied_index.argmax(dim=1)
    g = torch.arange(rg.num_groups, device=top.device)
    return st.resources.value[g, top].cpu().numpy()


def _host_reps(name: str, burst, repeats: int) -> tuple:
    """One warm-up ``burst()``, then ``repeats`` timed ones; each returns
    ``(ops, seconds, rounds, latency percentiles or None)``. Returns the
    rates, the best repetition's latencies, rounds per repetition and the
    kernels' launches per round over the timed repetitions."""
    burst()
    before = {k: f.launches for k, f in KERNELS.items()}
    rates, rounds, best_pct = [], [], None
    for rep in range(repeats):
        n, dt, r, pct = burst()
        rates.append(n / dt)
        rounds.append(r)
        if pct is not None and n / dt >= max(rates):
            best_pct = pct
        log(f"bench[{name}]: rep {rep}: {n} in {dt:.3f}s -> "
            f"{n / dt:,.0f}/s, {r} rounds")
    total = max(1, sum(rounds))
    launches = {k: (f.launches - before[k]) / total
                for k, f in KERNELS.items()}
    return rates, best_pct, rounds, launches


def run_host(mode: str = "deep", groups: int = GROUPS, peers: int = PEERS,
             submit_slots: int = SUBMIT_SLOTS, burst: int | None = None,
             repeats: int = REPEATS, telemetry: bool = False,
             device: torch.device | str | None = None) -> dict:
    """The reference's ``host`` scenario: ``burst`` ops per group a drive
    (default S × 8; S × 1 for ``queued``), every op ``OP_LONG_ADD(1)``,
    one warm-up drive and ``repeats`` timed ones."""
    if mode not in HOST_MODES:
        raise ValueError(f"mode {mode!r} is not one of {HOST_MODES}")
    S = submit_slots
    per_group = burst or S * (8 if mode != "queued" else 1)
    rg = _host_engine(groups, peers, S, mode in ("deep", "deepscan"),
                      telemetry, device)
    ops = np.repeat(np.arange(groups), per_group)
    driver = BulkDriver(rg, deep_scan=mode == "deepscan")

    def one_burst():
        if mode != "queued":
            res = driver.drive(ops, ap.OP_LONG_ADD, 1)
            return (ops.size, res.wall_s, res.rounds,
                    res.latency_percentiles_ms())
        t0, r0 = time.perf_counter(), rg.rounds
        tags = rg.submit_batch(ops, ap.OP_LONG_ADD, 1).tolist()
        rg.run_until(tags, max_rounds=120)
        return len(tags), time.perf_counter() - t0, rg.rounds - r0, None

    rates, pct, rounds, launches = _host_reps(f"host:{mode}", one_burst,
                                              repeats)
    want = per_group * (repeats + 1)
    mismatch = int((_lead_values(rg) != want).sum())
    out = {
        "metric": (f"host_observed_committed_ops_per_sec_{groups}_groups"
                   + {"deep": "", "deepscan": "_scan", "bulk": "_sync",
                      "queued": "_queued"}[mode]),
        "value": max(rates),
        "unit": "ops/sec",
        "scenario": "host",
        "mode": mode,
        "ops_per_drive": int(ops.size),
        "rounds_per_drive": float(np.mean(rounds)),
        "launches_per_round": launches,
        "groups_not_exactly_once": mismatch,
        **spread(rates),
        "shape": {"groups": groups, "peers": peers,
                  "log_slots": HOST_LOG_SLOTS, "submit_slots": S,
                  "ops_per_group": per_group, "repeats": repeats},
        "device": card_info() if rg.device.type == "cuda" else "cpu",
    }
    if pct is not None:
        out["p50_latency_ms"], out["p99_latency_ms"] = pct["p50"], pct["p99"]
    else:
        lat = rg.metrics.histogram("commit_latency_rounds")
        out["p50_commit_latency_rounds"] = lat.percentile(50)
        out["p99_commit_latency_rounds"] = lat.percentile(99)
    if rg.telemetry is not None:
        out["telemetry"] = True
        out["device_telemetry"] = rg.device_snapshot()
    return out


def run_host_read(read_level: str = "sequential", groups: int = GROUPS,
                  peers: int = PEERS, submit_slots: int = SUBMIT_SLOTS,
                  burst: int | None = None, repeats: int = REPEATS,
                  device: torch.device | str | None = None) -> dict:
    """The reference's ``host_read`` scenario: one write of 7 per group
    through the deep drive, then ``burst`` reads per group (default S ×
    8) a repetition through ``drive_queries``; every read must return
    7."""
    if read_level not in READ_LEVELS:
        raise ValueError(f"read level {read_level!r} is not one of "
                         f"{READ_LEVELS}")
    S = submit_slots
    per_group = burst or S * 8
    rg = _host_engine(groups, peers, S, True, False, device)
    driver = BulkDriver(rg)
    driver.drive(np.arange(groups), ap.OP_LONG_ADD, HOST_VALUE)
    reads = np.repeat(np.arange(groups), per_group)
    driver.drive_queries(reads[:groups], ap.OP_VALUE_GET,
                         consistency=read_level)
    wrong = 0

    def one_burst():
        nonlocal wrong
        r0, t0 = rg.rounds, time.perf_counter()
        got = driver.drive_queries(reads, ap.OP_VALUE_GET,
                                   consistency=read_level)
        dt = time.perf_counter() - t0
        wrong += int((got != HOST_VALUE).sum())
        return reads.size, dt, rg.rounds - r0, None

    rates, _, rounds, _ = _host_reps(f"host_read:{read_level}", one_burst,
                                     repeats)
    return {
        "metric": (f"host_observed_{read_level}_reads_per_sec_"
                   f"{groups}_groups"),
        "value": max(rates),
        "unit": "ops/sec",
        "scenario": "host_read",
        "read_level": read_level,
        "reads_per_repetition": int(reads.size),
        "settle_rounds_per_repetition": float(np.mean(rounds)),
        "wrong_reads": wrong,
        **spread(rates),
        "shape": {"groups": groups, "peers": peers,
                  "log_slots": HOST_LOG_SLOTS, "submit_slots": S,
                  "reads_per_group": per_group, "repeats": repeats},
        "device": card_info() if rg.device.type == "cuda" else "cpu",
    }


def run_session(n_sessions: int = SESSIONS, groups: int = GROUPS,
                peers: int = PEERS, submit_slots: int = SUBMIT_SLOTS,
                burst: int | None = None, repeats: int = REPEATS,
                telemetry: bool = False,
                device: torch.device | str | None = None) -> dict:
    """The reference's ``session`` scenario: ``n_sessions`` sessions of
    one ``BulkSessionClient`` on a monotone engine, each owning an equal
    slice of the groups, ``burst`` ops per group (default S × 8) in one
    flush a repetition; then group 0's counter must equal the ops
    committed to it."""
    S = submit_slots
    per_group = burst or S * 8
    rg = _host_engine(groups, peers, S, True, telemetry, device)
    client = BulkSessionClient(rg)
    sessions = [client.open_session() for _ in range(n_sessions)]
    slices = np.array_split(np.arange(groups), n_sessions)

    def one_burst():
        t0, r0 = time.perf_counter(), rg.rounds
        total = 0
        for s, sl in zip(sessions, slices):
            total += s.submit_batch(np.repeat(sl, per_group),
                                    ap.OP_LONG_ADD, 1).size
        n = client.flush()
        if n != total:
            raise AssertionError(f"session: flush committed {n} of {total}")
        return total, time.perf_counter() - t0, rg.rounds - r0, None

    rates, _, rounds, launches = _host_reps("session", one_burst, repeats)
    s0 = sessions[0]
    q = s0.submit(0, ap.OP_VALUE_GET)
    client.flush()
    return {
        "metric": f"session_committed_ops_per_sec_{groups}_groups",
        "value": max(rates),
        "unit": "ops/sec",
        "scenario": "session",
        "sessions": n_sessions,
        "rounds_per_flush": float(np.mean(rounds)),
        "launches_per_round": launches,
        "group0_counter": s0.result(q),
        "group0_expected": per_group * (repeats + 1),
        **spread(rates),
        "shape": {"groups": groups, "peers": peers,
                  "log_slots": HOST_LOG_SLOTS, "submit_slots": S,
                  "ops_per_group": per_group, "repeats": repeats},
        "device": card_info() if rg.device.type == "cuda" else "cpu",
    }


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenario", choices=SCENARIOS, default="counter")
    p.add_argument("--read-level", choices=READ_LEVELS, default="sequential",
                   help="map_read, host_read: how the reads are served")
    p.add_argument("--mode", choices=HOST_MODES, default="deep",
                   help="host: the drive")
    p.add_argument("--burst", type=int,
                   help="host, host_read, session: ops per group a drive "
                        f"(default {SUBMIT_SLOTS * 8}; {SUBMIT_SLOTS} for "
                        "--mode queued)")
    p.add_argument("--telemetry", action="store_true",
                   help="host, session: device telemetry on")
    p.add_argument("--sessions", type=int, default=SESSIONS,
                   help="session: sessions of the one client")
    p.add_argument("--groups", type=int,
                   help=f"default {GROUPS} ({ELECTION_GROUPS} for election)")
    p.add_argument("--peers", type=int, default=PEERS)
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--repeats", type=int, default=REPEATS)
    args = p.parse_args(argv)
    kw = dict(peers=args.peers, rounds=args.rounds, repeats=args.repeats)
    if args.scenario == "election":
        result = run_election(groups=args.groups or ELECTION_GROUPS, **kw)
    elif args.scenario == "map_read":
        result = run_map_read(args.read_level, groups=args.groups or GROUPS,
                              **kw)
    elif args.scenario in ("host", "host_read", "session"):
        kw = dict(groups=args.groups or GROUPS, peers=args.peers,
                  burst=args.burst, repeats=args.repeats)
        if args.scenario == "host":
            result = run_host(args.mode, telemetry=args.telemetry, **kw)
        elif args.scenario == "host_read":
            result = run_host_read(args.read_level, **kw)
        else:
            result = run_session(args.sessions, telemetry=args.telemetry,
                                 **kw)
    else:
        result = run_throughput(args.scenario, groups=args.groups or GROUPS,
                                **kw)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
