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
  counter (exactly once);
- ``spi`` — client-visible ops/s through the PUBLIC resource API
  (``run_spi``): ``--instances`` (1,000) device-backed
  ``DistributedAtomicLong``s on one ``AtomixServer(executor="tpu")``,
  ``--bursts`` (5) bursts of ``--waves`` (1) ``add_and_get(1)`` each, over
  ``--transport local|tcp|native``; ``--payload str`` puts string values
  into ``DistributedMap``s instead (the host-shadow cliff);
- ``readmix`` — read-dominated traffic through the public API
  (``run_readmix``): per burst one write and ``--reads`` (9) gets per
  instance at ``--read-level atomic|sequential|none|linearizable``
  (default atomic), through the server's read pump; reports reads/s;
- ``apply`` — the apply-limited scenario (``run_apply``): one server
  hosting ``--groups`` (4) Raft groups on one device engine,
  ``--sessions`` (24) sessions, ``get_and_set`` over ``--keys`` (256)
  zipfian (``--zipf`` 0.9) device counters interleaved with host-shadow
  string sets from an ``--ineligible`` (0.25) fraction of sessions,
  ``--ops`` (48) a session a burst; reports committed ops/s and the
  ``apply.*`` family;
- ``compartment`` — the deployment plane end to end
  (``run_compartment``): a supervised topology of OS processes
  (``deploy/``: 3 members × 4 groups serving the counter machine on the
  host, and an ingress tier swept over the widths 1, 2 and 4), 8 TCP
  clients × 600 zipfian (0.9) writes over 1,000,000 keys a burst, 3
  bursts, disk storage; on the widest tier ``kill -9`` of a member and
  of an ingress mid-load; reports committed ops/s per width and the
  ingress tier's latency attribution, and fails on any lost
  acknowledged write (the ``COPYCAT_BENCH_COMPARTMENT_*`` knobs).

The three public-API scenarios report the reference's fields under its
metric names, less ``vs_baseline`` (a ratio to the reference's TPU north
star); ``--metrics-json PATH`` writes the result with the scenario's
server and client metrics snapshots, series, the bench's host-profiler
summary and an attribution block (``metrics`` is empty for the engine
scenarios, which spin no server).

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
                    host_read|session|spi|readmix|apply|compartment]
        [--device cuda|cpu] [--metrics-json PATH]
        [--read-level sequential|atomic|none|linearizable] [--groups N
        --peers P --rounds R --repeats K] [--mode deep|deepscan|bulk|queued]
        [--burst OPS_PER_GROUP] [--telemetry] [--sessions N]
        [--instances N --bursts N --waves N --payload int|str
        --pools counters|all --transport local|tcp|native --log-slots L]
        [--reads N] [--ops N --keys N --zipf S --ineligible F]
        [--storage memory|mapped|disk]

probes the card first (``utils/platform.py``; a failed probe exits 2,
there is no fallback to the CPU), runs on it and prints one JSON line;
the engine scenarios' lines name the card and its power limit.
``--device cpu`` (or ``run_*(device="cpu")``, as the tests call them)
runs on the CPU, and an engine scenario's result says ``cpu``.
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
# shared by the public-API scenarios (spi, readmix, apply) and main
# ---------------------------------------------------------------------------

#: per-run registry snapshots the scenarios contribute to the
#: ``--metrics-json`` artifact (the server's ``stats_snapshot()`` and the
#: client registry), keyed by component name; empty for the engine
#: scenarios, which spin no server.
METRICS_SNAPSHOTS: dict = {}

#: retained ``/series`` windows the scenarios contribute to the artifact,
#: keyed like ``METRICS_SNAPSHOTS``; empty when the servers ran with
#: ``COPYCAT_SERIES=0`` or the scenario spins no server.
SERIES_WINDOWS: dict = {}


def capture_series(component: str, server_like: object) -> None:
    """Stash ``server_like``'s retained series window (if it keeps one)
    under ``component`` for the ``--metrics-json`` artifact."""
    store = getattr(server_like, "series", None)
    if store is not None:
        SERIES_WINDOWS[component] = store.payload()


def _bench_gc_tune():
    """GC tuning shared by the public-API scenarios (the production-server
    treatment): a 1k-op burst allocates ~20k short-lived objects (tasks,
    futures, messages); with default thresholds a gen-2 pass lands
    mid-burst and walks the whole live server. Freeze the settled heap
    out of collection and raise gen0 so cyclic garbage is still collected,
    just between bursts. Returns the function that undoes it (the
    reference leaves the process tuned; here a scenario restores it in a
    ``finally``, so a test process is left as it was)."""
    import gc

    saved = gc.get_threshold()
    gc.collect()
    gc.freeze()
    gc.set_threshold(100_000, 50, 100)

    def restore() -> None:
        gc.unfreeze()
        gc.set_threshold(*saved)

    return restore


async def _close_spi_stack(client, server, transport=None) -> None:
    """Teardown shared by the public-API scenarios: bounded closes (a
    wedged node must not hang the bench), then the transport's own
    shutdown when it runs background machinery (the native epoll pair)."""
    import asyncio

    try:
        await asyncio.wait_for(client.close(), 10)
    except Exception:
        pass
    try:
        await asyncio.wait_for(server.close(), 10)
    except Exception:
        pass
    if transport is not None:
        shutdown = getattr(transport, "shutdown", None)
        if shutdown is not None:
            shutdown()


def zipf_sampler(rng, n_keys: int, s: float):
    """Deterministic zipfian rank draw: inverse-CDF over 1/rank^s on the
    caller's seeded ``rng``; returns a 0-based rank in ``[0, n_keys)``."""
    import bisect

    weights = [1.0 / (r ** s) for r in range(1, n_keys + 1)]
    total_w = sum(weights)
    cdf = []
    acc = 0.0
    for w in weights:
        acc += w / total_w
        cdf.append(acc)

    def draw() -> int:
        return min(bisect.bisect_left(cdf, rng.random()), n_keys - 1)

    return draw


def _device_label(device) -> str:
    """What the scenarios' log lines name: the card, or ``cpu``."""
    dev = torch.device("cuda" if device is None else device)
    return card_info() if dev.type == "cuda" else dev.type


def _artifact_meta(device) -> dict:
    """Attribution block for ``--metrics-json`` artifacts: the git SHA,
    the explicit knob overrides and a host fingerprint (the torch device,
    the card count and the card's name and power limit) — two artifacts
    whose blocks differ are different experiments, not a regression."""
    import os
    import platform

    from .utils import knobs
    from .utils.buildinfo import git_sha

    dev = torch.device("cuda" if device is None else device)
    return {
        "git_sha": git_sha(),
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "knobs": knobs.overrides(),
        "host": {
            "hostname": platform.node(),
            "machine": platform.machine(),
            "python": platform.python_version(),
            "cpus": os.cpu_count(),
            "device": str(dev),
            "device_count": torch.cuda.device_count(),
            "card": card_info() if dev.type == "cuda" else None,
        },
    }


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
                                      "host_read", "session", "spi",
                                      "readmix", "apply", "compartment")
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


# ---------------------------------------------------------------------------
# the public resource API: AtomixServer(executor="tpu") and its clients
# ---------------------------------------------------------------------------

SPI_INSTANCES, SPI_BURSTS, SPI_LOG_SLOTS = 1000, 5, 16
SPI_PAYLOADS, SPI_POOLS = ("int", "str"), ("counters", "all")
SPI_TRANSPORTS = ("local", "tcp", "native")
READMIX_READS, READMIX_LEVEL = 9, "atomic"
READMIX_LEVELS = ("atomic", "sequential", "none", "linearizable")
APPLY = dict(groups=4, sessions=24, ops=48, bursts=5, keys=256, zipf=0.9,
             ineligible=0.25)


def run_spi(instances: int = SPI_INSTANCES, bursts: int = SPI_BURSTS,
            waves: int = 1, payload: str = "int", pools: str | None = None,
            transport: str = "local", log_slots: int = SPI_LOG_SLOTS,
            peers: int = PEERS, device: torch.device | str | None = None,
            check=None) -> dict:
    """The reference's ``spi`` scenario: client-visible throughput through
    the public resource API. ``instances`` device-backed
    ``DistributedAtomicLong``s (``DistributedMap``s with string values
    for ``payload="str"``, the host-shadow cliff) on one
    ``AtomixServer(executor="tpu")``; ``bursts`` bursts of ``waves``
    ``add_and_get(1)`` per instance, each instance's in sequence.
    The engine is ``DeviceEngineConfig(capacity=pow2 >= instances (min
    16), num_peers=peers, log_slots, submit_slots=4)``, counters only
    (``pools="counters"``, the default for ``int``) or every pool.
    ``transport`` is ``local`` (in memory), ``tcp`` (asyncio sockets) or
    ``native`` (the C++ epoll transport; exits when its extension is
    missing).

    Reports the reference's fields under its metric name, except
    ``vs_baseline`` (a ratio to the reference's TPU north star, which the
    port's bench reports for no scenario). ``check``, when given, is
    awaited before teardown with the handles (``server``, ``client``,
    ``engine``, ``counters``, ``expected``): the tests' and the smoke's
    exactly-once hook, outside the result."""
    import asyncio
    from types import SimpleNamespace

    from .atomic import DistributedAtomicLong
    from .io.local import LocalServerRegistry, LocalTransport
    from .io.transport import Address
    from .manager.atomix import AtomixClient, AtomixServer
    from .manager.device_executor import DeviceEngineConfig

    if payload not in SPI_PAYLOADS:
        raise SystemExit(f"spi payload {payload!r}: int|str")
    pools = pools or ("counters" if payload == "int" else "all")
    if pools not in SPI_POOLS:
        raise SystemExit(f"spi pools {pools!r}: counters|all")
    if transport not in SPI_TRANSPORTS:
        raise SystemExit(f"spi transport {transport!r}: local|tcp|native")
    engine_pools = (ap.ResourceConfig.counters_only() if pools == "counters"
                    else None)
    capacity = 1 << max(4, (instances - 1).bit_length())  # pow2 >= instances
    registry = LocalServerRegistry()  # shared by both ends in local mode

    def make_transport():
        if transport == "local":
            return LocalTransport(registry)
        if transport == "tcp":
            from .io.tcp import TcpTransport
            return TcpTransport()
        from .io.native import NativeTcpTransport, native_available
        if not native_available():
            raise SystemExit("native transport unavailable (make -C native)")
        return NativeTcpTransport()

    async def drive() -> dict:
        addr = Address("127.0.0.1", 15999)
        # one transport for both ends: the native kind owns an epoll
        # thread pair, shut down in the finally
        tr = make_transport()
        server = AtomixServer(
            addr, [addr], tr, election_timeout=0.5, heartbeat_interval=0.1,
            session_timeout=60.0, executor="tpu",
            engine_config=DeviceEngineConfig(
                capacity=capacity, num_peers=peers, log_slots=log_slots,
                submit_slots=4, resource=engine_pools, device=device))
        await server.open()
        client = AtomixClient([addr], tr, session_timeout=60.0)
        await client.open()
        restore_gc = None
        try:
            t0 = time.perf_counter()
            if payload == "str":
                from .collections import DistributedMap
                counters = await asyncio.gather(
                    *(client.get(f"map{i}", DistributedMap)
                      for i in range(instances)))
            else:
                counters = await asyncio.gather(
                    *(client.get(f"ctr{i}", DistributedAtomicLong)
                      for i in range(instances)))
            engine = server.server.state_machine.device_engine
            on_device = engine._next_group
            log(f"bench[spi:{payload}]: {instances} instances created in "
                f"{time.perf_counter() - t0:.1f}s; {on_device} on-device "
                f"(capacity {capacity}); device={_device_label(device)}")
            restore_gc = _bench_gc_tune()

            lats: list[float] = []
            n_op = [0]

            async def one(c) -> None:
                for _ in range(waves):
                    t = time.perf_counter()
                    if payload == "str":
                        # string values refuse the int32 lanes: host shadow
                        n_op[0] += 1
                        await c.put("k", f"v{n_op[0]}")
                    else:
                        await c.add_and_get(1)
                    lats.append(time.perf_counter() - t)

            reps = []
            best_lats: list[float] = []
            burst_ops = instances * waves
            for rep in range(bursts):
                lats.clear()
                t0 = time.perf_counter()
                await asyncio.gather(*(one(c) for c in counters))
                dt = time.perf_counter() - t0
                ops = burst_ops / dt
                reps.append(ops)
                if ops >= max(reps):
                    best_lats = list(lats)  # latencies pair with `value`
                log(f"bench[spi]: rep {rep}: {burst_ops} ops in {dt:.3f}s "
                    f"-> {ops:,.0f} client-visible ops/sec")
            lat = np.asarray(sorted(best_lats))
            rounds0 = engine._groups.rounds if engine._groups else 0
            METRICS_SNAPSHOTS["server"] = server.server.stats_snapshot()
            METRICS_SNAPSHOTS["client"] = client.client.metrics.snapshot()
            capture_series("server", server.server)
            if check is not None:
                await check(SimpleNamespace(
                    server=server, client=client, engine=engine,
                    counters=counters, expected=bursts * waves))
            return {
                "metric": (f"spi_client_visible_ops_per_sec_{instances}"
                           f"_device_instances"
                           + ("" if transport == "local"
                              else f"_{transport}")
                           + ("" if payload == "int" else "_shadow")
                           + ("" if waves == 1 else f"_w{waves}")),
                "transport": transport,
                "payload": payload,
                "pipeline_depth": waves,
                "value": max(reps),
                "unit": "ops/sec",
                "p50_latency_ms": float(lat[len(lat) // 2]) * 1e3,
                "p99_latency_ms": float(lat[int(len(lat) * 0.99)]) * 1e3,
                "on_device_instances": int(on_device),
                "engine_rounds": int(rounds0),
                **spread(reps),
            }
        finally:
            if restore_gc is not None:
                restore_gc()
            await _close_spi_stack(client, server, tr)

    return asyncio.run(drive())


def run_readmix(instances: int = SPI_INSTANCES, bursts: int = SPI_BURSTS,
                reads: int = READMIX_READS, read_level: str = READMIX_LEVEL,
                log_slots: int = SPI_LOG_SLOTS, peers: int = PEERS,
                device: torch.device | str | None = None,
                check=None) -> dict:
    """The reference's ``readmix`` scenario: read-dominated traffic
    through the public API. ``instances`` device-backed
    ``DistributedAtomicLong``s on one ``AtomixServer(executor="tpu")``
    (the spi engine, counters only); per burst every instance commits ONE
    ``add_and_get(1)`` and then serves ``reads`` gets at ``read_level``
    (``atomic``: lease-gated, the default; ``sequential``; ``none``;
    ``linearizable``: quorum-confirmed). The reads ride the no-append
    query lane and, with ``COPYCAT_SERVER_READ_PUMP`` on (the default),
    the server's read pump, whose device-eligible set goes through one
    ``query_step`` a window. Headline: client-visible reads/s.

    Reports the reference's fields except ``vs_baseline``; like the
    reference, raises unless the first counter reads ``bursts``.
    ``check``, when given, is awaited before teardown with the handles
    (``server``, ``client``, ``engine``, ``counters``), ``answers``: for
    every instance and burst ``(i, written, [reads])``, and
    ``latencies``: the best burst's op latencies in seconds."""
    import asyncio
    from types import SimpleNamespace

    from .atomic import DistributedAtomicLong
    from .io.local import LocalServerRegistry, LocalTransport
    from .io.transport import Address
    from .manager.atomix import AtomixClient, AtomixServer
    from .manager.device_executor import DeviceEngineConfig
    from .resource.consistency import Consistency
    from .utils import knobs

    facade_level = {"atomic": Consistency.ATOMIC,
                    "sequential": Consistency.SEQUENTIAL,
                    "none": Consistency.NONE}.get(read_level)
    if read_level not in READMIX_LEVELS:
        raise SystemExit(f"readmix read level {read_level!r}: "
                         "atomic|sequential|none|linearizable")
    read_pump = knobs.get_bool("COPYCAT_SERVER_READ_PUMP")
    capacity = 1 << max(4, (instances - 1).bit_length())
    registry = LocalServerRegistry()

    async def drive() -> dict:
        addr = Address("127.0.0.1", 15998)
        server = AtomixServer(
            addr, [addr], LocalTransport(registry),
            election_timeout=0.5, heartbeat_interval=0.1,
            session_timeout=60.0, executor="tpu",
            engine_config=DeviceEngineConfig(
                capacity=capacity, num_peers=peers, log_slots=log_slots,
                submit_slots=4, resource=ap.ResourceConfig.counters_only(),
                device=device))
        await server.open()
        client = AtomixClient([addr], LocalTransport(registry),
                              session_timeout=60.0)
        await client.open()
        restore_gc = None
        try:
            t0 = time.perf_counter()
            counters = await asyncio.gather(
                *(client.get(f"ctr{i}", DistributedAtomicLong)
                  for i in range(instances)))
            for c in counters:
                if facade_level is not None:
                    c.with_consistency(facade_level)
                else:
                    # quorum-confirmed reads: the facade vocabulary tops
                    # out at ATOMIC; override the read level only
                    c._read_cl = "linearizable"
            engine = server.server.state_machine.device_engine
            on_device = engine._next_group
            log(f"bench[readmix:{read_level}]: {instances} instances in "
                f"{time.perf_counter() - t0:.1f}s; {on_device} on-device; "
                f"read pump {'ON' if read_pump else 'OFF'}; "
                f"device={_device_label(device)}")
            restore_gc = _bench_gc_tune()
            answers = [] if check is not None else None
            lats: list[float] = []

            async def timed(op):
                t = time.perf_counter()
                out = await op
                lats.append(time.perf_counter() - t)
                return out

            async def one(i, c) -> None:
                written = await timed(c.add_and_get(1))
                got = [await timed(c.get()) for _ in range(reads)]
                if answers is not None:
                    answers.append((i, written, got))

            burst_reads = instances * reads
            burst_ops = instances * (reads + 1)
            reps = []
            best_lats: list[float] = []
            for rep in range(bursts):
                lats.clear()
                t0 = time.perf_counter()
                await asyncio.gather(*(one(i, c)
                                       for i, c in enumerate(counters)))
                dt = time.perf_counter() - t0
                reads_s = burst_reads / dt
                reps.append(reads_s)
                if reads_s >= max(reps):
                    best_lats = list(lats)
                log(f"bench[readmix]: rep {rep}: {burst_reads} reads + "
                    f"{instances} writes in {dt:.3f}s -> "
                    f"{reads_s:,.0f} reads/sec "
                    f"({burst_ops / dt:,.0f} ops/sec)")
            # the reference's spot check: the first counter saw every
            # increment
            v = await counters[0].get()
            if v != bursts:
                raise AssertionError(f"readmix: counter 0 reads {v}, "
                                     f"not {bursts}")
            METRICS_SNAPSHOTS["server"] = server.server.stats_snapshot()
            METRICS_SNAPSHOTS["client"] = client.client.metrics.snapshot()
            if check is not None:
                await check(SimpleNamespace(
                    server=server, client=client, engine=engine,
                    counters=counters, answers=answers, bursts=bursts,
                    latencies=best_lats))
            best = max(reps)
            return {
                "metric": (f"readmix_client_visible_reads_per_sec_"
                           f"{instances}_device_instances_{read_level}"
                           + ("" if read_pump else "_per_op")),
                "value": best,
                "unit": "reads/sec",
                "read_pump": read_pump,
                "read_level": read_level,
                "reads_per_write": reads,
                "ops_per_sec": best * (reads + 1) / reads,
                "on_device_instances": int(on_device),
                **spread(reps),
            }
        finally:
            if restore_gc is not None:
                restore_gc()
            await _close_spi_stack(client, server)

    return asyncio.run(drive())


def _shadow_name(j: int, groups: int) -> str:
    """A host-shadow value name the server's crc32 router puts on group
    ``j % groups``, so that every group's log interleaves ineligible
    entries (hash luck leaving a group shadow-free would hand it
    contiguous runs and measure nothing)."""
    import zlib

    name, t = f"sh{j}", 0
    while zlib.crc32(name.encode()) % groups != j % groups:
        t += 1
        name = f"sh{j}x{t}"
    return name


def run_apply(groups: int = APPLY["groups"],
              sessions: int = APPLY["sessions"], ops: int = APPLY["ops"],
              bursts: int = APPLY["bursts"], keys: int = APPLY["keys"],
              zipf: float = APPLY["zipf"],
              ineligible: float = APPLY["ineligible"],
              device: torch.device | str | None = None,
              check=None) -> dict:
    """The reference's ``apply`` scenario: committed ops/s through the
    public API on one member hosting ``groups`` Raft groups over ONE
    device engine (``DeviceEngineConfig(capacity=pow2 >= keys +
    sessions (min 16), num_peers=3, log_slots=32, submit_slots=8)``,
    counters only). Of ``sessions`` client sessions, an ``ineligible``
    fraction (at least one when positive) stream host-shadow string
    ``set``s, 2 in flight, on values whose names route to every group;
    the others stream ``get_and_set`` of seeded values, 8 in flight, on
    per-session handles to a shared zipfian (``zipf``) keyspace of
    ``keys`` device counters — ``ops`` a burst each (the shadow sessions
    a quarter of that). Each submission waits a seeded number of loop
    turns first, so shadow entries land inside device runs. One untimed
    warm-up wave; tracing on for the ``bursts`` timed ones only (the
    ``latency.apply_ms`` histograms), off again after.

    Reports the reference's fields, the ``apply.*`` family included,
    except ``vs_baseline``. ``check``, when given, is awaited before
    teardown with the handles (``server``, ``engine``, ``handles``: per
    device session, per key), ``writes``: every device write as ``(key,
    value written, value returned)``, warm-up included, and
    ``latencies``: the best burst's op latencies in seconds."""
    import asyncio
    import random
    from types import SimpleNamespace

    from .atomic import DistributedAtomicValue
    from .io.local import LocalServerRegistry, LocalTransport
    from .io.transport import Address
    from .manager.atomix import AtomixClient, AtomixServer
    from .manager.device_executor import DeviceEngineConfig
    from .utils import tracing

    groups = max(1, groups)
    rng = random.Random(17)
    draw_key = zipf_sampler(rng, keys, zipf)
    capacity = 1 << max(4, (keys + sessions - 1).bit_length())

    async def drive() -> dict:
        registry = LocalServerRegistry()
        addr = Address("local", 17500)
        server = AtomixServer(
            addr, [addr], LocalTransport(registry),
            election_timeout=0.5, heartbeat_interval=0.1,
            session_timeout=120.0, executor="tpu", groups=groups,
            engine_config=DeviceEngineConfig(
                capacity=capacity, num_peers=3, log_slots=32,
                submit_slots=8, resource=ap.ResourceConfig.counters_only(),
                device=device))
        await server.open()
        clients = [AtomixClient([addr], LocalTransport(registry),
                                session_timeout=120.0)
                   for _ in range(sessions)]
        await asyncio.gather(*(c.open() for c in clients))
        rs = server.server
        # a positive fraction always yields >= 1 shadow session; exactly 0
        # yields none (the pure-eligible datapoint)
        n_shadow = 0 if ineligible <= 0 else min(
            sessions - 1, max(1, round(sessions * ineligible)))
        n_elig = sessions - n_shadow
        restore_gc = None
        writes = [] if check is not None else None
        try:
            # per-session handles to the SHARED keyspace: instances of one
            # value share a resource (and its device row), while every
            # session submits through its own connection and seq space
            handles = await asyncio.gather(*(
                asyncio.gather(*(clients[i].get(f"k{k}",
                                                DistributedAtomicValue)
                                 for k in range(keys)))
                for i in range(n_elig)))
            shadows = await asyncio.gather(
                *(clients[n_elig + j].get(_shadow_name(j, groups),
                                          DistributedAtomicValue)
                  for j in range(n_shadow)))
            engine = rs.state_machine.device_engine
            log(f"bench[apply]: 1 member x {groups} groups, {n_elig} device "
                f"+ {n_shadow} host-shadow sessions x {ops} ops/burst, zipf "
                f"s={zipf} over {keys} keys, parallel_apply="
                f"{rs._parallel_apply} fuse={rs._apply_fuse}; "
                f"device={_device_label(device)}")
            restore_gc = _bench_gc_tune()
            lats: list[float] = []

            # Bounded in-flight windows, no chunk barriers: a standing
            # backlog keeps the applied windows large. The shadow window
            # is shallow (2): deep shadow pipelining would flush
            # ineligible entries contiguously and hide the interleave.
            # Both lanes wait a few seeded loop turns before sending, so
            # shadow entries land in the middle of device runs.
            async def one_device(i: int, script: list) -> None:
                h = handles[i]
                sem = asyncio.Semaphore(8)

                async def go(k: int, v: int, yields: int) -> None:
                    async with sem:
                        for _ in range(yields):
                            await asyncio.sleep(0)
                        t = time.perf_counter()
                        old = await h[k].get_and_set(v)
                        lats.append(time.perf_counter() - t)
                        if writes is not None:
                            writes.append((k, v, old))
                await asyncio.gather(*(go(k, v, rng.randrange(8))
                                       for k, v in script))

            async def one_shadow(j: int, script: list) -> None:
                sh = shadows[j]
                sem = asyncio.Semaphore(2)

                async def go(s: str, yields: int) -> None:
                    async with sem:
                        for _ in range(yields):
                            await asyncio.sleep(0)
                        t = time.perf_counter()
                        await sh.set(s)
                        lats.append(time.perf_counter() - t)
                await asyncio.gather(*(go(s, rng.randrange(8))
                                       for s in script))

            # a 2-deep shadow stream covers ~1/4 the ops of an 8-deep
            # device stream in the same wall window: shorter scripts keep
            # the two co-terminous
            shadow_ops = max(2, ops // 4)
            burst_ops = n_elig * ops + n_shadow * shadow_ops

            # warm-up wave (untimed, untraced): first-round costs
            await asyncio.gather(
                *(one_device(i, [(draw_key(), 1) for _ in range(ops // 2)])
                  for i in range(n_elig)),
                *(one_shadow(j, [f"w{j}x{t}" for t in range(shadow_ops // 2)])
                  for j in range(n_shadow)))

            # trace every timed request: the latency.apply_ms histograms
            # (commit -> commit future resolved) hold timed samples only
            tracing.TRACER.clear()
            tracing.enable()
            reps = []
            best_lats: list[float] = []
            seq = 0
            for rep in range(bursts):
                lats.clear()
                escripts = [[(draw_key(), rng.randrange(1 << 20))
                             for _ in range(ops)] for _ in range(n_elig)]
                sscripts = []
                for _ in range(n_shadow):
                    script = []
                    for _ in range(shadow_ops):
                        seq += 1
                        script.append(f"s{seq}")
                    sscripts.append(script)
                t0 = time.perf_counter()
                await asyncio.gather(
                    *(one_device(i, s) for i, s in enumerate(escripts)),
                    *(one_shadow(j, s) for j, s in enumerate(sscripts)))
                dt = time.perf_counter() - t0
                reps.append(burst_ops / dt)
                if burst_ops / dt >= max(reps):
                    best_lats = list(lats)
                log(f"bench[apply]: rep {rep}: {burst_ops} committed ops "
                    f"in {dt:.3f}s -> {burst_ops / dt:,.0f} ops/sec")
            METRICS_SNAPSHOTS["server"] = rs.stats_snapshot()
            METRICS_SNAPSHOTS["client"] = clients[0].client.metrics.snapshot()
            tracing.disable()
            # apply-phase tail latency per group; the headline p99 is the
            # worst group's (one group's stalled apply is the client tail)
            lat = {}
            for grp in rs.groups:
                h = grp.metrics.histogram("latency.apply_ms")
                if h.count:
                    lat[str(grp.group_id)] = h.percentile(99)
            fused = rs._metrics.counter("apply.fused_dispatches").value
            fused_rows = rs._metrics.histogram("apply.fused_rows")
            fused_groups = rs._metrics.histogram("apply.fused_groups")
            runs = spans = conflicts = vops = 0
            for grp in rs.groups:
                runs += grp.metrics.counter("vector_runs").value
                vops += grp.metrics.counter("vector_ops").value
                spans += grp.metrics.counter("apply.parallel_spans").value
                conflicts += grp.metrics.counter(
                    "apply.conflict_flushes").value
            if check is not None:
                await check(SimpleNamespace(
                    server=server, engine=engine, handles=handles,
                    writes=writes, latencies=best_lats))
            return {
                "metric": (f"apply_committed_ops_per_sec_{sessions}"
                           f"_sessions_{groups}_groups"),
                "value": max(reps),
                "unit": "ops/sec",
                "groups": groups,
                "sessions": sessions,
                "keys": keys,
                "zipf_s": zipf,
                "ineligible_fraction": ineligible,
                "parallel_apply": rs._parallel_apply,
                "apply_fuse": rs._apply_fuse,
                "latency_apply_p99_ms": max(lat.values()) if lat else 0.0,
                "latency_apply_p99_ms_per_group": lat,
                "apply": {
                    "vector_runs": runs,
                    "vector_ops": vops,
                    "parallel_spans": spans,
                    "conflict_flushes": conflicts,
                    "fused_dispatches": fused,
                    "rows_per_dispatch": fused_rows.mean if fused else 0.0,
                    "groups_per_dispatch": (fused_groups.mean if fused
                                            else 0.0),
                    "runs_per_dispatch": runs / fused if fused else 0.0,
                },
                **spread(reps),
            }
        finally:
            tracing.disable()
            if restore_gc is not None:
                restore_gc()
            for c in clients:
                try:
                    await asyncio.wait_for(c.close(), 10)
                except Exception:
                    pass
            try:
                await asyncio.wait_for(server.close(), 10)
            except Exception:
                pass

    return asyncio.run(drive())


def run_compartment(groups: int | None = None,
                    storage: str | None = None) -> dict:
    """Compartmentalized deployment bench (docs/DEPLOYMENT.md): committed
    ops/sec through a REAL multi-process topology — one OS process per
    Raft member and per standalone ingress proxy, real sockets, real
    fsync — swept across ingress-tier widths
    (``COPYCAT_BENCH_COMPARTMENT_TIERS``, default ``1,2,4``).

    The compartmentalization claim under test (PAPERS.md, "Scaling
    Replicated State Machines with Compartmentalization"): the ingress
    role — client connections, session fan-out, per-group routing, the
    global ingress batching — scales out independently of the write
    quorums it fronts. In-process benches cannot observe this (every
    tier shares one GIL); here each width is a fresh supervised
    topology and the clients pin round-robin across the tier, so adding
    ingress processes adds real CPU parallelism to exactly one role.

    Per-tier attribution rides the artifact from the existing
    ``latency.*`` plane: every ingress process records
    ``latency.ingress_queue_ms`` / ``latency.proxy_hop_ms`` for every
    forward (scraped over its stats port), and the client records
    ``submit_latency_ms`` end-to-end.

    The nemesis phase (``COPYCAT_BENCH_COMPARTMENT_NEMESIS``, on by
    default, widest tier only) SIGKILLs one member AND one ingress proxy
    mid-load through the supervisor: clients re-route within the tier,
    the supervisor restarts the corpses with backoff, and the read-back
    asserts ZERO lost acknowledged writes — every key's replicated
    counter covers every acked increment, and exceeds it only by
    in-doubt (INDETERMINATE) submissions, the exactly-once contract.

    ``COPYCAT_INGRESS_TIER=0`` is the A/B lane: no ingress processes
    deploy and clients dial the members' in-server ingress directly
    (width 0 in the artifact).

    The members serve the counter machine on the host, as the
    reference's do: the scenario runs no device work. ``groups`` and
    ``storage`` override their knobs (``--groups``, ``--storage``).
    Reports the reference's fields except ``vs_baseline`` (a ratio to
    the reference's TPU north star)."""
    import asyncio
    import random as _random

    from .client.client import PinnedConnectionStrategy, RaftClient
    from .deploy.supervisor import Supervisor
    from .deploy.topology import TopologySpec
    from .io.tcp import TcpTransport
    from .io.transport import Address
    from .server.stats import fetch_stats
    from .testing.counter_machine import ClusterAdd, ClusterGet
    from .utils import knobs

    members = max(1, knobs.get_int("COPYCAT_BENCH_COMPARTMENT_MEMBERS"))
    groups = max(1, groups or knobs.get_int(
        "COPYCAT_BENCH_COMPARTMENT_GROUPS"))
    n_clients = knobs.get_int("COPYCAT_BENCH_COMPARTMENT_CLIENTS")
    ops_per_client = knobs.get_int("COPYCAT_BENCH_COMPARTMENT_OPS")
    bursts = knobs.get_int("COPYCAT_BENCH_COMPARTMENT_BURSTS")
    n_keys = knobs.get_int("COPYCAT_BENCH_COMPARTMENT_KEYS")
    zipf_s = knobs.get_float("COPYCAT_BENCH_COMPARTMENT_ZIPF")
    storage = storage or knobs.get_str("COPYCAT_BENCH_COMPARTMENT_STORAGE")
    run_nemesis = knobs.get_bool("COPYCAT_BENCH_COMPARTMENT_NEMESIS")
    if knobs.get_bool("COPYCAT_INGRESS_TIER"):
        tiers = [max(1, int(w)) for w in knobs.get_str(
            "COPYCAT_BENCH_COMPARTMENT_TIERS").split(",") if w.strip()]
    else:
        # the A/B lane: no standalone tier, clients dial the members'
        # in-server ingress directly
        tiers = [0]
    machine = "copycat_tpu_torch.testing.counter_machine:counter_machine"

    rng = _random.Random(12)
    draw_rank = zipf_sampler(rng, n_keys, zipf_s)

    def draw_key() -> str:
        return f"user:{draw_rank()}"

    async def load(client: RaftClient, keys: list,
                   acked: dict, indet: dict) -> None:
        """Streamed micro-batch writer (the sharded scenario's shape)
        that CLASSIFIES every outcome: resolved future = acknowledged
        (the server must never lose it), failed future = in-doubt.
        Chunked so a mid-load process kill leaves a bounded in-flight
        window to classify, not a whole burst."""
        chunk, cap = 64, 768
        pending: list = []
        for i in range(0, len(keys), chunk):
            part = keys[i:i + chunk]
            pending.extend(
                (k, client.submit_command_nowait(ClusterAdd(key=k,
                                                            delta=1)))
                for k in part)
            await asyncio.sleep(0)  # turn boundary: one staged batch
            while len(pending) >= cap:
                k, fut = pending.pop(0)
                try:
                    await fut
                    acked[k] = acked.get(k, 0) + 1
                except Exception:
                    indet[k] = indet.get(k, 0) + 1
        for k, fut in pending:
            try:
                await fut
                acked[k] = acked.get(k, 0) + 1
            except Exception:
                indet[k] = indet.get(k, 0) + 1

    async def scrape(spec: TopologySpec, names: list) -> dict:
        """Per-process ``/stats`` scrape -> the per-tier attribution
        block: ingress latency phases + forward counters per ingress
        process (an unreachable stats port records as ``None``, never
        drops the row)."""
        out: dict = {}
        for name in names:
            try:
                snap = json.loads(await fetch_stats(
                    spec.stats_addrs()[name], "/stats", timeout=5.0))
            except (OSError, RuntimeError, ValueError,
                    asyncio.TimeoutError):
                out[name] = None
                continue
            ing = snap.get("ingress", {})
            out[name] = {
                k: ing.get(k) for k in (
                    "latency.ingress_queue_ms", "latency.proxy_hop_ms",
                    "ingress.commands_forwarded", "ingress.sessions",
                    "ingress.proxy_retries", "ingress.reroutes")}
        return out

    async def run_width(width: int) -> dict:
        spec = TopologySpec.local(
            members=members, ingresses=width, groups=groups,
            storage=storage, machine=machine)
        sup = Supervisor(spec)
        await sup.open()
        clients: list[RaftClient] = []
        restore_gc = None
        try:
            await sup.wait_healthy(timeout=180)
            addrs = [Address.parse(a) for a in spec.client_addrs()]
            clients = [
                RaftClient(addrs, TcpTransport(), session_timeout=120.0,
                           connection_strategy=PinnedConnectionStrategy(
                               addrs[i % len(addrs)]))
                for i in range(n_clients)]
            await asyncio.gather(*(c.open() for c in clients))
            # warmup: one committed write per client primes leader
            # views, session replicas and the disk lanes end to end
            await asyncio.gather(*(
                c.submit(ClusterAdd(key=f"warm:{i}", delta=1))
                for i, c in enumerate(clients)))
            log(f"bench[compartment]: width {width}: {members} member + "
                f"{width} ingress process(es), {groups} group(s), "
                f"{n_clients} clients x {ops_per_client} ops/burst, "
                f"zipf s={zipf_s} over {n_keys} keys, storage={storage}")
            restore_gc = _bench_gc_tune()
            burst_ops = n_clients * ops_per_client
            acked: dict[str, int] = {}
            indet: dict[str, int] = {}
            reps = []
            for rep in range(bursts):
                burst_keys = [[draw_key() for _ in range(ops_per_client)]
                              for _ in range(n_clients)]
                t0 = time.perf_counter()
                await asyncio.gather(*(
                    load(c, ks, acked, indet)
                    for c, ks in zip(clients, burst_keys)))
                dt = time.perf_counter() - t0
                ops = burst_ops / dt
                reps.append(ops)
                log(f"bench[compartment]: width {width} rep {rep}: "
                    f"{burst_ops} ops in {dt:.3f}s -> {ops:,.0f} ops/sec")
            attribution = await scrape(
                spec, [i.name for i in spec.ingresses])
            out = {
                "width": width,
                "ops_per_sec": round(max(reps), 1),
                "client_submit_ms": clients[0].metrics.histogram(
                    "submit_latency_ms").percentile(99),
                "ingress_attribution": attribution,
                **spread(reps),
            }
            if run_nemesis and width == max(tiers) and members >= 3:
                out["nemesis"] = await nemesis_phase(
                    sup, spec, clients, width, acked, indet)
            # zero lost acknowledged writes, every width: each touched
            # key's replicated counter covers every acked increment and
            # exceeds it only by in-doubt submissions
            lost = over = 0
            touched = sorted(acked)
            for i in range(0, len(touched), 256):
                part = touched[i:i + 256]
                got = await asyncio.gather(*(
                    clients[j % len(clients)].submit(ClusterGet(key=k))
                    for j, k in enumerate(part)))
                for k, v in zip(part, got):
                    if v < acked[k]:
                        lost += acked[k] - v
                    if v > acked[k] + indet.get(k, 0):
                        over += v - acked[k] - indet.get(k, 0)
            assert lost == 0, f"LOST {lost} acknowledged write(s)"
            assert over == 0, f"{over} duplicate apply(s) (exactly-once)"
            out["acked_ops"] = sum(acked.values())
            out["indeterminate_ops"] = sum(indet.values())
            out["lost_acked_writes"] = lost
            return out
        finally:
            if restore_gc is not None:
                restore_gc()
            for c in clients:
                try:
                    await asyncio.wait_for(c.close(), 10)
                except Exception:
                    pass
            await sup.close()

    async def nemesis_phase(sup: Supervisor, spec: TopologySpec,
                            clients: list, width: int,
                            acked: dict, indet: dict) -> dict:
        """kill -9 one member AND one ingress proxy mid-load through the
        supervisor (the process-level nemesis): clients re-route within
        the ingress tier, the supervisor restarts the corpses with
        backoff, and the caller's read-back proves zero lost
        acknowledged writes."""
        from .utils.tasks import spawn as spawn_task

        # A SIGKILLed MEMORY-storage member restarts blank — no log, no
        # (term, voted_for) — which violates Raft's persistence
        # assumptions: the blank member can grant a vote that elects a
        # leader missing an acked entry, a TRUE lost write. The member
        # kill therefore requires a durable level; on memory the
        # nemesis kills only the (stateless-by-design) ingress.
        kill_member = storage != "memory" and members >= 3
        log(f"bench[compartment]: nemesis: kill -9"
            + (" member-1" if kill_member else "")
            + (" + ingress-0" if width else "")
            + f" under load (width {width}, storage={storage})")
        keys = [[draw_key() for _ in range(ops_per_client)]
                for _ in range(n_clients)]
        tasks = [spawn_task(load(c, ks, acked, indet),
                            name="compartment-nemesis-load")
                 for c, ks in zip(clients, keys)]
        try:
            await asyncio.sleep(0.15)  # mid-load, not before it
            ok_m, detail_m = (sup.kill("member-1") if kill_member
                              else (False, f"member kill skipped on "
                                           f"{storage} storage"))
            await asyncio.sleep(0.15)
            ok_i, detail_i = (sup.kill("ingress-0") if width
                              else (False, "no ingress tier"))
            await asyncio.gather(*tasks)
        finally:
            for t in tasks:
                t.cancel()
        # both corpses must come back under supervision before teardown
        # (restart-with-backoff is half the nemesis claim)
        deadline = time.monotonic() + 60
        victims = ((["member-1"] if kill_member else [])
                   + (["ingress-0"] if width else []))
        while time.monotonic() < deadline:
            status = sup.status()["children"]
            if all(status[v]["state"] == "running"
                   and status[v]["pid"] for v in victims):
                break
            await asyncio.sleep(0.25)
        status = sup.status()["children"]
        return {
            "killed": {"member": detail_m if ok_m else None,
                       "ingress": detail_i if ok_i else None},
            "restarts": {v: status[v]["restarts"] for v in victims},
            "restored": all(status[v]["state"] == "running"
                            for v in victims),
        }

    async def drive() -> dict:
        widths = []
        for width in tiers:
            widths.append(await run_width(width))
        by_width = {str(w["width"]): w["ops_per_sec"] for w in widths}
        best = max(w["ops_per_sec"] for w in widths)
        base = widths[0]["ops_per_sec"]
        nemesis = next((w.get("nemesis") for w in widths
                        if "nemesis" in w), None)
        METRICS_SNAPSHOTS["compartment"] = {
            str(w["width"]): w["ingress_attribution"] for w in widths}
        return {
            "metric": (f"compartment_committed_ops_per_sec_{members}"
                       f"_members_{groups}_groups"),
            "value": best,
            "unit": "ops/sec",
            "members": members,
            "groups": groups,
            "storage_level": storage,
            "clients": n_clients,
            "zipf_s": zipf_s,
            "keys": n_keys,
            "ingress_tier": knobs.get_bool("COPYCAT_INGRESS_TIER"),
            "tier_widths": tiers,
            "ops_by_width": by_width,
            "scaling_vs_width1": {
                k: round(v / base, 3) for k, v in by_width.items()},
            "widths": widths,
            **({"nemesis": nemesis} if nemesis is not None else {}),
            "lost_acked_writes": sum(w["lost_acked_writes"]
                                     for w in widths),
        }

    return asyncio.run(drive())


def _run(args) -> dict:
    """The scenario ``args`` names, at its flags (a flag left unset takes
    the scenario's default)."""
    dev = args.device
    if args.scenario == "spi":
        return run_spi(args.instances, args.bursts, args.waves, args.payload,
                       args.pools, args.transport,
                       args.log_slots or SPI_LOG_SLOTS, args.peers,
                       device=dev)
    if args.scenario == "readmix":
        return run_readmix(args.instances, args.bursts, args.reads,
                           args.read_level or READMIX_LEVEL,
                           args.log_slots or SPI_LOG_SLOTS, args.peers,
                           device=dev)
    if args.scenario == "compartment":
        return run_compartment(args.groups, args.storage)
    if args.scenario == "apply":
        return run_apply(args.groups or APPLY["groups"],
                         args.sessions or APPLY["sessions"], args.ops,
                         args.bursts, args.keys, args.zipf, args.ineligible,
                         device=dev)
    level = args.read_level or "sequential"
    kw = dict(peers=args.peers, rounds=args.rounds, repeats=args.repeats,
              device=dev)
    if args.scenario == "election":
        return run_election(groups=args.groups or ELECTION_GROUPS, **kw)
    if args.scenario == "map_read":
        return run_map_read(level, groups=args.groups or GROUPS, **kw)
    if args.scenario in ("host", "host_read", "session"):
        kw = dict(groups=args.groups or GROUPS, peers=args.peers,
                  burst=args.burst, repeats=args.repeats, device=dev)
        if args.scenario == "host":
            return run_host(args.mode, telemetry=args.telemetry, **kw)
        if args.scenario == "host_read":
            return run_host_read(level, **kw)
        return run_session(args.sessions or SESSIONS,
                           telemetry=args.telemetry, **kw)
    return run_throughput(args.scenario, groups=args.groups or GROUPS, **kw)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenario", choices=SCENARIOS, default="counter")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (a failed probe exits 2) or cpu; there is no "
                        "fallback from one to the other")
    p.add_argument("--metrics-json", metavar="PATH",
                   help="write the result plus the scenario's metrics "
                        "snapshots, series, profile and attribution block "
                        "as one JSON artifact")
    p.add_argument("--read-level", choices=READMIX_LEVELS,
                   help="map_read, host_read: sequential (default) or "
                        f"atomic; readmix: any (default {READMIX_LEVEL})")
    p.add_argument("--mode", choices=HOST_MODES, default="deep",
                   help="host: the drive")
    p.add_argument("--burst", type=int,
                   help="host, host_read, session: ops per group a drive "
                        f"(default {SUBMIT_SLOTS * 8}; {SUBMIT_SLOTS} for "
                        "--mode queued)")
    p.add_argument("--telemetry", action="store_true",
                   help="host, session: device telemetry on")
    p.add_argument("--sessions", type=int,
                   help=f"session: sessions of the one client (default "
                        f"{SESSIONS}); apply: client sessions (default "
                        f"{APPLY['sessions']})")
    p.add_argument("--groups", type=int,
                   help=f"default {GROUPS} ({ELECTION_GROUPS} for election; "
                        f"apply: Raft groups of the server, default "
                        f"{APPLY['groups']}; compartment: groups of every "
                        f"member, default COPYCAT_BENCH_COMPARTMENT_GROUPS)")
    p.add_argument("--storage", choices=("memory", "mapped", "disk"),
                   help="compartment: member log storage level (default "
                        "COPYCAT_BENCH_COMPARTMENT_STORAGE, disk)")
    p.add_argument("--peers", type=int, default=PEERS)
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--repeats", type=int, default=REPEATS)
    p.add_argument("--instances", type=int, default=SPI_INSTANCES,
                   help="spi, readmix: device resource instances")
    p.add_argument("--bursts", type=int, default=SPI_BURSTS,
                   help="spi, readmix, apply: timed bursts")
    p.add_argument("--waves", type=int, default=1,
                   help="spi: commands in flight per instance")
    p.add_argument("--payload", choices=SPI_PAYLOADS, default="int",
                   help="spi: int counters, or str map values (host shadow)")
    p.add_argument("--pools", choices=SPI_POOLS,
                   help="spi: engine pools (default counters; all for str)")
    p.add_argument("--transport", choices=SPI_TRANSPORTS, default="local",
                   help="spi: the transport under client and server")
    p.add_argument("--log-slots", type=int,
                   help=f"spi, readmix: engine log slots (default "
                        f"{SPI_LOG_SLOTS})")
    p.add_argument("--reads", type=int, default=READMIX_READS,
                   help="readmix: reads per write")
    p.add_argument("--ops", type=int, default=APPLY["ops"],
                   help="apply: commands per device session a burst")
    p.add_argument("--keys", type=int, default=APPLY["keys"],
                   help="apply: device counters in the zipfian keyspace")
    p.add_argument("--zipf", type=float, default=APPLY["zipf"],
                   help="apply: zipf skew of the key draw")
    p.add_argument("--ineligible", type=float, default=APPLY["ineligible"],
                   help="apply: fraction of host-shadow sessions")
    args = p.parse_args(argv)
    if (args.scenario in ("map_read", "host_read")
            and args.read_level not in (None, *READ_LEVELS)):
        p.error(f"--read-level {args.read_level}: {args.scenario} serves "
                f"{'|'.join(READ_LEVELS)}")
    from .utils import profiler
    from .utils.platform import require_devices

    # probe the card before the first CUDA use; a failed probe exits 2
    require_devices(args.device, env="COPYCAT_BENCH_DEVICE_TIMEOUT")
    METRICS_SNAPSHOTS.clear()
    SERIES_WINDOWS.clear()
    # the bench holds its own profiler reference for the whole run: the
    # servers release theirs at close, and this one keeps the sampled
    # window alive for the artifact's top-frame summary (None under
    # COPYCAT_PROFILE=0: no "profile" key)
    bench_profiler = profiler.acquire()
    try:
        result = _run(args)
        if args.metrics_json:
            artifact = {**result, "scenario": args.scenario,
                        "meta": _artifact_meta(args.device),
                        "metrics": METRICS_SNAPSHOTS,
                        "series": SERIES_WINDOWS}
            if bench_profiler is not None:
                artifact["profile"] = bench_profiler.top_summary(top=10)
            with open(args.metrics_json, "w") as f:
                json.dump(artifact, f)
            log(f"bench: metrics snapshot written to {args.metrics_json}")
    finally:
        profiler.release(bench_profiler)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
