"""Counter throughput bench: committed ops/sec over batched Raft groups.

Counterpart of ``copycat_tpu/bench.py::run_throughput("counter")`` at the
same shapes and in the same units: G=10,000 groups × P=3 peers, L=64 log
slots, S=E=A=16 submit slots / append window / applies per round; every
submit slot carries an ``OP_LONG_ADD``; 200 rounds per repetition, best
of 5 after one warm-up repetition.

- committed ops/sec: the global applied high-water delta over the timed
  rounds (exact-once: out_valid reports are at-least-once), over the
  host-clock time of the rounds, ended by a device synchronise;
- ms/round;
- p50/p99 commit latency: rounds from leader-log append to apply (+1 for
  the appending round), histogrammed on the device, and in ms at the
  measured round cadence;
- launches per timed round of each quorum kernel (``launches_per_round``;
  0 on the CPU, where the plain versions run).

Run with ``python -m copycat_tpu_torch.bench``. It runs on the CUDA card
and prints one JSON line naming the card and its power limit; without a
card it raises. ``run_throughput(device="cpu")`` runs it on the CPU for
tests, and labels the result ``cpu``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .device import card_info, resolve_device
from .ops import apply as ap
from .ops.consensus import (
    Config,
    Submits,
    draw_timers,
    full_delivery,
    init_state,
    make_submits,
    step,
)
from .ops import kernels

GROUPS, PEERS, LOG_SLOTS, SUBMIT_SLOTS = 10_000, 3, 64, 16
KERNELS = {"kth_largest": kernels.kth_largest,
           "admit_submits": kernels.admit_submits,
           "ack_commit": kernels.ack_commit}
ROUNDS, REPEATS = 200, 5
SEED = 0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


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


def counter_submits(G: int, S: int, device: torch.device) -> Submits:
    """Every slot of every group carries ``addAndGet(1)``."""
    ones = torch.ones((G, S), dtype=torch.int32, device=device)
    return Submits(opcode=ones * ap.OP_LONG_ADD, a=ones, b=ones * 0,
                   c=ones * 0, tag=ones, valid=ones.bool())


def elect_all(state, empty: Submits, deliver: torch.Tensor,
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


def counter_setup(groups: int = GROUPS, log_slots: int = LOG_SLOTS,
                  submit_slots: int = SUBMIT_SLOTS,
                  device: torch.device | str | None = None):
    """The counter cell, with every group's leader elected: returns
    ``(config, generator, state, deliver, submits)``."""
    dev = resolve_device(device)
    G, P, L, S = groups, PEERS, log_slots, submit_slots
    config = Config(append_window=max(4, S), applies_per_round=max(4, S),
                    timer_min=4, timer_max=9,
                    resource=ap.ResourceConfig.counters_only())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = init_state(G, P, L, draw_timers(G, P, config, gen), config)
    deliver = full_delivery(G, P, dev)
    t0 = time.perf_counter()
    state, n_elect = elect_all(state, make_submits(G, S, dev), deliver, gen,
                               config)
    log(f"bench[counter]: G={G} P={P} L={L} S={S} device={dev}: all "
        f"leaders elected in {n_elect} rounds "
        f"({time.perf_counter() - t0:.1f}s)")
    return config, gen, state, deliver, counter_submits(G, S, dev)


def run_throughput(groups: int = GROUPS, log_slots: int = LOG_SLOTS,
                   submit_slots: int = SUBMIT_SLOTS, rounds: int = ROUNDS,
                   repeats: int = REPEATS,
                   device: torch.device | str | None = None) -> dict:
    dev = resolve_device(device)
    G, P, L, S = groups, PEERS, log_slots, submit_slots
    config, gen, state, deliver, submits = counter_setup(G, L, S, dev)

    # commit-latency histogram: exact integer buckets, the top bucket a
    # saturation catch-all
    max_lat = L + 34

    def run(state):
        hist = torch.zeros(max_lat, dtype=torch.int64, device=dev)
        n = torch.zeros((), dtype=torch.int64, device=dev)
        applied_prev = state.applied_index.amax(dim=1)
        for _ in range(rounds):
            fresh = draw_timers(G, P, config, gen)
            cand = draw_timers(G, P, config, gen)
            state, out = step(state, submits, deliver, fresh, cand, config)
            lat = out.out_latency.reshape(-1).clamp(0, max_lat - 1).long()
            hist.scatter_add_(0, lat, out.out_valid.reshape(-1).long())
            applied_now = state.applied_index.amax(dim=1)
            n += (applied_now - applied_prev).sum()
            applied_prev = applied_now
        return state, n, hist

    state, n, _ = run(state)
    log(f"bench[counter]: warmup committed {int(n)} ops")
    best, best_dt, best_hist, reps = 0.0, 1.0, None, []
    launches = dict.fromkeys(KERNELS, 0)
    for rep in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = {name: k.launches for name, k in KERNELS.items()}
        t0 = time.perf_counter()
        state, n, hist = run(state)
        n = int(n)                      # waits for the device
        dt = time.perf_counter() - t0
        launches = {name: k.launches - before[name]
                    for name, k in KERNELS.items()}
        ops = n / dt
        reps.append(ops)
        if ops >= best:
            best, best_dt, best_hist = ops, dt, hist.cpu().numpy()
        log(f"bench[counter]: rep {rep}: {n} committed ops in {dt:.3f}s "
            f"-> {ops:,.0f} ops/sec ({dt / rounds * 1e3:.3f} ms/round)")
    if best_hist[-1]:
        log(f"bench[counter]: WARNING: {int(best_hist[-1])} samples "
            f"saturated the top latency bucket; p99 is a lower bound")
    ms_per_round = best_dt / rounds * 1e3
    # the round that appended+replicated+applied an entry counts too (+1)
    p50_r, p99_r = [p + 1 for p in percentiles(best_hist, (0.50, 0.99))]
    return {
        "metric": f"committed_linearizable_ops_per_sec_{G}_groups",
        "value": best,
        "unit": "ops/sec",
        "ms_per_round": ms_per_round,
        "p50_commit_latency_rounds": p50_r,
        "p99_commit_latency_rounds": p99_r,
        "p50_commit_latency_ms": p50_r * ms_per_round,
        "p99_commit_latency_ms": p99_r * ms_per_round,
        "launches_per_round": {name: n / rounds
                               for name, n in launches.items()},
        **spread(reps),
        "shape": {"groups": G, "peers": P, "log_slots": L,
                  "submit_slots": S, "rounds": rounds, "repeats": repeats},
        "device": card_info() if dev.type == "cuda" else "cpu",
    }


def main() -> None:
    print(json.dumps(run_throughput()))


if __name__ == "__main__":
    main()
