"""Smoke run of copycat_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. card and build — the card's name and power limit, then the kernel
   library built from ``copycat_tpu_torch/csrc/kth_largest.cu``;
2. kernel — the quorum-tally kernel against its plain torch version on
   the card, bit for bit, over G ∈ {10,000, 100,000, 1,001}, P ∈ {3, 5, 7},
   k ∈ {P//2+1, 1, P}, with duplicate rows and INT_MIN lanes; plus the
   floor-mod and first-index argmax the step relies on;
3. path — the consensus step on the card (kernel) and on the CPU (plain
   version) from one state and one set of timer draws, G=1,000, P=3,
   L=64, S=16, 50 rounds under random partitions: every state and output
   leaf equal every round;
4. serve — the main path: ``RaftGroups(10_000, 3, log_slots=64,
   submit_slots=16)`` elects leaders and answers a few hundred
   ``OP_LONG_ADD`` requests, each checked against its running sum; the
   kernel's launch count, zeroed just before, must rise;
5. bench — the counter bench at full size (G=10,000 × P=3 × L=64 × S=16),
   and the kernel's time per call at G=10,000, P=3 beside its plain
   version, a library call computing the same function, and its bound;
   then a short ``torch.profiler`` window of the same step: kernel time,
   the device's idle share and launches per round.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12        # H100 SXM 32-bit rate outside the tensor cores


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


def phase_build(kernels) -> float:
    t0 = time.perf_counter()
    kernels.load_library()
    return time.perf_counter() - t0


def phase_kernel(kernels, dev) -> int:
    rng = np.random.default_rng(0)
    worst = 0
    cases = 0
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
                worst = max(worst, err)
                cases += 1
    say(f"kernel: {cases} cases equal to the plain version bit for bit "
        f"(max |err| {worst})")
    m = torch.tensor([-5, -1, 3, 4], dtype=torch.int32, device=dev) % 4
    if m.tolist() != [3, 3, 3, 0]:
        raise AssertionError(f"int32 % is not floor-mod on the card: {m}")
    am = torch.tensor([[1, 3, 3], [2, 2, 2], [-1, -1, 0]], dtype=torch.int32,
                      device=dev).argmax(dim=1)
    if am.tolist() != [1, 0, 2]:
        raise AssertionError(f"argmax ties do not go to the first index: {am}")
    say("kernel: int32 % is floor-mod and argmax ties take the first index")
    return worst


def phase_path(cons, convert, ap, dev) -> None:
    G, P, L, S, rounds = 1_000, 3, 64, 16, 50
    cfg = cons.Config(append_window=S, applies_per_round=S,
                      resource=ap.ResourceConfig.counters_only())
    rng = np.random.default_rng(1)

    def draws():
        return rng.integers(cfg.timer_min, cfg.timer_max, (G, P)
                            ).astype(np.int32)

    timer = torch.from_numpy(draws())
    cpu = cons.init_state(G, P, L, timer, cfg)
    gpu = cons.init_state(G, P, L, timer.to(dev), cfg)
    ops = np.array([ap.OP_LONG_ADD] * 6 + [ap.OP_VALUE_SET, ap.OP_VALUE_GET,
                                            ap.OP_VALUE_CAS, ap.OP_MAP_PUT],
                   np.int32)
    victims = rng.integers(0, P, G)
    installs = 0
    for r in range(rounds):
        sub = dict(opcode=rng.choice(ops, (G, S)).astype(np.int32),
                   a=rng.integers(-3, 4, (G, S)).astype(np.int32),
                   b=rng.integers(-3, 4, (G, S)).astype(np.int32),
                   c=rng.integers(0, 4, (G, S)).astype(np.int32),
                   tag=rng.integers(1, 1 << 30, (G, S)).astype(np.int32),
                   valid=rng.random((G, S)) < 0.8)
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
            for name, w in want.items():
                g = got[name]
                if w is None and g is None:
                    continue
                if w.dtype != g.dtype or not np.array_equal(w, g):
                    raise AssertionError(
                        f"path: {what}.{name} differs at round {r}")
        if out_c.stale.any():
            cpu = cons.install_snapshots(cpu, out_c.stale, out_c.leader, cfg)
            gpu = cons.install_snapshots(gpu, out_g.stale, out_g.leader, cfg)
            installs += 1
    say(f"path: CUDA step == CPU step on every leaf for {rounds} rounds "
        f"(G={G} P={P} L={L} S={S}, random partitions, {installs} snapshot "
        "installs)")


def phase_serve(RaftGroups, ap, kernels) -> int:
    kernels.kth_largest.launches = 0
    t0 = time.perf_counter()
    rg = RaftGroups(10_000, 3, log_slots=64, submit_slots=16)
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
    launches = kernels.kth_largest.launches
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
    if launches == 0:
        raise AssertionError("serve: the quorum-tally kernel never launched")
    say(f"serve: {len(tags)} requests on {len(totals)} of 10000 groups "
        f"answered correctly in {rg.rounds} rounds ({dt:.1f}s); "
        f"kth_largest launches {launches}")
    return launches


def phase_bench(bench, kernels, dev, card: str) -> tuple[dict, dict]:
    kernels.kth_largest.launches = 0
    result = bench.run_throughput()
    launches = kernels.kth_largest.launches
    if launches == 0:
        raise AssertionError("bench: the quorum-tally kernel never launched")
    say(f"bench: {result['value']:.1f} committed ops/s, "
        f"{result['ms_per_round']:.4f} ms/round, p50 "
        f"{result['p50_commit_latency_rounds']} rounds "
        f"({result['p50_commit_latency_ms']:.4f} ms), p99 "
        f"{result['p99_commit_latency_rounds']} rounds "
        f"({result['p99_commit_latency_ms']:.4f} ms) at G=10000 P=3 L=64 "
        f"S=16 on {card}; kth_largest launches {launches} "
        f"({result['kth_launches_per_round']} per timed round)")
    say("bench: " + json.dumps(result))

    G, P, k = 10_000, 3, 2
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 1 << 20, (G, P)).astype(np.int32)
                         ).to(dev)
    fns = {"kernel": lambda: kernels.kth_largest_cuda(x, k),
           "plain": lambda: kernels.kth_largest_plain(x, k),
           "library": lambda: torch.topk(x, k, dim=1).values[:, -1]}
    dev_ms = {name: graph_ms(fn) for name, fn in fns.items()}
    call_ms = {name: time_ms(fn) for name, fn in fns.items()}
    bytes_ms = (G * P * 4 + G * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * G * P * P / SCALAR_OPS_PER_S * 1e3
    timing = dict(ms=dev_ms["kernel"], plain_ms=dev_ms["plain"],
                  library_ms=dev_ms["library"],
                  bound_ms=max(bytes_ms, ops_ms),
                  bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                  call_ms=call_ms["kernel"], plain_call_ms=call_ms["plain"],
                  library_call_ms=call_ms["library"],
                  launches_bench=launches)
    say(f"kernel time at G={G} P={P} k={k} on {card}, device time per call "
        f"(CUDA graph): kth_largest {dev_ms['kernel']:.6f} ms, plain torch "
        f"{dev_ms['plain']:.6f} ms, torch.topk {dev_ms['library']:.6f} ms; "
        f"eager call time: {call_ms['kernel']:.6f} / {call_ms['plain']:.6f}"
        f" / {call_ms['library']:.6f} ms; bound {timing['bound_ms']:.6f} ms "
        f"({timing['bound_by']})")
    return result, timing


def phase_profile(bench, cons, dev, card: str, rounds: int = 20) -> None:
    """Where a counter round's time goes: ``rounds`` rounds of the bench's
    step under ``torch.profiler``: wall time, summed kernel time, the
    device's idle share, kernel launches per round and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    cfg, gen, state, deliver, submits = bench.counter_setup(device=dev)
    G, P = state.term.shape

    def run(state, n):
        for _ in range(n):
            state, _ = cons.step(state, submits, deliver,
                                 cons.draw_timers(G, P, cfg, gen),
                                 cons.draw_timers(G, P, cfg, gen), cfg)
        return state

    state = run(state, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = run(state, rounds)
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
        return
    launches = sum(e.count for e in kern) / rounds
    say(f"profile ({rounds} counter rounds, G=10000 P=3 L=64 S=16, on "
        f"{card}, profiler on): wall {wall_ms:.3f} ms/round, kernel time "
        f"{busy_ms:.3f} ms/round, device idle share "
        f"{1 - busy_ms / wall_ms:.4f}, {launches:.1f} kernel launches/round")
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        say(f"profile:   {e.self_device_time_total / 1e3 / rounds:.4f} "
            f"ms/round  x{e.count // rounds}  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from copycat_tpu_torch import bench, convert
    from copycat_tpu_torch.device import card_info
    from copycat_tpu_torch.models import RaftGroups
    from copycat_tpu_torch.ops import apply as ap
    from copycat_tpu_torch.ops import consensus as cons
    from copycat_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    card = card_info()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    say(f"build: kernel library built in {phase_build(kernels):.1f}s")
    max_err = phase_kernel(kernels, dev)
    phase_path(cons, convert, ap, dev)
    launches = phase_serve(RaftGroups, ap, kernels)
    _, timing = phase_bench(bench, kernels, dev, card)
    phase_profile(bench, cons, dev, card)
    say(json.dumps({"kernels": [{
        "name": "kth_largest",
        "route": "cuda",
        "source": "copycat_tpu_torch/csrc/kth_largest.cu",
        "replaces": "copycat_tpu/ops/pallas_kernels.py:67",
        "launches": launches,
        "max_abs_err": max_err,
        **timing,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
