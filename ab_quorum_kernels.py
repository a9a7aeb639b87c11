"""The quorum kernels of this checkout against other checkouts', timed on
one CUDA card on the same inputs.

    python3 ab_quorum_kernels.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Loads each other checkout's ``copycat_tpu_torch/ops/kernels.py`` as a
module of its own, which builds that checkout's ``csrc/quorum_phase.cu``
and ``kth_largest.cu`` (with the headers beside them) into that
checkout's build directory, and calls each checkout's kernels through its
own wrappers (``admit_submits_cuda``, ``ack_commit_cuda``,
``kth_largest_cuda``: their checks, allocations and C entry points), in
turns: other, this, this, other, for every other checkout in turn. Inputs
of the fused kernels:

- the step's own inputs (``chip_smoke.fused_fns``: the third round of a
  bench cell, every leader elected) at the four widths the paths run the
  static kernels at: the counter bench's G=10,000 × P=3, S=16, L=64; the
  mixed bench's G=100,000 × P=5, S=16, L=32 (six pools, the nemesis); a
  server engine's G=10,000 × P=3, S=4, L=64; ``spi``'s engine, G=1,024 ×
  P=3, S=4, L=16;
- drawn inputs (``copycat_tpu_torch/cases.py``) member-masked at P = 5:
  G=100,000, S=16, L=32 (the membership serve's width) and G=10,000,
  S=16, L=32 (the membership path's);
- served steps' own inputs (``chip_smoke.wide_serve``: a counter op and
  a lane added per group, S=4, L=64): ``RaftGroups(100_000, 5)`` with 3
  voters under dynamic membership (the masked kernels at the membership
  serve's width); the wide serves ``RaftGroups(10_000, 9)`` and
  ``(10_000, 16)``, and ``(10_000, 9)`` with 5 voters; and drawn inputs
  at G=10,000, S=16, L=64: P = 32 static and masked, P = 33 static.

The control row is the tally alone (``csrc/kth_largest.cu``) at P = 3 on
drawn rows (``chip_smoke.edge_rows``: duplicates and INT32_MIN lanes),
G=10,000, k = 2, a kernel the checkouts may share: its spread between
turns is the A/B's noise. P = 32 runs beside it.

Each build's outputs are checked equal to the plain version first. Each
kernel, shape and other checkout prints one JSON line: device ms per call
(100 calls in a CUDA graph, replayed 20 times) in each turn; the kernel's
own duration on the device in each turn (``torch.profiler``, CUDA
activity, 50 eager calls: from the kernel's start to its end, without the
gap between two launches); the eager call's ms (CUDA events around 200
back-to-back calls, the wrapper's host work included); the bound
(``chip_smoke.admit_bound`` / ``ack_bound`` / ``tally_bound``); and two
floors timed in the same graph harness: an empty kernel launched over 4
threads a group in blocks of 128, and one ``Tensor.copy_`` of int32 that
reads and writes as many bytes as the call moves (half of them each way).
The card's name and power limit print first, then each kernel of this
checkout's sources with its registers, spills and stack frame as ``nvcc
-Xptxas -v`` reports them. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs

# the static kernels on the step's own inputs: (label, bench cell)
STEP_SHAPES = (
    ("counter", dict(scenario="counter")),
    ("mixed", cs.MIXED),
    ("server", dict(scenario="counter", groups=10_000, peers=3, log_slots=64,
                    submit_slots=4)),
    ("spi", dict(scenario="counter", groups=1_024, peers=3, log_slots=16,
                 submit_slots=4)),
)
# drawn inputs: (label, G, P, S, L, member-masked)
DRAWN_SHAPES = (
    ("membership serve", 100_000, 5, 16, 32, True),
    ("membership path", 10_000, 5, 16, 32, True),
    ("drawn", 10_000, 32, 16, 64, False),
    ("drawn", 10_000, 32, 16, 64, True),
    ("drawn", 10_000, 33, 16, 64, False),
)
# served steps: (G, P, voters under dynamic membership, or None)
SERVES = ((100_000, 5, 3), (10_000, 9, None), (10_000, 16, None),
          (10_000, 9, 5))
# P of the tally alone: the control (P = 3) and a warp tile
TALLY_PEERS = (3, 32)
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def load_kernels(checkout: pathlib.Path, name: str):
    """``checkout``'s ``ops/kernels.py`` as a module of its own, with its
    libraries built and loaded."""
    path = checkout / "copycat_tpu_torch" / "ops" / "kernels.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.load_libraries()
    return module


class Current:
    """Stands for the kernels module of the build being timed: closures
    made over it (``chip_smoke.step_fns``, ``wide_fns``) call that
    build's wrappers."""

    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        return getattr(self.module, name)


def ptxas_report(kernels, source: pathlib.Path) -> list[str]:
    """One line per kernel of ``source``: its name with its template
    arguments, and what ``nvcc -Xptxas -v`` says of its registers, spills
    and stack frame."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(pathlib.Path(tmp) / "lib.so"), str(source)],
            capture_output=True, text=True, check=True)
    report = {}
    for line in proc.stderr.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"([a-z_]+_kernel)I(\w*?)EE", entry.group(1))
            args = re.findall(r"L[ib](\d+)", m.group(2)) if m else []
            name = (f"{m.group(1)}<{', '.join(args)}>" if m
                    else entry.group(1))
            report[name] = []
        elif report and ("spill" in line or "Used" in line):
            report[name].append(line.split(":", 1)[-1].strip())
    return [f"{name}: {'; '.join(facts)}" for name, facts in report.items()]


def empty_launcher(kernels):
    """An empty kernel's launch, ``fn(threads)``, built with nvcc."""
    tmp = pathlib.Path(tempfile.mkdtemp())
    src, lib = tmp / "empty.cu", tmp / "empty.so"
    src.write_text(EMPTY_SOURCE)
    subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(threads: int) -> None:
        err = fn((threads + 127) // 128, 128,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel launch failed: {err}")
    return launch


def kernel_ms(fn, calls: int = 50) -> float:
    """Mean duration on the device of the kernels ``calls`` eager calls of
    ``fn()`` launch, from ``torch.profiler``'s CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda]
    total = sum(e.self_device_time_total for e in kern)
    if total == 0:
        raise RuntimeError("the profiler saw no device time")
    return total / 1e3 / sum(e.count for e in kern)


def turns(current: Current, this, other, kern, check) -> dict:
    """Device ms per call (CUDA graph), the kernel's own duration
    (profiler) and the eager call's ms of ``kern`` in each build, in turns
    other, this, this, other; ``check(build)`` holds its outputs against
    the plain version first."""
    out = {f"{b}_{m}": [] for b in ("other", "this")
           for m in ("ms", "kernel_ms", "call_ms")}
    for build in ("other", "this", "this", "other"):
        current.module = this if build == "this" else other
        check(build)
        out[f"{build}_ms"].append(cs.graph_ms(kern))
        out[f"{build}_kernel_ms"].append(kernel_ms(kern))
        out[f"{build}_call_ms"].append(cs.time_ms(kern, iters=200,
                                                  warmup=20))
    current.module = this
    for b in ("other", "this"):
        for m in ("ms", "kernel_ms", "call_ms"):
            out[f"{b}_mean_{m}"] = sum(out[f"{b}_{m}"]) / 2
    return out


def floors(empty, G: int, bound: dict, dev) -> dict:
    """The two floors of a call that moves ``bound``'s bytes at G groups:
    an empty kernel over 4 threads a group, and one int32 ``copy_`` that
    reads and writes half the call's bytes each."""
    nbytes = round(bound["bound_ms"] * cs.HBM_BYTES_PER_S / 1e3)
    n = max(nbytes // 8, 1)
    src = torch.ones(n, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    return {"empty_kernel_ms": cs.graph_ms(lambda: empty(4 * G)),
            "copy_ms": cs.graph_ms(lambda: dst.copy_(src)),
            "copy_bytes": 8 * n}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("others", type=pathlib.Path, nargs="+",
                        help="roots of the other checkouts")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_quorum_kernels: no CUDA card", file=sys.stderr)
        return 1
    from copycat_tpu_torch import bench, cases
    from copycat_tpu_torch.device import card_info
    from copycat_tpu_torch.models import RaftGroups
    from copycat_tpu_torch.ops import apply as ap
    from copycat_tpu_torch.ops import consensus as cons
    from copycat_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    card = card_info()
    cs.say(card)
    for source in kernels.SOURCES:
        for line in ptxas_report(kernels, source):
            cs.say(f"ptxas: {line}")
    kernels.load_libraries()
    others = {str(path): load_kernels(path.resolve(), f"ab_other_{i}")
              for i, path in enumerate(args.others)}
    current = Current(kernels)
    empty = empty_launcher(kernels)
    rng = np.random.default_rng(9)

    def fused_rows(fns: dict, what: dict, G: int) -> None:
        for name in ("admit_submits", "ack_commit"):
            kern, plain, _, bound = fns[name]
            label = f"{name} at {what}"
            floor = floors(empty, G, bound, dev)
            for other_name, other in others.items():
                timed = turns(current, kernels, other, kern,
                              lambda build: cs.max_err(
                                  kern(), plain(), f"{label}, {build} build"))
                cs.say(json.dumps({"name": name, **what, "other": other_name,
                                   **timed, **bound, **floor, "card": card}))

    for label, cell in STEP_SHAPES:
        seen = cs.step_inputs(bench, cons, dev, cs.STEP_FNS, **cell)
        fns = cs.step_fns(current, seen, f"the {label} step's inputs")[0]
        (G, P), S = seen["admit_submits"][0][0].shape, \
            seen["admit_submits"][0][3].shape[1]
        L = seen["ack_commit"][1]["l_log_term"].shape[1]
        fused_rows(fns, {"shape": label, "G": G, "P": P, "S": S, "L": L,
                         "masked": False, "inputs": "the step's"}, G)
    for label, G, P, S, L, masked in DRAWN_SHAPES:
        fns = cs.wide_fns(current, cases, dev, rng, G, P, S, L, masked)
        fused_rows(fns, {"shape": label, "G": G, "P": P, "S": S, "L": L,
                         "masked": masked, "inputs": "drawn"}, G)
    for G, P, voters in SERVES:
        _, seen = cs.wide_serve(RaftGroups, ap, bench.KERNELS, P,
                                voters=voters, G=G)
        fns = cs.step_fns(current, seen, f"the P={P} serve's step")[0]
        S = seen["admit_submits"][0][3].shape[1]
        fused_rows(fns, {"shape": "serve", "G": G, "P": P, "S": S, "L": 64,
                         "masked": voters is not None,
                         "inputs": "the serve's step"}, G)
    for P in TALLY_PEERS:
        G, k = 10_000, P // 2 + 1
        x = torch.from_numpy(cs.edge_rows(rng, G, P)).to(dev)
        want = kernels.kth_largest_plain(x, k)

        def same(build):
            if not torch.equal(current.kth_largest_cuda(x, k), want):
                raise AssertionError(f"kth_largest at P={P}, {build} build "
                                     "differs from the plain version")

        bound = cs.tally_bound(G, P)
        floor = floors(empty, G, bound, dev)
        for other_name, other in others.items():
            timed = turns(current, kernels, other,
                          lambda: current.kth_largest_cuda(x, k), same)
            cs.say(json.dumps({
                "name": "kth_largest", "P": P, "k": k, "G": G,
                "inputs": "drawn", "other": other_name, **timed, **bound,
                **floor, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
