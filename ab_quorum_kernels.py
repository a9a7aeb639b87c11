"""The quorum kernels of this checkout against another checkout's, timed
on one CUDA card on the same inputs.

    python3 ab_quorum_kernels.py OTHER_CHECKOUT

Builds ``OTHER_CHECKOUT/copycat_tpu_torch/csrc/quorum_phase.cu`` and
``kth_largest.cu`` (with the headers beside them) as ``ops/kernels.py``
builds this checkout's, and calls both checkouts' libraries through this
checkout's wrappers ``admit_submits_cuda``, ``ack_commit_cuda`` and
``kth_largest_cuda`` (the same checks, allocations and C entry points), in
turns: other, this, this, other. Inputs of the fused kernels:

- the wide serves' own step inputs (``chip_smoke.wide_serve``):
  ``RaftGroups(10_000, 9)`` and ``(10_000, 16)``, and ``(10_000, 9)`` with
  5 voters under dynamic membership, S=4;
- drawn inputs (``copycat_tpu_torch/cases.py``) at G=10,000, S=16, L=64:
  P = 32 static and masked, P = 33 static, and P = 3 static and P = 5
  masked, whose unrolled kernels the two checkouts may share, as a
  measure of the noise.

The tally alone runs on drawn rows (``chip_smoke.edge_rows``: duplicates
and INT32_MIN lanes) at G=10,000, k = P // 2 + 1, for P = 9, 16, 32 and
33, and P = 3 as the control.

Each build's outputs are checked equal to the plain version first. Each
kernel and shape prints one JSON line: device ms per call (100 calls in a
CUDA graph, replayed 20 times) in each turn; the kernel's own duration on
the device in each turn (``torch.profiler``, CUDA activity, 50 eager
calls: from the kernel's start to its end, without the gap between two
launches); and the bound. The card's name and power limit print first,
then each kernel of this checkout's sources with its registers, spills and
shared memory as ``nvcc -Xptxas -v`` reports them. Without a card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs

# (P, member-masked, served): the wide serves, drawn P = 32 and 33, and
# two unrolled shapes as controls
SHAPES = ((9, False, True), (16, False, True), (9, True, True),
          (32, False, False), (32, True, False), (33, False, False),
          (3, False, False), (5, True, False))
# P of the tally alone: the warp tiles, and an unrolled control
TALLY_PEERS = (9, 16, 32, 33, 3)


def entries(kernels, sources) -> dict:
    """The C entry points of ``sources``, each built into this checkout's
    build directory (keyed on that source's hash)."""
    libs = kernels.build_libraries(sources)
    fns = {}
    for src, path in zip(sources, libs):
        lib = ctypes.CDLL(str(path))
        for name, argtypes in kernels.ENTRY_POINTS[src.name].items():
            fn = fns[name] = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return fns


def ptxas_report(kernels, source: pathlib.Path) -> list[str]:
    """One line per kernel of ``source``: its name with its template
    arguments, and what ``nvcc -Xptxas -v`` says of its registers, spills
    and shared memory."""
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


@contextlib.contextmanager
def launching(kernels, fns: dict):
    """While open, the wrappers launch through the entry points ``fns``."""
    saved = {name: kernels._entries[name] for name in fns}
    kernels._entries.update(fns)
    try:
        yield
    finally:
        kernels._entries.update(saved)


def turns(kernels, builds: dict, kern, check) -> tuple[dict, dict]:
    """Device ms per call (CUDA graph) and the kernel's own duration
    (profiler) of ``kern`` in each build, in turns other, this, this,
    other; ``check(build)`` holds its outputs against the plain version
    first."""
    ms = {b: [] for b in builds}
    own = {b: [] for b in builds}
    for build in ("other", "this", "this", "other"):
        with launching(kernels, builds[build]):
            check(build)
            ms[build].append(cs.graph_ms(kern))
            own[build].append(kernel_ms(kern))
    return ms, own


def means(ms: dict, own: dict) -> dict:
    return {"other_ms": ms["other"], "this_ms": ms["this"],
            "other_mean_ms": sum(ms["other"]) / 2,
            "this_mean_ms": sum(ms["this"]) / 2,
            "other_kernel_ms": own["other"], "this_kernel_ms": own["this"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=pathlib.Path,
                        help="root of the other checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_quorum_kernels: no CUDA card", file=sys.stderr)
        return 1
    from copycat_tpu_torch import bench, cases
    from copycat_tpu_torch.device import card_info
    from copycat_tpu_torch.models import RaftGroups
    from copycat_tpu_torch.ops import apply as ap
    from copycat_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    card = card_info()
    cs.say(card)
    for source in kernels.SOURCES:
        for line in ptxas_report(kernels, source):
            cs.say(f"ptxas: {line}")
    other_csrc = args.other.resolve() / "copycat_tpu_torch" / "csrc"
    builds = {"this": entries(kernels, kernels.SOURCES),
              "other": entries(kernels, tuple(
                  other_csrc / src.name for src in kernels.SOURCES))}
    kernels._entries.update(builds["this"])
    rng = np.random.default_rng(9)
    for P, masked, served in SHAPES:
        if served:
            _, seen = cs.wide_serve(RaftGroups, ap, bench.KERNELS, P,
                                    voters=5 if masked else None)
            fns = cs.step_fns(kernels, seen, f"the P={P} serve's step")[0]
            S = seen["admit_submits"][0][3].shape[1]
        else:
            S = 16
            fns = cs.wide_fns(kernels, cases, dev, rng, 10_000, P, S, 64,
                              masked)
        for name in ("admit_submits", "ack_commit"):
            kern, plain, _, bound = fns[name]
            what = f"{name} at P={P}" + (" (masked)" if masked else "")
            timed = turns(kernels, builds, kern, lambda build: cs.max_err(
                kern(), plain(), f"{what}, {build} build"))
            cs.say(json.dumps({
                "name": name, "P": P, "masked": masked, "G": 10_000, "S": S,
                "inputs": "the serve's step" if served else "drawn",
                **means(*timed), **bound, "card": card}))
    for P in TALLY_PEERS:
        G, k = 10_000, P // 2 + 1
        x = torch.from_numpy(cs.edge_rows(rng, G, P)).to(dev)
        want = kernels.kth_largest_plain(x, k)

        def same(build):
            if not torch.equal(kernels.kth_largest_cuda(x, k), want):
                raise AssertionError(f"kth_largest at P={P}, {build} build "
                                     "differs from the plain version")

        timed = turns(kernels, builds, lambda: kernels.kth_largest_cuda(x, k),
                      same)
        cs.say(json.dumps({
            "name": "kth_largest", "P": P, "k": k, "G": G, "inputs": "drawn",
            **means(*timed), **cs.bounds(G * P * 4 + G * 4, 2 * G * P * P),
            "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
