"""Quorum tally: the k-th largest value along the peer axis.

Raft's quorum median — the k-th largest ``applied_index`` (backpressure
floor) and ``matchIndex`` (commit candidate) across a group's P lanes —
runs twice per consensus round. Counterpart of
``copycat_tpu/ops/pallas_kernels.py``:

- :func:`kth_largest_plain` — masked max-extraction in torch, the plain
  version (``pallas_kernels.kth_largest``);
- :func:`kth_largest_masked` — per-group k over a lane mask, the O(P²)
  rank-select (``pallas_kernels.kth_largest_masked``), used by dynamic
  membership;
- :func:`kth_largest` — the dispatching wrapper. A CPU tensor takes the
  plain version; a CUDA tensor launches the hand-written kernel
  ``csrc/kth_largest.cu`` or raises. ``kth_largest.launches`` counts the
  kernel launches.

The kernel library is built with ``nvcc`` at first use from the source in
this package, into ``copycat_tpu_torch/_build/``, keyed on the source's
hash, and bound through a plain C function with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

INT_MIN = -(2 ** 31)

_PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
KTH_SOURCE = _PKG_DIR / "csrc" / "kth_largest.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_DEFAULT = pathlib.Path("/usr/local/cuda/bin/nvcc")
MAX_PEERS = 8
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[pathlib.Path, ctypes.CDLL] = {}   # loaded once per source


def kth_largest_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest along axis 1 of ``x [G, P]`` (k is 1-based): k-1
    rounds of removing the first maximum, then the maximum."""
    m = x
    for _ in range(k - 1):
        mx = m.amax(dim=1, keepdim=True)
        is_mx = m == mx
        first = (torch.cumsum(is_mx, dim=1, dtype=torch.int32) == 1) & is_mx
        m = torch.where(first, INT_MIN, m)
    return m.amax(dim=1)


def kth_largest_masked(x: torch.Tensor, mask: torch.Tensor,
                       k: torch.Tensor) -> torch.Tensor:
    """k-th largest of ``x [G, P]`` among ``mask [G, P]`` lanes, with a
    per-group ``k [G]`` (1-based): each lane's tie-broken descending rank,
    and the lane whose rank is k-1 (exactly one while k ≤ member count)."""
    P = x.shape[1]
    xm = torch.where(mask, x, INT_MIN)
    r_val = xm[:, :, None]
    s_val = xm[:, None, :]
    ids = torch.arange(P, dtype=torch.int32, device=x.device)
    r_idx = ids[None, :, None]
    s_idx = ids[None, None, :]
    beats = (s_val > r_val) | ((s_val == r_val) & (s_idx < r_idx))
    rank = beats.sum(dim=2, dtype=torch.int32)
    sel = rank == (k - 1)[:, None]
    return torch.where(sel, xm, 0).sum(dim=1, dtype=torch.int32)


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError(
        "nvcc not found: the CUDA toolkit is needed to build "
        f"{KTH_SOURCE.name}")


def library_path(source: pathlib.Path = KTH_SOURCE) -> pathlib.Path:
    """Where the built library for ``source`` lives: keyed on the source's
    content, so an edited kernel is rebuilt and a stale one never loads."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build_library(source: pathlib.Path = KTH_SOURCE) -> pathlib.Path:
    """Compile ``source`` into a shared library unless it is built already;
    returns its path. The library is written under a temporary name and
    renamed, so a concurrent or interrupted build never leaves a partial
    file where a loader looks."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source.name} (rc {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_library(source: pathlib.Path = KTH_SOURCE) -> ctypes.CDLL:
    """The kernel library for ``source``, built and loaded on first use
    (later calls take the loaded library without touching the file)."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(source)))
        lib.kth_largest_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.kth_largest_launch.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def kth_largest_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``x [G, P]`` int32 (contiguous, on the
    card) on the current stream; returns ``[G]`` int32."""
    if x.device.type != "cuda":
        raise ValueError(f"kth_largest_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise ValueError(f"kth_largest_cuda needs int32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"kth_largest_cuda needs [G, P], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("kth_largest_cuda needs a contiguous tensor")
    G, P = x.shape
    if not 1 <= P <= MAX_PEERS:
        raise ValueError(f"kth_largest_cuda takes 1..{MAX_PEERS} peers, got {P}")
    if not 1 <= k <= P:
        raise ValueError(f"k={k} outside 1..{P}")
    lib = load_library()
    out = torch.empty(G, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.kth_largest_launch(x.data_ptr(), out.data_ptr(), G, P, k,
                                     stream)
    if err != 0:
        raise RuntimeError(f"kth_largest kernel launch failed: CUDA error {err}")
    kth_largest.launches += 1
    return out


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest along axis 1 of ``x [G, P]``: the plain version on a
    CPU tensor, the CUDA kernel on a CUDA tensor. Any other device raises."""
    if x.device.type == "cpu":
        return kth_largest_plain(x, k)
    if x.device.type == "cuda":
        return kth_largest_cuda(x, k)
    raise ValueError(f"kth_largest: unsupported device {x.device}")


kth_largest.launches = 0
