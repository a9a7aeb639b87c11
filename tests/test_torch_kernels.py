"""The quorum-tally functions of ``copycat_tpu_torch/ops/kernels.py``
against the JAX reference (``copycat_tpu/ops/pallas_kernels.py``).

On the CPU the wrapper runs the plain version; it is held against the
jnp selection and against the Pallas kernel in interpret mode, exactly
(int32). The CUDA kernel itself is held against the plain version by the
``cuda``-marked test in ``test_torch_package.py`` (which imports no JAX,
so it runs on a card's machine) and by ``chip_smoke.py``.

The reference's selections and Pallas runs depend on nothing of the
port's: they run once, in a worker process started with the session's
first port file (``torch_reference.LONG_RUNS``), and come back to the
cases.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import (  # noqa: E402,F401
    LONG_RUNS,
    SUITE_AHEAD,
    release_jax_programs,
)
import jax.numpy as jnp  # noqa: E402

from copycat_tpu.ops.pallas_kernels import (  # noqa: E402
    kth_largest as jkth,
    kth_largest_masked as jkth_masked,
    kth_largest_pallas,
)

from copycat_tpu_torch.ops import kernels  # noqa: E402

INT_MIN = np.iinfo(np.int32).min


def _with_edges(x: np.ndarray, rng) -> np.ndarray:
    """Overwrite some rows with duplicates and some lanes with INT_MIN."""
    x = x.copy()
    G, P = x.shape
    dup = rng.random(G) < 0.2
    x[dup] = x[dup, :1]
    x[rng.random((G, P)) < 0.1] = INT_MIN
    return x


NARROW_TALLY = [(3, 2), (5, 3), (7, 4), (4, 1), (3, 3)]
PALLAS_GROUPS = [64, 512, 1000]


def _narrow_rows(P, k):
    rng = np.random.default_rng(P * 10 + k)
    return _with_edges(rng.integers(-100, 100, (257, P)).astype(np.int32),
                       rng)


def _pallas_rows(G):
    rng = np.random.default_rng(G)
    return _with_edges(rng.integers(0, 1 << 20, (G, 3)).astype(np.int32),
                       rng)


def _wide_rows(P, k):
    rng = np.random.default_rng(P * 100 + k)
    return _with_edges(rng.integers(-100, 100, (257, P)).astype(np.int32),
                       rng)


def _reference_tallies() -> dict:
    """The reference's answers for every tally case: the jnp selection
    and, where a case holds the port against it, the Pallas kernel in
    interpret mode."""
    out = {}
    for P, k in NARROW_TALLY:
        out["jnp", P, k] = np.asarray(jkth(jnp.asarray(_narrow_rows(P, k)),
                                           k))
    for G in PALLAS_GROUPS:
        out["pallas", G] = np.asarray(kth_largest_pallas(
            jnp.asarray(_pallas_rows(G)), 2, block=256, interpret=True))
    for P, k in WIDE_TALLY:
        x = jnp.asarray(_wide_rows(P, k))
        out["wide", P, k] = (np.asarray(jkth(x, k)), np.asarray(
            kth_largest_pallas(x, k, block=256, interpret=True))
            if P in (16, 33) else None)
    return out


@pytest.mark.parametrize("P,k", NARROW_TALLY)
def test_kth_largest_matches_jnp(P, k):
    x = _narrow_rows(P, k)
    want = SUITE_AHEAD.get("kernels", _reference_tallies)["jnp", P, k]
    got = kernels.kth_largest(torch.from_numpy(x), k).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x, axis=1)[:, ::-1][:, k - 1])


# past the unrolled kernels (P <= 8): the warp tiles' edges (16 and 32
# lanes a tile, 17 and 33 just past them) and two lanes a thread (64)
WIDE_TALLY = [(P, k) for P in (9, 16, 17, 32, 33, 64)
              for k in sorted({1, P // 2 + 1, P})]


@pytest.mark.parametrize("P,k", WIDE_TALLY)
def test_wide_kth_largest_matches_the_reference(P, k):
    """More than 8 peers, the shapes the card runs on warp tiles: the
    port's tally equals the jnp selection, and at P = 16 and 33 the Pallas
    kernel in interpret mode, exactly, on rows with duplicates and INT_MIN
    lanes."""
    x = _wide_rows(P, k)
    want, pallas = SUITE_AHEAD.get("kernels", _reference_tallies)[
        "wide", P, k]
    got = kernels.kth_largest(torch.from_numpy(x), k).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x, axis=1)[:, ::-1][:, k - 1])
    assert (pallas is not None) == (P in (16, 33))
    if pallas is not None:
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("G", PALLAS_GROUPS)
def test_kth_largest_matches_pallas_interpret(G):
    x = _pallas_rows(G)
    want = SUITE_AHEAD.get("kernels", _reference_tallies)["pallas", G]
    got = kernels.kth_largest(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)


def test_kth_largest_with_duplicates():
    x = torch.tensor([[5, 5, 5], [1, 1, 2], [0, 7, 7], [INT_MIN, INT_MIN, 3]],
                     dtype=torch.int32)
    assert kernels.kth_largest(x, 2).tolist() == [5, 1, 7, INT_MIN]


@pytest.mark.parametrize("P", [3, 5, 7])
def test_kth_largest_masked_matches_jnp(P):
    rng = np.random.default_rng(P)
    G = 300
    x = _with_edges(rng.integers(-50, 50, (G, P)).astype(np.int32), rng)
    mask = rng.random((G, P)) < 0.7
    mask[:, 0] = True
    members = mask.sum(axis=1)
    k = (rng.integers(0, 1 << 30, G) % members + 1).astype(np.int32)
    want = np.asarray(jkth_masked(jnp.asarray(x), jnp.asarray(mask),
                                  jnp.asarray(k)))
    got = kernels.kth_largest_masked(torch.from_numpy(x),
                                     torch.from_numpy(mask),
                                     torch.from_numpy(k)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_wrapper_takes_plain_version_only_on_cpu():
    before = kernels.kth_largest.launches
    x = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    assert kernels.kth_largest(x, 2).tolist() == [2]
    assert kernels.kth_largest.launches == before  # the plain version ran
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.kth_largest(x.to("meta"), 2)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernels.kth_largest_cuda(torch.zeros((4, 3), dtype=torch.int32), 2)


def test_missing_toolchain_raises(monkeypatch, tmp_path):
    """Without nvcc the library cannot be built, and loading it raises —
    there is no fallback to the plain version."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "NVCC_DEFAULT", tmp_path / "nvcc")
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    src = tmp_path / "kth_largest.cu"
    src.write_bytes(kernels.KTH_SOURCE.read_bytes())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load_library(src)


def test_library_path_is_keyed_on_source(tmp_path):
    a = tmp_path / "k.cu"
    a.write_text("// one")
    first = kernels.library_path(a)
    a.write_text("// two")
    assert kernels.library_path(a) != first
    assert first.parent == kernels.BUILD_DIR


LONG_RUNS.update({f"{os.path.basename(__file__)}::{test}": [
    ("kernels", _reference_tallies, ())] for test in (
        "test_kth_largest_matches_jnp",
        "test_wide_kth_largest_matches_the_reference",
        "test_kth_largest_matches_pallas_interpret")})
