"""The quorum-tally functions of ``copycat_tpu_torch/ops/kernels.py``
against the JAX reference (``copycat_tpu/ops/pallas_kernels.py``).

On the CPU the wrapper runs the plain version; it is held against the
jnp selection and against the Pallas kernel in interpret mode, exactly
(int32). The CUDA kernel itself is held against the plain version by the
``cuda``-marked test in ``test_torch_package.py`` (which imports no JAX,
so it runs on a card's machine) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401
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


@pytest.mark.parametrize("P,k", [(3, 2), (5, 3), (7, 4), (4, 1), (3, 3)])
def test_kth_largest_matches_jnp(P, k):
    rng = np.random.default_rng(P * 10 + k)
    x = _with_edges(rng.integers(-100, 100, (257, P)).astype(np.int32), rng)
    want = np.asarray(jkth(jnp.asarray(x), k))
    got = kernels.kth_largest(torch.from_numpy(x), k).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x, axis=1)[:, ::-1][:, k - 1])


@pytest.mark.parametrize("G", [64, 512, 1000])
def test_kth_largest_matches_pallas_interpret(G):
    rng = np.random.default_rng(G)
    x = _with_edges(rng.integers(0, 1 << 20, (G, 3)).astype(np.int32), rng)
    want = np.asarray(kth_largest_pallas(jnp.asarray(x), 2, block=256,
                                         interpret=True))
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
