"""Package rules of ``copycat_tpu_torch`` and ``chip_smoke.py``.

- No file imports ``jax``, ``jaxlib`` or ``copycat_tpu`` (an AST scan).
- Entry points run on CUDA unless the caller asks for the CPU: without a
  card they raise, and ``chip_smoke.py`` exits non-zero with no result.
- The CUDA path never falls back to the plain version; on a card the
  kernel equals the plain version (``cuda``-marked; this file imports no
  JAX, so it runs where the card is).
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from copycat_tpu_torch import bench, device  # noqa: E402
from copycat_tpu_torch.models import RaftGroups  # noqa: E402
from copycat_tpu_torch.ops import kernels  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "copycat_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "copycat_tpu")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom copycat_tpu.ops import apply\n"
                 "from . import sibling\n")
    assert _imported_roots(f) & set(FORBIDDEN) == {"jax", "copycat_tpu"}


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RaftGroups(4, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_throughput(groups=4, rounds=1, repeats=1)
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert RaftGroups(4, 3, device="cpu").state.term.device.type == "cpu"


def test_bench_runs_on_the_cpu_when_asked():
    out = bench.run_throughput(groups=8, log_slots=16, submit_slots=4,
                               rounds=4, repeats=1, device="cpu")
    assert out["device"] == "cpu"
    assert out["value"] > 0
    assert out["launches_per_round"] == {
        "kth_largest": 0, "admit_submits": 0, "ack_commit": 0}
    assert out["p50_commit_latency_rounds"] >= 1


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Run from a directory holding ``chip_smoke.py`` alone (it finds no
    card here, and would find no package there): non-zero exit, no
    result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            assert "ok" not in json.loads(line)
        except json.JSONDecodeError:
            pass


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P", [3, 5, 7])
def test_cuda_kernel_matches_plain(cuda_device, P):
    rng = np.random.default_rng(P)
    x = rng.integers(-1000, 1000, (10_001, P)).astype(np.int32)
    x[rng.random(10_001) < 0.2] = x[0]                  # duplicate rows
    x[rng.random((10_001, P)) < 0.1] = np.iinfo(np.int32).min
    xc = torch.from_numpy(x).to(cuda_device)
    before = kernels.kth_largest.launches
    for k in sorted({1, P // 2 + 1, P}):
        got = kernels.kth_largest(xc, k).cpu().numpy()
        np.testing.assert_array_equal(
            got, kernels.kth_largest_plain(torch.from_numpy(x), k).numpy())
    assert kernels.kth_largest.launches > before
