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
from copycat_tpu_torch.utils import knobs  # noqa: E402

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


KNOBS_FILE = ROOT / "copycat_tpu_torch" / "utils" / "knobs.py"
_READER_TEXT = "\n".join(
    p.read_text() for p in (ROOT / "copycat_tpu_torch").rglob("*.py")
    if p != KNOBS_FILE)


@pytest.mark.parametrize("name", sorted(knobs.REGISTRY))
def test_every_declared_knob_has_a_reader(name):
    """The registry declares only knobs some port module reads: a knob
    named nowhere outside ``utils/knobs.py`` is one nothing needs."""
    assert f'"{name}"' in _READER_TEXT, f"{name} is declared but never read"


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


@pytest.mark.parametrize("scenario", ["map", "lock", "mixed"])
def test_bench_scenarios_run_on_the_cpu(scenario, monkeypatch):
    """Each pool scenario runs at a tiny G with its own pools and budgets;
    under the ``mixed`` nemesis stale followers get snapshots installed,
    and replicas at equal applied index agree."""
    stale_lanes = []
    real = bench.install_snapshots

    def counting(state, stale, leader, config):
        stale_lanes.append(int(stale.sum()))
        return real(state, stale, leader, config)

    monkeypatch.setattr(bench, "install_snapshots", counting)
    out = bench.run_throughput(scenario, groups=12,
                               peers=5 if scenario == "mixed" else 3,
                               rounds=40, repeats=1, device="cpu")
    assert out["value"] > 0 and out["p50_commit_latency_rounds"] >= 1
    assert out["diverged_lanes"] == 0
    assert out["launches_per_round"] == dict.fromkeys(bench.KERNELS, 0.0)
    assert out["shape"]["pool_budgets"] == bench.pool_budgets_for(scenario,
                                                                  16)
    assert out["shape"]["log_slots"] == (32 if scenario == "mixed" else 64)
    if scenario == "mixed":
        assert out["shape"]["timers"] == [2, 4] and out["shape"]["nemesis"]
        assert sum(stale_lanes) > 0, "the nemesis left no follower stale"
    else:
        assert stale_lanes == []


def test_nemesis_schedule_is_the_reference_one():
    """Period 20, the first half isolated, seed 1 — and the same victims
    every repetition."""
    v = bench.isolation_masks(45, 6, 5, 20, 1)
    rng = np.random.default_rng(1)
    for start in (0, 20, 40):
        want = rng.integers(0, 5, 6, dtype=np.int32)
        assert (v[start:start + 10] == want).all()
        assert (v[start + 10:start + 20] == -1).all()
    d = bench.victim_deliver(torch.tensor([1, -1]), 2, 3)
    assert d[1].all() and not d[0, 1].any() and not d[0, :, 1].any()
    assert d[0, 0, 2] and d[0, 2, 0]


def test_bench_cli_needs_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--scenario", "mixed", "--groups", "4", "--peers", "5",
                    "--rounds", "1", "--repeats", "1"])
    for scenario in ("election", "map_read"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["--scenario", scenario, "--groups", "4",
                        "--rounds", "1", "--repeats", "1"])
    for scenario in ("host", "host_read", "session"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["--scenario", scenario, "--groups", "4",
                        "--repeats", "1"])
    with pytest.raises(SystemExit):
        bench.main(["--scenario", "spi"])
    with pytest.raises(SystemExit):
        bench.main(["--scenario", "host", "--mode", "pipelined"])
    with pytest.raises(SystemExit):
        bench.main(["--scenario", "map_read", "--read-level", "causal"])


def test_new_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    _no_cuda(monkeypatch)
    from copycat_tpu_torch.ops.consensus import Config
    dyn = Config(dynamic_membership=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RaftGroups(4, 5, config=dyn, voters=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_election(groups=4, rounds=1, repeats=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_map_read("atomic", groups=4, rounds=1, repeats=1)
    rg = RaftGroups(4, 5, config=dyn, voters=3, device="cpu")
    assert rg.sessions.open_session().id >= 1 << 30
    # the server's device engine, built at server open (prewarm)
    from copycat_tpu_torch.io.local import LocalServerRegistry, LocalTransport
    from copycat_tpu_torch.io.transport import Address
    from copycat_tpu_torch.manager.atomix import AtomixServer
    from copycat_tpu_torch.manager.device_executor import (
        DeviceEngine, DeviceEngineConfig)
    addr = Address("local", 1)
    for config in (DeviceEngineConfig(capacity=4),
                   DeviceEngineConfig(capacity=4, device="cpu")):
        server = AtomixServer(addr, [addr],
                              LocalTransport(LocalServerRegistry()),
                              executor="tpu", engine_config=config)
        if config.device is None:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                server.server.state_machine.prewarm()
        else:
            server.server.state_machine.prewarm()
            engine = server.server.state_machine.device_engine
            assert engine._groups.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceEngine()._ensure()


@pytest.mark.parametrize("mode", ["deep", "deepscan", "bulk", "queued"])
def test_host_runs_on_the_cpu(mode):
    """The host scenario at a tiny G: every group's counter holds exactly
    the ops committed to it; telemetry on in the deep mode."""
    out = bench.run_host(mode, groups=6, burst=5, repeats=1, device="cpu",
                         telemetry=mode == "deep")
    assert out["device"] == "cpu" and out["mode"] == mode
    assert out["value"] > 0 and out["groups_not_exactly_once"] == 0
    assert out["launches_per_round"] == dict.fromkeys(bench.KERNELS, 0.0)
    assert out["rounds_per_drive"] >= 1
    if mode == "deep":
        tel = out["device_telemetry"]
        assert tel["device.commit_advance"] >= 6 * 5 * 2
        assert sum(v for k, v in tel.items()
                   if k.startswith("device.invariant_violations")) == 0
    else:
        assert "device_telemetry" not in out


@pytest.mark.parametrize("read_level", ["sequential", "atomic"])
def test_host_read_and_session_run_on_the_cpu(read_level):
    out = bench.run_host_read(read_level, groups=6, burst=5, repeats=1,
                              device="cpu")
    assert out["wrong_reads"] == 0 and out["value"] > 0
    assert out["reads_per_repetition"] == 30
    out = bench.run_session(3, groups=6, burst=5, repeats=1, device="cpu")
    assert out["group0_counter"] == out["group0_expected"] == 10
    assert out["value"] > 0


def test_deep_plane_config_branches_run(monkeypatch):
    """``Config(monotone_tag_accept=True)`` and ``Config(telemetry=True)``
    build and step an engine, and entry points still need the card."""
    from copycat_tpu_torch.ops.consensus import Config
    cfg = Config(monotone_tag_accept=True, telemetry=True)
    rg = RaftGroups(4, 3, log_slots=16, config=cfg, device="cpu")
    rg.wait_for_leaders()
    assert rg.device_snapshot()["device.rounds"] == rg.rounds
    assert rg.metrics.counter("rounds").value == rg.rounds
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RaftGroups(4, 3, config=cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_host("deep", groups=4, repeats=1)


@pytest.mark.parametrize("read_level", ["sequential", "atomic"])
def test_map_read_runs_on_the_cpu(read_level):
    out = bench.run_map_read(read_level, groups=6, rounds=12, repeats=1,
                             device="cpu")
    assert out["device"] == "cpu" and out["read_level"] == read_level
    assert out["served_reads"] > 0 and out["wrong_reads"] == 0
    assert out["value"] > 0
    assert out["launches_per_round"] == dict.fromkeys(bench.KERNELS, 0.0)


def test_election_runs_on_the_cpu_and_checks_safety(monkeypatch):
    out = bench.run_election(groups=12, rounds=45, repeats=1, device="cpu")
    assert out["value"] > 0 and out["two_leaders_in_a_term"] == 0
    assert out["shape"]["nemesis"] == {"period": 15, "seed": 2}
    # a step that makes two lanes of group 0 lead in one term is caught
    real = bench.step

    def two_leaders(state, *args):
        state, out = real(state, *args)
        role = state.role.clone()
        role[0, :2] = 2
        term = state.term.clone()
        term[0, 1] = term[0, 0]
        return state._replace(role=role, term=term), out

    monkeypatch.setattr(bench, "step", two_leaders)
    out = bench.run_election(groups=4, rounds=3, repeats=1, device="cpu")
    assert out["two_leaders_in_a_term"] > 0


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
@pytest.mark.parametrize("P", [3, 5, 7, 9, 16])
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
