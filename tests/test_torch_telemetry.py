"""``models/telemetry.py`` of the torch port against the JAX reference.

Both packages' ``DeviceTelemetryHub``s are fed the same telemetry
sequences — the scripts of ``tests/test_device_telemetry.py`` (a healthy
run, a corrupted snapshot, a term regression and a split brain, strict
mode, the leaderless bound) and random blocks — and must agree on the
metric snapshot, the violation count, the flight ring (but for its wall
clock), the per-group totals and the shard snapshots. The environment
knobs turn telemetry on as the reference's do. Exact, integers only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401

from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.models import telemetry as jtel  # noqa: E402
from copycat_tpu.ops.consensus import DeviceTelemetry  # noqa: E402

from copycat_tpu_torch.models import RaftGroups  # noqa: E402
from copycat_tpu_torch.models import telemetry as ttel  # noqa: E402
from torch_reference import snapshot  # noqa: E402

G = 4
K = len(jtel.POOL_NAMES)


def _tel(commit=0, term=1, lane=0, leaderless=0, changes=0):
    z = np.zeros(G, np.int32)
    return DeviceTelemetry(
        elections_started=z, leader_changes=np.full(G, changes, np.int32),
        term_bumps=z, leaderless=np.full(G, leaderless, np.int32),
        commit_advance=z, commit_max=np.full(G, commit, np.int32),
        term_max=np.full(G, term, np.int32),
        leader_lane=np.full(G, lane, np.int32),
        leader_term=np.full(G, term, np.int32),
        applies=np.zeros((G, K), np.int32), ring_occ_max=z,
        submit_rejections=z, vote_splits=z, events_drained=z,
        events_dropped=z)


def _random(rng):
    return DeviceTelemetry(*(
        rng.integers(-1 if name in ("leader_lane", "leader_term") else 0,
                     4, (G, K) if name == "applies" else G).astype(np.int32)
        for name in DeviceTelemetry._fields))


SCRIPTS = {
    "healthy": [_tel(commit=c, term=1 + r // 2)
                for r, c in enumerate((1, 2, 2, 5))],
    "corrupted_snapshot": [_tel(commit=5), _tel(commit=3)],
    "term_regression_split_brain": [
        _tel(commit=1, term=5, lane=1, changes=1),
        _tel(commit=1, term=3, lane=1),
        _tel(commit=1, term=4, lane=2, changes=1),
        _tel(commit=1, term=5, lane=2)],
    "leaderless_bound": [_tel(leaderless=1), _tel(leaderless=0)],
    "random": [_random(np.random.default_rng(3)) for _ in range(12)],
}


def _flight(hub):
    return [{k: v for k, v in ev.items() if k != "t"}
            for ev in hub.flight.events()]


def _same_hubs(ref, port):
    assert snapshot(port.snapshot()) == snapshot(ref.snapshot())
    assert port.monitor.violations == ref.monitor.violations
    assert port.monitor.summary() == ref.monitor.summary()
    assert _flight(port) == _flight(ref)
    for name, want in ref.per_group_totals().items():
        np.testing.assert_array_equal(port.per_group_totals()[name], want)
    assert port.shard_snapshots(2) == ref.shard_snapshots(2)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_hubs_agree(script):
    hubs = []
    for mod in (jtel, ttel):
        hub = mod.DeviceTelemetryHub(G, mode="observe")
        if script == "leaderless_bound":
            hub.monitor.leaderless_max = 0.5
        for r, tel in enumerate(SCRIPTS[script]):
            hub.ingest(tel, r)
        hubs.append(hub)
    _same_hubs(*hubs)
    if script in ("corrupted_snapshot", "term_regression_split_brain",
                  "leaderless_bound"):
        assert hubs[1].monitor.violations > 0


def test_stacked_ingest_and_strict_mode():
    """``ingest_stacked`` folds ``[W, G]`` blocks in round order, and a
    strict monitor raises on the same block in both packages."""
    seq = SCRIPTS["random"]
    stacked = DeviceTelemetry(*(np.stack(x) for x in zip(*seq)))
    hubs = [mod.DeviceTelemetryHub(G, mode="observe") for mod in (jtel, ttel)]
    for hub in hubs:
        hub.ingest_stacked(stacked, 7)
    _same_hubs(*hubs)
    for mod in (jtel, ttel):
        hub = mod.DeviceTelemetryHub(G, mode="strict")
        hub.ingest(_tel(commit=5), 0)
        with pytest.raises(mod.InvariantViolation, match="commit"):
            hub.ingest(_tel(commit=3), 1)


@pytest.mark.parametrize("env", [("COPYCAT_TELEMETRY", "1"),
                                 ("COPYCAT_INVARIANTS", "strict"),
                                 ("COPYCAT_INVARIANTS", "off")])
def test_env_knobs_turn_telemetry_on(monkeypatch, env):
    monkeypatch.setenv(*env)
    ref = JaxRaftGroups(2, 3, log_slots=16)
    port = RaftGroups(2, 3, log_slots=16, device="cpu")
    assert port.config.telemetry == ref.config.telemetry
    assert (port.telemetry is None) == (ref.telemetry is None)
    if port.telemetry is not None:
        assert port.telemetry.monitor.mode == ref.telemetry.monitor.mode
    assert port.device_snapshot().keys() == ref.device_snapshot().keys()
