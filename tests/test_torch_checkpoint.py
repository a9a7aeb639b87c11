"""``models/checkpoint.py`` of the torch port against the JAX reference.

The single-device cases of ``tests/test_checkpoint.py`` (the round trip,
event dedup across a restore, blobs without newer leaves in both the
path-keyed and the legacy positional format) and
``tests/test_monotone_deep.py::test_checkpoint_restore_rebuilds_stream_cursor``
(its cursor rebuilt by each package's own ``load`` from one blob) run on
both packages from one seed, with the same timer draws
(``ReferenceDrawnGroups``; a restored port engine draws on from the
reference's key). Blobs cross both ways: the port's blob loads in the
reference and the reference's in the port, every leaf equal after the
load and after N more rounds with the same draws. Exact, integers only.
The meshed case waits for the port's multi-device slice.

The reference's engine of this file compiles its programs in a worker
process started with the session's first port file
(``torch_reference.LONG_RUNS``), into the session's compile cache, so the
cases load them.
"""

import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import release_jax_programs  # noqa: E402,F401

from copycat_tpu.models import RaftGroups as JaxRaftGroups  # noqa: E402
from copycat_tpu.models import checkpoint as jcheckpoint  # noqa: E402
from copycat_tpu.models.device_resources import DeviceLock as JLock  # noqa: E402,E501
from copycat_tpu.ops import apply as ap  # noqa: E402
from copycat_tpu.ops.apply import ResourceConfig  # noqa: E402
from copycat_tpu.ops.consensus import Config  # noqa: E402

from copycat_tpu_torch import convert  # noqa: E402
from copycat_tpu_torch.models import checkpoint as tcheckpoint  # noqa: E402
from copycat_tpu_torch.models import BulkDriver  # noqa: E402
from copycat_tpu_torch.models.device_resources import DeviceLock as TLock  # noqa: E402,E501
from torch_reference import (  # noqa: E402
    DEEP_SHAPE,
    LONG_RUNS,
    ReferenceDrawnGroups,
    as_reference_drawn,
    assert_same_state,
    deep_config,
)

G, P, L, S = 2, 3, 32, 4
JCFG = Config(resource=ResourceConfig(
    map_slots=4, set_slots=0, queue_slots=0, wait_slots=4, listener_slots=0,
    event_slots=8, multimap_slots=4, topic_slots=0))


def pair(seed=0):
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S, seed=seed,
                        config=JCFG)
    port = ReferenceDrawnGroups(G, P, L, S, JCFG, seed=seed)
    for rg in (ref, port):
        rg.wait_for_leaders()
    return ref, port


def both(engines, fn):
    """``fn`` on each engine; the results must be equal."""
    out = [fn(rg) for rg in engines]
    assert out[1] == out[0]
    return out[0]


def run_ops(rg, ops, group=0):
    tags = [rg.submit(group, *op) for op in ops]
    rg.run_until(tags)
    return [rg.results[t] for t in tags]


def host_fields(rg):
    return (rg.rounds, rg.clock, rg._next_tag, rg._ev_seen, rg.events)


def restored_pair(ref_blob, port_blob):
    """Each package's engine restored from its own blob, drawing on from
    the reference's restored key."""
    ref = jcheckpoint.load_bytes(ref_blob)
    port = as_reference_drawn(tcheckpoint.load_bytes(port_blob, "cpu"),
                              ref._key)
    return ref, port


def warm_reference() -> None:
    """The reference's side of the first case up to the save, then a
    restore stepped on: every program of the file's reference engine,
    compiled into the session's compile cache."""
    ref = JaxRaftGroups(G, P, log_slots=L, submit_slots=S, seed=0,
                        config=JCFG)
    ref.wait_for_leaders()
    tags = [ref.submit(0, ap.OP_LONG_ADD, 2) for _ in range(5)]
    tags += [ref.submit(1, ap.OP_MAP_PUT, 7, 70)]
    tags += [ref.submit(1, ap.OP_LOCK_ACQUIRE, 4, -1)]
    ref.run_until(tags)
    ref.run(5)
    again = jcheckpoint.load_bytes(jcheckpoint.save_bytes(ref))
    run_ops(again, [(ap.OP_LONG_ADD, 2)])
    run_ops(again, [(ap.OP_MAP_GET, 7), (ap.OP_LOCK_HOLDER,)], group=1)


LONG_RUNS[f"{os.path.basename(__file__)}::test_save_load_roundtrip"] = [
    ("checkpoint", warm_reference, ())]


def test_save_load_roundtrip(tmp_path):
    ref, port = pair()
    for rg in (ref, port):
        tags = [rg.submit(0, ap.OP_LONG_ADD, 2) for _ in range(5)]
        tags += [rg.submit(1, ap.OP_MAP_PUT, 7, 70)]
        tags += [rg.submit(1, ap.OP_LOCK_ACQUIRE, 4, -1)]
        rg.run_until(tags)
        rg.run(5)
    assert_same_state(ref, port, "before the save")
    jcheckpoint.save(ref, tmp_path / "ref.npz")
    tcheckpoint.save(port, tmp_path / "port.npz")
    ref2 = jcheckpoint.load(tmp_path / "ref.npz")
    port2 = as_reference_drawn(
        tcheckpoint.load(tmp_path / "port.npz", device="cpu"), ref2._key)
    assert host_fields(port2) == host_fields(ref2) == host_fields(port)
    assert_same_state(port, port2, "port restored")
    assert_same_state(ref2, port2, "both restored")
    out = both((ref2, port2), lambda rg: run_ops(rg, [
        (ap.OP_LONG_ADD, 2)]) + run_ops(rg, [(ap.OP_MAP_GET, 7),
                                             (ap.OP_LOCK_HOLDER,)], group=1))
    assert out == [12, 70, 4]
    assert_same_state(ref2, port2, "stepped on")


def test_restore_preserves_event_dedup():
    ref, port = pair(1)
    blobs = []
    for rg, ckpt in ((ref, jcheckpoint), (port, tcheckpoint)):
        run_ops(rg, [(ap.OP_LOCK_ACQUIRE, 1, -1), (ap.OP_LOCK_ACQUIRE, 2, -1),
                     (ap.OP_LOCK_RELEASE, 1)])
        rg.run(5)
        blobs.append(ckpt.save_bytes(rg))
    grants = both((ref, port), lambda rg: [
        e for e in rg.events.get(0, []) if e[1] == ap.EV_LOCK_GRANT])
    assert len(grants) == 1
    ref2, port2 = restored_pair(*blobs)
    for rg in (ref2, port2):
        rg.run(10)
    # the buffered grant survives exactly once: kept in events, not
    # harvested again from the ring (seq dedup)
    assert both((ref2, port2), lambda rg: [
        e for e in rg.events.get(0, []) if e[1] == ap.EV_LOCK_GRANT]) \
        == grants
    # a facade made after the restore does not consume the old grant; the
    # holder register says who holds the lock
    out = [[Lock(rg, 0, holder_id=2)._next_grant()]
           + run_ops(rg, [(ap.OP_LOCK_HOLDER,)])
           for rg, Lock in ((ref2, JLock), (port2, TLock))]
    assert out[0] == out[1] == [False, 2]
    assert_same_state(ref2, port2, "after the facade")


def _old_blobs(blob: bytes) -> tuple[bytes, bytes]:
    """The blob without its newer leaves (multimap, topic, lease, member):
    once path-keyed, once in the legacy positional format."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        arrays = {k: data[k] for k in data.files if k != "meta"}
    newer = ("mm_", "tp_", "lease", "member")
    partial = {k: v for k, v in arrays.items()
               if not any(f in k for f in newer)}
    legacy = {k: v for k, v in arrays.items() if not k.startswith("state.")}
    names = [k for k in arrays if k.startswith("state.")
             and not any(f in k for f in newer)]
    for i, name in enumerate(names):
        legacy[f"leaf_{i}"] = arrays[name]
    out = []
    for blob_arrays, n in ((partial, meta["num_leaves"]),
                           (legacy, len(names))):
        bio = io.BytesIO()
        np.savez_compressed(bio, meta=json.dumps({**meta, "num_leaves": n}),
                            **blob_arrays)
        out.append(bio.getvalue())
    return tuple(out)


@pytest.mark.parametrize("form", ["path-keyed", "positional"])
def test_load_snapshot_missing_newer_pool_leaves(form):
    """Blobs from before newer pools existed restore with fresh values for
    the missing leaves, in both packages alike (built from the reference's
    blob, as its own test builds them)."""
    ref, port = pair(2)
    for rg in (ref, port):
        run_ops(rg, [(ap.OP_LONG_ADD, 7)])
        rg.run(5)
    old = _old_blobs(jcheckpoint.save_bytes(ref))[form == "positional"]
    ref2, port2 = jcheckpoint.load_bytes(old), tcheckpoint.load_bytes(
        old, "cpu")
    as_reference_drawn(port2, ref2._key)
    assert_same_state(ref2, port2, "restored")
    out = both((ref2, port2), lambda rg: [rg.value(0)] + run_ops(
        rg, [(ap.OP_MM_PUT, 1, 2)]))
    assert out == [7, 1]
    assert_same_state(ref2, port2, "stepped on")


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_blobs_cross_between_packages(direction):
    """A blob saved by one package loads in the other with every leaf and
    host field equal, and the two engines then step 12 more rounds alike
    under partitions (with the same draws)."""
    ref, port = pair(3)
    for rg in (ref, port):
        run_ops(rg, [(ap.OP_LONG_ADD, 3), (ap.OP_LOCK_ACQUIRE, 9, -1),
                     (ap.OP_MM_PUT, 4, 5)])
        rg.run(3)
    if direction == "port-to-reference":
        src, blob = port, tcheckpoint.save_bytes(port)
        loaded = jcheckpoint.load_bytes(blob)
        loaded._key = ref._key          # its draws go on from the source's
        other = as_reference_drawn(tcheckpoint.load_bytes(blob, "cpu"),
                                   ref._key)
        meta = json.loads(str(np.load(io.BytesIO(blob))["meta"]))
        assert meta["key"] == [0, 3]    # PRNGKey(3)
        ref2, port2 = loaded, other
    else:
        src, blob = ref, jcheckpoint.save_bytes(ref)
        loaded = tcheckpoint.load_bytes(blob, "cpu")
        assert not loaded.config.ring_flow_control   # the reference's step
        assert loaded.key == tuple(int(k) for k in np.asarray(ref._key))
        port2 = as_reference_drawn(loaded, ref._key)
        ref2 = jcheckpoint.load_bytes(blob)
    assert host_fields(port2) == host_fields(ref2) == host_fields(src)
    assert_same_state(src, port2, "loaded")
    assert_same_state(ref2, port2, "loaded")
    rng = np.random.default_rng(3)
    for r in range(12):
        mask = rng.random((G, P, P)) > 0.3 if r < 6 else np.ones(
            (G, P, P), bool)
        ref2.deliver = jax.numpy.asarray(mask)
        port2.deliver = torch.from_numpy(mask)
        for rg in (ref2, port2):
            rg.submit(r % G, ap.OP_LONG_ADD, 1)
            rg.step_round()
        assert_same_state(ref2, port2, f"round {r}")
    assert ref2.results == port2.results


def test_generator_state_continues_bit_for_bit():
    """A port engine restored from its own blob on the same device type
    takes its generator back: its own draws go on as the original's."""
    from copycat_tpu_torch.models import RaftGroups
    from copycat_tpu_torch.ops.consensus import Config as TConfig
    cfg = convert.config_to_torch(JCFG)._replace(ring_flow_control=True)
    rg = RaftGroups(G, P, log_slots=L, submit_slots=S, config=cfg, seed=4,
                    device="cpu")
    rg.wait_for_leaders()
    rg.submit(0, ap.OP_LONG_ADD, 5)
    rg.run(2)
    twin = tcheckpoint.load_bytes(tcheckpoint.save_bytes(rg), "cpu")
    assert isinstance(twin.config, TConfig) and twin.config == cfg
    tags = []
    for r in range(10):
        tags.append([e.submit(1, ap.OP_LONG_ADD, r) for e in (rg, twin)])
        for e in (rg, twin):
            e.step_round()
        assert_same_state(rg, twin, f"round {r}")
    assert [rg.results.get(a) for a, _ in tags] \
        == [twin.results.get(b) for _, b in tags]
    assert rg.key == twin.key == (0, 4)


def test_checkpoint_restore_rebuilds_stream_cursor():
    """A restored monotone engine rebuilds its stream cursor from the
    ring, so the next drive's tags follow the consumed ones: the port's
    blob restores in both packages to the same cursor and state, and the
    port restored from either package's blob drives on exactly once."""
    s = DEEP_SHAPE
    port = ReferenceDrawnGroups(s["groups"], s["peers"], s["log_slots"],
                                s["submit_slots"], deep_config(), seed=61)
    port.wait_for_leaders()
    g = np.repeat(np.arange(port.num_groups), 3)
    BulkDriver(port).drive(g, ap.OP_LONG_ADD, 1)
    blob = tcheckpoint.save_bytes(port)
    ref = jcheckpoint.load_bytes(blob)
    assert_same_state(ref, port, "the port's blob in the reference")
    assert (np.asarray(ref._stream_count) == 3).all(), ref._stream_count
    for blob in (jcheckpoint.save_bytes(ref), blob):
        restored = tcheckpoint.load_bytes(blob, "cpu")
        np.testing.assert_array_equal(restored._stream_count,
                                      np.asarray(ref._stream_count))
        res = BulkDriver(restored).drive(g, ap.OP_LONG_ADD, 1)
        assert (res.results.reshape(-1, 3) == 3 + np.arange(1, 4)).all()


def test_load_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """Like every entry point, ``load`` runs on ``cuda`` unless the caller
    names another device, and raises without a card."""
    from copycat_tpu_torch.models import RaftGroups
    from copycat_tpu_torch.ops import apply as tap
    from copycat_tpu_torch.ops.consensus import Config as TConfig
    rg = RaftGroups(2, 3, log_slots=8, device="cpu", config=TConfig(
        resource=tap.ResourceConfig.counters_only()))
    blob = tcheckpoint.save_bytes(rg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcheckpoint.load_bytes(blob)
    assert tcheckpoint.load_bytes(blob, "cpu").device.type == "cpu"
