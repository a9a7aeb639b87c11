"""The port's server device engine (``copycat_tpu_torch/manager/
device_executor.py``: ``DeviceEngine``, ``DeviceWindow``, ``DeviceJob``)
against the reference's, script for script.

Each script runs on both engines from one shape. The port's engine steps
the reference's exact step (flow control off, ``convert.config_to_torch``)
with the reference's timer draws (``torch_reference.ReferenceDrawnGroups``),
so every result, every engine round count and every ``RaftGroups`` state
leaf must be equal after each script. The last case runs the reference's
own server stack on the port's engine.

One engine shape for the file (capacity 64, P=3, L=32, S=4, the value,
lock and election pools: the map, set, queue, multimap and topic pools
compiled out), so the reference compiles its programs once.

Each script's reference side depends on nothing of the port's: it runs
once, in a worker process started with the session's first port file
(``torch_reference.LONG_RUNS``), and what it returned and its engine's
warm-up and end come back to the case, which runs the port's side.
"""

import os
import random

import numpy as np
import pytest

pytest.importorskip("torch")

from copycat_tpu.manager import device_executor as ref_dx  # noqa: E402
from copycat_tpu.ops import apply as jap  # noqa: E402
from copycat_tpu_torch.manager import device_executor as dx  # noqa: E402
from copycat_tpu_torch.ops import apply as ap  # noqa: E402

from helpers import async_test  # noqa: E402
from torch_reference import (  # noqa: E402,F401
    LONG_RUNS,
    SUITE_AHEAD,
    ReferenceDrawnGroups,
    assert_same_state,
    release_jax_programs,
    state_leaves,
)

SHAPE = dict(capacity=64, num_peers=3, log_slots=32, submit_slots=4)
POOLS = dict(map_slots=0, set_slots=0, queue_slots=0, multimap_slots=0,
             topic_slots=0)


def _reference_engine():
    """The reference's engine, warmed up (leaders elected)."""
    ref = ref_dx.DeviceEngine(ref_dx.DeviceEngineConfig(
        **SHAPE, resource=jap.ResourceConfig(**POOLS)))
    ref._ensure()
    return ref


def _port_engine(jcfg, warm):
    """The port's engine warmed up on the draws of the reference's, whose
    ``RaftGroups`` config is ``jcfg``: its state must equal the reference
    engine's after its warm-up (``warm``, its :func:`_view`)."""
    port = dx.DeviceEngine(dx.DeviceEngineConfig(
        **SHAPE, resource=ap.ResourceConfig(**POOLS), device="cpu"))
    port._groups = ReferenceDrawnGroups(
        SHAPE["capacity"], SHAPE["num_peers"], SHAPE["log_slots"],
        SHAPE["submit_slots"], jcfg, seed=port.config.seed)
    port._groups.wait_for_leaders(max_rounds=200)
    assert port._ensure() is port._groups
    _same(warm, port, "warm-up")
    return port


def _view(engine) -> tuple:
    """An engine's ``RaftGroups`` as the cases compare them: rounds, state
    leaves, results and events."""
    rg = engine._groups
    return rg.rounds, state_leaves(rg), dict(rg.results), dict(rg.events)


def _same(want, port, what):
    rounds, leaves, results, events = want
    assert port._groups.rounds == rounds, what
    assert_same_state(leaves, port._groups, what)
    assert port._groups.results == results, what
    assert port._groups.events == events, what


def _one_add(mod, engine, group, amount):
    def chain():
        return (yield ("cmd", ap.OP_LONG_ADD, amount, 0, 0))
    return mod.DeviceJob(engine, group, False, chain())


def _window_shares_rounds(mod, engine):
    r0 = engine._groups.rounds
    window = engine.begin_window()
    results = {}
    for g in range(32):
        window.add_job(_one_add(mod, engine, g, g + 1),
                       on_done=lambda res, exc, _g=g:
                       results.__setitem__(_g, res))
    window.close()
    rounds = engine._groups.rounds - r0
    assert results == {g: g + 1 for g in range(32)}
    assert rounds <= 8, f"window used {rounds} rounds for 32 one-op chains"
    return results, rounds


def _window_fifo(mod, engine):
    window = engine.begin_window()
    results = []
    for _ in range(5):
        window.add_job(_one_add(mod, engine, 0, 10),
                       on_done=lambda res, exc: results.append(res))
    window.close()
    assert results == [10, 20, 30, 40, 50]
    return results


def _window_add_order(mod, engine):
    window = engine.begin_window()
    done = []
    window.add_job(_one_add(mod, engine, 1, 1),
                   on_done=lambda res, exc: done.append("job"))
    window.add_ready(lambda res, exc: done.append("ready"))
    window.close()
    assert done == ["job", "ready"]
    return done


def _window_exception(mod, engine):
    def boom():
        yield ("cmd", ap.OP_LONG_ADD, 1, 0, 0)
        raise ValueError("chain failed")

    window = engine.begin_window()
    seen = {}
    window.add_job(mod.DeviceJob(engine, 2, False, boom()),
                   on_done=lambda res, exc: seen.update(res=res, exc=exc))
    window.close()
    assert isinstance(seen["exc"], ValueError)
    return seen["res"], str(seen["exc"])


def _vectors(mod, engine):
    """``run_vector`` over uneven per-group runs against the per-op
    ``command`` path, then ``run_query_vector`` against ``query``."""
    rng = np.random.default_rng(5)
    groups = rng.integers(8, 24, 40)
    amounts = rng.integers(-50, 50, 40)
    r0 = engine._groups.rounds
    vec = engine.run_vector(groups, np.full(40, ap.OP_LONG_ADD), amounts,
                            np.zeros(40, np.int64), np.zeros(40, np.int64))
    vec_rounds = engine._groups.rounds - r0
    per_op = [engine.command(int(g), ap.OP_LONG_ADD, int(a))
              for g, a in zip(groups[:3], amounts[:3])]
    sets = [engine.command(30 + i, ap.OP_VALUE_SET, 100 + i)
            for i in range(2)]
    read_groups = np.concatenate([groups, np.arange(30, 32)])
    qv = engine.run_query_vector(
        read_groups, np.full(read_groups.size, ap.OP_VALUE_GET),
        np.zeros(read_groups.size, np.int64),
        np.zeros(read_groups.size, np.int64),
        np.zeros(read_groups.size, np.int64))
    q1 = {g: engine.query(g, ap.OP_VALUE_GET)
          for g in sorted(set(read_groups.tolist()))}
    assert qv == [q1[g] for g in read_groups.tolist()]
    want = {g: 100 + g - 30 for g in (30, 31)}
    for g, a in zip(groups.tolist(), amounts.tolist()):
        want[g] = want.get(g, 0) + a
    for g, a in zip(groups[:3].tolist(), amounts[:3].tolist()):
        want[g] += a
    assert q1 == want
    return vec, vec_rounds, per_op, sets, qv


def _events(mod, engine):
    """A lock hand-off on group 40 and an election succession on group
    41: the grant and promotion events through ``take_events`` from
    ``event_cursor``."""
    g_lock, g_elect = 40, 41
    cursors = [engine.event_cursor(g_lock), engine.event_cursor(g_elect)]
    answers = [
        engine.command(g_lock, ap.OP_LOCK_ACQUIRE, 1, -1),
        engine.command(g_lock, ap.OP_LOCK_ACQUIRE, 2, -1),
        engine.command(g_lock, ap.OP_LOCK_RELEASE, 1),
        engine.query(g_lock, ap.OP_LOCK_HOLDER),
        engine.command(g_elect, ap.OP_ELECT_LISTEN, 11),
        engine.command(g_elect, ap.OP_ELECT_LISTEN, 22),
        engine.command(g_elect, ap.OP_ELECT_RESIGN, 11),
        engine.query(g_elect, ap.OP_ELECT_LEADER),
    ]
    lock_ev, c1 = engine.take_events(g_lock, cursors[0])
    elect_ev, c2 = engine.take_events(g_elect, cursors[1])
    assert [e[1:3] for e in lock_ev] == [(ap.EV_LOCK_GRANT, 2)]
    assert [e[1:3] for e in elect_ev][-1] == (ap.EV_ELECT, 22)
    assert answers[3] == 2 and answers[7] == 22
    assert engine.take_events(g_lock, c1) == ([], c1)
    assert c1 == engine.event_cursor(g_lock)
    return answers, lock_ev, elect_ev, c1, c2


def _allocator(mod, engine):
    """Allocate → release → allocate hands back the lowest freed group."""
    first = [engine.allocate() for _ in range(5)]
    assert first == [0, 1, 2, 3, 4]
    engine.release(3)
    engine.release(1)
    again = [engine.allocate() for _ in range(3)]
    assert again == [1, 3, 5]
    engine.command(again[0], ap.OP_LONG_ADD, 7)
    return first, again, engine._next_group, list(engine._free)


SCRIPTS = {
    "window_shares_rounds": _window_shares_rounds,
    "window_fifo_within_a_group": _window_fifo,
    "window_finalizes_in_add_order": _window_add_order,
    "window_exception_reaches_on_done": _window_exception,
    "vector_and_query_vector_against_per_op": _vectors,
    "events_and_cursors": _events,
    "allocate_release_allocate": _allocator,
}


def _reference_script(name: str) -> tuple:
    """The reference's side of one script: its ``RaftGroups`` config, its
    engine after the warm-up, what the script returned, and its engine
    after."""
    ref = _reference_engine()
    warm = _view(ref)
    want = SCRIPTS[name](ref_dx, ref)
    return ref._groups.config, warm, want, _view(ref)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_engine_script_matches_reference(name):
    """One script on both engines: equal results, equal round counts and
    equal ``RaftGroups`` leaves afterwards."""
    jcfg, warm, want, end = SUITE_AHEAD.get("device_engine",
                                            _reference_scripts)[name]
    port = _port_engine(jcfg, warm)
    got = SCRIPTS[name](dx, port)
    assert got == want, name
    _same(end, port, name)


def _reference_scripts() -> dict:
    """Every script's reference side, in one worker: they share the
    reference's compiled programs."""
    return {name: _reference_script(name) for name in SCRIPTS}


LONG_RUNS[f"{os.path.basename(__file__)}::"
          "test_engine_script_matches_reference"] = [
    ("device_engine", _reference_scripts, ())]


def test_engine_raises_for_a_mesh():
    eng = dx.DeviceEngine(dx.DeviceEngineConfig(capacity=4, mesh=object(),
                                                device="cpu"))
    with pytest.raises(NotImplementedError, match="item 6"):
        eng._ensure()
    with pytest.raises(NotImplementedError, match="item 6"):
        eng.restore_snapshot(b"", 0, [])


# -- the reference's server stack on the port's engine ----------------------


def _port_engine_for(ref_config):
    """What ``ResourceManager.device_engine`` builds in place of the
    reference's engine: the port's, on the CPU, at the same shape."""
    assert ref_config.resource is None and ref_config.mesh is None
    return dx.DeviceEngine(dx.DeviceEngineConfig(
        capacity=ref_config.capacity, num_peers=ref_config.num_peers,
        log_slots=ref_config.log_slots,
        submit_slots=ref_config.submit_slots, seed=ref_config.seed,
        telemetry=ref_config.telemetry, device="cpu"))


@async_test(timeout=180)
async def test_reference_server_stack_on_the_port_engine(monkeypatch):
    """The reference's ``test_executor_parity.py`` value-and-long script
    and its ``test_differential_map_sequences`` through the reference's
    ``AtomixServer(executor="tpu")`` with the port's engine injected: the
    same answers as the reference's CPU executor, every resource a
    device machine on the port's engine."""
    import test_executor_parity as parity
    from copycat_tpu.atomic import (DistributedAtomicLong,
                                    DistributedAtomicValue)
    from copycat_tpu.collections import DistributedMap

    monkeypatch.setattr(ref_dx, "DeviceEngine", _port_engine_for)

    rng = random.Random(1234)
    script = [(rng.choice(["put", "get", "remove", "pia", "rip", "size"]),
               rng.randrange(24), rng.randrange(100)) for _ in range(60)]

    async def run(executor):
        servers, (client,) = await parity._cluster(executor)
        try:
            value = await client.get("val", DistributedAtomicValue)
            out = [await value.get()]
            await value.set(41)
            out += [await value.get(), await value.compare_and_set(41, 42),
                    await value.compare_and_set(41, 43),
                    await value.get_and_set(7)]
            await value.set("a string")
            out += [await value.get(),
                    await value.compare_and_set("a string", 99),
                    await value.get()]
            counter = await client.get("ctr", DistributedAtomicLong)
            out += [await counter.increment_and_get(),
                    await counter.add_and_get(9),
                    await counter.get_and_add(5), await counter.get(),
                    await counter.decrement_and_get()]
            m = await client.get("diff", DistributedMap)
            for op, k, v in script:
                if op == "put":
                    out.append(await m.put(k, v))
                elif op == "get":
                    out.append(await m.get(k))
                elif op == "remove":
                    out.append(await m.remove(k))
                elif op == "pia":
                    out.append(await m.put_if_absent(k, v))
                elif op == "rip":
                    out.append(await m.remove_if_present(k, v))
                else:
                    out.append(await m.size())
            if executor == "tpu":
                for s in servers:
                    mgr = s.server.state_machine
                    assert isinstance(mgr.device_engine, dx.DeviceEngine)
                    kinds = sorted(type(h.state_machine).__name__
                                   for h in mgr.resources.values())
                    assert kinds == ["DeviceAtomicValueState"] * 2 + [
                        "DeviceMapState"], kinds
            return out
        finally:
            await parity._teardown([client] + servers)

    cpu = await run("cpu")
    tpu = await run("tpu")
    assert cpu[:13] == [None, 41, True, False, 42, "a string", True, 99,
                        1, 10, 10, 15, 14]
    assert cpu == tpu
