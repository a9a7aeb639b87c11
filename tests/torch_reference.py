"""Helpers for the tests that hold ``copycat_tpu_torch`` against the JAX
reference: a port engine that draws its election timers as the
reference's ``RaftGroups`` does, leaf-by-leaf state comparison, and the
fixture that releases the reference's compiled programs after each test
file.

Every XLA CPU executable a process loads holds its own memory mappings
(about 18 each), and one pytest process running the whole suite loads
thousands: past the kernel's ``vm.max_map_count`` (65,530 here) the next
executable the process loads — compiled, or read back from the
persistent compilation cache — fails to map and the process dies with a
segmentation fault. :func:`release_jax_programs` keeps the port's tests
from adding to that count; every ``test_torch_*`` file that runs the JAX
reference imports it.
"""

import gc
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from copycat_tpu_torch import convert
from copycat_tpu_torch.models import RaftGroups


@pytest.fixture(scope="module", autouse=True)
def release_jax_programs(request):
    """At the end of the test file: drop every compiled JAX program, so
    their executables and memory mappings are released (later files
    compile again, or read the persistent cache). At its start: the
    session's long reference runs (:data:`LONG_RUNS`), once."""
    start_long_runs(request.session)
    yield
    jax.clear_caches()
    gc.collect()


class Ahead:
    """Reference computations started ahead, in background workers.

    Most of a differential test's time on the CPU is the reference
    compiling its programs. A test file whose reference side never
    depends on the port's (the same seeded inputs go to both) starts
    those computations here (:meth:`start`, from a module fixture or
    :func:`start_long_runs`, never while the module is imported): in
    threads (XLA compiles with the GIL released, and a thread shares the
    process's compiled programs) or, with ``processes``, in worker
    processes (no GIL shared at all; the results come back pickled). A
    test takes its result with :meth:`get`, which waits for it, or
    computes it in the test's own thread when it was never started or
    its worker could not run it. :meth:`close` waits for every
    computation."""

    def __init__(self, workers: int | None = None, processes: bool = False):
        self._workers = workers or max(1, min(4, os.cpu_count() or 1))
        self._processes = processes
        self._pool = None
        self._futures = {}

    def start(self, key, fn, *args) -> None:
        if key in self._futures:
            return
        try:
            if self._pool is None:
                self._pool = (ProcessPoolExecutor(
                    self._workers, mp_context=multiprocessing.get_context(
                        "spawn")) if self._processes
                    else ThreadPoolExecutor(self._workers,
                                            thread_name_prefix="ahead"))
            self._futures[key] = self._pool.submit(fn, *args)
        except (OSError, RuntimeError):   # no workers here: get computes
            pass

    def get(self, key, fn, *args):
        future = self._futures.get(key)
        if future is not None:
            try:
                return future.result()
            except Exception:   # noqa: BLE001 — recomputed (and raised) here
                pass
        return fn(*args)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        self._pool, self._futures = None, {}


def warm_reference(groups, peers, log_slots, submit_slots, config, seed=0,
                   fused=()):
    """Compile the reference's programs for one engine shape and config
    (the reference shares them between every ``RaftGroups`` of a config),
    by running a throwaway engine: its step (the leader election), its
    query program (one value read: every config has the value pool) and the
    fused ``step_rounds(n)`` program for each ``n`` of ``fused``. Meant
    for :class:`Ahead`: a file's engines then find the programs built."""
    from copycat_tpu.models import RaftGroups as JaxRaftGroups
    from copycat_tpu.ops.apply import OP_VALUE_GET
    rg = JaxRaftGroups(groups, peers, log_slots=log_slots,
                       submit_slots=submit_slots, seed=seed, config=config)
    rg.wait_for_leaders()
    rg.serve_query(0, OP_VALUE_GET)
    for n in fused:
        rg.step_rounds(n)


def warm_reference_engine(engine_config):
    """:func:`warm_reference` for the reference server's device engine: the
    engine's own warm-up (its step) and one vector read (its query
    program)."""
    from copycat_tpu.manager.device_executor import DeviceEngine
    from copycat_tpu.ops.apply import OP_VALUE_GET
    engine = DeviceEngine(engine_config)
    engine._ensure()
    engine.run_query_vector([0], [OP_VALUE_GET], [0], [0], [0])


#: Reference runs that compile for seconds each, by the test function that
#: takes them (``"file.py::test_name"``): ``[(key, function, args)]``,
#: registered when the file is imported (the function must be a module
#: attribute: a worker process imports it). When the session holds the
#: test, the first port test file that runs the reference starts them in
#: :data:`SUITE_AHEAD`'s worker processes, so they are done by the time
#: the test comes, without taking the GIL from the tests meanwhile; it
#: takes each result with ``SUITE_AHEAD.get``.
LONG_RUNS: dict = {}
SUITE_AHEAD = Ahead(workers=2, processes=True)


def start_long_runs(session) -> None:
    tests = {f"{item.path.name}::{getattr(item, 'originalname', item.name)}"
             for item in session.items}
    for test, runs in LONG_RUNS.items():
        if test in tests:
            for key, fn, args in runs:
                SUITE_AHEAD.start(key, fn, *args)


class ReferenceDrawnGroups(RaftGroups):
    """The port's ``RaftGroups`` on the CPU, stepping the reference's
    exact step (``convert.config_to_torch``) with the timer draws the
    reference's ``RaftGroups`` makes from the same seed: per round, one
    split of the engine key, then ``key_t, key_c`` inside the step; for
    ``step_rounds(n)``, one split and ``n`` keys (``_fused_rounds_program``).
    """

    def __init__(self, groups, peers, log_slots, submit_slots, jcfg,
                 seed=0, voters=None):
        super().__init__(groups, peers, log_slots=log_slots,
                         submit_slots=submit_slots,
                         config=convert.config_to_torch(jcfg), seed=seed,
                         device="cpu", voters=voters)
        self._key, init_key = jax.random.split(jax.random.PRNGKey(seed))
        self.state = self.state._replace(timer=self._randint(init_key))

    def _randint(self, key):
        cfg = self.config
        return torch.tensor(np.asarray(jax.random.randint(
            key, (self.num_groups, self.num_peers), cfg.timer_min,
            cfg.timer_max)))

    def _step_draws(self, key):
        key_t, key_c = jax.random.split(key)
        return self._randint(key_t), self._randint(key_c)

    def _draw_timers(self):
        self._key, key = jax.random.split(self._key)
        return self._step_draws(key)

    def _draw_rounds(self, n):
        self._key, key = jax.random.split(self._key)
        return [self._step_draws(k) for k in jax.random.split(key, n)]


def as_reference_drawn(rg, key):
    """A port engine restored from a checkpoint (a plain ``RaftGroups``)
    turned into a :class:`ReferenceDrawnGroups` whose next draws come from
    the reference key ``key``, so it steps on with the reference's draws."""
    rg.__class__ = ReferenceDrawnGroups
    rg._key = jax.numpy.asarray(np.asarray(key, np.uint32))
    return rg


def assert_same_state(ref, port, what):
    """Every state leaf of two engines equal, value and dtype."""
    want = convert.flat_leaves(ref.state)
    got = convert.flat_leaves(port.state)
    assert want.keys() == got.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype, (name, what)
        np.testing.assert_array_equal(got[name], w,
                                      err_msg=f"{name} at {what}")


def assert_same_leaves(ref, port, what):
    """Every leaf of two NamedTuples (either package's) equal."""
    want, got = convert.flat_leaves(ref), convert.flat_leaves(port)
    assert want.keys() == got.keys(), what
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None, (what, name)
            continue
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")


def isolate(G, P, lanes):
    """Full delivery except ``lanes``, cut from every other lane."""
    dl = np.ones((G, P, P), bool)
    for lane in lanes:
        dl[:, lane, :] = False
        dl[:, :, lane] = False
    return dl


# The deep bulk plane's differential tests share one reference config and
# one shape, so the reference's compiled programs are shared between them:
# the bulk plane's tag gate and telemetry on, and the pools the session
# scenarios use (value, lock, election, events).
DEEP_SHAPE = dict(groups=8, peers=3, log_slots=16, submit_slots=4)


def deep_config(**overrides):
    from copycat_tpu.ops.apply import ResourceConfig
    from copycat_tpu.ops.consensus import Config
    return Config(monotone_tag_accept=True, telemetry=True,
                  resource=ResourceConfig(map_slots=0, set_slots=0,
                                          queue_slots=0, multimap_slots=0,
                                          topic_slots=0))._replace(
                                              **overrides)


def engine_pair(seed, jcfg=None, leaders=True):
    """The reference's ``RaftGroups`` and the port's, drawing the same
    timers, at ``DEEP_SHAPE`` — with every group's leader elected."""
    from copycat_tpu.models import RaftGroups as JaxRaftGroups
    jcfg = jcfg or deep_config()
    s = DEEP_SHAPE
    ref = JaxRaftGroups(s["groups"], s["peers"], log_slots=s["log_slots"],
                        submit_slots=s["submit_slots"], seed=seed,
                        config=jcfg)
    port = ReferenceDrawnGroups(s["groups"], s["peers"], s["log_slots"],
                                s["submit_slots"], jcfg, seed=seed)
    ref._stage_submits = _full_payload(ref)
    if jcfg.monotone_tag_accept:
        ref._deep_fn = _wide_accumulators(ref._deep_fn())
    if leaders:
        ref.wait_for_leaders()
        port.wait_for_leaders()
        assert_same_state(ref, port, "leaders elected")
    return ref, port


def _full_payload(rg):
    """A ``_stage_submits`` for the reference's engine that hands every
    payload leaf over as a full ``[G, S]`` array: the same values as the
    bulk plane's scalar leaves, and one compiled signature of the
    reference's deep program for every drive."""
    shape = (rg.num_groups, rg.submit_slots)

    def stage(sub):
        return sub._replace(**{k: np.broadcast_to(
            np.asarray(getattr(sub, k), np.int32), shape)
            for k in ("opcode", "a", "b", "c")})
    return stage


def _wide_accumulators(prog, width=16):
    """The reference's deep program run on accumulators padded to
    ``width`` columns and cut back: no report lands in a padded column (a
    drive's reports have ranks below its own width), so every value is
    the same, and drives of up to ``width`` ops a group share one compiled
    program."""
    import jax.numpy as jnp

    def call(state, resbuf, valbuf, rndbuf, evflag, *rest):
        B = resbuf.shape[1]
        if B >= width:
            return prog(state, resbuf, valbuf, rndbuf, evflag, *rest)
        pad = ((0, 0), (0, width - B))
        state, r, v, n, e, out = prog(
            state, jnp.pad(resbuf, pad), jnp.pad(valbuf, pad),
            jnp.pad(rndbuf, pad, constant_values=2 ** 30), evflag, *rest)
        return state, r[:, :B], v[:, :B], n[:, :B], e, out
    return lambda: call


def counters(rg):
    """An engine's metric counters by flattened name."""
    return {k: v for k, v in rg.metrics.snapshot().items()
            if k != "uptime_s" and isinstance(v, int)}


def snapshot(x):
    """A metrics snapshot without its wall-clock ``uptime_s``."""
    return {k: v for k, v in x.items() if k != "uptime_s"}
