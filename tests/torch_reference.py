"""Helpers for the tests that hold ``copycat_tpu_torch`` against the JAX
reference: a port engine that draws its election timers as the
reference's ``RaftGroups`` does, leaf-by-leaf state comparison, the
reference's side of a case run ahead in worker processes
(:data:`LONG_RUNS`, :data:`SUITE_AHEAD`) with a :class:`Transcript` of
what the port's side must then show, and the fixture that releases the
reference's compiled programs after each test file.

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
from concurrent.futures import Future, ProcessPoolExecutor

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
    session's long reference runs (:data:`LONG_RUNS`), once; their
    workers end after the file in which the last of them finished."""
    start_long_runs(request.session)
    yield
    jax.clear_caches()
    gc.collect()
    SUITE_AHEAD.release_workers()


@pytest.fixture(autouse=True)
def no_leaked_profiler():
    """After each test of a file that imports it: stop the process-wide
    profiler of either package that a host left running. A crashed server
    (SIGKILL semantics), or a server or supervisor built and never closed,
    keeps its refcounted sampler thread and its event-loop patch, and
    every later test of the session would pay for them."""
    yield
    from copycat_tpu.utils import profiler as ref_profiler
    from copycat_tpu_torch.utils import profiler
    for mod in (profiler, ref_profiler):
        with mod._ACQUIRE_LOCK:
            leaked, mod.PROFILER = mod.PROFILER, None
        if leaked is not None:
            leaked.stop()


class Ahead:
    """Reference computations started ahead, in worker processes.

    Most of a differential test's time on the CPU is the reference
    compiling its programs and stepping. A test file whose reference side
    never depends on the port's (the same seeded inputs go to both)
    registers it in :data:`LONG_RUNS`; :meth:`start` runs it in a spawned
    worker process (no GIL shared with the tests; the result comes back
    pickled), never while a module is imported. A test takes its result
    with :meth:`get`, which waits for it, or computes it in the test's own
    process (once) when it was never started or its worker could not run
    it."""

    def __init__(self, workers: int):
        self._workers = workers
        self._pool = None
        self._futures = {}

    def start(self, key, fn, *args) -> None:
        if key in self._futures:
            return
        try:
            if self._pool is None:
                self._pool = ProcessPoolExecutor(
                    self._workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_worker_init)
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
        value = fn(*args)
        self._futures[key] = done = Future()    # the next get takes it
        done.set_result(value)
        return value

    def release_workers(self) -> None:
        """Once every computation has finished, end the workers (their
        results stay), so no idle process outlives the work."""
        if self._pool is not None and all(
                f.done() for f in self._futures.values()):
            self._pool.shutdown(wait=False)
            self._pool = None


def as_numpy(tree):
    """``tree`` with every JAX array and tensor in it as a numpy array: a
    worker's result comes back so (unpickled, a JAX array is put on a
    device again, and a tensor crosses as a shared-memory descriptor)."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        return np.asarray(x) if isinstance(x, jax.Array) else x
    return jax.tree.map(leaf, tree)


def _worker_init():
    """A worker process runs below the tests' priority, and compiles into
    the session's persistent compile cache, as the tests' process does
    (``tests/conftest.py``), so that what a worker compiled, the tests
    load rather than compile."""
    os.nice(10)
    from copycat_tpu.utils.platform import enable_compilation_cache
    enable_compilation_cache()


#: Computations a test holds the port against that depend on nothing of
#: the port's run (the reference's side of a case, and the sequential
#: apply of ``test_torch_apply_window.py``), by the test function that
#: takes them (``"file.py::test_name"``): ``[(key, function, args)]``,
#: registered when the file is imported (the function must be a module
#: attribute: a worker process imports it). When the session holds the
#: test, the first port test file that runs the reference starts them in
#: :data:`SUITE_AHEAD`'s worker processes, so they are done by the time
#: the test comes, without taking the GIL from the tests meanwhile; it
#: takes each result with ``SUITE_AHEAD.get``.
LONG_RUNS: dict = {}
SUITE_AHEAD = Ahead(workers=4)


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


def state_leaves(rg) -> dict:
    """An engine's state as numpy leaves by name (what crosses from a
    worker process: :func:`assert_same_state` takes it for ``ref``)."""
    return convert.flat_leaves(rg.state)


def assert_same_state(ref, port, what):
    """Every state leaf of two engines equal, value and dtype; ``ref`` may
    be the reference engine's :func:`state_leaves`."""
    want = ref if isinstance(ref, dict) else state_leaves(ref)
    got = convert.flat_leaves(port.state)
    assert want.keys() == got.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype, (name, what)
        np.testing.assert_array_equal(got[name], w,
                                      err_msg=f"{name} at {what}")


def assert_same_value(want, got, what):
    """``got`` equal to ``want``: state leaves (a dict of arrays) leaf by
    leaf with their dtypes, anything else by ``==``."""
    if isinstance(want, dict) and any(
            isinstance(v, np.ndarray) for v in want.values()):
        assert_same_leaves(want, got, what)
    else:
        assert got == want, what


class Transcript:
    """What one engine showed at each check of a script, in order: the
    reference's run records it (in a worker process), and the port's run
    of the same script is held against it check by check (``replay``),
    so two engines in lockstep need not share a process."""

    def __init__(self, replay=None):
        self.values = [] if replay is None else list(replay)
        self._replay = replay is not None
        self._at = 0

    def __call__(self, got, what=""):
        if not self._replay:
            self.values.append(got)
            return got
        assert self._at < len(self.values), f"{what}: past the record"
        want = self.values[self._at]
        self._at += 1
        assert_same_value(want, got, f"{what} (check {self._at})")
        return got

    def given(self, value):
        """An input the reference's run chose (``value``, recorded) and the
        port's run takes as it was recorded, unchecked."""
        if not self._replay:
            self.values.append(value)
            return value
        self._at += 1
        return self.values[self._at - 1]

    def done(self):
        """Every recorded check was made."""
        assert self._at == len(self.values), (self._at, len(self.values))


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


def reference_engine(seed, jcfg=None, leaders=True):
    """The reference's ``RaftGroups`` at ``DEEP_SHAPE`` (one compiled
    deep program for every drive, :func:`_full_payload` and
    :func:`_wide_accumulators`), with every group's leader elected."""
    from copycat_tpu.models import RaftGroups as JaxRaftGroups
    jcfg = jcfg or deep_config()
    s = DEEP_SHAPE
    ref = JaxRaftGroups(s["groups"], s["peers"], log_slots=s["log_slots"],
                        submit_slots=s["submit_slots"], seed=seed,
                        config=jcfg)
    ref._stage_submits = _full_payload(ref)
    if jcfg.monotone_tag_accept:
        ref._deep_fn = _wide_accumulators(ref._deep_fn())
    if leaders:
        ref.wait_for_leaders()
    return ref


def port_engine(seed, jcfg=None, leaders=True):
    """The port's engine drawing the reference's timers, at
    ``DEEP_SHAPE``, with every group's leader elected."""
    jcfg = jcfg or deep_config()
    s = DEEP_SHAPE
    port = ReferenceDrawnGroups(s["groups"], s["peers"], s["log_slots"],
                                s["submit_slots"], jcfg, seed=seed)
    if leaders:
        port.wait_for_leaders()
    return port


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
