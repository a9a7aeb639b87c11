"""Continuous host profiling plane (docs/OBSERVABILITY.md "Profiling").

The observability tiers before this module say *what* is slow — the
``latency.*`` phase histograms attribute a proxied write, the health
detectors grade commit stalls, ``/series`` shows when — but nothing
says *which code* held the event loop when it happened. This module is
the runtime complement to the copycheck loop-blocking rule (static
hazards) and the device-plane xprof helpers in ``utils/profiling.py``
(device time): a per-process **wall-stack sampler** plus **event-loop
hold attribution**, two pieces:

- **:class:`Profiler`** — ONE daemon thread per process folding
  ``sys._current_frames()`` stacks at ``COPYCAT_PROFILE_HZ`` (default
  ~19 Hz, deliberately off-cadence from the 1 Hz health/series timers)
  into a bounded, time-bucketed aggregate ring — the same ``?since=``
  retention model as ``utils/timeseries.py``. Stacks fold to the
  flamegraph.pl collapsed format (``thread;mod.func;...;leaf count``,
  root -> leaf), so ``/profile.txt`` pipes straight into flamegraph
  tooling. The sampler self-measures (``profile.overhead_ms``): the
  plane's cost is itself a series.
- **Hold attribution** — ``asyncio.events.Handle._run`` is patched
  while the profiler runs: every callback/task step is timed on the
  hot path with two ``perf_counter`` reads and nothing else; a step
  holding the loop at least ``COPYCAT_PROFILE_HOLD_MS`` records a
  *hold* carrying the owning frame — the sampler's most recent stack
  of the holding thread when one landed inside the hold (any 19 Hz
  sample during a 100 ms+ block does), else the callback/coroutine
  qualname. Holds feed the ``profile.hold_*`` gauges, a bounded hold
  ring (the ``loop_stall`` detector's evidence), and flight-recorder
  stall notes via each host's note callback.

The profiler is **process-wide and refcounted**: in-process test
clusters construct several servers per process, and per-server sampler
threads would multiply the cost for identical data. Every host
(member / ingress / supervisor) calls :func:`acquire` with its metric
registry — the first acquire starts the thread and installs the loop
patch, the last :func:`release` stops and uninstalls both. The
``profile.*`` family therefore reports *process* totals on every
co-resident host's registry — honest for a process-level property (the
GIL and the loop are shared), and exactly what the multi-process
deployment plane measures per process.

``COPYCAT_PROFILE=0`` removes all of it — no thread, no loop patch, no
``profile.*`` keys, no ``/profile`` routes, no ``loop_stall`` detector
— restoring the pre-profiler process bit-identically (the standing
``COPYCAT_*=0`` A/B discipline).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from collections import Counter, deque
from typing import Any, Callable, Iterable

from . import knobs

#: aggregate-ring bucket width (seconds): `?since=` resolution
_BUCKET_S = 1.0
#: frames folded per stack before truncation (runaway recursion guard)
_MAX_DEPTH = 64
#: holds retained for /profile + the loop_stall detector's evidence
_HOLD_RING = 128


def fold_stack(frame: Any, thread_name: str) -> str:
    """Fold one thread's leaf frame into the collapsed flamegraph.pl
    form ``thread;mod.func;mod.func;...;leaf`` (root -> leaf, thread
    name first — separators stripped from names so the one-line-per-
    stack format survives any input)."""
    parts: list[str] = []
    f = frame
    depth = 0
    while f is not None and depth < _MAX_DEPTH:
        code = f.f_code
        mod = os.path.splitext(os.path.basename(code.co_filename))[0]
        parts.append(f"{mod}.{code.co_name}")
        f = f.f_back
        depth += 1
    parts.append(thread_name.replace(";", "_").replace(" ", "_"))
    parts.reverse()
    return ";".join(parts)


def _describe_callback(handle: Any) -> str:
    """A handle's owning frame name for holds too short for any sample
    to land in: the stepped task's coroutine qualname, else the
    callback qualname."""
    cb = getattr(handle, "_callback", None)
    task = getattr(cb, "__self__", None)
    coro = getattr(task, "get_coro", None)
    if callable(coro):  # a Task.__step: name the coroutine, not __step
        try:
            return getattr(coro(), "__qualname__", None) \
                or task.get_name()
        except Exception:  # noqa: BLE001 - naming must never raise
            pass
    return getattr(cb, "__qualname__", None) or repr(cb)


class _HostView:
    """One host's registration: the ``profile.*`` gauges on its metric
    registry (refreshed by the sampler thread) + its stall-note
    callback (``RaftServer.health_note`` on members; the ingress and
    supervisor have no flight ring and pass ``None``).

    The view holds its host WEAKLY — the registry by ``weakref.ref``
    and a bound-method note callback by ``weakref.WeakMethod``. An
    orderly teardown goes through :func:`release`; a host that simply
    vanishes (SIGKILL-shaped test teardown never releases) must not be
    pinned alive by its view nor serviced by the sampler forever —
    ``refresh`` reports the registry dead and the sampler prunes the
    view. Plain functions (test callbacks) are kept strongly: only a
    bound method implies an owning host whose lifetime governs."""

    __slots__ = ("_reg", "_note", "_note_strong")

    def __init__(self, registry: Any,
                 note_fn: Callable[..., None] | None) -> None:
        self._reg = weakref.ref(registry)
        self._note = self._note_strong = None
        if note_fn is not None:
            try:
                self._note = weakref.WeakMethod(note_fn)
            except TypeError:  # a plain function: no host to outlive
                self._note_strong = note_fn

    @property
    def registry(self) -> Any:
        return self._reg()

    @property
    def note_fn(self) -> Callable[..., None] | None:
        if self._note_strong is not None:
            return self._note_strong
        if self._note is not None:
            return self._note()
        return None

    def refresh(self, prof: "Profiler") -> bool:
        """Publish the process counters; False once the host is gone."""
        registry = self._reg()
        if registry is None:
            return False
        registry.gauge("profile.samples").set(prof.samples)
        registry.gauge("profile.holds").set(prof.holds)
        registry.gauge("profile.hold_max_ms").set(round(prof.hold_max_ms, 2))
        registry.gauge("profile.hold_ms").set(round(prof.hold_total_ms, 2))
        registry.gauge("profile.overhead_ms").set(round(prof.overhead_ms, 2))
        return True


class Profiler:
    """The per-process sampling profiler (see the module docstring).

    Construct via :func:`acquire`, never directly — the refcounted
    singleton is what keeps one sampler thread per process."""

    def __init__(self, hz: float | None = None,
                 hold_ms: float | None = None,
                 window_s: float | None = None) -> None:
        self.hz = max(0.5, hz if hz is not None
                      else knobs.get_float("COPYCAT_PROFILE_HZ"))
        self.hold_threshold_ms = max(
            1.0, hold_ms if hold_ms is not None
            else knobs.get_float("COPYCAT_PROFILE_HOLD_MS"))
        self.window_s = max(2.0, window_s if window_s is not None
                            else knobs.get_int("COPYCAT_PROFILE_WINDOW_S"))
        # (bucket wall t, {folded stack: sample count}) oldest-first
        self._buckets: deque = deque(
            maxlen=max(2, int(self.window_s / _BUCKET_S)))
        self._holds: deque = deque(maxlen=_HOLD_RING)
        # thread ident -> (wall t, folded stack): the sampler's latest
        # view per thread, what hold attribution reads (GIL-atomic
        # tuple swap; no lock on the loop's hot path)
        self._last_stack: dict[int, tuple[float, str]] = {}
        self._lock = threading.Lock()
        self._views: list[_HostView] = []
        self._refs = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._orig_handle_run: Any = None
        self.samples = 0
        self.holds = 0
        self.hold_max_ms = 0.0
        self.hold_total_ms = 0.0
        self.overhead_ms = 0.0

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._install_loop_patch()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="copycat-profiler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._uninstall_loop_patch()
        thread, self._thread = self._thread, None
        if thread is not None:
            self._stop.set()
            thread.join(timeout=2.0)

    def register_view(self, registry: Any,
                      note_fn: Callable[..., None] | None) -> None:
        view = _HostView(registry, note_fn)
        view.refresh(self)  # keys exist in snapshots before any sample
        with self._lock:
            self._views.append(view)

    def unregister_view(self, registry: Any) -> None:
        with self._lock:  # drop the host's view + any dead ones
            self._views = [v for v in self._views
                           if (r := v.registry) is not None
                           and r is not registry]

    # -- the sampler thread ------------------------------------------------

    def _run(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            t0 = time.perf_counter()
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 - never kill the sampler
                pass
            self.overhead_ms += (time.perf_counter() - t0) * 1e3

    def _sample_once(self) -> None:
        now = time.time()
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        folded: dict[str, int] = {}
        for ident, frame in frames.items():
            if ident == me:  # the sampler never profiles itself
                continue
            stack = fold_stack(frame, names.get(ident, f"thread-{ident}"))
            folded[stack] = folded.get(stack, 0) + 1
            self._last_stack[ident] = (now, stack)
        with self._lock:
            bucket = self._bucket_for(now)
            for stack, n in folded.items():
                bucket[stack] = bucket.get(stack, 0) + n
            self.samples += 1
            views = list(self._views)
        dead = [v for v in views if not v.refresh(self)]
        if dead:  # hosts that vanished without release: stop servicing
            with self._lock:
                self._views = [v for v in self._views if v not in dead]

    def _bucket_for(self, now: float) -> dict:
        """The open bucket for ``now`` (callers hold the lock)."""
        if not self._buckets or now - self._buckets[-1][0] >= _BUCKET_S:
            self._buckets.append((round(now, 3), {}))
        return self._buckets[-1][1]

    # -- hold attribution (the asyncio.Handle._run patch) ------------------

    def _install_loop_patch(self) -> None:
        import asyncio.events as aio_events

        if self._orig_handle_run is not None:
            return
        orig = self._orig_handle_run = aio_events.Handle._run
        threshold_s = self.hold_threshold_ms / 1e3
        prof = self
        perf = time.perf_counter

        def _profiled_run(handle: Any) -> None:
            # THE hot path: two perf_counter reads and a compare per
            # callback; everything else happens only on a real hold
            t0 = perf()
            try:
                orig(handle)
            finally:
                dt = perf() - t0
                if dt >= threshold_s:
                    prof._record_hold(handle, dt)

        aio_events.Handle._run = _profiled_run

    def _uninstall_loop_patch(self) -> None:
        import asyncio.events as aio_events

        if self._orig_handle_run is not None:
            aio_events.Handle._run = self._orig_handle_run
            self._orig_handle_run = None

    def _record_hold(self, handle: Any, dt_s: float) -> None:
        """One loop hold over the threshold: attribute, meter, note.
        Runs on the (just-released) loop thread — swallow everything,
        observability must never wound the host."""
        try:
            dt_ms = dt_s * 1e3
            end = time.time()
            callback = _describe_callback(handle)
            sampled = self._last_stack.get(threading.get_ident())
            if sampled is not None and end - dt_s <= sampled[0] <= end:
                stack = sampled[1]
            else:  # too short for a sample to land: name the callback
                stack = (threading.current_thread().name
                         .replace(";", "_").replace(" ", "_")
                         + ";" + callback.replace(";", "_"))
            frame = stack.rsplit(";", 1)[-1]
            hold = {"t": round(end, 3), "ms": round(dt_ms, 2),
                    "frame": frame, "callback": callback, "stack": stack}
            with self._lock:
                self.holds += 1
                self.hold_total_ms += dt_ms
                self.hold_max_ms = max(self.hold_max_ms, dt_ms)
                self._holds.append(hold)
                views = list(self._views)
            for view in views:
                if not view.refresh(self):
                    continue  # host vanished without release
                note_fn = view.note_fn
                if note_fn is not None:
                    note_fn("loop_stall", hold_ms=round(dt_ms, 1),
                            frame=frame, callback=callback,
                            stack=stack)
        except Exception:  # noqa: BLE001
            pass

    # -- query side --------------------------------------------------------

    def holds_since(self, since: float) -> list[dict]:
        """Retained holds newer than ``since`` (wall seconds) — the
        ``loop_stall`` detector's per-window evidence read."""
        with self._lock:
            return [dict(h) for h in self._holds if h["t"] > since]

    def payload(self, since: float | None = None,
                top: int | None = None) -> dict:
        """The ``/profile`` JSON payload: folded stacks aggregated over
        the retained buckets, optionally windowed to ``t > since``
        (wall seconds, the ``/series`` model) and truncated to the
        ``top`` heaviest stacks."""
        with self._lock:
            merged: dict[str, int] = {}
            for t, bucket in self._buckets:
                if since is not None and t <= since:
                    continue
                for stack, n in bucket.items():
                    merged[stack] = merged.get(stack, 0) + n
            holds = [dict(h) for h in self._holds
                     if since is None or h["t"] > since]
            counters = {
                "samples": self.samples,
                "holds": self.holds,
                "hold_max_ms": round(self.hold_max_ms, 2),
                "hold_ms": round(self.hold_total_ms, 2),
                "overhead_ms": round(self.overhead_ms, 2),
            }
        stacks = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))
        if top is not None:
            stacks = stacks[:max(1, top)]
        return {
            "pid": os.getpid(),
            "hz": self.hz,
            "hold_threshold_ms": self.hold_threshold_ms,
            "window_s": self.window_s,
            "now": round(time.time(), 3),
            "window_samples": sum(merged.values()),
            "stacks": [{"stack": s, "count": n} for s, n in stacks],
            "holds": holds,
            "counters": counters,
        }

    def render_text(self, since: float | None = None,
                    top: int | None = None) -> str:
        """The ``/profile.txt`` rendering: pure flamegraph.pl collapsed
        lines (``stack count``) — pipeable into flamegraph tooling
        as-is, nothing else on the wire."""
        payload = self.payload(since=since, top=top)
        return "".join(f"{row['stack']} {row['count']}\n"
                       for row in payload["stacks"])

    def window_top(self, t0: float, t1: float, top: int = 3) -> dict:
        """Top folded stacks whose buckets overlap ``[t0, t1]`` (wall
        seconds) — what slow traces stamp so a trace's waterfall points
        at the code the process was actually running during it."""
        with self._lock:
            merged: dict[str, int] = {}
            for t, bucket in self._buckets:
                if t0 - _BUCKET_S <= t <= t1:
                    for stack, n in bucket.items():
                        merged[stack] = merged.get(stack, 0) + n
        stacks = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))
        return {
            "t0": round(t0, 3), "t1": round(t1, 3),
            "samples": sum(merged.values()),
            "stacks": [{"stack": s, "count": n}
                       for s, n in stacks[:max(1, top)]],
        }

    def top_summary(self, top: int = 10) -> dict:
        """The compact top-frame summary ``bench --metrics-json``
        embeds: the frame table over the retained window plus the
        plane's own counters (so the artifact carries its cost)."""
        payload = self.payload(top=max(top * 4, 40))
        return {
            "hz": self.hz,
            "window_s": self.window_s,
            "window_samples": payload["window_samples"],
            "counters": payload["counters"],
            "frames": frame_table(
                [(r["stack"], r["count"]) for r in payload["stacks"]],
                top=top),
        }


# ---------------------------------------------------------------------------
# pure aggregation + cluster merge (the CLI/bench side; no profiler needed)
# ---------------------------------------------------------------------------


def frame_table(stacks: Iterable[tuple[str, int]], top: int = 20,
                skip: int = 1) -> list[dict]:
    """Per-frame self/total aggregation over folded stacks.

    ``self`` counts samples where the frame is the leaf (on-CPU there),
    ``total`` samples where it appears anywhere (itself or callees
    below it — counted once per stack, so recursion can't exceed 100%).
    ``skip`` drops leading non-frame segments: 1 for a process profile
    (the thread name), 2 for a cluster merge (member prefix + thread).
    """
    rows = [(s.split(";")[skip:], n) for s, n in stacks]
    rows = [(frames, n) for frames, n in rows if frames]
    grand = sum(n for _, n in rows)
    self_c: Counter = Counter()
    total_c: Counter = Counter()
    for frames, n in rows:
        self_c[frames[-1]] += n
        for f in set(frames):
            total_c[f] += n
    table = [{"frame": f,
              "self": self_c.get(f, 0),
              "total": total,
              "self_pct": round(100 * self_c.get(f, 0) / grand, 1)
              if grand else 0.0,
              "total_pct": round(100 * total / grand, 1) if grand
              else 0.0}
             for f, total in total_c.items()]
    table.sort(key=lambda r: (-r["self"], -r["total"], r["frame"]))
    return table[:max(1, top)]


def assemble_profile(members: dict[str, dict | None],
                     failed_members: Iterable[str] = ()) -> dict:
    """Merge per-member ``/profile`` payloads into ONE cluster profile:
    every folded stack prefixed with its member identity (so one flame
    graph shows the whole cluster, per-member subtrees side by side).
    Unreachable members — and reachable ones serving no ``/profile``
    (plane off, pre-profiler build) — mark the merge ``incomplete=true``
    with reasons: partial profiles render, never drop (the trace/
    timeline assembly semantics)."""
    failed = sorted(set(failed_members))
    incomplete_why = [f"member {m} unreachable" for m in failed]
    stacks: dict[str, int] = {}
    contributed: dict[str, int] = {}
    holds: list[dict] = []
    for addr in sorted(members):
        payload = members[addr]
        if not isinstance(payload, dict) or "stacks" not in payload:
            incomplete_why.append(
                f"member {addr} serves no /profile "
                f"(COPYCAT_PROFILE=0 or a pre-profiler build)")
            contributed[addr] = 0
            continue
        node = payload.get("node") or addr
        n = 0
        for row in payload["stacks"]:
            key = f"{node};{row['stack']}"
            stacks[key] = stacks.get(key, 0) + int(row["count"])
            n += int(row["count"])
        contributed[node] = n
        for hold in payload.get("holds", ()):
            holds.append({**hold, "member": node})
    holds.sort(key=lambda h: -h.get("ms", 0.0))
    ordered = sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))
    return {
        "members": sorted(contributed),
        "contributed": contributed,
        "incomplete": bool(incomplete_why),
        "incomplete_why": incomplete_why,
        "total_samples": sum(stacks.values()),
        "stacks": [{"stack": s, "count": n} for s, n in ordered],
        "holds": holds[:50],
    }


def diff_profiles(current: dict, baseline: dict, top: int = 20
                  ) -> list[dict]:
    """Frame-table diff of two assembled cluster profiles (the saved
    ``--json`` artifact shape): per-frame self%% deltas, largest move
    first — "what got hotter since the baseline". Frames only on one
    side diff against 0."""
    cur = {r["frame"]: r for r in frame_table(
        [(s["stack"], s["count"]) for s in current.get("stacks", ())],
        top=10_000, skip=2)}
    base = {r["frame"]: r for r in frame_table(
        [(s["stack"], s["count"]) for s in baseline.get("stacks", ())],
        top=10_000, skip=2)}
    rows = []
    for frame in set(cur) | set(base):
        c = cur.get(frame, {}).get("self_pct", 0.0)
        b = base.get(frame, {}).get("self_pct", 0.0)
        if c == b == 0.0:
            continue
        rows.append({"frame": frame, "self_pct": c,
                     "baseline_self_pct": b,
                     "delta_pct": round(c - b, 1)})
    rows.sort(key=lambda r: (-abs(r["delta_pct"]), r["frame"]))
    return rows[:max(1, top)]


def render_profile(profile: dict, top: int = 20) -> str:
    """The human rendering of an assembled cluster profile: banner,
    per-member contribution, the frame table (self/total %%), then the
    heaviest loop holds. Incomplete merges carry a loud banner —
    rendered, never dropped."""
    lines = [f"cluster profile: {len(profile['members'])} member(s), "
             f"{profile['total_samples']} folded sample(s)"]
    if profile["incomplete"]:
        lines.append("!! INCOMPLETE: "
                     + "; ".join(profile["incomplete_why"]))
    for member in profile["members"]:
        lines.append(f"  {member:<24} "
                     f"{profile['contributed'].get(member, 0)} sample(s)")
    table = frame_table([(s["stack"], s["count"])
                         for s in profile.get("stacks", ())],
                        top=top, skip=2)
    if table:
        lines.append(f"{'frame':<52} {'self%':>6} {'total%':>7} "
                     f"{'self':>7} {'total':>7}")
        for row in table:
            lines.append(f"{row['frame']:<52} {row['self_pct']:>5.1f}% "
                         f"{row['total_pct']:>6.1f}% {row['self']:>7} "
                         f"{row['total']:>7}")
    else:
        lines.append("(no stacks in the window)")
    holds = profile.get("holds") or []
    lines.append(f"loop holds ({len(holds)}):")
    if not holds:
        lines.append("  (none recorded)")
    for hold in holds[:5]:
        mark = time.strftime("%H:%M:%S", time.localtime(hold.get("t", 0)))
        lines.append(f"  {mark} {hold.get('member', '?'):<22} "
                     f"{hold.get('ms', 0):>8.1f} ms  "
                     f"{hold.get('frame', '?')}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the refcounted process-wide singleton
# ---------------------------------------------------------------------------

_ACQUIRE_LOCK = threading.Lock()

#: THE per-process profiler while any host holds a reference; ``None``
#: when the plane is off or no host is alive (slow-trace stamping and
#: bench read this directly)
PROFILER: Profiler | None = None


def acquire(registry: Any = None,
            note_fn: Callable[..., None] | None = None
            ) -> Profiler | None:
    """Refcounted acquire of the process-wide profiler: the first
    caller starts the sampler thread and installs the loop patch;
    every caller with a ``registry`` gets the ``profile.*`` gauges
    registered there (refreshed by the sampler). Returns ``None`` —
    and touches NOTHING — under ``COPYCAT_PROFILE=0``: no thread, no
    keys, no patch (the A/B off-state)."""
    global PROFILER
    if not knobs.get_bool("COPYCAT_PROFILE"):
        return None
    with _ACQUIRE_LOCK:
        if PROFILER is None:
            PROFILER = Profiler()
            PROFILER.start()
        PROFILER._refs += 1
        if registry is not None:
            PROFILER.register_view(registry, note_fn)
        return PROFILER


def release(profiler: Profiler | None, registry: Any = None) -> None:
    """Release one host's reference (no-op on ``None``, so callers
    release unconditionally): drops the host's gauge view, and the
    LAST release stops the sampler and uninstalls the loop patch —
    the process returns to its unpatched shape."""
    global PROFILER
    if profiler is None:
        return
    with _ACQUIRE_LOCK:
        if registry is not None:
            profiler.unregister_view(registry)
        profiler._refs -= 1
        if profiler._refs <= 0:
            profiler.stop()
            if PROFILER is profiler:
                PROFILER = None


__all__ = [
    "Profiler", "acquire", "release", "assemble_profile", "frame_table",
    "diff_profiles", "render_profile", "fold_stack", "PROFILER",
]
