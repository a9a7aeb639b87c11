"""Device traces through ``torch.profiler``.

The port's counterpart of ``copycat_tpu/utils/profiling.py``. Where the
reference wraps a region in ``jax.profiler.trace`` and parses the XLA
capture with ``xprof``, :func:`trace` wraps it in ``torch.profiler`` with
the CUDA activity and writes a Chrome trace (open it in Perfetto or
``chrome://tracing``); :func:`summarize_trace` reads the newest one back
and sums the time of each kernel on the device lanes.

Usage::

    from copycat_tpu_torch.utils.profiling import summarize_trace, trace

    with trace("/tmp/copycat-trace"):   # no-op when the dir is falsy
        for _ in range(5):
            rg.step_round()
    for name, total_ms, count in summarize_trace("/tmp/copycat-trace"):
        ...
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Iterator

#: the file each traced session writes under its own directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(trace_dir: str | None, activities=None) -> Iterator[object]:
    """Trace the enclosed region with ``torch.profiler`` (no-op if
    ``trace_dir`` is falsy) and write its Chrome trace to a new session
    directory ``trace_dir/<YYYYmmdd-HHMMSS>-<ns>/trace.json``. Only the
    CUDA activity is traced unless ``activities`` names others: the
    summary reads device events alone, and tracing every host op slows
    the host it measures. Yields the profiler (``None`` when off)."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    session = os.path.join(str(trace_dir), time.strftime(
        "%Y%m%d-%H%M%S") + f"-{time.time_ns()}")
    with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
        yield prof
    os.makedirs(session, exist_ok=True)
    prof.export_chrome_trace(os.path.join(session, TRACE_FILE))


def find_trace_files(trace_dir: str) -> list[str]:
    """The Chrome trace files of the NEWEST session under ``trace_dir``:
    :func:`trace` writes one session directory per capture, so a reused
    trace dir never merges runs."""
    for session in sorted(glob.glob(os.path.join(str(trace_dir), "*", "")),
                          reverse=True):
        files = glob.glob(os.path.join(session, TRACE_FILE))
        if files:
            return files
    raise FileNotFoundError(
        f"no trace sessions under {trace_dir}: expected "
        f"<session>/{TRACE_FILE} — did the traced region actually run?")


def device_pids(events: list[dict]) -> set:
    """The pids of the device lanes: those whose ``process_name`` metadata
    names a device (the reference's rule, for XLA traces), and those whose
    ``process_labels`` do — a torch trace names every process ``python3``
    and labels its card's lanes ``GPU <n>``."""
    marks = ("TPU", "GPU", "/device", "Device", "XLA Op")
    pids = set()
    for event in events:
        if event.get("ph") != "M":
            continue
        args = event.get("args", {})
        text = {"process_name": args.get("name", ""),
                "process_labels": args.get("labels", "")}.get(
                    event.get("name"))
        if text and any(t in text for t in marks):
            pids.add(event.get("pid"))
    return pids


def aggregate_trace_events(events: list[dict],
                           top: int | None = 15
                           ) -> list[tuple[str, float, int]]:
    """Aggregate device-lane op time from trace-viewer JSON events.

    Returns ``[(op_name, total_ms, count), ...]`` sorted by time, ``top``
    of them (``None``: all). Only complete events on device lanes
    (:func:`device_pids`) are counted — in a torch trace, the kernels,
    copies and sets the card ran — so host-side spans and runtime calls
    don't drown the per-op numbers."""
    import collections

    pids = device_pids(events)
    agg: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for event in events:
        if event.get("ph") != "X" or event.get("pid") not in pids:
            continue
        name = event.get("name", "")
        agg[name] += event.get("dur", 0)
        cnt[name] += 1
    return [(name, dur / 1e3, cnt[name]) for name, dur in agg.most_common(top)]


def summarize_trace(trace_dir: str, top: int | None = 15
                    ) -> list[tuple[str, float, int]]:
    """Aggregate device-op time from the NEWEST trace session under
    ``trace_dir``: ``[(op_name, total_ms, count), ...]`` sorted by time
    (``top=None``: every op). Raises when the trace holds no device lane
    — a region traced without a card, or without the CUDA activity —
    rather than summing nothing."""
    files = find_trace_files(trace_dir)
    events: list[dict] = []
    for path in files:
        with open(path) as f:
            data = json.load(f)
        events += data["traceEvents"] if isinstance(data, dict) else data
    if not device_pids(events):
        raise RuntimeError(
            f"no device lane in the trace {files}: trace the region on a "
            "CUDA card with the CUDA activity (utils.profiling.trace does "
            "by default)")
    return aggregate_trace_events(events, top)
