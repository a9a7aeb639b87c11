"""The port's trace summary (``copycat_tpu_torch/utils/profiling.py``):
the aggregation equals the reference's on the same events, session
discovery picks the newest capture, and an empty directory or a trace
with no device lane raises an actionable error. A real device trace needs
the card (``chip_smoke.py`` reads its profile phases through this
module); these tests use canned traces, or one traced on the CPU."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from copycat_tpu.utils.profiling import (  # noqa: E402
    aggregate_trace_events as reference_aggregate,
)
from copycat_tpu_torch.utils.profiling import (  # noqa: E402
    TRACE_FILE,
    aggregate_trace_events,
    find_trace_files,
    summarize_trace,
    trace,
)

#: the reference's canned events: pid 1 is an XLA device lane, pid 2 a
#: host lane whose events must NOT be counted, pid 3 has no metadata.
EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 1,
     "args": {"name": "/device:TPU:0"}},
    {"ph": "M", "name": "process_name", "pid": 2,
     "args": {"name": "python host thread"}},
    {"ph": "X", "pid": 1, "name": "fusion.42", "dur": 3000},
    {"ph": "X", "pid": 1, "name": "fusion.42", "dur": 1000},
    {"ph": "X", "pid": 1, "name": "copy.7", "dur": 500},
    {"ph": "X", "pid": 2, "name": "host_overhead", "dur": 999999},
    {"ph": "X", "pid": 3, "name": "unknown_lane", "dur": 12345},
    {"ph": "B", "pid": 1, "name": "not_complete_event", "dur": 777},
]

#: a torch trace's layout (torch 2.11 on an H100): every process is named
#: ``python3``; the card's lanes carry ``process_labels`` ``GPU <n>``; the
#: host process holds the runtime calls and the flow events.
TORCH_EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 118,
     "args": {"name": "python3"}},
    {"ph": "M", "name": "process_labels", "pid": 118,
     "args": {"labels": "CPU"}},
    {"ph": "M", "name": "process_name", "pid": 0,
     "args": {"name": "python3"}},
    {"ph": "M", "name": "process_labels", "pid": 0,
     "args": {"labels": "GPU 0"}},
    {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
     "args": {"name": "stream 7 "}},
    {"ph": "X", "pid": 0, "tid": 7, "cat": "kernel",
     "name": "ack_commit_kernel<3>", "dur": 2.5},
    {"ph": "X", "pid": 0, "tid": 7, "cat": "kernel",
     "name": "ack_commit_kernel<3>", "dur": 3.5},
    {"ph": "X", "pid": 0, "tid": 7, "cat": "gpu_memcpy",
     "name": "Memcpy DtoH (Device -> Pageable)", "dur": 7.25},
    {"ph": "f", "pid": 0, "tid": 7, "cat": "ac2g", "name": "ac2g"},
    {"ph": "X", "pid": 118, "cat": "cuda_runtime",
     "name": "cudaLaunchKernel", "dur": 40.0},
    {"ph": "s", "pid": 118, "cat": "ac2g", "name": "ac2g"},
]


@pytest.mark.parametrize("top", [1, 3, 15, None])
def test_aggregate_equals_the_references(top):
    assert aggregate_trace_events(EVENTS, top) == reference_aggregate(
        EVENTS, top)


def test_aggregate_counts_a_torch_traces_device_lanes_only():
    rows = aggregate_trace_events(TORCH_EVENTS + EVENTS, top=None)
    assert rows == [("fusion.42", 4.0, 2), ("copy.7", 0.5, 1),
                    ("Memcpy DtoH (Device -> Pageable)", 0.00725, 1),
                    ("ack_commit_kernel<3>", 0.006, 2)]
    assert aggregate_trace_events(TORCH_EVENTS, top=1) == [
        ("Memcpy DtoH (Device -> Pageable)", 0.00725, 1)]


def _write_session(root, name, events):
    d = root / name
    d.mkdir(parents=True)
    (d / TRACE_FILE).write_text(json.dumps({"traceEvents": events}))
    return d / TRACE_FILE


def test_find_trace_files_picks_the_newest_session(tmp_path):
    _write_session(tmp_path, "20260101-000000-1", EVENTS)
    new = _write_session(tmp_path, "20260202-000000-2", EVENTS)
    assert find_trace_files(str(tmp_path)) == [str(new)]


def test_an_empty_trace_dir_is_actionable(tmp_path):
    with pytest.raises(FileNotFoundError, match=TRACE_FILE):
        find_trace_files(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="did the traced region"):
        summarize_trace(str(tmp_path))


def test_summarize_trace_reads_the_newest_sessions_device_lanes(tmp_path):
    _write_session(tmp_path, "20260101-000000-1", TORCH_EVENTS[:4] + [
        {"ph": "X", "pid": 0, "name": "old_kernel", "dur": 1.0}])
    _write_session(tmp_path, "20260202-000000-2", TORCH_EVENTS)
    assert summarize_trace(str(tmp_path), top=None) == [
        ("Memcpy DtoH (Device -> Pageable)", 0.00725, 1),
        ("ack_commit_kernel<3>", 0.006, 2)]


def test_a_trace_with_no_device_lane_is_actionable(tmp_path):
    """A region traced on the CPU: the torch trace has a host process and
    no card's lane, so there is nothing to sum."""
    from torch.profiler import ProfilerActivity

    with trace(str(tmp_path), activities=[ProfilerActivity.CPU]) as prof:
        assert prof is not None
        (torch.arange(8) * 2).sum()
    (session,) = os.listdir(tmp_path)
    assert os.path.exists(tmp_path / session / TRACE_FILE)
    with pytest.raises(RuntimeError, match="no device lane"):
        summarize_trace(str(tmp_path))


def test_trace_is_a_no_op_without_a_dir():
    with trace(None) as prof:
        assert prof is None
    with trace("") as prof:
        assert prof is None
