"""First-class metrics: counters, gauges + latency histograms (ops/sec, p99).

The reference ships no metrics registry (SURVEY.md §5.5 — "build
obligation: add ops/sec + p99 commit latency counters as first-class";
they are BASELINE.json's headline metric). Host-side and dependency-free:
device code stays pure, the driver feeds the registry.

The observability plane (docs/OBSERVABILITY.md) builds on three pieces
here:

- **labels**: ``registry.counter("frames_in", direction="rx")`` keys the
  metric by ``(name, labels)``; snapshots flatten to
  ``frames_in{direction=rx}`` so per-node/per-lane series coexist in one
  registry.
- **merge**: ``registry.merge(other, node="5001")`` folds another
  registry in (counters add, gauges overwrite, histogram reservoirs
  combine), optionally stamping extra labels — how per-transport and
  per-client registries roll up into one server snapshot.
  ``merge_snapshots`` does the lossier JSON-level equivalent for
  snapshots collected from other processes.
- **renderers**: ``render_prometheus()`` (text exposition format) and
  ``render_json()`` feed the ``/metrics`` stats listener
  (``server/stats.py``) and ``copycat-tpu stats``.
"""

from __future__ import annotations

import json
import random
import time

_EMPTY_LABELS: tuple = ()


def _key(name: str, labels: dict) -> tuple[str, tuple]:
    return (name, tuple(sorted(labels.items())) if labels else _EMPTY_LABELS)


def _flat(key: tuple[str, tuple]) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A point-in-time value (term, commit index, open sessions, queue
    depth): set/inc/dec, last write wins."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Reservoir-sampled value distribution with exact count/sum."""

    def __init__(self, reservoir: int = 65536, seed: int = 0) -> None:
        self._values: list[float] = []
        self._reservoir = reservoir
        self._rng = random.Random(seed)
        self.count = 0
        self.sum = 0.0
        # exact running max (like count/sum): the reservoir can evict
        # the worst sample, and "max" exists to surface outliers
        self.max_value = 0.0

    def record(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if self.count == 1 or value > self.max_value:
            self.max_value = value
        if len(self._values) < self._reservoir:
            self._values.append(value)
        else:
            i = self._rng.randrange(self.count)
            if i < self._reservoir:
                self._values[i] = value

    def percentile(self, p: float) -> float:
        """Linear-interpolated percentile (numpy's default method).

        Floor-indexing biased small samples: p50 of [1..100] returned 51
        and p-anything of a 2-sample histogram snapped to an endpoint.
        Interpolating at rank ``p/100 * (n-1)`` matches what every
        reader of a "p99" expects from small reservoirs.
        """
        if not self._values:
            return 0.0
        vals = sorted(self._values)
        n = len(vals)
        if n == 1:
            return vals[0]
        rank = max(0.0, min(p, 100.0)) / 100.0 * (n - 1)
        lo = int(rank)
        hi = min(lo + 1, n - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (rank - lo)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def merge_from(self, other: "Histogram") -> None:
        """Fold another histogram in: exact count/sum, combined
        reservoir (downsampled back to capacity if the union overflows)."""
        if other.count and (not self.count
                            or other.max_value > self.max_value):
            self.max_value = other.max_value
        self.count += other.count
        self.sum += other.sum
        combined = self._values + other._values
        if len(combined) > self._reservoir:
            combined = self._rng.sample(combined, self._reservoir)
        self._values = combined


class Timer:
    """Context manager recording elapsed milliseconds into a histogram."""

    def __init__(self, hist: Histogram) -> None:
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.record((time.perf_counter() - self._t0) * 1e3)
        return False


class MetricsRegistry:
    """Named counters, gauges and histograms with a JSON-able snapshot.

    Metrics are keyed by ``(name, sorted(labels))``; the snapshot
    flattens keys to ``name`` or ``name{k=v,...}``.
    """

    def __init__(self) -> None:
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}
        self._t0 = time.perf_counter()

    def counter(self, name: str, **labels) -> Counter:
        key = _key(name, labels)
        ctr = self._counters.get(key)
        if ctr is None:
            ctr = self._counters[key] = Counter()
        return ctr

    def gauge(self, name: str, **labels) -> Gauge:
        key = _key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        key = _key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram()
        return h

    def timer(self, name: str, **labels) -> Timer:
        return Timer(self.histogram(name, **labels))

    def rate(self, name: str, **labels) -> float:
        """Events/sec for a counter since registry creation (0.0 for a
        counter that was never incremented — asking for a rate must not
        be the thing that crashes the stats surface)."""
        ctr = self._counters.get(_key(name, labels))
        if ctr is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        return ctr.value / dt if dt > 0 else 0.0

    # -- aggregation -------------------------------------------------------

    def merge(self, other: "MetricsRegistry", **extra_labels) -> None:
        """Fold ``other`` into this registry: counters add, gauges
        overwrite, histograms combine reservoirs. ``extra_labels`` are
        stamped onto every merged key — the cluster roll-up idiom:
        ``total.merge(node_registry, node="5001")``."""

        def rekey(key: tuple) -> tuple:
            if not extra_labels:
                return key
            name, labels = key
            merged = dict(labels)
            merged.update(extra_labels)
            return _key(name, merged)

        for key, ctr in other._counters.items():
            name, labels = rekey(key)
            self.counter(name, **dict(labels)).inc(ctr.value)
        for key, g in other._gauges.items():
            name, labels = rekey(key)
            self.gauge(name, **dict(labels)).set(g.value)
        for key, h in other._histograms.items():
            name, labels = rekey(key)
            self.histogram(name, **dict(labels)).merge_from(h)

    # -- exposition --------------------------------------------------------

    def snapshot(self) -> dict:
        out: dict = {"uptime_s": round(time.perf_counter() - self._t0, 3)}
        for key, ctr in self._counters.items():
            out[_flat(key)] = ctr.value
        if self._gauges:
            # gauges are indistinguishable from counters once flattened
            # to JSON; the hint lets merge_snapshots keep them point-in-
            # time (max) instead of summing them into nonsense
            out["_gauge_keys"] = [_flat(k) for k in self._gauges]
        for key, g in self._gauges.items():
            out[_flat(key)] = g.value
        for key, h in self._histograms.items():
            out[_flat(key)] = {
                "count": h.count,
                "mean": round(h.mean, 4),
                "p50": round(h.percentile(50), 4),
                "p99": round(h.percentile(99), 4),
                "max": round(h.max_value, 4) if h.count else 0.0,
            }
        return out

    def render_json(self) -> str:
        return json.dumps(self.snapshot())

    def render_prometheus(self, namespace: str = "copycat") -> str:
        """Prometheus text exposition format (counters/gauges as-is,
        histograms as summaries with p50/p99 quantile samples)."""
        lines: list[str] = []

        def sample(name: str, labels: tuple, value, extra: dict | None = None):
            all_labels = dict(labels)
            if extra:
                all_labels.update(extra)
            if all_labels:
                inner = ",".join(f'{_sanitize(k)}="{v}"'
                                 for k, v in sorted(all_labels.items()))
                lines.append(f"{name}{{{inner}}} {value}")
            else:
                lines.append(f"{name} {value}")

        for (name, labels), ctr in self._counters.items():
            metric = f"{namespace}_{_sanitize(name)}"
            lines.append(f"# TYPE {metric} counter")
            sample(metric, labels, ctr.value)
        for (name, labels), g in self._gauges.items():
            metric = f"{namespace}_{_sanitize(name)}"
            lines.append(f"# TYPE {metric} gauge")
            sample(metric, labels, g.value)
        for (name, labels), h in self._histograms.items():
            metric = f"{namespace}_{_sanitize(name)}"
            lines.append(f"# TYPE {metric} summary")
            sample(metric, labels, h.percentile(50), {"quantile": "0.5"})
            sample(metric, labels, h.percentile(99), {"quantile": "0.99"})
            sample(f"{metric}_count", labels, h.count)
            sample(f"{metric}_sum", labels, h.sum)
        return "\n".join(lines) + "\n"


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def merge_snapshots(snaps: list[dict]) -> dict:
    """JSON-level merge of :meth:`MetricsRegistry.snapshot` dicts from
    OTHER processes (no reservoirs to combine): counters sum; gauges
    (identified by the snapshot's ``_gauge_keys`` hint) take the max —
    summing a per-node ``raft_term`` or ``raft_is_leader`` would
    fabricate values; histogram entries merge with exact count/weighted
    mean and worst-case (max) percentiles — an upper bound, honest for
    alerting."""
    gauge_keys: set = set()
    for snap in snaps:
        gauge_keys.update(snap.get("_gauge_keys", ()))
    out: dict = {}
    if gauge_keys:
        out["_gauge_keys"] = sorted(gauge_keys)
    for snap in snaps:
        for key, val in snap.items():
            if key == "_gauge_keys":
                continue
            if key == "uptime_s" or key in gauge_keys:
                out[key] = max(out.get(key, 0.0), val)
            elif isinstance(val, dict):
                cur = out.get(key)
                if cur is None:
                    out[key] = dict(val)
                else:
                    n = cur["count"] + val["count"]
                    if n:
                        cur["mean"] = round(
                            (cur["mean"] * cur["count"]
                             + val["mean"] * val["count"]) / n, 4)
                    cur["count"] = n
                    for q in ("p50", "p99", "max"):
                        cur[q] = max(cur.get(q, 0.0), val.get(q, 0.0))
            else:
                out[key] = out.get(key, 0) + val
    return out
