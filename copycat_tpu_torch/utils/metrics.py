"""Counters, gauges and histograms (ops/sec, p99) for the host runtime.

The port's own copy of the part of ``copycat_tpu/utils/metrics.py`` it
uses: counters, gauges, histograms and timers keyed by name and labels
(``registry.counter("device.applies", pool="map")`` flattens to
``device.applies{pool=map}`` in a snapshot). Host-side and
dependency-free; the device code stays pure and the drivers feed the
registry.
"""

from __future__ import annotations

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

    # -- exposition --------------------------------------------------------

    def snapshot(self) -> dict:
        out: dict = {"uptime_s": round(time.perf_counter() - self._t0, 3)}
        for key, ctr in self._counters.items():
            out[_flat(key)] = ctr.value
        if self._gauges:
            # gauges are indistinguishable from counters once flattened;
            # the hint tells a merge of snapshots to keep them
            # point-in-time (max) instead of summing them
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
