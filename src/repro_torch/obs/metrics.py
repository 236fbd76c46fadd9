"""Metrics registry: counters, gauges, and log-scale histograms.

The always-on half of ``repro_torch.obs`` (tracing is opt-in; metrics are
cheap enough to leave running).  Metric names follow
``subsystem.verb.unit`` (``serve.request.seconds``, ``train.step.seconds``)
with optional labels (``kind="joint_ll"``, ``bucket=8``); one (name,
labels) pair is one metric instance; ``repro_torch.obs.summary`` reads the
registry for the ``[obs]`` exit line.

Histograms use fixed log-scale buckets (``_PER_DECADE`` buckets per decade
of dynamic range, geometric midpoint readout), so ``percentile(q)`` is
accurate to about half a bucket ratio (~5% relative) at any load --
bounded memory, no sample retention, mergeable across label values by
summing the bucket count vectors (:meth:`MetricsRegistry.sum_histogram`).
``Histogram.counts()`` snapshots are subtractable: mark before a timed
pass, diff after (:func:`percentile_from_counts`) for that pass alone.
The bucket layout is the reference's (``repro.obs.metrics``), so both
packages' count vectors and percentiles agree on the same samples.

Thread safety: every mutation takes the owning metric's lock (concurrent
engine threads incrementing one counter must never lose updates).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# histogram bucket layout (class-wide so count vectors are always mergeable):
# values below _LO land in the underflow bucket, above _HI in overflow;
# 24 buckets/decade -> ratio 10^(1/24) ~ 1.10, midpoint error < 5%
_LO = 1e-7
_HI = 1e4
_PER_DECADE = 24
_DECADES = int(round(math.log10(_HI / _LO)))
NUM_BUCKETS = _DECADES * _PER_DECADE + 2  # + underflow + overflow
_LOG_LO = math.log10(_LO)


def _bucket_index(value: float) -> int:
    if value < _LO:
        return 0
    if value >= _HI:
        return NUM_BUCKETS - 1
    return 1 + int((math.log10(value) - _LOG_LO) * _PER_DECADE)


def _bucket_mid(index: int) -> float:
    """Geometric midpoint of bucket ``index`` (clamped for under/overflow)."""
    if index <= 0:
        return _LO
    if index >= NUM_BUCKETS - 1:
        return _HI
    lo = 10.0 ** (_LOG_LO + (index - 1) / _PER_DECADE)
    return lo * 10.0 ** (0.5 / _PER_DECADE)


def percentile_from_counts(counts: Sequence[int], q: float) -> float:
    """The q-th percentile (0..100) from a bucket count vector (e.g. the
    difference of two :meth:`Histogram.counts` snapshots)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = (q / 100.0) * (total - 1)
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum > rank:
            return _bucket_mid(i)
    return _bucket_mid(NUM_BUCKETS - 1)


class Counter:
    """Monotonic counter; ``inc`` accepts floats (seconds accumulators)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> float:
        v = self._value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-write-wins instantaneous value (queue depth, last LL), with a
    high-watermark: a bursty gauge such as ``serve.queue.depth`` has
    drained to ~0 by the time anyone reads it, so :attr:`max` keeps the
    largest value ever set."""

    __slots__ = ("_lock", "_value", "_max")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = -math.inf

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            if self._value > self._max:
                self._max = self._value

    @property
    def value(self) -> float:
        return self._value

    @property
    def max(self) -> float:
        """High-watermark of every ``set`` (0.0 before the first)."""
        return self._max if self._max != -math.inf else 0.0

    def snapshot(self) -> Dict[str, float]:
        """``value`` and ``max``, each left out where it is not finite
        (JSON has no NaN: a diverged step's health gauges still export a
        valid document, and their ``nonfinite`` slots count the fault)."""
        return {k: v for k, v in (("value", self._value), ("max", self.max))
                if math.isfinite(v)}


class Histogram:
    """Fixed-bucket log-scale histogram with percentile readout."""

    __slots__ = ("_lock", "_counts", "count", "total", "vmin", "vmax")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * NUM_BUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        value = float(value)
        idx = _bucket_index(value) if value > 0 else 0
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += value
            if value < self.vmin:
                self.vmin = value
            if value > self.vmax:
                self.vmax = value

    def counts(self) -> List[int]:
        """Snapshot of the bucket counts (subtract two snapshots to read
        percentiles over just the interval between them)."""
        with self._lock:
            return list(self._counts)

    def percentile(self, q: float,
                   baseline: Optional[Sequence[int]] = None) -> float:
        """q-th percentile (0..100); ``baseline`` subtracts an earlier
        :meth:`counts` snapshot first.  Clamped to the observed [min, max]
        when no baseline is given (bucket midpoints can overshoot)."""
        counts = self.counts()
        if baseline is not None:
            counts = [c - b for c, b in zip(counts, baseline)]
            return percentile_from_counts(counts, q)
        v = percentile_from_counts(counts, q)
        if self.count:
            v = min(max(v, self.vmin), self.vmax)
        return v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


_LabelKey = Tuple[str, Tuple[Tuple[str, Any], ...]]


def _key(name: str, labels: Dict[str, Any]) -> _LabelKey:
    return (name, tuple(sorted(labels.items())))


def _fullname(key: _LabelKey) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """All metrics of one process; module-level :data:`METRICS` is the
    default everything instruments into."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[_LabelKey, Any] = {}

    def _get(self, name: str, labels: Dict[str, Any], cls):
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls()
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {_fullname(key)} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}"
            )
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(name, labels, Histogram)

    def find(self, name: str, **match: Any) -> List[Tuple[Dict[str, Any], Any]]:
        """Every (labels, metric) registered under ``name`` whose labels
        include ``match``."""
        out = []
        with self._lock:
            items = list(self._metrics.items())
        for (n, labels), metric in items:
            if n != name:
                continue
            d = dict(labels)
            if all(d.get(k) == v for k, v in match.items()):
                out.append((d, metric))
        return out

    def sum_histogram(self, name: str, **match: Any) -> List[int]:
        """Merged bucket counts over every histogram labeled under ``name``
        matching ``match`` (histograms merge by summing count vectors)."""
        total = [0] * NUM_BUCKETS
        for _, h in self.find(name, **match):
            if isinstance(h, Histogram):
                for i, c in enumerate(h.counts()):
                    total[i] += c
        return total

    def value(self, name: str, default: float = 0.0, **labels: Any) -> float:
        m = self._metrics.get(_key(name, labels))
        return m.value if m is not None else default

    def snapshot(self) -> Dict[str, Any]:
        """The whole registry as one flat JSON-able dict keyed by
        ``name{label=value,...}`` (the ``--metrics out.json`` file)."""
        with self._lock:
            items = list(self._metrics.items())
        snap = {_fullname(k): m.snapshot() for k, m in sorted(
            items, key=lambda kv: _fullname(kv[0]))}
        # a gauge with no finite field has nothing to export
        return {k: v for k, v in snap.items() if v != {}}

    def reset(self) -> None:
        with self._lock:
            self._metrics = {}


METRICS = MetricsRegistry()
