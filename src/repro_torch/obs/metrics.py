"""The port's process-global metrics registry: counters, gauges and
histograms (a port of the recording half of ``repro.obs.metrics``).

A metric is a named *family* with fixed label names; each label-value
combination is one **series** (``repro_pool_admits_total{pool="0"}``).
Instruments hold plain Python numbers and are bumped on the host between
device calls, never from inside one, so they add no device work and no
host sync.  The serving layers' counter attributes are
:func:`series_property` views over their series, so ``stats()`` and the
registry read the same cells; each pool, scheduler or gateway instance
takes a fresh label, so two instances in one process keep separate
series.  ``REPRO_OBS=0`` keeps the instruments working but leaves them
out of the registry (and turns span recording off, see ``tracing``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Iterable

_HIST_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


def enabled() -> bool:
    """Telemetry master switch (``REPRO_OBS=0`` disables), read per call."""
    return os.environ.get("REPRO_OBS", "1") != "0"


class _Series:
    """One label combination's value cell."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, amount=1):
        self.value += amount

    def set(self, value):
        self.value = value


class _HistSeries:
    """Cumulative-bucket histogram cell (Prometheus ``le`` semantics)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)          # +inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        self.sum += value
        self.count += 1
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class Metric:
    """A named family of series sharing one set of label names."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: dict[tuple[tuple[str, str], ...], Any] = {}
        self._lock = threading.Lock()

    def _new_series(self):
        return _Series()

    def labels(self, **labels):
        """The series of one label-value combination (made on first use)."""
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} != "
                             f"declared {sorted(self.labelnames)}")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._new_series()
        return s


class Counter(Metric):
    kind = "counter"

    def inc(self, amount=1, **labels):
        self.labels(**labels).inc(amount)


class Gauge(Metric):
    kind = "gauge"


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: tuple[float, ...] = _HIST_DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        super().__init__(name, help, labelnames)

    def _new_series(self):
        return _HistSeries(self.buckets)


class Registry:
    """Name -> metric family; one process-global instance, ``REGISTRY``."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            have = self._metrics.get(metric.name)
            if have is None:
                self._metrics[metric.name] = metric
                return metric
            if type(have) is not type(metric) \
                    or have.labelnames != metric.labelnames:
                raise ValueError(f"metric {metric.name!r} re-registered "
                                 f"with a different type/labels")
            return have

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)


#: the port's process-global registry
REGISTRY = Registry()


def _make(cls, name, help, labelnames, **kw):
    metric = cls(name, help, labelnames, **kw)
    return REGISTRY.register(metric) if enabled() else metric


def counter(name: str, help: str = "",
            labelnames: Iterable[str] = ()) -> Counter:
    return _make(Counter, name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Iterable[str] = ()) -> Gauge:
    return _make(Gauge, name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Iterable[str] = (),
              buckets: tuple[float, ...] = _HIST_DEFAULT_BUCKETS) -> Histogram:
    return _make(Histogram, name, help, labelnames, buckets=buckets)


def series_property(key: str, store: str = "_obs_series") -> property:
    """A class attribute that reads and writes one series: the instance
    holds a ``{key: series}`` dict at ``store``."""
    def getter(self):
        return getattr(self, store)[key].value

    def setter(self, value):
        getattr(self, store)[key].set(value)

    return property(getter, setter)
