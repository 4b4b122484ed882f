"""The port's process-global metrics registry: counters, gauges and
histograms, their JSON snapshot and their Prometheus text exposition (a
port of ``repro.obs.metrics``).

A metric is a named *family* with fixed label names; each label-value
combination is one **series** (``repro_pool_admits_total{pool="0"}``).
Instruments hold plain Python numbers and are bumped on the host between
device calls, never from inside one, so they add no device work and no
host sync.  The serving layers' counter attributes are
:func:`series_property` views over their series, so ``stats()`` and the
registry read the same cells; each pool, scheduler or gateway instance
takes a fresh label, so two instances in one process keep separate
series.  ``REPRO_OBS=0`` keeps the instruments working but leaves them
out of the registry (exports stay empty) and turns span recording off
(see ``tracing``).

:func:`snapshot` returns a JSON-able ``{family: {"kind", "help",
"series"}}`` dict; :func:`prometheus_text` renders the text exposition
format (``# HELP`` / ``# TYPE`` and a line a series), each histogram
followed by a derived ``<name>_summary`` family of its estimated
quantiles.  Family names are the JAX package's (``repro_gateway_*``,
``repro_http_*``, ...), so a scrape configuration works unchanged.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Any, Iterable

_HIST_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

#: the quantiles every histogram family also exposes as an estimated
#: Prometheus *summary* (``<name>_summary{quantile="..."}``) and in the
#: JSON snapshot (``p50`` / ``p90`` / ``p99``)
SUMMARY_QUANTILES = (0.5, 0.9, 0.99)


def enabled() -> bool:
    """Telemetry master switch (``REPRO_OBS=0`` disables), read per call."""
    return os.environ.get("REPRO_OBS", "1") != "0"


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def escape_label_value(value: str) -> str:
    """Exposition escaping of a label VALUE: backslash, double quote and
    newline, without which the scrape line is ambiguous."""
    return (value.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def escape_help(text: str) -> str:
    """``# HELP`` text escaping: backslash and newline (quotes are legal
    in help text)."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{escape_label_value(v)}"'
                          for k, v in key) + "}"


class _Series:
    """One label combination's value cell."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, amount=1):
        self.value += amount

    def set(self, value):
        self.value = value

    def reset(self):
        self.value = 0


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

    def reset(self):
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def quantile(self, q: float) -> float | None:
        """The q-quantile estimated from the buckets, as Prometheus's
        ``histogram_quantile``: the bucket the rank falls in, linearly
        interpolated inside it.  A rank in the ``+Inf`` tail clamps to the
        highest finite edge; an empty series gives ``None``."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return None
        rank = q * self.count
        acc = 0
        for i, edge in enumerate(self.buckets):
            prev_acc = acc
            acc += self.counts[i]
            if acc >= rank and self.counts[i] > 0:
                lo = self.buckets[i - 1] if i > 0 else min(0.0, edge)
                frac = (rank - prev_acc) / self.counts[i]
                return lo + (edge - lo) * max(0.0, min(1.0, frac))
        # the rank is in the +Inf bucket: report the top edge ("at least")
        return self.buckets[-1] if self.buckets else None


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
        key = _label_key({k: str(v) for k, v in labels.items()})
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._new_series()
        return s

    @property
    def default(self):
        """The label-less series (only for a family declared label-less)."""
        return self.labels()

    def series(self) -> dict[str, Any]:
        """``{rendered label string: value}`` snapshot."""
        return {_fmt_labels(k) or "": s.value
                for k, s in sorted(self._series.items())}


class Counter(Metric):
    kind = "counter"

    def inc(self, amount=1, **labels):
        self.labels(**labels).inc(amount)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value, **labels):
        self.labels(**labels).set(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: tuple[float, ...] = _HIST_DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        super().__init__(name, help, labelnames)

    def _new_series(self):
        return _HistSeries(self.buckets)

    def observe(self, value, **labels):
        self.labels(**labels).observe(value)

    def series(self) -> dict[str, Any]:
        return {_fmt_labels(k): {"sum": s.sum, "count": s.count,
                                 "buckets": dict(zip(
                                     [str(b) for b in s.buckets] + ["+Inf"],
                                     list(itertools.accumulate(s.counts)))),
                                 "quantiles": {
                                     f"p{int(q * 100)}": s.quantile(q)
                                     for q in SUMMARY_QUANTILES}}
                for k, s in sorted(self._series.items())}


class Registry:
    """Name -> metric family; one process-global instance, ``REGISTRY``
    (tests may build private ones)."""

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

    def metrics(self) -> list[Metric]:
        return list(self._metrics.values())

    def snapshot(self) -> dict:
        """JSON-able ``{name: {"kind", "help", "series": {...}}}``."""
        return {m.name: {"kind": m.kind, "help": m.help,
                         "series": m.series()}
                for m in sorted(self._metrics.values(),
                                key=lambda m: m.name)}

    def prometheus_text(self) -> str:
        """The text exposition of every series.  Each histogram family is
        followed by a derived ``<name>_summary`` family of TYPE
        ``summary`` carrying its estimated quantiles
        (:data:`SUMMARY_QUANTILES`)."""
        lines: list[str] = []
        for m in sorted(self._metrics.values(), key=lambda m: m.name):
            lines.append(f"# HELP {m.name} {escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for key, s in sorted(m._series.items()):
                    acc = 0
                    for edge, c in zip(list(m.buckets) + ["+Inf"], s.counts):
                        acc += c
                        lk = _label_key(dict(key) | {"le": str(edge)})
                        lines.append(
                            f"{m.name}_bucket{_fmt_labels(lk)} {acc}")
                    lines.append(f"{m.name}_sum{_fmt_labels(key)} {s.sum}")
                    lines.append(f"{m.name}_count{_fmt_labels(key)} "
                                 f"{s.count}")
                sname = f"{m.name}_summary"
                lines.append(f"# HELP {sname} bucket-estimated quantiles "
                             f"of {m.name}")
                lines.append(f"# TYPE {sname} summary")
                for key, s in sorted(m._series.items()):
                    for q in SUMMARY_QUANTILES:
                        v = s.quantile(q)
                        if v is None:
                            continue
                        lk = _label_key(dict(key) | {"quantile": str(q)})
                        lines.append(f"{sname}{_fmt_labels(lk)} {v}")
                    lines.append(f"{sname}_sum{_fmt_labels(key)} {s.sum}")
                    lines.append(f"{sname}_count{_fmt_labels(key)} "
                                 f"{s.count}")
            else:
                for key, s in sorted(m._series.items()):
                    lines.append(f"{m.name}{_fmt_labels(key)} {s.value}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        """Drop every family (tests)."""
        with self._lock:
            self._metrics.clear()

    def reset(self) -> None:
        """Zero every series IN PLACE, keeping registrations and live
        series handles valid: the serving layers hold their series
        (``series_property`` views), which ``clear()`` would orphan.  The
        test modules of the wire and the obs plane
        (``tests/test_torch_{http,obs_live,obs_export}.py``) call it at
        their start; ``tests/conftest.py`` resets only ``repro.obs``'s
        registry, so every other port test reads deltas."""
        with self._lock:
            for m in self._metrics.values():
                with m._lock:
                    for s in m._series.values():
                        s.reset()


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


def snapshot() -> dict:
    return REGISTRY.snapshot()


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()
