"""repro_torch.obs — the port's telemetry (a port of ``repro.obs``).

::

    metrics    ── process-global registry: counters / gauges / histograms
    │             with labelled series; JSON snapshot and Prometheus text
    tracing    ── nestable spans in wall-clock and virtual decode-step time
    │             (gateway tick, admission, prefill, decode chunk, park /
    │             restore), recorded on the host between device calls
    export     ── Chrome / Perfetto trace_event JSON (one-shot and chunked)
    │             and snapshot writers
    live       ── the bounded ring of completed spans behind /debug/trace
    slo        ── the burn-rate SLO monitor and the flight recorder
    promparse  ── the strict parser of the Prometheus text exposition
    cycles     ── the cycle ledger: predicted against measured concurrent
                  steps per op family

All recording is host-side Python between device calls: it adds no
kernel launch and no host sync, and ``REPRO_OBS=0`` reduces every span
to one environment lookup while the metric instruments keep counting
(the serving layers' ``stats()`` dicts read them).
"""

from . import cycles, export, live, metrics, promparse, slo, tracing
from .cycles import LEDGER, audit, drift_table
from .export import (chrome_trace, iter_trace_chunks, validate_chrome_trace,
                     write_metrics, write_trace, write_trace_stream)
from .live import TraceRing
from .metrics import (REGISTRY, counter, enabled, gauge, histogram,
                      prometheus_text, snapshot)
from .slo import BurnWindow, FlightRecorder, SloMonitor, allocator_state
from .tracing import TRACER, instant, span

__all__ = [
    "cycles", "export", "live", "metrics", "promparse", "slo", "tracing",
    "LEDGER", "audit", "drift_table",
    "chrome_trace", "iter_trace_chunks", "validate_chrome_trace",
    "write_metrics", "write_trace", "write_trace_stream",
    "TraceRing", "BurnWindow", "FlightRecorder", "SloMonitor",
    "allocator_state",
    "REGISTRY", "counter", "enabled", "gauge", "histogram",
    "prometheus_text", "snapshot",
    "TRACER", "instant", "span",
]
