"""Exporters: Chrome/Perfetto ``trace_event`` JSON + snapshot files (a
port of ``repro.obs.export``; the output is byte for byte the JAX
package's for the same events).

:func:`chrome_trace` renders a
:class:`~repro_torch.obs.tracing.Tracer` buffer in the `Trace Event Format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
consumed by ``chrome://tracing`` and https://ui.perfetto.dev — open the
written ``trace.json`` there and every serving-layer span (gateway tick,
admission, prefill, decode chunk, park/restore) appears on its thread's
track, with the virtual decode-step clock riding in each event's ``args``
(``vstep``/``vdur``) and as a counter track.

Timestamps are microseconds relative to the first recorded event (the
format wants monotonic us; absolute epoch adds nothing to a single
process).  :func:`validate_chrome_trace` is the shared checker the tests
and ``chip_smoke.py`` run over an exported trace — structural validity
plus per-name span counts.
"""

from __future__ import annotations

import json
from typing import Any, Iterator

from .metrics import REGISTRY
from .tracing import TRACER, SpanEvent, Tracer

_PID = 1


def _resolve_events(source) -> list[SpanEvent]:
    """Accept a Tracer, anything with ``.events()`` (a ``live.TraceRing``),
    an iterable of SpanEvents, or None (the global tracer) — always
    returning one stable snapshot list."""
    if source is None:
        source = TRACER
    if isinstance(source, Tracer):
        return source.spans()
    events = getattr(source, "events", None)
    if callable(events):
        return list(events())
    return list(source)


def _meta_events(events: list[SpanEvent], process_name: str):
    """Metadata records + the tid remap shared by both renderers."""
    out: list[dict[str, Any]] = [{
        "ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    tids = sorted({e.tid for e in events})
    tid_map = {t: i + 1 for i, t in enumerate(tids)}
    for t, i in tid_map.items():
        out.append({"ph": "M", "pid": _PID, "tid": i,
                    "name": "thread_name",
                    "args": {"name": f"serve-thread-{i}"}})
    return out, tid_map


def _event_dict(e: SpanEvent, t0: float, tid_map: dict) -> dict:
    ts_us = (e.ts - t0) * 1e6
    args = dict(e.args or {})
    if e.vstep is not None:
        args["vstep"] = e.vstep
    if e.vdur is not None:
        args["vdur"] = e.vdur
    if e.cat.startswith("__counter__."):
        return {"ph": "C", "pid": _PID, "tid": tid_map[e.tid],
                "name": e.name, "cat": e.cat.split(".", 1)[1],
                "ts": ts_us, "args": args}
    if e.dur is None:
        return {"ph": "i", "s": "t", "pid": _PID,
                "tid": tid_map[e.tid], "name": e.name,
                "cat": e.cat, "ts": ts_us, "args": args}
    return {"ph": "X", "pid": _PID, "tid": tid_map[e.tid],
            "name": e.name, "cat": e.cat, "ts": ts_us,
            "dur": e.dur * 1e6, "args": args}


def _indent2(rendered: str) -> str:
    """Re-nest a depth-0 ``indent=1`` rendering to array-item depth, so
    streamed chunks concatenate byte-identically to the one-shot
    ``json.dumps(chrome_trace(...), indent=1)``."""
    return "\n".join("  " + ln for ln in rendered.splitlines())


def chrome_trace(tracer: Tracer | None = None,
                 process_name: str = "repro.serve") -> dict:
    """The tracer buffer as a ``{"traceEvents": [...]}`` JSON object."""
    events = _resolve_events(tracer)
    t0 = min((e.ts for e in events), default=0.0)
    out, tid_map = _meta_events(events, process_name)
    out.extend(_event_dict(e, t0, tid_map) for e in events)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def iter_trace_chunks(source=None, process_name: str = "repro.serve",
                      events_per_chunk: int = 256) -> Iterator[str]:
    """Stream a trace as text chunks that CONCATENATE to the exact JSON
    ``chrome_trace`` would produce — the live exporter behind
    ``GET /debug/trace`` and :func:`write_trace_stream`.

    ``source`` is a Tracer, a ``live.TraceRing``, an event iterable or
    None (the global tracer); the events are snapshotted once, then
    serialized ``events_per_chunk`` at a time, so peak memory is one
    chunk's text plus the (bounded, when ringed) snapshot — never the
    whole rendered JSON body of a week-long run."""
    events = _resolve_events(source)
    t0 = min((e.ts for e in events), default=0.0)
    meta, tid_map = _meta_events(events, process_name)
    head = json.dumps({"traceEvents": meta, "displayTimeUnit": "ms"},
                      indent=1)
    cut = head.rindex("]")                  # re-open the events array,
    while cut > 0 and head[cut - 1] in " \n":
        cut -= 1                            # splitting right after the
    head, tail = head[:cut], head[cut:]     # last metadata record
    yield head
    for i in range(0, len(events), events_per_chunk):
        batch = events[i:i + events_per_chunk]
        body = ",\n".join(_indent2(json.dumps(_event_dict(e, t0, tid_map),
                                              indent=1))
                          for e in batch)
        yield ",\n" + body
    yield tail


def write_trace_stream(path: str, source=None,
                       process_name: str = "repro.serve",
                       events_per_chunk: int = 256) -> int:
    """Chunked counterpart of :func:`write_trace` for live use: writes
    the stream chunk-by-chunk and returns the event count — the whole
    JSON text never exists in memory at once."""
    events = _resolve_events(source)
    with open(path, "w") as f:
        for chunk in iter_trace_chunks(events, process_name,
                                       events_per_chunk):
            f.write(chunk)
    return len(events)


def write_trace(path: str, tracer: Tracer | None = None) -> dict:
    """Write ``chrome_trace`` JSON to ``path``; returns the object."""
    obj = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return obj


def write_metrics(path: str, fmt: str = "prom") -> None:
    """Write the global registry snapshot — Prometheus text exposition
    (``fmt="prom"``) or the JSON snapshot (``fmt="json"``)."""
    if fmt == "prom":
        with open(path, "w") as f:
            f.write(REGISTRY.prometheus_text())
    elif fmt == "json":
        with open(path, "w") as f:
            json.dump(REGISTRY.snapshot(), f, indent=1, sort_keys=True)
    else:
        raise ValueError(f"unknown metrics format {fmt!r}")


def validate_chrome_trace(obj: dict) -> dict[str, int]:
    """Structural validation of a trace_event object; returns per-name
    event counts (what a check of "≥1 span per layer" grades against).

    Raises ``ValueError`` on malformed events — missing required keys,
    negative durations, unknown phase types."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a trace_event object: no traceEvents key")
    counts: dict[str, int] = {}
    for e in obj["traceEvents"]:
        ph = e.get("ph")
        if ph not in ("X", "i", "I", "M", "C", "B", "E"):
            raise ValueError(f"unknown event phase {ph!r}: {e}")
        if "name" not in e or "pid" not in e:
            raise ValueError(f"event missing name/pid: {e}")
        if ph == "X":
            if "ts" not in e or "dur" not in e:
                raise ValueError(f"complete event missing ts/dur: {e}")
            if e["dur"] < 0:
                raise ValueError(f"negative duration: {e}")
        if ph != "M":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts
