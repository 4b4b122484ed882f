"""The live trace plane: a bounded ring of completed spans (a port of
``repro.obs.live``).

``write_trace`` renders the tracer's whole buffer at once — right for a
post-hoc artifact, wrong for a server that must stay up for weeks:
the buffer and the rendered JSON both grow without bound.  The live
plane inverts it:

  * a :class:`TraceRing` subscribes to the tracer as a **sink** and
    keeps only the newest ``capacity`` completed events (drops are
    counted, never silent);
  * ``export.iter_trace_chunks(ring)`` streams the ring as trace_event
    JSON chunks (``GET /debug/trace`` serves them with chunked
    transfer-encoding), so peak memory is one chunk plus the ring —
    O(capacity) regardless of run length;
  * the flight recorder (:mod:`repro_torch.obs.slo`) dumps the same ring
    on an SLO burn alert, so a post-mortem always has the last-N spans
    that led up to the miss burst.

Everything here is host-side list work on already-completed events: the
ring never runs inside a span, let alone inside a device call, so it adds
no device work and no host sync.
"""

from __future__ import annotations

import collections
import threading

from .tracing import SpanEvent, Tracer


class TraceRing:
    """Last-``capacity`` completed span events, fed by a tracer sink.

    Attach/detach is explicit so one process can run several rings at
    different depths (a deep one for ``/debug/trace``, a shallow one for
    the flight recorder) off the same tracer.
    """

    def __init__(self, capacity: int = 4096,
                 tracer: Tracer | None = None):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._dq: collections.deque[SpanEvent] = \
            collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0            # events pushed out of the ring so far
        self.total = 0              # events ever recorded into the ring
        self._tracer: Tracer | None = None
        if tracer is not None:
            self.attach(tracer)

    # -- sink protocol ------------------------------------------------------
    def __call__(self, ev: SpanEvent) -> None:
        with self._lock:
            if len(self._dq) == self.capacity:
                self.dropped += 1
            self._dq.append(ev)
            self.total += 1

    def attach(self, tracer: Tracer) -> "TraceRing":
        if self._tracer is not None:
            raise RuntimeError("ring already attached")
        tracer.add_sink(self)
        self._tracer = tracer
        return self

    def detach(self) -> None:
        if self._tracer is not None:
            self._tracer.remove_sink(self)
            self._tracer = None

    # -- snapshot surface (what the exporters consume) ----------------------
    def events(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._dq)

    def last(self, n: int) -> list[SpanEvent]:
        with self._lock:
            if n >= len(self._dq):
                return list(self._dq)
            return list(self._dq)[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity, "len": len(self._dq),
                    "total": self.total, "dropped": self.dropped}
