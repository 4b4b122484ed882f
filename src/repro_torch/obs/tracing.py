"""Nestable spans over the serving loop, in wall-clock and virtual time
(a port of ``repro.obs.tracing``).

A span times one host-side region (gateway tick, admission bucket,
prefill, decode chunk, park, restore) with ``time.perf_counter`` and,
when the caller passes ``vclock`` (a closure over the pool's
``decode_steps`` host counter), the virtual decode-step clock at entry
and exit.  Recording is list appends and clock reads between device
calls: a span never synchronizes the device, so a span around an
asynchronous CUDA launch measures its dispatch.  With ``REPRO_OBS=0``
``span`` yields a shared null handle and records nothing.

The buffer is unbounded by default (a post-hoc ``write_trace`` wants
everything); :meth:`Tracer.set_limit` bounds it for a live server, and
**sinks** (``add_sink``, e.g. a ``live.TraceRing``) receive every
completed event on the recording thread, after the span closed.
``export`` renders the events as Chrome / Perfetto ``trace_event`` JSON.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable

from .metrics import enabled


@dataclasses.dataclass
class SpanEvent:
    """One finished span (or instant, ``dur is None``)."""
    name: str
    cat: str
    ts: float                      # perf_counter seconds at entry
    dur: float | None              # wall seconds (None for instants)
    tid: int
    depth: int                     # nesting depth within its thread
    vstep: int | None = None       # virtual decode-step clock at entry
    vdur: int | None = None        # virtual steps elapsed inside the span
    args: dict[str, Any] | None = None


class _SpanHandle:
    """Live span: mutate ``args`` inside the ``with`` to annotate it."""

    __slots__ = ("args",)

    def __init__(self, args: dict[str, Any]):
        self.args = args


_NULL_HANDLE = _SpanHandle({})


class Tracer:
    """The event buffer (a deque, ``max_events`` bounds it), the
    per-thread nesting depth and the sinks."""

    def __init__(self, max_events: int | None = None):
        self.events: collections.deque[SpanEvent] = \
            collections.deque(maxlen=max_events)
        self._sinks: list[Callable[[SpanEvent], None]] = []
        self._local = threading.local()
        self._lock = threading.Lock()

    @property
    def max_events(self) -> int | None:
        return self.events.maxlen

    def set_limit(self, max_events: int | None) -> None:
        """Bound (or unbound) the buffer in place, keeping the newest
        events; the HTTP frontend bounds the global tracer while it is
        mounted."""
        with self._lock:
            self.events = collections.deque(self.events, maxlen=max_events)

    def add_sink(self, sink: Callable[[SpanEvent], None]) -> None:
        """Register a per-event callback; it runs on the recording thread
        between device calls, so it must be O(1) host work."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[SpanEvent], None]) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def _emit(self, ev: SpanEvent) -> None:
        with self._lock:
            self.events.append(ev)
            sinks = list(self._sinks)
        for sink in sinks:
            sink(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "serve",
             vclock: Callable[[], int] | None = None,
             args: dict[str, Any] | None = None):
        """Record one nested region; ``vclock`` is read at entry and exit
        on the host."""
        if not enabled():
            yield _NULL_HANDLE
            return
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        handle = _SpanHandle(dict(args) if args else {})
        v0 = int(vclock()) if vclock is not None else None
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            dur = time.perf_counter() - t0
            v1 = int(vclock()) if vclock is not None else None
            self._local.depth = depth
            self._emit(SpanEvent(
                name=name, cat=cat, ts=t0, dur=dur,
                tid=threading.get_ident(), depth=depth, vstep=v0,
                vdur=(v1 - v0) if v0 is not None else None,
                args=handle.args or None))

    def instant(self, name: str, cat: str = "serve",
                vstep: int | None = None,
                args: dict[str, Any] | None = None) -> None:
        """Record a zero-duration marker (page grants, packed commits)."""
        if not enabled():
            return
        self._emit(SpanEvent(
            name=name, cat=cat, ts=time.perf_counter(), dur=None,
            tid=threading.get_ident(),
            depth=getattr(self._local, "depth", 0),
            vstep=int(vstep) if vstep is not None else None,
            args=dict(args) if args else None))

    def counter(self, name: str, value, cat: str = "serve") -> None:
        """Record a Chrome counter-track sample (rendered as ``ph: "C"``)."""
        if not enabled():
            return
        self._emit(SpanEvent(
            name=name, cat="__counter__." + cat, ts=time.perf_counter(),
            dur=None, tid=threading.get_ident(), depth=0,
            args={"value": value}))

    def spans(self, name: str | None = None) -> list[SpanEvent]:
        """Snapshot of recorded events, optionally filtered by name."""
        with self._lock:
            evs = list(self.events)
        return evs if name is None else [e for e in evs if e.name == name]

    def clear(self) -> None:
        with self._lock:
            self.events.clear()


#: the port's process-global tracer
TRACER = Tracer()


def span(name: str, cat: str = "serve",
         vclock: Callable[[], int] | None = None,
         args: dict[str, Any] | None = None):
    return TRACER.span(name, cat=cat, vclock=vclock, args=args)


def instant(name: str, cat: str = "serve", vstep: int | None = None,
            args: dict[str, Any] | None = None) -> None:
    TRACER.instant(name, cat=cat, vstep=vstep, args=args)
