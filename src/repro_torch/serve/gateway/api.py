"""The async front door: submit / stream / cancel over the engine loop (a
port of ``repro.serve.gateway.api``).

:class:`Gateway` owns one
:class:`~repro_torch.serve.session_pool.SessionPool` plus the preemption
policy and exposes two faces over the same deterministic core:

  * a **sync** face (``submit``/``tick``/``result``/``cancel``) that
    tests drive tick by tick in the pool's virtual time
    (``decode_steps``);
  * an **asyncio** face (``asubmit``/``stream``/``aresult``/``serve``)
    for a live process: ``serve()`` runs the tick loop cooperatively on
    the event loop, parking on an event when idle, and ``stream()``
    yields each request's new tokens as the bank commits them.  A tick's
    compute runs in a worker thread (``asyncio.to_thread``), so the event
    loop stays responsive; delivery (queue and event signalling) happens
    back on the event loop, since asyncio primitives are not
    thread-safe, and only the serve loop's one in-flight thread ever
    calls ``pool.step``.  ``serve(http_port=...)`` mounts the HTTP/SSE
    wire front (:class:`~repro_torch.serve.http.HttpFrontend`) around
    the loop.

Per-request knobs ride on :class:`Request`: a GenConfig override
(sampling params realized per pool row), a token budget, and an optional
``deadline_steps`` SLO graded in virtual decode-step time.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
from typing import Any, AsyncIterator

import numpy as np

from repro_torch.obs import metrics as obs_metrics

from ..engine import GenConfig
from .loop import EngineLoop, TickReport
from .preempt import PreemptConfig, Preemptor

# registry-backed gateway accounting (one label gw="<id>" per instance);
# the legacy attributes below are series_property views over these
_GW_IDS = itertools.count()
_GW_FAMILIES = {
    "slo_met_count": obs_metrics.counter(
        "repro_gateway_slo_met_total",
        "finished requests inside their deadline", ("gw",)),
    "slo_missed_count": obs_metrics.counter(
        "repro_gateway_slo_missed_total",
        "finished requests past their deadline", ("gw",)),
    "requests_total": obs_metrics.counter(
        "repro_gateway_requests_total", "requests submitted", ("gw",)),
}


@dataclasses.dataclass
class Request:
    """One request's lifecycle record (all times in decode steps)."""
    rid: int
    prompt: np.ndarray
    gen: GenConfig
    budget: int
    deadline_steps: int | None
    arrival_step: int
    sid: int = -1
    tokens: np.ndarray | None = None   # prompt + generated, set when done
    first_admit_step: int = -1         # prefill token time (TTFT anchor)
    finish_step: int = -1
    parks: int = 0                     # times preempted
    cancelled: bool = False
    _sent: int = 0                     # stream cursor into tokens
    _stream: Any = None                # asyncio.Queue while streaming
    _done_ev: Any = None               # asyncio.Event for aresult waiters

    @property
    def done(self) -> bool:
        return self.tokens is not None

    @property
    def latency_steps(self) -> int:
        return self.finish_step - self.arrival_step

    @property
    def ttft_steps(self) -> int:
        """Steps from arrival to the first generated token (admission
        emits it via prefill)."""
        return self.first_admit_step - self.arrival_step

    @property
    def slo_met(self) -> bool | None:
        if self.deadline_steps is None or not self.done:
            return None
        return self.latency_steps <= self.deadline_steps


class Gateway:
    """Traffic front door over one Engine: batched admission, LRU
    preemption, per-request sampling params/deadlines, streaming.  The
    pool's token banks follow the engine's ``cpm_backend`` unless
    ``bank_backend`` names one."""

    slo_met_count = obs_metrics.series_property("slo_met_count")
    slo_missed_count = obs_metrics.series_property("slo_missed_count")

    def __init__(self, engine, slots: int = 8, n_banks: int = 1,
                 chunk: int = 1, gen: GenConfig | None = None,
                 admit_batching: bool = True,
                 preempt: bool | PreemptConfig = True,
                 bank_backend: str | None = None, rng=None,
                 page_size: int | None = None,
                 pages_per_bank: int | None = None,
                 slo_monitor=None):
        self.gen = gen if gen is not None else GenConfig()
        self.pool = engine.session_pool(
            slots=slots, n_banks=n_banks, gen=self.gen, chunk=chunk,
            bank_backend=bank_backend, rng=rng,
            admit_batching=admit_batching, page_size=page_size,
            pages_per_bank=pages_per_bank)
        if preempt:
            cfg = preempt if isinstance(preempt, PreemptConfig) else None
            self.preemptor: Preemptor | None = Preemptor(self.pool, cfg)
        else:
            self.preemptor = None
        self.loop = EngineLoop(self.pool, self.preemptor)
        self._requests: dict[int, Request] = {}
        self._by_sid: dict[int, Request] = {}
        self._streaming: set[int] = set()
        self._next_rid = 0
        label = str(next(_GW_IDS))
        self._obs_series = {k: fam.labels(gw=label)
                            for k, fam in _GW_FAMILIES.items()}
        # optional obs.slo.SloMonitor: every deadline grade feeds its
        # burn-rate windows (a host-side deque append); on a multi-window
        # burn it fires its flight recorder
        self.slo_monitor = slo_monitor
        self.http = None               # HttpFrontend while serve(http_port=)
        self.last_report: TickReport | None = None
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._tick_lock = asyncio.Lock()   # serve()'s single-writer gate
        self._stopping = False

    @property
    def now(self) -> int:
        """Virtual time: the pool's decode-step counter."""
        return self.pool.decode_steps

    # -- sync core -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int | None = None,
               gen: GenConfig | None = None,
               deadline_steps: int | None = None) -> int:
        """Queue a request; returns its rid.  Validation (empty prompt,
        non-positive budget, overlong request) raises here, before the
        request exists."""
        sid = self.pool.submit(prompt, max_new_tokens, gen=gen)
        sess = self.pool.table.get(sid)
        req = Request(rid=self._next_rid,
                      prompt=self.pool.peek_tokens(sid),  # host copy
                      gen=gen if gen is not None else self.gen,
                      budget=sess.budget, deadline_steps=deadline_steps,
                      arrival_step=self.now, sid=sid)
        self._next_rid += 1
        self._obs_series["requests_total"].inc()
        self._requests[req.rid] = req
        self._by_sid[sid] = req
        if self._wake is not None:
            self._wake.set()
        return req.rid

    def request(self, rid: int) -> Request:
        return self._requests[rid]

    def tick(self) -> TickReport:
        """One heartbeat (preempt -> step -> collect) plus delivery:
        finished requests get their tokens/SLO grade, attached streams
        get their new tokens.  Returns the
        :class:`~repro_torch.serve.gateway.loop.TickReport`."""
        report = self.loop.tick()
        self.last_report = report
        self._publish()
        return report

    def result(self, rid: int) -> np.ndarray:
        """Drive ticks until ``rid`` finishes; returns prompt + generated."""
        req = self._requests[rid]
        while not req.done:
            self.tick()
        return req.tokens

    def cancel(self, rid: int) -> np.ndarray:
        """Abort a request in any phase; returns prompt + whatever it
        generated.  Graded against its deadline like a normal finish."""
        req = self._requests[rid]
        if req.done:
            return req.tokens
        toks = self.pool.cancel(req.sid)
        self.loop._finished.update(
            self.pool.table.collect_finished_sessions())
        sess = self.loop._finished.pop(req.sid, None)
        req.cancelled = True
        if sess is not None:
            req.first_admit_step = sess.first_admit_step
            req.parks = sess.parks
        self._finish(req, np.asarray(toks))
        return req.tokens

    def collect_delivered(self) -> list[Request]:
        """Pop every done Request (records stay with the caller; gateway
        memory stays bounded under a continuous stream)."""
        done = [r for r in self._requests.values() if r.done]
        for r in done:
            del self._requests[r.rid]
        return done

    def stats(self) -> dict:
        st = self.pool.stats()
        st.update({
            "ticks": self.loop.ticks,
            "requests": self._next_rid,
            "completed": sum(1 for r in self._requests.values() if r.done),
            "slo_met": self.slo_met_count,
            "slo_missed": self.slo_missed_count,
            "preempt_denied": (self.preemptor.denied
                               if self.preemptor else 0),
        })
        return st

    def _finish(self, req: Request, tokens: np.ndarray) -> None:
        req.tokens = tokens
        req.finish_step = self.now
        self._by_sid.pop(req.sid, None)
        if req.slo_met is True:
            self.slo_met_count += 1
        elif req.slo_met is False:
            self.slo_missed_count += 1
        if self.slo_monitor is not None and req.slo_met is not None:
            self.slo_monitor.record(req.slo_met, self.now)
        if req._done_ev is not None:
            req._done_ev.set()
        self._push_stream(req, final=True)

    def _publish(self) -> None:
        for sid, sess in self.loop.take_finished().items():
            req = self._by_sid.get(sid)
            if req is None:
                continue                   # cancelled out-of-band
            req.first_admit_step = sess.first_admit_step
            req.parks = sess.parks
            self._finish(req, np.asarray(sess.tokens))
        for rid in list(self._streaming):
            req = self._requests.get(rid)
            if req is None or req.done:
                continue
            self._push_stream(req, final=False)

    def _push_stream(self, req: Request, final: bool) -> None:
        if req._stream is None:
            return
        toks = req.tokens if final else self.pool.peek_tokens(req.sid)
        if len(toks) > req._sent:
            req._stream.put_nowait(np.asarray(toks[req._sent:]))
            req._sent = len(toks)
        if final:
            req._stream.put_nowait(None)
            self._streaming.discard(req.rid)

    # -- asyncio face --------------------------------------------------------
    def _ensure_wake(self) -> asyncio.Event:
        if self._wake is None:
            self._wake = asyncio.Event()
        return self._wake

    async def asubmit(self, prompt, max_new_tokens: int | None = None,
                      gen: GenConfig | None = None,
                      deadline_steps: int | None = None) -> int:
        rid = self.submit(prompt, max_new_tokens, gen=gen,
                          deadline_steps=deadline_steps)
        self._ensure_wake().set()
        return rid

    async def aresult(self, rid: int) -> np.ndarray:
        """Await a request's completion (serve() must be running)."""
        req = self._requests[rid]
        if req.done:
            return req.tokens
        if req._done_ev is None:
            req._done_ev = asyncio.Event()
        await req._done_ev.wait()
        return req.tokens

    async def acancel(self, rid: int) -> np.ndarray:
        """Cancel from the event loop while ``serve()`` is running.  The
        pool is single-writer: a bare ``cancel`` racing the tick thread
        could free a slot the in-flight ``pool.step`` then writes back as
        live.  This face takes the serve loop's tick lock, so the cancel
        lands strictly between heartbeats (the HTTP frontend uses it for
        client disconnects)."""
        async with self._tick_lock:
            return self.cancel(rid)

    async def stream(self, rid: int) -> AsyncIterator[np.ndarray]:
        """Async iterator of ``rid``'s NEW tokens (beyond the prompt) as
        the banks commit them; ends at finish or cancel."""
        req = self._requests[rid]
        req._sent = len(req.prompt)
        if req.done:
            if len(req.tokens) > req._sent:
                yield np.asarray(req.tokens[req._sent:])
            return
        req._stream = asyncio.Queue()
        self._streaming.add(rid)
        while True:
            chunk = await req._stream.get()
            if chunk is None:
                return
            yield chunk

    async def serve(self, idle_wait: float = 0.05,
                    http_port: int | None = None,
                    http_host: str = "127.0.0.1", **http_kw) -> None:
        """The continuous loop: tick while work is pending, park on the
        wake event (set by ``asubmit``) when idle.  The tick's compute
        half (``EngineLoop.tick``) runs in a worker thread; the delivery
        half (``_publish``) runs on the event loop.

        ``http_port`` mounts the wire front for the duration of the loop:
        an :class:`~repro_torch.serve.http.HttpFrontend` (SSE token
        streams on ``POST /v1/generate``, ``GET /metrics``, live stats,
        the chunked trace export) bound to ``http_host:http_port`` (port
        0 picks a free port: read it back from ``gateway.http.port``).
        Other keyword arguments go to the frontend (ring capacity,
        keep-alive period, detokenizer, recorder directory)."""
        wake = self._ensure_wake()
        self.http = None
        if http_port is not None:
            from ..http import HttpFrontend
            self.http = HttpFrontend(self, host=http_host, port=http_port,
                                     **http_kw)
            await self.http.start()
        try:
            while not self._stopping:
                if self.loop.pending():
                    async with self._tick_lock:
                        self.last_report = await asyncio.to_thread(
                            self.loop.tick)
                        self._publish()
                else:
                    wake.clear()
                    try:
                        await asyncio.wait_for(wake.wait(),
                                               timeout=idle_wait)
                    except asyncio.TimeoutError:
                        pass
        finally:
            if self.http is not None:
                await self.http.stop()

    async def start(self, **serve_kw) -> None:
        """Run :meth:`serve` as a background task; kwargs pass through
        (``start(http_port=0)`` mounts the wire front)."""
        if self._task is None:
            self._stopping = False
            self._task = asyncio.ensure_future(self.serve(**serve_kw))

    async def stop(self) -> None:
        self._stopping = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
