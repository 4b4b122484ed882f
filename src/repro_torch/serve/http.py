"""The wire protocol: a stdlib-asyncio HTTP/1.1 front over the Gateway (a
port of ``repro.serve.http``: its HTTP parsing, error statuses and SSE
framing are the JAX package's, byte for byte).

:class:`HttpFrontend` mounts four read paths and one write path on the
gateway, all pure stdlib (``asyncio.start_server`` and hand-rolled
HTTP/1.1):

  * ``POST /v1/generate`` — JSON request carrying the prompt, an
    optional per-request :class:`~repro_torch.serve.engine.GenConfig`
    override and ``deadline_steps`` SLO.  ``"stream": true`` (default)
    answers with an SSE stream riding :meth:`Gateway.stream` — each
    committed token chunk is one ``tokens`` event, so the wire emits
    exactly the chunks the in-process async face emits.  Keep-alive
    comment frames go out while a long prefill holds the first token
    back, and a client that disconnects mid-stream cancels its request
    through the gateway's ``acancel`` (the pool reclaims the pages).
  * ``GET /metrics`` — the port's process-global registry in Prometheus
    text exposition (:func:`repro_torch.obs.metrics.prometheus_text`).
  * ``GET /healthz`` / ``GET /v1/stats`` — liveness and the structured
    view: last :class:`TickReport`, pool stats, SLO monitor state,
    registry snapshot.
  * ``GET /debug/trace`` — the live trace ring streamed as chunked
    Chrome/Perfetto ``trace_event`` JSON via
    :func:`repro_torch.obs.export.iter_trace_chunks` — O(ring) memory no
    matter how long the server has been up.

The frontend does **no device work**: every handler reads host data
(registry cells, ring snapshots, request records), and the token payloads
are the host arrays ``Gateway.stream`` / ``aresult`` already hand out, so
mounting it changes no kernel launch of a decode chunk and adds no host
sync inside one.

Under a "model" axis longer than 1 the frontend refuses to mount
(``NotImplementedError``): every rank of a model group must tick on the
same submissions, and the wire takes them on one rank only, so the
others would wait forever.  Forwarding each tick's submissions and
cancels from model rank 0 to the others is ROADMAP Queue 1 item 5f.

The module also ships the minimal client half (``request``,
``sse_events``, :class:`SSEDecoder`) the tests and ``chip_smoke.py`` use
— incremental SSE parsing that is correct under arbitrary byte-chunk
splits, including mid-UTF-8.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Any, AsyncIterator, Callable

import numpy as np

from repro_torch.distributed import sharding
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.export import iter_trace_chunks
from repro_torch.obs.live import TraceRing
from repro_torch.obs.slo import FlightRecorder, SloMonitor

from .engine import GenConfig

_MAX_HEADER_LINE = 65536
_MAX_HEADERS = 100
_MAX_BODY = 8 << 20
_GEN_FIELDS = {f.name for f in dataclasses.fields(GenConfig)}

_HTTP_FAMILIES = {
    "http_requests": obs_metrics.counter(
        "repro_http_requests_total", "HTTP requests served",
        ("route", "code")),
    "http_sse_events": obs_metrics.counter(
        "repro_http_sse_events_total", "SSE frames written", ("kind",)),
    "http_disconnects": obs_metrics.counter(
        "repro_http_disconnects_total",
        "client disconnects mid-stream (request cancelled)", ()),
}

_STATUS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 413: "Payload Too Large",
           500: "Internal Server Error"}


def sse_event(event: str, data: Any) -> bytes:
    """One SSE frame: ``event:`` + JSON ``data:`` lines, blank-line
    terminated.  ``data`` is JSON-encoded (so embedded newlines are
    escaped and one ``data:`` line always suffices)."""
    payload = json.dumps(data, separators=(",", ":"), ensure_ascii=False)
    return f"event: {event}\ndata: {payload}\n\n".encode("utf-8")


class SSEDecoder:
    """Incremental SSE parser: feed raw body bytes in ANY split —
    mid-line, mid-frame, mid-UTF-8-sequence — and collect complete
    ``(event, data)`` frames.  Bytes are buffered and only decoded once
    a full frame (blank-line terminated) is present, so a multi-byte
    character split across transport chunks can never mis-decode."""

    def __init__(self):
        self._buf = b""
        self.comments: list[str] = []

    def feed(self, data: bytes) -> list[tuple[str, str]]:
        self._buf += data
        frames: list[tuple[str, str]] = []
        while True:
            # frame terminator: blank line (tolerate \r\n line endings)
            for sep in (b"\n\n", b"\r\n\r\n"):
                cut = self._buf.find(sep)
                if cut >= 0:
                    raw, self._buf = (self._buf[:cut],
                                      self._buf[cut + len(sep):])
                    break
            else:
                return frames
            event, datas = "message", []
            for line in raw.decode("utf-8").splitlines():
                if line.startswith(":"):
                    self.comments.append(line[1:].strip())
                elif line.startswith("event:"):
                    event = line[len("event:"):].strip()
                elif line.startswith("data:"):
                    datas.append(line[len("data:"):].lstrip())
            if datas:
                frames.append((event, "\n".join(datas)))


class HttpFrontend:
    """The HTTP/SSE wire front over one :class:`Gateway`.

    The frontend only serves; the gateway's tick loop must be running
    (``await gateway.start()``, or use ``gateway.serve(http_port=...)``
    which mounts and unmounts the frontend around the loop).  ``port=0``
    binds an ephemeral port, read back from :attr:`port` after
    :meth:`start`.
    """

    def __init__(self, gateway, host: str = "127.0.0.1", port: int = 0, *,
                 detokenize: Callable[[list[int]], str] | None = None,
                 ring_capacity: int = 4096,
                 tracer_limit: int | None = 65536,
                 keepalive_s: float = 5.0,
                 slo_monitor: SloMonitor | None = None,
                 recorder_dir: str = "artifacts/flightrec",
                 flight_last_n: int = 256):
        m = sharding.model_size()
        if m > 1:
            raise NotImplementedError(
                f"the HTTP frontend under a model axis of size {m}: every "
                f"model rank must tick on the same submissions, and "
                f"forwarding them from model rank 0 is ROADMAP Queue 1 "
                f"item 5f")
        self.gateway = gateway
        self.host = host
        self.port = port
        self.detokenize = detokenize
        self.keepalive_s = keepalive_s
        self.ring = TraceRing(ring_capacity)
        self._tracer_limit = tracer_limit
        self._saved_limit: int | None = None
        self._server: asyncio.AbstractServer | None = None
        # wire the SLO plane: grades flow from Gateway._finish into the
        # monitor; a multi-window burn dumps the flight recorder (last-N
        # ring spans + registry + allocator page table, atomic write)
        if slo_monitor is not None:
            self.slo_monitor = slo_monitor
        elif getattr(gateway, "slo_monitor", None) is not None:
            self.slo_monitor = gateway.slo_monitor
        else:
            self.recorder = FlightRecorder(recorder_dir, ring=self.ring,
                                           pool=gateway.pool,
                                           last_n=flight_last_n)
            self.slo_monitor = SloMonitor(recorder=self.recorder)
        gateway.slo_monitor = self.slo_monitor

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> "HttpFrontend":
        self.ring.attach(obs_tracing.TRACER)
        if self._tracer_limit is not None:
            # bound the process-global tracer too: a week of traffic must
            # not grow host memory (the ring serves the live exports)
            self._saved_limit = obs_tracing.TRACER.max_events
            obs_tracing.TRACER.set_limit(self._tracer_limit)
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.ring.detach()
        if self._tracer_limit is not None:
            obs_tracing.TRACER.set_limit(self._saved_limit)

    # -- request plumbing ---------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        route = "?"
        try:
            try:
                method, path, headers = await self._read_head(reader)
            except (ValueError, asyncio.IncompleteReadError,
                    ConnectionResetError):
                return
            route = path.split("?", 1)[0]
            body = b""
            length = int(headers.get("content-length", "0") or "0")
            if length > _MAX_BODY:
                await self._respond(writer, 413, {"error": "body too large"})
                return
            if length:
                body = await reader.readexactly(length)
            await self._route(method, route, body, reader, writer)
        except (ConnectionResetError, BrokenPipeError):
            pass
        except Exception as e:                      # noqa: BLE001
            try:
                await self._respond(writer, 500, {"error": repr(e)},
                                    route=route)
            except (ConnectionResetError, BrokenPipeError):
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _read_head(self, reader):
        line = await reader.readline()
        if not line:
            raise ValueError("empty request")
        if len(line) > _MAX_HEADER_LINE:
            raise ValueError("request line too long")
        parts = line.decode("latin-1").split()
        if len(parts) < 3:
            raise ValueError(f"malformed request line {line!r}")
        method, path = parts[0].upper(), parts[1]
        headers: dict[str, str] = {}
        for _ in range(_MAX_HEADERS):
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            if len(line) > _MAX_HEADER_LINE:
                raise ValueError("header line too long")
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        else:
            raise ValueError("too many headers")
        return method, path, headers

    async def _route(self, method, route, body, reader, writer):
        gw = self.gateway
        if route == "/healthz" and method == "GET":
            await self._respond(writer, 200, {
                "ok": True, "step": gw.now, "ticks": gw.loop.ticks,
                "pending": gw.loop.pending()}, route=route)
        elif route == "/metrics" and method == "GET":
            await self._respond(
                writer, 200, obs_metrics.prometheus_text().encode("utf-8"),
                content_type="text/plain; version=0.0.4; charset=utf-8",
                route=route)
        elif route == "/v1/stats" and method == "GET":
            rep = gw.last_report
            await self._respond(writer, 200, {
                "tick": rep.asdict() if rep is not None else None,
                "stats": gw.stats(),
                "slo": (self.slo_monitor.state()
                        if self.slo_monitor is not None else None),
                "ring": self.ring.stats(),
                "metrics": obs_metrics.snapshot()}, route=route)
        elif route == "/debug/trace" and method == "GET":
            await self._stream_trace(writer, route)
        elif route == "/v1/generate":
            if method != "POST":
                await self._respond(writer, 405, {"error": "POST only"},
                                    route=route)
            else:
                await self._generate(body, reader, writer, route)
        elif route in ("/healthz", "/metrics", "/v1/stats", "/debug/trace"):
            await self._respond(writer, 405, {"error": "GET only"},
                                route=route)
        else:
            await self._respond(writer, 404, {"error": f"no route {route}"},
                                route=route)

    # -- responses ----------------------------------------------------------
    def _count(self, route: str, code: int) -> None:
        _HTTP_FAMILIES["http_requests"].inc(route=route, code=str(code))

    async def _respond(self, writer, code: int, body,
                       content_type: str = "application/json",
                       route: str | None = None) -> None:
        if isinstance(body, (dict, list)):
            body = json.dumps(body, indent=1, default=_jsonable).encode()
        head = (f"HTTP/1.1 {code} {_STATUS.get(code, '?')}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n")
        writer.write(head.encode("latin-1") + body)
        await writer.drain()
        if route is not None:
            self._count(route, code)

    async def _start_chunked(self, writer, content_type: str) -> None:
        head = ("HTTP/1.1 200 OK\r\n"
                f"Content-Type: {content_type}\r\n"
                "Cache-Control: no-store\r\n"
                "Transfer-Encoding: chunked\r\n"
                "Connection: close\r\n\r\n")
        writer.write(head.encode("latin-1"))
        await writer.drain()

    async def _chunk(self, writer, data: bytes) -> None:
        if not data:
            return
        writer.write(f"{len(data):x}\r\n".encode("latin-1") + data + b"\r\n")
        await writer.drain()

    async def _end_chunked(self, writer) -> None:
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    async def _stream_trace(self, writer, route: str) -> None:
        await self._start_chunked(writer, "application/json")
        for chunk in iter_trace_chunks(self.ring):
            await self._chunk(writer, chunk.encode("utf-8"))
        await self._end_chunked(writer)
        self._count(route, 200)

    # -- /v1/generate -------------------------------------------------------
    def _parse_generate(self, body: bytes) -> dict:
        try:
            req = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise ValueError(f"bad JSON body: {e}")
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        prompt = req.get("prompt")
        if not isinstance(prompt, list) or \
                not all(isinstance(t, int) for t in prompt):
            raise ValueError('"prompt" must be a list of token ids')
        gen_kw = req.get("gen", {})
        if not isinstance(gen_kw, dict):
            raise ValueError('"gen" must be an object')
        unknown = set(gen_kw) - _GEN_FIELDS
        if unknown:
            raise ValueError(f"unknown gen fields {sorted(unknown)}; "
                             f"have {sorted(_GEN_FIELDS)}")
        gen = (dataclasses.replace(self.gateway.gen, **gen_kw)
               if gen_kw else None)
        return {
            "prompt": np.asarray(prompt, np.int32),
            "max_new_tokens": req.get("max_new_tokens"),
            "gen": gen,
            "deadline_steps": req.get("deadline_steps"),
            "stream": bool(req.get("stream", True)),
        }

    def _token_payload(self, rid: int, tokens: np.ndarray) -> dict:
        toks = [int(t) for t in np.asarray(tokens)]
        payload = {"rid": rid, "tokens": toks}
        if self.detokenize is not None:
            payload["text"] = self.detokenize(toks)
        return payload

    def _done_payload(self, rid: int) -> dict:
        req = self.gateway.request(rid)
        return {"rid": rid, "n_tokens": int(len(req.tokens)),
                "ttft_steps": req.ttft_steps,
                "latency_steps": req.latency_steps,
                "slo_met": req.slo_met, "parks": req.parks,
                "cancelled": req.cancelled}

    async def _generate(self, body, reader, writer, route) -> None:
        try:
            spec = self._parse_generate(body)
        except ValueError as e:
            await self._respond(writer, 400, {"error": str(e)}, route=route)
            return
        try:
            rid = await self.gateway.asubmit(
                spec["prompt"], spec["max_new_tokens"], gen=spec["gen"],
                deadline_steps=spec["deadline_steps"])
        except ValueError as e:                 # pool-level validation
            await self._respond(writer, 400, {"error": str(e)}, route=route)
            return
        if not spec["stream"]:
            tokens = await self.gateway.aresult(rid)
            await self._respond(writer, 200, dict(
                self._done_payload(rid),
                **self._token_payload(rid, tokens)), route=route)
            return
        await self._sse_stream(rid, reader, writer, route)

    async def _sse_stream(self, rid, reader, writer, route) -> None:
        """The SSE body: one ``tokens`` event per committed chunk —
        chunks arrive exactly as ``Gateway.stream`` yields them, so the
        wire is byte-identical in token content to the in-process face.
        A keep-alive comment goes out every ``keepalive_s`` of silence
        (long prefills), and EOF on the request socket (client gone)
        cancels the request through the gateway."""
        gw = self.gateway
        await self._start_chunked(writer, "text/event-stream")
        agen = gw.stream(rid)
        next_t = asyncio.ensure_future(agen.__anext__())
        eof_t = asyncio.ensure_future(reader.read(1))
        disconnected = False
        try:
            await self._chunk(writer, sse_event("start", {"rid": rid}))
            _HTTP_FAMILIES["http_sse_events"].inc(kind="start")
            while True:
                done, _ = await asyncio.wait(
                    {next_t, eof_t}, timeout=self.keepalive_s,
                    return_when=asyncio.FIRST_COMPLETED)
                if eof_t in done:              # client closed its end
                    disconnected = True
                    break
                if not done:                   # silence: long prefill
                    await self._chunk(writer, b": keep-alive\n\n")
                    _HTTP_FAMILIES["http_sse_events"].inc(kind="keepalive")
                    continue
                try:
                    tokens = next_t.result()
                except StopAsyncIteration:
                    break
                await self._chunk(writer, sse_event(
                    "tokens", self._token_payload(rid, tokens)))
                _HTTP_FAMILIES["http_sse_events"].inc(kind="tokens")
                next_t = asyncio.ensure_future(agen.__anext__())
            if not disconnected:
                await self._chunk(writer, sse_event(
                    "done", self._done_payload(rid)))
                _HTTP_FAMILIES["http_sse_events"].inc(kind="done")
                await self._end_chunked(writer)
                self._count(route, 200)
        except (ConnectionResetError, BrokenPipeError):
            disconnected = True
        finally:
            next_t.cancel()
            eof_t.cancel()
            if disconnected and not gw.request(rid).done:
                # acancel, not cancel: the serve loop's tick thread may be
                # mid-step, and a bare cancel would race its write-back
                await gw.acancel(rid)
                _HTTP_FAMILIES["http_disconnects"].inc()
                self._count(route, 499)        # nginx-style client abort


def _jsonable(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj)}")


# -- minimal async client (tests, chip_smoke.py) ----------------------------

async def _read_response_head(reader):
    status_line = await reader.readline()
    parts = status_line.decode("latin-1").split()
    status = int(parts[1])
    headers: dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


async def _iter_body(reader, headers) -> AsyncIterator[bytes]:
    if headers.get("transfer-encoding", "").lower() == "chunked":
        while True:
            size_line = await reader.readline()
            size = int(size_line.strip().split(b";")[0], 16)
            if size == 0:
                await reader.readline()        # trailing CRLF
                return
            data = await reader.readexactly(size)
            await reader.readexactly(2)        # chunk CRLF
            yield data
    elif "content-length" in headers:
        yield await reader.readexactly(int(headers["content-length"]))
    else:
        while True:
            data = await reader.read(65536)
            if not data:
                return
            yield data


def _request_bytes(method: str, path: str, host: str,
                   body: bytes | None) -> bytes:
    head = (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
            f"Accept: */*\r\n")
    if body is not None:
        head += (f"Content-Type: application/json\r\n"
                 f"Content-Length: {len(body)}\r\n")
    return (head + "Connection: close\r\n\r\n").encode("latin-1") + \
        (body or b"")


async def request(host: str, port: int, method: str, path: str,
                  body: dict | bytes | None = None):
    """One full request/response; returns ``(status, headers, body)``
    with chunked bodies reassembled."""
    if isinstance(body, dict):
        body = json.dumps(body).encode("utf-8")
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(_request_bytes(method, path, host, body))
        await writer.drain()
        status, headers = await _read_response_head(reader)
        chunks = [c async for c in _iter_body(reader, headers)]
        return status, headers, b"".join(chunks)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass


async def sse_events(host: str, port: int, path: str, body: dict,
                     decoder: SSEDecoder | None = None):
    """POST ``body`` and yield decoded ``(event, data_json_str)`` SSE
    frames until the server ends the stream."""
    payload = json.dumps(body).encode("utf-8")
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(_request_bytes("POST", path, host, payload))
        await writer.drain()
        status, headers = await _read_response_head(reader)
        if status != 200:
            chunks = [c async for c in _iter_body(reader, headers)]
            raise RuntimeError(
                f"HTTP {status}: {b''.join(chunks).decode()}")
        dec = decoder if decoder is not None else SSEDecoder()
        async for raw in _iter_body(reader, headers):
            for frame in dec.feed(raw):
                yield frame
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
