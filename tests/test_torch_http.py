"""``repro_torch.serve.http`` — the port's wire front — with
``tests/test_http.py``'s cases, and against the JAX package.

Held here, on the CPU:

  * SSE framing: ``sse_event`` byte for byte with JAX's, and the
    incremental decoder giving JAX's events at every split point of a
    stream with multibyte UTF-8 (and under one-byte feeds);
  * wire identity: on granite-8b's smoke config (JAX params from
    ``PRNGKey(0)`` carried across by ``models/convert.py``), the SSE
    tokens of a fixed batch equal the port's in-process
    ``Gateway.stream`` tokens bit for bit and with the same chunking,
    and both equal JAX's ``Gateway.stream`` tokens (JAX in-process);
  * the server's behaviour: keep-alive comments while no token comes, a
    client disconnect cancelling its request and freeing its slot and
    pages, the plain routes and every error status;
  * the frontend changes nothing under the decode chunk: one steady step
    with it mounted calls each row kernel's wrapper (``gather_rows``,
    ``fused_stream``, ``scatter_rows``) once per bank, and the chunk
    reads nothing back to the host;
  * ``serve(http_port=)`` mounts and unmounts it, leaving no sink on the
    port's tracer and its limit as it was.

Steadiness: every wait is on a condition polled every 10 ms with a
deadline of ``DEADLINE`` seconds, never a fixed sleep; every port is 0;
every frontend writes its flight records under ``tmp_path`` and is
stopped in ``finally``; counters are read as deltas.  The port's registry
and tracer are process global and ``tests/conftest.py`` resets only
``repro.obs``'s, so this module resets the port's own at its start.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Gateway as JGateway  # noqa: E402
from repro.serve import GenConfig as JGenConfig  # noqa: E402
from repro.serve import http as jwire  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import cpm_kernels  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.obs import (export, metrics, promparse,  # noqa: E402
                             tracing, validate_chrome_trace)
from repro_torch.serve import (Engine, Gateway, GenConfig,  # noqa: E402
                               HttpFrontend)
from repro_torch.serve import http as wire  # noqa: E402

CFG = get_config("granite-8b").smoke()
MAX_LEN = 64
#: seconds a test waits for a condition (polled every 10 ms)
DEADLINE = 60.0
_START = {}


@pytest.fixture(autouse=True, scope="module")
def _torch_obs_module_isolation():
    """The port's counterpart of conftest's ``_obs_module_isolation``:
    zero the port's registry in place, empty its tracer, and when the
    module ends restore the tracer's limit and detach any ring a failed
    test left mounted."""
    _START["limit"] = limit = tracing.TRACER.max_events
    metrics.REGISTRY.reset()
    tracing.TRACER.clear()
    yield
    tracing.TRACER.set_limit(limit)
    for sink in list(tracing.TRACER._sinks):
        tracing.TRACER.remove_sink(sink)


@pytest.fixture(scope="module")
def engines():
    jcfg = jget_config("granite-8b").smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    from repro.serve import Engine as JEngine
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return JEngine(jcfg, jp, max_len=MAX_LEN), Engine(CFG, tp,
                                                      max_len=MAX_LEN)


@pytest.fixture(scope="module")
def granite(engines):
    return engines[1]


def _prompt(seed, s):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, s).astype(np.int32)


def _detok(toks):
    # CJK page: every char is 3 UTF-8 bytes, so a split of the wire can
    # fall inside a character
    return "".join(chr(0x4E00 + t % 64) for t in toks)


async def _until(cond, what: str, deadline: float = DEADLINE) -> None:
    """Wait for ``cond()``, polled every 10 ms, failing after
    ``deadline`` seconds."""
    end = time.monotonic() + deadline
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out after {deadline}s: {what}")
        await asyncio.sleep(0.01)


@contextlib.asynccontextmanager
async def _served(engine, tmp_path, *, slots=4, n_banks=1, chunk=2,
                  budget=8, run=True, gw_kw=None, **fe_kw):
    """A gateway with its frontend on an ephemeral port (flight records
    under ``tmp_path``); ``run`` starts the tick loop.  Both stop on
    exit."""
    gw = Gateway(engine, slots=slots, n_banks=n_banks, chunk=chunk,
                 gen=GenConfig(max_new_tokens=budget), **(gw_kw or {}))
    fe = HttpFrontend(gw, port=0, recorder_dir=str(tmp_path), **fe_kw)
    await fe.start()
    try:
        if run:
            await gw.start()
        yield gw, fe
    finally:
        await gw.stop()
        await fe.stop()


def _series(name: str, **labels) -> float:
    fam = metrics.REGISTRY.get(name)
    return 0 if fam is None else fam.labels(**labels).value


# ---------------------------------------------------------------------------
# SSE framing: the decoder under hostile splits, against JAX's
# ---------------------------------------------------------------------------

class TestSSEDecoder:
    def test_multibyte_utf8_split_across_chunks(self):
        text = "你好，世界 — done ✓"
        frame = wire.sse_event("tokens", {"text": text, "tokens": [1, 2]})
        dec = wire.SSEDecoder()
        frames = []
        for i in range(len(frame)):
            frames.extend(dec.feed(frame[i:i + 1]))
        assert len(frames) == 1
        ev, data = frames[0]
        assert ev == "tokens" and json.loads(data)["text"] == text

    def test_split_mid_frame_and_coalesced_frames(self):
        a = wire.sse_event("tokens", {"tokens": [1]})
        b = wire.sse_event("done", {"rid": 0})
        blob = a + b
        cut = len(a) // 2
        dec = wire.SSEDecoder()
        frames = dec.feed(blob[:cut])
        frames += dec.feed(blob[cut:])
        assert [e for e, _ in frames] == ["tokens", "done"]

    def test_comments_and_crlf_tolerated(self):
        dec = wire.SSEDecoder()
        assert dec.feed(b": keep-alive\n\n") == []
        assert dec.comments == ["keep-alive"]
        assert dec.feed(b"event: done\r\ndata: {}\r\n\r\n") == [("done",
                                                                   "{}")]


_PAYLOADS = {
    "ascii": ("tokens", {"rid": 3, "tokens": [1, 2, 3]}),
    "cjk": ("tokens", {"rid": 0, "tokens": [9], "text": "你好，世界"}),
    "emoji": ("tokens", {"text": "ok ✓ 😀 é", "tokens": []}),
    "newlines": ("done", {"note": "a\nb\r\nc", "q": '"quoted"'}),
    "nested": ("done", {"rid": 1, "slo_met": None, "cancelled": False,
                        "x": [1.5, {"y": [None, True]}]}),
    "start": ("start", {"rid": 12345678901}),
}


@pytest.mark.parametrize("case", sorted(_PAYLOADS))
def test_sse_event_bytes_equal_jax(case):
    event, data = _PAYLOADS[case]
    assert wire.sse_event(event, data) == jwire.sse_event(event, data)


def _stream(pkg, seed: int, crlf: bool) -> bytes:
    """Seeded SSE frames of ``pkg`` (either package's ``http``) with
    multibyte text and keep-alive comments between them."""
    rng = np.random.default_rng(seed)
    pages = (0x41, 0xE9, 0x4E00, 0x1F600)
    out = b""
    for rid in range(int(rng.integers(3, 7))):
        toks = [int(t) for t in rng.integers(0, 512, rng.integers(1, 6))]
        text = "".join(chr(int(rng.choice(pages)) + int(rng.integers(64)))
                       for _ in range(int(rng.integers(1, 8))))
        kind = ("start", "tokens", "done")[int(rng.integers(3))]
        out += pkg.sse_event(kind, {"rid": rid, "tokens": toks,
                                    "text": text})
        if rng.random() < 0.5:
            out += b": keep-alive\n\n"
    return out.replace(b"\n", b"\r\n") if crlf else out


@pytest.mark.parametrize("seed,crlf", [(0, False), (1, False), (2, True),
                                       (3, False)])
def test_sse_decoder_every_split_matches_jax(seed, crlf):
    stream = _stream(wire, seed, crlf)
    assert stream == _stream(jwire, seed, crlf)
    whole = wire.SSEDecoder()
    want = whole.feed(stream)
    assert want
    for cut in range(len(stream) + 1):
        got, jgot = wire.SSEDecoder(), jwire.SSEDecoder()
        frames = got.feed(stream[:cut]) + got.feed(stream[cut:])
        jframes = jgot.feed(stream[:cut]) + jgot.feed(stream[cut:])
        assert frames == jframes == want, cut
        assert got.comments == jgot.comments == whole.comments
    one, jone = wire.SSEDecoder(), jwire.SSEDecoder()
    assert [f for i in range(len(stream)) for f in one.feed(
        stream[i:i + 1])] == [f for i in range(len(stream)) for f in
                              jone.feed(stream[i:i + 1])] == want


# ---------------------------------------------------------------------------
# wire identity: HTTP stream == in-process stream == JAX's stream
# ---------------------------------------------------------------------------

#: (seed, prompt length) of a fixed batch, each with budget WIRE_BUDGET
WIRE_PROMPTS = ((80, 6), (81, 9), (82, 6))
WIRE_BUDGET = 8


async def _streams_of(gw, rids, start):
    """Attach a stream to each rid before the first tick, then run the
    tick loop (``start``); returns each rid's token chunks."""
    async def consume(rid):
        return [[int(t) for t in np.asarray(c)] async for c in
                gw.stream(rid)]

    tasks = [asyncio.ensure_future(consume(r)) for r in rids]
    await _until(lambda: len(gw._streaming) == len(rids), "streams attached")
    await start()
    try:
        return await asyncio.wait_for(asyncio.gather(*tasks), DEADLINE)
    finally:
        await gw.stop()


def test_wire_tokens_equal_inprocess_and_jax(engines, tmp_path):
    """A fixed batch (every request queued and streaming before the
    first tick): the port's SSE chunks equal its in-process
    ``Gateway.stream`` chunks, and both equal JAX's."""
    jeng, teng = engines
    prompts = [_prompt(s, n) for s, n in WIRE_PROMPTS]

    async def over_wire():
        async with _served(teng, tmp_path, run=False) as (gw, fe):
            async def client(p):
                chunks = []
                async for ev, data in wire.sse_events(
                        fe.host, fe.port, "/v1/generate",
                        {"prompt": [int(t) for t in p],
                         "max_new_tokens": WIRE_BUDGET}):
                    if ev == "tokens":
                        chunks.append(json.loads(data)["tokens"])
                return chunks

            tasks = []
            for p in prompts:                  # one at a time: rid order
                tasks.append(asyncio.ensure_future(client(p)))
                n = len(tasks)
                await _until(lambda: len(gw._streaming) == n,
                             f"{n} SSE streams attached")
            await gw.start()
            return await asyncio.wait_for(asyncio.gather(*tasks), DEADLINE)

    async def in_process(gw_cls, eng, gen_cls, as_input):
        gw = gw_cls(eng, slots=4, n_banks=1, chunk=2,
                    gen=gen_cls(max_new_tokens=WIRE_BUDGET))
        rids = [await gw.asubmit(as_input(p), WIRE_BUDGET) for p in prompts]
        return await _streams_of(gw, rids, gw.start)

    http_chunks = asyncio.run(over_wire())
    local = asyncio.run(in_process(Gateway, teng, GenConfig, np.asarray))
    jax_chunks = asyncio.run(in_process(JGateway, jeng, JGenConfig,
                                        np.asarray))
    assert http_chunks == local == jax_chunks
    for chunks in http_chunks:
        assert sum(len(c) for c in chunks) == WIRE_BUDGET and len(chunks) > 1
    flat = [np.asarray(sum(c, []), np.int32).tobytes() for c in http_chunks]
    assert flat == [np.asarray(sum(c, []), np.int32).tobytes()
                    for c in jax_chunks]


class TestWireIdentity:
    def test_sse_stream_byte_identical_to_inprocess(self, granite, tmp_path):
        async def scenario():
            async with _served(granite, tmp_path, detokenize=_detok) as (
                    gw, fe):
                prompt = _prompt(10, 6)
                body = {"prompt": [int(t) for t in prompt],
                        "max_new_tokens": 8, "deadline_steps": 200}
                http_chunks, texts, done = [], [], None
                async for ev, data in wire.sse_events(
                        fe.host, fe.port, "/v1/generate", body):
                    d = json.loads(data)
                    if ev == "tokens":
                        http_chunks.append(d["tokens"])
                        texts.append(d["text"])
                    elif ev == "done":
                        done = d
                rid = await gw.asubmit(prompt, 8)
                local_chunks = [[int(t) for t in ch]
                                async for ch in gw.stream(rid)]
                assert np.asarray(sum(http_chunks, []), np.int32).tobytes() \
                    == np.asarray(sum(local_chunks, []), np.int32).tobytes()
                assert http_chunks == local_chunks
                assert "".join(texts) == _detok(sum(http_chunks, []))
                assert done["n_tokens"] == len(prompt) + 8
                assert done["slo_met"] is True and not done["cancelled"]
        asyncio.run(scenario())

    def test_nonstream_matches_stream(self, granite, tmp_path):
        async def scenario():
            async with _served(granite, tmp_path) as (gw, fe):
                prompt = _prompt(11, 5)
                status, _, raw = await wire.request(
                    fe.host, fe.port, "POST", "/v1/generate",
                    {"prompt": [int(t) for t in prompt],
                     "max_new_tokens": 6, "stream": False})
                assert status == 200
                d = json.loads(raw)
                rid = await gw.asubmit(prompt, 6)
                expect = await gw.aresult(rid)
                # non-stream bodies carry prompt + generated
                assert d["tokens"] == [int(t) for t in expect]
                assert d["n_tokens"] == len(expect) == len(prompt) + 6
        asyncio.run(scenario())

    def test_per_request_gen_override_applies(self, granite, tmp_path):
        async def scenario():
            async with _served(granite, tmp_path) as (gw, fe):
                prompt = _prompt(12, 5)
                status, _, raw = await wire.request(
                    fe.host, fe.port, "POST", "/v1/generate",
                    {"prompt": [int(t) for t in prompt],
                     "max_new_tokens": 4, "gen": {"temperature": 0.0},
                     "stream": False})
                assert status == 200
                greedy = json.loads(raw)["tokens"][-4:]
                await gw.stop()                # the sync face from here
                toks = gw.result(gw.submit(
                    prompt, 4, gen=GenConfig(max_new_tokens=4,
                                             temperature=0.0)))
                assert greedy == [int(t) for t in toks[-4:]]
        asyncio.run(scenario())


# ---------------------------------------------------------------------------
# server-side SSE behaviour: keep-alives, disconnect-cancel
# ---------------------------------------------------------------------------

class TestSSEServer:
    def test_keepalive_comments_during_silence(self, granite, tmp_path):
        """While no token arrives (tick loop not yet running: the wire's
        picture of a long prefill) the stream carries keep-alive
        comments; the loop starts once the client has seen three."""
        async def scenario():
            before = _series("repro_http_sse_events_total", kind="keepalive")
            async with _served(granite, tmp_path, slots=2, budget=4,
                               run=False, keepalive_s=0.02) as (gw, fe):
                dec, events = wire.SSEDecoder(), []

                async def client():
                    async for ev, _ in wire.sse_events(
                            fe.host, fe.port, "/v1/generate",
                            {"prompt": [int(t) for t in _prompt(13, 4)],
                             "max_new_tokens": 4}, decoder=dec):
                        events.append(ev)

                task = asyncio.ensure_future(client())
                await _until(lambda: len(dec.comments) >= 3,
                             "three keep-alive comments")
                await gw.start()
                await asyncio.wait_for(task, DEADLINE)
                assert events[0] == "start" and events[-1] == "done"
                assert "tokens" in events
                assert all(c == "keep-alive" for c in dec.comments)
                after = _series("repro_http_sse_events_total",
                                kind="keepalive")
                assert after - before >= len(dec.comments) >= 3
        asyncio.run(scenario())

    def test_client_disconnect_cancels_request(self, granite, tmp_path):
        """Closing the socket after the ``start`` event cancels the
        request through ``Gateway.acancel``: it grades as cancelled, and
        its slot and pages come back."""
        async def scenario():
            gone = _series("repro_http_disconnects_total")
            aborted = _series("repro_http_requests_total",
                              route="/v1/generate", code="499")
            async with _served(granite, tmp_path, chunk=1, budget=48,
                               gw_kw=dict(page_size=8, pages_per_bank=16)
                               ) as (gw, fe):
                reader, writer = await asyncio.open_connection(fe.host,
                                                               fe.port)
                body = json.dumps({
                    "prompt": [int(t) for t in _prompt(14, 4)],
                    "max_new_tokens": 48}).encode()
                writer.write(wire._request_bytes("POST", "/v1/generate",
                                                 fe.host, body))
                await writer.drain()
                await asyncio.wait_for(reader.readuntil(b"start"), DEADLINE)
                writer.close()
                await writer.wait_closed()
                req = gw.request(gw._next_rid - 1)
                await _until(lambda: req.done, "the request is cancelled")
                assert req.cancelled
                assert len(req.tokens) < len(req.prompt) + 48
                pool = gw.pool
                await _until(lambda: pool.alloc.free_count() == pool.slots
                             and pool.alloc.page_free_count()
                             == pool.total_pages, "slot and pages back")
                await _until(lambda: _series(
                    "repro_http_disconnects_total") == gone + 1,
                    "the disconnect counted")
                assert _series("repro_http_requests_total",
                               route="/v1/generate",
                               code="499") == aborted + 1
                assert gw.stats()["cancels"] == 1
        asyncio.run(scenario())


# ---------------------------------------------------------------------------
# plain routes + error statuses
# ---------------------------------------------------------------------------

def _gateway_series(gw, key):
    """The registry series behind one of ``gw``'s counters, with its
    label (the label is per instance)."""
    cell = gw._obs_series[key]
    fam = {"requests_total": "repro_gateway_requests_total",
           "slo_met_count": "repro_gateway_slo_met_total"}[key]
    (label,) = [dict(k)["gw"] for k, s in
                metrics.REGISTRY.get(fam)._series.items() if s is cell]
    return fam, label


class TestRoutes:
    def test_healthz_stats_metrics_trace(self, granite, tmp_path):
        async def scenario():
            async with _served(granite, tmp_path) as (gw, fe):
                rid = await gw.asubmit(_prompt(15, 5), 4,
                                       deadline_steps=100)
                await gw.aresult(rid)
                st, _, raw = await wire.request(fe.host, fe.port, "GET",
                                                "/healthz")
                assert st == 200 and json.loads(raw)["ok"] is True
                st, _, raw = await wire.request(fe.host, fe.port, "GET",
                                                "/v1/stats")
                d = json.loads(raw)
                assert st == 200
                assert d["tick"]["stats"]["prefill_launches"] >= 1
                assert d["stats"]["requests"] == d["stats"]["completed"] == 1
                assert d["ring"]["capacity"] == fe.ring.capacity
                assert d["slo"]["objective"] == fe.slo_monitor.objective
                assert d["slo"]["recorded"] == 1
                st, hdrs, raw = await wire.request(fe.host, fe.port, "GET",
                                                   "/metrics")
                assert st == 200 and hdrs["content-type"].startswith(
                    "text/plain; version=0.0.4")
                fams = promparse.parse(raw.decode())
                assert "repro_http_requests_total" in fams
                stats = gw.stats()
                for key, stat in (("requests_total", "requests"),
                                  ("slo_met_count", "slo_met")):
                    fam, label = _gateway_series(gw, key)
                    assert fams[fam].series()[(("gw", label),)] == \
                        stats[stat]
                pool_fam = fams["repro_pool_admits_total"].series()
                assert pool_fam[(("pool", gw.pool._pool_label),)] == \
                    stats["admits"]
                st, hdrs, raw = await wire.request(fe.host, fe.port, "GET",
                                                   "/debug/trace")
                assert st == 200
                assert hdrs.get("transfer-encoding") == "chunked"
                trace = json.loads(raw.decode())
                counts = validate_chrome_trace(trace)
                assert counts.get("pool.decode_chunk", 0) >= 1
                assert raw.decode() == json.dumps(
                    export.chrome_trace(fe.ring), indent=1)
        asyncio.run(scenario())

    @pytest.mark.parametrize("method,path,body,expect", [
        ("GET", "/no/such/route", None, 404),
        ("POST", "/metrics", None, 405),
        ("PUT", "/healthz", None, 405),
        ("GET", "/v1/generate", None, 405),
        ("POST", "/v1/generate", b"not json", 400),
        ("POST", "/v1/generate", b"[1, 2]", 400),
        ("POST", "/v1/generate", {"prompt": "strings"}, 400),
        ("POST", "/v1/generate", {"prompt": [1, 2], "gen": {"bogus": 1}},
         400),
        ("POST", "/v1/generate", {"prompt": [1, 2], "gen": 3}, 400),
        ("POST", "/v1/generate", {"prompt": []}, 400),
    ], ids=["404", "405_post_metrics", "405_put_healthz",
            "405_get_generate", "400_not_json", "400_not_object",
            "400_prompt_strings", "400_unknown_gen", "400_gen_not_object",
            "400_empty_prompt"])
    def test_error_statuses(self, granite, tmp_path, method, path, body,
                            expect):
        async def scenario():
            route = path.split("?", 1)[0]
            before = _series("repro_http_requests_total", route=route,
                             code=str(expect))
            async with _served(granite, tmp_path) as (gw, fe):
                st, _, raw = await wire.request(fe.host, fe.port, method,
                                                path, body)
                assert st == expect, (path, raw)
                assert "error" in json.loads(raw)
                assert gw.stats()["requests"] == 0
            assert _series("repro_http_requests_total", route=route,
                           code=str(expect)) == before + 1
        asyncio.run(scenario())

    def test_body_too_large_is_413(self, granite, tmp_path):
        async def scenario():
            async with _served(granite, tmp_path) as (gw, fe):
                reader, writer = await asyncio.open_connection(fe.host,
                                                               fe.port)
                writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                             + f"Content-Length: {(8 << 20) + 1}\r\n\r\n"
                             .encode())
                await writer.drain()
                status, headers = await wire._read_response_head(reader)
                body = b"".join([c async for c in
                                 wire._iter_body(reader, headers)])
                writer.close()
                await writer.wait_closed()
                assert status == 413
                assert json.loads(body) == {"error": "body too large"}
                assert gw.stats()["requests"] == 0
        asyncio.run(scenario())

    def test_handler_fault_is_500(self, granite, tmp_path, monkeypatch):
        async def scenario():
            async with _served(granite, tmp_path) as (gw, fe):
                def broken():
                    raise RuntimeError("stats unavailable")
                monkeypatch.setattr(gw, "stats", broken)
                st, _, raw = await wire.request(fe.host, fe.port, "GET",
                                                "/v1/stats")
                assert st == 500
                assert "stats unavailable" in json.loads(raw)["error"]
        asyncio.run(scenario())


# ---------------------------------------------------------------------------
# nothing changes under the decode chunk with the frontend mounted
# ---------------------------------------------------------------------------

_ROW_KERNELS = ("gather_rows", "fused_stream", "scatter_rows")


class TestInvariantsWithHttp:
    def test_row_kernel_calls_per_steady_step_with_frontend(
            self, granite, tmp_path, monkeypatch):
        """With the frontend mounted (after serving a request over the
        wire), one steady ``pool.step()`` on ``cuda`` banks calls each row
        kernel's wrapper once per bank — the launches of the card, here
        through the plain twins the wrappers run for CPU tensors."""
        calls = dict.fromkeys(_ROW_KERNELS, 0)

        def counted(name):
            inner = getattr(cpm_kernels, name)

            def call(*a, **k):
                calls[name] += 1
                return inner(*a, **k)
            return call

        async def scenario():
            async with _served(granite, tmp_path, slots=4, n_banks=2,
                               budget=12,
                               gw_kw=dict(bank_backend="cuda", page_size=8,
                                          pages_per_bank=16)) as (gw, fe):
                st, _, _ = await wire.request(
                    fe.host, fe.port, "POST", "/v1/generate",
                    {"prompt": [int(t) for t in _prompt(16, 5)],
                     "max_new_tokens": 4, "stream": False})
                assert st == 200
                await gw.stop()                # the frontend stays up
                for i in range(4):
                    gw.submit(_prompt(160 + i, 6), 12)
                gw.tick()                      # admission + one chunk
                before = gw.pool.stats()
                assert before["active"] == 4 and before["waiting"] == 0
                for name in _ROW_KERNELS:
                    monkeypatch.setattr(cpm_kernels, name, counted(name))
                gw.pool.step()
                monkeypatch.undo()
                after = gw.pool.stats()
                assert after["active"] == 4 and after["admits"] == \
                    before["admits"]
                assert fe._server is not None   # mounted throughout
        asyncio.run(scenario())
        assert calls == dict.fromkeys(_ROW_KERNELS, 2)

    def test_chunk_reads_nothing_back_serving_over_http(
            self, granite, tmp_path, monkeypatch):
        """Serving over the wire adds no host read inside the decode
        chunk: every tensor-reading method raises while ``_chunk`` runs
        (the card's ``set_sync_debug_mode("error")`` check is
        ``chip_smoke.py``'s phase 14)."""
        chunks = []

        def read(*_a, **_k):
            raise AssertionError("host read inside the decode chunk")

        async def scenario():
            async with _served(granite, tmp_path, slots=2, budget=6,
                               run=False) as (gw, fe):
                inner = gw.pool._chunk

                def guarded(*a, **k):
                    with monkeypatch.context() as m:
                        for name in ("item", "cpu", "tolist", "numpy",
                                     "__bool__", "__int__", "__float__",
                                     "__index__"):
                            m.setattr(torch.Tensor, name, read)
                        chunks.append(1)
                        return inner(*a, **k)

                gw.pool._chunk = guarded

                async def client(p):
                    return [ev async for ev, _ in wire.sse_events(
                        fe.host, fe.port, "/v1/generate",
                        {"prompt": [int(t) for t in p],
                         "max_new_tokens": 6})]

                tasks = []
                for seed in (18, 19):
                    tasks.append(asyncio.ensure_future(
                        client(_prompt(seed, 5))))
                    n = len(tasks)
                    await _until(lambda: len(gw._streaming) == n,
                                 "streams attached")
                await gw.start()
                got = await asyncio.wait_for(asyncio.gather(*tasks),
                                             DEADLINE)
                assert all(evs[0] == "start" and evs[-1] == "done"
                           for evs in got)
        asyncio.run(scenario())
        assert len(chunks) >= 3


# ---------------------------------------------------------------------------
# serve(http_port=) lifecycle
# ---------------------------------------------------------------------------

class TestServeMount:
    def test_serve_mounts_and_unmounts_frontend(self, granite, tmp_path):
        async def scenario():
            limit = tracing.TRACER.max_events
            gw = Gateway(granite, slots=2, n_banks=1, chunk=2,
                         gen=GenConfig(max_new_tokens=4))
            await gw.start(http_port=0, recorder_dir=str(tmp_path),
                           tracer_limit=4096)
            try:
                await _until(lambda: gw.http is not None
                             and gw.http.port != 0, "the frontend bound")
                port = gw.http.port
                assert tracing.TRACER.max_events == 4096
                assert gw.http.ring in tracing.TRACER._sinks
                st, _, raw = await wire.request("127.0.0.1", port, "POST",
                                                "/v1/generate",
                                                {"prompt": [1, 2, 3],
                                                 "max_new_tokens": 3,
                                                 "stream": False})
                assert st == 200 and len(json.loads(raw)["tokens"]) == 6
                st, _, raw = await wire.request("127.0.0.1", port, "GET",
                                                "/healthz")
                assert st == 200 and json.loads(raw)["ok"]
                assert gw.slo_monitor is gw.http.slo_monitor
                assert gw.http.recorder.directory == str(tmp_path)
            finally:
                await gw.stop()
            with pytest.raises(OSError):
                await wire.request("127.0.0.1", port, "GET", "/healthz")
            assert gw.http.ring not in tracing.TRACER._sinks
            assert tracing.TRACER.max_events == limit
        asyncio.run(scenario())


def test_module_isolation_fixture_is_active(request):
    """Pin this module's reset of the port's registry and tracer:
    conftest's fixture resets only ``repro.obs``."""
    assert "_torch_obs_module_isolation" in request.fixturenames


def test_no_sink_left_and_tracer_limit_restored():
    """Every frontend of this module was stopped: no sink is left on the
    port's tracer and its limit is what it was when the module began."""
    assert tracing.TRACER._sinks == []
    assert tracing.TRACER.max_events == _START["limit"]
