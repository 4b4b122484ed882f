"""The port's live observability plane — ``repro_torch.obs.live``,
``slo`` and ``promparse`` — with ``tests/test_obs_live.py``'s cases, and
against the JAX package on the same inputs.

Held here, on the CPU:

  * the bounded ring: over 10k spans it never exceeds its capacity,
    counts every drop, and its chunked export concatenates to the
    one-shot ``chrome_trace`` JSON;
  * histogram quantiles and their summary family;
  * the strict exposition parser, and the port's parser and JAX's
    rejecting the same malformed inputs with the same message and
    accepting the same good inputs into equal families;
  * the burn-rate monitor: the multi-window alert, cooldown, min-events,
    the gateway feeding it, and the same met / missed sequences (seeded)
    giving equal alert dicts, burn rates and ``state()`` in both packages;
  * the flight recorder's atomic dumps (always under ``tmp_path``);
  * ``Registry.reset`` keeping live series handles valid.

The port's registry and tracer are process global and
``tests/conftest.py`` resets only ``repro.obs``'s, so this module resets
the port's own at its start (``_torch_obs_module_isolation``) and reads
counter deltas only.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.obs import promparse as jpromparse  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.obs import (export, live, metrics, promparse,  # noqa: E402
                             slo, tracing)
from repro_torch.serve import Engine, Gateway, GenConfig  # noqa: E402

CFG = get_config("granite-8b").smoke()


@pytest.fixture(autouse=True, scope="module")
def _torch_obs_module_isolation():
    """The port's counterpart of conftest's ``_obs_module_isolation``:
    zero the port's registry in place, empty its tracer, and restore the
    tracer's limit when the module ends."""
    limit = tracing.TRACER.max_events
    metrics.REGISTRY.reset()
    tracing.TRACER.clear()
    yield
    tracing.TRACER.set_limit(limit)


@pytest.fixture(scope="module")
def granite():
    from repro.configs import get_config as jget_config
    jp = jlm.init_params(jget_config("granite-8b").smoke(),
                         jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return Engine(CFG, params, max_len=64)


def _prompt(seed, s):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, s).astype(np.int32)


# ---------------------------------------------------------------------------
# the bounded ring + streaming export
# ---------------------------------------------------------------------------

class TestTraceRing:
    def test_bounded_over_10k_spans_and_chunked_export_identity(self):
        t = tracing.Tracer()
        ring = live.TraceRing(capacity=512).attach(t)
        n = 10_000
        for i in range(n):
            with t.span("work", args={"i": i}):
                pass
            if i % 100 == 0:
                t.instant("mark", vstep=i)
        stats = ring.stats()
        assert len(ring) == 512 and stats["len"] == 512
        assert stats["total"] == n + n // 100
        assert stats["dropped"] == stats["total"] - 512
        streamed = "".join(export.iter_trace_chunks(ring))
        assert streamed == json.dumps(export.chrome_trace(ring), indent=1)
        trace = json.loads(streamed)
        export.validate_chrome_trace(trace)
        data = [e for e in trace["traceEvents"] if e["ph"] in "XiC"]
        assert len(data) == 512
        ring.detach()
        with t.span("after-detach"):
            pass
        assert ring.stats()["total"] == stats["total"]

    def test_write_trace_stream_file(self, tmp_path):
        t = tracing.Tracer()
        ring = live.TraceRing(capacity=64).attach(t)
        for i in range(100):
            with t.span("s", args={"i": i}):
                pass
        path = tmp_path / "stream.json"
        assert export.write_trace_stream(path, ring) == 64
        export.validate_chrome_trace(json.loads(path.read_text()))

    def test_attach_twice_raises_and_capacity_validates(self):
        t = tracing.Tracer()
        ring = live.TraceRing(capacity=4).attach(t)
        with pytest.raises(RuntimeError, match="attached"):
            ring.attach(t)
        ring.detach()
        ring.attach(t)
        ring.detach()
        assert t._sinks == []
        with pytest.raises(ValueError, match="capacity"):
            live.TraceRing(capacity=0)

    def test_last_n_returns_newest(self):
        t = tracing.Tracer()
        ring = live.TraceRing(capacity=8).attach(t)
        for i in range(20):
            t.instant("e", args={"i": i})
        assert [e.args["i"] for e in ring.last(3)] == [17, 18, 19]
        assert len(ring.last(100)) == 8
        ring.clear()
        assert len(ring) == 0 and ring.stats()["total"] == 20
        ring.detach()

    def test_tracer_set_limit_bounds_global_buffer(self):
        t = tracing.Tracer()
        for i in range(100):
            t.instant("e", args={"i": i})
        t.set_limit(10)
        assert t.max_events == 10 and len(t.spans()) == 10
        assert t.spans()[-1].args["i"] == 99
        t.set_limit(None)
        for i in range(20):
            t.instant("e2")
        assert t.max_events is None and len(t.spans()) == 30


# ---------------------------------------------------------------------------
# histogram quantiles
# ---------------------------------------------------------------------------

class TestQuantiles:
    def test_interpolation_and_top_edge_clamp(self):
        h = metrics.Histogram("t_q_lat", "", (), buckets=(1.0, 2.0, 4.0, 8.0))
        s = h.default
        for v in [0.5] * 50 + [3.0] * 40 + [100.0] * 10:
            s.observe(v)
        assert s.quantile(0.5) == pytest.approx(1.0)
        assert s.quantile(0.9) == pytest.approx(4.0)
        assert s.quantile(0.99) == pytest.approx(8.0)
        assert s.quantile(0.0) == pytest.approx(0.0)
        with pytest.raises(ValueError):
            s.quantile(1.5)

    def test_empty_series_has_no_quantiles(self):
        h = metrics.Histogram("t_q_empty", "", ())
        assert h.default.quantile(0.5) is None
        assert h.series()[""]["quantiles"] == {"p50": None, "p90": None,
                                               "p99": None}

    def test_summary_family_in_exposition_parses(self):
        reg = metrics.Registry()
        h = reg.register(metrics.Histogram("t_q_sum", "latency", ("k",),
                                           buckets=(1.0, 10.0)))
        for v in (0.5, 2.0, 20.0):
            h.labels(k="a").observe(v)
        fams = promparse.parse(reg.prometheus_text())
        assert fams["t_q_sum"].type == "histogram"
        summ = fams["t_q_sum_summary"]
        assert summ.type == "summary"
        assert len(summ.series()) == 3
        assert summ.series("_count")[(("k", "a"),)] == 3


# ---------------------------------------------------------------------------
# strict exposition parsing, and against JAX's parser
# ---------------------------------------------------------------------------

#: (case, text, message the parser raises with); the first five are
#: tests/test_obs_live.py's TestPromParse rejections
BAD_EXPOSITIONS = [
    ("type_before_help", "# TYPE x counter\nx 1\n",
     "without preceding HELP"),
    ("interleaved", "# HELP a a\n# TYPE a counter\na 1\n"
                    "# HELP b b\n# TYPE b counter\nb 1\na 2\n",
     "block ended"),
    ("undeclared", "orphan 1\n", "preceding"),
    ("noncumulative", "# HELP h h\n# TYPE h histogram\n"
                      'h_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n'
                      "h_sum 1\nh_count 3\n", "cumulative"),
    ("inf_count_mismatch", "# HELP h h\n# TYPE h histogram\n"
                           'h_bucket{le="1"} 1\nh_bucket{le="+Inf"} 3\n'
                           "h_sum 1\nh_count 4\n", "_count"),
    ("no_inf_bucket", "# HELP h h\n# TYPE h histogram\n"
                      'h_bucket{le="1"} 1\nh_sum 1\nh_count 1\n', "+Inf"),
    ("missing_sum", "# HELP h h\n# TYPE h histogram\n"
                    'h_bucket{le="+Inf"} 1\nh_count 1\n', "_sum/_count"),
    ("bucket_without_le", "# HELP h h\n# TYPE h histogram\n"
                          'h_bucket{x="1"} 1\nh_sum 1\nh_count 1\n',
     "without le"),
    ("bad_escape", '# HELP c c\n# TYPE c counter\nc{p="a\\qb"} 1\n',
     "bad escape"),
    ("dangling_backslash", '# HELP c c\n# TYPE c counter\nc{p="a\\\\\\"} 1\n',
     "unterminated"),
    ("unquoted_value", "# HELP c c\n# TYPE c counter\nc{p=1} 1\n",
     "unquoted"),
    ("duplicate_label", '# HELP c c\n# TYPE c counter\nc{p="1",p="2"} 1\n',
     "duplicate label"),
    ("bad_label_name", '# HELP c c\n# TYPE c counter\nc{p-q="1"} 1\n',
     "bad label name"),
    ("no_comma", '# HELP c c\n# TYPE c counter\nc{p="1"q="2"} 1\n',
     "expected ','"),
    ("label_without_eq", "# HELP c c\n# TYPE c counter\nc{p} 1\n",
     "without '='"),
    ("unbalanced_braces", "# HELP c c\n# TYPE c counter\nc}p{ 1\n",
     "unbalanced"),
    ("missing_value", "# HELP c c\n# TYPE c counter\nc\n", "missing value"),
    ("bad_value", "# HELP c c\n# TYPE c counter\nc one\n",
     "bad sample value"),
    ("unknown_type", "# HELP c c\n# TYPE c widget\nc 1\n", "unknown type"),
    ("malformed_type", "# HELP c c\n# TYPE c\nc 1\n", "malformed TYPE"),
    ("duplicate_help", "# HELP c c\n# TYPE c counter\nc 1\n# HELP c c\n",
     "duplicate HELP"),
    ("help_before_type", "# HELP a a\n# HELP b b\n", "before TYPE"),
    ("dangling_help", "# HELP c c\n", "dangling HELP"),
    ("summary_no_quantile", "# HELP s s\n# TYPE s summary\ns 1\n"
                            "s_sum 1\ns_count 1\n", "without quantile"),
    ("quantile_range", '# HELP s s\n# TYPE s summary\ns{quantile="1.5"} 1\n',
     "outside"),
]

GOOD_EXPOSITIONS = [
    ("escapes", '# HELP c c\n# TYPE c counter\nc{p="a\\\\b\\"q\\nr"} 1\n'),
    ("comments_and_blank", "# a comment\n\n# HELP g g x\n# TYPE g gauge\n"
                           "g -2.5\n"),
    ("histogram_and_summary",
     "# HELP h lat\n# TYPE h histogram\n"
     'h_bucket{k="a",le="1.0"} 1\nh_bucket{k="a",le="+Inf"} 3\n'
     'h_sum{k="a"} 22.5\nh_count{k="a"} 3\n'
     "# HELP h_summary q\n# TYPE h_summary summary\n"
     'h_summary{k="a",quantile="0.5"} 1.5\nh_summary_sum{k="a"} 22.5\n'
     'h_summary_count{k="a"} 3\n'),
    ("inf_values", "# HELP u u\n# TYPE u untyped\nu +Inf\nu{a=\"b\"} -Inf\n"),
]


class TestPromParse:
    def test_rejects_type_before_help(self):
        with pytest.raises(ValueError, match="without preceding HELP"):
            promparse.parse("# TYPE x counter\nx 1\n")

    def test_unescapes_label_values(self):
        text = ('# HELP c c\n# TYPE c counter\n'
                'c{p="a\\\\b\\"q\\nr"} 1\n')
        fam = promparse.parse(text)["c"]
        assert fam.series() == {(("p", 'a\\b"q\nr'),): 1.0}


def _message(parse, text):
    with pytest.raises(ValueError) as info:
        parse(text)
    return str(info.value)


@pytest.mark.parametrize("text,match",
                         [c[1:] for c in BAD_EXPOSITIONS],
                         ids=[c[0] for c in BAD_EXPOSITIONS])
def test_parsers_reject_alike(text, match):
    got = _message(promparse.parse, text)
    assert got == _message(jpromparse.parse, text)
    assert match in got


def _families(fams) -> dict:
    return {name: (f.name, f.help, f.type,
                   [(s.name, s.labels, s.value, s.line) for s in f.samples])
            for name, f in fams.items()}


@pytest.mark.parametrize("text", [c[1] for c in GOOD_EXPOSITIONS],
                         ids=[c[0] for c in GOOD_EXPOSITIONS])
def test_parsers_accept_alike(text):
    assert _families(promparse.parse(text)) == \
        _families(jpromparse.parse(text))


def test_parsers_accept_a_live_scrape_alike(granite):
    gw = Gateway(granite, slots=2, chunk=2, gen=GenConfig(max_new_tokens=4))
    gw.result(gw.submit(_prompt(70, 6), 4, deadline_steps=100))
    text = metrics.prometheus_text()
    assert _families(promparse.parse(text)) == \
        _families(jpromparse.parse(text))


# ---------------------------------------------------------------------------
# burn-rate monitor + flight recorder
# ---------------------------------------------------------------------------

def _monitor(pkg, name, **kw):
    kw.setdefault("objective", 0.9)
    kw.setdefault("fast", pkg.BurnWindow(steps=16, threshold=5.0))
    kw.setdefault("slow", pkg.BurnWindow(steps=64, threshold=2.0))
    return pkg.SloMonitor(name=name, **kw)


class TestSloMonitor:
    def test_all_met_never_alerts(self):
        m = _monitor(slo, "t_all_met")
        for step in range(0, 200, 2):
            assert m.record(True, step) is None
        assert m.alerts == [] and m.attainment() == 1.0

    def test_miss_burst_fires_multi_window_alert(self):
        m = _monitor(slo, "t_burst")
        fam = metrics.REGISTRY.get("repro_slo_alerts_total")
        before = fam.labels(monitor="t_burst").value
        step = 0
        for _ in range(40):
            m.record(True, step)
            step += 1
        alerts = []
        for _ in range(12):
            a = m.record(False, step)
            if a:
                alerts.append(a)
            step += 1
        assert len(alerts) == 1
        a = alerts[0]
        assert a["fast"]["burn"] > 5.0 and a["slow"]["burn"] > 2.0
        assert m.state()["alerts"] == 1
        assert m.state()["attainment_slow"] < 1.0
        assert fam.labels(monitor="t_burst").value == before + 1

    def test_min_events_guard(self):
        m = _monitor(slo, "t_min_events", min_events=8)
        for i in range(4):
            assert m.record(False, i) is None
        assert m.alerts == []

    def test_burn_rate_math(self):
        m = _monitor(slo, "t_math")
        for i in range(8):
            m.record(i % 2 == 0, i)
        assert m.burn_rate(7, m.fast) == pytest.approx(5.0)

    def test_cooldown_then_refire(self):
        m = _monitor(slo, "t_cooldown", cooldown_steps=10)
        fired = sum(1 for step in range(40) if m.record(False, step))
        assert fired >= 2
        assert m.alerts[1]["step"] - m.alerts[0]["step"] >= 10

    def test_window_validation(self):
        with pytest.raises(ValueError, match="objective"):
            slo.SloMonitor(objective=1.0)
        with pytest.raises(ValueError, match="fast window"):
            slo.SloMonitor(fast=slo.BurnWindow(100, 1.0),
                           slow=slo.BurnWindow(10, 1.0))

    def test_gateway_feeds_monitor(self, granite):
        m = _monitor(slo, "t_gw", fast=slo.BurnWindow(steps=8, threshold=1.0),
                     slow=slo.BurnWindow(steps=32, threshold=0.5),
                     min_events=1)
        gw = Gateway(granite, slots=2, chunk=2,
                     gen=GenConfig(max_new_tokens=4), slo_monitor=m)
        gw.result(gw.submit(_prompt(30, 6), 4, deadline_steps=100))
        gw.result(gw.submit(_prompt(31, 6), 4, deadline_steps=0))
        gw.result(gw.submit(_prompt(32, 6), 4))          # ungraded
        assert m.recorded == 2
        assert m.alerts


@pytest.mark.parametrize("seed", range(4))
def test_slo_monitor_equals_jax(seed):
    """The same seeded met / missed sequence (bursts of misses over
    healthy traffic, steps advancing by 0-3) gives equal alert dicts,
    burn rates, attainment and ``state()`` in both packages."""
    rng = np.random.default_rng(seed)
    kw = dict(objective=float(rng.choice([0.9, 0.95, 0.99])),
              cooldown_steps=int(rng.integers(4, 40)),
              min_events=int(rng.integers(1, 6)))
    m = _monitor(slo, f"t_eq{seed}", **kw)
    jm = _monitor(jslo, f"t_eq{seed}", **kw)
    step = 0
    for i in range(600):
        step += int(rng.integers(0, 4))
        met = bool(rng.random() < (0.3 if (i // 50) % 3 == 1 else 0.97))
        assert m.record(met, step) == jm.record(met, step)
        if i % 37 == 0:
            for w in (m.fast, m.slow):
                assert m.burn_rate(step, w) == jm.burn_rate(step, w)
            assert m.attainment(step) == jm.attainment(step)
    assert m.alerts == jm.alerts and m.alerts
    assert m.state() == jm.state()


class TestFlightRecorder:
    def test_dump_roundtrips_validators(self, granite, tmp_path):
        t = tracing.Tracer()
        ring = live.TraceRing(capacity=32).attach(t)
        for i in range(50):
            with t.span("tick", args={"i": i}):
                pass
        gw = Gateway(granite, slots=2, chunk=2,
                     gen=GenConfig(max_new_tokens=4))
        gw.submit(_prompt(40, 6), 4)
        gw.tick()                            # leaves a live session
        rec = slo.FlightRecorder(str(tmp_path), ring=ring, pool=gw.pool,
                                 last_n=16)
        path = rec.dump("test burst", extra={"k": 1})
        assert path and os.path.exists(path)
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
        d = json.loads(open(path).read())
        assert d["reason"] == "test burst" and d["extra"] == {"k": 1}
        export.validate_chrome_trace(d["trace"])
        assert len([e for e in d["trace"]["traceEvents"]
                    if e["ph"] in "XiC"]) == 16
        promparse.parse(d["metrics_prom"])
        jpromparse.parse(d["metrics_prom"])
        alloc = d["allocator"]
        assert alloc == json.loads(json.dumps(slo.allocator_state(gw.pool)))
        assert alloc["n_slots"] == 2 and alloc["free_slots"] == 1
        assert alloc["free_slots"] == alloc["slot_state"].count(0)
        assert alloc["free_pages"] == alloc["page_state"].count(0)
        used_pages = sum(len(v) for v in alloc["page_lists"].values())
        assert used_pages == alloc["n_pages"] - alloc["free_pages"]
        ring.detach()

    def test_max_dumps_cap(self, tmp_path):
        rec = slo.FlightRecorder(str(tmp_path), max_dumps=2)
        assert rec.dump("a") and rec.dump("b")
        assert rec.dump("c") is None
        assert sorted(os.listdir(tmp_path)) == ["flight_0000.json",
                                                "flight_0001.json"]

    def test_alert_dumps_once_under_cooldown(self, tmp_path):
        ring = live.TraceRing(capacity=8, tracer=tracing.Tracer())
        rec = slo.FlightRecorder(str(tmp_path), ring=ring)
        m = _monitor(slo, "t_dump", recorder=rec)
        for step in range(12):
            m.record(False, step)
        assert [a["dump"] for a in m.alerts] == [
            os.path.join(str(tmp_path), "flight_0000.json")]
        d = json.loads(open(m.alerts[0]["dump"]).read())
        assert d["reason"].startswith("slo_burn step=")
        assert d["extra"]["alert"]["fast"] == m.alerts[0]["fast"]
        ring.detach()


# ---------------------------------------------------------------------------
# registry hygiene
# ---------------------------------------------------------------------------

class TestRegistryReset:
    def test_reset_zeroes_but_keeps_series_references(self):
        reg = metrics.Registry()
        c = reg.register(metrics.Counter("t_r_c", "", ("k",)))
        h = reg.register(metrics.Histogram("t_r_h", "", ()))
        series = c.labels(k="x")
        series.inc(5)
        h.default.observe(3.0)
        reg.reset()
        assert series.value == 0
        assert h.default.count == 0 and h.default.sum == 0.0
        series.inc()
        assert reg.snapshot()["t_r_c"]["series"] == {'{k="x"}': 1}

    def test_global_reset_keeps_gateway_series_valid(self, granite):
        gw = Gateway(granite, slots=2, chunk=2,
                     gen=GenConfig(max_new_tokens=4))
        gw.result(gw.submit(_prompt(50, 6), 4, deadline_steps=100))
        assert gw.slo_met_count == 1
        metrics.REGISTRY.reset()
        assert gw.slo_met_count == 0
        gw.result(gw.submit(_prompt(51, 6), 4, deadline_steps=100))
        assert gw.slo_met_count == 1

    def test_module_isolation_fixture_is_active(self, request):
        """Pin this module's reset of the port's registry and tracer:
        conftest's fixture resets only ``repro.obs``."""
        assert "_torch_obs_module_isolation" in request.fixturenames
