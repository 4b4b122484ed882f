"""The port's metrics exposition and trace export against the JAX
package's on the same inputs.

Held here, on the CPU:

  * the exposition half of ``repro_torch.obs.metrics`` — snapshots,
    Prometheus text, escaping, histogram quantiles — with
    ``tests/test_obs.py``'s ``TestMetrics`` cases, and byte for byte with
    ``repro.obs.metrics`` over the same families, labels and
    observations (made with numpy from a seed) in a fresh ``Registry`` of
    each package; JAX's strict parser accepts the port's text;
  * ``repro_torch.obs.export`` with ``TestExport``'s cases, and
    ``chrome_trace`` / ``iter_trace_chunks`` byte for byte with JAX's
    over the same ``SpanEvent`` list; JAX's ``validate_chrome_trace``
    accepts the port's trace;
  * the package's exports.

The port's registry and tracer are process global and
``tests/conftest.py`` resets only ``repro.obs``'s, so this module resets
the port's own at its start (``_torch_obs_module_isolation``).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.obs import export as jexport  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import promparse as jpromparse  # noqa: E402
from repro.obs import tracing as jtracing  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import export, metrics, promparse, tracing  # noqa: E402


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


def test_module_isolation_fixture_is_active(request):
    assert "_torch_obs_module_isolation" in request.fixturenames


# ---------------------------------------------------------------------------
# the exposition half of the registry (tests/test_obs.py::TestMetrics)
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_counter_gauge_series_and_snapshot(self):
        reg = metrics.Registry()
        c = reg.register(metrics.Counter("t_reqs", "requests", ("pool",)))
        g = reg.register(metrics.Gauge("t_occ", "occupancy"))
        c.inc(pool="0")
        c.inc(2, pool="0")
        c.inc(pool="1")
        g.default.set(0.5)
        snap = reg.snapshot()
        assert snap["t_reqs"]["kind"] == "counter"
        assert snap["t_reqs"]["series"] == {'{pool="0"}': 3,
                                            '{pool="1"}': 1}
        assert snap["t_occ"]["series"] == {"": 0.5}
        json.dumps(snap)

    def test_label_mismatch_raises(self):
        c = metrics.Counter("t_c", "", ("bank",))
        with pytest.raises(ValueError, match="labels"):
            c.labels(pool="0")
        with pytest.raises(ValueError, match="labels"):
            c.labels()

    def test_reregister_idempotent_but_type_change_raises(self):
        reg = metrics.Registry()
        a = reg.register(metrics.Counter("t_x", "", ()))
        assert reg.register(metrics.Counter("t_x", "", ())) is a
        with pytest.raises(ValueError, match="re-registered"):
            reg.register(metrics.Gauge("t_x", "", ()))
        with pytest.raises(ValueError, match="re-registered"):
            reg.register(metrics.Counter("t_x", "", ("pool",)))

    def test_histogram_buckets_cumulative(self):
        h = metrics.Histogram("t_h", "", (), buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 0.5, 5.0):
            h.observe(v)
        s = h.series()[""]
        assert s["count"] == 4 and s["sum"] == pytest.approx(6.05)
        assert s["buckets"] == {"0.1": 1, "1.0": 3, "+Inf": 4}

    def test_prometheus_text_format(self):
        reg = metrics.Registry()
        c = reg.register(metrics.Counter("t_reqs", "total requests",
                                         ("pool",)))
        c.inc(7, pool="0")
        h = reg.register(metrics.Histogram("t_lat", "latency", (),
                                           buckets=(0.5,)))
        h.observe(0.2)
        text = reg.prometheus_text()
        assert "# HELP t_reqs total requests" in text
        assert "# TYPE t_reqs counter" in text
        assert 't_reqs{pool="0"} 7' in text
        assert 't_lat_bucket{le="0.5"} 1' in text
        assert 't_lat_bucket{le="+Inf"} 1' in text
        assert "t_lat_count 1" in text

    def test_prometheus_escaping_roundtrips_parser(self):
        reg = metrics.Registry()
        c = reg.register(metrics.Counter("t_esc", 'help with "quotes"\n',
                                         ("path",)))
        hostile = 'a\\b"c\nd'
        c.inc(3, path=hostile)
        fams = promparse.parse(reg.prometheus_text())
        assert fams["t_esc"].series() == {(("path", hostile),): 3.0}
        assert fams["t_esc"].help.startswith("help with")

    def test_prometheus_exposition_passes_strict_parser(self):
        """The port's whole live registry after real gateway traffic —
        with the pool's chunk histogram and its summary family — passes
        the strict parser, as a ``/metrics`` scrape must."""
        from repro_torch.configs import get_config
        from repro_torch.models import lm
        from repro_torch.serve import Engine, Gateway

        cfg = get_config("granite-8b").smoke()
        eng = Engine(cfg, lm.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), max_len=32)
        gw = Gateway(eng, slots=2, chunk=2)
        prompt = np.random.default_rng(60).integers(
            0, cfg.vocab_size, 8).astype(np.int32)
        gw.result(gw.submit(prompt, 4, deadline_steps=100))
        fams = promparse.parse(metrics.REGISTRY.prometheus_text())
        assert "repro_gateway_requests_total" in fams
        hists = [f for f in fams.values() if f.type == "histogram"]
        assert hists
        for f in hists:
            assert f.series("_count")

    def test_series_property_shim(self):
        fam = metrics.Counter("t_shim", "", ("pool",))

        class Layer:
            hits = metrics.series_property("hits")

            def __init__(self):
                self._obs_series = {"hits": fam.labels(pool="p")}

        layer = Layer()
        layer.hits += 3
        assert layer.hits == 3
        assert fam.series() == {'{pool="p"}': 3}

    def test_disabled_instruments_still_function(self, monkeypatch):
        monkeypatch.setenv("REPRO_OBS", "0")
        c = metrics.counter("t_disabled_counter", "", ())
        c.inc(5)
        assert c.default.value == 5
        assert metrics.REGISTRY.get("t_disabled_counter") is None
        assert "t_disabled_counter" not in metrics.snapshot()


# ---------------------------------------------------------------------------
# the registry against the JAX package's on the same inputs
# ---------------------------------------------------------------------------

_BUCKETS = ((0.001, 0.01, 0.1, 1.0), (1.0, 2.0, 4.0, 8.0), (0.5,))
_HOSTILE = ("plain", 'q"uote', "back\\slash", "new\nline", "ünï€ode")


def _fill(pkg, seed: int):
    """A fresh ``Registry`` of ``pkg`` (``metrics`` of either package)
    holding seeded counters, gauges and histograms, some with hostile
    label values."""
    rng = np.random.default_rng(seed)
    reg = pkg.Registry()
    c = reg.register(pkg.Counter(f"t_c{seed}", 'requests "served"\n',
                                 ("pool", "path")))
    g = reg.register(pkg.Gauge(f"t_g{seed}", "occupancy", ("bank",)))
    u = reg.register(pkg.Counter(f"t_u{seed}", "label-less", ()))
    hs = [reg.register(pkg.Histogram(f"t_h{seed}_{i}", f"latency {i}",
                                     ("k",), buckets=b))
          for i, b in enumerate(_BUCKETS)]
    for _ in range(int(rng.integers(20, 60))):
        c.inc(int(rng.integers(1, 5)), pool=str(rng.integers(0, 3)),
              path=_HOSTILE[rng.integers(0, len(_HOSTILE))])
    for b in range(3):
        g.set(float(rng.normal()), bank=b)
    u.inc(int(rng.integers(0, 100)))
    for h in hs:
        for v in rng.exponential(1.5, int(rng.integers(0, 200))):
            h.observe(float(v), k=str(rng.integers(0, 2)))
    return reg


@pytest.mark.parametrize("seed", range(5))
def test_prometheus_text_bytes_equal_jax(seed):
    got = _fill(metrics, seed).prometheus_text()
    want = _fill(jmetrics, seed).prometheus_text()
    assert got.encode() == want.encode()
    jfams = jpromparse.parse(got)               # JAX's parser accepts it
    assert set(jfams) == set(promparse.parse(want))


@pytest.mark.parametrize("seed", range(5))
def test_snapshot_equals_jax(seed):
    got = _fill(metrics, seed).snapshot()
    assert got == _fill(jmetrics, seed).snapshot()
    json.dumps(got)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_quantiles_equal_jax(q):
    rng = np.random.default_rng(7)
    vals = np.concatenate([rng.exponential(2.0, 300), [0.0, 100.0]])
    got = metrics.Histogram("t_qe", "", (), buckets=_BUCKETS[1])
    want = jmetrics.Histogram("t_qe", "", (), buckets=_BUCKETS[1])
    for v in vals:
        got.observe(float(v))
        want.observe(float(v))
    assert got.default.quantile(q) == want.default.quantile(q)
    assert got.series() == want.series()


def test_reset_zeroes_like_jax():
    reg, jreg = _fill(metrics, 3), _fill(jmetrics, 3)
    reg.reset()
    jreg.reset()
    assert reg.prometheus_text() == jreg.prometheus_text()
    assert reg.snapshot() == jreg.snapshot()


# ---------------------------------------------------------------------------
# trace export (tests/test_obs.py::TestExport)
# ---------------------------------------------------------------------------

class TestExport:
    def test_chrome_trace_structure_and_validation(self):
        tr = tracing.Tracer()
        with tr.span("tick", cat="gateway", vclock=lambda: 5):
            tr.instant("grant")
        tr.counter("depth", 3)
        obj = export.chrome_trace(tr)
        counts = export.validate_chrome_trace(obj)
        assert counts == {"tick": 1, "grant": 1, "depth": 1}
        evs = {e["name"]: e for e in obj["traceEvents"] if e["ph"] != "M"}
        assert evs["tick"]["ph"] == "X" and evs["tick"]["dur"] >= 0
        assert evs["tick"]["args"]["vstep"] == 5
        assert evs["grant"]["ph"] == "i"
        assert evs["depth"]["ph"] == "C"
        assert any(e["ph"] == "M" for e in obj["traceEvents"])
        json.dumps(obj)

    def test_validation_rejects_malformed(self):
        with pytest.raises(ValueError, match="traceEvents"):
            export.validate_chrome_trace({"events": []})
        bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 1,
                                "ts": 0.0, "dur": -1.0}]}
        with pytest.raises(ValueError, match="negative"):
            export.validate_chrome_trace(bad)
        with pytest.raises(ValueError, match="phase"):
            export.validate_chrome_trace(
                {"traceEvents": [{"ph": "?", "name": "a", "pid": 1}]})

    def test_write_trace_roundtrip(self, tmp_path):
        tr = tracing.Tracer()
        with tr.span("s"):
            pass
        path = tmp_path / "trace.json"
        export.write_trace(str(path), tr)
        assert export.validate_chrome_trace(
            json.loads(path.read_text())) == {"s": 1}

    def test_write_metrics_formats(self, tmp_path):
        c = metrics.counter("t_wm", "help text", ())
        before = c.default.value
        c.inc(2)
        prom = tmp_path / "m.prom"
        export.write_metrics(str(prom))
        assert f"t_wm {before + 2}" in prom.read_text()
        j = tmp_path / "m.json"
        export.write_metrics(str(j), fmt="json")
        assert json.loads(j.read_text())["t_wm"]["series"][""] == before + 2
        with pytest.raises(ValueError, match="format"):
            export.write_metrics(str(j), fmt="xml")


_NAMES = ("gateway.tick", "pool.admission", "pool.prefill",
          "pool.decode_chunk", "pool.commit_packed", "ünï€ode \"span\"")


def _events(pkg, seed: int, n: int) -> list:
    """``n`` seeded ``SpanEvent``s of ``pkg`` (``tracing`` of either
    package): spans, instants and counter samples over three threads,
    with and without the virtual clock and args."""
    rng = np.random.default_rng(seed)
    tids = [int(t) for t in rng.integers(1, 2**40, 3)]
    out, ts = [], float(rng.uniform(1e3, 1e5))
    for i in range(n):
        ts += float(rng.exponential(1e-4))
        kind = int(rng.integers(0, 3))
        vstep = int(rng.integers(0, 500)) if rng.random() < 0.6 else None
        args = ({"i": i, "x": float(rng.normal())}
                if rng.random() < 0.5 else None)
        name = _NAMES[rng.integers(0, len(_NAMES))]
        if kind == 2:
            out.append(pkg.SpanEvent(
                name=name, cat="__counter__.serve", ts=ts, dur=None,
                tid=tids[0], depth=0, args={"value": int(rng.integers(9))}))
            continue
        out.append(pkg.SpanEvent(
            name=name, cat="pool", ts=ts,
            dur=float(rng.exponential(1e-3)) if kind == 0 else None,
            tid=tids[rng.integers(0, 3)], depth=int(rng.integers(0, 3)),
            vstep=vstep,
            vdur=(int(rng.integers(0, 8))
                  if vstep is not None and kind == 0 else None),
            args=args))
    return out


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 37), (3, 600)])
def test_chrome_trace_bytes_equal_jax(seed, n):
    got = export.chrome_trace(_events(tracing, seed, n))
    want = jexport.chrome_trace(_events(jtracing, seed, n))
    assert json.dumps(got, indent=1) == json.dumps(want, indent=1)
    assert jexport.validate_chrome_trace(got) == \
        export.validate_chrome_trace(want)


@pytest.mark.parametrize("per_chunk", [1, 7, 256, 10_000])
def test_trace_chunks_bytes_equal_jax(per_chunk):
    evs, jevs = _events(tracing, 4, 300), _events(jtracing, 4, 300)
    got = "".join(export.iter_trace_chunks(evs, events_per_chunk=per_chunk))
    want = "".join(jexport.iter_trace_chunks(jevs,
                                             events_per_chunk=per_chunk))
    assert got.encode() == want.encode()
    assert got == json.dumps(export.chrome_trace(evs), indent=1)
    jexport.validate_chrome_trace(json.loads(got))


def test_trace_of_a_live_tracer_validates_under_jax():
    tr = tracing.Tracer()
    clock = {"v": 0}
    for i in range(20):
        with tr.span("tick", vclock=lambda: clock["v"], args={"i": i}):
            with tr.span("chunk"):
                clock["v"] += 2
            tr.instant("grant", vstep=clock["v"])
        tr.counter("depth", i)
    counts = jexport.validate_chrome_trace(export.chrome_trace(tr))
    assert counts == {"tick": 20, "chunk": 20, "grant": 20, "depth": 20}


def test_obs_package_exports():
    assert obs.enabled() in (True, False)
    assert callable(obs.span) and callable(obs.audit)
    assert obs.REGISTRY is metrics.REGISTRY
    assert obs.TRACER is tracing.TRACER
    import repro.obs as jobs
    assert sorted(obs.__all__) == sorted(jobs.__all__)
