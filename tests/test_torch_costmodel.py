"""The port's cost-priced instruction streams: the tuning cache, the
launch/byte cost model, the scheduler's cost-aware branch, eager dispatch,
autotuned sections and row blocks, the ``auto`` crossover lookup, the
commit scheduled by cost, and the cycle ledger.

Held against the JAX package where it runs on this jax: with explicit
``CostParams(..., source="override")`` (which never reach the JAX
``tuning.measurable()``, broken on jax 0.9.0), the port's ``group_cost``,
``decide`` and ``schedule(prog, device=..., cost=...)`` kinds and
``decision`` fields equal JAX's over a grid of streams, geometries and
coefficients.  Held to their invariants elsewhere: eager plans equal fused
plans bit for bit; tuned sections and row blocks give the untuned bits;
nothing is measured under ``torch.compile`` or with the switches off; a
calibration writes only the port's spill.  Every test points
``REPRO_TORCH_CPM_TUNING_CACHE`` at a temporary file and clears the
in-process cache.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference; the GPU machine has no JAX
    import jax.numpy as jnp

    from repro.cpm import CPMProgram as JProgram
    from repro.cpm import cpm_array as jcpm_array
    from repro.cpm.program import CostParams as JCost
    from repro.cpm.program import costmodel as jcostmodel
    from repro.cpm.program import schedule as jschedule
    from repro.cpm.program import \
        scan_structured_steps as jscan_structured_steps
except ImportError:
    jnp = None

from repro_torch.cpm import CPMProgram, cpm_array, record, tuning  # noqa: E402
from repro_torch.cpm import backends as B  # noqa: E402
from repro_torch.cpm.optable import optimal_section  # noqa: E402
from repro_torch.cpm.program import (CostParams, costmodel,  # noqa: E402
                                     executors, group_cost, roofline_params,
                                     run_plan, scan_structured_steps,
                                     schedule)
from repro_torch.cpm.program.ir import Instruction  # noqa: E402
from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.obs import cycles  # noqa: E402
from repro_torch.serve import program_paths  # noqa: E402

#: launch-dominated machine: fusing always pays
FUSE_PARAMS = (1e-5, 1e-12, 1e-5, 1e-12)
#: launch-free machine with a pricier fused byte slope: never fuse
EAGER_PARAMS = (1e-9, 1e-12, 1e-9, 2e-12)
#: near the margin: the verdict turns on the geometry
EDGE_PARAMS = (2e-6, 2e-13, 2.4e-6, 2.2e-13)
#: a fused launch ten times cheaper than an eager one: even the one-launch
#: commit (truncate costs no launch) fuses
CHEAP_FUSED_LAUNCH = (1e-5, 1e-12, 1e-6, 1e-12)
#: the H100 priors' shape (one launch cost, the byte rate for both)
PRIOR_PARAMS = (22.5e-6, 1 / 3.35e12, 22.5e-6, 1 / 3.35e12)


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    """The port's spill in a temporary file, the switches at their
    defaults, the in-process cache empty."""
    spill = tmp_path / "cpm_tuning.json"
    monkeypatch.setenv("REPRO_TORCH_CPM_TUNING_CACHE", str(spill))
    monkeypatch.delenv("REPRO_TORCH_CPM_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_CPM_CALIBRATE", raising=False)
    tuning.clear(in_process_only=False)
    yield spill
    tuning.clear()


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jnp is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs JAX, the reference package")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cost(params, port=True):
    return (CostParams if port else JCost)(*params, source="override")


# ---------------------------------------------------------------------------
# streams built alike in both packages
# ---------------------------------------------------------------------------

def _pipeline(P, A, n):
    return (P().append("shift", start=0, end=n // 2, shift=1, fill=0)
            .append("insert", pos=5, values=A(np.arange(3)))
            .append("compare", datum=3, op="lt")
            .append("activate", start=0, end=n - 1, carry=2)
            .append("stencil", taps=(1.0, 2.0, 1.0), wrap=False))


def _commit(P, A, n):
    return (P().append("insert", pos=n // 3, values=A(np.arange(4)))
            .append("truncate", new_len=n // 3 + 2))


def _walled(P, A, n):
    return (P().append("delete", pos=3, k=2, fill=0)
            .append("template_match", template=A(np.arange(5)))
            .append("section_sum")
            .append("substring_match", needle=A(np.arange(3)))
            .append("truncate", new_len=n - 9)
            .append("sort", steps=4)
            .append("activate", start=1, end=n // 2, carry=3))


_STREAMS = {"pipeline": _pipeline, "commit": _commit, "walled": _walled}
_GEOMETRY = [((), 256, np.int32), ((4,), 1024, np.float32),
             ((64,), 16384, np.int32), ((2, 3), 512, np.int8)]


def _devices(lead, n, dtype):
    x = np.zeros((*lead, n), dtype)
    return (cpm_array(_t(x), n, backend="cuda", device="cpu"),
            jcpm_array(jnp.asarray(x), n, backend="pallas", interpret=True))


class TestAgainstJax:
    @pytest.mark.parametrize("params", [FUSE_PARAMS, EAGER_PARAMS,
                                        EDGE_PARAMS, PRIOR_PARAMS,
                                        CHEAP_FUSED_LAUNCH])
    @pytest.mark.parametrize("geometry", _GEOMETRY)
    @pytest.mark.parametrize("stream", sorted(_STREAMS))
    def test_schedule_kinds_and_decisions(self, stream, geometry, params):
        lead, n, dtype = geometry
        dev, jdev = _devices(lead, n, dtype)
        prog = _STREAMS[stream](CPMProgram,
                                lambda a: _t(a.astype(np.int32)), n)
        jprog = _STREAMS[stream](JProgram,
                                 lambda a: jnp.asarray(a, jnp.int32), n)
        plan = schedule(prog, device=dev, cost=_cost(params))
        jplan = jschedule(jprog, device=jdev, cost=_cost(params, False))
        assert [g.kind for g in plan.groups] == \
            [g.kind for g in jplan.groups]
        assert [g.indices for g in plan.groups] == \
            [g.indices for g in jplan.groups]
        assert [g.decision for g in plan.groups] == \
            [g.decision for g in jplan.groups]
        for g, jg in zip(plan.groups, jplan.groups):
            if g.kind == "boundary":
                continue
            rows = int(np.prod(lead)) if lead else 1
            itemsize = np.dtype(dtype).itemsize
            assert group_cost(g.instructions, rows, n, itemsize,
                              _cost(params)) == \
                jcostmodel.group_cost(jg.instructions, rows, n, itemsize,
                                      _cost(params, False))
        assert plan.steps_report(n)["total"] == \
            jplan.steps_report(n)["total"]
        assert scan_structured_steps(prog, n) == \
            jscan_structured_steps(jprog, n)

    @pytest.mark.parametrize("params", [FUSE_PARAMS, EAGER_PARAMS,
                                        EDGE_PARAMS])
    @pytest.mark.parametrize("rows,n,itemsize", [(1, 8, 4), (4, 1024, 4),
                                                 (64, 1 << 20, 1)])
    def test_decide_equals_jax(self, params, rows, n, itemsize):
        instrs = list(_pipeline(CPMProgram, _t, n).instructions)
        jinstrs = list(_pipeline(JProgram, jnp.asarray, n).instructions)
        assert costmodel.decide(instrs, rows, n, itemsize, _cost(params)) \
            == jcostmodel.decide(jinstrs, rows, n, itemsize,
                                 _cost(params, False))

    def test_constants_equal_jax(self):
        assert costmodel.FUSE_MARGIN == jcostmodel.FUSE_MARGIN
        # the port settles every calibrated verdict by measurement: its
        # band holds JAX's and every other ratio
        lo, hi = costmodel.MEASURE_BAND
        jlo, jhi = jcostmodel.MEASURE_BAND
        assert lo <= min(jlo, 0.0) and hi >= max(jhi, float("inf"))
        assert costmodel._PROBE_SIZES == jcostmodel._PROBE_SIZES
        assert [i.op for i in costmodel._probe_program(64)] == \
            [i.op for i in jcostmodel._probe_program(64)]


# ---------------------------------------------------------------------------
# the cost-aware schedule and eager dispatch
# ---------------------------------------------------------------------------

def _spied(monkeypatch):
    """Count the kernel wrappers' calls (on CPU rows they run the twins
    and count no launch)."""
    calls = {}
    for name in ("fused_stream", "shift_range", "activate", "compare",
                 "stencil", "template_match"):
        fn = getattr(TK, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(TK, name, spy)
    return calls


class TestCostAwareSchedule:
    def test_bare_schedule_keeps_fuse_all(self):
        plan = schedule(_pipeline(CPMProgram, _t, 256))
        assert [g.kind for g in plan.groups] == ["fused"]
        assert plan.groups[0].decision is None

    def test_launch_bound_params_fuse(self):
        dev = cpm_array(torch.zeros(256, dtype=torch.int32), 256,
                        backend="cuda", device="cpu")
        plan = schedule(_pipeline(CPMProgram, _t, 256), device=dev,
                        cost=_cost(FUSE_PARAMS))
        assert [g.kind for g in plan.groups] == ["fused"]
        assert plan.groups[0].decision["fuse"] is True
        assert "1 fused_stream launch" in plan.describe()

    def test_byte_bound_params_fall_back_to_eager(self):
        dev = cpm_array(torch.zeros(256, dtype=torch.int32), 256,
                        backend="cuda", device="cpu")
        plan = schedule(_pipeline(CPMProgram, _t, 256), device=dev,
                        cost=_cost(EAGER_PARAMS))
        assert [g.kind for g in plan.groups] == ["eager"]
        d = plan.groups[0].decision
        assert d["fuse"] is False and d["eager_us"] < d["fused_us"]
        text = plan.describe()
        assert "per-op dispatch (cost model)" in text and "[override]" in text

    @pytest.mark.parametrize("backend", ["reference", "auto"])
    def test_reference_backend_skips_cost_decisions(self, backend):
        dev = cpm_array(torch.zeros(256, dtype=torch.int32), 256,
                        backend=backend, device="cpu")
        plan = schedule(_pipeline(CPMProgram, _t, 256), device=dev,
                        cost=_cost(EAGER_PARAMS))
        assert [g.kind for g in plan.groups] == ["fused"]
        assert plan.groups[0].decision is None

    def test_eager_group_dispatches_per_op(self, monkeypatch):
        n = 256
        data = _t(np.random.default_rng(0).integers(0, 9, n)
                  .astype(np.int32))
        dev = cpm_array(data, n, backend="cuda", device="cpu")
        calls = _spied(monkeypatch)
        eager = schedule(_pipeline(CPMProgram, _t, n), device=dev,
                         cost=_cost(EAGER_PARAMS))
        run_plan(eager, dev)
        assert calls == {"shift_range": 2, "compare": 1, "activate": 1,
                         "stencil": 1}
        calls.clear()
        fused = schedule(_pipeline(CPMProgram, _t, n), device=dev,
                         cost=_cost(FUSE_PARAMS))
        run_plan(fused, dev)
        assert calls == {"fused_stream": 1}

    @pytest.mark.parametrize("lead,used", [((), 200), ((3,), [256, 97, 4]),
                                           ((2, 2), 180)])
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    @pytest.mark.parametrize("stream", sorted(_STREAMS))
    def test_eager_plan_bit_identical_to_fused(self, lead, used, dtype,
                                               stream):
        n = 256
        rng = np.random.default_rng(len(lead))
        data = _t(rng.integers(0, 9, (*lead, n)).astype(dtype))
        dev = cpm_array(data, torch.tensor(used, dtype=torch.int32),
                        backend="cuda", device="cpu")
        prog = _STREAMS[stream](CPMProgram,
                                lambda a: _t(a.astype(dtype)), n)
        fused = schedule(prog, device=dev, cost=_cost(FUSE_PARAMS))
        eager = schedule(prog, device=dev, cost=_cost(EAGER_PARAMS))
        assert "eager" in [g.kind for g in eager.groups]
        of, pf = run_plan(fused, dev)
        oe, pe = run_plan(eager, dev)
        ro, rp = run_plan(fused, dev, backend="reference")
        for a, b in ((of.data, oe.data), (of.used_len, oe.used_len),
                     (of.data, ro.data)):
            assert torch.equal(a, b)
        for a, b, c in zip(pf, pe, rp):
            if a is not None:
                assert torch.equal(a, b) and torch.equal(a, c)

    def test_steps_report_surfaces_decisions(self):
        dev = cpm_array(torch.zeros(256, dtype=torch.int32), 256,
                        backend="cuda", device="cpu")
        plan = schedule(_pipeline(CPMProgram, _t, 256), device=dev,
                        cost=_cost(EAGER_PARAMS))
        rep = plan.steps_report(256)
        assert rep["total"] == plan.predicted_steps(256)
        (entry,) = rep["schedule"]
        assert entry["kind"] == "eager"
        assert entry["decision"]["params"] == "override"

    def test_truncate_cost_metadata_is_free(self):
        t = Instruction("truncate", {"new_len": 3})
        params = _cost(EAGER_PARAMS)
        fused_s, eager_s = group_cost([t], 1, 1024, 4, params)
        assert eager_s == 0.0 and fused_s == params.fused_launch_s

    def test_priors_take_no_tpu_constant(self):
        """The priors' byte slope is the H100's 3.35 TB/s and their launch
        term the card's measured per-call time; they fuse multi-op runs
        and leave the one-launch commit eager (truncate costs nothing)."""
        params = roofline_params()
        assert params.eager_byte_s == params.fused_byte_s == 1 / 3.35e12
        assert params.launch_s == params.fused_launch_s == costmodel.LAUNCH_S
        prog = _pipeline(CPMProgram, _t, 4096)
        fused_s, eager_s = group_cost(list(prog.instructions), 1, 4096, 4,
                                      params)
        assert fused_s < costmodel.FUSE_MARGIN * eager_s
        commit = list(_commit(CPMProgram, _t, 320).instructions)
        assert not costmodel.decide(commit, 4, 320, 4, params)["fuse"]

    @pytest.mark.parametrize("n,dtype,fits", [
        (29056, torch.int32, True), (29057, torch.int32, False),
        (64, torch.int8, False), (64, torch.float32, True)])
    def test_long_cuda_rows_replay_per_op(self, n, dtype, fits):
        """A fused group whose rows the kernel cannot hold on the card
        (two resident copies over 232,448 bytes: more than 29,056 int32
        lanes; or a dtype other than int32 / float32) replays per op; on
        the CPU the twin takes any rows."""
        arr = cpm_array(torch.zeros(n, dtype=dtype), n, device="cpu")
        assert executors.fits_fused_stream(arr)
        card = type("OnCard", (), {"data": type("T", (), {"is_cuda": True})(),
                                   "dtype": dtype, "n": n})()
        assert executors.fits_fused_stream(card) == fits


# ---------------------------------------------------------------------------
# tuning: pick, tuned sections and row blocks, the switches, measurability
# ---------------------------------------------------------------------------

class TestAutotune:
    def test_pick_caches_and_spills(self, isolated_cache):
        calls = []

        def run(c):
            calls.append(c)
            return torch.zeros(4) + c

        first = tuning.pick("t:unit", [1, 2, 3], run, default=1, reps=1)
        assert first in (1, 2, 3)
        n_calls = len(calls)
        again = tuning.pick("t:unit", [1, 2, 3], run, default=1, reps=1)
        assert again == first and len(calls) == n_calls       # cache hit
        assert json.loads(isolated_cache.read_text())["t:unit"] == first
        tuning.clear(in_process_only=False)                    # reloads
        assert tuning.lookup("t:unit") == first
        assert tuning.entries("t:") == {"t:unit": first}

    def test_failing_candidates_are_disqualified(self):
        def run(c):
            if c != 2:
                raise ValueError("invalid for the shape")
            return torch.zeros(1)
        def broken(c):
            raise RuntimeError("CUDA error")

        assert tuning.pick("t:fail", [1, 2, 3], run, default=9) == 2
        assert tuning.pick("t:none", [1], run, default=9) == 9
        assert tuning.lookup("t:none") is None
        # a failed build or launch is not a refused shape: it surfaces
        with pytest.raises(RuntimeError, match="CUDA error"):
            tuning.pick("t:broken", [1, 2], broken, default=9)
        assert tuning.lookup("t:broken") is None

    def test_switches_off_fall_back_uncached(self, isolated_cache,
                                             monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_CPM_AUTOTUNE", "0")
        monkeypatch.setenv("REPRO_TORCH_CPM_CALIBRATE", "0")
        assert tuning.pick("t:off", [1, 2], lambda c: torch.zeros(2),
                           default=7) == 7
        assert costmodel.params_for("cpu") == roofline_params()
        x = _t(np.arange(3 * 4096, dtype=np.int32).reshape(3, 4096) % 50)
        assert torch.equal(
            cpm_array(x, backend="cuda", device="cpu").section_sum(),
            TK.section_sum_plain(x, optimal_section(4096)))
        assert not isolated_cache.exists()
        assert tuning.entries() == {}

    def test_nothing_is_measured_under_torch_compile(self, isolated_cache,
                                                     monkeypatch):
        assert tuning.measurable()
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert not tuning.measurable()
        assert tuning.pick("t:traced", [1, 2], lambda c: torch.zeros(4),
                           default=9) == 9
        assert costmodel.params_for("cpu").source == "roofline"
        dev = cpm_array(torch.arange(16), 12, device="cpu")
        with record() as prog:
            dev.compare(3, "lt")
        with pytest.raises(RuntimeError, match="torch.compile"):
            cycles.audit(prog, dev)
        assert not isolated_cache.exists()
        tuning.store("t:traced", 2)                 # an earlier decision
        assert tuning.pick("t:traced", [1, 2], lambda c: 0, default=9) == 2

    @pytest.mark.parametrize("r,n", [(1, 2048), (3, 4099), (2, 6000)])
    def test_tuned_sections_bit_identical_to_untuned(self, r, n):
        """Integer rows give the untuned bits at any section; float rows
        give the twin's at the tuned section (regrouped float sums)."""
        rng = np.random.default_rng(n)
        xi = _t(rng.integers(-50, 50, (r, n)).astype(np.int32))
        xf = _t(rng.standard_normal((r, n)).astype(np.float32))
        bk = B.get_backend("cuda")
        assert torch.equal(bk.section_sum(xi),
                           TK.section_sum_plain(xi, 97))
        assert torch.equal(bk.super_limit(xi, "max"),
                           TK.super_limit_plain(xi, 64, "max"))
        key = f"section:section_sum|{r}x{n}|int32|cuda-twin-cpu"
        assert tuning.lookup(key) in {min(c, n) for c in
                                      (optimal_section(n), 256, 1024,
                                       4096, n)}
        got = bk.section_sum(xf)
        sec = tuning.lookup(f"section:section_sum|{r}x{n}|float32"
                            f"|cuda-twin-cpu")
        assert torch.equal(got, TK.section_sum_plain(xf, sec))
        edges = _t(np.asarray([-40, -10, 0, 10, 40], np.int32))
        assert torch.equal(bk.histogram(xi, edges),
                           TK.histogram_plain(xi, edges, 64))
        assert torch.equal(bk.section_sum(xi, section=7),
                           TK.section_sum_plain(xi, 7))   # explicit: no tune

    def test_block_r_tuning_gives_the_same_bits(self):
        r, n = 8, 4096                               # r * n = 2**15: tunes
        rng = np.random.default_rng(5)
        data = _t(rng.integers(0, 9, (r, n)).astype(np.int32))
        used = _t(rng.integers(100, n, r).astype(np.int32))
        dev = cpm_array(data, used, backend="cuda", device="cpu")
        prog = _commit(CPMProgram, lambda a: _t(a.astype(np.int32)), n) \
            .append("compare", datum=4, op="lt")
        out, outs = schedule(prog).run(dev, backend="cuda")
        keys = tuning.entries("blockr:")
        assert len(keys) == 1 and next(iter(keys.values())) in (1, 8)
        ref, routs = schedule(prog).run(dev, backend="reference")
        assert torch.equal(out.data, ref.data)
        assert torch.equal(out.used_len, ref.used_len)
        assert torch.equal(outs[2], routs[2])
        descs = (("insert", (("k", 2),), 2), ("truncate", (), 1))
        opnds = (_t(np.full((r, 1), 50, np.int32)),
                 _t(np.ones((1, 2), np.int32)), _t(np.full((1, 1), 70,
                                                           np.int32)))
        one = TK.fused_stream_plain(data, used, descs, opnds, block_r=1)
        for br in executors._blockr_candidates(r):
            got = TK.fused_stream_plain(data, used, descs, opnds,
                                        block_r=br)
            assert all(torch.equal(a, b) for a, b in zip(one[:2], got[:2]))

    def test_executor_block_r_threshold(self):
        descs = (("compare", (("op", "eq"), ("has_mask", False),
                              ("ct", "int32")), 1),)
        got = executors._fused_block_r(
            descs, (torch.zeros((1, 1), dtype=torch.int32),),
            torch.zeros((2, 64), dtype=torch.int32), 2, 64)
        assert got == 1 and tuning.entries() == {}


class TestCalibration:
    def test_calibration_spills_and_reloads(self, isolated_cache):
        params = costmodel.params_for("cpu")
        assert params.source == "calibrated"
        assert min(params.as_dict()[k] for k in
                   ("launch_s", "eager_byte_s", "fused_launch_s",
                    "fused_byte_s")) > 0
        spilled = json.loads(isolated_cache.read_text())
        assert spilled["calib:cuda-twin-cpu"]["source"] == "calibrated"
        assert costmodel.params_for("cpu") == params          # cached

    def test_calibration_touches_only_the_port_spill(self, tmp_path,
                                                     monkeypatch):
        """With ``HOME`` elsewhere and the JAX package's switches set to
        refuse, the port still calibrates (it reads no ``REPRO_CPM_*``
        variable) and writes its spill under ``~/.cache/repro_torch/``,
        nothing under ``~/.cache/repro/``."""
        home = tmp_path / "home"
        monkeypatch.setenv("HOME", str(home))
        monkeypatch.delenv("REPRO_TORCH_CPM_TUNING_CACHE")
        monkeypatch.setenv("REPRO_CPM_TUNING_CACHE",
                           str(tmp_path / "jax.json"))
        monkeypatch.setenv("REPRO_CPM_AUTOTUNE", "0")
        monkeypatch.setenv("REPRO_CPM_CALIBRATE", "0")
        tuning.clear(in_process_only=False)
        assert costmodel.params_for("cpu").source == "calibrated"
        assert (home / ".cache" / "repro_torch" / "cpm_tuning.json").is_file()
        assert not (home / ".cache" / "repro").exists()
        assert not (tmp_path / "jax.json").exists()
        src = Path(tuning.__file__).resolve().parents[1]
        for f in src.rglob("*.py"):
            assert "REPRO_CPM_" not in f.read_text(), f

    @pytest.mark.parametrize("exc,surfaces", [(ValueError, False),
                                              (TypeError, False),
                                              (RuntimeError, True)])
    def test_probe_failures(self, isolated_cache, monkeypatch, exc,
                            surfaces):
        """A probe the wrappers refuse prices with the priors, uncached; a
        failed kernel build or launch raises instead of changing the
        verdict."""
        def failing(device):
            raise exc("probe failed")

        monkeypatch.setattr(costmodel, "calibrate", failing)
        if surfaces:
            with pytest.raises(exc, match="probe failed"):
                costmodel.params_for("cpu")
        else:
            assert costmodel.params_for("cpu") == roofline_params()
        assert tuning.lookup("calib:cuda-twin-cpu") is None

    @pytest.mark.parametrize("source,measured", [("calibrated", True),
                                                 ("override", False),
                                                 ("roofline", False)])
    def test_calibrated_verdicts_are_measured(self, source, measured):
        """A calibrated prediction far from a tie (fused / eager = 10) is
        still settled by timing the group (the twins here), and cached;
        priors and overrides keep the model's verdict."""
        params = CostParams(1e-9, 1e-12, 1e-8, 1e-12, source=source)
        instrs = (CPMProgram().append("insert", pos=2, values=[5, 6])
                  .append("truncate", new_len=9).instructions)
        d = costmodel.decide(instrs, 4, 32, 4, params, lead=(4,),
                             dtype=torch.int32, device="cpu")
        assert d["params"] == ("measured" if measured else source)
        assert bool(tuning.entries("fuse:")) == measured
        if not measured:
            assert d["fuse"] is False

    def test_measured_fuse_surfaces_launch_failures(self, monkeypatch):
        """``_measured_fuse`` (a calibrated near-tie settled by timing)
        returns None for a group the wrappers refuse and raises on a
        failed launch."""
        instrs = (CPMProgram().append("compare", datum=3, op="lt")
                  .append("activate", start=0, end=7, carry=1)
                  .instructions)
        for exc, surfaces in ((ValueError, False), (RuntimeError, True)):
            def failing(*a, exc=exc, **k):
                raise exc("launch failed")

            monkeypatch.setattr(costmodel, "_timed_both", failing)
            if surfaces:
                with pytest.raises(exc, match="launch failed"):
                    costmodel._measured_fuse(instrs, (), 64, torch.int32,
                                             "cpu")
            else:
                assert costmodel._measured_fuse(
                    instrs, (), 64, torch.int32, "cpu") is None

    def test_backend_key_names_the_card(self, monkeypatch):
        assert tuning.backend_key("cpu") == "cuda-twin-cpu"
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: "NVIDIA H100 80GB HBM3")
        assert tuning.backend_key("cuda") == "cuda-NVIDIA H100 80GB HBM3"


class TestCudaMinN:
    """``backend="auto"`` thresholds on a measured crossover per op, then
    pooled, then the static ``CUDA_MIN_N``."""

    def test_per_op_beats_pooled_beats_static(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: "card")
        assert B.cuda_min_n("compare") == B.CUDA_MIN_N == 1024
        tuning.store("xover:*:cuda-card", 2048)
        assert B.cuda_min_n("compare") == 2048
        tuning.store("xover:compare:cuda-card", 512)
        assert B.cuda_min_n("compare") == 512
        assert B.cuda_min_n("section_sum") == B.cuda_min_n() == 2048
        assert B.cuda_min_n("compare", "cpu") == 1024   # another key
        tuning.clear()
        assert B.cuda_min_n("compare") == 1024

    def test_measured_crossover_is_read_back(self, isolated_cache):
        """``measure_crossover`` is the producer of the keys ``cuda_min_n``
        reads: per op, the first size where the kernels (their twins on
        CPU rows) are no slower than the reference, and the pooled
        maximum."""
        sizes = (64, 256)
        found = B.measure_crossover("cpu", sizes=sizes, reps=1)
        assert set(found) == {*B.XOVER_OPS, "*"}
        for op in B.XOVER_OPS:
            assert found[op] in (*sizes, 1 << 30)
            assert B.cuda_min_n(op, "cpu") == found[op]
        assert found["*"] == max(found[op] for op in B.XOVER_OPS)
        assert B.cuda_min_n(None, "cpu") == found["*"]
        spilled = json.loads(isolated_cache.read_text())
        assert spilled["xover:*:cuda-twin-cpu"] == found["*"]

    def test_measure_crossover_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no GPU"):
            B.measure_crossover()
        assert tuning.entries("xover:") == {}

    def test_cpu_rows_stay_on_the_reference(self):
        tuning.store("xover:*:cuda-twin-cpu", 1)
        assert B.auto_backend_name(torch.zeros(4096), "compare") \
            == "reference"


# ---------------------------------------------------------------------------
# the commit scheduled by cost, and the cycle ledger
# ---------------------------------------------------------------------------

class TestCommitByCost:
    @pytest.mark.parametrize("params,kind", [(CHEAP_FUSED_LAUNCH, "fused"),
                                             (FUSE_PARAMS, "eager"),
                                             (EAGER_PARAMS, "eager")])
    def test_commit_tokens_under_both_verdicts(self, params, kind,
                                               monkeypatch):
        rng = np.random.default_rng(3)
        buf = np.zeros((4, 24), np.int32)
        buf[:, :9] = rng.integers(0, 50, (4, 9))
        used = np.asarray([9, 9, 7, 9], np.int32)
        preds = rng.integers(100, 200, (4, 4)).astype(np.int32)
        emit = np.asarray([4, 1, 2, 0], np.int32)
        args = [_t(a) for a in (buf, used, preds, emit)]
        want = program_paths.commit_tokens(*args, backend="reference")
        _, rplan = program_paths.record_commit_program(*args)
        assert rplan.groups[0].decision is None        # no decision here
        monkeypatch.setattr(costmodel, "params_for",
                            lambda device: _cost(params))
        _, plan = program_paths.record_commit_program(*args,
                                                      backend="cuda")
        assert [g.kind for g in plan.groups] == [kind]
        got = program_paths.commit_tokens(*args, backend="cuda")
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


class TestCycles:
    def test_audit_zero_drift_over_every_op(self):
        dev = cpm_array(torch.arange(64, dtype=torch.int32) % 11, 48,
                        backend="reference", device="cpu")
        with record() as prog:
            d = dev.insert(3, [7, 8]).truncate(47)
            d = d.shift(2, 20, 3, fill=0).delete(5, 2, fill=-1)
            d.activate(1, 30, 2)
            d.compare(9, "lt")
            d.count(9, "lt")
            d.substring_match([7, 8])
            d.find_all([7, 8], 4)
            d.template_match([1, 2, 3])
            d.stencil((1.0, 2.0, 1.0))
            d.histogram([0, 4, 8, 12])
            d.section_sum()
            d.global_limit("min")
            d.super_sum()
            d.super_limit("max")
            d = d.sort(steps=5)
            d = d.sort()
            d.compact(d.data % 2 == 0)
        led = cycles.CycleLedger()
        rows = cycles.audit(prog, dev, ledger=led)
        assert len(rows) == len(prog) == 19
        assert [r["drift"] for r in rows] == [0] * len(rows)
        by_op = {r["op"]: r for r in rows}
        assert by_op["substring_match"]["measured_trips"] == 2
        assert by_op["find_all"]["predicted"] == 3
        assert by_op["template_match"]["measured_trips"] == 3
        assert by_op["histogram"]["measured_trips"] == 4
        assert by_op["super_sum"]["measured_trips"] > 0
        assert all(r["launches"] == 0 for r in rows)       # CPU rows
        table = led.drift_table()
        assert all(r["drift"] == 0 for r in table)
        assert {r["family"] for r in table} == {"activate", "move",
                                                "search", "compare",
                                                "compute"}
        led.format_drift_table()

    def test_steps_report_feeds_the_ledger(self, monkeypatch):
        def search_total():
            return sum(r["predicted"] for r in cycles.LEDGER.drift_table()
                       if r["family"] == "search")

        dev = cpm_array(torch.arange(32), 24, device="cpu")
        with record() as prog:
            dev.substring_match([1, 2, 3])
        before = search_total()
        assert prog.steps_report(32)["total"] == 3
        assert search_total() == before + 3
        monkeypatch.setenv("REPRO_OBS", "0")
        prog.steps_report(32)
        assert search_total() == before + 3
