"""The port's CPM slice against the JAX package, bit for bit: the
reference functions, ``CPMArray``, and fuse-all programs run on the
port's ``reference`` and ``cuda`` backends (the latter runs the
``fused_stream`` kernel's plain twin on CPU tensors) against the JAX
``pallas`` backend in interpret mode."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.cpm import CPMArray as JArray  # noqa: E402
from repro.cpm import cpm_array as jcpm  # noqa: E402
from repro.cpm import optable as joptable  # noqa: E402
from repro.cpm import record as jrecord  # noqa: E402
from repro.cpm import schedule as jschedule  # noqa: E402
from repro.cpm import semantics as jsem  # noqa: E402
from repro.cpm.reference import comparable as jcmp  # noqa: E402
from repro.cpm.reference import movable as jmov  # noqa: E402
from repro.cpm.reference import pe_array as jpe  # noqa: E402
from repro.cpm.reference import searchable as jsearch  # noqa: E402
from repro_torch.cpm import CPMArray, cpm_array, optable, record  # noqa: E402
from repro_torch.cpm import schedule, semantics  # noqa: E402
from repro_torch.cpm.backends import get_backend, resolve  # noqa: E402
from repro_torch.cpm.program import CPMProgram, apply_instruction  # noqa: E402
from repro_torch.cpm.reference import (comparable, movable,  # noqa: E402
                                       pe_array, searchable)


def _eq(jv, tv):
    a = np.asarray(jv)
    b = tv.numpy() if isinstance(tv, torch.Tensor) else np.asarray(tv)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


T = torch.from_numpy
J = jnp.asarray


class TestReferenceFunctions:
    rng = np.random.default_rng(0)
    x = rng.integers(0, 6, (3, 40)).astype(np.int32)
    row = x[0]

    @pytest.mark.parametrize("args", [(40, 3, 30, 1), (40, 5, 37, 4),
                                      (40, -3, 12, 0), (40, 20, 10, 2)])
    def test_activation_mask(self, args):
        _eq(jpe.activation_mask(*args), pe_array.activation_mask(*args))

    @pytest.mark.parametrize("shift,fill", [(3, None), (-4, 99), (0, 5),
                                            (45, -1)])
    def test_shift_range(self, shift, fill):
        _eq(jmov.shift_range(J(self.x), 5, 30, shift, fill),
            movable.shift_range(T(self.x), 5, 30, shift, fill))

    def test_insert_delete_write_window(self):
        vals = np.array([91, 92, 93], np.int32)
        _eq(jmov.insert(J(self.row), 4, J(vals), 20),
            movable.insert(T(self.row), 4, T(vals), 20))
        _eq(jmov.delete(J(self.row), 6, 3, 25, fill=-2),
            movable.delete(T(self.row), 6, 3, 25, fill=-2))
        _eq(jmov.write_window(J(self.row), 38, J(vals)),
            movable.write_window(T(self.row), 38, T(vals)))

    def test_substring_and_enumerate(self):
        nee = self.row[7:10]
        _eq(jsearch.substring_match(J(self.x), J(nee)),
            searchable.substring_match(T(self.x), T(nee)))
        _eq(jsearch.substring_match(J(self.row), J(nee), needle_len=2),
            searchable.substring_match(T(self.row), T(nee), needle_len=2))
        ends = self.x > 3
        for a, b in zip(jpe.enumerate_matches(J(ends), 5),
                        pe_array.enumerate_matches(T(ends), 5)):
            _eq(a, b)

    def test_ngram_lookup_and_verify_draft(self):
        ctx = np.tile(np.array([1, 2, 3, 4, 5], np.int32), 6)
        for a, b in zip(jsearch.ngram_lookup(J(ctx), J(ctx[-3:]), 3),
                        searchable.ngram_lookup(T(ctx), T(ctx[-3:]), 3)):
            _eq(a, b)
        d = np.array([[1, 2, 3, 4], [1, 9, 3, 4], [0, 2, 3, 4]], np.int32)
        t = np.array([[1, 2, 3, 5], [1, 2, 3, 4], [0, 2, 3, 4]], np.int32)
        _eq(jsearch.verify_draft(J(d), J(t)), searchable.verify_draft(T(d),
                                                                       T(t)))

    def test_batched_ngram_lookup_equals_per_row(self):
        """The port batches rows where the engine vmaps in JAX."""
        ctx = self.x.copy()
        ng = ctx[:, 10:13].copy()
        got = searchable.ngram_lookup(T(ctx), T(ng), 2)
        for i in range(3):
            want = jsearch.ngram_lookup(J(ctx[i]), J(ng[i]), 2)
            _eq(want[0], got[0][i])
            _eq(want[1], got[1][i])

    @pytest.mark.parametrize("op", ["eq", "ne", "lt", "gt", "le", "ge"])
    def test_compare(self, op):
        _eq(jcmp.compare(J(self.x), J(np.int32(3)), op),
            comparable.compare(T(self.x), torch.tensor(3, dtype=torch.int32),
                               op))
        _eq(jcmp.compare(J(self.x), J(np.int32(6)), op, mask=3),
            comparable.compare(T(self.x), torch.tensor(6, dtype=torch.int32),
                               op, mask=3))

    def test_topk_mask(self):
        s = np.round(self.rng.standard_normal((4, 12)), 1).astype(np.float32)
        _eq(jcmp.topk_mask(J(s), 3), comparable.topk_mask(T(s), 3))

    def test_semantics(self):
        ends = self.x > 3
        _eq(jsem.ends_to_starts(J(ends), 3),
            semantics.ends_to_starts(T(ends), 3))
        ul = np.array([40, 7, 22], np.int32)
        _eq(jsem.window_valid(40, 4, J(ul)), semantics.window_valid(40, 4,
                                                                    T(ul)))

    def test_optable_is_the_jax_table(self):
        assert optable.fusable_ops() == joptable.fusable_ops()
        for name, spec in joptable.OP_TABLE.items():
            mine = optable.OP_TABLE[name]
            assert (mine.family, mine.paper, mine.backends, mine.fusable) \
                == (spec.family, spec.paper, spec.backends, spec.fusable)
            for n in (16, 100, 1024):
                assert optable.op_steps(name, n=n, m=4) == \
                    joptable.op_steps(name, n=n, m=4)


# ---------------------------------------------------------------------------
# CPMArray and fuse-all programs
# ---------------------------------------------------------------------------

_N, _USED = 96, 70
_DATA = np.random.default_rng(5).integers(0, 12, (_N,)).astype(np.int32)
_FDATA = (_DATA.astype(np.float32) - 5.5) / 2

_CASES = {
    "activate": lambda d, A: d.activate(3, 80, 4),
    "shift": lambda d, A: d.shift(5, 60, -2, fill=-1),
    "insert": lambda d, A: d.insert(7, A([41, 42, 43])),
    "delete": lambda d, A: d.delete(9, 3, fill=-7),
    "truncate": lambda d, A: d.truncate(33),
    "compare": lambda d, A: d.compare(4, "ge"),
    "compare_float": lambda d, A: d.compare(3.5, "lt"),
    "compare_mask": lambda d, A: d.compare(2, "eq", mask=3),
    "substring_start": lambda d, A: d.substring_match(A(_DATA[10:13])),
    "substring_end": lambda d, A: d.substring_match(A(_DATA[10:13]),
                                                    where="end"),
    "template": lambda d, A: d.template_match(
        A(_DATA[4:8].astype(np.float32))),
    "stencil": lambda d, A: d.stencil((1.0, 2.0, 1.0)),
    "stencil_wrap": lambda d, A: d.stencil((0.5, 1.0, 0.5), wrap=True),
}


def _result(x):
    if isinstance(x, (JArray, CPMArray)):
        return [x.data, x.used_len]
    if isinstance(x, tuple):
        return list(x)
    return [x]


class TestProgramsAgainstJax:
    # the bit-field compare (``mask=``) is integer-only in both packages
    @pytest.mark.parametrize("name,dt", [(n, "int32") for n in sorted(_CASES)]
                             + [(n, "float32") for n in sorted(_CASES)
                                if n != "compare_mask"])
    def test_each_fusable_op(self, name, dt):
        data = _DATA if dt == "int32" else _FDATA
        call = _CASES[name]
        with jrecord() as jprog:
            call(jcpm(data, _USED), jnp.asarray)
        jfin, jouts = jschedule(jprog).run(jcpm(data, _USED),
                                           backend="pallas", interpret=True)
        want = _result(jfin if jouts[0] is None else jouts[0])
        with record() as prog:
            rec = call(cpm_array(data, _USED, device="cpu"), torch.as_tensor)
        plan = schedule(prog)
        assert [g.kind for g in plan.groups] == ["fused"]
        for bk in ("reference", "cuda"):
            fin, outs = plan.run(cpm_array(data, _USED, device="cpu"),
                                 backend=bk)
            got = _result(fin if outs[0] is None else outs[0])
            for a, b in zip(want, got):
                _eq(a, b)
        for a, b in zip(want, _result(rec)):        # recording is eager
            _eq(a, b)

    def test_pipeline_one_fused_group(self):
        def pipe(dev, A):
            d = dev.shift(2, 30, 3)
            d = d.insert(4, A([7, 8]))
            d.compare(20, "ge")
            d.activate(0, 40, 2)
            d.stencil((1.0, 2.0, 1.0))
            return d

        data = np.random.default_rng(3).integers(0, 40, (64,)).astype(
            np.int32)
        with jrecord() as jprog:
            pipe(jcpm(data, 50), jnp.asarray)
        jfin, jouts = jschedule(jprog).run(jcpm(data, 50), backend="pallas",
                                           interpret=True)
        with record() as prog:
            pipe(cpm_array(data, 50, device="cpu"), torch.as_tensor)
        plan = schedule(prog)
        assert plan.fused_group_count == len(plan.groups) == 1
        for bk in ("reference", "cuda"):
            fin, outs = plan.run(cpm_array(data, 50, device="cpu"),
                                 backend=bk)
            _eq(jfin.data, fin.data)
            _eq(jfin.used_len, fin.used_len)
            for a, b in zip(jouts, outs):
                assert (a is None) == (b is None)
                if a is not None:
                    _eq(a, b)

    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    def test_batched_commit_per_row_operands(self, backend):
        """The serving-commit shape: (B, cap) buffer, per-row lengths."""
        buf = np.arange(40, dtype=np.int32).reshape(4, 10)
        used = np.array([5, 6, 7, 8], np.int32)
        preds = np.arange(400, 412, dtype=np.int32).reshape(4, 3)
        emit = np.array([1, 0, 3, 2], np.int32)
        jdev = JArray(J(buf), J(used))
        with jrecord() as jprog:
            jdev.insert(J(used), J(preds)).truncate(J(used + emit))
        jfin, _ = jschedule(jprog).run(JArray(J(buf), J(used)),
                                       backend="pallas", interpret=True)
        dev = CPMArray(T(buf), T(used))
        with record() as prog:
            dev.insert(T(used), T(preds)).truncate(T(used + emit))
        fin, _ = schedule(prog).run(CPMArray(T(buf), T(used)),
                                    backend=backend)
        _eq(jfin.data, fin.data)
        _eq(jfin.used_len, fin.used_len)
        _eq(used + emit, fin.used_len)

    def test_batched_per_row_producers(self):
        """Per-row needles / templates / datums on a (3, n) device with
        per-row lengths: row-by-row replay and the fused lowering both
        equal the JAX kernel."""
        rng = np.random.default_rng(8)
        data = rng.integers(0, 4, (3, 40)).astype(np.int32)
        used = np.array([40, 25, 33], np.int32)
        nee = data[:, 5:8].copy()
        tmpl = rng.standard_normal((3, 4)).astype(np.float32)
        datum = np.array([1, 2, 3], np.int32)

        def prog_of(rec, arr, A):
            with rec() as p:
                arr.substring_match(A(nee))
                arr.template_match(A(tmpl))
                arr.compare(A(datum), "ge")
                arr.stencil((0.5, 1.0, 0.25))
            return p

        jarr = JArray(J(data), J(used))
        jfin, jouts = jschedule(prog_of(jrecord, jarr, J)).run(
            jarr, backend="pallas", interpret=True)
        tarr = CPMArray(T(data), T(used))
        plan = schedule(prog_of(record, tarr, T))
        for bk in ("reference", "cuda"):
            _, outs = plan.run(tarr, backend=bk)
            for a, b in zip(jouts, outs):
                _eq(a, b)

    def test_boundary_op_splits_groups(self):
        prog = CPMProgram().append("insert", pos=2, values=[1]) \
            .append("histogram", edges=[0, 1]) \
            .append("truncate", new_len=3)
        plan = schedule(prog)
        assert [g.kind for g in plan.groups] == ["fused", "boundary",
                                                 "fused"]
        text = plan.describe()
        assert "3 groups (2 fused)" in text
        assert "1 fused_stream launch" in text and "per-op" in text

    def test_steps_report_matches_jax(self):
        def build(P):
            return P().append("shift", start=1, end=9, shift=2) \
                .append("substring_match", needle=[1, 2, 3]) \
                .append("template_match", template=[1.0, 2.0]) \
                .append("stencil", taps=(1.0, 2.0, 1.0))

        from repro.cpm import CPMProgram as JProgram
        want = build(JProgram).steps_report(64)
        assert build(CPMProgram).steps_report(64) == want


class TestBackends:
    def test_forced_cuda_backend_raises_per_op(self):
        """Every op with a TPU kernel runs on a forced cuda backend
        (``stencil`` through ``CPMArray``, ``shift_range`` on the backend
        itself, the kernels' plain twins on CPU rows) and equals JAX; an
        op with no kernel column (``hybrid_sort``) raises per op."""
        dev = cpm_array(_DATA, _USED, backend="cuda", device="cpu")
        ref = jcpm(_DATA, _USED)
        _eq(ref.stencil((1.0, 2.0, 1.0)), dev.stencil((1.0, 2.0, 1.0)))
        _eq(jmov.shift_range(J(_DATA), 0, 3, 1),
            get_backend("cuda").shift_range(T(_DATA), 0, 3, 1))
        with pytest.raises(NotImplementedError, match="hybrid_sort"):
            resolve("cuda", "hybrid_sort", T(_DATA))

    def test_forced_cuda_backend_runs_the_ported_ops(self):
        """``compare``, ``section_sum``, ``global_limit`` and ``compact``
        run on a forced cuda backend (the kernels' plain twins on CPU
        rows) and equal the JAX reference."""
        dev = cpm_array(_DATA, _USED, backend="cuda", device="cpu")
        ref = jcpm(_DATA, _USED)
        _eq(ref.compare(3, "ge"), dev.compare(3, "ge"))
        _eq(ref.count(3), dev.count(3))
        _eq(ref.section_sum(), dev.section_sum())
        _eq(ref.global_limit("min"), dev.global_limit("min"))
        keep = _DATA % 3 == 0
        jc, tc = ref.compact(keep, fill=-1), dev.compact(T(keep), fill=-1)
        _eq(jc.data, tc.data)
        _eq(jc.used_len, tc.used_len)

    def test_auto_on_cpu_is_reference(self):
        assert resolve("auto", "compare", T(_DATA)).name == "reference"

    def test_eager_replay_inside_a_program_uses_reference(self):
        """An eager replay on ``auto`` runs the reference on CPU rows; a
        forced cuda replay of ``compare`` runs its per-op kernel (the twin
        here), and so does one of ``stencil`` and ``truncate``, whose
        per-op kernels are ported now (pin compatibility: never a
        substituted realization)."""
        dev = cpm_array(_DATA, _USED, device="cpu")
        prog = CPMProgram().append("compare", datum=4, op="ge")
        got = apply_instruction(dev, prog.instructions[0], backend="auto")
        _eq(jcpm(_DATA, _USED).compare(4, "ge"), got)
        got = apply_instruction(dev, prog.instructions[0], backend="cuda")
        _eq(jcpm(_DATA, _USED).compare(4, "ge"), got)
        stencil, truncate = CPMProgram() \
            .append("stencil", taps=(1.0, 2.0, 1.0)) \
            .append("truncate", new_len=3).instructions
        _eq(jcpm(_DATA, _USED).stencil((1.0, 2.0, 1.0)),
            apply_instruction(dev, stencil, backend="cuda"))
        got = apply_instruction(dev, truncate, backend="cuda")
        assert got.backend == "cuda"
        _eq(jcpm(_DATA, _USED).truncate(3).used_len, got.used_len)

    def test_non_linear_recording_raises(self):
        dev = cpm_array(_DATA, _USED, device="cpu")
        with pytest.raises(RuntimeError, match="non-linear"):
            with record():
                dev.insert(3, [1])
                dev.truncate(4)
