"""The port's §6.3 histogram, §7.7 sorts and §8 super ops — the reference
modules, the ``histogram``, ``super_sum`` / ``super_limit`` and
``oddeven_sort`` kernels' plain twins, and ``CPMArray`` on both backends
— against the JAX package.

Held here on the CPU, on seeded NumPy inputs (and the inputs of
``tests/test_core.py``, ``test_properties.py`` and ``test_sort_ops.py``):

  * integer, bool and sort results bit for bit, ``-0.0`` and NaN
    included (the port's ``jnp.minimum`` / ``jnp.maximum`` order -0.0
    below +0.0 as JAX does; NaN is held by position, not by payload:
    XLA's choice between two NaN payloads follows no simple rule);
  * float32 sums bit for bit where both sides add in the same order (the
    §8 trees), and to ``rtol=1e-5`` where a kernel's in-section order
    differs (the JAX package's own tolerance for float sums);
  * every float sort also against ``np.sort``, subnormals included, which
    the JAX sorts flush to zero on this CPU (ROADMAP Queue 3): rows with
    subnormals are held against NumPy only;
  * the reference algorithms' loop trips against the op table.

The ``cuda``-marked tests hold each CUDA kernel against its twin on the
card and skip here.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference; the GPU machine has no JAX
    import jax.numpy as jnp

    from repro.cpm import CPMArray as JArray
    from repro.cpm import cpm_array as jcpm_array
    from repro.cpm.reference import comparable as jcomparable
    from repro.cpm.reference import computable as jcomputable
    from repro.cpm.reference import movable as jmovable
    from repro.cpm.reference import pe_array as jpe_array
    from repro.cpm.reference import searchable as jsearchable
    from repro.kernels import cpm_kernels as JK
except ImportError:
    jnp = None

from repro_torch.cpm import CPMArray, cpm_array  # noqa: E402
from repro_torch.cpm import backends as B  # noqa: E402
from repro_torch.cpm import tuning  # noqa: E402
from repro_torch.cpm.optable import op_steps, optimal_section  # noqa: E402
from repro_torch.cpm.reference import (comparable, computable,  # noqa: E402
                                       movable, pe_array, searchable)
from repro_torch.cpm.reference.trips import count_trips  # noqa: E402
from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _static_tuning(tmp_path_factory):
    """The cuda backend's plain twins would calibrate the cost model and
    tune sections on CPU rows, at random: keep this file's tests on the
    static defaults (the cost model's priors), any spill in a temporary
    directory and never the user's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_CPM_TUNING_CACHE",
                  str(tmp_path_factory.mktemp("tuning") / "cpm.json"))
        mp.setenv("REPRO_TORCH_CPM_AUTOTUNE", "0")
        mp.setenv("REPRO_TORCH_CPM_CALIBRATE", "0")
        tuning.clear()
        yield
    tuning.clear()


@pytest.fixture(autouse=True)
def _needs_reference(request):
    """Tests that compare with JAX skip where JAX is missing (the GPU
    machine, where only the ``cuda``-marked tests are run)."""
    if jnp is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs JAX, the reference package")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.c_contiguous else a.copy())


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _bits(a):
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "f":
        return a.view({2: np.uint16, 4: np.uint32}[a.itemsize])
    return a


def _same(got, want):
    """Dtype and shape equal; values bit for bit, except that NaN equals
    NaN whatever its payload."""
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind == "f":
        nan = np.isnan(got)
        np.testing.assert_array_equal(nan, np.isnan(want))
        np.testing.assert_array_equal(_bits(np.where(nan, 0, got)),
                                      _bits(np.where(nan, 0, want)))
    else:
        np.testing.assert_array_equal(got, want)


def _np_sorted(got, x, used=None):
    """Each row of ``got`` whose used prefix holds no NaN has
    ``np.sort``'s values there (the network orders -0.0 before +0.0,
    which NumPy does not; values compare equal)."""
    got, x = _np(got).reshape(-1, x.shape[-1]), x.reshape(-1, x.shape[-1])
    used = np.broadcast_to(x.shape[-1] if used is None else used,
                           x.shape[:1])
    for r in range(x.shape[0]):
        row = x[r, :used[r]]
        if not np.isnan(row).any():
            np.testing.assert_array_equal(got[r, :used[r]], np.sort(row))


def _ints(shape, seed, lo=-50, hi=50, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _floats(shape, seed, special=True):
    """Normal float32 rows; with ``special`` a NaN, +-inf and both signed
    zeros are planted (no subnormals: the JAX sorts flush them)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if special:
        flat = x.reshape(-1)
        k = flat.size
        flat[[k // 7, k // 3]] = [0.0, -0.0]
        flat[[k // 5, (2 * k) // 3]] = [-0.0, 0.0]
        if k >= 8:
            flat[k // 2] = np.nan
            flat[[1, k - 2]] = [np.inf, -np.inf]
    return x


# ---------------------------------------------------------------------------
# the reference modules against their JAX functions
# ---------------------------------------------------------------------------

class TestSuperReference:
    @pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9, 16, 17])
    @pytest.mark.parametrize("mode", ["sum", "max", "min"])
    def test_tree_combine(self, k, mode):
        from repro_torch.cpm.semantics import maximum, minimum

        x = _floats((3, k), seed=k, special=k >= 8)
        jcomb = {"sum": jnp.add, "max": jnp.maximum, "min": jnp.minimum}
        tcomb = {"sum": torch.add, "max": maximum, "min": minimum}
        ident = {"sum": 0.0, "max": -np.inf, "min": np.inf}[mode]
        want = jcomputable.tree_combine(jnp.asarray(x), jcomb[mode], ident)
        with count_trips() as trips:
            got = computable.tree_combine(_t(x), tcomb[mode], ident)
        _same(got, want)
        assert trips.n == max(0, (k - 1).bit_length())

    @pytest.mark.parametrize("dtype", [np.int32, np.int8, np.uint8,
                                       np.float32, np.float16, np.bool_])
    @pytest.mark.parametrize("n,section", [(1, None), (130, None),
                                           (130, 16), (1000, 7)])
    def test_super_sum_and_limit(self, n, section, dtype):
        if dtype == np.bool_:
            x = _ints((2, n), seed=n) > 0
        elif np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            x = _ints((2, n), n, info.min // 2, info.max // 2, dtype)
        else:
            x = _floats((2, n), seed=n).astype(dtype)
        with count_trips() as trips:
            got = computable.super_sum(_t(x), section)
        _same(got, jcomputable.super_sum(jnp.asarray(x), section))
        assert trips.n == op_steps("super_sum", n=n, section=section)
        for mode in ("max", "min"):
            with count_trips() as trips:
                got = computable.super_limit(_t(x), section, mode)
            _same(got, jcomputable.super_limit(jnp.asarray(x), section,
                                               mode))
            assert trips.n == op_steps("super_limit", n=n, section=section)

    def test_super_int_sums_equal_section_sum(self):
        """Integer super sums wrap in 32 bits exactly as the two-phase sum
        does (``tests/test_cpm_array.py`` TestSuperOps inputs)."""
        x = _ints((11, 130), 0, 0, 1 << 16)
        x[0] = np.iinfo(np.int32).max // 3
        _same(computable.super_sum(_t(x)), computable.section_sum(_t(x)))


class TestSortReference:
    @pytest.mark.parametrize("steps", [None, 0, 1, 7, 16])
    @pytest.mark.parametrize("n", [1, 2, 33, 64])
    def test_odd_even_sort_int(self, n, steps):
        x = _ints((3, n), seed=n + 1)
        with count_trips() as trips:
            got = computable.odd_even_sort(_t(x), steps)
        _same(got, jcomputable.odd_even_sort(jnp.asarray(x), steps))
        assert trips.n == (n if steps is None else steps)
        if steps is None:
            _same(got, np.sort(x, -1))

    @pytest.mark.parametrize("steps", [None, 1, 2, 5])
    def test_odd_even_sort_float_signed_zeros_and_nan(self, steps):
        """Bit for bit with JAX: ``jnp.minimum(-0.0, 0.0)`` is -0.0 (and
        ``jnp.maximum`` +0.0) on this CPU, and NaN spreads through its
        pairs, cycle by cycle."""
        x = _floats((4, 40), seed=3)
        x[3] = [0.0, -0.0] * 20
        got = computable.odd_even_sort(_t(x), steps)
        _same(got, jcomputable.odd_even_sort(jnp.asarray(x), steps))
        if steps is None:
            _np_sorted(got, x)
            assert np.signbit(got[3, :20].numpy()).all()
        pair = jnp.asarray([-0.0, 0.0], jnp.float32)
        assert np.signbit(np.asarray(jnp.minimum(pair, pair[::-1]))).all()
        assert not np.signbit(np.asarray(jnp.maximum(pair,
                                                     pair[::-1]))).any()

    def test_full_sort_keeps_subnormals(self):
        """The odd-even network with ``np.sort``'s answer, subnormals
        included (held against NumPy only: the JAX sort flushes them)."""
        tiny = np.float32(1e-40)
        x = np.asarray([[tiny, 0.0, -tiny, 1.0, 3e-39, -1e-45, 2.0]],
                       np.float32)
        _same(computable.odd_even_sort(_t(x)), np.sort(x, -1))
        rng = np.random.default_rng(4)
        y = (rng.standard_normal((3, 50)) * 1e-39).astype(np.float32)
        _same(computable.odd_even_sort(_t(y)), np.sort(y, -1))
        _same(computable.hybrid_sort(_t(y[0])), np.sort(y[0]))

    @pytest.mark.parametrize("seed", range(6))
    def test_odd_even_full_sort_test_core_inputs(self, seed):
        """``tests/test_core.py::test_odd_even_full_sort``'s draw (floats in
        [-50, 50], 2-64 of them), from seeds."""
        rng = np.random.default_rng(100 + seed)
        vals = rng.uniform(-50, 50, rng.integers(2, 65)).astype(np.float32)
        got = computable.odd_even_sort(_t(vals))
        _same(got, np.sort(vals))
        _same(got, jcomputable.odd_even_sort(jnp.asarray(vals)))

    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("kind", ["float", "int"])
    def test_hybrid_sort(self, seed, kind):
        rng = np.random.default_rng(200 + seed)
        n = int(rng.integers(2, 49))
        vals = (rng.uniform(-50, 50, n).astype(np.float32) if kind == "float"
                else rng.integers(-20, 20, n).astype(np.int32))
        got = computable.hybrid_sort(_t(vals))
        _same(got, np.sort(vals))
        _same(got, jcomputable.hybrid_sort(jnp.asarray(vals)))

    @pytest.mark.parametrize("n", [64, 256, 1000])
    def test_hybrid_sort_steps(self, n):
        """The local phase runs ``optimal_section(n)`` exchange cycles (the
        trips JAX reads off its jaxpr, ``tests/test_sort_ops.py``), and
        ``hybrid_sort_steps`` adds the N/M global moves, as in JAX."""
        x = _floats((n,), seed=n, special=False)
        with count_trips() as trips:
            got = computable.hybrid_sort(_t(x))
        _same(got, np.sort(x))
        m = optimal_section(n)
        assert trips.n == m
        assert computable.hybrid_sort_steps(n) == m + -(-n // m) \
            == jcomputable.hybrid_sort_steps(n) == op_steps("hybrid_sort",
                                                            n=n)
        assert op_steps("sort", n=n) == n

    def test_count_disorder_and_defects(self):
        for v in ([1, 2, 3], [3, 2, 1], [5, 1, 4, 4, 0]):
            for desc in (False, True):
                _same(computable.count_disorder(_t(np.int32(v)), desc),
                      jcomputable.count_disorder(jnp.asarray(v, jnp.int32),
                                                 desc))
        for v in ([1.0, 2, 9, 3, 4], [5.0, 6, 1, 7, 8], [1.0, 3, 2, 4, 5],
                  _floats((20,), seed=5, special=False)):
            x = np.asarray(v, np.float32)
            got = computable.detect_defects(_t(x))
            want = jcomputable.detect_defects(jnp.asarray(x))
            for key in ("peak", "valley", "fault"):
                _same(got[key], want[key])
        x = _ints((3, 30), seed=6)
        got = computable.detect_defects(_t(x))
        want = jcomputable.detect_defects(jnp.asarray(x))
        for key in ("peak", "valley", "fault"):
            _same(got[key], want[key])


class TestComparableReference:
    @pytest.mark.parametrize("seed", range(4))
    def test_histogram_test_core_inputs(self, seed):
        """``tests/test_core.py::test_histogram_matches_numpy``'s draw."""
        rng = np.random.default_rng(300 + seed)
        vals = rng.integers(0, 256, rng.integers(1, 33)).astype(np.int32)
        edges = np.asarray([0, 64, 128, 192, 256], np.int32)
        with count_trips() as trips:
            got = comparable.histogram(_t(vals), _t(edges))
        _same(got, jcomparable.histogram(jnp.asarray(vals),
                                         jnp.asarray(edges)))
        _same(got, np.histogram(vals, bins=edges)[0].astype(np.int32))
        assert trips.n == op_steps("histogram", n=vals.size, m=4)

    @pytest.mark.parametrize("case", ["int", "fractional", "nan",
                                      "unordered", "int8_wide_edges"])
    def test_histogram_cases(self, case):
        x = _ints((3, 200), seed=7, lo=0, hi=100)
        edges = np.asarray([0, 10, 25, 50, 99], np.int32)
        if case == "fractional":
            edges = np.asarray([0, 9.5, 10.5, 50.25, 99.5], np.float32)
        elif case == "nan":
            x = x.astype(np.float32)
            x[0, ::7] = np.nan
            edges = np.asarray([0, 10, np.nan, 50, 99], np.float32)
        elif case == "unordered":
            edges = np.asarray([50, 10, 70, 0, 99], np.int32)
        elif case == "int8_wide_edges":
            x = x.astype(np.int8)
            edges = np.asarray([-300, 10, 50, 300], np.int32)
        _same(comparable.histogram(_t(x), _t(edges)),
              jcomparable.histogram(jnp.asarray(x), jnp.asarray(edges)))

    def test_lex_compare_and_quantile(self):
        words = np.asarray([[1, 9], [2, 0], [1, 2], [2, 1]], np.int32)
        datum = np.asarray([2, 1], np.int32)
        with count_trips() as trips:
            got = comparable.lex_compare_lt(_t(words), _t(datum))
        _same(got, jcomparable.lex_compare_lt(jnp.asarray(words),
                                              jnp.asarray(datum)))
        assert trips.n == 2
        x = np.linspace(0.0, 1.0, 100, dtype=np.float32)
        for k in (1, 10, 50):
            _same(comparable.quantile_threshold(_t(x), k, 0.0, 1.0),
                  jcomparable.quantile_threshold(jnp.asarray(x), k, 0.0,
                                                 1.0))


class TestPeArrayAndMovesReference:
    def test_decoder_stages(self):
        _same(pe_array.carry_pattern(8, 3), jpe_array.carry_pattern(8, 3))
        bits = np.random.default_rng(8).random(64) < 0.3
        for s in (0, 1, 5, 33, 63):
            _same(pe_array.parallel_shift(_t(bits), s),
                  jpe_array.parallel_shift(jnp.asarray(bits), s))
            _same(pe_array.all_line(64, s), jpe_array.all_line(64, s))
        for start, end, carry in ((0, 63, 1), (3, 9, 1), (4, 20, 4),
                                  (10, 5, 2), (17, 60, 7), (63, 63, 16)):
            got = pe_array.general_decoder(64, start, end, carry)
            _same(got, jpe_array.general_decoder(64, start, end, carry))
            _same(got, pe_array.activation_mask(64, start, end, carry))

    def test_first_match_and_find_all(self):
        for m in ([False, True, False, True, True], [False] * 7):
            match = np.asarray(m)
            _same(pe_array.first_match(_t(match)),
                  jpe_array.first_match(jnp.asarray(match)))
        hay, needle = np.int32(list(b"aaaa")), np.int32(list(b"aa"))
        got = searchable.find_all(_t(hay), _t(needle), 4)
        want = jsearchable.find_all(jnp.asarray(hay), jnp.asarray(needle), 4)
        for a, b in zip(got, want):
            _same(a, b)
        hay = np.int32(list(b"abracadabra"))
        got = searchable.find_all(_t(hay), _t(np.int32(list(b"abra"))), 3)
        want = jsearchable.find_all(jnp.asarray(hay),
                                    jnp.asarray(np.int32(list(b"abra"))), 3)
        for a, b in zip(got, want):
            _same(a, b)

    @pytest.mark.parametrize("src,length,dst", [(2, 3, 6), (6, 3, 2),
                                                (2, 4, 4), (0, 10, 0),
                                                (7, 5, 1)])
    def test_move_object(self, src, length, dst):
        x = np.arange(10, dtype=np.int32)
        _same(movable.move_object(_t(x), src, length, dst),
              jmovable.move_object(jnp.asarray(x), src, length, dst))
        xb = np.arange(20, dtype=np.int32).reshape(2, 10)
        _same(movable.move_object(_t(xb), src, length, dst),
              jmovable.move_object(jnp.asarray(xb), src, length, dst))


# ---------------------------------------------------------------------------
# the kernels' plain twins against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

class TestTwinsAgainstPallas:
    @pytest.mark.parametrize("case", ["int", "fractional", "nan",
                                      "unordered", "int8", "bool"])
    @pytest.mark.parametrize("shape,section", [((1, 1), 1), ((3, 300), 64),
                                               ((2, 1000), 128)])
    def test_histogram(self, shape, section, case):
        x = _ints(shape, seed=shape[1], lo=0, hi=100)
        edges = np.asarray([0, 10, 25, 50, 99], np.int32)
        if case == "fractional":
            edges = np.asarray([0, 9.5, 10.5, 50.25, 99.5], np.float32)
        elif case == "nan":
            x = x.astype(np.float32)
            x[0, ::5] = np.nan
        elif case == "unordered":
            edges = np.asarray([50, 10, 70, 0, 99, 20], np.int32)
        elif case == "int8":
            x = (x - 50).astype(np.int8)
            edges = np.asarray([-40, -10, 0, 10, 40], np.int8)
        elif case == "bool":
            x = x > 50
            edges = np.asarray([0, 1, 2], np.int32)
        want = JK.histogram(jnp.asarray(x), jnp.asarray(edges), section,
                            interpret=True)
        _same(TK.histogram_plain(_t(x), _t(edges), section), want)

    @pytest.mark.parametrize("dtype", [np.int32, np.int8, np.uint8,
                                       np.float32, np.bool_])
    @pytest.mark.parametrize("shape,section", [((1, 1), 1), ((3, 300), 64),
                                               ((2, 1000), 100)])
    def test_super_sum_and_limit(self, shape, section, dtype):
        if dtype == np.bool_:
            x = _ints(shape, seed=9) > 0
        elif np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            x = _ints(shape, 9, info.min // 2, info.max // 2, dtype)
            if dtype == np.int32:
                x[0] = info.max // 3                    # wraps in int32
        else:
            x = _floats(shape, seed=9)
        xj = jnp.asarray(x)
        got = TK.super_sum_plain(_t(x), section)
        want = JK.super_sum(xj, section, interpret=True)
        if dtype == np.float32:     # in-section order differs: jnp.sum
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        else:
            _same(got, want)
        for mode in ("max", "min"):
            _same(TK.super_limit_plain(_t(x), section, mode),
                  JK.super_limit(xj, section, mode, interpret=True))

    def test_super_limit_signed_zeros(self):
        """-0.0 < +0.0 in both phases, whatever the order (a row of each
        arrangement of the two zeros, in one section and across several)."""
        x = np.asarray([[0.0, -0.0, -0.0, -0.0], [-0.0, 0.0, -0.0, -0.0],
                        [-0.0, -0.0, -0.0, -0.0], [0.0, 0.0, 0.0, -0.0]],
                       np.float32)
        for section in (1, 2, 4):
            for mode in ("max", "min"):
                want = JK.super_limit(jnp.asarray(x), section, mode,
                                      interpret=True)
                _same(TK.super_limit_plain(_t(x), section, mode), want)
                _same(TK.section_limit_plain(_t(x), section, mode),
                      JK.section_limit(jnp.asarray(x), section, mode,
                                       interpret=True))

    @pytest.mark.parametrize("steps", [None, 1, 6])
    @pytest.mark.parametrize("kind", ["int32", "int8", "float32", "bool"])
    @pytest.mark.parametrize("shape", [(1, 1), (3, 33), (2, 64)])
    def test_oddeven_sort(self, shape, kind, steps):
        if kind == "float32":
            x = _floats(shape, seed=shape[1])
        elif kind == "bool":
            x = _ints(shape, seed=shape[1]) > 0
        else:
            x = _ints(shape, seed=shape[1]).astype(kind)
        want = JK.oddeven_sort(jnp.asarray(x), steps, interpret=True)
        got = TK.oddeven_sort_plain(_t(x), steps)
        _same(got, want)
        if steps is None:
            _np_sorted(got, x)

    def test_wrappers_run_the_twins_on_cpu_uncounted(self):
        x = _t(_ints((3, 40), seed=10))
        e = _t(np.int32([-50, 0, 25, 50]))
        ops.reset_launch_counts()
        assert torch.equal(TK.histogram(x, e, 8),
                           TK.histogram_plain(x, e, 8))
        assert torch.equal(TK.super_sum(x, 8), TK.super_sum_plain(x, 8))
        assert torch.equal(TK.super_limit(x, 8, "min"),
                           TK.super_limit_plain(x, 8, "min"))
        assert torch.equal(TK.oddeven_sort(x, 5),
                           TK.oddeven_sort_plain(x, 5))
        assert torch.equal(ops.sort(x), ops.sort(x, impl="kernel"))
        assert torch.equal(ops.sort(x, impl="ref"), torch.sort(x).values)
        assert torch.equal(ops.section_sum(x, section=8),
                           computable.section_sum(x))
        counts = ops.launch_counts()
        assert set(counts) >= {"histogram", "super_sum", "super_limit",
                               "oddeven_sort"}
        assert all(v == 0 for v in counts.values())


class TestOddEvenPlan:
    """The kernel's tiles for rows longer than a block's shared memory:
    a tile computes ``halo`` cycles of its interior exactly.  The tiling
    is replayed here in NumPy, pass by pass, with the plan's numbers."""

    @staticmethod
    def _tiled(x, steps, interior, halo, passes):
        n = x.shape[-1]
        src, done = x.copy(), 0
        for _ in range(passes):
            cycles = steps if passes == 1 else min(halo, steps - done)
            dst = np.empty_like(src)
            for i0 in range(0, n, interior):
                i1 = min(n, i0 + interior)
                lo, hi = max(0, i0 - halo), min(n, i1 + halo)
                v = src[..., lo:hi].copy()
                for c in range(cycles):
                    a0 = (((done + c) & 1) - lo) & 1
                    for a in range(a0, hi - lo - 1, 2):
                        left, right = v[..., a].copy(), v[..., a + 1].copy()
                        v[..., a] = np.minimum(left, right)
                        v[..., a + 1] = np.maximum(right, left)
                dst[..., i0:i1] = v[..., i0 - lo:i1 - lo]
            src, done = dst, done + cycles
        assert done == steps
        return src

    @pytest.mark.parametrize("n,steps", [(64, 64), (200, 7), (200, 16),
                                         (200, 40), (333, 333), (130, 0)])
    def test_halo_tiles_equal_the_whole_row(self, n, steps):
        interior, halo, passes = TK.oddeven_plan(n, steps, tile=64)
        if n > 64:
            assert interior + 2 * halo <= 64 and halo <= 16
            assert passes * max(halo, 1) >= steps
        x = _ints((2, n), seed=n + steps)
        got = self._tiled(x, steps, interior, halo, passes)
        _same(got, computable.odd_even_sort(_t(x), steps))

    def test_plan_at_the_card_shapes(self):
        assert TK.oddeven_plan(16384, 16384) == (16384, 0, 1)
        assert TK.oddeven_plan(16385, 10) == (16384 - 20, 10, 1)
        interior, halo, passes = TK.oddeven_plan(1 << 20, 1024)
        assert (halo, passes) == (1024, 1) and interior == 16384 - 2048
        assert TK.oddeven_plan(1 << 20, 1 << 20)[2] == 256


# ---------------------------------------------------------------------------
# CPMArray on both backends against the JAX CPMArray
# ---------------------------------------------------------------------------

def _pair(x, ul, backend):
    t = cpm_array(_t(x), _t(np.asarray(ul, np.int32)), backend=backend,
                  device="cpu")
    return t, jcpm_array(x, np.asarray(ul, np.int32), backend="reference")


class TestCPMArray:
    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    @pytest.mark.parametrize("dtype", [np.int32, np.int8, np.float32])
    def test_batched_ops(self, dtype, backend):
        """``(2, 3, N)`` rows with ragged ``used_len`` (0 and N included)."""
        n = 1100
        if dtype == np.float32:
            x = _floats((6, n), seed=11).reshape(2, 3, n)
            edges = np.asarray([-1.5, -0.5, 0.0, 0.5, 1.5], np.float32)
        else:
            x = _ints((2, 3, n), seed=11, lo=-100, hi=100).astype(dtype)
            edges = np.asarray([-100, -30, 0, 2.5, 30, 100], np.float32)
        ul = [[n, 700, 0], [1, 513, 1024]]
        t, j = _pair(x, ul, backend)
        _same(t.histogram(edges), j.histogram(edges))
        for mode in ("max", "min"):
            _same(t.super_limit(mode), j.super_limit(mode))
        got, want = t.super_sum(), j.super_sum()
        if dtype == np.float32 and backend == "cuda":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        else:
            _same(got, want)
        for steps in (None, 3, 32):
            if steps is None and dtype == np.float32 and backend == "cuda":
                continue        # NaN rows: see test_full_sort_with_nan_rows
            ts, js = t.sort(steps, fill=-7), j.sort(steps, fill=-7)
            _same(ts.data, js.data)
            _same(ts.used_len, js.used_len)
            if steps is None:
                _np_sorted(ts.data, x, np.asarray(ul).reshape(-1))
        assert t.steps_report() == j.steps_report()
        assert t.steps_report(needle_len=3, bins=16, section=32) == \
            j.steps_report(needle_len=3, bins=16, section=32)

    def test_full_sort_with_nan_rows(self):
        """The two backends differ on a row with NaN, as in JAX: the
        reference's ``torch.sort`` puts NaN last (``jnp.sort``), the
        kernel backend's exchange network spreads it through its pairs
        (the JAX ``pallas`` backend)."""
        x = _floats((3, 33), seed=12)
        ul = [33, 20, 5]
        ref, jref = _pair(x, ul, "reference")
        _same(ref.sort().data, jref.sort().data)
        cuda = cpm_array(_t(x), _t(np.int32(ul)), backend="cuda",
                         device="cpu")
        jpal = JArray(jnp.asarray(x), jnp.asarray(ul, jnp.int32),
                      backend="pallas", interpret=True)
        _same(cuda.sort().data, jpal.sort().data)
        assert not np.array_equal(np.isnan(ref.sort().data.numpy()),
                                  np.isnan(cuda.sort().data.numpy()))
        for r, u in enumerate(ul):     # rows without NaN: np.sort's values
            row = x[r, :u]              # (the network puts -0.0 first)
            if not np.isnan(row).any():
                np.testing.assert_array_equal(cuda.sort().data[r, :u],
                                              np.sort(row))

    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    def test_sort_bool_and_uint8_rows(self, backend):
        x = _ints((2, 50), seed=13) > 0
        t, j = _pair(x, [50, 31], backend)
        _same(t.sort(fill=False).data, j.sort(fill=False).data)
        x8 = _ints((2, 50), seed=13, lo=0, hi=255, dtype=np.uint8)
        t, j = _pair(x8, [50, 31], backend)
        _same(t.sort(fill=3).data, j.sort(fill=3).data)
        _same(t.sort(5).data, j.sort(5).data)

    def test_test_sort_ops_inputs(self):
        """``tests/test_sort_ops.py``'s shapes: one row with a used prefix,
        (4, 33) rows with lengths [33, 17, 5, 0], and a (2, 3, 16) batch."""
        for n, used in ((64, 64), (130, 100), (96, 17)):
            x = _ints((n,), seed=n)
            for backend in ("reference", "cuda"):
                t, j = _pair(x, used, backend)
                _same(t.sort(fill=-99).data, j.sort(fill=-99).data)
                _same(t.sort(fill=-99).data[:used], np.sort(x[:used]))
        x = _ints((4, 33), seed=6, lo=-20, hi=20)
        for backend in ("reference", "cuda"):
            t, j = _pair(x, [33, 17, 5, 0], backend)
            _same(t.sort(fill=-1).data, j.sort(fill=-1).data)
        x = _ints((2, 3, 16), seed=7, lo=0, hi=99)
        t, j = _pair(x, [[16, 9, 4], [1, 16, 12]], "cuda")
        _same(t.sort().data, j.sort().data)

    def test_find_all(self):
        data = np.tile(np.int32([[1, 2, 1, 2, 1, 2, 0, 0]]), (3, 1))
        t, j = _pair(data, [8, 8, 2], "reference")
        for a, b in zip(t.find_all(np.int32([1, 2]), max_out=2),
                        j.find_all(np.int32([1, 2]), max_out=2)):
            _same(a, b)
        x = _ints((130,), seed=14, lo=0, hi=4)
        auto, j = _pair(x, 100, "auto")
        for a, b in zip(auto.find_all(x[5:8], 8), j.find_all(x[5:8], 8)):
            _same(a, b)
        cuda = cpm_array(_t(x), 100, backend="cuda", device="cpu")
        for a, b in zip(cuda.find_all(_t(x[5:8]), 8), j.find_all(x[5:8], 8)):
            _same(a, b)

    def test_ops_are_recordable(self):
        from repro_torch.cpm.program import record

        x = _ints((2, 40), seed=15)
        arr = CPMArray(_t(x), _t(np.int32([40, 22])))
        with record() as prog:
            h = arr.histogram(np.int32([-50, 0, 50]))
            s = arr.super_sum()
            idx, _ = arr.find_all(np.int32([1, 2]), 3)
            out = arr.sort(4)
        assert [i.op for i in prog.instructions] == [
            "histogram", "super_sum", "find_all", "sort"]
        j = jcpm_array(x, np.int32([40, 22]))
        _same(h, j.histogram(np.int32([-50, 0, 50])))
        _same(s, j.super_sum())
        _same(out.data, j.sort(4).data)
        _same(idx, j.find_all(np.int32([1, 2]), 3)[0])

    def test_backend_routes(self):
        for op in ("histogram", "super_sum", "super_limit", "sort"):
            assert B.get_backend("reference").supports(op)
            assert B.get_backend("cuda").supports(op)
            assert B.resolve("auto", op, torch.zeros(4096)).name \
                == "reference"                  # CPU rows


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card(dev, x):
    return _t(x).to(dev)


def _nan_equal(a, b):
    return bool(((a == b) | (torch.isnan(a.float())
                             & torch.isnan(b.float()))).all())


def _bit_equal(a, b):
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return a.dtype == b.dtype and torch.equal(
        a.view(view[a.element_size()]), b.view(view[b.element_size()]))


_CARD_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16,
                torch.int32, torch.float16, torch.bfloat16, torch.float32]


def _card_rows(dev, r, n, dtype, seed):
    x = (np.random.default_rng(seed).standard_normal((r, n)) * 60)
    return _card(dev, x.astype(np.float32)).to(dtype)


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("m", [1, 8, 64, 256, 700])
    @pytest.mark.parametrize("r,n,section", [(1, 1, 1), (3, 1000, 64),
                                             (5, 4099, 1024),
                                             (4, 300000, 1024)])
    def test_histogram_int(self, cuda_device, r, n, section, m):
        x = _card(cuda_device, _ints((r, n), seed=n, lo=0, hi=4096))
        edges = torch.linspace(-10, 4100, m + 1, device=cuda_device)
        for e in (edges.round().to(torch.int32), edges):
            got = TK.histogram(x, e, section)
            assert torch.equal(got, TK.histogram_plain(x, e, section))

    @pytest.mark.parametrize("dtype", _CARD_DTYPES)
    def test_histogram_dtypes_nan_and_unordered(self, cuda_device, dtype):
        x = _card_rows(cuda_device, 3, 5000, dtype, 1)
        if dtype.is_floating_point:
            x[0, ::9] = float("nan")
        edges = torch.tensor([40, -30, 0, 1, 2, 100, -100, 5],
                             device=cuda_device).to(dtype)
        got = TK.histogram(x, edges, 256)
        assert torch.equal(got, TK.histogram_plain(x, edges, 256))

    @pytest.mark.parametrize("r,n,section", [(1, 1, 1), (3, 1000, 64),
                                             (5, 4099, 64), (2, 16384, 128),
                                             (64, 1 << 20, 1024),
                                             (2, 100000, 3)])
    @pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
    def test_super_ops(self, cuda_device, r, n, section, dtype):
        x = _card_rows(cuda_device, r, n, dtype, r + n)
        got, want = TK.super_sum(x, section), TK.super_sum_plain(x, section)
        if dtype == torch.float32:
            ref = x.double().sum(-1)
            tol = 1e-5 * x.double().abs().sum(-1)
            assert bool(((got.double() - ref).abs() <= tol).all())
        else:
            assert torch.equal(got, want)
            assert torch.equal(got, TK.section_sum(x, section))
        for mode in ("max", "min"):
            got = TK.super_limit(x, section, mode)
            assert _bit_equal(got, TK.super_limit_plain(x, section, mode))
            assert _bit_equal(got, TK.section_limit(x, section, mode))

    @pytest.mark.parametrize("dtype", _CARD_DTYPES)
    def test_super_dtypes_nan_and_zeros(self, cuda_device, dtype):
        x = _card_rows(cuda_device, 5, 3000, dtype, 2)
        if dtype.is_floating_point:
            x[0, 17] = float("nan")
            x[1] = 0.0
            x[1, ::3] = -0.0
            x[2] = -0.0
        for section in (64, 1000):
            for mode in ("max", "min"):
                got = TK.super_limit(x, section, mode)
                want = TK.super_limit_plain(x, section, mode)
                assert _nan_equal(got, want)
                keep = ~torch.isnan(got.float())
                assert _bit_equal(got[keep], want[keep])
            got, want = TK.super_sum(x, section), TK.super_sum_plain(x,
                                                                     section)
            assert got.dtype == want.dtype
            if not dtype.is_floating_point and dtype != torch.bool:
                assert torch.equal(got, want)
            else:
                assert _nan_equal(got, want) or bool(torch.allclose(
                    got, want, rtol=1e-5, atol=1e-3, equal_nan=True))

    @pytest.mark.parametrize("steps", [None, 0, 1, 7, 128])
    @pytest.mark.parametrize("r,n", [(1, 1), (2, 2), (3, 17), (3, 1000),
                                     (2, 16383), (2, 16384)])
    def test_oddeven_sort_matches_twin(self, cuda_device, r, n, steps):
        for dtype in (torch.int32, torch.float32):
            x = _card_rows(cuda_device, r, n, dtype, n + 3)
            if dtype == torch.float32 and n >= 8:
                x[0, n // 2], x[0, 1], x[-1, 3] = float("nan"), -0.0, 0.0
            got = TK.oddeven_sort(x, steps)
            assert _bit_equal(got, TK.oddeven_sort_plain(x, steps))
            if steps is None and dtype == torch.int32:
                assert torch.equal(got, torch.sort(x).values)

    @pytest.mark.parametrize("n,steps", [(16385, 3), (58113, 5000),
                                         (200000, 300), (200000, 20000),
                                         (70000, 0)])
    def test_oddeven_long_rows_halo_passes(self, cuda_device, n, steps):
        for dtype in (torch.int32, torch.float32):
            x = _card_rows(cuda_device, 2, n, dtype, n)
            if dtype == torch.float32:      # a NaN tile, signed zeros
                x[1, n // 3], x[0, 7], x[0, 9000] = float("nan"), 0.0, -0.0
            got = TK.oddeven_sort(x, steps)
            assert _bit_equal(got, TK.oddeven_sort_plain(x, steps))

    @pytest.mark.parametrize("n", [31, 33, 255, 257, 513, 1023, 1025, 4097,
                                   8193, 12345, 16384])
    def test_oddeven_sweep_of_block_widths(self, cuda_device, n):
        """Block widths across the one-tile sort's range (ceil(n / 16)
        threads rounded up to whole warps), every dtype: full sorts give
        torch.sort's values, bounded ones with NaN and signed zeros the
        twin's bits — the exchange across threads through shared memory
        at each thread count and in each key type."""
        for dtype in _CARD_DTYPES:
            x = _card_rows(cuda_device, 3, n, dtype, n)
            assert torch.equal(TK.oddeven_sort(x).float(),
                               torch.sort(x.float()).values), dtype
            if dtype.is_floating_point:
                x[1, n // 2], x[2, 1], x[2, n - 1] = float("nan"), -0.0, 0.0
            for steps in (1, 2, 33):
                assert _bit_equal(TK.oddeven_sort(x, steps),
                                  TK.oddeven_sort_plain(x, steps)), \
                    (dtype, steps)

    @pytest.mark.parametrize("dtype", _CARD_DTYPES)
    def test_oddeven_dtypes(self, cuda_device, dtype):
        x = _card_rows(cuda_device, 3, 3000, dtype, 4)
        if dtype.is_floating_point:
            x[1, 5] = float("nan")
            x[2, ::4] = -0.0
            x[2, 1::4] = 0.0
        for steps in (None, 9):
            assert _bit_equal(TK.oddeven_sort(x, steps),
                              TK.oddeven_sort_plain(x, steps))

    def test_full_sort_keeps_subnormals(self, cuda_device):
        y = (np.random.default_rng(5).standard_normal((4, 4096))
             * 1e-39).astype(np.float32)
        got = TK.oddeven_sort(_card(cuda_device, y)).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.sort(y, -1).view(np.uint32))

    def test_repeats_bit_identical_and_counted(self, cuda_device):
        x = _card_rows(cuda_device, 64, 1 << 20, torch.float32, 6)
        e = torch.linspace(-100, 100, 65, device=cuda_device)
        ops.reset_launch_counts()
        for fn in (lambda: TK.histogram(x, e, 1024),
                   lambda: TK.super_sum(x, 1024),
                   lambda: TK.super_limit(x, 1024, "min"),
                   lambda: TK.oddeven_sort(x[:, :16384].contiguous(), 64)):
            assert _bit_equal(fn(), fn())
        counts = ops.launch_counts()
        assert all(counts[k] == 2 for k in ("histogram", "super_sum",
                                            "super_limit", "oddeven_sort"))

    def test_cpm_array_launches_and_auto(self, cuda_device):
        x = _card(cuda_device, _ints((2, 4096), seed=7, lo=0, hi=100))
        short = _card(cuda_device, _ints((2, 8), seed=8, lo=0, hi=100))
        e = [0, 10, 50, 99]
        for backend in ("cuda", "auto"):
            ops.reset_launch_counts()
            arr = cpm_array(x, 4000, backend=backend)
            cpu = cpm_array(x.cpu(), 4000, backend="reference")
            assert torch.equal(arr.histogram(e).cpu(), cpu.histogram(e))
            assert torch.equal(arr.super_sum().cpu(), cpu.super_sum())
            assert torch.equal(arr.super_limit("min").cpu(),
                               cpu.super_limit("min"))
            assert torch.equal(arr.sort(fill=-1).data.cpu(),
                               cpu.sort(fill=-1).data)
            assert torch.equal(arr.sort(9).data.cpu(), cpu.sort(9).data)
            counts = ops.launch_counts()
            assert (counts["histogram"], counts["super_sum"],
                    counts["super_limit"], counts["oddeven_sort"]) == \
                (1, 1, 1, 2)
        ops.reset_launch_counts()
        arr = cpm_array(short, 6)
        arr.histogram(e), arr.super_sum(), arr.super_limit(), arr.sort()
        assert not any(ops.launch_counts().values())
