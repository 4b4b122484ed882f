"""The port's per-op CPM kernels — ``compare``, ``section_sum``,
``section_limit`` and ``compact`` — and the ``cuda`` backend and
``SlotAllocator(backend="cuda")`` built on them, against the JAX package.

Held here on the CPU, on the same seeded NumPy inputs:

  * each plain twin against the JAX Pallas kernel in interpret mode, with
    an explicit ``section``, on ragged shapes, int32 / int8 / float32 rows,
    NaN and +-inf rows and limit-identity rows: bit for bit, float sums to
    ``rtol=1e-5`` (the JAX package's own tolerance for float sums, whose
    order differs by backend);
  * ``cpm_array(..., backend="cuda", device="cpu")`` on batched
    ``(2, 3, N)`` layouts with per-row ``used_len`` against the JAX
    ``CPMArray`` on its reference backend;
  * the ``backend="auto"`` rule (kernels only for GPU rows of at least
    ``CUDA_MIN_N`` lanes) and the reductions' split plan;
  * the faults ROADMAP Queue 3 found in the port (out-of-range Python
    integers, half-precision stencils, the shift fill, signed zeros in
    the limits), each on the ROADMAP's own inputs against JAX.

The ``cuda``-marked tests hold each CUDA kernel against its twin on the
card (small and ``chip_smoke.py`` phase-7 shapes, repeat runs bit for
bit, a device datum with no host sync, eager ``compare`` against
``fused_stream``'s compare branch) and skip here.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference; the GPU machine has no JAX
    import jax.numpy as jnp

    from repro.cpm import cpm_array as jcpm_array
    from repro.kernels import cpm_kernels as JK
except ImportError:
    jnp = None

from repro_torch.cpm import backends as B  # noqa: E402
from repro_torch.cpm import cpm_array  # noqa: E402
from repro_torch.cpm.pool import SlotAllocator  # noqa: E402
from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


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
    return torch.from_numpy(np.ascontiguousarray(a))


_CMP_OPS = ["eq", "ne", "lt", "gt", "le", "ge"]
#: (shape, explicit section): one lane; a ragged 1000 = 15 x 64 + 40; a
#: ragged 4099 = 64 x 64 + 3 (optimal_section(4099) = 64)
_SHAPES = [((1, 1), 1), ((3, 1000), 64), ((5, 4099), 64)]
_DTYPES = [np.int32, np.int8, np.float32]


def _rows(shape, dtype, seed, special=True):
    """Seeded rows; float rows get a NaN row, a +-inf row and a row of
    the max identity (-inf) when there are rows enough."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        x = (rng.standard_normal(shape) + 1.0).astype(dtype)
        if special and shape[0] >= 3:
            x[0, shape[1] // 2] = np.nan
            x[1, 0], x[1, -1] = np.inf, -np.inf
            x[2, :] = -np.inf
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min // 2, info.max // 2, shape).astype(dtype)
        if special and shape[0] >= 3:
            x[2, :] = info.min                   # the max identity
            x[1, :] = info.max                   # the min identity
    return x


def _same(got, want):
    """Bit for bit, dtype included (NaN equals NaN)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (a) the plain twins against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

class TestTwinsAgainstPallas:
    @pytest.mark.parametrize("dtype", _DTYPES)
    @pytest.mark.parametrize("shape,section", _SHAPES)
    def test_section_sum(self, shape, section, dtype):
        x = _rows(shape, dtype, seed=1, special=False)
        if dtype == np.int32:                # wraps like int32 jnp.sum
            x[0, :] = np.iinfo(np.int32).max // 3
        want = JK.section_sum(jnp.asarray(x), section, interpret=True)
        got = TK.section_sum_plain(_t(x), section)
        if dtype == np.float32:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
        else:
            _same(got, want)

    @pytest.mark.parametrize("mode", ["max", "min"])
    @pytest.mark.parametrize("dtype", _DTYPES)
    @pytest.mark.parametrize("shape,section", _SHAPES)
    def test_section_limit(self, shape, section, dtype, mode):
        x = _rows(shape, dtype, seed=2)
        want = JK.section_limit(jnp.asarray(x), section, mode, interpret=True)
        _same(TK.section_limit_plain(_t(x), section, mode), want)

    @pytest.mark.parametrize("dtype", _DTYPES)
    @pytest.mark.parametrize("shape,section", _SHAPES)
    def test_compare_all_ops(self, shape, section, dtype):
        """All six ops against an element of the rows and a float datum
        (int rows promote, never truncate it)."""
        x = _rows(shape, dtype, seed=3)
        for datum in (x.flat[-1].item(), 2.5):
            for op in _CMP_OPS:
                want = JK.compare(jnp.asarray(x), datum, op, interpret=True)
                _same(TK.compare_plain(_t(x), datum, op), want)

    @pytest.mark.parametrize("dtype", _DTYPES)
    @pytest.mark.parametrize("shape,section", _SHAPES)
    def test_compact(self, shape, section, dtype):
        x = _rows(shape, dtype, seed=4)
        keep = np.random.default_rng(5).random(shape) < 0.5
        if shape[0] >= 3:
            keep[0], keep[1] = False, True       # none kept, all kept
        jo, jn = JK.compact(jnp.asarray(x), jnp.asarray(keep), -7,
                            interpret=True)
        to, tn = TK.compact_plain(_t(x), _t(keep), -7)
        _same(to, jo)
        _same(tn, jn)

    def test_limits_propagate_nan(self):
        x = np.asarray([[1.0, np.nan, 3.0, -np.inf],
                        [np.inf, 2.0, -1.0, 0.5]], np.float32)
        for mode in ("max", "min"):
            got = TK.section_limit_plain(_t(x), 3, mode).numpy()
            assert np.isnan(got[0]) and not np.isnan(got[1])
            _same(got, JK.section_limit(jnp.asarray(x), 3, mode,
                                        interpret=True))


# ---------------------------------------------------------------------------
# (b) the cuda backend on CPU tensors against the JAX CPMArray
# ---------------------------------------------------------------------------

class TestCudaBackendOnCpu:
    @pytest.mark.parametrize("n", [37, 1100])
    @pytest.mark.parametrize("dtype", _DTYPES)
    def test_batched_ops_match_jax_reference(self, dtype, n):
        rng = np.random.default_rng(n)
        x = _rows((6, n), dtype, seed=n).reshape(2, 3, n)
        ul = rng.integers(0, n + 1, (2, 3)).astype(np.int32)
        keep = rng.random((2, 3, n)) < 0.4
        t = cpm_array(_t(x), _t(ul), backend="cuda", device="cpu")
        j = jcpm_array(x, ul, backend="reference")
        datum = x.flat[n + 1].item()
        for op in _CMP_OPS:
            _same(t.compare(datum, op), j.compare(datum, op))
        _same(t.count(datum, "le"), j.count(datum, "le"))
        for mode in ("max", "min"):
            _same(t.global_limit(mode), j.global_limit(mode))
        got, want = t.section_sum(), j.section_sum()
        if dtype == np.float32:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
        else:
            _same(got, want)
        tc, jc = t.compact(_t(keep), fill=-1), j.compact(keep, fill=-1)
        _same(tc.data, jc.data)
        _same(tc.used_len, jc.used_len)

    @pytest.mark.parametrize("section", [None, 7])
    def test_one_row_reductions_and_section(self, section):
        """A 1-D device reduces to a 0-d result; an explicit section
        reaches the twin."""
        x = _rows((1, 50), np.int32, seed=9)[0]
        t = cpm_array(_t(x), 41, backend="cuda", device="cpu")
        j = jcpm_array(x, 41, backend="reference")
        _same(t.section_sum(section), j.section_sum(section))
        _same(t.global_limit("max", section), j.global_limit("max", section))

    def test_wrappers_run_the_twins_on_cpu_uncounted(self):
        x = _t(_rows((3, 40), np.int32, seed=6))
        keep = x > 0
        ops.reset_launch_counts()
        assert torch.equal(TK.compare(x, 3, "lt"), TK.compare_plain(x, 3,
                                                                    "lt"))
        assert torch.equal(TK.section_sum(x, 8), TK.section_sum_plain(x, 8))
        assert torch.equal(TK.section_limit(x, 8, "min"),
                           TK.section_limit_plain(x, 8, "min"))
        for a, b in zip(TK.compact(x, keep, 0), TK.compact_plain(x, keep, 0)):
            assert torch.equal(a, b)
        counts = ops.launch_counts()
        assert set(counts) >= {"compare", "section_sum", "section_limit",
                               "compact"}
        assert all(v == 0 for v in counts.values())


# ---------------------------------------------------------------------------
# faults found in the port against the reference (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

class TestQueue3Repairs:
    _OVERFLOW = {
        "insert": (np.int8, lambda a, keep: a.insert(1, [300])),
        "delete": (np.int8, lambda a, keep: a.delete(1, 2, fill=200)),
        "compact": (np.uint8, lambda a, keep: a.compact(keep, -1)),
    }

    @pytest.mark.parametrize("case,backend", [
        ("insert", "reference"), ("delete", "reference"),
        ("compact", "reference"), ("compact", "cuda")])
    def test_out_of_range_python_ints_raise(self, case, backend):
        """A Python integer outside the row dtype raises OverflowError, as
        ``jnp.asarray`` does (the port wrapped it: 44, -56, 255)."""
        dtype, call = self._OVERFLOW[case]
        x = np.arange(8, dtype=dtype)
        keep = x % 2 == 0
        j = jcpm_array(x, 5, backend="reference")
        t = cpm_array(_t(x), 5, backend=backend, device="cpu")
        with pytest.raises(OverflowError):
            call(j, keep)
        with pytest.raises(OverflowError, match="out of bounds"):
            call(t, _t(keep))

    def test_in_range_values_and_arrays_still_convert(self):
        from repro_torch.cpm._tensor import asarray

        x = np.arange(8, dtype=np.int8)
        t = cpm_array(_t(x), 5, backend="reference", device="cpu")
        j = jcpm_array(x, 5, backend="reference")
        _same(t.insert(1, [127, -128]).data, j.insert(1, [127, -128]).data)
        _same(t.delete(1, 2, fill=-1).data, j.delete(1, 2, fill=-1).data)
        # arrays cast (and wrap) as jnp.asarray casts them
        wide = np.array([300, -1])
        _same(asarray(wide, torch.int8), jnp.asarray(wide, jnp.int8))
        with pytest.raises(OverflowError):
            asarray(2 ** 31)
        assert asarray(2 ** 40, torch.float32).item() == 2.0 ** 40

    @pytest.mark.parametrize("wrap", [False, True])
    @pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
    def test_half_precision_stencil_returns_float32(self, dtype, wrap):
        """Half-precision rows accumulate and return float32, as the JAX
        reference (its weights are float64 NumPy scalars)."""
        x = np.linspace(-2, 2, 16, dtype=np.float32)
        taps = (0.1, 0.3, 0.7)
        t = cpm_array(_t(x).to(getattr(torch, dtype)), 12,
                      backend="reference", device="cpu")
        j = jcpm_array(jnp.asarray(x, getattr(jnp, dtype)), 12,
                       backend="reference")
        got, want = t.stencil(taps, wrap=wrap), j.stencil(taps, wrap=wrap)
        assert got.dtype == torch.float32
        _same(got, want)

    @pytest.mark.parametrize("dtype,fill,want", [
        (np.int32, 2.5, np.float32), (np.bool_, 1, np.int32),
        (np.int8, 3, np.int8), (np.int8, 300, np.int8),
        (np.float16, 2.5, np.float16), (np.uint8, -1, np.uint8)])
    def test_shift_fill_promotes_as_jnp_where(self, dtype, fill, want):
        """The reference ``shift(fill=...)`` promotes the row with the
        fill (a weakly typed Python scalar), as ``jnp.where`` does."""
        x = np.arange(8).astype(dtype)
        t = cpm_array(_t(x), 8, backend="reference", device="cpu")
        j = jcpm_array(x, 8, backend="reference")
        got = t.shift(1, 5, 2, fill=fill).data
        _same(got, j.shift(1, 5, 2, fill=fill).data)
        assert got.numpy().dtype == want

    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    @pytest.mark.parametrize("row", [[-0.0, 0.0], [0.0, -0.0],
                                     [-0.0, 0.0, -0.0], [-0.0, -0.0]])
    def test_limits_order_signed_zeros_as_jnp(self, row, backend):
        """max(-0.0, +0.0) is +0.0 and min is -0.0 in any order, as
        ``jnp.max`` / ``jnp.min`` (``torch.amax`` kept the first)."""
        x = np.asarray([row], np.float32)
        t = cpm_array(_t(x), len(row), backend=backend, device="cpu")
        j = jcpm_array(x, len(row), backend="reference")
        for mode in ("max", "min"):
            for section in (None, 1, 2):
                got = t.global_limit(mode, section)
                want = j.global_limit(mode, section)
                _same(got, want)
                assert got.numpy().view(np.uint32).tolist() == \
                    np.asarray(want).view(np.uint32).tolist()


# ---------------------------------------------------------------------------
# dispatch rules and launch plans (no card needed)
# ---------------------------------------------------------------------------

class TestDispatch:
    @pytest.mark.parametrize("is_cuda,n,want", [
        (True, 1024, "cuda"), (True, 1 << 20, "cuda"),
        (True, 1023, "reference"), (True, 8, "reference"),
        (False, 1 << 20, "reference"), (False, 8, "reference")])
    def test_auto_rule_is_the_jax_min_n(self, is_cuda, n, want):
        """``auto`` sends only GPU rows of >= 1024 lanes to the kernels
        (the JAX package's static ``PALLAS_MIN_N``)."""
        assert B.CUDA_MIN_N == 1024
        assert B.auto_name(is_cuda, n) == want

    def test_cuda_supports_exactly_the_ported_ops(self):
        bk = B.get_backend("cuda")
        ported = {"compare", "substring_match", "compact", "global_limit",
                  "section_sum", "histogram", "super_sum", "super_limit",
                  "sort"}
        for op in ported | {"stencil", "activate", "template_match",
                            "shift"}:
            assert bk.supports(op) == (op in ported), op
        assert B.resolve("auto", "compare", torch.zeros(4096)).name \
            == "reference"                      # CPU rows

    @pytest.mark.parametrize("r,n,section", [
        (64, 1 << 20, 1024), (1, 16384, 128), (5, 4099, 64), (1, 1, 1),
        (3, 1000, 2000), (1, 1 << 20, 1), (1000, 4096, 64)])
    def test_reduce_plan_covers_rows_with_whole_sections(self, r, n,
                                                         section):
        parts, part_len = TK.reduce_plan(r, n, section)
        assert parts >= 1 and part_len % section == 0
        assert (parts - 1) * part_len < n <= parts * part_len
        assert r * parts <= max(r, TK.REDUCE_TARGET_BLOCKS + r)


# ---------------------------------------------------------------------------
# (c, d) the allocator on the cuda backend
# ---------------------------------------------------------------------------

class TestAllocatorOnCuda:
    def test_cuda_allocator_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SlotAllocator(4, backend="cuda")

    def test_default_devices(self):
        assert SlotAllocator(4).device.type == "cpu"
        a = SlotAllocator(4, backend="cuda", n_pages=8, device="cpu")
        assert a.device.type == "cpu" and a._state.device.type == "cpu"
        assert a.alloc() == 0 and a.alloc_pages(0, 3) == [0, 1, 2]
        assert a.victim() == 0 and a.used_slots() == [0]


# ---------------------------------------------------------------------------
# (e) on the card
# ---------------------------------------------------------------------------

def _card_rows(dev, r, n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.float32:
        x = rng.standard_normal((r, n)).astype(np.float32)
    else:
        x = rng.integers(0, 4096, (r, n)).astype(np.int32)
    return _t(x).to(dev).to(dtype)


def _float_sum_ok(got, x):
    """Float sums: within 1e-5 * sum|x| of the float64 sum per row (the
    kernel and the twin add in different orders)."""
    want = x.double().sum(-1)
    tol = 1e-5 * x.double().abs().sum(-1)
    return bool(((got.double() - want).abs() <= tol).all())


def _bits(t):
    """``t``'s elements as integers of the same width (bit comparison)."""
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _nan_equal(a, b):
    return bool(((a == b) | (torch.isnan(a.float())
                             & torch.isnan(b.float()))).all())


@pytest.mark.cuda
class TestKernelsOnCard:
    _CARD_SHAPES = [(1, 1), (3, 1000), (5, 4099), (2, 16384),
                    (64, 1 << 20)]
    _CARD_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16,
                    torch.int32, torch.float16, torch.bfloat16,
                    torch.float32]

    @pytest.mark.parametrize("r,n", _CARD_SHAPES)
    def test_compare_bit_identical(self, cuda_device, r, n):
        x = _card_rows(cuda_device, r, n, torch.int32, r + n)
        for datum in (2048, 2047.5):
            for op in _CMP_OPS:
                got = TK.compare(x, datum, op)
                assert torch.equal(got, TK.compare_plain(x, datum, op))

    @pytest.mark.parametrize("dtype", _CARD_DTYPES)
    def test_compare_dtypes(self, cuda_device, dtype):
        x = _card_rows(cuda_device, 3, 1000, torch.float32, 1) * 3
        x = x.to(dtype)
        d = x[1, 7].reshape(1)
        for op in _CMP_OPS:
            assert torch.equal(TK.compare(x, d, op),
                               TK.compare_plain(x, d, op))

    @pytest.mark.parametrize("r,n", _CARD_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
    def test_reductions_match_twins(self, cuda_device, r, n, dtype):
        x = _card_rows(cuda_device, r, n, dtype, 7 * r + n)
        for section in sorted({1024, max(1, math.isqrt(n))}):
            s, s_plain = TK.section_sum(x, section), \
                TK.section_sum_plain(x, section)
            if dtype == torch.float32:
                assert _float_sum_ok(s, x) and _float_sum_ok(s_plain, x)
            else:
                assert torch.equal(s, s_plain)
            for mode in ("max", "min"):
                assert torch.equal(TK.section_limit(x, section, mode),
                                   TK.section_limit_plain(x, section, mode))

    @pytest.mark.parametrize("dtype", _CARD_DTYPES)
    def test_reduction_dtypes(self, cuda_device, dtype):
        x = (_card_rows(cuda_device, 4, 5000, torch.float32, 3) * 40)
        x = x.to(dtype)
        for mode in ("max", "min"):
            assert _nan_equal(TK.section_limit(x, 64, mode),
                              TK.section_limit_plain(x, 64, mode))
        got, want = TK.section_sum(x, 64), TK.section_sum_plain(x, 64)
        assert got.dtype == want.dtype
        if dtype.is_floating_point:
            assert _float_sum_ok(got, x.float())
        else:
            assert torch.equal(got, want)

    def test_limits_nan_and_inf_rows(self, cuda_device):
        x = _card_rows(cuda_device, 4, 70000, torch.float32, 8)
        x[0, 12345] = float("nan")
        x[1, 0], x[1, -1] = float("inf"), -float("inf")
        x[2, :] = -float("inf")
        x[3, 69999] = float("nan")
        for mode in ("max", "min"):
            got = TK.section_limit(x, 256, mode)
            assert _nan_equal(got, TK.section_limit_plain(x, 256, mode))
            assert _nan_equal(got, (torch.amax if mode == "max"
                                    else torch.amin)(x, -1))
            assert torch.isnan(got[0]) and torch.isnan(got[3])

    @pytest.mark.parametrize("r,n", _CARD_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.int32, torch.float16,
                                       torch.int8])
    def test_compact_bit_identical(self, cuda_device, r, n, dtype):
        x = _card_rows(cuda_device, r, n, torch.int32, r * n).to(dtype)
        keep = _card_rows(cuda_device, r, n, torch.int32, n) < 2048
        if r >= 3:
            keep[0], keep[1] = False, True
        got = TK.compact(x, keep, -1)
        want = TK.compact_plain(x, keep, -1)
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        assert torch.equal(got[1], want[1])

    def test_repeat_runs_are_bit_identical(self, cuda_device):
        x = _card_rows(cuda_device, 64, 1 << 20, torch.float32, 11)
        keep = x > 0
        ops.reset_launch_counts()
        for fn in (lambda: TK.section_sum(x, 1024),
                   lambda: TK.section_limit(x, 1024, "max"),
                   lambda: TK.compare(x, 0.5, "lt"),
                   lambda: TK.compact(x, keep, 0.0)[0]):
            a, b = fn(), fn()
            assert torch.equal(_bits(a), _bits(b))
        counts = ops.launch_counts()
        assert all(counts[k] == 2 for k in ("section_sum", "section_limit",
                                            "compare", "compact"))

    def test_compare_reads_a_device_datum_without_sync(self, cuda_device):
        x = _card_rows(cuda_device, 8, 4096, torch.int32, 12)
        oldest = TK.section_limit(x, 64, "min")[3]      # on the device
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            hits = TK.compare(x, oldest, "eq")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(hits, TK.compare_plain(x, oldest, "eq"))
        assert bool(hits[3].any())

    @pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
    def test_eager_compare_equals_fused_compare(self, cuda_device, dtype):
        x = _card_rows(cuda_device, 7, 300, dtype, 13)
        ul = torch.full((7,), 300, dtype=torch.int32, device=cuda_device)
        ct = "float32" if dtype == torch.float32 else "int32"
        d = x[2, 5].reshape(1, 1).contiguous()
        for op in _CMP_OPS:
            instrs = (("compare", (("op", op), ("has_mask", False),
                                   ("ct", ct)), 1),)
            _, _, (fused,) = TK.fused_stream(x, ul, instrs, (d,))
            assert torch.equal(fused.to(torch.bool), TK.compare(x, d, op))

    def test_auto_launches_only_for_long_rows(self, cuda_device):
        long = cpm_array(_card_rows(cuda_device, 2, 4096, torch.int32, 14),
                         4000)
        short = cpm_array(_card_rows(cuda_device, 2, 8, torch.int32, 15), 6)
        ops.reset_launch_counts()
        for arr in (short, long):
            arr.count(7)
            arr.section_sum()
            arr.global_limit("min")
            arr.compact(arr.data > 9)
        counts = ops.launch_counts()
        assert all(counts[k] == 1 for k in ("compare", "section_sum",
                                            "section_limit", "compact"))

    def test_allocator_on_the_card_matches_the_oracle(self, cuda_device):
        from repro_torch.cpm.pool import OracleAllocator

        a = SlotAllocator(16, backend="cuda", n_pages=4096)
        o = OracleAllocator(16, n_pages=4096)
        assert a._state.is_cuda and a._pstate.is_cuda
        rng = np.random.default_rng(16)
        held: list[int] = []
        ops.reset_launch_counts()
        for i in range(120):
            mv = int(rng.integers(0, 4))
            if mv == 0 or not held:
                got = a.alloc()
                assert got == o.alloc()
                if got is not None:
                    held.append(got)
            elif mv == 1:
                s, k = held[i % len(held)], int(rng.integers(1, 9))
                lo = int(rng.integers(0, 4)) * 1024
                assert a.alloc_pages(s, k, lo, lo + 1024) == \
                    o.alloc_pages(s, k, lo, lo + 1024)
            elif mv == 2:
                s = held.pop(i % len(held))
                a.free(s)
                o.free(s)
            else:
                s = held[i % len(held)]
                a.touch(s)
                o.touch(s)
            assert a.victim() == o.victim()
            assert a.used_slots() == o.used_slots()
            assert a.free_count() == o.free_count()
            assert a.page_free_count() == o.page_free_count()
        counts = ops.launch_counts()
        assert min(counts[k] for k in ("compare", "section_limit",
                                       "compact")) > 0
