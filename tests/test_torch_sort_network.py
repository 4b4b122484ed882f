"""The full sort's bitonic route of the ``oddeven_sort`` kernel: its plan,
its int32 keys, its plain network and the rule that picks it per row.

For ``steps >= N`` the odd-even network sorts a row, and the kernel
computes that result with a bitonic network on the rows without NaN.
Held here on the CPU, on seeded NumPy inputs:

  * ``bitonic_plan`` at the card's shapes: the passes run every stage's
    strides once, in the network's order, tiles in shared memory and the
    strides of a tile or more in device memory;
  * the key round trip, bit for bit, for every dtype the kernel takes
    (signed zeros, subnormals, +-inf, NaN payloads, f16 / bf16), and the
    key order equal to the value order;
  * ``bitonic_sort_plain`` (the kernel's schedule in PyTorch) equal to
    ``np.sort`` and, bit for bit, to the twin ``oddeven_sort_plain`` on
    rows without NaN, subnormals included (the JAX sorts flush them on
    this CPU, ROADMAP Queue 3, so they are held against NumPy);
  * the route rule (``steps >= N`` and no NaN: the network; otherwise the
    cycles) on the inputs of ``test_torch_cpm_sort.py``'s NaN rows, whose
    combination equals the twin and the Pallas kernel in interpret mode.

The ``cuda``-marked tests hold the kernel against the twin, ``torch.sort``
and ``np.sort`` on the card and skip here.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference; the GPU machine has no JAX
    import jax.numpy as jnp

    from repro.kernels import cpm_kernels as JK
except ImportError:
    jnp = None

from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


_DTYPES = list(TK._DTYPE_CODE)


def _bits(t):
    """A tensor's storage bits as an integer tensor (bool stays bool)."""
    if t.dtype == torch.bool:
        return t
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _network(p):
    """The bitonic network's steps over ``p`` lanes: stages k = 2 .. p,
    strides k/2 .. 1."""
    return [(1 << s, (1 << s) >> i) for s in range(1, p.bit_length())
            for i in range(1, s + 1)]


def _specials(dtype):
    """Every float class the keys must carry: signed zeros, subnormals,
    +-inf, normal values of both signs, and NaN with several payloads."""
    if dtype == torch.float32:
        raw = np.array([0x00000000, 0x80000000, 0x00000001, 0x807FFFFF,
                        0x7F800000, 0xFF800000, 0x3F800000, 0xBF800000,
                        0x7FC00000, 0xFFC00001, 0x7F800001, 0x7FFFFFFF],
                       np.uint32).view(np.int32)
        return torch.from_numpy(raw).view(torch.float32)
    if dtype in (torch.float16, torch.bfloat16):
        inf = 0x7C00 if dtype == torch.float16 else 0x7F80
        raw = np.array([0x0000, 0x8000, 0x0001, 0x8003, inf, inf | 0x8000,
                        0x3C00, 0xBC00, inf | 1, (inf | 0x8000) | 3,
                        0x7FFF, 0xFFFF], np.uint16).view(np.int16)
        return torch.from_numpy(raw).view(dtype)
    if dtype == torch.bool:
        return torch.tensor([False, True, True, False])
    info = torch.iinfo(dtype)
    return torch.tensor([info.min, info.max, 0, -1 if info.min else 1, 7],
                        dtype=dtype)


def _rows(dtype, r, n, seed, subnormals=False):
    """Seeded ``(r, n)`` rows of ``dtype`` without NaN: floats are normal
    values times 60 with both signed zeros and +-inf planted (and, with
    ``subnormals``, 1e-39-scale float32 values); integers span the
    dtype's range."""
    rng = np.random.default_rng(seed)
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, (r, n)) > 0)
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        x = rng.integers(info.min, info.max, (r, n), endpoint=True)
        return torch.from_numpy(x).to(dtype)
    x = (rng.standard_normal((r, n)) * 60).astype(np.float32)
    if subnormals:
        x[:, ::5] *= np.float32(1e-41)
    flat = x.reshape(-1)
    flat[[0, flat.size // 3]] = [-0.0, 0.0]
    if flat.size >= 4:
        flat[[flat.size // 2, flat.size - 1]] = [np.inf, -np.inf]
    return torch.from_numpy(x).to(dtype)


class TestBitonicPlan:
    @pytest.mark.parametrize("r,n", [(64, 16384), (64, 1 << 20), (1, 1),
                                     (3, 17), (3, 1000), (64, 16385),
                                     (2, 200000), (1, 16384), (5, 4097),
                                     (300, 1 << 12)])
    def test_passes_run_the_whole_network_once(self, r, n):
        p, t, g, passes = TK.bitonic_plan(r, n)
        assert 1 <= g <= r and (g == 1 or g * p * 4 <= TK.BITONIC_GROUP_BYTES)
        assert p >= max(n, TK.BITONIC_MIN_PAD) and p & (p - 1) == 0
        assert p < 2 * max(n, TK.BITONIC_MIN_PAD)
        assert t & (t - 1) == 0 and p % t == 0
        assert t <= TK.BITONIC_TILE_MAX
        assert t == p or t >= TK.BITONIC_TILE_MIN
        assert list(TK.bitonic_steps(passes, t)) == _network(p)
        assert passes[0] == ("tile", 2, t) and passes[-1][0] == "tile"
        for kind, a, b, *rest in passes:
            if kind == "stride":
                (levels,) = rest
                assert 1 <= levels <= TK.BITONIC_LEVELS
                assert b >> (levels - 1) >= t and a > b
            else:
                assert a == b or (a, b) == (2, t)

    def test_plan_at_the_card_shapes(self):
        """(64, 16,384): one group, 4,096-key tiles, 256 blocks on the 132
        SMs, five passes; (64, 2^20): groups of 4 rows (16 MiB of keys),
        16,384-key tiles, 256 blocks a launch, sixteen passes a group,
        nine of them in device memory; non-powers of two pad to the next
        power."""
        p, t, g, passes = TK.bitonic_plan(64, 16384)
        assert (p, t, g) == (16384, 4096, 64) and g * p // t == 256
        assert passes == [("tile", 2, 4096), ("stride", 8192, 4096, 1),
                          ("tile", 8192, 8192), ("stride", 16384, 8192, 2),
                          ("tile", 16384, 16384)]
        p, t, g, passes = TK.bitonic_plan(64, 1 << 20)
        assert (p, t, g, len(passes)) == (1 << 20, 16384, 4, 16)
        assert sum(k == "stride" for k, *_ in passes) == 9
        assert TK.bitonic_plan(3, 1000) == (1024, 1024, 3,
                                            [("tile", 2, 1024)])
        assert TK.bitonic_plan(64, 16385)[:3] == (32768, 8192, 64)
        assert TK.bitonic_plan(1, 1) == (16, 16, 1, [("tile", 2, 16)])


class TestSortKeys:
    @pytest.mark.parametrize("dtype", _DTYPES, ids=str)
    def test_round_trip_bit_for_bit(self, dtype):
        for x in (_specials(dtype)[None], _rows(dtype, 3, 257, seed=1)):
            keys = TK.sort_keys(x)
            assert keys.dtype == torch.int32
            back = TK.sort_values(keys, dtype)
            assert back.dtype == dtype
            assert torch.equal(_bits(back), _bits(x))

    @pytest.mark.parametrize("dtype", _DTYPES, ids=str)
    def test_key_order_is_value_order(self, dtype):
        """Sorted keys map back to ``np.sort``'s values, and -0.0 sorts
        just below +0.0 (NaN aside: its keys lie past +-inf)."""
        x = torch.cat([_specials(dtype), _rows(dtype, 1, 300, seed=2)[0]])
        if dtype.is_floating_point:
            x = x[~torch.isnan(x)]
        got = TK.sort_values(torch.sort(TK.sort_keys(x)).values, dtype)
        want = np.sort(x.float().numpy())
        np.testing.assert_array_equal(got.float().numpy(), want)
        if dtype.is_floating_point:
            zeros = got[got == 0]
            assert bool(torch.signbit(zeros).int().diff().le(0).all())
            sp = _specials(dtype)
            nan_keys = TK.sort_keys(sp)[torch.isnan(sp)]
            inf_keys = TK.sort_keys(torch.tensor(
                [-float("inf"), float("inf")]).to(dtype))
            assert bool(((nan_keys < inf_keys[0])
                         | (nan_keys > inf_keys[1])).all())


class TestBitonicPlain:
    @pytest.mark.parametrize("dtype", _DTYPES, ids=str)
    @pytest.mark.parametrize("r,n", [(1, 1), (2, 2), (3, 17), (2, 300),
                                     (2, 1025)])
    def test_equals_the_twin_and_np_sort(self, dtype, r, n):
        x = _rows(dtype, r, n, seed=n)
        got = TK.bitonic_sort_plain(x)
        assert torch.equal(_bits(got), _bits(TK.oddeven_sort_plain(x)))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.sort(x.float().numpy(), -1))

    def test_subnormals_kept(self):
        """Subnormal float32 rows (which the JAX sorts flush) against
        ``np.sort`` bit for bit and the twin."""
        x = _rows(torch.float32, 3, 700, seed=4, subnormals=True)
        assert int((x.abs() < 1.2e-38).sum()) > 100
        got = TK.bitonic_sort_plain(x)
        assert torch.equal(_bits(got), _bits(TK.oddeven_sort_plain(x)))
        want = np.sort(x.numpy(), -1)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(((got != 0) & (got.abs() < 1.2e-38)).sum()) > 100

    @pytest.mark.parametrize("r,n", [(2, 20000), (4, 16384), (3, 5000)])
    def test_stride_passes_on_longer_rows(self, r, n):
        """Rows whose plan has device-memory stride passes (tiles of the
        minimum size, up to three strides a pass) against ``np.sort``."""
        x = _rows(torch.int32, r, n, seed=r + n)
        p, t, g, passes = TK.bitonic_plan(r, n)
        assert any(k == "stride" for k, *_ in passes)
        got = TK.bitonic_sort_plain(x)
        np.testing.assert_array_equal(got.numpy(), np.sort(x.numpy(), -1))

    def test_reversed_and_constant_rows(self):
        n = 777
        x = torch.stack([torch.arange(n, 0, -1, dtype=torch.int32),
                         torch.full((n,), 2 ** 31 - 1, dtype=torch.int32),
                         torch.full((n,), -2 ** 31, dtype=torch.int32)])
        got = TK.bitonic_sort_plain(x)
        assert torch.equal(got, TK.oddeven_sort_plain(x))
        assert torch.equal(got, torch.sort(x).values)


class TestRoute:
    def test_rule(self):
        x = _rows(torch.float32, 4, 50, seed=3)
        x[1, 7] = float("nan")
        assert TK.bitonic_rows(x).tolist() == [True, False, True, True]
        assert TK.bitonic_rows(x, 50).tolist() == [True, False, True, True]
        assert not TK.bitonic_rows(x, 49).any()
        xi = _rows(torch.int16, 4, 50, seed=3)
        assert TK.bitonic_rows(xi).all() and not TK.bitonic_rows(xi, 3).any()

    @pytest.mark.parametrize("steps", [None, 33, 40])
    def test_routes_combined_equal_the_twin_on_nan_rows(self, steps):
        """The inputs of ``TestCPMArray::test_full_sort_with_nan_rows``
        (``_floats((3, 33), seed=12)`` with a NaN, +-inf and signed zeros
        planted, ``used_len`` 33, 20, 5, dead lanes +inf): rows without
        NaN through the network, the others through the cycles, equal the
        twin and the Pallas kernel in interpret mode."""
        if jnp is None:
            pytest.skip("needs JAX, the reference package")
        x = np.random.default_rng(12).standard_normal((3, 33)).astype(
            np.float32)
        flat = x.reshape(-1)
        k = flat.size
        flat[[k // 7, k // 3]] = [0.0, -0.0]
        flat[[k // 5, (2 * k) // 3]] = [-0.0, 0.0]
        flat[k // 2] = np.nan
        flat[[1, k - 2]] = [np.inf, -np.inf]
        live = np.arange(33)[None] < np.array([33, 20, 5])[:, None]
        xt = torch.from_numpy(np.where(live, x, np.float32(np.inf)))
        route = TK.bitonic_rows(xt, steps)
        assert route.tolist() == [True, False, True]
        twin = TK.oddeven_sort_plain(xt, steps)
        got = torch.where(route[:, None], TK.bitonic_sort_plain(xt), twin)
        want = torch.from_numpy(np.asarray(JK.oddeven_sort(
            jnp.asarray(xt.numpy()), steps, interpret=True)))
        for ref in (twin, want):
            nan = torch.isnan(got)
            assert torch.equal(nan, torch.isnan(ref))
            assert torch.equal(_bits(torch.where(nan, 0.0, got)),
                               _bits(torch.where(nan, 0.0, ref)))

    def test_wrapper_on_cpu_runs_the_twin_uncounted(self):
        x = _rows(torch.float32, 3, 40, seed=9)
        x[0, 3] = float("nan")
        ops.reset_launch_counts()
        for steps in (None, 7):
            assert torch.equal(_bits(TK.oddeven_sort(x, steps)),
                               _bits(TK.oddeven_sort_plain(x, steps)))
        assert ops.launch_counts()["oddeven_sort"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_floats(dev, r, n, seed):
    x = np.random.default_rng(seed).standard_normal((r, n)) * 60
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _nan_same(got, want):
    nan = torch.isnan(got)
    return torch.equal(nan, torch.isnan(want)) and torch.equal(
        _bits(torch.where(nan, 0, got)), _bits(torch.where(nan, 0, want)))


@pytest.mark.cuda
class TestSortNetworkOnCard:
    @pytest.mark.parametrize("r,n", [(8, 3000), (64, 16384), (3, 16385)])
    def test_mixed_nan_rows_take_both_routes(self, cuda_device, r, n):
        """A full sort of float rows where some hold NaN: one call runs
        the network (rows without NaN) and the cycles (the others); both
        equal the twin, and the NaN-free rows ``np.sort``."""
        x = _card_floats(cuda_device, r, n, seed=n)
        x[1, n // 3] = float("nan")
        x[r - 1, 2] = float("nan")
        x[0, 5], x[0, 6] = 0.0, -0.0
        ops.reset_launch_counts()
        got = TK.oddeven_sort(x)
        torch.cuda.synchronize()
        assert ops.launch_counts()["oddeven_sort"] == 1
        assert _nan_same(got, TK.oddeven_sort_plain(x))
        route = TK.bitonic_rows(x)
        assert route.sum().item() == r - 2
        got_np, x_np = got.cpu().numpy(), x.cpu().numpy()
        for i in np.flatnonzero(route.cpu().numpy()):
            np.testing.assert_array_equal(got_np[i], np.sort(x_np[i]))

    @pytest.mark.parametrize("r,n", [(64, 1 << 20), (3, 100003),
                                     (5, 16385), (2, 1 << 21), (7, 999)])
    def test_int32_rows_equal_torch_sort(self, cuda_device, r, n):
        g = np.random.default_rng(n)
        x = torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, (r, n))
                             .astype(np.int32)).to(cuda_device)
        got = TK.oddeven_sort(x)
        assert torch.equal(got, torch.sort(x, -1).values)
        for i in (0, r - 1):
            np.testing.assert_array_equal(got[i].cpu().numpy(),
                                          np.sort(x[i].cpu().numpy()))
        assert torch.equal(got, TK.oddeven_sort(x))          # deterministic

    @pytest.mark.parametrize("dtype", _DTYPES, ids=str)
    def test_every_dtype_and_repeats(self, cuda_device, dtype):
        x = _rows(dtype, 4, 5000, seed=7).to(cuda_device)
        got = TK.oddeven_sort(x)
        assert torch.equal(_bits(got), _bits(TK.bitonic_sort_plain(x)))
        assert torch.equal(_bits(got), _bits(TK.oddeven_sort(x)))
        np.testing.assert_array_equal(
            got.float().cpu().numpy(), np.sort(x.float().cpu().numpy(), -1))

    def test_subnormal_rows_equal_np_sort(self, cuda_device):
        x = _rows(torch.float32, 4, 20000, seed=8, subnormals=True)
        got = TK.oddeven_sort(x.to(cuda_device)).cpu()
        np.testing.assert_array_equal(_bits(got).numpy(),
                                      _bits(torch.from_numpy(
                                          np.sort(x.numpy(), -1))).numpy())

    @pytest.mark.parametrize("n,steps", [(16384, 128), (16384, 16383),
                                         (70000, 3000), (200000, 300)])
    def test_bounded_and_halo_sorts_unchanged(self, cuda_device, n, steps):
        """Below N cycles the kernel still runs the cycles, cycle for
        cycle with the twin (NaN and signed zeros included)."""
        x = _card_floats(cuda_device, 2, n, seed=steps)
        x[1, n // 2], x[0, 3], x[0, 4] = float("nan"), 0.0, -0.0
        assert _nan_same(TK.oddeven_sort(x, steps),
                         TK.oddeven_sort_plain(x, steps))
