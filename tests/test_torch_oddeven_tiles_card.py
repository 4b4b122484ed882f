"""The odd-even route of the sort kernel on the card (``-m cuda``; every
test skips without one), held bit for bit against ``oddeven_sort_plain``
on the same CUDA tensors: the boundary grid of ``steps`` at the card's
row sizes, under the kernel's own plans and under pinned ones (several
tiles a row, several passes in one cooperative launch, blocks that take
many tiles a pass); float rows where only some tiles hold a NaN, so the
integer loop and the NaN loop run in one call; the NaN rows of a full
sort, each spread over many blocks; every dtype; repeats bit for bit.
No JAX here: the plan's twin is held against JAX in
``tests/test_torch_oddeven_tiles.py``.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.cpm import tuning  # noqa: E402
from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
           torch.float16, torch.bfloat16, torch.float32]
_S = TK.OE_ROUND


@pytest.fixture(scope="module", autouse=True)
def _static_tuning(tmp_path_factory):
    """No calibration or tuning at random; any spill in a temporary
    directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_CPM_TUNING_CACHE",
                  str(tmp_path_factory.mktemp("tuning") / "cpm.json"))
        mp.setenv("REPRO_TORCH_CPM_AUTOTUNE", "0")
        mp.setenv("REPRO_TORCH_CPM_CALIBRATE", "0")
        tuning.clear()
        yield
    tuning.clear()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _rows(shape, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 60
    if dtype == torch.bool:
        return x > 0
    if dtype == torch.uint8:
        return x.abs().round().to(dtype)
    return x.to(dtype) if dtype.is_floating_point else x.round().to(dtype)


def _bits(t):
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return t.contiguous().view(view[t.element_size()])


def _held(x, steps):
    got = TK.oddeven_sort(x, steps)
    want = TK.oddeven_sort_plain(x, steps)
    assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want)), \
        (tuple(x.shape), x.dtype, steps)
    return got


@pytest.fixture
def pinned(monkeypatch):
    """Run the wrapper under a given plan (it looks the plan up in its
    module at every call)."""
    def pin(plan):
        monkeypatch.setattr(TK, "oddeven_plan", lambda *a, **k: plan)
    return pin


class TestBoundaryGrid:
    @pytest.mark.parametrize("steps", [0, 1, 2, _S - 1, _S, _S + 1, 127,
                                       128, 129, 257, 1023, 1024, 1025])
    @pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
    def test_card_rows_own_plan(self, dev, dtype, steps):
        """(64, 16,384) rows (a NaN in two rows) under the plan the kernel
        chooses for each ``steps``."""
        x = _rows((64, 16384), dtype, steps, dev)
        if dtype.is_floating_point:
            x[3, 9000], x[40, 1663], x[7, 5] = float("nan"), \
                float("nan"), -0.0
        _held(x, steps)

    @pytest.mark.parametrize("steps", [_S - 1, _S, _S + 1, 127, 128, 129,
                                       257, 700])
    def test_pinned_halo_plan(self, dev, pinned, steps):
        """Four-warp blocks, tiles of 1,664 lanes read with 128 more on
        either side: one pass up to 128 cycles, a cooperative launch of
        several above (halo - 1, halo, halo + 1, 2 halo + 1 and more)."""
        n = 16384
        plan = TK.OddEvenPlan(4, 1664, 128, min(steps, 128),
                              -(-steps // 128), 10)
        pinned(plan)
        for dtype in (torch.int32, torch.float32):
            x = _rows((8, n), dtype, steps, dev)
            if dtype.is_floating_point:
                x[1, 1664], x[2, 1663], x[5, 16383] = (float("nan"),) * 3
            _held(x, steps)

    @pytest.mark.parametrize("n", [16383, 16384])
    def test_full_and_one_short(self, dev, n):
        """N - 1 and N cycles of odd and even rows (a NaN row and a
        NaN-free one: the full sort's cycles run on the NaN row only)."""
        x = _rows((4, n), torch.float32, n, dev)
        x[2, n // 3] = float("nan")
        for steps in (n - 1, n):
            _held(x, steps)
        xi = _rows((4, n), torch.int32, n + 1, dev)
        _held(xi, n - 1)


class TestBothLoops:
    def test_some_tiles_hold_nan(self, dev):
        """Rows where two of ten tiles hold a NaN: those tiles take the
        NaN loop, the others the integer loop, in one call; 128 cycles
        spread the NaN into the neighbouring tiles' halos."""
        x = _rows((16, 16384), torch.float32, 1, dev)
        x[:, 2 * 1664 + 17] = float("nan")
        x[:, 7 * 1664 - 1] = float("nan")
        x[3, 0] = float("nan")
        assert TK.oddeven_plan(16, 16384, 128).tiles == 10
        _held(x, 128)
        _held(x, 129)

    def test_nan_free_rows_in_a_nan_call(self, dev, pinned):
        """Several passes: tiles a NaN reaches only after the first pass
        (its flags widened by the cycles run) switch loops between
        passes."""
        pinned(TK.OddEvenPlan(4, 1664, 128, 128, 6, 10))
        x = _rows((8, 16384), torch.float32, 2, dev)
        x[:, 1664 * 3 + 1660] = float("nan")       # beside tile 4's halo
        x[4].fill_(0.5)                            # ties
        _held(x, 700)

    def test_float_full_sort_nan_rows_spread(self, dev):
        """The full sort's NaN rows (two NaN payloads, signed NaN, a row
        with NaN at both ends) over 19 tiles a row and 32 passes, beside
        rows without NaN on the bitonic route."""
        x = _rows((64, 16384), torch.float32, 3, dev)
        x[5, 100] = float("nan")
        x[9].view(torch.int32)[[50, 12000]] = torch.tensor(
            [0x7FC01234, -4194303], dtype=torch.int32, device=dev)
        x[60, 0], x[60, 16383] = float("nan"), float("nan")
        plan = TK.oddeven_plan(64, 16384, 16384, full=True)
        assert plan.tiles == 19 and plan.passes == 32
        got = _held(x, None)
        keep = ~torch.isnan(x).any(-1)
        assert torch.equal(got[keep], torch.sort(x[keep], -1).values)


class TestWidthsAndDtypes:
    @pytest.mark.parametrize("dtype", _DTYPES)
    def test_every_dtype(self, dev, dtype):
        x = _rows((4, 70001), dtype, 4, dev)
        if dtype.is_floating_point:
            x[1, 35000], x[2, 1], x[3, 70000] = (float("nan"),) * 3
        for steps in (1, 300, 2049):
            _held(x, steps)

    @pytest.mark.parametrize("warps", [1, 2, 4, 8, 16, 32])
    def test_every_block_width(self, dev, pinned, warps):
        """Blocks of 1 to 32 warps, three passes of 40 cycles: each width's
        shared-memory tile, halo buffers and cooperative grid."""
        interior = warps * TK.OE_STEP - 80
        n = 5 * interior + 7
        pinned(TK.OddEvenPlan(warps, interior, 40, 40, 3, 6))
        for dtype in (torch.int32, torch.float32):
            x = _rows((3, n), dtype, warps, dev)
            if dtype.is_floating_point:
                x[0, interior], x[2, 2 * interior - 41] = (float("nan"),) * 2
            _held(x, 120)

    def test_long_rows_many_tiles_a_block(self, dev, pinned):
        """(64, 2^20) rows in 8-warp tiles with a 64-lane halo: thousands
        of tiles a pass over a resident grid, five passes (the grid
        barrier, reads of the last pass's output through L2)."""
        pinned(TK.OddEvenPlan(8, 8 * TK.OE_STEP - 128, 64, 64, 5, 283))
        x = _rows((64, 1 << 20), torch.int32, 5, dev)
        _held(x, 300)


class TestRepeats:
    def test_bit_identical_and_counted(self, dev):
        xl = _rows((64, 1 << 20), torch.int32, 6, dev)
        xf = _rows((64, 16384), torch.float32, 7, dev)
        xf[5, 100] = float("nan")
        ops.reset_launch_counts()
        for fn in (lambda: TK.oddeven_sort(xl, 1024),
                   lambda: TK.oddeven_sort(xf),
                   lambda: TK.oddeven_sort(xf, 128)):
            a, b = fn(), fn()
            assert torch.equal(_bits(a), _bits(b))
        assert ops.launch_counts()["oddeven_sort"] == 6
