"""The tiled ``shift_range`` and ``stencil`` kernels on the card
(``-m cuda``; every test skips without one): each against its plain twin
on the same CUDA tensors, bit for bit, on every dtype, over the edge grid
of bounds and shifts, misaligned rows and sources, per-row bounds, the
fill, ``|shift| >= n``, rows of 1, 31 and 1000 lanes and (64, 2^20),
stencils of up to 63 taps; and ``fused_stream`` against the eager kernels
on a stream of shift / insert / delete / stencil.  No JAX here: the twins
are held against JAX in ``tests/test_torch_move_tiles.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.cpm import CPMProgram, cpm_array, tuning  # noqa: E402
from repro_torch.cpm.program import (CostParams, run_plan,  # noqa: E402
                                     schedule)
from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

I32_MAX = 2 ** 31 - 1
_SHIFT_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16,
                 torch.int32, torch.int64, torch.float16, torch.bfloat16,
                 torch.float32, torch.float64]
_STENCIL_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16,
                   torch.int32, torch.float16, torch.bfloat16, torch.float32]
_TAPS = [(3.0,), (1.0, 2.0, 1.0), (0.5, 0.0, 1.0, 0.0, -0.25),
         tuple(0.0 if k % 5 == 2 else float(np.float32(np.sin(k + 1.0)))
               for k in range(63))]
_ST = TK.STENCIL_TILE


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


def _rows(shape, dtype, seed, dev, offset=0):
    """Random rows; ``offset`` elements past the start of their storage,
    so the rows' base is that many elements off a 16-byte boundary."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = (torch.randn(offset + int(np.prod(shape)), generator=g,
                        device=dev) * 60)
    if dtype == torch.bool:
        flat = flat > 0
    else:
        flat = flat.to(dtype) if dtype.is_floating_point \
            else flat.round().to(dtype)
    return flat[offset:].view(shape)


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _move_cases(n, tile):
    return [(0, n - 1, 1, None), (n // 4, n // 2, 1, None),
            (n // 4, n // 2, -3, 1), (tile - 5, 2 * tile + 3, 5, 0),
            (tile, n - 1, -tile, None), (-9, n + 9, n, None),
            (1, n, 0, 1), (0, n - 1, -n - 3, 1), (5, 2, 2, 0),
            (3, n - 4, 16, -1), (3, n - 4, -8, None),
            (7, n - 1, I32_MAX, 1), (0, n - 1, -I32_MAX, None),
            (tile - 1, tile, 1, 2), (n - 1, n - 1, -(n - 1), None)]


def _check_moves(x, cases, per_row=False):
    """Each case through the kernel and the twin, bit for bit; returns
    the launches."""
    r, n = x.shape
    before = ops.launch_counts()["shift_range"]
    for start, end, shift, fill in cases:
        if per_row:
            lo = torch.tensor([start + 3 * k for k in range(r)],
                              device=x.device).clamp(-2 ** 31, I32_MAX)
            hi = torch.tensor([end - 2 * k for k in range(r)],
                              device=x.device).clamp(-2 ** 31, I32_MAX)
            lo, hi = lo.to(torch.int32), hi.to(torch.int32)
        else:
            se = torch.tensor([start, end], dtype=torch.int32,
                              device=x.device)
            lo, hi = se[0], se[1]
        got = TK.shift_range(x, lo, hi, shift, fill)
        want = TK.shift_range_plain(x, lo, hi, shift, fill)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), (start, end, shift,
                                                       fill)
    return ops.launch_counts()["shift_range"] - before


class TestShiftRangeOnCard:
    @pytest.mark.parametrize("dtype", _SHIFT_DTYPES, ids=str)
    @pytest.mark.parametrize("n", [1, 31, 1000, 3001, 3 * 4096 + 7])
    def test_every_dtype(self, dev, dtype, n):
        x = _rows((3, n), dtype, n, dev)
        tile = TK.SHIFT_TILE_BYTES // x.element_size()
        cases = _move_cases(n, tile)
        assert _check_moves(x, cases) == len(cases)
        assert _check_moves(x, cases, per_row=True) == len(cases)

    @pytest.mark.parametrize("dtype", [torch.int8, torch.int32], ids=str)
    @pytest.mark.parametrize("n", [1, 31, 1000])
    def test_edge_grid(self, dev, dtype, n):
        """start > end, start < 0, end >= n; shifts 0, +-1, +-(n-1), +-n,
        +-(n+5), +-(2^31-1); with and without the fill."""
        x = _rows((2, n), dtype, n + 1, dev)
        edges = sorted({-2 ** 31, -n - 5, -1, 0, 1, n // 2, n - 1, n,
                        n + 3, I32_MAX})
        shifts = sorted({0, 1, -1, n - 1, 1 - n, n, -n, n + 5, -n - 5,
                         I32_MAX, -I32_MAX})
        cases = [(s, e, sh, f) for s in edges for e in edges
                 for sh in shifts for f in (None, 7)]
        assert _check_moves(x, cases) == len(cases)

    @pytest.mark.parametrize("offset", [1, 2, 3, 5])
    @pytest.mark.parametrize("dtype,n", [(torch.int8, 1000),
                                         (torch.int8, 40003),
                                         (torch.int16, 8195),
                                         (torch.int32, 3001),
                                         (torch.float32, 4096),
                                         (torch.int64, 2051)], ids=str)
    def test_misaligned_sources(self, dev, dtype, n, offset):
        """Rows whose base sits ``offset`` elements off a 16-byte boundary:
        the copies stage their sources, every tile case included."""
        x = _rows((3, n), dtype, n + offset, dev, offset=offset)
        tile = TK.SHIFT_TILE_BYTES // x.element_size()
        cases = _move_cases(n, tile)
        assert _check_moves(x, cases) == len(cases)
        assert _check_moves(x, cases, per_row=True) == len(cases)

    def test_full_rows(self, dev):
        """(64, 2^20) int32, chip_smoke's rows: the measured move, per-row
        bounds, the fill and whole-vector shifts."""
        n = 1 << 20
        x = _rows((64, n), torch.int32, 3, dev)
        cases = [(n // 4, n // 2, 1, None), (n // 4, n // 2, -1, 0),
                 (n // 4, n // 2, 4, None), (0, n - 1, 4096, -1),
                 (17, n - 3, -5, None), (0, n - 1, n, 1)]
        assert _check_moves(x, cases) == len(cases)
        assert _check_moves(x, cases, per_row=True) == len(cases)


class TestStencilOnCard:
    @pytest.mark.parametrize("taps", range(len(_TAPS)))
    @pytest.mark.parametrize("wrap", [True, False])
    @pytest.mark.parametrize("dtype", _STENCIL_DTYPES, ids=str)
    def test_every_dtype(self, dev, dtype, wrap, taps):
        ops.reset_launch_counts()
        ns = [1, 2, 31, 1000, _ST - 1, _ST, _ST + 1, 3 * _ST + 7]
        for n in ns:
            for offset in (0, 1):
                x = _rows((3, n), dtype, n, dev, offset=offset)
                got = TK.stencil(x, _TAPS[taps], wrap)
                want = TK.stencil_plain(x, _TAPS[taps], wrap)
                torch.cuda.synchronize()
                assert torch.equal(_bits(got), _bits(want)), (n, offset)
        assert ops.launch_counts()["stencil"] == 2 * len(ns)

    @pytest.mark.parametrize("taps", range(len(_TAPS)))
    def test_full_rows(self, dev, taps):
        x = _rows((64, 1 << 20), torch.float32, 5, dev)
        for wrap in (False, True):
            got = TK.stencil(x, _TAPS[taps], wrap)
            want = TK.stencil_plain(x, _TAPS[taps], wrap)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(want))


#: launch-dominated machine: fusing always pays
_FUSE = CostParams(1e-5, 1e-12, 1e-5, 1e-12, source="override")
#: launch-free machine with a pricier fused byte slope: never fuse
_EAGER = CostParams(1e-9, 1e-12, 1e-9, 2e-12, source="override")


class TestFusedAgainstEager:
    @pytest.mark.parametrize("dtype", [torch.int32, torch.float32], ids=str)
    @pytest.mark.parametrize("wrap", [True, False])
    def test_stream_bit_for_bit(self, dev, dtype, wrap):
        """shift / insert / delete / stencil fused in one launch and
        replayed on the eager kernels: the same rows, lengths and stencil
        bits."""
        n = 4096
        x = _rows((4, n), dtype, 11, dev)
        ul = torch.tensor([n, n - 5, 1000, 3], dtype=torch.int32,
                          device=dev)
        vals = torch.tensor([7, -8, 9], device=dev).to(dtype)
        prog = (CPMProgram()
                .append("shift", start=100, end=n // 2, shift=3, fill=-1)
                .append("insert", pos=5, values=vals)
                .append("delete", pos=n // 3, k=2, fill=0)
                .append("shift", start=1, end=n - 2, shift=-17)
                .append("stencil", taps=(0.25, -1.0, 0.0, 2.0, 0.5),
                        wrap=wrap))
        arr = cpm_array(x, ul, backend="cuda")
        fused = schedule(prog, device=arr, cost=_FUSE)
        eager = schedule(prog, device=arr, cost=_EAGER)
        assert [g.kind for g in fused.groups] == ["fused"]
        assert "eager" in [g.kind for g in eager.groups]
        ops.reset_launch_counts()
        of, pf = run_plan(fused, arr)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["fused_stream"] == 1 and counts["shift_range"] == 0
        ops.reset_launch_counts()
        oe, pe = run_plan(eager, arr)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["fused_stream"] == 0
        assert counts["shift_range"] == 4 and counts["stencil"] == 1
        assert torch.equal(_bits(of.data), _bits(oe.data))
        assert torch.equal(of.used_len, oe.used_len)
        for a, b in zip(pf, pe):
            if a is not None:
                assert torch.equal(_bits(a), _bits(b))
