"""The redesigned ``histogram`` and ``template_match`` kernels on the card
(``-m cuda``; every test skips without one): each against its plain twin
on the same CUDA tensors, bit for bit.  ``histogram``: both forms a block
can take — ordered edges (the search), shuffled edges and edges with a
NaN (the counts form) — on every dtype, M in {1, 8, 64, 128, 4095}, rows
of 1, 31 and 1000 lanes and (64, 2^20); ``template_match``: every dtype
over M in {1, 2, 4, 5, 16, 63, 64} and rows of 1, M - 1 and about a tile
of lanes, unaligned rows, long templates up to ``TEMPLATE_MAX_M`` and
(64, 2^20); and ``fused_stream``'s template branch against the eager
kernel, with launch counts.  No JAX here: the twins are held against JAX
in ``tests/test_torch_bins_sad_tiles.py``.
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

_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
           torch.float16, torch.bfloat16, torch.float32]
_TILE = TK.TEMPLATE_TILE


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
    flat = torch.randn(offset + int(np.prod(shape)), generator=g,
                       device=dev) * 40
    if dtype == torch.bool:
        flat = flat > 0
    elif dtype == torch.uint8:
        flat = flat.abs().round().to(dtype)
    else:
        flat = flat.to(dtype) if dtype.is_floating_point \
            else flat.round().to(dtype)
    return flat[offset:].view(shape)


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _edges(kind, m, dtype, dev):
    """``m + 1`` edges of a kind, in the rows' dtype family."""
    rng = np.random.default_rng(m)
    e = np.sort(rng.normal(0, 40, m + 1)).round()
    if dtype == torch.uint8:
        e = np.sort(np.abs(e))
    e = torch.from_numpy(e.astype(np.float32)).to(dev)
    if not dtype.is_floating_point:
        e = e.to(torch.int32)
    if kind == "shuffled":
        g = torch.Generator(device=dev).manual_seed(m)
        e = e[torch.randperm(m + 1, generator=g, device=dev)]
        if bool((e[:-1] <= e[1:]).all()):          # M = 1 may stay sorted
            e = e.flip(0)
            e[0] = e[-1] + 1
    elif kind == "nan":
        e = e.to(torch.float32)
        e[m // 2] = float("nan")
    elif kind == "inf" and e.dtype == torch.float32:
        e[0], e[-1] = -float("inf"), float("inf")
    return e


def _hold_hist(x, e, section, want_path=None):
    ct = torch.promote_types(x.dtype, e.dtype)
    path = TK.histogram_path(e.to(ct))
    if want_path is not None:
        assert path == want_path
    before = ops.launch_counts()["histogram"]
    got = TK.histogram(x, e, section)
    torch.cuda.synchronize()
    assert ops.launch_counts()["histogram"] == before + 1
    want = TK.histogram_plain(x, e, section)
    assert torch.equal(got, want), (path, x.dtype, tuple(x.shape),
                                    e.numel())


class TestHistogram:
    @pytest.mark.parametrize("dtype", _DTYPES, ids=str)
    @pytest.mark.parametrize("m", [1, 8, 64, 128, 4095])
    @pytest.mark.parametrize("kind", ["ordered", "inf", "shuffled", "nan"])
    def test_both_forms(self, dev, dtype, m, kind):
        """Rows of 1, 31 and 1000 lanes (padded to sections of 64), NaN
        lanes in the float rows."""
        e = _edges(kind, m, dtype, dev)
        want_path = None
        if kind in ("shuffled", "nan") or m + 1 > \
                TK.HISTOGRAM_SEARCH_MAX_EDGES:
            want_path = "counts"
        elif kind == "ordered":
            want_path = "search"
        for n in (1, 31, 1000):
            x = _rows((3, n), dtype, seed=n + m, dev=dev)
            if dtype.is_floating_point and n > 3:
                x[0, ::3] = float("nan")
                x[1, 1] = float("inf")
            _hold_hist(x, e, 64, want_path)

    @pytest.mark.parametrize("m", [8, 64, 128])
    @pytest.mark.parametrize("kind", ["ordered", "shuffled", "nan"])
    def test_full_rows(self, dev, m, kind):
        """(64, 2^20) int32 and float32 rows, the kernel's own plan."""
        e = _edges(kind, m, torch.float32, dev) * 40
        xi = _rows((64, 1 << 20), torch.int32, seed=m, dev=dev) * 40
        xf = _rows((64, 1 << 20), torch.float32, seed=m + 1, dev=dev)
        xf[3, ::1000] = float("nan")
        for x in (xi, xf):
            _hold_hist(x, e, 1024)

    def test_unaligned_rows(self, dev):
        """Runs that start off a 16-byte boundary: the search form's head
        and tail lanes."""
        for dtype, off in ((torch.int32, 1), (torch.int8, 5),
                           (torch.float16, 3)):
            x = _rows((5, 3001), dtype, seed=off, dev=dev, offset=off)
            e = _edges("ordered", 16, dtype, dev)
            _hold_hist(x, e, 100, "search")

    def test_int_extremes(self, dev):
        top, low = 2 ** 31 - 1, -2 ** 31
        x = torch.tensor([[low, low + 1, -1, 0, 5, top - 1, top, top] * 9],
                         dtype=torch.int32, device=dev)
        for e in ([low, 0, top], [low, low, top - 1, top], [0, 5, 5, top]):
            _hold_hist(x, torch.tensor(e, dtype=torch.int32, device=dev), 8,
                       "search")


class TestTemplateMatch:
    @pytest.mark.parametrize("dtype", _DTYPES, ids=str)
    @pytest.mark.parametrize("m", [1, 2, 4, 5, 16, 63, 64])
    def test_grid(self, dev, dtype, m):
        for n in sorted({1, max(1, m - 1), _TILE - 1, _TILE, _TILE + 1,
                         3 * _TILE + 7}):
            x = _rows((3, n), dtype, seed=7 * n + m, dev=dev)
            t = torch.randn(m, device=dev) * 20
            before = ops.launch_counts()["template_match"]
            got = TK.template_match(x, t)
            torch.cuda.synchronize()
            assert ops.launch_counts()["template_match"] == before + 1
            assert torch.equal(_bits(got), _bits(TK.template_match_plain(
                x, t))), (n, m)

    @pytest.mark.parametrize("dtype,off", [(torch.int32, 1),
                                           (torch.int8, 5),
                                           (torch.bfloat16, 3)])
    def test_unaligned_rows(self, dev, dtype, off):
        x = _rows((3, 4099), dtype, seed=off, dev=dev, offset=off)
        for m in (3, 16):
            t = torch.randn(m, device=dev)
            assert torch.equal(_bits(TK.template_match(x, t)),
                               _bits(TK.template_match_plain(x, t)))

    @pytest.mark.parametrize("m", [2047, 2048, 2049, 4100,
                                   TK.TEMPLATE_MAX_M])
    def test_long_templates(self, dev, m):
        """Templates staged in chunks, up to the largest taken."""
        x = _rows((2, 3000), torch.int32, seed=m, dev=dev)
        t = torch.randn(m, device=dev)
        assert torch.equal(_bits(TK.template_match(x, t)),
                           _bits(TK.template_match_plain(x, t)))

    @pytest.mark.parametrize("m", [4, 16, 64])
    def test_full_rows(self, dev, m):
        x = _rows((64, 1 << 20), torch.int32, seed=m, dev=dev)
        t = x[5, 1000:1000 + m].float()
        got = TK.template_match(x, t)
        assert torch.equal(_bits(got), _bits(TK.template_match_plain(x, t)))
        assert float(got[5, 1000]) == 0.0


#: launch-dominated machine: fusing always pays
_FUSE = CostParams(1e-5, 1e-12, 1e-5, 1e-12, source="override")
#: launch-free machine with a pricier fused byte slope: never fuse
_EAGER = CostParams(1e-9, 1e-12, 1e-9, 2e-12, source="override")


class TestFusedTemplate:
    @pytest.mark.parametrize("dtype", [torch.int32, torch.float32], ids=str)
    @pytest.mark.parametrize("m", [1, 4, 7, 64])
    def test_stream_bit_for_bit(self, dev, dtype, m):
        """A stream with a template match fused in one launch and replayed
        on the eager kernels: the same rows, lengths and match bits."""
        n = 4096
        x = _rows((4, n), dtype, 13 + m, dev)
        ul = torch.tensor([n, n - 5, 1000, 3], dtype=torch.int32,
                          device=dev)
        tmpl = x[0, 10:10 + m].float()
        prog = (CPMProgram()
                .append("shift", start=100, end=n // 2, shift=3, fill=0)
                .append("template_match", template=tmpl))
        arr = cpm_array(x, ul, backend="cuda")
        fused = schedule(prog, device=arr, cost=_FUSE)
        eager = schedule(prog, device=arr, cost=_EAGER)
        assert [g.kind for g in fused.groups] == ["fused"]
        assert "eager" in [g.kind for g in eager.groups]
        ops.reset_launch_counts()
        of, pf = run_plan(fused, arr)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["fused_stream"] == 1
        assert counts["template_match"] == 0 and counts["shift_range"] == 0
        ops.reset_launch_counts()
        oe, pe = run_plan(eager, arr)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["fused_stream"] == 0
        assert counts["template_match"] == 1 and counts["shift_range"] == 1
        assert torch.equal(_bits(of.data), _bits(oe.data))
        assert torch.equal(of.used_len, oe.used_len)
        produced = [(a, b) for a, b in zip(pf, pe) if a is not None]
        assert produced
        for a, b in produced:
            assert torch.equal(_bits(a), _bits(b))
