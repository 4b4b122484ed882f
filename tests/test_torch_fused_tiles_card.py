"""The tiled ``fused_stream`` kernel and the stepped ``activate`` kernel on
the card (``-m cuda``; every test skips without one), held bit for bit
against ``fused_stream_tiled_plain`` and ``fused_stream_plain`` on the same
CUDA tensors: the serving commit (4, 320), nine-op streams on (7, 300)
rows with ``block_r=3``, the cost model's probe stream on (64, 16,384) and
(64, 1,048,576) rows, a shift wider than the halo cap (the pass form in
one cooperative launch) on the long rows, and pinned plans (small tiles,
a small cap); the kernel each plan runs (rows held in one tile, as the
commit's, the resident-row kernel; rows cut into tiles, the tiled one);
one ``fused_stream`` launch per fused group on long rows; ``activate`` on
1,048,576 lanes by value and from device tensors.  No JAX
here: the twins are held against JAX in ``tests/test_torch_fused_tiles.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.cpm import CPMProgram, cpm_array, tuning  # noqa: E402
from repro_torch.cpm.program import CostParams, run_plan  # noqa: E402
from repro_torch.cpm.program import schedule  # noqa: E402
from repro_torch.cpm.program.costmodel import _probe_program  # noqa: E402
from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

#: launch-dominated machine with a free fused byte slope: fusing always
#: pays, on rows of any length
_FUSE = CostParams(1e-5, 1e-12, 1e-5, 1e-18, source="override")
#: launch-free machine with a pricier fused byte slope: never fuse
_EAGER = CostParams(1e-9, 1e-12, 1e-9, 2e-12, source="override")


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


def _hold(got, want):
    """Rows (words moved, so every bit) and lengths bit for bit; flags
    bit for bit; float outputs bit for bit, a NaN matching any NaN."""
    gx, gul, gp = got
    wx, wul, wp = want
    torch.cuda.synchronize()
    assert torch.equal(gx.view(torch.int32), wx.view(torch.int32))
    assert torch.equal(gul, wul)
    assert len(gp) == len(wp)
    for a, b in zip(gp, wp):
        assert a.dtype == b.dtype
        if a.dtype == torch.float32:
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(torch.nan_to_num(a).view(torch.int32),
                               torch.nan_to_num(b).view(torch.int32))
        else:
            assert torch.equal(a, b)


def _stream(kind, dtype, r, n, per_row, seed):
    """Rows, lengths, a stream and its operands (numpy, from a seed):
    ``"nine"`` all nine instruction kinds, ``"wrapping"`` moves followed by
    producers that read across the row's end, ``"wide"`` a shift and a
    template wider than a 64-lane cap."""
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        x = rng.integers(-4, 5, (r, n)).astype(np.int32)
    else:
        x = (np.round(rng.standard_normal((r, n)) * 4) / 2).astype(
            np.float32)
        x[rng.random((r, n)) < 0.02] = np.nan
        x[rng.random((r, n)) < 0.05] = -0.0
    ul = np.array(([0, n // 2, n] + list(rng.integers(0, n + 1, r)))[:r],
                  np.int32)
    ct = "float32" if dtype == np.float32 else "int32"

    def rows(a):
        a = np.asarray(a)
        return a if per_row else a[:1].copy()

    def pair(lo, hi):
        return rows(np.stack([lo, hi], 1).astype(np.int32))

    if kind == "nine":
        instrs = (
            ("activate", (), 1),
            ("shift", (("shift", 3), ("has_fill", True)), 2),
            ("compare", (("op", "eq"), ("has_mask", False), ("ct", ct)), 1),
            ("insert", (("k", 3),), 2),
            ("template_match", (("m", 5), ("mask_tail", False)), 1),
            ("substring_match", (("m", 3), ("where", "start")), 1),
            ("delete", (("k", 2),), 2),
            ("compare", (("op", "lt"), ("has_mask", False),
                         ("ct", "float32")), 1),
            ("substring_match", (("m", 2), ("where", "end")), 1),
            ("stencil", (("taps", (0.25, 1.5, 0.0, -0.75, 0.125)),
                         ("wrap", True)), 0),
            ("shift", (("shift", -2), ("has_fill", False)), 1),
            ("stencil", (("taps", (0.5, 1.0, 0.5)), ("wrap", False)), 0),
            ("truncate", (), 1),
            ("template_match", (("m", 3), ("mask_tail", True)), 1))
        opnds = [
            rows(np.stack([rng.integers(-3, 4, r),
                           rng.integers(n // 2, n + 3, r),
                           rng.integers(1, 4, r)], 1).astype(np.int32)),
            pair(rng.integers(-2, 5, r), rng.integers(n // 2, n + 2, r)),
            rows(np.full((r, 1), -9, dtype)),
            rows(np.zeros((r, 1), np.float32 if ct == "float32"
                          else np.int32)),
            rows(rng.integers(0, n, (r, 1)).astype(np.int32)),
            rows(rng.integers(-4, 5, (r, 3)).astype(dtype)),
            rows(rng.integers(-3, 4, (r, 5)).astype(np.float32)),
            rows(x[:, 2:5].copy()),
            rows(rng.integers(0, n, (r, 1)).astype(np.int32)),
            rows(np.full((r, 1), 7, dtype)),
            rows(np.full((r, 1), 0.5, np.float32)),
            rows(x[:, 6:8].copy()),
            pair(rng.integers(0, n // 4, r), rng.integers(n - 5, n, r)),
            rows(rng.integers(n // 4, n + 1, (r, 1)).astype(np.int32)),
            rows(rng.integers(-3, 4, (r, 3)).astype(np.int32))]
    elif kind == "wrapping":
        instrs = (
            ("shift", (("shift", 9), ("has_fill", True)), 2),
            ("template_match", (("m", 7), ("mask_tail", False)), 1),
            ("insert", (("k", 4),), 2),
            ("stencil", (("taps", (1.0, -2.0, 0.5, 0.25, 1.0)),
                         ("wrap", True)), 0),
            ("shift", (("shift", -6), ("has_fill", False)), 1),
            ("template_match", (("m", 12), ("mask_tail", False)), 1),
            ("delete", (("k", 5),), 2),
            ("stencil", (("taps", (0.5, 1.0, 0.5)), ("wrap", True)), 0))
        opnds = [
            pair(np.zeros(r), np.full(r, n - 1)),
            rows(np.full((r, 1), 3, dtype)),
            rows(rng.integers(-3, 4, (r, 7)).astype(np.float32)),
            rows(rng.integers(0, 3, (r, 1)).astype(np.int32)),
            rows(rng.integers(-4, 5, (r, 4)).astype(dtype)),
            pair(np.full(r, 2), np.full(r, n - 1)),
            rows(rng.integers(-2, 3, (r, 12)).astype(np.float32)),
            rows(rng.integers(0, 4, (r, 1)).astype(np.int32)),
            rows(np.full((r, 1), -1, dtype))]
    else:
        instrs = (
            ("compare", (("op", "ge"), ("has_mask", False), ("ct", ct)), 1),
            ("shift", (("shift", 300), ("has_fill", True)), 2),
            ("stencil", (("taps", (0.5, 1.0, 0.5)), ("wrap", True)), 0),
            ("insert", (("k", 2),), 2),
            ("template_match", (("m", 90), ("mask_tail", True)), 1),
            ("shift", (("shift", -250), ("has_fill", False)), 1),
            ("activate", (), 1),
            ("shift", (("shift", 5), ("has_fill", False)), 1),
            ("template_match", (("m", 4), ("mask_tail", False)), 1))
        opnds = [
            rows(np.zeros((r, 1), dtype)),
            pair(rng.integers(0, 50, r), np.full(r, n - 1)),
            rows(np.full((r, 1), 2, dtype)),
            rows(rng.integers(0, n, (r, 1)).astype(np.int32)),
            rows(np.array([[8, 9]] * r, dtype)),
            rows(rng.integers(-3, 4, (r, 90)).astype(np.float32)),
            pair(np.full(r, 100), np.full(r, n - 50)),
            rows(np.stack([rng.integers(-5, 5, r),
                           rng.integers(n - 9, n + 9, r),
                           rng.integers(1, 5, r)], 1).astype(np.int32)),
            pair(np.full(r, 10), np.full(r, n - 20)),
            rows(rng.integers(-3, 4, (r, 4)).astype(np.float32))]
    return x, ul, instrs, opnds


def _on(dev, x, ul, instrs, opnds):
    return (torch.from_numpy(x).to(dev), torch.from_numpy(ul).to(dev),
            instrs, tuple(torch.from_numpy(o).to(dev) for o in opnds))


def _statics(instrs):
    return tuple((op, st) for op, st, _ in instrs)


def _probe(dev, r, n):
    """The cost model's probe stream (shift, compare, activate, stencil)
    over (r, n) int32 rows, as the fused executor lowers it."""
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randint(-2 ** 20, 2 ** 20, (r, n), generator=g,
                      device=dev, dtype=torch.int32)
    ul = torch.randint(0, n + 1, (r,), generator=g, device=dev,
                       dtype=torch.int32)
    instrs = (("shift", (("shift", 1), ("has_fill", True)), 2),
              ("compare", (("op", "lt"), ("has_mask", False),
                           ("ct", "int32")), 1),
              ("activate", (), 1),
              ("stencil", (("taps", (1.0, 2.0, 1.0)), ("wrap", False)), 0))
    i32 = torch.int32
    opnds = (torch.tensor([[0, n // 2]], dtype=i32, device=dev),
             torch.tensor([[0]], dtype=i32, device=dev),
             torch.tensor([[3]], dtype=i32, device=dev),
             torch.tensor([[0, n - 1, 1]], dtype=i32, device=dev))
    return x, ul, instrs, opnds


def _kernels(fn, calls=20):
    """The fused_stream kernels ``fn`` launches, by name (torch.profiler,
    which can drop a record: 20 calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()]
    return {k for k in ("fused_resident_kernel", "fused_tiles_kernel")
            if any(k in key for key in keys)}


@pytest.fixture
def pinned(monkeypatch):
    """Run the wrapper under a given plan (it looks the plan up in its
    module)."""
    def pin(plan):
        monkeypatch.setattr(TK, "fused_plan", lambda *a, **k: plan)
    return pin


class TestKernelAgainstTwins:
    def test_serving_commit(self, dev):
        """insert -> truncate at (4, 320), one tile a row."""
        rng = np.random.default_rng(5)
        r, n, k = 4, 320, 4
        buf = rng.integers(0, 49152, (r, n)).astype(np.int32)
        used = rng.integers(256, n - k, (r,)).astype(np.int32)
        preds = rng.integers(0, 49152, (r, k)).astype(np.int32)
        emit = rng.integers(0, k + 1, (r,)).astype(np.int32)
        args = _on(dev, buf, used, (("insert", (("k", k),), 2),
                                    ("truncate", (), 1)),
                   [used[:, None].copy(), preds,
                    (used + emit)[:, None].copy()])
        ops.reset_launch_counts()
        got = TK.fused_stream(*args)
        assert ops.launch_counts()["fused_stream"] == 1
        _hold(got, TK.fused_stream_tiled_plain(*args))
        _hold(got, TK.fused_stream_plain(*args))
        assert _kernels(lambda: TK.fused_stream(*args)) == \
            {"fused_resident_kernel"}

    @pytest.mark.parametrize("per_row", [False, True])
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    @pytest.mark.parametrize("kind", ["nine", "wrapping", "wide"])
    def test_streams_block_r_3(self, dev, kind, dtype, per_row):
        """(7, 300) rows, three rows a block."""
        args = _on(dev, *_stream(kind, dtype, 7, 300, per_row, 2))
        got = TK.fused_stream(*args, block_r=3)
        _hold(got, TK.fused_stream_tiled_plain(*args))
        _hold(got, TK.fused_stream_plain(*args, block_r=3))

    @pytest.mark.parametrize("n", [16384, 1 << 20])
    def test_probe_stream(self, dev, n):
        """The cost model's probe at (64, 16,384) and (64, 1,048,576)."""
        args = _probe(dev, 64, n)
        plan = TK.fused_plan(64, n, _statics(args[2]))
        assert plan.tiles > 1 and len(plan.passes) == 1
        got = TK.fused_stream(*args)
        _hold(got, TK.fused_stream_plain(*args))
        if n <= 16384:
            _hold(got, TK.fused_stream_tiled_plain(*args))
            assert _kernels(lambda: TK.fused_stream(*args)) == \
                {"fused_tiles_kernel"}

    @pytest.mark.parametrize("block_r", [1, 8, 64])
    def test_wide_shift_on_long_rows(self, dev, block_r):
        """A shift by 100,000 lanes and a 2,100-item template on (64,
        1,048,576) rows: two passes in one cooperative launch."""
        x, ul, _, _ = _probe(dev, 64, 1 << 20)
        n = x.shape[1]
        instrs = (("shift", (("shift", 100000), ("has_fill", True)), 2),
                  ("stencil", (("taps", (1.0, 2.0, 1.0)), ("wrap", True)),
                   0),
                  ("template_match", (("m", 2100), ("mask_tail", True)), 1),
                  ("delete", (("k", 7),), 2))
        i32 = torch.int32
        opnds = (torch.tensor([[5, n - 3]], dtype=i32, device=dev),
                 torch.tensor([[-1]], dtype=i32, device=dev),
                 x[0, :2100].float().reshape(1, -1).contiguous(),
                 (ul // 3).reshape(-1, 1).contiguous(),
                 torch.tensor([[9]], dtype=i32, device=dev))
        plan = TK.fused_plan(64, n, _statics(instrs))
        assert [p[2] for p in plan.passes] == [True, True]
        ops.reset_launch_counts()
        got = TK.fused_stream(x, ul, instrs, opnds, block_r=block_r)
        assert ops.launch_counts()["fused_stream"] == 1
        _hold(got, TK.fused_stream_plain(x, ul, instrs, opnds))

    @pytest.mark.parametrize("tile,cap", [(128, TK.FS_HALO_CAP), (48, 4),
                                          (128, 64), (16, 64)])
    @pytest.mark.parametrize("kind", ["nine", "wrapping", "wide"])
    def test_pinned_plans(self, dev, pinned, kind, tile, cap):
        """Small tiles (halos crossing tiles, wrapped reads at the row's
        last tile) and small caps (several passes)."""
        for dtype in (np.int32, np.float32):
            args = _on(dev, *_stream(kind, dtype, 5, 1000, True, tile))
            plan = TK.fused_plan(5, 1000, _statics(args[2]), tile=tile,
                                 cap=cap)
            want = TK.fused_stream_tiled_plain(*args, plan=plan)
            pinned(plan)
            for block_r in (1, 2):
                _hold(TK.fused_stream(*args, block_r=block_r), want)

    def test_repeats_bit_for_bit(self, dev):
        args = _on(dev, *_stream("wide", np.float32, 7, 300, True, 4))
        a, b = TK.fused_stream(*args), TK.fused_stream(*args)
        _hold(a, b)


class TestLaunches:
    @pytest.mark.parametrize("tile,want", [(1000, "fused_resident_kernel"),
                                           (992, "fused_tiles_kernel")])
    @pytest.mark.parametrize("kind", ["nine", "wrapping", "wide"])
    def test_one_tile_rows_run_resident(self, dev, pinned, kind, tile,
                                        want):
        """A plan that holds the (5, 1,000) rows in one tile runs the
        resident-row kernel, one a tile short of them the tiled kernel;
        both bit for bit with the twin, at one and two rows a block."""
        for dtype in (np.int32, np.float32):
            args = _on(dev, *_stream(kind, dtype, 5, 1000, True, 3))
            plan = TK.fused_plan(5, 1000, _statics(args[2]), tile=tile)
            pinned(plan)
            assert _kernels(lambda: TK.fused_stream(*args)) == {want}
            for block_r in (1, 2):
                _hold(TK.fused_stream(*args, block_r=block_r),
                      TK.fused_stream_plain(*args, block_r=block_r))

    def test_one_launch_a_group_on_long_rows(self, dev):
        """A fused group on (4, 1,048,576) int32 rows is one fused_stream
        launch (no per-op replay), equal to the eager plan's replay on the
        per-op kernels."""
        x, ul, _, _ = _probe(dev, 4, 1 << 20)
        prog = (CPMProgram()
                .append("shift", start=3, end=(1 << 19), shift=2, fill=-1)
                .append("insert", pos=1000, values=[7, 8, 9])
                .append("compare", datum=5, op="gt")
                .append("delete", pos=77, k=2, fill=0)
                .append("stencil", taps=(1.0, 2.0, 1.0), wrap=True))
        arr = cpm_array(x, ul, backend="cuda")
        plan = schedule(prog, device=arr, cost=_FUSE)
        assert [g.kind for g in plan.groups] == ["fused"]
        ops.reset_launch_counts()
        got, outs = run_plan(plan, arr)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == {"fused_stream": 1}
        eager = schedule(prog, device=arr, cost=_EAGER)
        assert "eager" in [g.kind for g in eager.groups]
        ref, ref_outs = run_plan(eager, arr)
        assert torch.equal(got.data, ref.data)
        assert torch.equal(got.used_len, ref.used_len)
        for a, b in zip(outs, ref_outs):
            if a is not None:
                assert torch.equal(a.view(torch.uint8) if a.dtype ==
                                   torch.bool else a.view(torch.int32),
                                   b.view(torch.uint8) if b.dtype ==
                                   torch.bool else b.view(torch.int32))

    def test_probe_fused_on_the_paper_rows(self, dev):
        """The cost model's probe program on (64, 1,048,576) rows, forced
        fused: one launch."""
        x, ul, _, _ = _probe(dev, 64, 1 << 20)
        arr = cpm_array(x, 1 << 20, backend="cuda")
        plan = schedule(_probe_program(1 << 20), device=arr, cost=_FUSE)
        assert [g.kind for g in plan.groups] == ["fused"]
        ops.reset_launch_counts()
        run_plan(plan, arr)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.launch_counts().items() if v} == \
            {"fused_stream": 1}


class TestActivate:
    @pytest.mark.parametrize("carry", [1, 2, 3, 7, 1000])
    @pytest.mark.parametrize("start,end", [
        (0, (1 << 20) - 1), (-5, (1 << 20) + 9), (17, 63), (40, 39),
        (1000, 500000), (-2 ** 31, 2 ** 31 - 1), (-2 ** 31 + 3, 90)])
    def test_by_value_and_from_tensors(self, dev, carry, start, end):
        n = 1 << 20
        want = TK.activate_plain(n, start, end, carry, device=dev)
        ops.reset_launch_counts()
        got = TK.activate(n, start, end, carry, device=dev)
        p = torch.tensor([start, end, carry], dtype=torch.int32, device=dev)
        got_t = TK.activate(n, p[0], p[1], p[2])
        torch.cuda.synchronize()
        assert ops.launch_counts()["activate"] == 2
        assert torch.equal(got, want) and torch.equal(got_t, want)

    @pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 1000003])
    def test_ragged_lengths(self, dev, n):
        for carry in (1, 3):
            assert torch.equal(TK.activate(n, 2, n - 3, carry, device=dev),
                               TK.activate_plain(n, 2, n - 3, carry,
                                                 device=dev))
