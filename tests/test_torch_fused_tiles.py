"""The tiled ``fused_stream`` kernel's plan and index arithmetic, and the
stepped ``activate``, on the CPU (no GPU needed).

``fused_stream_tiled_plain`` replays what ``csrc/fused_stream.cu``'s
blocks do — tiles with halos, windows holding lanes modulo N, moves from
slot to slot, wrapped reads, the pass form's lead instructions against
the rows in memory — and raises where a real lane would read a slot its
halo does not cover.  It is held bit for bit against ``fused_stream_plain``
and the JAX kernel in interpret mode, on small tiles that make the halos
cross tiles, a move followed by producers that wrap across the row's end,
a shift wider than the halo cap, and rows past the old resident-row
limit.  ``fused_plan``'s halos are held against the smallest halos the
twin accepts and the reach a perturbed lane shows.  The kernel itself is
held against the twin on the card in
``tests/test_torch_fused_tiles_card.py``.
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
    JK = None

from repro_torch.kernels import cpm_kernels as TK  # noqa: E402


@pytest.fixture
def jk():
    if JK is None:
        pytest.skip("needs JAX, the reference package")
    return JK


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _same(a, b, what=""):
    """Bit for bit; a float NaN matches any NaN (payloads are the CPU's)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), what)
        a, b = np.where(np.isnan(a), 0, a), np.where(np.isnan(b), 0, b)
    np.testing.assert_array_equal(_bits(a), _bits(b), what)


def _lengths(rng, r, n):
    """Per-row used lengths at 0, mid and n, then random."""
    fixed = [0, n // 2, n]
    return np.array(fixed[:r] + list(rng.integers(0, n + 1, max(r - 3, 0))),
                    np.int32)


def _rows(rng, dtype, r, n):
    if dtype == np.int32:
        return rng.integers(-4, 5, (r, n)).astype(np.int32)
    x = (np.round(rng.standard_normal((r, n)) * 4) / 2).astype(np.float32)
    x[rng.random((r, n)) < 0.02] = np.nan          # NaN and -0.0 lanes for
    x[rng.random((r, n)) < 0.05] = -0.0            # the compares
    return x


def _nine(rng, x, ul, per_row):
    """All nine instruction kinds, moves between wrapping producers."""
    r, n = x.shape
    dt = x.dtype
    ct = "float32" if dt == np.float32 else "int32"

    def rows(a):
        a = np.asarray(a)
        return a if per_row else a[:1].copy()

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
        ("template_match", (("m", 3), ("mask_tail", True)), 1),
    )
    ops = [
        rows(np.stack([rng.integers(-3, 4, r), rng.integers(n // 2, n + 3, r),
                       rng.integers(1, 4, r)], 1).astype(np.int32)),
        rows(np.stack([rng.integers(-2, 5, r), rng.integers(n // 2, n + 2, r)],
                      1).astype(np.int32)),
        rows(np.full((r, 1), -9, dt)),
        rows(np.zeros((r, 1), np.float32 if ct == "float32" else np.int32)),
        rows(rng.integers(0, n, (r, 1)).astype(np.int32)),
        rows(rng.integers(-4, 5, (r, 3)).astype(dt)),
        rows(rng.integers(-3, 4, (r, 5)).astype(np.float32)),
        rows(x[:, 2:5].copy()),
        rows(rng.integers(0, n, (r, 1)).astype(np.int32)),
        rows(np.full((r, 1), 7, dt)),
        rows(np.full((r, 1), 0.5, np.float32)),
        rows(x[:, 6:8].copy()),
        rows(np.stack([rng.integers(0, n // 4, r), rng.integers(n - 5, n, r)],
                      1).astype(np.int32)),
        rows(rng.integers(n // 4, n + 1, (r, 1)).astype(np.int32)),
        rows(rng.integers(-3, 4, (r, 3)).astype(np.int32)),
    ]
    return instrs, ops


def _wrapping(rng, x, ul, per_row):
    """Moves, each followed by a producer that reads across the row's end:
    template matches (reading lanes i .. i + m - 1 modulo N) and ringed
    stencils (reading lanes on both sides modulo N)."""
    r, n = x.shape
    dt = x.dtype

    def rows(a):
        a = np.asarray(a)
        return a if per_row else a[:1].copy()

    instrs = (
        ("shift", (("shift", 9), ("has_fill", True)), 2),
        ("template_match", (("m", 7), ("mask_tail", False)), 1),
        ("insert", (("k", 4),), 2),
        ("stencil", (("taps", (1.0, -2.0, 0.5, 0.25, 1.0)),
                     ("wrap", True)), 0),
        ("shift", (("shift", -6), ("has_fill", False)), 1),
        ("template_match", (("m", 12), ("mask_tail", False)), 1),
        ("delete", (("k", 5),), 2),
        ("stencil", (("taps", (0.5, 1.0, 0.5)), ("wrap", True)), 0),
    )
    ops = [
        rows(np.stack([np.zeros(r, np.int64), np.full(r, n - 1)],
                      1).astype(np.int32)),             # the whole row
        rows(np.full((r, 1), 3, dt)),
        rows(rng.integers(-3, 4, (r, 7)).astype(np.float32)),
        rows(rng.integers(0, 3, (r, 1)).astype(np.int32)),
        rows(rng.integers(-4, 5, (r, 4)).astype(dt)),
        rows(np.stack([np.full(r, 2), np.full(r, n - 1)], 1).astype(np.int32)),
        rows(rng.integers(-2, 3, (r, 12)).astype(np.float32)),
        rows(rng.integers(0, 4, (r, 1)).astype(np.int32)),
        rows(np.full((r, 1), -1, dt)),
    ]
    return instrs, ops


def _wide(rng, x, ul, per_row):
    """A shift wider than the plan's halo cap, then producers, a template
    longer than the cap, and a narrow move: the pass form."""
    r, n = x.shape
    dt = x.dtype

    def rows(a):
        a = np.asarray(a)
        return a if per_row else a[:1].copy()

    instrs = (
        ("compare", (("op", "ge"), ("has_mask", False),
                     ("ct", "float32" if dt == np.float32 else "int32")), 1),
        ("shift", (("shift", 300), ("has_fill", True)), 2),
        ("stencil", (("taps", (0.5, 1.0, 0.5)), ("wrap", True)), 0),
        ("insert", (("k", 2),), 2),
        ("template_match", (("m", 90), ("mask_tail", True)), 1),
        ("shift", (("shift", -250), ("has_fill", False)), 1),
        ("activate", (), 1),
        ("shift", (("shift", 5), ("has_fill", False)), 1),
        ("template_match", (("m", 4), ("mask_tail", False)), 1),
    )
    ops = [
        rows(np.zeros((r, 1), dt)),
        rows(np.stack([rng.integers(0, 50, r), np.full(r, n - 1)],
                      1).astype(np.int32)),
        rows(np.full((r, 1), 2, dt)),
        rows(rng.integers(0, n, (r, 1)).astype(np.int32)),
        rows(np.array([[8, 9]] * r, dt)),
        rows(rng.integers(-3, 4, (r, 90)).astype(np.float32)),
        rows(np.stack([np.full(r, 100), np.full(r, n - 50)],
                      1).astype(np.int32)),
        rows(np.stack([rng.integers(-5, 5, r), rng.integers(n - 9, n + 9, r),
                       rng.integers(1, 5, r)], 1).astype(np.int32)),
        rows(np.stack([np.full(r, 10), np.full(r, n - 20)],
                      1).astype(np.int32)),
        rows(rng.integers(-3, 4, (r, 4)).astype(np.float32)),
    ]
    return instrs, ops


_STREAMS = {"nine": _nine, "wrapping": _wrapping, "wide": _wide}


def _case(kind, dtype, per_row, seed, r=5, n=1000):
    rng = np.random.default_rng(seed)
    x = _rows(rng, dtype, r, n)
    ul = _lengths(rng, r, n)
    instrs, ops = _STREAMS[kind](rng, x, ul, per_row)
    return x, ul, instrs, ops


def _torch(x, ul, instrs, ops):
    return (torch.from_numpy(x), torch.from_numpy(ul), instrs,
            tuple(torch.from_numpy(o) for o in ops))


def _statics(instrs):
    return tuple((op, st) for op, st, _ in instrs)


def _plan(x, instrs, tile=128, cap=TK.FS_HALO_CAP):
    r, n = x.shape
    return TK.fused_plan(r, n, _statics(instrs), tile=tile, cap=cap)


def _hold(got, want, what="", instrs=None):
    """Rows, lengths and outputs bit for bit.  Given the stream
    (``instrs``, for a JAX result), a stencil output is held equal in
    value, a zero's sign aside: XLA folds the body's ``0.0 + w * x`` into
    ``w * x`` (so a -0.0 product stays -0.0), and may contract
    multiply-adds (``tests/test_torch_kernels.py``); here every product
    and sum is exact, so only the sign of a zero can differ."""
    gx, gul, gp = (got[0], got[1], got[2])
    wx, wul, wp = want
    _same(np.asarray(wx), np.asarray(gx), f"{what} rows")
    np.testing.assert_array_equal(np.asarray(wul), np.asarray(gul),
                                  f"{what} lengths")
    assert len(gp) == len(wp), what
    prods = [op for op, _, _ in instrs if op in TK.FUSED_PRODUCERS] \
        if instrs else [None] * len(gp)
    for j, (a, b, op) in enumerate(zip(gp, wp, prods)):
        if op == "stencil":
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          f"{what} output {j}")
        else:
            _same(np.asarray(b), np.asarray(a), f"{what} output {j}")


def _np_out(out):
    x, ul, prods = out
    return x.numpy(), ul.numpy(), [p.numpy() for p in prods]


class TestTiledTwin:
    """``fused_stream_tiled_plain`` bit for bit with the untiled twin and
    the JAX kernel in interpret mode."""

    @pytest.mark.parametrize("per_row", [False, True])
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    @pytest.mark.parametrize("kind,tile,cap", [
        ("nine", 128, TK.FS_HALO_CAP), ("wrapping", 128, TK.FS_HALO_CAP),
        ("wide", 128, 64), ("nine", 48, 4)])
    def test_matches_plain_and_jax(self, jk, kind, tile, cap, dtype,
                                   per_row):
        x, ul, instrs, ops = _case(kind, dtype, per_row, seed=11 + tile)
        plan = _plan(x, instrs, tile, cap)
        assert plan.tiles == -(-1000 // tile)
        got = _np_out(TK.fused_stream_tiled_plain(*_torch(x, ul, instrs,
                                                          ops), plan=plan))
        _hold(got, _np_out(TK.fused_stream_plain(*_torch(x, ul, instrs,
                                                         ops))), "plain")
        want = jk.fused_stream(jnp.asarray(x), jnp.asarray(ul), instrs,
                               tuple(jnp.asarray(o) for o in ops),
                               interpret=True)
        _hold(got, (want[0], want[1], list(want[2])), "jax", instrs)

    @pytest.mark.parametrize("kind", list(_STREAMS))
    def test_default_plan_is_the_wrappers(self, kind):
        """Without a plan the twin runs fused_plan's, as the kernel does,
        and equals the untiled twin."""
        x, ul, instrs, ops = _case(kind, np.int32, True, seed=3)
        got = TK.fused_stream_tiled_plain(*_torch(x, ul, instrs, ops))
        _hold(_np_out(got),
              _np_out(TK.fused_stream_plain(*_torch(x, ul, instrs, ops))))

    def test_wide_stream_takes_passes(self):
        """The 300- and 250-lane shifts and the 90-item template exceed a
        64-lane cap, so each leads a pass; under the default cap the stream
        is one pass."""
        x, ul, instrs, ops = _case("wide", np.int32, True, seed=4)
        plan = _plan(x, instrs, 128, 64)
        assert plan.passes == ((0, 1, False), (1, 4, True), (4, 5, True),
                               (5, 9, True))
        assert (plan.halo_l, plan.halo_r) == (5, 3)
        assert len(_plan(x, instrs).passes) == 1

    def test_row_past_the_old_limit(self, jk):
        """(2, 30,000) int32 rows, more than two resident copies fit in
        shared memory: insert -> truncate -> compare under the default
        plan (several tiles a row)."""
        rng = np.random.default_rng(7)
        n = 30000
        x = rng.integers(0, 50, (2, n)).astype(np.int32)
        ul = np.array([29990, 12], np.int32)
        instrs = (("insert", (("k", 4),), 2), ("truncate", (), 1),
                  ("compare", (("op", "gt"), ("has_mask", False),
                               ("ct", "int32")), 1))
        ops = [np.array([[100], [3]], np.int32),
               rng.integers(60, 70, (2, 4)).astype(np.int32),
               np.array([[29992], [20]], np.int32),
               np.array([[25]], np.int32)]
        plan = TK.fused_plan(2, n, _statics(instrs))
        assert plan.tiles > 1 and plan.halo_l == 4
        got = _np_out(TK.fused_stream_tiled_plain(*_torch(x, ul, instrs,
                                                          ops)))
        _hold(got, _np_out(TK.fused_stream_plain(*_torch(x, ul, instrs,
                                                         ops))))
        want = jk.fused_stream(jnp.asarray(x), jnp.asarray(ul), instrs,
                               tuple(jnp.asarray(o) for o in ops),
                               interpret=True)
        _hold(got, (want[0], want[1], list(want[2])), "jax", instrs)

    def test_wide_shift_default_cap_past_the_old_limit(self, jk):
        """A shift by 5,000 lanes on 30,000-lane rows: past the default
        cap, so a pass of its own reads the rows in memory."""
        rng = np.random.default_rng(8)
        n = 30000
        x = rng.integers(-9, 9, (2, n)).astype(np.int32)
        ul = np.array([n, 7000], np.int32)
        instrs = (("shift", (("shift", -5000), ("has_fill", True)), 2),
                  ("stencil", (("taps", (1.0, 2.0, 1.0)), ("wrap", False)),
                   0),
                  ("delete", (("k", 3),), 2))
        ops = [np.array([[5000, n - 1]], np.int32), np.array([[-1]], np.int32),
               np.array([[11], [6000]], np.int32), np.array([[0]], np.int32)]
        plan = TK.fused_plan(2, n, _statics(instrs))
        assert plan.passes[0] == (0, 3, True)
        got = _np_out(TK.fused_stream_tiled_plain(*_torch(x, ul, instrs,
                                                          ops)))
        want = jk.fused_stream(jnp.asarray(x), jnp.asarray(ul), instrs,
                               tuple(jnp.asarray(o) for o in ops),
                               interpret=True)
        _hold(got, (want[0], want[1], list(want[2])), "jax", instrs)

    @pytest.mark.parametrize("tile", [16, 48, 100, 128, 333, 999, 1000,
                                      4096])
    @pytest.mark.parametrize("kind", list(_STREAMS))
    def test_every_tile_width(self, kind, tile):
        """The tiled twin equals the untiled one whatever the tile width,
        one tile a row or many, ragged or not."""
        x, ul, instrs, ops = _case(kind, np.float32, True, seed=5, r=3)
        cap = 64 if kind == "wide" else TK.FS_HALO_CAP
        got = TK.fused_stream_tiled_plain(*_torch(x, ul, instrs, ops),
                                          plan=_plan(x, instrs, tile, cap))
        _hold(_np_out(got),
              _np_out(TK.fused_stream_plain(*_torch(x, ul, instrs, ops))))

    @pytest.mark.parametrize("n", [9, 17, 40])
    def test_rows_shorter_than_a_window(self, n):
        """Rows shorter than the halos: a window holds some lanes more
        than once, each moved alike."""
        x, ul, instrs, ops = _case("nine", np.int32, True, seed=6, r=4,
                                   n=n)
        for tile in (4, 16, n):
            got = TK.fused_stream_tiled_plain(*_torch(x, ul, instrs, ops),
                                              plan=_plan(x, instrs, tile))
            _hold(_np_out(got),
                  _np_out(TK.fused_stream_plain(*_torch(x, ul, instrs,
                                                        ops))))


class TestPlan:
    @pytest.mark.parametrize("kind", list(_STREAMS))
    def test_halos_are_the_least_the_twin_accepts(self, kind):
        """The twin raises where a real lane reads outside its halo: the
        plan's halos are exactly the least it accepts."""
        x, ul, instrs, ops = _case(kind, np.int32, True, seed=9, r=2)
        cap = 64 if kind == "wide" else TK.FS_HALO_CAP
        plan = _plan(x, instrs, 128, cap)
        args = _torch(x, ul, instrs, ops)
        TK.fused_stream_tiled_plain(*args, plan=plan)
        for side in ("halo_l", "halo_r"):
            h = getattr(plan, side)
            assert h > 0
            with pytest.raises(AssertionError, match="halo too small"):
                TK.fused_stream_tiled_plain(
                    *args, plan=plan._replace(**{side: h - 1}))

    @pytest.mark.parametrize("seed", range(6))
    def test_halos_cover_a_perturbed_lanes_reach(self, seed):
        """A brute-force reach: change one lane of the input and see which
        lanes of the rows and outputs change; each lies within the plan's
        halos of the lane changed (distances taken around the ring)."""
        rng = np.random.default_rng(100 + seed)
        n = 240
        x = rng.standard_normal((1, n)).astype(np.float32)
        ul = np.array([n - 5], np.int32)
        kind = ("nine", "wrapping")[seed % 2]
        instrs, ops = _STREAMS[kind](rng, x, ul, True)
        plan = TK.fused_plan(1, n, _statics(instrs))
        base = _np_out(TK.fused_stream_plain(*_torch(x, ul, instrs, ops)))
        left = right = 0
        for j in range(n):
            y = x.copy()
            y[0, j] = 1000.0 + j
            out = _np_out(TK.fused_stream_plain(*_torch(y, ul, instrs,
                                                        ops)))
            for a, b in zip([out[0]] + out[2], [base[0]] + base[2]):
                a, b = np.nan_to_num(a[0], nan=7.5), np.nan_to_num(b[0],
                                                                   nan=7.5)
                for i in np.nonzero(_bits(a) != _bits(b))[0]:
                    d = (j - int(i)) % n          # lane i read lane j
                    if d <= n // 2:
                        right = max(right, d)
                    else:
                        left = max(left, n - d)
        assert left <= plan.halo_l and right <= plan.halo_r
        assert left > 0 and right > 0

    @pytest.mark.parametrize("op,statics,reach", [
        ("shift", (("shift", 7), ("has_fill", False)), ("move", 7, 0)),
        ("shift", (("shift", -7), ("has_fill", True)), ("move", 0, 7)),
        ("shift", (("shift", 1000), ("has_fill", True)), ("move", 0, 0)),
        ("insert", (("k", 4),), ("move", 4, 0)),
        ("delete", (("k", 4),), ("move", 0, 4)),
        ("substring_match", (("m", 5), ("where", "end")),
         ("producer", 4, 0)),
        ("substring_match", (("m", 5), ("where", "start")),
         ("producer", 0, 4)),
        ("substring_match", (("m", 2000), ("where", "start")),
         ("producer", 0, 0)),
        ("template_match", (("m", 64), ("mask_tail", True)),
         ("producer", 0, 63)),
        ("stencil", (("taps", (1.0, 2.0, 1.0)), ("wrap", False)),
         ("producer", 1, 1)),
        ("stencil", (("taps", (1.0, 2.0, 3.0, 4.0)), ("wrap", True)),
         ("producer", 1, 2)),
        ("compare", (("op", "eq"), ("has_mask", False), ("ct", "int32")),
         ("none", 0, 0)),
        ("activate", (), ("none", 0, 0)),
        ("truncate", (), ("none", 0, 0))])
    def test_reach_of_each_instruction(self, op, statics, reach):
        assert TK.fused_reach(op, statics, 1000) == reach

    def test_card_shapes(self):
        """The serving commit is one tile a row with a 4-lane left halo;
        the probe stream tiles its rows; every window fits shared
        memory."""
        commit = (("insert", (("k", 4),)), ("truncate", ()))
        plan = TK.fused_plan(4, 320, commit)
        assert (plan.tile, plan.tiles, plan.halo_l, plan.halo_r) == \
            (320, 1, 4, 0) and plan.passes == ((0, 2, False),)
        probe = (("shift", (("shift", 1), ("has_fill", True))),
                 ("compare", (("op", "lt"), ("has_mask", False),
                              ("ct", "int32"))),
                 ("activate", ()),
                 ("stencil", (("taps", (1.0, 2.0, 1.0)), ("wrap", False))))
        for n, tiles in ((16384, 4), (1 << 20, 128)):
            plan = TK.fused_plan(64, n, probe)
            assert (plan.halo_l, plan.halo_r, plan.tiles) == (2, 1, tiles)
            assert plan.smem() <= TK.MAX_SMEM_BYTES
        wide = (("shift", (("shift", 100000), ("has_fill", False))),
                ("template_match", (("m", 3000), ("mask_tail", False))))
        plan = TK.fused_plan(64, 1 << 20, wide)
        assert plan.passes == ((0, 1, True), (1, 2, True))
        assert plan.smem() <= TK.MAX_SMEM_BYTES

    def test_descriptor_carries_the_plan(self):
        """The by-value descriptor holds the tile, halos and passes."""
        x, ul, instrs, ops = _case("wide", np.int32, True, seed=4)
        tx, tul, _, tops = _torch(x, ul, instrs, ops)
        plan = _plan(x, instrs, 128, 64)
        prods = [torch.empty((5, 1000), dtype=TK.FUSED_PRODUCERS[op])
                 for op, _, _ in instrs if op in TK.FUSED_PRODUCERS]
        prog = TK._describe(instrs, tops, tx, prods, plan)
        assert (prog.tile, prog.halo_l, prog.halo_r, prog.n_pass) == \
            (128, 5, 3, 4)
        assert list(prog.pass_end)[:4] == [1, 4, 5, 9]
        assert prog.lead_mask == 0b1110           # passes 1-3 lead


class TestActivateStepped:
    """``cpm_activate_lanes``' stepped form (the modulo once a 16-lane
    run) against the JAX kernel in interpret mode."""

    @pytest.mark.parametrize("carry", [1, 2, 3, 7, 1000, 0, -4])
    @pytest.mark.parametrize("start,end", [
        (0, 99), (-5, 120), (17, 63), (40, 39), (100, 200), (-30, -1),
        (-2 ** 31, 2 ** 31 - 1), (-2 ** 31 + 3, 90), (2 ** 31 - 1,
                                                      2 ** 31 - 1)])
    def test_matches_jax(self, jk, carry, start, end):
        n = 100
        got = TK.activate_stepped_plain(n, start, end, carry)
        want = np.asarray(jk.activate(n, start, end, carry,
                                      interpret=True)).reshape(-1)
        np.testing.assert_array_equal(got.numpy(), want.astype(bool))
        assert torch.equal(got, TK.activate_plain(n, start, end, carry))

    @pytest.mark.parametrize("n", [1, 15, 16, 33, 1000])
    def test_ragged_lengths(self, n):
        for carry in (1, 3, 1000):
            assert torch.equal(TK.activate_stepped_plain(n, 2, n - 3, carry),
                               TK.activate_plain(n, 2, n - 3, carry))
