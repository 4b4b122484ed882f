"""The index arithmetic of the tiled ``shift_range`` and ``stencil``
kernels (``csrc/shift_range.cu``, ``csrc/stencil.cu``), held here on the
CPU where the kernels cannot run.

``shift_range``: the modulo-free lane rule ``shift_src_plain`` (the
``cpm_shift_src`` of ``csrc/cpm_ops.cuh``) against ``_shift_vals``'s
source rule over an edge grid of bounds and shifts, and against the
modulo form on rows of 2^30 + 3 lanes; the per-block cases of
``shift_tile_cases`` applied tile by tile, and a byte-level model of the
kernel's blocks (aligned 16-byte vectors, the staged funnel shift, the
head and tail lanes of misaligned rows), against ``shift_range_plain``.

``stencil``: ``stencil_tiled_plain`` (the kernel's tile + halo schedule)
bit for bit with ``stencil_plain`` for every kernel dtype, both wraps and
1 to 63 taps, with JAX's ``_stencil_vals`` op by op, and near the Pallas
kernel in interpret mode (1e-5 at 3 and 5 taps, the rounding bound of
two summations at 63); ``stencil_lane_plain`` against the
floor modulo; and the kernel's staging plan (16-byte chunks, the
lane-by-lane rest, shared-memory slots) covering each position once.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference
    import jax.numpy as jnp

    from repro.kernels import cpm_kernels as JK
except ImportError:
    jnp = None

from repro_torch.kernels import cpm_kernels as TK  # noqa: E402

I32_MAX = 2 ** 31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    """Same shape, dtype and bits."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.contiguous().view(torch.uint8),
                       want.contiguous().view(torch.uint8))


def _modulo_src(i, n, start, end, shift, has_fill):
    """The lane rule as it was written with the floor modulo (Python
    ints): the roll source where the moved range lands in the row."""
    j = (i - shift) % n
    dst = start <= j <= end
    if shift > 0:
        dst = dst and i >= shift
    elif shift < 0:
        dst = dst and i < n + shift
    if dst:
        return j
    return -1 if has_fill and start <= i <= end else i


# ---------------------------------------------------------------------------
# shift_range: the lane rule
# ---------------------------------------------------------------------------

def _edge_values(n):
    return sorted({-I32_MAX - 1, -n - 5, -1, 0, 1, n // 2, n - 1, n, n + 3,
                   I32_MAX})


def _edge_shifts(n):
    return sorted({0, 1, -1, n - 1, 1 - n, n, -n, n + 5, -n - 5, I32_MAX,
                   -I32_MAX})


class TestShiftSrc:
    @pytest.mark.parametrize("has_fill", [False, True])
    @pytest.mark.parametrize("n", [1, 2, 7, 31, 1000])
    def test_equals_shift_vals_source_rule(self, n, has_fill):
        """Over every lane and the edge grid (start > end, start < 0,
        end >= n, shifts 0, +-1, +-(n-1), +-n, +-(n+5), +-(2^31-1)):
        ``_shift_vals`` moving the lane numbers gives each lane's source
        (the fill -1 marks a vacated lane)."""
        i = torch.arange(n, dtype=torch.int64)
        idx = i.to(torch.int32)[None, :]
        lanes = i[None, :]
        fill = torch.tensor(-1, dtype=torch.int64) if has_fill else None
        for start in _edge_values(n):
            for end in _edge_values(n):
                for shift in _edge_shifts(n):
                    want = TK._shift_vals(lanes, idx, start, end, shift, n,
                                          fill)[0]
                    got = TK.shift_src_plain(i, n, start, end, shift,
                                             has_fill)
                    assert torch.equal(got, want), (start, end, shift)

    @pytest.mark.parametrize("has_fill", [False, True])
    def test_rows_of_2_to_the_30_lanes(self, has_fill):
        """n = 2^30 + 3, where i - shift leaves int32 for shifts near
        +-n: sampled lanes against the modulo form, index tensors only."""
        n = 2 ** 30 + 3
        lanes = [0, 1, 2, 5, n // 3, n // 2, n - 6, n - 2, n - 1]
        i = torch.tensor(lanes, dtype=torch.int64)
        for start in (-5, 0, 3, n // 2, n - 2, n - 1, n + 1, I32_MAX):
            for end in (-1, 0, 4, n // 2 + 7, n - 1, n + 9, I32_MAX):
                for shift in _edge_shifts(n) + [2 ** 30, -2 ** 30, n // 2]:
                    got = TK.shift_src_plain(i, n, start, end, shift,
                                             has_fill).tolist()
                    want = [_modulo_src(k, n, start, end, shift, has_fill)
                            for k in lanes]
                    assert got == want, (start, end, shift)

    def test_per_row_bounds_broadcast(self):
        n = 50
        i = torch.arange(n, dtype=torch.int64)[None, :]
        lo = torch.tensor([[0], [7], [49], [-4]])
        hi = torch.tensor([[49], [6], [60], [20]])
        got = TK.shift_src_plain(i, n, lo, hi, -3, True)
        for r in range(4):
            want = [_modulo_src(k, n, int(lo[r]), int(hi[r]), -3, True)
                    for k in range(n)]
            assert got[r].tolist() == want


# ---------------------------------------------------------------------------
# shift_range: the tiles and the kernel's blocks
# ---------------------------------------------------------------------------

def _move_cases(n, tile):
    """(start, end, shift, fill) cases around tile edges, row ends and the
    fill, plus shifts that are whole 16-byte vectors."""
    return [(0, n - 1, 1, None), (n // 4, n // 2, 1, None),
            (n // 4, n // 2, -3, 1), (tile - 5, 2 * tile + 3, 5, 0),
            (tile, n - 1, -tile, None), (-9, n + 9, n, None),
            (1, n, 0, 1), (0, n - 1, -n - 3, 1), (5, 2, 2, 0),
            (3, n - 4, 16, -1), (3, n - 4, -8, None),
            (7, n - 1, I32_MAX, 1), (0, n - 1, -I32_MAX, None),
            (tile - 1, tile, 1, 2), (n - 1, n - 1, -(n - 1), None)]


def _rows(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-100, 100, shape).astype(dtype)


def _per_row(case, r, n):
    start, end, shift, fill = case
    lo = np.array([start, start + 3, -4][:r], dtype=np.int64)
    hi = np.array([end, end - 2, n + 1][:r], dtype=np.int64)
    return lo, hi, shift, fill


def _apply_cases(x, lo, hi, shift, fill, tile, head_of):
    """Each row through shift_tile_cases, each case applied as the kernel
    applies it: (a) a copy, (b) x[i - shift], (c) the lane rule."""
    r, n = x.shape
    s = max(-n, min(shift, n))
    out = torch.empty_like(x)
    seen = torch.zeros((r, n), dtype=torch.int64)
    f = None if fill is None else TK._shift_fill(x, fill)[0]
    for row in range(r):
        start, end = int(lo[row]), int(hi[row])
        for a, b, case in TK.shift_tile_cases(n, start, end, shift, tile,
                                              head_of(row), fill is not None):
            seen[row, a:b] += 1
            if case == "a":
                out[row, a:b] = x[row, a:b]
            elif case == "b":
                out[row, a:b] = x[row, a - s:b - s]
            else:
                src = TK.shift_src_plain(torch.arange(a, b), n, start, end,
                                         shift, fill is not None)
                moved = x[row, src.clamp(min=0)]
                out[row, a:b] = moved if f is None else \
                    torch.where(src < 0, f, moved)
    assert torch.equal(seen, torch.ones_like(seen)), "tiles overlap or miss"
    return out


class TestShiftTiles:
    @pytest.mark.parametrize("tile", [64, 100, None])
    @pytest.mark.parametrize("dtype,n", [(np.int8, 1000), (np.int32, 3001),
                                         (np.int16, 257), (np.int64, 1)])
    @pytest.mark.parametrize("per_row", [False, True])
    def test_cases_reproduce_plain(self, dtype, n, tile, per_row):
        x = _t(_rows((3, n), dtype, n))
        isz = x.element_size()
        tile = tile or TK.SHIFT_TILE_BYTES // isz
        for case in _move_cases(n, tile):
            lo, hi, shift, fill = _per_row(case, 3, n) if per_row else \
                (np.full(3, case[0]), np.full(3, case[1]), *case[2:])
            want = TK.shift_range_plain(
                x, _t(lo.astype(np.int32)) if per_row else int(lo[0]),
                _t(hi.astype(np.int32)) if per_row else int(hi[0]),
                shift, fill)
            got = _apply_cases(x, lo, hi, shift, fill, tile,
                               lambda row: (-row * n * isz) % 16 // isz)
            _same(got, want)

    def test_case_rule(self):
        """A tile inside the moved range is (b), one off both ranges (a),
        one across an edge (c); |shift| >= n lands nothing."""
        n, t = 1000, 100
        cases = {lo: c for lo, _, c in
                 TK.shift_tile_cases(n, 250, 499, 1, t)}
        assert cases[0] == "a" and cases[300] == "b" and cases[200] == "c"
        assert cases[500] == "c" and cases[600] == "a"
        assert {c for *_, c in TK.shift_tile_cases(n, 0, n - 1, n + 5, t)} \
            == {"a"}
        assert {c for *_, c in TK.shift_tile_cases(n, 0, n - 1, -n, t,
                                                   has_fill=True)} == {"c"}
        # the fill range alone makes a tile lane by lane
        cases = {lo: c for lo, _, c in
                 TK.shift_tile_cases(n, 250, 499, 300, t, has_fill=True)}
        assert cases[300] == "c" and cases[600] == "b"
        tiles = TK.shift_tile_cases(n, 0, n - 1, 1, t, head=3)
        assert tiles[0][:2] == (0, 103) and tiles[-1][1] == n


def _funnel(words, boff):
    """bytes_at of csrc/shift_range.cu on every output vector at once:
    words (J + 1, 4) uint32 of the stage; vector j is the 16 bytes at
    byte boff of stage chunks j and j + 1, word by word a funnel shift."""
    w = np.concatenate([words[:-1], words[1:]], axis=1).astype(np.uint64)
    o, sh = boff >> 2, np.uint64((boff & 3) * 8)
    cols = [((w[:, o + m + 1] << np.uint64(32)) | w[:, o + m]) >> sh
            for m in range(4)]
    return (np.stack(cols, axis=1) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _kernel_model(x, lo, hi, shift, fill, x_off):
    """shift_range.cu's blocks byte for byte, on rows whose x lies
    ``x_off`` bytes past a 16-byte boundary (the output at one): the tile
    cases, then offset_copy's head and tail lanes, its direct vectors or
    its staged chunks and funnel shift.  Asserts the kernel's alignment
    claims and that no source lane outside the row is read."""
    r, n = x.shape
    isz = x.itemsize
    V, T = 16 // isz, TK.SHIFT_TILE_BYTES // isz
    s = max(-n, min(shift, n))
    xv = x.view(np.uint8).reshape(r, n * isz)
    f = None if fill is None else \
        TK._shift_fill(_t(x), fill).numpy().view(np.uint8)
    out = np.zeros((r, n * isz), np.uint8)
    for row in range(r):
        xa, oa = x_off + row * n * isz, row * n * isz
        head = (-oa) % 16 // isz
        start, end = int(lo[row]), int(hi[row])

        def lanes(a, b, d):
            assert 0 <= a - d and b - d <= n
            out[row, a * isz:b * isz] = xv[row, (a - d) * isz:(b - d) * isz]

        for t_lo, t_hi, case in TK.shift_tile_cases(
                n, start, end, shift, T, head, fill is not None):
            if case == "c":
                for i in range(t_lo, t_hi):
                    src = _modulo_src(i, n, start, end, shift,
                                      fill is not None)
                    out[row, i * isz:(i + 1) * isz] = f if src < 0 else \
                        xv[row, src * isz:(src + 1) * isz]
                continue
            d = s if case == "b" else 0
            a = min(head, t_hi) if t_lo == 0 else t_lo
            J = (t_hi - a) // V
            e = a + J * V
            assert a - t_lo < V and t_hi - e < V       # head / tail threads
            lanes(t_lo, a, d)
            lanes(e, t_hi, d)
            if J <= 0:
                continue
            assert (oa + a * isz) % 16 == 0 and J <= TK.SHIFT_TILE_BYTES // 16
            p = a - d
            off = (xa + p * isz) % 16 // isz
            if off == 0:
                lanes(a, e, d)
                continue
            p0 = p - off
            stage = np.full(((J + 1) * 16,), 0xEE, np.uint8)
            for k in range(1, J):                   # whole aligned chunks
                assert (xa + (p0 + k * V) * isz) % 16 == 0
                assert p <= p0 + k * V and p0 + (k + 1) * V <= p + J * V
                stage[k * 16:(k + 1) * 16] = \
                    xv[row, (p0 + k * V) * isz:(p0 + (k + 1) * V) * isz]
            for t in range(V):                      # the partial chunks
                q = p0 + t if t >= off else p0 + J * V + t
                assert p <= q < p + J * V <= n
                k = t if t >= off else J * V + t
                stage[k * isz:(k + 1) * isz] = xv[row, q * isz:(q + 1) * isz]
            vec = _funnel(stage.view(np.uint32).reshape(J + 1, 4), off * isz)
            out[row, a * isz:e * isz] = vec.view(np.uint8).reshape(-1)
    return out.view(x.dtype).reshape(r, n)


class TestShiftKernelModel:
    @pytest.mark.parametrize("x_off", [0, 1, 2])     # in elements
    @pytest.mark.parametrize("dtype,n", [
        (np.int8, 1000), (np.int8, 2 * 16384 + 1003), (np.int16, 8195),
        (np.int32, 3001), (np.int32, 3 * 4096 + 7), (np.int64, 2051),
        (np.uint8, 31), (np.float32, 4096)])
    def test_blocks_reproduce_plain(self, dtype, n, x_off):
        """Scalar and per-row bounds, misaligned rows and sources: every
        byte equals ``shift_range_plain``, every source lane in the
        row."""
        x = _rows((3, n), dtype, n + x_off)
        isz = x.itemsize
        T = TK.SHIFT_TILE_BYTES // isz
        for per_row in (False, True):
            for case in _move_cases(n, T):
                lo, hi, shift, fill = _per_row(case, 3, n) if per_row else \
                    (np.full(3, case[0]), np.full(3, case[1]), *case[2:])
                want = TK.shift_range_plain(
                    _t(x), _t(lo.astype(np.int32)) if per_row
                    else int(lo[0]), _t(hi.astype(np.int32)) if per_row
                    else int(hi[0]), shift, fill)
                got = _kernel_model(x, lo, hi, shift, fill, x_off * isz)
                _same(_t(got), want)


# ---------------------------------------------------------------------------
# stencil: the tiled schedule
# ---------------------------------------------------------------------------

_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
           torch.float16, torch.bfloat16, torch.float32]
_TAPS = {"1": (3.0,), "3": (0.25, 0.0, -1.5),
         "5": (0.5, 0.0, 1.0, 0.0, -0.25),
         "63": tuple(0.0 if k % 5 == 2 else float(np.float32(
             np.sin(k + 1.0))) for k in range(63))}
_T = TK.STENCIL_TILE
_NS = [1, 2, 31, _T - 1, _T, _T + 1, 3 * _T + 7]


def _stencil_rows(dtype, n, seed, r=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, n)).astype(np.float32) * 40
    x.reshape(-1)[::7] = 0
    t = _t(x)
    if dtype == torch.bool:
        return t > 0
    return t.to(dtype) if dtype.is_floating_point else t.round().to(dtype)


class TestStencilTiles:
    @pytest.mark.parametrize("taps", sorted(_TAPS))
    @pytest.mark.parametrize("wrap", [True, False])
    @pytest.mark.parametrize("dtype", _DTYPES, ids=str)
    def test_tiled_equals_plain(self, dtype, wrap, taps):
        for n in _NS:
            x = _stencil_rows(dtype, n, seed=n)
            want = TK.stencil_plain(x, _TAPS[taps], wrap)
            got = TK.stencil_tiled_plain(x, _TAPS[taps], wrap)
            _same(got, want)

    @pytest.mark.parametrize("wrap", [True, False])
    @pytest.mark.parametrize("tile", [4, 16, 33])
    def test_small_tiles(self, tile, wrap):
        """Tiles shorter than the halo: every output still reads its
        taps' positions through the staged slots."""
        for taps in _TAPS.values():
            for n in (1, 5, 40, 97):
                x = _stencil_rows(torch.float32, n, seed=tile + n)
                _same(TK.stencil_tiled_plain(x, taps, wrap, tile),
                      TK.stencil_plain(x, taps, wrap))

    @pytest.mark.parametrize("n,taps,wrap", [
        (31, "5", True), (_T + 1, "3", False), (3 * _T + 7, "5", False),
        (40, "63", True), (2, "63", False)])
    def test_against_jax(self, n, taps, wrap):
        """Bit for bit with JAX's ``_stencil_vals`` op by op; against the
        Pallas kernel in interpret mode, whose jit contracts the
        multiply-add into an FMA (ROADMAP Queue 3), within 1e-5 at 3 and
        5 taps, and at 63 taps within the two summations' rounding bound,
        2 * ntaps * 2^-24 * sum_k |w_k x_(i-k)| a lane."""
        if jnp is None:
            pytest.skip("needs JAX, the reference package")
        x = _stencil_rows(torch.float32, n, seed=7)
        w = _TAPS[taps]
        got = TK.stencil_tiled_plain(x, w, wrap)
        xf = jnp.asarray(x.numpy())
        idx = jnp.arange(n, dtype=jnp.int32)[None, :]
        _same(got, _t(np.asarray(JK._stencil_vals(xf, idx, w, wrap, n))))
        interp = np.asarray(JK.stencil(xf, w, wrap=wrap, interpret=True))
        if len(w) <= 5:
            np.testing.assert_allclose(got.numpy(), interp, rtol=1e-5,
                                       atol=1e-5)
        else:
            mag = TK.stencil_plain(x.abs(), [abs(v) for v in w], wrap)
            assert (np.abs(got.numpy() - interp)
                    <= 2 * len(w) * 2.0 ** -24 * mag.numpy()).all()

    @pytest.mark.parametrize("wrap", [True, False])
    def test_lane_rule(self, wrap):
        for n in (1, 2, 3, 31, 64):
            q = torch.arange(-200, 200)
            got = TK.stencil_lane_plain(q, n, wrap).tolist()
            want = [k % n if wrap else (k if 0 <= k < n else -1)
                    for k in q.tolist()]
            assert got == want


def _stencil_stage_plan(n, ntaps, isz, x_off, t0, row):
    """stencil.cu's staging of one block: the slots of its 16-byte chunks
    and of its lane-by-lane positions, with the checks its comments
    claim (aligned chunk loads inside the row, float4 slots, every staged
    position once, inside ST_STAGE)."""
    V, T = 16 // isz, TK.STENCIL_TILE
    c = ntaps // 2
    L = ntaps - 1 - c if ntaps else 0
    base, stop = t0 - L, t0 + T + c
    live = min(t0 + T, n) + c
    xa = x_off + row * n * isz                      # the row's address
    in_lo, in_hi = max(base, 0), min(live, n)
    ax = (16 - (xa + in_lo * isz) % 16) % 16 // isz
    vlo = min(in_lo + ax, in_hi)
    nch = (in_hi - vlo) // V
    vhi = vlo + nch * V
    pad = (4 - (vlo - base) % 4) % 4
    hits = np.zeros(stop - base, np.int64)
    for k in range(nch):
        q = vlo + k * V
        assert (xa + q * isz) % 16 == 0 and 0 <= q and q + V <= n
        assert (pad + q - base) % 4 == 0
        hits[q - base:q - base + V] += 1
    hits[:vlo - base] += 1
    hits[vhi - base:] += 1
    assert (hits == 1).all()
    assert pad + (stop - base) <= T + TK.STENCIL_MAX_TAPS + 4
    # U chunk loads a thread are enough for the chunks
    U = (T + TK.STENCIL_MAX_TAPS) // V // 256 + 1
    assert nch <= 256 * U
    return vlo, vhi


class TestStencilStagePlan:
    @pytest.mark.parametrize("isz", [1, 2, 4])
    @pytest.mark.parametrize("ntaps", [0, 1, 2, 3, 5, 63, 64])
    def test_each_position_staged_once(self, isz, ntaps):
        for n in (1, 31, _T - 1, _T + 1, 3 * _T + 7, 10000):
            for x_off in range(0, 16, isz):
                for row in (0, 1, 5):
                    for t0 in range(0, n, _T):
                        _stencil_stage_plan(n, ntaps, isz, x_off, t0, row)
