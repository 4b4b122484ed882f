"""The odd-even route of the sort kernel (``csrc/oddeven_sort.cu``
``oddeven_tiles``), held here on the CPU where the kernel cannot run.

``oddeven_tiled_plain`` replays the kernel's plan: tiles with halos, warp
segments of 32 threads of ``OE_K`` lanes whose end threads copy the
neighbouring warps' lanes between rounds of ``OE_HALO`` cycles, the pads
beyond the row's ends, the passes, the cycle parity counted over the
call, and the choice of the integer exchange on tiles that no NaN can
reach.  It is held bit for bit against ``oddeven_sort_plain`` (the twin
that defines the function) and against JAX's ``oddeven_sort`` in
interpret mode (NaN by position: XLA's choice between NaN payloads
follows no simple rule; rows with subnormals against the plain twin only,
as the JAX sorts flush them on this CPU), on a small plan's boundary
grid of ``steps``: {0, 1, 2, s - 1, s, s + 1, halo - 1, halo, halo + 1,
2 halo + 1, N - 1, N} with s the round.  Then ``oddeven_plan``: its
invariants over many shapes and its numbers at the card's shapes.
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

#: every storage dtype the kernel takes, as (torch, the JAX dtype's name)
_DTYPES = [(torch.bool, "bool"), (torch.int8, "int8"),
           (torch.uint8, "uint8"), (torch.int16, "int16"),
           (torch.int32, "int32"), (torch.float16, "float16"),
           (torch.bfloat16, "bfloat16"), (torch.float32, "float32")]
_IDS = [name for _, name in _DTYPES]
#: the small plan: one-warp blocks (480 interior lanes a segment), tiles of
#: 400 lanes read with 40 more on either side
_WARPS, _HALO = 1, 40
_S = TK.OE_ROUND                    # cycles a round
_GRID = (0, 1, 2, _S - 1, _S, _S + 1, _HALO - 1, _HALO, _HALO + 1,
         2 * _HALO + 1)
#: the H100's shared memory a block can take
_SMEM = 232448


@pytest.fixture(autouse=True)
def _needs_reference():
    if jnp is None:
        pytest.skip("needs JAX, the reference package")


def _bits(t):
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return t.contiguous().view(view[t.element_size()])


def _same(got, want):
    """Same shape, dtype and bits."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))


def _same_as_jax(got, want):
    """``got`` against a JAX array: the same bits, NaN by position."""
    want = np.asarray(want)
    g = got.float().numpy() if got.dtype in (torch.float16,
                                             torch.bfloat16) \
        else got.numpy()
    w = want.astype(np.float32) if want.dtype.kind == "V" or \
        str(want.dtype) == "bfloat16" else want
    assert g.shape == w.shape
    if g.dtype.kind == "f":
        nan = np.isnan(g)
        np.testing.assert_array_equal(nan, np.isnan(w))
        g, w = np.where(nan, 0, g), np.where(nan, 0, w)
        np.testing.assert_array_equal(np.signbit(g), np.signbit(w))
    np.testing.assert_array_equal(g, w)


def _jax(x, steps):
    """JAX's ``oddeven_sort`` of the torch rows ``x`` in interpret mode."""
    if x.dtype == torch.bfloat16:
        xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    else:
        xj = jnp.asarray(x.numpy())
    return JK.oddeven_sort(xj, steps, interpret=True)


def _rows(shape, tdt, seed):
    """Seeded NumPy rows in ``tdt``: floats with -0.0, +-inf and a NaN
    planted (no subnormals), integers over the type's range."""
    rng = np.random.default_rng(seed)
    if tdt == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
    if not tdt.is_floating_point:
        info = torch.iinfo(tdt)
        lo, hi = max(info.min, -1000), min(info.max, 1000)
        a = rng.integers(lo, hi + 1, shape)
        return torch.from_numpy(a).to(tdt)
    x = (rng.standard_normal(shape) * 50).astype(np.float32)
    flat = x.reshape(-1)
    k = flat.size
    if k >= 8:
        flat[[k // 7, k // 3, k // 5]] = [-0.0, 0.0, np.inf]
        flat[[k // 2, 1]] = [np.nan, -np.inf]
    return torch.from_numpy(x).to(tdt)


def _plan(r, n, steps):
    return TK.oddeven_candidate(n, steps, _WARPS, _HALO)


class TestTiledTwin:
    @pytest.mark.parametrize("steps", [*_GRID, "N-1", "N"])
    @pytest.mark.parametrize("n", [1001, 1000])
    @pytest.mark.parametrize("kind", ["int32", "float32"])
    def test_boundary_grid(self, kind, n, steps):
        """Odd and even N over three tiles of the small plan (several
        passes from ``halo + 1`` cycles on), every ``steps`` of the grid,
        against the plain twin and JAX."""
        steps = {"N-1": n - 1, "N": n}.get(steps, steps)
        x = _rows((3, n), getattr(torch, kind), n + 7)
        plan = _plan(3, n, steps)
        assert plan.tiles == 3 and plan.interior == 400
        got = TK.oddeven_tiled_plain(x, steps, plan)
        _same(got, TK.oddeven_sort_plain(x, steps))
        _same_as_jax(got, _jax(x, steps))

    @pytest.mark.parametrize("n", [1, 2, 17, 37, 300, 511])
    def test_rows_shorter_than_a_segment(self, n):
        """Rows of one tile, shorter than a warp's 512 lanes (odd and
        even, not a multiple of the 16 lanes a thread holds), in the
        plan of the kernel's own choice and in the small one."""
        for kind in ("int32", "float32"):
            x = _rows((2, n), getattr(torch, kind), n)
            for steps in (1, 2, _S + 1, n):
                want = TK.oddeven_sort_plain(x, steps)
                _same(TK.oddeven_tiled_plain(x, steps), want)
                _same(TK.oddeven_tiled_plain(x, steps, _plan(2, n, steps)),
                      want)
                _same_as_jax(want, _jax(x, steps))

    @pytest.mark.parametrize("steps", [_S, _HALO + 1, 2 * _HALO + 1, 1201])
    def test_nan_at_tile_and_segment_borders(self, steps):
        """NaN on and beside tile borders (lanes 400, 800), a tile's halo
        edges and a thread's end lanes, two different NaN payloads that
        meet, +-0, +-inf and subnormals (held against the plain twin; the
        rows without subnormals also against JAX)."""
        n = 1201
        x = _rows((4, n), torch.float32, 3).numpy().copy()
        x[0, [399, 400, 801, 440]] = np.nan
        x[1, [15, 16, 360, 831]] = np.nan
        x[2, 500] = np.float32(np.nan)
        bits = x.view(np.uint32)
        bits[2, 520] = 0x7FC01234                  # another payload
        bits[2, 540] = 0xFFC00001                  # a NaN with the sign set
        x[3, ::7] = np.float32(1e-40)              # subnormals
        x[3, 3::7] = np.float32(-3e-39)
        x[3, 5] = -0.0
        xt = torch.from_numpy(x)
        plan = _plan(4, n, steps)
        got = TK.oddeven_tiled_plain(xt, steps, plan)
        _same(got, TK.oddeven_sort_plain(xt, steps))
        _same_as_jax(got[:3], _jax(xt[:3], steps))

    @pytest.mark.parametrize("tdt,name", _DTYPES, ids=_IDS)
    def test_every_dtype(self, tdt, name):
        n = 1001
        x = _rows((3, n), tdt, 11)
        for steps in (_HALO + 1, 2 * _HALO + 1, n):
            got = TK.oddeven_tiled_plain(x, steps, _plan(3, n, steps))
            _same(got, TK.oddeven_sort_plain(x, steps))
            _same_as_jax(got, _jax(x, steps))

    def test_wider_blocks_and_nan_rows(self):
        """Two-warp blocks (halos refreshed between warps every round),
        the halo larger than a round, and a full sort of a NaN row next to
        a NaN-free one, as the card's full float sorts run them."""
        n = 2000
        x = _rows((2, n), torch.float32, 5)
        x[1] = torch.from_numpy(np.random.default_rng(6).standard_normal(
            n).astype(np.float32))
        for steps in (_S * 3 + 5, 301, n):
            plan = TK.oddeven_candidate(n, steps, 2, 100)
            assert plan.tiles > 1
            got = TK.oddeven_tiled_plain(x, steps, plan)
            _same(got, TK.oddeven_sort_plain(x, steps))
            _same_as_jax(got, _jax(x, steps))

    def test_a_plan_that_outruns_its_halo_is_wrong(self):
        """The halo is what makes a tile exact: one pass of more cycles
        than the halo (a plan the kernel refuses) changes the result, so
        the tests above would see a plan that broke the rule."""
        n = 1001
        x = _rows((3, n), torch.int32, 9)
        bad = TK.OddEvenPlan(_WARPS, 400, _HALO, 3 * _HALO, 1, 3)
        got = TK.oddeven_tiled_plain(x, 3 * _HALO, bad)
        assert not torch.equal(got, TK.oddeven_sort_plain(x, 3 * _HALO))

    def test_the_nan_loop_choice_is_needed(self, monkeypatch):
        """A NaN reaches a tile whose window held none when the pass
        began; the twin chooses the NaN exchange there from the flags
        widened by the cycles already run.  Without the widening (every
        tile on its own window's flags) the result differs."""
        n = 1201
        x = _rows((1, n), torch.float32, 4).numpy().copy()
        x.view(np.uint32)[0, 1120] = 0xFFC00000    # 24 lanes left of the
        x = torch.from_numpy(x)                    # last tile's window
        steps = 3 * _HALO
        want = TK.oddeven_sort_plain(x, steps)
        _same(TK.oddeven_tiled_plain(x, steps, _plan(1, n, steps)), want)
        small = TK.OddEvenPlan(_WARPS, 400, _HALO, _HALO, 3, 4)
        monkeypatch.setattr(TK, "OE_CHUNK", 16)    # flags of 16 lanes
        _same(TK.oddeven_tiled_plain(x, steps, small), want)
        monkeypatch.setattr(TK, "_oe_widen", lambda done: 0)
        assert not torch.equal(_bits(TK.oddeven_tiled_plain(x, steps,
                                                            small)),
                               _bits(want))


class TestPlan:
    @pytest.mark.parametrize("full", [False, True])
    @pytest.mark.parametrize("r,n", [(1, 1), (3, 17), (2, 511), (2, 1000),
                                     (64, 16384), (3, 16385), (2, 70001),
                                     (64, 1 << 20), (1, 200000)])
    def test_invariants(self, r, n, full):
        """Every lane written once a pass (the tiles' interiors cover the
        row, the last one reaching past its end), the halo at least a
        pass's cycles where a row has several tiles, the passes exactly
        the cycles, the block within its shared memory and the grid within
        2^31 blocks."""
        for steps in ([n] if full else
                      sorted({0, 1, 15, 16, 128, 1024, max(n - 1, 0)})):
            if steps > n:
                continue
            p = TK.oddeven_plan(r, n, steps, full=full)
            assert p.warps in TK.OE_WARPS
            assert p.interior + 2 * p.halo <= p.warps * TK.OE_STEP
            assert (p.tiles - 1) * p.interior < n <= p.tiles * p.interior
            if p.tiles > 1:
                assert p.per_pass <= p.halo
            if steps == 0:
                assert p.passes == 1
            else:
                assert (p.passes - 1) * p.per_pass < steps \
                    <= p.passes * p.per_pass
            assert TK.oddeven_smem(p.warps) <= _SMEM
            assert r * p.tiles < 2 ** 31
            lanes = torch.zeros(n + p.interior, dtype=torch.int32)
            for t in range(p.tiles):
                lanes[t * p.interior:(t + 1) * p.interior] += 1
            assert bool((lanes[:n] == 1).all())

    def test_plan_at_the_card_shapes(self):
        """The plans of chip_smoke's odd-even cases: 1,024 cycles of the
        long rows in 32-warp blocks and two passes; 128 cycles of (64,
        16,384) in 640 four-warp blocks, one pass; the full float sort's
        NaN rows spread over 19 tiles a row, 32 passes."""
        P = TK.OddEvenPlan
        assert TK.oddeven_plan(64, 1 << 20, 1024) == P(32, 14336, 512, 512,
                                                       2, 74)
        assert TK.oddeven_plan(64, 16384, 128) == P(4, 1664, 128, 128, 1, 10)
        assert TK.oddeven_plan(64, 16384, 16384, full=True) == P(
            4, 896, 512, 512, 32, 19)
        assert TK.oddeven_smem(32) == 69760 and TK.oddeven_smem(4) == 8832

    def test_shared_memory_of_every_width(self):
        for w in range(1, TK.OE_MAX_WARPS + 1):
            assert TK.oddeven_smem(w) <= _SMEM
        assert TK.OE_STEP == 32 * TK.OE_K - 2 * TK.OE_HALO == 480
        assert TK.OE_ROUND <= TK.OE_HALO
