"""The plans of the redesigned ``histogram`` and ``template_match`` kernels
(``csrc/histogram.cu``, ``csrc/template_match.cu``), held here on the CPU
where the kernels cannot run.

``histogram``: the search form's twin ``histogram_search_plain`` (the
kernel's breadth-first descent, its bins prefix-summed into the same
``(R, parts, E)`` counts, and the unchanged finish) bit for bit with
``histogram_plain`` and with JAX's ``histogram`` in interpret mode, on
ordered edges with duplicates, +-inf and +-0, NaN lanes, every kernel
dtype, fractional edges on int rows and padded rows; its counts equal the
counts form's part by part; the CPU model of the form a block takes
(``histogram_path``); the split plan's cap that keeps the 16-bit counters
from carrying.

``template_match``: ``template_tiled_plain`` (the kernel's tiles, staged
span, one-subtraction wrap and the modulo only for short rows) bit for bit
with ``template_match_plain`` and with JAX's ``template_match`` in
interpret mode, over M in {1, 2, 4, 5, 16, 63, 64}, rows of 1, M - 1 and
about a tile of lanes, every kernel dtype; ``template_src_plain`` against
the floor modulo; the shared-memory plan behind ``TEMPLATE_MAX_M``.
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

#: every storage dtype the kernels take, as (torch, the JAX dtype's name)
_DTYPES = [(torch.bool, "bool"), (torch.int8, "int8"),
           (torch.uint8, "uint8"), (torch.int16, "int16"),
           (torch.int32, "int32"), (torch.float16, "float16"),
           (torch.bfloat16, "bfloat16"), (torch.float32, "float32")]
_IDS = [name for _, name in _DTYPES]
_TILE = TK.TEMPLATE_TILE


def _same(got, want):
    """Same shape, dtype and bits (``want`` may be a JAX array)."""
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.asarray(want).copy())
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.contiguous().view(torch.uint8),
                       want.contiguous().view(torch.uint8))


def _pair(vals: np.ndarray, tdt, jname):
    """The same values as a torch tensor of ``tdt`` and a JAX array of
    ``jname`` (through float32 for the 16-bit floats, exact here)."""
    if tdt == torch.bool:
        return torch.from_numpy(vals != 0), jnp.asarray(vals != 0)
    if tdt in (torch.float16, torch.bfloat16):
        f = vals.astype(np.float32)
        return torch.from_numpy(f).to(tdt), jnp.asarray(f).astype(jname)
    a = vals.astype(np.dtype(jname))
    return torch.from_numpy(a), jnp.asarray(a)


def _values(shape, tdt, seed):
    """Small values every dtype holds exactly (halves for the floats)."""
    rng = np.random.default_rng(seed)
    if tdt == torch.bool:
        return rng.integers(0, 2, shape).astype(np.float32)
    if tdt == torch.uint8:
        return rng.integers(0, 120, shape).astype(np.float32)
    v = rng.integers(-60, 60, shape).astype(np.float32)
    if tdt.is_floating_point:
        v = v + 0.5 * rng.integers(0, 2, shape)
    return v


# ---------------------------------------------------------------------------
# histogram: the search form
# ---------------------------------------------------------------------------

def _edges(case, tdt):
    """(edge values, torch edge dtype, JAX edge dtype name) of a case."""
    if case == "duplicates":
        e = np.array([-40, -10, -10, 0, 0, 7, 30, 30, 30, 55], np.float32)
    elif case == "fractional":
        e = np.array([-40.5, -9.75, 0.25, 0.5, 31.5, 59.5], np.float32)
        return e, torch.float32, "float32"
    elif case == "signed_zero":
        e = np.array([-20, -0.0, 0.0, 0.0, 12], np.float32)
        if not tdt.is_floating_point:
            return np.array([-20, 0, 0, 12], np.float32), torch.int32, \
                "int32"
        return e, torch.float32, "float32"
    elif case == "inf":
        e = np.array([-np.inf, -15, 1, 40, np.inf], np.float32)
        return e, torch.float32, "float32"
    else:
        raise AssertionError(case)
    if tdt == torch.bool:
        e = np.array([0, 0, 1, 1, 2], np.float32)
    elif tdt == torch.uint8:
        e = np.abs(e)
        e.sort()
    return e, torch.int32, "int32"


@pytest.mark.skipif(jnp is None, reason="needs the JAX reference")
class TestHistogramSearch:
    @pytest.mark.parametrize("tdt,jname", _DTYPES, ids=_IDS)
    @pytest.mark.parametrize("case", ["duplicates", "fractional",
                                      "signed_zero", "inf"])
    @pytest.mark.parametrize("shape,section", [((3, 300), 64),
                                               ((2, 1000), 128),
                                               ((1, 1), 1)])
    def test_search_equals_counts_and_pallas(self, tdt, jname, case, shape,
                                             section):
        """The search form = the counts form = the Pallas kernel, bit for
        bit; NaN lanes, -0.0 and +-inf planted in the float rows, and rows
        padded to whole sections."""
        vals = _values(shape, tdt, seed=shape[1] + len(case))
        if tdt.is_floating_point and vals.size > 8:
            vals[0, ::7] = np.nan
            vals[-1, 1], vals[-1, 2], vals[-1, 3] = np.inf, -np.inf, -0.0
        x, jx = _pair(vals, tdt, jname)
        e_vals, edt, ejname = _edges(case, tdt)
        e, je = torch.from_numpy(e_vals).to(edt), \
            jnp.asarray(e_vals.astype(np.dtype(ejname)))
        ct = torch.promote_types(x.dtype, e.dtype)
        assert TK.histogram_path(e.to(ct)) == "search"
        got = TK.histogram_search_plain(x, e, section)
        _same(got, TK.histogram_plain(x, e, section))
        _same(got, JK.histogram(jx, je, section, interpret=True))

    @pytest.mark.parametrize("m", [1, 8, 64, 128])
    @pytest.mark.parametrize("n,section", [(31, 8), (5000, 128),
                                           (70000, 1024)])
    def test_counts_equal_part_by_part(self, m, n, section):
        """The search form's (R, parts, E) scratch equals the counts form's
        under the kernel's plan: C_p(e[j]) of every part."""
        rng = np.random.default_rng(m + n)
        x = torch.from_numpy(rng.normal(0, 30, (2, n)).astype(np.float32))
        x[0, ::11] = float("nan")
        e = torch.from_numpy(np.sort(rng.normal(0, 30, m + 1))
                             .astype(np.float32))
        e[m // 2] = e[max(m // 2 - 1, 0)]             # an empty bin
        parts, part_len = TK.histogram_plan(2, n)
        a = TK.histogram_search_counts_plain(x, e, parts, part_len)
        b = TK.histogram_counts_plain(x, e, parts, part_len)
        assert a.shape == (2, parts, m + 1)
        _same(a, b)
        _same(TK.histogram_finish_plain(a, e, (-n) % section),
              TK.histogram_plain(x, e, section))

    def test_int_extremes(self):
        """Lanes at the int32 ends: the tree's padding nodes hold the
        largest int32, which a lane of that value does not pass."""
        top, low = 2 ** 31 - 1, -2 ** 31
        x = torch.tensor([[low, low + 1, -1, 0, 5, top - 1, top, top]],
                         dtype=torch.int32)
        for e in ([low, 0, top], [low, low, top - 1, top], [0, 5, 5, top]):
            et = torch.tensor(e, dtype=torch.int32)
            want = JK.histogram(jnp.asarray(x.numpy()),
                                jnp.asarray(et.numpy()), 4, interpret=True)
            _same(TK.histogram_search_plain(x, et, 4), want)


class TestHistogramPath:
    @pytest.mark.parametrize("e,path", [
        ([0, 1, 2], "search"), ([0, 0, 0], "search"),
        ([-np.inf, 0, np.inf], "search"), ([0.0, -0.0, 0.0], "search"),
        ([2, 1], "counts"), ([0, 2, 1, 3], "counts"),
        ([3, 2, 1, 0], "counts"), ([0, np.nan, 1], "counts"),
        ([np.nan, 0], "counts"), ([0, 1, np.nan], "counts")])
    def test_form_by_edges(self, e, path):
        """Ordered edges (duplicates, +-inf, +-0 included) take the search;
        shuffled, descending and NaN edges the counts form."""
        dt = torch.float32 if any(isinstance(v, float) for v in e) \
            else torch.int32
        assert TK.histogram_path(torch.tensor(e, dtype=dt)) == path

    def test_form_by_edge_count(self):
        lim = TK.HISTOGRAM_SEARCH_MAX_EDGES
        assert TK.histogram_path(torch.arange(lim)) == "search"
        assert TK.histogram_path(torch.arange(lim + 1)) == "counts"
        assert TK.histogram_path(torch.arange(TK.HISTOGRAM_MAX_EDGES)) == \
            "counts"

    def test_shuffled_edges_take_counts(self):
        rng = np.random.default_rng(4)
        for m in (8, 64, 128):
            e = torch.from_numpy(rng.permutation(m + 1).astype(np.int32))
            assert TK.histogram_path(e) == "counts"
            assert TK.histogram_path(e.sort().values) == \
                ("search" if m + 1 <= TK.HISTOGRAM_SEARCH_MAX_EDGES
                 else "counts")

    def test_search_twin_refuses_unordered(self):
        x = torch.arange(10, dtype=torch.int32)[None]
        for e in ([3, 1, 2], [0.0, float("nan"), 2.0]):
            with pytest.raises(ValueError, match="non-decreasing"):
                TK.histogram_search_plain(x, torch.tensor(e))


class TestHistogramPlan:
    @pytest.mark.parametrize("r,n", [
        (64, 1 << 20), (1, 1), (3, 70000), (264, 1 << 25),
        (1, (1 << 26) + 3), (500, (1 << 24) + 1), (2, 1 << 30),
        (10560, 10 ** 7), (1, 4096 * 5000 + 7)])
    def test_parts_cover_the_row(self, r, n):
        """Every part holds at most HISTOGRAM_MAX_PART lanes, the parts
        cover the row and the last part is not empty (the kernel refuses
        any other split); parts are at least HISTOGRAM_MIN_PART lanes
        unless one part or the cap asks otherwise, and about
        HISTOGRAM_TARGET_BLOCKS of them run over all rows."""
        parts, part_len = TK.histogram_plan(r, n)
        assert 1 <= part_len <= TK.HISTOGRAM_MAX_PART
        assert (parts - 1) * part_len < n <= parts * part_len
        if parts > 1 and part_len < TK.HISTOGRAM_MIN_PART:
            assert parts == -(-n // TK.HISTOGRAM_MAX_PART)
        if part_len < TK.HISTOGRAM_MAX_PART and \
                n >= TK.HISTOGRAM_MIN_PART * 2:
            assert r * parts >= min(TK.HISTOGRAM_TARGET_BLOCKS, r * 2)

    @pytest.mark.parametrize("vec", [4, 8, 16])
    def test_sixteen_bit_counters_never_carry(self, vec):
        """A thread of the 512 counts at most ceil(chunks / 512) 16-byte
        chunks of ``vec`` lanes plus one head and one tail lane of a part:
        below 2^16 at the cap."""
        chunks = TK.HISTOGRAM_MAX_PART // vec
        assert -(-chunks // 512) * vec + 2 < 2 ** 16


# ---------------------------------------------------------------------------
# template_match: the tiled plan
# ---------------------------------------------------------------------------

_MS = [1, 2, 4, 5, 16, 63, 64]


def _ns(m):
    return sorted({1, max(1, m - 1), _TILE - 1, _TILE, _TILE + 1,
                   3 * _TILE + 7})


class TestTemplateTiles:
    @pytest.mark.parametrize("tdt,jname", _DTYPES, ids=_IDS)
    @pytest.mark.parametrize("m", _MS)
    def test_tiled_equals_plain(self, tdt, jname, m):
        """Every row length of the grid, rows shorter than the template
        included, bit for bit with the twin."""
        for n in _ns(m):
            x, _ = _pair(_values((2, n), tdt, seed=m * 7 + n), tdt, jname)
            t = torch.from_numpy(_values((m,), torch.float32, seed=m))
            _same(TK.template_tiled_plain(x, t),
                  TK.template_match_plain(x, t))

    @pytest.mark.skipif(jnp is None, reason="needs the JAX reference")
    @pytest.mark.parametrize("m", _MS)
    def test_tiled_equals_pallas_int32(self, m):
        for n in _ns(m):
            vals = _values((2, n), torch.int32, seed=m + n)
            x, jx = _pair(vals, torch.int32, "int32")
            t = vals[0, :m] if n >= m else np.resize(vals[0], m)
            t = t.astype(np.float32)               # exact zeros occur
            want = JK.template_match(jx, jnp.asarray(t), interpret=True)
            _same(TK.template_tiled_plain(x, torch.from_numpy(t)), want)

    @pytest.mark.skipif(jnp is None, reason="needs the JAX reference")
    @pytest.mark.parametrize("tdt,jname", _DTYPES, ids=_IDS)
    @pytest.mark.parametrize("m", [4, 63])
    def test_tiled_equals_pallas_every_dtype(self, tdt, jname, m):
        for n in (max(1, m - 1), _TILE + 1):
            x, jx = _pair(_values((2, n), tdt, seed=3 * m + n), tdt, jname)
            t = _values((m,), torch.float32, seed=m + 1)
            want = JK.template_match(jx, jnp.asarray(t), interpret=True)
            _same(TK.template_tiled_plain(x, torch.from_numpy(t)), want)

    def test_small_tiles(self):
        """The plan at other tile widths (blocks that end past the row,
        rows of several tiles) gives the same bits."""
        x = torch.from_numpy(_values((3, 37), torch.float32, seed=5))
        t = torch.from_numpy(_values((9,), torch.float32, seed=6))
        for tile in (1, 4, 8, 36, 37, 64):
            _same(TK.template_tiled_plain(x, t, tile),
                  TK.template_match_plain(x, t))

    @pytest.mark.parametrize("n", [1, 3, 100, _TILE + 5])
    def test_src_rule(self, n):
        """One subtraction where the row is at least the span; the floor
        modulo otherwise; positions inside the row read themselves."""
        for m in (1, 64, 5000):
            span = TK.template_span(m)
            for b0 in range(0, n, _TILE):
                q = torch.arange(b0, b0 + span)
                src = TK.template_src_plain(q, n, span)
                assert torch.equal(src, torch.remainder(q, n))
                if n >= span:
                    assert bool((q < 2 * n).all())

    def test_span_and_limit(self):
        """The span covers the last output's last item and the window's
        16-byte read past it; the largest template's span and a chunk fit
        the shared memory, and the limit did not shrink."""
        for m in (0, 1, 3, 4, 5, 64, 2049):
            span = TK.template_span(m)
            assert span % 4 == 0
            # the last thread's window read ends at tile + m + 2
            assert span >= TK.TEMPLATE_TILE + m + 3
        def smem(m):          # tm_smem_floats: span, then a template chunk
            return 4 * (TK.template_span(m)
                        + min((m + 3) & ~3, TK.TEMPLATE_CHUNK))

        assert smem(TK.TEMPLATE_MAX_M) <= TK.MAX_SMEM_BYTES
        assert smem(TK.TEMPLATE_MAX_M + 1) > TK.MAX_SMEM_BYTES
        assert TK.TEMPLATE_MAX_M >= 28928
        assert TK.TEMPLATE_TILE % 4 == 0 and TK.TEMPLATE_CHUNK % 4 == 0
