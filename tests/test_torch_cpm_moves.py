"""The four per-op kernels an eager group replays — ``activate``,
``shift_range``, ``template_match`` and ``stencil`` — and the CPM ops that
reach them, against the JAX package.

Held here on the CPU: each kernel's plain twin against the Pallas kernel
in interpret mode, bit for bit (``stencil`` bit for bit against JAX's
``_stencil_vals`` evaluated op by op, and within 1e-5 of the
interpret-mode kernel, where XLA contracts the multiply-add into an FMA);
``CPMArray``'s moves, ``activate``, ``template_match`` and ``stencil`` on
``backend="cuda"`` (the twins on CPU rows) against JAX ``pallas`` and the
port's ``reference``, batched and ragged rows included; the executor's
forced ``cuda`` replay of every op; and ``CPMBank``'s device rule.  On
the card (``-m cuda``) each kernel against its twin on the same CUDA
tensors, bit for bit, with its launches counted.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference; the GPU machine has no JAX
    import jax.numpy as jnp

    from repro.cpm import CPMProgram as JProgram
    from repro.cpm import cpm_array as jcpm_array
    from repro.cpm.program import apply_instruction as japply
    from repro.kernels import cpm_kernels as JK
except ImportError:
    jnp = None

from repro_torch.cpm import CPMProgram, cpm_array, tuning  # noqa: E402
from repro_torch.cpm.pool import CPMBank  # noqa: E402
from repro_torch.cpm.program import apply_instruction  # noqa: E402
from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _static_tuning(tmp_path_factory):
    """No calibration or tuning at random on CPU rows; any spill in a
    temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_CPM_TUNING_CACHE",
                  str(tmp_path_factory.mktemp("tuning") / "cpm.json"))
        mp.setenv("REPRO_TORCH_CPM_AUTOTUNE", "0")
        mp.setenv("REPRO_TORCH_CPM_CALIBRATE", "0")
        tuning.clear()
        yield
    tuning.clear()


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


def _same(got, want):
    """Same shape, dtype and bits (NaN where NaN)."""
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if g.dtype.kind == "f":
        g, w = g.view(f"u{g.itemsize}"), w.view(f"u{w.itemsize}")
    np.testing.assert_array_equal(g, w)


def _rows(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.dtype(dtype).kind == "f":
        x = (rng.standard_normal(shape) * 4).astype(dtype)
        x.reshape(-1)[::7] = 0                   # exact zeros in SADs
        return x
    return rng.integers(-20, 20, shape).astype(dtype)


# ---------------------------------------------------------------------------
# the twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

class TestTwinsAgainstPallas:
    @pytest.mark.parametrize("n,start,end,carry", [
        (40, 3, 30, 1), (40, 5, 37, 4), (40, -3, 12, 0), (40, 20, 10, 2),
        (17, 0, 16, -3), (1, 0, 0, 1), (64, -2 ** 31, 10, 3),
        (33, 30, 2 ** 31 - 1, 7)])
    def test_activate(self, n, start, end, carry):
        want = JK.activate(n, start, end, carry, interpret=True)
        _same(TK.activate_plain(n, start, end, carry), want)
        _same(TK.activate(n, start, end, carry, device="cpu"),
              want)                                   # CPU: the twin

    @pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.int32,
                                       np.float32, np.float16])
    @pytest.mark.parametrize("start,end,shift", [
        (5, 30, 3), (5, 30, -4), (5, 30, 0), (5, 30, 1), (5, 30, 40),
        (5, 30, -40), (0, 39, 45), (30, 5, 2), (-10, 100, 3),
        (-10, 100, -7), (20, 20, -20)])
    def test_shift_range(self, dtype, start, end, shift):
        x = _rows((3, 40), dtype, seed=shift & 0xff)
        want = JK.shift_range(jnp.asarray(x), start, end, shift,
                              interpret=True)
        _same(TK.shift_range_plain(_t(x), start, end, shift), want)
        fill = {np.bool_: True, np.int8: -1, np.int32: 2.5,
                np.float32: -0.0, np.float16: 1e5}[dtype]
        want = JK.shift_range(jnp.asarray(x), start, end, shift, fill,
                              interpret=True)
        _same(TK.shift_range(_t(x), start, end, shift, fill), want)

    @pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.int32,
                                       np.float32])
    @pytest.mark.parametrize("shift", [3, -4, 0, 45])
    def test_shift_range_per_row_bounds(self, dtype, shift):
        """``(R,)`` per-row bounds move each row as the Pallas kernel
        moves that row with its own scalars (JAX ``vmap``\\ s the kernel),
        in one call; a scalar beside a per-row bound broadcasts."""
        x = _rows((4, 40), dtype, seed=shift & 0xff)
        starts = np.asarray([5, 0, 30, -3], np.int32)
        ends = np.asarray([30, 39, 5, 100], np.int32)
        fill = {np.bool_: True, np.int8: -1, np.int32: 7,
                np.float32: -0.5}[dtype]
        for lo, hi, f in ((starts, ends, None), (starts, ends, fill),
                          (2, ends, fill), (starts, 20, None)):
            want = np.concatenate([np.asarray(JK.shift_range(
                jnp.asarray(x[i:i + 1]), int(np.broadcast_to(lo, 4)[i]),
                int(np.broadcast_to(hi, 4)[i]), shift, f, interpret=True))
                for i in range(4)])
            args = [_t(v) if isinstance(v, np.ndarray) else v
                    for v in (lo, hi)]
            _same(TK.shift_range_plain(_t(x), *args, shift, f), want)
            _same(TK.shift_range(_t(x), *args, shift, f), want)

    def test_shift_range_bounds_shape(self):
        x = _t(np.zeros((3, 8), np.int32))
        with pytest.raises(ValueError, match="per-row bounds"):
            TK.shift_range(x, _t(np.zeros(2, np.int32)), 5, 1)
        with pytest.raises(ValueError, match="per-row bounds"):
            TK.shift_range(x, 0, _t(np.zeros((3, 1), np.int32)), 1)

    @pytest.mark.parametrize("fill", [300, -129, 2 ** 31 - 1])
    def test_shift_fill_casts_as_the_kernel(self, fill):
        """The fill is taken at 32 bits, then cast to the row's dtype
        (an int8 row with 300 gets 44), as the JAX kernel's jit does."""
        x = np.arange(16, dtype=np.int8).reshape(2, 8)
        want = JK.shift_range(jnp.asarray(x), 1, 5, 2, fill,
                              interpret=True)
        _same(TK.shift_range(_t(x), 1, 5, 2, fill), want)

    @pytest.mark.parametrize("m", [1, 2, 5, 16, 33, 64])
    @pytest.mark.parametrize("dtype", [np.int32, np.int8, np.float32,
                                       np.bool_])
    @pytest.mark.parametrize("n", [37, 100])
    def test_template_match(self, m, dtype, n):
        """M from 1 to 64 over rows of 37 and 100 lanes (not multiples of
        32), the tail wrapping — past several row lengths when M > N."""
        x = _rows((2, n), dtype, seed=m + n)
        t = x[0, 3:3 + m].astype(np.float32)     # exact zeros occur
        if t.size < m:
            t = np.resize(t, m)
        for tmpl in (t, t.astype(np.int32)):
            want = JK.template_match(jnp.asarray(x), jnp.asarray(tmpl),
                                     interpret=True)
            _same(TK.template_match_plain(_t(x), _t(tmpl)), want)
            _same(ops.template_match(_t(x), _t(tmpl), impl="kernel"),
                  want)

    @pytest.mark.parametrize("taps", [(1.0, 2.0, 1.0), (0.25, 0.0, -1.5),
                                      (0.5, 0.0, 1.0, 0.0, -0.25),
                                      (0.1, 0.3, 0.7), (3.0,)])
    @pytest.mark.parametrize("wrap", [True, False])
    @pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int8,
                                       np.bool_])
    def test_stencil(self, taps, wrap, dtype):
        """Bit for bit with ``_stencil_vals`` evaluated op by op; within
        1e-5 of the interpret-mode kernel, whose jit contracts the
        multiply-add into an FMA (ROADMAP Queue 3)."""
        x = _rows((3, 45), dtype, seed=len(taps))
        xf = jnp.asarray(x).astype(jnp.float32)
        idx = jnp.arange(45, dtype=jnp.int32)[None, :]
        want = JK._stencil_vals(xf, idx, taps, wrap, 45)
        got = TK.stencil_plain(_t(x), taps, wrap)
        _same(got, want)
        _same(TK.stencil(_t(x), taps, wrap), want)
        interp = JK.stencil(jnp.asarray(x), taps, wrap=wrap, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(interp),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# CPMArray on the cuda backend (twins on CPU rows)
# ---------------------------------------------------------------------------

_N = 48
_DATA = np.random.default_rng(11).integers(0, 9, (_N,)).astype(np.int32)
_FDATA = (_DATA.astype(np.float32) - 4.5) / 2

#: op -> (method, args); moves return devices, the rest values
_OPS = {
    "activate": ("activate", (3, 40, 3)),
    "shift": ("shift", (4, 30, 3)),
    "shift_fill": ("shift", (4, 30, -5, -1)),
    "insert": ("insert", (6, [7, 8, 9])),
    "delete": ("delete", (5, 3, -1)),
    "template": ("template_match", ([1, 2, 3],)),
    "template_raw": ("template_match", ([1.5, 2.0], False)),
    "stencil": ("stencil", ((1.0, 2.0, 1.0),)),
    "stencil_wrap": ("stencil", ((0.5, 0.0, 1.0, 0.0, -0.25), True)),
}


def _result(out):
    if hasattr(out, "used_len"):
        return out.data, out.used_len
    return (out,)


def _arr_args(args, A):
    return tuple(A(a) if isinstance(a, list) else a for a in args)


class TestCPMArray:
    @pytest.mark.parametrize("op", sorted(_OPS))
    @pytest.mark.parametrize("data", ["int", "float"])
    @pytest.mark.parametrize("used", [_N, 37, 0])
    def test_ops_match_jax_pallas_and_reference(self, op, data, used):
        x = _DATA if data == "int" else _FDATA
        method, args = _OPS[op]
        want = getattr(jcpm_array(x, used, backend="pallas"), method)(
            *_arr_args(args, lambda a: jnp.asarray(a, x.dtype)))
        for backend in ("cuda", "reference"):
            dev = cpm_array(_t(x), used, backend=backend, device="cpu")
            got = getattr(dev, method)(
                *_arr_args(args, lambda a: _t(np.asarray(a, x.dtype))))
            for g, w in zip(_result(got), _result(want)):
                _same(g, w)

    @pytest.mark.parametrize("op", ["insert", "delete", "shift",
                                    "shift_fill", "template", "stencil",
                                    "activate"])
    def test_batched_ragged_rows_replay_like_jax(self, op):
        """A (3, N) device with per-row lengths: the executor runs the
        moves in one ``shift_range`` call with per-row bounds on ``cuda``
        and row by row on the reference (JAX vmaps), the others in one
        call; equal to JAX pallas, and to the port's reference."""
        x = np.stack([_DATA, _DATA[::-1], (_DATA * 3) % 7]).astype(np.int32)
        used = np.asarray([_N, 30, 5], np.int32)
        method, args = _OPS[op]
        names = {"activate": ("start", "end", "carry"),
                 "shift": ("start", "end", "shift", "fill"),
                 "insert": ("pos", "values"),
                 "delete": ("pos", "k", "fill"),
                 "template_match": ("template", "mask_tail"),
                 "stencil": ("taps", "wrap")}[method]
        kw = dict(zip(names, args))
        jprog = JProgram().append(method, **{
            k: jnp.asarray(v, np.int32) if isinstance(v, list) else v
            for k, v in kw.items()})
        prog = CPMProgram().append(method, **{
            k: _t(np.asarray(v, np.int32)) if isinstance(v, list) else v
            for k, v in kw.items()})
        want = japply(jcpm_array(x, used, backend="pallas"),
                      jprog.instructions[0], backend="pallas")
        for backend in ("cuda", "reference"):
            got = apply_instruction(
                cpm_array(_t(x), _t(used), backend=backend, device="cpu"),
                prog.instructions[0], backend=backend)
            for g, w in zip(_result(got), _result(want)):
                _same(g, w)


class TestExecutor:
    @pytest.mark.parametrize("op,kw", [
        ("activate", dict(start=2, end=30, carry=2)),
        ("shift", dict(start=2, end=30, shift=2, fill=0)),
        ("insert", dict(pos=3, values=[5, 6])),
        ("delete", dict(pos=3, k=2, fill=0)),
        ("truncate", dict(new_len=9)),
        ("compare", dict(datum=4, op="lt")),
        ("substring_match", dict(needle=[1, 2])),
        ("template_match", dict(template=[1, 2, 3])),
        ("stencil", dict(taps=(1.0, -1.0, 0.5))),
        ("histogram", dict(edges=[0, 3, 6, 9])),
        ("section_sum", {}), ("global_limit", dict(mode="min")),
        ("super_sum", {}), ("super_limit", {}), ("sort", dict(steps=5)),
        ("compact", dict(keep=_DATA % 2 == 0))])
    def test_forced_cuda_replay_of_every_op(self, op, kw):
        """A forced ``cuda`` replay runs every op on its per-op kernel (the
        twins here) and equals the reference replay; none raises."""
        def prog_of(vec):
            return CPMProgram().append(op, **{
                k: vec(v) if isinstance(v, (list, np.ndarray)) else v
                for k, v in kw.items()})

        dev = cpm_array(_t(_DATA), 40, device="cpu")
        instr = prog_of(lambda v: _t(np.asarray(v))).instructions[0]
        got = apply_instruction(dev, instr, backend="cuda")
        want = apply_instruction(dev, instr, backend="reference")
        for g, w in zip(_result(got), _result(want)):
            _same(g, w.numpy())


    @pytest.mark.parametrize("op,kw,calls", [
        ("insert", dict(pos=[3, 0, 5], values=[[5, 6], [7, 8], [9, 1]]), 1),
        ("insert", dict(pos=4, values=[5, 6, 7]), 1),
        ("delete", dict(pos=[3, 1, 2], k=2, fill=[0, -1, 9]), 1),
        ("shift", dict(start=[2, 0, 4], end=[30, 9, 40], shift=-2,
                       fill=-1), 1),
        ("shift", dict(start=2, end=30, shift=3, fill=[1, 2, 3]), 3)])
    def test_batched_moves_are_one_kernel_call(self, op, kw, calls,
                                               monkeypatch):
        """On ``cuda`` a move on a (3, N) device with per-row lengths is
        ONE ``shift_range`` call with ``(R,)`` bounds (a per-row ``shift``
        fill, which the kernel takes as one element, replays rows), equal
        to the reference backend's row replay."""
        seen = []
        inner = TK.shift_range

        def counted(*a, **k):
            seen.append(1)
            return inner(*a, **k)

        monkeypatch.setattr(TK, "shift_range", counted)
        x = np.stack([_DATA, _DATA[::-1], (_DATA * 3) % 7]).astype(np.int32)
        used = _t(np.asarray([_N, 30, 5], np.int32))
        instr = CPMProgram().append(op, **{
            k: _t(np.asarray(v, np.int32)) if isinstance(v, list) else v
            for k, v in kw.items()}).instructions[0]
        got = apply_instruction(
            cpm_array(_t(x), used, backend="cuda", device="cpu"), instr)
        assert len(seen) == calls
        want = apply_instruction(
            cpm_array(_t(x), used, backend="reference", device="cpu"),
            instr)
        for g, w in zip(_result(got), _result(want)):
            _same(g, w.numpy())


class TestActivateDevice:
    def test_activate_without_a_device_goes_to_the_card(self,
                                                         monkeypatch):
        """``activate(n, start, end)`` with Python scalars and no device
        resolves to the card (``repro_torch.resolve_device``) and raises
        without one; tensor scalars keep their device."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no GPU"):
            TK.activate(8, 0, 3)
        want = TK.activate_plain(8, 0, 3, 1)
        _same(TK.activate(8, 0, 3, device="cpu"), want.numpy())
        p = torch.tensor([0, 3, 1], dtype=torch.int32)
        _same(TK.activate(8, p[0], p[1], p[2]), want.numpy())


# ---------------------------------------------------------------------------
# the CPMBank repair: the card unless device="cpu"
# ---------------------------------------------------------------------------

class TestBankDevice:
    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    def test_bank_without_a_device_goes_to_the_card(self, backend,
                                                    monkeypatch):
        """``CPMBank(slots, width)`` with no device resolves to the card
        (``repro_torch.resolve_device``); with no card it raises, where it
        once ran the plain twins on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no GPU"):
            CPMBank(2, 4, backend=backend)
        b = CPMBank(2, 4, backend=backend, device="cpu")
        assert b.data.device.type == b.lens.device.type == "cpu"


# ---------------------------------------------------------------------------
# on the card: each kernel against its twin (run on the H100)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("n", [1, 31, 1000, 70001])
    def test_activate(self, cuda_device, n):
        ops.reset_launch_counts()
        for start, end, carry in ((0, n - 1, 1), (3, n // 2, 4),
                                  (-5, n + 9, 0), (-2 ** 31, 7, 3)):
            p = torch.tensor([start, end, carry], dtype=torch.int32,
                             device=cuda_device)
            got = TK.activate(n, p[0], p[1], p[2], device=cuda_device)
            want = TK.activate_plain(n, p[0], p[1], p[2],
                                     device=cuda_device)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        assert ops.launch_counts()["activate"] == 4

    @pytest.mark.parametrize("dtype", [torch.bool, torch.int8,
                                       torch.float16, torch.bfloat16,
                                       torch.int32, torch.float32,
                                       torch.int64])
    @pytest.mark.parametrize("shape", [(1, 1), (3, 33), (7, 4099)])
    def test_shift_range(self, cuda_device, dtype, shape):
        g = torch.Generator(device=cuda_device).manual_seed(shape[1])
        x = torch.randint(-100, 100, shape, generator=g,
                          device=cuda_device).to(dtype)
        n = shape[1]
        ops.reset_launch_counts()
        cases = [(0, n - 1, 1, None), (n // 4, n // 2, -3, 1),
                 (5, 2, 2, 0), (-9, n + 9, n, None), (1, n, 0, 1),
                 (0, n - 1, -n - 3, 1)]
        for start, end, shift, fill in cases:
            se = torch.tensor([start, end], dtype=torch.int32,
                              device=cuda_device)
            got = TK.shift_range(x, se[0], se[1], shift, fill)
            want = TK.shift_range_plain(x, se[0], se[1], shift, fill)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.uint8),
                               want.view(torch.uint8)), (start, end, shift)
        assert ops.launch_counts()["shift_range"] == len(cases)

    @pytest.mark.parametrize("m", [1, 4, 16, 64, 300, 12000])
    @pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                       torch.int8, torch.bfloat16])
    def test_template_match(self, cuda_device, m, dtype):
        g = torch.Generator(device=cuda_device).manual_seed(m)
        x = torch.randint(-50, 50, (5, 4099), generator=g,
                          device=cuda_device).to(dtype)
        t = x[1, 7:7 + m].float().contiguous() if m <= 4000 else \
            torch.randn(m, generator=g, device=cuda_device)
        got = TK.template_match(x, t)
        want = TK.template_match_plain(x, t)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    def test_template_match_bound(self, cuda_device):
        x = torch.zeros((1, 64), dtype=torch.int32, device=cuda_device)
        t = torch.zeros(TK.TEMPLATE_MAX_M + 1, device=cuda_device)
        with pytest.raises(ValueError, match="at most"):
            TK.template_match(x, t)
        TK.template_match(x, t[:TK.TEMPLATE_MAX_M])   # the largest runs
        torch.cuda.synchronize()

    @pytest.mark.parametrize("taps", [(1.0, 2.0, 1.0), (0.1, 0.3, 0.7),
                                      (0.5, 0.0, 1.0, 0.0, -0.25),
                                      tuple(np.linspace(-1, 1, 63))])
    @pytest.mark.parametrize("wrap", [True, False])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                       torch.float16])
    def test_stencil(self, cuda_device, taps, wrap, dtype):
        g = torch.Generator(device=cuda_device).manual_seed(len(taps))
        x = (torch.randn((6, 1000), generator=g, device=cuda_device)
             * 50).to(dtype)
        got = TK.stencil(x, taps, wrap)
        want = TK.stencil_plain(x, taps, wrap)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        with pytest.raises(ValueError, match="at most"):
            TK.stencil(x, (1.0,) * (TK.STENCIL_MAX_TAPS + 1))

    @pytest.mark.parametrize("dtype", [torch.int8, torch.int32,
                                       torch.float32])
    def test_shift_range_per_row_bounds(self, cuda_device, dtype):
        g = torch.Generator(device=cuda_device).manual_seed(5)
        x = torch.randint(-100, 100, (5, 3001), generator=g,
                          device=cuda_device).to(dtype)
        lo = torch.tensor([0, 7, 2999, -4, 1500], dtype=torch.int32,
                          device=cuda_device)
        hi = torch.tensor([3000, 6, 3005, 100, 2000], dtype=torch.int32,
                          device=cuda_device)
        ops.reset_launch_counts()
        for shift, fill in ((2, None), (-3, -1), (0, 1), (3001, None)):
            got = TK.shift_range(x, lo, hi, shift, fill)
            want = TK.shift_range_plain(x, lo, hi, shift, fill)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.uint8),
                               want.view(torch.uint8)), shift
        assert ops.launch_counts()["shift_range"] == 4

    def test_moves_on_per_row_lengths_launch_once(self, cuda_device):
        """Per-row lengths through the executor, on rows the fused kernel
        cannot hold: each move is one ``shift_range`` launch over all
        rows, equal to the reference backend's row replay."""
        # rows longer than fused_stream holds (29,056 int32 lanes), so the
        # program replays per op
        x = torch.arange(4 * 30000, dtype=torch.int32,
                         device=cuda_device).reshape(4, 30000) % 97
        ul = torch.tensor([30000, 29990, 17, 0], dtype=torch.int32,
                          device=cuda_device)
        prog = (CPMProgram().append("insert", pos=700, values=[7, 8])
                .append("delete", pos=5, k=2, fill=-1))
        ops.reset_launch_counts()
        got = prog.run(cpm_array(x, ul, backend="cuda"))[0]
        torch.cuda.synchronize()
        assert ops.launch_counts()["shift_range"] == 2
        want = prog.run(cpm_array(x, ul, backend="reference"))[0]
        assert torch.equal(got.data, want.data)
        assert torch.equal(got.used_len, want.used_len)

    def test_moves_through_cpm_array_launch_once(self, cuda_device):
        """A batched device with a scalar length: each move is one
        ``shift_range`` launch, and equals the reference backend."""
        x = torch.arange(4 * 3000, dtype=torch.int32,
                         device=cuda_device).reshape(4, 3000) % 97
        dev = cpm_array(x, 2990, backend="cuda")
        ref = cpm_array(x, 2990, backend="reference")
        ops.reset_launch_counts()
        for name, args in (("insert", (700, [7, 8])),
                           ("delete", (700, 2, -1)),
                           ("shift", (700, 1500, -3, -1))):
            got, want = (getattr(d, name)(*args) for d in (dev, ref))
            assert torch.equal(got.data, want.data)
            assert torch.equal(got.used_len, want.used_len)
        assert ops.launch_counts()["shift_range"] == 3
