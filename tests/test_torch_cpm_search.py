"""The port's §5 substring match — the ``substring_match`` kernel's plain
twin, ``CPMArray.substring_match`` / ``find_all`` on both backends, the
program executor and ``kernels.ops.substring_match`` — against the JAX
package, on seeded NumPy inputs: flags and addresses bit for bit.

The kernel (``csrc/substring_match.cu``) computes the carry chain's
closed form (lane p ends a match iff p >= M-1 and the M lanes ending at
p equal the needle); that form is replayed here in NumPy against the
twin.  The ``cuda``-marked tests hold the CUDA kernel against its twin on
the card and skip here.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference; the GPU machine has no JAX
    import jax.numpy as jnp

    from repro.cpm import cpm_array as jcpm_array
    from repro.cpm.program import CPMProgram as JProgram
    from repro.kernels import cpm_kernels as JK
    from repro.kernels import ops as jops
except ImportError:
    jnp = None

from repro_torch.cpm import backends as B  # noqa: E402
from repro_torch.cpm import cpm_array  # noqa: E402
from repro_torch.cpm.program import CPMProgram  # noqa: E402
from repro_torch.cpm.program.executors import apply_instruction  # noqa
from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


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
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.c_contiguous else a.copy())


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


#: four symbols, as the paper benchmark's T2 rows (benchmarks/run.py:98);
#: the float alphabet holds -0.0 (equal to +0.0) and NaN (equal to nothing)
_ALPHABET = {"float32": [-0.0, 0.0, 1.5, np.nan],
             "float16": [-0.0, 0.0, 1.5, np.nan],
             "int32": [-7, 0, 3, 2 ** 30], "int8": [-128, 0, 3, 127],
             "uint8": [0, 1, 200, 255], "int16": [-300, 0, 3, 300]}
_DTYPES = ["int32", "int8", "uint8", "int16", "bool", "float32", "float16"]


def _hay(shape, dtype, seed):
    idx = np.random.default_rng(seed).integers(0, 4, shape)
    if dtype == "bool":
        return idx % 2 == 1
    return np.asarray(_ALPHABET[dtype], dtype)[idx]


def _needle(hay, m, seed):
    """An ``m``-item needle: a window of the first row (so that it occurs)
    when the row is long enough, else drawn from the alphabet."""
    row = hay.reshape(-1, hay.shape[-1])[0]
    if m <= row.shape[0] and m:
        p = np.random.default_rng(seed).integers(0, row.shape[0] - m + 1)
        return row[p:p + m].copy()
    return _hay((m,), hay.dtype.name, seed + 1)


def _closed_form(hay, needle):
    """The kernel's algorithm in NumPy: lane p ends a match iff p >= M-1
    and the M lanes ending at p equal the needle (== semantics)."""
    r, n = hay.shape
    m = needle.shape[0]
    out = np.zeros((r, n), np.int8)
    for p in range(m - 1, n) if m else ():
        out[:, p] = (hay[:, p - m + 1:p + 1] == needle[None, :]).all(1)
    return out


_SHAPES_M = [((1, 1), 1), ((1, 7), 8), ((3, 40), 2), ((2, 130), 3),
             ((4, 1030), 8)]


class TestTwinAgainstPallas:
    @pytest.mark.parametrize("dtype", _DTYPES)
    @pytest.mark.parametrize("shape,m", _SHAPES_M)
    def test_substring_match(self, shape, m, dtype):
        """The twin's int8 flags equal the TPU kernel's (interpret mode)
        and the kernel's closed form, bit for bit."""
        hay = _hay(shape, dtype, seed=shape[1] + m)
        nee = _needle(hay, m, seed=m)
        want = JK.substring_match(jnp.asarray(hay), jnp.asarray(nee),
                                  interpret=True)
        got = TK.substring_match_plain(_t(hay), _t(nee))
        _same(got, want)
        _same(got, _closed_form(hay, nee))
        nan = nee.dtype.kind == "f" and np.isnan(nee).any()
        if m <= shape[1] and not nan:
            assert got[0].any()                 # the needle occurs

    @pytest.mark.parametrize("m", [0, 1, 2, 5, 12, 13, 20])
    def test_closed_form_edges(self, m):
        """Needles of no item (no step: all zeros), of the row's length
        and longer; NaN needles match nothing, -0.0 matches +0.0."""
        for dtype in ("int32", "float32"):
            hay = _hay((3, 12), dtype, seed=m)
            nee = _hay((m,), dtype, seed=m + 7)
            _same(TK.substring_match_plain(_t(hay), _t(nee)),
                  _closed_form(hay, nee))
        hay = np.float32([[0.0, -0.0, np.nan, 0.0, 1.5]])
        for nee, want in (([-0.0, 0.0], [0, 1, 0, 0, 0]),
                          ([np.nan], [0, 0, 0, 0, 0]),
                          ([0.0, 1.5], [0, 0, 0, 0, 1])):
            got = TK.substring_match_plain(_t(hay), _t(np.float32(nee)))
            _same(got, np.int8([want]))

    def test_needle_of_another_dtype_promotes(self):
        """An int row against a float needle compares in float32, as the
        twin's == (and the TPU kernel's) does: 2.5 matches nothing."""
        hay = np.int32([[1, 2, 3, 2, 3]])
        for nee in (np.float32([2.0, 3.0]), np.float32([2.5])):
            want = JK.substring_match(jnp.asarray(hay), jnp.asarray(nee),
                                      interpret=True)
            _same(TK.substring_match_plain(_t(hay), _t(nee)), want)

    def test_wrapper_runs_the_twin_on_cpu_uncounted(self):
        hay = _t(_hay((3, 40), "int32", seed=3))
        nee = hay[1, 4:7].clone()
        ops.reset_launch_counts()
        got = TK.substring_match(hay, nee)
        assert torch.equal(got, TK.substring_match_plain(hay, nee))
        assert torch.equal(ops.substring_match(hay, nee, impl="kernel"),
                           got)
        assert ops.launch_counts()["substring_match"] == 0
        assert "substring_match" in ops.KERNELS

    def test_ops_match_jax_ops(self):
        hay = _hay((3, 40), "int32", seed=4)
        nee = hay[2, 10:13].copy()
        _same(ops.substring_match(_t(hay), _t(nee)),
              jops.substring_match(jnp.asarray(hay), jnp.asarray(nee),
                                   impl="ref"))
        _same(ops.substring_match(_t(hay), _t(nee), impl="kernel"),
              jops.substring_match(jnp.asarray(hay), jnp.asarray(nee),
                                   impl="interpret"))


def _pair(x, ul, backend):
    t = cpm_array(_t(x), _t(np.asarray(ul, np.int32)), backend=backend,
                  device="cpu")
    return t, jcpm_array(x, np.asarray(ul, np.int32), backend="reference")


class TestCPMArray:
    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    @pytest.mark.parametrize("dtype", ["int32", "uint8", "bool", "float32"])
    def test_batched_search(self, dtype, backend):
        """``(2, 3, N)`` rows with ragged ``used_len`` (0 and N included):
        start and end flags and ``find_all`` equal JAX's."""
        n = 1100
        x = _hay((2, 3, n), dtype, seed=21)
        ul = [[n, 700, 0], [1, 513, 1024]]
        t, j = _pair(x, ul, backend)
        for m in (1, 3, 8):
            nee = _needle(x, m, seed=m)
            for where in ("start", "end"):
                _same(t.substring_match(nee, where=where),
                      j.substring_match(nee, where=where))
            for a, b in zip(t.find_all(nee, 16), j.find_all(nee, 16)):
                _same(a, b)

    def test_cuda_find_all_runs_the_kernel_twin(self):
        """A forced cuda backend now realizes ``find_all`` (the
        substring_match kernel; its twin on CPU rows), as the JAX
        ``pallas`` backend does."""
        x = _hay((130,), "int32", seed=14)
        cuda = cpm_array(_t(x), 100, backend="cuda", device="cpu")
        j = jcpm_array(x, np.int32(100), backend="pallas", interpret=True)
        for a, b in zip(cuda.find_all(x[5:8], 8), j.find_all(x[5:8], 8)):
            _same(a, b)
        assert B.get_backend("cuda").supports("substring_match")
        assert B.resolve("cuda", "substring_match", _t(x)).name == "cuda"

    @pytest.mark.parametrize("op", ["substring_match", "find_all"])
    def test_program_replay_on_cuda(self, op):
        """The executor replays ``substring_match`` and ``find_all`` on a
        forced cuda backend (no raise) and equals the JAX executor."""
        from repro.cpm.program.executors import \
            apply_instruction as japply

        x = _hay((2, 40), "int32", seed=5)
        ul = np.int32([40, 23])
        nee = x[0, 3:6].copy()
        kw = {"needle": nee} if op == "substring_match" \
            else {"needle": nee, "max_out": 4}
        t = CPMProgram().append(op, **kw).instructions[0]
        j = JProgram().append(op, **kw).instructions[0]
        got = apply_instruction(cpm_array(_t(x), _t(ul), device="cpu"), t,
                                backend="cuda")
        want = japply(jcpm_array(x, ul), j, backend="reference")
        for a, b in zip(got if op == "find_all" else (got,),
                        want if op == "find_all" else (want,)):
            _same(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

_CARD_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16,
                torch.int32, torch.float16, torch.bfloat16, torch.float32]


def _card_hay(dev, r, n, dtype, seed):
    """Four symbols (0, 1, 2 and 3, or NaN for a float 3) of ``dtype``."""
    x = np.random.default_rng(seed).integers(0, 4, (r, n))
    t = _t(x.astype(np.float32)).to(dev)
    if dtype.is_floating_point:
        t = torch.where(t == 3, float("nan"), t)
    return t.to(dtype)


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("m", [0, 1, 2, 8, 32, 1025])
    @pytest.mark.parametrize("r,n", [(1, 1), (3, 1000), (5, 1024),
                                     (2, 4099), (64, 1 << 16)])
    def test_matches_twin(self, cuda_device, r, n, m):
        hay = _card_hay(cuda_device, r, n, torch.int32, seed=n + m)
        nee = hay[0, :m].clone() if m <= n else \
            _card_hay(cuda_device, 1, m, torch.int32, seed=m)[0]
        ops.reset_launch_counts()
        got = TK.substring_match(hay, nee)
        assert ops.launch_counts()["substring_match"] == 1
        assert got.dtype == torch.int8 and got.is_cuda
        assert torch.equal(got.cpu(), TK.substring_match_plain(
            hay.cpu(), nee.cpu()))

    @pytest.mark.parametrize("dtype", _CARD_DTYPES)
    def test_dtypes_nan_and_zeros(self, cuda_device, dtype):
        hay = _card_hay(cuda_device, 3, 5000, dtype, seed=9)
        if dtype.is_floating_point:
            hay[1, 100:104] = torch.tensor([-0.0, 0.0, 1.0, 2.0])
        for m, nee in ((4, hay[1, 100:104].clone()),
                       (3, hay[2, 7:10].clone()),
                       (2, torch.tensor([0.0, 0.0]).to(cuda_device)
                        .to(dtype))):
            got = TK.substring_match(hay, nee)
            assert torch.equal(got.cpu(), TK.substring_match_plain(
                hay.cpu(), nee.cpu())), (dtype, m)

    def test_float_needle_on_int_rows_promotes(self, cuda_device):
        hay = _card(cuda_device, np.int32([[1, 2, 3, 2, 3]]))
        for nee, want in (([2.0, 3.0], [0, 0, 1, 0, 1]),
                          ([2.5], [0, 0, 0, 0, 0])):
            got = TK.substring_match(
                hay, torch.tensor(nee, device=cuda_device))
            assert got.cpu().tolist() == [want]

    def test_repeats_bit_identical(self, cuda_device):
        hay = _card_hay(cuda_device, 64, 1 << 20, torch.int32, seed=3)
        nee = hay[5, 1000:1008].clone()
        assert torch.equal(TK.substring_match(hay, nee),
                           TK.substring_match(hay, nee))

    def test_cpm_array_launches_and_auto(self, cuda_device):
        x = _card_hay(cuda_device, 2, 4096, torch.int32, seed=7)
        nee = x[1, 50:54].clone()
        for backend in ("cuda", "auto"):
            ops.reset_launch_counts()
            arr = cpm_array(x, 4000, backend=backend)
            cpu = cpm_array(x.cpu(), 4000, backend="reference")
            for a, b in zip(arr.find_all(nee, 8), cpu.find_all(nee.cpu(), 8)):
                assert torch.equal(a.cpu(), b)
            assert torch.equal(arr.substring_match(nee, "end").cpu(),
                               cpu.substring_match(nee.cpu(), "end"))
            assert ops.launch_counts()["substring_match"] == 2
        ops.reset_launch_counts()
        cpm_array(x[:, :8].contiguous(), 6).find_all(nee, 4)
        assert not any(ops.launch_counts().values())


def _card(dev, x):
    return _t(x).to(dev)
