"""The port's kernels against the JAX package: flash attention and the
fused CPM instruction stream.

The plain PyTorch twins run here on the CPU and are held against the JAX
Pallas kernels in interpret mode (and the JAX references) on the same
inputs, made with NumPy from a seed.  The CUDA kernels themselves are
held against the twins by the ``cuda``-marked tests, which skip without a
card and run on the H100 (see README, "PyTorch/CUDA port").
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference; the GPU machine has no JAX
    import jax
    import jax.numpy as jnp

    from repro.kernels import cpm_kernels as JK
    from repro.kernels import flash_attention as JFA
    from repro.kernels import ref as JREF
except ImportError:
    jax = None

from repro_torch.kernels import _build, cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import ops, ref as TREF  # noqa: E402


@pytest.fixture(autouse=True)
def _needs_reference(request):
    """Tests that compare with JAX skip where JAX is missing (the GPU
    machine, where only the ``cuda``-marked tests are run)."""
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs JAX, the reference package")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(seed, b, h, kvh, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, skv, d)).astype(np.float32)
    return q, k, v


_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# causal / window / GQA cases: (b, h, kvh, s, d, causal, window, bq, bk)
_FLASH_CASES = [
    (1, 4, 4, 32, 16, True, None, 16, 16),
    (2, 4, 2, 32, 16, True, None, 16, 8),
    (1, 4, 1, 48, 32, True, 12, 16, 16),
    (1, 2, 2, 32, 16, False, None, 32, 16),
    (1, 4, 2, 32, 16, False, 9, 8, 16),
]


class TestFlashAttentionPlain:
    """Tolerances: float32 — 2e-5, the summation-order noise of float32
    products over D <= 32 and Skv <= 48; bfloat16 — one bf16 rounding of
    the output (2^-8 relative, so 2e-2 absolute on O(1) values), since
    both sides compute in float32 from the same bf16 inputs."""

    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    @pytest.mark.parametrize("case", _FLASH_CASES)
    def test_matches_jax_interpret_kernel(self, case, dt):
        b, h, kvh, s, d, causal, window, bq, bk = case
        q, k, v = _qkv(sum(case[:5]), b, h, kvh, s, s, d)
        jq, jk, jv = (jnp.asarray(a, getattr(jnp, dt)) for a in (q, k, v))
        want = JFA.flash_attention(jq, jk, jv, causal=causal, window=window,
                                   block_q=bq, block_k=bk, interpret=True)
        tq, tk, tv = (torch.from_numpy(a).to(_TDT[dt]) for a in (q, k, v))
        got = TFA.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window, block_q=bq,
                                        block_k=bk)
        assert got.dtype == _TDT[dt] and got.shape == (b, h, s, d)
        tol = 2e-5 if dt == "float32" else 2e-2
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=tol, atol=tol)

    @pytest.mark.parametrize("case", _FLASH_CASES)
    def test_matches_jax_reference(self, case):
        """At Sq == Skv the reference's end-aligned mask equals the
        kernel's, so all three agree (float32)."""
        b, h, kvh, s, d, causal, window, bq, bk = case
        q, k, v = _qkv(7, b, h, kvh, s, s, d)
        want = JREF.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        window=window, block_k=bk)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = TFA.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window, block_q=bq,
                                        block_k=bk)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5,
                                   atol=2e-5)
        port_ref = TREF.flash_attention_ref(tq, tk, tv, causal=causal,
                                            window=window, block_k=bk)
        np.testing.assert_allclose(port_ref.numpy(), _np(want), rtol=2e-5,
                                   atol=2e-5)

    def test_wrapper_on_cpu_is_the_plain_twin_and_counts_nothing(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 32, 32,
                                                      16))
        ops.reset_launch_counts()
        got = TFA.flash_attention(q, k, v, block_q=16, block_k=16)
        want = TFA.flash_attention_plain(q, k, v, block_q=16, block_k=16)
        assert torch.equal(got, want)
        assert ops.launch_counts()["flash_attention"] == 0

    def test_contract_checks(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 24, 24,
                                                      16))
        with pytest.raises(ValueError):
            TFA.flash_attention(q, k, v, block_q=16)     # 24 % 16 != 0
        with pytest.raises(ValueError):
            TFA.flash_attention(q, k[:, :, :20], v[:, :, :20], block_k=8)
        with pytest.raises(ValueError):
            TFA.flash_attention(q, k[:, :1].expand(1, 3, 24, 16).clone(),
                                v[:, :1].expand(1, 3, 24, 16).clone())

    def test_ops_dispatch_on_cpu_is_the_reference(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 4, 2, 32, 32,
                                                      16))
        got = ops.attention(q, k, v, causal=True)
        assert torch.equal(got, TREF.flash_attention_ref(q, k, v))
        kern = ops.attention(q, k, v, causal=True, impl="kernel")
        assert torch.equal(kern, TFA.flash_attention_plain(q, k, v))


class TestAttentionReferences:
    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    def test_decode_attention_matches_jax(self, dt):
        rng = np.random.default_rng(11)
        q = rng.standard_normal((3, 4, 1, 16)).astype(np.float32)
        k = rng.standard_normal((3, 2, 20, 16)).astype(np.float32)
        v = rng.standard_normal((3, 2, 20, 16)).astype(np.float32)
        lens = np.array([5, 20, 11], np.int32)
        want = JREF.decode_attention_ref(
            *(jnp.asarray(a, getattr(jnp, dt)) for a in (q, k, v)),
            jnp.asarray(lens))
        got = TREF.decode_attention_ref(
            *(torch.from_numpy(a).to(_TDT[dt]) for a in (q, k, v)),
            torch.from_numpy(lens))
        tol = 2e-5 if dt == "float32" else 2e-2
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=tol, atol=tol)

    def test_attention_naive_matches_jax(self):
        q, k, v = _qkv(12, 1, 4, 2, 8, 24, 16)
        want = JREF.attention_naive(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, window=6)
        got = TREF.attention_naive(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   window=6)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# fused_stream
# ---------------------------------------------------------------------------

def _stream(dtype, r, n, per_row, seed):
    """A stream over all nine instruction kinds with int32/float32
    operands, broadcast (1, k) or per-row (r, k)."""
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        x = rng.integers(-4, 5, (r, n)).astype(dtype)
    else:
        x = np.round(rng.standard_normal((r, n)) * 4).astype(dtype) / 2
    ul = rng.integers(n // 3, n + 1, (r,)).astype(np.int32)

    def rows(a):
        a = np.asarray(a)
        return a if per_row else a[:1].copy()

    ct = "float32" if dtype == np.float32 else "int32"
    instrs = (
        ("activate", (), 1),
        ("shift", (("shift", 3), ("has_fill", True)), 2),
        ("compare", (("op", "ge"), ("has_mask", False), ("ct", ct)), 1),
        ("insert", (("k", 3),), 2),
        ("substring_match", (("m", 3), ("where", "start")), 1),
        ("template_match", (("m", 4), ("mask_tail", True)), 1),
        ("delete", (("k", 2),), 2),
        ("compare", (("op", "lt"), ("has_mask", False),
                     ("ct", "float32")), 1),
        ("substring_match", (("m", 2), ("where", "end")), 1),
        ("stencil", (("taps", (0.25, 1.5, 0.0, -0.75, 0.125)),
                     ("wrap", False)), 0),
        ("shift", (("shift", -2), ("has_fill", False)), 1),
        ("stencil", (("taps", (0.5, 1.0, 0.5)), ("wrap", True)), 0),
        ("truncate", (), 1),
        ("template_match", (("m", 3), ("mask_tail", False)), 1),
    )
    operands = [
        rows(np.stack([rng.integers(0, 4, r), rng.integers(n // 2, n, r),
                       rng.integers(1, 4, r)], 1).astype(np.int32)),
        rows(np.stack([rng.integers(0, 5, r), rng.integers(n // 2, n, r)],
                      1).astype(np.int32)),
        rows(np.full((r, 1), -9, dtype)),
        rows(rng.integers(-2, 3, (r, 1)).astype(
            np.float32 if ct == "float32" else np.int32)),
        rows(rng.integers(0, n // 2, (r, 1)).astype(np.int32)),
        rows(rng.integers(-4, 5, (r, 3)).astype(dtype)),
        rows(x[:, 2:5].copy()),
        rows(rng.standard_normal((r, 4)).astype(np.float32)),
        rows(rng.integers(0, n // 2, (r, 1)).astype(np.int32)),
        rows(np.full((r, 1), 7, dtype)),
        rows(np.full((r, 1), 0.5, np.float32)),
        rows(x[:, 6:8].copy()),
        rows(rng.integers(n // 4, n, (r, 2)).astype(np.int32)),
        rows(rng.integers(n // 4, n, (r, 1)).astype(np.int32)),
        rows(rng.integers(-3, 4, (r, 3)).astype(np.int32)),
    ]
    return x, ul, instrs, operands


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _jax_stream(x, ul, instrs, operands, block_r):
    return JK.fused_stream(jnp.asarray(x), jnp.asarray(ul), instrs,
                           tuple(jnp.asarray(o) for o in operands),
                           block_r=block_r, interpret=True)


def _torch_stream(x, ul, instrs, operands, block_r):
    return TK.fused_stream_plain(
        torch.from_numpy(x), torch.from_numpy(ul), instrs,
        tuple(torch.from_numpy(o) for o in operands), block_r=block_r)


class TestFusedStreamPlain:
    """Bit for bit against the JAX kernel in interpret mode.  One
    exception, stated: the float stencil output, where XLA's CPU fusion
    contracts ``acc + w * shifted`` into fused multiply-adds (one rounding
    where the kernel body as written has two).  That output is held bit
    for bit against the JAX body evaluated op by op, and to 1e-5 of the
    interpret-mode kernel (a few float32 roundings of O(10) sums)."""

    @pytest.mark.parametrize("block_r", [1, 3])
    @pytest.mark.parametrize("per_row", [False, True])
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    def test_all_nine_ops_match_jax(self, dtype, per_row, block_r):
        x, ul, instrs, operands = _stream(dtype, 5, 41, per_row,
                                          seed=3 + per_row)
        jx, jul, jp = _jax_stream(x, ul, instrs, operands, block_r)
        tx, tul, tp = _torch_stream(x, ul, instrs, operands, block_r)
        np.testing.assert_array_equal(_bits(jx), _bits(tx.numpy()))
        np.testing.assert_array_equal(np.asarray(jul), tul.numpy())
        prods = [op for op, _, _ in instrs if op in TK.FUSED_PRODUCERS]
        assert len(tp) == len(jp) == len(prods)
        for op, a, b in zip(prods, jp, tp):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, op
            if op == "stencil":
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                           atol=1e-5, err_msg=op)
            else:
                np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                              err_msg=op)

    @pytest.mark.parametrize("wrap", [False, True])
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    def test_stencil_body_bit_identical_op_by_op(self, dtype, wrap):
        rng = np.random.default_rng(9)
        x = (rng.standard_normal((3, 40)) * 3).astype(dtype)
        ul = np.array([[40], [17], [29]], np.int32)
        idx = np.broadcast_to(np.arange(40, dtype=np.int32), (3, 40))
        st = (("taps", (0.3, 1.7, 0.0, -0.55, 0.11)), ("wrap", wrap))
        with jax.disable_jit():
            _, _, want = JK._fused_apply("stencil", st, jnp.asarray(x),
                                         jnp.asarray(ul), [],
                                         jnp.asarray(idx), 40)
        _, _, got = TK._fused_apply("stencil", st, torch.from_numpy(x),
                                    torch.from_numpy(ul), [],
                                    torch.from_numpy(idx.copy()), 40)
        np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))

    def test_block_r_is_bit_identical(self):
        x, ul, instrs, operands = _stream(np.int32, 7, 30, True, seed=5)
        outs = [_torch_stream(x, ul, instrs, operands, br)
                for br in (1, 3, 7, 9)]
        for o in outs[1:]:
            assert torch.equal(o[0], outs[0][0])
            assert torch.equal(o[1], outs[0][1])
            for a, b in zip(o[2], outs[0][2]):
                assert torch.equal(a, b)

    def test_commit_stream_matches_jax(self):
        """The main-path stream: insert(used, preds) -> truncate."""
        rng = np.random.default_rng(1)
        buf = rng.integers(0, 100, (4, 30)).astype(np.int32)
        used = np.array([10, 12, 9, 20], np.int32)
        preds = rng.integers(100, 200, (4, 4)).astype(np.int32)
        emit = np.array([1, 4, 2, 0], np.int32)
        instrs = (("insert", (("k", 4),), 2), ("truncate", (), 1))
        ops_ = [used[:, None].copy(), preds, (used + emit)[:, None].copy()]
        jx, jul, _ = _jax_stream(buf, used, instrs, ops_, 1)
        tx, tul, _ = _torch_stream(buf, used, instrs, ops_, 1)
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
        np.testing.assert_array_equal(np.asarray(jul), tul.numpy())

    def test_wrapper_on_cpu_is_the_plain_twin(self):
        x, ul, instrs, operands = _stream(np.float32, 4, 33, True, seed=8)
        ops.reset_launch_counts()
        a = TK.fused_stream(torch.from_numpy(x), torch.from_numpy(ul),
                            instrs,
                            tuple(torch.from_numpy(o) for o in operands))
        b = _torch_stream(x, ul, instrs, operands, 1)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert ops.launch_counts()["fused_stream"] == 0


def _plan_of(instrs, x):
    """The kernel's plan for the stream ``instrs`` over the rows ``x``."""
    return TK.fused_plan(*x.shape, tuple((op, st) for op, st, _ in instrs))


class TestFusedStreamDescriptor:
    """The by-value kernel descriptor is packed in Python: check it here,
    where the kernel cannot run."""

    def test_packs_opcodes_strides_flags_and_taps(self):
        x, ul, instrs, operands = _stream(np.float32, 5, 41, True, seed=3)
        tx = torch.from_numpy(x)
        tops = tuple(torch.from_numpy(o) for o in operands)
        prods = [torch.empty(5, 41, dtype=TK.FUSED_PRODUCERS[op])
                 for op, _, _ in instrs if op in TK.FUSED_PRODUCERS]
        prog = TK._describe(instrs, tops, tx, prods, _plan_of(instrs, tx))
        assert prog.n_instr == len(instrs) and prog.x_float == 1
        assert [prog.ins[i].op for i in range(len(instrs))] == \
            [TK._OPCODE[op] for op, _, _ in instrs]
        shift = prog.ins[1]
        assert shift.shift == 3 and shift.flags == TK._F_FILL
        assert shift.ostride0 == 2 and shift.ostride1 == 1
        assert shift.o0 == tops[1].data_ptr()
        sten = prog.ins[9]
        assert sten.ntaps == 5 and sten.tap_off == 0
        assert [prog.taps[j] for j in range(5)] == \
            [0.25, 1.5, 0.0, -0.75, 0.125]
        assert prog.ins[11].tap_off == 5 and prog.ins[11].flags == \
            TK._F_WRAP
        assert prog.ins[2].flags == TK._F_CTF
        assert prog.ins[0].out == prods[0].data_ptr()

    def test_broadcast_operands_get_zero_row_stride(self):
        x, ul, instrs, operands = _stream(np.int32, 5, 41, False, seed=3)
        tx = torch.from_numpy(x)
        prog = TK._describe(instrs, tuple(torch.from_numpy(o)
                                          for o in operands), tx,
                            [torch.empty(5, 41, dtype=TK.FUSED_PRODUCERS[op])
                             for op, _, _ in instrs
                             if op in TK.FUSED_PRODUCERS],
                            _plan_of(instrs, tx))
        assert all(prog.ins[i].ostride0 == 0 for i in range(len(instrs))
                   if instrs[i][2])

    def test_rejects_what_the_kernel_does_not_take(self):
        x = torch.zeros(2, 8, dtype=torch.int32)
        bad_dtype = (torch.zeros(2, 1, dtype=torch.int64),)
        trunc = (("truncate", (), 1),)
        with pytest.raises(TypeError):
            TK._describe(trunc, bad_dtype, x, [], _plan_of(trunc, x))
        insert = (("insert", (("k", 3),), 2),)
        with pytest.raises(ValueError):
            TK._describe(insert, (torch.zeros(2, 1, dtype=torch.int32),
                                  torch.zeros(2, 2, dtype=torch.int32)), x,
                         [], _plan_of(insert, x))
        many = trunc * (TK.MAX_INSTR + 1)
        with pytest.raises(ValueError):
            TK._describe(many, (torch.zeros(1, 1, dtype=torch.int32),)
                         * (TK.MAX_INSTR + 1), x, [], _plan_of(many, x))


class TestBuild:
    def test_sources_and_cache_key(self):
        assert _build.sources() == ["activate", "compact", "compare",
                                    "flash_attention", "fused_stream",
                                    "histogram", "oddeven_sort", "reduce",
                                    "rows", "shift_range", "stencil",
                                    "substring_match", "super_reduce",
                                    "template_match"]
        p1 = _build._lib_path("fused_stream")
        assert p1 == _build._lib_path("fused_stream")
        assert p1.parent == _build.build_dir()
        assert p1.parent.parent.parent == _build._CHECKOUT
        assert p1 != _build._lib_path("flash_attention")
        assert "-fmad=false" in _build._flags("fused_stream")
        assert "-fmad=false" in _build._flags("stencil")
        for name in _build.sources():
            assert any("sm_90a" in f for f in _build._flags(name))
        # a shared header is part of every library's key
        assert (_build.CSRC / "cpm_ops.cuh").is_file()

    def test_build_dir_outside_a_checkout(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "_CHECKOUT", tmp_path)
        monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
        with pytest.raises(RuntimeError, match="REPRO_TORCH_BUILD_DIR"):
            _build.build_dir()
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
        assert _build._lib_path("fused_stream").parent == tmp_path / "b"

    def test_missing_nvcc_raises(self, monkeypatch):
        monkeypatch.setattr(_build.shutil, "which", lambda _: None)
        monkeypatch.setattr(_build.Path, "exists", lambda self: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc_path()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
class TestKernelsOnCard:
    """Each CUDA kernel against its plain twin on the same card inputs."""

    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    @pytest.mark.parametrize("case", _FLASH_CASES + [
        (2, 32, 8, 256, 128, True, None, 128, 128),
        (2, 8, 8, 200, 64, True, 33, 200, 200),     # one 200-row q block
        (1, 4, 2, 200, 64, False, None, 40, 50)])
    def test_flash_kernel_matches_plain(self, cuda_device, case, dt):
        b, h, kvh, s, d, causal, window, bq, bk = case
        q, k, v = (torch.from_numpy(a).to(cuda_device, _TDT[dt])
                   for a in _qkv(1, b, h, kvh, s, s, d))
        ops.reset_launch_counts()
        got = TFA.flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 1
        want = TFA.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, block_q=bq,
                                         block_k=bk)
        tol = 2e-5 if dt == "float32" else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)

    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    @pytest.mark.parametrize("case", [
        (2, 32, 8, 256, 128, True, None),
        (1, 4, 2, 48, 16, True, 33)])
    def test_flash_kernel_on_strided_views(self, cuda_device, case, dt):
        """The main path's layout: (B, S, heads, D) projections viewed as
        (B, heads, S, D), so the sequence stride is heads * D."""
        b, h, kvh, s, d, causal, window = case
        rng = np.random.default_rng(3)
        q, k, v = (torch.from_numpy(
            rng.standard_normal((b, s, n, d)).astype(np.float32))
            .to(cuda_device, _TDT[dt]).transpose(1, 2) for n in (h, kvh, kvh))
        assert q.stride(2) == h * d and k.stride(2) == kvh * d
        got = TFA.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = TFA.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        tol = 2e-5 if dt == "float32" else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)

    @pytest.mark.parametrize("d", [16, 32, 64, 128])
    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    def test_flash_kernel_launches_across_shapes(self, cuda_device, dt, d):
        """Every built head dim launches at sequence lengths that are and
        are not multiples of the q tile, Sq != Skv included."""
        for i, (b, h, kvh, sq, skv, causal, window) in enumerate([
                (1, 4, 2, 48, 48, True, None), (1, 4, 2, 48, 48, False, 33),
                (2, 8, 8, 64, 64, True, None), (1, 4, 1, 80, 80, True, 17),
                (1, 8, 2, 256, 256, False, None),
                (1, 4, 2, 64, 128, True, None)]):
            q, k, v = (torch.from_numpy(a).to(cuda_device, _TDT[dt])
                       for a in _qkv(i, b, h, kvh, sq, skv, d))
            got = TFA.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = TFA.flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
            tol = 2e-5 if dt == "float32" else 2e-2
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)

    @pytest.mark.parametrize("layout", ["contiguous", "strided"])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("group", [1, 2, 4, 8])
    def test_wgmma_flash_gqa_groups(self, cuda_device, group, d, layout):
        """The bf16 wgmma + TMA kernel (D 64 and 128) over GQA groups 1, 2,
        4 and 8 (one head a block, or two), causal, windowed and not,
        ragged S = 200, Sq != Skv, on packed tensors and on the main
        path's strided views."""
        kvh = 2
        h = kvh * group
        rng = np.random.default_rng(group * d)
        for b, sq, skv, causal, window in [(2, 256, 256, True, None),
                                           (1, 200, 200, True, 33),
                                           (1, 200, 200, False, None),
                                           (1, 64, 128, True, None),
                                           (1, 130, 130, False, 50)]:
            def make(n, s):
                shape = (b, s, n, d) if layout == "strided" else (b, n, s, d)
                t = torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32)).to(cuda_device, torch.bfloat16)
                return t.transpose(1, 2) if layout == "strided" else t
            q, k, v = make(h, sq), make(kvh, skv), make(kvh, skv)
            got = TFA.flash_attention(q, k, v, causal=causal, window=window,
                                      block_q=sq, block_k=skv)
            torch.cuda.synchronize()
            want = TFA.flash_attention_plain(q, k, v, causal=causal,
                                             window=window, block_q=sq,
                                             block_k=skv)
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)

    def test_wgmma_flash_refuses_what_tma_cannot_load(self, cuda_device):
        """TMA needs 16-byte aligned bases and strides: the wrapper raises,
        naming the rule, and never copies the input."""
        kv = torch.zeros((1, 2, 64, 64), device=cuda_device,
                         dtype=torch.bfloat16)
        flat = torch.zeros(2 * 64 * 64 + 1, device=cuda_device,
                           dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="TMA"):
            TFA.flash_attention(flat[1:].view(1, 2, 64, 64), kv, kv)
        wide = torch.zeros((1, 2, 64, 68), device=cuda_device,
                           dtype=torch.bfloat16)[..., :64]
        with pytest.raises(ValueError, match="TMA"):
            TFA.flash_attention(wide, kv, kv)

    @pytest.mark.parametrize("block_r", [1, 3])
    @pytest.mark.parametrize("per_row", [False, True])
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    def test_fused_stream_kernel_bit_identical(self, cuda_device, dtype,
                                               per_row, block_r):
        x, ul, instrs, operands = _stream(dtype, 7, 300, per_row, seed=2)
        args = (torch.from_numpy(x).to(cuda_device),
                torch.from_numpy(ul).to(cuda_device), instrs,
                tuple(torch.from_numpy(o).to(cuda_device)
                      for o in operands))
        gx, gul, gp = TK.fused_stream(*args, block_r=block_r)
        torch.cuda.synchronize()
        wx, wul, wp = TK.fused_stream_plain(*args, block_r=block_r)
        np.testing.assert_array_equal(_bits(gx.cpu().numpy()),
                                      _bits(wx.cpu().numpy()))
        assert torch.equal(gul, wul)
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(_bits(a.cpu().numpy()),
                                          _bits(b.cpu().numpy()))
