"""The flash attention CUDA kernel at head dim 256 against its plain twin
on the card (recurrentgemma-9b's shape: 16 q heads over one kv head,
causal, windows of 2,048 and 100, bf16 and float32, on the main path's
strided (B, S, H, D) views and on packed tensors).  Every test here is
``cuda``-marked and skips without a card.

Tolerances: float32 1e-4, bfloat16 2e-2 (``chip_smoke.py``'s phase 2):
the kernel's products run in another order than the twin's (bf16 on the
tensor cores with float32 accumulation and P split into two bf16
halves; float32 on the FP32 pipes).  In bf16 each output row must also
lie within 2^-6 of its largest |value| (two roundings of float32 values
~1e-6 apart are at most one bf16 ulp, 2^-7 of it, apart), a gate that
the twin with the window one key wider or narrower fails.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import flash_attention as TFA  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ROW_TOL = 2.0 ** -6


def _assert_agrees(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    if dtype is torch.bfloat16:
        g, w = got.float(), want.float()
        row = ((g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30))
        assert float(row.max()) <= ROW_TOL, float(row.max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _make(dev, layout, b, h, kvh, s, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for n in (h, kvh, kvh):
        if layout == "strided":
            t = torch.randn((b, s, n, 256), generator=g, device=dev)
            out.append(t.to(dtype).transpose(1, 2))
        else:
            t = torch.randn((b, n, s, 256), generator=g, device=dev)
            out.append(t.to(dtype))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 2048),
                                           (True, 100), (False, 300)])
def test_kernel_matches_twin_at_recurrentgemma_shape(cuda_device, layout,
                                                     dtype, causal, window):
    q, k, v = _make(cuda_device, layout, 2, 16, 1, 2304, dtype, 7)
    before = TFA.flash_attention.launches
    got = TFA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert TFA.flash_attention.launches == before + 1
    want = TFA.flash_attention_plain(q, k, v, causal=causal, window=window)
    _assert_agrees(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [2048, 100])
@pytest.mark.parametrize("shift", [-1, 1])
def test_gate_catches_a_one_key_window_shift(cuda_device, layout, dtype,
                                             window, shift):
    """The kernel's output fails the gate against the twin whose window is
    one key off: at window 2,048 only rows 2,048-2,303 differ."""
    q, k, v = _make(cuda_device, layout, 2, 16, 1, 2304, dtype, 7)
    got = TFA.flash_attention(q, k, v, causal=True, window=window)
    off = TFA.flash_attention_plain(q, k, v, causal=True,
                                    window=window + shift)
    with pytest.raises(AssertionError):
        _assert_agrees(got, off, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kvh,s,window", [(1, 2, 1, 64, None),
                                              (1, 4, 2, 200, 33),
                                              (2, 2, 2, 130, 50),
                                              (1, 16, 1, 384, 128)])
def test_kernel_matches_twin_across_shapes(cuda_device, dtype, b, h, kvh, s,
                                           window):
    """Ragged S (not a multiple of the 64-row tile), GQA groups 1 to 16."""
    q, k, v = _make(cuda_device, "contiguous", b, h, kvh, s, dtype, s)
    got = TFA.flash_attention(q, k, v, causal=True, window=window,
                              block_q=s, block_k=s)
    torch.cuda.synchronize()
    want = TFA.flash_attention_plain(q, k, v, causal=True, window=window,
                                     block_q=s, block_k=s)
    _assert_agrees(got, want, dtype)
