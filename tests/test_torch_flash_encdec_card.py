"""The flash attention CUDA kernel in the encoder-decoder's modes against
its plain twin on the card, at seamless-m4t-large-v2's shapes (16 q
heads over 16 kv heads, head dim 64, the bf16 wgmma + TMA route and the
float32 kernel): the encoder's bidirectional self-attention (Sq = Skv =
1,024 source frames), the decoder's cross attention (Sq = 64 prompt
positions over Skv = 1,024 frames), on the main path's strided
(B, S, H, D) views and on packed tensors, and ragged lengths that are no
multiple of a tile (one block over all of Sq and of Skv).  Every test
here is ``cuda``-marked and skips without a card.

Tolerances: float32 1e-4, bfloat16 2e-2 (``chip_smoke.py``'s phase 2),
and in bf16 each output row within 2^-6 of its largest |value|, as
``tests/test_torch_flash256_card.py``.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import flash_attention as TFA  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ROW_TOL = 2.0 ** -6
B, H, KVH, D = 4, 16, 16, 64


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


def _make(dev, layout, b, heads, s, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "strided":
        t = torch.randn((b, s, heads, D), generator=g, device=dev)
        return t.to(dtype).transpose(1, 2)
    return torch.randn((b, heads, s, D), generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,skv", [(1024, 1024), (64, 1024)])
def test_kernel_matches_twin_at_seamless_shapes(cuda_device, layout, dtype,
                                                sq, skv):
    """(1,024, 1,024): the encoder; (64, 1,024): cross attention."""
    q = _make(cuda_device, layout, B, H, sq, dtype, 1)
    k = _make(cuda_device, layout, B, KVH, skv, dtype, 2)
    v = _make(cuda_device, layout, B, KVH, skv, dtype, 3)
    before = TFA.flash_attention.launches
    got = TFA.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert TFA.flash_attention.launches == before + 1
    want = TFA.flash_attention_plain(q, k, v, causal=False)
    _assert_agrees(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kvh,sq,skv", [(1, 16, 16, 64, 200),
                                            (2, 4, 2, 40, 1000),
                                            (1, 2, 1, 100, 72)])
def test_kernel_matches_twin_on_ragged_lengths(cuda_device, dtype, b, h,
                                               kvh, sq, skv):
    q = _make(cuda_device, "contiguous", b, h, sq, dtype, sq)
    k = _make(cuda_device, "contiguous", b, kvh, skv, dtype, skv)
    v = _make(cuda_device, "contiguous", b, kvh, skv, dtype, skv + 1)
    got = TFA.flash_attention(q, k, v, causal=False, block_q=sq,
                              block_k=skv)
    torch.cuda.synchronize()
    want = TFA.flash_attention_plain(q, k, v, causal=False, block_q=sq,
                                     block_k=skv)
    _assert_agrees(got, want, dtype)


@pytest.mark.cuda
def test_bidirectional_differs_from_causal(cuda_device):
    """The gate catches a causal mask where none belongs."""
    q = _make(cuda_device, "strided", 1, H, 256, torch.bfloat16, 4)
    k = _make(cuda_device, "strided", 1, KVH, 256, torch.bfloat16, 5)
    v = _make(cuda_device, "strided", 1, KVH, 256, torch.bfloat16, 6)
    got = TFA.flash_attention(q, k, v, causal=False)
    off = TFA.flash_attention_plain(q, k, v, causal=True)
    with pytest.raises(AssertionError):
        _assert_agrees(got, off, torch.bfloat16)
