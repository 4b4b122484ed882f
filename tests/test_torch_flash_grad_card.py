"""Flash attention under autograd on the card (``chip_smoke.py`` phase
15(a)): ``ops.attention`` with grad enabled launches the forward kernel
through ``FlashAttentionFn``, once a call, and dq, dk, dv agree with
autograd of the plain twin on the same inputs at the serving shapes
(granite-8b causal, recurrentgemma-9b's D = 256 window, seamless's
bidirectional encoder and cross attention, the float32 kernel) and at
one microbatch of the training phase's 4,096-token sequences.  Every
test here is ``cuda``-marked and skips without a card.

Tolerances, of each gradient's largest |value|: bfloat16 2e-2 (the
kernel's forward rounds P to bf16 and the backward runs its products on
bf16 operands; the twin keeps float32), float32 1e-4 (summation order).
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# (B, H, KVH, Sq, Skv, D, causal, window)
SHAPES = {
    "granite": (2, 32, 8, 1024, 1024, 128, True, None),
    "granite-train": (2, 32, 8, 4096, 4096, 128, True, None),
    "recurrentgemma": (1, 16, 1, 2304, 2304, 256, True, 2048),
    "seamless-encoder": (4, 16, 16, 1024, 1024, 64, False, None),
    "seamless-cross": (4, 16, 16, 64, 1024, 64, False, None),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _make(dev, b, h, kvh, sq, skv, d, dtype, seed):
    """q, k, v in the main path's layout ((B, S, heads, D) viewed as (B,
    heads, S, D)), requiring grad, and an output gradient."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def one(n, s):
        return torch.randn((b, s, n, d), generator=g, device=dev).to(
            dtype).transpose(1, 2).requires_grad_()

    q, k, v = one(h, sq), one(kvh, skv), one(kvh, skv)
    do = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
    return q, k, v, do


def _rel(x, y) -> float:
    return float((x.float() - y.float()).abs().max()
                 / y.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [
    *((n, torch.bfloat16) for n in SHAPES), ("granite", torch.float32)])
def test_gradients_match_autograd_of_twin(cuda_device, name, dtype):
    b, h, kvh, sq, skv, d, causal, window = SHAPES[name]
    q, k, v, do = _make(cuda_device, b, h, kvh, sq, skv, d, dtype, sq + d)
    before = TFA.flash_attention.launches
    out = ops.attention(q, k, v, causal=causal, window=window)
    assert TFA.flash_attention.launches == before + 1
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(
        TFA.flash_attention_plain(q, k, v, causal=causal, window=window),
        (q, k, v), do)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == dtype
        assert _rel(x, y) <= TOL[dtype]


@pytest.mark.cuda
def test_serving_keeps_the_bare_kernel(cuda_device):
    """Without grad (or with no input requiring it) ``ops.attention``
    launches the bare wrapper: no autograd node."""
    q, k, v, _ = _make(cuda_device, 1, 4, 2, 128, 128, 64, torch.bfloat16, 1)
    with torch.no_grad():
        out = ops.attention(q, k, v, causal=True)
    assert out.grad_fn is None
    out = ops.attention(q.detach(), k.detach(), v.detach(), causal=True)
    assert out.grad_fn is None


@pytest.mark.cuda
def test_kernel_refusals_raise_under_autograd(cuda_device):
    """A head dim the kernel was not built for raises through the Function
    as through the bare wrapper: nothing falls back to the twin."""
    q, k, v, _ = _make(cuda_device, 1, 2, 2, 64, 64, 48, torch.bfloat16, 2)
    before = TFA.flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        ops.attention(q, k, v, causal=True)
    assert TFA.flash_attention.launches == before


@pytest.mark.cuda
def test_attention_weights_get_their_gradients(cuda_device, monkeypatch):
    """The fault ``FlashAttentionFn`` closes (ROADMAP Queue 3): the bare
    wrapper writes its output into a fresh tensor, so through it wq, wk
    and wv get no gradient at all.  Through ``ops.attention`` they get
    the CPU reference's, within 1e-3 of each leaf's largest value
    (granite-8b's smoke config cut to 2 layers, 2 x 64 tokens, float32
    compute)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import layers, lm
    from repro_torch.train._tree import leaves_with_path
    from repro_torch.train.train_step import loss_and_grads

    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    cfg = dataclasses.replace(get_config("granite-8b").smoke(), n_layers=2)
    params = lm.init_params(cfg, torch.Generator(device=cuda_device)
                            .manual_seed(3), cuda_device)
    batch = {"tokens": np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)}
    qkv = ("['wq']", "['wk']", "['wv']")

    def attn_grads(p):
        _, _, grads = loss_and_grads(p, cfg, batch)
        return {path: g for path, g in leaves_with_path(grads)
                if path.endswith(qkv)}

    want = attn_grads(lm.tree_map(lambda t: t.detach().cpu(), params))
    got = attn_grads(params)
    for path, g in got.items():
        assert _rel(g.cpu(), want[path]) <= 1e-3, path

    def bare(q, k, v, *, causal=True, window=None, impl=None, **kw):
        return TFA.flash_attention(q, k, v, causal=causal, window=window,
                                   **kw)

    monkeypatch.setattr(ops, "attention", bare)
    detached = attn_grads(params)
    assert all(float(g.abs().max()) == 0 for g in detached.values())
    assert all(float(g.abs().max()) > 0 for g in want.values())
