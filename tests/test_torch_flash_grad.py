"""Gradients of flash attention in the port: ``FlashAttentionFn``'s
plain backward (``flash_attention_bwd_plain``), run here through the
kernel's plain twin as its forward, against ``jax.grad`` of the JAX
package's ``flash_attention_ref`` (Sq = Skv: causal, window,
bidirectional, GQA, head dims 16-256) and against torch autograd of the
twin ``flash_attention_plain`` (also Sq != Skv, and rows that keep no
key).  The CUDA forward kernel under the same Function is held against
the twin on the card by ``tests/test_torch_flash_grad_card.py``.

Tolerances, of each gradient's largest |value|:
  * against JAX, float32 1e-4: the JAX reference scales q in the input
    dtype before its product and sums kv blocks of its own, so float32
    results differ by summation order; bfloat16 2e-2: the JAX
    reference's gradients are bf16 all the way (one bf16 rounding is
    2^-8), the port's backward runs its products on bf16 operands with
    float32 sums;
  * against the twin's autograd, float32 1e-5 (the same float32 math in
    another order), bfloat16 2e-2.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TWIN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (b, h, kvh, s, d, causal, window, tile_q): Sq = Skv
JAX_CASES = [
    (2, 4, 2, 64, 16, True, None, 16),
    (1, 4, 1, 64, 32, True, 24, 16),
    (2, 4, 4, 64, 64, False, None, 32),
    (1, 4, 2, 64, 32, False, 20, 16),
    (1, 4, 2, 128, 128, True, 40, 32),
    (1, 2, 1, 64, 256, True, 48, 16),
]

# (b, h, kvh, sq, skv, d, causal, window, tile_q)
TWIN_CASES = [
    (1, 4, 2, 32, 64, 16, False, None, 16),     # cross, bidirectional
    (1, 4, 2, 32, 64, 32, True, None, 16),      # Sq < Skv, absolute rows
    (2, 4, 4, 64, 32, 16, True, 8, 16),         # rows past Skv + window
    (1, 2, 1, 64, 64, 64, False, 16, 32),       # window, not causal
    (2, 8, 2, 64, 64, 128, True, None, 16),
    (1, 2, 1, 48, 48, 256, True, 20, 16),       # a ragged last tile
]


def _inputs(seed, b, h, kvh, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kvh, skv, d)).astype(np.float32),
            rng.standard_normal((b, kvh, skv, d)).astype(np.float32),
            rng.standard_normal((b, h, sq, d)).astype(np.float32))


def _port_grads(arrs, dt, causal, window, tile_q=None):
    """Gradients of ``sum(dO * FlashAttentionFn(q, k, v))``, the backward
    called with ``tile_q``."""
    q, k, v, do = (torch.from_numpy(a).to(_TDT[dt]) for a in arrs)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = fa.flash_attention.launches
    out = fa.FlashAttentionFn.apply(q, k, v, causal, window, 128, 128)
    assert fa.flash_attention.launches == before     # CPU: the twin
    dq, dk, dv = fa.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), do,
        causal=causal, window=window, tile_q=tile_q)
    auto = torch.autograd.grad(out, (q, k, v), do)
    if tile_q is None:                         # the Function's own backward
        for x, y in zip(auto, (dq, dk, dv)):
            assert torch.equal(x, y)
    return (dq, dk, dv), out


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", JAX_CASES)
def test_backward_matches_jax_grad_of_reference(case, dt):
    b, h, kvh, s, d, causal, window, tile_q = case
    arrs = _inputs(s + d + h, b, h, kvh, s, s, d)
    jq, jk, jv, jdo = (jnp.asarray(a, getattr(jnp, dt)) for a in arrs)

    def f(q, k, v):
        o = jref.flash_attention_ref(q, k, v, causal=causal, window=window)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    for tq in (tile_q, None):
        got, _ = _port_grads(arrs, dt, causal, window, tq)
        for g, w in zip(got, want):
            assert g.dtype == _TDT[dt]
            _close(g, w, JAX_TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TWIN_CASES)
def test_backward_matches_autograd_of_twin(case, dt):
    b, h, kvh, sq, skv, d, causal, window, tile_q = case
    arrs = _inputs(sq + skv + d, b, h, kvh, sq, skv, d)
    q, k, v, do = (torch.from_numpy(a).to(_TDT[dt]) for a in arrs)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    bq = 16 if sq % 16 == 0 else sq
    out = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   block_q=bq, block_k=16)
    want = torch.autograd.grad(out, (q, k, v), do)
    got, fwd = _port_grads(arrs, dt, causal, window, tile_q)
    for g, w in zip(got, want):
        _close(g, w, TWIN_TOL[dt])


def test_dead_rows_read_every_key_and_give_q_no_gradient():
    """A row with no key in its window (Sq >= Skv + window) averages every
    value in the forward: its dq is 0, it adds nothing to dk, and each
    value gets 1 / Skv of its output gradient."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 2, 24, 8,
                                                        16))
    first_dead = 8 + 4 - 1
    out = fa.flash_attention_plain(q, k, v, causal=True, window=4,
                                   block_q=8, block_k=8)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, do, causal=True,
                                              window=4, tile_q=8)
    assert torch.count_nonzero(dq[:, :, first_dead:]) == 0
    live = slice(0, first_dead)
    lq, lk, lv = fa.flash_attention_bwd_plain(
        q[:, :, live], k, v, out[:, :, live], do[:, :, live], causal=True,
        window=4, tile_q=8)
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dq[:, :, live], lq, **tol)
    torch.testing.assert_close(dk, lk, **tol)
    extra = do[:, :, first_dead:].sum(2, keepdim=True) / 8
    torch.testing.assert_close(dv, lv + extra, **tol)


@pytest.mark.parametrize("b,h,sq,skv,want", [(2, 32, 4096, 4096, 256),
                                             (1, 16, 2304, 2304, 1024),
                                             (4, 16, 64, 1024, 64),
                                             (1, 2, 40, 40, 40)])
def test_default_tile_bounds_the_score_block(b, h, sq, skv, want):
    t = fa._tile_rows(b, h, sq, skv)
    assert t == want
    assert t == sq or b * h * t * skv * 4 <= fa.TILE_BYTES


@pytest.mark.parametrize("i0,i1,skv,causal,window,want", [
    (0, 16, 64, True, None, (0, 16, False)),
    (48, 64, 64, True, 20, (29, 64, False)),
    (16, 32, 64, False, None, (0, 64, False)),
    (16, 32, 64, False, 8, (9, 64, False)),
    (16, 24, 8, True, 4, (0, 8, True)),        # row 23 >= 8 - 1 + 4
    (0, 8, 8, True, 4, (0, 8, False)),
])
def test_key_span(i0, i1, skv, causal, window, want):
    assert fa._key_span(i0, i1, skv, causal, window) == want


def test_cpu_attention_keeps_the_reference_under_grad():
    """On the CPU, ``ops.attention`` differentiates the reference itself
    (no Function, no launch), as the JAX package differentiates its
    reference off the TPU."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(5, 1, 4, 2, 32, 32,
                                                        16))
    q.requires_grad_()
    before = fa.flash_attention.launches
    out = ops.attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
    assert fa.flash_attention.launches == before
    want = ops.attention(q.detach(), k, v, causal=True, impl="ref")
    assert torch.equal(out.detach(), want)
