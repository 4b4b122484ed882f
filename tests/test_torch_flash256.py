"""Flash attention at head dim 256 (recurrentgemma-9b: 16 q heads over
one kv head, local window): the port's plain twin against the JAX Pallas
kernel in interpret mode on the same NumPy inputs.

Tolerances: float32 — 5e-5, the summation-order noise of float32 dot
products over D = 256 (the twin multiplies whole tiles, the interpreted
kernel its own blocks); bfloat16 — one bf16 rounding of the output
(2^-8 relative, so 2e-2 absolute on O(1) values), since both sides
compute in float32 from the same bf16 inputs.  The CUDA kernel is held
against the twin on the card by ``tests/test_torch_flash256_card.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as JFA  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402

D = 256
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 5e-5, "bfloat16": 2e-2}

# (b, h, kvh, s, causal, window, block_q, block_k): S 64-256, one kv head
CASES = [
    (1, 4, 1, 64, True, None, 64, 64),
    (1, 2, 1, 128, True, 48, 64, 32),
    (2, 2, 1, 256, True, 100, 128, 128),
    (1, 4, 2, 128, False, 40, 128, 64),
    (1, 2, 1, 256, True, 200, 128, 64),
]


def _qkv(seed, b, h, kvh, s):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, D)).astype(np.float32),
            rng.standard_normal((b, kvh, s, D)).astype(np.float32),
            rng.standard_normal((b, kvh, s, D)).astype(np.float32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_twin_matches_jax_interpret_kernel(case, dt):
    b, h, kvh, s, causal, window, bq, bk = case
    q, k, v = _qkv(s + h, b, h, kvh, s)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dt)) for a in (q, k, v))
    want = JFA.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=bq, block_k=bk, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(_TDT[dt]) for a in (q, k, v))
    got = TFA.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                    block_q=bq, block_k=bk)
    assert got.dtype == _TDT[dt] and tuple(got.shape) == (b, h, s, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=_TOL[dt], atol=_TOL[dt])


def test_window_rows_past_the_window_lose_their_first_keys():
    """The mask is on absolute indices: with window W, rows below W keep
    every causal key, row r >= W keeps keys r - W + 1 .. r.  A key that
    only rows past W lose changes those rows alone."""
    b, h, s, w = 1, 2, 128, 64
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, b, h, 1, s))
    base = TFA.flash_attention_plain(q, k, v, causal=True, window=w)
    v2 = v.clone()
    v2[:, :, 0] += 10.0                    # key 0: live for rows 0 .. 63
    moved = TFA.flash_attention_plain(q, k, v2, causal=True, window=w)
    changed = (moved - base).abs().amax(dim=(0, 1, 3)) > 0
    assert bool(changed[:w].all()) and not bool(changed[w:].any())


def test_wrapper_takes_head_dim_256_on_the_cpu():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(5, 1, 16, 1, 64))
    before = TFA.flash_attention.launches
    out = TFA.flash_attention(q, k, v, causal=True, window=32)
    assert TFA.flash_attention.launches == before     # the twin: no launch
    assert torch.equal(out, TFA.flash_attention_plain(q, k, v, causal=True,
                                                      window=32))
    assert 256 in TFA._HEAD_DIMS and 256 in TFA._TMA_HEAD_DIMS
