"""The port's M-RoPE and vision-patch text path against the JAX package,
on qwen2-vl-7b's smoke config (M-RoPE sections (2, 3, 3), qkv biases),
with parameters converted from ``lm.init_params(cfg, PRNGKey(0))``.

Tolerances (relative, and that share of max(1, max|want|) absolute):
``apply_rope`` on the same float32 input 1e-6 (the same float32 angles
and products); the model in float32 compute (both packages'
``COMPUTE_DTYPE`` set to float32 for the test) 1e-4; in bfloat16, the
serving dtype, 2e-2 (the two stacks round at different places).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert, layers, lm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402

TOL = 2e-2
F32_TOL = 1e-4
NAME = "qwen2-vl-7b"
B, S, P, MAX_LEN = 2, 16, 5, 24


def _f(a, vocab=None):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    return a if vocab is None else a[..., :vocab]


def _close(j, t, vocab=None, tol=TOL):
    """Within ``tol`` relative and ``tol`` x max(1, max|want|) absolute."""
    want = _f(j, vocab)
    np.testing.assert_allclose(_f(t, vocab), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def model():
    jcfg = jall_configs()[NAME].smoke()
    cfg = get_config(NAME).smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 128, (B, S)).astype(np.int32)
    # 3-axis positions: text runs on all axes, a patch grid in rows 2..6
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    pos[1, :, 2:2 + P] = 2 + np.arange(P) // 2
    pos[2, :, 2:2 + P] = 2 + np.arange(P) % 2
    patch_pos = np.stack([np.arange(2, 2 + P)] * B).astype(np.int32)
    patches = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "pos_ids": jnp.asarray(pos),
              "patch_embeds": jnp.asarray(patches),
              "patch_pos": jnp.asarray(patch_pos)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "pos_ids": torch.from_numpy(pos),
              "patch_embeds": torch.from_numpy(patches),
              "patch_pos": torch.from_numpy(patch_pos)}
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jbatch=jbatch,
                tbatch=tbatch)


@pytest.fixture
def f32(monkeypatch):
    """Both packages compute in float32 for one test (restored after)."""
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)


def test_mrope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # one position on all three axes is plain RoPE
    same = np.broadcast_to(pos[:1], pos.shape)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same.copy()),
                          1e6, (2, 3, 3)).numpy(),
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                          1e6).numpy(), rtol=1e-6, atol=1e-6)


def test_patches_replace_token_embeddings(model):
    x = lm._embed(model["tp"], model["cfg"], model["tbatch"]["tokens"],
                  model["tbatch"])
    want = model["tbatch"]["patch_embeds"].to(layers.COMPUTE_DTYPE)
    assert torch.equal(x[:, 2:2 + P], want)
    plain = lm._embed(model["tp"], model["cfg"], model["tbatch"]["tokens"])
    assert torch.equal(x[:, :2], plain[:, :2])


def test_forward_loss_prefill_decode(model, f32):
    jcfg, cfg, jp, tp = (model[k] for k in ("jcfg", "cfg", "jp", "tp"))
    jb, tb = model["jbatch"], model["tbatch"]
    v = cfg.vocab_size
    jx, _ = jax.jit(functools.partial(jlm.forward, cfg=jcfg, remat=False))(
        jp, batch=jb)
    tx, _ = lm.forward(tp, cfg, tb)
    _close(jx, tx, tol=F32_TOL)
    jloss, _ = jax.jit(functools.partial(jlm.loss_fn, cfg=jcfg,
                                         remat=False))(jp, batch=jb)
    tloss, _ = lm.loss_fn(tp, cfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=F32_TOL)
    jl, jc = jax.jit(functools.partial(jlm.prefill, cfg=jcfg),
                     static_argnames=("max_len",))(jp, batch=jb,
                                                   max_len=MAX_LEN)
    tl, tc = lm.prefill(tp, cfg, tb, max_len=MAX_LEN)
    _close(jl, tl, v, tol=F32_TOL)
    _close(jc["blocks"][0]["attn"]["k"], tc["blocks"][0]["attn"]["k"],
           tol=F32_TOL)
    jc, tc = jkv.broadcast_lens(jc, B), kv_cache.broadcast_lens(tc, B)
    nxt = np.array([[5], [77]], np.int32)
    pos = np.array([S, S - 2], np.int32)
    jl, jc = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg))(
        jp, tokens_t=jnp.asarray(nxt), caches=jc, pos=jnp.asarray(pos))
    tl, tc = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
    _close(jl, tl, v, tol=F32_TOL)
    draft = np.random.default_rng(2).integers(0, 128, (B, 3)).astype(
        np.int32)
    jl, _, _ = jax.jit(functools.partial(jlm.decode_multi, cfg=jcfg))(
        jp, tokens=jnp.asarray(draft), caches=jc, pos=jnp.asarray(pos + 1))
    tl, _, _ = lm.decode_multi(tp, cfg, torch.from_numpy(draft), tc,
                               torch.from_numpy(pos + 1))
    _close(jl, tl, v, tol=F32_TOL)


def test_prefill_in_bfloat16(model):
    jcfg, cfg, jp, tp = (model[k] for k in ("jcfg", "cfg", "jp", "tp"))
    jl, _ = jax.jit(functools.partial(jlm.prefill, cfg=jcfg),
                    static_argnames=("max_len",))(jp, batch=model["jbatch"],
                                                  max_len=MAX_LEN)
    tl, _ = lm.prefill(tp, cfg, model["tbatch"], max_len=MAX_LEN)
    assert tl.dtype == torch.bfloat16
    _close(jl, tl, cfg.vocab_size)


def test_text_only_positions_are_arange_on_three_axes(model):
    cfg = model["cfg"]
    p = lm._positions(cfg, {}, 5, 2, "cpu")
    assert tuple(p.shape) == (3, 2, 5)
    assert torch.equal(p, torch.arange(5, dtype=torch.int32).expand(3, 2, 5))


def test_init_params_shapes(model):
    tp = lm.init_params(model["cfg"], torch.Generator().manual_seed(0),
                        "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), model["jp"]) == \
        torch.utils._pytree.tree_map(lambda a: tuple(a.shape), tp)
    attn = tp["blocks"][0]["attn"]
    assert not bool(attn["bq"].any()) and not bool(attn["bk"].any())
