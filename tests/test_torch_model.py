"""The port's dense-decoder stack against ``repro.models.lm`` on
``granite-8b``'s smoke config, with parameters converted from
``lm.init_params(cfg, PRNGKey(0))``.

Tolerance (logits, K/V): 2e-2 relative, and 2e-2 of the tensor's largest
magnitude absolute (at least 2e-2).  Both stacks compute
in bfloat16 (8 significant bits, 2^-8 ~ 0.4% per rounding) with float32
softmax statistics and norms, but round at different places — XLA fuses
bf16 elementwise chains in float32, PyTorch rounds after every op — so
O(1) values agree to a few bf16 ulps, not bit for bit.  Shapes, dtypes,
the integer ``len`` leaves and masked-pad logits are exact.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert, layers, lm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402

TOL = 2e-2


B, S, MAX_LEN = 3, 16, 24


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("granite-8b").smoke()
    cfg = get_config("granite-8b").smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, 128, (B, S)).astype(
        np.int32)
    jprefill = jax.jit(functools.partial(jlm.prefill, cfg=jcfg),
                       static_argnames=("max_len",))
    jl, jc = jprefill(jp, batch={"tokens": jnp.asarray(toks)},
                      max_len=MAX_LEN)
    return jcfg, cfg, jp, tp, toks, (jl, jc)


def _f(a, vocab=None):
    a = np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()
    return a if vocab is None else a[..., :vocab]


def _close(j, t, vocab=None):
    """Within TOL, absolute errors scaled by the tensor's magnitude: a
    difference of bf16-rounded products (RoPE's ``x1 cos - x2 sin``) keeps
    the products' absolute error, not the result's relative one."""
    want = _f(j, vocab)
    np.testing.assert_allclose(_f(t, vocab), want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _port_prefill(setup):
    """A fresh port prefill (decode writes its caches in place)."""
    _, cfg, _, tp, toks, _ = setup
    return lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                      max_len=MAX_LEN)


def _fields(c):
    return {k: getattr(c, k) for k in c.__dataclass_fields__}


def test_configs_are_the_jax_configs():
    jcfg = jget_config("granite-8b")
    cfg = get_config("granite-8b")
    assert _fields(cfg) == _fields(jcfg)
    assert _fields(cfg.smoke()) == _fields(jcfg.smoke())
    assert cfg.param_count() == jcfg.param_count()


def test_converted_params_mirror_the_pytree(setup):
    _, _, jp, tp, _, _ = setup
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = torch.utils._pytree.tree_flatten(tp)[0]
    assert len(jleaves) == len(tleaves)
    for (_, a), b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_init_params_shapes_and_distributions(setup):
    _, cfg, jp, _, _, _ = setup
    g = torch.Generator().manual_seed(0)
    tp = lm.init_params(cfg, g, "cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = torch.utils._pytree.tree_map(lambda a: tuple(a.shape), tp)
    assert jshapes == tshapes
    w = tp["blocks"][0]["ffn"]["w_in"]           # (reps, d, f)
    z = w * (cfg.d_model ** 0.5)
    assert float(z.abs().max()) <= 2.0            # truncated at +-2 sd
    assert abs(float(z.std()) - 0.88) < 0.05      # sd of N(0,1) cut at 2
    emb = tp["emb"]
    assert abs(float(emb.std()) - 0.02) < 0.002


def test_prefill_logits_and_caches(setup):
    _, cfg, _, _, _, (jl, jc) = setup
    tl, tc = _port_prefill(setup)
    assert tuple(tl.shape) == tuple(jl.shape) == (B, 1, lm.padded_vocab(cfg))
    _close(jl, tl, cfg.vocab_size)
    np.testing.assert_array_equal(_f(jl)[..., cfg.vocab_size:],
                                  _f(tl)[..., cfg.vocab_size:])
    ja, ta = jc["blocks"][0]["attn"], tc["blocks"][0]["attn"]
    for name in ("k", "v"):
        assert tuple(ta[name].shape) == tuple(ja[name].shape)
        assert ta[name].dtype == layers.COMPUTE_DTYPE
        _close(ja[name], ta[name])
    np.testing.assert_array_equal(np.asarray(ja["len"]), ta["len"].numpy())


def test_decode_step_per_row_positions(setup):
    jcfg, cfg, jp, tp, _, (_, jc) = setup
    _, tc = _port_prefill(setup)
    jc, tc = jkv.broadcast_lens(jc, B), kv_cache.broadcast_lens(tc, B)
    nxt = np.array([[5], [77], [0]], np.int32)
    pos = np.array([S, S - 3, S], np.int32)       # rows at other positions
    jl, jc2 = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg))(
        jp, tokens_t=jnp.asarray(nxt), caches=jc, pos=jnp.asarray(pos))
    tl, tc2 = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc,
                             torch.from_numpy(pos))
    _close(jl, tl, cfg.vocab_size)
    ja, ta = jc2["blocks"][0]["attn"], tc2["blocks"][0]["attn"]
    _close(ja["k"], ta["k"])
    np.testing.assert_array_equal(np.asarray(ja["len"]), ta["len"].numpy())


def test_decode_multi_and_rollback(setup):
    jcfg, cfg, jp, tp, _, (_, jc) = setup
    _, tc = _port_prefill(setup)
    jc, tc = jkv.broadcast_lens(jc, B), kv_cache.broadcast_lens(tc, B)
    draft = np.random.default_rng(2).integers(0, 128, (B, 4)).astype(
        np.int32)
    pos = np.full((B,), S, np.int32)
    jl, jc2, js = jax.jit(functools.partial(jlm.decode_multi, cfg=jcfg))(
        jp, tokens=jnp.asarray(draft), caches=jc, pos=jnp.asarray(pos))
    tl, tc2, ts = lm.decode_multi(tp, cfg, torch.from_numpy(draft), tc,
                                  torch.from_numpy(pos))
    assert tuple(tl.shape) == tuple(jl.shape)
    _close(jl, tl, cfg.vocab_size)
    assert jax.tree.map(lambda a: a.shape, js) == \
        torch.utils._pytree.tree_map(lambda a: tuple(a.shape), ts)
    idx = np.array([0, 3, 1], np.int32)
    jr = jkv.truncate(jlm.rollback_caches(jcfg, jc2, js, jnp.asarray(idx)),
                      jnp.asarray(pos + idx + 1))
    tr = kv_cache.truncate(lm.rollback_caches(cfg, tc2, ts,
                                              torch.from_numpy(idx)),
                           torch.from_numpy(pos + idx + 1))
    ja, ta = jr["blocks"][0]["attn"], tr["blocks"][0]["attn"]
    np.testing.assert_array_equal(np.asarray(ja["len"]), ta["len"].numpy())
    _close(ja["k"], ta["k"])
    _close(ja["v"], ta["v"])


def test_init_caches_match_jax(setup):
    jcfg, cfg, _, _, _, _ = setup
    want = jlm.init_caches(jcfg, 2, 20)
    got = lm.init_caches(cfg, 2, 20, "cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want) == \
        torch.utils._pytree.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
            got)
    assert all(not bool(t.any()) for t in
               torch.utils._pytree.tree_flatten(got)[0])


def test_prefill_then_decode_equals_longer_prefill(setup):
    """Internal consistency of the port: decoding token t after a prefill
    of t tokens gives the logits a prefill of t+1 tokens gives."""
    _, cfg, _, tp, _, _ = setup
    toks = np.random.default_rng(4).integers(0, 128, (2, 17)).astype(
        np.int32)
    full, _ = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _, c = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :16])},
                      max_len=20)
    c = kv_cache.broadcast_lens(c, 2)
    step, _ = lm.decode_step(tp, cfg, torch.from_numpy(toks[:, 16:]), c,
                             torch.tensor([16, 16], dtype=torch.int32))
    np.testing.assert_allclose(_f(step, cfg.vocab_size),
                               _f(full, cfg.vocab_size), rtol=TOL,
                               atol=TOL)


def test_unported_kinds_raise():
    """Every mixer kind of the JAX package is ported: a kind outside them
    raises ``ValueError`` as JAX's ``init_block`` does; the session pool
    refuses the encoder-decoder with ``NotImplementedError``, as JAX's."""
    from repro_torch.serve import Engine

    rg = get_config("granite-8b").smoke()
    with pytest.raises(ValueError, match="mamba"):
        lm.init_params(dataclasses.replace(rg, pattern=("mamba",)),
                       torch.Generator().manual_seed(0), "cpu")
    ed = dataclasses.replace(rg, enc_dec=True, n_enc_layers=2)
    p = lm.init_params(ed, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        Engine(ed, p, max_len=32).session_pool(slots=2)
