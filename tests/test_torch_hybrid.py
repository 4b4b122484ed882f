"""The port's hybrid stack (RG-LRU + local-window attention) against
``repro.models.lm`` on ``recurrentgemma-9b``'s smoke config (d_model 64,
window 16, layers (rglru, rglru, attn_local)) and on an 8-layer cut
(two repeats of the unit and a tail of two, the full config's layout),
with parameters converted from ``lm.init_params(cfg, PRNGKey(0))``; and
the ten configs against the JAX package's.

Tolerances (relative, and that share of the tensor's largest magnitude
absolute, at least the share itself):
  * the 8-layer model in float32 compute (both packages'
    ``COMPUTE_DTYPE`` set to float32 for the test; the algorithm, not
    bf16 rounding): 1e-4 for logits, hidden states, rings, recurrent
    states and the loss.  In bfloat16 the two stacks round at different
    places and 8 layers drift apart by up to 5% of an O(1) value, so
    the 8-layer model is held in float32;
  * the smoke config (3 layers) in bfloat16, the serving dtype: 2e-2, as
    ``tests/test_torch_model.py``;
  * ``_rglru_scan`` on the same float32 inputs: 1e-5 relative and 1e-5
    absolute.  The port's log-depth scan combines pairs at strides 1, 2,
    4, ... and JAX's ``associative_scan`` in another tree, so float32
    results agree to a few ulps, not bit for bit;
  * integer leaves (``len``) and shapes are exact; so is the port's own
    rollback against replaying the accepted steps (the same ops).
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

from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import all_configs, get_config  # noqa: E402
from repro_torch.models import convert, layers, lm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402

TOL = 2e-2
SCAN_TOL = 1e-5
NAME = "recurrentgemma-9b"
B, S, MAX_LEN = 2, 24, 40                      # S > window: rings wrap


def _flat(t):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _flat(v)]
    return [t]


def _f(a, vocab=None):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    return a if vocab is None else a[..., :vocab]


def _close(j, t, vocab=None, tol=TOL):
    """Within ``tol`` relative and ``tol`` x max(1, max|want|) absolute."""
    want = _f(j, vocab)
    np.testing.assert_allclose(_f(t, vocab), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _close_trees(jt, tt, tol=TOL):
    jl, tl = _flat(jt), _flat(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        if b.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            _close(a, b, tol=tol)


def _models(n_layers=None):
    jcfg = jall_configs()[NAME].smoke()
    cfg = get_config(NAME).smoke()
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, 128, (B, S)).astype(
        np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, toks=toks)


@pytest.fixture(scope="module")
def deep():
    """8 layers: two repeats of the (rglru, rglru, attn_local) unit and a
    tail of two rglru layers, as the full config's 12 repeats and tail."""
    return _models(8)


@pytest.fixture(scope="module")
def smoke():
    return _models()


@pytest.fixture
def f32(monkeypatch):
    """Both packages compute in float32 for one test (restored after)."""
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    return 1e-4


def _jprefill(m):
    return functools.partial(jax.jit(functools.partial(
        jlm.prefill, cfg=m["jcfg"]), static_argnames=("max_len",)), m["jp"])


def _jdecode(m):
    return functools.partial(jax.jit(functools.partial(
        jlm.decode_step, cfg=m["jcfg"])), m["jp"])


def _fields(c):
    """A config's fields, a nested ``MoEConfig`` as its own fields (the two
    packages' classes are distinct)."""
    out = {}
    for k in c.__dataclass_fields__:
        v = getattr(c, k)
        out[k] = _fields(v) if hasattr(v, "__dataclass_fields__") else v
    return out


@pytest.mark.parametrize("name", sorted(jall_configs()))
def test_configs_are_the_jax_configs(name):
    jcfg, cfg = jall_configs()[name], all_configs()[name]
    assert _fields(cfg) == _fields(jcfg)
    assert _fields(cfg.smoke()) == _fields(jcfg.smoke())
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_layout_is_the_jax_layout():
    full = get_config(NAME)
    assert lm._layout(full) == jlm._layout(jall_configs()[NAME])
    assert lm._layout(full) == (("rglru", "rglru", "attn_local"), 12,
                                ("rglru", "rglru"))


def test_converted_params_mirror_the_pytree(deep):
    jl, tl = _flat(deep["jp"]), _flat(deep["tp"])
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_init_params_shapes_and_distributions(deep):
    tp = lm.init_params(deep["cfg"], torch.Generator().manual_seed(0),
                        "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), deep["jp"]) == \
        torch.utils._pytree.tree_map(lambda a: tuple(a.shape), tp)
    rg = tp["blocks"][0]["rglru"]
    a = torch.sigmoid(rg["a_param"])
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert not bool(rg["w_input_gate"].any())
    assert float(rg["conv_w"].abs().max()) <= 0.2 + 1e-6   # 0.1 x cut at 2


def test_forward_and_loss(deep, f32):
    jcfg, cfg, jp, tp, toks = (deep[k] for k in
                               ("jcfg", "cfg", "jp", "tp", "toks"))
    jx, jaux = jax.jit(functools.partial(jlm.forward, cfg=jcfg,
                                         remat=False))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tx, taux = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert tx.dtype == torch.float32
    _close(jx, tx, tol=f32)
    assert float(taux) == float(jaux) == 0.0
    for chunk in (7, 1024):
        jloss, jm = jax.jit(functools.partial(
            jlm.loss_fn, cfg=jcfg, remat=False, loss_chunk=chunk))(
            jp, batch={"tokens": jnp.asarray(toks)})
        tloss, tm = lm.loss_fn(tp, cfg, {"tokens": torch.from_numpy(toks)},
                               loss_chunk=chunk)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=f32)
        np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]),
                                   rtol=f32)


def test_loss_in_bfloat16(smoke):
    jcfg, cfg, jp, tp, toks = (smoke[k] for k in
                               ("jcfg", "cfg", "jp", "tp", "toks"))
    jloss, _ = jax.jit(functools.partial(jlm.loss_fn, cfg=jcfg,
                                         remat=False))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tloss, _ = lm.loss_fn(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)


@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
def test_prefill_logits_rings_and_states(smoke, deep, mode, request):
    m, tol = (smoke, TOL) if mode == "bfloat16" else \
        (deep, request.getfixturevalue("f32"))
    cfg = m["cfg"]
    jl, jc = _jprefill(m)(batch={"tokens": jnp.asarray(m["toks"])},
                          max_len=MAX_LEN)
    tl, tc = lm.prefill(m["tp"], cfg, {"tokens": torch.from_numpy(m["toks"])},
                        max_len=MAX_LEN)
    _close(jl, tl, cfg.vocab_size, tol=tol)
    unit, n_rep, tail = lm._layout(cfg)
    ring = tc["blocks"][2]["attn"]
    assert tuple(ring["k"].shape) == (n_rep, B, cfg.n_kv_heads, cfg.window,
                                      cfg.dh)
    assert tc["blocks"][0]["rglru"]["h"].dtype == torch.float32
    for node in tc["tail"]:
        assert tuple(node["rglru"]["conv_buf"].shape) == (
            B, cfg.conv_width - 1, cfg.rnn_width)
    _close_trees(jc, tc, tol=tol)


def test_prefill_ring_holds_position_p_at_slot_p_mod_w(smoke):
    """A prompt longer than the window leaves the last W keys in the ring,
    key p at slot p % W; a shorter one leaves its keys in order, zeros
    after.  The attn_local layer's keys depend only on the rglru layers
    before it, so a window past S (no ring) gives the same keys in
    order: exact."""
    cfg, tp = smoke["cfg"], smoke["tp"]
    toks = torch.from_numpy(smoke["toks"])
    w = cfg.window
    _, ring = lm.prefill(tp, cfg, {"tokens": toks}, max_len=MAX_LEN)
    wide = dataclasses.replace(cfg, window=MAX_LEN)
    _, flat = lm.prefill(tp, wide, {"tokens": toks}, max_len=MAX_LEN)
    rk = ring["blocks"][2]["attn"]["k"][0]               # (B, KVH, W, dh)
    fk = flat["blocks"][2]["attn"]["k"][0]               # (B, KVH, 40, dh)
    assert rk.shape[-2] == w and fk.shape[-2] == MAX_LEN
    for p in range(S - w, S):
        assert torch.equal(rk[..., p % w, :], fk[..., p, :])
    _, short = lm.prefill(tp, cfg, {"tokens": toks[:, :10]}, max_len=MAX_LEN)
    sk = short["blocks"][2]["attn"]["k"][0]
    assert sk.shape[-2] == w
    assert torch.equal(sk[..., :10, :], fk[..., :10, :])
    assert not bool(sk[..., 10:, :].any())


@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
def test_decode_past_the_window_matches_jax(smoke, deep, mode, request):
    """Prefill 10 tokens, then decode 12 with a scalar position: the ring
    wraps at 16; logits and every cache leaf follow JAX's."""
    m, tol = (smoke, TOL) if mode == "bfloat16" else \
        (deep, request.getfixturevalue("f32"))
    cfg, tp = m["cfg"], m["tp"]
    toks = m["toks"][:, :10]
    jdecode = _jdecode(m)
    _, jc = _jprefill(m)(batch={"tokens": jnp.asarray(toks)},
                         max_len=MAX_LEN)
    _, tc = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                       max_len=MAX_LEN)
    nxt = np.random.default_rng(5).integers(0, 128, (12, B, 1)).astype(
        np.int32)
    for t in range(12):
        pos = 10 + t
        jl, jc = jdecode(tokens_t=jnp.asarray(nxt[t]), caches=jc,
                         pos=jnp.asarray(pos, jnp.int32))
        tl, tc = lm.decode_step(tp, cfg, torch.from_numpy(nxt[t]), tc,
                                torch.tensor(pos, dtype=torch.int32))
        _close(jl, tl, cfg.vocab_size, tol=tol)
    _close_trees(jc, tc, tol=tol)
    assert int(tc["blocks"][2]["attn"]["len"][0]) == 22


def test_decode_step_per_row_positions(deep, f32):
    cfg, tp = deep["cfg"], deep["tp"]
    _, jc = _jprefill(deep)(batch={"tokens": jnp.asarray(deep["toks"])},
                            max_len=MAX_LEN)
    _, tc = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(deep["toks"])},
                       max_len=MAX_LEN)
    jc, tc = jkv.broadcast_lens(jc, B), kv_cache.broadcast_lens(tc, B)
    nxt = np.array([[5], [77]], np.int32)
    pos = np.array([S, S - 3], np.int32)
    jl, jc2 = _jdecode(deep)(tokens_t=jnp.asarray(nxt), caches=jc,
                             pos=jnp.asarray(pos))
    tl, tc2 = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc,
                             torch.from_numpy(pos))
    _close(jl, tl, cfg.vocab_size, tol=f32)
    _close_trees(jc2, tc2, tol=f32)


@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
def test_decode_multi_and_rollback(smoke, deep, mode, request):
    """Rollback of ``h``, ``conv_buf`` and the rings per row against JAX,
    and against the port's own replay of the accepted steps (exact)."""
    m, tol = (smoke, TOL) if mode == "bfloat16" else \
        (deep, request.getfixturevalue("f32"))
    jcfg, cfg, jp, tp = (m[k] for k in ("jcfg", "cfg", "jp", "tp"))
    toks = torch.from_numpy(m["toks"])
    _, jc = _jprefill(m)(batch={"tokens": jnp.asarray(m["toks"])},
                         max_len=MAX_LEN)
    _, tc = lm.prefill(tp, cfg, {"tokens": toks}, max_len=MAX_LEN)
    jc, tc = jkv.broadcast_lens(jc, B), kv_cache.broadcast_lens(tc, B)
    draft = np.random.default_rng(2).integers(0, 128, (B, 4)).astype(
        np.int32)
    pos = np.full((B,), S, np.int32)
    jl, jc2, js = jax.jit(functools.partial(jlm.decode_multi, cfg=jcfg))(
        jp, tokens=jnp.asarray(draft), caches=jc, pos=jnp.asarray(pos))
    tl, tc2, ts = lm.decode_multi(tp, cfg, torch.from_numpy(draft), tc,
                                  torch.from_numpy(pos))
    _close(jl, tl, cfg.vocab_size, tol=tol)
    idx = np.array([0, 2], np.int32)
    jr = jkv.truncate(jlm.rollback_caches(jcfg, jc2, js, jnp.asarray(idx)),
                      jnp.asarray(pos + idx + 1))
    tr = kv_cache.truncate(lm.rollback_caches(cfg, tc2, ts,
                                              torch.from_numpy(idx)),
                           torch.from_numpy(pos + idx + 1))
    _close_trees(jr, tr, tol=tol)
    # the port's rollback == the state after idx[r] + 1 decode steps, row
    # by row (the same batch of 2: a matmul's bits depend on its shape)
    _, c = lm.prefill(tp, cfg, {"tokens": toks}, max_len=MAX_LEN)
    c = kv_cache.broadcast_lens(c, B)
    for t in range(int(idx.max()) + 1):
        _, c = lm.decode_step(tp, cfg, torch.from_numpy(draft[:, t:t + 1]),
                              c, torch.from_numpy(pos + t))
        for r in np.nonzero(idx == t)[0]:
            for got, want in zip(
                    _flat(lm.tree_map(lambda a: a[:, r], tr["blocks"])) +
                    _flat(lm.tree_map(lambda a: a[r], tr["tail"])),
                    _flat(lm.tree_map(lambda a: a[:, r], c["blocks"])) +
                    _flat(lm.tree_map(lambda a: a[r], c["tail"]))):
                assert torch.equal(got, want)


@pytest.mark.parametrize("s,h0", [(1, False), (37, False), (64, True)])
def test_rglru_scan_against_jax(s, h0):
    rng = np.random.default_rng(s)
    x, gx, rx = (rng.standard_normal((2, s, 24)).astype(np.float32)
                 for _ in range(3))
    a_param = rng.standard_normal(24).astype(np.float32) * 2
    h = rng.standard_normal((2, 24)).astype(np.float32) if h0 else None
    want = jL._rglru_scan(jnp.asarray(x), jnp.asarray(a_param),
                          jnp.asarray(gx), jnp.asarray(rx),
                          None if h is None else jnp.asarray(h))
    got = layers._rglru_scan(*(torch.from_numpy(a) for a in
                               (x, a_param, gx, rx)),
                             None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


def test_rglru_step_continues_the_forward(smoke):
    """Internal consistency: ``rglru_step`` after ``rglru_fwd`` over t
    tokens gives the state a forward over t + 1 tokens gives."""
    cfg, tp = smoke["cfg"], smoke["tp"]
    p = layers.compute_view(lm._rep(tp["blocks"][0]["rglru"], 0))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)).to(layers.COMPUTE_DTYPE)
    y9, c9 = layers.rglru_fwd(p, x, cfg, with_cache=True)
    _, c8 = layers.rglru_fwd(p, x[:, :8], cfg, with_cache=True)
    y, c = layers.rglru_step(p, x[:, 8:], c8, cfg)
    torch.testing.assert_close(c["h"], c9["h"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c["conv_buf"], c9["conv_buf"])
    torch.testing.assert_close(y.float(), y9[:, 8:].float(), rtol=TOL,
                               atol=TOL)
