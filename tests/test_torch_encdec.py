"""The port's encoder-decoder (``seamless-m4t-large-v2``: a bidirectional
encoder over ``src_embeds``, decoder blocks with cross attention, layer
norm, ReLU FFNs) against ``repro.models.lm`` on its smoke config (d_model
64, 4 heads over 2 kv heads, 2 encoder and 2 decoder layers), with
parameters converted from ``lm.init_params(cfg, PRNGKey(0))``, on the
CPU; and flash attention's plain twin in the encoder's and cross
attention's modes (bidirectional, Sq != Skv) against the JAX Pallas
kernel in interpret mode.

Tolerances (relative, and that share of the tensor's largest magnitude
absolute, at least the share itself):
  * float32 compute (both packages' ``COMPUTE_DTYPE`` set to float32 for
    a test): 1e-4 for the encoder output, hidden states, logits, the
    loss and every cache leaf;
  * bfloat16 compute, the serving dtype: 2e-2;
  * the flash twin: float32 5e-5 and bfloat16 2e-2, as
    ``tests/test_torch_flash256.py``;
  * integer leaves (``len``), shapes and greedy tokens are exact, and the
    cross-attention K/V survive truncation and rollback bit for bit.
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
from repro.kernels import flash_attention as JFA  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import GenConfig as JGenConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.cpm import tuning  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.models import convert, layers, lm  # noqa: E402
from repro_torch.serve import (Engine, GenConfig, ReferenceEngine,  # noqa: E402
                               kv_cache)

TOL = 2e-2
F32_TOL = 1e-4
NAME = "seamless-m4t-large-v2"
B, S, TS, MAX_LEN = 2, 18, 10, 96


@pytest.fixture(scope="module", autouse=True)
def _static_tuning(tmp_path_factory):
    """The cuda backend's plain twins would calibrate the cost model on
    CPU rows: keep this file's tests on the static defaults, any spill in
    a temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_CPM_TUNING_CACHE",
                  str(tmp_path_factory.mktemp("tuning") / "cpm.json"))
        mp.setenv("REPRO_TORCH_CPM_AUTOTUNE", "0")
        mp.setenv("REPRO_TORCH_CPM_CALIBRATE", "0")
        tuning.clear()
        yield
    tuning.clear()


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


def _repetitive(b, s):
    """Prompts with period-6 structure so n-gram lookup finds drafts."""
    period = np.arange(6, dtype=np.int32) + 7
    return np.tile(period[None], (b, -(-s // 6)))[:, :s]


@pytest.fixture(scope="module")
def smoke():
    jcfg = jall_configs()[NAME].smoke()
    cfg = get_config(NAME).smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 128, (B, S)).astype(np.int32)
    src = rng.standard_normal((B, TS, cfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, toks=toks, src=src,
                engine=Engine(cfg, tp, max_len=MAX_LEN),
                ref=ReferenceEngine(cfg, tp, max_len=MAX_LEN))


@pytest.fixture(params=["float32", "bfloat16"])
def tol(request, monkeypatch):
    """The test's tolerance, with both packages computing in float32 (for
    one test, restored after) or in bfloat16."""
    if request.param == "float32":
        monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
        return F32_TOL
    return TOL


def _jbatch(m, toks=None):
    return {"tokens": jnp.asarray(m["toks"] if toks is None else toks),
            "src_embeds": jnp.asarray(m["src"])}


def _tbatch(m, toks=None):
    return {"tokens": torch.from_numpy(m["toks"] if toks is None else toks),
            "src_embeds": torch.from_numpy(m["src"])}


def _prefill_both(m, max_len=MAX_LEN):
    jl, jc = jax.jit(functools.partial(jlm.prefill, cfg=m["jcfg"]),
                     static_argnames=("max_len",))(
        m["jp"], batch=_jbatch(m), max_len=max_len)
    tl, tc = lm.prefill(m["tp"], m["cfg"], _tbatch(m), max_len=max_len)
    return jl, jc, tl, tc


# ---------------------------------------------------------------------------
# parameters, layout, caches
# ---------------------------------------------------------------------------

def test_layout_and_params_mirror_jax(smoke):
    full = get_config(NAME)
    assert lm._layout(full) == jlm._layout(jall_configs()[NAME]) == \
        (("attn",), 24, ())
    tp = lm.init_params(smoke["cfg"], torch.Generator().manual_seed(0),
                        "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), smoke["jp"]) == \
        torch.utils._pytree.tree_map(lambda a: tuple(a.shape), tp)
    assert set(tp["blocks"][0]) == {"norm1", "attn", "norm_cross", "cross",
                                    "norm2", "ffn"}
    assert "cross" not in tp["encoder"]["blocks"]
    assert tp["encoder"]["blocks"]["attn"]["wq"].shape[0] == 2


def test_init_caches_with_cross_len_match_jax(smoke):
    want = jlm.init_caches(smoke["jcfg"], 2, 20, cross_len=TS)
    got = lm.init_caches(smoke["cfg"], 2, 20, "cpu", cross_len=TS)
    jl, tl = _flat(want), _flat(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_f(a), _f(b))
    assert int(got["blocks"][0]["cross_kv"]["len"][0]) == TS


# ---------------------------------------------------------------------------
# cross attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rope", [False, True])
def test_cross_attention_fwd_matches_jax(smoke, tol, rope):
    """Sq = 18 decoder positions over Skv = 10 encoder positions,
    bidirectional; with RoPE the keys sit at their own positions."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    jp = jax.tree.map(lambda a: a[0], smoke["jp"]["blocks"][0]["cross"])
    tp = lm._rep(smoke["tp"]["blocks"][0]["cross"], 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((B, TS, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    kpos = np.broadcast_to(np.arange(TS, dtype=np.int32)[None] + 5, (B, TS))
    dt = jL.COMPUTE_DTYPE
    want = jL.attention_fwd(
        jax.tree.map(lambda a: a.astype(dt), jp),
        jnp.asarray(x, dt), jcfg, jnp.asarray(pos), causal=False,
        kv_input=jnp.asarray(kv, dt), kv_positions=jnp.asarray(kpos),
        rope=rope)
    tdt = layers.COMPUTE_DTYPE
    got = layers.attention_fwd(
        layers.compute_view(tp), torch.from_numpy(x).to(tdt), cfg,
        torch.from_numpy(pos), causal=False,
        kv_input=torch.from_numpy(kv).to(tdt),
        kv_positions=torch.from_numpy(kpos), rope=rope)
    assert tuple(got.shape) == (B, S, cfg.d_model)
    _close(want, got, tol=tol)


def test_cross_attention_step_matches_jax(smoke, tol):
    """A decode step's cross attention reads the first ``len`` encoder
    positions of each row and leaves its cache alone."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    jp = jax.tree.map(lambda a: a[1], smoke["jp"]["blocks"][0]["cross"])
    tp = lm._rep(smoke["tp"]["blocks"][0]["cross"], 1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, cfg.n_kv_heads, TS, cfg.dh)).astype(
        np.float32) for _ in range(2))
    ln = np.array([TS, 6], np.int32)
    dt, tdt = jL.COMPUTE_DTYPE, layers.COMPUTE_DTYPE
    want, _ = jL.attention_step(
        jax.tree.map(lambda a: a.astype(dt), jp), jnp.asarray(x, dt), {},
        jcfg, 0, cross_kv={"k": jnp.asarray(k, dt), "v": jnp.asarray(v, dt),
                           "len": jnp.asarray(ln)})
    marker = {}
    got, back = layers.attention_step(
        layers.compute_view(tp), torch.from_numpy(x).to(tdt), marker, cfg,
        0, cross_kv={"k": torch.from_numpy(k).to(tdt),
                     "v": torch.from_numpy(v).to(tdt),
                     "len": torch.from_numpy(ln)})
    assert back is marker
    _close(want, got, tol=tol)


def test_encoder_matches_jax(smoke, tol):
    want = jax.jit(functools.partial(jlm._run_encoder, cfg=smoke["jcfg"]))(
        smoke["jp"], src_embeds=jnp.asarray(smoke["src"]))
    got = lm._run_encoder(smoke["tp"], smoke["cfg"],
                          torch.from_numpy(smoke["src"]), "cpu")
    assert got.dtype == layers.COMPUTE_DTYPE
    assert tuple(got.shape) == (B, TS, smoke["cfg"].d_model)
    _close(want, got, tol=tol)


def test_encoder_is_bidirectional(smoke):
    """Changing the last source frame moves the encoder output at the
    first position (a causal encoder would not)."""
    src = torch.from_numpy(smoke["src"])
    a = lm._run_encoder(smoke["tp"], smoke["cfg"], src, "cpu")
    src2 = src.clone()
    src2[:, -1] += 1.0
    b = lm._run_encoder(smoke["tp"], smoke["cfg"], src2, "cpu")
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_and_loss(smoke, tol):
    jcfg, cfg, jp, tp = (smoke[k] for k in ("jcfg", "cfg", "jp", "tp"))
    jx, jaux = jax.jit(functools.partial(jlm.forward, cfg=jcfg,
                                         remat=False))(jp, batch=_jbatch(smoke))
    tx, taux = lm.forward(tp, cfg, _tbatch(smoke))
    _close(jx, tx, tol=tol)
    assert float(taux) == float(jaux) == 0.0
    for chunk in (7, 1024):
        jloss, _ = jax.jit(functools.partial(
            jlm.loss_fn, cfg=jcfg, remat=False, loss_chunk=chunk))(
            jp, batch=_jbatch(smoke))
        tloss, _ = lm.loss_fn(tp, cfg, _tbatch(smoke), loss_chunk=chunk)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol)


def test_prefill_caches_and_decode_step(smoke, tol):
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    jl, jc, tl, tc = _prefill_both(smoke)
    _close(jl, tl, cfg.vocab_size, tol=tol)
    _close_trees(jc, tc, tol=tol)
    assert tuple(tc["blocks"][0]["cross_kv"]["k"].shape) == (
        1 * cfg.n_layers, B, cfg.n_kv_heads, TS, cfg.dh)
    jc, tc = jkv.broadcast_lens(jc, B), kv_cache.broadcast_lens(tc, B)
    nxt = np.random.default_rng(9).integers(0, 128, (B, 3)).astype(np.int32)
    for t in range(3):
        pos = np.full((B,), S + t, np.int32)
        jl, jc = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg))(
            smoke["jp"], tokens_t=jnp.asarray(nxt[:, t:t + 1]), caches=jc,
            pos=jnp.asarray(pos))
        tl, tc = lm.decode_step(smoke["tp"], cfg,
                                torch.from_numpy(nxt[:, t:t + 1]), tc,
                                torch.from_numpy(pos))
        _close(jl, tl, cfg.vocab_size, tol=tol)
    _close_trees(jc, tc, tol=tol)


def test_prefill_then_decode_equals_longer_prefill(smoke):
    cfg, tp = smoke["cfg"], smoke["tp"]
    toks = smoke["toks"]
    full, _ = lm.prefill(tp, cfg, _tbatch(smoke))
    _, c = lm.prefill(tp, cfg, _tbatch(smoke, toks[:, :-1]), max_len=24)
    c = kv_cache.broadcast_lens(c, B)
    step, _ = lm.decode_step(tp, cfg, torch.from_numpy(toks[:, -1:]), c,
                             torch.full((B,), S - 1, dtype=torch.int32))
    _close(full, step, cfg.vocab_size)


def test_decode_multi_and_rollback_match_jax(smoke, tol):
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    _, jc, _, tc = _prefill_both(smoke)
    jc, tc = jkv.broadcast_lens(jc, B), kv_cache.broadcast_lens(tc, B)
    seq = np.random.default_rng(11).integers(0, 128, (B, 4)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    jlg, jc2, jsn = jax.jit(functools.partial(jlm.decode_multi, cfg=jcfg))(
        smoke["jp"], tokens=jnp.asarray(seq), caches=jc, pos=jnp.asarray(pos))
    tlg, tc2, tsn = lm.decode_multi(smoke["tp"], cfg, torch.from_numpy(seq),
                                    tc, torch.from_numpy(pos))
    _close(jlg, tlg, cfg.vocab_size, tol=tol)
    _close_trees(jsn, tsn, tol=tol)
    idx = np.array([1, 3], np.int32)
    jr = jkv.truncate(jlm.rollback_caches(jcfg, jc2, jsn, jnp.asarray(idx)),
                      jnp.asarray(pos + idx + 1))
    tr = kv_cache.truncate(lm.rollback_caches(cfg, tc2, tsn,
                                              torch.from_numpy(idx)),
                           torch.from_numpy(pos + idx + 1))
    _close_trees(jr, tr, tol=tol)


def test_truncate_and_rollback_keep_the_cross_kv(smoke):
    """Speculative rollback never touches the cross-attention K/V: the
    per-row ``len`` stays the encoder length through ``broadcast_lens``,
    ``truncate`` to fewer positions and ``rollback_caches``, and the
    buffers keep their storage and bits."""
    cfg, tp = smoke["cfg"], smoke["tp"]
    _, c = lm.prefill(tp, cfg, _tbatch(smoke), max_len=MAX_LEN)
    c = kv_cache.broadcast_lens(c, B)
    cross = c["blocks"][0]["cross_kv"]
    k0, v0 = cross["k"].clone(), cross["v"].clone()
    assert cross["len"].tolist() == [[TS] * B] * cfg.n_layers
    t = kv_cache.truncate(c, torch.tensor([3, 4], dtype=torch.int32))
    assert t["blocks"][0]["cross_kv"] is cross
    assert t["blocks"][0]["attn"]["len"].tolist() == [[3, 4]] * cfg.n_layers
    pos = torch.full((B,), S, dtype=torch.int32)
    seq = torch.from_numpy(_repetitive(B, 4))
    _, c2, snaps = lm.decode_multi(tp, cfg, seq, c, pos)
    assert "cross_kv" not in snaps["blocks"][0]
    r = lm.rollback_caches(cfg, c2, snaps, torch.tensor([0, 2]))
    r = kv_cache.truncate(r, pos + torch.tensor([1, 3], dtype=torch.int32))
    rc = r["blocks"][0]["cross_kv"]
    assert rc["k"].data_ptr() == cross["k"].data_ptr()
    assert torch.equal(rc["k"], k0) and torch.equal(rc["v"], v0)
    assert rc["len"].tolist() == [[TS] * B] * cfg.n_layers


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _equiv_case(cfg):
    """``tests/test_engine_equiv.py``'s enc-dec case: repeated prompts of
    18 tokens and ``src_embeds`` of 10 frames from ``PRNGKey(2)``."""
    src = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                       (2, 10, cfg.d_model)))
    return _repetitive(2, 18), src


def test_greedy_tokens_equal_jax_engine_and_the_oracle(smoke):
    """JAX's engine, the port's scan and speculative paths (both commit
    backends) and its step-by-step oracle give the same greedy tokens on
    the enc-dec case of the JAX package's engine tests."""
    toks, src = _equiv_case(smoke["cfg"])
    jeng = JEngine(smoke["jcfg"], smoke["jp"], max_len=MAX_LEN)
    jout, _ = jeng.generate({"tokens": jnp.asarray(toks),
                             "src_embeds": jnp.asarray(src)},
                            JGenConfig(max_new_tokens=12))
    batch = {"tokens": torch.from_numpy(toks),
             "src_embeds": torch.from_numpy(src)}
    scan, _ = smoke["engine"].generate(batch, GenConfig(max_new_tokens=12))
    ref, _ = smoke["ref"].generate(batch, GenConfig(max_new_tokens=12))
    np.testing.assert_array_equal(scan.numpy(), np.asarray(jout))
    assert torch.equal(scan, ref)
    for backend in ("reference", "cuda"):
        eng = Engine(smoke["cfg"], smoke["tp"], max_len=MAX_LEN,
                     cpm_backend=backend)
        spec, stats = eng.generate(batch, GenConfig(max_new_tokens=12,
                                                    ngram_spec=4))
        assert torch.equal(spec, scan), backend
        assert stats["rounds"] > 0


def test_oracle_speculative_rounds_keep_the_cross_kv(smoke):
    """Batch 1: the oracle's own speculative rounds truncate the caches
    every round; its tokens equal the scan path's."""
    toks, src = _equiv_case(smoke["cfg"])
    batch = {"tokens": torch.from_numpy(toks[:1]),
             "src_embeds": torch.from_numpy(src[:1])}
    scan, _ = smoke["engine"].generate(batch, GenConfig(max_new_tokens=12))
    ref, stats = smoke["ref"].generate(batch, GenConfig(max_new_tokens=12,
                                                        ngram_spec=4))
    assert torch.equal(ref, scan) and stats["proposed"] > 0


def test_session_pool_refuses_the_encoder_decoder(smoke):
    """As in JAX: the pool serves decoder-only models."""
    with pytest.raises(NotImplementedError, match="decoder-only"):
        smoke["engine"].session_pool(slots=2)


# ---------------------------------------------------------------------------
# flash attention's twin in the encoder's and cross attention's modes
# ---------------------------------------------------------------------------

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FLASH_TOL = {"float32": 5e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh,sq,skv,bq,bk", [
    (4, 4, 128, 128, 64, 64),       # the encoder: bidirectional, Sq = Skv
    (4, 4, 64, 256, 64, 128),       # cross: one q tile over two kv tiles
    (4, 2, 32, 96, 32, 96),         # cross, ragged Skv in one tile, GQA
])
def test_flash_twin_bidirectional_matches_jax(dt, h, kvh, sq, skv, bq, bk):
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((1, h, sq, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, kvh, skv, 64)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dt)) for a in (q, k, v))
    want = JFA.flash_attention(jq, jk, jv, causal=False, block_q=bq,
                               block_k=bk, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(_TDT[dt]) for a in (q, k, v))
    got = TFA.flash_attention(tq, tk, tv, causal=False, block_q=bq,
                              block_k=bk)
    assert got.dtype == _TDT[dt] and tuple(got.shape) == (1, h, sq, 64)
    np.testing.assert_allclose(got.float().numpy(), _f(want),
                               rtol=_FLASH_TOL[dt], atol=_FLASH_TOL[dt])
