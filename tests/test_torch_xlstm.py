"""The port's xLSTM stack (mLSTM and sLSTM mixers, no FFN) against
``repro.models.lm`` on ``xlstm-1.3b``'s smoke config (d_model 64, 4
heads, layers 7 x mlstm then slstm: one repeat of the full config's
unit), with parameters converted from ``lm.init_params(cfg,
PRNGKey(0))``, on the CPU.

Tolerances (relative, and that share of the tensor's largest magnitude
absolute, at least the share itself):
  * float32 compute (both packages' ``COMPUTE_DTYPE`` set to float32 for
    a test): 1e-4 for hidden states, logits, the loss and the recurrent
    states ``C``, ``n``, ``c``, ``n``, ``h``, ``m``;
  * bfloat16 compute, the serving dtype: 2e-2, on each of the smoke
    model's 8 layers fed JAX's input, on its loss, and on a 2-layer
    (mlstm, slstm) cut end to end.  The two stacks round at different
    places (each layer is one bf16 ulp apart), and over 8 layers the
    recurrences carry that to ~4% of the hidden state's largest value,
    so the 8-layer model is held in float32;
  * ``_mlstm_chunk_scan`` on the same float32 inputs: 1e-5 against JAX
    (the port carries the state across chunks by a loop, JAX by an
    associative scan: they agree to rounding) and 1e-4 against a float64
    replay of the step recurrence;
  * the layers against a replay of their own ``*_step``: 1e-4 in float32;
  * integer leaves (``len``), shapes and greedy tokens are exact.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

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
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import GenConfig as JGenConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.cpm import tuning  # noqa: E402
from repro_torch.models import convert, layers, lm  # noqa: E402
from repro_torch.serve import (Engine, GenConfig, ReferenceEngine,  # noqa: E402
                               kv_cache)

TOL = 2e-2
F32_TOL = 1e-4
SCAN_TOL = 1e-5
NAME = "xlstm-1.3b"
B, S, MAX_LEN = 2, 24, 64


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


def _models(cut=False):
    jcfg = jall_configs()[NAME].smoke()
    cfg = get_config(NAME).smoke()
    if cut:
        jcfg, cfg = (dataclasses.replace(c, n_layers=2,
                                         pattern=("mlstm", "slstm"))
                     for c in (jcfg, cfg))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, 128, (B, S)).astype(
        np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, toks=toks,
                engine=Engine(cfg, tp, max_len=MAX_LEN),
                ref=ReferenceEngine(cfg, tp, max_len=MAX_LEN))


@pytest.fixture(scope="module")
def smoke():
    return _models()


@pytest.fixture(scope="module")
def cut():
    """Two layers, (mlstm, slstm): the bf16 model held end to end."""
    return _models(cut=True)


@pytest.fixture(params=["float32", "bfloat16"])
def model(request, monkeypatch, smoke, cut):
    """(the model, its tolerance): the smoke config in float32 compute,
    or the 2-layer cut in bfloat16."""
    if request.param == "float32":
        monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
        return smoke, F32_TOL
    return cut, TOL


@pytest.fixture
def f32(monkeypatch):
    """Both packages compute in float32 for one test (restored after)."""
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    return F32_TOL


def _prompt(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


def _repetitive(b, s):
    """Prompts with period-6 structure so n-gram lookup finds drafts."""
    period = np.arange(6, dtype=np.int32) + 7
    return np.tile(period[None], (b, -(-s // 6)))[:, :s]


def _block(m, i):
    """Layer ``i`` of the smoke model (one repeat): (kind, JAX params,
    port params)."""
    unit, _, _ = jlm._layout(m["jcfg"])
    kind = unit[i]
    return (kind, jax.tree.map(lambda a: a[0], m["jp"]["blocks"][i]),
            lm._rep(m["tp"]["blocks"][i], 0))


# ---------------------------------------------------------------------------
# layout and parameters
# ---------------------------------------------------------------------------

def test_layout_is_the_jax_layout():
    full = get_config(NAME)
    assert lm._layout(full) == jlm._layout(jall_configs()[NAME])
    assert lm._layout(full) == (("mlstm",) * 7 + ("slstm",), 6, ())


def test_init_params_shapes_match_jax(smoke):
    tp = lm.init_params(smoke["cfg"], torch.Generator().manual_seed(0),
                        "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), smoke["jp"]) == \
        torch.utils._pytree.tree_map(lambda a: tuple(a.shape), tp)
    assert "ffn" not in tp["blocks"][0] and "ffn" not in tp["blocks"][7]
    assert float(tp["blocks"][0]["mlstm"]["w_if"].abs().max()) <= 0.04 + 1e-6


# ---------------------------------------------------------------------------
# the mLSTM
# ---------------------------------------------------------------------------

def _scan_inputs(seed, b=2, h=3, s=32, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    gates = rng.standard_normal((2, b, h, s)).astype(np.float32) * 2
    log_f = np.log(1 / (1 + np.exp(-gates[0]))).astype(np.float32)
    log_i = np.log(1 / (1 + np.exp(-gates[1]))).astype(np.float32)
    return q, k, v, log_f, log_i


def _replay_recurrence(q, k, v, log_f, log_i):
    """The step recurrence in float64: C_t = f C + i k v^T, n_t = f n +
    i k, out_t = q C / max(|q . n|, 1)."""
    q, k, v, log_f, log_i = (a.astype(np.float64) for a in
                             (q, k, v, log_f, log_i))
    b, h, s, dh = q.shape
    C = np.zeros((b, h, dh, dh))
    n = np.zeros((b, h, dh))
    out = np.zeros_like(q)
    for t in range(s):
        f = np.exp(log_f[..., t])[..., None]
        i = np.exp(log_i[..., t])[..., None]
        C = f[..., None] * C + (i * k[:, :, t])[..., :, None] \
            * v[:, :, t, None, :]
        n = f * n + i * k[:, :, t]
        num = np.einsum("bhd,bhde->bhe", q[:, :, t], C)
        den = np.maximum(np.abs(np.einsum("bhd,bhd->bh", q[:, :, t], n)), 1)
        out[:, :, t] = num / den[..., None]
    return out, C, n


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunk_scan_matches_jax_and_the_recurrence(chunk):
    args = _scan_inputs(chunk)
    jout, (jC, jn) = jax.jit(jL._mlstm_chunk_scan, static_argnums=5)(
        *map(jnp.asarray, args), chunk)
    tout, (tC, tn) = layers._mlstm_chunk_scan(*map(torch.from_numpy, args),
                                              chunk)
    for j, t in ((jout, tout), (jC, tC), (jn, tn)):
        _close(j, t, tol=SCAN_TOL)
    rout, rC, rn = _replay_recurrence(*args)
    for r, t in ((rout, tout), (rC, tC), (rn, tn)):
        np.testing.assert_allclose(t.numpy(), r, rtol=F32_TOL,
                                   atol=F32_TOL * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_fwd_matches_jax_and_its_step_replay(smoke, f32, chunk):
    cfg, jcfg = smoke["cfg"], smoke["jcfg"]
    _, jp, tp = _block(smoke, 0)
    jp, tp = jp["mlstm"], tp["mlstm"]
    x = np.random.default_rng(chunk).standard_normal(
        (B, 32, cfg.d_model)).astype(np.float32)
    jy, jc = jax.jit(functools.partial(jL.mlstm_fwd, cfg=jcfg,
                                       with_cache=True, chunk=chunk))(
        jp, jnp.asarray(x))
    ty, tc = layers.mlstm_fwd(tp, torch.from_numpy(x), cfg, with_cache=True,
                              chunk=chunk)
    _close(jy, ty, tol=f32)
    _close_trees(jc, tc, tol=f32)
    cache = layers.init_mlstm_cache(cfg, B, "cpu")
    ys = []
    for t in range(x.shape[1]):
        y, cache = layers.mlstm_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                     cache, cfg)
        ys.append(y)
    _close(ty, torch.cat(ys, 1), tol=f32)
    _close_trees(tc, cache, tol=f32)


def test_mlstm_step_matches_jax(smoke, f32):
    cfg, jcfg = smoke["cfg"], smoke["jcfg"]
    _, jp, tp = _block(smoke, 3)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jc = jL.init_mlstm_cache(jcfg, B)
    jc = jax.tree.map(lambda a: a + 0.1 if a.dtype == jnp.float32 else a, jc)
    tc = convert.params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    jy, jn = jL.mlstm_step(jp["mlstm"], jnp.asarray(x), jc, jcfg)
    ty, tn = layers.mlstm_step(tp["mlstm"], torch.from_numpy(x), tc, cfg)
    _close(jy, ty, tol=f32)
    _close_trees(jn, tn, tol=f32)


def test_mlstm_keeps_jax_chunk_rule(smoke):
    """S a multiple of ``min(chunk, S)``, as JAX asserts: nothing pads."""
    _, _, tp = _block(smoke, 0)
    x = torch.zeros((1, 20, smoke["cfg"].d_model))
    with pytest.raises(AssertionError):
        layers.mlstm_fwd(tp["mlstm"], x, smoke["cfg"], chunk=8)
    assert layers.mlstm_fwd(tp["mlstm"], x, smoke["cfg"]).shape == x.shape


# ---------------------------------------------------------------------------
# the sLSTM
# ---------------------------------------------------------------------------

def test_slstm_cell_matches_jax_and_forgets_nothing_on_step_one(smoke, f32):
    cfg, jcfg = smoke["cfg"], smoke["jcfg"]
    _, jp, tp = _block(smoke, 7)
    rng = np.random.default_rng(6)
    x_pre = rng.standard_normal((B, 4 * cfg.d_model)).astype(np.float32)
    z = layers.init_slstm_cache(cfg, B, "cpu")
    z["c"] = z["c"] + 5.0                  # forgotten entirely at step one
    state = (z["c"], z["n"], z["h"], z["m"])
    jstate = tuple(jnp.asarray(t.numpy()) for t in state)
    jnew = jL._slstm_cell(jp["slstm"], jcfg, jnp.asarray(x_pre), jstate)
    tnew = layers._slstm_cell(tp["slstm"], cfg, torch.from_numpy(x_pre),
                              state)
    for j, t in zip(jnew, tnew):
        _close(j, t, tol=f32)
    zero = layers.init_slstm_cache(cfg, B, "cpu")
    fresh = layers._slstm_cell(tp["slstm"], cfg, torch.from_numpy(x_pre),
                               (zero["c"], zero["n"], zero["h"], zero["m"]))
    assert torch.equal(tnew[0], fresh[0])  # exp(f + m - m_new) == 0


def test_slstm_fwd_matches_jax_and_its_step_replay(smoke, f32):
    cfg, jcfg = smoke["cfg"], smoke["jcfg"]
    _, jp, tp = _block(smoke, 7)
    x = np.random.default_rng(7).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jy, jc = jL.slstm_fwd(jp["slstm"], jnp.asarray(x), jcfg,
                          with_cache=True)
    ty, tc = layers.slstm_fwd(tp["slstm"], torch.from_numpy(x), cfg,
                              with_cache=True)
    _close(jy, ty, tol=f32)
    _close_trees(jc, tc, tol=f32)
    cache = layers.init_slstm_cache(cfg, B, "cpu")
    ys = []
    for t in range(S):
        y, cache = layers.slstm_step(tp["slstm"],
                                     torch.from_numpy(x[:, t:t + 1]), cache,
                                     cfg)
        ys.append(y)
    _close(ty, torch.cat(ys, 1), tol=f32)
    _close_trees(tc, cache, tol=f32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_and_loss(model):
    m, tol = model
    jcfg, cfg, jp, tp, toks = (m[k] for k in
                               ("jcfg", "cfg", "jp", "tp", "toks"))
    jx, jaux = jax.jit(functools.partial(jlm.forward, cfg=jcfg,
                                         remat=False))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tx, taux = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(jx, tx, tol=tol)
    assert float(taux) == float(jaux) == 0.0
    for chunk in (7, 1024):
        jloss, _ = jax.jit(functools.partial(
            jlm.loss_fn, cfg=jcfg, remat=False, loss_chunk=chunk))(
            jp, batch={"tokens": jnp.asarray(toks)})
        tloss, _ = lm.loss_fn(tp, cfg, {"tokens": torch.from_numpy(toks)},
                              loss_chunk=chunk)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol)


def test_bf16_layers_and_loss(smoke):
    """The served dtype on the smoke model: every layer fed JAX's input to
    it (so no layer inherits another's rounding), and the loss."""
    jcfg, cfg, jp, tp, toks = (smoke[k] for k in
                               ("jcfg", "cfg", "jp", "tp", "toks"))
    x = jlm._embed(jp, jcfg, jnp.asarray(toks), {})
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    for i in range(cfg.n_layers):
        kind, jblk, tblk = _block(smoke, i)
        want, _, _ = jlm.block_fwd(jblk, x, kind, jcfg, jnp.asarray(pos))
        got, _, _ = lm.block_fwd(tblk, torch.tensor(_f(x)).bfloat16(),
                                 kind, cfg, torch.from_numpy(pos))
        assert got.dtype == torch.bfloat16
        _close(want, got)
        x = want
    jloss, _ = jax.jit(functools.partial(jlm.loss_fn, cfg=jcfg,
                                         remat=False))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tloss, _ = lm.loss_fn(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)


def _prefill_both(m, toks, max_len=MAX_LEN):
    jl, jc = jax.jit(functools.partial(jlm.prefill, cfg=m["jcfg"]),
                     static_argnames=("max_len",))(
        m["jp"], batch={"tokens": jnp.asarray(toks)}, max_len=max_len)
    tl, tc = lm.prefill(m["tp"], m["cfg"], {"tokens": torch.from_numpy(toks)},
                        max_len=max_len)
    return jl, jc, tl, tc


def test_prefill_caches_and_decode_step(smoke, f32):
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    toks = smoke["toks"]
    jl, jc, tl, tc = _prefill_both(smoke, toks)
    _close(jl, tl, cfg.vocab_size, tol=f32)
    _close_trees(jc, tc, tol=f32)
    jc = jkv.broadcast_lens(jc, B)
    tc = kv_cache.broadcast_lens(tc, B)
    assert tuple(tc["blocks"][0]["mlstm"]["len"].shape) == (1, B)
    nxt = _prompt(B, 3, seed=9)
    for t in range(3):
        pos = np.full((B,), S + t, np.int32)
        jl, jc = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg))(
            smoke["jp"], tokens_t=jnp.asarray(nxt[:, t:t + 1]), caches=jc,
            pos=jnp.asarray(pos))
        tl, tc = lm.decode_step(smoke["tp"], cfg,
                                torch.from_numpy(nxt[:, t:t + 1]), tc,
                                torch.from_numpy(pos))
        _close(jl, tl, cfg.vocab_size, tol=f32)
    _close_trees(jc, tc, tol=f32)


def test_prefill_then_decode_equals_longer_prefill(smoke, f32):
    """The recurrent states the prefill leaves carry on exactly as a
    longer prefill would."""
    cfg, tp = smoke["cfg"], smoke["tp"]
    toks = _prompt(B, 17, seed=4)
    full, _ = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _, c = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :16])},
                      max_len=20)
    c = kv_cache.broadcast_lens(c, B)
    step, _ = lm.decode_step(tp, cfg, torch.from_numpy(toks[:, 16:]), c,
                             torch.full((B,), 16, dtype=torch.int32))
    _close(full, step, cfg.vocab_size, tol=f32)


def test_decode_multi_and_rollback_match_jax(model):
    m, tol = model
    jcfg, cfg = m["jcfg"], m["cfg"]
    toks = m["toks"]
    _, jc, _, tc = _prefill_both(m, toks)
    jc, tc = jkv.broadcast_lens(jc, B), kv_cache.broadcast_lens(tc, B)
    seq = _prompt(B, 4, seed=11)
    pos = np.full((B,), S, np.int32)
    jlg, jc2, jsn = jax.jit(functools.partial(jlm.decode_multi, cfg=jcfg))(
        m["jp"], tokens=jnp.asarray(seq), caches=jc, pos=jnp.asarray(pos))
    tlg, tc2, tsn = lm.decode_multi(m["tp"], cfg, torch.from_numpy(seq),
                                    tc, torch.from_numpy(pos))
    _close(jlg, tlg, cfg.vocab_size, tol=tol)
    _close_trees(jsn, tsn, tol=tol)
    idx = np.array([1, 3], np.int32)
    jr = jlm.rollback_caches(jcfg, jc2, jsn, jnp.asarray(idx))
    tr = lm.rollback_caches(cfg, tc2, tsn, torch.from_numpy(idx))
    _close_trees(jr, tr, tol=tol)


def test_rollback_equals_replaying_the_accepted_steps(smoke):
    """Per row, the rolled-back ``C`` / ``n`` / ``c`` / ``n`` / ``h`` /
    ``m`` and ``len`` are exactly those of decoding only the accepted
    steps (the same ops, so bit for bit)."""
    cfg, tp = smoke["cfg"], smoke["tp"]
    toks = torch.from_numpy(smoke["toks"])
    seq = torch.from_numpy(_prompt(B, 4, seed=12))
    pos = torch.full((B,), S, dtype=torch.int32)

    def fresh():
        _, c = lm.prefill(tp, cfg, {"tokens": toks}, max_len=MAX_LEN)
        return kv_cache.broadcast_lens(c, B)

    _, c2, snaps = lm.decode_multi(tp, cfg, seq, fresh(), pos)
    idx = torch.tensor([0, 2])
    rolled = lm.rollback_caches(cfg, c2, snaps, idx)
    for row in range(B):
        c = fresh()
        for t in range(int(idx[row]) + 1):
            _, c = lm.decode_step(tp, cfg, seq[:, t:t + 1], c, pos + t)
        for want, got in zip(_flat(c), _flat(rolled)):
            bdim = 1 if want.ndim >= 2 else 0
            assert torch.equal(want.select(bdim, row), got.select(bdim, row))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_greedy_tokens_equal_jax_engine_and_the_oracle(smoke):
    """JAX's engine, the port's scan and speculative paths and its
    step-by-step oracle give the same greedy tokens."""
    toks = _repetitive(2, 18)
    jeng = JEngine(smoke["jcfg"], smoke["jp"], max_len=MAX_LEN)
    jout, _ = jeng.generate({"tokens": jnp.asarray(toks)},
                            JGenConfig(max_new_tokens=12))
    t = torch.from_numpy(toks)
    scan, _ = smoke["engine"].generate({"tokens": t},
                                       GenConfig(max_new_tokens=12))
    ref, _ = smoke["ref"].generate({"tokens": t},
                                   GenConfig(max_new_tokens=12))
    np.testing.assert_array_equal(scan.numpy(), np.asarray(jout))
    assert torch.equal(scan, ref)
    for backend in ("reference", "cuda"):
        eng = Engine(smoke["cfg"], smoke["tp"], max_len=MAX_LEN,
                     cpm_backend=backend)
        spec, stats = eng.generate({"tokens": t},
                                   GenConfig(max_new_tokens=12,
                                             ngram_spec=4))
        assert torch.equal(spec, scan), backend
        assert stats["rounds"] > 0


@pytest.mark.parametrize("b,draft_len", [(1, 4), (4, 6)])
def test_spec_matches_scan_on_random_prompts(smoke, b, draft_len):
    toks = torch.from_numpy(_prompt(b, 16, seed=b))
    base, _ = smoke["engine"].generate({"tokens": toks},
                                       GenConfig(max_new_tokens=14))
    spec, _ = smoke["engine"].generate(
        {"tokens": toks}, GenConfig(max_new_tokens=14, ngram_spec=draft_len))
    assert torch.equal(base, spec)


def test_pool_matches_solo_generate(smoke):
    """Six requests through a paged pool of 3 slots with page pressure:
    sessions park (their ``C``, ``n`` and sLSTM states lifted out) and
    restore; every drained sequence equals a solo generate."""
    eng = smoke["engine"]
    pool = eng.session_pool(slots=3, n_banks=1, chunk=3, page_size=8,
                            pages_per_bank=6)
    rng = np.random.default_rng(4)
    lens, budgets = [8, 20, 8, 12, 20, 8], [9, 12, 6, 8, 5, 14]
    prompts = [rng.integers(0, 128, s).astype(np.int32) for s in lens]
    sids = [pool.submit(p, b) for p, b in zip(prompts, budgets)]
    out = pool.drain()
    for sid, p, b in zip(sids, prompts, budgets):
        solo, _ = eng.generate({"tokens": torch.from_numpy(p)[None]},
                               GenConfig(max_new_tokens=b))
        np.testing.assert_array_equal(out[sid], solo[0].numpy())
    st = pool.stats()
    assert st["pages_free"] == pool.total_pages
    assert st["page_stalls"] > 0 and st["restores"] > 0


def test_pool_of_two_banks_drains_jax_lengths(smoke):
    """Three requests of 8, 12 and 16 prompt tokens (budget 6) through
    ``session_pool(slots=4, n_banks=2, chunk=4)`` drain 14, 18 and 22
    tokens each, as the JAX pool does, equal to solo generation."""
    eng = smoke["engine"]
    pool = eng.session_pool(slots=4, n_banks=2, chunk=4)
    prompts = [_prompt(1, n, seed=n)[0] for n in (8, 12, 16)]
    sids = [pool.submit(p, 6) for p in prompts]
    out = pool.drain()
    assert [len(out[s]) for s in sids] == [14, 18, 22]
    for sid, p in zip(sids, prompts):
        solo, _ = eng.generate({"tokens": torch.from_numpy(p)[None]},
                               GenConfig(max_new_tokens=6))
        np.testing.assert_array_equal(out[sid], solo[0].numpy())


def test_serve_cli_runs_xlstm_on_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", NAME,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "24",
         "--max-new", "8", "--spec", "3"],
        capture_output=True, text=True, timeout=120, env=env, cwd=root)
    assert out.returncode == 0, out.stderr
    assert "generated 16 tokens" in out.stdout
    assert "spec decode:" in out.stdout
