"""The port's MoE layer and MoE models against the JAX package, on the
smoke configs of granite-moe-1b-a400m (top 2 of 4 experts after
``smoke()``) and phi3.5-moe-42b-a6.6b, with parameters converted from
``lm.init_params(cfg, PRNGKey(0))``.

Held:
  * routing bit for bit on the same router probabilities: the
    comparable-memory mask, the expert ids (a stable sort, ties by
    expert index), the queue positions (an exact int32 prefix sum) and
    the drops past capacity, on random and on tied probabilities;
  * ``apply_moe`` on the same bf16 input, with drops: output within
    2e-2 relative and 2e-2 x max(1, max|y|) absolute (bf16 expert
    products summed in another order), the aux loss within 1e-5
    relative (float32 means);
  * the models in float32 compute (both packages' ``COMPUTE_DTYPE`` set
    to float32 for the test): ``forward``, ``prefill``, ``decode_step``,
    ``decode_multi`` logits and ``loss_fn`` within 1e-4 (relative, and
    of max(1, max|want|) absolute).  In bfloat16 a token whose k-th and
    (k+1)-th router probabilities lie within bf16's drift of each other
    can route to another expert in one package than in the other, so the
    bf16 models are held through the loss, a mean over every token,
    within 2e-2.
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
from repro.cpm.reference import comparable as jcomparable  # noqa: E402
from repro.distributed.sharding import compute_view as jview  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert, layers, lm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402

TOL = 2e-2
F32_TOL = 1e-4
NAMES = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
B, S, MAX_LEN = 2, 16, 24


def _f(a, vocab=None):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    return a if vocab is None else a[..., :vocab]


def _close(j, t, vocab=None, tol=TOL):
    """Within ``tol`` relative and ``tol`` x max(1, max|want|) absolute."""
    want = _f(j, vocab)
    np.testing.assert_allclose(_f(t, vocab), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    jcfg = jall_configs()[request.param].smoke()
    cfg = get_config(request.param).smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, 128, (B, S)).astype(
        np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, toks=toks)


@pytest.fixture
def f32(monkeypatch):
    """Both packages compute in float32 for one test (restored after)."""
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)


def _jax_route(probs, k: int, cap: int):
    """``repro.models.layers.apply_moe``'s routing lines, verbatim."""
    t, e = probs.shape
    mask = jcomparable.topk_mask(probs, k)
    eidx = jnp.argsort(jnp.where(mask, -probs, jnp.inf), axis=-1)[:, :k]
    ohk = jax.nn.one_hot(eidx, e, dtype=probs.dtype)
    oh = ohk.reshape(t * k, e).astype(jnp.int32)
    pos_flat = jax.lax.associative_scan(jnp.add, oh, axis=0) - 1
    pos = jnp.sum(pos_flat * oh, axis=-1).reshape(t, k)
    return mask, eidx, pos, pos < cap


@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("k,cap", [(2, 4), (3, 10), (8, 12)])
def test_routing_bit_for_bit(kind, k, cap):
    rng = np.random.default_rng(k * 10 + cap)
    t, e = 64, 32 if k == 8 else 8
    if kind == "random":
        probs = rng.dirichlet(np.ones(e), size=t).astype(np.float32)
    else:                       # few distinct values: ties everywhere
        probs = (rng.integers(0, 4, (t, e)) / 4.0).astype(np.float32)
    want = _jax_route(jnp.asarray(probs), k, cap)
    got = layers.moe_route(torch.from_numpy(probs), k, cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert got[1].dtype == torch.int64 and got[2].dtype == torch.int32
    assert not bool(got[3].all())                        # some drops


@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_apply_moe_matches_jax(model, cf):
    jcfg = dataclasses.replace(
        model["jcfg"], moe=dataclasses.replace(model["jcfg"].moe,
                                               capacity_factor=cf))
    cfg = dataclasses.replace(
        model["cfg"], moe=dataclasses.replace(model["cfg"].moe,
                                              capacity_factor=cf))
    pj = jview(jax.tree.map(lambda a: a[0],
                                    model["jp"]["blocks"][0]["ffn"]),
                       jnp.bfloat16)
    pt = layers.compute_view(lm._rep(model["tp"]["blocks"][0]["ffn"], 0))
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    yj, aj = jax.jit(functools.partial(jL.apply_moe, cfg=jcfg))(
        pj, jnp.asarray(x, jnp.bfloat16))
    yt, at = layers.apply_moe(pt, torch.from_numpy(x).to(torch.bfloat16),
                              cfg)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == (B, S,
                                                              cfg.d_model)
    _close(yj, yt)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    # the same route in both: from the port's probabilities
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(-1, cfg.d_model)
    probs = torch.softmax(xt.float() @ pt["router"].float(), -1)
    cap = max(int(cf * B * S * cfg.moe.top_k / cfg.moe.n_experts), 4)
    keep = layers.moe_route(probs, cfg.moe.top_k, cap)[3]
    assert bool(keep.all()) == (cf == 8.0)               # drops at cf 1


def test_forward_and_loss(model, f32):
    jcfg, cfg, jp, tp, toks = (model[k] for k in
                               ("jcfg", "cfg", "jp", "tp", "toks"))
    jx, jaux = jax.jit(functools.partial(jlm.forward, cfg=jcfg,
                                         remat=False))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tx, taux = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(jx, tx, tol=F32_TOL)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=F32_TOL)
    jloss, jm = jax.jit(functools.partial(jlm.loss_fn, cfg=jcfg, remat=False,
                                          loss_chunk=5))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tloss, tm = lm.loss_fn(tp, cfg, {"tokens": torch.from_numpy(toks)},
                           loss_chunk=5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=F32_TOL)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=F32_TOL)


def test_loss_in_bfloat16(model):
    jcfg, cfg, jp, tp, toks = (model[k] for k in
                               ("jcfg", "cfg", "jp", "tp", "toks"))
    jloss, _ = jax.jit(functools.partial(jlm.loss_fn, cfg=jcfg,
                                         remat=False))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tloss, _ = lm.loss_fn(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)


def test_prefill_decode_and_multi(model, f32):
    jcfg, cfg, jp, tp, toks = (model[k] for k in
                               ("jcfg", "cfg", "jp", "tp", "toks"))
    v = cfg.vocab_size
    jl, jc = jax.jit(functools.partial(jlm.prefill, cfg=jcfg),
                     static_argnames=("max_len",))(
        jp, batch={"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    tl, tc = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN)
    _close(jl, tl, v, tol=F32_TOL)
    _close(jc["blocks"][0]["attn"]["k"], tc["blocks"][0]["attn"]["k"],
           tol=F32_TOL)
    jc, tc = jkv.broadcast_lens(jc, B), kv_cache.broadcast_lens(tc, B)
    nxt = np.array([[5], [77]], np.int32)
    pos = np.array([S, S - 3], np.int32)
    jl, jc = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg))(
        jp, tokens_t=jnp.asarray(nxt), caches=jc, pos=jnp.asarray(pos))
    tl, tc = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
    _close(jl, tl, v, tol=F32_TOL)
    draft = np.random.default_rng(2).integers(0, 128, (B, 4)).astype(
        np.int32)
    jl, _, _ = jax.jit(functools.partial(jlm.decode_multi, cfg=jcfg))(
        jp, tokens=jnp.asarray(draft), caches=jc, pos=jnp.asarray(pos + 1))
    tl, _, _ = lm.decode_multi(tp, cfg, torch.from_numpy(draft), tc,
                               torch.from_numpy(pos + 1))
    assert tuple(tl.shape) == (B, 4, lm.padded_vocab(cfg))
    _close(jl, tl, v, tol=F32_TOL)


def test_init_params_shapes(model):
    tp = lm.init_params(model["cfg"], torch.Generator().manual_seed(0),
                        "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), model["jp"]) == \
        torch.utils._pytree.tree_map(lambda a: tuple(a.shape), tp)
    ffn = tp["blocks"][0]["ffn"]
    e = model["cfg"].moe.n_experts
    assert float(ffn["expert_in"].abs().max()) <= 2.0 / e ** 0.5 + 1e-6
    assert float(ffn["router"].abs().max()) <= 0.04 + 1e-6
