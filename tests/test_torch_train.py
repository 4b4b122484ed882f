"""Training in the port (``repro_torch.train``, ``launch/train.py``)
against the JAX package's on the CPU, at the smoke configs: the
synthetic token stream, AdamW (schedule, clipping, the update and its
decay mask), one train step's loss and gradients for six configs, five
steps' losses, microbatches, remat, checkpoints written by either
package and restored by the other, the atomic commit, the fault-tolerant
restart and the CLI.

Tolerances:
  * the token stream, the decay mask, checkpoints and every bit-for-bit
    case (remat on or off, 6 straight steps against 3 + restart + 3) are
    exact;
  * ``apply_updates`` 1e-6 relative (and 1e-6 of the leaf's largest
    value absolute, for moments that cancel to near 0): the same float32
    operations in the same order, which XLA may contract or round an ulp
    apart (``pow``, division by a scalar);
  * one step's gradients within 1e-4 of each leaf's largest value in
    float32 compute (both packages' ``COMPUTE_DTYPE`` set to float32: the
    algorithm, summation order apart); in bf16, each leaf's relative L2
    distance from JAX's float32 gradient at most 1.5 times JAX's own bf16
    gradient's, plus 2e-3 (``test_step_gradients_match_jax`` says why);
    the loss within 1e-4 / 2e-2 relative;
  * five steps' losses 1e-4 relative in float32;
  * microbatch equivalence and "loss decreases" as JAX's own tests pin
    them (``tests/test_train.py``).
"""

from __future__ import annotations

import functools
import json
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
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import all_configs, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, layers, lm  # noqa: E402
from repro_torch.train import (OptConfig, checkpoint, data,  # noqa: E402
                               fault_tolerance as ft, init_opt_state,
                               make_eval_step, make_train_step, optimizer)
from repro_torch.train._tree import leaves_with_path  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SHAPE = type("S", (), {"seq_len": 32, "global_batch": 8})()
GRAD_CONFIGS = ["granite-8b", "granite-moe-1b-a400m", "recurrentgemma-9b",
                "xlstm-1.3b", "seamless-m4t-large-v2", "qwen2-vl-7b"]


def _f(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jleaves(tree) -> list:
    return [(jax.tree_util.keystr(p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _models(name):
    jcfg = jall_configs()[name].smoke()
    cfg = get_config(name).smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp


def _tparams(jp):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(params=["float32", "bfloat16"])
def dt(request, monkeypatch):
    """The compute dtype of both packages for one test (float32 set by
    monkeypatching their ``COMPUTE_DTYPE``, restored after)."""
    if request.param == "float32":
        monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    return request.param


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2)])
def test_synthetic_tokens_equal_jax(index, count):
    cfg = get_config("granite-8b").smoke()
    kw = dict(seed=3, process_index=index, process_count=count)
    ours = data.make_pipeline(cfg, SHAPE, **kw)
    ref = jdata.make_pipeline(jall_configs()["granite-8b"].smoke(), SHAPE,
                              **kw)
    for _ in range(5):
        a, b = next(ours)["tokens"], next(ref)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert ours.state() == ref.state() == {"step": 5, "seed": 3}


def test_synthetic_tokens_resume_from_state():
    cfg = get_config("granite-8b").smoke()
    pipe = data.make_pipeline(cfg, SHAPE, seed=1)
    for _ in range(3):
        next(pipe)
    again = data.make_pipeline(cfg, SHAPE)
    again.restore(json.loads(json.dumps(pipe.state())))
    ref = jdata.make_pipeline(jall_configs()["granite-8b"].smoke(), SHAPE,
                              seed=1)
    for _ in range(3):
        next(ref)
    for _ in range(2):
        want = next(ref)["tokens"]
        np.testing.assert_array_equal(next(again)["tokens"], want)
        np.testing.assert_array_equal(next(pipe)["tokens"], want)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _close_rel(got, want, tol):
    got, want = _f(got), _f(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


@pytest.mark.parametrize("name", sorted(all_configs()))
def test_paths_and_decay_mask_match_jax(name):
    """Every config's smoke params: the port's leaf paths are JAX's
    ``keystr`` paths in JAX's order, and the decay mask picks the same
    leaves."""
    _, _, jp = _models(name)
    tp = _tparams(jp)
    paths = [p for p, _ in leaves_with_path(tp)]
    assert paths == [p for p, _ in _jleaves(jp)]
    mask = [optimizer._decay_mask(p) for p in paths]
    assert mask == [jopt._decay_mask(p) for p in paths]
    assert any(mask) and not all(mask)


@pytest.mark.parametrize("name", ["granite-8b", "recurrentgemma-9b",
                                  "xlstm-1.3b"])
def test_apply_updates_match_jax(name):
    """Two AdamW steps on a config's smoke params with random gradients:
    params, moments and metrics within 1e-6 relative of JAX's."""
    _, _, jp = _models(name)
    tp = _tparams(jp)
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    japply = jax.jit(jopt.apply_updates, static_argnums=3)
    jocfg = jopt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(7)
    jstate, tstate = jopt.init_opt_state(jp), init_opt_state(tp)
    for _ in range(2):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), jp)
        jp, jstate, jm = japply(jp, jax.tree.map(jnp.asarray, g), jstate,
                                jocfg)
        tp, tstate, tm = optimizer.apply_updates(
            tp, convert.params_from_numpy(g, "cpu"), tstate, ocfg)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    assert tstate["step"].dtype == torch.int32
    for key in ("lr", "grad_norm"):
        _close_rel(tm[key], jm[key], 1e-6)
    for tree_t, tree_j in ((tp, jp), (tstate["mu"], jstate["mu"]),
                           (tstate["nu"], jstate["nu"])):
        for (_, a), (_, b) in zip(leaves_with_path(tree_t),
                                  _jleaves(tree_j)):
            _close_rel(a, b, 1e-6)


def test_schedule_and_clip_match_jax():
    ocfg = OptConfig(lr=3e-4, warmup_steps=5, total_steps=40,
                     min_lr_frac=0.2)
    jocfg = jopt.OptConfig(lr=3e-4, warmup_steps=5, total_steps=40,
                           min_lr_frac=0.2)
    steps = np.arange(0, 45, dtype=np.int32)
    _close_rel(optimizer.schedule(ocfg, torch.from_numpy(steps)),
               jopt.schedule(jocfg, jnp.asarray(steps)), 1e-6)
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((5, 7)).astype(np.float32) * 3,
         "b": [rng.standard_normal((11,)).astype(np.float32)]}
    for max_norm in (0.5, 1.0, 1e3):
        tc, tn = optimizer.clip_by_global_norm(
            convert.params_from_numpy(g, "cpu"), max_norm)
        jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        _close_rel(tn, jn, 1e-6)
        for (_, a), (_, b) in zip(leaves_with_path(tc), _jleaves(jc)):
            _close_rel(a, b, 1e-6)


def test_optimizer_adamw_math():
    """``tests/test_train.py``'s case: the first step moves every param by
    the step-1 learning rate."""
    params = {"w": torch.ones((2, 2)), "norm": {"scale": torch.ones((2,))}}
    grads = lm.tree_map(torch.ones_like, params)
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=10, weight_decay=0.0,
                    clip_norm=100.0)
    p2, s2, _ = optimizer.apply_updates(params, grads, state, cfg)
    lr1 = float(optimizer.schedule(cfg, torch.tensor(1)))
    np.testing.assert_allclose(p2["w"].numpy(), 1 - lr1, rtol=1e-4)
    assert int(s2["step"]) == 1


def test_grad_clip():
    g = {"w": torch.full((10,), 100.0)}
    clipped, _ = optimizer.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(optimizer.global_norm(clipped)), 1.0,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# one step's gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _grad_batch(name, cfg):
    """(numpy batch, microbatches): 4 sequences of 16 tokens in 2
    microbatches; seamless adds 12 source frames, qwen2-vl 3-axis
    positions with a patch grid."""
    rng = np.random.default_rng(11)
    b, s = 4, 16
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.enc_dec:
        batch["src_embeds"] = rng.standard_normal(
            (b, 12, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[1, :, 2:6] = 2 + np.arange(4) // 2
        pos[2, :, 2:6] = 2 + np.arange(4) % 2
        pos[:, 1] += 1              # rows differ: the split must keep them
        batch["pos_ids"] = pos
    return batch, 2


def _jax_step_grads(jcfg, jp, batch, k, chunk):
    """JAX's train step's gradient half: ``jax.value_and_grad`` of
    ``lm.loss_fn`` over its ``k`` microbatches (split as its scan splits
    them: ``pos_ids`` on axis 1), averaged."""
    f = jax.jit(jax.value_and_grad(
        lambda p, mb: jlm.loss_fn(p, jcfg, mb, remat=False,
                                  loss_chunk=chunk), has_aux=True))
    b = batch["tokens"].shape[0] // k
    loss, grads = 0.0, None
    for i in range(k):
        mb = {key: jnp.asarray(v[:, i * b:(i + 1) * b] if key == "pos_ids"
                               else v[i * b:(i + 1) * b])
              for key, v in batch.items()}
        (l, _), g = f(jp, mb)
        loss = loss + l
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return loss / k, jax.tree.map(lambda g: g / k, grads)


@functools.lru_cache(maxsize=None)
def _jax_grads(name: str, dtype: str):
    """(loss, [(path, gradient)]) of JAX's step on ``_grad_batch``, its
    ``COMPUTE_DTYPE`` set to ``dtype`` for the call."""
    jcfg, cfg, jp = _models(name)
    batch, k = _grad_batch(name, cfg)
    saved = jL.COMPUTE_DTYPE
    jL.COMPUTE_DTYPE = getattr(jnp, dtype)
    try:
        loss, grads = _jax_step_grads(jcfg, jp, batch, k, 8)
    finally:
        jL.COMPUTE_DTYPE = saved
    return float(loss), [(p, _f(g)) for p, g in _jleaves(grads)]


def _err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _rl2(got, want) -> float:
    """Relative L2 distance, ||got - want|| / ||want||."""
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)


def _port_grads(name):
    """(loss, metrics, grads) of the port's step on ``_grad_batch``: 2
    microbatches, remat."""
    _, cfg, jp = _models(name)
    batch, k = _grad_batch(name, cfg)
    return loss_and_grads(
        _tparams(jp), cfg, {key: torch.from_numpy(v)
                            for key, v in batch.items()},
        num_microbatches=k, remat=True, loss_chunk=8)


def _bf16_outside(name, tgrads):
    """The port's bf16 gradient leaves outside the bound: relative L2
    distance from JAX's float32 gradient above 1.5 times JAX's own bf16
    gradient's, plus 2e-3, as (path, port's, JAX's).  Also the largest
    distances (JAX's, port's, and the port's over JAX's) and JAX's
    largest max-based error (its value, its leaf)."""
    jgrads = _jax_grads(name, "bfloat16")[1]
    truth = _jax_grads(name, "float32")[1]
    outside, worst, max_err = [], [0.0, 0.0, 0.0], (0.0, "")
    for (path, a), (_, b), (_, t) in zip(leaves_with_path(tgrads), jgrads,
                                         truth):
        ours, ref = _rl2(_f(a), t), _rl2(b, t)
        if ours > 1.5 * ref + 2e-3:
            outside.append((path, ours, ref))
        worst = [max(worst[0], ref), max(worst[1], ours),
                 max(worst[2], ours / max(ref, 1e-30))]
        max_err = max(max_err, (_err(b, t), path))
    return outside, worst, max_err


@pytest.mark.parametrize("name", GRAD_CONFIGS)
def test_step_gradients_match_jax(name, dt):
    """The port's step gradients (``loss_and_grads``, 2 microbatches,
    remat) against JAX's.  float32: every leaf within 1e-4 of its largest
    value.

    bf16: JAX's own bf16 gradients are not within 2e-2 of its float32
    ones here: up to 0.267 of the leaf's largest value in seamless
    (``['encoder']['blocks']['ffn']['w_in']``, largest |value| 4.4e-3;
    ``['emb']``'s is 6.6e-2), 0.143 in xlstm (``['blocks'][1]['mlstm']
    ['w_if']``, 1.6e-2), 2.4% in granite.  In seamless the cause is the
    ReLU gates that bf16 rounding flips
    (``test_seamless_bf16_gap_is_flipped_relu_gates``); in xlstm it is
    not pinned down.  The two stacks flip different gates, so the
    max-based error of one against the other says little; each leaf is
    held by its relative L2 distance from JAX's float32 gradient, at most
    1.5 times JAX's own bf16 gradient's plus 2e-3 (``_bf16_outside``).
    Measured: at most 1.28 times; the largest distances 0.089 (port) and
    0.082 (JAX), xlstm's ``w_if``.  A backward 5% off in one place fails
    it (``test_bf16_bound_catches_a_scaled_dq``)."""
    tloss, metrics, tgrads = _port_grads(name)
    jloss, jgrads = _jax_grads(name, dt)
    np.testing.assert_allclose(float(tloss), jloss, rtol=GRAD_TOL[dt])
    assert set(metrics) == {"ce", "aux"}
    got = leaves_with_path(tgrads)
    assert [p for p, _ in got] == [p for p, _ in jgrads]
    for (path, a), (_, b) in zip(got, jgrads):
        assert a.dtype == torch.float32 and a.shape == b.shape, path
        if dt == "float32":
            assert _err(_f(a), b) <= GRAD_TOL[dt], (path, _err(_f(a), b))
    if dt == "bfloat16":       # the print shown by ``pytest -s``
        outside, worst, max_err = _bf16_outside(name, tgrads)
        assert not outside, outside
        print(f"{name} bf16 gradients, largest leaf relative L2 distance "
              f"from JAX's float32 gradient: JAX {worst[0]:.3e}, port "
              f"{worst[1]:.3e}, port over JAX at most {worst[2]:.3f}; JAX's "
              f"largest max-based error {max_err[0]:.3e} ({max_err[1]})")


def test_bf16_bound_catches_a_scaled_dq(monkeypatch):
    """The bf16 bound's reach: granite-8b's step with attention's dq
    scaled by 1.05 in the backward (the forward unchanged) puts an
    attention weight's gradient outside it."""

    class ScaledGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g * 1.05

    attention = ops.attention
    monkeypatch.setattr(ops, "attention", lambda q, k, v, *a, **kw:
                        attention(ScaledGrad.apply(q), k, v, *a, **kw))
    outside, _, _ = _bf16_outside("granite-8b", _port_grads("granite-8b")[2])
    assert any("['attn']" in path for path, _, _ in outside), outside


def test_seamless_bf16_gap_is_flipped_relu_gates(monkeypatch):
    """Why seamless's bf16 gradients sit far from float32: the port's
    float32 and bf16 steps on ``_grad_batch``, the ReLU inputs and the
    gradients at its outputs recorded.  Some pre-activations change sign
    in bf16, and the gradient change that the flipped gates alone make
    (float32 values, bf16's gates) in the encoder's ``ffn.w_in`` is at
    least 0.9 of that leaf's whole bf16 error (max-based: 0.258 of
    0.261)."""
    name, leaf = "seamless-m4t-large-v2", "['encoder']['blocks']['ffn']['w_in']"
    _, cfg, jp = _models(name)
    batch, k = _grad_batch(name, cfg)
    relu, apply_ffn = torch.nn.functional.relu, layers.apply_ffn

    def run(dtype):
        calls = []

        def ffn(p, x, c):
            calls.append({"x": x.detach().float()})
            return apply_ffn(p, x, c)

        def gate(x):
            y = relu(x)
            entry = calls[-1]
            entry["pre"] = x.detach().float()
            y.register_hook(lambda g: entry.__setitem__("g", g.float()))
            return y

        monkeypatch.setattr(layers, "COMPUTE_DTYPE", dtype)
        monkeypatch.setattr(layers, "apply_ffn", ffn)
        monkeypatch.setattr(torch.nn.functional, "relu", gate)
        _, _, grads = loss_and_grads(
            _tparams(jp), cfg, {key: torch.from_numpy(v)
                                for key, v in batch.items()},
            num_microbatches=k, remat=False, loss_chunk=8)
        return calls, dict(leaves_with_path(grads))[leaf]

    f32, want = run(torch.float32)
    bf16, got = run(torch.bfloat16)
    assert len(f32) == len(bf16)
    src = batch["src_embeds"].shape[1]
    delta, flips, n_enc = torch.zeros_like(want), 0, want.shape[0]
    for i, (a, b) in enumerate(c for c in zip(f32, bf16)
                               if c[0]["x"].shape[1] == src):
        moved = (b["pre"] > 0).float() - (a["pre"] > 0).float()
        flips += int(moved.abs().sum())
        delta[i % n_enc] += torch.einsum("bsd,bsf->df", a["x"],
                                         a["g"] * moved) / k
    scale = float(want.abs().max())
    whole = float((got - want).abs().max()) / scale
    by_flips = float(delta.abs().max()) / scale
    print(f"seamless bf16, {leaf}: {flips} ReLU gates flipped in the "
          f"encoder; error {whole:.3f} of the largest value, the flips "
          f"alone {by_flips:.3f}")                  # shown by ``pytest -s``
    assert flips > 0 and by_flips >= 0.9 * whole


def test_remat_gives_the_same_gradients_bit_for_bit():
    for name in ("granite-8b", "recurrentgemma-9b"):
        _, cfg, jp = _models(name)
        batch, _ = _grad_batch(name, cfg)
        tb = {key: torch.from_numpy(v) for key, v in batch.items()}
        outs = [loss_and_grads(_tparams(jp), cfg, tb, remat=r, loss_chunk=8)
                for r in (True, False)]
        assert torch.equal(outs[0][0], outs[1][0])
        for (_, a), (_, b) in zip(leaves_with_path(outs[0][2]),
                                  leaves_with_path(outs[1][2])):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def test_five_steps_match_jax(f32):
    """``make_train_step(..., num_microbatches=2, remat=True,
    loss_chunk=16)`` of both packages from the same params over the same
    token stream: every step's loss, lr and grad norm within 1e-4
    relative.  (The params themselves are not held to 1e-4: Adam divides
    by the root of the second moment, so a leaf's tiny gradients give
    updates of ~lr whatever their rounding.)"""
    jcfg, cfg, jp = _models("granite-8b")
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.OptConfig(**ocfg),
                                        num_microbatches=2, remat=True,
                                        loss_chunk=16))
    tstep = make_train_step(cfg, OptConfig(**ocfg), num_microbatches=2,
                            remat=True, loss_chunk=16)
    tp = _tparams(jp)
    tstate = init_opt_state(tp)
    jstate = jopt.init_opt_state(jp)
    pipe = data.make_pipeline(cfg, SHAPE)
    for _ in range(5):
        batch = next(pipe)
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tstate, tm = tstep(tp, tstate, batch)
        assert set(tm) == {"loss", "ce", "aux", "lr", "grad_norm"}
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4)


def _state(cfg, seed=0):
    from repro_torch.launch.train import init_state
    return init_state(cfg, "cpu", seed)


def test_loss_decreases():
    """``tests/test_train.py``'s ``trained`` run: 30 steps, 2
    microbatches, remat."""
    cfg = get_config("granite-8b").smoke()
    step = make_train_step(cfg, OptConfig(lr=3e-3, warmup_steps=5,
                                          total_steps=60),
                           num_microbatches=2, remat=True, loss_chunk=16)
    pipe = data.make_pipeline(cfg, SHAPE)
    state, losses = _state(cfg), []
    for _ in range(30):
        state["params"], state["opt"], m = step(state["params"],
                                                state["opt"], next(pipe))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    # the step leaves the params as it found them: no autograd when served
    assert not any(p.requires_grad or p.grad is not None
                   for _, p in leaves_with_path(state["params"]))


def test_microbatch_equivalence():
    """Gradient accumulation over 4 microbatches == one batch of 8 (as
    ``tests/test_train.py`` pins it)."""
    cfg = get_config("granite-8b").smoke()
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = {"tokens": np.random.default_rng(7).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)}
    outs = []
    for k in (1, 4):
        st = _state(cfg, 1)
        p, _, m = make_train_step(cfg, ocfg, num_microbatches=k,
                                  loss_chunk=16)(st["params"], st["opt"],
                                                 batch)
        outs.append((p, m))
    np.testing.assert_allclose(float(outs[0][1]["loss"]),
                               float(outs[1][1]["loss"]), rtol=2e-3)
    for (_, a), (_, b) in zip(leaves_with_path(outs[0][0]),
                              leaves_with_path(outs[1][0])):
        np.testing.assert_allclose(_f(a), _f(b), atol=2e-3, rtol=2e-2)


def test_eval_step_matches_jax():
    jcfg, cfg, jp = _models("granite-8b")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    want = jax.jit(jts.make_eval_step(jcfg, loss_chunk=8))(
        jp, {"tokens": jnp.asarray(toks)})
    got = make_eval_step(cfg, loss_chunk=8)(_tparams(jp), {"tokens": toks})
    assert set(got) == set(want) == {"loss", "ce", "aux"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# checkpoints and restarts
# ---------------------------------------------------------------------------

def _trained_jax_state():
    """A JAX train state after one update (moments nonzero), as host
    arrays in its pytree."""
    jcfg, _, jp = _models("recurrentgemma-9b")
    jstate = jopt.init_opt_state(jp)
    g = jax.tree.map(lambda x: jnp.full(x.shape, 0.5, x.dtype), jp)
    jp, jstate, _ = jopt.apply_updates(jp, g, jstate, jopt.OptConfig())
    return jax.tree.map(np.asarray, {"params": jp, "opt": jstate})


def _files(d: Path) -> dict:
    return {f.name: f.read_bytes() for f in sorted(d.iterdir())}


def test_checkpoints_cross_packages_bit_for_bit(tmp_path):
    """A checkpoint JAX writes restores in the port and the port's in JAX,
    leaf for leaf; the same state written by both gives the same files
    (every ``.npy`` and ``manifest.json``) byte for byte."""
    host = _trained_jax_state()
    ours = convert.params_from_numpy(host, "cpu")
    extra = {"data": {"step": 3, "seed": 0}}
    jckpt.save(str(tmp_path / "jax"), 7, host, extra=extra)
    checkpoint.save(str(tmp_path / "port"), 7, ours, extra=extra,
                    async_=True).join()
    jdir, tdir = tmp_path / "jax" / "step_00000007", \
        tmp_path / "port" / "step_00000007"
    assert _files(jdir) == _files(tdir)
    like = lm.tree_map(lambda t: torch.empty_like(t, device="meta"), ours)
    got, got_extra = checkpoint.restore(str(tmp_path / "jax"), 7, like,
                                        device="cpu")
    assert got_extra == extra
    for (pa, a), (pb, b) in zip(leaves_with_path(got), _jleaves(host)):
        assert pa == pb and a.dtype == ours_dtype(ours, pa)
        np.testing.assert_array_equal(a.numpy(), b)
    jlike = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         host)
    back, _ = jckpt.restore(str(tmp_path / "port"), 7, jlike)
    for (_, a), (_, b) in zip(_jleaves(back), leaves_with_path(ours)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def ours_dtype(tree, path):
    return dict(leaves_with_path(tree))[path].dtype


def test_checkpoint_atomic_no_partial(tmp_path):
    """A ``.tmp`` directory (a crash mid-write) is never picked up."""
    checkpoint.save(str(tmp_path), 1, {"x": torch.ones((4,))})
    os.makedirs(tmp_path / "step_00000002.tmp", exist_ok=True)
    assert checkpoint.latest_step(str(tmp_path)) == 1
    checkpoint.gc_old(str(tmp_path), keep=1)
    assert checkpoint.latest_step(str(tmp_path)) == 1


def test_fault_tolerant_restart_identical(tmp_path):
    """6 steps straight against 3 steps + checkpoint + crash + restore
    (into tensors built from a meta-device skeleton) + 3 steps: the final
    params equal bit for bit, the data pipeline's state included."""
    cfg = get_config("granite-8b").smoke()
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=0,
                                          total_steps=20), loss_chunk=16)

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    shape = type("S", (), {"seq_len": 32, "global_batch": 4})()
    pipe = data.make_pipeline(cfg, shape)
    state = _state(cfg, 5)
    for _ in range(6):
        state, _ = step_fn(state, next(pipe))
    ref = [p.detach().clone() for _, p in leaves_with_path(state["params"])]

    fcfg = ft.FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=3)
    pipe = data.make_pipeline(cfg, shape)
    state, hb = ft.run_loop(fcfg, _state(cfg, 5), step_fn, pipe, 0, 3)
    assert hb.straggler_steps == []
    del state, pipe                                      # the crash
    from repro_torch.launch.train import init_state
    state, extra, start = ft.resume_or_init(
        fcfg, lambda: _state(cfg, 5), like=init_state(cfg, "meta"),
        device="cpu")
    assert start == 3 and extra["data"]["step"] == 3
    assert state["opt"]["step"].dtype == torch.int32
    pipe = data.make_pipeline(cfg, shape)
    pipe.restore(extra["data"])
    state, _ = ft.run_loop(fcfg, state, step_fn, pipe, start, 6)
    for (_, a), b in zip(leaves_with_path(state["params"]), ref):
        assert torch.equal(a, b)


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-8b", "--smoke", "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=cwd)


def test_cli_trains_then_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    first = _cli("--steps", "4", "--ckpt-dir", ck, "--log-every", "2",
                 cwd=tmp_path)
    assert first.returncode == 0, first.stderr
    assert "step 4 loss" in first.stderr
    assert "done: 4 steps (from 0)" in first.stderr
    assert checkpoint.latest_step(ck) == 4
    second = _cli("--steps", "8", "--ckpt-dir", ck, cwd=tmp_path)
    assert second.returncode == 0, second.stderr
    assert "restored checkpoint step 4" in second.stderr
    assert "done: 8 steps (from 4)" in second.stderr
    assert checkpoint.latest_step(ck) == 8


def test_cli_refuses_the_production_meshes():
    """In a group of one (the CLI starts a gloo group of one), the
    production meshes exit naming the 256 or 512 ranks they need."""
    from repro_torch.launch import train as cli
    for mesh, ranks in (("production", 256), ("production-multi", 512)):
        with pytest.raises(SystemExit, match=f"group of {ranks} ranks"):
            cli.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                      "--mesh", mesh])
