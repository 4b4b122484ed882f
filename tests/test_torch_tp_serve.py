"""Serving under a "model" axis in the port, on ("data", "model") meshes,
against JAX's serving cells under the same mesh, on the CPU at the smoke
configs.

Three gloo groups, one per mesh: (1, 2), (1, 4) and (2, 2)
(``make_host_mesh(model=m, device="cpu")`` over 2, 4 and 4 ranks, the
weights ``distribute_params`` under ``make_ctx(mesh, fsdp=False)``, as
JAX's dry run stores serving weights), each rank a process meeting the
others over a ``FileStore`` under ``tmp_path``; one JAX subprocess a mesh
on 4 host devices with an Auto-typed mesh of the same shape, jitting
``lm.prefill``, ``lm.decode_step``, ``lm.decode_multi`` and
``lm.rollback_caches`` with ``repro.launch.dryrun``'s shardings (the
params by ``param_specs``, the batch by ``_batch_spec``, caches and logits
by ``_cache_spec``); one more JAX subprocess runs JAX's unsharded
``Engine.generate``.  All start together and are waited on with one
deadline (``test_torch_collectives.wait_all``).

The six families' smoke configs: granite-8b (GQA), qwen2-vl-7b (M-RoPE
and biases), recurrentgemma-9b (RG-LRU and a 16-slot ring under a
20-token prompt), granite-moe-1b-a400m (experts), xlstm-1.3b (mLSTM and
sLSTM) and seamless-m4t-large-v2 (cross attention).  With 2 KV heads
(1 for recurrentgemma) the (1, 4) mesh, and recurrentgemma's (1, 2),
split the slots of the caches (split-KV); the others split the heads.

Held (float32 compute):
  * every rank's block of the logits and of every cache leaf (after the
    prefill, three decode steps, a ``decode_multi`` of 4 tokens and a
    rollback) within 1e-4 of the leaf's largest value of JAX's, the
    block being the rank's batch rows and its part of the dim JAX's spec
    puts on "model"; and its shape JAX's ``shard_shape``.  Where JAX's
    rules keep the data axes off the batch dim (at (2, 2): the lengths,
    rule (), replicated; the sLSTM's ``h``, ("b", "width") right-aligned
    on (B, H, dh), on its heads) a data rank holds its rows instead, and
    the other dims are JAX's block;
  * ``Engine.generate`` (scan, and speculative with draft 4) under the
    mesh: tokens equal on every model rank bit for bit, and equal to the
    unsharded port's and JAX's up to the first step whose top-2 logit gap
    (teacher forcing over the reference's tokens) is within ``TIE`` of
    the step's largest logit;
  * ``Engine.generate`` sampled at temperature 1, each rank's generator
    seeded differently: tokens equal on every model rank bit for bit.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

torch.set_num_threads(2)

from test_torch_collectives import (load, start_ranks, start_script,  # noqa: E402
                                    wait_all)

#: shared by the test, the rank script and the JAX scripts
CASES = r'''
import numpy as np

CONFIGS = ("granite-8b", "qwen2-vl-7b", "recurrentgemma-9b",
           "granite-moe-1b-a400m", "xlstm-1.3b", "seamless-m4t-large-v2")
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
B, S, MAX, STEPS, T, ENC = 4, 20, 32, 3, 4, 16
NEW, DRAFT, ENGINE_LEN = 8, 4, 34


def batch_of(cfg):
    """The prefill batch: tokens, an encoder's frames, M-RoPE positions."""
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.enc_dec:
        out["src_embeds"] = rng.standard_normal(
            (B, ENC, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections is not None:
        t = np.arange(S, dtype=np.int32)
        out["pos_ids"] = np.stack([np.broadcast_to(a, (B, S)) for a in
                                   (t, t // 2, t % 5)]).astype(np.int32)
    return out


def decode_inputs(cfg):
    """STEPS single tokens, a T-token draft and the rollback's steps."""
    rng = np.random.default_rng(2)
    return (rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            np.array([0, 3, 1, 2], np.int32))


def engine_batch(cfg):
    """Periodic prompts (drafts get accepted), an encoder's frames."""
    rng = np.random.default_rng(3)
    period = rng.integers(0, cfg.vocab_size, (B, 5)).astype(np.int32)
    out = {"tokens": np.tile(period, (1, 4))}
    if cfg.enc_dec:
        out["src_embeds"] = rng.standard_normal(
            (B, ENC, cfg.d_model)).astype(np.float32)
    return out
'''

RANK_SCRIPT = CASES + r'''
import datetime
import pickle
import sys

import torch
import torch.distributed as dist

rank, world, out, shared, tag = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out}/store",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, layers, lm
from repro_torch.serve import Engine, GenConfig, kv_cache
from repro_torch.train._tree import leaves_with_path

layers.COMPUTE_DTYPE = torch.float32
dp_n, m = MESHES[tag]
mesh = make_host_mesh(model=m, device="cpu")
ctx = sh.make_ctx(mesh, fsdp=False)
dp, dr = sh.dp_size(ctx), sh.dp_rank(ctx)
b = B // dp
res = {}


def rows(batch):
    return {k: torch.from_numpy(v[:, dr * b:(dr + 1) * b] if k == "pos_ids"
                                else v[dr * b:(dr + 1) * b])
            for k, v in batch.items()}


def record(prefix, tree):
    for path, x in leaves_with_path(tree):
        res[f"{prefix}{path}"] = x.detach().float().numpy().copy()


with sh.use_sharding(ctx):
    for name in CONFIGS:
        cfg = get_config(name).smoke()
        with open(f"{shared}/params_{name}.pkl", "rb") as f:
            params = sh.distribute_params(
                convert.params_from_numpy(pickle.load(f), "cpu"), ctx)
        batch = rows(batch_of(cfg))
        lens = {"max_len": MAX,
                "cross_len": ENC if cfg.enc_dec else None}
        logits, caches = lm.prefill(params, cfg, batch, max_len=MAX)
        res[f"{name}|prefill|logits"] = logits.float().numpy()
        record(f"{name}|prefill|caches", caches)
        caches = kv_cache.broadcast_lens(caches, b)
        steps, draft, idx = decode_inputs(cfg)
        pos = torch.full((b,), S, dtype=torch.int32)
        for t in range(STEPS):
            tok = torch.from_numpy(steps[t, dr * b:(dr + 1) * b])
            logits, caches = lm.decode_step(params, cfg, tok, caches, pos,
                                            **lens)
            res[f"{name}|dec{t}|logits"] = logits.float().numpy()
            pos = pos + 1
        record(f"{name}|dec|caches", caches)
        logits, caches, snaps = lm.decode_multi(
            params, cfg, torch.from_numpy(draft[dr * b:(dr + 1) * b]),
            caches, pos, **lens)
        res[f"{name}|multi|logits"] = logits.float().numpy()
        record(f"{name}|multi|caches", caches)
        caches = lm.rollback_caches(cfg, caches, snaps,
                                    torch.from_numpy(idx[dr * b:(dr + 1) * b]))
        record(f"{name}|rollback|caches", caches)

        eng = Engine(cfg, params, max_len=ENGINE_LEN)
        eb = rows(engine_batch(cfg))
        for kind, spec in (("scan", 0), ("spec", DRAFT)):
            toks, _ = eng.generate(eb, GenConfig(max_new_tokens=NEW,
                                                 ngram_spec=spec))
            res[f"{name}|engine|{kind}"] = toks.numpy()
        # sampled: each rank's own generator, seeded by its global rank
        toks, _ = eng.generate(
            eb, GenConfig(max_new_tokens=NEW, temperature=1.0),
            generator=torch.Generator().manual_seed(rank))
        res[f"{name}|engine|sampled"] = toks.numpy()

np.savez(f"{out}/rank{rank}.npz", **{k: np.asarray(v)
                                     for k, v in res.items()})
dist.barrier()
dist.destroy_process_group()
'''

JAX_SCRIPT = CASES + r'''
import os
import pickle
import sys

out, shared, tag = sys.argv[1], sys.argv[2], sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding

devs = np.asarray(jax.devices()[:4])        # 4 host devices, before the
from repro.launch.dryrun import (_batch_spec, _cache_spec,   # dry run's
                                 _tree_shardings)          # import asks 512
from repro.configs import all_configs
from repro.distributed import sharding as sh
from repro.models import layers as L, lm
from repro.serve import kv_cache

L.COMPUTE_DTYPE = jnp.float32
res, specs = {}, {}
shape = MESHES[tag]
mesh = Mesh(devs[:shape[0] * shape[1]].reshape(shape), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
ctx = sh.make_ctx(mesh, fsdp=False)
sh.set_sharding_ctx(ctx)


def keep(prefix, tree):
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = f"{prefix}{jax.tree_util.keystr(path)}"
        res[key] = np.asarray(jnp.asarray(x, jnp.float32))
        specs[key] = (tuple(x.sharding.spec),
                      tuple(x.sharding.shard_shape(x.shape)))


def bsh(tree):
    return _tree_shardings(tree, _batch_spec, ctx, mesh)


def csh(tree):
    return _tree_shardings(tree, _cache_spec, ctx, mesh)


def lsh(x):
    return NamedSharding(mesh, _cache_spec("logits", x.shape, ctx))


for name in CONFIGS:
    cfg = all_configs()[name].smoke()
    with open(f"{shared}/params_{name}.pkl", "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    psh = sh.named_shardings(sh.param_specs(params, ctx), mesh)
    batch = {k: jnp.asarray(v) for k, v in batch_of(cfg).items()}
    step = lambda p, bt: lm.prefill(p, cfg, bt, max_len=MAX)
    lg0, c0 = jax.eval_shape(step, params, batch)
    logits, caches = jax.jit(step, in_shardings=(psh, bsh(batch)),
                             out_shardings=(lsh(lg0), csh(c0)))(params,
                                                                batch)
    keep(f"{name}|prefill|logits", logits)
    keep(f"{name}|prefill|caches", caches)
    caches = kv_cache.broadcast_lens(caches, B)
    cs = csh(caches)
    steps, draft, idx = decode_inputs(cfg)
    pos = jnp.full((B,), S, jnp.int32)
    one = lambda p, t, c, q: lm.decode_step(p, cfg, t, c, q)
    lg1 = jax.eval_shape(one, params, jnp.asarray(steps[0]), caches, pos)[0]
    dec = jax.jit(one, in_shardings=(psh, bsh(jnp.asarray(steps[0])), cs,
                                     bsh(pos)),
                  out_shardings=(lsh(lg1), cs))
    for t in range(STEPS):
        logits, caches = dec(params, jnp.asarray(steps[t]), caches, pos)
        keep(f"{name}|dec{t}|logits", logits)
        pos = pos + 1
    keep(f"{name}|dec|caches", caches)
    multi = lambda p, t, c, q: lm.decode_multi(p, cfg, t, c, q)
    lgm, _, sn = jax.eval_shape(multi, params, jnp.asarray(draft), caches,
                                pos)
    logits, caches, snaps = jax.jit(
        multi, in_shardings=(psh, bsh(jnp.asarray(draft)), cs, bsh(pos)),
        out_shardings=(lsh(lgm), cs, csh(sn)))(params, jnp.asarray(draft),
                                                caches, pos)
    keep(f"{name}|multi|logits", logits)
    keep(f"{name}|multi|caches", caches)
    back = lambda c, s_, i: lm.rollback_caches(cfg, c, s_, i)
    caches = jax.jit(back, in_shardings=(cs, csh(sn), bsh(jnp.asarray(idx))),
                     out_shardings=cs)(caches, snaps, jnp.asarray(idx))
    keep(f"{name}|rollback|caches", caches)
np.savez(f"{out}/jax.npz", **res)
with open(f"{out}/specs.pkl", "wb") as f:
    pickle.dump(specs, f)
'''

JAX_ENGINE_SCRIPT = CASES + r'''
import pickle
import sys

out, shared = sys.argv[1], sys.argv[2]
import jax
import jax.numpy as jnp

from repro.configs import all_configs
from repro.models import layers as L
from repro.serve import Engine, GenConfig

L.COMPUTE_DTYPE = jnp.float32
res = {}
for name in CONFIGS:
    cfg = all_configs()[name].smoke()
    with open(f"{shared}/params_{name}.pkl", "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    eng = Engine(cfg, params, max_len=ENGINE_LEN, cpm_backend="reference")
    batch = {k: jnp.asarray(v) for k, v in engine_batch(cfg).items()}
    for kind, spec in (("scan", 0), ("spec", DRAFT)):
        toks, _ = eng.generate(batch, GenConfig(max_new_tokens=NEW,
                                                ngram_spec=spec))
        res[f"{name}|{kind}"] = np.asarray(toks)
np.savez(f"{out}/jax.npz", **res)
'''


def _scope() -> dict:
    scope: dict = {}
    exec(CASES, scope)
    return scope


_S = _scope()
CONFIGS, MESHES = _S["CONFIGS"], _S["MESHES"]
B, S, NEW, ENGINE_LEN = _S["B"], _S["S"], _S["NEW"], _S["ENGINE_LEN"]
STAGES = ("prefill", "dec", "multi", "rollback")
#: the top-2 logit gap, of the step's largest |logit|, that counts as a tie
TIE = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results by mesh tag (a list by rank), JAX's by tag and
    JAX's engine tokens under "engine"; the JAX params of every config."""
    import jax

    from repro.configs import all_configs
    from repro.models import lm as jlm

    tmp = tmp_path_factory.mktemp("tp_serve")
    shared = tmp / "shared"
    shared.mkdir()
    params = {}
    for name in CONFIGS:
        jp = jlm.init_params(all_configs()[name].smoke(),
                             jax.random.PRNGKey(0))
        params[name] = jax.tree.map(np.asarray, jp)
        with open(shared / f"params_{name}.pkl", "wb") as f:
            pickle.dump(params[name], f)
    procs = start_script(JAX_ENGINE_SCRIPT, tmp / "jax_engine", str(shared))
    for tag, (d, m) in MESHES.items():
        procs += start_script(JAX_SCRIPT, tmp / f"jax{tag}", str(shared),
                              tag)
        procs += start_ranks(RANK_SCRIPT, d * m, tmp / tag, str(shared), tag)
    wait_all(procs)
    out = {"engine": load(tmp / "jax_engine" / "jax.npz"), "params": params}
    for tag, (d, m) in MESHES.items():
        with open(tmp / f"jax{tag}" / "specs.pkl", "rb") as f:
            out[f"jax{tag}"] = (load(tmp / f"jax{tag}" / "jax.npz"),
                                pickle.load(f))
        out[tag] = [load(tmp / tag / f"rank{r}.npz") for r in range(d * m)]
    return out


def _names(entry) -> tuple:
    """The mesh axes a spec entry names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _batch_dim(key: str, ndim: int):
    """The batch dim of a result leaf, or None (a length before
    ``broadcast_lens``)."""
    if key.endswith("logits"):
        return 0
    stacked = "['blocks']" in key
    if key.endswith("['len']") and ndim < (2 if stacked else 1):
        return None
    return 1 if stacked else 0


def _expected_block(want, spec, key: str, d_rank: int, m_rank: int,
                    dp: int, m: int):
    """The rank's block of JAX's whole ``want``: its batch rows, and its
    part of the dim ``spec`` puts on "model"."""
    bd = _batch_dim(key, want.ndim)
    if bd is not None and dp > 1:
        n = want.shape[bd] // dp
        want = np.take(want, range(d_rank * n, (d_rank + 1) * n), axis=bd)
    full = tuple(spec) + (None,) * (want.ndim - len(spec))
    for d, e in enumerate(full):
        if "model" in _names(e):
            n = want.shape[d] // m
            want = np.take(want, range(m_rank * n, (m_rank + 1) * n), axis=d)
    return want


def _err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_serving_blocks_match_jax_under_the_same_mesh(runs, name, tag,
                                                      stage):
    """Each rank's block of every logits and cache leaf of the stage, for
    the config on the mesh, within 1e-4 of JAX's (of the leaf's largest
    value), its shape JAX's ``shard_shape`` (module docstring)."""
    jres, jspecs = runs[f"jax{tag}"]
    dp, m = MESHES[tag]
    keys = sorted(k for k in jres if k.split("|")[0] == name
                  and k.split("|")[1].startswith(stage))
    assert keys
    split = set()
    for r, ours in enumerate(runs[tag]):
        d_rank, m_rank = divmod(r, m)
        assert set(keys) <= set(ours), sorted(set(keys) - set(ours))
        for key in keys:
            spec, shard_shape = jspecs[key]
            got = ours[key]
            want = _expected_block(jres[key], spec, key, d_rank, m_rank, dp,
                                   m)
            assert got.shape == want.shape, (key, got.shape, want.shape)
            full = tuple(spec) + (None,) * (got.ndim - len(spec))
            bd = _batch_dim(key, got.ndim)
            if dp == 1 or (bd is not None and "data" in _names(full[bd])):
                assert got.shape == shard_shape, (key, got.shape,
                                                  shard_shape)
            else:
                # JAX's rule keeps the data axes off the batch dim: the
                # rank holds its rows, and JAX's block of every other dim
                # the data axes do not split
                assert all(g == w for i, (g, w, e) in enumerate(
                    zip(got.shape, shard_shape, full))
                    if i != bd and "data" not in _names(e)), (
                        key, got.shape, shard_shape)
            if any("model" in _names(e) for e in spec) and m > 1:
                split.add(key)
            assert _err(got, want) <= 1e-4, (key, r, _err(got, want))
    if m > 1:
        assert split, "no leaf split over the model axis"


def _smoke_cfg(name):
    from repro_torch.configs import get_config

    return get_config(name).smoke()


def _teacher_gaps(name, params, batch, seq) -> np.ndarray:
    """(B, NEW) top-2 gaps of the unsharded port's float32 logits at each
    generated step, teacher-forced over ``seq``, each over the step's
    largest |logit|."""
    from repro_torch.models import convert, layers, lm

    cfg = _smoke_cfg(name)
    prev = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        p = convert.params_from_numpy(params, "cpu")
        full = {k: torch.from_numpy(v) for k, v in batch.items()}
        full["tokens"] = torch.from_numpy(seq)
        with torch.no_grad():
            x, _ = lm.forward(p, cfg, full, remat=False)
            lg = lm._logits(p, cfg, x).float().numpy()
    finally:
        layers.COMPUTE_DTYPE = prev
    lg = lg[:, S - 1:-1, :cfg.vocab_size]
    top = np.sort(lg, -1)
    return (top[..., -1] - top[..., -2]) / np.abs(lg).max(-1)


def _plain_engine(name, params, batch, spec: int) -> np.ndarray:
    from repro_torch.models import convert, layers
    from repro_torch.serve import Engine, GenConfig

    prev = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        eng = Engine(_smoke_cfg(name), convert.params_from_numpy(params,
                                                                 "cpu"),
                     max_len=ENGINE_LEN)
        toks, _ = eng.generate({k: torch.from_numpy(v)
                                for k, v in batch.items()},
                               GenConfig(max_new_tokens=NEW,
                                         ngram_spec=spec))
    finally:
        layers.COMPUTE_DTYPE = prev
    return toks.numpy()


def _agree_up_to_a_tie(got, want, gaps) -> None:
    """``got`` equals ``want`` in every row up to its first differing step,
    and a step at or before that one is a near-tie."""
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r, S:] != want[r, S:])[0]
        if diff.size:
            assert gaps[r, :diff[0] + 1].min() <= TIE, (r, diff[0],
                                                        gaps[r])


@pytest.mark.parametrize("kind", ["scan", "spec"])
@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_engine_tokens_under_the_mesh(runs, name, tag, kind):
    """``Engine.generate`` under the mesh: every model rank's tokens equal
    bit for bit; the rows put together equal the unsharded port's and
    JAX's ``Engine.generate`` up to the first near-tie step."""
    _, m = MESHES[tag]
    ranks = runs[tag]
    key = f"{name}|engine|{kind}"
    for r, ours in enumerate(ranks):
        np.testing.assert_array_equal(ours[key], ranks[r - r % m][key])
    got = np.concatenate([ranks[r][key] for r in range(0, len(ranks), m)])
    assert got.shape == (B, S + NEW)
    batch = _S["engine_batch"](_smoke_cfg(name))
    np.testing.assert_array_equal(got[:, :S], batch["tokens"])
    plain = _plain_engine(name, runs["params"][name], batch,
                          _S["DRAFT"] if kind == "spec" else 0)
    gaps = _teacher_gaps(name, runs["params"][name], batch, plain)
    _agree_up_to_a_tie(got, plain, gaps)
    _agree_up_to_a_tie(got, runs["engine"][f"{name}|{kind}"], gaps)


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_sampled_tokens_agree_across_model_ranks(runs, name, tag):
    """``Engine.generate`` at temperature 1 under the mesh, each rank
    drawing from a generator seeded by its global rank: every model rank
    of a data group holds the same tokens bit for bit (model rank 0's
    draws), its prompt rows unchanged."""
    _, m = MESHES[tag]
    ranks = runs[tag]
    key = f"{name}|engine|sampled"
    batch = _S["engine_batch"](_smoke_cfg(name))
    b = B * m // len(ranks)
    for r, ours in enumerate(ranks):
        np.testing.assert_array_equal(ours[key], ranks[r - r % m][key])
        d = r // m
        np.testing.assert_array_equal(ours[key][:, :S],
                                      batch["tokens"][d * b:(d + 1) * b])
