"""The paged session pool and the gateway under a "model" axis in the
port, on ("data", "model") meshes, against the unsharded port pool and
JAX's unsharded pool, on the CPU at the smoke configs.

Three gloo groups, one per mesh: (1, 2), (1, 4) and (2, 2)
(``make_host_mesh(model=m, device="cpu")`` over 2, 4 and 4 ranks, the
weights ``distribute_params`` under ``make_ctx(mesh, fsdp=False)``), each
rank a process meeting the others over a ``FileStore`` under
``tmp_path``; one process runs the unsharded port pool on the same
submissions, and one a config the JAX package's unsharded pool
(``reference`` banks).
All start together and are waited on with one deadline
(``test_torch_collectives.wait_all``).  Every model rank of a data group
runs the same pool on the same submissions; data rank ``d`` is given
submission set ``d``, and the unsharded runs drain both sets.

Five smoke configs, float32 compute: granite-8b (GQA), qwen2-vl-7b
(M-RoPE and biases, text path), recurrentgemma-9b (RG-LRU and 16-slot
rings, 1 KV head: split-KV at every size), granite-moe-1b-a400m (experts)
and xlstm-1.3b (mLSTM and sLSTM).  Their 2 KV heads split over a model
axis of 2 and split the slots of every page (split-KV) over 4.  Pages of
4 slots, chunks of 3 and a page file small enough that a page stall, a
park and a restore occur; the first session's single prompt token is
shorter than any rank's part of a page.

Held:
  * (a) drained greedy tokens equal on every model rank bit for bit, and
    equal to the unsharded port pool's and JAX's up to the first step
    whose top-2 logit gap (teacher forcing over the unsharded port's
    tokens) is within ``TIE`` of the step's largest logit;
  * (b) ``stats()`` counters equal the unsharded pool's exactly;
  * (c) after admission and a chunk, after a park and after the parked
    session's restore (other sessions having moved pages in between),
    each rank's block of every pool leaf, and of the parked host image,
    within 1e-4 of the leaf's largest value of the unsharded pool's
    block, the pool's global-attn leaves ``(n_pages + 1, KVH / m, 4,
    dh)`` where the axis divides the KV heads and ``(n_pages + 1, KVH,
    4 / m, dh)`` (split-KV) where it does not; seating a prefill,
    parking and restoring run no collective;
  * (d) a ``Gateway`` with LRU preemption under a burst: the unsharded
    gateway's tokens, parks and admission / finish steps per request,
    and its preemption counters;
  * (e) at temperature 1, each rank's generator seeded by its global
    rank, tokens equal on every model rank;
  * (f) ``bank_backend="cuda"`` on CPU tensors calls the ``gather_rows``,
    ``fused_stream`` and ``scatter_rows`` wrappers once a bank in a steady
    step and drains the reference banks' tokens;
  * (g) split-KV with a page the axis does not divide raises
    ``ValueError`` naming both numbers, and ``HttpFrontend`` refuses the
    axis citing ROADMAP Queue 1 item 5f.
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

#: shared by the test, the rank script and the unsharded scripts
CASES = r'''
import numpy as np

CONFIGS = ("granite-8b", "qwen2-vl-7b", "recurrentgemma-9b",
           "granite-moe-1b-a400m", "xlstm-1.3b")
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
MAX_LEN, PAGE = 24, 4
POOL = dict(slots=4, n_banks=2, chunk=3, page_size=PAGE, pages_per_bank=7)
#: (prompt length, budget) of the drained sessions
SESSIONS = ((1, 9), (6, 8), (7, 6), (5, 9), (6, 7), (3, 5))
GATEWAY = dict(slots=2, chunk=2, page_size=PAGE, pages_per_bank=8)
PREEMPT = dict(min_resident=1, min_remaining=1, max_parks=3)
#: (arrival tick, prompt length, budget) of the gateway's requests
ARRIVALS = ((0, 6, 12), (0, 7, 12), (2, 5, 3), (2, 5, 3), (3, 6, 3))
SAMPLED = ((4, 5), (6, 4), (2, 6))
#: (f)'s sessions: every slot seated, none finishing or stalling by the
#: steady step
STEADY = ((4, 12), (6, 12), (7, 12), (5, 12))
STAGES = ("admit", "park", "restore")
#: a page size the model axis does not divide, by its size
BAD_PAGE = {2: 3, 4: 6}
#: the pool counters of ``stats()`` held against the unsharded pool's
COUNTERS = ("decode_steps", "emitted", "submitted", "admits",
            "prefill_launches", "admit_batches", "preemptions",
            "page_stalls", "restores", "cancels", "pages_free",
            "bank_launches", "streams_packed")


def prompts(cfg, d, seed, lens):
    """Data rank ``d``'s seeded prompts of the given lengths."""
    rng = np.random.default_rng(1000 * d + seed)
    return [rng.integers(0, cfg.vocab_size, s).astype(np.int32)
            for s in lens]


def drain_scenario(pool, cfg, d, as_in, snap):
    """Submit ``SESSIONS``; one step (admission and a chunk), park the
    LRU victim, step until it is restored, drain.  ``snap(stage, pool,
    image)`` after each stage.  Returns ({sid: tokens}, parked sid)."""
    ps = prompts(cfg, d, 1, [s for s, _ in SESSIONS])
    for p, (_, b) in zip(ps, SESSIONS):
        pool.submit(as_in(p), b)
    pool.step()
    snap("admit", pool, None)
    victim = pool.victim_session().sid
    pool.park(victim)
    snap("park", pool, pool.table.get(victim).parked)
    while pool.table.get(victim).parked is not None:
        pool.step()
    snap("restore", pool, None)
    out = pool.drain()
    return {sid: np.asarray(t) for sid, t in out.items()}, victim


def replay(gw, cfg, d, as_in):
    """``ARRIVALS`` submitted when the gateway's tick count reaches them,
    ticked until done; returns the request ids in order."""
    ps = prompts(cfg, d, 2, [s for _, s, _ in ARRIVALS])
    rids, nxt = [], 0
    while nxt < len(ARRIVALS) or not all(gw.request(r).done for r in rids):
        while nxt < len(ARRIVALS) and ARRIVALS[nxt][0] <= gw.loop.ticks:
            b = ARRIVALS[nxt][2]
            rids.append(gw.submit(as_in(ps[nxt]), b, deadline_steps=3 * b))
            nxt += 1
        gw.tick()
    return rids
'''

PORT_COMMON = CASES + r'''
import pickle

import torch

from repro_torch.configs import get_config
from repro_torch.models import convert, layers
from repro_torch.serve import Engine, Gateway, GenConfig
from repro_torch.serve.gateway import PreemptConfig
from repro_torch.train._tree import leaves_with_path

layers.COMPUTE_DTYPE = torch.float32
# the pool's caches in float32 too (``init_caches``' default dtype is
# bound at import), so that (c) compares float32 values, not roundings
# of them to bfloat16
from repro_torch.models import lm
lm.init_caches.__defaults__ = (None, torch.float32, 0)
GW_KEYS = ("preemptions", "restores", "prefill_launches", "admits",
           "page_stalls", "slo_met", "slo_missed", "ticks",
           "preempt_denied", "decode_steps", "pages_free")
res = {}


def calls():
    """Collectives run so far, of every kind and axis."""
    from repro_torch.distributed import sharding as shd

    return sum(v["calls"] for v in shd.collective_counts().values())


def counting(fn, into):
    """``fn``, adding the collectives each call runs to ``into[0]``."""
    def call(*a, **k):
        before = calls()
        out = fn(*a, **k)
        into[0] += calls() - before
        return out
    return call


def tree_rec(prefix, tree):
    for path, x in leaves_with_path(tree):
        res[f"{prefix}{path}"] = x.detach().float().cpu().numpy().copy()


def run_config(name, params, d, seed):
    """Every scenario of config ``name`` on data set ``d``; ``seed``: the
    sampled scenario's generator seed."""
    cfg = get_config(name).smoke()
    eng = Engine(cfg, params, max_len=MAX_LEN)
    key = f"{name}|d{d}"

    def snap(stage, pool, image):
        tree_rec(f"{key}|{stage}|pool", pool.caches)
        if image is not None:
            tree_rec(f"{key}|{stage}|image", image.caches)

    pool = eng.session_pool(**POOL)
    # the collectives of seating (admission and restore) and parking, and
    # of the whole drain
    from repro_torch.serve import kv_cache
    seat, seat_fn = [0], kv_cache.seat_caches
    kv_cache.seat_caches = counting(seat_fn, seat)
    pool.park = counting(pool.park, seat)
    pool._restore_group = counting(pool._restore_group, seat)
    total = calls()
    try:
        toks, victim = drain_scenario(pool, cfg, d, lambda p: p, snap)
    finally:
        kv_cache.seat_caches = seat_fn
    res[f"{key}|collectives"] = np.asarray([seat[0], calls() - total])
    for sid, t in toks.items():
        res[f"{key}|drain|{sid}"] = t
    st = pool.stats()
    res[f"{key}|stats"] = np.asarray([st[k] for k in COUNTERS])
    gw = Gateway(eng, preempt=PreemptConfig(**PREEMPT), **GATEWAY)
    for i, rid in enumerate(replay(gw, cfg, d, lambda p: p)):
        r = gw.request(rid)
        res[f"{key}|gw|{i}"] = np.asarray(r.tokens)
        res[f"{key}|gw_steps|{i}"] = np.asarray(
            [r.first_admit_step, r.finish_step, r.parks])
    st = gw.stats()
    res[f"{key}|gw_stats"] = np.asarray([st[k] for k in GW_KEYS])
    pool = eng.session_pool(gen=GenConfig(temperature=1.0, top_k=8),
                            rng=torch.Generator().manual_seed(seed), **POOL)
    for p, (_, b) in zip(prompts(cfg, d, 3, [s for s, _ in SAMPLED]),
                         SAMPLED):
        pool.submit(p, b)
    for sid, t in pool.drain().items():
        res[f"{key}|sampled|{sid}"] = np.asarray(t)
    return eng


def cuda_banks(eng, cfg, d):
    """(f): a steady step of a cuda-bank pool, its row wrappers counted;
    the drained tokens of its 4 sessions."""
    from repro_torch.kernels import cpm_kernels

    pool = eng.session_pool(bank_backend="cuda",
                            **dict(POOL, pages_per_bank=12))
    ps = prompts(cfg, d, 4, [s for s, _ in STEADY])
    for p, (_, b) in zip(ps, STEADY):
        pool.submit(p, b)
    pool.step()
    calls = dict.fromkeys(("gather_rows", "fused_stream", "scatter_rows"), 0)
    inner = {n: getattr(cpm_kernels, n) for n in calls}

    def counted(n):
        def call(*a, **k):
            calls[n] += 1
            return inner[n](*a, **k)
        return call

    moves = ("admits", "restores", "preemptions", "active")
    before = {k: pool.stats()[k] for k in moves}
    for n in calls:
        setattr(cpm_kernels, n, counted(n))
    try:
        pool.step()
    finally:
        for n in calls:
            setattr(cpm_kernels, n, inner[n])
    res[f"cuda|d{d}|calls"] = np.asarray([calls[n] for n in sorted(calls)])
    res[f"cuda|d{d}|steady"] = np.asarray(
        before == {k: pool.stats()[k] for k in moves} and
        before["active"] == len(STEADY))
    for sid, t in pool.drain().items():
        res[f"cuda|d{d}|{sid}"] = np.asarray(t)


def ref_banks(eng, cfg, d):
    """(f)'s sessions drained on reference banks."""
    pool = eng.session_pool(**dict(POOL, pages_per_bank=12))
    ps = prompts(cfg, d, 4, [s for s, _ in STEADY])
    for p, (_, b) in zip(ps, STEADY):
        pool.submit(p, b)
    for sid, t in pool.drain().items():
        res[f"cuda|d{d}|{sid}"] = np.asarray(t)
'''

RANK_SCRIPT = PORT_COMMON + r'''
import dataclasses
import datetime
import sys

import torch.distributed as dist

rank, world, out, shared, tag = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out}/store",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))

from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.http import HttpFrontend

dp_n, m = MESHES[tag]
mesh = make_host_mesh(model=m, device="cpu")
ctx = sh.make_ctx(mesh, fsdp=False)
dr = sh.dp_rank(ctx)

with sh.use_sharding(ctx):
    for name in CONFIGS:
        with open(f"{shared}/params_{name}.pkl", "rb") as f:
            params = sh.distribute_params(
                convert.params_from_numpy(pickle.load(f), "cpu"), ctx)
        eng = run_config(name, params, dr, 100 + rank)
        cfg = eng.cfg
        if name == "granite-8b":
            cuda_banks(eng, cfg, dr)
            # (g): split-KV (one KV head) with a page the axis does not
            # divide; the wire front
            one = Engine(dataclasses.replace(cfg, n_kv_heads=1), params,
                         max_len=MAX_LEN)
            try:
                one.session_pool(slots=4, page_size=BAD_PAGE[m])
                res["raises|page"] = "no error"
            except ValueError as e:
                res["raises|page"] = str(e)
            try:
                HttpFrontend(Gateway(eng, slots=2))
                res["raises|http"] = "no error"
            except NotImplementedError as e:
                res["raises|http"] = str(e)

np.savez(f"{out}/rank{rank}.npz", **{k: np.asarray(v)
                                     for k, v in res.items()})
dist.barrier()
dist.destroy_process_group()
'''

PLAIN_SCRIPT = PORT_COMMON + r'''
import sys

out, shared = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
for name in CONFIGS:
    with open(f"{shared}/params_{name}.pkl", "rb") as f:
        params = convert.params_from_numpy(pickle.load(f), "cpu")
    for d in range(2):
        eng = run_config(name, params, d, 0)
        if name == "granite-8b":
            ref_banks(eng, eng.cfg, d)
np.savez(f"{out}/plain.npz", **res)
'''

JAX_SCRIPT = CASES + r'''
import pickle
import sys

out, shared, name = sys.argv[1], sys.argv[2], sys.argv[3]
import jax
import jax.numpy as jnp

from repro.configs import all_configs
from repro.models import layers as L
from repro.serve import Engine

from repro.models import lm

L.COMPUTE_DTYPE = jnp.float32
lm.init_caches.__defaults__ = (0, jnp.float32)     # as the port's pools
res = {}
cfg = all_configs()[name].smoke()
with open(f"{shared}/params_{name}.pkl", "rb") as f:
    params = jax.tree.map(jnp.asarray, pickle.load(f))
for d in range(2):
    eng = Engine(cfg, params, max_len=MAX_LEN)
    toks, _ = drain_scenario(eng.session_pool(**POOL), cfg, d,
                             jnp.asarray, lambda *a: None)
    for sid, t in toks.items():
        res[f"{name}|d{d}|drain|{sid}"] = t
np.savez(f"{out}/jax.npz", **res)
'''


def _scope() -> dict:
    scope: dict = {}
    exec(CASES, scope)
    return scope


_S = _scope()
CONFIGS, MESHES, STAGES = _S["CONFIGS"], _S["MESHES"], _S["STAGES"]
SESSIONS, ARRIVALS, SAMPLED = _S["SESSIONS"], _S["ARRIVALS"], _S["SAMPLED"]
PAGE = _S["PAGE"]
#: the top-2 logit gap, of the step's largest |logit|, that counts as a tie
TIE = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results by mesh tag (a list by rank), the unsharded
    port's under "plain", JAX's under "jax"; the JAX params of every
    config under "params"."""
    import jax

    from repro.configs import all_configs
    from repro.models import lm as jlm

    tmp = tmp_path_factory.mktemp("tp_pool")
    shared = tmp / "shared"
    shared.mkdir()
    params = {}
    for name in CONFIGS:
        jp = jlm.init_params(all_configs()[name].smoke(),
                             jax.random.PRNGKey(0))
        params[name] = jax.tree.map(np.asarray, jp)
        with open(shared / f"params_{name}.pkl", "wb") as f:
            pickle.dump(params[name], f)
    procs = start_script(PLAIN_SCRIPT, tmp / "plain", str(shared))
    for name in CONFIGS:                 # JAX compiles each pool's steps
        procs += start_script(JAX_SCRIPT, tmp / f"jax_{name}", str(shared),
                              name)
    for tag, (d, m) in MESHES.items():
        procs += start_ranks(RANK_SCRIPT, d * m, tmp / tag, str(shared), tag)
    wait_all(procs)
    out = {"jax": {k: v for name in CONFIGS
                   for k, v in load(tmp / f"jax_{name}" / "jax.npz").items()},
           "plain": load(tmp / "plain" / "plain.npz"), "params": params}
    for tag, (d, m) in MESHES.items():
        out[tag] = [load(tmp / tag / f"rank{r}.npz") for r in range(d * m)]
    return out


def attn_sites(cfg):
    from repro_torch.serve import kv_cache

    return kv_cache.attn_sites(cfg)


def _smoke_cfg(name):
    from repro_torch.configs import get_config

    return get_config(name).smoke()


def _gaps(name, params, seq, s: int) -> np.ndarray:
    """(len(seq) - s,) top-2 gaps of the unsharded port's float32 logits
    teacher-forced over one session's ``seq`` at its generated steps,
    each over the step's largest |logit|."""
    from repro_torch.models import convert, layers, lm

    cfg = _smoke_cfg(name)
    prev = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        p = convert.params_from_numpy(params, "cpu")
        with torch.no_grad():
            x, _ = lm.forward(p, cfg, {"tokens": torch.from_numpy(
                np.asarray(seq, np.int32))[None]}, remat=False)
            lg = lm._logits(p, cfg, x).float().numpy()[0]
    finally:
        layers.COMPUTE_DTYPE = prev
    lg = lg[s - 1:-1, :cfg.vocab_size]
    top = np.sort(lg, -1)
    return (top[:, -1] - top[:, -2]) / np.abs(lg).max(-1)


def _agree_up_to_a_tie(got, want, s: int, gaps) -> None:
    """``got`` equals ``want`` up to its first differing generated step,
    and a step at or before that one is a near-tie."""
    assert got.shape == want.shape and np.array_equal(got[:s], want[:s])
    diff = np.nonzero(got[s:] != want[s:])[0]
    if diff.size:
        assert gaps[:diff[0] + 1].min() <= TIE, (diff[0], gaps)


def _by_group(runs, tag):
    """[(data rank, [its model ranks' results])]."""
    _, m = MESHES[tag]
    ranks = runs[tag]
    return [(g, ranks[g * m:(g + 1) * m]) for g in range(len(ranks) // m)]


def _keys(res, prefix):
    return sorted(k for k in res if k.startswith(prefix))


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_drained_tokens_under_the_mesh(runs, name, tag):
    """(a): every model rank's drained tokens equal bit for bit; they
    equal the unsharded port pool's and JAX's up to a near-tie."""
    plain, jres = runs["plain"], runs["jax"]
    for d, group in _by_group(runs, tag):
        prefix = f"{name}|d{d}|drain|"
        keys = _keys(plain, prefix)
        assert len(keys) == len(SESSIONS)
        for ours in group:
            assert _keys(ours, prefix) == keys
            for k in keys:
                np.testing.assert_array_equal(ours[k], group[0][k])
        for k in keys:
            s = SESSIONS[int(k.rsplit("|", 1)[1])][0]
            gaps = _gaps(name, runs["params"][name], plain[k], s)
            _agree_up_to_a_tie(group[0][k], plain[k], s, gaps)
            _agree_up_to_a_tie(group[0][k], jres[k], s, gaps)


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_pool_counters_equal_the_unsharded_pools(runs, name, tag):
    """(b): ``stats()`` counters, on every rank, equal the unsharded
    pool's exactly (no rank counts another's work); the run parked,
    stalled on pages and restored."""
    plain = runs["plain"]
    for d, group in _by_group(runs, tag):
        want = plain[f"{name}|d{d}|stats"]
        for ours in group:
            np.testing.assert_array_equal(ours[f"{name}|d{d}|stats"], want)
    names = ("preemptions", "page_stalls", "restores")
    idx = [_S["COUNTERS"].index(n) for n in names]
    assert all(plain[f"{name}|d0|stats"][i] > 0 for i in idx), dict(
        zip(names, plain[f"{name}|d0|stats"][idx]))


def _err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _paged(cfg, key: str) -> bool:
    """Whether ``key`` is a global-attention K/V leaf (a page pool, or its
    logical rows in a parked image)."""
    import re

    hit = re.search(r"\['(blocks|tail)'\]\[(\d+)\]\['attn'\]\['[kv]'\]$",
                    key)
    if not hit:
        return False
    ub, ut = attn_sites(cfg)
    return int(hit[2]) in (ub if hit[1] == "blocks" else ut)


def _block(whole, got, m_rank: int, m: int, pages: bool = False):
    """The rank's block of ``whole``: its part of the one dim where the
    shapes differ by the factor ``m`` (every dim the same: all of it);
    with ``pages``, logical rows of pages of ``PAGE`` slots on that dim,
    the rank's ``PAGE / m`` slots of every page."""
    dims = [i for i, (w, g) in enumerate(zip(whole.shape, got.shape))
            if w != g]
    assert len(dims) <= 1 and whole.ndim == got.ndim, (whole.shape,
                                                       got.shape)
    if not dims:
        return whole
    d = dims[0]
    n = got.shape[d]
    assert whole.shape[d] == n * m, (whole.shape, got.shape, m)
    if pages:
        q = PAGE // m
        i = np.arange(n)
        return np.take(whole, (i // q) * PAGE + m_rank * q + i % q, axis=d)
    return np.take(whole, range(m_rank * n, (m_rank + 1) * n), axis=d)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_pool_blocks_match_the_unsharded_pool(runs, name, tag, stage):
    """(c): after the stage each rank's block of every pool leaf (and of
    the parked image) within 1e-4 of the leaf's largest value of its
    block of the unsharded pool's; the global-attn page pools in the
    layout's shape.  Seating (admission and restore) and parking ran no
    collective, while the drain ran many."""
    cfg = _smoke_cfg(name)
    _, m = MESHES[tag]
    plain = runs["plain"]
    heads = cfg.n_kv_heads % m == 0
    for d, group in _by_group(runs, tag):
        for ours in group:
            seat, drain = ours[f"{name}|d{d}|collectives"]
            assert seat == 0 and drain > 0, (seat, drain)
        prefix = f"{name}|d{d}|{stage}|"
        keys = _keys(plain, prefix)
        assert keys
        pages = 0
        for m_rank, ours in enumerate(group):
            assert _keys(ours, prefix) == keys
            for k in keys:
                got, whole = ours[k], plain[k]
                if "|pool" in k and "['attn']" in k and \
                        k.endswith(("['k']", "['v']")) and \
                        whole.shape[-2] == PAGE:
                    pages += 1
                    kvh, dh = cfg.n_kv_heads, cfg.dh
                    want_shape = whole.shape[:-3] + (
                        (kvh // m, PAGE, dh) if heads
                        else (kvh, PAGE // m, dh))
                    assert got.shape == want_shape, (k, got.shape)
                want = _block(whole, got, m_rank, m, pages=not heads and
                              "|image" in k and _paged(cfg, k))
                assert _err(got, want) <= 1e-4, (k, m_rank, _err(got, want))
        if any(attn_sites(cfg)):
            assert pages


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_gateway_with_preemption_under_the_mesh(runs, name, tag):
    """(d): the gateway's tokens, parks and admission / finish steps per
    request and its counters equal the unsharded gateway's, and the
    burst preempted."""
    plain = runs["plain"]
    for d, group in _by_group(runs, tag):
        for ours in group:
            for i, (_, s, _) in enumerate(ARRIVALS):
                k = f"{name}|d{d}|gw|{i}"
                np.testing.assert_array_equal(ours[k], group[0][k])
                gaps = _gaps(name, runs["params"][name], plain[k], s)
                _agree_up_to_a_tie(ours[k], plain[k], s, gaps)
                np.testing.assert_array_equal(
                    ours[f"{name}|d{d}|gw_steps|{i}"],
                    plain[f"{name}|d{d}|gw_steps|{i}"])
            np.testing.assert_array_equal(ours[f"{name}|d{d}|gw_stats"],
                                          plain[f"{name}|d{d}|gw_stats"])
    assert plain[f"{name}|d0|gw_stats"][0] > 0      # preemptions


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_sampled_tokens_agree_across_model_ranks(runs, name, tag):
    """(e): at temperature 1 (top-k 8), each rank drawing from a
    generator seeded by its global rank, every model rank of a data
    group holds the same tokens (model rank 0's draws)."""
    for d, group in _by_group(runs, tag):
        keys = _keys(group[0], f"{name}|d{d}|sampled|")
        assert len(keys) == len(SAMPLED)
        for ours in group:
            for k in keys:
                np.testing.assert_array_equal(ours[k], group[0][k])
        lens = [len(group[0][k]) for k in keys]
        assert lens == [s + b for s, b in SAMPLED]


@pytest.mark.parametrize("tag", MESHES)
def test_cuda_banks_call_each_row_wrapper_once_a_bank(runs, tag):
    """(f): on ``cuda`` banks (the wrappers' plain twins for CPU
    tensors), one steady step calls ``fused_stream``, ``gather_rows`` and
    ``scatter_rows`` once a bank on every rank, and the drained tokens
    are the reference banks' of the unsharded pool."""
    plain = runs["plain"]
    for d, group in _by_group(runs, tag):
        for ours in group:
            assert bool(ours[f"cuda|d{d}|steady"])
            np.testing.assert_array_equal(ours[f"cuda|d{d}|calls"],
                                          [2, 2, 2])
            keys = _keys(plain, f"cuda|d{d}|")
            keys = [k for k in keys if k.rsplit("|", 1)[1].isdigit()]
            assert len(keys) == 4
            for k in keys:
                s = _S["STEADY"][int(k.rsplit("|", 1)[1])][0]
                gaps = _gaps("granite-8b", runs["params"]["granite-8b"],
                             plain[k], s)
                _agree_up_to_a_tie(ours[k], plain[k], s, gaps)


@pytest.mark.parametrize("what", ["page", "http"])
@pytest.mark.parametrize("tag", MESHES)
def test_refusals_under_the_mesh(runs, tag, what):
    """(g): a split-KV pool whose page the model axis does not divide
    raises ``ValueError`` naming both; the HTTP front refuses the axis,
    citing ROADMAP Queue 1 item 5f."""
    _, m = MESHES[tag]
    for ours in runs[tag]:
        msg = str(ours[f"raises|{what}"])
        if what == "page":
            assert f"page_size ({_S['BAD_PAGE'][m]})" in msg, msg
            assert f"model axis ({m})" in msg, msg
        else:
            assert "ROADMAP Queue 1 item 5f" in msg, msg
            assert f"model axis of size {m}" in msg, msg
