"""The port's paged session pool against the JAX package's, and against
the port's own solo ``Engine.generate``.

Both packages run ``granite-8b``'s smoke config on the same weights
(converted with ``models/convert.py``) and the same seeded NumPy
submissions; the JAX pool uses ``reference`` banks.  Held here, on the
CPU:

  * drained greedy tokens: the port pool equals the port's solo
    ``Engine.generate`` of each prompt and the JAX pool, token for token;
  * exactly, the pool counters of ``stats()`` (admits, prefill launches,
    preemptions, page stalls, restores, cancels, decode steps, ...);
  * whole-row and paged layouts, ``chunk`` 1 and 3, page pressure,
    explicit park / restore and cancel;
  * a ``bank_backend="cuda"`` pool on CPU tensors (the row kernels' and
    ``fused_stream``'s plain twins) equals a ``reference`` pool;
  * the decode chunk reads nothing back to the host between its gather
    and its scatter.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference; the GPU machine has no JAX
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro.serve import Engine as JEngine
except ImportError:
    jax = None

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.cpm import tuning  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import Engine, Gateway, GenConfig  # noqa: E402

MAX_LEN = 64
#: counters of ``stats()`` that must agree between the two packages
COUNTERS = ("decode_steps", "emitted", "submitted", "admits",
            "prefill_launches", "admit_batches", "preemptions",
            "page_stalls", "restores", "cancels", "pages_free",
            "bank_launches", "streams_packed")


@pytest.fixture(scope="module", autouse=True)
def _static_tuning(tmp_path_factory):
    """The cuda backend's plain twins would calibrate the cost model and
    tune sections on CPU rows, at random: keep this file's tests on the
    static defaults (the cost model's priors), any spill in a temporary
    directory and never the user's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_CPM_TUNING_CACHE",
                  str(tmp_path_factory.mktemp("tuning") / "cpm.json"))
        mp.setenv("REPRO_TORCH_CPM_AUTOTUNE", "0")
        mp.setenv("REPRO_TORCH_CPM_CALIBRATE", "0")
        tuning.clear()
        yield
    tuning.clear()


@pytest.fixture(autouse=True)
def _needs_reference(request):
    """Tests that compare with JAX skip where JAX is missing (the GPU
    machine, where only the ``cuda``-marked tests are run)."""
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs JAX, the reference package")


@pytest.fixture(scope="module")
def engines():
    jcfg = jget_config("granite-8b").smoke()
    cfg = get_config("granite-8b").smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (JEngine(jcfg, jp, max_len=MAX_LEN),
            Engine(cfg, tp, max_len=MAX_LEN), cfg)


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s).astype(np.int32) for s in lens]


def _solo(engine, prompt, budget):
    out, _ = engine.generate({"tokens": torch.from_numpy(prompt)[None]},
                             GenConfig(max_new_tokens=budget))
    return out[0].numpy()


def _assert_tokens_match_jax(prompt, tseq, jseq):
    tseq, jseq = np.asarray(tseq), np.asarray(jseq)
    np.testing.assert_array_equal(tseq[:len(prompt)], prompt)
    np.testing.assert_array_equal(tseq, jseq)


def _pair(engines, **kw):
    jeng, teng, _ = engines
    return jeng.session_pool(**kw), teng.session_pool(**kw)


def _assert_same(engines, prompts, jpool, tpool, jout, tout):
    assert sorted(jout) == sorted(tout)
    for sid in jout:
        _assert_tokens_match_jax(prompts[sid], tout[sid],
                                 jout[sid])
    js, ts = jpool.stats(), tpool.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}


# name: (pool kwargs, prompt lengths, budgets).  Two pool shapes and two
# prompt lengths, so the JAX side compiles few programs.
SHAPES = {"whole_row_chunk1": dict(slots=4, n_banks=2, chunk=1),
          "paged_chunk3": dict(slots=3, n_banks=1, chunk=3, page_size=8,
                               pages_per_bank=5)}
SCENARIOS = {
    "whole_row_chunk1": (SHAPES["whole_row_chunk1"], [8, 12, 8, 12, 8, 12],
                         [5, 12, 3, 9, 1, 7]),
    "paged_chunk3_pressure": (SHAPES["paged_chunk3"], [8, 12, 8, 12],
                              [9, 12, 6, 8]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_drain_matches_jax_pool_and_solo(engines, name):
    kw, lens, budgets = SCENARIOS[name]
    prompts = _prompts(len(name), lens, engines[2].vocab_size)
    jpool, tpool = _pair(engines, **kw)
    jsids = [jpool.submit(jnp.asarray(p), b) for p, b in zip(prompts,
                                                            budgets)]
    tsids = [tpool.submit(p, b) for p, b in zip(prompts, budgets)]
    assert jsids == tsids
    jout, tout = jpool.drain(), tpool.drain()
    _assert_same(engines, prompts, jpool, tpool, jout, tout)
    for sid, p, b in zip(tsids, prompts, budgets):
        np.testing.assert_array_equal(tout[sid], _solo(engines[1], p, b))
    st = tpool.stats()
    assert st["pages_free"] == tpool.total_pages
    assert tpool.alloc.free_count() == tpool.slots
    if "pressure" in name:
        assert st["page_stalls"] > 0 and st["restores"] > 0


def test_cuda_banks_on_cpu_equal_reference_banks(engines):
    """The cuda bank path (gather_rows -> fused_stream -> scatter_rows,
    their plain twins on CPU tensors) drains what the reference banks
    drain, with the same counters."""
    kw, lens, budgets = SCENARIOS["paged_chunk3_pressure"]
    prompts = _prompts(7, lens, engines[2].vocab_size)
    teng = engines[1]
    ref = teng.session_pool(**kw)
    cud = teng.session_pool(bank_backend="cuda", **kw)
    for p, b in zip(prompts, budgets):
        ref.submit(p, b)
        cud.submit(p, b)
    r, c = ref.drain(), cud.drain()
    assert sorted(r) == sorted(c)
    for sid in r:
        np.testing.assert_array_equal(c[sid], r[sid])
    assert ref.stats() == cud.stats()
    for bank_r, bank_c in zip(ref.banks, cud.banks):
        np.testing.assert_array_equal(bank_c.lens.numpy(),
                                      bank_r.lens.numpy())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_park_restore_cancel_match_jax(engines, shape):
    """A scripted run: two steps, park the LRU victim, cancel a late
    session and an active one, drain.  Cancels return the same prefixes,
    the parked session restores and continues, counters agree."""
    prompts = _prompts(11, [8, 12, 8, 12, 8], engines[2].vocab_size)
    budgets = [12, 8, 6, 9, 5]
    jpool, tpool = _pair(engines, **SHAPES[shape])
    for p, b in zip(prompts, budgets):
        jpool.submit(jnp.asarray(p), b)
        tpool.submit(p, b)
    cancelled = {"late": [], "active": []}
    for step in range(6):
        for pool in (jpool, tpool):
            if step == 2:
                victim = pool.victim_session()
                assert victim is not None
                pool.park(victim.sid)
            if step == 3:
                cancelled["late"].append(np.asarray(pool.cancel(4)))
            if step == 4:
                active = pool.table.active()[0].sid
                cancelled["active"].append(
                    (active, np.asarray(pool.cancel(active))))
            pool.step()
        _assert_tokens_match_jax(prompts[0], tpool.peek_tokens(0),
                                 jpool.peek_tokens(0))
    _assert_tokens_match_jax(prompts[4], *cancelled["late"][::-1])
    (ja, jtoks), (ta, ttoks) = cancelled["active"]
    assert ja == ta
    _assert_tokens_match_jax(prompts[ta], ttoks, jtoks)
    jout, tout = jpool.drain(), tpool.drain()
    _assert_same(engines, prompts, jpool, tpool, jout, tout)
    st = tpool.stats()
    assert st["preemptions"] >= 1 and st["restores"] >= 1
    assert st["cancels"] == 2
    for sid in tout:
        if sid not in (4, ta):
            np.testing.assert_array_equal(
                tout[sid], _solo(engines[1], prompts[sid], budgets[sid]))


def test_engine_submit_step_drain_facade(engines):
    teng = Engine(engines[1].cfg, engines[1].params, max_len=MAX_LEN)
    prompts = _prompts(3, [8, 10], engines[2].vocab_size)
    sids = [teng.submit(prompts[0], 4, slots=2), teng.submit(prompts[1], 4)]
    with pytest.raises(ValueError, match="already exists"):
        teng.submit(prompts[0], 4, slots=4)
    assert teng.step()["active"] == 2
    out = teng.drain()
    for sid, p in zip(sids, prompts):
        np.testing.assert_array_equal(out[sid], _solo(teng, p, 4))


def test_banks_follow_the_engine_backend(engines):
    """With no ``bank_backend`` the pool's banks take the engine's
    ``cpm_backend``, which defaults to ``cuda`` on a CUDA device and
    ``reference`` on the CPU; a named backend wins."""
    from repro_torch.serve.engine import resolve_cpm_backend
    assert resolve_cpm_backend(None, torch.device("cuda")) == "cuda"
    assert resolve_cpm_backend(None, "cpu") == "reference"
    assert resolve_cpm_backend("reference", "cuda") == "reference"
    with pytest.raises(ValueError, match="cpm_backend"):
        resolve_cpm_backend("pallas", "cpu")
    teng = engines[1]
    assert teng.cpm_backend == "reference"
    assert {b.backend for b in teng.session_pool(slots=2).banks} == \
        {"reference"}
    ceng = Engine(teng.cfg, teng.params, max_len=MAX_LEN,
                  cpm_backend="cuda")
    assert {b.backend for b in ceng.session_pool(slots=2).banks} == {"cuda"}
    assert {b.backend for b in Gateway(ceng, slots=2).pool.banks} == \
        {"cuda"}
    assert {b.backend for b in ceng.session_pool(
        slots=2, bank_backend="reference").banks} == {"reference"}


def test_submit_validation(engines):
    pool = engines[1].session_pool(slots=2, page_size=8, pages_per_bank=4)
    for bad, match in (([], "empty"), (np.arange(8), "positive")):
        with pytest.raises(ValueError, match=match):
            pool.submit(bad, 0 if match == "positive" else 4)
    with pytest.raises(ValueError, match="max_len"):
        pool.submit(np.arange(60), 8)
    with pytest.raises(ValueError, match="bank capacity"):
        pool.submit(np.arange(30), 20)
    with pytest.raises(ValueError, match="page_size"):
        engines[1].session_pool(slots=2, page_size=7)
    with pytest.raises(ValueError, match="multiple"):
        engines[1].session_pool(slots=3, n_banks=2)


def test_two_pools_keep_separate_series(engines):
    a = engines[1].session_pool(slots=2)
    b = engines[1].session_pool(slots=2)
    a.submit(np.arange(8, dtype=np.int32), 2)
    a.drain()
    assert a.stats()["admits"] == 1 and b.stats()["admits"] == 0
    assert a._pool_label != b._pool_label


@pytest.mark.cuda
def test_default_entry_points_launch_the_kernels_on_the_card():
    """``Engine.submit/step/drain`` and ``Gateway(engine)``, built with no
    backend argument on CUDA weights, move sub-pages with ``gather_rows``
    / ``scatter_rows`` and commit on ``fused_stream``, and finish every
    request with its budget."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    cfg = get_config("granite-8b").smoke()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen, "cuda")
    prompts = _prompts(9, [8, 12, 8], cfg.vocab_size)
    row_kernels = ("gather_rows", "fused_stream", "scatter_rows")
    for face in ("engine", "gateway"):
        eng = Engine(cfg, params, max_len=MAX_LEN)
        assert eng.cpm_backend == "cuda"
        ops.reset_launch_counts()
        if face == "engine":
            sids = [eng.submit(prompts[0], 6, slots=2, chunk=2,
                               page_size=8, pages_per_bank=6)]
            sids += [eng.submit(p, 6) for p in prompts[1:]]
            out = eng.drain()
            got = [out[s] for s in sids]
        else:
            gw = Gateway(eng, slots=2, chunk=2, page_size=8,
                         pages_per_bank=6)
            got = [gw.result(r) for r in [gw.submit(p, 6) for p in prompts]]
        counts = ops.launch_counts()
        assert all(counts[k] > 0 for k in row_kernels), (face, counts)
        for g, p in zip(got, prompts):
            assert len(g) == len(p) + 6
            np.testing.assert_array_equal(np.asarray(g)[:len(p)], p)


def _prime(device="cpu"):
    """A paged two-bank cuda-bank pool past its admission step."""
    cfg = get_config("granite-8b").smoke()
    gen = torch.Generator(device=device).manual_seed(0)
    from repro_torch.models import lm
    eng = Engine(cfg, lm.init_params(cfg, gen, device), max_len=MAX_LEN)
    pool = eng.session_pool(slots=2, n_banks=2, chunk=3, page_size=8,
                            pages_per_bank=6, bank_backend="cuda")
    for p in _prompts(5, [9, 12], cfg.vocab_size):
        pool.submit(p, 8)
    pool.step()                                 # admission may read
    return pool


def test_decode_chunk_reads_nothing_back_to_the_host(monkeypatch):
    """Between the chunk's gather and its scatter no tensor is read on the
    host: every reading method raises while ``_chunk`` runs (on the card,
    the ``cuda`` test below holds the chunk to no sync at all)."""
    pool = _prime()
    inner, calls = pool._chunk, []

    def read(*_a, **_k):
        raise AssertionError("host read inside the decode chunk")

    def guarded(*a, **k):
        with monkeypatch.context() as m:
            for name in ("item", "cpu", "tolist", "numpy", "__bool__",
                         "__int__", "__float__", "__index__"):
                m.setattr(torch.Tensor, name, read)
            calls.append(1)
            return inner(*a, **k)

    monkeypatch.setattr(pool, "_chunk", guarded)
    pool.step()
    assert calls == [1]


@pytest.mark.cuda
def test_decode_chunk_never_syncs_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    pool = _prime("cuda")
    inner = pool._chunk

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(pool, "_chunk", guarded)
    pool.step()
    torch.cuda.synchronize()
