"""The port's gateway against the JAX package's on a seeded bursty trace,
and its sync and asyncio faces against solo generation.

Both packages run ``granite-8b``'s smoke config on the same weights and
replay the same ``benchmarks/traffic.bursty_trace`` (requests submitted
when the pool's virtual clock reaches their arrival step), with LRU
preemption on.  Held here, on the CPU: the same tokens per request,
the same SLO grades and first-admission / finish steps in virtual time,
the same preemption count and prefill launches.  The port's tokens equal
its solo ``Engine.generate`` exactly.
"""

from __future__ import annotations

import asyncio
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Gateway as JGateway  # noqa: E402
from repro.serve.gateway import PreemptConfig as JPreemptConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.cpm.pool.sessions import Session  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import Engine, Gateway, GenConfig  # noqa: E402
from repro_torch.serve.gateway import (PreemptConfig, Preemptor,  # noqa: E402
                                       admission)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "benchmarks"))
import traffic  # noqa: E402

MAX_LEN = 64
PREEMPT = dict(min_resident=1, min_remaining=1, max_parks=3)


@pytest.fixture(scope="module")
def engines():
    jcfg = jget_config("granite-8b").smoke()
    cfg = get_config("granite-8b").smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (JEngine(jcfg, jp, max_len=MAX_LEN),
            Engine(cfg, tp, max_len=MAX_LEN), cfg)


def _prompt(seed, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, s).astype(np.int32)


def _solo(engine, prompt, budget):
    out, _ = engine.generate({"tokens": torch.from_numpy(prompt)[None]},
                             GenConfig(max_new_tokens=budget))
    return out[0].numpy()


def _replay(gw, trace, prompts, as_jax):
    """Submit each request once the virtual clock reaches its arrival,
    tick until every request is done; returns the rids in trace order."""
    rids, nxt = [], 0
    while nxt < len(trace) or not all(gw.request(r).done for r in rids):
        while nxt < len(trace) and trace.arrivals[nxt] <= gw.now:
            p = jnp.asarray(prompts[nxt]) if as_jax else prompts[nxt]
            budget = int(trace.budgets[nxt])
            rids.append(gw.submit(p, budget, deadline_steps=3 * budget))
            nxt += 1
        gw.tick()
    return rids


@pytest.mark.parametrize("paged", [False, True])
def test_bursty_trace_matches_jax_gateway(engines, paged):
    jeng, teng, cfg = engines
    trace = traffic.bursty_trace(incumbents=2, long_budget=10, n_bursts=2,
                                 burst=3, gap=4, start=2, seed=3,
                                 burst_len_choices=(8, 12), burst_budget=3,
                                 incumbent_len=8)
    prompts = [_prompt(100 + i, int(s), cfg.vocab_size)
               for i, s in enumerate(trace.lens)]
    kw = dict(slots=2, chunk=1)
    if paged:
        kw.update(page_size=8, pages_per_bank=5)
    jgw = JGateway(jeng, preempt=JPreemptConfig(**PREEMPT), **kw)
    tgw = Gateway(teng, preempt=PreemptConfig(**PREEMPT), **kw)
    jr = _replay(jgw, trace, prompts, True)
    tr = _replay(tgw, trace, prompts, False)
    assert jr == tr
    for rid, p in zip(tr, prompts):
        a, b = tgw.request(rid), jgw.request(rid)
        got = a.tokens
        np.testing.assert_array_equal(got, np.asarray(b.tokens))
        np.testing.assert_array_equal(got, _solo(teng, p, a.budget))
        assert (a.first_admit_step, a.finish_step, a.parks, a.slo_met) == \
            (b.first_admit_step, b.finish_step, b.parks, b.slo_met)
    keys = ("preemptions", "restores", "prefill_launches", "admits",
            "page_stalls", "slo_met", "slo_missed", "ticks",
            "preempt_denied", "decode_steps", "pages_free")
    ts, js = tgw.stats(), jgw.stats()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["preemptions"] > 0
    assert ts["pages_free"] == tgw.pool.total_pages


def test_sync_cancel_and_result(engines):
    teng, cfg = engines[1], engines[2]
    gw = Gateway(teng, slots=2, chunk=2, page_size=8, pages_per_bank=6)
    a = gw.submit(_prompt(1, 8, cfg.vocab_size), 6)
    b = gw.submit(_prompt(2, 12, cfg.vocab_size), 8)
    c = gw.submit(_prompt(3, 8, cfg.vocab_size), 4)
    gw.tick()
    np.testing.assert_array_equal(gw.cancel(c), _prompt(3, 8,
                                                        cfg.vocab_size))
    part = gw.cancel(b)
    assert 12 < len(part) <= 20 and gw.request(b).cancelled
    np.testing.assert_array_equal(
        part, _solo(teng, _prompt(2, 12, cfg.vocab_size), len(part) - 12))
    np.testing.assert_array_equal(
        gw.result(a), _solo(teng, _prompt(1, 8, cfg.vocab_size), 6))
    assert gw.stats()["cancels"] == 2
    with pytest.raises(ValueError, match="empty"):
        gw.submit(np.zeros((0,), np.int32), 4)
    assert {r.rid for r in gw.collect_delivered()} == {a, b, c}


def test_async_stream_and_aresult(engines):
    teng, cfg = engines[1], engines[2]
    gw = Gateway(teng, slots=2, chunk=2)

    async def scenario():
        await gw.start()
        r0 = await gw.asubmit(_prompt(300, 8, cfg.vocab_size), 5)
        r1 = await gw.asubmit(_prompt(301, 12, cfg.vocab_size), 3)
        chunks = [c async for c in gw.stream(r0)]
        t1 = await gw.aresult(r1)
        await gw.stop()
        return np.concatenate(chunks), t1

    streamed, t1 = asyncio.run(scenario())
    full = _solo(teng, _prompt(300, 8, cfg.vocab_size), 5)
    np.testing.assert_array_equal(streamed, full[8:])
    np.testing.assert_array_equal(
        t1, _solo(teng, _prompt(301, 12, cfg.vocab_size), 3))


class _FakeSession(Session):
    def __init__(self, sid, prompt_len, phase="waiting", n_pages=None):
        super().__init__(sid, None, prompt_len, 4, phase=phase)
        if n_pages is not None:
            self.parked = type("PS", (), {"n_pages": n_pages})()


def test_admission_plan_buckets():
    ss = [_FakeSession(0, 8), _FakeSession(1, 12), _FakeSession(2, 8),
          _FakeSession(3, 8, "parked", 2), _FakeSession(4, 8, "parked", 3),
          _FakeSession(5, 8, "parked", 2)]
    plan = admission.plan(ss)
    assert [[s.sid for s in b] for b in plan.buckets] == [[0, 2], [1]]
    assert {tuple(s.sid for s in g) for g in plan.restores} == \
        {(3, 5), (4,)}
    assert plan.launches == 2 and plan.sessions == 6
    fifo = admission.plan(ss, batching=False)
    assert [[s.sid for s in b] for b in fifo.buckets] == [[0], [1], [2]]


def test_preemptor_acts_on_page_pressure_alone(engines):
    teng, cfg = engines[1], engines[2]
    pool = teng.session_pool(slots=4, n_banks=1, chunk=2, page_size=8,
                             pages_per_bank=4)
    pre = Preemptor(pool, PreemptConfig(min_resident=0, min_remaining=0,
                                        max_parks=5))
    a = pool.submit(_prompt(320, 16, cfg.vocab_size), 10)   # 3 pages
    pool.step()
    pool.submit(_prompt(321, 8, cfg.vocab_size), 20)        # wants 2
    assert pool._free_hint > 0                              # slots free
    assert pre.maybe_preempt() == 1                         # pages scarce
    assert pool.table.get(a).phase == "parked"


def test_pool_series_and_spans_are_recorded(engines):
    """The port's own registry holds each pool's labelled series, and a
    tick records the gateway and pool spans with the virtual clock."""
    from repro_torch.obs import metrics, tracing
    tracing.TRACER.clear()
    gw = Gateway(engines[1], slots=2, chunk=2)
    gw.result(gw.submit(_prompt(5, 8, engines[2].vocab_size), 3))
    admits = metrics.REGISTRY.get("repro_pool_admits_total")
    assert admits.labels(pool=gw.pool._pool_label).value == 1
    names = {e.name for e in tracing.TRACER.spans()}
    assert {"gateway.tick", "pool.admission", "pool.prefill",
            "pool.decode_chunk", "pool.commit_packed"} <= names
    chunk = tracing.TRACER.spans("pool.decode_chunk")[0]
    assert chunk.vdur == 2 and chunk.dur > 0
