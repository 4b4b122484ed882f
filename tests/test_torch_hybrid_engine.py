"""The port's serving paths on the hybrid model: recurrentgemma-9b's smoke
config (rglru, rglru, attn_local with a 16-slot ring), parameters
converted from ``lm.init_params(cfg, PRNGKey(0))``, on the CPU.

Greedy tokens, exact, over ``tests/test_engine_equiv.py``'s grids:
  * the scan path equals the port's step-by-step ``ReferenceEngine``
    over (b, s, new) in {(1, 16, 12), (4, 16, 12), (4, 8, 6)} and (2, 20,
    24), which decodes past the window so every ring wraps;
  * the speculative path (per-row rollback of ``h``, ``conv_buf`` and
    the rings) equals the scan path over (b, draft_len) in {(1, 4),
    (4, 4), (4, 6)} on repeated prompts, on both commit backends (the
    ``cuda`` backend's plain twins here);
  * the scan tokens are the JAX model's own choices: at every generated
    position JAX's teacher-forced logit of the port's token lies within
    2e-2 of JAX's largest (bf16 near-ties may pick either);
  * the paged session pool, under page pressure (parks and restores of
    rings and recurrent states), equals solo ``Engine.generate``.
The oracle's speculative round rolls back global-attention K/V only (as
the JAX package's), so the hybrid oracle is its greedy path.
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
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.cpm import tuning  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import Engine, GenConfig, ReferenceEngine  # noqa: E402

NAME = "recurrentgemma-9b"
MAX_LEN = 96
TOL = 2e-2


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


@pytest.fixture(scope="module")
def hybrid():
    jcfg = jall_configs()[NAME].smoke()
    cfg = get_config(NAME).smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp,
                engine=Engine(cfg, tp, max_len=MAX_LEN),
                ref=ReferenceEngine(cfg, tp, max_len=MAX_LEN))


def _prompt(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


def _repetitive(b, s):
    """Prompts with period-6 structure so n-gram lookup finds drafts."""
    period = np.arange(6, dtype=np.int32) + 7
    return np.tile(period[None], (b, -(-s // 6)))[:, :s]


@pytest.mark.parametrize("b,s,new", [(1, 16, 12), (4, 16, 12), (4, 8, 6),
                                     (2, 20, 24)])
def test_scan_matches_reference_greedy(hybrid, b, s, new):
    toks = torch.from_numpy(_prompt(b, s))
    out, stats = hybrid["engine"].generate({"tokens": toks},
                                           GenConfig(max_new_tokens=new))
    rout, _ = hybrid["ref"].generate({"tokens": toks},
                                     GenConfig(max_new_tokens=new))
    assert tuple(out.shape) == (b, s + new)
    assert torch.equal(out, rout)
    assert stats["emitted"] == b * new


@pytest.mark.parametrize("b,draft_len", [(1, 4), (4, 4), (4, 6)])
def test_spec_matches_scan(hybrid, b, draft_len):
    toks = torch.from_numpy(_repetitive(b, 18))
    base, _ = hybrid["engine"].generate({"tokens": toks},
                                        GenConfig(max_new_tokens=14))
    for backend in ("reference", "cuda"):
        eng = Engine(hybrid["cfg"], hybrid["tp"], max_len=MAX_LEN,
                     cpm_backend=backend)
        spec, stats = eng.generate({"tokens": toks},
                                   GenConfig(max_new_tokens=14,
                                             ngram_spec=draft_len))
        assert torch.equal(base, spec), backend
        assert stats["rounds"] > 0
        assert stats["emitted"] == b * 14


def test_spec_on_random_prompts_past_the_window(hybrid):
    """Rows without an n-gram hit draft zeros; 24 prompt tokens and 20 new
    ones wrap every ring during verification and rollback."""
    toks = torch.from_numpy(_prompt(2, 24, seed=3))
    gen = GenConfig(max_new_tokens=20)
    base, _ = hybrid["engine"].generate({"tokens": toks}, gen)
    spec, _ = hybrid["engine"].generate(
        {"tokens": toks}, GenConfig(max_new_tokens=20, ngram_spec=4))
    assert torch.equal(base, spec)


def test_scan_tokens_are_jax_choices(hybrid):
    jcfg, jp = hybrid["jcfg"], hybrid["jp"]
    s, new = 20, 24
    toks = _prompt(2, s)
    out, _ = hybrid["engine"].generate({"tokens": torch.from_numpy(toks)},
                                       GenConfig(max_new_tokens=new))
    seq = out.numpy()

    @functools.partial(jax.jit)
    def logits_of(params, tokens):
        x, _ = jlm.forward(params, jcfg, {"tokens": tokens}, remat=False)
        return jlm._logits(params, jcfg, x)

    lg = np.asarray(logits_of(jp, jnp.asarray(seq)).astype(jnp.float32))
    lg = lg[:, s - 1:-1, :jcfg.vocab_size]               # predicts s .. end
    picked = np.take_along_axis(lg, seq[:, s:, None], axis=-1)[..., 0]
    gap = lg.max(-1) - picked
    assert gap.max() <= TOL * max(1.0, float(np.abs(lg).max())), gap


def test_pool_matches_solo_generate(hybrid):
    """Six requests through a paged pool of 3 slots with page pressure:
    sessions park (their rings, ``h`` and ``conv_buf`` lifted to the host)
    and restore; every drained sequence equals a solo generate."""
    eng = hybrid["engine"]
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


def test_zero_budget_returns_prompt(hybrid):
    toks = torch.from_numpy(_prompt(2, 8))
    out, stats = hybrid["engine"].generate({"tokens": toks},
                                           GenConfig(max_new_tokens=0))
    rout, _ = hybrid["ref"].generate({"tokens": toks},
                                     GenConfig(max_new_tokens=0))
    assert torch.equal(out, toks) and torch.equal(rout, toks)
    assert stats["emitted"] == 0


def test_serve_cli_runs_the_hybrid_on_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path

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
