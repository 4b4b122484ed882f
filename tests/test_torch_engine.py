"""The port's ``Engine.generate`` on ``granite-8b``'s smoke config.

Held here: speculative tokens equal scan tokens; the ``cuda`` commit
path (the ``fused_stream`` twin on CPU tensors) equals the ``reference``
scatter commit token for token; and the port's greedy tokens are what
the JAX model would pick — at every generated position, JAX's logit for
the port's token lies within ``TOL`` of JAX's largest logit (teacher
forcing over the port's sequence).  ``TOL`` = 2e-2: the bf16 agreement of
the two stacks' logits (see tests/test_torch_model.py), so a token may
differ from JAX's only at a near-tie.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import GenConfig as JGenConfig  # noqa: E402
from repro.serve import program_paths as jpaths  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.cpm import tuning  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import Engine, GenConfig, program_paths  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402

TOL = 2e-2
MAX_NEW = 12


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
def models():
    jcfg = jget_config("granite-8b").smoke()
    cfg = get_config("granite-8b").smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    period = np.array([[3, 9, 4, 17, 5], [40, 41, 42, 43, 44]], np.int32)
    prompt = np.tile(period, (1, 4))                    # (2, 20)
    return jcfg, cfg, jp, tp, prompt


@pytest.fixture(scope="module")
def port_runs(models):
    _, cfg, _, tp, prompt = models
    out = {}
    for backend in ("reference", "cuda"):
        eng = Engine(cfg, tp, max_len=48, cpm_backend=backend)
        for name, spec in (("scan", 0), ("spec", 3)):
            toks, stats = eng.generate({"tokens": prompt},
                                       GenConfig(max_new_tokens=MAX_NEW,
                                                 ngram_spec=spec))
            out[backend, name] = (toks, stats)
    return out


def test_spec_equals_scan(port_runs, models):
    prompt = models[4]
    scan, _ = port_runs["reference", "scan"]
    assert scan.shape == (2, prompt.shape[1] + MAX_NEW)
    assert scan.dtype == torch.int32
    np.testing.assert_array_equal(scan[:, :prompt.shape[1]].numpy(), prompt)
    for backend in ("reference", "cuda"):
        spec, stats = port_runs[backend, "spec"]
        assert torch.equal(spec, scan), backend
        assert stats["rounds"] >= 1
        assert stats["emitted"] == 2 * MAX_NEW
        assert 0 <= stats["accepted"] <= stats["proposed"]


def test_cuda_commit_equals_reference_commit(port_runs):
    ref_toks, ref_stats = port_runs["reference", "spec"]
    cu_toks, cu_stats = port_runs["cuda", "spec"]
    assert torch.equal(ref_toks, cu_toks)
    assert ref_stats == cu_stats


def test_greedy_tokens_agree_with_jax_by_teacher_forcing(port_runs, models):
    jcfg, cfg, jp, _, prompt = models
    toks, _ = port_runs["reference", "scan"]
    seq = toks.numpy()

    @jax.jit
    def logits_of(params, tokens):
        x, _ = jlm.forward(params, jcfg, {"tokens": tokens}, remat=False)
        return jlm._logits(params, jcfg, x)

    lg = np.asarray(logits_of(jp, jnp.asarray(seq)).astype(jnp.float32))
    s = prompt.shape[1]
    lg = lg[:, s - 1:-1, :cfg.vocab_size]                # predicts s .. end
    picked = np.take_along_axis(lg, seq[:, s:, None], axis=-1)[..., 0]
    gap = lg.max(-1) - picked
    assert gap.max() <= TOL, gap
    # and against the JAX engine itself, up to its first near-tie
    jtoks, _ = JEngine(jcfg, jp, max_len=48, cpm_backend="reference") \
        .generate({"tokens": jnp.asarray(prompt)},
                  JGenConfig(max_new_tokens=MAX_NEW))
    jtoks = np.asarray(jtoks)
    for r in range(seq.shape[0]):
        diff = np.nonzero(jtoks[r, s:] != seq[r, s:])[0]
        if diff.size:
            assert gap[r, diff[0]] <= TOL


def test_commit_tokens_match_jax():
    rng = np.random.default_rng(3)
    buf = np.zeros((4, 12), np.int32)
    buf[:, :6] = rng.integers(0, 50, (4, 6))
    used = np.full((4,), 6, np.int32)
    preds = np.arange(100, 112, dtype=np.int32).reshape(4, 3)
    emit = np.array([3, 1, 2, 0], np.int32)
    jb, ju = jpaths.commit_tokens(jnp.asarray(buf), jnp.asarray(used),
                                  jnp.asarray(preds), jnp.asarray(emit),
                                  backend="reference")
    ops.reset_launch_counts()
    for backend in ("reference", "cuda"):
        tb, tu = program_paths.commit_tokens(
            torch.from_numpy(buf), torch.from_numpy(used),
            torch.from_numpy(preds), torch.from_numpy(emit),
            backend=backend)
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    _, plan = program_paths.record_commit_program(
        torch.from_numpy(buf), torch.from_numpy(used),
        torch.from_numpy(preds), torch.from_numpy(emit))
    assert [g.kind for g in plan.groups] == ["fused"]
    assert [i.op for i in plan.program] == ["insert", "truncate"]
    assert ops.launch_counts()["fused_stream"] == 0   # CPU: the plain twin


def test_greedy_matches_jax_argmax_on_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]], np.float32)
    np.testing.assert_array_equal(
        np.asarray(jnp.argmax(jnp.asarray(x), -1).astype(jnp.int32)),
        sampling.greedy(torch.from_numpy(x)).numpy())


def test_sampling_is_seeded_and_truncates():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(1))
    draw = [sampling.sample(logits, torch.Generator().manual_seed(7),
                            temperature=0.8, top_k=5) for _ in range(2)]
    assert torch.equal(draw[0], draw[1]) and draw[0].dtype == torch.int32
    allowed = torch.topk(logits, 5, dim=-1).indices
    assert all(int(t) in allowed[i].tolist()
               for i, t in enumerate(draw[0]))
    probs = torch.softmax(logits, -1)
    want = jax.numpy.asarray(probs.numpy())
    from repro.serve import sampling as jsampling
    np.testing.assert_array_equal(
        np.asarray(jsampling.top_p_mask(want, 0.6)),
        sampling.top_p_mask(probs, 0.6).numpy())
    nucleus = sampling.sample(logits, torch.Generator().manual_seed(7),
                              temperature=1.0, top_p=0.6)
    keep = sampling.top_p_mask(probs, 0.6)
    assert bool(keep.gather(-1, nucleus[:, None].long()).all())


def test_engine_argument_checks(models, monkeypatch):
    _, cfg, _, tp, prompt = models
    with pytest.raises(ValueError, match="cpm_backend"):
        Engine(cfg, tp, cpm_backend="pallas")
    with pytest.raises(ValueError, match="max_len"):
        Engine(cfg, tp, max_len=24).generate(
            {"tokens": prompt}, GenConfig(max_new_tokens=8, ngram_spec=3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
