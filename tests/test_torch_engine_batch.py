"""``Engine.generate`` hands the whole batch to the prefill, as the JAX
engine does: every key besides ``tokens`` (qwen2-vl's ``patch_embeds``,
``patch_pos`` and ``pos_ids``; an encoder-decoder's ``src_embeds``)
reaches ``lm.prefill`` on the engine's device, whether given as tensors
or NumPy arrays.  Held on the smoke configs, with parameters converted
from ``lm.init_params(cfg, PRNGKey(0))``, on the CPU.

Greedy tokens are compared exactly: JAX's engine with the image equals
the port's engine (scan and speculative) and its step-by-step oracle
with the image, and differs from the text-only tokens.  The
encoder-decoder's tokens are held as JAX's own choices up to bf16
near-ties (2e-2 x max(1, |logit|)).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import GenConfig as JGenConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.cpm import tuning  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import Engine, GenConfig, ReferenceEngine  # noqa: E402

MAX_LEN = 64
NEW = 8


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


def _models(name):
    jcfg = jall_configs()[name].smoke()
    cfg = get_config(name).smoke()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jp=jp,
                jeng=JEngine(jcfg, jp, max_len=MAX_LEN),
                engine=Engine(cfg, tp, max_len=MAX_LEN),
                ref=ReferenceEngine(cfg, tp, max_len=MAX_LEN))


@pytest.fixture(scope="module")
def vlm():
    return _models("qwen2-vl-7b")


@pytest.fixture(scope="module")
def encdec():
    return _models("seamless-m4t-large-v2")


def _image_batch(d_model, pos_ids=False):
    """2 x 16 tokens and 4 patch embeddings at positions 2-5 of each row;
    with ``pos_ids`` the patches take (t, h, w) grid positions."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 128, (2, 16)).astype(np.int32),
             "patch_embeds": rng.standard_normal((2, 4, d_model)).astype(
                 np.float32),
             "patch_pos": np.broadcast_to(np.arange(2, 6, dtype=np.int32),
                                          (2, 4)).copy()}
    if pos_ids:
        pos = np.broadcast_to(np.arange(16, dtype=np.int32), (3, 2, 16)).copy()
        pos[1, :, 2:6] = [2, 2, 3, 3]          # h
        pos[2, :, 2:6] = [2, 3, 2, 3]          # w
        batch["pos_ids"] = pos
    return batch


def _jax_tokens(m, batch):
    out, _ = m["jeng"].generate({k: jnp.asarray(v) for k, v in batch.items()},
                                JGenConfig(max_new_tokens=NEW))
    return np.asarray(out)


@pytest.mark.parametrize("pos_ids", [False, True])
@pytest.mark.parametrize("as_tensors", [False, True])
def test_vlm_generate_keeps_the_image(vlm, pos_ids, as_tensors):
    batch = _image_batch(vlm["cfg"].d_model, pos_ids)
    want = _jax_tokens(vlm, batch)
    text = _jax_tokens(vlm, {"tokens": batch["tokens"]})
    assert not np.array_equal(want, text)       # the image matters
    tb = ({k: torch.from_numpy(v) for k, v in batch.items()} if as_tensors
          else batch)
    got, _ = vlm["engine"].generate(tb, GenConfig(max_new_tokens=NEW))
    np.testing.assert_array_equal(got.numpy(), want)
    ref, _ = vlm["ref"].generate(tb, GenConfig(max_new_tokens=NEW))
    np.testing.assert_array_equal(ref.numpy(), want)


def test_vlm_speculative_keeps_the_image(vlm):
    batch = _image_batch(vlm["cfg"].d_model)
    scan, _ = vlm["engine"].generate(batch, GenConfig(max_new_tokens=NEW))
    spec, stats = vlm["engine"].generate(
        batch, GenConfig(max_new_tokens=NEW, ngram_spec=3))
    assert torch.equal(scan, spec) and stats["rounds"] > 0
    text, _ = vlm["engine"].generate({"tokens": batch["tokens"]},
                                     GenConfig(max_new_tokens=NEW))
    np.testing.assert_array_equal(text.numpy(), _jax_tokens(
        vlm, {"tokens": batch["tokens"]}))


def test_encdec_generate_reads_src_embeds(encdec):
    """The source reaches the encoder: for two sources the port's greedy
    tokens differ, and each is JAX's own choice on its source (at every
    generated position JAX's teacher-forced logit of the port's token lies
    within 2e-2 x max(1, |logit|) of its largest: bf16 near-ties may pick
    either, as in ``tests/test_torch_hybrid_engine.py``)."""
    jcfg, s = encdec["jcfg"], 12
    toks = np.random.default_rng(1).integers(0, 128, (2, s)).astype(
        np.int32)

    @jax.jit
    def logits_of(params, tokens, src):
        x, _ = jlm.forward(params, jcfg, {"tokens": tokens,
                                          "src_embeds": src}, remat=False)
        return jlm._logits(params, jcfg, x).astype(jnp.float32)

    outs = []
    for seed in (2, 3):
        src = np.random.default_rng(seed).standard_normal(
            (2, 8, jcfg.d_model)).astype(np.float32)
        got, _ = encdec["engine"].generate({"tokens": toks,
                                            "src_embeds": src},
                                           GenConfig(max_new_tokens=NEW))
        seq = got.numpy()
        lg = np.asarray(logits_of(encdec["jp"], jnp.asarray(seq),
                                  jnp.asarray(src)))
        lg = lg[:, s - 1:-1, :jcfg.vocab_size]           # predicts s .. end
        picked = np.take_along_axis(lg, seq[:, s:, None], axis=-1)[..., 0]
        gap = lg.max(-1) - picked
        assert gap.max() <= 2e-2 * max(1.0, float(np.abs(lg).max())), gap
        outs.append(seq)
    assert not np.array_equal(*outs)


def test_encdec_generate_needs_its_source(encdec):
    with pytest.raises(KeyError, match="src_embeds"):
        encdec["engine"].generate({"tokens": np.zeros((1, 4), np.int32)},
                                  GenConfig(max_new_tokens=2))
