"""Step-by-step reference engine — the differential-test oracle (a port of
``repro.serve.reference``).

The original serving path, kept simple on purpose: a Python ``while``
loop with one ``lm.decode_step`` call per token, and a batch-size-1
prompt-lookup speculative round that calls ``decode_step`` once per
draft token.  Every intermediate is observable and the control flow is
trivially auditable, so the tests can hold ``engine.Engine`` (the scan
and speculative paths) token for token against it.

Scope, as in the JAX package (acceptable in an oracle):
  * speculative rounds support batch 1 only and roll back global-attention
    K/V only (``kv_cache.truncate``); the production engine handles batch
    > 1, recurrent-state rollback and local-window rings.  So the oracle
    of a hybrid model (recurrentgemma) is its greedy path.
  * ``stats["accepted"]`` counts tokens of the final round even when they
    overshoot ``max_new_tokens`` and are sliced off; the production
    engine reports clipped counts.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.cpm.reference import searchable
from repro_torch.models import lm
from . import kv_cache, sampling
from .engine import GenConfig


class ReferenceEngine:
    """Static-batch engine, one decode call per token; ``params`` decide
    the device."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 512):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = params["emb"].device

    def generate(self, batch: dict, gen: GenConfig,
                 generator: torch.Generator | None = None):
        """Returns (tokens (B, prompt+new) int32, acceptance stats)."""
        tokens = torch.as_tensor(batch["tokens"]).to(self.device,
                                                     torch.int32)
        b, s = tokens.shape
        logits, caches = lm.prefill(self.params, self.cfg,
                                    dict(batch, tokens=tokens),
                                    max_len=self.max_len)
        out, pos = tokens, s
        stats = {"accepted": 0, "proposed": 0}
        nxt = self._sample(logits[:, -1], gen, generator)
        out = torch.cat([out, nxt[:, None]], dim=1)
        while out.shape[1] - s < gen.max_new_tokens:
            if (gen.ngram_spec and out.shape[1] > gen.ngram_spec + 2
                    and b == 1):
                out, caches, pos, acc, prop = self._spec_round(
                    out, caches, pos, gen)
                stats["accepted"] += acc
                stats["proposed"] += prop
            else:
                logits, caches = self._decode(out[:, -1:], caches, pos)
                pos += 1
                nxt = self._sample(logits[:, -1], gen, generator)
                out = torch.cat([out, nxt[:, None]], dim=1)
        return out[:, : s + gen.max_new_tokens], stats

    def _decode(self, tok, caches, pos: int):
        return lm.decode_step(self.params, self.cfg, tok, caches,
                              torch.tensor(pos, dtype=torch.int32,
                                           device=self.device))

    def _sample(self, logits, gen: GenConfig, generator):
        return sampling.sample(logits, generator, gen.temperature,
                               gen.top_k, gen.top_p)

    # -- prompt-lookup speculative decoding (content-searchable memory) ----

    def _spec_round(self, out, caches, pos: int, gen: GenConfig):
        n = min(gen.ngram_len, out.shape[1] - 1)
        ctx = out[0]
        starts, valid = searchable.ngram_lookup(ctx[:-1], ctx[-n:],
                                                max_out=1)
        draft_len = gen.ngram_spec
        draft = torch.zeros((draft_len,), dtype=torch.int32,
                            device=self.device)          # degenerate draft
        if bool(valid[0]):
            st = int(starts[0])
            found = ctx[st: st + draft_len]
            draft[: found.shape[0]] = found

        # verify: run the model over [last_token, draft[:-1]] step by step,
        # sampling greedily; acceptance = searchable carry chain
        seq = torch.cat([out[0, -1:], draft[:-1]])
        preds, p = [], pos
        for t in range(draft_len):
            logits, caches = self._decode(seq[t].reshape(1, 1), caches, p)
            preds.append(sampling.greedy(logits[:, -1])[0])
            p += 1
        preds = torch.stack(preds)                       # model's tokens
        n_acc = int(searchable.verify_draft(draft, preds))
        n_emit = min(n_acc + 1, draft_len)               # +1 model token
        idx = torch.arange(draft_len, device=self.device)
        emitted = torch.where(idx < n_acc, draft, preds)[:n_emit]
        out = torch.cat([out, emitted[None]], dim=1)
        # roll back cache entries past the accepted prefix (movable delete)
        new_pos = pos + n_emit
        caches = kv_cache.truncate(caches, new_pos)
        return out, caches, new_pos, n_acc, draft_len
