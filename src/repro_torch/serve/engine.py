"""Batched serving engine with prompt-lookup speculative decoding (a port
of the static-batch ``Engine.generate`` of ``repro.serve.engine``).

Decode keeps fixed-shape state on the device (current token, KV caches,
per-row positions) and never reads it back per token: the scan path
loops ``lm.decode_step`` and syncs once at the end, where the JAX package
runs one ``lax.scan``.  Speculative decoding (greedy only) drafts from the
paper's content-searchable memory (``searchable.ngram_lookup`` over each
row's context), verifies the whole draft in one teacher-forced
``lm.decode_multi``, accepts per row by the searchable carry chain
(``searchable.verify_draft``), rolls the caches back with a per-row
length truncation and commits the tokens — through the recorded
``insert -> truncate`` CPM program on the ``cuda`` backend (one
``fused_stream`` launch per round), or one scatter on ``reference``.
Each round makes ONE host sync: the loop condition and the round's
statistics come back together.

Under a sharding context with a "model" axis (``sharding.make_ctx(mesh,
fsdp=False)``, the params ``sharding.distribute_params``' ``DTensor``s or
plain tensors) ``generate`` runs on each rank over the rows it is given:
the prefill and every decode step on the rank's heads, channels and
cache blocks, the logits gathered whole, so every model rank drafts and
commits the same tokens.  A greedy token is the same on every model rank
by construction; a sampled one (``temperature > 0``) is model rank 0's
draw, summed over the axis with the other ranks' zeros, since each rank
draws from its own generator (``sampling.shared_draw``, the session
pool's rule too).

Beyond the static ``generate`` batch, the engine serves a *stream* of
requests through the paged session pool (``session_pool.py``):
``submit`` / ``step`` / ``drain`` admit sessions into free KV and token
pages mid-flight, decode every live page, and retire finished sessions
so their pages go straight back to the allocator.  They run under the
same context: every rank of a model group runs the same pool on the same
submissions, each data rank its own.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.cpm.reference import searchable
from repro_torch.models import lm
from . import kv_cache, program_paths, sampling

CPM_BACKENDS = ("reference", "cuda")


def resolve_cpm_backend(backend: str | None, device) -> str:
    """The CPM backend of an engine or a pool: the caller's choice, else
    ``cuda`` (the hand-written kernels) on a CUDA device and
    ``reference`` (plain PyTorch) on the CPU."""
    if backend is None:
        backend = ("cuda" if torch.device(device).type == "cuda"
                   else "reference")
    if backend not in CPM_BACKENDS:
        raise ValueError(f"cpm_backend must be one of {CPM_BACKENDS}, "
                         f"got {backend!r}")
    return backend


@dataclasses.dataclass
class GenConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0           # 0 => greedy
    top_k: int = 0
    top_p: float = 0.0
    ngram_spec: int = 0                # >0: prompt-lookup draft length
    ngram_len: int = 3                 # trailing n-gram matched for drafts


class Engine:
    """Static-batch generation over one parameter set.

    ``params`` decide the device (build them with ``lm.init_params`` or
    ``convert.params_from_numpy``).  ``cpm_backend`` picks the commit
    path: ``"reference"`` (one scatter) or ``"cuda"`` (the recorded
    commit program scheduled by the cost model: one ``fused_stream``
    launch a round, or the eager ``insert``: one ``shift_range`` launch
    over the rows' own lengths; the plain twins for CPU tensors); by
    default
    ``cuda`` on a CUDA device, ``reference`` on the CPU.  The session
    pool's token banks follow it."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 cpm_backend: str | None = None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = params["emb"].device
        self.cpm_backend = resolve_cpm_backend(cpm_backend, self.device)

    # -- public API --------------------------------------------------------

    def generate(self, batch: dict, gen: GenConfig,
                 generator: torch.Generator | None = None):
        """Returns (tokens (B, prompt+new) int32, stats).  ``batch`` holds
        ``tokens`` and whatever else the model reads (``src_embeds``;
        ``patch_embeds``, ``patch_pos``, ``pos_ids``).

        stats: ``accepted`` / ``proposed`` draft tokens (clipped to the
        budget), ``emitted`` new tokens, ``rounds`` speculative rounds,
        ``acceptance_rate`` = accepted / proposed."""
        tokens = torch.as_tensor(batch["tokens"]).to(self.device,
                                                     torch.int32)
        b, s = tokens.shape
        if gen.max_new_tokens <= 0:
            return tokens, {"accepted": 0, "proposed": 0, "rounds": 0,
                            "emitted": 0, "acceptance_rate": 0.0}
        # every batch key reaches the prefill (patch embeddings and their
        # positions, an encoder's src_embeds), on the engine's device
        full = {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}
        logits, caches = lm.prefill(self.params, self.cfg,
                                    dict(full, tokens=tokens),
                                    max_len=self.max_len)
        caches = kv_cache.broadcast_lens(caches, b)
        pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        # the whole caches' slots, for a model axis that splits their slots
        lens = {"max_len": max(self.max_len, s),
                "cross_len": (full["src_embeds"].shape[1]
                              if self.cfg.enc_dec else None)}
        spec = (gen.ngram_spec > 0 and gen.temperature <= 0
                and s >= min(gen.ngram_len, s - 1) + 2)
        if spec:
            out, stats = self._generate_spec(tokens, logits, caches, pos,
                                             gen, lens)
        else:
            out, stats = self._generate_scan(tokens, logits, caches, pos,
                                             gen, generator, lens)
        prop = stats["proposed"]
        stats["acceptance_rate"] = stats["accepted"] / prop if prop else 0.0
        return out[:, : s + gen.max_new_tokens], stats

    def _sample(self, logits, gen: GenConfig, generator):
        tok = sampling.sample(logits, generator, gen.temperature,
                              gen.top_k, gen.top_p)
        return sampling.shared_draw(tok) if gen.temperature > 0 else tok

    # -- non-speculative: no per-token host sync ---------------------------

    def _generate_scan(self, tokens, logits, caches, pos, gen: GenConfig,
                       generator, lens: dict):
        b, _ = tokens.shape
        tok = self._sample(logits[:, -1], gen, generator)
        seq = [tok]
        for _ in range(gen.max_new_tokens - 1):
            logits, caches = lm.decode_step(self.params, self.cfg,
                                            tok[:, None], caches, pos,
                                            **lens)
            tok = self._sample(logits[:, -1], gen, generator)
            seq.append(tok)
            pos = pos + 1
        out = torch.cat([tokens, torch.stack(seq, dim=1)], dim=1)
        return out, {"accepted": 0, "proposed": 0, "rounds": 0,
                     "emitted": b * gen.max_new_tokens}

    # -- batched prompt-lookup speculative decoding ------------------------

    def _generate_spec(self, tokens, logits, caches, pos, gen: GenConfig,
                       lens: dict):
        b, s = tokens.shape
        max_new = gen.max_new_tokens
        # an active row's last verify round can write up to draft_len - 1
        # KV slots past its budget
        need = s + max_new + gen.ngram_spec - 1
        if self.max_len < need:
            raise ValueError(
                f"speculative decoding needs max_len >= prompt + "
                f"max_new_tokens + ngram_spec - 1 = {need}, got "
                f"{self.max_len}")
        buf = torch.zeros((b, s + max_new), dtype=torch.int32,
                          device=self.device)
        buf[:, :s] = tokens
        buf[:, s] = sampling.greedy(logits[:, -1])
        n_new = torch.ones((b,), dtype=torch.int32, device=self.device)
        stats = {"accepted": 0, "proposed": 0, "rounds": 0, "emitted": b}
        least_new = 1                          # host copy of n_new.min()
        while least_new < max_new:
            seq, draft = self._draft(buf, n_new, s, gen)
            logits, caches, snaps = lm.decode_multi(
                self.params, self.cfg, seq, caches, pos, **lens)
            buf, n_new, caches, pos, acc, prop, emit = self._commit(
                buf, n_new, caches, snaps, draft, logits, pos, s, gen)
            # the round's one host sync: loop condition + statistics
            least_new, acc, prop, emit = torch.stack(
                [n_new.min(), acc, prop, emit]).tolist()
            stats["accepted"] += acc
            stats["proposed"] += prop
            stats["emitted"] += emit
            stats["rounds"] += 1
        return buf, stats

    def _draft(self, buf, n_new, s: int, gen: GenConfig):
        """(buf, n_new) -> (seq (B, T) verification input, draft (B, T))."""
        draft_len = gen.ngram_spec
        n = min(gen.ngram_len, s - 1)
        b, cap = buf.shape
        dev = buf.device
        rows = torch.arange(b, device=dev)[:, None]
        total = s + n_new                                # (B,) live lengths
        gidx = total[:, None] - n + torch.arange(n, device=dev)[None]
        ngram = buf[rows, gidx.long()]
        # search context = live tokens minus the final one (the trailing
        # self-match must not count); dead slots get -1, matching nothing
        live = torch.arange(cap, device=dev)[None] < (total - 1)[:, None]
        ctx = torch.where(live, buf, -1)
        starts, valid = searchable.ngram_lookup(ctx, ngram, max_out=1)
        start, ok = starts[:, 0], valid[:, 0]
        # draft = continuation after the earliest earlier occurrence,
        # zero-padded past the live region (rows without one draft zeros)
        didx = start[:, None] + torch.arange(draft_len, device=dev)[None]
        vals = buf[rows, torch.clamp(didx, max=cap - 1).long()]
        draft = torch.where(ok[:, None] & (didx < total[:, None]), vals, 0)
        last = buf[rows[:, 0], (total - 1).long()]
        seq = torch.cat([last[:, None], draft[:, :-1]], dim=1)
        return seq, draft

    def _commit(self, buf, n_new, caches, snaps, draft, logits, pos, s: int,
                gen: GenConfig):
        """Acceptance, cache rollback and token commit for one round."""
        draft_len, max_new = gen.ngram_spec, gen.max_new_tokens
        preds = sampling.greedy(logits)                  # (B, T)
        n_acc = searchable.verify_draft(draft, preds)    # (B,)
        n_emit = torch.clamp(n_acc + 1, max=draft_len)   # always >= 1
        caches = lm.rollback_caches(self.cfg, caches, snaps, n_emit - 1)
        new_pos = pos + n_emit
        caches = kv_cache.truncate(caches, new_pos)
        remaining = torch.clamp(max_new - n_new, min=0)
        emit_n = torch.minimum(n_emit, remaining)
        if self.cpm_backend == "reference":
            # one scatter touching draft_len slots; slots past a row's
            # accepted count go to a dropped extra column
            b, cap = buf.shape
            tidx = torch.arange(draft_len, device=buf.device)[None]
            widx = torch.where(tidx < emit_n[:, None],
                               s + n_new[:, None] + tidx, cap)
            wide = torch.cat([buf, buf.new_zeros((b, 1))], dim=1)
            wide.scatter_(1, widx.long(), preds)
            buf = wide[:, :cap].contiguous()
            n_new = n_new + emit_n
        else:
            buf, new_used = program_paths.commit_tokens(
                buf, s + n_new, preds, emit_n, backend=self.cpm_backend)
            n_new = new_used - s
        acc = torch.minimum(n_acc, emit_n).sum(dtype=torch.int32)
        # proposed, like accepted, counts only draft tokens within budget
        prop = torch.clamp(remaining, max=draft_len).sum(dtype=torch.int32)
        return (buf, n_new, caches, new_pos, acc, prop,
                emit_n.sum(dtype=torch.int32))

    # -- continuous batching (paged session pool) --------------------------

    def session_pool(self, slots: int = 8, n_banks: int = 1, gen=None,
                     **kw):
        """A fresh continuous-batching pool over this engine's weights:
        ``slots`` sessions split across ``n_banks`` CPM banks (see
        ``repro_torch.serve.session_pool``)."""
        from .session_pool import SessionPool
        return SessionPool(self, slots=slots, n_banks=n_banks, gen=gen,
                           **kw)

    def submit(self, tokens, max_new_tokens: int | None = None, **pool_kw):
        """Queue one request on the engine's default session pool (made at
        the first call; ``pool_kw`` configures it).  Returns the session
        id; ``step()`` / ``drain()`` advance it."""
        if getattr(self, "_pool", None) is None:
            self._pool = self.session_pool(**pool_kw)
        elif pool_kw:
            raise ValueError("default pool already exists; use "
                             "session_pool() for a differently-shaped one")
        return self._pool.submit(tokens, max_new_tokens)

    def step(self):
        """One continuous-batching step on the default pool; returns the
        pool's stats snapshot."""
        if getattr(self, "_pool", None) is None:
            raise RuntimeError("no sessions submitted")
        return self._pool.step()

    def drain(self):
        """Run the default pool to completion; returns ``{session_id:
        (prompt + generated,) tokens}``."""
        if getattr(self, "_pool", None) is None:
            raise RuntimeError("no sessions submitted")
        return self._pool.drain()
