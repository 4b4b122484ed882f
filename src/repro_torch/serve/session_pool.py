"""Continuous batching over paged CPM banks (a port of
``repro.serve.session_pool``).

The session pool serves a stream of requests over a fixed set of
fixed-size **sub-pages** — KV-cache pages and token-bank pages — that
sessions check in and out of mid-flight:

  * ``submit``  — queue a prompt + token budget (FIFO), optionally with
    per-request sampling params (a GenConfig override);
  * ``step``    — admit waiting sessions with **batched admission** (one
    stacked ``lm.prefill`` per same-length bucket; parked sessions
    restore in one group, no prefill), decode a ``chunk`` of tokens for
    every live session, then retire finished sessions and reclaim their
    pages;
  * ``park``    — preempt an ACTIVE session: its live sub-pages are
    copied to a host-side :class:`PageState`, its slot and page list are
    freed, and it re-queues FIFO for a restore that continues the token
    stream exactly where it was cut (the LRU *policy* lives in
    ``repro_torch.serve.gateway.preempt``);
  * ``cancel``  — abort a session in any phase, returning what ran;
  * ``drain``   — step until every submitted session is done.

Paged layout: each session holds an ordered page list
(``SlotAllocator.pages``); a per-slot page table ``(slots, C)`` maps
logical page ranks to sub-page ids.  Global-attn KV leaves live as page
pools (``kv_cache.paged_pool``), token rows as ``(pages_per_bank,
page_size)`` banks.  The decode chunk gathers each session's FULL
logical row through the table, runs ``chunk`` decode steps with per-row
positions, commits each bank's tokens with the packed ``insert ->
truncate`` stream, then scatters back only the *dirty* pages (ranks
touched since the chunk began; clean pages carry a sentinel and drop).
On a ``cuda`` bank each chunk is, per bank, one ``gather_rows``, one
``fused_stream`` and one ``scatter_rows`` launch, and the chunk reads
nothing back to the host between its gather and its scatter: no
``.item()``, ``.cpu()`` or ``bool(tensor)``.  Sessions are topped up
host-side between chunks (``_ensure_pages``) with enough pages for the
next chunk; when a bank runs dry the youngest sessions park.

Under a "model" axis (``sharding.make_ctx(mesh, fsdp=False)``, of any
size) every rank of a model group runs the same host logic on the same
submissions, as JAX's pool runs under GSPMD; each data rank is a replica
given its own.  A rank's device state is its block of the pool: every
global-attn pool leaf holds the rank's KV heads of every page where the
axis divides them, else (split-KV) every KV head at the rank's
``page_size / m`` slots of every page (``kv_cache.page_slots``,
``sharding.split_kv_slots``), so the page table, the allocator, page
ids, grants, the sink page and the dirty masks are the same on every
rank, and seating, parking and restoring run no collective.  Rings,
recurrent states and ``len`` keep their per-slot blocks.  A parked
image is the rank's own and restores on the rank that parked it; a
sampled token is model rank 0's draw (``sampling.shared_draw``), a
greedy one the same on every rank by construction.

Bookkeeping is CPM all the way down: free-slot and free-page lookups are
§6 ``compare`` + Rule-6 drains on the allocator's metadata devices, the
LRU victim a §7.5 ``global_limit("min")``.  The host keeps mirrors
(live flags, budgets, page lists, sampling params).

Correctness contract: under greedy decoding the pool is token-identical
to generating each session alone with ``Engine.generate`` (decode math is
row-independent, the paged gather/scatter round trip is a copy, and a
parked page image restores into any slot), at any ``chunk`` size.  On
the card, cuBLAS may pick another algorithm for another row count, so
bf16 logits can differ in their last bits there; ``chip_smoke.py`` holds
the pool to the solo tokens up to near-ties.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any

import numpy as np
import torch

from repro_torch.cpm.pool import (CPMBank, MultiBankScheduler, SessionTable,
                                  SlotAllocator)
from repro_torch.cpm.pool.sessions import ACTIVE, DONE, PARKED
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from . import kv_cache, sampling

# -- registry-backed accounting ---------------------------------------------
# Each pool instance is one label (pool="<id>") on these families; the
# counter attributes (``pool.prefill_launches`` ...) are series_property
# views, so ``stats()`` and the registry read the same cells.
_POOL_IDS = itertools.count()

_POOL_COUNTERS = {
    "decode_steps": ("repro_pool_decode_steps_total",
                     "virtual decode-step clock (chunks x chunk size)"),
    "total_emitted": ("repro_pool_emitted_total",
                      "tokens emitted (prefill + decode)"),
    "_decode_emitted": ("repro_pool_decode_emitted_total",
                        "budgeted decode tokens (excludes prefill)"),
    "submitted": ("repro_pool_submitted_total", "sessions submitted"),
    "admits": ("repro_pool_admits_total",
               "fresh sessions admitted (restores counted separately)"),
    "prefill_launches": ("repro_pool_prefill_launches_total",
                         "stacked prefill launches"),
    "admit_batches": ("repro_pool_admit_batches_total",
                      "same-length admission buckets executed"),
    "preemptions": ("repro_pool_preemptions_total", "sessions parked"),
    "page_stalls": ("repro_pool_page_stalls_total",
                    "parks forced by page pressure"),
    "restores": ("repro_pool_restores_total", "parked sessions restored"),
    "cancels": ("repro_pool_cancels_total", "sessions cancelled"),
}
_POOL_GAUGES = {
    "active": ("repro_pool_active", "sessions decoding this step"),
    "waiting": ("repro_pool_waiting", "fresh sessions queued"),
    "parked": ("repro_pool_parked", "preempted sessions queued"),
    "pages_free": ("repro_pool_pages_free", "free sub-pages, all banks"),
    "occupancy": ("repro_pool_occupancy",
                  "budgeted decode tokens per slot-step"),
}
_POOL_FAMILIES = (
    {k: obs_metrics.counter(name, help, ("pool",))
     for k, (name, help) in _POOL_COUNTERS.items()}
    | {k: obs_metrics.gauge(name, help, ("pool",))
       for k, (name, help) in _POOL_GAUGES.items()}
)
_CHUNK_SECONDS = obs_metrics.histogram(
    "repro_pool_chunk_seconds",
    "wall seconds per decode chunk (dispatch, no forced sync)", ("pool",))


@dataclasses.dataclass
class PageState:
    """Host-side parking image of one preempted session: its LIVE KV
    sub-pages flattened to a logical ``n_pages * page_size`` row per
    global-attn leaf (``len`` leaves ride along, all on the CPU), the
    decode position, the current token and its token row.  Under a model
    axis, the rank's block of those pages (its KV heads, or its slots of
    each page), restored on the same rank."""
    caches: Any                        # {"blocks": [...], "tail": [...]}
    pos: int
    cur: int
    row: np.ndarray                    # (row_len,) token content
    row_len: int
    n_pages: int                       # live sub-pages saved per leaf


class SessionPool:
    """Paged continuous-batching state for one
    :class:`~repro_torch.serve.Engine`.

    ``slots`` sessions are split across ``n_banks`` equal banks (the model
    batch is all banks' rows).  ``page_size`` sets the sub-page width in
    tokens (default ``max_len``: one page per session, the whole-row
    layout); ``pages_per_bank`` sets each bank's sub-page count (default:
    every slot's worst case).  ``gen`` fixes the pool-wide sampling
    parameters; budgets come from ``submit``.  ``chunk`` tokens decode
    per ``step``.  ``bank_backend`` routes the token banks: ``"cuda"``
    moves sub-pages with the ``gather_rows`` / ``scatter_rows`` kernels
    and commits each bank with one ``fused_stream`` launch (their plain
    twins on CPU tensors), ``"reference"`` uses the plain twins and the
    unfused reference program; by default the engine's ``cpm_backend``
    (``cuda`` on a CUDA device).  ``rng`` is the ``torch.Generator`` of
    sampled rows (seed 0 on the engine's device by default).
    ``admit_batching=False`` admits one session per bucket (strict FIFO).
    """

    decode_steps = obs_metrics.series_property("decode_steps")
    total_emitted = obs_metrics.series_property("total_emitted")
    _decode_emitted = obs_metrics.series_property("_decode_emitted")
    submitted = obs_metrics.series_property("submitted")
    admits = obs_metrics.series_property("admits")
    prefill_launches = obs_metrics.series_property("prefill_launches")
    admit_batches = obs_metrics.series_property("admit_batches")
    preemptions = obs_metrics.series_property("preemptions")
    page_stalls = obs_metrics.series_property("page_stalls")
    restores = obs_metrics.series_property("restores")
    cancels = obs_metrics.series_property("cancels")

    def __init__(self, engine, slots: int = 8, n_banks: int = 1, gen=None,
                 chunk: int = 1, bank_backend: str | None = None, rng=None,
                 admit_batching: bool = True, page_size: int | None = None,
                 pages_per_bank: int | None = None):
        from .engine import GenConfig

        if engine.cfg.enc_dec:
            raise NotImplementedError(
                "session pool supports decoder-only models (cross-attention "
                "pages are encoder-owned)")
        if slots <= 0 or n_banks <= 0 or slots % n_banks:
            raise ValueError(f"slots ({slots}) must be a positive multiple "
                             f"of n_banks ({n_banks})")
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.engine = engine
        self.device = engine.device
        self.gen = gen if gen is not None else GenConfig()
        self.slots = slots
        self.n_banks = n_banks
        self.rows_per_bank = slots // n_banks
        self.chunk = chunk
        self.max_len = engine.max_len

        pg = self.max_len if page_size is None else page_size
        if not 0 < pg <= self.max_len or self.max_len % pg:
            raise ValueError(
                f"page_size ({pg}) must be a positive divisor of max_len "
                f"({self.max_len})")
        self.page_size = pg
        self.C = self.max_len // pg        # page-table width per slot
        ppb = (self.rows_per_bank * self.C if pages_per_bank is None
               else pages_per_bank)
        if ppb <= 0:
            raise ValueError(f"pages_per_bank must be positive, got {ppb}")
        self.pages_per_bank = ppb
        self.total_pages = n_banks * ppb   # doubles as the table sentinel

        self.alloc = SlotAllocator(slots, n_pages=self.total_pages)
        if bank_backend is None:
            bank_backend = engine.cpm_backend
        self.banks = [CPMBank(ppb, pg, backend=bank_backend,
                              device=self.device) for _ in range(n_banks)]
        self.sched = MultiBankScheduler(self.banks)
        self._commits = [self.sched.compiled_commit(b, chunk,
                                                    rows=self.rows_per_bank)
                         for b in range(n_banks)]
        self.table = SessionTable()

        caches = lm.init_caches(engine.cfg, slots, self.max_len,
                                device=self.device)
        caches = kv_cache.broadcast_lens(caches, slots)
        self.caches = kv_cache.paged_pool(caches, engine.cfg,
                                          self.total_pages, pg)
        i32 = dict(dtype=torch.int32, device=self.device)
        self.pos = torch.zeros((slots,), **i32)
        self.cur = torch.zeros((slots,), **i32)
        self.tok_lens = torch.zeros((slots,), **i32)
        self.live = np.zeros((slots,), bool)
        self._free_hint = slots            # host mirror of the free count
        self._rng = rng if rng is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self.admit_batching = admit_batching

        # host mirrors of each slot's sampling params
        self._temp = np.full((slots,), self.gen.temperature, np.float32)
        self._topk = np.full((slots,), self.gen.top_k, np.int32)
        self._topp = np.full((slots,), self.gen.top_p, np.float32)

        self._pool_label = str(next(_POOL_IDS))
        self._obs_series = {k: fam.labels(pool=self._pool_label)
                            for k, fam in _POOL_FAMILIES.items()}
        self._chunk_hist = _CHUNK_SECONDS.labels(pool=self._pool_label)
        self.last_chunk_s = 0.0            # dispatch wall time, last chunk

    # -- host -> device ----------------------------------------------------
    def _dev(self, a) -> torch.Tensor:
        """A host array on the pool's device; on the card the copy is
        asynchronous (from pinned memory), so it never waits for the
        chunk in flight."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # -- paging arithmetic --------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        """Sub-pages needed to hold ``tokens`` of content."""
        return -(-tokens // self.page_size)

    def _bank_of(self, slot: int) -> int:
        return slot // self.rows_per_bank

    def _page_range(self, bank: int) -> tuple[int, int]:
        """Bank ``bank``'s slice of the global sub-page id space."""
        return bank * self.pages_per_bank, (bank + 1) * self.pages_per_bank

    def _grant0(self, prompt_len: int) -> int:
        """Admission grant: pages covering the prompt + its prefill token."""
        return min(self.C, self.pages_for(prompt_len + 1))

    # -- public API ---------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int | None = None,
               gen=None) -> int:
        """Queue one session; returns its id.  ``gen`` optionally overrides
        the pool GenConfig's sampling params for this session; the budget
        is ``max_new_tokens``, else the request's then the pool's
        GenConfig.  Empty prompts, non-positive budgets, requests longer
        than a logical row, and requests whose worst-case page count
        exceeds one bank raise ``ValueError``."""
        tokens = torch.as_tensor(np.asarray(tokens, np.int32)).reshape(-1) \
            if not isinstance(tokens, torch.Tensor) else tokens.reshape(-1)
        tokens = tokens.to(self.device, torch.int32)
        s = int(tokens.shape[0])
        if s < 1:
            raise ValueError(
                "empty prompt: a session needs at least one prompt token")
        g = self.gen if gen is None else gen
        if gen is not None and getattr(gen, "ngram_spec", 0):
            raise ValueError(
                "pooled serving is non-speculative: per-request "
                "ngram_spec is not supported")
        budget = g.max_new_tokens if max_new_tokens is None else max_new_tokens
        if budget <= 0:
            raise ValueError(
                f"max_new_tokens must be positive, got {budget}: a "
                "session must generate at least one token")
        if s + budget > self.max_len:
            raise ValueError(
                f"prompt ({s}) + budget ({budget}) exceeds max_len "
                f"({self.max_len}); pages are max_len wide")
        worst = min(self.C, self.pages_for(s + budget - 1 + self.chunk))
        if worst > self.pages_per_bank:
            raise ValueError(
                f"prompt ({s}) + budget ({budget}) needs up to {worst} "
                f"sub-pages of {self.page_size} tokens, but bank capacity "
                f"is {self.pages_per_bank} pages — the session could "
                f"never be seated")
        sess = self.table.add(tokens, s, budget)
        sess.gen = g
        self.submitted += 1
        return sess.sid

    def _vclock(self) -> int:
        """The pool's virtual clock for spans: decode steps elapsed."""
        return self.decode_steps

    def step(self) -> dict:
        """Admit -> decode ``chunk`` tokens for every live session ->
        retire.  Returns a stats snapshot (see :meth:`stats`)."""
        self.last_chunk_s = 0.0
        self._admit()
        self._retire()                      # budget-1 sessions finish on admit
        if self.table.active_count():
            self._ensure_pages()            # slack for the next chunk
        if self.table.active_count():
            self._decode_chunk()
            self._retire()
        return self.stats()

    def drain(self) -> dict[int, np.ndarray]:
        """Step until every submitted session is DONE; returns ``{sid:
        (prompt + generated,) int32}`` for the sessions finished since the
        last drain (delivered sessions leave the table)."""
        while not self.table.all_done():
            self.step()
        return self.table.collect_finished()

    def stats(self) -> dict:
        steps = self.decode_steps
        st = {
            "decode_steps": steps,
            "emitted": self.total_emitted,
            "occupancy": (self._decode_emitted / (steps * self.slots)
                          if steps else 0.0),
            "active": self.table.active_count(),
            "waiting": (self.table.waiting_count()
                        - self.table.parked_count()),
            "parked": self.table.parked_count(),
            "pages_free": self.alloc.page_free_count(),
            "bank_launches": self.sched.bank_launches,
            "streams_packed": self.sched.streams_packed,
            "prefill_launches": self.prefill_launches,
            "admit_batches": self.admit_batches,
            "preemptions": self.preemptions,
            "page_stalls": self.page_stalls,
            "restores": self.restores,
            "cancels": self.cancels,
            "submitted": self.submitted,
            "admits": self.admits,
        }
        for key in _POOL_GAUGES:
            self._obs_series[key].set(st[key])
        return st

    # -- admission ----------------------------------------------------------
    def _try_seat(self, need: int) -> int | None:
        """Reserve one slot plus ``need`` sub-pages in the slot's own bank;
        a slot whose bank is out of pages is set aside and the next
        probed.  On failure everything probed is released."""
        held: list[int] = []
        try:
            while True:
                slot = self.alloc.alloc()
                if slot is None:
                    return None
                lo, hi = self._page_range(self._bank_of(slot))
                if self.alloc.alloc_pages(slot, need, lo, hi) is not None:
                    return slot
                held.append(slot)
        finally:
            for s in held:
                self.alloc.free(s)

    def _admit(self) -> None:
        """Admit queued sessions that fit this step: a session needs a free
        slot AND its page grant in the slot's bank; the others stay queued
        in FIFO position.  The admission plan splits the seated window
        into restore groups (by saved page count, no prefill) and
        same-prompt-length buckets (one stacked prefill each)."""
        from .gateway import admission
        take = min(self._free_hint, self.table.waiting_count())
        if not take:
            return
        seated: dict[int, int] = {}
        for sess in self.table.peek_waiting(take):
            need = (sess.parked.n_pages if sess.phase == PARKED
                    else self._grant0(sess.prompt_len))
            slot = self._try_seat(need)
            if slot is None:
                continue
            seated[sess.sid] = slot
            self._free_hint -= 1
            obs_tracing.instant("pool.page_grant", cat="pool",
                                vstep=self.decode_steps,
                                args={"slot": slot, "pages": need})
        if not seated:
            return
        with obs_tracing.span("pool.admission", cat="pool",
                              vclock=self._vclock,
                              args={"seated": len(seated)}) as sp:
            plan = admission.plan(
                [s for s in self.table.peek_waiting(take)
                 if s.sid in seated],
                batching=self.admit_batching)
            sp.args["restore_groups"] = len(plan.restores)
            sp.args["buckets"] = len(plan.buckets)
            for group in plan.restores:
                self._restore_group(list(group), seated)
            for bucket in plan.buckets:
                self._admit_bucket(list(bucket), seated)

    def _note_admit(self, sess, slot: int) -> None:
        """Host mirrors for one freshly seated session."""
        sess.admit_step = self.decode_steps
        if sess.first_admit_step < 0:
            sess.first_admit_step = self.decode_steps
        self.live[slot] = True
        self._temp[slot] = sess.gen.temperature
        self._topk[slot] = sess.gen.top_k
        self._topp[slot] = sess.gen.top_p

    def _page_table_rows(self, slots: list[int], width: int) -> np.ndarray:
        """Page-table rows for ``slots``: each page list left-aligned into a
        ``(k, width)`` table, sentinel (``total_pages``) beyond it."""
        pt = np.full((len(slots), width), self.total_pages, np.int32)
        for i, slot in enumerate(slots):
            ids = self.alloc.pages(slot)[:width]
            pt[i, :len(ids)] = ids
        return pt

    def _scatter_token_pages(self, pairs) -> None:
        """Write admitted or restored token rows into their banks: ``pairs``
        is ``[(slot, row (tensor or numpy), row_len)]``; each row is
        page-chunked onto the slot's page list with per-page lengths."""
        per_bank: dict[int, list] = {}
        for slot, row, row_len in pairs:
            per_bank.setdefault(self._bank_of(slot), []).append(
                (slot, row, row_len))
        pg = self.page_size
        for bank_id, members in per_bank.items():
            base = bank_id * self.pages_per_bank
            idx: list[int] = []
            lens: list[int] = []
            chunks = []
            for slot, row, row_len in members:
                n_live = self.pages_for(row_len)
                idx += [p - base for p in self.alloc.pages(slot)[:n_live]]
                lens += [min(pg, max(0, row_len - r * pg))
                         for r in range(n_live)]
                row = torch.as_tensor(row).to(self.device,
                                              torch.int32).reshape(-1)
                padded = torch.zeros((n_live * pg,), dtype=torch.int32,
                                     device=self.device)
                take = row[:n_live * pg]
                padded[:take.shape[0]] = take
                chunks.append(padded.reshape(n_live, pg))
            self.banks[bank_id].scatter(
                self._dev(np.asarray(idx, np.int32)), torch.cat(chunks),
                self._dev(np.asarray(lens, np.int32)))

    def _sample(self, logits, temp, topk, topp) -> torch.Tensor:
        """Per-row sampling; all-greedy rows (a host mirror) skip the
        sampler's sort, which returns the same argmax."""
        if not (temp > 0).any():
            return sampling.greedy(logits)
        return sampling.shared_draw(sampling.sample_rows(
            logits, self._rng, self._dev(temp), self._dev(topk),
            self._dev(topp)))

    def _admit_bucket(self, bucket, seated: dict[int, int]) -> None:
        """Check a same-prompt-length bucket of fresh sessions in with one
        stacked prefill and one scatter of their pages."""
        k, s = len(bucket), bucket[0].prompt_len
        with obs_tracing.span("pool.admit_bucket", cat="pool",
                              vclock=self._vclock,
                              args={"sessions": k, "prompt_len": s}):
            engine, cfg = self.engine, self.engine.cfg
            slots = [seated[sess.sid] for sess in bucket]
            prompts = torch.stack([sess.prompt for sess in bucket])
            with obs_tracing.span("pool.prefill", cat="pool",
                                  vclock=self._vclock,
                                  args={"sessions": k, "prompt_len": s}):
                logits, caches1 = lm.prefill(engine.params, cfg,
                                             {"tokens": prompts},
                                             max_len=self.max_len,
                                             page_size=self.page_size)
            caches1 = kv_cache.broadcast_lens(caches1, k)
            first = self._sample(
                logits[:, -1],
                np.asarray([se.gen.temperature for se in bucket], np.float32),
                np.asarray([se.gen.top_k for se in bucket], np.int32),
                np.asarray([se.gen.top_p for se in bucket], np.float32))
            pt = self._dev(self._page_table_rows(slots, self.C))
            idx = self._dev(np.asarray(slots, np.int64))
            self.caches = kv_cache.seat_caches(self.caches, caches1, cfg,
                                               idx, pt)
            self.pos[idx] = s
            self.cur[idx] = first
            self.tok_lens[idx] = s + 1
            rows = torch.zeros((k, self.max_len), dtype=torch.int32,
                               device=self.device)
            rows[:, :s] = prompts
            rows[:, s] = first
            self.prefill_launches += 1
            self.admit_batches += 1
            self.admits += k
            for sess, slot in zip(bucket, slots):
                self.table.activate(sess.sid, self._bank_of(slot), slot)
                self._note_admit(sess, slot)
                sess.emitted = 1                # the prefill token
                self.total_emitted += 1
            self._scatter_token_pages(
                [(slot, rows[i], s + 1) for i, slot in enumerate(slots)])

    # -- preemption (mechanism) ---------------------------------------------
    def park(self, sid: int) -> None:
        """Preempt an ACTIVE session: copy its LIVE sub-pages into a
        host-side :class:`PageState`, free its slot and page list, and
        re-queue it at the FIFO tail for a token-identical restore."""
        sess = self.table.get(sid)
        if sess.phase != ACTIVE:
            raise ValueError(f"session {sid} is {sess.phase}, not active")
        if sess.finished:
            raise ValueError(f"session {sid} already hit its budget; "
                             "step() will retire it")
        slot = sess.slot
        row_len = sess.prompt_len + sess.emitted
        n_live = self.pages_for(row_len)
        with obs_tracing.span("pool.park", cat="pool", vclock=self._vclock,
                              args={"sid": sid, "pages": n_live}):
            row = self._read_row(sess)
            pt1 = self._dev(self._page_table_rows([slot], n_live))
            image = kv_cache.lift_slot(self.caches, self.engine.cfg, slot,
                                       pt1)
            sess.parked = PageState(
                caches=lm.tree_map(lambda t: t.cpu(), image),
                pos=int(self.pos[slot]), cur=int(self.cur[slot]), row=row,
                row_len=row_len, n_pages=n_live)
            sess.parks += 1
            self.preemptions += 1
            self.table.park(sid)
            self._release(slot)

    def _release(self, slot: int) -> None:
        """Slot + page list back to the free files, mirrors pinned."""
        self.alloc.free(slot)
        self._free_hint += 1
        self.live[slot] = False
        self.pos[slot] = 0
        self.cur[slot] = 0
        self.tok_lens[slot] = 0

    def _restore_group(self, group, seated: dict[int, int]) -> None:
        """Re-admit parked sessions with the same saved page count: one
        re-seat of the group's saved sub-pages / positions / tokens (no
        prefill), then each token row scatters onto its new page list."""
        states = [sess.parked for sess in group]
        k, n_live = len(group), states[0].n_pages
        with obs_tracing.span("pool.restore", cat="pool",
                              vclock=self._vclock,
                              args={"sessions": k, "pages": n_live}):
            slots = [seated[sess.sid] for sess in group]
            blocks = lm.tree_map(
                lambda *xs: torch.stack(xs, dim=1).to(self.device),
                *[st.caches["blocks"] for st in states])
            tail = lm.tree_map(
                lambda *xs: torch.stack(xs).to(self.device),
                *[st.caches["tail"] for st in states])
            pt = self._dev(self._page_table_rows(slots, n_live))
            idx = self._dev(np.asarray(slots, np.int64))
            self.caches = kv_cache.seat_caches(
                self.caches, {"blocks": blocks, "tail": tail},
                self.engine.cfg, idx, pt)
            self.pos[idx] = self._dev(
                np.asarray([st.pos for st in states], np.int32))
            self.cur[idx] = self._dev(
                np.asarray([st.cur for st in states], np.int32))
            self.tok_lens[idx] = self._dev(
                np.asarray([st.row_len for st in states], np.int32))
            for sess, slot in zip(group, slots):
                self.table.activate(sess.sid, self._bank_of(slot), slot)
                self._note_admit(sess, slot)
                sess.parked = None
                self.restores += 1
            self._scatter_token_pages(
                [(slot, st.row, st.row_len)
                 for slot, st in zip(slots, states)])

    def victim_session(self):
        """The allocator's LRU eviction candidate (§7.5 min over ticks on
        the metadata device) as a Session, or None."""
        slot = self.alloc.victim()
        return self.table.at_slot(slot) if slot is not None else None

    # -- cancellation / inspection ------------------------------------------
    def _local_pages(self, sess, n: int) -> list[int]:
        base = self._bank_of(sess.slot) * self.pages_per_bank
        return [p - base for p in self.alloc.pages(sess.slot)[:n]]

    def _read_row(self, sess) -> np.ndarray:
        """A session's token content reassembled from its live sub-pages
        (host copy)."""
        row_len = sess.prompt_len + sess.emitted
        local = self._local_pages(sess, self.pages_for(row_len))
        pages = self.banks[sess.bank].gather(
            self._dev(np.asarray(local, np.int32)))
        return pages.cpu().numpy().reshape(-1)[:row_len]

    def _row_committed(self, sess) -> int:
        """Summed page-length registers of a session's live sub-pages —
        the bank's own view of how many tokens it holds."""
        row_len = sess.prompt_len + sess.emitted
        local = self._local_pages(sess, self.pages_for(row_len))
        lens = self.banks[sess.bank].lens.cpu().numpy()
        return int(lens[np.asarray(local, np.int64)].sum())

    def cancel(self, sid: int) -> np.ndarray:
        """Abort a session in any phase; returns prompt + whatever it
        generated.  The tokens stay collectible (DONE) until the next
        drain or collect."""
        sess = self.table.get(sid)
        if sess.phase == DONE:
            return np.asarray(sess.tokens)
        if sess.phase == ACTIVE:
            row = self._read_row(sess)
            self.table.finish(sid, row)
            self._release(sess.slot)
        elif sess.phase == PARKED:
            st = sess.parked
            self.table.finish(sid, np.asarray(st.row[:st.row_len]))
        else:                               # WAITING: nothing ran yet
            self.table.finish(sid, sess.prompt.cpu().numpy())
        self.cancels += 1
        return np.asarray(sess.tokens)

    def peek_tokens(self, sid: int) -> np.ndarray:
        """Host snapshot of a session's tokens so far (prompt + emitted),
        in any phase — what the gateway's streaming iterator reads."""
        sess = self.table.get(sid)
        if sess.phase == ACTIVE:
            return self._read_row(sess)
        if sess.phase == PARKED:
            return np.asarray(sess.parked.row[:sess.parked.row_len])
        if sess.phase == DONE:
            return np.asarray(sess.tokens)
        return sess.prompt.cpu().numpy()

    # -- decode -------------------------------------------------------------
    def _ensure_pages(self) -> None:
        """Host-side top-up between chunks: every active session gets
        enough pages for the next chunk's KV and token writes.  When a
        bank runs dry the *youngest* sessions park, so the oldest always
        progresses (submit bounds every worst case to one bank)."""
        order = sorted(self.table.active(),
                       key=lambda s: (s.first_admit_step, s.sid))
        for sess in reversed(order):
            need = min(self.C, self.pages_for(
                sess.prompt_len + sess.emitted + self.chunk))
            have = len(self.alloc.pages(sess.slot))
            if need <= have:
                continue
            lo, hi = self._page_range(self._bank_of(sess.slot))
            if self.alloc.alloc_pages(sess.slot, need - have,
                                      lo, hi) is None:
                self.page_stalls += 1
                self.park(sess.sid)
            else:
                obs_tracing.instant(
                    "pool.page_topup", cat="pool", vstep=self.decode_steps,
                    args={"slot": sess.slot, "pages": need - have})

    def _decode_chunk(self) -> None:
        """Stage the chunk's host inputs, run :meth:`_chunk` (no host read
        inside), adopt its results and do the host-mirror accounting."""
        active = self.table.active()
        with obs_tracing.span("pool.decode_chunk", cat="pool",
                              vclock=self._vclock,
                              args={"chunk": self.chunk,
                                    "active": len(active)}):
            budget_left = np.zeros((self.slots,), np.int32)
            pt = np.full((self.slots, self.C), self.total_pages, np.int32)
            for sess in active:
                budget_left[sess.slot] = sess.budget - sess.emitted
                ids = self.alloc.pages(sess.slot)
                pt[sess.slot, :len(ids)] = ids
            greedy_only = not (self._temp > 0).any()
            t0 = time.perf_counter()
            self._chunk(self._dev(self.live), self._dev(budget_left),
                        self._dev(pt), greedy_only)
            # dispatch wall time only: no device sync here
            self.last_chunk_s = time.perf_counter() - t0
            self._chunk_hist.observe(self.last_chunk_s)

            for sess in active:             # host-mirror accounting only
                emit = min(self.chunk, sess.budget - sess.emitted)
                sess.emitted += emit
                self.total_emitted += emit
                self._decode_emitted += emit
            self.decode_steps += self.chunk
            self.sched.bank_launches += self.n_banks  # packed commits
            self.sched.streams_packed += len(active)
            obs_tracing.instant("pool.commit_packed", cat="pool",
                                vstep=self.decode_steps,
                                args={"banks": self.n_banks,
                                      "streams": len(active)})

    def _chunk(self, live, budget_left, page_tbl, greedy_only: bool) -> None:
        """The decode chunk, paged end to end, with no host read between
        its gather and its scatter: gather every session's logical KV row
        through the page table, run ``chunk`` decode steps with per-row
        positions (dead rows stay pinned — position frozen, token 0),
        scatter the DIRTY KV pages back, and per bank gather the logical
        token rows, commit them with the packed ``insert -> truncate``
        stream and scatter the dirty token pages back (clean pages take
        the sentinel and drop).  Rows whose budget ends mid-chunk decode
        into slack; ``emit`` clamps what the commit makes visible."""
        engine, cfg = self.engine, self.engine.cfg
        rpb, C, pg, ppb = (self.rows_per_bank, self.C, self.page_size,
                           self.pages_per_bank)
        if not greedy_only:
            temp, topk, topp = (self._dev(a) for a in
                                (self._temp, self._topk, self._topp))
        pos0 = self.pos
        cur, pos = self.cur, self.pos
        logical = kv_cache.logical_view(self.caches, cfg, page_tbl)
        toks = []
        for _ in range(self.chunk):
            logits, logical = lm.decode_step(
                engine.params, cfg, cur[:, None], logical, pos,
                max_len=self.max_len, page_size=self.page_size)
            nxt = sampling.greedy(logits[:, -1]) if greedy_only else \
                sampling.shared_draw(sampling.sample_rows(
                    logits[:, -1], self._rng, temp, topk, topp))
            cur = torch.where(live, nxt, 0)
            pos = torch.where(live, pos + 1, pos)
            toks.append(cur)
        toks = torch.stack(toks, dim=1)                   # (slots, chunk)
        emit = torch.where(live, torch.clamp(budget_left, max=self.chunk), 0)
        rank = torch.arange(C, dtype=torch.int32, device=self.device)[None]
        kv_dirty = rank >= (pos0 // pg)[:, None]          # (slots, C)
        self.caches = kv_cache.merge_paged(
            self.caches, logical, cfg,
            torch.where(kv_dirty, page_tbl, self.total_pages))
        new_tl = []
        for b, bank in enumerate(self.banks):
            rows = slice(b * rpb, (b + 1) * rpb)
            ptb = page_tbl[rows] - b * ppb                # (rpb, C) local
            flat = ptb.reshape(-1)
            lrows = bank.gather(flat.clamp(0, ppb - 1)).reshape(rpb, C * pg)
            lens_b = self.tok_lens[rows]
            d_rows, l_rows = self._commits[b](lrows, lens_b, toks[rows],
                                              emit[rows])
            # dirty pages only; a clean page is full before and after the
            # chunk, so its length register (page_size) needs no write
            tok_dirty = rank >= (lens_b // pg)[:, None]
            bank.scatter(torch.where(tok_dirty, ptb, ppb).reshape(-1),
                         d_rows.reshape(rpb * C, pg),
                         torch.clamp(l_rows[:, None] - rank * pg, 0,
                                     pg).reshape(-1))
            new_tl.append(l_rows)
        self.cur, self.pos = cur, pos
        self.tok_lens = torch.cat(new_tl)

    # -- retirement ---------------------------------------------------------
    def _retire(self) -> None:
        for sess in list(self.table.active()):
            if not sess.finished:
                continue
            ln = self._row_committed(sess)
            assert ln == sess.prompt_len + sess.emitted, (
                ln, sess.prompt_len, sess.emitted)
            self.table.finish(sess.sid, self._read_row(sess))
            self._release(sess.slot)

