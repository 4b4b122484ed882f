#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # full-width, full-depth granite-8b
    python3 chip_smoke.py --layers 4      # cut depth (debugging)

Phases, in order; any failure exits non-zero:

  1. build every CUDA kernel of ``src/repro_torch/csrc`` (one nvcc each,
     all started together) and print the registers, static shared memory
     and spills ``-Xptxas -v`` reports for the kernels of the sort, flash
     attention, ``shift_range``, ``stencil``, ``histogram`` and
     ``template_match``, and the instruction counts of the sort's
     odd-even kernel (``cuobjdump -sass``) for its issue floor;
  2. hold each kernel against its plain PyTorch twin on the card, at the
     main paths' shapes, and time kernel, twin and the one PyTorch call
     that computes the same function where there is one
     (``scaled_dot_product_attention`` with ``enable_gqa``, and pinned
     to its flash backend on K/V repeated outside the timing, each with
     the kernels it ran; ``index_select`` for
     ``gather_rows``, ``index_copy_`` on a clone for ``scatter_rows``):
     device time from ``torch.profiler`` (CUDA events when it records
     none) and per-call time with events.  ``fused_stream`` is held
     against its twin at the serving commit (4, 320), on nine-op streams
     (7, 300) and on the cost model's probe stream over (64, 16,384) and
     (64, 1,048,576) rows, and each of the commit and the two probes is
     timed under its plan (tiles, halos, passes; a row held in one tile,
     as the commit's, runs the resident-row kernel) beside the eager
     plan's summed device time, in the same process; an empty kernel
     (built here from ``EMPTY_KERNEL``) is timed as the launch floor;
     flash attention again at head dim 256 (recurrentgemma-9b's B = 2,
     H = 16, KVH = 1, S = 2,304; bf16 and float32, causal with no window,
     window 2,048 and window 100, strided and packed), the bf16
     window-2,048 case timed beside its bound and SDPA with the window
     as a mask; and at seamless-m4t-large-v2's shapes (B = 4,
     H = KVH = 16, D = 64, strided, bf16 and float32), bidirectional: the
     encoder's Sq = Skv = 1,024 and cross attention's Sq = 64 over
     Skv = 1,024, each bf16 case timed beside its bound and SDPA;
  3. check the port end to end on a small input: the smoke config on the
     card (kernels) against the same weights on the CPU (plain twins);
  4. build granite-8b at full width from a seeded ``torch.Generator`` on
     the card (~8.3B float32 parameters);
  5. serve 4 requests of 256 prompt tokens built from repeated n-grams
     through ``Engine.generate``: greedy on the scan path, then with
     ``ngram_spec=4`` and ``cpm_backend="cuda"``, with the launch counters
     set to 0 just before and read just after; the speculative tokens must
     equal the scan tokens, flash attention must launch at least once per
     layer per prefill, and the commit, scheduled by the cost model
     (phases 1-8 price with its priors: no calibration, no tuning), must
     launch what its verdict implies — one ``fused_stream`` a round, or
     one ``shift_range`` a round (the eager ``insert`` over every row's
     own bounds) — and no other per-op CPM kernel;
  6. serve 12 greedy requests through ``Gateway.tick`` over the paged
     session pool on the same weights (8 slots in 2 banks, chunk 4,
     32-token pages, 24 pages per bank, no backend named so that the
     engine and its banks default to the kernels, LRU preemption on): 4 incumbents of 128 prompt tokens and budget 32 at
     tick 0, bursts of 4 at ticks 2 (64 tokens) and 3 (256 tokens), budget
     8.  Every request must finish with its budget, its tokens must equal
     a solo ``Engine.generate`` (a differing token only at a near-tie of
     the solo path's teacher-forced logits, within 2e-2 of the max), the
     pool must preempt and give every page back; over one steady
     ``pool.step()`` (counters set to 0 just before), ``gather_rows``,
     ``fused_stream`` and ``scatter_rows`` must each launch once per bank
     and the decode chunk must not synchronize with the host;
  7. the paper's CPM operator surface and the self-managing allocator on
     the kernels: ``cpm_array(..., backend="cuda")`` over (64, 1,048,576)
     seeded int32 rows in [0, 4096) and float32 normal rows, per-row
     ``used_len = N - 4099 r``: ``compare``/``count`` (int and float
     datum), ``compact`` (about half the lanes kept), ``section_sum``,
     ``global_limit`` max and min, with the counters set to 0 just before
     and read just after.  Each result against the kernel's plain twin on
     the same inputs (bit for bit; float sums, kernel and twin, within
     1e-5 x sum|x| of NumPy's float64 sum) and against NumPy for the
     counts and int sums; every kernel run twice, bit for bit;
     ``global_limit`` again on rows planted with NaN and +-inf; the same
     ops under ``backend="auto"`` launch the same kernels, an 8-lane row
     under ``"auto"`` none.  Then ``SlotAllocator(256, n_pages=16384,
     backend="cuda")`` (metadata on the card) over a seeded 300-operation
     trace, every answer equal to ``OracleAllocator`` and a reference
     ``SlotAllocator`` on the CPU; ``compare``, ``section_limit`` and
     ``compact`` must launch.  The four kernels are timed at these shapes;
  8. the paper's §5 search, §6.3 histogram, §8 super ops and §7.7 sort
     through ``cpm_array(..., backend="cuda")``, with the counters set to
     0 just before and read just after: ``find_all`` of needles of 2, 8
     and 32 items (the paper benchmark's T2 lengths) in phase 7's int
     rows cut to four symbols, and the match-end flags of a float needle
     in the float rows; ``histogram`` of phase 7's rows with 8
     and 64 integer edges, 64 fractional float32 edges, and float rows
     with NaN; ``super_sum`` and ``super_limit`` (max, min) of the int and
     float rows and of rows with NaN; a full ``sort`` of (64, 16,384) int32
     and float32 rows (subnormals planted, one row with NaN), a bounded
     one of ``optimal_section(16,384) = 128`` cycles, and the bounded local
     phase of 1024 cycles on phase 7's (64, 1,048,576) int rows (halo
     tiles); after the counted path, a full sort of those long rows (the
     bitonic route) against ``torch.sort(...).values`` and, on three
     rows, ``np.sort`` (its twin, 2^20 cycles deep, is not run).  Each
     result against the kernel's twin (bit for bit; float
     sums within 1e-5 x sum|x| of NumPy), match addresses against the
     reference backend and NumPy, integer super sums against
     ``section_sum``, limits against ``global_limit``, full sorts against
     ``np.sort`` on rows without NaN; every kernel twice, bit for bit;
     ``backend="auto"`` the same launches, none on an 8-lane row.  After
     the counted path, ``histogram`` of the int rows with the 64 edges
     shuffled and of the float rows with a NaN edge (both the counts
     form; ordered edges take the bin search) against its twin.  The
     five kernels are timed at these shapes (``histogram`` at 8 and 64
     edges on both forms, each with the form its blocks took), the full
     sorts (16,384 and 1,048,576 lanes) beside ``torch.sort``, with the
     device launches of each sort call (``torch.profiler``), and each
     odd-even case on its own (1,024 cycles of the long rows, 128 cycles
     of int32 and of float32 rows, the float full sort with its NaN row,
     and 128 cycles of NaN-free float32 rows against the same rows with a
     NaN in every tile: the integer loop against the NaN loop, each held
     against the twin), each with its plan, its device launches, its
     bound at the published peaks and its issue floor;
  9. instruction streams priced by cost, on phase 7's rows: with a scalar
     ``used_len = N - 7`` (each op one launch, counted), ``activate``,
     ``shift`` (with and without a fill, negative), ``insert`` and
     ``delete`` on int32 and float32 rows, ``shift`` on bool and int8
     rows (the byte path), ``template_match`` with templates of 4, 16
     and 64 items cut from the rows (the paper benchmark's T6 lengths),
     ``stencil((1, 2, 1))`` zero-padded and ringed on float32 and int32
     rows and a five-tap stencil with zero taps, each result bit for bit
     with the kernels' plain twins run in their place and with the
     reference backend (the stencil within 1e-5 relative); ``insert``
     and ``delete`` on the per-row lengths through ``CPMProgram.run``
     (one ``fused_stream`` launch over the long rows' tiles where the
     program's plan fuses them, else one ``shift_range`` launch each over
     all 64 rows, per-row bounds).
     Then the cost model calibrates on the card into
     ``build/chip_smoke/`` (its four coefficients printed with the card),
     its probe stream runs forced fused and forced eager on (64, 16,384)
     int32 rows, bit for bit, with the calibrated verdict, and the
     ``auto`` crossover is measured and read back; phase 5's speculative
     path runs three times: with the commit priced by the calibrated
     model, then under coefficients that force each verdict (one
     ``fused_stream`` a round, then one ``shift_range`` a round), each
     with the launches its verdict implies, tokens equal to the scan
     path's, no host sync in a commit and one a round, the two forced
     runs and their commits at the generate shape timed in the same
     process; a small pool's steady step still launches
     ``gather_rows``, ``fused_stream`` and ``scatter_rows`` once, with no
     cost decision.  The four kernels are timed at these shapes
     (``conv1d`` beside the stencil; ``template_match`` at 4, 16 and 64
     items, each with its bytes, operation and float32 issue bounds;
     ``activate`` with its bounds by value, as phase 9 calls it, beside
     the same from device tensors);
 10. with granite-8b's weights freed, recurrentgemma-9b at full width and
     depth (38 layers: 12 units of (rglru, rglru, attn_local) and two
     rglru; 8.5B float32 parameters from a seeded generator) through
     ``Engine.generate`` at batch 2 with 2,304-token prompts (past the
     2,048-key window, so every ring wraps) and 32 new tokens, scan then
     speculative (draft 4), counters set to 0 before each: the tokens
     equal, 12 ``flash_attention`` launches a prefill (head dim 256, one
     kv head), the commit's launches as in phase 5, one host sync a round
     and none in a commit; then phase 6's gateway traffic over the paged
     pool on these weights (rings and recurrent states parked and
     restored), with phase 6's checks;
 11. granite-moe-1b-a400m at full width (24 layers, top 8 of 32
     experts) on a small input, card against the port's CPU run of the
     same weights: the last prefill logits in float32 compute within
     phase 3's tolerance (2e-2 x max(1, |logit|)); in bf16, the served
     dtype, every layer from the CPU's input to it, its routing equal but
     at near-ties and its hidden state within 2e-2 of each token's largest
     value (the full-depth bf16 logits printed beside); then
     ``Engine.generate`` scan and speculative with tokens/s, acceptance
     and the share of speculative tokens equal to the scan's, not gated:
     each decode step routes one token a row under one capacity, and a
     speculative step's are drafts at each row's own position, so where
     an expert overflows another token is dropped than in the scan;
 12. with those weights freed, xlstm-1.3b at full width and depth (48
     layers: 6 units of 7 mLSTM and 1 sLSTM, no attention; 1.94B float32
     parameters): the first mLSTM and the sLSTM layer on a 2 x 16 input
     in float32 compute, card against CPU, outputs and states within
     1e-4 x max(1, |value|); ``Engine.generate`` at 4 x 256 prompt
     tokens (one mLSTM chunk), 32 new, scan then speculative (draft 4):
     tokens equal, no ``flash_attention`` launch, the commit's launches as
     in phase 5, one host sync a round and none in a commit; then phase
     6's gateway traffic over the paged pool with phase 6's checks (the
     mLSTM / sLSTM states parked and restored; no flash launch);
 13. seamless-m4t-large-v2 at full width and depth (24 encoder and 24
     decoder layers, d_model 1,024, 16 heads of dim 64, ReLU d_ff 8,192,
     vocab 256,206; 1.63B float32 parameters): a small input (2 x 64
     frames, 2 x 16 tokens) card against CPU: the encoder output
     and last logits in float32 compute within 2e-2 x max(1, |value|);
     in bf16 every encoder and decoder layer fed the CPU's input within
     2e-2 of each token's largest value (the full-depth bf16 encoder
     output and logits printed beside); then ``Engine.generate`` with ``src_embeds`` of 4 x 1,024
     seeded normal frames under 4 x 64 prompt tokens, 32 new, scan then
     speculative (draft 4): tokens equal, 72 ``flash_attention`` launches
     a prefill (24 encoder, 24 decoder, 24 cross) and none a decode step,
     the commit's launches as in phase 5;
 14. the HTTP/SSE wire and the live obs plane, run right after phase 6 on
     its granite-8b while the weights are resident: a ``Gateway`` with
     phase 6's pool, mounted with ``start(http_port=0)`` on 127.0.0.1,
     the launch counters set to 0 just before and read just after, less
     the launches of the in-process reference run below.
     Identity: phase 6's 4 x 128-token prompts (budget 32) POSTed as SSE
     streams and one of its 64-token prompts (budget 8) as one
     ``"stream": false`` body, the tick loop held at its lock until all 5
     wait, so the batch is fixed; then a fresh ``Gateway`` over the same
     engine ``asubmit``s the same 5 in order and streams them: the wire's
     tokens and chunking equal the in-process stream's bit for bit, the
     JSON body its stream.  Launches: one steady tick with the frontend
     mounted (8 SSE streams seated), run in a worker thread as
     ``serve()`` runs it, passes phase 6's steady-step check (one
     ``gather_rows``, ``fused_stream`` and ``scatter_rows`` per bank, the
     decode chunk under ``torch.cuda.set_sync_debug_mode("error")``) and
     is timed as phase 6's step (host, CUDA events, device busy under
     ``torch.profiler``), beside one ``pool.step()`` on the event loop's
     thread.
     ``/metrics`` passes the port's strict parser and its
     ``repro_http_requests_total``, gateway and pool series equal
     ``gw.stats()``; the chunked ``/debug/trace`` body equals
     ``export.chrome_trace`` of the ring byte for byte and validates; a
     client that closes after ``start`` leaves its request cancelled and
     every slot and page free; a burst with ``deadline_steps=1`` fires the
     SLO monitor's multi-window alert once, whose flight-recorder dump
     under ``build/chip_smoke/flightrec`` validates (trace, Prometheus
     text, the allocator's page table).  Printed beside the card: time
     to the first SSE token, wire against in-process tokens/s and the
     frontend's host time per request (the wall time of each request's
     handler steps on the event loop, by route);
 15. training, after phase 13 with the serving weights freed: (a)
     ``ops.attention`` under autograd launches the flash kernel through
     ``FlashAttentionFn`` (one launch a call) and its dq, dk, dv agree
     with autograd of the plain twin within 2e-2 (bf16) / 1e-4 (float32)
     of each gradient's largest value, at granite-8b's (2, 32/8, 1,024,
     128) causal, recurrentgemma's D = 256 window 2,048, seamless's
     bidirectional encoder and cross attention, and float32; (b) one
     train step's gradients of granite-8b at full width cut to 2
     layers, 2 x 128 tokens, float32 compute, card against CPU: every
     leaf nonzero where the CPU's is and within 1e-3 of its largest
     value; (c) granite-8b at full width and 8 layers, 8 x 4,096 tokens
     (``train_4k``'s sequence) in 4 microbatches, remat, bf16: 6
     straight steps with the launch counters set to 0 just before and
     read just after (64 ``flash_attention`` launches a step, forward
     and remat recompute; finite losses), each timed on the host clock
     to a synchronize, the host syncs of one under
     ``set_sync_debug_mode("warn")`` by site, another under
     ``torch.profiler`` (busy share, top kernels), the peak memory, the
     forward kernel and the plain backward timed alone at the training
     shape; then 3 steps through ``run_loop`` with an async checkpoint
     (under ``build/chip_smoke/train_ckpt``, timed, kept for phase 17),
     the state dropped, ``resume_or_init`` into fresh tensors from a
     ``meta`` skeleton and 3 more: params bit for bit the straight
     run's, losses equal; their losses and the params' digest kept for
     phase 17.
 16. the CPM layer on a mesh of processes, after phase 15: a group of
     one rank over NCCL (a ``FileStore`` under ``build/chip_smoke``,
     ``device_id`` cuda:0; one card holds one NCCL rank, so no run
     crosses cards).  (a) ``cpm_array(..., backend="mesh")`` on phase 7's
     (64, 1,048,576) int32 and float32 rows with their per-row lengths,
     and on one unbatched row: ``section_sum``, ``super_sum``,
     ``global_limit`` and ``super_limit`` max / min, ``compare(2048,
     "lt")``, held against the ``cuda`` backend (the kernels) and the
     reference: ints, flags and limits bit for bit, float sums within
     1e-5 x sum|x|; the mesh path launches no CPM kernel (JAX's mesh path
     reaches no Pallas kernel); each op timed beside the ``cuda``
     backend's; (b) the collectives on CUDA tensors over
     ``make_host_mesh()``'s (1, 1) mesh: each returns its input unchanged
     in a new tensor and leaves the input as it was; (c) the roofline of
     phase 15's step (``roofline_terms`` / ``model_flops``) and the share
     of the card's bf16 peak its measured step reaches.  The group is
     destroyed at the end of the phase.
 17. ZeRO-3 data-parallel training, after phase 16: a group of one NCCL
     rank again (one card takes one rank, so no run crosses cards), the
     host mesh's ``make_ctx(mesh, pure_dp=True)`` (the data axes only, no
     model-axis code); phase 15's step-3 checkpoint restored
     through ``resume_or_init(..., shardings=)`` into DTensors (each rank
     its ``param_spec`` block of params, mu and nu), then steps 4-6 of
     phase 15's run through the sharded trainer (every weight all-gathered
     as its layer runs, every gradient reduce-scattered, over NCCL at n =
     1): losses and the params' digest equal phase 15's bit for bit (if
     not, the first step and the leaves that differ are printed, the
     unsharded trainer runs the same steps and every leaf is held within
     1e-3 of its largest value), 64 flash launches a step, the host
     syncs of one step by site, the collectives' bytes a step by kind and
     dtype equal to the partition rules' formula (PERF.md §6), step ms
     and peak memory beside phase 15's, one more step under
     ``torch.profiler`` (busy, NCCL kernels' time), the roofline share.
 18. tensor and expert parallelism, after phase 17: (a) flash attention at
     granite-8b's training microbatch with a rank's heads of a 4-way model
     axis, (2, 32/4 over 8/4, 4,096, 128), causal, bf16, output and
     gradients under autograd against the plain twin, the forward timed;
     (b) phase 17's run on the model-parallel path: a group of one NCCL
     rank, the host mesh's ``make_ctx(mesh)`` with its "model" axis of
     size 1 (every region operator's collective runs at n = 1, none is
     skipped), phase 15's checkpoint restored, steps 4-6: losses and the
     params' digest against phase 15's (bit for bit, else within 1e-3 as
     in phase 17), 64 flash launches and the host syncs a step, the data
     axes' bytes against phase 17's formula and the model axis's by kind
     and dtype against PERF.md's, step ms, busy, NCCL time and peak
     memory beside phase 15's; the checkpoint is removed at the end.
 19. serving under a "model" axis, run right after phase 9 on phase 5's
     weights: (a) flash attention at granite-8b's serving prefill with a
     rank's heads of a 4-way model axis, (4, 32/4 over 8/4, 256, 128),
     causal, bf16, strided as the main path lays it out, against its
     plain twin (2e-2) and timed beside its bound; (b) a group of one
     NCCL rank, the host mesh's ``make_ctx(mesh, fsdp=False)`` with its
     "model" axis of size 1 (serving weights as JAX's dry run stores
     them: ``distribute_params``' DTensors, whole on the data axes, split
     over "model"; every region operator's collective, the
     vocabulary-parallel embedding and the logits' gather run at n = 1),
     phase 5's prompts through ``Engine.generate``, scan then speculative
     (draft 4), the launch counters set to 0 just before and read just
     after: the tokens equal phase 5's bit for bit, flash launches at
     least once a layer a prefill, the commit's launches as its verdict
     implies; then the prefill and the scan decode timed, the plain path
     (no context, phase 5's) and the model-axis path alternately in the
     same phase, with the model axis's collectives a decode step.
 20. the paged session pool and the gateway under the "model" axis, run
     right after phase 19 on its NCCL group of one rank, its context and
     its distributed weights: phase 6's gateway traffic (12 requests over
     ``POOL``) under ``make_ctx(mesh, fsdp=False)``, the launch counters
     set to 0 just before and read just after: every request's tokens
     equal phase 6's bit for bit, the same preemptions, flash at least
     once a layer a prefill, the pool's kernels launched and no per-op
     CPM kernel; a steady step under the axis launches one
     ``gather_rows``, ``fused_stream`` and ``scatter_rows`` a bank with
     no host sync in the chunk (``_steady_chunk``); then a steady
     ``pool.step()`` timed on the plain path (phase 6's: no context,
     plain tensors) and on the model axis's, in turns in the same phase,
     with each path's device busy time and the model axis's collectives
     a step.

The lines before the last are the launch floor beside the kernels that
run at it, the card (``nvidia-smi`` name and power limit) and one JSON
object with every kernel's launches, error and times; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repo's ``src/repro_torch`` beside it, it
prints no result and exits non-zero.  The full record is also written to
``artifacts/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

PROMPT_LEN, MAX_NEW, BATCH, SPEC = 256, 64, 4, 4
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: D = 256, bf16: the largest error of an output row over that row's
#: largest value.  The kernel and its twin round float32 values that differ
#: by ~1e-6 to bf16, at most one ulp apart (2^-7 of the row's largest
#: value); a window one key off moves some row by over 10% of it
FLASH_ROW_TOL = 2.0 ** -6
# phase 6: the paged pool behind the gateway
POOL = dict(slots=8, n_banks=2, chunk=4, page_size=32, pages_per_bank=24)
POOL_MAX_LEN = 384
#: (gateway tick, requests, prompt tokens, budget)
POOL_TRAFFIC = ((0, 4, 128, 32), (2, 4, 64, 8), (3, 4, 256, 8))
# phase 14: seconds any wait of the wire phase may take (each is a condition
# polled every 10 ms), the disconnecting client's budget, the SLO burst and
# the /healthz round trips timed for the frontend's host time
HTTP_DEADLINE = 300.0
HTTP_DISCONNECT_BUDGET = 200
HTTP_BURST = 8
HTTP_HEALTHZ_TRIPS = 50
# phase 10: recurrentgemma-9b at full width and depth (38 layers, 12 of
# them local attention over a 2,048-key window): prompts longer than the
# window, so every ring wraps
HYB_BATCH, HYB_PROMPT, HYB_NEW, HYB_SPEC = 2, 2304, 32, 4
# phase 11: granite-moe-1b-a400m at full width: a small input card against
# CPU, then Engine.generate
MOE_SMALL = (2, 32)
MOE_BATCH, MOE_PROMPT, MOE_NEW, MOE_SPEC = 4, 256, 32, 4
NEAR_TIE = 2e-2
# phase 12: xlstm-1.3b at full width and depth (42 mLSTM and 6 sLSTM
# layers): prompts of one mLSTM chunk; the small input card against CPU
XL_SMALL = (2, 16)
XL_BATCH, XL_PROMPT, XL_NEW, XL_SPEC = 4, 256, 32, 4
XL_TOL = 1e-4
# phase 13: seamless-m4t-large-v2 at full width and depth (24 encoder and
# 24 decoder layers): 1,024 source frames (a multiple of the kernel's
# 128-key tile) under 64 prompt tokens; the small input's (batch, frames,
# tokens)
ED_SMALL = (2, 64, 16)
ED_BATCH, ED_SRC, ED_PROMPT, ED_NEW, ED_SPEC = 4, 1024, 64, 32, 4
# phase 15: training.  (a) flash gradients at the serving shapes and at
# (c)'s one microbatch of train_4k (granite-train): (name,
# B, H, KVH, Sq, Skv, D, causal, window, dtype); (b) the 2-layer cut's
# (layers, batch, sequence), card against CPU; (c) granite-8b at 8 layers,
# train_4k's sequence, global batch 8 in 4 microbatches, 6 steps
TRAIN_GRAD_CASES = (
    ("granite", 2, 32, 8, 1024, 1024, 128, True, None, "bfloat16"),
    ("granite-train", 2, 32, 8, 4096, 4096, 128, True, None, "bfloat16"),
    ("recurrentgemma", 1, 16, 1, 2304, 2304, 256, True, 2048, "bfloat16"),
    ("seamless-encoder", 4, 16, 16, 1024, 1024, 64, False, None, "bfloat16"),
    ("seamless-cross", 4, 16, 16, 64, 1024, 64, False, None, "bfloat16"),
    ("granite", 2, 32, 8, 1024, 1024, 128, True, None, "float32"))
#: phase 18: granite-8b's training microbatch at a rank's heads of a
#: 4-way model axis (32 / 4 q heads, 8 / 4 KV heads)
TP_FLASH_CASES = (
    ("granite-train-tp4", 2, 8, 2, 4096, 4096, 128, True, None, "bfloat16"),)
#: phase 19: granite-8b's serving prefill at a rank's heads of a 4-way
#: model axis: (B, H, KVH, S, D), causal, bf16
SERVE_TP_FLASH = (BATCH, 32 // 4, 8 // 4, PROMPT_LEN, 128)
SERVE_TP_REPEATS = 2               # timed prefills / scan runs, each path
FLASH_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_SMALL = (2, 2, 128)
TRAIN_TOL = 1e-3
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 8, 8, 4, 6
TRAIN_PROFILED = 4                     # the straight run's step under profile
# phase 7: the CPM surface at the paper benchmark's row length, and the
# allocator at a pool's size (16,384 pages of 32 tokens: about what the
# card holds of granite-8b's KV at ~147 KB a token)
CPM_R, CPM_N, CPM_LEN_STEP = 64, 1 << 20, 4099
ALLOC_SLOTS, ALLOC_PAGES, ALLOC_BANKS, ALLOC_OPS = 256, 16384, 4, 300
SUM_TOL = 1e-5              # x sum|x| per row, for float32 sums
#: the kernels each path must launch, and whose launches it reports
POOL_KERNELS = ("flash_attention", "fused_stream", "gather_rows",
                "scatter_rows")
CPM_KERNELS = ("compare", "section_sum", "section_limit", "compact")
CPM2_KERNELS = ("substring_match", "histogram", "super_sum", "super_limit",
                "oddeven_sort")
# phase 8: the paper benchmark's T2 needle lengths on four-symbol rows
# (benchmarks/run.py:98), its T3 bin counts (:110),
# the allocator's longest row for the sort, its ~sqrt(N) bounded phase,
# and the bounded local phase on phase 7's rows
NEEDLES, FIND_MAX = (2, 8, 32), 64
HIST_BINS = (8, 64)
SORT_R, SORT_N, SORT_LEN_STEP, LONG_SORT_STEPS = 64, 16384, 129, 1024
#: the float32 rate outside the tensor cores (H100 SXM data sheet), for
#: the bounds of kernels that compare rather than multiply
F32_OPS_PER_S = 67e12
#: the odd-even route's issue floor: min and max issue on the ALU pipe, 64
#: lanes a clock on each of the H100's 132 SMs (CUDA programming guide,
#: compute capability 9.0); in the SASS of oddeven_tiles the integer loop
#: spends 0.75 ALU instructions a lane a cycle (a min for every pair, a
#: max for half of them, the other half's max two IMADs on the FMA pipe),
#: the NaN loop 3.5 (two compares, a min, a max and three selects a pair)
SMS, ALU_LANES_PER_CLOCK = 132, 64
OE_INT_ALU, OE_NAN_ALU = 0.75, 3.5
# phase 9: the paper benchmark's T6 template lengths (benchmarks/run.py:151)
# on phase 7's rows, a five-tap stencil with zero taps, and the cost
# model's probe stream on rows of the allocator's longest length (phase 2
# also runs it on phase 7's row length)
STREAM_TEMPLATES = (4, 16, 64)
STENCIL5 = (0.5, 0.0, 1.0, 0.0, -0.25)
#: the 63-tap stencil timed in phase 9: every tap nonzero, so each lane
#: does 63 multiplies and adds
STENCIL63 = tuple(math.sin(k + 1.0) for k in range(63))
PROBE_N = 16384
STREAM_KERNELS = ("activate", "shift_range", "template_match", "stencil")
# phase 16: the mesh backend's ops on phase 7's rows, and the bytes a
# training step must move at least per parameter: AdamW reads params,
# grads, mu and nu and writes params, mu and nu, float32 each
MESH_OPS = (("section_sum", ()), ("super_sum", ()),
            ("global_limit", ("max",)), ("global_limit", ("min",)),
            ("super_limit", ("max",)), ("super_limit", ("min",)),
            ("compare", (2048, "lt")))
ADAMW_BYTES_PER_PARAM = 7 * 4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _profile(fn, iters: int):
    """``torch.profiler``'s device records of ``iters`` calls of ``fn``:
    (key, count, self device ms) a kernel name.  The profiler was seen on
    the H100 to lose kernel records (14 to 19 of 20 in one window), so a
    first (warm-up) window of ``iters`` calls is discarded, and a window
    whose record count of some kernel is not a multiple of ``iters`` is
    measured again, up to three times.  None when the profiler records no
    device activity or no window was whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        evs = [ev for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA") and ev.count]
        if not evs:
            return None
        if not any(ev.count % iters for ev in evs):
            break
    else:
        return None
    out = {}
    for ev in evs:
        m = re.search(r"::(\w+)[<(]", ev.key)
        name = m.group(1) if m else ev.key[:40]
        n, t = out.get(name, (0, 0.0))
        out[name] = (n + ev.count, t + ev.self_device_time_total / 1e3)
    return out


def kernel_ms(fn, iters: int = 20):
    """Mean device time per call of ``fn`` by kernel name, from
    ``torch.profiler`` (CUPTI, :func:`_profile`): the CUDA kernels (and
    copies) it launches.  Host gaps between launches are excluded, so a
    wrapper whose Python side is slower than its kernel is not charged for
    it.  None where the profiler has no whole window."""
    recs = _profile(fn, iters)
    return None if recs is None else {
        name: t / iters for name, (_, t) in recs.items()}


def device_launches(fn, iters: int = 5):
    """Device activities (kernels, memsets) one call of ``fn`` puts on the
    card, by name (:func:`_profile`); None where the profiler has no whole
    window."""
    recs = _profile(fn, iters)
    return None if recs is None else {
        name: n // iters for name, (n, _) in recs.items()}


#: the mangled template arguments of shift_range_kernel<W>: its word type
_WORDS = {"h": "u8", "t": "u16", "j": "u32", "m": "u64"}


def ptxas_report(build, names=("oddeven_sort", "flash_attention",
                               "shift_range", "stencil", "histogram",
                               "template_match", "fused_stream",
                               "activate")):
    """Registers, static shared memory and spills of every kernel of the
    named sources, from their ``-Xptxas -v`` build logs: one entry a
    kernel instantiation (its mangled name cut to the kernel's name and
    template numbers)."""
    out = {}
    for src in names:
        kern = None
        for line in build.build_log(src).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                mangled = m.group(1)
                base = re.search(r"(flash_fwd_\w+?_kernel|oddeven_tiles|"
                                 r"nan_chunks|bitonic_tile|bitonic_stride|"
                                 r"nan_rows|"
                                 r"shift_range_kernel|stencil_kernel|"
                                 r"hist_count|hist_finish|"
                                 r"template_match_kernel|"
                                 r"fused_tiles_kernel|"
                                 r"fused_resident_kernel|activate_kernel)",
                                 mangled)
                name = base.group(1) if base else mangled[:40]
                rest = mangled[base.end():] if base else ""
                args = re.findall(r"Li(\d+)E|(B?[A-Z]\d+T|BoolT)", rest)
                tmpl = ",".join(a or b for a, b in args[:2])
                if name == "shift_range_kernel":
                    w = re.match(r"I([hjmt])E", rest)
                    tmpl = _WORDS[w.group(1)] if w else rest[:8]
                kern = "%s/%s<%s>" % (src, name, tmpl)
                out[kern] = {}
                continue
            if kern is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                out[kern]["spill_stores"] = int(m.group(1))
                out[kern]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[kern]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                out[kern]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def sass_counts(build, src: str = "oddeven_sort",
                kernel: str = "oddeven_tiles") -> dict:
    """Counts of the opcodes that set an exchange's issue (min / max,
    IMAD other than a move, compares, selects, shuffles, barriers, and
    local-memory loads and stores: spills) in each
    instantiation of ``kernel`` in the library built from
    ``csrc/<src>.cu``, by its dtype trait (``cuobjdump -sass`` of the CUDA
    toolkit); {} where the tool is missing."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(build._lib_path(src))],
                          capture_output=True, text=True, timeout=300).stdout
    out = {}
    for part in re.split(r"\n\s+Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        m = re.search(kernel + r"I(\d+)", name)
        if not m:
            continue
        trait = name[m.end():m.end() + int(m.group(1))]
        ops = {}
        for op, mods in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                                   r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)",
                                   part):
            key = "IMAD.MOV" if op == "IMAD" and ".MOV" in mods else op
            if key in ("VIMNMX", "IMNMX", "IMAD", "ISETP", "SEL", "SHFL",
                       "BAR", "LDL", "STL"):
                ops[key] = ops.get(key, 0) + 1
        out[trait] = ops
    return out


def sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def device_ms(fn, iters: int = 20):
    """Mean device-busy time of one call of ``fn`` (:func:`kernel_ms`
    summed); None — the caller falls back to CUDA events — where that
    has no data."""
    by_kernel = kernel_ms(fn, iters)
    return sum(by_kernel.values()) if by_kernel else None


def timed(fn, iters: int):
    """(device ms per call or, without profiler data, events ms; the
    source; events ms per call including host time)."""
    call = cuda_ms(fn, iters=iters)
    dev = device_ms(fn, iters=iters)
    return (dev, "profiler", call) if dev is not None else \
        (call, "events", call)


def bound(nbytes: float, flops: float = 0.0,
          rate: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------

def check_flash(torch, dev, record):
    from repro_torch.kernels import flash_attention as fa

    cfg = record["config"]
    b, h, kvh, d = BATCH, cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    s = PROMPT_LEN
    g = torch.Generator(device=dev).manual_seed(11)
    # "strided": the main path's layout, (B, S, heads, D) projections
    # viewed as (B, heads, S, D) (models/layers.py attention_fwd), so the
    # sequence stride is heads * D; "contiguous": packed (B, heads, S, D)
    layouts = {
        "strided": [torch.randn((b, s, n, d), generator=g,
                                device=dev).transpose(1, 2)
                    for n in (h, kvh, kvh)],
        "contiguous": [torch.randn((b, n, s, d), generator=g, device=dev)
                       for n in (h, kvh, kvh)]}
    worst = {}
    cases = [("bfloat16", True, None), ("float32", True, None),
             ("bfloat16", True, 100), ("float32", False, 37)]
    for layout, base in layouts.items():
        for dt, causal, window in cases:
            q, k, v = (t.to(getattr(torch, dt)) for t in base)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            err = float((got.float() - want.float()).abs().max())
            tol = FLASH_TOL[dt]
            ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                atol=tol)
            print(f"flash_attention {dt} causal={causal} window={window} "
                  f"{layout} q strides {tuple(q.stride())} (B={b} H={h} "
                  f"KVH={kvh} S={s} D={d}): max_abs_err={err:.3e} "
                  f"tol={tol} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"flash_attention {dt} window={window} {layout} "
                     f"disagrees with its plain twin (max abs err {err})")
            worst[dt, causal, window] = max(
                err, worst.get((dt, causal, window), 0.0))

    # timed on the main path's layout
    q, k, v = (t.to(torch.bfloat16) for t in layouts["strided"])
    ms, src, call_ms = timed(lambda: fa.flash_attention(q, k, v,
                                                        causal=True), 20)
    plain_ms, _, plain_call = timed(
        lambda: fa.flash_attention_plain(q, k, v, causal=True), 5)
    # two SDPA yardsticks: the same inputs with enable_gqa (the backend
    # PyTorch picks), and the flash backend pinned on K/V repeated to H
    # heads outside the timing; the kernels each ran are printed
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def gqa():
        return sdpa(q, k, v, is_causal=True, enable_gqa=True)

    lib_ms, _, _ = timed(gqa, 20)
    lib_kernels = kernel_ms(gqa, 20)
    kr, vr = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))

    def pinned():
        return sdpa(q, kr, vr, is_causal=True)

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        flash_lib_ms, _, _ = timed(pinned, 20)
        flash_lib_kernels = kernel_ms(pinned, 20)
    print(f"flash_attention yardsticks: SDPA enable_gqa {lib_ms:.4f} ms on "
          f"{lib_kernels}; SDPA pinned to FLASH_ATTENTION, K/V repeated "
          f"outside the timing, {flash_lib_ms:.4f} ms on "
          f"{flash_lib_kernels}")
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())   # q, k, v, out
    pairs = s * (s + 1) // 2                                # causal
    flops = 4.0 * d * pairs * b * h
    bound_ms, by = bound(nbytes, flops)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "launches": None,
            "max_abs_err": worst["bfloat16", True, None],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms, "ms_source": src,
            "call_ms": call_ms, "plain_call_ms": plain_call,
            "library_call": "scaled_dot_product_attention(enable_gqa=True)",
            "library_kernels": lib_kernels,
            "library_flash_pinned_ms": flash_lib_ms,
            "library_flash_pinned_kernels": flash_lib_kernels,
            "device_launches": device_launches(
                lambda: fa.flash_attention(q, k, v, causal=True))}


def _window_tiles(s: int, window: int, tile: int = 64) -> int:
    """64 x 64 (query, key) tiles of a causal window-``window`` mask over
    S = Sq = Skv that hold a live pair (the tiles the kernel computes)."""
    n = -(-s // tile)
    return sum(min(i + 1, n) - max(0, (i * tile - window + 1) // tile)
               for i in range(n))


def _window_pairs(s: int, window: int) -> int:
    """Live (query, key) pairs of a causal window-``window`` mask over
    S = Sq = Skv: row r keeps keys max(0, r - window + 1) .. r."""
    return sum(min(r + 1, window) for r in range(s))


def _row_err(torch, got, want) -> float:
    """Attention output (..., S, D): the largest over rows of a row's
    max |got - want| over its max |want|."""
    g, w = got.float(), want.float()
    return float(((g - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp_min(1e-30)).max())


def _flash_agrees(torch, got, want, dt):
    """Phase 2's gate for D = 256 and the encoder-decoder's modes: ``allclose`` at ``FLASH_TOL``, and in bf16
    also each row within ``FLASH_ROW_TOL`` of its largest value.  Returns
    (ok, max abs err, row err)."""
    err = float((got.float() - want.float()).abs().max())
    row = _row_err(torch, got, want)
    tol = FLASH_TOL[dt]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    if dt == "bfloat16":
        ok = ok and row <= FLASH_ROW_TOL
    return ok, err, row


def check_flash_d256(torch, dev, rec):
    """Phase 2, head dim 256 (recurrentgemma-9b's attn_local layers: 16 q
    heads over one kv head, window 2,048): the kernel against its plain
    twin in bf16 and float32, causal with no window, window 2,048 and
    window 100, on the main path's strided (B, S, H, D) views and on
    packed tensors, each gate also shown to fail against the twin with
    the window one key wider and one key narrower; the bf16 window-2,048
    case timed with its bound and SDPA's time on the same inputs (the
    window as a boolean mask).  Adds ``d256_*`` keys to phase 2's
    flash_attention record ``rec``."""
    from repro_torch.kernels import flash_attention as fa

    b, h, kvh, s, d, w = HYB_BATCH, 16, 1, HYB_PROMPT, 256, 2048
    g = torch.Generator(device=dev).manual_seed(12)
    layouts = {
        "strided": [torch.randn((b, s, n, d), generator=g,
                                device=dev).transpose(1, 2)
                    for n in (h, kvh, kvh)],
        "contiguous": [torch.randn((b, n, s, d), generator=g, device=dev)
                       for n in (h, kvh, kvh)]}
    worst, worst_row, shift_row = {}, {}, {}
    for layout, base in layouts.items():
        for dt in ("bfloat16", "float32"):
            for window in (None, w, 100):
                q, k, v = (t.to(getattr(torch, dt)) for t in base)
                got = fa.flash_attention(q, k, v, causal=True, window=window)
                torch.cuda.synchronize()
                want = fa.flash_attention_plain(q, k, v, causal=True,
                                                window=window)
                ok, err, row = _flash_agrees(torch, got, want, dt)
                print(f"flash_attention D=256 {dt} causal window={window} "
                      f"{layout} (B={b} H={h} KVH={kvh} S={s}): "
                      f"max_abs_err={err:.3e} tol={FLASH_TOL[dt]}, row "
                      f"err {row:.3e} (bf16 tol {FLASH_ROW_TOL:.4f}) "
                      f"{'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"flash_attention D=256 {dt} window={window} "
                         f"{layout} disagrees with its plain twin "
                         f"(max abs err {err}, row err {row})")
                worst[dt] = max(err, worst.get(dt, 0.0))
                worst_row[dt] = max(row, worst_row.get(dt, 0.0))
                for shifted in ((window - 1, window + 1) if window else ()):
                    off = fa.flash_attention_plain(q, k, v, causal=True,
                                                   window=shifted)
                    passes, _, srow = _flash_agrees(torch, got, off, dt)
                    print(f"  against the twin at window {shifted}: row "
                          f"err {srow:.3e}, "
                          f"{'NOT CAUGHT' if passes else 'caught'}")
                    if passes:
                        fail(f"flash_attention D=256 {dt} window={window} "
                             f"{layout}: the gate passes the twin at window "
                             f"{shifted}")
                    shift_row[dt] = min(srow, shift_row.get(dt, 1e30))
    q, k, v = (t.to(torch.bfloat16) for t in layouts["strided"])
    ms, src, call_ms = timed(
        lambda: fa.flash_attention(q, k, v, causal=True, window=w), 20)
    plain_ms, _, _ = timed(
        lambda: fa.flash_attention_plain(q, k, v, causal=True, window=w), 3)
    i = torch.arange(s, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms, _, _ = timed(lambda: sdpa(q, k, v, attn_mask=mask,
                                      enable_gqa=True), 20)
    tiles = _window_tiles(s, w)
    pairs = _window_pairs(s, w)
    flops = 4.0 * d * pairs * b * h                # QK^T and PV, live pairs
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())   # q, k, v, out
    bound_ms, by = bound(nbytes, flops)
    qf, kf, vf = (t.float() for t in layouts["strided"])
    f32_ms, f32_src, _ = timed(
        lambda: fa.flash_attention(qf, kf, vf, causal=True, window=w), 3)
    rec.update({"d256_shape": [b, h, kvh, s, d], "d256_window": w,
                "d256_max_abs_err": worst["bfloat16"],
                "d256_f32_max_abs_err": worst["float32"],
                "d256_row_err": worst_row["bfloat16"],
                "d256_row_tol": FLASH_ROW_TOL,
                "d256_shifted_row_err": shift_row["bfloat16"],
                "d256_f32_shifted_row_err": shift_row["float32"],
                "d256_ms": ms, "d256_ms_source": src,
                "d256_call_ms": call_ms, "d256_plain_ms": plain_ms,
                "d256_bound_ms": bound_ms, "d256_bound_by": by,
                "d256_tiles": tiles * b * h, "d256_pairs": pairs * b * h,
                "d256_library_ms": lib_ms,
                "d256_library_call": "scaled_dot_product_attention("
                                     "attn_mask=window, enable_gqa=True)",
                "d256_f32_ms": f32_ms, "d256_f32_ms_source": f32_src})
    print(f"flash_attention D=256 bf16 causal window {w} (B={b} H={h} "
          f"KVH={kvh} S={s}, strided): {ms:.4f} ms ({src}; {call_ms:.4f} "
          f"a call), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} "
          f"({pairs * b * h} live pairs; the kernel computes "
          f"{tiles * b * h} 64x64 tiles), SDPA with the window mask "
          f"{lib_ms:.4f} ms; float32 {f32_ms:.4f} ms")


def check_flash_encdec(torch, dev, rec):
    """Phase 2, seamless-m4t-large-v2's modes (16 q heads over 16 kv
    heads of dim 64: the wgmma + TMA route in bf16): the encoder's
    bidirectional self-attention (Sq = Skv = 1,024 frames) and the
    decoder's cross attention (Sq = 64 prompt positions over Skv = 1,024
    frames), bf16 and float32, on the main path's strided (B, S, H, D)
    views, each against the plain twin under the D = 256 gate; each bf16
    case timed beside its bound and SDPA on the same inputs (no mask, no
    kv repeat), float32 timed too.  Adds ``encoder_*`` and ``cross_*``
    keys to phase 2's flash_attention record ``rec``."""
    from repro_torch.kernels import flash_attention as fa

    b, h, d, skv = ED_BATCH, 16, 64, ED_SRC
    g = torch.Generator(device=dev).manual_seed(13)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for tag, sq in (("encoder", ED_SRC), ("cross", ED_PROMPT)):
        base = [torch.randn((b, n, h, d), generator=g,
                            device=dev).transpose(1, 2)
                for n in (sq, skv, skv)]
        errs = {}
        for dt in ("bfloat16", "float32"):
            q, k, v = (t.to(getattr(torch, dt)) for t in base)
            got = fa.flash_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=False)
            ok, err, row = _flash_agrees(torch, got, want, dt)
            print(f"flash_attention {tag} {dt} bidirectional (B={b} H={h} "
                  f"KVH={h} Sq={sq} Skv={skv} D={d}, strided): "
                  f"max_abs_err={err:.3e} tol={FLASH_TOL[dt]}, row err "
                  f"{row:.3e} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"flash_attention {tag} {dt} disagrees with its plain "
                     f"twin (max abs err {err}, row err {row})")
            errs[dt] = (err, row)
        q, k, v = (t.to(torch.bfloat16) for t in base)
        ms, src, call_ms = timed(
            lambda: fa.flash_attention(q, k, v, causal=False), 20)
        plain_ms, _, _ = timed(
            lambda: fa.flash_attention_plain(q, k, v, causal=False), 5)
        lib_ms, _, _ = timed(lambda: sdpa(q, k, v), 20)
        lib_kernels = kernel_ms(lambda: sdpa(q, k, v), 20)
        pairs = b * h * sq * skv
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v, out
        bound_ms, by = bound(nbytes, 4.0 * d * pairs)
        qf, kf, vf = (t.float() for t in base)
        f32_ms, f32_src, _ = timed(
            lambda: fa.flash_attention(qf, kf, vf, causal=False), 5)
        rec.update({f"{tag}_shape": [b, h, h, sq, skv, d],
                    f"{tag}_max_abs_err": errs["bfloat16"][0],
                    f"{tag}_row_err": errs["bfloat16"][1],
                    f"{tag}_f32_max_abs_err": errs["float32"][0],
                    f"{tag}_ms": ms, f"{tag}_ms_source": src,
                    f"{tag}_call_ms": call_ms, f"{tag}_plain_ms": plain_ms,
                    f"{tag}_bound_ms": bound_ms, f"{tag}_bound_by": by,
                    f"{tag}_pairs": pairs, f"{tag}_library_ms": lib_ms,
                    f"{tag}_library_call": "scaled_dot_product_attention",
                    f"{tag}_library_kernels": lib_kernels,
                    f"{tag}_f32_ms": f32_ms, f"{tag}_f32_ms_source": f32_src})
        print(f"flash_attention {tag} bf16 bidirectional (B={b} H={h} "
              f"Sq={sq} Skv={skv} D={d}, strided): {ms:.4f} ms ({src}; "
              f"{call_ms:.4f} a call), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {by} ({pairs} (q, k) pairs), SDPA "
              f"{lib_ms:.4f} ms on {lib_kernels}; float32 {f32_ms:.4f} ms")


def _nine_op_stream(np, r, n, dtype, per_row, seed):
    """A stream over all nine fused instruction kinds."""
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        x = rng.integers(-4, 5, (r, n)).astype(dtype)
    else:
        x = np.round(rng.standard_normal((r, n)) * 4).astype(dtype) / 2
    ul = rng.integers(n // 3, n + 1, (r,)).astype(np.int32)

    def rows(a):
        return a if per_row else a[:1].copy()

    ct = "float32" if dtype == np.float32 else "int32"
    instrs = (
        ("activate", (), 1),
        ("shift", (("shift", 3), ("has_fill", True)), 2),
        ("compare", (("op", "ge"), ("has_mask", False), ("ct", ct)), 1),
        ("insert", (("k", 3),), 2),
        ("substring_match", (("m", 3), ("where", "start")), 1),
        ("template_match", (("m", 4), ("mask_tail", True)), 1),
        ("delete", (("k", 2),), 2),
        ("substring_match", (("m", 2), ("where", "end")), 1),
        ("stencil", (("taps", (0.25, 1.5, 0.0, -0.75, 0.125)),
                     ("wrap", False)), 0),
        ("stencil", (("taps", (0.5, 1.0, 0.5)), ("wrap", True)), 0),
        ("truncate", (), 1),
    )
    ops = [
        rows(np.stack([rng.integers(0, 4, r), rng.integers(n // 2, n, r),
                       rng.integers(1, 4, r)], 1).astype(np.int32)),
        rows(np.stack([rng.integers(0, 5, r), rng.integers(n // 2, n, r)],
                      1).astype(np.int32)),
        rows(np.full((r, 1), -9, dtype)),
        rows(rng.integers(-2, 3, (r, 1)).astype(
            np.float32 if ct == "float32" else np.int32)),
        rows(rng.integers(0, n // 2, (r, 1)).astype(np.int32)),
        rows(rng.integers(-4, 5, (r, 3)).astype(dtype)),
        rows(x[:, 2:5].copy()),
        rows(rng.standard_normal((r, 4)).astype(np.float32)),
        rows(rng.integers(0, n // 2, (r, 1)).astype(np.int32)),
        rows(np.full((r, 1), 7, dtype)),
        rows(x[:, 6:8].copy()),
        rows(rng.integers(n // 4, n, (r, 1)).astype(np.int32)),
    ]
    return x, ul, instrs, ops


def _bitwise_err(torch, got, want):
    """0.0 when bit-identical, else the largest absolute difference."""
    gx, gul, gp = got
    wx, wul, wp = want
    same = (torch.equal(gx.view(torch.int32), wx.view(torch.int32))
            and torch.equal(gul, wul)
            and all(torch.equal(a.view(torch.int8 if a.dtype == torch.int8
                                       else torch.int32),
                                b.view(torch.int8 if b.dtype == torch.int8
                                       else torch.int32))
                    for a, b in zip(gp, wp)))
    if same:
        return 0.0
    errs = [float((gx.double() - wx.double()).abs().max()),
            float((gul - wul).abs().max())]
    errs += [float((a.double() - b.double()).abs().nan_to_num().max())
             for a, b in zip(gp, wp)]
    return max(errs + [float("inf")])


def _lowered(torch, arr, prog):
    """The fused kernel's arguments for the whole of ``prog`` on ``arr``,
    as the executor lowers a fused group."""
    from repro_torch.cpm._tensor import asarray
    from repro_torch.cpm.program import executors

    lead, n = arr.batch_shape, arr.n
    r = math.prod(lead)
    descs, operands = [], []
    for instr in prog.instructions:
        (op, st), opnds, _ = executors._lower(instr, arr.dtype, lead, r,
                                              arr.device)
        descs.append((op, st, len(opnds)))
        operands.extend(opnds)
    ul = asarray(arr.used_len, torch.int32, arr.device).expand(lead)
    return (arr.data.reshape(r, n).contiguous(),
            ul.reshape(r).contiguous(), tuple(descs), tuple(operands))


def _device_split(fn, iters: int):
    """(kernel ms, all device ms, {name: ms}) per call of ``fn``: the
    kernels alone, and with the copies and memsets the call puts on the
    card (``torch.profiler``; CUDA events for both where it has no
    window)."""
    by = kernel_ms(fn, iters)
    if not by:
        t = cuda_ms(fn, iters=iters)
        return t, t, {}
    kern = sum(t for k, t in by.items()
               if not k.startswith(("Memcpy", "Memset")))
    return kern, sum(by.values()), by


def _fused_cases(torch, dev):
    """Phase 2's three ``fused_stream`` cases, each with its rows, the
    kernel's arguments and the program the executor runs fused or eager:
    the serving commit (insert -> truncate on (4, 320) int32 rows, as
    ``serve/program_paths.py`` records it) and the cost model's probe
    stream (``costmodel._probe_program``) on (64, 16,384) and (64,
    1,048,576) int32 rows from a seeded generator."""
    from repro_torch.cpm import CPMProgram, cpm_array
    from repro_torch.cpm.program.costmodel import _probe_program

    out = {}
    g = torch.Generator(device=dev).manual_seed(5)
    r, n = BATCH, PROMPT_LEN + MAX_NEW
    buf = torch.randint(0, 49152, (r, n), generator=g, device=dev,
                        dtype=torch.int32)
    used = torch.randint(PROMPT_LEN, n - SPEC, (r,), generator=g,
                         device=dev, dtype=torch.int32)
    preds = torch.randint(0, 49152, (r, SPEC), generator=g, device=dev,
                          dtype=torch.int32)
    emit = torch.randint(0, SPEC + 1, (r,), generator=g, device=dev,
                         dtype=torch.int32)
    prog = (CPMProgram().append("insert", pos=used, values=preds)
            .append("truncate", new_len=used + emit))
    out["commit"] = (cpm_array(buf, used, backend="cuda"), prog)
    for tag, pn in (("probe16k", PROBE_N), ("probe1m", CPM_N)):
        x = torch.randint(0, 4096, (CPM_R, pn), generator=g, device=dev,
                          dtype=torch.int32)
        ul = torch.randint(pn // 2, pn + 1, (CPM_R,), generator=g,
                           device=dev, dtype=torch.int32)
        out[tag] = (cpm_array(x, ul, backend="cuda"), _probe_program(pn))
    return out


def _one_group(prog, kind: str):
    """``prog`` as one group of ``kind`` (``"fused"``: one launch)."""
    from repro_torch.cpm.program import FusionGroup, FusionPlan

    return FusionPlan(prog, (FusionGroup(
        kind, tuple(range(len(prog.instructions))),
        tuple(prog.instructions)),))


def check_fused_stream(torch, np, dev, card, empty):
    """The kernel against its twin at the commit, nine-op, probe and
    long-row shapes (rows held in one tile run its resident-row form, the
    others its tiles); then each of the three cases timed with its plan
    beside the eager plan, in the same process; and ``empty`` (an empty
    kernel's launch), the launch floor."""
    from repro_torch.cpm.program import run_plan
    from repro_torch.cpm.program.costmodel import _eager_plan
    from repro_torch.kernels import cpm_kernels as ck

    def on_dev(x, ul, instrs, ops):
        return (torch.from_numpy(x).to(dev), torch.from_numpy(ul).to(dev),
                instrs, tuple(torch.from_numpy(o).to(dev) for o in ops))

    def hold(args, what, **kw):
        got = ck.fused_stream(*args, **kw)
        torch.cuda.synchronize()
        err = _bitwise_err(torch, got, ck.fused_stream_plain(*args, **kw))
        print(f"fused_stream {what}: max_abs_err={err} tol=0 "
              f"(bit-identical) {'ok' if err == 0 else 'MISMATCH'}")
        if err != 0:
            fail(f"fused_stream {what} disagrees with its plain twin")
        return err

    cases = _fused_cases(torch, dev)
    args = {tag: _lowered(torch, arr, prog)
            for tag, (arr, prog) in cases.items()}
    commit_err = hold(args["commit"], f"commit insert->truncate "
                      f"(R={BATCH} N={PROMPT_LEN + MAX_NEW} k={SPEC})")
    for dtype in (np.int32, np.float32):
        for per_row in (False, True):
            hold(on_dev(*_nine_op_stream(np, 7, 300, dtype, per_row, 2)),
                 f"nine ops {dtype.__name__} "
                 f"{'per-row' if per_row else 'broadcast'} operands "
                 f"(R=7 N=300 block_r=3)", block_r=3)
    for tag in ("probe16k", "probe1m"):
        hold(args[tag], f"probe stream shift->compare->activate->stencil "
             f"{tuple(args[tag][0].shape)}")

    floor_ms, _, _ = _device_split(lambda: empty(dev), 200)
    print(f"launch floor: an empty kernel, {floor_ms:.4f} ms of device "
          f"time; {card}")
    timings = {}
    for tag, (arr, prog) in cases.items():
        x, ul, descs, opnds = args[tag]
        r, n = x.shape
        plan = ck.fused_plan(r, n, tuple((op, st) for op, st, _ in descs))
        iters = 200 if tag == "commit" else 20
        ms, _, by = _device_split(lambda a=args[tag]: ck.fused_stream(*a),
                                  iters)
        rec = {"shape": [r, n], "ms": ms, "kernels": by,
               "plan": plan._asdict() | {"window": plan.window}}
        fused, eager = _one_group(prog, "fused"), _eager_plan(prog)
        rec["fused_plan_ms"], rec["fused_plan_device_ms"], \
            rec["fused_plan_kernels"] = _device_split(
                lambda: run_plan(fused, arr), iters)
        rec["eager_plan_ms"], rec["eager_plan_device_ms"], \
            rec["eager_kernels"] = _device_split(lambda: run_plan(eager,
                                                                  arr), iters)
        prods = [ck.FUSED_PRODUCERS[op].itemsize for op, _, _ in descs
                 if op in ck.FUSED_PRODUCERS]
        nbytes = (2 * (x.numel() * 4 + ul.numel() * 4) + x.numel()
                  * sum(prods) + sum(o.numel() * 4 for o in opnds))
        rec["bound_ms"], rec["bound_by"] = bound(nbytes)
        rec["call_ms"] = cuda_ms(lambda a=args[tag]: ck.fused_stream(*a),
                                 iters=iters)
        timings[tag] = rec
        kernel = "resident-row" if plan.tiles == 1 else "tiled"
        rec["kernel"] = kernel
        print(f"fused_stream {tag} {tuple(x.shape)}: {kernel} kernel "
              f"{ms:.4f} ms (tile {plan.tile}, halos {plan.halo_l}/"
              f"{plan.halo_r}, "
              f"{plan.tiles} tiles a row, {len(plan.passes)} pass), eager "
              f"plan {rec['eager_plan_ms']:.4f} ms of kernels "
              f"({rec['eager_plan_device_ms']:.4f} device, "
              f"{sorted(rec['eager_kernels'])}), fused plan "
              f"{rec['fused_plan_ms']:.4f} of kernels "
              f"({rec['fused_plan_device_ms']:.4f} device, "
              f"{sorted(rec['fused_plan_kernels'])}); bound "
              f"{rec['bound_ms']:.6f} ms by {rec['bound_by']}; floor "
              f"{floor_ms:.4f}; {card}")

    commit = timings["commit"]
    plain_ms, _, plain_call = timed(
        lambda: ck.fused_stream_plain(*args["commit"]), 20)
    return {"name": "fused_stream", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_stream.cu",
            "replaces": "src/repro/kernels/cpm_kernels.py:809",
            "launches": None, "max_abs_err": commit_err,
            "ms": commit["ms"], "plain_ms": plain_ms,
            "bound_ms": commit["bound_ms"], "bound_by": commit["bound_by"],
            "library_ms": None, "ms_source": "profiler",
            "call_ms": commit["call_ms"], "plain_call_ms": plain_call,
            "floor_ms": floor_ms, "cases": timings}


# ---------------------------------------------------------------------------
# phase 2: the paged-row kernels at the pool's shapes
# ---------------------------------------------------------------------------

def check_rows(torch, np, dev):
    """gather_rows / scatter_rows against their twins, bit for bit, on
    int32 token banks at phase 6's shapes: a chunk moves rows_per_bank x C
    pages per bank, clean pages carry the sentinel ``pages_per_bank``;
    a park reads one session's pages."""
    from repro_torch.kernels import cpm_kernels as ck

    ppb, pg = POOL["pages_per_bank"], POOL["page_size"]
    rpb, c = POOL["slots"] // POOL["n_banks"], POOL_MAX_LEN // pg
    rng = np.random.default_rng(9)
    bank = torch.from_numpy(
        rng.integers(0, 49152, (ppb, pg)).astype(np.int32)).to(dev)
    # a chunk's page table: each row's pages unique, the tail sentinel
    table = np.full((rpb, c), ppb, np.int32)
    free = list(rng.permutation(ppb))
    for r in range(rpb):
        for j in range(int(rng.integers(2, 6))):
            table[r, j] = free.pop()
    flat = torch.from_numpy(table.reshape(-1)).to(dev)
    gather_ids = flat.clamp(0, ppb - 1).contiguous()
    dirty = np.where(np.arange(c)[None] >= rng.integers(0, 3, (rpb, 1)),
                     table, ppb).reshape(-1)
    scatter_ids = torch.from_numpy(dirty.astype(np.int32)).to(dev)
    src = torch.from_numpy(
        rng.integers(0, 49152, (rpb * c, pg)).astype(np.int32)).to(dev)
    park_ids = torch.from_numpy(table[0, :4].copy()).to(dev)
    cases = {"gather_rows": [(bank, gather_ids), (bank, park_ids)],
             "scatter_rows": [(bank, scatter_ids, src)]}
    kernels = {"gather_rows": (ck.gather_rows, ck.gather_rows_plain),
               "scatter_rows": (ck.scatter_rows, ck.scatter_rows_plain)}
    for name, args_list in cases.items():
        fn, plain = kernels[name]
        for args in args_list:
            got = fn(*args)
            torch.cuda.synchronize()
            same = torch.equal(got, plain(*args))
            shapes = " ".join(str(tuple(a.shape)) for a in args)
            print(f"{name} int32 {shapes} (sentinel {ppb}): "
                  f"max_abs_err={0.0 if same else 'inf'} tol=0 "
                  f"(bit-identical) {'ok' if same else 'MISMATCH'}")
            if not same:
                fail(f"{name} disagrees with its plain twin at {shapes}")

    keep = scatter_ids < ppb                      # the library call cannot
    lib_ids = scatter_ids[keep].long()            # drop: give it only the
    lib_src = src[keep]                           # in-range rows
    out = []
    for name, args, lib, nbytes in (
            ("gather_rows", (bank, gather_ids),
             lambda: torch.index_select(bank, 0, gather_ids),
             # distinct rows read once, every output row written once
             (gather_ids.unique().numel() + gather_ids.numel()) * pg * 4
             + gather_ids.numel() * 4),
            ("scatter_rows", (bank, scatter_ids, src),
             lambda: bank.clone().index_copy_(0, lib_ids, lib_src),
             # each output row reads one row (of src or of dst) once
             (2 * bank.numel() + scatter_ids.numel()) * 4)):
        fn, plain = kernels[name]
        ms, src_, call_ms = timed(lambda: fn(*args), 200)
        plain_ms, _, plain_call = timed(lambda: plain(*args), 50)
        lib_ms, _, _ = timed(lib, 200)
        bound_ms, by = bound(nbytes)
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/csrc/rows.cu",
                    "replaces": ("src/repro/kernels/cpm_kernels.py:670"
                                 if name == "gather_rows" else
                                 "src/repro/kernels/cpm_kernels.py:698"),
                    "launches": None, "max_abs_err": 0.0, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": lib_ms,
                    "ms_source": src_, "call_ms": call_ms,
                    "plain_call_ms": plain_call})
    return out


# ---------------------------------------------------------------------------
# phase 3: small input, card against CPU
# ---------------------------------------------------------------------------

def check_small_model(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import repeated_prompts
    from repro_torch.models import lm
    from repro_torch.serve import Engine, GenConfig, kv_cache

    cfg = get_config("granite-8b").smoke()
    cpu_p = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    dev_p = lm.tree_map(lambda t: t.to(dev), cpu_p)
    prompt = repeated_prompts(2, 32, cfg.vocab_size, 4)
    gen = GenConfig(max_new_tokens=16, ngram_spec=3)
    toks_dev, _ = Engine(cfg, dev_p, max_len=64, cpm_backend="cuda") \
        .generate({"tokens": prompt.to(dev)}, gen)
    toks_cpu, _ = Engine(cfg, cpu_p, max_len=64) \
        .generate({"tokens": prompt}, gen)
    toks_dev = toks_dev.cpu()
    # teacher forcing on the CPU: the plain model's logits at every
    # generated position of the card's sequence
    lg0, caches = lm.prefill(cpu_p, cfg, {"tokens": prompt}, max_len=64)
    caches = kv_cache.broadcast_lens(caches, 2)
    new = toks_dev[:, 32:]
    lg, _, _ = lm.decode_multi(cpu_p, cfg, new[:, :-1], caches,
                               torch.full((2,), 32, dtype=torch.int32))
    lg = torch.cat([lg0, lg], dim=1)[..., :cfg.vocab_size].float()
    picked = lg.gather(-1, new[..., None].long())[..., 0]
    gap = float((lg.amax(-1) - picked).max())
    tol = 2e-2 * max(1.0, float(lg.abs().max()))
    same = float((toks_dev == toks_cpu).float().mean())
    print(f"small input (smoke config, card vs CPU): teacher-forcing gap "
          f"{gap:.3e} (tol {tol:.3e}), tokens equal {same:.3f}")
    if not gap <= tol:
        fail("the card's tokens are not the plain model's greedy choice")


# ---------------------------------------------------------------------------
# phases 4-5: full-width granite-8b through Engine.generate
# ---------------------------------------------------------------------------

def serve_granite(torch, dev, layers, record):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import repeated_prompts
    from repro_torch.models import lm
    from repro_torch.serve import Engine, GenConfig

    cfg = get_config("granite-8b")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in
                   torch.utils._pytree.tree_flatten(params)[0])
    print(f"granite-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f}B float32 params, init "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    engine = Engine(cfg, params, max_len=PROMPT_LEN + MAX_NEW + SPEC + 8,
                    cpm_backend="cuda")
    prompt = repeated_prompts(BATCH, PROMPT_LEN, cfg.vocab_size, 1,
                              device=dev)
    scan_cfg = GenConfig(max_new_tokens=MAX_NEW)
    spec_cfg = GenConfig(max_new_tokens=MAX_NEW, ngram_spec=SPEC)

    ops.reset_launch_counts()                      # the main path, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan, _ = engine.generate({"tokens": prompt}, scan_cfg)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    after_scan = ops.launch_counts()
    t0 = time.perf_counter()
    spec, stats = engine.generate({"tokens": prompt}, spec_cfg)
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    counts = ops.launch_counts()

    if tuple(scan.shape) != (BATCH, PROMPT_LEN + MAX_NEW):
        fail(f"scan output shape {tuple(scan.shape)}")
    if not bool(((scan >= 0) & (scan < cfg.vocab_size)).all()):
        fail("scan tokens outside the vocabulary")
    if not torch.equal(scan, spec):
        fail("speculative tokens differ from scan tokens")
    if not torch.equal(scan[:, :PROMPT_LEN], prompt):
        fail("the prompt was not kept")
    if after_scan["flash_attention"] < cfg.n_layers or \
            counts["flash_attention"] < 2 * cfg.n_layers:
        fail(f"flash_attention launched {after_scan['flash_attention']} / "
             f"{counts['flash_attention']} times for 2 prefills of "
             f"{cfg.n_layers} layers")
    kind, decision = _commit_verdict(torch, dev, BATCH,
                                     PROMPT_LEN + MAX_NEW, SPEC)
    if after_scan["fused_stream"] != 0 or after_scan["shift_range"] != 0:
        fail(f"the scan path launched a commit kernel: {after_scan}")
    commit_launch_check(counts, kind, stats["rounds"], "generate")

    # timings outside the counted run
    t0 = time.perf_counter()
    logits, _ = lm.prefill(params, cfg, {"tokens": prompt},
                           max_len=engine.max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size].float()).all()):
        fail("non-finite prefill logits")
    new = BATCH * MAX_NEW
    serve = {"layers": cfg.n_layers, "batch": BATCH,
             "prompt_len": PROMPT_LEN, "max_new": MAX_NEW, "spec": SPEC,
             "prefill_ms": prefill_ms,
             "scan_s": t_scan, "scan_tok_s": new / t_scan,
             "spec_s": t_spec, "spec_tok_s": new / t_spec,
             "rounds": stats["rounds"], "accepted": stats["accepted"],
             "proposed": stats["proposed"],
             "acceptance_rate": stats["acceptance_rate"],
             "launches": counts, "launches_after_scan": after_scan,
             "commit_verdict": kind, "commit_decision": decision,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"serve: prefill {prefill_ms:.1f} ms (B={BATCH} x {PROMPT_LEN}); "
          f"scan {t_scan:.2f}s = {new / t_scan:.1f} tok/s; spec "
          f"{t_spec:.2f}s = {new / t_spec:.1f} tok/s, {stats['rounds']} "
          f"rounds, acceptance {stats['acceptance_rate']:.3f} "
          f"({stats['accepted']}/{stats['proposed']}); spec == scan")
    print(f"launches on the main path: {counts} (after scan: {after_scan}); "
          f"commit {kind} by the cost model's {decision['params']} "
          f"coefficients (fused {decision['fused_us']:.1f} us vs eager "
          f"{decision['eager_us']:.1f} us)")
    record["serve"] = serve
    gen = {"engine": engine, "prompt": prompt, "scan": scan,
           "spec": spec_cfg}
    return counts, cfg, params, gen


# ---------------------------------------------------------------------------
# phase 6: the paged session pool behind the gateway, full width
# ---------------------------------------------------------------------------

def _solo_gaps(torch, engine, prompt, seq):
    """The solo path's teacher-forced logits over ``seq``: per generated
    token, the max logit minus the token's logit; the tolerance; and how
    many tokens are not the solo path's own choice (an exact bf16 tie of
    the max counts here with gap 0)."""
    from repro_torch.models import lm
    from repro_torch.serve import kv_cache

    s = prompt.shape[0]
    lg0, caches = lm.prefill(engine.params, engine.cfg,
                             {"tokens": prompt[None]},
                             max_len=engine.max_len)
    caches = kv_cache.broadcast_lens(caches, 1)
    new = seq[None, s:]
    lg, _, _ = lm.decode_multi(engine.params, engine.cfg, new[:, :-1],
                               caches, torch.full((1,), s, dtype=torch.int32,
                                                  device=seq.device))
    lg = torch.cat([lg0, lg], dim=1)[0, :, :engine.cfg.vocab_size].float()
    picked = lg.gather(-1, new[0, :, None].long())[:, 0]
    tol = NEAR_TIE * max(1.0, float(lg.abs().max()))
    other = int((lg.argmax(-1) != new[0]).sum())
    return (lg.amax(-1) - picked).cpu(), tol, other


def _steady_chunk(torch, pool, run_step):
    """One steady step of ``pool`` (every slot seated, none waiting)
    through ``run_step()``, its decode chunk under
    ``set_sync_debug_mode("error")``.  Fails if the chunk synchronizes
    with the host, if the step admitted, restored, parked or retired, or
    if it launched anything but one ``gather_rows``, ``fused_stream`` and
    ``scatter_rows`` a bank.  Returns (``run_step()``'s result, its
    launches, host ms to its end on the card, ms between CUDA events
    around it)."""
    from repro_torch.kernels import ops

    before = pool.stats()
    if before["waiting"] or before["active"] != pool.slots:
        fail(f"the steady step is not steady: {before}")
    active = pool.table.active_count()
    inner = pool._chunk

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    pool._chunk = guarded
    c0 = ops.launch_counts()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    try:
        out = run_step()
    except RuntimeError as e:
        fail(f"the decode chunk failed under set_sync_debug_mode('error'), "
             f"where a host sync raises: {e}")
    finally:
        del pool._chunk
    ev1.record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts_delta(ops.launch_counts(), c0)
    after = pool.stats()
    moved = {k: (before[k], after[k]) for k in ("admits", "restores",
                                                "preemptions", "cancels")
             if after[k] != before[k]}
    if moved or pool.table.active_count() != active:
        fail(f"the steady step admitted, restored, parked or retired: "
             f"{moved}, active {active} -> {pool.table.active_count()}")
    want = {name: 0 for name in launches}
    want.update({k: len(pool.banks) for k in ("gather_rows", "fused_stream",
                                              "scatter_rows")})
    if launches != want:
        fail(f"one steady step launched {launches}, want {want}")
    return out, launches, step_ms, ev0.elapsed_time(ev1)


def _counts_delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _pool_gateway(torch, engine):
    """Phase 6's gateway over ``engine``; fails unless the engine and the
    pool's banks default to the kernels on the card."""
    from repro_torch.serve import Gateway

    gw = Gateway(engine, **POOL)
    if engine.cpm_backend != "cuda" or \
            {b.backend for b in gw.pool.banks} != {"cuda"}:
        fail("the pool on the card does not default to the cuda banks")
    return gw


def _pool_traffic(torch, dev, gw, vocab: int):
    """Phase 6's requests (``POOL_TRAFFIC``), each submitted once the
    gateway's tick count reaches its arrival, ticked until done; the
    launch counters set to 0 just before.  Returns ([(rid, prompt,
    budget)], the tick reports, seconds, the launch counts)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import repeated_prompts

    arrivals = []
    for i, (tick, n, plen, budget) in enumerate(POOL_TRAFFIC):
        prompts = repeated_prompts(n, plen, vocab, 20 + i, device=dev)
        arrivals += [(tick, prompts[j], budget) for j in range(n)]
    ops.reset_launch_counts()                      # the pool path, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, reports, nxt = [], [], 0
    while nxt < len(arrivals) or gw.loop.pending():
        while nxt < len(arrivals) and arrivals[nxt][0] <= gw.loop.ticks:
            _, prompt, budget = arrivals[nxt]
            rids.append((gw.submit(prompt, budget), prompt, budget))
            nxt += 1
        reports.append(gw.tick())
        if gw.loop.ticks > 200:
            fail("the gateway did not drain in 200 ticks")
    torch.cuda.synchronize()
    return rids, reports, time.perf_counter() - t0, ops.launch_counts()


def _seat_steady(torch, dev, gw, vocab: int, budget: int = 24):
    """Seat ``POOL["slots"]`` sessions of 64-token prompts with
    ``budget`` tokens each and run the tick that admits them (and one
    chunk): the next steps are steady."""
    from repro_torch.launch.serve import repeated_prompts

    for i in range(POOL["slots"]):
        gw.submit(repeated_prompts(1, 64, vocab, 40 + i, device=dev)[0],
                  budget)
    gw.tick()


def serve_pool(torch, dev, cfg, params, record, tag="pool",
               kernels=POOL_KERNELS, keep=None):
    """Phase 6 (see the module docstring) on ``cfg`` / ``params``, its
    record in ``record[tag]``; each of ``kernels`` must launch.  Returns
    the launch counts of the gateway run; ``keep`` (a dict) gets each
    request's tokens in order (``"tokens"``) and the gateway's
    ``"preemptions"``."""
    from repro_torch.serve import Engine, GenConfig

    # no backend named: on the card the engine and the pool's banks
    # default to the kernels
    engine = Engine(cfg, params, max_len=POOL_MAX_LEN)
    gw = _pool_gateway(torch, engine)
    pool = gw.pool
    rids, reports, t_run, counts = _pool_traffic(torch, dev, gw,
                                                 cfg.vocab_size)
    st = gw.stats()
    if keep is not None:
        keep.update(tokens=[gw.request(rid).tokens for rid, _, _ in rids],
                    preemptions=st["preemptions"])

    # every request finished with its budget
    for rid, prompt, budget in rids:
        req = gw.request(rid)
        if not req.done or req.cancelled or \
                len(req.tokens) != prompt.shape[0] + budget:
            fail(f"request {rid} did not finish with its budget "
                 f"({None if req.tokens is None else len(req.tokens)} "
                 f"tokens for {prompt.shape[0]} + {budget})")
    if st["preemptions"] <= 0:
        fail("the burst preempted nothing")
    if st["pages_free"] != pool.total_pages:
        fail(f"{st['pages_free']} of {pool.total_pages} pages free after "
             f"the drain")
    for name in kernels:
        if counts[name] <= 0:
            fail(f"{name} was not launched on the {tag} path ({counts})")
    if any(counts[name] for name in CPM_KERNELS + CPM2_KERNELS):
        fail(f"the pool path launched a per-op CPM kernel: {counts}")

    # tokens against solo generation, near-ties allowed
    t0 = time.perf_counter()
    identical, tie_steps, worst, worst_tol = 0, 0, 0.0, None
    for rid, prompt, budget in rids:
        got = torch.as_tensor(gw.request(rid).tokens).to(dev)
        solo, _ = engine.generate({"tokens": prompt[None]},
                                  GenConfig(max_new_tokens=budget))
        if torch.equal(got, solo[0]):
            identical += 1
            continue
        gaps, tol, other = _solo_gaps(torch, engine, prompt, got)
        if float(gaps.max()) >= worst:
            worst, worst_tol = float(gaps.max()), tol
        tie_steps += other
        if not float(gaps.max()) <= tol:
            fail(f"request {rid}: a pool token lies {float(gaps.max())} "
                 f"below the solo path's max logit (tol {tol})")
    t_solo = time.perf_counter() - t0
    print(f"{tag} tokens vs solo Engine.generate: {identical}/{len(rids)} "
          f"requests identical; in the others {tie_steps} steps took a "
          f"token other than the solo path's choice on the same prefix, "
          f"each a near-tie (largest gap {worst:.3e}, its tol {worst_tol} "
          f"= {NEAR_TIE} x max(1, |logit|))")

    # one steady step: 8 sessions seated, none waiting, finishing or parked
    _seat_steady(torch, dev, gw, cfg.vocab_size)
    _, steady, step_ms, event_ms = _steady_chunk(torch, pool, pool.step)
    dispatch_s = pool.last_chunk_s
    chunk_tokens = POOL["slots"] * POOL["chunk"]
    busy_ms, top = profile_top(torch, pool.step)
    while gw.loop.pending():
        gw.tick()
    if gw.stats()["pages_free"] != pool.total_pages:
        fail("pages leaked after the steady-step drain")

    pool_rec = {
        **POOL, "model": cfg.name, "max_len": POOL_MAX_LEN,
        "layers": cfg.n_layers, "requests": len(rids),
        "traffic": POOL_TRAFFIC,
        "ticks": st["ticks"], "run_s": t_run,
        "tokens_out": sum(b for _, _, b in rids),
        "run_tok_s": sum(b for _, _, b in rids) / t_run,
        "prefill_launches": st["prefill_launches"],
        "admits": st["admits"], "preemptions": st["preemptions"],
        "restores": st["restores"], "page_stalls": st["page_stalls"],
        "slo_met": st["slo_met"], "identical": identical,
        "near_tie_steps": tie_steps, "largest_gap": worst,
        "largest_gap_tol": worst_tol, "solo_check_s": t_solo,
        "launches": counts, "steady_launches": steady,
        "steady_step_ms": step_ms,
        "steady_step_device_ms": event_ms,
        "steady_dispatch_ms": dispatch_s * 1e3,
        "steady_decode_tok_s": chunk_tokens / step_ms * 1e3,
        "steady_device_busy_ms": busy_ms,
        "steady_idle_share": 1.0 - busy_ms / step_ms,
        "steady_top_kernels": top,
        "ticks_report": [{k: r[k] for k in (
            "tick", "step", "admitted", "restored", "preempted", "finished",
            "emitted", "chunk_wall_s", "wall_s", "active", "waiting",
            "parked", "pages_free")} for r in reports],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    record[tag] = pool_rec
    print(f"{tag} ({cfg.name}): {len(rids)} requests in {st['ticks']} ticks, "
          f"{t_run:.2f}s ({pool_rec['run_tok_s']:.1f} new tok/s incl. "
          f"prefill); prefill launches {st['prefill_launches']} for "
          f"{st['admits']} admits; preemptions {st['preemptions']}, "
          f"restores {st['restores']}, page stalls {st['page_stalls']}")
    print(f"{tag} steady step ({POOL['slots']} rows x chunk "
          f"{POOL['chunk']}): {step_ms:.1f} ms synchronized, "
          f"{event_ms:.1f} ms between events, chunk dispatch "
          f"{dispatch_s * 1e3:.1f} ms; {chunk_tokens / step_ms * 1e3:.1f} "
          f"decode tok/s; launches {steady}; no host sync in the chunk "
          f"under set_sync_debug_mode('error')")
    print(f"{tag} steady step under torch.profiler: device busy "
          f"{busy_ms:.1f} ms of the {step_ms:.1f} ms unprofiled step "
          f"(idle share {1.0 - busy_ms / step_ms:.3f}); top kernels "
          f"(ms, calls): {top}")
    print(f"launches on the {tag} path: {counts}")
    return counts


def _device_events(torch, fn) -> list:
    """One call of ``fn`` under ``torch.profiler``, the device's activity
    only: its kernels and copies, largest device time first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    return sorted(dev, key=lambda e: -e.self_device_time_total)


def _ms(events) -> float:
    return sum(e.self_device_time_total for e in events) / 1e3


def _top(events) -> list:
    """The eight largest events as ``[name, ms, calls]``."""
    return [[e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count]
            for e in events[:8]]


def profile_top(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: the summed device time
    of its kernels and copies (ms), and the eight largest by device time
    as ``[name, ms, calls]``."""
    dev = _device_events(torch, fn)
    return _ms(dev), _top(dev)


# ---------------------------------------------------------------------------
# phase 14: the HTTP/SSE wire and the live obs plane over the gateway
# ---------------------------------------------------------------------------

async def _until(cond, what: str, gw=None) -> None:
    """Wait for ``cond()``, polled every 10 ms, for at most HTTP_DEADLINE
    seconds; fails at the deadline or when ``gw``'s serve loop died."""
    import asyncio

    end = time.monotonic() + HTTP_DEADLINE
    while not cond():
        task = gw._task if gw is not None else None
        if task is not None and task.done():
            why = "cancelled" if task.cancelled() else task.exception()
            fail(f"the gateway's serve loop ended while waiting for {what}: "
                 f"{why}")
        if time.monotonic() > end:
            fail(f"timed out after {HTTP_DEADLINE}s waiting for {what}")
        await asyncio.sleep(0.01)


class _Stepped:
    """Awaits ``coro`` and adds the wall time of each of its steps to
    ``acc[0]``: the time the coroutine itself holds the event loop (a wait
    for the GIL inside a step included), without the waits between steps.
    Not ``thread_time``: some hosts count a thread's CPU time only in
    10 ms ticks."""

    def __init__(self, coro, acc):
        self.coro, self.acc = coro, acc

    def __await__(self):
        coro, acc = self.coro, self.acc
        value, exc = None, None
        while True:
            t0 = time.perf_counter()
            try:
                fut = coro.send(value) if exc is None else coro.throw(exc)
            except StopIteration as e:
                return e.value
            finally:
                acc[0] += time.perf_counter() - t0
            try:
                value, exc = (yield fut), None
            except BaseException as e:          # noqa: BLE001 -- to coro
                value, exc = None, e


def _time_handlers(fe):
    """Wraps the mounted frontend's ``_route``: each request's handler
    time on the event loop (:class:`_Stepped`) is kept under its route,
    JSON-body generates apart.  Returns ``{route: [seconds, ...]}``."""
    spent = {}
    inner = fe._route

    async def timed(method, route, body, reader, writer):
        acc = [0.0]
        try:
            return await _Stepped(inner(method, route, body, reader, writer),
                                  acc)
        finally:
            if route == "/v1/generate" and \
                    json.loads(body or b"{}").get("stream", True) is False:
                route += " (json)"
            spent.setdefault(route, []).append(acc[0])

    fe._route = timed
    return spent


async def _sse_tokens(wire, host, port, prompt, budget, **extra):
    """One SSE request: (token chunks, the first ``tokens`` event's and
    the ``done`` event's perf_counter times, the ``done`` payload)."""
    chunks, first, done = [], None, None
    async for ev, data in wire.sse_events(
            host, port, "/v1/generate",
            {"prompt": [int(t) for t in prompt], "max_new_tokens": budget,
             **extra}):
        if ev == "tokens":
            first = first or time.perf_counter()
            chunks.append(json.loads(data)["tokens"])
        elif ev == "done":
            done = json.loads(data)
    if done is None:
        fail(f"an SSE stream ended without its done event ({chunks})")
    return chunks, first, time.perf_counter(), done


async def _stream_of(gw, rid):
    """``Gateway.stream`` of ``rid``: (chunks, first chunk's and last
    chunk's perf_counter times)."""
    chunks, first = [], None
    async for c in gw.stream(rid):
        first = first or time.perf_counter()
        chunks.append([int(t) for t in c])
    return chunks, first, time.perf_counter()


async def _http_phase(torch, dev, cfg, params, card):
    """Phase 14 (see the module docstring).  Returns (launch counts of the
    phase, its record)."""
    import asyncio
    import shutil

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import repeated_prompts
    from repro_torch.obs import export, metrics, promparse, tracing
    from repro_torch.serve import Engine, Gateway
    from repro_torch.serve import http as wire

    engine = Engine(cfg, params, max_len=POOL_MAX_LEN)
    _, n_long, plen, budget = POOL_TRAFFIC[0]
    # phase 6's prompts, as host arrays: the wire carries token lists
    longs = list(repeated_prompts(n_long, plen, cfg.vocab_size, 20).numpy())
    short_budget = POOL_TRAFFIC[1][3]
    short = repeated_prompts(POOL_TRAFFIC[1][1], POOL_TRAFFIC[1][2],
                             cfg.vocab_size, 21).numpy()[0]
    steady = [repeated_prompts(1, 64, cfg.vocab_size, 40 + i).numpy()[0]
              for i in range(POOL["slots"])]
    rec_dir = ROOT / "build" / "chip_smoke" / "flightrec"
    shutil.rmtree(rec_dir, ignore_errors=True)
    limit = tracing.TRACER.max_events

    def http_series(route, code):
        fam = metrics.REGISTRY.get("repro_http_requests_total")
        return 0 if fam is None else fam.labels(route=route,
                                                code=str(code)).value

    ops.reset_launch_counts()                   # the http_pool path, counted
    gw = Gateway(engine, **POOL)
    pool = gw.pool
    if {b.backend for b in pool.banks} != {"cuda"}:
        fail("the gateway on the card does not default to the cuda banks")
    gen_200 = http_series("/v1/generate", 200)
    rec = {"pool": dict(POOL), "prompts": [n_long, plen, budget],
           "json_body": [int(short.shape[0]), short_budget]}

    # -- 1. identity: wire == in-process, the batch fixed -------------------
    async with gw._tick_lock:                   # no tick until all 5 wait
        await gw.start(http_port=0, http_host="127.0.0.1",
                       recorder_dir=str(rec_dir))
        await _until(lambda: gw.http is not None and gw.http.port != 0,
                     "the frontend to bind", gw)
        fe = gw.http
        host, port = fe.host, fe.port
        spent = _time_handlers(fe)
        if tracing.TRACER.max_events != fe._tracer_limit or \
                fe.ring not in tracing.TRACER._sinks:
            fail("the mounted frontend did not bound the tracer or attach "
                 "its ring")
        streams = []
        for p in longs:                         # one at a time: rid order
            streams.append(asyncio.ensure_future(
                _sse_tokens(wire, host, port, p, budget)))
            k = len(streams)
            await _until(lambda: len(gw._streaming) == k,
                         f"{k} SSE streams attached", gw)
        body = asyncio.ensure_future(wire.request(
            host, port, "POST", "/v1/generate",
            {"prompt": [int(t) for t in short],
             "max_new_tokens": short_budget, "stream": False}))
        await _until(lambda: gw.stats()["waiting"] == n_long + 1,
                     "all 5 requests waiting", gw)
        t_wire = time.perf_counter()
    wire_out = await asyncio.wait_for(asyncio.gather(*streams),
                                      HTTP_DEADLINE)
    status, _, raw = await asyncio.wait_for(body, HTTP_DEADLINE)
    t_wire_end = time.perf_counter()
    if status != 200:
        fail(f"the JSON-body request answered {status}: {raw[:300]}")
    json_body = json.loads(raw)

    # the in-process reference runs while the wire gateway idles: its
    # launches are taken out of the http_pool path's
    c_local = ops.launch_counts()
    local = Gateway(engine, **POOL)
    rids = [await local.asubmit(p, budget) for p in longs]
    rids.append(await local.asubmit(short, short_budget))
    consumers = [asyncio.ensure_future(_stream_of(local, r)) for r in rids]
    await _until(lambda: len(local._streaming) == len(rids),
                 "the in-process streams attached")
    t_local = time.perf_counter()
    await local.start()
    local_out = await asyncio.wait_for(asyncio.gather(*consumers),
                                       HTTP_DEADLINE)
    t_local_end = time.perf_counter()
    await local.stop()
    local_counts = _counts_delta(ops.launch_counts(), c_local)
    for i, ((chunks, *_), (lchunks, *_)) in enumerate(zip(wire_out,
                                                          local_out)):
        if chunks != lchunks:
            fail(f"request {i}: SSE chunks differ from the in-process "
                 f"stream's: {chunks} vs {lchunks}")
        if np.asarray(sum(chunks, []), np.int32).tobytes() != \
                np.asarray(sum(lchunks, []), np.int32).tobytes() or \
                sum(len(c) for c in chunks) != budget or len(chunks) < 2:
            fail(f"request {i}: {sum(len(c) for c in chunks)} wire tokens "
                 f"in {len(chunks)} chunks for budget {budget}")
    want = [int(t) for t in short] + sum(local_out[-1][0], [])
    got_local = [int(t) for t in np.asarray(local.request(rids[-1]).tokens)]
    if json_body["tokens"] != want or got_local != want or \
            json_body["n_tokens"] != len(short) + short_budget:
        fail(f"the JSON body's tokens {json_body['tokens'][-short_budget:]} "
             f"differ from their stream {want[-short_budget:]}")
    new_tokens = n_long * budget + short_budget
    ttft_wire = [w[1] - t_wire for w in wire_out]
    ttft_local = [w[1] - t_local for w in local_out]
    rec["identity"] = {
        "wire_s": t_wire_end - t_wire, "inprocess_s": t_local_end - t_local,
        "wire_tok_s": new_tokens / (t_wire_end - t_wire),
        "inprocess_tok_s": new_tokens / (t_local_end - t_local),
        "ttft_wire_ms": [x * 1e3 for x in ttft_wire],
        "ttft_inprocess_ms": [x * 1e3 for x in ttft_local],
        "chunks": [len(w[0]) for w in wire_out]}
    print(f"http identity: {n_long} SSE streams of {plen} + {budget} and a "
          f"JSON body of {len(short)} + {short_budget} == the in-process "
          f"stream, bit for bit, chunks {rec['identity']['chunks']}")

    # -- 2. steady ticks with the frontend mounted --------------------------
    async with gw._tick_lock:
        clients = []
        for p in steady:
            clients.append(asyncio.ensure_future(
                _sse_tokens(wire, host, port, p, 24)))
            k = len(clients)
            await _until(lambda: len(gw._streaming) == k,
                         f"{k} steady streams attached", gw)
        await _until(lambda: gw.stats()["waiting"] == POOL["slots"],
                     "8 steady requests waiting", gw)
        # ticks as serve() runs them: the compute in a worker thread,
        # delivery back on the event loop
        gw.last_report = await asyncio.to_thread(gw.loop.tick)
        gw._publish()
        gw.last_report, step_counts, tick_ms, tick_event_ms = \
            await asyncio.to_thread(_steady_chunk, torch, pool, gw.loop.tick)
        chunk_ms = gw.last_report.chunk_wall_s * 1e3
        c0 = ops.launch_counts()
        t0 = time.perf_counter()
        gw._publish()
        publish_ms = (time.perf_counter() - t0) * 1e3
        delivery = _counts_delta(ops.launch_counts(), c0)
        # the same step on the event loop's own thread, as phase 6 runs it
        _, _, main_ms, _ = _steady_chunk(torch, pool, pool.step)
        gw._publish()
        busy_ms, top = profile_top(torch, gw.loop.tick)   # device time
        gw._publish()
    await asyncio.wait_for(asyncio.gather(*clients), HTTP_DEADLINE)
    chunk_tokens = POOL["slots"] * POOL["chunk"]
    rec["steady"] = {
        "launches": step_counts, "delivery_launches": delivery,
        "tick_ms": tick_ms, "tick_device_ms": tick_event_ms,
        "tick_chunk_dispatch_ms": chunk_ms, "main_thread_step_ms": main_ms,
        "decode_tok_s": chunk_tokens / tick_ms * 1e3,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / tick_ms,
        "top_kernels": top, "publish_ms": publish_ms}
    print(f"http steady tick (frontend mounted, {POOL['slots']} SSE "
          f"streams, gw.loop.tick in a worker thread as serve() runs it): "
          f"launches {step_counts}, no host sync in the chunk under "
          f"set_sync_debug_mode('error'); {tick_ms:.1f} ms synchronized, "
          f"{tick_event_ms:.1f} ms between events, chunk dispatch "
          f"{chunk_ms:.1f} ms, {chunk_tokens / tick_ms * 1e3:.1f} decode "
          f"tok/s; pool.step() on the event loop thread {main_ms:.1f} ms; "
          f"device busy "
          f"{busy_ms:.1f} ms under torch.profiler (idle share "
          f"{1.0 - busy_ms / tick_ms:.3f}); the delivery to 8 streams "
          f"{publish_ms:.2f} ms on the host, "
          f"{delivery['gather_rows']} gather_rows; {card}")

    # -- 3. /metrics against gw.stats() -------------------------------------
    await _until(lambda: not gw.loop.pending(), "the steady streams done",
                 gw)
    stats = gw.stats()                          # sets the pool's gauges
    st, _, raw = await wire.request(host, port, "GET", "/metrics")
    if st != 200:
        fail(f"/metrics answered {st}")
    fams = promparse.parse(raw.decode("utf-8"))

    def scraped(name, **labels):
        key = tuple(sorted(labels.items()))
        if name not in fams or key not in fams[name].series():
            fail(f"/metrics has no {name}{labels}")
        return fams[name].series()[key]

    served = n_long + 1 + POOL["slots"]
    got = scraped("repro_http_requests_total", route="/v1/generate",
                  code="200")
    if got != gen_200 + served:
        fail(f"repro_http_requests_total counts {got} generate requests, "
             f"want {gen_200 + served}")
    gw_label = next(dict(k)["gw"] for k, s in metrics.REGISTRY.get(
        "repro_gateway_requests_total")._series.items()
        if s is gw._obs_series["requests_total"])
    checks = {("repro_gateway_requests_total", "gw", gw_label): "requests",
              ("repro_gateway_slo_met_total", "gw", gw_label): "slo_met",
              ("repro_gateway_slo_missed_total", "gw", gw_label):
                  "slo_missed"}
    for key, name in (("admits", "admits_total"),
                      ("prefill_launches", "prefill_launches_total"),
                      ("decode_steps", "decode_steps_total"),
                      ("emitted", "emitted_total"),
                      ("submitted", "submitted_total"),
                      ("cancels", "cancels_total"),
                      ("preemptions", "preemptions_total"),
                      ("active", "active"), ("waiting", "waiting"),
                      ("pages_free", "pages_free")):
        checks[(f"repro_pool_{name}", "pool", pool._pool_label)] = key
    for (name, label, value), key in checks.items():
        if scraped(name, **{label: value}) != stats[key]:
            fail(f"/metrics {name}{{{label}={value}}} = "
                 f"{scraped(name, **{label: value})}, gw.stats()[{key!r}] "
                 f"= {stats[key]}")
    rec["metrics"] = {"families": len(fams), "bytes": len(raw),
                      "checked": len(checks) + 1}
    print(f"http /metrics: {len(fams)} families, {len(raw)} bytes, parsed "
          f"by the strict parser; {len(checks) + 1} series equal "
          f"gw.stats()")

    # -- 4. the chunked trace ------------------------------------------------
    total = fe.ring.stats()["total"]
    st, hdrs, raw = await wire.request(host, port, "GET", "/debug/trace")
    if st != 200 or hdrs.get("transfer-encoding") != "chunked":
        fail(f"/debug/trace answered {st} with {hdrs}")
    if fe.ring.stats()["total"] != total:
        fail("the ring grew while the trace was read")
    one_shot = json.dumps(export.chrome_trace(fe.ring), indent=1)
    if raw.decode("utf-8") != one_shot:
        fail("the chunked /debug/trace body differs from chrome_trace")
    counts = export.validate_chrome_trace(json.loads(raw))
    for name in ("gateway.tick", "pool.admission", "pool.prefill",
                 "pool.decode_chunk"):
        if counts.get(name, 0) < 1:
            fail(f"the trace has no {name} span: {sorted(counts)}")
    rec["trace"] = {"bytes": len(raw), "events": sum(counts.values()),
                    "ring": fe.ring.stats()}
    print(f"http /debug/trace: {len(raw)} bytes in chunks == chrome_trace "
          f"of the ring, {sum(counts.values())} events, valid")

    # -- 5. a client that walks away ----------------------------------------
    gone = metrics.REGISTRY.get("repro_http_disconnects_total").default.value
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(wire._request_bytes("POST", "/v1/generate", host, json.dumps(
        {"prompt": [int(t) for t in longs[0]],
         "max_new_tokens": HTTP_DISCONNECT_BUDGET}).encode()))
    await writer.drain()
    await asyncio.wait_for(reader.readuntil(b"start"), HTTP_DEADLINE)
    writer.close()
    await writer.wait_closed()
    req = gw.request(gw._next_rid - 1)
    await _until(lambda: req.done, "the disconnected request to end", gw)
    if not req.cancelled or len(req.tokens) >= plen + HTTP_DISCONNECT_BUDGET:
        fail(f"the disconnected request was not cancelled "
             f"({len(req.tokens)} tokens)")
    await _until(lambda: pool.alloc.free_count() == pool.slots
                 and pool.alloc.page_free_count() == pool.total_pages,
                 "every slot and page back", gw)
    await _until(lambda: metrics.REGISTRY.get(
        "repro_http_disconnects_total").default.value == gone + 1,
        "the disconnect counted", gw)
    rec["disconnect"] = {"tokens_at_cancel": len(req.tokens) - plen}
    print(f"http disconnect: cancelled after {len(req.tokens) - plen} of "
          f"{HTTP_DISCONNECT_BUDGET} tokens; {pool.slots} slots and "
          f"{pool.total_pages} pages free")

    # -- 6. an SLO burn fires the flight recorder ----------------------------
    mon = gw.slo_monitor
    n_alerts = len(mon.alerts)
    burst = [asyncio.ensure_future(wire.request(
        host, port, "POST", "/v1/generate",
        {"prompt": [int(t) for t in steady[i]], "max_new_tokens": 8,
         "deadline_steps": 1, "stream": False}))
        for i in range(HTTP_BURST)]
    for r in await asyncio.wait_for(asyncio.gather(*burst), HTTP_DEADLINE):
        if r[0] != 200 or json.loads(r[2])["slo_met"] is not False:
            fail(f"a burst request answered {r[0]}: {r[2][:200]}")
    if len(mon.alerts) != n_alerts + 1:
        fail(f"the burst fired {len(mon.alerts) - n_alerts} alerts, want 1 "
             f"({mon.state()})")
    alert = mon.alerts[-1]
    dumps = sorted(os.listdir(rec_dir)) if rec_dir.is_dir() else []
    if dumps != ["flight_0000.json"] or alert["dump"] != str(
            rec_dir / "flight_0000.json"):
        fail(f"the alert wrote {dumps} (dump {alert['dump']})")
    dump = json.loads((rec_dir / dumps[0]).read_text())
    export.validate_chrome_trace(dump["trace"])
    promparse.parse(dump["metrics_prom"])
    alloc = dump["allocator"]
    used = sum(len(v) for v in alloc["page_lists"].values())
    if alloc["n_slots"] != POOL["slots"] or \
            alloc["n_pages"] != pool.total_pages or \
            alloc["free_slots"] != alloc["slot_state"].count(0) or \
            alloc["free_pages"] != alloc["page_state"].count(0) or \
            used != alloc["n_pages"] - alloc["free_pages"] or \
            alloc["page_size"] != POOL["page_size"]:
        fail(f"the dump's allocator state is inconsistent: "
             f"{ {k: v for k, v in alloc.items() if 'state' not in k} }")
    rec["alert"] = {"step": alert["step"], "fast": alert["fast"],
                    "slow": alert["slow"], "dump_bytes":
                    (rec_dir / dumps[0]).stat().st_size,
                    "dump_spans": len(dump["trace"]["traceEvents"]),
                    "slo": mon.state()}
    print(f"http SLO burst: {HTTP_BURST} requests past deadline_steps=1, "
          f"one alert at step {alert['step']} (fast burn "
          f"{alert['fast']['burn']:.1f}x, slow {alert['slow']['burn']:.1f}x)"
          f", dump {dumps[0]} ({rec['alert']['dump_bytes']} bytes): trace "
          f"valid, Prometheus text parsed, allocator {alloc['free_slots']} "
          f"slots / {alloc['free_pages']} pages free")

    # -- the frontend's host time per request --------------------------------
    t0 = time.perf_counter()
    for _ in range(HTTP_HEALTHZ_TRIPS):
        st, _, _ = await wire.request(host, port, "GET", "/healthz")
        if st != 200:
            fail(f"/healthz answered {st}")
    healthz_ms = (time.perf_counter() - t0) * 1e3 / HTTP_HEALTHZ_TRIPS
    await gw.stop()
    if fe.ring in tracing.TRACER._sinks or \
            tracing.TRACER.max_events != limit:
        fail("the unmounted frontend left its sink or the tracer's limit")
    counts = _counts_delta(ops.launch_counts(), local_counts)
    for name in POOL_KERNELS:
        if counts[name] <= 0:
            fail(f"{name} was not launched on the http_pool path ({counts})")
    if any(counts[name] for name in CPM_KERNELS + CPM2_KERNELS):
        fail(f"the http_pool path launched a per-op CPM kernel: {counts}")
    ident = rec["identity"]
    rec["healthz_ms"] = healthz_ms
    rec["handler_ms"] = {r: {"requests": len(v), "mean": np.mean(v) * 1e3,
                                 "max": np.max(v) * 1e3}
                             for r, v in sorted(spent.items())}
    rec["launches"] = counts
    rec["inprocess_launches"] = local_counts
    print(f"http time to the first SSE token: "
          f"{np.mean(ident['ttft_wire_ms']):.1f} ms (in-process stream "
          f"{np.mean(ident['ttft_inprocess_ms']):.1f} ms), the 5 requests "
          f"of {plen} / {len(short)} prompt tokens admitted in one tick; "
          f"{card}")
    print(f"http wire {ident['wire_tok_s']:.1f} new tok/s against "
          f"in-process {ident['inprocess_tok_s']:.1f} tok/s "
          f"({new_tokens} tokens, {ident['wire_s']:.3f} s vs "
          f"{ident['inprocess_s']:.3f} s); {card}")
    per_route = "; ".join(
        f"{r} {v['mean']:.3f} ms mean, {v['max']:.3f} max over "
        f"{v['requests']}" for r, v in rec["handler_ms"].items())
    print(f"http frontend host time per request (the wall time of the "
          f"handler's own steps on the event loop, other tasks and the "
          f"waits between steps excluded): {per_route}; a /healthz round "
          f"trip {healthz_ms:.3f} ms wall (mean of {HTTP_HEALTHZ_TRIPS}); "
          f"{card}")
    print(f"launches on the http_pool path: {counts} (the in-process "
          f"reference's {local_counts} taken out)")
    return counts, rec


def serve_http(torch, dev, cfg, params, record, card):
    """Phase 14 on phase 6's weights; its record in ``record["http"]``.
    Returns the launch counts of the phase."""
    import asyncio

    counts, record["http"] = asyncio.run(_http_phase(torch, dev, cfg,
                                                     params, card))
    return counts


# ---------------------------------------------------------------------------
# phase 10: recurrentgemma-9b at full width and depth
# ---------------------------------------------------------------------------

def _init_full(torch, dev, name, seed):
    """A config's full-width random parameters on the card, timed."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(name)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in torch.utils._pytree.tree_flatten(params)[0])
    init_s = time.perf_counter() - t0
    print(f"{name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n / 1e9:.3f}B float32 params (config count "
          f"{cfg.param_count() / 1e9:.3f}B), init {init_s:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    return cfg, params, {"params": n, "init_s": init_s}


def _serve_counted(torch, dev, name, cfg, params, batch, new, spec, flash,
                   card):
    """``Engine.generate`` on ``batch`` (its (B, S) ``tokens`` and whatever
    else the model reads) with ``new`` tokens, greedy scan then
    speculative (draft ``spec``), the launch counters set to 0 before
    each run: tokens in the vocabulary, speculative == scan, ``flash``
    ``flash_attention`` launches a run (its one prefill; none a decode
    step), the commit's launches as its verdict implies, one host sync a
    round and none in a commit; then the prefill timed, its logits
    finite, and profiled.  Returns (record, the speculative run's counts,
    engine)."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve import Engine, GenConfig

    b, s = batch["tokens"].shape
    torch.cuda.reset_peak_memory_stats()             # this model's peak
    engine = Engine(cfg, params, max_len=s + new + spec + 8,
                    cpm_backend="cuda")
    scan_cfg = GenConfig(max_new_tokens=new)
    spec_cfg = GenConfig(max_new_tokens=new, ngram_spec=spec)
    # the commit's verdict at this shape first: a calibrated model settles
    # it by timing the group once, outside the counted runs
    kind, decision = _commit_verdict(torch, dev, b, s + new, spec)

    ops.reset_launch_counts()                      # the scan path, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan, _ = engine.generate(batch, scan_cfg)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    scan_counts = ops.launch_counts()
    gen = {"engine": engine, "batch": batch, "spec": spec_cfg}
    out, stats, counts, syncs, t_spec = _generate_counted(torch, gen)
    in_commit, in_prefill, rounds_syncs = syncs

    if tuple(scan.shape) != (b, s + new) or not bool(
            ((scan >= 0) & (scan < cfg.vocab_size)).all()):
        fail(f"{name} scan output {tuple(scan.shape)} or tokens outside "
             f"the vocabulary")
    if not torch.equal(scan, out):
        fail(f"{name}: speculative tokens differ from scan tokens")
    for path, c in (("scan", scan_counts), ("speculative", counts)):
        if c["flash_attention"] != flash:
            fail(f"{name} {path}: flash_attention launched "
                 f"{c['flash_attention']} times, want {flash} (one "
                 f"prefill)")
    if scan_counts["fused_stream"] or scan_counts["shift_range"]:
        fail(f"the {name} scan path launched a commit kernel: "
             f"{scan_counts}")
    commit_launch_check(counts, kind, stats["rounds"], f"{name} generate")
    if in_commit:
        fail(f"a {name} commit synchronized with the host: "
             f"{in_commit[:3]}")
    if len(rounds_syncs) != stats["rounds"]:
        fail(f"{name}: {len(rounds_syncs)} host syncs over "
             f"{stats['rounds']} rounds outside the prefill, want one a "
             f"round: {rounds_syncs[:3]}")

    t0 = time.perf_counter()
    logits, _ = lm.prefill(params, cfg, batch, max_len=engine.max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size].float()).all()):
        fail(f"{name}: non-finite prefill logits")
    del logits
    busy_ms, top = profile_top(torch, lambda: lm.prefill(
        params, cfg, batch, max_len=engine.max_len))
    print(f"{name} prefill under torch.profiler: device busy "
          f"{busy_ms:.1f} ms; top kernels (ms, calls): {top}")
    n_new = b * new
    rec = {"layers": cfg.n_layers, "batch": b, "prompt_len": s,
           "max_new": new, "spec": spec, "prefill_ms": prefill_ms,
           "prefill_device_busy_ms": busy_ms, "prefill_top_kernels": top,
           "scan_s": t_scan, "scan_tok_s": n_new / t_scan,
           "spec_s": t_spec, "spec_tok_s": n_new / t_spec,
           "rounds": stats["rounds"], "accepted": stats["accepted"],
           "proposed": stats["proposed"],
           "acceptance_rate": stats["acceptance_rate"],
           "launches_scan": scan_counts, "launches": counts,
           "commit_verdict": kind, "commit_decision": decision,
           "host_syncs_rounds": len(rounds_syncs),
           "host_syncs_commits": len(in_commit),
           "host_syncs_prefill": len(in_prefill),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"{name} serve: prefill {prefill_ms:.1f} ms (B={b} x {s}); "
          f"scan {t_scan:.2f}s = {n_new / t_scan:.1f} tok/s; spec "
          f"{t_spec:.2f}s = {n_new / t_spec:.1f} tok/s, {stats['rounds']} "
          f"rounds, acceptance {stats['acceptance_rate']:.3f}; spec == "
          f"scan; flash_attention {counts['flash_attention']} a prefill, "
          f"none a decode step; commit {kind}: fused_stream "
          f"{counts['fused_stream']}, shift_range {counts['shift_range']}; "
          f"host syncs {len(rounds_syncs)} in {stats['rounds']} rounds, 0 "
          f"in commits, {len(in_prefill)} in the prefill; peak "
          f"{rec['peak_gib']:.1f} GiB; {card}")
    return rec, counts, engine


def serve_recurrentgemma(torch, dev, record, card):
    """Phase 10: recurrentgemma-9b through ``Engine.generate`` at batch 2
    with 2,304-token prompts (past the 2,048-key window: every ring
    wraps), 32 new tokens, greedy scan then speculative (draft 4)
    (:func:`_serve_counted`, 12 ``flash_attention`` launches a prefill:
    one per attn_local layer); each ring the window wide; then phase 6's
    gateway over the paged pool on these weights.  Returns (generate
    counts, pool counts)."""
    from repro_torch.launch.serve import repeated_prompts
    from repro_torch.models import lm

    cfg, params, init = _init_full(torch, dev, "recurrentgemma-9b", 0)
    n_local = sum(k == "attn_local" for k in cfg.layer_kinds())
    prompt = repeated_prompts(HYB_BATCH, HYB_PROMPT, cfg.vocab_size, 3,
                              device=dev)
    rec, counts, engine = _serve_counted(
        torch, dev, "recurrentgemma-9b", cfg, params, {"tokens": prompt},
        HYB_NEW, HYB_SPEC, n_local, card)
    _, caches = lm.prefill(params, cfg, {"tokens": prompt},
                           max_len=engine.max_len)
    ring = caches["blocks"][2]["attn"]["k"]
    if ring.shape[-2] != cfg.window:
        fail(f"recurrentgemma ring of {ring.shape[-2]} slots, want "
             f"{cfg.window}")
    del caches, ring
    record["hybrid"] = {**init, **rec, "attn_local_layers": n_local,
                        "window": cfg.window}
    pool_counts = serve_pool(torch, dev, cfg, params, record,
                             tag="hybrid_pool")
    return counts, pool_counts


# ---------------------------------------------------------------------------
# phase 11: granite-moe-1b-a400m at full width
# ---------------------------------------------------------------------------

def check_moe_layers(torch, cfg, params, cpu_p, tokens):
    """Phase 11's gate on the served dtype: every layer of the model run on
    the card and on the CPU in bf16 compute from the CPU's input to that
    layer (so no layer inherits another's rounding).  Routing: the router
    probabilities within ``NEAR_TIE``; the comparable-memory mask equal
    token by token except at near-ties (a token whose k-th and (k+1)-th
    CPU probabilities lie within twice the layer's largest probability
    difference); the experts that keep each token equal except in an
    expert whose queue a near-tie changed (capacity drops shift).  Hidden
    state: each token whose routing agrees within 2e-2 x max(1, its
    largest |value|), phase 3's tolerance per token.  Returns a record."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    b, s = tokens.shape
    dev = params["emb"].device
    unit, n_rep, tail = lm._layout(cfg)
    blocks = [(kind, lm._rep(cpu_p["blocks"][u], r),
               lm._rep(params["blocks"][u], r))
              for r in range(n_rep) for u, kind in enumerate(unit)]
    blocks += list(zip(tail, cpu_p["tail"], params["tail"]))
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    route, seen = L.moe_route, []

    def recorded(probs, k, cap):
        out = route(probs, k, cap)
        seen.append([t.cpu() for t in (probs, *out)])
        return out

    def kept(eidx, keep):                 # (T, E): experts that hold a token
        return torch.zeros(eidx.shape[0], cfg.moe.n_experts,
                           dtype=torch.bool).scatter(1, eidx, keep)

    x = lm._embed(cpu_p, cfg, tokens)
    per_layer = []
    L.moe_route = recorded
    try:
        for i, (kind, blk_cpu, blk_dev) in enumerate(blocks):
            want, _, _ = lm.block_fwd(blk_cpu, x, kind, cfg, pos)
            got, _, _ = lm.block_fwd(blk_dev, x.to(dev), kind, cfg,
                                     pos.to(dev))
            (pw, mw, ew, _, kw), (pg, mg, eg, _, kg) = seen[-2:]
            dp = float((pg - pw).abs().max())
            top = pw.sort(-1, descending=True).values
            k = cfg.moe.top_k
            near = (top[:, k - 1] - top[:, k]) <= 2 * dp
            flip = (mw != mg).any(-1)
            moved = (mw != mg).any(0)                # experts a flip touched
            kd = kept(ew, kw) != kept(eg, kg)
            same = ~(flip | kd.any(-1))
            wt, gt = want.reshape(b * s, -1).float(), \
                got.cpu().reshape(b * s, -1).float()
            err = ((gt - wt).abs().amax(-1)
                   / wt.abs().amax(-1).clamp_min(1.0))[same]
            rec = {"layer": i, "probs_max_diff": dp,
                   "near_ties": int(near.sum()), "mask_flips": int(flip.sum()),
                   "keep_diffs": int(kd.any(-1).sum()),
                   "tokens_compared": int(same.sum()),
                   "hidden_rel_err": float(err.max()) if len(err) else None,
                   "hidden_max_abs": float(wt.abs().max())}
            per_layer.append(rec)
            if not dp <= NEAR_TIE:
                fail(f"granite-moe layer {i}: router probabilities differ "
                     f"by {dp} between the card and the CPU")
            if bool((flip & ~near).any()):
                fail(f"granite-moe layer {i}: the card routes "
                     f"{int((flip & ~near).sum())} tokens to other experts "
                     f"than the CPU away from a near-tie")
            if bool((kd & ~moved[None]).any()):
                fail(f"granite-moe layer {i}: capacity keeps differ in an "
                     f"expert no near-tie touched")
            if not same.any() or float(err.max()) > 2e-2:
                fail(f"granite-moe layer {i}: bf16 hidden state differs "
                     f"from the CPU's by {rec['hidden_rel_err']} of a "
                     f"token's largest value (tol 2e-2), "
                     f"{rec['tokens_compared']} tokens compared")
            x = want
    finally:
        L.moe_route = route
    out = {"layers": len(per_layer),
           "worst_hidden_rel_err": max(r["hidden_rel_err"]
                                       for r in per_layer),
           "worst_probs_diff": max(r["probs_max_diff"] for r in per_layer),
           "mask_flips": sum(r["mask_flips"] for r in per_layer),
           "keep_diffs": sum(r["keep_diffs"] for r in per_layer),
           "first_layers": per_layer[:2], "per_layer": per_layer}
    print(f"granite-moe-1b-a400m bf16, each layer from the CPU's input, card "
          f"vs CPU over {len(per_layer)} layers: hidden state within "
          f"{out['worst_hidden_rel_err']:.3e} of a token's largest value "
          f"(tol 2e-2), router probabilities within "
          f"{out['worst_probs_diff']:.3e}, {out['mask_flips']} routing "
          f"flips (all near-ties), {out['keep_diffs']} capacity keeps moved "
          f"by them; layers 0-1: {per_layer[:2]}")
    return out


def serve_moe(torch, dev, record, card):
    """Phase 11: granite-moe-1b-a400m (24 layers, 32 experts, top 8) at full
    width on a small input, card against the port's CPU run of the same
    weights: the last position's prefill logits with both sides computing
    in float32, within phase 3's tolerance (2e-2 x max(1, |logit|)); in
    bf16, the served dtype, layer by layer (:func:`check_moe_layers`),
    with the full-depth bf16 logits reported beside them.  Then
    ``Engine.generate``, scan and speculative, counted, with tokens/s,
    acceptance and the share of speculative tokens equal to the scan's.
    That share is not gated: each decode step routes the batch's b tokens
    (one a row) under one capacity, and in a speculative step those are
    drafts, some later rejected, at each row's own position, so where an
    expert overflows another token is dropped than in the scan (at
    ``MOE_BATCH`` = 4 the capacity, max(int(1.25 x 4 x 8 / 32), 4) = 4,
    holds every row's token, so none is dropped at decode).
    Returns the generate path's launch counts."""
    from repro_torch.launch.serve import repeated_prompts
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serve import Engine, GenConfig

    cfg, params, init = _init_full(torch, dev, "granite-moe-1b-a400m", 5)
    b, s = MOE_SMALL
    small = repeated_prompts(b, s, cfg.vocab_size, 6)
    cpu_p = lm.tree_map(lambda t: t.cpu(), params)

    def last_logits(dtype):
        """The small input's last prefill logits, CPU and card, with the
        model computing in ``dtype`` (the port's ``COMPUTE_DTYPE``)."""
        saved = L.COMPUTE_DTYPE
        L.COMPUTE_DTYPE = dtype
        try:
            want, _ = lm.prefill(cpu_p, cfg, {"tokens": small})
            got, _ = lm.prefill(params, cfg, {"tokens": small.to(dev)})
        finally:
            L.COMPUTE_DTYPE = saved
        want = want[..., :cfg.vocab_size].float()
        got = got[..., :cfg.vocab_size].float().cpu()
        return (float((got - want).abs().max()),
                2e-2 * max(1.0, float(want.abs().max())),
                float((got.argmax(-1) == want.argmax(-1)).float().mean()))

    err, tol, same_top = last_logits(torch.float32)
    err16, tol16, same16 = last_logits(torch.bfloat16)
    layers16 = check_moe_layers(torch, cfg, params, cpu_p, small)
    del cpu_p
    print(f"granite-moe-1b-a400m small input ({b} x {s}), card vs CPU, last "
          f"logits: float32 compute max |diff| {err:.3e} (tol {tol:.3e}), "
          f"argmax equal {same_top:.3f}; bf16 compute through all "
          f"{cfg.n_layers} layers max |diff| {err16:.3e} ({tol16:.3e} would "
          f"be the tolerance), argmax equal {same16:.3f} (not gated: each "
          f"layer carries the differences of those before it; bf16 is held "
          f"layer by layer above)")
    if not err <= tol:
        fail(f"granite-moe card logits (float32 compute) differ from the "
             f"CPU run by {err} (tol {tol})")

    engine = Engine(cfg, params,
                    max_len=MOE_PROMPT + MOE_NEW + MOE_SPEC + 8,
                    cpm_backend="cuda")
    prompt = repeated_prompts(MOE_BATCH, MOE_PROMPT, cfg.vocab_size, 7,
                              device=dev)
    kind, _ = _commit_verdict(torch, dev, MOE_BATCH, MOE_PROMPT + MOE_NEW,
                              MOE_SPEC)                # settled uncounted
    ops.reset_launch_counts()                      # the generate path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan, _ = engine.generate({"tokens": prompt},
                              GenConfig(max_new_tokens=MOE_NEW))
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec, stats = engine.generate({"tokens": prompt},
                                  GenConfig(max_new_tokens=MOE_NEW,
                                            ngram_spec=MOE_SPEC))
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    counts = ops.launch_counts()
    for name, out in (("scan", scan), ("spec", spec)):
        if tuple(out.shape) != (MOE_BATCH, MOE_PROMPT + MOE_NEW) or not \
                bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            fail(f"granite-moe {name} output {tuple(out.shape)} or tokens "
                 f"outside the vocabulary")
    if counts["flash_attention"] != 2 * cfg.n_layers:
        fail(f"granite-moe: flash_attention launched "
             f"{counts['flash_attention']} times for two prefills of "
             f"{cfg.n_layers} layers")
    commit_launch_check(counts, kind, stats["rounds"], "granite-moe generate")
    t0 = time.perf_counter()
    lm.prefill(params, cfg, {"tokens": prompt}, max_len=engine.max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    new = MOE_BATCH * MOE_NEW
    agree = float((scan == spec).float().mean())
    record["moe"] = {**init, "small_input": [b, s], "small_max_abs_err": err,
                     "small_tol": tol, "small_argmax_equal": same_top,
                     "small_bf16_max_abs_err": err16,
                     "small_bf16_argmax_equal": same16,
                     "small_bf16_layers": layers16,
                     "batch": MOE_BATCH, "prompt_len": MOE_PROMPT,
                     "max_new": MOE_NEW, "spec": MOE_SPEC,
                     "prefill_ms": prefill_ms, "scan_tok_s": new / t_scan,
                     "spec_tok_s": new / t_spec, "rounds": stats["rounds"],
                     "acceptance_rate": stats["acceptance_rate"],
                     "spec_scan_token_agreement": agree,
                     "commit_verdict": kind, "launches": counts}
    print(f"granite-moe-1b-a400m serve: prefill {prefill_ms:.1f} ms (B="
          f"{MOE_BATCH} x {MOE_PROMPT}); scan {new / t_scan:.1f} tok/s; spec "
          f"{new / t_spec:.1f} tok/s, {stats['rounds']} rounds, acceptance "
          f"{stats['acceptance_rate']:.3f}, tokens equal to scan's "
          f"{agree:.3f} (not gated: a step's capacity is shared with draft "
          f"tokens); launches "
          f"{counts}; {card}")
    del params, engine
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 12: xlstm-1.3b at full width and depth
# ---------------------------------------------------------------------------

def _rel_err(want, got, per_token=False) -> float:
    """max |got - want| over max(1, max |want|): of the whole tensor, or
    (``per_token``) of each token's row of a (..., d) tensor, the largest."""
    w, g = want.float(), got.float().cpu()
    if per_token:
        return float(((g - w).abs().amax(-1)
                      / w.abs().amax(-1).clamp_min(1.0)).max())
    return float((g - w).abs().max() / max(1.0, float(w.abs().max())))


def check_xlstm_layers(torch, cfg, params):
    """Phase 12's small input: the first mLSTM layer and the sLSTM layer of
    the full-width model in float32 compute, on the card and on the CPU
    from the same input (2 x 16 embedded tokens): each output and state
    within ``XL_TOL`` x max(1, its largest |value|).  Returns a record."""
    from repro_torch.launch.serve import repeated_prompts
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    b, s = XL_SMALL
    dev = params["emb"].device
    unit, _, _ = lm._layout(cfg)
    tokens = repeated_prompts(b, s, cfg.vocab_size, 10, device=dev)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    out = {}
    saved = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        x = lm._embed(params, cfg, tokens).cpu()
        for kind in ("mlstm", "slstm"):
            blk = lm._rep(params["blocks"][unit.index(kind)], 0)
            want, _, wc = lm.block_fwd(lm.tree_map(lambda t: t.cpu(), blk),
                                       x, kind, cfg, pos, with_cache=True)
            got, _, gc = lm.block_fwd(blk, x.to(dev), kind, cfg,
                                      pos.to(dev), with_cache=True)
            errs = {"y": _rel_err(want, got)}
            for leaf, w in wc[kind].items():
                if w.is_floating_point():
                    errs[leaf] = _rel_err(w, gc[kind][leaf])
            out[kind] = errs
            if not max(errs.values()) <= XL_TOL:
                fail(f"xlstm-1.3b {kind} layer, card vs CPU in float32: "
                     f"{errs} (tol {XL_TOL} x max(1, |value|))")
    finally:
        L.COMPUTE_DTYPE = saved
    print(f"xlstm-1.3b small input ({b} x {s}), card vs CPU in float32, "
          f"error over max(1, |value|): {out} (tol {XL_TOL})")
    return out


def serve_xlstm(torch, dev, record, card):
    """Phase 12: xlstm-1.3b (42 mLSTM and 6 sLSTM layers, no attention)
    at full width and depth: the small input card against CPU
    (:func:`check_xlstm_layers`), then ``Engine.generate`` at 4 x 256
    prompt tokens (one mLSTM chunk), 32 new, draft 4
    (:func:`_serve_counted`: no ``flash_attention`` launch), then phase
    6's gateway over the paged pool (no flash launch there either; the
    mLSTM and sLSTM states parked and restored).  Returns (generate
    counts, pool counts)."""
    from repro_torch.launch.serve import repeated_prompts

    cfg, params, init = _init_full(torch, dev, "xlstm-1.3b", 8)
    small = check_xlstm_layers(torch, cfg, params)
    dh = 2 * cfg.d_model // cfg.n_heads
    state_mb = cfg.n_heads * dh * dh * 4 / 1e6        # C, float32
    n_m = sum(k == "mlstm" for k in cfg.layer_kinds())
    print(f"xlstm-1.3b: an mLSTM state C is {state_mb:.1f} MB a row a "
          f"layer; a verify round of draft {XL_SPEC} holds it "
          f"{XL_SPEC + 1} times (live and {XL_SPEC} snapshots): "
          f"{XL_BATCH * n_m * (XL_SPEC + 1) * state_mb / 1e3:.1f} GB at "
          f"batch {XL_BATCH} over {n_m} layers")
    prompt = repeated_prompts(XL_BATCH, XL_PROMPT, cfg.vocab_size, 9,
                              device=dev)
    rec, counts, _ = _serve_counted(torch, dev, "xlstm-1.3b", cfg, params,
                                    {"tokens": prompt}, XL_NEW, XL_SPEC, 0,
                                    card)
    record["xlstm"] = {**init, **rec, "small_input": small,
                       "state_mb_row_layer": state_mb}
    pool_counts = serve_pool(torch, dev, cfg, params, record,
                             tag="xlstm_pool",
                             kernels=("fused_stream", "gather_rows",
                                      "scatter_rows"))
    if pool_counts["flash_attention"]:
        fail(f"the xlstm pool launched flash_attention: {pool_counts}")
    return counts, pool_counts


# ---------------------------------------------------------------------------
# phase 13: seamless-m4t-large-v2 at full width and depth
# ---------------------------------------------------------------------------

def check_seamless_small(torch, cfg, params):
    """Phase 13's small input, card against the port's CPU run of the same
    weights: 2 x 64 source frames under 2 x 16 prompt tokens.  The encoder
    output and the last prefill logits with both sides computing in
    float32, within 2e-2 x max(1, largest |value|) (phase 3's tolerance);
    in bf16, the served dtype, every encoder and decoder layer fed the
    CPU's input to it (a decoder layer's cross attention the CPU's encoder
    output), each token's hidden state within 2e-2 x max(1, its largest
    |value|), as phase 11, with the full-depth bf16 encoder output and
    logits reported beside them: through 24 layers each layer's one or two
    bf16 ulps carry to about the tolerance (2.016e-2 of the encoder
    output on an H100 80GB HBM3 at 700 W).  Returns a record."""
    from repro_torch.launch.serve import repeated_prompts
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    b, ts, s = ED_SMALL
    dev = params["emb"].device
    cpu_p = lm.tree_map(lambda t: t.cpu(), params)
    src = torch.randn((b, ts, cfg.d_model),
                      generator=torch.Generator().manual_seed(14))
    tokens = repeated_prompts(b, s, cfg.vocab_size, 15)
    v = cfg.vocab_size
    rec = {}
    for tag, dtype in (("", torch.float32), ("bf16_", torch.bfloat16)):
        saved = L.COMPUTE_DTYPE
        L.COMPUTE_DTYPE = dtype
        try:
            enc_w = lm._run_encoder(cpu_p, cfg, src, "cpu")
            enc_g = lm._run_encoder(params, cfg, src.to(dev), dev)
            lw, _ = lm.prefill(cpu_p, cfg, {"tokens": tokens,
                                            "src_embeds": src})
            lg, _ = lm.prefill(params, cfg, {"tokens": tokens.to(dev),
                                             "src_embeds": src.to(dev)})
        finally:
            L.COMPUTE_DTYPE = saved
        rec.update({
            f"{tag}encoder_err": _rel_err(enc_w, enc_g),
            f"{tag}logits_err": _rel_err(lw[..., :v], lg[..., :v]),
            f"{tag}argmax_equal": float(
                (lw[..., :v].float().argmax(-1) ==
                 lg[..., :v].float().argmax(-1).cpu()).float().mean())})
    pos_s = torch.arange(ts, dtype=torch.int32)[None].expand(b, ts)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    layers = [("encoder", r, cpu_p["encoder"]["blocks"],
               params["encoder"]["blocks"]) for r in range(cfg.n_enc_layers)]
    layers += [("decoder", r, cpu_p["blocks"][0], params["blocks"][0])
               for r in range(cfg.n_layers)]
    x = src.to(torch.bfloat16)
    errs = {"encoder": [], "decoder": []}
    for part, r, blk_cpu, blk_dev in layers:
        dec = part == "decoder"
        if dec and r == 0:
            x = lm._embed(cpu_p, cfg, tokens)
        p_ = pos if dec else pos_s
        want, _, _ = lm.block_fwd(lm._rep(blk_cpu, r), x, "attn", cfg, p_,
                                  causal=dec, enc_out=enc_w if dec else None)
        got, _, _ = lm.block_fwd(lm._rep(blk_dev, r), x.to(dev), "attn",
                                 cfg, p_.to(dev), causal=dec,
                                 enc_out=enc_w.to(dev) if dec else None)
        errs[part].append(_rel_err(want, got, per_token=True))
        x = want
    del cpu_p
    rec.update({f"{part}_layers_worst": max(e) for part, e in errs.items()})
    rec["first_layers"] = {part: e[:2] for part, e in errs.items()}
    print(f"seamless-m4t-large-v2 small input ({b} x {ts} frames, {b} x "
          f"{s} tokens), card vs CPU: float32 compute, encoder output "
          f"{rec['encoder_err']:.3e}, last logits {rec['logits_err']:.3e} "
          f"of max(1, |value|) (tol 2e-2), argmax equal "
          f"{rec['argmax_equal']:.3f}; bf16, each layer from the CPU's "
          f"input, worst token: encoder {rec['encoder_layers_worst']:.3e}, "
          f"decoder {rec['decoder_layers_worst']:.3e} (tol 2e-2); bf16 "
          f"through all layers (not gated): encoder output "
          f"{rec['bf16_encoder_err']:.3e}, last logits "
          f"{rec['bf16_logits_err']:.3e}, argmax equal "
          f"{rec['bf16_argmax_equal']:.3f}")
    bad = {k: rec[k] for k in ("encoder_err", "logits_err",
                               "encoder_layers_worst",
                               "decoder_layers_worst") if not rec[k] <= 2e-2}
    if bad:
        fail(f"seamless-m4t-large-v2 card vs CPU beyond 2e-2: {bad}")
    return rec


def serve_seamless(torch, dev, record, card):
    """Phase 13: seamless-m4t-large-v2 (24 encoder and 24 decoder layers,
    16 heads of dim 64, ReLU FFNs of 8,192, layer norm) at full width and
    depth: the small input card against CPU
    (:func:`check_seamless_small`), then ``Engine.generate`` with
    ``src_embeds`` of 4 x 1,024 seeded normal frames under 4 x 64 prompt
    tokens, 32 new, draft 4 (:func:`_serve_counted`: 72
    ``flash_attention`` launches a prefill, 24 bidirectional encoder, 24
    causal decoder and 24 cross, none a decode step).  Returns the
    generate counts."""
    from repro_torch.launch.serve import repeated_prompts

    cfg, params, init = _init_full(torch, dev, "seamless-m4t-large-v2", 10)
    small = check_seamless_small(torch, cfg, params)
    src = torch.randn((ED_BATCH, ED_SRC, cfg.d_model), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(11))
    prompt = repeated_prompts(ED_BATCH, ED_PROMPT, cfg.vocab_size, 12,
                              device=dev)
    flash = cfg.n_enc_layers + 2 * cfg.n_layers
    rec, counts, _ = _serve_counted(
        torch, dev, "seamless-m4t-large-v2", cfg, params,
        {"tokens": prompt, "src_embeds": src}, ED_NEW, ED_SPEC, flash, card)
    record["seamless"] = {**init, **rec, "source_frames": ED_SRC,
                          "flash_per_prefill": flash, "small_input": small}
    return counts


# ---------------------------------------------------------------------------
# phase 15: training on the card
# ---------------------------------------------------------------------------

def _max_rel(got, want) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    num = float((got.float() - want.float()).abs().max())
    den = float(want.float().abs().max())
    return num / den if den else num


def check_flash_grads(torch, dev, cases=TRAIN_GRAD_CASES):
    """Phase 15(a): ``ops.attention`` under autograd on the card goes
    through ``FlashAttentionFn`` (one forward launch a call) and its
    output and dq, dk, dv agree with the plain twin's (autograd of it)
    on the same inputs, within 2e-2 (bf16) or 1e-4 (float32) of each
    one's largest value, at the serving shapes and at one microbatch of
    (c)'s 4,096-token sequences (phase 18: ``cases``, a rank's share of
    it).  Returns a record."""
    from repro_torch.kernels import flash_attention as fa, ops

    out = []
    for name, b, h, kvh, sq, skv, d, causal, window, dt in cases:
        g = torch.Generator(device=dev).manual_seed(sq + d)
        dtype = getattr(torch, dt)
        # the main path's layout: (B, S, heads, D) viewed as (B, heads, S, D)
        q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype) \
            .transpose(1, 2).requires_grad_()
        k, v = (torch.randn((b, skv, kvh, d), generator=g, device=dev)
                .to(dtype).transpose(1, 2).requires_grad_()
                for _ in range(2))
        do = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
        n0 = fa.flash_attention.launches
        o = ops.attention(q, k, v, causal=causal, window=window)
        launches = fa.flash_attention.launches - n0
        if "FlashAttentionFn" not in type(o.grad_fn).__name__ \
                or launches != 1:
            fail(f"flash gradients {name}: ops.attention under grad ran "
                 f"{type(o.grad_fn).__name__} with {launches} launches")
        got = torch.autograd.grad(o, (q, k, v), do)
        plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        want = torch.autograd.grad(plain, (q, k, v), do)
        torch.cuda.synchronize()
        fwd_err = _max_rel(o.detach(), plain.detach())
        errs = [_max_rel(x, y) for x, y in zip(got, want)]
        tol = FLASH_GRAD_TOL[dt]
        print(f"flash_attention gradients {name} {dt} (B={b} H={h} KVH={kvh}"
              f" Sq={sq} Skv={skv} D={d} causal={causal} window={window}): "
              f"output err {fwd_err:.2e}, dq/dk/dv err {errs[0]:.2e}/"
              f"{errs[1]:.2e}/{errs[2]:.2e} of the largest value, tol {tol};"
              f" {launches} forward launch")
        if fwd_err > tol or any(e > tol for e in errs):
            fail(f"flash {name} {dt} disagrees with the plain twin: output "
                 f"{fwd_err}, gradients {errs}")
        out.append({"case": name, "dtype": dt, "errs": errs,
                    "fwd_err": fwd_err, "launches": launches})
    return out


def check_train_grads_small(torch, dev):
    """Phase 15(b): one train step's gradients (``loss_and_grads``, remat
    on) of granite-8b at full width cut to 2 layers, batch 2 x 128,
    float32 compute, card (the flash kernel and its plain backward)
    against CPU (autograd of the reference) from the same params and
    tokens: every leaf nonzero where the CPU's is and within 1e-3 of its
    largest value.  A detached attention leaves wq, wk, wv without
    gradient.  Returns a record."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L, lm
    from repro_torch.train._tree import leaves_with_path
    from repro_torch.train.train_step import loss_and_grads

    layers, b, s = TRAIN_SMALL
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=layers)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        290), dev)
    cpu_params = lm.tree_map(lambda t: t.cpu(), params)
    tokens = np.random.default_rng(291).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    saved = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        n0 = ops.launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = ops.launch_counts()["flash_attention"] - n0
        t0 = time.perf_counter()
        cpu_loss, _, cpu_grads = loss_and_grads(cpu_params, cfg,
                                                {"tokens": tokens})
        cpu_s = time.perf_counter() - t0
    finally:
        L.COMPUTE_DTYPE = saved
    worst, errs = ("", 0.0), {}
    for (path, g), (_, c) in zip(leaves_with_path(grads),
                                 leaves_with_path(cpu_grads)):
        err = _max_rel(g.cpu(), c)
        errs[path] = err
        if err > worst[1]:
            worst = (path, err)
        if float(c.abs().max()) > 0 and float(g.abs().max()) == 0:
            fail(f"train gradients: {path} is zero on the card and not on "
                 f"the CPU (a detached attention?)")
        if err > TRAIN_TOL:
            fail(f"train gradients: {path} {err:.2e} of its largest value "
                 f"from the CPU's (tol {TRAIN_TOL})")
    if launches != 2 * layers:
        fail(f"train gradients: {launches} flash launches, want "
             f"{2 * layers} (forward and remat recompute a layer)")
    qkv = {n: max(e for p, e in errs.items() if f"['{n}']" in p)
           for n in ("wq", "wk", "wv")}
    loss_err = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    print(f"train gradients, granite-8b x {layers} layers, {b} x {s} "
          f"tokens, float32 compute, card vs CPU: {len(errs)} leaves, worst "
          f"{worst[0]} {worst[1]:.2e}, wq/wk/wv {qkv['wq']:.2e}/"
          f"{qkv['wk']:.2e}/{qkv['wv']:.2e} of each leaf's largest value "
          f"(tol {TRAIN_TOL}); loss {float(loss):.6f} vs {float(cpu_loss):.6f}"
          f"; {launches} flash launches; card {card_s:.2f}s, CPU {cpu_s:.2f}s")
    return {"layers": layers, "batch": [b, s], "worst_leaf": worst[0],
            "worst_err": worst[1], "qkv_errs": qkv, "loss_rel_err": loss_err,
            "flash_launches": launches, "card_s": card_s, "cpu_s": cpu_s}


def _sync_sites(torch, fn, *args):
    """``fn(*args)`` under ``set_sync_debug_mode("warn")``: its result and
    one entry a host sync, the innermost frame of the port or of this
    script on the Python stack when it warned (file:line, function and
    source line).  Syncs inside the autograd engine's device thread are
    reported at the ``backward()`` call that waits for them."""
    import traceback

    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "repro_torch" in f.filename
                  or f.filename.endswith("chip_smoke.py")]
        f = frames[-1] if frames else traceback.extract_stack()[-2]
        sites.append(f"{Path(f.filename).name}:{f.lineno} {f.name}: "
                     f"{(f.line or '').strip()}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def _digest(torch, tree) -> list:
    """Per float32 leaf (a DTensor's block), two int64 sums of its bits,
    plain and weighted by position (mod 65521), on the device in chunks,
    then read back once: equal digests mean equal leaves, bit for bit,
    but for a collision."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.train._tree import leaves_with_path

    out, chunk = [], 1 << 26
    for _, x in leaves_with_path(tree):
        bits = sh.local(x).detach().reshape(-1).view(torch.int32)
        s = w = torch.zeros((), dtype=torch.int64, device=bits.device)
        for i in range(0, bits.numel(), chunk):
            c = bits[i:i + chunk].long()
            pos = torch.arange(i, i + c.numel(), device=c.device) % 65521
            s = s + c.sum()
            w = w + (c * (pos + 1)).sum()
        out.append(torch.stack([s, w]))
    return torch.stack(out).cpu().tolist()


def _ckpt_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def train_granite(torch, dev, record, card):
    """Phase 15 (a, b, then c): granite-8b at full width cut to 8 layers,
    train_4k's 4,096-token sequences, global batch 8 in 4 microbatches of
    2, remat on, bf16 compute.  Six steps through ``run_loop``, each
    timed on the host clock ending in a synchronize, with the launch
    counters set to 0 just before and read just after (64 flash launches
    a step, forward and remat recompute), host syncs of step 3 under
    ``set_sync_debug_mode("warn")``, step 5 under ``torch.profiler``, and
    an async checkpoint after step 3 (its copy and its write timed).  Then
    the state is dropped (the crash), ``resume_or_init`` restores the
    step-3 checkpoint into fresh tensors and three more steps run: the
    final params must equal the six-step run's bit for bit.  Returns the
    six-step run's launch counts."""
    import dataclasses
    import shutil

    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.launch.train import init_state
    from repro_torch.train import (OptConfig, checkpoint, data,
                                   fault_tolerance as ft, make_train_step)
    from repro_torch.train._tree import leaves_with_path

    t_phase = time.perf_counter()
    rec = {"flash_grads": check_flash_grads(torch, dev)}
    rec["grads_s"] = time.perf_counter() - t_phase
    rec["small"] = check_train_grads_small(torch, dev)
    rec["small_s"] = time.perf_counter() - t_phase - rec["grads_s"]
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("granite-8b"),
                              n_layers=TRAIN_LAYERS)
    seq = SHAPES["train_4k"].seq_len
    shape = ShapeConfig("train_4k", seq, TRAIN_BATCH, "train")
    opt_cfg = OptConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, opt_cfg, num_microbatches=TRAIN_MICRO,
                           remat=True, loss_chunk=1024)
    tokens = TRAIN_BATCH * seq

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    # six steps, an async checkpoint after the third
    half = TRAIN_STEPS // 2
    ckpt_dir = ROOT / "build" / "chip_smoke" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    fcfg = ft.FaultConfig(ckpt_dir=str(ckpt_dir), ckpt_every=half)
    no_ckpt = dataclasses.replace(fcfg, ckpt_every=0)
    t_run = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # earlier phases' tensors
    t0 = time.perf_counter()
    state = init_state(cfg, dev, seed=29)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in leaves_with_path(state["params"]))
    print(f"train: granite-8b x {TRAIN_LAYERS} layers, {n_params / 1e9:.3f}B"
          f" float32 params, init {time.perf_counter() - t0:.1f}s")
    pipe = data.make_pipeline(cfg, shape, seed=29)
    losses, step_ms, per_step, syncs, prof = [], [], [], [], {}

    def timed_step(state, batch):
        i = len(step_ms)
        c0 = ops.launch_counts()["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 2:
            (state, m), found = _sync_sites(torch, step_fn, state, batch)
            syncs.extend(found)
        elif i == TRAIN_PROFILED:
            out = []
            prof["busy_ms"], prof["top"] = profile_top(
                torch, lambda: out.append(step_fn(state, batch)))
            state, m = out[0]
        else:
            state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(ops.launch_counts()["flash_attention"] - c0)
        losses.append(float(m["loss"]))
        return state, m

    times = {}
    real_save = checkpoint.save

    def timed_save(*a, **kw):
        t = time.perf_counter()
        out = real_save(*a, **kw)
        times["save_copy_s"] = time.perf_counter() - t
        times["save_return"] = time.perf_counter()
        return out

    ops.reset_launch_counts()
    checkpoint.save = timed_save
    try:
        # run_loop waits for the write before it returns
        state, _ = ft.run_loop(fcfg, state, timed_step, pipe, 0, half)
    finally:
        checkpoint.save = real_save
    times["save_write_s"] = time.perf_counter() - times.pop("save_return")
    state, _ = ft.run_loop(no_ckpt, state, timed_step, pipe, half,
                           TRAIN_STEPS)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    nbytes = _ckpt_bytes(ckpt_dir)
    want = 2 * TRAIN_LAYERS * TRAIN_MICRO
    if any(n != want for n in per_step):
        fail(f"train: flash launches a step {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: losses not finite: {losses}")
    # the first step warms up, the profiled one runs slower
    steady = [t for i, t in enumerate(step_ms) if i and i != TRAIN_PROFILED]
    mean_ms = sum(steady) / len(steady)
    busy_ms, top = prof["busy_ms"], prof["top"]
    print(f"train: losses {losses}; step ms {[round(x, 1) for x in step_ms]}"
          f" (steps 2-{TRAIN_STEPS} but the profiled step {TRAIN_PROFILED + 1}"
          f": mean {mean_ms:.1f} ms, "
          f"{tokens / mean_ms * 1e3:.0f} tokens/s); {per_step} flash "
          f"launches a step; peak {peak / 2**30:.2f} GiB allocated "
          f"({(peak - base) / 2**30:.2f} above the earlier phases' "
          f"{base / 2**30:.2f}); "
          f"host syncs in step 3: {len(syncs)} {syncs}; {card}")
    print(f"train: step {TRAIN_PROFILED + 1} under torch.profiler: device "
          f"busy {busy_ms:.1f} ms of the {mean_ms:.1f} ms unprofiled step "
          f"(busy share {busy_ms / mean_ms:.3f}); top kernels {top}; {card}")
    rec["run_s"] = time.perf_counter() - t_run
    # the six-step run's params stay on the card (8.6 GB) for the compare
    ref = [p.detach() for _, p in leaves_with_path(state["params"])]
    del state
    torch.cuda.empty_cache()

    # the forward kernel and the plain backward at the training shape
    g = torch.Generator(device=dev).manual_seed(30)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    mb = TRAIN_BATCH // TRAIN_MICRO
    q, k, v, do = (torch.randn((mb, seq, n, d), generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2)
                   for n in (h, kvh, kvh, h))
    o = fa.flash_attention(q, k, v, causal=True)
    fwd_ms, fwd_src, _ = timed(lambda: fa.flash_attention(q, k, v,
                                                          causal=True), 10)
    bwd_ms, bwd_src, bwd_call = timed(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, do, causal=True), 3)
    # bounds from the causal pairs: the forward's two products are 4 * D
    # flops a pair, the backward's five 10 * D; bytes each input read once
    # and each output written once (bf16)
    pairs = mb * h * seq * (seq + 1) // 2
    qo = 2 * mb * h * seq * d
    kv = 2 * mb * kvh * seq * d
    fwd_bound = bound(2 * qo + 2 * kv, 4.0 * d * pairs)
    bwd_bound = bound(3 * qo + 2 * kv + qo + 2 * kv, 10.0 * d * pairs)
    del q, k, v, do, o
    per_step_attn = want // 2 * bwd_ms + want * fwd_ms
    print(f"train: flash forward at ({mb}, {h}/{kvh}, {seq}, {d}) bf16 "
          f"{fwd_ms:.3f} ms a call ({fwd_src}; bound {fwd_bound[0]:.4f} ms "
          f"by {fwd_bound[1]}), plain backward {bwd_ms:.2f} ms a call "
          f"({bwd_src}; {bwd_call:.2f} with host time; bound "
          f"{bwd_bound[0]:.4f} ms by {bwd_bound[1]}): {per_step_attn:.0f} ms"
          f" of attention a step ({want} forward, {want // 2} backward "
          f"calls), {per_step_attn / mean_ms:.3f} of the step; {card}")

    # the crash: the state is gone; resume from the step-3 checkpoint
    t_resume = time.perf_counter()
    t0 = time.perf_counter()
    state, extra, start = ft.resume_or_init(
        fcfg, lambda: init_state(cfg, dev, seed=29),
        like=init_state(cfg, "meta"), device=dev)
    torch.cuda.synchronize()
    times["restore_s"] = time.perf_counter() - t0
    if start != half:
        fail(f"train: resumed at step {start}, want {half}")
    pipe = data.make_pipeline(cfg, shape, seed=29)
    pipe.restore(extra["data"])
    resumed = []
    state, _ = ft.run_loop(
        no_ckpt, state, step_fn, pipe, start, TRAIN_STEPS,
        on_metrics=lambda s, m: resumed.append(float(m["loss"])))
    same = [torch.equal(p.detach(), r) for (_, p), r in
            zip(leaves_with_path(state["params"]), ref)]
    print(f"train: checkpoint of {nbytes / 1e9:.2f} GB after step {half}: "
          f"save {times['save_copy_s']:.1f}s copying to the host + "
          f"{times['save_write_s']:.1f}s writing (async), restore "
          f"{times['restore_s']:.1f}s (warm page "
          f"cache); resumed losses {resumed} vs the six-step run's "
          f"{losses[half:]}; params equal bit for bit: "
          f"{sum(same)}/{len(same)} leaves; {card}")
    if not all(same) or resumed != losses[half:]:
        fail("train: 3 steps + checkpoint + resume + 3 steps differ from 6 "
             "steps without the restart")
    rec["resume_s"] = time.perf_counter() - t_resume
    # the step-3 checkpoint, steps 4-6's losses and the params' digest stay
    # for phase 17, which removes the checkpoint
    rec["digest"] = _digest(torch, state["params"])
    rec["ckpt_dir"] = str(ckpt_dir)
    del state, ref
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"train: phase 15 took {rec['phase_s']:.1f}s: (a) "
          f"{rec['grads_s']:.1f}s, (b) {rec['small_s']:.1f}s, six steps "
          f"with the checkpoint {rec['run_s']:.1f}s, resume and three steps "
          f"{rec['resume_s']:.1f}s")
    rec.update({"layers": TRAIN_LAYERS, "seq": seq, "batch": TRAIN_BATCH,
                "microbatches": TRAIN_MICRO, "params": n_params,
                "losses": losses, "step_ms": step_ms, "mean_step_ms": mean_ms,
                "tokens_per_s": tokens / mean_ms * 1e3,
                "flash_per_step": per_step, "peak_bytes": peak,
                "base_bytes": base,
                "busy_ms": busy_ms, "busy_share": busy_ms / mean_ms,
                "top_kernels": top, "host_syncs": syncs,
                "flash_fwd_ms": fwd_ms, "flash_bwd_plain_ms": bwd_ms,
                "flash_fwd_bound": fwd_bound, "flash_bwd_bound": bwd_bound,
                "attention_share": per_step_attn / mean_ms,
                "ckpt_bytes": nbytes, **times, "resumed_losses": resumed,
                "card": card})
    record["train"] = rec
    return counts


# ---------------------------------------------------------------------------
# phase 7: the CPM operator surface and the allocator on the kernels
# ---------------------------------------------------------------------------

def _bits(torch, t):
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _nan_equal(torch, a, b):
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a.float()) & torch.isnan(b.float()))).all())


def _cpm_ops(arr_i, arr_f, keep):
    """The phase's op sequence on one int and one float device; returns
    the results by name."""
    return {"compare": arr_i.compare(2048, "lt"),
            "count": arr_i.count(2048, "lt"),
            "compare_float_datum": arr_i.compare(2047.5, "lt"),
            "compact": arr_i.compact(keep),
            "sum_int": arr_i.section_sum(),
            "sum_float": arr_f.section_sum(),
            "max_int": arr_i.global_limit("max"),
            "min_int": arr_i.global_limit("min"),
            "max_float": arr_f.global_limit("max"),
            "min_float": arr_f.global_limit("min")}


def _float_sums_ok(np, got, x_np, ul):
    """Per row: |got - float64 sum| <= SUM_TOL * sum|x| over the used
    lanes; returns (ok, worst error / tolerance)."""
    worst = 0.0
    for r in range(x_np.shape[0]):
        row = x_np[r, :ul[r]].astype(np.float64)
        tol = SUM_TOL * float(np.abs(row).sum())
        worst = max(worst, abs(float(got[r]) - float(row.sum())) / tol)
    return worst <= 1.0, worst


def check_cpm_surface(torch, np, dev):
    """Phase 7, part 1 (see the module docstring).  Returns the launch
    counts of the counted run and per-kernel check results."""
    from repro_torch.cpm import cpm_array
    from repro_torch.cpm.optable import optimal_section
    from repro_torch.cpm.semantics import limit_identity
    from repro_torch.kernels import cpm_kernels as ck
    from repro_torch.kernels import ops

    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    xi_np = rng.integers(0, 4096, (CPM_R, CPM_N)).astype(np.int32)
    xf_np = rng.standard_normal((CPM_R, CPM_N)).astype(np.float32)
    keep_np = rng.random((CPM_R, CPM_N)) < 0.5
    ul_np = (CPM_N - CPM_LEN_STEP * np.arange(CPM_R)).astype(np.int32)
    xi, xf, keep, ul = (torch.from_numpy(a).to(dev)
                        for a in (xi_np, xf_np, keep_np, ul_np))
    torch.cuda.synchronize()
    print(f"cpm: (R, N) = ({CPM_R}, {CPM_N}) int32 in [0, 4096) and "
          f"float32 normal rows, used_len {int(ul_np[-1])}..{CPM_N}, made "
          f"in {time.perf_counter() - t0:.1f}s")

    ops.reset_launch_counts()                    # the CPM path, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arr_i = cpm_array(xi, ul, backend="cuda")
    arr_f = cpm_array(xf, ul, backend="cuda")
    got = _cpm_ops(arr_i, arr_f, keep)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    want_launches = {"compare": 3, "compact": 1, "section_sum": 2,
                     "section_limit": 4}
    for name, n in want_launches.items():
        if counts[name] != n:
            fail(f"the CPM path launched {name} {counts[name]} times, want "
                 f"{n} ({counts})")
    print(f"cpm path through cpm_array(backend='cuda'): {path_s:.3f}s, "
          f"launches {counts}")

    # the kernels' inputs on that path, and their plain twins
    live = torch.arange(CPM_N, dtype=torch.int32, device=dev)[None] \
        < ul[:, None]
    sec = optimal_section(CPM_N)
    mi0 = torch.where(live, xi, 0)
    mf0 = torch.where(live, xf, 0.0)
    errs = {}

    def hold(name, ok, err=0.0, what=""):
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"{name} {what}: max_abs_err={err} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} {what} disagrees with its check")

    for key, datum in (("compare", 2048), ("compare_float_datum", 2047.5)):
        want = ck.compare_plain(xi, datum, "lt") & live
        hold("compare", torch.equal(got[key], want), 0.0,
             f"int32 rows < {datum} ({CPM_R} x {CPM_N}), bit for bit with "
             f"the twin")
    n_lt = int(sum(int((xi_np[r, :ul_np[r]] < 2048).sum())
                   for r in range(CPM_R)))
    hold("compare", int(got["count"]) == n_lt, 0.0,
         f"count {int(got['count'])} against NumPy {n_lt}")
    kp = keep & live
    want_c = ck.compact_plain(xi, kp, 0)
    hold("compact", torch.equal(got["compact"].data, want_c[0])
         and torch.equal(got["compact"].used_len, want_c[1]), 0.0,
         f"int32 rows, {float(kp.float().mean()):.3f} of lanes kept, bit "
         f"for bit with the twin")
    s_int = ck.section_sum_plain(mi0, sec)
    np_int = np.asarray([int(xi_np[r, :ul_np[r]].astype(np.int64).sum())
                         for r in range(CPM_R)], np.int64)
    np_int = ((np_int + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    hold("section_sum", torch.equal(got["sum_int"], s_int)
         and np.array_equal(got["sum_int"].cpu().numpy(), np_int), 0.0,
         "int32 rows, bit for bit with the twin and NumPy (wrapped int32)")
    ok_k, worst_k = _float_sums_ok(np, got["sum_float"].cpu(), xf_np, ul_np)
    ok_p, worst_p = _float_sums_ok(
        np, ck.section_sum_plain(mf0, sec).cpu(), xf_np, ul_np)
    err = float((got["sum_float"] - ck.section_sum_plain(mf0, sec))
                .abs().max())
    hold("section_sum", ok_k and ok_p, err,
         f"float32 rows, kernel and twin within {SUM_TOL} x sum|x| of "
         f"NumPy float64 (worst {worst_k:.3f} / {worst_p:.3f} of tol)")
    for mode in ("max", "min"):
        for kind, x in (("int", xi), ("float", xf)):
            m = torch.where(live, x, limit_identity(x.dtype, mode))
            want = ck.section_limit_plain(m, sec, mode)
            hold("section_limit", torch.equal(got[f"{mode}_{kind}"], want),
                 0.0, f"{mode} {kind} rows, bit for bit with the twin")

    # determinism: every kernel twice on the path's inputs
    for name, fn in (("compare", lambda: ck.compare(xi, 2048, "lt")),
                     ("compact", lambda: ck.compact(xi, kp, 0)[0]),
                     ("section_sum", lambda: ck.section_sum(mf0, sec)),
                     ("section_limit",
                      lambda: ck.section_limit(mf0, sec, "max"))):
        a, b = fn(), fn()
        hold(name, torch.equal(_bits(torch, a), _bits(torch, b)), 0.0,
             "run twice, bit-identical")

    # NaN and +-inf rows through global_limit
    xn = xf.clone()
    xn[3, 1000] = float("nan")
    xn[5, 17], xn[5, 99] = float("inf"), -float("inf")
    xn[7, :] = -float("inf")
    xn[9, int(ul_np[9]) + 5] = float("nan")      # past used_len: masked
    arr_n = cpm_array(xn, ul, backend="cuda")
    for mode in ("max", "min"):
        lim = arr_n.global_limit(mode)
        m = torch.where(live, xn, limit_identity(xn.dtype, mode))
        lib = (torch.amax if mode == "max" else torch.amin)(m, -1)
        ok = (_nan_equal(torch, lim, ck.section_limit_plain(m, sec, mode))
              and _nan_equal(torch, lim, lib) and bool(torch.isnan(lim[3]))
              and not bool(torch.isnan(lim[9])))
        hold("section_limit", ok, 0.0,
             f"{mode} over rows planted with NaN and +-inf (NaN wins, "
             f"masked NaN ignored)")

    # backend="auto": the same launches on these rows, none on 8 lanes
    ops.reset_launch_counts()
    _cpm_ops(cpm_array(xi, ul), cpm_array(xf, ul), keep)
    torch.cuda.synchronize()
    auto = ops.launch_counts()
    if auto != counts:
        fail(f"backend='auto' launched {auto}, backend='cuda' {counts}")
    small_i = torch.arange(8, dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    _cpm_ops(cpm_array(small_i, 6), cpm_array(small_i.float(), 6),
             small_i % 2 == 0)
    torch.cuda.synchronize()
    short = ops.launch_counts()
    if any(short.values()):
        fail(f"an 8-lane row under backend='auto' launched {short}")
    print(f"backend='auto': the same launches on {CPM_N}-lane rows, none "
          f"on an 8-lane row")
    return counts, errs, {"xi": xi, "mf0": mf0, "kp": kp, "sec": sec,
                          "path_s": path_s, "xf": xf, "ul": ul,
                          "live": live, "xi_np": xi_np, "xf_np": xf_np,
                          "ul_np": ul_np}


def check_allocator(torch, np, dev):
    """Phase 7, part 2: the allocator on the card against the oracle and
    the reference allocator on the CPU.  Returns (launch counts, record)."""
    from repro_torch.cpm.pool import OracleAllocator, SlotAllocator
    from repro_torch.kernels import ops

    span = ALLOC_PAGES // ALLOC_BANKS
    card = SlotAllocator(ALLOC_SLOTS, n_pages=ALLOC_PAGES, backend="cuda")
    cpu = SlotAllocator(ALLOC_SLOTS, n_pages=ALLOC_PAGES)
    orc = OracleAllocator(ALLOC_SLOTS, n_pages=ALLOC_PAGES)
    if not (card._state.is_cuda and card._tick.is_cuda
            and card._pstate.is_cuda):
        fail("SlotAllocator(backend='cuda') keeps its metadata off the card")
    rng = np.random.default_rng(17)
    held: list[int] = []
    card_s, queries, kinds = 0.0, 0, {}

    def ask(kind, *args):
        nonlocal card_s, queries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = getattr(card, kind)(*args)
        torch.cuda.synchronize()
        card_s += time.perf_counter() - t0
        queries += 1
        kinds[kind] = kinds.get(kind, 0) + 1
        b, c = getattr(cpu, kind)(*args), getattr(orc, kind)(*args)
        if not a == b == c:
            fail(f"allocator {kind}{args}: card {a}, CPU reference {b}, "
                 f"oracle {c}")
        return a

    ops.reset_launch_counts()                    # the allocator, counted
    for i in range(ALLOC_OPS):
        mv = int(rng.integers(0, 8))
        if mv in (0, 1) or not held:
            got = ask("alloc")
            if got is not None:
                held.append(got)
        elif mv == 2:
            slot, bank = held[i % len(held)], int(rng.integers(0,
                                                               ALLOC_BANKS))
            ask("alloc_pages", slot, int(rng.integers(1, 9)), bank * span,
                (bank + 1) * span)
        elif mv == 3:
            ask("touch", held[i % len(held)])
        elif mv == 4:
            ask("victim")
        elif mv == 5:
            ask("used_slots")
        elif mv == 6:
            slot = held.pop(i % len(held))
            ask("free", slot)
        else:
            bank = int(rng.integers(0, ALLOC_BANKS))
            ask("free_count")
            ask("page_free_count", bank * span, (bank + 1) * span)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name in ("compare", "section_limit", "compact"):
        if counts[name] <= 0:
            fail(f"the allocator on the card never launched {name}: "
                 f"{counts}")
    rec = {"slots": ALLOC_SLOTS, "pages": ALLOC_PAGES, "ops": ALLOC_OPS,
           "queries": queries, "by_kind": kinds,
           "mean_query_ms": card_s / queries * 1e3, "launches": counts,
           "held_at_end": len(held)}
    print(f"allocator SlotAllocator({ALLOC_SLOTS}, n_pages={ALLOC_PAGES}, "
          f"backend='cuda'): {queries} queries {kinds} all equal to the "
          f"oracle and the CPU reference; mean {rec['mean_query_ms']:.3f} ms "
          f"per synchronized query (host-bound: every answer is read); "
          f"launches {counts}")
    return counts, rec


def time_cpm_kernels(torch, dev, data, errs):
    """The four kernels at phase 7's shapes: device time, twin, bound and
    the one PyTorch call that computes the same function."""
    from repro_torch.kernels import cpm_kernels as ck

    xi, mf0, kp, sec = data["xi"], data["mf0"], data["kp"], data["sec"]
    # operands on the card, as the CPMArray path passes them
    d = torch.tensor([2048], dtype=torch.int32, device=dev)
    f0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    nel = xi.numel()
    kept = int(kp.sum())
    cases = (
        ("compare", "src/repro_torch/csrc/compare.cu", ":273",
         lambda: ck.compare(xi, d, "lt"),
         lambda: ck.compare_plain(xi, d, "lt"),
         lambda: torch.lt(xi, d), nel * 4 + nel, 20, 5),
        ("section_sum", "src/repro_torch/csrc/reduce.cu", ":230",
         lambda: ck.section_sum(mf0, sec),
         lambda: ck.section_sum_plain(mf0, sec),
         lambda: torch.sum(mf0, -1, dtype=torch.float32), nel * 4, 20, 5),
        ("section_limit", "src/repro_torch/csrc/reduce.cu", ":367",
         lambda: ck.section_limit(mf0, sec, "max"),
         lambda: ck.section_limit_plain(mf0, sec, "max"),
         lambda: torch.amax(mf0, -1), nel * 4, 20, 5),
        ("compact", "src/repro_torch/csrc/compact.cu", ":637",
         lambda: ck.compact(xi, kp, f0),
         lambda: ck.compact_plain(xi, kp, f0),
         None, nel + kept * 4 + nel * 4, 20, 2))
    out = []
    for name, src, line, fn, plain, lib, nbytes, iters, plain_iters in cases:
        ms, src_, call_ms = timed(fn, iters)
        # the device launches of one call (two for the reductions' split
        # pass, three for compact), each with its time
        launches = kernel_ms(fn, iters)
        print(f"{name}: device launches of one call (ms): {launches}")
        plain_ms, _, plain_call = timed(plain, plain_iters)
        lib_ms = timed(lib, iters)[0] if lib is not None else None
        bound_ms, by = bound(nbytes)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": f"src/repro/kernels/cpm_kernels.py{line}",
                    "launches": None, "max_abs_err": errs[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": lib_ms,
                    "ms_source": src_, "call_ms": call_ms,
                    "plain_call_ms": plain_call, "device_launches": launches,
                    "shape": [CPM_R, CPM_N], "kept_share": kept / nel})
    return out


# ---------------------------------------------------------------------------
# phase 8: the §6.3 histogram, §8 super ops and §7.7 sort on the kernels
# ---------------------------------------------------------------------------

def _sort_rows(np):
    """(64, 16,384) int32 rows over the whole int32 range, and float32
    normal rows with 16 subnormals planted in every row and a NaN in row
    5; per-row ``used_len = N - 129 r``."""
    rng = np.random.default_rng(8)
    si = rng.integers(-2 ** 31, 2 ** 31, (SORT_R, SORT_N)).astype(np.int32)
    sf = rng.standard_normal((SORT_R, SORT_N)).astype(np.float32)
    cols = rng.choice(SORT_N - SORT_LEN_STEP * SORT_R, (SORT_R, 16))
    np.put_along_axis(sf, cols, (rng.standard_normal((SORT_R, 16))
                                 * 1e-39).astype(np.float32), axis=1)
    sf[5, 100] = np.nan
    sul = (SORT_N - SORT_LEN_STEP * np.arange(SORT_R)).astype(np.int32)
    return si, sf, sul


def _cpm2_ops(arrs, needles, edges, steps):
    """Phase 8's op sequence (``steps``: the bounded sort's cycles);
    returns the results by name."""
    a_i, a_f, a_n, a_si, a_sf, a_q = arrs
    out = {f"find{m}": a_q.find_all(needles[m], FIND_MAX) for m in NEEDLES}
    out["ends_float"] = a_f.substring_match(needles["float"], where="end")
    out.update({f"hist{m}": a_i.histogram(edges[m]) for m in HIST_BINS})
    out["hist_frac"] = a_i.histogram(edges["frac"])
    out["hist_nan"] = a_n.histogram(edges["float"])
    out["ssum_int"], out["ssum_float"] = a_i.super_sum(), a_f.super_sum()
    for mode in ("max", "min"):
        for kind, a in (("int", a_i), ("float", a_f), ("nan", a_n)):
            out[f"s{mode}_{kind}"] = a.super_limit(mode)
    out["sort_int"], out["sort_float"] = a_si.sort(), a_sf.sort()
    out["sort_bounded_int"] = a_si.sort(steps)
    out["sort_bounded_float"] = a_sf.sort(steps)
    out["sort_long"] = a_i.sort(LONG_SORT_STEPS)
    return out


def check_cpm_ops2(torch, np, dev, data):
    """Phase 8 (see the module docstring).  Returns the launch counts of
    the counted run, per-kernel errors, and the inputs for timing."""
    from repro_torch.cpm import cpm_array
    from repro_torch.cpm.optable import optimal_section
    from repro_torch.cpm.semantics import limit_identity
    from repro_torch.kernels import cpm_kernels as ck
    from repro_torch.kernels import ops

    steps = optimal_section(SORT_N)              # the bounded sort's cycles
    xi, xf, ul, live = data["xi"], data["xf"], data["ul"], data["live"]
    xi_np, xf_np, ul_np = data["xi_np"], data["xf_np"], data["ul_np"]
    sec = data["sec"]
    t0 = time.perf_counter()
    xn = xf.clone()                          # NaN and +-inf rows
    xn[3, 1000] = float("nan")
    xn[5, 17], xn[5, 99] = float("inf"), -float("inf")
    xn[7, :] = -float("inf")
    xn[9, int(ul_np[9]) + 5] = float("nan")  # past used_len: masked
    si_np, sf_np, sul_np = _sort_rows(np)
    si, sf, sul = (torch.from_numpy(a).to(dev) for a in (si_np, sf_np,
                                                         sul_np))
    # four-symbol rows (phase 7's ints mod 4) with the 32-item needle
    # planted once a row; the 2- and 8-item needles occur by chance
    rng = np.random.default_rng(5)
    needles = {m: torch.from_numpy(rng.integers(0, 4, m).astype(np.int32))
               .to(dev) for m in NEEDLES}
    xq = xi & 3
    plant = 5000 + 7 * torch.arange(CPM_R, device=dev)
    xq[torch.arange(CPM_R, device=dev)[:, None],
       plant[:, None] + torch.arange(32, device=dev)] = needles[32]
    needles["float"] = xf[0, 1000:1008].clone()
    edges = {m: torch.from_numpy(np.linspace(0, 4096, m + 1).round()
                                 .astype(np.int32)).to(dev)
             for m in HIST_BINS}
    edges["frac"] = torch.from_numpy(np.linspace(-0.5, 4096.5, 65)
                                     .astype(np.float32)).to(dev)
    edges["float"] = torch.from_numpy(np.linspace(-4, 4, 65)
                                      .astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    print(f"cpm2: sort rows ({SORT_R}, {SORT_N}) int32 and float32 "
          f"(subnormals, a NaN row), used_len {int(sul_np[-1])}..{SORT_N}; "
          f"made in {time.perf_counter() - t0:.1f}s")

    def arrays(backend):
        return tuple(cpm_array(x, u, backend=backend) for x, u in
                     ((xi, ul), (xf, ul), (xn, ul), (si, sul), (sf, sul),
                      (xq, ul)))

    ops.reset_launch_counts()                    # the phase-8 path, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrs = arrays("cuda")
    got = _cpm2_ops(arrs, needles, edges, steps)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    want_launches = {"substring_match": 4, "histogram": 4, "super_sum": 2,
                     "super_limit": 6, "oddeven_sort": 5}
    for name, n in want_launches.items():
        if counts[name] != n:
            fail(f"the phase-8 path launched {name} {counts[name]} times, "
                 f"want {n} ({counts})")
    if any(counts[k] for k in ("compare", "compact", "section_sum",
                               "section_limit")):
        fail(f"the phase-8 path launched a phase-7 kernel: {counts}")
    print(f"cpm2 path through cpm_array(backend='cuda'): {path_s:.3f}s, "
          f"launches {counts}")

    errs = {}

    def hold(name, ok, err=0.0, what=""):
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"{name} {what}: max_abs_err={err} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} {what} disagrees with its check")

    # search: the kernel against its twin on the path's rows, find_all
    # against the reference backend on the card and two rows against
    # NumPy's windows
    ref_q = cpm_array(xq, ul, backend="reference")
    for m in NEEDLES:
        nee = needles[m]
        hold("substring_match", torch.equal(
            ck.substring_match(xq, nee), ck.substring_match_plain(xq, nee)),
            0.0, f"{m}-item needle on four-symbol int32 rows, bit for bit "
            f"with the twin")
        idx, valid = got[f"find{m}"]
        w_idx, w_valid = ref_q.find_all(nee, FIND_MAX)
        hold("substring_match", torch.equal(idx, w_idx)
             and torch.equal(valid, w_valid), 0.0,
             f"find_all of a {m}-item needle, equal to the reference backend")
        for r in (0, CPM_R - 1):
            row = xq[r, :ul_np[r]].cpu().numpy()
            hits = np.flatnonzero(
                (np.lib.stride_tricks.sliding_window_view(row, m)
                 == nee.cpu().numpy()).all(1))[:FIND_MAX]
            k = len(hits)
            if not (np.array_equal(idx[r, :k].cpu().numpy(), hits)
                    and int(valid[r].sum()) == k):
                fail(f"find_all of a {m}-item needle, row {r}, against "
                     f"NumPy ({k} matches)")
            if m == 32 and (k == 0 or hits[0] != 5000 + 7 * r):
                fail(f"the planted 32-item needle was not found in row {r}")
    ends = got["ends_float"]
    hold("substring_match", torch.equal(
        ends, ck.substring_match_plain(xf, needles["float"]).bool() & live)
        and bool(ends[0, 1007]), 0.0,
        "match-end flags of a float32 needle, equal to the twin's")
    n_found = {m: int(got[f"find{m}"][1].sum()) for m in NEEDLES}
    print(f"find_all: {n_found} matches reported over the {CPM_R} rows "
          f"(at most {FIND_MAX} a row)")

    # histogram: the kernel's inputs on the path (promoted, tail = top
    # edge) through the twin; two rows against NumPy's counts
    hist_in = {}
    for key, x, e in ((8, xi, edges[8]), (64, xi, edges[64]),
                      ("frac", xi, edges["frac"]),
                      ("nan", xn, edges["float"])):
        ct = torch.promote_types(x.dtype, e.dtype)
        xh = torch.where(live, x.to(ct), e.to(ct)[-1])
        hist_in[key] = (xh, e.to(ct))
        want = ck.histogram_plain(xh, e.to(ct), 1024)
        name = f"hist_{key}" if isinstance(key, str) else f"hist{key}"
        hold("histogram", torch.equal(got[name], want), 0.0,
             f"{key} edges on {x.dtype} rows, bit for bit with the twin")
        src = (xf_np if key == "nan" else xi_np)
        e_np = e.cpu().numpy().astype(np.float64)
        for r in (0, CPM_R - 1):
            row = src[r, :ul_np[r]].astype(np.float64)
            if key == "nan":
                row = xn[r, :ul_np[r]].cpu().numpy().astype(np.float64)
            cnt = np.diff([(row < e).sum() for e in e_np])
            if not np.array_equal(got[name][r].cpu().numpy(), cnt):
                fail(f"histogram {key} row {r} against NumPy")
    nan_row = xn[3, :ul_np[3]].cpu().numpy()
    if int(got["hist_nan"][3].sum()) != int(((nan_row >= -4) &
                                             (nan_row < 4)).sum()):
        fail("histogram counted a NaN lane")
    # the path's edges are ordered (the bin search); shuffled edges and a
    # NaN edge take the counts form, each against the twin
    perm = torch.randperm(65, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(8))
    e_nan = edges["float"].clone()
    e_nan[20] = float("nan")
    hist_in["shuffled"] = (hist_in[64][0], hist_in[64][1][perm])
    hist_in["nan_edge"] = (hist_in["nan"][0], e_nan)
    for key, form in ((8, "search"), (64, "search"), ("frac", "search"),
                      ("nan", "search"), ("shuffled", "counts"),
                      ("nan_edge", "counts")):
        xh, e = hist_in[key]
        if ck.histogram_path(e) != form:
            fail(f"histogram {key} edges would take the "
                 f"{ck.histogram_path(e)} form, want {form}")
        if key in ("shuffled", "nan_edge"):
            hold("histogram", torch.equal(ck.histogram(xh, e, 1024),
                                          ck.histogram_plain(xh, e, 1024)),
                 0.0, f"{key} edges (the counts form), bit for bit with "
                 f"the twin")

    # super ops: int sums = section_sum, limits = global_limit, bit for
    # bit; float sums within SUM_TOL x sum|x| of NumPy
    a_i, a_f, a_n = arrs[:3]
    mi0 = torch.where(live, xi, 0)
    mf0 = torch.where(live, xf, 0.0)
    ss_sec = a_i.section_sum()
    hold("super_sum", torch.equal(got["ssum_int"], ss_sec)
         and torch.equal(got["ssum_int"], ck.super_sum_plain(mi0, sec)),
         0.0, "int32 rows, bit for bit with section_sum and the twin")
    ok_k, worst_k = _float_sums_ok(np, got["ssum_float"].cpu(), xf_np, ul_np)
    ok_p, worst_p = _float_sums_ok(
        np, ck.super_sum_plain(mf0, sec).cpu(), xf_np, ul_np)
    err = float((got["ssum_float"] - ck.super_sum_plain(mf0, sec))
                .abs().max())
    hold("super_sum", ok_k and ok_p, err,
         f"float32 rows, kernel and twin within {SUM_TOL} x sum|x| of "
         f"NumPy float64 (worst {worst_k:.3f} / {worst_p:.3f} of tol)")
    for mode in ("max", "min"):
        for kind, a, x in (("int", a_i, xi), ("float", a_f, xf),
                           ("nan", a_n, xn)):
            m = torch.where(live, x, limit_identity(x.dtype, mode))
            twin = ck.super_limit_plain(m, sec, mode)
            k = got[f"s{mode}_{kind}"]
            ok = (_nan_equal(torch, k, twin)
                  and _nan_equal(torch, k, a.global_limit(mode)))
            if kind == "nan":
                ok = ok and bool(torch.isnan(k[3])) \
                    and not bool(torch.isnan(k[9]))
            else:
                ok = ok and torch.equal(_bits(torch, k), _bits(torch, twin))
            hold("super_limit", ok, 0.0,
                 f"{mode} {kind} rows, bit for bit with the twin and "
                 f"global_limit")

    # sorts: the kernel's inputs on the path (dead lanes = the dtype's
    # max) through the twin; full sorts against np.sort
    s_live = torch.arange(SORT_N, device=dev)[None] < sul[:, None]
    sort_in = {"int": torch.where(s_live, si, torch.iinfo(torch.int32).max),
               "float": torch.where(s_live, sf, float("inf")),
               "long": torch.where(live, xi, torch.iinfo(torch.int32).max)}
    t0 = time.perf_counter()
    for kind in ("int", "float"):
        x = sort_in[kind]
        full = ck.oddeven_sort(x)
        hold("oddeven_sort", torch.equal(_bits(torch, full), _bits(
            torch, ck.oddeven_sort_plain(x))), 0.0,
            f"full sort of ({SORT_R}, {SORT_N}) {kind} rows, bit for bit "
            f"with the twin")
        data_np = got[f"sort_{kind}"].data.cpu().numpy()
        src = si_np if kind == "int" else sf_np
        for r in range(SORT_R):
            u = int(sul_np[r])
            if np.isnan(src[r, :u]).any():
                continue
            want = np.sort(src[r, :u])
            if not (np.array_equal(data_np[r, :u].view(np.int32),
                                   want.view(np.int32))
                    and not data_np[r, u:].any()):
                fail(f"sorted {kind} row {r} differs from np.sort")
        hold("oddeven_sort", torch.equal(
            _bits(torch, got[f"sort_bounded_{kind}"].data),
            _bits(torch, torch.where(s_live, ck.oddeven_sort_plain(
                x, steps), 0).to(x.dtype))), 0.0,
            f"{steps} cycles on {kind} rows, cycle for cycle with the twin")
    tiny = sf_np[np.abs(sf_np) < 1.2e-38]
    print(f"np.sort held on every row without NaN, {tiny.size} subnormals "
          f"kept; the sort twins took {time.perf_counter() - t0:.1f}s")
    x = sort_in["long"]
    want = ck.oddeven_sort_plain(x, LONG_SORT_STEPS)
    hold("oddeven_sort", torch.equal(
        got["sort_long"].data, torch.where(live, want, 0)), 0.0,
        f"{LONG_SORT_STEPS} cycles on ({CPM_R}, {CPM_N}) int32 rows "
        f"(halo tiles), cycle for cycle with the twin")

    # the full sort of phase 7's (64, 2^20) rows on the bitonic route: its
    # twin is 2^20 cycles deep and is not run
    x = sort_in["long"]
    full_long = ck.oddeven_sort(x)
    hold("oddeven_sort", torch.equal(full_long, torch.sort(x, -1).values),
         0.0, f"full sort of ({CPM_R}, {CPM_N}) int32 rows, equal to "
         f"torch.sort(...).values")
    for r in (0, CPM_R // 2, CPM_R - 1):
        if not np.array_equal(full_long[r].cpu().numpy(),
                              np.sort(x[r].cpu().numpy())):
            fail(f"full sort of a ({CPM_R}, {CPM_N}) row {r} differs from "
                 f"np.sort")
    print(f"full sort of ({CPM_R}, {CPM_N}) int32 rows: np.sort held on "
          f"rows 0, {CPM_R // 2}, {CPM_R - 1}")
    del full_long

    # determinism: every kernel twice on the path's inputs
    for name, fn in (("substring_match",
                      lambda: ck.substring_match(xq, needles[8])),
                     ("histogram", lambda: ck.histogram(*hist_in[64], 1024)),
                     ("super_sum", lambda: ck.super_sum(mf0, sec)),
                     ("super_limit",
                      lambda: ck.super_limit(mf0, sec, "min")),
                     ("oddeven_sort", lambda: ck.oddeven_sort(
                         sort_in["float"])),
                     ("oddeven_sort", lambda: ck.oddeven_sort(
                         sort_in["long"], LONG_SORT_STEPS)),
                     ("oddeven_sort", lambda: ck.oddeven_sort(
                         sort_in["long"]))):
        a, b = fn(), fn()
        hold(name, torch.equal(_bits(torch, a), _bits(torch, b)), 0.0,
             "run twice, bit-identical")

    # backend="auto": the same launches on these rows, none on 8 lanes
    ops.reset_launch_counts()
    _cpm2_ops(arrays("auto"), needles, edges, steps)
    torch.cuda.synchronize()
    auto = ops.launch_counts()
    if auto != counts:
        fail(f"backend='auto' launched {auto}, backend='cuda' {counts}")
    small = torch.arange(8, dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    a8 = cpm_array(small, 6)
    a8.find_all(needles[2], 4), a8.histogram(edges[8])
    a8.super_sum(), a8.super_limit(), a8.sort()
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        fail(f"an 8-lane row under backend='auto' launched "
             f"{ops.launch_counts()}")
    print(f"backend='auto': the same launches on these rows, none on an "
          f"8-lane row")
    return counts, errs, {"xq": xq, "needles": needles,
                          "hist_in": hist_in, "mf0": mf0, "sec": sec,
                          "mfl": torch.where(live, xf, -float("inf")),
                          "sort_in": sort_in, "path_s": path_s,
                          "steps": steps}


def _bitonic_bound(r: int, n: int) -> float:
    """The bitonic network's own bound: R * P/2 * p(p+1)/2
    compare-exchanges of two operations each over rows padded to
    P = 2^p lanes, at the float32 rate."""
    from repro_torch.kernels import cpm_kernels as ck

    pad, tile, _, passes = ck.bitonic_plan(r, n)
    steps = sum(1 for _ in ck.bitonic_steps(passes, tile))
    return bound(0, 2.0 * r * (pad // 2) * steps, F32_OPS_PER_S)[0]


def _oddeven_cases(torch, ck, data, card) -> dict:
    """Each odd-even case of phase 8 on its own, held bit for bit against
    the twin: its plan, device time, device launches, the bound at the
    published peaks (the larger of the call's bytes and two operations an
    exchange of the rows that take the cycles, at the float32 rate) and
    the issue floor (ALU instructions a lane a cycle, OE_INT_ALU or
    OE_NAN_ALU, at 64 lanes a clock on 132 SMs at the highest SM clock).
    Beside the path's cases, 128 cycles of NaN-free float32 rows (every
    tile on the integer loop) and of the same rows with a NaN in the
    middle of every tile (every tile on the NaN loop)."""
    clock = sm_clock_hz()
    xs, xf = data["sort_in"]["int"], data["sort_in"]["float"]
    xl, steps = data["sort_in"]["long"], data["steps"]
    clean = torch.where(torch.isnan(xf), torch.zeros_like(xf), xf)
    tile = ck.oddeven_plan(SORT_R, SORT_N, steps).interior
    nan_tiles = clean.clone()
    nan_tiles[:, tile // 2::tile] = float("nan")
    cases = (("long_1024_int32", xl, LONG_SORT_STEPS, OE_INT_ALU),
             ("bounded_128_int32", xs, steps, OE_INT_ALU),
             ("bounded_128_float32", xf, steps, OE_INT_ALU),
             ("full_float32_nan_row", xf, None, OE_NAN_ALU),
             ("bounded_128_float32_no_nan", clean, steps, OE_INT_ALU),
             ("bounded_128_float32_nan_every_tile", nan_tiles, steps,
              OE_NAN_ALU))
    out = {}
    for name, x, st, alu in cases:
        r, n = x.shape
        cycles = n if st is None else st
        full = cycles >= n
        plan = ck.oddeven_plan(r, n, cycles, full=full, elem=x.element_size())

        def call(x=x, st=st):
            return ck.oddeven_sort(x, st)

        if not torch.equal(_bits(torch, call()),
                           _bits(torch, ck.oddeven_sort_plain(x, st))):
            fail(f"oddeven_sort, {name}, disagrees with its twin")
        ms, src, call_ms = timed(call, 3 if cycles >= 1024 else 20)
        rows = int(torch.isnan(x).any(-1).sum()) if full else r
        lane_cycles = rows * n * cycles
        bound_ms, bound_by = bound(2 * x.numel() * x.element_size(),
                                   lane_cycles, F32_OPS_PER_S)
        out[name] = {
            "shape": [r, n], "dtype": str(x.dtype), "steps": cycles,
            "plan": plan._asdict(), "ms": ms, "ms_source": src,
            "call_ms": call_ms, "cycle_rows": rows,
            "issue_floor_ms": lane_cycles * alu
            / (SMS * ALU_LANES_PER_CLOCK * clock) * 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by, "sm_clock_hz": clock,
            "device_launches": device_launches(call, 3)}
        print(f"oddeven_sort {name}: {out[name]}; {card}")
    # what the long rows' time is made of, under their own plan's tiles:
    # one pass of 0 cycles (the loads and stores alone) and one of a full
    # pass's cycles, whose difference gives the rate of a cycle against
    # the ALU's (every warp segment's lanes, its end threads' included)
    plan = ck.oddeven_plan(CPM_R, CPM_N, LONG_SORT_STEPS)
    real, t = ck.oddeven_plan, {}
    try:
        for cycles in (0, plan.per_pass):
            one = plan._replace(per_pass=cycles, passes=1)
            ck.oddeven_plan = lambda *a, one=one, **k: one
            t[cycles] = timed(lambda c=cycles: ck.oddeven_sort(xl, c), 3)[0]
    finally:
        ck.oddeven_plan = real
    seg = CPM_R * plan.tiles * plan.warps * 32 * ck.OE_K * plan.per_pass
    rate = seg / ((t[plan.per_pass] - t[0]) * 1e-3)
    out["long_1024_int32"]["pass_io_ms"] = t[0]
    out["long_1024_int32"]["pass_ms"] = t[plan.per_pass]
    out["long_1024_int32"]["cycle_alu_share"] = (
        rate * OE_INT_ALU / (SMS * ALU_LANES_PER_CLOCK * clock))
    print(f"oddeven_sort long rows, one pass of their tiles: 0 cycles "
          f"{t[0]:.4f} ms, {plan.per_pass} cycles {t[plan.per_pass]:.4f} "
          f"ms; a cycle at {out['long_1024_int32']['cycle_alu_share']:.3f}"
          f" of the ALU rate; {card}")
    return out


def time_cpm2_kernels(torch, dev, data, errs, card):
    """The five phase-8 kernels at their shapes: device time, twin, bound
    and the PyTorch call that computes the same function (``card``: the
    ``nvidia-smi`` name and power limit printed beside the times).  Each
    bound is the work the function needs: bytes for the search, the
    histogram (ordered edges place a lane in ceil(log2(M+2)) compares,
    the bin search its blocks take; the counts form's M+1 compares a
    lane, which shuffled edges take, are kept beside it as
    ``counts_form_bound_ms``) and the super ops;
    for the full sort the larger of its bytes and R * N * log2(N)
    comparisons, with the odd-even network's own R * N * N/2
    compare-exchanges beside it as ``network_bound_ms``."""
    from repro_torch.kernels import cpm_kernels as ck

    xh, e64 = data["hist_in"][64]
    xh8, e8 = data["hist_in"][8]
    mf0, mfl, sec = data["mf0"], data["mfl"], data["sec"]
    xs = data["sort_in"]["int"]
    xq, needles = data["xq"], data["needles"]
    nel = xh.numel()
    m = e64.numel() - 1
    offs = (torch.arange(CPM_R, device=dev) * (m + 2))[:, None]

    def hist_lib():     # searchsorted + bincount (two calls, and the add
        idx = torch.searchsorted(e64, xh, right=True)  # of row offsets)
        return torch.bincount((idx + offs).reshape(-1),
                              minlength=CPM_R * (m + 2))

    out = []
    cases = (
        ("substring_match", "src/repro_torch/csrc/substring_match.cu",
         ":540", lambda: ck.substring_match(xq, needles[8]),
         lambda: ck.substring_match_plain(xq, needles[8]), None,
         bound(xq.numel() * 4 + 8 * 4 + xq.numel()), 20, 2),
        ("histogram", "src/repro_torch/csrc/histogram.cu", ":315",
         lambda: ck.histogram(xh, e64, 1024),
         lambda: ck.histogram_plain(xh, e64, 1024), hist_lib,
         bound(nel * 4 + (m + 1) * 4 + CPM_R * m * 4), 20, 2),
        ("super_sum", "src/repro_torch/csrc/super_reduce.cu", ":456",
         lambda: ck.super_sum(mf0, sec),
         lambda: ck.super_sum_plain(mf0, sec),
         lambda: torch.sum(mf0, -1, dtype=torch.float32),
         bound(nel * 4 + CPM_R * 4), 20, 5),
        ("super_limit", "src/repro_torch/csrc/super_reduce.cu", ":466",
         lambda: ck.super_limit(mfl, sec, "max"),
         lambda: ck.super_limit_plain(mfl, sec, "max"),
         lambda: torch.amax(mfl, -1), bound(nel * 4 + CPM_R * 4), 20, 5),
        ("oddeven_sort", "src/repro_torch/csrc/oddeven_sort.cu", ":177",
         lambda: ck.oddeven_sort(xs), None,
         lambda: torch.sort(xs, -1).values,
         bound(2 * xs.numel() * 4,
               SORT_R * SORT_N * math.log2(SORT_N), F32_OPS_PER_S),
         5, 0))
    for name, src, line, fn, plain, lib, (bound_ms, by), iters, p_it in cases:
        ms, src_, call_ms = timed(fn, iters)
        launches = kernel_ms(fn, iters)
        print(f"{name}: device launches of one call (ms): {launches}; "
              f"{card}")
        if plain is not None:
            plain_ms, _, plain_call = timed(plain, p_it)
            plain_src = "profiler"
        else:          # the full sort's twin is N cycles of launches deep:
            plain_ms = plain_call = cuda_ms(       # one call, events
                lambda: ck.oddeven_sort_plain(xs), iters=1, warmup=0)
            plain_src = "events, one call"
        lib_ms = None if lib is None else timed(lib, iters)[0]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": f"src/repro/kernels/cpm_kernels.py{line}",
               "launches": None, "max_abs_err": errs[name],
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": by, "library_ms": lib_ms, "ms_source": src_,
               "call_ms": call_ms, "plain_call_ms": plain_call,
               "plain_source": plain_src, "device_launches": launches}
        if name == "substring_match":
            rec["shape"], rec["needle"] = [CPM_R, CPM_N], 8
            rec["library_call"] = None
            for k in (2, 32):
                rec[f"m{k}_ms"] = timed(lambda: ck.substring_match(
                    xq, needles[k]), iters)[0]
        elif name == "histogram":
            rec["shape"], rec["bins"] = [CPM_R, CPM_N], m
            rec["form"] = ck.histogram_path(e64)
            rec["counts_form_bound_ms"] = bound(
                0, 2.0 * nel * (m + 1), F32_OPS_PER_S)[0]
            rec["m8_ms"] = timed(lambda: ck.histogram(xh8, e8, 1024),
                                 iters)[0]
            rec["m8_form"] = ck.histogram_path(e8)
            rec["m8_bound_ms"] = bound(nel * 4 + 9 * 4 + CPM_R * 8 * 4)[0]
            # the same rows and edges in shuffled order: the counts form
            for k, e in ((64, e64), (8, e8)):
                g = torch.Generator(device=dev).manual_seed(k)
                es = e[torch.randperm(k + 1, device=dev, generator=g)]
                rec[f"m{k}_shuffled_form"] = ck.histogram_path(es)
                if not torch.equal(ck.histogram(xh, es, 1024),
                                   ck.histogram_plain(xh, es, 1024)):
                    fail(f"histogram, {k} shuffled edges, against its twin")
                rec[f"m{k}_shuffled_ms"] = timed(
                    lambda es=es: ck.histogram(xh, es, 1024), iters)[0]
            print(f"histogram: M = 64 {rec['ms']:.4f} ms ({rec['form']} "
                  f"form), M = 8 {rec['m8_ms']:.4f} ms ({rec['m8_form']}); "
                  f"shuffled edges: M = 64 {rec['m64_shuffled_ms']:.4f} ms "
                  f"({rec['m64_shuffled_form']}), M = 8 "
                  f"{rec['m8_shuffled_ms']:.4f} ms "
                  f"({rec['m8_shuffled_form']}); {card}")
        elif name == "oddeven_sort":
            steps = data["steps"]
            rec["shape"] = [SORT_R, SORT_N]
            rec["library_call"] = "torch.sort(...).values"
            # the bitonic network's own compare-exchanges (2 operations
            # each), and the odd-even network's that it replaces
            rec["network_bound_ms"] = _bitonic_bound(SORT_R, SORT_N)
            rec["oddeven_network_bound_ms"] = bound(
                0, 2.0 * SORT_R * SORT_N * -(-SORT_N // 2),
                F32_OPS_PER_S)[0]
            xl = data["sort_in"]["long"]
            rec["long_full"] = {
                "shape": [CPM_R, CPM_N],
                "ms": timed(lambda: ck.oddeven_sort(xl), 5)[0],
                "library_ms": timed(lambda: torch.sort(xl, -1).values,
                                    5)[0],
                "bound_ms": bound(2 * xl.numel() * 4,
                                  CPM_R * CPM_N * math.log2(CPM_N),
                                  F32_OPS_PER_S)[0],
                "network_bound_ms": _bitonic_bound(CPM_R, CPM_N),
                "device_launches": device_launches(
                    lambda: ck.oddeven_sort(xl), 2)}
            rec["oddeven_cases"] = _oddeven_cases(torch, ck, data, card)
            rec["bounded_plain_ms"] = cuda_ms(
                lambda: ck.oddeven_sort_plain(xs, steps), iters=1, warmup=0)
            rec["full_device_launches"] = device_launches(fn)
            print(f"oddeven_sort full (int32) device launches "
                  f"{rec['full_device_launches']}; long full "
                  f"{rec['long_full']}; {card}")
        else:
            rec["shape"] = [CPM_R, CPM_N]
        if name == "histogram":
            rec["library_call"] = ("torch.searchsorted + torch.bincount "
                                   "(two calls and a row-offset add)")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 9: instruction streams priced by cost — the moves, activate,
# template match and stencil on their kernels, the calibrated cost model,
# the commit scheduled by cost on the generate path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _twins(ck, names):
    """Run the named kernel wrappers' plain twins in their place (the
    backends call them through the module), so one op sequence gives the
    kernels' results and the twins' on the same inputs; twins count no
    launch."""
    saved = {n: getattr(ck, n) for n in names}
    try:
        for n in names:
            setattr(ck, n, getattr(ck, f"{n}_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(ck, n, fn)


def _stream_ops(arrs, templates):
    """Phase 9's op sequence on one int32, float32, bool and int8 device
    with a scalar ``used_len`` (so each op is one call); returns the
    results by name."""
    ai, af, ab, a8 = arrs
    q, h = ai.n // 4, ai.n // 2
    out = {"activate": (ai.activate(q, h, 4),)}
    for name, d in (("shift", ai.shift(q, h, 1)),
                    ("shift_fill", ai.shift(q, h, 1, fill=-1)),
                    ("shift_neg", ai.shift(q, h, -3)),
                    ("insert_int", ai.insert(q, [7, 8])),
                    ("insert_float", af.insert(q, [7.5, -8.0])),
                    ("delete_int", ai.delete(q, 2, fill=-1)),
                    ("delete_float", af.delete(q, 2, fill=-1)),
                    ("shift_bool", ab.shift(q, h, 5)),
                    ("shift_int8", a8.shift(q, h, -2, fill=-1))):
        out[name] = (d.data, d.used_len)
    for m, t in templates.items():
        out[f"template{m}"] = (ai.template_match(t),)
    taps = (1.0, 2.0, 1.0)
    out["stencil_float"] = (af.stencil(taps),)
    out["stencil_float_wrap"] = (af.stencil(taps, wrap=True),)
    out["stencil_int"] = (ai.stencil(taps),)
    out["stencil_int_wrap"] = (ai.stencil(taps, wrap=True),)
    out["stencil5"] = (af.stencil(STENCIL5),)
    return out


def check_streams(torch, np, dev, data):
    """Phase 9, part 1 (see the module docstring).  Returns the launch
    counts of the counted runs, per-kernel errors and timing inputs."""
    from repro_torch.cpm import CPMProgram, cpm_array
    from repro_torch.cpm.program import schedule
    from repro_torch.kernels import cpm_kernels as ck
    from repro_torch.kernels import ops

    xi, xf, ul = data["xi"], data["xf"], data["ul"]
    used = CPM_N - 7
    xb = (xi & 1) == 0
    x8 = ((xi % 251) - 125).to(torch.int8)
    templates = {m: xi[5, 1000:1000 + m].clone() for m in STREAM_TEMPLATES}

    def arrays(backend):
        return tuple(cpm_array(x, used, backend=backend)
                     for x in (xi, xf, xb, x8))

    torch.cuda.synchronize()
    ops.reset_launch_counts()                    # the phase-9 path, counted
    t0 = time.perf_counter()
    got = _stream_ops(arrays("cuda"), templates)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {name: 0 for name in counts}
    want.update({"activate": 1, "shift_range": 9,
                 "template_match": len(STREAM_TEMPLATES), "stencil": 5})
    if counts != want:
        fail(f"the phase-9 path launched {counts}, want {want}")
    print(f"streams path through cpm_array(backend='cuda'): {path_s:.3f}s, "
          f"launches {counts}")
    with _twins(ck, STREAM_KERNELS):
        twin = _stream_ops(arrays("cuda"), templates)
    ref = _stream_ops(arrays("reference"), templates)

    errs = {}

    def hold(name, ok, err=0.0, what=""):
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"{name} {what}: max_abs_err={err} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} {what} disagrees with its check")

    kernel_of = {"activate": "activate", "template": "template_match",
                 "stencil": "stencil"}
    for key, vals in got.items():
        name = next((k for p, k in kernel_of.items() if key.startswith(p)),
                    "shift_range")
        same_twin = all(torch.equal(_bits(torch, a), _bits(torch, b))
                        for a, b in zip(vals, twin[key]))
        if name == "stencil":
            # the reference stencil adds the same products in the same
            # order; held to 1e-5 relative where a fused lowering could
            # round otherwise (PERF.md §2)
            a, b = vals[0], ref[key][0]
            err = float((a - b).abs().max())
            ok_ref = err <= 1e-5 * max(1.0, float(b.abs().max()))
        else:
            err = 0.0
            ok_ref = all(torch.equal(_bits(torch, a), _bits(torch, b))
                         for a, b in zip(vals, ref[key]))
        hold(name, same_twin and ok_ref, err,
             f"{key}: bit for bit with the twin, "
             f"{'1e-5 relative' if name == 'stencil' else 'bit for bit'} "
             f"with the reference backend")
    for m in STREAM_TEMPLATES:                  # the template was cut here
        if float(got[f"template{m}"][0][5, 1000]) != 0.0:
            fail(f"template_match M={m}: no exact zero where the template "
                 f"was cut from the row")

    # per-row lengths through the executor: one launch over every row's
    # own bounds
    prog = (CPMProgram().append("insert", pos=CPM_N // 4, values=[7, 8])
            .append("delete", pos=CPM_N // 8, k=2, fill=-1))
    kinds = [g.kind for g in schedule(prog).groups]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = prog.run(cpm_array(xi, ul, backend="cuda"))[0]
    torch.cuda.synchronize()
    rows_s = time.perf_counter() - t0
    rows_counts = ops.launch_counts()
    # the group fuses on the long int32 rows: one fused_stream launch over
    # their tiles (the per-move shift_range launch over every row's own
    # bounds is pinned on int8 rows by the card tests)
    want = {name: 0 for name in rows_counts} | {"fused_stream": 1}
    if kinds != ["fused"] or rows_counts != want:
        fail(f"the per-row-length insert and delete ({kinds}, want "
             f"['fused']) launched {rows_counts}, want {want}")
    ref_out = prog.run(cpm_array(xi, ul, backend="reference"))[0]
    hold("fused_stream", torch.equal(out.data, ref_out.data)
         and torch.equal(out.used_len, ref_out.used_len), 0.0,
         f"insert and delete on per-row lengths through CPMProgram.run "
         f"({kinds}) over {CPM_R} rows, equal to the reference backend's "
         f"row replay")
    print(f"per-row-length insert + delete through CPMProgram.run: "
          f"{rows_s:.3f}s, launches "
          f"{ {k: v for k, v in rows_counts.items() if v} } ({kinds}, "
          f"{CPM_R} rows, per-row bounds)")
    return ({"streams": counts, "rows": rows_counts}, errs,
            {"templates": templates, "used": used, "path_s": path_s,
             "rows_s": rows_s})


def check_cost_model(torch, np, dev, data, card):
    """Phase 9, part 2: calibrate the cost model on the card into the
    build spill, and run its probe stream forced fused and forced eager on
    (64, 16,384) int32 rows, bit for bit, with the calibrated verdict."""
    from repro_torch.cpm import cpm_array, tuning
    from repro_torch.cpm.program import CostParams, costmodel, run_plan
    from repro_torch.cpm.program import schedule
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    params = costmodel.params_for(dev)
    calib_s = time.perf_counter() - t0
    if params.source != "calibrated":
        fail(f"the cost model did not calibrate on the card: {params}")
    if f"calib:{tuning.backend_key(dev)}" not in json.loads(
            Path(tuning.cache_path()).read_text()):
        fail("the calibration was not spilled")
    print(f"cost model calibrated in {calib_s:.2f}s: launch_s "
          f"{params.launch_s:.4e}, eager_byte_s {params.eager_byte_s:.4e}, "
          f"fused_launch_s {params.fused_launch_s:.4e}, fused_byte_s "
          f"{params.fused_byte_s:.4e}; {card}")
    rows = data["xi"][:, :PROBE_N].contiguous()
    dev64 = cpm_array(rows, PROBE_N, backend="cuda")
    prog = costmodel._probe_program(PROBE_N)
    plans = {
        "fused": schedule(prog, device=dev64, cost=CostParams(
            1e-5, 1e-12, 1e-6, 1e-12, source="override")),
        "eager": schedule(prog, device=dev64, cost=CostParams(
            1e-9, 1e-12, 1e-9, 2e-12, source="override"))}
    res, launches, times = {}, {}, {}
    for kind, plan in plans.items():
        if [g.kind for g in plan.groups] != [kind]:
            fail(f"forced {kind} plan: {plan.describe()}")
        ops.reset_launch_counts()
        res[kind] = run_plan(plan, dev64)
        torch.cuda.synchronize()
        launches[kind] = {k: v for k, v in ops.launch_counts().items() if v}
        times[kind] = tuning.time_call(lambda plan=plan: run_plan(plan,
                                                                  dev64))
    (fx, fo), (ex, eo) = res["fused"], res["eager"]
    same = torch.equal(fx.data, ex.data) and all(
        torch.equal(a, b) for a, b in zip(fo, eo) if a is not None)
    if not same:
        fail("the probe stream's eager plan differs from its fused plan")
    verdict = schedule(prog, device=dev64)
    d = verdict.groups[0].decision
    block_r = tuning.entries("blockr:")

    # the auto crossover: measured on the card, read back by cuda_min_n
    from repro_torch.cpm import backends as B
    t0 = time.perf_counter()
    xover = B.measure_crossover(dev)
    xover_s = time.perf_counter() - t0
    for op in B.XOVER_OPS:
        n = xover[op]
        if B.cuda_min_n(op, dev) != n:
            fail(f"cuda_min_n({op!r}) does not read the measured {n}")
        wide = data["xi"][:1]                    # rows up to 1,048,576
        if n < 1 << 30 and (
                B.auto_backend_name(wide[:, :n], op) != "cuda"
                or n > 1 and B.auto_backend_name(wide[:, :n - 1],
                                                 op) != "reference"):
            fail(f"backend='auto' for {op} does not switch at {n} lanes")
    print(f"auto crossover measured in {xover_s:.2f}s: {xover} lanes "
          f"(static {B.CUDA_MIN_N}); {card}")
    print(f"probe stream on ({CPM_R}, {PROBE_N}) int32 rows: fused "
          f"{times['fused'] * 1e6:.1f} us ({launches['fused']}), eager "
          f"{times['eager'] * 1e6:.1f} us ({launches['eager']}), bit for "
          f"bit; calibrated verdict {verdict.groups[0].kind} (fused "
          f"{d['fused_us']:.1f} us vs eager {d['eager_us']:.1f} us, "
          f"{d['params']}); tuned block_r {block_r}; {card}")
    return {"params": params.as_dict(), "calibrate_s": calib_s,
            "probe_shape": [CPM_R, PROBE_N],
            "probe_fused_us": times["fused"] * 1e6,
            "probe_eager_us": times["eager"] * 1e6,
            "probe_launches": launches, "probe_verdict": d,
            "block_r": block_r, "crossover": xover}


def _commit_verdict(torch, dev, batch, cap, spec):
    """The kind the cost model gives the engine's commit at its shape."""
    from repro_torch.serve import program_paths

    _, plan = program_paths.record_commit_program(
        *_commit_args(torch, dev, batch, cap, spec), backend="cuda")
    return plan.groups[0].kind, plan.groups[0].decision


def commit_launch_check(counts, kind, rounds, path):
    """The launches a commit verdict implies: one fused_stream a round
    and no shift_range (fused), or one shift_range a round (the eager
    insert over all rows' own bounds) and no fused_stream
    (eager); no other per-op CPM kernel."""
    want = ({"fused_stream": rounds, "shift_range": 0} if kind == "fused"
            else {"fused_stream": 0, "shift_range": rounds})
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"the {path} path's {kind} commit launched {got} over "
             f"{rounds} rounds, want {want}")
    others = [k for k in CPM_KERNELS + CPM2_KERNELS + STREAM_KERNELS
              if k != "shift_range" and counts[k]]
    if others:
        fail(f"the {path} path launched per-op CPM kernels {others}: "
             f"{counts}")


def _syncs_of(caught) -> list[str]:
    return [str(w.message) for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


@contextlib.contextmanager
def _syncs_inside(module, name, into):
    """Collect the host syncs made inside ``module.name`` calls into
    ``into`` (an enclosing collector then does not see them)."""
    inner = getattr(module, name)

    def watched(*a, **k):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                return inner(*a, **k)
            finally:
                into.extend(_syncs_of(caught))

    setattr(module, name, watched)
    try:
        yield
    finally:
        setattr(module, name, inner)


#: coefficients that force each commit verdict (source "override": the
#: model's prediction stands, nothing is measured): a fused launch ten
#: times cheaper than an eager one fuses even the one-launch commit; no
#: launch cost and a dearer fused byte slope never fuses
FORCE_FUSED = (1e-5, 1e-12, 1e-6, 1e-12)
FORCE_EAGER = (1e-9, 1e-12, 1e-9, 2e-12)


@contextlib.contextmanager
def _forced_cost(dev, coeffs):
    """The cost model's coefficients for ``dev`` set to ``coeffs`` (the
    tuning spill's ``calib:`` entry, which ``costmodel.params_for``
    reads), restored afterwards."""
    from repro_torch.cpm import tuning
    from repro_torch.cpm.program import CostParams

    key = f"calib:{tuning.backend_key(dev)}"
    saved = tuning.lookup(key)
    tuning.store(key, CostParams(*coeffs, source="override").as_dict())
    try:
        yield
    finally:
        tuning.store(key, saved)


def _generate_counted(torch, gen):
    """Phase 5's speculative path once, counted: (tokens, stats, launch
    counts, host syncs in commits / the prefill / the rounds, seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve import program_paths

    in_commit, in_prefill, rounds_syncs = [], [], []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _syncs_inside(program_paths, "commit_tokens", in_commit), \
            _syncs_inside(lm, "prefill", in_prefill), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            spec, stats = gen["engine"].generate(
                gen.get("batch") or {"tokens": gen["prompt"]}, gen["spec"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
            rounds_syncs.extend(_syncs_of(caught))
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    return (spec, stats, ops.launch_counts(),
            (in_commit, in_prefill, rounds_syncs), spec_s)


def _commit_args(torch, dev, batch, cap, spec):
    """A verify round's commit inputs at the generate path's shape."""
    z = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return (torch.zeros((batch, cap), dtype=torch.int32, device=dev),
            z + cap // 2,
            torch.zeros((batch, spec), dtype=torch.int32, device=dev),
            z + 1)


def check_generate_by_cost(torch, dev, gen, card):
    """Phase 9, part 3: phase 5's speculative path again, its commit now
    priced by the calibrated coefficients, then under coefficients that
    force each verdict; each run with the launches its verdict implies,
    tokens equal to the scan path's, no host sync in a commit and one a
    round outside the prefill.  The two forced runs, and one commit at
    the generate shape under each verdict, are timed here side by side."""
    from repro_torch.serve import program_paths

    runs, path_counts = {}, {}
    for name, coeffs in (("calibrated", None), ("fused", FORCE_FUSED),
                         ("eager", FORCE_EAGER)):
        with (_forced_cost(dev, coeffs) if coeffs
              else contextlib.nullcontext()):
            kind, decision = _commit_verdict(torch, dev, BATCH,
                                             PROMPT_LEN + MAX_NEW, SPEC)
            if coeffs and kind != name:
                fail(f"coefficients {coeffs} gave the commit {kind}, "
                     f"want {name}")
            spec, stats, counts, syncs, spec_s = _generate_counted(torch,
                                                                   gen)
            args = _commit_args(torch, dev, BATCH, PROMPT_LEN + MAX_NEW,
                                SPEC)
            commit_ms, commit_src, commit_call_ms = timed(
                lambda: program_paths.commit_tokens(*args, backend="cuda"),
                20)
        in_commit, in_prefill, rounds_syncs = syncs
        if not torch.equal(spec, gen["scan"]):
            fail(f"speculative tokens under the {name} commit ({kind}) "
                 f"differ from the scan tokens")
        commit_launch_check(counts, kind, stats["rounds"],
                            f"{name} generate")
        if in_commit:
            fail(f"a {name} commit synchronized with the host: "
                 f"{in_commit[:3]}")
        if len(rounds_syncs) != stats["rounds"]:
            fail(f"{len(rounds_syncs)} host syncs over {stats['rounds']} "
                 f"rounds outside the prefill ({name} commit), want one a "
                 f"round: {rounds_syncs[:3]}")
        print(f"generate, commit priced by the {name} coefficients: {kind} "
              f"(fused {decision['fused_us']:.1f} us vs eager "
              f"{decision['eager_us']:.1f} us, {decision['params']}); "
              f"{stats['rounds']} rounds in {spec_s:.3f}s, launches "
              f"fused_stream {counts['fused_stream']}, shift_range "
              f"{counts['shift_range']}; host syncs: {len(rounds_syncs)} in "
              f"the rounds (0 in commits), {len(in_prefill)} in the "
              f"prefill; tokens == scan; one commit at ({BATCH}, "
              f"{PROMPT_LEN + MAX_NEW}): {commit_ms:.4f} ms on the card "
              f"({commit_src}), {commit_call_ms:.4f} ms a call with host "
              f"time; {card}")
        runs[name] = {"verdict": kind, "decision": decision,
                      "rounds": stats["rounds"], "spec_s": spec_s,
                      "commit_ms": commit_ms, "commit_ms_source": commit_src,
                      "commit_call_ms": commit_call_ms,
                      "launches": {k: counts[k] for k in
                                   ("fused_stream", "shift_range")},
                      "host_syncs_rounds": len(rounds_syncs),
                      "host_syncs_prefill": len(in_prefill)}
        path_counts[name] = counts
    return path_counts, runs


def check_pool_by_cost(torch, dev, gen):
    """Phase 9, part 4: the pool's packed commit takes no decision after
    calibration: one gather_rows, fused_stream and scatter_rows per bank
    for a steady step."""
    from repro_torch.cpm.pool import scheduler as psched
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import repeated_prompts

    from repro_torch.serve import Engine

    base = gen["engine"]
    engine = Engine(base.cfg, base.params, max_len=POOL_MAX_LEN,
                    cpm_backend=base.cpm_backend)
    pool = engine.session_pool(slots=4, n_banks=1, chunk=2,
                               page_size=POOL["page_size"],
                               pages_per_bank=POOL["pages_per_bank"])
    for i in range(4):
        pool.submit(repeated_prompts(1, 64, engine.cfg.vocab_size, 60 + i,
                                     device=dev)[0], 12)
    pool.step()                                    # admission + a chunk
    plans = []
    inner = psched.schedule

    def watched(prog, *a, **k):
        plan = inner(prog, *a, **k)
        plans.append(plan)
        return plan

    psched.schedule = watched
    try:
        ops.reset_launch_counts()
        pool.step()
        torch.cuda.synchronize()
    finally:
        psched.schedule = inner
    counts = ops.launch_counts()
    want = {"gather_rows": 1, "fused_stream": 1, "scatter_rows": 1}
    if {k: counts[k] for k in want} != want or \
            [g.kind for p in plans for g in p.groups] != ["fused"] or \
            any(g.decision is not None for p in plans for g in p.groups):
        fail(f"the pool after calibration: launches {counts}, plans "
             f"{[p.describe() for p in plans]}")
    pool.drain()
    print("pool after calibration: one gather_rows, fused_stream and "
          "scatter_rows per bank for a steady step, no cost decision")
    return counts


def _stencil_conv(torch, F, x, taps):
    """The zero-padded stencil as one ``conv1d`` (odd tap counts; a
    correlation, so the taps go in reversed): a yardstick, timed only."""
    w = torch.tensor(taps, dtype=torch.float32,
                     device=x.device).flip(0)[None, None, :]
    return lambda: F.conv1d(x[:, None, :], w, padding=len(taps) // 2)[:, 0]


def time_stream_kernels(torch, dev, data, sdata, errs):
    """The four phase-9 kernels at its shapes: device time, twin, bound
    and the PyTorch call that computes the same function (``conv1d`` for
    the zero-padded stencil, timed only).  ``shift_range`` is also timed
    beside ``clone()`` plus one slice ``copy_`` over the same move, two
    calls and no library call; ``stencil`` also at 5 and 63 taps, each
    with its bound and its ``conv1d``."""
    import torch.nn.functional as F

    from repro_torch.kernels import cpm_kernels as ck

    xi, xf = data["xi"], data["xf"]
    nel = xi.numel()
    q, h = CPM_N // 4, CPM_N // 2
    p = torch.tensor([q, h, 4], dtype=torch.int32, device=dev)
    t64 = sdata["templates"][64]
    taps = torch.tensor((1.0, 2.0, 1.0), device=dev)
    conv_w = taps.flip(0)[None, None, :]

    def conv():          # zero-padded, taps reversed (a correlation)
        return F.conv1d(xf[:, None, :], conv_w, padding=1)[:, 0]

    cases = (
        # phase 9's call: bounds as Python ints, passed by value
        ("activate", ":89", lambda: ck.activate(CPM_N, q, h, 4, device=dev),
         lambda: ck.activate_plain(CPM_N, q, h, 4, device=dev),
         None, bound(CPM_N)),
        ("shift_range", ":133", lambda: ck.shift_range(xi, p[0], p[1], 1),
         lambda: ck.shift_range_plain(xi, p[0], p[1], 1), None,
         bound(2 * nel * 4 + 8)),
        ("template_match", ":496", lambda: ck.template_match(xi, t64),
         lambda: ck.template_match_plain(xi, t64), None,
         bound(nel * 4 + nel * 4 + 64 * 4, 3.0 * nel * 64, F32_OPS_PER_S)),
        ("stencil", ":585", lambda: ck.stencil(xf, (1.0, 2.0, 1.0), False),
         lambda: ck.stencil_plain(xf, (1.0, 2.0, 1.0), False), conv,
         bound(2 * nel * 4, 2.0 * nel * 3, F32_OPS_PER_S)))
    out = []
    for name, line, fn, plain, lib, (bound_ms, by) in cases:
        ms, src_, call_ms = timed(fn, 20)
        launches = kernel_ms(fn, 20)
        plain_ms, _, plain_call = timed(plain, 3)
        lib_ms = None if lib is None else timed(lib, 20)[0]
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{name}.cu",
               "replaces": f"src/repro/kernels/cpm_kernels.py{line}",
               "launches": None, "max_abs_err": errs[name],
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": by, "library_ms": lib_ms, "ms_source": src_,
               "call_ms": call_ms, "plain_call_ms": plain_call,
               "device_launches": launches,
               "shape": [CPM_N] if name == "activate" else [CPM_R, CPM_N]}
        if name == "activate":
            # bounds read on the device, as from an earlier kernel
            def tensor_bounds():
                return ck.activate(CPM_N, p[0], p[1], p[2])

            if not torch.equal(tensor_bounds(), fn()):
                fail("activate from device tensors disagrees with its "
                     "bounds by value")
            rec["tensor_bounds_ms"] = timed(tensor_bounds, 20)[0]
        if name == "shift_range":
            # per-row bounds: each row's own live end, as a batched
            # device's moves take them
            hi = data["ul"] - 1
            rec["per_row_ms"] = timed(lambda: ck.shift_range(xi, p[0], hi,
                                                             1), 20)[0]

            def two_calls():     # lanes [q, h] land on [q + 1, h + 1]
                out = xi.clone()
                out[:, q + 1:h + 2].copy_(xi[:, q:h + 1])
                return out

            if not torch.equal(two_calls(), fn()):
                fail("clone + copy_ does not compute shift_range's move")
            rec["two_calls"] = "clone() + one slice copy_ (two calls)"
            rec["two_calls_ms"] = timed(two_calls, 20)[0]
        if name == "template_match":
            # no multiply-add pairs in a SAD: two float32 instructions a
            # (lane, item), issued at half the 67e12/s operation peak
            rec["m"] = 64
            rec["issue_bound_ms"] = bound(0, 2.0 * nel * 64,
                                          F32_OPS_PER_S / 2)[0]
            for m in (4, 16):
                tm = sdata["templates"][m]
                rec[f"m{m}_ms"] = timed(lambda tm=tm: ck.template_match(
                    xi, tm), 20)[0]
                rec[f"m{m}_bound_ms"] = bound(2 * nel * 4 + m * 4,
                                              3.0 * nel * m,
                                              F32_OPS_PER_S)[0]
                rec[f"m{m}_op_bound_ms"] = bound(0, 3.0 * nel * m,
                                                 F32_OPS_PER_S)[0]
                rec[f"m{m}_issue_bound_ms"] = bound(0, 2.0 * nel * m,
                                                    F32_OPS_PER_S / 2)[0]
            print(f"template_match: M = 64 {rec['ms']:.4f} ms (bound "
                  f"{rec['bound_ms']:.4f} by {rec['bound_by']}, issue "
                  f"{rec['issue_bound_ms']:.4f}); M = 16 "
                  f"{rec['m16_ms']:.4f} (bytes {rec['m16_bound_ms']:.4f}, "
                  f"issue {rec['m16_issue_bound_ms']:.4f}); M = 4 "
                  f"{rec['m4_ms']:.4f} (bytes {rec['m4_bound_ms']:.4f}, "
                  f"issue {rec['m4_issue_bound_ms']:.4f})")
        if name == "stencil":
            rec["library_call"] = ("torch.nn.functional.conv1d, taps "
                                   "reversed, padding 1 (TF32 off)")
            rec["library_max_abs_err"] = float(
                (conv() - fn()).abs().max())
            for tag, w in (("taps5", STENCIL5), ("taps63", STENCIL63)):
                nz = sum(1 for v in w if v != 0.0)
                got = ck.stencil(xf, w, False)
                err = float((got - ck.stencil_plain(xf, w, False))
                            .abs().max())
                if err != 0.0:
                    fail(f"stencil {tag} disagrees with its twin: {err}")
                rec[f"{tag}_ms"] = timed(
                    lambda w=w: ck.stencil(xf, w, False), 20)[0]
                rec[f"{tag}_bound_ms"], rec[f"{tag}_bound_by"] = bound(
                    2 * nel * 4, 2.0 * nel * nz, F32_OPS_PER_S)
                rec[f"{tag}_library_ms"] = timed(
                    _stencil_conv(torch, F, xf, w), 20)[0]
                print(f"stencil {tag}: {rec[f'{tag}_ms']:.4f} ms, bound "
                      f"{rec[f'{tag}_bound_ms']:.4f} ms by "
                      f"{rec[f'{tag}_bound_by']}, conv1d "
                      f"{rec[f'{tag}_library_ms']:.4f} ms")
        if name == "shift_range":
            print(f"shift_range: {rec['ms']:.4f} ms, per-row bounds "
                  f"{rec['per_row_ms']:.4f} ms, clone + copy_ "
                  f"{rec['two_calls_ms']:.4f} ms (two calls)")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 16: the CPM layer on a mesh of processes
# ---------------------------------------------------------------------------

def _mesh_ops_agree(torch, np, name, got, cuda, ref, x_np, ul_np):
    """Phase 16 (a)'s rule: float sums within SUM_TOL x sum|x| of NumPy
    (as the kernels' and the reference's), everything else bit for bit
    with the cuda backend and the reference."""
    if name in ("section_sum", "super_sum") and got.dtype.is_floating_point:
        ok, worst = _float_sums_ok(np, got.cpu(), x_np, ul_np)
        return ok, float((got - cuda).abs().max()), f"worst {worst:.3f} tol"
    same = (torch.equal(_bits(torch, got), _bits(torch, cuda))
            and torch.equal(_bits(torch, got), _bits(torch, ref)))
    return same, 0.0, "bit for bit"


def check_mesh(torch, np, dev, data, record, card):
    """Phase 16 (see the module docstring).  Returns the launch counts of
    the mesh path (no CPM kernel)."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch.analysis import roofline
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.cpm import collectives as C, cpm_array, semantics
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    store = ROOT / "build" / "chip_smoke" / "mesh_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=60))
    rec = {"group": f"nccl, 1 rank, {dist.get_backend()}"}
    try:
        # (a) the mesh backend against the kernels and the reference
        xi, xf, ul = data["xi"], data["xf"], data["ul"]
        rows = (("int32", xi, data["xi_np"]), ("float32", xf, data["xf_np"]))
        ul_np = data["ul_np"]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = {(k, m, a): getattr(cpm_array(x, ul, backend="mesh"), m)(*a)
               for k, x, _ in rows for m, a in MESH_OPS}
        one = {(m, a): getattr(cpm_array(xi[1], ul[1], backend="mesh"),
                               m)(*a) for m, a in MESH_OPS}
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        if any(counts.values()):
            fail(f"the mesh path launched CPM kernels: {counts}")
        times = {}
        for kind, x, x_np in rows:
            for m, a in MESH_OPS:
                arrs = {b: cpm_array(x, ul, backend=b)
                        for b in ("mesh", "cuda", "reference")}
                want = {b: getattr(arrs[b], m)(*a) for b in arrs}
                ok, err, how = _mesh_ops_agree(
                    torch, np, m, got[(kind, m, a)], want["cuda"],
                    want["reference"], x_np, ul_np)
                tag = f"{m}({', '.join(map(repr, a))}) {kind}"
                if not ok:
                    fail(f"mesh {tag} disagrees with the cuda backend / the "
                         f"reference ({how}, max |err| {err})")
                mesh_ms, src_m, _ = timed(
                    lambda: getattr(arrs["mesh"], m)(*a), 10)
                cuda_ms_, src_c, _ = timed(
                    lambda: getattr(arrs["cuda"], m)(*a), 10)
                times[tag] = {"mesh_ms": mesh_ms, "cuda_ms": cuda_ms_,
                              "source": f"{src_m}/{src_c}", "check": how}
                print(f"mesh {tag} at ({CPM_R}, {CPM_N}): {mesh_ms:.4f} ms "
                      f"({src_m}) vs the cuda backend {cuda_ms_:.4f} ms "
                      f"({src_c}); {how}; {card}")
        for m, a in MESH_OPS:
            ref = getattr(cpm_array(xi[1], ul[1], backend="reference"), m)(*a)
            if not torch.equal(one[(m, a)], ref):
                fail(f"mesh {m} on one row disagrees with the reference")
        rec.update(shape=[CPM_R, CPM_N], path_s=path_s, times=times)
        print(f"mesh backend: {len(got) + len(one)} ops on ({CPM_R}, "
              f"{CPM_N}) rows and one row in {path_s:.3f}s, no CPM kernel "
              f"launched; every op held against the cuda backend and the "
              f"reference")

        # (b) the collectives at n = 1 on CUDA tensors
        mesh = make_host_mesh()
        g = torch.Generator(device=dev).manual_seed(16)
        xs = {"float32": torch.randn((64, 1024), generator=g, device=dev),
              "int32": torch.randint(-2 ** 30, 2 ** 30, (64, 1024),
                                     generator=g, device=dev,
                                     dtype=torch.int32)}
        calls = {
            "ring_shift": lambda v: C.ring_shift(v, "data", 1),
            "ring_allreduce": lambda v: C.ring_allreduce(v, "data"),
            "tree_allreduce": lambda v: C.tree_allreduce(v, "data"),
            "tree_allreduce_max": lambda v: C.tree_allreduce(
                v, "data", semantics.maximum),
            "tree_allreduce_min": lambda v: C.tree_allreduce(
                v, "data", semantics.minimum),
            "ring_reduce_scatter": lambda v: C.ring_reduce_scatter(
                v, "data", 1),
            "ring_allgather": lambda v: C.ring_allgather(v, "data", 1),
            **{f"hierarchical_psum_{md}": (lambda v, md=md:
                                           C.hierarchical_psum(
                                               v, "data", "model", md))
               for md in ("ring", "two_phase", "xla")},
            "grad_sync": lambda v: C.grad_sync(
                {"w": v, "b": [v[0], v[:, :3]]}, ("model", "data"))["b"][1],
            "psum": lambda v: C.psum(v, ("data", "model")),
            "pmax": lambda v: C.pmax(v, "data"),
        }
        with sh.use_sharding(sh.make_ctx(mesh)):
            for name, fn in calls.items():
                for kind, v in xs.items():
                    before = v.clone()
                    out = fn(v)
                    want = v[:, :3] if name == "grad_sync" else v
                    if not (torch.equal(_bits(torch, out), _bits(torch, want))
                            and torch.equal(v, before)
                            and out.data_ptr() != v.data_ptr()):
                        fail(f"{name} on {kind} over NCCL at n = 1 did not "
                             f"return its input unchanged in a new tensor")
        torch.cuda.synchronize()
        rec["collectives"] = sorted(calls)
        print(f"collectives over NCCL at n = 1 on CUDA tensors, float32 and "
              f"int32: {', '.join(calls)}: each returned its input in a new "
              f"tensor and left it unchanged")
    finally:
        dist.destroy_process_group()

    # (c) the roofline of phase 15's training step
    tr = record["train"]
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=tr["layers"])
    shape = ShapeConfig("train_4k", tr["seq"], tr["batch"], "train")
    flops = roofline.model_flops(cfg, shape)
    nbytes = ADAMW_BYTES_PER_PARAM * tr["params"]
    terms = roofline.roofline_terms(flops, nbytes, 0.0)
    step_s = tr["mean_step_ms"] / 1e3
    share = flops / (step_s * roofline.HW["peak_flops"])
    rec["roofline"] = {"model_flops": flops, "bytes": nbytes, **terms,
                       "step_s": step_s, "peak_share": share, "hw": roofline.HW}
    print(f"roofline of phase 15's step (granite-8b x {tr['layers']} layers, "
          f"{tr['batch']} x {tr['seq']} tokens, {tr['params'] / 1e9:.3f}B "
          f"params, one card): model_flops {flops:.4e} (6 N D), AdamW's "
          f"{nbytes / 1e9:.2f} GB; terms compute {terms['compute_s']:.4f} s,"
          f" memory {terms['memory_s']:.4f} s, collective "
          f"{terms['collective_s']:.4f} s: bound by {terms['bound']}, "
          f"{terms['step_s_lower_bound']:.4f} s at least; measured step "
          f"{step_s:.4f} s = {share:.3f} of the card's "
          f"{roofline.HW['peak_flops']:.3g} bf16 FLOP/s ({card})")
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["card"] = card
    print(f"mesh: phase 16 took {rec['phase_s']:.1f}s")
    record["mesh"] = rec
    return counts


# ---------------------------------------------------------------------------
# phase 17: ZeRO-3 data-parallel training on one NCCL rank
# ---------------------------------------------------------------------------

def _zero3_bytes(cfg, like, ctx, micro: int) -> dict:
    """The bytes each kind of collective carries over the data axes in one
    bf16 train step of ``micro`` microbatches with remat, by the partition
    rules (PERF.md §6): a leaf split over the data axes is all-gathered
    whole in bf16 at each use (twice a microbatch in the rematerialized
    layer unit, once for the embedding and the unembedding) and its
    gradient reduce-scattered once a microbatch (bf16; the embedding
    table's float32); a replicated leaf's float32 gradient all-reduced
    once a microbatch; the loss and its two metrics (float32) and the
    global norm's per-leaf sums all-reduced once a step.  A leaf split
    over the model axis moves its model block."""
    from repro_torch.distributed import sharding as sh

    gathered = scattered = reduced = leaves = 0
    m = sh.model_size(ctx)

    def walk(t, path):
        nonlocal gathered, scattered, reduced, leaves
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
            return
        if isinstance(t, (list, tuple)):
            for v in t:
                walk(v, path)
            return
        leaves += 1
        spec = sh.param_spec(path, tuple(t.shape), ctx)
        axes = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        split = any(a in ctx.data_axes for a in axes)
        n = t.numel() // (m if ctx.model_axis in axes else 1)
        top = path.split("/")[1]
        tied = top == "emb" and cfg.tie_embeddings
        if split:
            gathered += (1 + (top == "blocks" or tied)) * 2 * n
            scattered += (4 if top == "emb" else 2) * n
            scattered += 2 * n if tied else 0
        else:
            reduced += 4 * n

    walk(like, "")
    return {"all_gather": micro * gathered,
            "reduce_scatter": micro * scattered,
            "all_reduce": micro * reduced + 3 * 4 + 4 * leaves}


def _model_bytes(cfg, like, m: int, rows: int, seq: int, micro: int,
                 dtype: str = "bfloat16") -> dict:
    """The bytes the model axis's collectives carry in one train step of a
    dense attention model whose rematerialized units are one layer each
    (granite-8b), by kind and element type (PERF.md §6): ``rows``
    sequences of ``seq`` tokens a rank and microbatch, T = rows seq, T' =
    rows (seq - 1), L layers, c bytes a compute element.  A microbatch
    all-reduces each layer's two row-parallel outputs (T d c each; again
    in the recompute but for the FFN's, which no saved tensor needs) and
    the gradients entering them, the embedding's rows, the loss's input
    gradient (T' d c) and three float32 numbers a position; it
    all-gathers the final norm's float32 scale and, where the axis does
    not divide the KV heads, ``wk`` and ``wv`` (twice), reduce-scattering
    their gradients once.  A step all-reduces the global norm's float32
    sums, one a leaf."""
    from repro_torch.train._tree import leaves_with_path

    c = {"bfloat16": 2, "float32": 4}[dtype]
    d, n = cfg.d_model, cfg.n_layers
    t, t1 = rows * seq, rows * (seq - 1)
    leaves = len(leaves_with_path(like))
    act = micro * (5 * n * t * d + t * d + t1 * d) * c
    f32 = micro * 3 * t1 * 4 + 4 * leaves
    out = {"all_reduce:model": ({dtype: act, "float32": f32}
                                if dtype != "float32"
                                else {"float32": act + f32}),
           "all_gather:model": {"float32": micro * 4 * d}}
    if cfg.n_kv_heads % m:
        kv = 2 * d * cfg.n_kv_heads * cfg.dh * c
        ag = out["all_gather:model"]
        ag[dtype] = ag.get(dtype, 0) + micro * n * 2 * kv
        out["reduce_scatter:model"] = {dtype: micro * n * kv}
    return out


def _resume_sharded(torch, dev, record, card, tag: str, phase: int,
                    **ctx_kw):
    """Phases 17 and 18 (see the module docstring): a group of one NCCL
    rank, ``make_host_mesh()``'s (1, 1) mesh under ``make_ctx(mesh,
    **ctx_kw)``, phase 15's step-3 checkpoint restored sharded, steps 4-6
    timed and checked against phase 15's, one more step profiled.
    Returns (the launch counts of the three steps, the record, the
    context's collective counts of the last step, the meta skeleton)."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch.analysis import roofline
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import init_state, state_shardings
    from repro_torch.train import (OptConfig, data, fault_tolerance as ft,
                                   make_train_step)
    from repro_torch.train._tree import leaves_with_path

    tr = record["train"]
    ckpt_dir = tr["ckpt_dir"]
    half = TRAIN_STEPS // 2
    store = ROOT / "build" / "chip_smoke" / f"{tag}_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=60))
    rec = {"group": f"nccl, 1 rank, {dist.get_backend()}"}
    try:
        mesh = make_host_mesh()
        ctx = sh.make_ctx(mesh, **ctx_kw)
        rec["ctx"] = {"data_axes": list(ctx.data_axes),
                      "model_axis": ctx.model_axis}
        cfg = dataclasses.replace(get_config("granite-8b"),
                                  n_layers=TRAIN_LAYERS)
        seq = SHAPES["train_4k"].seq_len
        shape = ShapeConfig("train_4k", seq, TRAIN_BATCH, "train")
        with sh.use_sharding(ctx):
            like = init_state(cfg, "meta")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            fcfg = ft.FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=0)
            state, extra, start = ft.resume_or_init(
                fcfg, lambda: fail(f"phase {phase}: no checkpoint of phase "
                                   f"15"),
                like=like, device=dev, shardings=state_shardings(like, ctx))
            torch.cuda.synchronize()
            rec["restore_s"] = time.perf_counter() - t0
            sharded = [sh.is_distributed(x) for t in (
                state["params"], state["opt"]["mu"], state["opt"]["nu"])
                for _, x in leaves_with_path(t)]
            if start != half or not all(sharded):
                fail(f"phase {phase}: resumed at step {start} (want {half})"
                     f" with {sum(sharded)}/{len(sharded)} leaves DTensors")
            pipe = data.make_pipeline(cfg, shape, seed=29,
                                      process_index=sh.dp_rank(ctx),
                                      process_count=sh.dp_size(ctx))
            pipe.restore(extra["data"])
            step = make_train_step(
                cfg, OptConfig(warmup_steps=2, total_steps=TRAIN_STEPS),
                num_microbatches=TRAIN_MICRO, remat=True, loss_chunk=1024)
            losses, step_ms, flash, colls, syncs = [], [], [], [], []
            ops.reset_launch_counts()
            for i in range(half, TRAIN_STEPS):
                batch = next(pipe)
                sh.reset_collective_counts()
                c0 = ops.launch_counts()["flash_attention"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == half + 1:
                    (p, o, m), found = _sync_sites(
                        torch, step, state["params"], state["opt"], batch)
                    syncs.extend(found)
                else:
                    p, o, m = step(state["params"], state["opt"], batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                colls.append(sh.collective_counts())
                flash.append(ops.launch_counts()["flash_attention"] - c0)
                state = {"params": p, "opt": o}
                losses.append(float(m["loss"]))
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            digest = _digest(torch, state["params"])
            # one more step (7, compared with nothing) under the profiler
            batch = next(pipe)
            events = _device_events(torch, lambda: step(
                state["params"], state["opt"], batch))
            busy_ms, top = _ms(events), _top(events)
            nccl = [e for e in events if "nccl" in e.key.lower()]
            nccl_ms = _ms(nccl)
            nccl_by = {}
            for e in nccl:
                nccl_by[e.key] = nccl_by.get(e.key, 0.0) + _ms([e])
        want = 2 * TRAIN_LAYERS * TRAIN_MICRO
        if any(n != want for n in flash):
            fail(f"phase {phase}: flash launches a step {flash}, want {want}")
        same_losses = losses == tr["resumed_losses"]
        differ = [path for (path, _), a, b in zip(
            leaves_with_path(state["params"]), digest, tr["digest"])
            if a != b]
        print(f"{tag}: granite-8b x {TRAIN_LAYERS} layers sharded on "
              f"{rec['group']} ({rec['ctx']}), restored from phase 15's "
              f"step-{half} checkpoint in {rec['restore_s']:.1f}s (each "
              f"leaf a DTensor); steps {half + 1}-{TRAIN_STEPS} losses "
              f"{losses} vs phase 15's {tr['resumed_losses']}: "
              f"{'equal' if same_losses else 'DIFFER'}; params "
              f"{len(digest) - len(differ)}/{len(digest)} leaves equal bit "
              f"for bit (digest); {card}")
        if not same_losses or differ:
            params = state["params"]
            del state, p, o, m
            torch.cuda.empty_cache()
            _hold_within_bounds(torch, dev, cfg, shape, ckpt_dir, params,
                                losses, tr["resumed_losses"], tag, phase)
        # the data axes' collectives of a step beside the partition rules'
        want_bytes = _zero3_bytes(cfg, like["params"], ctx, TRAIN_MICRO)
        got = {k: v["bytes"] for k, v in colls[-1].items()
               if ":" not in k}
        if got != want_bytes:
            fail(f"phase {phase}: collective bytes a step {got}, the formula"
                 f" gives {want_bytes}")
        stats = roofline.collective_stats(colls[-1])
        mean_ms = sum(step_ms[1:]) / len(step_ms[1:])
        flops = roofline.model_flops(cfg, ShapeConfig(
            "train_4k", seq, TRAIN_BATCH, "train"))
        terms = roofline.roofline_terms(flops, ADAMW_BYTES_PER_PARAM
                                        * tr["params"], stats.per_chip_bytes)
        share = flops / (mean_ms / 1e3 * roofline.HW["peak_flops"])
        print(f"{tag}: step ms {[round(x, 1) for x in step_ms]} (mean of "
              f"the last {len(step_ms) - 1}: {mean_ms:.1f}; phase 15's "
              f"{tr['mean_step_ms']:.1f}); {flash} flash launches a step; "
              f"peak {peak / 2**30:.2f} GiB allocated ({(peak - base) / 2**30:.2f}"
              f" above the earlier phases' {base / 2**30:.2f}; phase 15's "
              f"peak {tr['peak_bytes'] / 2**30:.2f}); host syncs in step "
              f"{half + 2}: {len(syncs)} {syncs} (phase 15's step 3: "
              f"{len(tr['host_syncs'])}); {card}")
        print(f"{tag}: collectives a step (NCCL, 1 rank) "
              + ", ".join(f"{k} {v['calls']} calls {v['bytes']} bytes "
                          f"{v['dtypes']}" for k, v in colls[-1].items())
              + f": the data axes' equal to the formula {want_bytes}; each "
              f"rank moves {stats.per_chip_bytes:.0f} bytes on a ring of 1 "
              f"(at N ranks (N - 1) / N of the gathers' and scatters' bytes,"
              f" 2 (N - 1) / N of the all-reduces'); roofline: compute "
              f"{terms['compute_s']:.4f} s, memory {terms['memory_s']:.4f} s,"
              f" collective {terms['collective_s']:.4f} s, bound by "
              f"{terms['bound']}; the measured step reaches {share:.3f} of "
              f"{roofline.HW['peak_flops']:.3g} bf16 FLOP/s ({card})")
        print(f"{tag}: step {TRAIN_STEPS + 1} under torch.profiler: device "
              f"busy {busy_ms:.1f} ms (share {busy_ms / mean_ms:.3f} of the "
              f"{mean_ms:.1f} ms step; phase 15's busy {tr['busy_ms']:.1f}),"
              f" NCCL kernels {nccl_ms:.1f} ms {nccl_by}; top kernels {top};"
              f" {card}")
        rec.update(busy_ms=busy_ms, nccl_ms=nccl_ms, nccl_by_kernel=nccl_by,
                   top_kernels=top)
        rec.update(losses=losses, step_ms=step_ms, mean_step_ms=mean_ms,
                   flash_per_step=flash, peak_bytes=peak, base_bytes=base,
                   host_syncs=syncs, collectives=colls[-1],
                   formula=want_bytes, roofline={**terms, "peak_share": share,
                                                 "model_flops": flops},
                   equal_losses=same_losses, differing_leaves=differ)
        del state
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return counts, rec, colls[-1], like


def train_sharded(torch, dev, record, card):
    """Phase 17 (see the module docstring).  Returns the launch counts of
    its three steps."""
    t_phase = time.perf_counter()
    counts, rec, _, _ = _resume_sharded(torch, dev, record, card, "fsdp",
                                        17, pure_dp=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["card"] = card
    print(f"fsdp: phase 17 took {rec['phase_s']:.1f}s")
    record["fsdp"] = rec
    return counts


def train_tensor_parallel(torch, dev, record, card):
    """Phase 18 (see the module docstring).  Returns the launch counts of
    its three steps."""
    import dataclasses
    import shutil

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    try:
        # (a) flash attention at a rank's shapes of a 4-way model axis
        flash = check_flash_grads(torch, dev, TP_FLASH_CASES)
        _, b, h, kvh, sq, skv, d, causal, window, dt = TP_FLASH_CASES[0]
        g = torch.Generator(device=dev).manual_seed(33)
        q = torch.randn((b, h, sq, d), generator=g, device=dev).to(
            getattr(torch, dt))
        k, v = (torch.randn((b, kvh, skv, d), generator=g, device=dev).to(
            q.dtype) for _ in range(2))
        fwd_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
        pairs = b * h * sq * (sq + 1) // 2
        # q, k, v read and the output written, bf16; 4 D flops a pair
        fwd_bound = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                          4 * d * pairs)
        del q, k, v
        print(f"tp: flash_attention forward at a rank's shape of a 4-way "
              f"model axis (B={b} H={h} KVH={kvh} S={sq} D={d}, causal, "
              f"{dt}): {fwd_ms:.4f} ms, bound {fwd_bound[0]:.4f} ms by "
              f"{fwd_bound[1]}; {card}")
        # (b) the model-parallel path on the (1, 1) mesh
        counts, rec, last, like = _resume_sharded(torch, dev, record, card,
                                                  "tp", 18)
    finally:
        shutil.rmtree(record["train"]["ckpt_dir"], ignore_errors=True)
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=TRAIN_LAYERS)
    rows = TRAIN_BATCH // TRAIN_MICRO
    want = _model_bytes(cfg, like["params"], 1, rows,
                        SHAPES["train_4k"].seq_len, TRAIN_MICRO)
    got = {k: v["dtypes"] for k, v in last.items() if k.endswith(":model")}
    print(f"tp: the model axis's collectives a step (m = 1, NCCL): "
          + ", ".join(f"{k} {v['calls']} calls {v['bytes']} bytes"
                      for k, v in last.items() if k.endswith(":model"))
          + f"; by dtype {got}, the formula {want}: "
          f"{'equal' if got == want else 'DIFFER'}")
    if got != want:
        fail(f"phase 18: model-axis bytes a step {got}, the formula gives "
             f"{want}")
    rec.update(model_formula=want, flash=flash, flash_fwd_ms=fwd_ms,
               flash_fwd_bound_ms=fwd_bound[0])
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["card"] = card
    print(f"tp: phase 18 took {rec['phase_s']:.1f}s")
    record["tp"] = rec
    return counts


def _check_serve_tp_flash(torch, dev, card) -> dict:
    """Phase 19 (a): flash at a rank's serving heads of a 4-way model axis
    against its plain twin, timed beside its bound."""
    from repro_torch.kernels import flash_attention as fa

    b, h, kvh, s, d = SERVE_TP_FLASH
    g = torch.Generator(device=dev).manual_seed(19)
    # (B, S, heads, D) projections viewed as (B, heads, S, D), as the
    # main path lays them out
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev)
               .transpose(1, 2).to(torch.bfloat16) for n in (h, kvh, kvh))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    tol = FLASH_TOL["bfloat16"]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    ms, src, _ = timed(lambda: fa.flash_attention(q, k, v, causal=True), 20)
    pairs = b * h * s * (s + 1) // 2
    # q, k, v read and the output written, bf16; 4 D flops a live pair
    bnd, by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                    4 * d * pairs)
    print(f"serve_tp: flash_attention at a rank's heads of a 4-way model "
          f"axis (B={b} H={h} KVH={kvh} S={s} D={d}, causal, bf16, "
          f"strided): max_abs_err={err:.3e} tol={tol} "
          f"{'ok' if ok else 'MISMATCH'}; {ms:.4f} ms ({src}), bound "
          f"{bnd:.5f} ms by {by}; {card}")
    if not ok:
        fail(f"phase 19: flash_attention at a rank's serving heads "
             f"disagrees with its plain twin (max abs err {err})")
    return {"flash_err": err, "flash_ms": ms, "flash_ms_source": src,
            "flash_bound_ms": bnd, "flash_bound_by": by}


def serve_tensor_parallel(torch, dev, record, card, gen, params,
                          pool_run):
    """Phase 19 (see the module docstring), then phase 20 on its group,
    context and weights (``pool_run``: phase 6's tokens and
    preemptions).  Returns the launch counts of phase 19's generate runs
    and of phase 20's gateway run, both under the model axis."""
    import datetime

    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.serve import Engine, GenConfig

    t_phase = time.perf_counter()
    rec = _check_serve_tp_flash(torch, dev, card)
    cfg = gen["engine"].cfg
    prompt, want = gen["prompt"], gen["scan"]
    max_len = gen["engine"].max_len
    store = ROOT / "build" / "chip_smoke" / "serve_tp_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=60))
    try:
        ctx = sh.make_ctx(make_host_mesh(), fsdp=False)
        rec.update(group=f"nccl, 1 rank, {dist.get_backend()}",
                   ctx={"data_axes": list(ctx.data_axes),
                        "model_axis": ctx.model_axis,
                        "model_size": sh.model_size(ctx), "fsdp": False})
        t0 = time.perf_counter()
        with sh.use_sharding(ctx):
            dparams = sh.distribute_params(params, ctx)
        torch.cuda.synchronize()
        rec["distribute_s"] = time.perf_counter() - t0
        engine = Engine(cfg, dparams, max_len=max_len, cpm_backend="cuda")
        scan_cfg = GenConfig(max_new_tokens=MAX_NEW)
        spec_cfg = GenConfig(max_new_tokens=MAX_NEW, ngram_spec=SPEC)
        with sh.use_sharding(ctx):
            ops.reset_launch_counts()              # the main path, counted
            scan, _ = engine.generate({"tokens": prompt}, scan_cfg)
            after_scan = ops.launch_counts()
            spec, stats = engine.generate({"tokens": prompt}, spec_cfg)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        equal = {"scan": torch.equal(scan, want),
                 "spec": torch.equal(spec, want)}
        print(f"serve_tp: granite-8b, {cfg.n_layers} layers, on "
              f"{rec['group']} under {rec['ctx']} (weights distributed in "
              f"{rec['distribute_s']:.1f}s, each leaf a DTensor): scan and "
              f"speculative tokens against phase 5's: {equal}; "
              f"{stats['rounds']} rounds, acceptance "
              f"{stats['acceptance_rate']:.3f}; {card}")
        if not all(equal.values()):
            fail(f"phase 19: tokens under the model axis differ from phase "
                 f"5's: {equal}")
        if after_scan["flash_attention"] < cfg.n_layers or \
                counts["flash_attention"] < 2 * cfg.n_layers:
            fail(f"phase 19: flash_attention launched "
                 f"{after_scan['flash_attention']} / "
                 f"{counts['flash_attention']} times for 2 prefills of "
                 f"{cfg.n_layers} layers")
        if after_scan["fused_stream"] or after_scan["shift_range"]:
            fail(f"phase 19: the scan path launched a commit kernel: "
                 f"{after_scan}")
        kind, _ = _commit_verdict(torch, dev, BATCH, PROMPT_LEN + MAX_NEW,
                                  SPEC)
        commit_launch_check(counts, kind, stats["rounds"], "serve_tp")

        # the plain path (phase 5's: no context, plain tensors) and the
        # model axis's, alternately, in this phase
        plain = gen["engine"]
        paths = {"plain": (plain, sh.ShardingCtx()), "model": (engine, ctx)}
        times = {k: {"prefill_ms": [], "scan_s": []} for k in paths}
        for _ in range(SERVE_TP_REPEATS):
            for name, (eng, c) in paths.items():
                with sh.use_sharding(c):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lm.prefill(eng.params, cfg, {"tokens": prompt},
                               max_len=max_len)
                    torch.cuda.synchronize()
                    times[name]["prefill_ms"].append(
                        (time.perf_counter() - t0) * 1e3)
                    t0 = time.perf_counter()
                    eng.generate({"tokens": prompt}, scan_cfg)
                    torch.cuda.synchronize()
                    times[name]["scan_s"].append(time.perf_counter() - t0)
        new = BATCH * MAX_NEW
        for name, t in times.items():
            t["prefill_ms_best"] = min(t["prefill_ms"])
            t["scan_tok_s_best"] = new / min(t["scan_s"])
        # each path's device busy time in a prefill and a decode step (the
        # rest of their host-clock time is the host's), the model axis's
        # collectives a decode step and the host time of one such call
        pos = torch.tensor(PROMPT_LEN, dtype=torch.int32, device=dev)
        for name, (eng, c) in paths.items():
            with sh.use_sharding(c):
                caches = lm.init_caches(cfg, BATCH, max_len, device=dev)
                times[name]["prefill_busy_ms"] = _ms(_device_events(
                    torch, lambda: lm.prefill(eng.params, cfg,
                                              {"tokens": prompt},
                                              max_len=max_len)))
                sh.reset_collective_counts()
                times[name]["decode_busy_ms"] = _ms(_device_events(
                    torch, lambda: lm.decode_step(
                        eng.params, cfg, prompt[:, :1], caches, pos,
                        max_len=max_len)))
                del caches
        step_colls = sh.collective_counts()
        small = torch.zeros((BATCH, 1, cfg.d_model), dtype=torch.bfloat16,
                            device=dev)
        with sh.use_sharding(ctx):
            sh.model_sum(small)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                sh.model_sum(small)
            torch.cuda.synchronize()
        rec["model_sum_call_us"] = (time.perf_counter() - t0) / 200 * 1e6
        rec.update(scan_equal=equal["scan"], spec_equal=equal["spec"],
                   rounds=stats["rounds"],
                   acceptance_rate=stats["acceptance_rate"],
                   launches=counts, launches_after_scan=after_scan,
                   commit_verdict=kind, times=times,
                   phase5={k: record["serve"][k] for k in (
                       "prefill_ms", "scan_tok_s", "spec_tok_s")},
                   decode_step_collectives={
                       k: {"calls": v["calls"], "bytes": v["bytes"]}
                       for k, v in step_colls.items() if v["calls"]})
        pt, mt = times["plain"], times["model"]
        print(f"serve_tp: prefill (B={BATCH} x {PROMPT_LEN}) best of "
              f"{SERVE_TP_REPEATS}: plain {pt['prefill_ms_best']:.1f} ms, "
              f"model axis {mt['prefill_ms_best']:.1f} ms "
              f"({mt['prefill_ms_best'] / pt['prefill_ms_best'] - 1:+.1%});"
              f" scan decode {MAX_NEW} new: plain "
              f"{pt['scan_tok_s_best']:.1f} tok/s, model axis "
              f"{mt['scan_tok_s_best']:.1f} tok/s "
              f"({mt['scan_tok_s_best'] / pt['scan_tok_s_best'] - 1:+.1%});"
              f" phase 5: prefill {record['serve']['prefill_ms']:.1f} ms, "
              f"scan {record['serve']['scan_tok_s']:.1f} tok/s; device busy"
              f" in a prefill {pt['prefill_busy_ms']:.1f} / "
              f"{mt['prefill_busy_ms']:.1f} ms and a decode step "
              f"{pt['decode_busy_ms']:.2f} / {mt['decode_busy_ms']:.2f} ms "
              f"(plain / model axis); the model axis's collectives a decode "
              f"step {rec['decode_step_collectives']}, "
              f"{rec['model_sum_call_us']:.1f} us of host time a call at "
              f"(4, 1, d); {card}")
        rec["phase_s"] = time.perf_counter() - t_phase
        del engine
        pool_counts = serve_pool_tensor_parallel(
            torch, dev, record, card, cfg, params, dparams, ctx, pool_run)
        del dparams
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    rec["card"] = card
    print(f"serve_tp: phase 19 took {rec['phase_s']:.1f}s")
    record["serve_tp"] = rec
    return counts, pool_counts


#: phase 20: timed steady steps a path, in turns, and the budget of the
#: sessions they run (enough for the steps: 64-token prompts, 4 a chunk)
TP_POOL_REPEATS, TP_POOL_BUDGET = 3, 64


def serve_pool_tensor_parallel(torch, dev, record, card, cfg, params,
                               dparams, ctx, pool_run):
    """Phase 20 (see the module docstring) on phase 19's group and
    context: phase 6's gateway traffic under the model axis, its steady
    step checked, then a steady ``pool.step()`` timed on both paths in
    turns.  Returns the gateway run's launch counts."""
    import numpy as np

    from repro_torch.distributed import sharding as sh
    from repro_torch.serve import Engine

    t_phase = time.perf_counter()
    rec = {"model": cfg.name, "layers": cfg.n_layers, **POOL,
           "max_len": POOL_MAX_LEN, "traffic": POOL_TRAFFIC}
    engine = Engine(cfg, dparams, max_len=POOL_MAX_LEN)
    with sh.use_sharding(ctx):
        gw = _pool_gateway(torch, engine)
        pool = gw.pool
        rids, _, t_run, counts = _pool_traffic(torch, dev, gw,
                                               cfg.vocab_size)
        st = gw.stats()
        got = [gw.request(rid).tokens for rid, _, _ in rids]
        equal = [np.array_equal(a, b) for a, b in zip(got,
                                                      pool_run["tokens"])]
        rec.update(requests=len(rids), run_s=t_run, launches=counts,
                   tokens_equal=sum(equal), preemptions=st["preemptions"],
                   phase6_preemptions=pool_run["preemptions"],
                   restores=st["restores"], page_stalls=st["page_stalls"],
                   prefill_launches=st["prefill_launches"],
                   kv_page_shape=list(pool.caches["blocks"][0]["attn"]["k"]
                                      .shape))
        print(f"serve_tp_pool: phase 6's {len(rids)} requests through "
              f"Gateway.tick under the model axis (m = "
              f"{sh.model_size(ctx)}, pool leaf {rec['kv_page_shape']}): "
              f"{sum(equal)}/{len(rids)} token streams equal phase 6's bit "
              f"for bit; preemptions {st['preemptions']} (phase 6: "
              f"{pool_run['preemptions']}), restores {st['restores']}, "
              f"page stalls {st['page_stalls']}, prefill launches "
              f"{st['prefill_launches']}; {t_run:.2f}s; launches {counts}; "
              f"{card}")
        if not all(equal) or len(equal) != len(pool_run["tokens"]):
            fail(f"phase 20: tokens under the model axis differ from phase "
                 f"6's: {equal}")
        if st["preemptions"] != pool_run["preemptions"]:
            fail(f"phase 20: {st['preemptions']} preemptions, phase 6 had "
                 f"{pool_run['preemptions']}")
        if counts["flash_attention"] < cfg.n_layers * st["prefill_launches"]:
            fail(f"phase 20: flash_attention launched "
                 f"{counts['flash_attention']} times for "
                 f"{st['prefill_launches']} prefills of {cfg.n_layers} "
                 f"layers")
        for name in POOL_KERNELS:
            if counts[name] <= 0:
                fail(f"phase 20: {name} was not launched ({counts})")
        if any(counts[name] for name in CPM_KERNELS + CPM2_KERNELS):
            fail(f"phase 20: the pool path launched a per-op CPM kernel: "
                 f"{counts}")
        _seat_steady(torch, dev, gw, cfg.vocab_size)
        _, steady, step_ms, event_ms = _steady_chunk(torch, pool, pool.step)
        while gw.loop.pending():
            gw.tick()
        if gw.stats()["pages_free"] != pool.total_pages:
            fail("phase 20: pages leaked after the drain")
        rec.update(steady_launches=steady, steady_step_ms=step_ms,
                   steady_step_device_ms=event_ms)
        print(f"serve_tp_pool: a steady step under the model axis "
              f"launched {steady}, no host sync in the chunk under "
              f"set_sync_debug_mode('error'); {step_ms:.1f} ms")
        del gw, pool

    # a steady pool.step() on the plain path (phase 6's: no context, plain
    # tensors) and on the model axis's, in turns
    plain = Engine(cfg, params, max_len=POOL_MAX_LEN)
    paths = {"plain": (plain, sh.ShardingCtx()), "model": (engine, ctx)}
    gws = {}
    for name, (eng, c) in paths.items():
        with sh.use_sharding(c):
            gws[name] = _pool_gateway(torch, eng)
            _seat_steady(torch, dev, gws[name], cfg.vocab_size,
                         TP_POOL_BUDGET)
    times = {k: {"step_ms": []} for k in paths}
    for _ in range(TP_POOL_REPEATS):
        for name, (_, c) in paths.items():
            with sh.use_sharding(c):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gws[name].pool.step()
                torch.cuda.synchronize()
                times[name]["step_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
    for name, (_, c) in paths.items():
        with sh.use_sharding(c):
            pool = gws[name].pool
            sh.reset_collective_counts()
            pool.step()
            torch.cuda.synchronize()
            colls = sh.collective_counts()
            busy_ms, top = profile_top(torch, pool.step)
            t = times[name]
            t.update(step_ms_best=min(t["step_ms"]), device_busy_ms=busy_ms,
                     idle_share=1.0 - busy_ms / min(t["step_ms"]),
                     top_kernels=top,
                     collectives={k: {"calls": v["calls"],
                                      "bytes": v["bytes"]}
                                  for k, v in colls.items() if v["calls"]})
            if pool.stats()["active"] != POOL["slots"]:
                fail(f"phase 20: the timed {name} steps were not steady: "
                     f"{pool.stats()}")
    del gws, plain, engine
    rec["times"] = times
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["card"] = card
    record["serve_tp_pool"] = rec
    pt, mt = times["plain"], times["model"]
    print(f"serve_tp_pool: steady pool.step() ({POOL['slots']} rows x chunk "
          f"{POOL['chunk']}) best of {TP_POOL_REPEATS} in turns: plain "
          f"{pt['step_ms_best']:.1f} ms, model axis {mt['step_ms_best']:.1f} "
          f"ms ({mt['step_ms_best'] / pt['step_ms_best'] - 1:+.1%}); device "
          f"busy {pt['device_busy_ms']:.1f} / {mt['device_busy_ms']:.1f} ms "
          f"(idle {pt['idle_share']:.3f} / {mt['idle_share']:.3f}); the "
          f"model axis's collectives a step {mt['collectives']}; {card}")
    print(f"serve_tp_pool: phase 20 took {rec['phase_s']:.1f}s")
    return counts


def _hold_within_bounds(torch, dev, cfg, shape, ckpt_dir, params, losses,
                        want_losses, tag, phase):
    """Phases 17 and 18 when their steps are not phase 15's bit for bit: the
    unsharded trainer runs the same steps from the same checkpoint, the
    first step and the leaves that differ are printed, and every leaf is
    held within 1e-3 of its largest value and every loss within 1e-3
    relative (phase 15(b)'s card-against-CPU bound)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.train import init_state
    from repro_torch.train import (OptConfig, data, fault_tolerance as ft,
                                   make_train_step)
    from repro_torch.train._tree import leaves_with_path

    half = TRAIN_STEPS // 2
    with sh.use_sharding(sh.ShardingCtx()):
        state, extra, _ = ft.resume_or_init(
            ft.FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=0),
            lambda: fail(f"phase {phase}: the checkpoint is gone"),
            like=init_state(cfg, "meta"), device=dev)
        pipe = data.make_pipeline(cfg, shape, seed=29)
        pipe.restore(extra["data"])
        step = make_train_step(
            cfg, OptConfig(warmup_steps=2, total_steps=TRAIN_STEPS),
            num_microbatches=TRAIN_MICRO, remat=True, loss_chunk=1024)
        for _ in range(half, TRAIN_STEPS):
            p, o, _ = step(state["params"], state["opt"], next(pipe))
            state = {"params": p, "opt": o}
    errs = {}
    for (path, a), (_, b) in zip(leaves_with_path(params),
                                 leaves_with_path(state["params"])):
        a = sh.local(a)
        if not torch.equal(a, b):
            errs[path] = float((a - b).abs().max() / b.abs().max())
    first = next((half + 1 + i for i, (a, b) in enumerate(
        zip(losses, want_losses)) if a != b), None)
    print(f"{tag}: NOT bit for bit: the first loss that differs is step "
          f"{first}'s ({losses} vs {want_losses}); leaves against the "
          f"unsharded trainer's, largest error over the largest value: "
          f"{errs}")
    bad_losses = [(a, b) for a, b in zip(losses, want_losses)
                  if abs(a - b) > TRAIN_TOL * abs(b)]
    bad = {k: v for k, v in errs.items() if v > TRAIN_TOL}
    if bad or bad_losses:
        fail(f"phase {phase}: beyond the bound {TRAIN_TOL}: leaves {bad}, "
             f"losses {bad_losses}")
    del state


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: the launch floor: an empty kernel behind a C entry point that takes the
#: stream, launched through ctypes as the package's kernels are
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def start_empty_kernel(build):
    """Start nvcc on EMPTY_KERNEL under ``build/chip_smoke`` with the
    package's flags (``build``: ``repro_torch.kernels._build``); returns
    what :func:`load_empty_kernel` waits for."""
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "empty.cu", out / "empty.so"
    src.write_text(EMPTY_KERNEL)
    cmd = [build.nvcc_path(), *build._COMMON, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load_empty_kernel(started):
    """Wait for :func:`start_empty_kernel`'s nvcc; returns a function that
    launches the empty kernel on a device's current stream."""
    import torch

    proc, lib = started
    log = proc.communicate()[0]
    if proc.returncode:
        fail(f"nvcc failed for the empty kernel:\n{log}")
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch(dev):
        if fn(torch.cuda.current_stream(dev).cuda_stream):
            fail("the empty kernel did not launch")

    return launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="on-card smoke of repro_torch")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut granite-8b's depth (0 = full, 36)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({card})")

    # the port's tuning spill under build/, fresh each run; phases 1-8 run
    # on the static defaults (the cost model's priors, untuned sections and
    # row blocks), phase 9 calibrates and tunes
    spill = ROOT / "build" / "chip_smoke" / "cpm_tuning.json"
    spill.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_CPM_TUNING_CACHE"] = str(spill)
    os.environ["REPRO_TORCH_CPM_AUTOTUNE"] = "0"
    os.environ["REPRO_TORCH_CPM_CALIBRATE"] = "0"

    t0 = time.perf_counter()
    empty_build = start_empty_kernel(_build)
    try:
        built = _build.build_all()
    finally:                    # no nvcc left running
        empty = load_empty_kernel(empty_build)
    print(f"built {built} and the empty kernel with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f}s")
    ptxas = ptxas_report(_build)
    for kern, info in ptxas.items():
        print(f"ptxas {kern}: {info}")
    sass = sass_counts(_build)
    print(f"sass oddeven_tiles opcodes by dtype: {sass}")

    full = get_config("granite-8b")
    record = {"card": card, "torch": torch.__version__, "ptxas": ptxas,
              "sass": sass,
              "config": {"n_heads": full.n_heads,
                         "n_kv_heads": full.n_kv_heads,
                         "head_dim": full.dh}}
    kernels = [check_flash(torch, dev, record),
               check_fused_stream(torch, np, dev, card, empty),
               *check_rows(torch, np, dev)]
    check_flash_d256(torch, dev, kernels[0])
    check_flash_encdec(torch, dev, kernels[0])
    check_small_model(torch, dev)
    gen_counts, cfg, params, gen = serve_granite(torch, dev, args.layers,
                                                record)
    pool_run = {}
    pool_counts = serve_pool(torch, dev, cfg, params, record, keep=pool_run)
    # phase 14: the HTTP/SSE wire over the same weights
    http_counts = serve_http(torch, dev, cfg, params, record, card)

    # phase 7
    cpm_counts, errs, data = check_cpm_surface(torch, np, dev)
    alloc_counts, record["allocator"] = check_allocator(torch, np, dev)
    record["cpm"] = {"shape": [CPM_R, CPM_N], "len_step": CPM_LEN_STEP,
                     "path_s": data["path_s"], "launches": cpm_counts}
    kernels += time_cpm_kernels(torch, dev, data, errs)
    if any(cpm_counts[name] for name in CPM2_KERNELS):
        fail(f"the phase-7 path launched a phase-8 kernel: {cpm_counts}")

    # phase 8
    cpm2_counts, errs2, data2 = check_cpm_ops2(torch, np, dev, data)
    record["cpm2"] = {"sort_shape": [SORT_R, SORT_N],
                      "path_s": data2["path_s"], "launches": cpm2_counts}
    kernels += time_cpm2_kernels(torch, dev, data2, errs2, card)
    del data2

    # phase 9
    s_counts, errs3, data3 = check_streams(torch, np, dev, data)
    os.environ["REPRO_TORCH_CPM_AUTOTUNE"] = "1"
    os.environ["REPRO_TORCH_CPM_CALIBRATE"] = "1"
    from repro_torch.cpm import tuning
    tuning.clear(in_process_only=False)
    record["cost_model"] = check_cost_model(torch, np, dev, data, card)
    by_cost, record["generate_by_cost"] = check_generate_by_cost(
        torch, dev, gen, card)
    pool2_counts = check_pool_by_cost(torch, dev, gen)
    # phases 19 and 20: serving under the model axis, on phase 5's weights
    tp_serve_counts, tp_pool_counts = serve_tensor_parallel(
        torch, dev, record, card, gen, params, pool_run)
    kernels[0].update(
        serve_tp_rank_ms=record["serve_tp"]["flash_ms"],
        serve_tp_rank_bound_ms=record["serve_tp"]["flash_bound_ms"],
        serve_tp_rank_err=record["serve_tp"]["flash_err"])
    del gen, params
    torch.cuda.empty_cache()

    # phases 10 and 11: the other decoder families, granite-8b's weights
    # freed first
    hyb_counts, hyb_pool_counts = serve_recurrentgemma(torch, dev, record,
                                                       card)
    torch.cuda.empty_cache()
    moe_counts = serve_moe(torch, dev, record, card)
    # phases 12 and 13: xLSTM and the encoder-decoder
    xl_counts, xl_pool_counts = serve_xlstm(torch, dev, record, card)
    torch.cuda.empty_cache()
    ed_counts = serve_seamless(torch, dev, record, card)
    torch.cuda.empty_cache()
    # phase 15: training, the serving weights freed
    train_counts = train_granite(torch, dev, record, card)
    kernels[0].update(train_fwd_ms=record["train"]["flash_fwd_ms"],
                      train_bwd_plain_ms=record["train"]["flash_bwd_plain_ms"])
    kernels += time_stream_kernels(torch, dev, data, data3, errs3)
    # phase 16: the CPM layer on a mesh of processes, on phase 7's rows
    mesh_counts = check_mesh(torch, np, dev, data, record, card)
    # phase 17: phase 15's steps 4-6 from its checkpoint, sharded
    fsdp_counts = train_sharded(torch, dev, record, card)
    # phase 18: the same steps on the model-parallel path
    tp_counts = train_tensor_parallel(torch, dev, record, card)
    kernels[0].update(tp_rank_fwd_ms=record["tp"]["flash_fwd_ms"],
                      tp_rank_fwd_bound_ms=record["tp"]["flash_fwd_bound_ms"])
    del data
    record["streams"] = {"shape": [CPM_R, CPM_N], "used_len": data3["used"],
                         "path_s": data3["path_s"],
                         "rows_s": data3["rows_s"], "launches": s_counts}
    paths = {"generate": gen_counts, "pool": pool_counts,
             "http_pool": http_counts, "cpm": cpm_counts,
             "allocator": alloc_counts, "cpm2": cpm2_counts,
             "streams": s_counts["streams"], "rows": s_counts["rows"],
             "generate_by_cost": by_cost["calibrated"],
             "generate_fused": by_cost["fused"],
             "generate_eager": by_cost["eager"],
             "pool_by_cost": pool2_counts,
             "hybrid_generate": hyb_counts, "hybrid_pool": hyb_pool_counts,
             "moe_generate": moe_counts, "xlstm_generate": xl_counts,
             "xlstm_pool": xl_pool_counts, "seamless_generate": ed_counts,
             "train": train_counts, "mesh": mesh_counts,
             "train_sharded": fsdp_counts, "train_tp": tp_counts,
             "serve_tp": tp_serve_counts, "serve_tp_pool": tp_pool_counts}
    for k in kernels:
        # each kernel's count on the newest path that runs it (the pool for
        # the serving kernels, phase 7, 8 or 9 for the per-op ones)
        name = k["name"]
        k["launches"] = (cpm_counts if name in CPM_KERNELS
                         else cpm2_counts if name in CPM2_KERNELS
                         else s_counts["streams"] if name in STREAM_KERNELS
                         else pool_counts)[name]
        k["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        print(f"{k['name']}: {k['ms']:.4f} ms on the card "
              f"({k['ms_source']}; {k['call_ms']:.4f} ms per call with "
              f"host time), plain {k['plain_ms']:.4f} ms "
              f"({k['plain_call_ms']:.4f} per call), bound "
              f"{k['bound_ms']:.6f} ms by {k['bound_by']}, library "
              f"{k['library_ms']} ms; {k['launches_by_path']} launches "
              f"on the main paths; {card}")
    ms = {k["name"]: k["ms"] for k in kernels}
    floor = next(k for k in kernels if k["name"] == "fused_stream")[
        "floor_ms"]
    record["launch_floor_ms"] = floor
    print(f"launch floor (an empty kernel) {floor:.4f} ms beside "
          + ", ".join(f"{k} {ms[k]:.4f}" for k in (
              "activate", "gather_rows", "scatter_rows", "fused_stream"))
          + f" ms of device time; {card}")
    record["kernels"] = kernels
    out_dir = ROOT / "artifacts"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
