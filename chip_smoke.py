#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # full-width, full-depth granite-8b
    python3 chip_smoke.py --layers 4      # cut depth (debugging)

Phases, in order; any failure exits non-zero:

  1. build every CUDA kernel of ``src/repro_torch/csrc`` (one nvcc each,
     all started together);
  2. hold each kernel against its plain PyTorch twin on the card, at the
     main paths' shapes, and time kernel, twin and the one PyTorch call
     that computes the same function where there is one
     (``scaled_dot_product_attention``; ``index_select`` for
     ``gather_rows``, ``index_copy_`` on a clone for ``scatter_rows``):
     device time from ``torch.profiler`` (CUDA events when it records
     none) and per-call time with events;
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
     tiles).  Each result against the kernel's twin (bit for bit; float
     sums within 1e-5 x sum|x| of NumPy), match addresses against the
     reference backend and NumPy, integer super sums against
     ``section_sum``, limits against ``global_limit``, full sorts against
     ``np.sort`` on rows without NaN; every kernel twice, bit for bit;
     ``backend="auto"`` the same launches, none on an 8-lane row.  The
     five kernels are timed at these shapes;
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
     (one ``shift_range`` launch each over all 64 rows, per-row bounds).
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
     (``conv1d`` beside the stencil).

The lines before the last are the card (``nvidia-smi`` name and power
limit) and one JSON object with every kernel's launches, error and
times; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repo's ``src/repro_torch`` beside it, it
prints no result and exits non-zero.  The full record is also written to
``artifacts/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
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
# phase 6: the paged pool behind the gateway
POOL = dict(slots=8, n_banks=2, chunk=4, page_size=32, pages_per_bank=24)
POOL_MAX_LEN = 384
#: (gateway tick, requests, prompt tokens, budget)
POOL_TRAFFIC = ((0, 4, 128, 32), (2, 4, 64, 8), (3, 4, 256, 8))
NEAR_TIE = 2e-2
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
# phase 9: the paper benchmark's T6 template lengths (benchmarks/run.py:151)
# on phase 7's rows, a five-tap stencil with zero taps, and the cost
# model's probe stream on rows of the allocator's longest length (two
# resident rows fit fused_stream)
STREAM_TEMPLATES = (4, 16, 64)
STENCIL5 = (0.5, 0.0, 1.0, 0.0, -0.25)
PROBE_N = 16384
STREAM_KERNELS = ("activate", "shift_range", "template_match", "stencil")


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


def kernel_ms(fn, iters: int = 20):
    """Mean device time per call of ``fn`` by kernel name, from
    ``torch.profiler`` (CUPTI): the CUDA kernels (and copies) it launches.
    Host gaps between launches are excluded, so a wrapper whose Python
    side is slower than its kernel is not charged for it.  The profiler
    was seen on the H100 to lose kernel records (14 to 19 of 20 in one
    window), so a first (warm-up) window of ``iters`` calls is discarded,
    and a window whose record count of some kernel is not a multiple of
    ``iters`` is measured again, up to three times.  None when the
    profiler records no device activity or no window was whole."""
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
        out[name] = (out.get(name, 0.0)
                     + ev.self_device_time_total / 1e3 / iters)
    return out


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
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:                        # the same inputs; enable_gqa needs >= 2.5
        lib_ms, _, _ = timed(lambda: sdpa(q, k, v, is_causal=True,
                                          enable_gqa=True), 20)
    except TypeError:           # older torch: kv repeated outside the timing
        kr, vr = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))
        lib_ms, _, _ = timed(lambda: sdpa(q, kr, vr, is_causal=True), 20)
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
            "call_ms": call_ms, "plain_call_ms": plain_call}


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


def check_fused_stream(torch, np, dev):
    from repro_torch.kernels import cpm_kernels as ck

    def on_dev(x, ul, instrs, ops):
        return (torch.from_numpy(x).to(dev), torch.from_numpy(ul).to(dev),
                instrs, tuple(torch.from_numpy(o).to(dev) for o in ops))

    # the commit stream at the main path's shapes: insert -> truncate
    r, n = BATCH, PROMPT_LEN + MAX_NEW
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 49152, (r, n)).astype(np.int32)
    used = rng.integers(PROMPT_LEN, n - SPEC, (r,)).astype(np.int32)
    preds = rng.integers(0, 49152, (r, SPEC)).astype(np.int32)
    emit = rng.integers(0, SPEC + 1, (r,)).astype(np.int32)
    commit = on_dev(buf, used, (("insert", (("k", SPEC),), 2),
                                ("truncate", (), 1)),
                    [used[:, None].copy(), preds,
                     (used + emit)[:, None].copy()])
    got = ck.fused_stream(*commit)
    torch.cuda.synchronize()
    commit_err = _bitwise_err(torch, got, ck.fused_stream_plain(*commit))
    print(f"fused_stream commit insert->truncate (R={r} N={n} k={SPEC}): "
          f"max_abs_err={commit_err} tol=0 (bit-identical) "
          f"{'ok' if commit_err == 0 else 'MISMATCH'}")
    if commit_err != 0:
        fail("fused_stream commit stream disagrees with its plain twin")

    for dtype in (np.int32, np.float32):
        for per_row in (False, True):
            args = on_dev(*_nine_op_stream(np, 7, 300, dtype, per_row, 2))
            got = ck.fused_stream(*args, block_r=3)
            torch.cuda.synchronize()
            err = _bitwise_err(torch, got,
                               ck.fused_stream_plain(*args, block_r=3))
            name = dtype.__name__
            print(f"fused_stream nine ops {name} "
                  f"{'per-row' if per_row else 'broadcast'} operands "
                  f"(R=7 N=300 block_r=3): max_abs_err={err} tol=0 "
                  f"(bit-identical) {'ok' if err == 0 else 'MISMATCH'}")
            if err != 0:
                fail(f"fused_stream nine-op stream ({name}, per_row="
                     f"{per_row}) disagrees with its plain twin")

    ms, src, call_ms = timed(lambda: ck.fused_stream(*commit), 200)
    plain_ms, _, plain_call = timed(
        lambda: ck.fused_stream_plain(*commit), 20)
    x, ul, _, ops = commit
    nbytes = (2 * (x.numel() * 4 + ul.numel() * 4)
              + sum(o.numel() * 4 for o in ops))
    bound_ms, by = bound(nbytes)
    return {"name": "fused_stream", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_stream.cu",
            "replaces": "src/repro/kernels/cpm_kernels.py:809",
            "launches": None, "max_abs_err": commit_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None, "ms_source": src,
            "call_ms": call_ms, "plain_call_ms": plain_call}


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
    dev_p = lm._tree_map(lambda t: t.to(dev), cpu_p)
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


def serve_pool(torch, dev, cfg, params, record):
    """Phase 6 (see the module docstring).  Returns the launch counts of
    the gateway run."""
    import warnings

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import repeated_prompts
    from repro_torch.serve import Engine, Gateway, GenConfig

    # no backend named: on the card the engine and the pool's banks
    # default to the kernels
    engine = Engine(cfg, params, max_len=POOL_MAX_LEN)
    gw = Gateway(engine, **POOL)
    pool = gw.pool
    if engine.cpm_backend != "cuda" or \
            {b.backend for b in pool.banks} != {"cuda"}:
        fail("the pool on the card does not default to the cuda banks")
    arrivals = []
    for i, (tick, n, plen, budget) in enumerate(POOL_TRAFFIC):
        prompts = repeated_prompts(n, plen, cfg.vocab_size, 20 + i,
                                   device=dev)
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
    t_run = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = gw.stats()

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
    for name in POOL_KERNELS:
        if counts[name] <= 0:
            fail(f"{name} was not launched on the pool path ({counts})")
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
    print(f"pool tokens vs solo Engine.generate: {identical}/{len(rids)} "
          f"requests identical; in the others {tie_steps} steps took a "
          f"token other than the solo path's choice on the same prefix, "
          f"each a near-tie (largest gap {worst:.3e}, its tol {worst_tol} "
          f"= {NEAR_TIE} x max(1, |logit|))")

    # one steady step: 8 sessions seated, none waiting, finishing or parked
    for i in range(POOL["slots"]):
        gw.submit(repeated_prompts(1, 64, cfg.vocab_size, 40 + i,
                                   device=dev)[0], 24)
    gw.tick()                                      # admission + one chunk
    before = gw.stats()
    if before["waiting"] or before["active"] != POOL["slots"]:
        fail(f"the steady step is not steady: {before}")
    inner = pool._chunk
    syncs = []

    def watched(*a, **k):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return inner(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                syncs.extend(str(w.message) for w in caught
                             if "synchronizing CUDA operation"
                             in str(w.message))

    pool._chunk = watched
    done_before = pool.table.active_count()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    pool.step()
    ev1.record()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del pool._chunk
    dispatch_s = pool.last_chunk_s
    steady = ops.launch_counts()
    after = pool.stats()
    moved = {k: (before[k], after[k]) for k in ("admits", "restores",
                                                "preemptions", "cancels")
             if after[k] != before[k]}
    if moved or pool.table.active_count() != done_before:
        fail(f"the steady step admitted, restored, parked or retired: "
             f"{moved}, active {done_before} -> "
             f"{pool.table.active_count()}")
    want = {name: 0 for name in steady}
    want.update({"gather_rows": POOL["n_banks"],
                 "fused_stream": POOL["n_banks"],
                 "scatter_rows": POOL["n_banks"]})
    if steady != want:
        fail(f"one steady pool.step() launched {steady}, want {want}")
    if syncs:
        fail(f"the decode chunk synchronized with the host: {syncs[:3]}")
    chunk_tokens = POOL["slots"] * POOL["chunk"]
    busy_ms, top = steady_profile(torch, pool)
    while gw.loop.pending():
        gw.tick()
    if gw.stats()["pages_free"] != pool.total_pages:
        fail("pages leaked after the steady-step drain")

    pool_rec = {
        **POOL, "max_len": POOL_MAX_LEN, "layers": cfg.n_layers,
        "requests": len(rids), "traffic": POOL_TRAFFIC,
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
        "steady_step_ms": step_s * 1e3,
        "steady_step_device_ms": ev0.elapsed_time(ev1),
        "steady_dispatch_ms": dispatch_s * 1e3,
        "steady_decode_tok_s": chunk_tokens / step_s,
        "steady_device_busy_ms": busy_ms,
        "steady_idle_share": 1.0 - busy_ms / (step_s * 1e3),
        "steady_top_kernels": top,
        "ticks_report": [{k: r[k] for k in (
            "tick", "step", "admitted", "restored", "preempted", "finished",
            "emitted", "chunk_wall_s", "wall_s", "active", "waiting",
            "parked", "pages_free")} for r in reports],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    record["pool"] = pool_rec
    print(f"pool: {len(rids)} requests in {st['ticks']} ticks, "
          f"{t_run:.2f}s ({pool_rec['run_tok_s']:.1f} new tok/s incl. "
          f"prefill); prefill launches {st['prefill_launches']} for "
          f"{st['admits']} admits; preemptions {st['preemptions']}, "
          f"restores {st['restores']}, page stalls {st['page_stalls']}")
    print(f"pool steady step ({POOL['slots']} rows x chunk "
          f"{POOL['chunk']}): {step_s * 1e3:.1f} ms synchronized, "
          f"{ev0.elapsed_time(ev1):.1f} ms between events, chunk dispatch "
          f"{dispatch_s * 1e3:.1f} ms; {chunk_tokens / step_s:.1f} "
          f"decode tok/s; launches {steady}; host syncs in the chunk 0")
    print(f"pool steady step under torch.profiler: device busy "
          f"{busy_ms:.1f} ms of the {step_s * 1e3:.1f} ms unprofiled step "
          f"(idle share {1.0 - busy_ms / (step_s * 1e3):.3f}); top kernels "
          f"(ms, calls): {top}")
    print(f"launches on the pool path: {counts}")
    return counts


def steady_profile(torch, pool):
    """One more steady ``pool.step()`` under ``torch.profiler``: the summed
    device time of its kernels and copies (ms), and the eight largest by
    device time as ``[name, ms, calls]``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pool.step()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    dev.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    return busy, [[e.key[:60], round(e.self_device_time_total / 1e3, 3),
                   e.count] for e in dev[:8]]


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
                         sort_in["long"], LONG_SORT_STEPS))):
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


def time_cpm2_kernels(torch, dev, data, errs, card):
    """The five phase-8 kernels at their shapes: device time, twin, bound
    and the PyTorch call that computes the same function (``card``: the
    ``nvidia-smi`` name and power limit printed beside the times).  Each
    bound is the work the function needs: bytes for the search, the
    histogram (sorted edges would place a lane in log2(M+1) compares, so
    the difference-of-counts form's M+1 compares a lane are its own, and
    are kept beside it as ``counts_form_bound_ms``) and the super ops;
    for the full sort the larger of its bytes and R * N * log2(N)
    comparisons, with the odd-even network's own R * N * N/2
    compare-exchanges beside it as ``network_bound_ms``."""
    import math

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
            rec["counts_form_bound_ms"] = bound(
                0, 2.0 * nel * (m + 1), F32_OPS_PER_S)[0]
            rec["m8_ms"] = timed(lambda: ck.histogram(xh8, e8, 1024),
                                 iters)[0]
            rec["m8_bound_ms"] = bound(nel * 4 + 9 * 4 + CPM_R * 8 * 4)[0]
        elif name == "oddeven_sort":
            steps = data["steps"]
            rec["shape"] = [SORT_R, SORT_N]
            rec["library_call"] = "torch.sort(...).values"
            rec["network_bound_ms"] = bound(
                0, 2.0 * SORT_R * SORT_N * -(-SORT_N // 2),
                F32_OPS_PER_S)[0]
            rec["bounded"] = {
                "steps": steps,
                "ms": timed(lambda: ck.oddeven_sort(xs, steps), 20)[0],
                "plain_ms": cuda_ms(lambda: ck.oddeven_sort_plain(
                    xs, steps), iters=1, warmup=0),
                "bound_ms": bound(2 * xs.numel() * 4, 2.0 * SORT_R * steps
                                  * -(-SORT_N // 2), F32_OPS_PER_S)[0],
                "library_ms": None}
            xl = data["sort_in"]["long"]
            rec["long"] = {
                "shape": [CPM_R, CPM_N], "steps": LONG_SORT_STEPS,
                "ms": timed(lambda: ck.oddeven_sort(xl, LONG_SORT_STEPS),
                            5)[0],
                "bound_ms": bound(2 * xl.numel() * 4,
                                  2.0 * CPM_R * LONG_SORT_STEPS
                                  * -(-CPM_N // 2), F32_OPS_PER_S)[0]}
            print(f"oddeven_sort bounded {rec['bounded']}, long "
                  f"{rec['long']}; {card}")
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

    # per-row lengths through the executor: each move is one launch over
    # every row's own bounds
    prog = (CPMProgram().append("insert", pos=CPM_N // 4, values=[7, 8])
            .append("delete", pos=CPM_N // 8, k=2, fill=-1))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = prog.run(cpm_array(xi, ul, backend="cuda"))[0]
    torch.cuda.synchronize()
    rows_s = time.perf_counter() - t0
    rows_counts = ops.launch_counts()
    want = {name: 0 for name in rows_counts}
    want["shift_range"] = 2
    if rows_counts != want:
        fail(f"the per-row-length insert and delete launched "
             f"{rows_counts}, want {want} (one shift_range a move over "
             f"the rows' own bounds)")
    ref_out = prog.run(cpm_array(xi, ul, backend="reference"))[0]
    hold("shift_range", torch.equal(out.data, ref_out.data)
         and torch.equal(out.used_len, ref_out.used_len), 0.0,
         f"insert and delete on per-row lengths through CPMProgram.run: "
         f"one launch each over {CPM_R} rows, equal to the reference "
         f"backend's row replay")
    print(f"per-row-length insert + delete through CPMProgram.run: "
          f"{rows_s:.3f}s, {rows_counts['shift_range']} shift_range "
          f"launches ({CPM_R} rows each, per-row bounds)")
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
            spec, stats = gen["engine"].generate({"tokens": gen["prompt"]},
                                                 gen["spec"])
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


def time_stream_kernels(torch, dev, data, sdata, errs):
    """The four phase-9 kernels at its shapes: device time, twin, bound
    and the PyTorch call that computes the same function (``conv1d`` for
    the zero-padded stencil, timed only)."""
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
        ("activate", ":89", lambda: ck.activate(CPM_N, p[0], p[1], p[2],
                                               device=dev),
         lambda: ck.activate_plain(CPM_N, p[0], p[1], p[2], device=dev),
         None, bound(CPM_N + 12)),
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
        if name == "shift_range":
            # per-row bounds: each row's own live end, as a batched
            # device's moves take them
            hi = data["ul"] - 1
            rec["per_row_ms"] = timed(lambda: ck.shift_range(xi, p[0], hi,
                                                             1), 20)[0]
        if name == "template_match":
            rec["m"] = 64
            for m in (4, 16):
                tm = sdata["templates"][m]
                rec[f"m{m}_ms"] = timed(lambda tm=tm: ck.template_match(
                    xi, tm), 20)[0]
                rec[f"m{m}_bound_ms"] = bound(2 * nel * 4 + m * 4,
                                              3.0 * nel * m,
                                              F32_OPS_PER_S)[0]
        if name == "stencil":
            rec["library_call"] = ("torch.nn.functional.conv1d, taps "
                                   "reversed, padding 1 (TF32 off)")
            rec["library_max_abs_err"] = float(
                (conv() - fn()).abs().max())
        out.append(rec)
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    built = _build.build_all()
    print(f"built {built} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f}s")

    full = get_config("granite-8b")
    record = {"card": card, "torch": torch.__version__,
              "config": {"n_heads": full.n_heads,
                         "n_kv_heads": full.n_kv_heads,
                         "head_dim": full.dh}}
    kernels = [check_flash(torch, dev, record),
               check_fused_stream(torch, np, dev),
               *check_rows(torch, np, dev)]
    check_small_model(torch, dev)
    gen_counts, cfg, params, gen = serve_granite(torch, dev, args.layers,
                                                record)
    pool_counts = serve_pool(torch, dev, cfg, params, record)

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
    del gen, params
    torch.cuda.empty_cache()
    kernels += time_stream_kernels(torch, dev, data, data3, errs3)
    del data
    record["streams"] = {"shape": [CPM_R, CPM_N], "used_len": data3["used"],
                         "path_s": data3["path_s"],
                         "rows_s": data3["rows_s"], "launches": s_counts}
    paths = {"generate": gen_counts, "pool": pool_counts, "cpm": cpm_counts,
             "allocator": alloc_counts, "cpm2": cpm2_counts,
             "streams": s_counts["streams"], "rows": s_counts["rows"],
             "generate_by_cost": by_cost["calibrated"],
             "generate_fused": by_cost["fused"],
             "generate_eager": by_cost["eager"],
             "pool_by_cost": pool2_counts}
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
