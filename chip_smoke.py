#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # full-width, full-depth granite-8b
    python3 chip_smoke.py --layers 4      # cut depth (debugging)

Phases, in order; any failure exits non-zero:

  1. build every CUDA kernel of ``src/repro_torch/csrc`` (one nvcc each,
     all started together);
  2. hold each kernel against its plain PyTorch twin on the card, at the
     main path's shapes, and time kernel, twin and (for attention)
     ``scaled_dot_product_attention``: device time from ``torch.profiler``
     (CUDA events when it records none) and per-call time with events;
  3. check the port end to end on a small input: the smoke config on the
     card (kernels) against the same weights on the CPU (plain twins);
  4. build granite-8b at full width from a seeded ``torch.Generator`` on
     the card (~8.3B float32 parameters);
  5. serve 4 requests of 256 prompt tokens built from repeated n-grams
     through ``Engine.generate``: greedy on the scan path, then with
     ``ngram_spec=4`` and ``cpm_backend="cuda"``, with the launch counters
     set to 0 just before and read just after; the speculative tokens must
     equal the scan tokens, flash attention must launch at least once per
     layer per prefill and ``fused_stream`` once per speculative round.

The lines before the last are the card (``nvidia-smi`` name and power
limit) and one JSON object with every kernel's launches, error and
times; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repo's ``src/repro_torch`` beside it, it
prints no result and exits non-zero.  The full record is also written to
``artifacts/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

PROMPT_LEN, MAX_NEW, BATCH, SPEC = 256, 64, 4, 4
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def device_ms(fn, iters: int = 20):
    """Mean device-busy time of one call of ``fn``: the summed durations
    of the CUDA kernels (and copies) it launches, from ``torch.profiler``
    (CUPTI).  Host gaps between launches are excluded, so a wrapper
    whose Python side is slower than its kernel is not charged for it.
    None when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA"))
    return total_us / 1e3 / iters if total_us > 0 else None


def timed(fn, iters: int):
    """(device ms per call or, without profiler data, events ms; the
    source; events ms per call including host time)."""
    call = cuda_ms(fn, iters=iters)
    dev = device_ms(fn, iters=iters)
    return (dev, "profiler", call) if dev is not None else \
        (call, "events", call)


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
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
    if after_scan["fused_stream"] != 0 or \
            counts["fused_stream"] != stats["rounds"]:
        fail(f"fused_stream launched {counts['fused_stream']} times for "
             f"{stats['rounds']} speculative rounds")

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
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"serve: prefill {prefill_ms:.1f} ms (B={BATCH} x {PROMPT_LEN}); "
          f"scan {t_scan:.2f}s = {new / t_scan:.1f} tok/s; spec "
          f"{t_spec:.2f}s = {new / t_spec:.1f} tok/s, {stats['rounds']} "
          f"rounds, acceptance {stats['acceptance_rate']:.3f} "
          f"({stats['accepted']}/{stats['proposed']}); spec == scan")
    print(f"launches on the main path: {counts} (after scan: {after_scan})")
    record["serve"] = serve
    return counts


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
               check_fused_stream(torch, np, dev)]
    check_small_model(torch, dev)
    counts = serve_granite(torch, dev, args.layers, record)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        print(f"{k['name']}: {k['ms']:.4f} ms on the card "
              f"({k['ms_source']}; {k['call_ms']:.4f} ms per call with "
              f"host time), plain {k['plain_ms']:.4f} ms "
              f"({k['plain_call_ms']:.4f} per call), bound "
              f"{k['bound_ms']:.6f} ms by {k['bound_by']}, library "
              f"{k['library_ms']} ms; {k['launches']} launches on the "
              f"main path; {card}")
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
