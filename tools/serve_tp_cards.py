"""Serving under a "model" axis across the cards of one host: the port's
``Engine.generate`` on N NCCL ranks, one a card, each mesh (N / M, M)
("data", "model"): weights whole on the data axes and split over "model"
(``make_ctx(mesh, fsdp=False)``), each rank its rows and its block of
every cache.

    torchrun --standalone --nproc-per-node 4 tools/serve_tp_cards.py
    torchrun --standalone --nproc-per-node 4 tools/serve_tp_cards.py \\
        --device cpu --no-full        # gloo, (a) and (c)'s smoke part
    torchrun --standalone --nproc-per-node 4 tools/serve_tp_cards.py \\
        --parts c                     # the session pool only

(a) the six families' smoke configs (granite-8b, qwen2-vl-7b,
    recurrentgemma-9b, granite-moe-1b-a400m, xlstm-1.3b,
    seamless-m4t-large-v2) at (1, 4) (split-KV where their 2 KV heads, 1
    for recurrentgemma, do not divide 4) and (2, 2), float32 compute:
    scan and speculative (draft 4) tokens equal on every model rank, and
    the rows put together equal rank 0's unsharded ``generate`` up to the
    first step whose top-2 logit gap (teacher forcing over the unsharded
    tokens) is within ``TIE`` of the step's largest logit.
(b) granite-8b at full width and depth at (1, 4), bf16 serving weights
    (every >=2-D leaf, as JAX's dry run stores them; 8 KV heads over 4,
    so the heads split), ``chip_smoke.py``'s phase-5 prompts (4 x 256, 64
    new, draft 4): tokens equal on every rank, prefill ms, scan and
    speculative tok/s, the NCCL kernels' device time by name in a prefill
    and a decode step (``torch.profiler``), the model axis's collectives
    a decode step, peak memory, and the params + cache bytes a card,
    which must equal ``launch/dryrun.py``'s argument bytes for this mesh
    and batch (its decode cell at ``max_len`` slots, less the token and
    the position).
(c) the paged session pool and the gateway under the axis: the smoke
    families but seamless (the pool serves decoder-only models) at (1, 4)
    and (2, 2), float32 compute, pages of 4 slots (split-KV pages where
    their 2 KV heads, 1 for recurrentgemma, do not divide 4), a burst
    that preempts, each data rank its own requests: tokens equal on every
    model rank and, as in (a), to rank 0's unsharded gateway; then
    full-depth granite-8b at (1, 4), bf16 weights, ``chip_smoke.py``'s
    phase-20 traffic (phase 6's 12 requests over ``POOL``): tokens equal
    on every rank and to the unsharded pool run on rank 0's card (bit
    for bit, else each token within ``chip_smoke.NEAR_TIE`` of the
    unsharded model's largest logit, as phase 6 holds the pool to solo
    generation), the KV page bytes a card against ``L x 2 x (n_pages +
    1) x KVH / m x page_size x dh x c`` (a quarter of the unsharded
    pool's), a steady ``pool.step()``'s ms, device busy and NCCL time.
Rank 0 prints the card (``nvidia-smi`` name and power limit) and one
JSON line; the script exits non-zero where a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import repeated_prompts  # noqa: E402
from repro_torch.models import layers as L, lm  # noqa: E402
from repro_torch.serve import Engine, Gateway, GenConfig  # noqa: E402
from repro_torch.serve.gateway import PreemptConfig  # noqa: E402
from repro_torch.train._tree import leaves_with_path  # noqa: E402

CONFIGS = ("granite-8b", "qwen2-vl-7b", "recurrentgemma-9b",
           "granite-moe-1b-a400m", "xlstm-1.3b", "seamless-m4t-large-v2")
SMALL = dict(batch=4, prompt=20, new=8, draft=4, max_len=34, enc=16)
TIE = 1e-4


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _params(cfg, dev, ctx, seed: int, dtype=None):
    """Seeded params drawn leaf by leaf on every rank alike, each rank
    keeping its block (``dtype``: cast every >=2-D leaf first)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def cast(t):
        return t.to(dtype) if dtype is not None and t.ndim >= 2 else t

    def keep(name, t):
        t = cast(t)
        return t if ctx.mesh is None else sh.distribute_leaf(name, t, ctx)

    with L.leaf_hook(keep):
        return lm.init_params(cfg, gen, dev)


def _gather_rows(x: torch.Tensor, ctx) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order (no gradient)."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x.contiguous())
    return torch.stack(out)


def _small(dev, model: int) -> dict:
    """(a) at a (N / model, model) mesh."""
    mesh = make_host_mesh(model=model, device=dev.type)
    ctx = sh.make_ctx(mesh, fsdp=False)
    dp, dr, m = sh.dp_size(ctx), sh.dp_rank(ctx), sh.model_size(ctx)
    b = SMALL["batch"] // dp
    out = {}
    L.COMPUTE_DTYPE = torch.float32
    for name in CONFIGS:
        cfg = get_config(name).smoke()
        g = torch.Generator().manual_seed(7)
        batch = {"tokens": repeated_prompts(SMALL["batch"], SMALL["prompt"],
                                            cfg.vocab_size, 3, period=5,
                                            device=dev)}
        if cfg.enc_dec:
            batch["src_embeds"] = torch.randn(
                (SMALL["batch"], SMALL["enc"], cfg.d_model),
                generator=g).to(dev)
        rows = {k: v[dr * b:(dr + 1) * b] for k, v in batch.items()}
        with sh.use_sharding(ctx):
            eng = Engine(cfg, _params(cfg, dev, ctx, 41),
                         max_len=SMALL["max_len"])
            got = {kind: eng.generate(rows, GenConfig(
                max_new_tokens=SMALL["new"], ngram_spec=spec))[0]
                for kind, spec in (("scan", 0), ("spec", SMALL["draft"]))}
        every = {k: _gather_rows(v, ctx).cpu() for k, v in got.items()}
        res = {}
        if dist.get_rank() == 0:
            with sh.use_sharding(sh.ShardingCtx()):
                plain = Engine(cfg, _params(cfg, dev, sh.ShardingCtx(), 41),
                               max_len=SMALL["max_len"])
                gaps = None
                for kind, spec in (("scan", 0), ("spec", SMALL["draft"])):
                    want = plain.generate(batch, GenConfig(
                        max_new_tokens=SMALL["new"],
                        ngram_spec=spec))[0].cpu()
                    if gaps is None:
                        gaps = _teacher_gaps(plain, batch, want.to(dev))
                    ranks = every[kind]               # (N, b, S + new)
                    same = all(torch.equal(ranks[r], ranks[r - r % m])
                               for r in range(len(ranks)))
                    whole = torch.cat([ranks[r] for r in
                                       range(0, len(ranks), m)])
                    res[kind] = {"ranks_equal": same,
                                 "agree": _agree(whole.numpy(),
                                                 want.numpy(), gaps),
                                 "equal": bool(torch.equal(whole, want))}
        out[name] = res
    L.COMPUTE_DTYPE = torch.bfloat16
    return out


def _teacher_gaps(engine, batch, seq) -> np.ndarray:
    """(B, new) top-2 gaps of the unsharded logits teacher-forced over
    ``seq``, each over the step's largest |logit|."""
    cfg = engine.cfg
    full = dict(batch, tokens=seq)
    with torch.no_grad():
        x, _ = lm.forward(engine.params, cfg, full, remat=False)
        lg = lm._logits(engine.params, cfg, x).float().cpu().numpy()
    s = SMALL["prompt"]
    lg = lg[:, s - 1:-1, :cfg.vocab_size]
    top = np.sort(lg, -1)
    return (top[..., -1] - top[..., -2]) / np.abs(lg).max(-1)


def _agree(got, want, gaps, s: int = SMALL["prompt"]) -> bool:
    """Equal in every row up to its first differing step after the
    ``s``-token prompt, which a near-tie at or before it explains."""
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r, s:] != want[r, s:])[0]
        if diff.size and gaps[r, :diff[0] + 1].min() > TIE:
            return False
    return True


_DRYRUN = r"""
import sys
from torch.testing._internal.distributed.fake_pg import FakeStore
import torch.distributed as dist
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh

n, max_len, batch = map(int, sys.argv[1:4])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
mesh = make_host_mesh(model=n, device="cpu")
_, args, _ = dryrun.build_cell(
    "granite-8b", ShapeConfig("serve_tp", max_len, batch, "decode"), mesh)
print(dryrun._bytes((args[0], args[2])))
"""


def _dryrun_bytes(n: int, max_len: int) -> int:
    """The dry run's params + cache bytes a rank of a (1, n) mesh for the
    decode cell of ``cs.BATCH`` rows and ``max_len`` slots, as rank 0 of
    a fake group of n ranks on ``meta`` (in a subprocess: this process
    runs the NCCL group)."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", _DRYRUN, str(n),
                          str(max_len), str(cs.BATCH)], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return int(out.stdout.strip().splitlines()[-1])


def _nccl(events) -> dict:
    by = {}
    for e in events:
        if "nccl" in e.key.lower():
            by[e.key] = by.get(e.key, 0.0) + cs._ms([e])
    return by


def _full(dev) -> dict:
    """(b): full-depth granite-8b at (1, N)."""
    n = dist.get_world_size()
    mesh = make_host_mesh(model=n, device=dev.type)
    ctx = sh.make_ctx(mesh, fsdp=False)
    cfg = get_config("granite-8b")
    max_len = cs.PROMPT_LEN + cs.MAX_NEW + cs.SPEC + 8
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with sh.use_sharding(ctx):
        params = _params(cfg, dev, ctx, 0, torch.bfloat16)
    _sync(dev)
    out = {"mesh": [1, n], "init_s": time.perf_counter() - t0,
           "max_len": max_len, "batch": cs.BATCH,
           "prompt_len": cs.PROMPT_LEN, "max_new": cs.MAX_NEW,
           "spec": cs.SPEC}
    prompt = repeated_prompts(cs.BATCH, cs.PROMPT_LEN, cfg.vocab_size, 1,
                              device=dev)
    eng = Engine(cfg, params, max_len=max_len, cpm_backend="cuda")
    new = cs.BATCH * cs.MAX_NEW
    with sh.use_sharding(ctx):
        # a warm-up, then timed: the prefill, scan, speculative
        eng.generate({"tokens": prompt}, GenConfig(max_new_tokens=2))
        pre = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            _, caches = lm.prefill(params, cfg, {"tokens": prompt},
                                   max_len=max_len)
            _sync(dev)
            pre.append((time.perf_counter() - t0) * 1e3)
        runs = {}
        for kind, spec in (("scan", 0), ("spec", cs.SPEC)):
            _sync(dev)
            t0 = time.perf_counter()
            toks, stats = eng.generate({"tokens": prompt}, GenConfig(
                max_new_tokens=cs.MAX_NEW, ngram_spec=spec))
            _sync(dev)
            dt = time.perf_counter() - t0
            runs[kind] = {"s": dt, "tok_s": new / dt,
                          "rounds": stats["rounds"],
                          "acceptance_rate": stats["acceptance_rate"]}
            runs[kind]["tokens"] = toks
        every = _gather_rows(runs["scan"]["tokens"], ctx)
        out["ranks_equal"] = bool(all(torch.equal(every[0], t)
                                      for t in every))
        out["spec_equals_scan"] = bool(torch.equal(
            runs["scan"]["tokens"], runs["spec"]["tokens"]))
        for r in runs.values():
            del r["tokens"]
        out.update(prefill_ms=pre, prefill_ms_best=min(pre), runs=runs)
        # the held bytes: params and the prefill's caches, against the
        # dry run's decode cell for this mesh and batch
        held = {"params": sum(sh.local(x).numel() * x.element_size()
                              for _, x in leaves_with_path(params)),
                "caches": sum(x.numel() * x.element_size()
                              for _, x in leaves_with_path(caches))}
        want = _dryrun_bytes(n, max_len)
        out.update(held_bytes=held, dryrun_bytes=want,
                   bytes_equal=sum(held.values()) == want)
        # device time of a prefill and a decode step, NCCL by kernel
        ev = cs._device_events(torch, lambda: lm.prefill(
            params, cfg, {"tokens": prompt}, max_len=max_len))
        out["prefill_busy_ms"], out["prefill_nccl_ms"] = (
            cs._ms(ev), _nccl(ev))
        pos = torch.tensor(cs.PROMPT_LEN, dtype=torch.int32, device=dev)
        sh.reset_collective_counts()
        lm.decode_step(params, cfg, prompt[:, :1], caches, pos,
                       max_len=max_len)
        out["decode_collectives"] = {
            k: {"calls": v["calls"], "bytes": v["bytes"]}
            for k, v in sh.collective_counts().items() if v["calls"]}
        ev = cs._device_events(torch, lambda: lm.decode_step(
            params, cfg, prompt[:, :1], caches, pos, max_len=max_len))
        out["decode_busy_ms"], out["decode_nccl_ms"] = (
            cs._ms(ev), _nccl(ev))
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


#: (c)'s smoke gateway: pages of 4 slots, chunks of 3, a burst that
#: preempts; (arrival tick, prompt length, budget) of its requests
POOL_SMALL = dict(slots=2, chunk=3, page_size=4, pages_per_bank=8,
                  preempt=PreemptConfig(min_resident=1, min_remaining=1,
                                        max_parks=3))
POOL_ARRIVALS = ((0, 6, 12), (0, 7, 12), (2, 5, 3), (2, 5, 3), (3, 6, 3))
POOL_LEN = 24
POOL_CONFIGS = CONFIGS[:-1]                  # decoder-only


def _replay(gw, prompts, arrivals):
    """Each request submitted when the gateway's tick count reaches its
    arrival, ticked until done; returns each request's tokens."""
    rids, nxt = [], 0
    while nxt < len(arrivals) or gw.loop.pending():
        while nxt < len(arrivals) and arrivals[nxt][0] <= gw.loop.ticks:
            rids.append(gw.submit(prompts[nxt], arrivals[nxt][-1]))
            nxt += 1
        gw.tick()
    return [torch.as_tensor(gw.request(r).tokens) for r in rids]


def _pool_prompts(cfg, dev, d: int) -> list:
    g = torch.Generator().manual_seed(50 + d)
    return [torch.randint(0, cfg.vocab_size, (s,), generator=g).to(dev)
            for _, s, _ in POOL_ARRIVALS]


def _gaps(engine, prompt, seq) -> np.ndarray:
    """Top-2 logit gaps of the unsharded model teacher-forced over one
    request's ``seq``, each over the step's largest |logit|."""
    with torch.no_grad():
        x, _ = lm.forward(engine.params, engine.cfg,
                          {"tokens": seq.to(prompt.device)[None]},
                          remat=False)
        lg = lm._logits(engine.params, engine.cfg, x).float().cpu().numpy()
    s = prompt.shape[0]
    lg = lg[0, s - 1:-1, :engine.cfg.vocab_size]
    top = np.sort(lg, -1)
    return (top[:, -1] - top[:, -2]) / np.abs(lg).max(-1)


def _pool_small(dev, model: int) -> dict:
    """(c)'s smoke part at a (N / model, model) mesh."""
    mesh = make_host_mesh(model=model, device=dev.type)
    ctx = sh.make_ctx(mesh, fsdp=False)
    dp, dr, m = sh.dp_size(ctx), sh.dp_rank(ctx), sh.model_size(ctx)
    out = {}
    L.COMPUTE_DTYPE = torch.float32
    for name in POOL_CONFIGS:
        cfg = get_config(name).smoke()
        with sh.use_sharding(ctx):
            eng = Engine(cfg, _params(cfg, dev, ctx, 41), max_len=POOL_LEN)
            got = _replay(Gateway(eng, **POOL_SMALL),
                          _pool_prompts(cfg, dev, dr), POOL_ARRIVALS)
        width = max(t.shape[0] for t in got)
        mine = torch.stack([torch.nn.functional.pad(t, (0, width - len(t)),
                                                    value=-1) for t in got])
        every = _gather_rows(mine.to(dev), ctx).cpu()   # (N, requests, W)
        res = {}
        if dist.get_rank() == 0:
            plain = Engine(cfg, _params(cfg, dev, sh.ShardingCtx(), 41),
                           max_len=POOL_LEN)
            same = all(torch.equal(every[r], every[r - r % m])
                       for r in range(len(every)))
            agree = equal = True
            for d in range(dp):
                ps = _pool_prompts(cfg, dev, d)
                want = _replay(Gateway(plain, **POOL_SMALL), ps,
                               POOL_ARRIVALS)
                for i, (p, w) in enumerate(zip(ps, want)):
                    g_ = every[d * m, i, :len(w)]
                    equal &= bool(torch.equal(g_, w))
                    agree &= _agree(g_.numpy()[None], w.numpy()[None],
                                    _gaps(plain, p, w.to(dev))[None],
                                    s=p.shape[0])
            res = {"ranks_equal": same, "agree": agree, "equal": equal}
        out[name] = res
    L.COMPUTE_DTYPE = torch.bfloat16
    return out


def _kv_page_bytes(pool) -> int:
    """Bytes of the pool's global-attention K/V page leaves on this card."""
    from repro_torch.serve import kv_cache

    ub, ut = kv_cache.attn_sites(pool.engine.cfg)
    nodes = [pool.caches["blocks"][u]["attn"] for u in ub] + \
        [pool.caches["tail"][t]["attn"] for t in ut]
    return sum(a[k].numel() * a[k].element_size() for a in nodes
               for k in ("k", "v"))


def _pool_full(dev) -> dict:
    """(c)'s full-depth part: granite-8b at (1, N) behind the gateway."""
    n = dist.get_world_size()
    mesh = make_host_mesh(model=n, device=dev.type)
    ctx = sh.make_ctx(mesh, fsdp=False)
    cfg = get_config("granite-8b")
    torch.cuda.reset_peak_memory_stats(dev)
    with sh.use_sharding(ctx):
        params = _params(cfg, dev, ctx, 0, torch.bfloat16)
        eng = Engine(cfg, params, max_len=cs.POOL_MAX_LEN)
        gw = cs._pool_gateway(torch, eng)
        rids, _, run_s, counts = cs._pool_traffic(torch, dev, gw,
                                                  cfg.vocab_size)
        st = gw.stats()
        pool = gw.pool
        page_bytes = _kv_page_bytes(pool)
        kvh, pg = cfg.n_kv_heads, cs.POOL["page_size"]
        want_bytes = (cfg.n_layers * 2 * (pool.total_pages + 1)
                      * (kvh // n) * pg * cfg.dh
                      * pool.caches["blocks"][0]["attn"]["k"].element_size())
        toks = [torch.as_tensor(gw.request(r).tokens) for r, _, _ in rids]
        width = max(len(t) for t in toks)
        mine = torch.stack([torch.nn.functional.pad(t, (0, width - len(t)),
                                                    value=-1) for t in toks])
        every = _gather_rows(mine.to(dev), ctx).cpu()
        # a steady step: every slot seated, timed, profiled
        cs._seat_steady(torch, dev, gw, cfg.vocab_size, 64)
        step_ms = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            pool.step()
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        sh.reset_collective_counts()
        pool.step()
        colls = {k: {"calls": v["calls"], "bytes": v["bytes"]}
                 for k, v in sh.collective_counts().items() if v["calls"]}
        ev = cs._device_events(torch, pool.step)
        steady = pool.stats()["active"] == cs.POOL["slots"]
        del gw, pool, eng, params
    torch.cuda.empty_cache()
    out = {"mesh": [1, n], "requests": len(rids), "run_s": run_s,
           "preemptions": st["preemptions"], "restores": st["restores"],
           "prefill_launches": st["prefill_launches"], "launches": counts,
           "ranks_equal": bool(all(torch.equal(every[0], t) for t in every)),
           "kv_page_bytes": page_bytes, "kv_page_bytes_formula": want_bytes,
           "step_ms": step_ms, "step_ms_best": min(step_ms),
           "steady": steady, "step_busy_ms": cs._ms(ev),
           "step_nccl_ms": _nccl(ev), "step_collectives": colls,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    if dist.get_rank() == 0:
        # the unsharded pool on this card: the same weights, whole
        with sh.use_sharding(sh.ShardingCtx()):
            plain = Engine(cfg, _params(cfg, dev, sh.ShardingCtx(), 0,
                                        torch.bfloat16),
                           max_len=cs.POOL_MAX_LEN)
            gw = cs._pool_gateway(torch, plain)
            prids, _, plain_s, _ = cs._pool_traffic(torch, dev, gw,
                                                    cfg.vocab_size)
            out["plain_kv_page_bytes"] = _kv_page_bytes(gw.pool)
            out["plain_run_s"] = plain_s
            out["plain_preemptions"] = gw.stats()["preemptions"]
            identical, worst, ok = 0, 0.0, True
            for i, (rid, prompt, _) in enumerate(prids):
                want = torch.as_tensor(gw.request(rid).tokens)
                got = every[0, i, :len(want)]
                if torch.equal(got, want):
                    identical += 1
                    continue
                gaps, tol, _ = cs._solo_gaps(torch, plain, prompt,
                                             got.to(dev))
                worst = max(worst, float(gaps.max()))
                ok &= float(gaps.max()) <= tol
            out.update(identical=identical, near_tie_ok=bool(ok),
                       largest_gap=worst)
            del gw, plain
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu: gloo)")
    ap.add_argument("--no-full", action="store_true",
                    help="skip the full-depth runs of (b) and (c)")
    ap.add_argument("--parts", default="abc",
                    help="which of (a), (b), (c) to run (default abc)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    make_host_mesh(device=dev.type)              # starts the group
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    rec = {"ranks": n, "backend": dist.get_backend(),
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "small": {}, "pool_small": {}}
    meshes = [n] + ([2] if n % 2 == 0 and n > 2 else [])
    full = dev.type == "cuda" and not args.no_full
    for m in meshes:
        tag = f"{n // m}x{m}"
        if "a" in args.parts:
            rec["small"][tag] = _small(dev, m)
        if "c" in args.parts:
            rec["pool_small"][tag] = _pool_small(dev, m)
    if full and "b" in args.parts:
        rec["full"] = _full(dev)
    if full and "c" in args.parts:
        rec["pool_full"] = _pool_full(dev)
    bad = []
    if dist.get_rank() == 0:
        for part in ("small", "pool_small"):
            for tag, by_cfg in rec[part].items():
                for name, res in by_cfg.items():
                    for kind, r in (res.items() if part == "small"
                                    else [("gateway", res)]):
                        if not (r["ranks_equal"] and r["agree"]):
                            bad.append(f"{part} {tag} {name} {kind}: {r}")
        f = rec.get("full")
        if f and not (f["ranks_equal"] and f["spec_equals_scan"]
                      and f["bytes_equal"]):
            bad.append(f"full depth: ranks equal {f['ranks_equal']}, spec "
                       f"== scan {f['spec_equals_scan']}, bytes "
                       f"{f['held_bytes']} vs the dry run's "
                       f"{f['dryrun_bytes']}")
        f = rec.get("pool_full")
        if f and not (f["ranks_equal"] and f["near_tie_ok"] and f["steady"]
                      and f["kv_page_bytes"] == f["kv_page_bytes_formula"]
                      and f["kv_page_bytes"] * n
                      == f["plain_kv_page_bytes"]):
            bad.append(f"pool at full depth: ranks equal "
                       f"{f['ranks_equal']}, tokens within near-ties "
                       f"{f['near_tie_ok']}, steady {f['steady']}, KV page "
                       f"bytes {f['kv_page_bytes']} vs the formula's "
                       f"{f['kv_page_bytes_formula']} and the unsharded "
                       f"pool's {f['plain_kv_page_bytes']}")
        if dev.type == "cuda":
            print(cs.nvidia_smi_line())
        print(json.dumps(rec))
        for b in bad:
            print(f"serve_tp_cards: FAILED {b}", file=sys.stderr)
    dist.destroy_process_group()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
