"""Serving under a "model" axis across the cards of one host: the port's
``Engine.generate`` on N NCCL ranks, one a card, each mesh (N / M, M)
("data", "model"): weights whole on the data axes and split over "model"
(``make_ctx(mesh, fsdp=False)``), each rank its rows and its block of
every cache.

    torchrun --standalone --nproc-per-node 4 tools/serve_tp_cards.py
    torchrun --standalone --nproc-per-node 4 tools/serve_tp_cards.py \\
        --device cpu --no-full        # gloo, (a) only

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
from repro_torch.serve import Engine, GenConfig  # noqa: E402
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

    def keep(name, t):
        if dtype is not None and t.ndim >= 2:
            t = t.to(dtype)
        return sh.distribute_leaf(name, t, ctx)

    if ctx.mesh is None:
        return lm.init_params(cfg, gen, dev)
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


def _agree(got, want, gaps) -> bool:
    """Equal in every row up to its first differing step, which a
    near-tie at or before it explains."""
    s = SMALL["prompt"]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu: gloo)")
    ap.add_argument("--no-full", action="store_true",
                    help="run (a) only")
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
           "small": {f"1x{n}": _small(dev, n)}}
    if n % 2 == 0 and n > 2:
        rec["small"][f"{n // 2}x2"] = _small(dev, 2)
    if dev.type == "cuda" and not args.no_full:
        rec["full"] = _full(dev)
    bad = []
    if dist.get_rank() == 0:
        for tag, by_cfg in rec["small"].items():
            for name, res in by_cfg.items():
                for kind, r in res.items():
                    if not (r["ranks_equal"] and r["agree"]):
                        bad.append(f"{tag} {name} {kind}: {r}")
        f = rec.get("full")
        if f and not (f["ranks_equal"] and f["spec_equals_scan"]
                      and f["bytes_equal"]):
            bad.append(f"full depth: ranks equal {f['ranks_equal']}, spec "
                       f"== scan {f['spec_equals_scan']}, bytes "
                       f"{f['held_bytes']} vs the dry run's "
                       f"{f['dryrun_bytes']}")
        if dev.type == "cuda":
            print(cs.nvidia_smi_line())
        print(json.dumps(rec))
        for b in bad:
            print(f"serve_tp_cards: FAILED {b}", file=sys.stderr)
    dist.destroy_process_group()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
