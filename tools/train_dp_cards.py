"""Sharded training across the cards of one host: the trainer on N NCCL
ranks, one a card, on a (N / M, M) ("data", "model") mesh: ZeRO-3 over
"data" by the partition rules, tensor and expert parallel over "model".

    torchrun --standalone --nproc-per-node 4 tools/train_dp_cards.py
    torchrun --standalone --nproc-per-node 4 tools/train_dp_cards.py \\
        --model 4                    # (1, 4): tensor parallel
    torchrun --standalone --nproc-per-node 4 tools/train_dp_cards.py \\
        --model 2 --steps 0          # (2, 2), the gradients only
    torchrun --standalone --nproc-per-node 2 tools/train_dp_cards.py \\
        --device cpu --model 2       # gloo, the smoke configs

(a) granite-8b and granite-moe-1b-a400m at full width cut to 2 layers,
    float32 compute, 2 rows of 128 tokens a data rank: one step's
    gradients of the sharded trainer against the unsharded trainer's on
    the whole batch, run on rank 0's card: every leaf within 1e-3 of its
    largest value (``chip_smoke.py`` phase 15(b)'s bound), the losses
    within 1e-3 relative.
(b) with ``--steps`` > 0, granite-8b at full depth (36 layers, 8.17B
    params: 131 GB of float32 params, gradients and moments, a 1/N block
    of each a card), ``train_4k``'s 4,096-token rows, 8 a step (32,768
    tokens) in 2 microbatches, remat, bf16: the state drawn leaf by leaf,
    ``--steps`` steps timed on the host clock to a synchronize, peak
    memory a card, the collectives of a step (calls, bytes, ring bytes)
    against the formulas (``chip_smoke._zero3_bytes`` for the data axes,
    ``chip_smoke._model_bytes`` for the model axis), one more step under
    ``torch.profiler`` (device busy, NCCL kernels by name), the roofline
    share.
Rank 0 prints the card (``nvidia-smi`` name and power limit) and one
JSON line; the script exits non-zero where a check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.train import init_state  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.train import OptConfig, data, make_train_step  # noqa: E402
from repro_torch.train._tree import leaves_with_path  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

TOL = 1e-3
ROWS = 2                               # rows a data rank in (a)
GLOBAL_ROWS, MICRO = 8, 2              # rows a step, microbatches in (b)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _grads_against_unsharded(cfg, dev, ctx, seq: int) -> dict:
    """(a): the sharded step's gradients, gathered whole, against rank 0's
    unsharded step on the whole batch."""
    rank, n = sh.dp_rank(ctx), sh.dp_size(ctx)
    tokens = np.random.default_rng(291).integers(
        0, cfg.vocab_size, (ROWS * n, seq)).astype(np.int32)
    state = init_state(cfg, dev, seed=290, ctx=ctx)
    loss, _, grads = loss_and_grads(
        state["params"], cfg, {"tokens": tokens[rank * ROWS:(rank + 1)
                                               * ROWS]})
    got = [(p, sh.full_tensor(g)) for p, g in leaves_with_path(grads)]
    del state, grads
    out = {}
    if dist.get_rank() == 0:
        with sh.use_sharding(sh.ShardingCtx()):
            plain = init_state(cfg, dev, seed=290)["params"]
            want_loss, _, want = loss_and_grads(plain, cfg,
                                                {"tokens": tokens})
        errs = {}
        for (path, a), (_, b) in zip(got, leaves_with_path(want)):
            errs[path] = float((a - b).abs().max() / b.abs().max())
        worst = max(errs, key=errs.get)
        out = {"leaves": len(errs), "worst_leaf": worst,
               "worst_err": errs[worst], "loss": float(loss),
               "unsharded_loss": float(want_loss)}
        del plain, want
    dist.barrier()
    return out


def _train_full_depth(cfg, dev, ctx, seq: int, steps: int) -> dict:
    """(b): ``steps`` steps of the sharded trainer, timed and counted."""
    n, msize = sh.dp_size(ctx), sh.model_size(ctx)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_state(cfg, dev, seed=29, ctx=ctx)
    _sync(dev)
    init_s = time.perf_counter() - t0
    shape = ShapeConfig("train_4k", seq, GLOBAL_ROWS, "train")
    pipe = data.make_pipeline(cfg, shape, seed=29,
                              process_index=sh.dp_rank(ctx), process_count=n)
    step = make_train_step(cfg, OptConfig(warmup_steps=2, total_steps=steps),
                           num_microbatches=MICRO, remat=True,
                           loss_chunk=min(1024, seq))
    losses, step_ms, counts = [], [], None
    for _ in range(steps):
        batch = next(pipe)
        sh.reset_collective_counts()
        _sync(dev)
        t0 = time.perf_counter()
        p, o, m = step(state["params"], state["opt"], batch)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = sh.collective_counts()
        state = {"params": p, "opt": o}
        losses.append(float(m["loss"]))
    every = sh.dp_gather(torch.tensor(losses, device=dev)).cpu()
    local = sum(sh.local(x).numel() for t in (
        state["params"], state["opt"]["mu"], state["opt"]["nu"])
        for _, x in leaves_with_path(t))
    n_params = sum(x.numel() for _, x in leaves_with_path(state["params"]))
    like = init_state(cfg, "meta")["params"]
    rows = GLOBAL_ROWS // n
    out = {"layers": cfg.n_layers, "params": n_params, "mesh": [n, msize],
           "rows_per_data_rank": rows, "seq": seq, "microbatches": MICRO,
           "init_s": init_s, "losses": losses, "step_ms": step_ms,
           "ranks_agree": bool((every == every[0]).all()),
           "state_elements_per_rank": local,
           "state_elements": 3 * n_params,
           "collectives": counts,
           "formula": cs._zero3_bytes(cfg, like, ctx, MICRO),
           "model_formula": cs._model_bytes(cfg, like, msize, rows // MICRO,
                                            seq, MICRO)}
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        batch = next(pipe)
        events = cs._device_events(torch, lambda: step(
            state["params"], state["opt"], batch))
        nccl = [e for e in events if "nccl" in e.key.lower()]
        by = {}
        for e in nccl:
            by[e.key] = by.get(e.key, 0.0) + cs._ms([e])
        out.update(busy_ms=cs._ms(events), top=cs._top(events),
                   nccl_ms=cs._ms(nccl), nccl_by_kernel=by)
        mean_s = sum(step_ms[1:]) / max(len(step_ms) - 1, 1) / 1e3
        cards = n * msize
        flops = roofline.model_flops(cfg, shape) / cards
        stats = roofline.collective_stats(counts)
        terms = roofline.roofline_terms(
            flops, cs.ADAMW_BYTES_PER_PARAM * n_params / cards,
            stats.per_chip_bytes)
        out["roofline"] = {**terms, "flops_per_card": flops,
                           "ring_bytes": stats.per_chip_bytes,
                           "ring_bytes_by_axis": stats.by_axis,
                           "share": flops / (mean_s
                                             * roofline.HW["peak_flops"])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu: gloo, smoke)")
    ap.add_argument("--steps", type=int, default=3,
                    help="steps of (b); 0 runs (a) only")
    ap.add_argument("--model", type=int, default=1,
                    help="the model axis's size (the mesh is (N / M, M))")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = make_host_mesh(model=args.model, device=dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    ctx = sh.make_ctx(mesh)
    sh.set_sharding_ctx(ctx)
    full = dev.type == "cuda"
    base = get_config("granite-8b")
    rec = {"ranks": dist.get_world_size(), "backend": dist.get_backend(),
           "device": (torch.cuda.get_device_name(dev) if full else "cpu")}
    rec["mesh"] = list(mesh.shape)
    L.COMPUTE_DTYPE = torch.float32
    rec["grads"] = {}
    for name in ("granite-8b", "granite-moe-1b-a400m"):
        cfg = get_config(name)
        small = dataclasses.replace(cfg, n_layers=2) if full else cfg.smoke()
        rec["grads"][name] = _grads_against_unsharded(small, dev, ctx,
                                                      128 if full else 16)
    L.COMPUTE_DTYPE = torch.bfloat16
    if args.steps:
        rec["train"] = _train_full_depth(base if full else base.smoke(), dev,
                                         ctx, 4096 if full else 32,
                                         args.steps)
    bad = []
    if dist.get_rank() == 0:
        for g in rec["grads"].values():
            if g["worst_err"] > TOL or abs(g["loss"] - g["unsharded_loss"]) \
                    > TOL * abs(g["unsharded_loss"]):
                bad.append(f"gradients: {g}")
        t = rec.get("train")
        if t and (not all(map(math.isfinite, t["losses"]))
                  or not t["ranks_agree"]):
            bad.append(f"losses: {t['losses']}, ranks agree "
                       f"{t['ranks_agree']}")
        if t:
            got = {k: v["bytes"] for k, v in t["collectives"].items()
                   if ":" not in k}
            if got != t["formula"]:
                bad.append(f"collective bytes {got} != {t['formula']}")
            got = {k: v["dtypes"] for k, v in t["collectives"].items()
                   if k.endswith(":model")}
            if got != t["model_formula"]:
                bad.append(f"model-axis bytes {got} != "
                           f"{t['model_formula']}")
        if full:
            print(cs.nvidia_smi_line())
        print(json.dumps(rec))
        for b in bad:
            print(f"train_dp_cards: FAILED {b}", file=sys.stderr)
    dist.destroy_process_group()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
