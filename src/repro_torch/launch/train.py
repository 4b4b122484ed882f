"""Training entry point, on the card by default.

    python -m repro_torch.launch.train --arch granite-8b --smoke \\
        --device cpu --steps 4 --ckpt-dir build/train_ckpt/smoke
    python -m repro_torch.launch.train --arch granite-8b --seq-len 4096 \\
        --global-batch 8 --microbatches 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch granite-8b --seq-len 4096 --global-batch 32

The flags of ``repro.launch.train`` plus ``--device``.  ``--mesh host``
trains over the running group: ``make_host_mesh()`` = (world, 1)
("data", "model") over the ranks ``torchrun`` starts, or a group of one
this process starts itself.  ``--mesh production`` / ``production-multi``
build ``make_production_mesh``'s (16, 16) ("data", "model") / (2, 16,
16) ("pod", "data", "model") over a running group of 256 / 512 ranks
(another size exits, naming them): tensor and expert parallel over
"model", data-parallel over the rest.  Each rank holds only its
``param_spec`` block of the params, ``mu`` and ``nu`` (ZeRO-3), reads
the rows of its data coordinate and all-gathers each block's weights
over the data axes as it runs it (``sharding.compute_view``).
Weights start from seed 0, drawn leaf by leaf: every rank draws each
whole leaf from the same generator on its device and keeps its block, so
one rank's init is the unsharded one's and no rank holds the whole
state.  The data is the synthetic token stream of
``repro_torch.train.data``; the run resumes from the newest checkpoint
in ``--ckpt-dir`` (default ``build/train_ckpt/<arch>`` under the working
directory), re-sharded onto the running group whatever its size.
Besides the periodic checkpoints of the loop, the last step is
checkpointed too, so a later run with more ``--steps`` resumes where
this one ended; rank 0 writes them and logs.  Loss, lr and tokens/s are
logged every ``--log-every`` steps, the only host reads of the metrics.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import SHAPES, ShapeConfig, all_configs, get_config
from repro_torch.distributed import sharding as shlib
from repro_torch.launch.mesh import (ensure_group, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import layers as L, lm
from repro_torch.train import (OptConfig, checkpoint, data,
                               fault_tolerance as ft, init_opt_state,
                               make_train_step)

log = logging.getLogger("repro_torch.launch.train")


def init_state(cfg, device, seed: int = 0, ctx=None) -> dict:
    """Fresh params (``lm.init_params`` from ``seed``) and optimizer state
    on ``device``; on ``meta`` a skeleton of shapes and dtypes only.  With
    a sharding context whose mesh is running, every leaf becomes a
    ``DTensor`` of this rank's block as soon as it is drawn."""
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    if ctx is None or ctx.mesh is None or dev.type == "meta":
        params = lm.init_params(cfg, gen, dev)
    else:
        with L.leaf_hook(lambda name, t: shlib.distribute_leaf(name, t,
                                                               ctx)):
            params = lm.init_params(cfg, gen, dev)
    return {"params": params, "opt": init_opt_state(params)}


def state_shardings(like, ctx) -> dict:
    """Where each leaf of a train state goes (``checkpoint.restore``'s
    ``shardings``): params, ``mu`` and ``nu`` by the partition rules, the
    step whole."""
    specs = shlib.param_specs(like["params"], ctx)
    one = shlib.named_shardings(specs, ctx.mesh)
    return {"params": one, "opt": {"mu": one, "nu": one, "step": None}}


#: the ranks each production mesh needs
MESH_RANKS = {"production": 256, "production-multi": 512}


def build_mesh(kind: str, device: str):
    """The ``DeviceMesh`` of ``--mesh kind`` over the running group (one
    started for ``device`` where none runs).  A production mesh needs its
    256 or 512 ranks: a group of another size exits, naming them."""
    if kind == "host":
        return make_host_mesh(device=device)
    ensure_group(device)
    need, have = MESH_RANKS[kind], dist.get_world_size()
    if have != need:
        raise SystemExit(f"--mesh {kind} needs a group of {need} ranks "
                         f"(make_production_mesh); the running group has "
                         f"{have}")
    return make_production_mesh(multi_pod=kind == "production-multi",
                                device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(all_configs()))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["host", "production",
                                       "production-multi"], default="host")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    try:
        mesh = build_mesh(args.mesh, dev.type)
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        ctx = shlib.make_ctx(mesh)
        shlib.set_sharding_ctx(ctx)
        logging.basicConfig(level=logging.INFO if checkpoint.writes()
                            else logging.WARNING)
        _train(args, dev, ctx)
    finally:
        shlib.set_sharding_ctx(shlib.ShardingCtx())
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev, ctx):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    shape = SHAPES[args.shape]
    seq = args.seq_len or (64 if args.smoke else shape.seq_len)
    gbs = args.global_batch or (8 if args.smoke else shape.global_batch)
    log.info("device %s | mesh %s %s | arch %s (%.2fB params) | %d x %d "
             "tokens a step", dev, tuple(ctx.mesh.shape),
             ctx.mesh.mesh_dim_names, cfg.name, cfg.param_count() / 1e9,
             gbs, seq)

    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(1, args.steps // 20))
    step = make_train_step(cfg, opt_cfg, num_microbatches=args.microbatches,
                           loss_chunk=min(1024, seq))
    fcfg = ft.FaultConfig(ckpt_dir=args.ckpt_dir or os.path.join(
        "build", "train_ckpt", cfg.name), ckpt_every=args.ckpt_every)
    like = init_state(cfg, "meta")
    state, extra, start = ft.resume_or_init(
        fcfg, lambda: init_state(cfg, dev, ctx=ctx), like=like, device=dev,
        shardings=state_shardings(like, ctx))
    pipe = data.make_pipeline(
        cfg, ShapeConfig(shape.name, seq, gbs, shape.kind),
        process_index=shlib.dp_rank(ctx), process_count=shlib.dp_size(ctx))
    if extra.get("data"):
        pipe.restore(extra["data"])

    t0 = time.perf_counter()

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def on_metrics(s, m):
        if (s + 1) % args.log_every == 0 and checkpoint.writes():
            loss, lr = float(m["loss"]), float(m["lr"])   # syncs the card
            dt = time.perf_counter() - t0
            toks = (s + 1 - start) * gbs * seq
            log.info("step %d loss %.4f lr %.2e | %.0f tok/s", s + 1, loss,
                     lr, toks / max(dt, 1e-9))

    state, hb = ft.run_loop(fcfg, state, step_fn, pipe, start, args.steps,
                            on_metrics)
    if args.steps > start and (not fcfg.ckpt_every
                               or args.steps % fcfg.ckpt_every):
        checkpoint.save(fcfg.ckpt_dir, args.steps, state,
                        extra={"data": pipe.state()})
        checkpoint.gc_old(fcfg.ckpt_dir, fcfg.keep)
    log.info("done: %d steps (from %d), %d stragglers", args.steps, start,
             len(hb.straggler_steps))


if __name__ == "__main__":
    main()
