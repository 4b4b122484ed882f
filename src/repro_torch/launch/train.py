"""Training entry point, on the card by default.

    python -m repro_torch.launch.train --arch granite-8b --smoke \\
        --device cpu --steps 4 --ckpt-dir build/train_ckpt/smoke
    python -m repro_torch.launch.train --arch granite-8b --seq-len 4096 \\
        --global-batch 8 --microbatches 4

The flags of ``repro.launch.train`` plus ``--device``.  ``--mesh host``
(one device) is the only mesh: the production meshes come with
distribution (ROADMAP Queue 1 item 5).  Weights start from seed 0 and
the data is the synthetic token stream of ``repro_torch.train.data``;
the run resumes from the newest checkpoint in ``--ckpt-dir`` (default
``build/train_ckpt/<arch>`` under the working directory).  Besides the
periodic checkpoints of the loop, the last step is checkpointed too, so
a later run with more ``--steps`` resumes where this one ended.  Loss, lr
and tokens/s are logged every ``--log-every`` steps, the only host reads
of the metrics.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import SHAPES, ShapeConfig, all_configs, get_config
from repro_torch.models import lm
from repro_torch.train import (OptConfig, checkpoint, data,
                               fault_tolerance as ft, init_opt_state,
                               make_train_step)

log = logging.getLogger("repro_torch.launch.train")


def init_state(cfg, device, seed: int = 0) -> dict:
    """Fresh params (``lm.init_params`` from ``seed``) and optimizer state
    on ``device``; on ``meta`` a skeleton of shapes and dtypes only."""
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    params = lm.init_params(cfg, gen.manual_seed(seed), dev)
    return {"params": params, "opt": init_opt_state(params)}


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

    logging.basicConfig(level=logging.INFO)
    if args.mesh != "host":
        raise SystemExit(f"--mesh {args.mesh}: repro_torch trains on one "
                         f"device ('host'); the production meshes come "
                         f"with distribution (ROADMAP Queue 1 item 5)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    shape = SHAPES[args.shape]
    seq = args.seq_len or (64 if args.smoke else shape.seq_len)
    gbs = args.global_batch or (8 if args.smoke else shape.global_batch)
    log.info("device %s | arch %s (%.2fB params) | %d x %d tokens a step",
             dev, cfg.name, cfg.param_count() / 1e9, gbs, seq)

    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(1, args.steps // 20))
    step = make_train_step(cfg, opt_cfg, num_microbatches=args.microbatches,
                           loss_chunk=min(1024, seq))
    fcfg = ft.FaultConfig(ckpt_dir=args.ckpt_dir or os.path.join(
        "build", "train_ckpt", cfg.name), ckpt_every=args.ckpt_every)
    state, extra, start = ft.resume_or_init(
        fcfg, lambda: init_state(cfg, dev), like=init_state(cfg, "meta"),
        device=dev)
    pipe = data.make_pipeline(cfg, ShapeConfig(shape.name, seq, gbs,
                                               shape.kind))
    if extra.get("data"):
        pipe.restore(extra["data"])

    t0 = time.perf_counter()

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def on_metrics(s, m):
        if (s + 1) % args.log_every == 0:
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
