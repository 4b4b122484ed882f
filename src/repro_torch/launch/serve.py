"""Serving entry point: batched generation with prompt-lookup speculative
decoding, on the card by default.

    python -m repro_torch.launch.serve --arch granite-8b --batch 4 \\
        --prompt-len 256 --max-new 64 --spec 4
    python -m repro_torch.launch.serve --arch granite-8b --smoke --device cpu

Weights are random, drawn from ``--seed``; prompts repeat a seeded n-gram
so that prompt-lookup drafts find matches.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve import Engine, GenConfig


def repeated_prompts(batch: int, prompt_len: int, vocab: int, seed: int,
                     period: int = 7, device="cpu") -> torch.Tensor:
    """(batch, prompt_len) int32 prompts, each a seeded random n-gram of
    ``period`` tokens repeated."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randint(0, vocab, (batch, period), generator=g,
                         dtype=torch.int32)
    reps = -(-prompt_len // period)
    return base.repeat(1, reps)[:, :prompt_len].to(device)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny same-family config (cfg.smoke())")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--spec", type=int, default=0,
                    help="prompt-lookup draft length (greedy only)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    # the commit runs through the fused_stream kernel on a GPU
    backend = "cuda" if dev.type == "cuda" else "reference"
    gen_ = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen_, dev)
    slack = 8 + 4 * args.spec
    engine = Engine(cfg, params, max_len=args.prompt_len + args.max_new
                    + slack, cpm_backend=backend)
    tokens = repeated_prompts(args.batch, args.prompt_len, cfg.vocab_size,
                              args.seed + 1, device=dev)
    gen = GenConfig(max_new_tokens=args.max_new,
                    temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p, ngram_spec=args.spec)
    _sync(dev)
    t0 = time.perf_counter()
    out, stats = engine.generate(
        {"tokens": tokens}, gen,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 2))
    _sync(dev)
    dt = time.perf_counter() - t0
    new = args.batch * args.max_new
    print(f"{cfg.name} on {dev}: generated {new} tokens in {dt:.3f}s "
          f"({new / dt:.1f} tok/s)")
    if stats["proposed"]:
        print(f"spec decode: {stats['rounds']} rounds, {stats['accepted']}/"
              f"{stats['proposed']} draft tokens accepted "
              f"(rate {stats['acceptance_rate']:.2f})")
    print(out[:, -args.max_new:].cpu().tolist())


if __name__ == "__main__":
    main()
