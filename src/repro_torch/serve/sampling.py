"""Sampling via content-comparable primitives (a port of
``repro.serve.sampling``).

Greedy is the argmax (first maximal index on ties, as in ``jnp``).
Sampling draws from an explicit ``torch.Generator``; it gives other
numbers than ``jax.random`` from the same seed, so sampled rows are held
by distribution, greedy rows token for token."""

from __future__ import annotations

import torch

from repro_torch.cpm.reference import comparable
from repro_torch.distributed import sharding


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    return comparable.topk_mask(logits, k)


def top_p_mask(probs: torch.Tensor, p: float, iters: int = 20):
    """Smallest prob threshold t with sum(probs[probs >= t]) >= p, by
    bisection — each iteration one concurrent compare + masked sum."""
    b = probs.shape[:-1]
    lo = torch.zeros(b, dtype=probs.dtype, device=probs.device)
    hi = torch.ones(b, dtype=probs.dtype, device=probs.device)
    for _ in range(iters):
        mid = (lo + hi) / 2
        mass = torch.where(probs >= mid[..., None], probs, 0.0).sum(-1)
        ok = mass >= p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return probs >= lo[..., None]


def sample(logits: torch.Tensor, generator: torch.Generator | None = None,
           temperature: float = 1.0, top_k: int = 0,
           top_p: float = 0.0) -> torch.Tensor:
    """Batched token sampling with CPM-style truncation masks."""
    logits = logits.float()
    if temperature <= 0:
        return greedy(logits)
    logits = logits / temperature
    if top_k:
        logits = torch.where(top_k_mask(logits, top_k), logits, -torch.inf)
    if top_p:
        probs = torch.softmax(logits, -1)
        logits = torch.where(top_p_mask(probs, top_p), logits, -torch.inf)
    probs = torch.softmax(logits, -1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)


def sample_rows(logits: torch.Tensor, generator: torch.Generator | None,
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """Per-row sampling for pooled decode: each row of ``logits`` (B, V)
    carries its own ``temperature`` / ``top_k`` / ``top_p`` ((B,) tensors
    from per-request GenConfigs).  Rows with ``temperature <= 0`` take the
    greedy argmax, bit-identical to :func:`greedy`; ``top_k <= 0`` /
    ``top_p <= 0`` disable that truncation for the row.  The draw is
    Gumbel-max over ``generator``'s uniforms (the form of
    ``jax.random.categorical``), so it reads nothing back to the host."""
    logits = logits.float()
    b, v = logits.shape
    t = torch.where(temperature > 0, temperature, 1.0).float()
    x = logits / t[:, None]
    k = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v).long()
    kth = torch.sort(x, dim=-1, descending=True).values.gather(
        -1, k[:, None] - 1)
    x = torch.where(x >= kth, x, -torch.inf)
    p = torch.where(top_p > 0, top_p, 1.0).float()
    x = torch.where(top_p_mask(torch.softmax(x, -1), p), x, -torch.inf)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    sampled = torch.argmax(x + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy(logits))


def shared_draw(tok: torch.Tensor) -> torch.Tensor:
    """A sampled token the same on every rank of a "model" axis: model
    rank 0's draw, summed over the axis with the other ranks' zeros, since
    each rank draws from its own generator.  ``tok`` itself without a
    model axis longer than 1."""
    if sharding.model_size() <= 1:
        return tok
    mine = sharding.model_rank() == 0
    return sharding.model_sum(tok if mine else torch.zeros_like(tok))
