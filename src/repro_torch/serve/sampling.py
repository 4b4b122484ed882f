"""Sampling via content-comparable primitives (a port of
``repro.serve.sampling``'s static-batch part).

Greedy is the argmax (first maximal index on ties, as in ``jnp``).
Sampling draws from an explicit ``torch.Generator``; it gives other
numbers than ``jax.random`` from the same seed, so sampled rows are held
by distribution, greedy rows token for token."""

from __future__ import annotations

import torch

from repro_torch.cpm.reference import comparable


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
