"""Canonical result conventions shared by every backend (a port of
``repro.cpm.semantics``).

  * substring matches are reported at **start** addresses; the raw
    end-address view is one converter away (`ends_to_starts`);
  * sliding-window ops (template match) report every start whose window
    fits: tail positions ``p > used_len - m`` are masked (`window_valid`);
  * stencils default to zero padding at the row ends (``wrap=False``);
  * global limits pad with the reduction's identity (`limit_identity`);
  * ``maximum`` / ``minimum`` are ``jnp.maximum`` / ``jnp.minimum``: NaN
    wins (the first NaN operand is returned) and -0.0 < +0.0, so every
    backend and kernel combines signed zeros the same way whatever the
    order (``torch.maximum`` returns its first operand on a tie).
"""

from __future__ import annotations

import torch

from ._tensor import asarray


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def ends_to_starts(ends: torch.Tensor, m: int) -> torch.Tensor:
    """Match-*end* flags -> match-*start* flags for an m-item needle."""
    n = ends.shape[-1]
    starts = torch.roll(ends, -(m - 1), dims=-1)
    return starts & (_arange(n, ends) <= n - m)


def window_valid(n: int, m: int, used_len=None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Position ``p`` is valid iff ``p + m <= used_len`` (a per-batch
    ``used_len`` broadcasts against a trailing address axis)."""
    used = asarray(n if used_len is None else used_len, device=device)
    idx = torch.arange(n, dtype=torch.int32, device=used.device)
    return idx + m <= (used[..., None] if used.ndim else used)


def limit_identity(dtype: torch.dtype, mode: str):
    """Identity element of the §7.5 global-limit reduction for ``dtype``
    (the one fill every backend pads with).  As in the JAX package,
    only integer types get integer limits: bool takes the float ones."""
    if dtype.is_floating_point or dtype == torch.bool:
        return -float("inf") if mode == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if mode == "max" else info.max


def mask_window_tail(out: torch.Tensor, m: int, used_len=None,
                     fill=float("inf")) -> torch.Tensor:
    """Mask sliding-window results at invalid tail starts with ``fill``."""
    valid = window_valid(out.shape[-1], m, used_len, device=out.device)
    return torch.where(valid, out, torch.tensor(fill, dtype=out.dtype,
                                                device=out.device))


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``: NaN wins, and ``max(-0.0, +0.0)`` is +0.0."""
    if not a.dtype.is_floating_point:
        return torch.maximum(a, b)
    take_a = torch.isnan(a) | (((a > b) | ((a == b) & ~torch.signbit(a)))
                               & ~torch.isnan(b))
    return torch.where(take_a, a, b)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum``: NaN wins, and ``min(-0.0, +0.0)`` is -0.0."""
    if not a.dtype.is_floating_point:
        return torch.minimum(a, b)
    take_a = torch.isnan(a) | (((a < b) | ((a == b) & torch.signbit(a)))
                               & ~torch.isnan(b))
    return torch.where(take_a, a, b)


def limit_reduce(x: torch.Tensor, mode: str, dim: int = -1) -> torch.Tensor:
    """``jnp.max`` / ``jnp.min`` along ``dim`` with the combine rule of
    :func:`maximum` / :func:`minimum` (NaN wins; a zero result is +0.0
    under max if any +0.0 is there, -0.0 under min if any -0.0 is), which
    no order of combining changes."""
    red = torch.amax if mode == "max" else torch.amin
    out = red(x, dim=dim)
    if not x.dtype.is_floating_point:
        return out
    zero = x == 0
    want_pos = mode == "max"
    found = (zero & (torch.signbit(x) != want_pos)).any(dim=dim)
    signed = torch.zeros((), dtype=x.dtype, device=x.device)
    signed = signed if want_pos else -signed
    return torch.where((out == 0) & found, signed, out)
