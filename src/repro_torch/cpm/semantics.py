"""Canonical result conventions shared by every backend (a port of
``repro.cpm.semantics``).

  * substring matches are reported at **start** addresses; the raw
    end-address view is one converter away (`ends_to_starts`);
  * sliding-window ops (template match) report every start whose window
    fits: tail positions ``p > used_len - m`` are masked (`window_valid`);
  * stencils default to zero padding at the row ends (``wrap=False``).
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


def mask_window_tail(out: torch.Tensor, m: int, used_len=None,
                     fill=float("inf")) -> torch.Tensor:
    """Mask sliding-window results at invalid tail starts with ``fill``."""
    valid = window_valid(out.shape[-1], m, used_len, device=out.device)
    return torch.where(valid, out, torch.tensor(fill, dtype=out.dtype,
                                                device=out.device))
