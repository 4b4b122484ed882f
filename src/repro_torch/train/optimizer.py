"""AdamW with a cosine schedule and global-norm clipping (a port of
``repro.train.optimizer``): float32 throughout, in JAX's order of
operations.  The JAX version's states inherit the params' sharding; here
they live on the params' device (distribution is ROADMAP Queue 1 item 5).

:func:`apply_updates` works in place under ``torch.no_grad()`` (JAX's
returns new arrays): params, ``mu`` and ``nu`` are updated leaf by leaf,
so the step needs one leaf's temporaries on top of the state, and it
reads nothing back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.lm import tree_map
from ._tree import leaves_with_path


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init_opt_state(params) -> dict:
    """Zero first and second moments shaped as ``params``, and ``step``, an
    int32 0-d tensor on the params' device."""
    dev = leaves_with_path(params)[0][1].device
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: OptConfig, step):
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``, as a
    float32 tensor of ``step``'s shape and device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float()))
              for _, x in leaves_with_path(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm, max_norm: float):
    """``min(1, max_norm / max(norm, 1e-9))`` on the device (a true
    division by the norm, as JAX's)."""
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


_NO_DECAY = ("scale", "bias", "a_param", "w_input_gate", "norm")


def _decay_mask(path: str) -> bool:
    return not any(t in path for t in _NO_DECAY)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig):
    """One AdamW step, in place.  Returns ``(params, state, {"lr",
    "grad_norm"})``: the same param and moment tensors, updated, a new
    ``step`` and the metrics as 0-d device tensors.  The gradients are
    clipped leaf by leaf as they are used (the same products as clipping
    the whole tree first) and are not modified."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    flat_g = [g for _, g in leaves_with_path(grads)]
    flat_mu = [m for _, m in leaves_with_path(state["mu"])]
    flat_nu = [n for _, n in leaves_with_path(state["nu"])]
    for (path, p), g, mu, nu in zip(leaves_with_path(params), flat_g,
                                    flat_mu, flat_nu):
        g = g.float() * scale
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(torch.square(g) * (1 - b2))
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path):
            upd = upd + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
    state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, state, {"lr": lr, "grad_norm": gnorm}
