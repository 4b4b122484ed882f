"""AdamW with fully sharded (ZeRO-3) states, a cosine schedule and
global-norm clipping (a port of ``repro.train.optimizer``): float32
throughout, in JAX's order of operations.  ``mu`` and ``nu`` take the
params' placements: a ``DTensor`` param (``sharding.distribute_params``)
gets ``DTensor`` moments holding the same block, a plain one plain
moments on its device.

:func:`apply_updates` works in place under ``torch.no_grad()`` (JAX's
returns new arrays): params, ``mu`` and ``nu`` are updated leaf by leaf
on the rank's local blocks, so the step needs one leaf's temporaries on
top of the state, and it reads nothing back to the host.  The global
norm of distributed gradients sums the ranks' local sums of squares in
one all-reduce over the model axis and one over the data axes, a leaf
replicated over an axis counted once there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed import sharding
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


def _zeros_like(p):
    """Zeros shaped and placed as ``p`` (a ``DTensor`` of the same
    placements holding a zero block, for a ``DTensor``)."""
    if not sharding.is_distributed(p):
        return torch.zeros_like(p)
    return type(p).from_local(torch.zeros_like(sharding.local(p)),
                              p.device_mesh, p.placements, run_check=False)


def init_opt_state(params) -> dict:
    """Zero first and second moments shaped and placed as ``params``, and
    ``step``, an int32 0-d tensor on the params' device (the same on
    every rank)."""
    dev = sharding.local(leaves_with_path(params)[0][1]).device
    return {"mu": tree_map(_zeros_like, params),
            "nu": tree_map(_zeros_like, params),
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


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together.  Of ``DTensor`` leaves each
    rank squares its block; a leaf replicated over the model axis counts
    on model coordinate 0 only and one all-reduce over the model axis
    sums the per-leaf terms, then a leaf replicated over the data axes
    counts on data coordinate 0 only and one all-reduce over them sums
    them, before they are added in leaf order."""
    leaves = [x for _, x in leaves_with_path(tree)]
    sums = [torch.sum(torch.square(sharding.local(x).float()))
            for x in leaves]
    if not any(sharding.is_distributed(x) for x in leaves):
        return torch.sqrt(torch.sum(torch.stack(sums)))
    if sharding.current_ctx().mesh is None:
        raise ValueError("distributed leaves need the sharding context "
                         "of their mesh (sharding.use_sharding)")
    if sharding.dp_rank():
        sums = [s if sharding.dp_sharded(x) else torch.zeros_like(s)
                for s, x in zip(sums, leaves)]
    if sharding.model_rank():
        sums = [s if sharding.model_sharded(x) else torch.zeros_like(s)
                for s, x in zip(sums, leaves)]
    vec = torch.stack(sums)
    if sharding.model_parallel():
        vec = sharding.model_sum(vec)
    return torch.sqrt(torch.sum(sharding.dp_sum(vec)))


def _clip_scale(norm, max_norm: float):
    """``min(1, max_norm / max(norm, 1e-9))`` on the device (a true
    division by the norm, as JAX's)."""
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)

    def clip(g):
        if not sharding.is_distributed(g):
            return g * scale
        return type(g).from_local(sharding.local(g) * scale, g.device_mesh,
                                  g.placements, run_check=False)

    return tree_map(clip, grads), norm


_NO_DECAY = ("scale", "bias", "a_param", "w_input_gate", "norm")


def _decay_mask(path: str) -> bool:
    return not any(t in path for t in _NO_DECAY)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig):
    """One AdamW step, in place.  Returns ``(params, state, {"lr",
    "grad_norm"})``: the same param and moment tensors, updated, a new
    ``step`` and the metrics as 0-d device tensors.  The gradients are
    clipped leaf by leaf as they are used (the same products as clipping
    the whole tree first) and are not modified.  ``DTensor`` leaves
    (params, gradients, moments of the same placements) are updated
    through their local blocks."""
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
        p, g, mu, nu = (sharding.local(x) for x in (p, g, mu, nu))
        g = g.float() * scale
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(torch.square(g) * (1 - b2))
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path):
            upd = upd + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
    state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, state, {"lr": lr, "grad_norm": gnorm}
