"""The training step (a port of ``repro.train.train_step``): microbatched
gradient accumulation, the remat forward, the AdamW update.

JAX differentiates a pure loss with ``jax.value_and_grad`` and scans the
microbatches; here each microbatch's loss is differentiated by
``backward()`` into the params' ``.grad``, which accumulates in float32
in microbatch order (``((0 + g1) + g2) + ...``, JAX's scan sum), is
divided by the count and is freed after the update.  Params must be leaf
tensors; they require grad only during the step.

Data parallelism (JAX's GSPMD reduction): with ``DTensor`` params
(``sharding.distribute_params``) each rank runs its own batch rows, cut
into the microbatches in order (microbatch ``i`` of the global batch is
every data rank's ``i``-th, in coordinate order), on views of its blocks;
``compute_view``'s backward reduce-scatters each weight's gradient over
the data axes inside every microbatch's backward (JAX's per-microbatch
sync), so the block's ``.grad`` accumulates reduced gradients in float32
in microbatch order.  The rows go by the data coordinate: the ranks of
one model group (one data coordinate) hold the same rows, and loss and
metrics, the same on each of them, are averaged over the data ranks
only.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import lm
from . import optimizer as opt
from ._tree import leaves_with_path


def _microbatches(batch: dict, k: int) -> list[dict]:
    """``k`` microbatches: every key split on axis 0, ``pos_ids`` (3, B, S)
    on axis 1, in order."""
    def split(x, axis):
        b = x.shape[axis]
        assert b % k == 0, f"batch {b} % microbatches {k}"
        return torch.split(x, b // k, dim=axis)

    parts = {key: split(v, 1 if key == "pos_ids" else 0)
             for key, v in batch.items()}
    return [{key: p[i] for key, p in parts.items()} for i in range(k)]


def loss_and_grads(params, cfg: ModelConfig, batch: dict, *,
                   num_microbatches: int = 1, remat: bool = True,
                   loss_chunk: int = 1024):
    """The train step's gradient half: ``(loss, metrics, grads)`` of
    ``lm.loss_fn`` over ``num_microbatches`` microbatches, the gradients a
    float32 tree shaped as ``params`` (the microbatches' sum divided by
    their count, as JAX's scan), loss and metrics the microbatches' means
    as 0-d device tensors.  ``params`` must be leaf tensors: they require
    grad for the call (their flags are restored on return, so the same
    tensors serve without autograd after) and their ``.grad`` is the
    accumulator, cleared on return.  Of ``DTensor`` params the local
    blocks are those leaves, the gradients ``DTensor``s of the params'
    placements, reduced over the data axes (module docstring), and loss
    and metrics the data ranks' means (``batch``: this data coordinate's
    rows, the same on every model rank)."""
    k = num_microbatches
    dist = any(sharding.is_distributed(p) for _, p in
               leaves_with_path(params))
    flat = [sharding.local(p) for _, p in leaves_with_path(params)]
    dev = flat[0].device
    batch = {key: torch.as_tensor(v).to(dev) for key, v in batch.items()}
    flags = [p.requires_grad for p in flat]
    for p in flat:
        p.requires_grad_(True)
        p.grad = None
    losses, ms = [], []
    for mb in (_microbatches(batch, k) if k > 1 else [batch]):
        view = lm.tree_map(_view, params) if dist else params
        loss, m = lm.loss_fn(view, cfg, mb, remat=remat,
                             loss_chunk=loss_chunk)
        loss.backward()
        losses.append(loss.detach())
        ms.append({key: v.detach() for key, v in m.items()})
    grads = lm.tree_map(_grad, params)
    for p, flag in zip(flat, flags):
        p.grad = None
        p.requires_grad_(flag)
    loss, metrics = losses[0], ms[0]
    if k > 1:
        # true divisions by a device scalar (a host scalar divides by its
        # reciprocal on the card)
        kk = torch.full((), float(k), device=dev)
        for x in losses[1:]:
            loss = loss + x
        loss = loss / kk
        for _, g in leaves_with_path(grads):
            sharding.local(g).div_(kk)
        metrics = {key: torch.mean(torch.stack([m[key] for m in ms]))
                   for key in ms[0]}
    if dist:
        loss, metrics = _dp_means(loss, metrics)
    return loss, metrics, grads


def _view(p):
    """A ``DTensor`` of ``p``'s placements over its local block, through
    which autograd reaches the block (one a microbatch: a graph's nodes
    serve one backward)."""
    if not sharding.is_distributed(p):
        return p
    return type(p).from_local(sharding.local(p), p.device_mesh, p.placements,
                              run_check=False)


def _grad(p):
    """The accumulated gradient of a param (zeros where none reached it),
    a ``DTensor`` of its placements for a ``DTensor`` param."""
    b = sharding.local(p)
    g = torch.zeros_like(b) if b.grad is None else b.grad
    if not sharding.is_distributed(p):
        return g
    return type(p).from_local(g, p.device_mesh, p.placements,
                              run_check=False)


@torch.no_grad()
def _dp_means(loss, metrics: dict):
    """Loss and metrics averaged over the data ranks, in one all-reduce
    (the model ranks of a data coordinate hold the same values).  Each
    rank's loss is the mean over its own rows, and every rank holds as
    many rows of as many tokens, so the mean of the ranks' means is the
    global batch's mean exactly (up to rounding)."""
    keys = list(metrics)
    vec = sharding.dp_mean(torch.stack([loss, *(metrics[k] for k in keys)]))
    return vec[0], dict(zip(keys, vec[1:]))


def make_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig,
                    num_microbatches: int = 1, remat: bool = True,
                    loss_chunk: int = 1024):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``batch`` a dict of tensors (or arrays) moved
    to the params' device; ``metrics`` holds ``loss``, ``ce``, ``aux``,
    ``lr`` and ``grad_norm`` as 0-d device tensors (nothing read back to
    the host).  Params and moments are updated in place."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(
            params, cfg, batch, num_microbatches=num_microbatches,
            remat=remat, loss_chunk=loss_chunk)
        params, opt_state, om = opt.apply_updates(params, grads, opt_state,
                                                  opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def make_eval_step(cfg: ModelConfig, loss_chunk: int = 1024):
    @torch.no_grad()
    def eval_step(params, batch):
        leaves = [p for _, p in leaves_with_path(params)]
        dev = sharding.local(leaves[0]).device
        batch = {key: torch.as_tensor(v).to(dev) for key, v in batch.items()}
        loss, metrics = lm.loss_fn(params, cfg, batch, remat=False,
                                   loss_chunk=loss_chunk)
        if any(sharding.is_distributed(p) for p in leaves):
            loss, metrics = _dp_means(loss, metrics)
        return dict(metrics, loss=loss)
    return eval_step
