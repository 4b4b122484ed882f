"""Fault-tolerant training loop: checkpoint / restart and heartbeat-based
straggler detection (a port of ``repro.train.fault_tolerance``).

Failure model: a process dies mid-step (survived by the atomic
checkpoint protocol of ``checkpoint.py``), stalls (flagged by the
per-step heartbeat deadline; the response is to restart and restore) or
comes back on another topology (elastic: checkpoints hold full arrays,
so a restore with ``shardings`` re-shards them onto the mesh running
now, any world size).  Under a process group every rank restores and
checkpoints (the gathers are collective); only rank 0 writes and logs.
The JAX ``FaultConfig`` field ``max_restarts``, which nothing reads, is
left out.
"""

from __future__ import annotations

import dataclasses
import logging
import time

from . import checkpoint

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    step_deadline_s: float = 0.0       # 0 = no straggler deadline (CPU tests)


class Heartbeat:
    """Per-step liveness record.  A cluster-side monitor restarts ranks
    whose heartbeat age exceeds the deadline; here the same signal flags
    straggling steps locally."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self.last = time.monotonic()
        self.straggler_steps: list[int] = []

    def beat(self, step: int) -> bool:
        now = time.monotonic()
        late = self.deadline_s > 0 and (now - self.last) > self.deadline_s
        if late:
            self.straggler_steps.append(step)
            log.warning("straggler: step %d took %.1fs (deadline %.1fs)",
                        step, now - self.last, self.deadline_s)
        self.last = now
        return late


def resume_or_init(fcfg: FaultConfig, init_fn, like=None, device=None,
                   shardings=None):
    """Restore the latest complete checkpoint or initialize fresh.

    Returns ``(state_tree, extra, start_step)``.  ``init_fn()`` builds the
    fresh state.  ``like`` is the restore skeleton: a tree of tensors or
    of shapes and dtypes (a ``meta``-device init, with ``device`` naming
    where the leaves go), so that resuming builds the state once.
    Without it the fresh state is built and serves as the skeleton (JAX
    uses ``jax.eval_shape``, which builds nothing).  ``shardings``
    (``checkpoint.restore``'s) puts each rank's block of each leaf on its
    device."""
    step = checkpoint.latest_step(fcfg.ckpt_dir)
    if step is None:
        return init_fn(), {}, 0
    like = like if like is not None else init_fn()
    state, extra = checkpoint.restore(fcfg.ckpt_dir, step, like, device,
                                      shardings)
    if checkpoint.writes():
        log.info("restored checkpoint step %d from %s", step,
                 fcfg.ckpt_dir)
    return state, extra, step


def run_loop(fcfg: FaultConfig, state, step_fn, data_iter, start_step: int,
             num_steps: int, on_metrics=None):
    """Drive ``num_steps`` of ``step_fn(state, batch) -> (state, metrics)``
    with periodic async checkpointing and a heartbeat."""
    hb = Heartbeat(fcfg.step_deadline_s)
    pending = None
    for step in range(start_step, num_steps):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        hb.beat(step)
        if on_metrics is not None:
            on_metrics(step, metrics)
        if fcfg.ckpt_every and (step + 1) % fcfg.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = checkpoint.save(
                fcfg.ckpt_dir, step + 1, state,
                extra={"data": data_iter.state()}, async_=True)
            checkpoint.gc_old(fcfg.ckpt_dir, fcfg.keep)
    if pending is not None:
        pending.join()
    return state, hb
