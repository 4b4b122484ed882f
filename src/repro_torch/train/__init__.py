"""Training (a port of ``repro.train``): AdamW, the microbatched train
step with remat, the synthetic token stream, atomic checkpoints and the
fault-tolerant loop.  On the card by default; ``device="cpu"`` for the
tests."""

from . import checkpoint, data, fault_tolerance, optimizer, train_step
from .optimizer import OptConfig, apply_updates, init_opt_state
from .train_step import make_eval_step, make_train_step

__all__ = ["optimizer", "train_step", "data", "checkpoint", "fault_tolerance",
           "OptConfig", "init_opt_state", "apply_updates", "make_train_step",
           "make_eval_step"]
