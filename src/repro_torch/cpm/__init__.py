"""repro_torch.cpm — the paper's memory device behind one operator surface
(the slice of ``repro.cpm`` that the serving commit path needs).

  * :class:`CPMArray` / :func:`cpm_array` — a physical buffer plus its
    §4.2 ``used_len`` register; every op dispatches to a backend.
  * ``backends`` — ``reference`` (plain PyTorch) and ``cuda`` (Hopper
    kernels; this slice has its ``fused_stream``).
  * ``optable`` — the op registry with each op's concurrent-step formula
    (a verbatim copy of the JAX package's pure-Python table).
  * ``semantics`` — the canonical result conventions.
  * ``program`` — record, schedule and execute instruction streams.
"""

from . import backends, optable, program, reference, semantics
from .array import CPMArray, cpm_array
from .backends import get_backend
from .optable import OP_TABLE, fusable_ops, op_steps
from .program import CPMProgram, FusionPlan, record, schedule

__all__ = ["CPMArray", "cpm_array", "backends", "get_backend", "OP_TABLE",
           "op_steps", "fusable_ops", "optable", "CPMProgram", "FusionPlan",
           "record", "schedule", "program", "reference", "semantics"]
