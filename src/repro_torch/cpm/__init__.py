"""repro_torch.cpm — the paper's memory device behind one operator surface
(the slice of ``repro.cpm`` that the serving paths need).

  * :class:`CPMArray` / :func:`cpm_array` — a physical buffer plus its
    §4.2 ``used_len`` register; every op dispatches to a backend.
  * ``backends`` — ``reference`` (plain PyTorch) and ``cuda`` (Hopper
    kernels: ``fused_stream`` and a per-op kernel for every op with a TPU
    kernel).
  * ``tuning`` — the autotune / calibration cache (the port's own JSON
    spill and ``REPRO_TORCH_CPM_*`` switches).
  * ``optable`` — the op registry with each op's concurrent-step formula
    (a verbatim copy of the JAX package's pure-Python table).
  * ``semantics`` — the canonical result conventions.
  * ``program`` — record, schedule (cost-aware on the cuda backend) and
    execute instruction streams.
  * ``pool`` — paged banks, the self-managing allocator and the
    multi-bank packer under the serving session pool.
"""

from . import backends, optable, program, reference, semantics, tuning
from .array import CPMArray, cpm_array
from .backends import get_backend
from .optable import OP_TABLE, fusable_ops, op_steps
from .program import CPMProgram, FusionPlan, record, schedule

__all__ = ["CPMArray", "cpm_array", "backends", "get_backend", "OP_TABLE",
           "op_steps", "fusable_ops", "optable", "CPMProgram", "FusionPlan",
           "record", "schedule", "program", "reference", "semantics",
           "tuning"]
