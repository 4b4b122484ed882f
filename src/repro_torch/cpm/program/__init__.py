"""repro_torch.cpm.program — instruction streams as first-class values.

Record ``CPMArray`` method calls into a :class:`CPMProgram` (or build one
with :meth:`CPMProgram.append`), :func:`schedule` it into fusion groups,
and run the plan: on the cuda backend each fused group is ONE
``fused_stream`` kernel launch and each eager group (a fusable run the
cost model of :mod:`.costmodel` priced slower fused) replays op by op on
the per-op kernels; on the reference backend every instruction replays
unfused — bit-identical results.  The JAX package's jaxpr walker
(``introspect``) has no module here: the port counts loop trips with
``cpm.reference.trips`` and launches with ``kernels.ops.launch_counts``.
"""

from .ir import CPMProgram, Instruction, record
from .scheduler import (FusionGroup, FusionPlan, instruction_steps,
                        program_steps, scan_structured_steps, schedule)
from .executors import apply_instruction, run_plan
from .costmodel import CostParams, group_cost, roofline_params

__all__ = ["CPMProgram", "Instruction", "record", "FusionGroup",
           "FusionPlan", "schedule", "instruction_steps", "program_steps",
           "scan_structured_steps", "apply_instruction", "run_plan",
           "CostParams", "group_cost", "roofline_params"]
