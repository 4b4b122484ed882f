"""repro_torch.cpm.program — instruction streams as first-class values.

Record ``CPMArray`` method calls into a :class:`CPMProgram` (or build one
with :meth:`CPMProgram.append`), :func:`schedule` it into fusion groups,
and run the plan: on the cuda backend each fused group is ONE
``fused_stream`` kernel launch, on the reference backend every
instruction replays unfused — bit-identical results.
"""

from .ir import CPMProgram, Instruction, record
from .scheduler import (FusionGroup, FusionPlan, instruction_steps,
                        program_steps, schedule)
from .executors import apply_instruction, run_plan

__all__ = ["CPMProgram", "Instruction", "record", "FusionGroup",
           "FusionPlan", "schedule", "instruction_steps", "program_steps",
           "apply_instruction", "run_plan"]
