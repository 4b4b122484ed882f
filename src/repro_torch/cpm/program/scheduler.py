"""The fusing scheduler and the whole-program cycle-cost model (a port of
the fuse-all branch of ``repro.cpm.program.scheduler``).

``schedule`` partitions an instruction stream into :class:`FusionGroup`\\ s
by the op table's ``fusable`` flag: maximal runs of elementwise/local ops
fuse into one group — on the cuda backend ONE ``fused_stream`` kernel
launch that keeps the row resident across the group — and everything else
is a ``boundary`` group of one instruction.  The JAX package's cost-aware
branch (``schedule(prog, device=...)``, pricing each run with a
calibrated launch/byte model) waits for the port of ``costmodel`` and
``tuning`` (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..optable import fusable_ops, op_steps
from .ir import DERIVED_METHODS as _DERIVED
from .ir import CPMProgram, Instruction


def _operand_len(v) -> int:
    shape = getattr(v, "shape", None)
    if shape is None:
        shape = np.shape(v)
    if len(shape) == 0:
        raise ValueError(f"expected a vector operand, got scalar {v!r}")
    return int(shape[-1])


def _instr_m(instr: Instruction) -> int:
    """The op-specific size M, read from the recorded operand shapes."""
    ops = instr.operands
    if instr.op == "substring_match":
        return _operand_len(ops["needle"])
    if instr.op == "template_match":
        return _operand_len(ops["template"])
    if instr.op == "stencil":
        return len(ops["taps"])
    return 0


def instruction_steps(instr: Instruction, n: int,
                      section: int | None = None) -> int:
    """Concurrent-step count of one instruction at device size ``n``
    (bound-checked against the paper's ceiling by ``op_steps``)."""
    table_op = _DERIVED.get(instr.op, instr.op)
    extra = 1 if instr.op in _DERIVED else 0  # the Rule-6 count/drain step
    sec = instr.operands.get("section")
    if sec is None:
        sec = section
    if sec is not None and sec < 1:
        raise ValueError(f"{instr.op}: section must be >= 1, got {sec!r}")
    return op_steps(table_op, n=n, m=_instr_m(instr), section=sec) + extra


def program_steps(prog: CPMProgram, n: int,
                  section: int | None = None) -> int:
    """Total predicted concurrent cycles of the whole stream."""
    return sum(instruction_steps(i, n, section=section) for i in prog)


@dataclass(frozen=True)
class FusionGroup:
    kind: str                         # "fused" | "boundary"
    indices: tuple[int, ...]          # instruction positions in the program
    instructions: tuple[Instruction, ...]

    def __repr__(self):
        body = "; ".join(i.op for i in self.instructions)
        return f"<{self.kind} [{body}]>"


@dataclass(frozen=True)
class FusionPlan:
    program: CPMProgram
    groups: tuple[FusionGroup, ...]

    @property
    def fused_group_count(self) -> int:
        return sum(g.kind == "fused" for g in self.groups)

    def describe(self) -> str:
        lines = [f"CPMProgram: {len(self.program)} instructions -> "
                 f"{len(self.groups)} groups "
                 f"({self.fused_group_count} fused)"]
        for g in self.groups:
            tag = ("1 fused_stream launch" if g.kind == "fused"
                   else "per-op dispatch")
            lines.append(f"  {g.kind:8s} {list(g.indices)} "
                         f"[{' -> '.join(i.op for i in g.instructions)}]  "
                         f"({tag})")
        return "\n".join(lines)

    def run(self, array, backend: str | None = None):
        from . import executors
        return executors.run_plan(self, array, backend=backend)


def schedule(prog: CPMProgram) -> FusionPlan:
    """Greedy linear partition: maximal fusable runs, everything else a
    boundary (the JAX package's fuse-all default)."""
    fus = fusable_ops()
    groups: list[FusionGroup] = []
    run: list[int] = []

    def flush():
        if run:
            groups.append(FusionGroup(
                "fused", tuple(run),
                tuple(prog.instructions[i] for i in run)))
            run.clear()

    for i, ins in enumerate(prog.instructions):
        if ins.op in fus:
            run.append(i)
        else:
            flush()
            groups.append(FusionGroup("boundary", (i,), (ins,)))
    flush()
    return FusionPlan(prog, tuple(groups))
