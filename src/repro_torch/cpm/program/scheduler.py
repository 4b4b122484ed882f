"""The fusing scheduler and the whole-program cycle-cost model (a port of
``repro.cpm.program.scheduler``).

``schedule`` partitions an instruction stream into :class:`FusionGroup`\\ s
by the op table's ``fusable`` flag: maximal runs of elementwise/local ops
fuse into one group — on the cuda backend ONE ``fused_stream`` kernel
launch that keeps the row resident across the group — and everything else
is a ``boundary`` group of one instruction.

Fusing is *cost-aware* when the caller supplies the device: each fusable
run is priced both ways by the launch/byte model of
:mod:`~repro_torch.cpm.program.costmodel` (calibrated on the card, or
priors), and a run predicted slower fused becomes an ``eager`` group
(per-op dispatch on the per-op kernels, same instructions, bit-identical
results).  The verdict rides in ``FusionGroup.decision`` and shows in
``describe()`` / ``steps_report()``.  Without a device every fusable run
fuses (the launch-bound default), and on the ``reference`` backend no
decision is made.

The cycle model sums the ``OP_TABLE`` concurrent-step formulas per
instruction.  ``scan_structured_steps`` restricts the sum to the ops
whose JAX reference lowering is a literal ``lax.scan``; the port's
reference counts those loops' trips (``cpm.reference.trips``), which
``obs.cycles.audit`` holds to it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..optable import fusable_ops, op_steps
from .ir import DERIVED_METHODS as _DERIVED
from .ir import CPMProgram, Instruction

#: methods whose reference lowering is a literal scan over concurrent
#: steps in the JAX package (a counted trip loop in the port's)
_SCAN_STRUCTURED = ("substring_match", "find_all", "template_match",
                    "super_sum", "super_limit")


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
    if instr.op in ("substring_match", "find_all"):
        return _operand_len(ops["needle"])
    if instr.op == "histogram":
        return _operand_len(ops["edges"]) - 1
    if instr.op == "template_match":
        return _operand_len(ops["template"])
    if instr.op == "stencil":
        return len(ops["taps"])
    return 0


def instruction_steps(instr: Instruction, n: int,
                      section: int | None = None) -> int:
    """Concurrent-step count of one instruction at device size ``n``
    (bound-checked against the paper's ceiling by ``op_steps``)."""
    if instr.op == "sort" and instr.operands.get("steps") is not None:
        return int(instr.operands["steps"])   # bounded local exchange phase
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


def scan_structured_steps(prog: CPMProgram, n: int) -> int:
    """Predicted cycles of the scan-lowered instructions only (the Rule-6
    drain of a derived method is not a scan trip)."""
    return sum(instruction_steps(i, n) - (1 if i.op in _DERIVED else 0)
               for i in prog if i.op in _SCAN_STRUCTURED)


# ---------------------------------------------------------------------------
# fusion groups
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusionGroup:
    kind: str                         # "fused" | "eager" | "boundary"
    indices: tuple[int, ...]          # instruction positions in the program
    instructions: tuple[Instruction, ...]
    #: the cost model's verdict for this run (None when scheduling was not
    #: cost-aware): {"fuse", "fused_us", "eager_us", "params"}
    decision: dict | None = field(default=None, compare=False)

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

    def predicted_steps(self, n: int, section: int | None = None) -> int:
        return program_steps(self.program, n, section=section)

    def describe(self) -> str:
        lines = [f"CPMProgram: {len(self.program)} instructions -> "
                 f"{len(self.groups)} groups "
                 f"({self.fused_group_count} fused)"]
        for g in self.groups:
            tag = {"fused": "1 fused_stream launch",
                   "eager": "per-op dispatch (cost model)"}.get(
                       g.kind, "per-op dispatch")
            cost = ""
            if g.decision is not None:
                cost = (f"  fused {g.decision['fused_us']:.2f}us vs "
                        f"eager {g.decision['eager_us']:.2f}us "
                        f"[{g.decision['params']}]")
            lines.append(f"  {g.kind:8s} {list(g.indices)} "
                         f"[{' -> '.join(i.op for i in g.instructions)}]  "
                         f"({tag}){cost}")
        return "\n".join(lines)

    def steps_report(self, n: int, section: int | None = None) -> dict:
        """The cycle model plus the schedule's fuse/eager verdicts."""
        report = self.program.steps_report(n, section=section)
        report["schedule"] = [
            {"kind": g.kind,
             "ops": [i.op for i in g.instructions],
             "decision": g.decision}
            for g in self.groups]
        return report

    def run(self, array, backend: str | None = None):
        from . import executors
        return executors.run_plan(self, array, backend=backend)


def _device_geometry(device) -> tuple[int, int, int]:
    """(rows, n, itemsize) of anything CPMArray-shaped."""
    lead = device.batch_shape
    rows = math.prod(lead) if lead else 1
    return rows, device.n, device.data.element_size()


def schedule(prog: CPMProgram, device=None, *, backend: str | None = None,
             cost=None) -> FusionPlan:
    """Greedy linear partition: maximal fusable runs, reductions as walls.

    With ``device`` (a ``CPMArray``) the partition is cost-aware on the
    cuda backend: each fusable run fuses only when the launch/byte model
    predicts the single ``fused_stream`` launch beats eager per-op
    dispatch there — otherwise the run becomes an ``eager`` group
    (identical per-op execution, decision recorded).  ``backend``
    defaults to the device's own (``auto`` resolves by the rule
    ``run_plan`` uses); ``cost`` takes an explicit
    :class:`~repro_torch.cpm.program.costmodel.CostParams` (tests,
    what-if scheduling) in place of the calibrated coefficients or the
    priors.  On the reference backend no decision is made.

    Without ``device``, every fusable run fuses — the launch-bound
    default, and the only safe answer with no geometry to price.
    """
    params = None
    geometry = None
    lead, dtype, where = (), None, None
    if device is not None or cost is not None:
        from . import costmodel            # circular at module load time
        bk = backend or (device.backend if device is not None else "cuda")
        if bk == "auto" and device is not None:
            from .. import backends as B
            bk = B.auto_backend_name(device.data)   # same rule as run_plan
        if bk == "cuda" and device is not None:
            geometry = _device_geometry(device)
            lead, dtype, where = (device.batch_shape, device.dtype,
                                  device.device)
            params = cost if cost is not None \
                else costmodel.params_for(where)

    fus = fusable_ops()
    groups: list[FusionGroup] = []
    run: list[int] = []

    def flush():
        if not run:
            return
        instrs = tuple(prog.instructions[i] for i in run)
        kind, decision = "fused", None
        if params is not None:
            rows, n, itemsize = geometry
            decision = costmodel.decide(instrs, rows, n, itemsize, params,
                                        lead=lead, dtype=dtype,
                                        device=where)
            kind = "fused" if decision["fuse"] else "eager"
        groups.append(FusionGroup(kind, tuple(run), instrs, decision))
        run.clear()

    for i, ins in enumerate(prog.instructions):
        if ins.op in fus:
            run.append(i)
        else:
            flush()
            groups.append(FusionGroup("boundary", (i,), (ins,)))
    flush()
    return FusionPlan(prog, tuple(groups))
