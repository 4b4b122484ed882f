"""The CPM program IR and the method-call tracer (a port of
``repro.cpm.program.ir``).

A :class:`CPMProgram` is a linear stream of :class:`Instruction`\\ s over
ONE memory device: each instruction is a ``CPMArray`` method name plus its
*named* operands, captured at record time.  Inside ``with record() as
prog:`` every wrapped ``CPMArray`` method still returns its real value —
computed by the *reference* executor, so no kernel launches at record
time — while appending the instruction to ``prog``.  Nested internal calls
(``count`` -> ``compare``) record only the outermost method.

Scheduling lives in ``scheduler.py`` and execution in ``executors.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class Instruction:
    """One broadcast instruction: an op-table entry plus named operands."""

    op: str                           # CPMArray method name
    operands: dict[str, Any]          # parameter name -> value (arrays OK)

    def __repr__(self):  # operand values may be large tensors — keep it short
        args = ", ".join(f"{k}={_short(v)}" for k, v in self.operands.items())
        return f"{self.op}({args})"


def _short(v) -> str:
    shape = getattr(v, "shape", None)
    if shape is not None and shape != ():
        return f"<{str(v.dtype).removeprefix('torch.')}{list(shape)}>"
    return repr(v)


@dataclass
class CPMProgram:
    """A recorded (or hand-built) instruction stream over one device.

    The IR is strictly linear: instruction ``i+1`` applies to the device
    state instruction ``i`` left behind.  The recorder enforces this —
    calling a method on a stale receiver (anything but the current head of
    the stream) raises instead of silently replaying against the wrong
    state.  Operands are captured **by value** (standard trace
    semantics): re-running a plan on a *different* device reuses the recorded operand values, so an operand derived from
    a recorded intermediate result does not recompute for the new data.
    """

    instructions: list[Instruction] = field(default_factory=list)
    #: the device state the next recorded instruction must apply to
    _head: Any = field(default=None, repr=False, compare=False)

    def __len__(self):
        return len(self.instructions)

    def __iter__(self):
        return iter(self.instructions)

    def append(self, op: str, /, **operands) -> "CPMProgram":
        """Explicit builder: append one instruction (chainable).

        ``op`` is positional-only so operand keywords can never collide
        with it (``append("compare", datum=40, op="lt")`` works).  Operand
        names are validated against the recorded method's signature and
        defaults are applied, so explicitly built and traced programs
        lower identically.
        """
        sig = _SIGNATURES.get(op)
        if sig is not None:
            bound = sig.bind(None, **operands)      # None stands in for self
            bound.apply_defaults()
            operands = dict(bound.arguments)
            operands.pop("self")
        self.instructions.append(Instruction(op, operands))
        return self

    # -- whole-program cost model (delegates to the scheduler) --------------
    def steps_report(self, n: int, section: int | None = None) -> dict:
        """Per-instruction + total concurrent-step counts at device size
        ``n``, from the op table's formulas.

        Telemetry hook: every report also feeds the process-global cycle
        ledger (``repro_torch.obs.cycles``), so predicted cycles
        accumulate per op family next to the trips an audit measures.
        Host-side accounting only; ``REPRO_OBS=0`` skips it."""
        from repro_torch.obs import cycles

        from . import scheduler
        per = [(f"{i}:{ins.op}",
                scheduler.instruction_steps(ins, n, section=section))
               for i, ins in enumerate(self.instructions)]
        report = dict(per)
        report["total"] = sum(s for _, s in per)
        cycles.note_report(self, n, report)
        return report

    def run(self, array, backend: str | None = None):
        """Schedule and execute against ``array``; returns
        ``(final_array, outputs)`` with ``outputs[i]`` the value produced by
        instruction ``i`` (``None`` for pure buffer transforms)."""
        from . import scheduler
        return scheduler.schedule(self).run(array, backend=backend)


# ---------------------------------------------------------------------------
# recorder state + the method decorator
# ---------------------------------------------------------------------------

#: derived CPMArray methods -> the OP_TABLE op doing the work (each adds
#: one Rule-6 count/drain step on top) — the single definition shared by
#: the cost model (scheduler) and backend-fallback routing (executors)
DERIVED_METHODS = {"count": "compare", "find_all": "substring_match"}

_STATE: dict[str, Any] = {"program": None, "suspend": 0}

#: op name -> the decorated CPMArray method's signature (self included) —
#: lets the explicit builder bind/validate operands exactly like the tracer
_SIGNATURES: dict[str, inspect.Signature] = {}


def active_program() -> CPMProgram | None:
    """The open recorder, unless recording is suspended (internal calls)."""
    return None if _STATE["suspend"] else _STATE["program"]


@contextlib.contextmanager
def suspended():
    """Temporarily stop recording (nested method calls, executor replay)."""
    _STATE["suspend"] += 1
    try:
        yield
    finally:
        _STATE["suspend"] -= 1


@contextlib.contextmanager
def record():
    """``with cpm.record() as prog:`` — trace CPMArray method calls.

    One recorder may be open at a time (the device executes one broadcast
    stream); nesting raises.  The stream must be linear (see
    :class:`CPMProgram`): chain each transform off the previous result, and
    remember that operands are captured by value — replaying the plan on a
    different device does not recompute operands that were derived from
    recorded intermediates.
    """
    if _STATE["program"] is not None:
        raise RuntimeError("cpm.record() does not nest: a recording is "
                           "already active")
    prog = CPMProgram()
    _STATE["program"] = prog
    try:
        yield prog
    finally:
        _STATE["program"] = None


def recordable(op: str):
    """Decorator for ``CPMArray`` methods: the dispatch hook of the tracer.

    Outside a recording the method runs untouched.  Inside, the call is
    appended as an :class:`Instruction` (operands bound to parameter names,
    defaults applied) and the result is computed through the reference
    executor with recording suspended — real values out, no device kernels
    in the trace, single execution path shared with replay.
    """
    def deco(fn):
        sig = inspect.signature(fn)
        _SIGNATURES[op] = sig

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            prog = active_program()
            if prog is None:
                return fn(self, *args, **kwargs)
            # linearity guard: replay applies instructions in sequence, so
            # a call on anything but the stream's current head would replay
            # against different state than it ran on — raise, don't diverge
            head = prog._head
            if head is not None and not (self.data is head.data
                                         and self.used_len is head.used_len):
                raise RuntimeError(
                    f"non-linear recording: {op}() called on a device that "
                    "is not the current head of the recorded stream (the "
                    "result of the last recorded transform).  Record one "
                    "linear chain per program, or build branching pipelines "
                    "as separate programs.")
            bound = sig.bind(self, *args, **kwargs)
            bound.apply_defaults()
            operands = dict(bound.arguments)
            operands.pop("self")
            instr = Instruction(op, operands)
            prog.instructions.append(instr)
            from . import executors
            with suspended():
                out = executors.apply_instruction(self, instr,
                                                  backend="reference")
            # restore the caller's device identity on array results so the
            # chained stream keeps its backend routing hint
            if type(out) is type(self):
                out = dataclasses.replace(out, backend=self.backend)
                prog._head = out            # transforms advance the head
            elif head is None:
                prog._head = self           # first call pins the device
            return out
        return wrapper
    return deco
