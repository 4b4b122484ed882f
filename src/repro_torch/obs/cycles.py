"""Cycle accounting: the paper's predicted budgets against the measured
lowering (a port of ``repro.obs.cycles``).

The cost model predicts every program's *concurrent-step* cycles from the
op table (``~1`` universal, ``~M`` local, ``~sqrt(N)`` global, ``~log N``
super — §4–§8).  This module makes the comparison with what the
reference lowering does a live metric: a process-global
:class:`CycleLedger` accumulates, per op *family*,

  * ``predicted``       — op-table concurrent-step cycles,
  * ``predicted_scan``  — the share of them that the reference lowering
    runs as a counted loop (see :func:`_scan_share`),
  * ``measured_trips``  — loop trips counted while the reference lowering
    ran (``cpm.reference.trips.count_trips``, where the JAX package walks
    a jaxpr for ``lax.scan`` trips),
  * ``launches``        — kernel launches of that lowering
    (``kernels.ops.launch_counts``, where JAX counts ``pallas_call``),

and exposes ``drift = measured_trips - predicted_scan`` per family.  A
healthy build holds drift at 0; a nonzero drift means an op's lowering
no longer matches its registered budget.

Feeding the ledger:

  * ``CPMProgram.steps_report()`` is hooked: every report records its
    predicted cycles here, per family, when telemetry is on;
  * :func:`audit` replays a program instruction by instruction on a
    concrete device through the reference lowering and counts its trips
    and launches — never while ``torch.compile`` traces or a CUDA graph
    is captured (``tuning.measurable``), where nothing would run.

All recording is host arithmetic; ``REPRO_OBS=0`` turns both feeds off.
"""

from __future__ import annotations

import dataclasses
import threading

from .metrics import counter, enabled


@dataclasses.dataclass
class FamilyCycles:
    """Accumulated cycle accounting for one op family."""
    family: str
    predicted: int = 0
    predicted_scan: int = 0
    measured_trips: int = 0
    launches: int = 0
    instructions: int = 0
    audited: int = 0               # instructions with a measured lowering

    @property
    def drift(self) -> int:
        return self.measured_trips - self.predicted_scan


class CycleLedger:
    def __init__(self):
        self._families: dict[str, FamilyCycles] = {}
        self._lock = threading.Lock()
        self._predicted = counter(
            "repro_cycles_predicted_total",
            "op-table predicted concurrent-step cycles", ("family",))
        self._measured = counter(
            "repro_cycles_measured_trips_total",
            "counted loop trips of audited reference lowerings",
            ("family",))
        self._launches = counter(
            "repro_cycles_kernel_launches_total",
            "kernel launches of audited lowerings", ("family",))

    def _fam(self, family: str) -> FamilyCycles:
        f = self._families.get(family)
        if f is None:
            f = self._families[family] = FamilyCycles(family)
        return f

    # -- feeds ---------------------------------------------------------------
    def note_predicted(self, family: str, steps: int,
                       scan_steps: int = 0) -> None:
        """One instruction's predicted cycles (``steps_report`` hook)."""
        with self._lock:
            f = self._fam(family)
            f.predicted += steps
            f.predicted_scan += scan_steps
            f.instructions += 1
        self._predicted.inc(steps, family=family)

    def note_measured(self, family: str, trips: int, launches: int,
                      predicted: int = 0, scan_predicted: int = 0) -> None:
        """One audited instruction: measured lowering next to its budget."""
        with self._lock:
            f = self._fam(family)
            f.predicted += predicted
            f.predicted_scan += scan_predicted
            f.measured_trips += trips
            f.launches += launches
            f.instructions += 1
            f.audited += 1
        if predicted:
            self._predicted.inc(predicted, family=family)
        self._measured.inc(trips, family=family)
        self._launches.inc(launches, family=family)

    # -- views ---------------------------------------------------------------
    def drift_table(self) -> list[dict]:
        """Per-family rows, audited families first, worst drift on top."""
        with self._lock:
            fams = [dataclasses.asdict(f) | {"drift": f.drift}
                    for f in self._families.values()]
        return sorted(fams, key=lambda r: (-r["audited"], -abs(r["drift"]),
                                           r["family"]))

    def format_drift_table(self) -> str:
        rows = self.drift_table()
        head = (f"{'family':<10} {'instrs':>6} {'predicted':>9} "
                f"{'pred_scan':>9} {'meas_trips':>10} {'launches':>8} "
                f"{'drift':>5}")
        lines = [head, "-" * len(head)]
        for r in rows:
            lines.append(
                f"{r['family']:<10} {r['instructions']:>6} "
                f"{r['predicted']:>9} {r['predicted_scan']:>9} "
                f"{r['measured_trips']:>10} {r['launches']:>8} "
                f"{r['drift']:>5}")
        return "\n".join(lines)

    def clear(self) -> None:
        with self._lock:
            self._families.clear()


#: the process-global ledger
LEDGER = CycleLedger()


def _family_of(op: str) -> str:
    from repro_torch.cpm.optable import OP_TABLE
    from repro_torch.cpm.program.ir import DERIVED_METHODS
    spec = OP_TABLE.get(DERIVED_METHODS.get(op, op))
    return spec.family if spec is not None else "unknown"


def _scan_share(instr, steps: int) -> int:
    """The share of one instruction's predicted cycles that the port's
    reference lowering runs as a counted loop: the JAX package's
    scan-structured ops (``scheduler.scan_structured_steps``) in full,
    minus the Rule-6 drain step of a derived method (``find_all`` =
    ``substring_match`` + 1), which is no loop trip; and, where the
    port's reference loops but JAX's does not scan, the ``histogram``'s
    M+1 compare-and-count steps and a bounded ``sort``'s exchange cycles
    (a full sort is one ``torch.sort``, no loop)."""
    from repro_torch.cpm.program.ir import DERIVED_METHODS
    from repro_torch.cpm.program.scheduler import _SCAN_STRUCTURED
    op = instr.op
    if op == "histogram":
        return steps
    if op == "sort":
        return steps if instr.operands.get("steps") is not None else 0
    if op not in _SCAN_STRUCTURED:
        return 0
    return steps - (1 if op in DERIVED_METHODS else 0)


def note_report(prog, n: int, report: dict) -> None:
    """The ``CPMProgram.steps_report`` hook: fold one report's per-
    instruction predicted cycles into the ledger (telemetry on only)."""
    if not enabled():
        return
    for i, instr in enumerate(prog.instructions):
        steps = report.get(f"{i}:{instr.op}")
        if steps is None:
            continue
        LEDGER.note_predicted(_family_of(instr.op), int(steps),
                              _scan_share(instr, int(steps)))


def audit(prog, device, section: int | None = None,
          ledger: CycleLedger | None = None) -> list[dict]:
    """Measure a program's reference lowering instruction by instruction
    against its op-table budget, on a concrete ``device`` (a CPMArray).

    For each instruction: predicted cycles come from the op-table formula
    at the device's ``n``; measured loop trips and kernel launches are
    counted while the instruction's *reference* replay runs against the
    evolving device state.  Results land in the ledger per family and are
    returned per instruction.  Refuses to run where nothing would run
    (``tuning.measurable()`` False: ``torch.compile`` tracing, or a CUDA
    graph being captured)."""
    from repro_torch.cpm import tuning
    from repro_torch.cpm.program import executors
    from repro_torch.cpm.program.scheduler import instruction_steps
    from repro_torch.cpm.reference.trips import count_trips
    from repro_torch.kernels import ops

    if not tuning.measurable():
        raise RuntimeError(
            "cycles.audit() under torch.compile tracing or CUDA-graph "
            "capture would count a trace, not a run; audit eagerly between "
            "compiled calls")
    led = ledger if ledger is not None else LEDGER
    n = device.n
    rows: list[dict] = []
    dev = device
    for instr in prog.instructions:
        predicted = instruction_steps(instr, n, section=section)
        scan_pred = _scan_share(instr, predicted)
        before = ops.launch_counts()
        with count_trips() as trips:
            out = executors.apply_instruction(dev, instr,
                                              backend="reference")
        after = ops.launch_counts()
        launches = sum(after[k] - before[k] for k in after)
        fam = _family_of(instr.op)
        if enabled():
            led.note_measured(fam, trips.n, launches, predicted=predicted,
                              scan_predicted=scan_pred)
        rows.append({"op": instr.op, "family": fam, "n": n,
                     "predicted": predicted, "predicted_scan": scan_pred,
                     "measured_trips": trips.n, "launches": launches,
                     "drift": trips.n - scan_pred})
        if type(out) is type(dev):
            dev = out                   # transforms advance the stream head
    return rows


def drift_table() -> list[dict]:
    return LEDGER.drift_table()
