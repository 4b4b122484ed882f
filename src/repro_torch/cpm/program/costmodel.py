"""The launch/byte wall-clock cost model behind cost-aware fusion (a port
of ``repro.cpm.program.costmodel``).

The §3–§8 cycle model (``scheduler.program_steps``) prices programs in
concurrent steps, the paper's currency.  It says nothing about what a
kernel launch costs on the card, which is what decides whether a run of
elementwise ops is better as ONE ``fused_stream`` launch or as per-op
dispatch.  So the model prices a fusable run both ways in seconds::

    eager(group) = launches · L_e  + passes · bytes · c_e
    fused(group) = L_f            + passes · bytes · c_f

with per-op ``passes`` / ``launches`` read off the op table
(``OpSpec.passes`` / ``OpSpec.eager_launches``) and the four
coefficients either

  * **calibrated** — a one-time microbenchmark per backend key
    (``tuning.backend_key``): a fixed probe stream (``shift -> compare ->
    activate -> stencil``) timed fused and eager at two sizes on the cuda
    backend (the kernels on CUDA rows, their plain twins on CPU rows),
    solved for the launch intercepts and per-byte slopes, and spilled to
    the tuning cache for reuse; or
  * **priors** (:func:`roofline_params`) — where measurement is off
    (``REPRO_TORCH_CPM_CALIBRATE=0``) or impossible: the H100's byte rate
    for both paths and one launch cost measured on the card, so launches
    decide.

``schedule(prog, device=...)`` consults :func:`decide` per fusable run
and records the verdict in the emitted ``FusionGroup``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import tuning

#: H100 SXM device-memory rate (NVIDIA data sheet), the byte slope of the
#: priors: both paths read and write the row at this rate at best
H100_HBM_BYTES_PER_S = 3.35e12
#: the priors' launch intercept: the per-call host time of a launch-bound
#: kernel on the card, gather_rows at the pool's shapes, 0.0225 ms a call
#: (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W power limit;
#: PERF.md §6 row 14).  Only its ratio to the byte terms matters.
LAUNCH_S = 22.5e-6

#: probe stream sizes (elements) for the two-point calibration fit
_PROBE_SIZES = (512, 8192)
_PROBE_REPS = 5


def calibration_enabled() -> bool:
    return os.environ.get("REPRO_TORCH_CPM_CALIBRATE", "1") != "0"


@dataclass(frozen=True)
class CostParams:
    """Per-backend launch/byte coefficients (seconds / seconds-per-byte)."""
    launch_s: float            # eager per-op launch intercept  (L_e)
    eager_byte_s: float        # eager per-pass byte slope      (c_e)
    fused_launch_s: float      # fused single-launch intercept  (L_f)
    fused_byte_s: float        # fused per-pass byte slope      (c_f)
    source: str = "roofline"   # "calibrated" | "roofline" | "override"

    def as_dict(self) -> dict:
        return {"launch_s": self.launch_s,
                "eager_byte_s": self.eager_byte_s,
                "fused_launch_s": self.fused_launch_s,
                "fused_byte_s": self.fused_byte_s,
                "source": self.source}


def roofline_params() -> CostParams:
    """Priors: byte slopes at the H100's device-memory rate (identical for
    both paths — launches decide) and the measured launch cost."""
    byte_s = 1.0 / H100_HBM_BYTES_PER_S
    return CostParams(LAUNCH_S, byte_s, LAUNCH_S, byte_s, source="roofline")


# ---------------------------------------------------------------------------
# one-time microbenchmark calibration
# ---------------------------------------------------------------------------

def _probe_program(n: int):
    from .ir import CPMProgram
    return (CPMProgram()
            .append("shift", start=0, end=n // 2, shift=1, fill=0)
            .append("compare", datum=3, op="lt")
            .append("activate", start=0, end=n - 1, carry=1)
            .append("stencil", taps=(1.0, 2.0, 1.0), wrap=False))


def _eager_plan(prog):
    from .scheduler import FusionGroup, FusionPlan
    return FusionPlan(prog, tuple(
        FusionGroup("eager", (i,), (ins,))
        for i, ins in enumerate(prog.instructions)))


def _timed_both(prog, data, used, reps: int) -> tuple[float, float]:
    """(fused_s, eager_s) of ``prog`` on the cuda backend over ``data``."""
    from ..array import CPMArray
    from . import executors
    from .scheduler import schedule

    def runner(plan):
        def go():
            arr = CPMArray(data, used, backend="cuda")
            cur, outs = executors.run_plan(plan, arr, backend="cuda")
            return cur.data, [o for o in outs if o is not None]
        return go

    t_fused = tuning.time_call(runner(schedule(prog)), reps=reps)
    t_eager = tuning.time_call(runner(_eager_plan(prog)), reps=reps)
    return t_fused, t_eager


def _time_probe(n: int, device) -> tuple[float, float]:
    """(fused_s, eager_s) of the 4-op probe stream at size ``n``."""
    used = torch.tensor(n, dtype=torch.int32, device=device)
    return _timed_both(_probe_program(n),
                       tuning.synth((n,), torch.int32, device), used,
                       _PROBE_REPS)


def calibrate(device) -> CostParams:
    """Fit the four coefficients from the probe at two sizes (int32, one
    row, k=4 ops): intercept = launch term, slope = per-byte term."""
    k = len(_probe_program(8).instructions)
    n1, n2 = _PROBE_SIZES
    b1, b2 = n1 * 4, n2 * 4
    tf1, te1 = _time_probe(n1, device)
    tf2, te2 = _time_probe(n2, device)
    c_e = max((te2 - te1) / (k * (b2 - b1)), 1e-15)
    c_f = max((tf2 - tf1) / (k * (b2 - b1)), 1e-15)
    l_e = max(te1 / k - c_e * b1, 1e-9)
    l_f = max(tf1 - k * c_f * b1, 1e-9)
    return CostParams(l_e, c_e, l_f, c_f, source="calibrated")


def params_for(device) -> CostParams:
    """The coefficients for ``device``'s backend key: tuning-cache hit,
    else a fresh calibration (spilled), else the priors.  A probe the
    wrappers refuse (``ValueError`` / ``TypeError``) prices with the
    priors; a failed kernel build or launch (``RuntimeError``) raises."""
    key = f"calib:{tuning.backend_key(device)}"
    cached = tuning.lookup(key)
    if isinstance(cached, dict):
        try:
            return CostParams(**cached)
        except TypeError:
            pass
    if not calibration_enabled() or not tuning.measurable():
        # where the probe would be traced or captured, not run, price with
        # the priors (uncached, so a later schedule still calibrates)
        return roofline_params()
    try:
        params = calibrate(device)
    except (ValueError, TypeError):
        return roofline_params()
    tuning.store(key, params.as_dict())
    return params


# ---------------------------------------------------------------------------
# the per-group decision
# ---------------------------------------------------------------------------

def _cost_meta(instr, n: int) -> tuple[int, int]:
    """(row passes, eager launches) of one instruction — op-table cost
    metadata, with the concurrent-step formula as the passes fallback."""
    from ..optable import OP_TABLE
    from .ir import DERIVED_METHODS
    from .scheduler import _instr_m

    spec = OP_TABLE[DERIVED_METHODS.get(instr.op, instr.op)]
    m = _instr_m(instr)
    if spec.passes is not None:
        return int(spec.passes(n=n, m=m)), spec.eager_launches
    return int(spec.steps(n=n, m=m)), spec.eager_launches


def group_cost(instructions, rows: int, n: int, itemsize: int,
               params: CostParams) -> tuple[float, float]:
    """Predicted (fused_s, eager_s) of one fusable run on ``rows`` rows of
    ``n`` elements."""
    nbytes = rows * n * itemsize
    passes = launches = 0
    for instr in instructions:
        p, l = _cost_meta(instr, n)
        passes += p
        launches += l
    eager_s = launches * params.launch_s + passes * nbytes * params.eager_byte_s
    fused_s = params.fused_launch_s + passes * nbytes * params.fused_byte_s
    return fused_s, eager_s


#: fuse only on a predicted *clear* win.  Eager per-op dispatch is the
#: safe baseline (same instructions, bit-identical results), while the
#: coefficients behind a near-tie prediction carry microbenchmark noise.
FUSE_MARGIN = 0.85

#: when a *calibrated* prediction lands in this fused/eager ratio band,
#: settle the verdict by timing the actual group both ways on synthesized
#: inputs instead (cached per (op-stream, shape, dtype, backend key)).
#: JAX's band is (0.5, 1.5): there only a near-tie is within the fit's
#: noise.  The port's is every ratio: its calibrated intercepts are the
#: host's dispatch times, which differ per op and per operand, so the
#: fit's ratio is no guide for a group unlike the probe (on an NVIDIA
#: H100 80GB HBM3 at 700 W, chip_smoke.py: the probe fit L_e 289 us and
#: L_f 759 us, while the generate commit took 808 us a call eager and 210
#: us fused; PERF.md §6).  Priors and explicit overrides are never
#: second-guessed.
MEASURE_BAND = (0.0, float("inf"))
_MEASURE_REPS = 3


def _synth(v, device):
    """A timing stand-in for one recorded operand: tensors and arrays
    become zeros of the same shape and dtype on ``device``; static
    Python values pass through."""
    if isinstance(v, (torch.Tensor, np.ndarray)):
        from .._tensor import asarray
        a = asarray(v)
        return tuning.synth(a.shape, a.dtype, device)
    return v


def _measured_fuse(instructions, lead, n: int, dtype,
                   device) -> dict | None:
    """Time the run fused vs eager on a synthesized device of the real
    geometry; returns the verdict dict or None (a miss while tuning is off
    or nothing is measurable, or a group the wrappers refuse at this
    geometry; a failed build or launch raises)."""
    from .ir import CPMProgram

    sig = "+".join(i.op for i in instructions)
    key = (f"fuse:{sig}|{'x'.join(str(d) for d in lead) or 1}x{n}"
           f"|{str(dtype).removeprefix('torch.')}"
           f"|{tuning.backend_key(device)}")
    cached = tuning.lookup(key)
    if isinstance(cached, dict):
        return dict(cached, params="measured")
    if not tuning.tuning_enabled() or not tuning.measurable():
        return None

    prog = CPMProgram()
    for ins in instructions:
        prog = prog.append(ins.op, **{k: _synth(v, device)
                                      for k, v in ins.operands.items()})
    used = (torch.full(lead, n, dtype=torch.int32, device=device) if lead
            else torch.tensor(n, dtype=torch.int32, device=device))
    try:
        t_fused, t_eager = _timed_both(
            prog, tuning.synth((*lead, n), dtype, device), used,
            _MEASURE_REPS)
    except (ValueError, TypeError):
        return None
    verdict = {"fuse": bool(t_fused <= t_eager),
               "fused_us": t_fused * 1e6, "eager_us": t_eager * 1e6}
    tuning.store(key, verdict)
    return dict(verdict, params="measured")


def decide(instructions, rows: int, n: int, itemsize: int,
           params: CostParams, *, lead=(), dtype=None,
           device=None) -> dict:
    """The scheduler's per-run verdict, recorded in the FusionGroup.

    Model-predicted from ``params``; a *calibrated* prediction (ratio
    inside ``MEASURE_BAND``: on the port, any) is settled by direct
    measurement when the caller supplies ``dtype`` / ``device`` — see
    ``_measured_fuse``.
    """
    fused_s, eager_s = group_cost(instructions, rows, n, itemsize, params)
    verdict = {"fuse": bool(fused_s <= FUSE_MARGIN * eager_s),
               "fused_us": fused_s * 1e6,
               "eager_us": eager_s * 1e6,
               "params": params.source}
    ratio = fused_s / eager_s if eager_s > 0 else float("inf")
    if (params.source == "calibrated" and dtype is not None
            and device is not None
            and MEASURE_BAND[0] <= ratio <= MEASURE_BAND[1]):
        measured = _measured_fuse(instructions, lead, n, dtype, device)
        if measured is not None:
            verdict = measured
    return verdict
