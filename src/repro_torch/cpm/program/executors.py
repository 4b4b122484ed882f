"""Per-backend execution of CPM programs (a port of
``repro.cpm.program.executors`` for the reference and cuda backends).

One contract, bit-identical results:

  * ``reference`` — replays every instruction unfused through the
    ordinary ``CPMArray`` method.  Batched devices with per-row operands
    (and the move ops, whose lowerings read a scalar ``used_len``) replay
    row by row, where the JAX package ``vmap``\\ s over rows.
  * ``cuda``      — each *fused* group lowers to ONE ``fused_stream``
    kernel launch: the row block loads once and every instruction of the
    group reads and writes it in shared memory.  On CPU rows the same
    lowering runs the kernel's plain twin.

Operand layout is described once (``_RANKS``): scalars are rank 0,
needle/template/values vectors rank 1.  An operand whose leading dims
equal the device batch shape is *per-row* — a per-row ``(R, k)`` block in
the kernel; anything else broadcasts as ``(1, k)``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels.cpm_kernels import FUSED_PRODUCERS

from .. import backends as B
from .._tensor import asarray, result_type
from ..optable import OP_TABLE
from . import ir
from .ir import DERIVED_METHODS as _DERIVED

#: ops that leave a value (mask / SAD / filtered flags) rather than a new
#: buffer state — each gets its own output in the kernel
PRODUCERS = frozenset(FUSED_PRODUCERS)

#: operand name -> rank (0 scalar, 1 vector) per recordable method
_RANKS: dict[str, dict[str, int]] = {
    "activate": {"start": 0, "end": 0, "carry": 0},
    "shift": {"start": 0, "end": 0, "fill": 0},
    "insert": {"pos": 0, "values": 1},
    "delete": {"pos": 0, "fill": 0},
    "truncate": {"new_len": 0},
    "compare": {"datum": 0, "mask": 0},
    "count": {"datum": 0, "mask": 0},
    "histogram": {"edges": 1},
    "substring_match": {"needle": 1},
    "find_all": {"needle": 1},
    "template_match": {"template": 1},
    "stencil": {},
}

#: move ops read ``used_len`` inside roll/select masks — their unbatched
#: lowerings are only row-correct, so batched devices always replay rows
_ROWWISE_ALWAYS = frozenset({"shift", "insert", "delete"})

_TRANSFORMS = frozenset({"shift", "insert", "delete", "truncate"})

#: the op table's column for a TPU kernel, whose place the cuda backend takes
_KERNEL_COLUMN = "pallas"


def _shape(v) -> tuple[int, ...]:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def _is_per_row(v, rank: int, lead: tuple[int, ...]) -> bool:
    """Per-row iff the operand carries the device's batch dims verbatim."""
    if v is None or not lead:
        return False
    shape = _shape(v)
    return (len(shape) == len(lead) + rank
            and tuple(shape[:len(lead)]) == tuple(lead))


def _per_row_operands(instr: ir.Instruction, lead) -> bool:
    return any(_is_per_row(instr.operands.get(k), r, lead)
               for k, r in _RANKS.get(instr.op, {}).items())


# ---------------------------------------------------------------------------
# single-instruction replay
# ---------------------------------------------------------------------------

def apply_instruction(arr, instr: ir.Instruction, backend: str | None = None):
    """Execute one instruction eagerly on ``backend`` (default: the
    array's).  As in the JAX executor, an op that the op table gives no
    kernel at all replays on the reference (per-op pin compatibility).
    On a forced ``cuda`` backend an op with a ported per-op kernel runs it
    (``compare``, and ``count`` through it: the ``csrc/compare.cu``
    launch); an op whose TPU kernel is not yet ported raises: a forced
    kernel backend never substitutes another realization."""
    bk = backend or arr.backend
    op = _DERIVED.get(instr.op, instr.op)
    if bk not in ("reference", "auto") and not B.get_backend(bk).supports(op):
        spec = OP_TABLE.get(op)
        if spec is None or _KERNEL_COLUMN not in spec.backends:
            bk = "reference"
        else:
            raise NotImplementedError(
                f"op {op!r} has no per-op kernel on the {bk!r} backend yet "
                f"(ROADMAP Queue 2); fused groups run through fused_stream, "
                f"backend='auto' replays on the reference")
    a = dataclasses.replace(arr, backend=bk)
    lead = arr.batch_shape
    if lead and (instr.op in _ROWWISE_ALWAYS
                 or _per_row_operands(instr, lead)):
        return _apply_rows(a, instr)
    with ir.suspended():
        return getattr(a, instr.op)(**instr.operands)


def _apply_rows(a, instr: ir.Instruction):
    """Row-by-row replay of one instruction on a batched device."""
    from ..array import CPMArray

    lead, n = a.batch_shape, a.n
    r = math.prod(lead)
    data = a.data.reshape(r, n)
    ul = asarray(a.used_len, torch.int32, a.device).expand(lead).reshape(r)
    mapped, shared = {}, dict(instr.operands)
    for name, rank in _RANKS.get(instr.op, {}).items():
        v = instr.operands.get(name)
        if _is_per_row(v, rank, lead):
            va = asarray(v, device=a.device)
            mapped[name] = va.reshape(r, *va.shape[len(lead):])
            del shared[name]
    outs = []
    for i in range(r):
        row = CPMArray(data[i], ul[i], a.backend)
        kw = dict(shared, **{k: m[i] for k, m in mapped.items()})
        with ir.suspended():
            outs.append(getattr(row, instr.op)(**kw))
    if isinstance(outs[0], CPMArray):
        return dataclasses.replace(
            a, data=torch.stack([o.data for o in outs]).reshape(*lead, n),
            used_len=torch.stack([o.used_len for o in outs]).reshape(lead))
    st = torch.stack(outs)
    return st.reshape(*lead, *st.shape[1:])


# ---------------------------------------------------------------------------
# plan execution
# ---------------------------------------------------------------------------

def run_plan(plan, arr, backend: str | None = None):
    """Execute a scheduled plan; returns ``(final_array, outputs)``.

    ``fused`` groups on the cuda backend take the single-launch kernel
    path; ``boundary`` groups replay per op (same instructions,
    bit-identical results).  ``"auto"`` resolves once per plan by
    ``backends.auto_backend_name``, the rule per-op dispatch uses: rows
    shorter than ``CUDA_MIN_N`` run on the reference, as in JAX."""
    bk = backend or arr.backend
    if bk == "auto":
        bk = B.auto_backend_name(arr.data)
    outputs: list = [None] * len(plan.program)
    cur = arr
    for group in plan.groups:
        if group.kind == "fused" and bk == "cuda":
            cur, produced = _run_fused(cur, group)
            for idx, val in produced:
                outputs[idx] = val
            continue
        for idx, instr in zip(group.indices, group.instructions):
            res = apply_instruction(cur, instr, backend=bk)
            if type(res) is type(cur):
                cur = res
            else:
                outputs[idx] = res
    return cur, outputs


# ---------------------------------------------------------------------------
# the fused-group lowering
# ---------------------------------------------------------------------------

def _norm_operand(v, rank: int, lead, r: int, device, dtype=None):
    """One dynamic operand as a contiguous ``(rows, k)`` kernel input
    (``rows`` is ``r`` per-row or 1 broadcast).  Returns (tensor, shared)."""
    a = asarray(v, dtype, device)
    if _is_per_row(a, rank, lead):
        a = a.reshape(r, -1) if rank else a.reshape(r, 1)
        return a.contiguous(), False
    if a.ndim != rank:
        raise ValueError(
            f"operand of shape {tuple(a.shape)} matches neither the shared "
            f"rank-{rank} layout nor the per-row layout {tuple(lead)} + "
            f"rank-{rank} for batch {tuple(lead)}")
    return a.reshape(1, -1).contiguous(), True


def _pack_scalars(values, lead, r, device, dtype):
    """Scalars that share one operand (start/end/carry): broadcast to a
    common row count and concatenate along the operand axis."""
    parts = [_norm_operand(v, 0, lead, r, device, dtype) for v in values]
    shared = all(s for _, s in parts)
    rows = 1 if shared else r
    packed = torch.cat([a.expand(rows, 1) for a, _ in parts], dim=1)
    return packed.contiguous(), shared


def _dtname(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _lower(instr: ir.Instruction, dtype, lead, r: int, device):
    """Instruction -> (static descriptor, operand tensors, all_shared)."""
    op, ops = instr.op, instr.operands
    if op == "activate":
        packed, shared = _pack_scalars(
            [ops["start"], ops["end"], ops["carry"]], lead, r, device,
            torch.int32)
        return (op, ()), [packed], shared
    if op == "shift":
        se, shared = _pack_scalars([ops["start"], ops["end"]], lead, r,
                                   device, torch.int32)
        statics = (("shift", int(ops["shift"])),
                   ("has_fill", ops["fill"] is not None))
        opnds = [se]
        if ops["fill"] is not None:
            f, fs = _norm_operand(ops["fill"], 0, lead, r, device, dtype)
            opnds.append(f)
            shared = shared and fs
        return (op, statics), opnds, shared
    if op == "insert":
        values = asarray(ops["values"], dtype, device)
        k = values.shape[-1]
        pos, ps = _norm_operand(ops["pos"], 0, lead, r, device, torch.int32)
        vals, vs = _norm_operand(values, 1, lead, r, device, dtype)
        return (op, (("k", int(k)),)), [pos, vals], ps and vs
    if op == "delete":
        pos, ps = _norm_operand(ops["pos"], 0, lead, r, device, torch.int32)
        fill, fs = _norm_operand(ops["fill"], 0, lead, r, device, dtype)
        return (op, (("k", int(ops["k"])),)), [pos, fill], ps and fs
    if op == "truncate":
        nl, s = _norm_operand(ops["new_len"], 0, lead, r, device,
                              torch.int32)
        return (op, ()), [nl], s
    if op == "compare":
        if ops.get("mask") is not None:
            d, ds = _norm_operand(asarray(ops["datum"], dtype, device), 0,
                                  lead, r, device)
            mct = result_type(dtype, ops["mask"])
            m, ms = _norm_operand(ops["mask"], 0, lead, r, device, mct)
            statics = (("op", ops["op"]), ("has_mask", True),
                       ("ct", _dtname(mct)))
            return (op, statics), [d, m], ds and ms
        ct = torch.promote_types(dtype, asarray(ops["datum"]).dtype)
        d, ds = _norm_operand(ops["datum"], 0, lead, r, device, ct)
        statics = (("op", ops["op"]), ("has_mask", False),
                   ("ct", _dtname(ct)))
        return (op, statics), [d], ds
    if op == "substring_match":
        needle = asarray(ops["needle"], dtype, device)
        nee, s = _norm_operand(needle, 1, lead, r, device, dtype)
        statics = (("m", int(needle.shape[-1])), ("where", ops["where"]))
        return (op, statics), [nee], s
    if op == "template_match":
        template = asarray(ops["template"], device=device)
        t, s = _norm_operand(template, 1, lead, r, device)
        statics = (("m", int(template.shape[-1])),
                   ("mask_tail", bool(ops["mask_tail"])))
        return (op, statics), [t], s
    if op == "stencil":
        statics = (("taps", tuple(float(t) for t in ops["taps"])),
                   ("wrap", bool(ops["wrap"])))
        return (op, statics), [], True
    raise NotImplementedError(f"no fused lowering for op {op!r}")


def _run_fused(arr, group):
    """One fused group -> one ``fused_stream`` launch."""
    lead, n, dev = arr.batch_shape, arr.n, arr.device
    r = math.prod(lead) if lead else 1
    data = arr.data.reshape(r, n).contiguous()
    ul = asarray(arr.used_len, torch.int32, dev).expand(lead).reshape(r)
    descs, operands, meta = [], [], []
    for idx, instr in zip(group.indices, group.instructions):
        (op, statics), opnds, all_shared = _lower(instr, arr.dtype, lead, r,
                                                  dev)
        descs.append((op, statics, len(opnds)))
        operands.extend(opnds)
        if instr.op in PRODUCERS:
            meta.append((idx, instr.op, all_shared))
    out_x, out_ul, prods = B.get_backend("cuda").fused_stream(
        data, ul.contiguous(), tuple(descs), tuple(operands))

    if any(i.op in _TRANSFORMS for i in group.instructions):
        new = dataclasses.replace(arr, data=out_x.reshape(*lead, n),
                                  used_len=out_ul.reshape(lead))
    else:                       # producers only: the device is untouched
        new = arr
    produced = []
    for (idx, op, all_shared), raw in zip(meta, prods):
        if op in ("activate", "compare", "substring_match"):
            raw = raw.to(torch.bool)
        if op == "activate" and all_shared:
            out = raw[0]        # eager activate is batch-free: one (n,) mask
        else:
            out = raw.reshape(*lead, n)
        produced.append((idx, out))
    return new, produced
