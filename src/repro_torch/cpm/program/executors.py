"""Per-backend execution of CPM programs (a port of
``repro.cpm.program.executors`` for the reference and cuda backends).

One contract, bit-identical results:

  * ``reference`` — replays every instruction unfused through the
    ordinary ``CPMArray`` method.  Batched devices with per-row operands
    (and the move ops, whose lowerings read a scalar ``used_len``) replay
    row by row, where the JAX package ``vmap``\\ s over rows.
  * ``cuda``      — each *fused* group lowers to ONE ``fused_stream``
    kernel launch: the row block loads once and every instruction of the
    group reads and writes it in shared memory, ``block_r`` rows a block
    (autotuned per stream signature, shape, dtype and backend key).  On
    CPU rows the same lowering runs the kernel's plain twin.  *Eager*
    groups (fusable runs the cost model priced slower fused) and
    *boundary* groups replay per op on the per-op kernels — and so does a
    fused group whose CUDA rows the kernel cannot hold resident (see
    :func:`fits_fused_stream`).

Operand layout is described once (``_RANKS``): scalars are rank 0,
needle/template/values vectors rank 1.  An operand whose leading dims
equal the device batch shape is *per-row* — a per-row ``(R, k)`` block in
the kernel; anything else broadcasts as ``(1, k)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

from repro_torch.kernels import cpm_kernels as K
from repro_torch.kernels.cpm_kernels import FUSED_PRODUCERS

from .. import backends as B
from .. import tuning
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
#: lowerings are only row-correct, so batched devices replay rows, except
#: on the cuda backend, whose ``shift_range`` takes per-row bounds
#: (:func:`_apply_moves`)
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
    kernel at all replays on the reference (per-op pin compatibility);
    on a forced ``cuda`` backend every other op runs its per-op kernel
    (``count`` through ``compare``, ``insert`` / ``delete`` / ``shift``
    through ``shift_range``, one call over a batched device's rows), and
    a backend that lacked one would raise: a forced kernel backend never
    substitutes another realization."""
    bk = backend or arr.backend
    spec = OP_TABLE.get(_DERIVED.get(instr.op, instr.op))
    if bk not in ("reference", "auto") and spec is not None \
            and _KERNEL_COLUMN not in spec.backends:
        bk = "reference"
    a = dataclasses.replace(arr, backend=bk)
    lead = arr.batch_shape
    if lead and instr.op in _ROWWISE_ALWAYS and _moves_at_once(a, instr):
        return _apply_moves(a, instr)
    if lead and (instr.op in _ROWWISE_ALWAYS
                 or _per_row_operands(instr, lead)):
        return _apply_rows(a, instr)
    with ir.suspended():
        return getattr(a, instr.op)(**instr.operands)


def _moves_at_once(a, instr: ir.Instruction) -> bool:
    """Whether a move on batched ``a`` runs as one ``shift_range`` call:
    on the cuda backend (``auto`` as it resolves for the op), unless
    ``shift`` carries a per-row fill, which the kernel takes as one
    element."""
    bk = a.backend
    if bk == "auto":
        bk = B.auto_backend_name(a.data, instr.op)
    return bk == "cuda" and not (
        instr.op == "shift"
        and _is_per_row(instr.operands.get("fill"), 0, a.batch_shape))


def _apply_moves(a, instr: ir.Instruction):
    """One move on every row of batched ``a`` in one ``shift_range``
    call: per-row ``start`` / ``end`` (``used_len - 1`` of each row for
    ``insert`` / ``delete``) as ``(R,)`` bounds, then the same window
    write / tail fill as ``CPMArray.insert`` / ``delete`` per row, so the
    bits equal the row replay's."""
    lead, n, dev = a.batch_shape, a.n, a.device
    r = math.prod(lead)
    data = a.data.reshape(r, n)
    ul = asarray(a.used_len, torch.int32, dev).expand(lead).reshape(r)
    ops = instr.operands
    kernels = B.get_backend("cuda")

    def col(v, dtype=torch.int32):           # scalar or per-row -> (r,)
        return asarray(v, dtype, dev).expand(lead).reshape(r)

    if instr.op == "shift":
        out = kernels.shift_range(data, col(ops["start"]), col(ops["end"]),
                                  int(ops["shift"]), ops["fill"])
        return dataclasses.replace(a, data=out.reshape(*lead, n),
                                   used_len=ul.reshape(lead))
    idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    if instr.op == "insert":
        values = asarray(ops["values"], a.dtype, dev)
        k = values.shape[-1]
        pos = col(ops["pos"])
        shifted = kernels.shift_range(data, pos, ul - 1, k, None)
        p = pos[:, None]
        window = (idx >= p) & (idx < p + k)
        vals = torch.gather(values.expand(*lead, k).reshape(r, k), 1,
                            torch.clamp(idx - p, 0, k - 1).long()
                            .expand(r, n))
        out = torch.where(window, vals, shifted)
        new_ul = torch.clamp(ul + k, max=n)
    else:                                    # delete
        k = int(ops["k"])
        shifted = kernels.shift_range(data, col(ops["pos"]) + k, ul - 1, -k,
                                      None)
        u = ul[:, None]
        vacated = (idx >= u - k) & (idx < u)
        fill = col(ops["fill"], a.dtype)[:, None]
        out = torch.where(vacated, fill, shifted)
        new_ul = torch.clamp(ul - k, min=0)
    return dataclasses.replace(a, data=out.reshape(*lead, n),
                               used_len=new_ul.reshape(lead))


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

def fits_fused_stream(arr) -> bool:
    """Whether the ``fused_stream`` kernel takes ``arr``'s rows: any rows
    on the CPU (the plain twin), on the card int32 or float32 rows whose
    two resident copies fit a block's shared memory (29,056 lanes)."""
    if not arr.data.is_cuda:
        return True
    return (arr.dtype in (torch.int32, torch.float32)
            and 2 * arr.n * 4 <= K.MAX_SMEM_BYTES)


def run_plan(plan, arr, backend: str | None = None):
    """Execute a scheduled plan; returns ``(final_array, outputs)``.

    ``fused`` groups on the cuda backend take the single-launch kernel
    path; ``eager`` groups (fusable runs the cost model rejected) and
    ``boundary`` groups replay per op — same instructions, bit-identical
    results, another launch structure.  A fused group whose rows the
    kernel cannot hold (:func:`fits_fused_stream`) replays per op too.
    ``"auto"`` resolves once per plan by ``backends.auto_backend_name``,
    the rule per-op dispatch uses: rows shorter than the crossover run on
    the reference, as in JAX."""
    bk = backend or arr.backend
    if bk == "auto":
        bk = B.auto_backend_name(arr.data)
    outputs: list = [None] * len(plan.program)
    cur = arr
    for group in plan.groups:
        if group.kind == "fused" and bk == "cuda" \
                and fits_fused_stream(cur):
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

#: don't bother timing row blockings below this problem size — the launch
#: count is tiny and tuning would cost more than it can ever return
_TUNE_MIN_ROWS = 4
_TUNE_MIN_ELEMS = 1 << 15


def _blockr_candidates(r: int) -> list[int]:
    return sorted({br for br in (1, 8, 32, r) if 1 <= br <= r})


def _fused_block_r(descs, operands, data, r: int, n: int) -> int:
    """Autotuned rows a block for one fused stream, cached per
    (op-stream signature, shape, dtype, backend key) with a JSON spill
    (JAX ``executors.py:186-222``); candidates are timed on zeros of the
    recorded shapes, only where ``tuning.measurable``.  Any value gives
    the same bits."""
    if r < _TUNE_MIN_ROWS or r * n < _TUNE_MIN_ELEMS:
        return 1
    cands = _blockr_candidates(r)
    if len(cands) < 2:
        return 1
    sig = hashlib.md5(repr(descs).encode()).hexdigest()[:12]
    key = (f"blockr:{'+'.join(op for op, _, _ in descs)}:{sig}"
           f"|{r}x{n}|{_dtname(data.dtype)}"
           f"|{tuning.backend_key(data.device)}")
    cached = tuning.lookup(key)
    if cached is not None:
        return int(cached)
    if not tuning.tuning_enabled() or not tuning.measurable():
        return 1
    dev = data.device
    datz = tuning.synth((r, n), data.dtype, dev)
    ulz = tuning.synth((r,), torch.int32, dev)
    opz = tuple(tuning.synth(a.shape, a.dtype, dev) for a in operands)
    backend = B.get_backend("cuda")

    def run(br):
        return backend.fused_stream(datz, ulz, descs, opz, block_r=br)

    return int(tuning.pick(key, cands, run, default=1))


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
    descs, operands = tuple(descs), tuple(operands)
    block_r = _fused_block_r(descs, operands, data, r, n)
    out_x, out_ul, prods = B.get_backend("cuda").fused_stream(
        data, ul.contiguous(), descs, operands, block_r=block_r)

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
