"""The fused CPM instruction stream: the Hopper kernel and its plain twin.

Replaces ``src/repro/kernels/cpm_kernels.py:809`` (``fused_stream``,
``pallas_call`` at ``:882``, per-instruction body ``_fused_apply`` at
``:742``): one launch runs a whole fused group of broadcast instructions
over ``(R, N)`` rows and their ``(R,)`` §4.2 used-length registers, the
row staying resident across the group.  The nine instruction kinds are
``activate``, ``shift``, ``insert``, ``delete``, ``truncate``,
``compare``, ``substring_match``, ``template_match`` and ``stencil``.

The value bodies shared with the standalone kernels (``_activate_vals``,
``_shift_vals``, ``_sad_vals``, ``_substring_ends_vals``,
``_stencil_vals``) and ``_fused_apply`` repeat the JAX bodies op for op,
so :func:`fused_stream_plain` is bit-identical to the TPU kernel run in
interpret mode.  :func:`fused_stream` launches ``csrc/fused_stream.cu``
for CUDA tensors (counted in ``fused_stream.launches``) and runs the
plain twin for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: producer ops and their kernel output dtypes (cast to bool by the caller)
FUSED_PRODUCERS = {
    "activate": torch.int8,
    "compare": torch.int8,
    "substring_match": torch.int8,
    "template_match": torch.float32,
    "stencil": torch.float32,
}

_CMP = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "gt": lambda a, b: a > b,
    "le": lambda a, b: a <= b,
    "ge": lambda a, b: a >= b,
}

_CT = {"int32": torch.int32, "float32": torch.float32}


# ---------------------------------------------------------------------------
# shared value bodies (each mirrors the JAX body of the same name)
# ---------------------------------------------------------------------------

def _activate_vals(idx, start, end, carry):
    """Rule-4 general-decoder predicate (floor modulo, as ``jnp``)."""
    carry = torch.clamp(carry, min=1)
    return (idx >= start) & (idx <= end) & ((idx - start) % carry == 0)


def _shift_vals(x, idx, start, end, shift: int, n: int, fill=None):
    """§4.1 range move of a resident block."""
    src_mask = (idx >= start) & (idx <= end)
    moved = torch.roll(x, shift, dims=-1)
    dst_mask = torch.roll(src_mask, shift, dims=-1)
    if shift > 0:
        dst_mask = dst_mask & (idx >= shift)
    elif shift < 0:
        dst_mask = dst_mask & (idx < n + shift)
    out = torch.where(dst_mask, moved, x)
    if fill is not None:
        out = torch.where(src_mask & ~dst_mask, fill, out)
    return out


def _sad_vals(x_f32, t_row, m: int):
    """§7.6 sliding SAD, accumulated in the order ``j = 0 .. m-1``;
    ``t_row`` is a (1, M) broadcast or (BR, M) per-row template."""
    acc = torch.zeros_like(x_f32)
    for j in range(m):
        shifted = torch.roll(x_f32, -j, dims=-1)
        tap = t_row[:, j:j + 1].to(torch.float32)
        acc = acc + torch.abs(shifted - tap)
    return acc


def _substring_ends_vals(x, nee_row, m: int, idx):
    """§5 match-END carry chain; returns int32 0/1 flags."""
    first = idx == 0
    state = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i in range(m):
        sym = nee_row[:, i:i + 1]
        hit = (x == sym).to(torch.int32)
        shifted = torch.where(first, 0, torch.roll(state, 1, dims=-1))
        state = hit if i == 0 else hit * shifted
    return state


def _stencil_vals(x, idx, taps: tuple[float, ...], wrap: bool, n: int):
    """§7.3 tap accumulation on a resident float32 block (fixed tap
    order; zero taps are skipped)."""
    acc = torch.zeros_like(x)
    c = len(taps) // 2
    for k, w in enumerate(taps):
        if w == 0:
            continue
        shifted = torch.roll(x, k - c, dims=-1)
        if not wrap:
            if k - c > 0:
                shifted = torch.where(idx >= k - c, shifted, 0.0)
            elif k - c < 0:
                shifted = torch.where(idx < n + (k - c), shifted, 0.0)
        acc = acc + w * shifted
    return acc


def _fused_apply(op: str, statics, x, ul, refs, idx, n: int):
    """One broadcast instruction on the resident (BR, N) block ``x`` with
    its (BR, 1) length column ``ul``.  Operands are (1, k) broadcast or
    (BR, k) per-row.  Returns ``(x, ul, produced or None)``."""
    s = dict(statics)
    live = idx < ul
    if op == "activate":
        p = refs[0]
        mask = _activate_vals(idx, p[:, 0:1], p[:, 1:2], p[:, 2:3])
        return x, ul, torch.broadcast_to(mask, x.shape).to(torch.int8)
    if op == "shift":
        se = refs[0]
        fill = refs[1][:, 0:1] if s["has_fill"] else None
        return (_shift_vals(x, idx, se[:, 0:1], se[:, 1:2], s["shift"], n,
                            fill), ul, None)
    if op == "insert":
        pos, v, k = refs[0][:, 0:1], refs[1], s["k"]
        x = _shift_vals(x, idx, pos, ul - 1, k, n)
        for j in range(k):
            x = torch.where(idx == pos + j, v[:, j:j + 1], x)
        return x, torch.clamp(ul + k, max=n), None
    if op == "delete":
        pos, fill, k = refs[0][:, 0:1], refs[1][:, 0:1], s["k"]
        x = _shift_vals(x, idx, pos + k, ul - 1, -k, n)
        x = torch.where((idx >= ul - k) & (idx < ul), fill, x)
        return x, torch.clamp(ul - k, min=0), None
    if op == "truncate":
        return x, torch.minimum(ul, refs[0][:, 0:1]), None
    if op == "compare":
        d = refs[0][:, 0:1]
        if s["has_mask"]:
            m = refs[1][:, 0:1]
            a, b = x & m, d & m
        else:
            a, b = x.to(getattr(torch, s["ct"])), d
        return x, ul, (_CMP[s["op"]](a, b) & live).to(torch.int8)
    if op == "substring_match":
        m = s["m"]
        ends = _substring_ends_vals(x, refs[0], m, idx)
        flags = (ends > 0) & live
        if s["where"] == "start":
            flags = torch.roll(flags, -(m - 1), dims=-1) & (idx <= n - m)
        return x, ul, flags.to(torch.int8)
    if op == "template_match":
        m = s["m"]
        sad = _sad_vals(x.to(torch.float32), refs[0], m)
        if s["mask_tail"]:
            sad = torch.where(idx + m <= ul, sad, float("inf"))
        return x, ul, sad
    if op == "stencil":
        base = x if s["wrap"] else torch.where(
            live, x, torch.zeros((), dtype=x.dtype, device=x.device))
        return x, ul, _stencil_vals(base.to(torch.float32), idx, s["taps"],
                                    s["wrap"], n)
    raise NotImplementedError(f"fused instruction {op!r}")


def _counts(instrs, operands) -> list[int]:
    counts = [nops for _, _, nops in instrs]
    if len(operands) != sum(counts):
        raise ValueError(f"{len(operands)} operands for descriptor counts "
                         f"{counts}")
    return counts


def fused_stream_plain(x, used_len, instrs, operands, *, block_r: int = 1):
    """The TPU kernel's arithmetic in PyTorch: rows pad to a multiple of
    ``block_r``, each block of rows runs the whole stream, pad rows are
    sliced off.  Returns ``(rows, used_lens, producer_outputs)``."""
    r, n = x.shape
    counts = _counts(instrs, operands)
    br = max(1, min(int(block_r), r))
    pad = (-r) % br
    ul2 = used_len.reshape(r, 1).to(torch.int32)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        ul2 = torch.nn.functional.pad(ul2, (0, 0, 0, pad))
        operands = tuple(
            torch.nn.functional.pad(a, (0, 0, 0, pad)) if a.shape[0] == r
            else a for a in operands)
    rp = r + pad
    idx = torch.arange(n, dtype=torch.int32, device=x.device)[None, :]
    idx = idx.expand(br, n)
    xs, uls, prods = [], [], []
    for b0 in range(0, rp, br):
        blk = slice(b0, b0 + br)
        xv, ul = x[blk], ul2[blk]
        refs, pos = [], 0
        for c in counts:
            refs.append([a if (a.shape[0] == 1 and rp != 1) else a[blk]
                         for a in operands[pos:pos + c]])
            pos += c
        outs = []
        for (op, statics, _), orefs in zip(instrs, refs):
            xv, ul, out = _fused_apply(op, statics, xv, ul, orefs, idx, n)
            if out is not None:
                outs.append(out)
        xs.append(xv)
        uls.append(torch.broadcast_to(ul.to(torch.int32), (br, 1)))
        prods.append(outs)
    out_x = torch.cat(xs)[:r]
    out_ul = torch.cat(uls)[:r, 0]
    out_p = [torch.cat([p[i] for p in prods])[:r]
             for i in range(len(prods[0]))] if prods else []
    return out_x, out_ul, out_p


# ---------------------------------------------------------------------------
# the CUDA kernel: descriptors and launch
# ---------------------------------------------------------------------------

#: must equal FS_MAX_INSTR / FS_MAX_TAPS / FS_THREADS in csrc/fused_stream.cu
MAX_INSTR = 16
MAX_TAPS = 64
#: shared memory a block may use on the H100 (two resident row buffers)
MAX_SMEM_BYTES = 232448

_OPCODE = {op: i for i, op in enumerate(
    ("activate", "shift", "insert", "delete", "truncate", "compare",
     "substring_match", "template_match", "stencil"))}
_CMPCODE = {op: i for i, op in enumerate(("eq", "ne", "lt", "gt", "le",
                                          "ge"))}
_F_FILL, _F_MASK, _F_START, _F_TAIL, _F_WRAP, _F_CTF = 1, 2, 4, 8, 16, 32
_DT = {torch.int32: 0, torch.float32: 1}


class _Instr(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_int) for f in
                 ("op", "k", "shift", "m", "flags", "cmp", "ntaps",
                  "tap_off", "odt0", "odt1", "ostride0", "ostride1")]
                + [("o0", ctypes.c_void_p), ("o1", ctypes.c_void_p),
                   ("out", ctypes.c_void_p)])


class _Program(ctypes.Structure):
    _fields_ = [("n_instr", ctypes.c_int), ("x_float", ctypes.c_int),
                ("ins", _Instr * MAX_INSTR),
                ("taps", ctypes.c_float * MAX_TAPS)]


def _want(op, i, a, dtypes, cols, r):
    if a.dtype not in dtypes:
        raise TypeError(f"fused {op}: operand {i} has dtype {a.dtype}, "
                        f"kernel takes {[str(d) for d in dtypes]}")
    if a.ndim != 2 or a.shape[0] not in (1, r) or a.shape[1] < cols:
        raise ValueError(f"fused {op}: operand {i} has shape "
                         f"{tuple(a.shape)}, want (1 or {r}, >={cols})")
    if not a.is_contiguous():
        raise ValueError(f"fused {op}: operand {i} is not contiguous")


def _describe(instrs, operands, x, prods):
    """Pack the static stream into the kernel's by-value descriptor."""
    r, n = x.shape
    prog = _Program()
    if len(instrs) > MAX_INSTR:
        raise ValueError(f"{len(instrs)} instructions > {MAX_INSTR}")
    prog.n_instr, prog.x_float = len(instrs), int(x.dtype == torch.float32)
    counts = _counts(instrs, operands)
    i32, xdt = (torch.int32,), (x.dtype,)
    pos, pi, ntap = 0, 0, 0
    for slot, ((op, statics, _), c) in enumerate(zip(instrs, counts)):
        s = dict(statics)
        ops = operands[pos:pos + c]
        pos += c
        d = prog.ins[slot]
        d.op = _OPCODE[op]
        flags = 0
        if op == "activate":
            _want(op, 0, ops[0], i32, 3, r)
        elif op == "shift":
            _want(op, 0, ops[0], i32, 2, r)
            d.shift = int(s["shift"])
            if s["has_fill"]:
                _want(op, 1, ops[1], xdt, 1, r)
                flags |= _F_FILL
        elif op in ("insert", "delete"):
            d.k = int(s["k"])
            _want(op, 0, ops[0], i32, 1, r)
            _want(op, 1, ops[1], xdt, d.k if op == "insert" else 1, r)
        elif op == "truncate":
            _want(op, 0, ops[0], i32, 1, r)
        elif op == "compare":
            ct = _CT.get(s["ct"])
            if ct is None:
                raise TypeError(f"fused compare in {s['ct']}: the kernel "
                                f"takes int32/float32 (ROADMAP Queue 1)")
            d.cmp = _CMPCODE[s["op"]]
            if s["has_mask"]:
                if x.dtype != torch.int32:
                    raise TypeError("fused compare with a mask needs int32 "
                                    "rows")
                _want(op, 0, ops[0], i32, 1, r)
                _want(op, 1, ops[1], i32, 1, r)
                flags |= _F_MASK
            else:
                _want(op, 0, ops[0], (ct,), 1, r)
                if ct == torch.float32:
                    flags |= _F_CTF
                elif x.dtype != torch.int32:
                    raise TypeError(f"compare ct {ct} on {x.dtype} rows")
        elif op == "substring_match":
            d.m = int(s["m"])
            _want(op, 0, ops[0], xdt, d.m, r)
            if s["where"] == "start":
                flags |= _F_START
        elif op == "template_match":
            d.m = int(s["m"])
            _want(op, 0, ops[0], tuple(_DT), d.m, r)
            if s["mask_tail"]:
                flags |= _F_TAIL
        elif op == "stencil":
            taps = tuple(s["taps"])
            if ntap + len(taps) > MAX_TAPS:
                raise ValueError(f"more than {MAX_TAPS} stencil taps")
            d.ntaps, d.tap_off = len(taps), ntap
            for j, w in enumerate(taps):
                prog.taps[ntap + j] = w
                if w != 0 and prog.taps[ntap + j] == 0:
                    # the kernel skips zero taps by their float32 value
                    raise ValueError(f"stencil tap {w!r} underflows float32")
            ntap += len(taps)
            if s["wrap"]:
                flags |= _F_WRAP
        else:
            raise NotImplementedError(f"fused instruction {op!r}")
        d.flags = flags
        for j, a in enumerate(ops[:2]):
            if a.device != x.device:
                raise ValueError(f"fused {op}: operand {j} on {a.device}, "
                                 f"rows on {x.device}")
            setattr(d, f"o{j}", a.data_ptr())
            setattr(d, f"odt{j}", _DT[a.dtype])
            setattr(d, f"ostride{j}", 0 if (a.shape[0] == 1 and r != 1)
                    else a.shape[1])
        if op in FUSED_PRODUCERS:
            d.out = prods[pi].data_ptr()
            pi += 1
    return prog


def _lib():
    lib = _build.load("fused_stream")
    fn = lib.fused_stream_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, ctypes.POINTER(_Program), P]
        fn.restype = ctypes.c_int
    return lib, fn


def fused_stream(x, used_len, instrs, operands, *, block_r: int = 1):
    """Execute a fused instruction group in one kernel launch.

    ``x``: (R, N) int32 or float32 rows; ``used_len``: (R,) int32;
    ``instrs``: static ``(op, statics, n_operands)`` descriptors in stream
    order; ``operands``: the matching (R, k) per-row or (1, k) broadcast
    int32/float32 tensors.  ``block_r`` rows per CUDA block (any value is
    bit-identical to 1).  Returns ``(rows, used_lens, producer_outputs)``.
    """
    if x.device.type == "cpu":
        return fused_stream_plain(x, used_len, instrs, operands,
                                  block_r=block_r)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stream takes CPU or CUDA rows, got "
                         f"{x.device}")
    if x.dtype not in _DT:
        raise TypeError(f"fused_stream kernel takes int32 or float32 rows, "
                        f"got {x.dtype} (other dtypes: ROADMAP Queue 1)")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("fused_stream kernel needs contiguous (R, N) rows")
    r, n = x.shape
    if used_len.shape != (r,) or used_len.dtype != torch.int32 \
            or used_len.device != x.device:
        raise ValueError(f"used_len must be ({r},) int32 on {x.device}")
    if 2 * n * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"row length {n} does not fit two resident rows "
                         f"in shared memory (ROADMAP Queue 1)")
    used_len = used_len.contiguous()
    prods = [torch.empty((r, n), dtype=FUSED_PRODUCERS[op], device=x.device)
             for op, _, _ in instrs if op in FUSED_PRODUCERS]
    prog = _describe(instrs, operands, x, prods)
    out_x = torch.empty_like(x)
    out_ul = torch.empty_like(used_len)
    br = max(1, min(int(block_r), r))
    lib, fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out_x.data_ptr(), used_len.data_ptr(),
                out_ul.data_ptr(), r, n, br, ctypes.byref(prog), stream)
    _build.check(lib, rc, "fused_stream launch")
    fused_stream.launches += 1
    return out_x, out_ul, prods


fused_stream.launches = 0
