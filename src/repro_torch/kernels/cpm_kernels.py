"""The CPM kernels of the port: the fused instruction stream and the
paged-row moves, each a Hopper kernel beside its plain twin.

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

:func:`gather_rows` and :func:`scatter_rows` replace ``:670`` and
``:698`` of the same JAX file: the sub-page moves of the session pool's
token banks, one ``csrc/rows.cu`` launch each (counted the same way),
with :func:`gather_rows_plain` / :func:`scatter_rows_plain` as twins.

:func:`compare`, :func:`section_sum`, :func:`section_limit` and
:func:`compact` replace ``:273``, ``:230``, ``:367`` and ``:637``: the
per-op kernels of the cuda CPM backend (``csrc/compare.cu``,
``csrc/reduce.cu``, ``csrc/compact.cu``), each beside its ``*_plain``
twin.  :func:`histogram`, :func:`super_sum` / :func:`super_limit` and
:func:`oddeven_sort` replace ``:315``, ``:456`` / ``:466`` and ``:177``
(``csrc/histogram.cu``, ``csrc/super_reduce.cu``,
``csrc/oddeven_sort.cu``), and :func:`substring_match` replaces ``:540``
(``csrc/substring_match.cu``), the same way.  :func:`activate`,
:func:`shift_range`, :func:`template_match` and :func:`stencil` replace
``:89``, ``:133``, ``:496`` and ``:585`` (``csrc/activate.cu``,
``shift_range.cu``, ``template_match.cu``, ``stencil.cu``): the per-op
kernels an ``eager`` group of the cost-priced scheduler replays, each
built on the value body (twin) and lane rule (kernel) the fused stream
uses.  Every TPU kernel of the JAX package now has its Hopper kernel.
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
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("fused_stream", "fused_stream_launch",
                  [P, P, P, P, I, I, I, ctypes.POINTER(_Program)], x.device,
                  x.data_ptr(), out_x.data_ptr(), used_len.data_ptr(),
                  out_ul.data_ptr(), r, n, br, ctypes.byref(prog))
    fused_stream.launches += 1
    return out_x, out_ul, prods


fused_stream.launches = 0


# ---------------------------------------------------------------------------
# paged-row movement (repro_torch.cpm.pool banks): csrc/rows.cu
# ---------------------------------------------------------------------------
#
# Replaces ``src/repro/kernels/cpm_kernels.py:670`` (``gather_rows``) and
# ``:698`` (``scatter_rows``).  Rows move as bytes, so any dtype works.

def gather_rows_plain(x, idx):
    """``(R, N)`` rows at ``(K,)`` ids -> ``(K, N)`` copies; an id outside
    ``[0, R)`` clamps (the pool clips its ids before the call)."""
    r = x.shape[0]
    return x[idx.to(torch.long).clamp(0, r - 1)]


def scatter_rows_plain(dst, idx, src):
    """A new ``(R, N)`` array: row ``idx[i]`` takes ``src[i]`` (ids unique),
    every other row keeps ``dst``; ids outside ``[0, R)`` drop.  Built as
    the TPU kernel builds it: an inverse page map, then a gather over the
    destination rows."""
    r, k = dst.shape[0], idx.shape[0]
    if k == 0:
        return dst.clone()
    ids = idx.to(torch.long)
    ok = (ids >= 0) & (ids < r)
    inv = torch.full((r + 1,), -1, dtype=torch.long, device=dst.device)
    inv[torch.where(ok, ids, r)] = torch.arange(k, device=dst.device)
    inv = inv[:r]                                 # row r + 1 took the drops
    return torch.where((inv >= 0)[:, None], src[inv.clamp(min=0)], dst)


def _rows_check(name, x, idx):
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous (R, N) rows, got shape "
                         f"{tuple(x.shape)}")
    if idx.ndim != 1 or idx.dtype != torch.int32 or idx.device != x.device \
            or not idx.is_contiguous():
        raise ValueError(f"{name}: ids must be a contiguous (K,) int32 "
                         f"tensor on {x.device}")
    if x.shape[0] >= 2 ** 31 or idx.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: more than 2**31 rows")


def _rows_argtypes(nptr: int) -> list:
    return [ctypes.c_void_p] * nptr + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_longlong]


def gather_rows(x, idx):
    """Rows of an ``(R, N)`` bank at ``(K,)`` int32 ids -> ``(K, N)``: one
    ``csrc/rows.cu`` launch for CUDA tensors (counted in
    ``gather_rows.launches``), the plain twin for CPU tensors."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"gather_rows takes CPU or CUDA rows, got "
                         f"{x.device}")
    _rows_check("gather_rows", x, idx)
    r, n = x.shape
    k = idx.shape[0]
    out = torch.empty((k, n), dtype=x.dtype, device=x.device)
    if k == 0 or n == 0:
        return out
    if r == 0:
        raise ValueError("gather_rows from an empty bank")
    _build.launch("rows", "gather_rows_launch", _rows_argtypes(3), x.device,
                  x.data_ptr(), idx.data_ptr(), out.data_ptr(), r, k,
                  n * x.element_size())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def scatter_rows(dst, idx, src):
    """``src`` ``(K, N)`` written into a copy of ``dst`` ``(R, N)`` at
    ``(K,)`` unique int32 ids; ids outside ``[0, R)`` drop.  One
    ``csrc/rows.cu`` launch for CUDA tensors (counted in
    ``scatter_rows.launches``), the plain twin for CPU tensors.  Returns
    the new array; ``dst`` is not written."""
    if dst.device.type == "cpu":
        return scatter_rows_plain(dst, idx, src)
    if dst.device.type != "cuda":
        raise ValueError(f"scatter_rows takes CPU or CUDA rows, got "
                         f"{dst.device}")
    _rows_check("scatter_rows", dst, idx)
    r, n = dst.shape
    k = idx.shape[0]
    if src.shape != (k, n) or src.dtype != dst.dtype \
            or src.device != dst.device or not src.is_contiguous():
        raise ValueError(f"scatter_rows: src must be contiguous ({k}, {n}) "
                         f"{dst.dtype} on {dst.device}, got "
                         f"{tuple(src.shape)} {src.dtype} on {src.device}")
    out = torch.empty_like(dst)
    if r == 0 or n == 0:
        return out
    _build.launch("rows", "scatter_rows_launch", _rows_argtypes(4),
                  dst.device, dst.data_ptr(), idx.data_ptr(), src.data_ptr(),
                  out.data_ptr(), r, k, n * dst.element_size())
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0


# ---------------------------------------------------------------------------
# the per-op kernels of the cuda backend: compare, substring_match,
# section_sum, section_limit and compact (csrc/compare.cu,
# substring_match.cu, reduce.cu, compact.cu)
# ---------------------------------------------------------------------------
#
# Replace ``src/repro/kernels/cpm_kernels.py:273`` (``compare``), ``:540``
# (``substring_match``), ``:230`` (``section_sum``), ``:367``
# (``section_limit``) and ``:637`` (``compact``).  Each plain twin repeats the TPU kernel's arithmetic;
# each wrapper launches its kernel for CUDA tensors (counted in
# ``<name>.launches``) and runs the twin for CPU tensors.

#: the storage dtypes the kernels take, by the code of csrc/cpm_ops.cuh
_DTYPE_CODE = {torch.bool: 0, torch.int8: 1, torch.uint8: 2, torch.int16: 3,
               torch.int32: 4, torch.float16: 5, torch.bfloat16: 6,
               torch.float32: 7}
#: blocks the reductions aim for: about two per SM of the H100's 132
REDUCE_TARGET_BLOCKS = 264
#: no part of a row shorter than this goes to a block of its own
REDUCE_MIN_PART = 8192


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The TPU kernels' accumulator: int32 for integer types, float32 for
    bool and the floats (``_acc_dtype`` of the JAX module)."""
    if dtype.is_floating_point or dtype == torch.bool:
        return torch.float32
    return torch.int32


def _datum(datum, device) -> torch.Tensor:
    """``jnp.asarray(datum)`` with 64-bit types off, on ``device``."""
    # function-level import: the cpm package imports this module
    from repro_torch.cpm._tensor import asarray

    return asarray(datum, device=device)


def _pad_rows(x, section: int, fill):
    """(..., N) -> ((R, N padded to whole sections), nsec, lead shape);
    ``fill`` is a Python scalar or a one-element tensor."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    pad = (-n) % section
    x2 = x.reshape(-1, n)
    if pad:
        if isinstance(fill, torch.Tensor):
            block = fill.to(x.dtype).reshape(1, 1).expand(x2.shape[0], pad)
        else:
            block = torch.full((x2.shape[0], pad), fill, dtype=x.dtype,
                               device=x.device)
        x2 = torch.cat([x2, block], 1)
    return x2, x2.shape[1] // section, lead


def compare_plain(x, datum, op: str = "eq"):
    """Rows against a broadcast datum, as the TPU kernel: both promote to
    one dtype (never truncating the datum), int8 flags, cast to bool."""
    d = _datum(datum, x.device)
    ct = torch.promote_types(x.dtype, d.dtype)
    return _CMP[op](x.to(ct), d.to(ct).reshape(())).to(torch.int8) \
        .to(torch.bool)


def substring_match_plain(hay, needle):
    """Match-END flags of an ``(M,)`` needle in every ``(R, N)`` row ->
    ``(R, N)`` int8, as the TPU kernel: the M-step carry chain (step ``i``
    compares ``needle[i]`` with every lane and ANDs the state shifted one
    lane right, lane 0 reading 0)."""
    idx = torch.arange(hay.shape[-1], device=hay.device)[None, :]
    return _substring_ends_vals(hay, needle.reshape(1, -1),
                                needle.shape[-1], idx).to(torch.int8)


def section_sum_plain(x, section: int = 1024):
    """Two-phase sum of every ``(..., N)`` row: pad to whole sections with
    0, sum each section in the accumulator dtype (phase 1), add the
    section sums in section order (phase 2, ``cumsum``).  Returns
    ``promote(x, acc)``."""
    acc = _acc_dtype(x.dtype)
    xs, nsec, lead = _pad_rows(x, section, 0)
    parts = xs.reshape(-1, nsec, section).to(acc).sum(-1, dtype=acc)
    out = torch.cumsum(parts, dim=-1, dtype=acc)[:, -1]
    return out.reshape(lead).to(torch.promote_types(x.dtype, acc))


def section_limit_plain(x, section: int = 1024, mode: str = "max"):
    """Two-phase max / min of every ``(..., N)`` row: pad to whole sections
    with ``limit_identity(x.dtype, mode)``, reduce each section in the
    accumulator dtype, combine the sections, with ``jnp.max`` /
    ``jnp.min``'s rule (NaN wins, -0.0 < +0.0).  Returns ``x.dtype``."""
    # function-level import: the cpm package imports this module
    from repro_torch.cpm.semantics import limit_identity, limit_reduce

    acc = _acc_dtype(x.dtype)
    xs, nsec, lead = _pad_rows(x, section, limit_identity(x.dtype, mode))
    parts = limit_reduce(xs.reshape(-1, nsec, section).to(acc), mode)
    return limit_reduce(parts, mode).reshape(lead).to(x.dtype)


def histogram_plain(x, edges, section: int = 1024):
    """§6.3 counts of every ``(..., N)`` row in the ``M`` bins of ``(M+1,)``
    edges -> ``(..., M)`` int32, as the TPU kernel: rows and edges promote
    to one dtype, rows pad to whole sections with the top edge, each
    section counts ``x < e`` for every edge and adds its count differences
    (``cum[1:] - cum[:-1]``) to the row's bins."""
    ct = torch.promote_types(x.dtype, edges.dtype)
    x, edges = x.to(ct), edges.to(ct)
    m = edges.shape[-1] - 1
    xs, nsec, lead = _pad_rows(x, section, edges[-1])
    sec = xs.reshape(-1, nsec, section)
    cum = torch.stack([(sec < e).sum(-1, dtype=torch.int32) for e in edges],
                      -1)                             # (R, nsec, M+1)
    bins = (cum[..., 1:] - cum[..., :-1]).sum(1, dtype=torch.int32)
    return bins.reshape(*lead, m)


def super_sum_plain(x, section: int = 1024):
    """§8 sum of every ``(..., N)`` row, as the TPU kernel: pad to whole
    sections with 0, sum each section in the accumulator dtype (phase 1),
    then the log-depth tree over the section partials (phase 2,
    ``tree_combine``'s bracketing).  Returns ``promote(x, acc)``."""
    from repro_torch.cpm.reference.computable import tree_combine

    acc = _acc_dtype(x.dtype)
    xs, nsec, lead = _pad_rows(x, section, 0)
    parts = xs.reshape(-1, nsec, section).to(acc).sum(-1, dtype=acc)
    out = tree_combine(parts, torch.add, 0)
    return out.reshape(lead).to(torch.promote_types(x.dtype, acc))


def super_limit_plain(x, section: int = 1024, mode: str = "max"):
    """§8 max / min of every ``(..., N)`` row, as the TPU kernel: pad with
    ``limit_identity(x.dtype)``, reduce each section in the accumulator
    dtype (phase 1), then the log-depth tree whose missing partners read
    ``limit_identity(acc)``; ``jnp.maximum`` / ``jnp.minimum``'s rule
    throughout.  Returns ``x.dtype``."""
    from repro_torch.cpm.reference.computable import tree_combine
    from repro_torch.cpm.semantics import (limit_identity, limit_reduce,
                                           maximum, minimum)

    acc = _acc_dtype(x.dtype)
    xs, nsec, lead = _pad_rows(x, section, limit_identity(x.dtype, mode))
    parts = limit_reduce(xs.reshape(-1, nsec, section).to(acc), mode)
    out = tree_combine(parts, maximum if mode == "max" else minimum,
                       limit_identity(acc, mode))
    return out.reshape(lead).to(x.dtype)


def oddeven_sort_plain(x, steps: int | None = None):
    """``steps`` (default N) odd-even exchange cycles over every ``(R, N)``
    row, as the TPU kernel's loop: cycle ``i`` has parity ``i % 2``, the
    left lane of a pair takes ``jnp.minimum``, the right ``jnp.maximum``
    (NaN spreads through its pair), lanes without a partner keep their
    value."""
    from repro_torch.cpm.reference.computable import odd_even_sort

    return odd_even_sort(x, steps)


def compact_plain(x, keep, fill=0):
    """Stable §4.2 pack of every ``(R, N)`` row, as the TPU kernel: an
    inclusive Hillis-Steele cumsum of the keep flags, then a lower-bound
    search per output lane for its source lane.  Returns
    ``(packed (R, N), new_len (R,) int32)``."""
    r, n = x.shape
    c = keep.to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=x.device)[None, :]
    for b in range(max(n - 1, 0).bit_length()):
        stride = 1 << b
        sh = torch.roll(c, stride, dims=-1)
        c = c + torch.where(idx >= stride, sh, 0)
    new_len = c[:, n - 1:]
    t = idx + 1
    pos = torch.zeros((r, n), dtype=torch.int32, device=x.device)
    for b in reversed(range(n.bit_length())):
        npos = pos + (1 << b)
        cv = torch.gather(c, 1, torch.clamp(npos - 1, 0, n - 1).long())
        pos = torch.where((npos <= n) & (cv < t), npos, pos)
    gathered = torch.gather(x, 1, torch.clamp(pos, 0, n - 1).long())
    f = _datum(fill, x.device).to(x.dtype)
    return torch.where(t <= new_len, gathered, f), new_len[:, 0]


def _on_card(name: str, x) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (the twin);
    raises for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")
    return True


def _kernel_dtype(name: str, x) -> int:
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"the {name} kernel takes "
                        f"{[str(d) for d in _DTYPE_CODE]}, got {x.dtype} "
                        f"(64-bit types: ROADMAP Queue 1)")
    if not x.is_contiguous():
        raise ValueError(f"the {name} kernel needs contiguous rows")
    return code


def compare(x, datum, op: str = "eq"):
    """Rows vs a broadcast datum -> bool flags of ``x``'s shape: one
    ``csrc/compare.cu`` launch for CUDA tensors (counted in
    ``compare.launches``), the plain twin for CPU tensors.  A datum of
    another dtype promotes both sides first, as the TPU wrapper does; the
    kernel reads the datum on the device, so the call never syncs."""
    if not _on_card("compare", x):
        return compare_plain(x, datum, op)
    if op not in _CMPCODE:
        raise ValueError(f"compare op must be one of {sorted(_CMPCODE)}, "
                         f"got {op!r}")
    d = _datum(datum, x.device)
    if d.numel() != 1:
        raise ValueError(f"compare: the datum must be one element, got "
                         f"shape {tuple(d.shape)}")
    ct = torch.promote_types(x.dtype, d.dtype)
    x, d = x.to(ct), d.to(ct).reshape(1)
    code = _kernel_dtype("compare", x)
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("compare", "compare_launch",
                  [P, P, P, ctypes.c_longlong, I, I], x.device,
                  x.data_ptr(), d.data_ptr(), out.data_ptr(), x.numel(),
                  code, _CMPCODE[op])
    compare.launches += 1
    return out


compare.launches = 0


def substring_match(hay, needle):
    """Match-END flags of an ``(M,)`` needle in every ``(R, N)`` row ->
    ``(R, N)`` int8: one ``csrc/substring_match.cu`` launch for CUDA
    tensors (counted in ``substring_match.launches``), the plain twin for
    CPU tensors.  A needle of another dtype promotes both sides first, as
    the twin's ``==`` does; the kernel reads the needle on the device, so
    the call never syncs."""
    if not _on_card("substring_match", hay):
        return substring_match_plain(hay, needle)
    if hay.ndim != 2:
        raise ValueError(f"substring_match takes (R, N) rows, got shape "
                         f"{tuple(hay.shape)}")
    if needle.ndim != 1 or needle.device != hay.device:
        raise ValueError(f"substring_match: the needle must be (M,) on "
                         f"{hay.device}, got {tuple(needle.shape)} on "
                         f"{needle.device}")
    ct = torch.promote_types(hay.dtype, needle.dtype)
    hay, needle = hay.to(ct).contiguous(), needle.to(ct).contiguous()
    code = _kernel_dtype("substring_match", hay)
    r, n = hay.shape
    out = torch.empty((r, n), dtype=torch.int8, device=hay.device)
    if r == 0 or n == 0:
        return out
    if r >= 2 ** 31 or needle.shape[0] >= 2 ** 31:
        raise ValueError("substring_match: more than 2**31 rows or needle "
                         "items")
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("substring_match", "substring_match_launch",
                  [P, P, P, I, ctypes.c_longlong, I, I], hay.device,
                  hay.data_ptr(), needle.data_ptr(), out.data_ptr(), r, n,
                  needle.shape[0], code)
    substring_match.launches += 1
    return out


substring_match.launches = 0


def reduce_plan(r: int, n: int, section: int) -> tuple[int, int]:
    """``(parts, part_len)`` of the split-pass reductions: each row splits
    into ``parts`` runs of whole sections, enough runs over all rows for
    about :data:`REDUCE_TARGET_BLOCKS` blocks, none shorter than
    :data:`REDUCE_MIN_PART` lanes unless it is the whole row."""
    nsec = -(-n // section)
    want = max(1, min(-(-REDUCE_TARGET_BLOCKS // max(r, 1)),
                      n // REDUCE_MIN_PART, nsec))
    per = -(-nsec // want)                   # sections per part
    return -(-nsec // per), per * section


def _reduce(name: str, x, section, out_dtype, *extra):
    """Launch ``<name>_launch`` of ``csrc/reduce.cu`` over the rows of
    ``x`` with the split plan of :func:`reduce_plan`; ``extra`` are the
    entry point's int arguments after the dtype code."""
    section = int(section)
    if section < 1:
        raise ValueError(f"{name}: section must be positive, got {section}")
    n = x.shape[-1]
    if x.ndim == 0 or n == 0:
        raise ValueError(f"{name} needs rows of at least one lane")
    code = _kernel_dtype(name, x)
    x2 = x.reshape(-1, n)
    r = x2.shape[0]
    if r >= 2 ** 31:
        raise ValueError(f"{name}: more than 2**31 rows")
    parts, part_len = reduce_plan(r, n, section)
    out = torch.empty((r,), dtype=out_dtype, device=x.device)
    partials = torch.empty((r, parts) if parts > 1 else (0,),
                           dtype=_acc_dtype(x.dtype), device=x.device)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _build.launch("reduce", f"{name}_launch",
                  [P, P, P, I, L, I, L, I] + [I] * len(extra), x.device,
                  x2.data_ptr(), out.data_ptr(), partials.data_ptr(), r, n,
                  parts, part_len, code, *extra)
    return out.reshape(x.shape[:-1])


def section_sum(x, section: int = 1024):
    """Two-phase sum of every ``(..., N)`` row -> ``(...)`` in
    ``promote(x, acc)`` (int32 for integer rows, float32 otherwise): one
    ``csrc/reduce.cu`` call for CUDA tensors (one or two device launches,
    counted once in ``section_sum.launches``), the plain twin for CPU
    tensors."""
    if not _on_card("section_sum", x):
        return section_sum_plain(x, section)
    out = _reduce("section_sum", x, section, _acc_dtype(x.dtype))
    section_sum.launches += 1
    return out


section_sum.launches = 0


def section_limit(x, section: int = 1024, mode: str = "max"):
    """Two-phase max / min of every ``(..., N)`` row -> ``(...)`` in
    ``x.dtype``, NaN propagating: one ``csrc/reduce.cu`` call for CUDA
    tensors (one or two device launches, counted once in
    ``section_limit.launches``), the plain twin for CPU tensors."""
    if not _on_card("section_limit", x):
        return section_limit_plain(x, section, mode)
    if mode not in ("max", "min"):
        raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
    out = _reduce("section_limit", x, section, x.dtype, int(section),
                  0 if mode == "max" else 1)
    section_limit.launches += 1
    return out


section_limit.launches = 0


def compact(x, keep, fill=0):
    """Stable §4.2 pack of every ``(R, N)`` row under ``(R, N)`` keep flags
    -> ``(packed (R, N), new_len (R,) int32)``: one ``csrc/compact.cu``
    call for CUDA tensors (three device launches: tile counts, their scan,
    the scatter; counted once in ``compact.launches``), the plain twin for
    CPU tensors.  Elements move as 1-, 2- or 4-byte words."""
    if not _on_card("compact", x):
        return compact_plain(x, keep, fill)
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"compact takes contiguous (R, N) rows, got shape "
                         f"{tuple(x.shape)}")
    if x.element_size() not in (1, 2, 4):
        raise TypeError(f"the compact kernel moves 1-, 2- or 4-byte "
                        f"elements, got {x.dtype} (64-bit types: ROADMAP "
                        f"Queue 1)")
    r, n = x.shape
    if keep.shape != x.shape or keep.device != x.device \
            or keep.dtype != torch.bool or not keep.is_contiguous():
        raise ValueError(f"compact: keep must be contiguous ({r}, {n}) "
                         f"bool on {x.device}, got {tuple(keep.shape)} "
                         f"{keep.dtype} on {keep.device}")
    f = _datum(fill, x.device)
    if f.numel() != 1:
        raise ValueError(f"compact: fill must be one element, got shape "
                         f"{tuple(f.shape)}")
    f = f.to(x.dtype).reshape(1)
    out = torch.empty_like(x)
    if r == 0 or n == 0:
        return out, torch.zeros((r,), dtype=torch.int32, device=x.device)
    if n >= 2 ** 31:
        raise ValueError("compact: rows of 2**31 lanes or more")
    tile = _build.load("compact").compact_tile    # lanes per tile
    tile.argtypes, tile.restype = [], ctypes.c_int
    new_len = torch.empty((r,), dtype=torch.int32, device=x.device)
    scratch = torch.empty((2 * r * -(-n // tile()),), dtype=torch.int32,
                          device=x.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("compact", "compact_launch",
                  [P, P, P, P, P, P, I, ctypes.c_longlong, I], x.device,
                  x.data_ptr(), keep.data_ptr(), f.data_ptr(),
                  out.data_ptr(), new_len.data_ptr(), scratch.data_ptr(), r,
                  n, x.element_size())
    compact.launches += 1
    return out, new_len


compact.launches = 0


#: lanes of the per-edge counts a thread keeps: must equal HIST_THREADS *
#: HIST_MAX_EPT in csrc/histogram.cu
HISTOGRAM_MAX_EDGES = 4096


def histogram(x, edges, section: int = 1024):
    """§6.3 counts of every ``(..., N)`` row in the ``M`` bins of ``(M+1,)``
    edges -> ``(..., M)`` int32: one ``csrc/histogram.cu`` call for CUDA
    tensors (two device launches, the counts and their differences;
    counted once in ``histogram.launches``), the plain twin for CPU
    tensors.  Rows and edges promote to one dtype first, as the TPU
    wrapper does."""
    if not _on_card("histogram", x):
        return histogram_plain(x, edges, section)
    section = int(section)
    if section < 1:
        raise ValueError(f"histogram: section must be positive, got "
                         f"{section}")
    if edges.ndim != 1 or edges.device != x.device:
        raise ValueError(f"histogram: edges must be (M+1,) on {x.device}, "
                         f"got {tuple(edges.shape)} on {edges.device}")
    e = edges.shape[0]
    if not 2 <= e <= HISTOGRAM_MAX_EDGES:
        raise ValueError(f"the histogram kernel takes 2 to "
                         f"{HISTOGRAM_MAX_EDGES} edges, got {e}")
    n = x.shape[-1]
    if x.ndim == 0 or n == 0:
        raise ValueError("histogram needs rows of at least one lane")
    ct = torch.promote_types(x.dtype, edges.dtype)
    x, edges = x.to(ct).contiguous(), edges.to(ct).contiguous()
    code = _kernel_dtype("histogram", x)
    x2 = x.reshape(-1, n)
    r = x2.shape[0]
    if r >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("histogram: more than 2**31 rows or lanes")
    parts, part_len = reduce_plan(r, n, section)
    counts = torch.empty((r, parts, e), dtype=torch.int32, device=x.device)
    out = torch.empty((r, e - 1), dtype=torch.int32, device=x.device)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _build.launch("histogram", "histogram_launch",
                  [P, P, P, P, I, L, I, L, I, L, I], x.device,
                  x2.data_ptr(), edges.data_ptr(), counts.data_ptr(),
                  out.data_ptr(), r, n, parts, part_len, e,
                  (-n) % section, code)
    histogram.launches += 1
    return out.reshape(*x.shape[:-1], e - 1)


histogram.launches = 0

#: partials a row's §8 tree holds in shared memory: SUPER_MAX_NSEC of
#: csrc/super_reduce.cu
SUPER_MAX_NSEC = 58112
_SUPER_OP = {"sum": 0, "max": 1, "min": 2}


def _super(name, x, section, mode):
    """One ``csrc/super_reduce.cu`` call (phase 1 partials, phase 2 tree)
    over the rows of ``x``."""
    section = int(section)
    if section < 1:
        raise ValueError(f"{name}: section must be positive, got {section}")
    n = x.shape[-1]
    if x.ndim == 0 or n == 0:
        raise ValueError(f"{name} needs rows of at least one lane")
    x = x.contiguous()
    code = _kernel_dtype(name, x)
    x2 = x.reshape(-1, n)
    r = x2.shape[0]
    nsec = -(-n // section)
    if r >= 2 ** 31 or nsec > SUPER_MAX_NSEC:
        raise ValueError(
            f"{name}: {nsec} sections of {section} lanes, more than the "
            f"{SUPER_MAX_NSEC} partials a row's tree holds in shared memory "
            f"(or more than 2**31 rows); take a section of at least "
            f"{-(-n // SUPER_MAX_NSEC)} lanes")
    acc = _acc_dtype(x.dtype)
    out = torch.empty((r,), dtype=acc if mode == "sum" else x.dtype,
                      device=x.device)
    partials = torch.empty((r, nsec), dtype=acc, device=x.device)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _build.launch("super_reduce", "super_reduce_launch",
                  [P, P, P, I, L, L, I, I, I], x.device, x2.data_ptr(),
                  out.data_ptr(), partials.data_ptr(), r, n, section, nsec,
                  code, _SUPER_OP[mode])
    return out.reshape(x.shape[:-1])


def super_sum(x, section: int = 1024):
    """§8 sum of every ``(..., N)`` row -> ``(...)`` in ``promote(x, acc)``
    (int32 for integer rows, float32 otherwise; integer sums equal
    :func:`section_sum` bit for bit): one ``csrc/super_reduce.cu`` call
    for CUDA tensors (two device launches, the section partials and the
    log-depth tree; counted once in ``super_sum.launches``), the plain
    twin for CPU tensors."""
    if not _on_card("super_sum", x):
        return super_sum_plain(x, section)
    out = _super("super_sum", x, section, "sum")
    super_sum.launches += 1
    return out


super_sum.launches = 0


def super_limit(x, section: int = 1024, mode: str = "max"):
    """§8 max / min of every ``(..., N)`` row -> ``(...)`` in ``x.dtype``
    (NaN wins, -0.0 < +0.0): one ``csrc/super_reduce.cu`` call for CUDA
    tensors (two device launches; counted once in
    ``super_limit.launches``), the plain twin for CPU tensors."""
    if not _on_card("super_limit", x):
        return super_limit_plain(x, section, mode)
    if mode not in ("max", "min"):
        raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
    out = _super("super_limit", x, section, mode)
    super_limit.launches += 1
    return out


super_limit.launches = 0


#: lanes of a row one block of the sort holds (16 a thread in registers,
#: 1024 threads): SORT_TILE of csrc/oddeven_sort.cu
SORT_TILE = 16384


def oddeven_plan(n: int, steps: int,
                 tile: int = SORT_TILE) -> tuple[int, int, int]:
    """``(interior, halo, passes)`` of :func:`oddeven_sort`'s tiles: a row
    of at most ``tile`` lanes is one tile for all ``steps``; a longer row
    takes tiles of ``interior`` lanes with ``halo`` lanes more on each
    side (at most a quarter of the tile), in ``passes`` passes of at most
    ``halo`` cycles."""
    if n <= tile:
        return n, 0, 1
    if steps == 0:
        return tile, 0, 1
    halo = min(steps, tile // 4)
    return tile - 2 * halo, halo, -(-steps // halo)


def oddeven_sort(x, steps: int | None = None):
    """``steps`` (default N) odd-even exchange cycles over every ``(R, N)``
    row -> ``(R, N)`` of ``x.dtype``, bit for bit the twin's: one
    ``csrc/oddeven_sort.cu`` call for CUDA tensors (one device launch a
    pass; rows longer than :data:`SORT_TILE` lanes take
    ``oddeven_plan``'s halo passes; counted once in
    ``oddeven_sort.launches``), the plain twin for CPU tensors."""
    if not _on_card("oddeven_sort", x):
        return oddeven_sort_plain(x, steps)
    if x.ndim != 2:
        raise ValueError(f"oddeven_sort takes (R, N) rows, got shape "
                         f"{tuple(x.shape)}")
    code = _kernel_dtype("oddeven_sort", x)
    r, n = x.shape
    steps = n if steps is None else int(steps)
    if steps < 0 or steps >= 2 ** 31:
        raise ValueError(f"oddeven_sort: steps must be in [0, 2**31), got "
                         f"{steps}")
    out = torch.empty_like(x)
    if r == 0 or n == 0:
        return out
    if r >= 2 ** 31:
        raise ValueError("oddeven_sort: more than 2**31 rows")
    interior, halo, passes = oddeven_plan(n, steps)
    scratch = torch.empty_like(x) if passes > 1 else None
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _build.launch("oddeven_sort", "oddeven_sort_launch",
                  [P, P, P, I, L, L, L, L, I, I], x.device, x.data_ptr(),
                  out.data_ptr(), None if scratch is None
                  else scratch.data_ptr(), r, n, steps, interior, halo,
                  passes, code)
    oddeven_sort.launches += 1
    return out


oddeven_sort.launches = 0


# ---------------------------------------------------------------------------
# the per-op kernels an eager group replays: activate, shift_range,
# template_match and stencil (csrc/activate.cu, shift_range.cu,
# template_match.cu, stencil.cu)
# ---------------------------------------------------------------------------
#
# Replace ``src/repro/kernels/cpm_kernels.py:89`` (``activate``), ``:133``
# (``shift_range``), ``:496`` (``template_match``) and ``:585``
# (``stencil``).  Each twin is built on the value body that
# :func:`fused_stream_plain` uses (``_activate_vals``, ``_shift_vals``,
# ``_sad_vals``, ``_stencil_vals``), as each kernel is built on the lane
# rule that ``csrc/fused_stream.cu`` uses (``csrc/cpm_ops.cuh``), so a
# group replayed op by op equals the fused group bit for bit.  Dynamic
# scalars (``start``, ``end``, ``carry``) reach the kernels as int32
# device tensors, never through a host read.

def _scalars(device, *vals) -> torch.Tensor:
    """``jnp.asarray(v, int32)`` of each scalar, stacked into one
    contiguous ``(k,)`` tensor on ``device``: the kernels read it there,
    so a value an earlier kernel produced needs no host read."""
    from repro_torch.cpm._tensor import asarray

    return torch.stack([asarray(v, torch.int32, device).reshape(())
                        for v in vals]).contiguous()


def _scalar_device(device, *vals) -> torch.device:
    from repro_torch.cpm._tensor import device_of

    return torch.device(device) if device is not None else device_of(*vals)


def activate_plain(n: int, start, end, carry=1, *, device=None):
    """Rule-4 activation mask of length ``n`` -> ``(n,)`` bool, as the TPU
    kernel: ``_activate_vals`` over the lane addresses, int8 flags cast to
    bool."""
    dev = _scalar_device(device, start, end, carry)
    p = _scalars(dev, start, end, carry)
    idx = torch.arange(int(n), dtype=torch.int32, device=dev)
    return _activate_vals(idx, p[0], p[1], p[2]).to(torch.int8) \
        .to(torch.bool)


def activate(n: int, start, end, carry=1, *, device=None):
    """Rule-4 activation mask of length ``n`` -> ``(n,)`` bool on
    ``device`` (default: where a tensor scalar lies, else the card, as
    every entry point: ``repro_torch.resolve_device``, which raises
    without one): one ``csrc/activate.cu`` launch for a CUDA device
    (counted in ``activate.launches``), the plain twin on the CPU."""
    if device is None and not any(isinstance(v, torch.Tensor)
                                  for v in (start, end, carry)):
        from repro_torch import resolve_device

        device = resolve_device(None)
    dev = _scalar_device(device, start, end, carry)
    if dev.type == "cpu":
        return activate_plain(n, start, end, carry, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"activate runs on the CPU or CUDA, got {dev}")
    n = int(n)
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"activate: n must be in [0, 2**31), got {n}")
    p = _scalars(dev, start, end, carry)
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    P = ctypes.c_void_p
    _build.launch("activate", "activate_launch", [P, P, ctypes.c_int], dev,
                  p.data_ptr(), out.data_ptr(), n)
    activate.launches += 1
    return out


activate.launches = 0


def _shift_fill(x, fill):
    """The fill as one element of ``x``'s dtype on its device: the TPU
    kernel's ``jnp.asarray(fill, x.dtype)`` inside its jit, which takes a
    Python scalar at 32 bits first and then casts (wrapping an int)."""
    from repro_torch.cpm._tensor import asarray

    f = asarray(fill, device=x.device).to(x.dtype)
    if f.numel() != 1:
        raise ValueError(f"shift_range: fill must be one element, got "
                         f"shape {tuple(f.shape)}")
    return f.reshape(1).contiguous()


def _static_shift(shift) -> int:
    shift = int(shift)
    if not -2 ** 31 < shift < 2 ** 31:
        raise ValueError(f"shift_range: shift must fit int32, got {shift}")
    return shift


def _shift_bounds(x, start, end):
    """``start`` / ``end`` as the kernel reads them: one int32 ``(1, 2)``
    pair for every row, or an ``(R, 2)`` pair a row where either is an
    ``(R,)`` tensor (per-row bounds, e.g. a batched device's per-row
    ``used_len - 1``).  Returns ``(pairs, per_row)``."""
    from repro_torch.cpm._tensor import asarray

    r = x.shape[0] if x.ndim == 2 else 1
    s, e = (asarray(v, torch.int32, x.device) for v in (start, end))
    s, e = (v.reshape(()) if v.numel() == 1 else v for v in (s, e))
    if s.ndim == 0 and e.ndim == 0:
        return torch.stack([s, e]).reshape(1, 2).contiguous(), False
    for v in (s, e):
        if v.ndim > 1 or (v.ndim == 1 and (x.ndim != 2 or len(v) != r)):
            raise ValueError(f"shift_range: start / end must be scalars or "
                             f"({r},) per-row bounds for rows of shape "
                             f"{tuple(x.shape)}, got shape {tuple(v.shape)}")
    return torch.stack([s.expand(r), e.expand(r)], dim=1).contiguous(), True


def shift_range_plain(x, start, end, shift: int = 1, fill=None):
    """§4.1 move of lanes ``[start, end]`` of every ``(R, N)`` row by a
    static ``shift``, as the TPU kernel: ``_shift_vals`` with the fill
    cast to ``x.dtype``; vacated lanes keep their content unless ``fill``
    is given, content crossing the row ends is dropped.  ``start`` /
    ``end`` are scalars or ``(R,)`` per-row bounds."""
    n = x.shape[-1]
    se, per_row = _shift_bounds(x, start, end)
    lo, hi = (se[:, 0:1], se[:, 1:2]) if per_row else (se[0, 0], se[0, 1])
    f = None if fill is None else _shift_fill(x, fill)[0]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)[None, :]
    return _shift_vals(x, idx, lo, hi, _static_shift(shift), n, f)


def shift_range(x, start, end, shift: int = 1, fill=None):
    """§4.1 range move of every ``(R, N)`` row -> a new ``(R, N)`` array of
    ``x.dtype``: one ``csrc/shift_range.cu`` launch for CUDA tensors
    (counted in ``shift_range.launches``; rows move as 1-, 2-, 4- or
    8-byte words, so any dtype), the plain twin for CPU tensors.
    ``start`` / ``end`` are scalars or ``(R,)`` per-row bounds, and may be
    device tensors: the kernel reads them on the card, so the call never
    syncs, and rows of different bounds still move in one launch."""
    if not _on_card("shift_range", x):
        return shift_range_plain(x, start, end, shift, fill)
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"shift_range takes contiguous (R, N) rows, got "
                         f"shape {tuple(x.shape)}")
    size = x.element_size()
    if size not in (1, 2, 4, 8):
        raise TypeError(f"the shift_range kernel moves 1-, 2-, 4- or 8-byte "
                        f"elements, got {x.dtype}")
    shift = _static_shift(shift)
    r, n = x.shape
    if r >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("shift_range: more than 2**31 rows or lanes")
    se, per_row = _shift_bounds(x, start, end)
    f = None if fill is None else _shift_fill(x, fill)
    out = torch.empty_like(x)
    if r == 0 or n == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("shift_range", "shift_range_launch",
                  [P, P, P, I, P, I, I, I, I], x.device, x.data_ptr(),
                  out.data_ptr(), se.data_ptr(), 2 if per_row else 0,
                  None if f is None else f.data_ptr(), r, n, shift, size)
    shift_range.launches += 1
    return out


shift_range.launches = 0

#: lanes a template_match block computes (TM_TILE of
#: csrc/template_match.cu): it stages TM_TILE + 2 M - 1 float32 values
TEMPLATE_TILE = 256
#: the longest template whose tile halo and items fit a block's shared
#: memory on the H100 (MAX_SMEM_BYTES)
TEMPLATE_MAX_M = (MAX_SMEM_BYTES // 4 - TEMPLATE_TILE + 1) // 2


def template_match_plain(data, template):
    """§7.6 sliding SAD of an ``(M,)`` template at every start of every
    ``(R, N)`` row -> ``(R, N)`` float32, as the TPU kernel: ``_sad_vals``
    over the rows cast to float32, ``j = 0 .. M-1`` in order, the tail
    wrapping."""
    return _sad_vals(data.to(torch.float32), template.reshape(1, -1),
                     template.shape[-1])


def template_match(data, template):
    """§7.6 sliding SAD -> ``(R, N)`` float32: one ``csrc/template_match.cu``
    launch for CUDA tensors (counted in ``template_match.launches``; a
    template of at most :data:`TEMPLATE_MAX_M` items), the plain twin
    for CPU tensors."""
    if not _on_card("template_match", data):
        return template_match_plain(data, template)
    if data.ndim != 2:
        raise ValueError(f"template_match takes (R, N) rows, got shape "
                         f"{tuple(data.shape)}")
    code = _kernel_dtype("template_match", data)
    if template.ndim != 1 or template.device != data.device:
        raise ValueError(f"template_match: the template must be (M,) on "
                         f"{data.device}, got {tuple(template.shape)} on "
                         f"{template.device}")
    t = template.to(torch.float32).contiguous()
    m = t.shape[0]
    if m > TEMPLATE_MAX_M:
        raise ValueError(f"the template_match kernel takes templates of at "
                         f"most {TEMPLATE_MAX_M} items (its tile halo and "
                         f"the items in shared memory), got {m}")
    r, n = data.shape
    if r >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("template_match: more than 2**31 rows or lanes")
    out = torch.empty((r, n), dtype=torch.float32, device=data.device)
    if r == 0 or n == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("template_match", "template_match_launch",
                  [P, P, P, I, I, I, I], data.device, data.data_ptr(),
                  t.data_ptr(), out.data_ptr(), r, n, m, code)
    template_match.launches += 1
    return out


template_match.launches = 0

#: must equal ST_MAX_TAPS in csrc/stencil.cu
STENCIL_MAX_TAPS = 64


class _StTaps(ctypes.Structure):
    _fields_ = [("ntaps", ctypes.c_int), ("wrap", ctypes.c_int),
                ("w", ctypes.c_float * STENCIL_MAX_TAPS)]


def stencil_plain(x, taps, wrap: bool = True):
    """§7.3 taps over every ``(R, N)`` row -> ``(R, N)`` float32, as the TPU
    kernel: ``_stencil_vals`` over the rows cast to float32 (fixed tap
    order, zero taps skipped; ``wrap=False`` zero-pads the row ends)."""
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)[None, :]
    return _stencil_vals(x.to(torch.float32), idx,
                         tuple(float(t) for t in taps), bool(wrap), n)


def stencil(x, taps, wrap: bool = True):
    """§7.3 tap stencil -> ``(R, N)`` float32: one ``csrc/stencil.cu``
    launch for CUDA tensors (counted in ``stencil.launches``; at most
    :data:`STENCIL_MAX_TAPS` taps), the plain twin for CPU tensors."""
    taps = tuple(float(t) for t in taps)
    if not _on_card("stencil", x):
        return stencil_plain(x, taps, wrap)
    if x.ndim != 2:
        raise ValueError(f"stencil takes (R, N) rows, got shape "
                         f"{tuple(x.shape)}")
    code = _kernel_dtype("stencil", x)
    if len(taps) > STENCIL_MAX_TAPS:
        raise ValueError(f"the stencil kernel takes at most "
                         f"{STENCIL_MAX_TAPS} taps, got {len(taps)}")
    st = _StTaps(ntaps=len(taps), wrap=int(bool(wrap)))
    for j, w in enumerate(taps):
        st.w[j] = w
        if w != 0 and st.w[j] == 0:
            # the kernel skips zero taps by their float32 value
            raise ValueError(f"stencil tap {w!r} underflows float32")
    r, n = x.shape
    if r >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("stencil: more than 2**31 rows or lanes")
    out = torch.empty((r, n), dtype=torch.float32, device=x.device)
    if r == 0 or n == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("stencil", "stencil_launch",
                  [P, P, I, I, I, ctypes.POINTER(_StTaps)], x.device,
                  x.data_ptr(), out.data_ptr(), r, n, code,
                  ctypes.byref(st))
    stencil.launches += 1
    return out


stencil.launches = 0
