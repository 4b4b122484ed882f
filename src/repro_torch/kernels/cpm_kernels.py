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
for CUDA tensors (counted in ``fused_stream.launches``), which runs rows
of any length in tiles with halos as :func:`fused_plan` lays them out
(:func:`fused_stream_tiled_plain` replays that plan on the CPU), and runs
the plain twin for CPU tensors.

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
``csrc/oddeven_sort.cu``: bounded sorts run the exchange cycles, full
sorts a bitonic network on the rows without NaN, :func:`bitonic_plan`),
and :func:`substring_match` replaces ``:540``
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
import functools
from typing import NamedTuple

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

#: must equal FS_MAX_INSTR / FS_MAX_TAPS in csrc/fused_stream.cu
MAX_INSTR = 16
MAX_TAPS = 64
#: shared memory a block may use on the H100
MAX_SMEM_BYTES = 232448

_OPCODE = {op: i for i, op in enumerate(
    ("activate", "shift", "insert", "delete", "truncate", "compare",
     "substring_match", "template_match", "stencil"))}
_CMPCODE = {op: i for i, op in enumerate(("eq", "ne", "lt", "gt", "le",
                                          "ge"))}
_F_FILL, _F_MASK, _F_START, _F_TAIL, _F_WRAP, _F_CTF = 1, 2, 4, 8, 16, 32
_DT = {torch.int32: 0, torch.float32: 1}


# ---------------------------------------------------------------------------
# the kernel's tiles, halos and passes, and their CPU twin
# ---------------------------------------------------------------------------

#: csrc/fused_stream.cu's blocks write outputs FS_GROUP lanes a thread at
#: once (16-byte stores); a window's two buffers are padded by FS_PAD lanes
#: on either side and rounded up to 32-word blocks
FS_GROUP, FS_PAD = 16, 16
#: tiles of at most FS_TILE interior lanes, halved (not under FS_MIN_TILE)
#: while the rows' tiles would not give each of the H100's 132 SMs a block,
#: and at least four times the halos, so that they add at most a quarter
#: (wider tiles ran faster on the probe stream, PERF.md §6)
FS_TILE, FS_MIN_TILE, FS_TARGET_BLOCKS = 8192, 1024, 132
#: the most halo a pass takes on either side: an instruction that would
#: need more leads a pass of its own, which reads device memory
FS_HALO_CAP = 2048
#: the longest window whose two padded buffers fit a block's shared memory
FS_MAX_WINDOW = MAX_SMEM_BYTES // 8 - 2 * FS_PAD


class FusedPlan(NamedTuple):
    """How ``csrc/fused_stream.cu`` runs one stream over ``(R, N)`` rows:
    every row cut into ``tiles`` tiles of ``tile`` interior lanes, each
    staged with ``halo_l`` lanes before it and ``halo_r`` after it (its
    window, lanes taken modulo N); ``passes`` the ``(first, end, lead)``
    instruction ranges that run between two trips of the rows through
    device memory, ``lead`` where the range's first instruction reads
    device memory rather than the window."""

    tile: int
    halo_l: int
    halo_r: int
    tiles: int
    passes: tuple

    @property
    def window(self) -> int:
        """Slots a window holds: the tile, its halos and up to 3 lanes that
        align its first slot to 16 bytes of the row, rounded up to 4."""
        return (self.halo_l + self.tile + self.halo_r + 6) // 4 * 4

    def smem(self) -> int:
        """Bytes of shared memory a block takes: two buffers of the window
        padded by FS_PAD slots either side, in whole 32-word blocks
        (``fs_buffer`` of the kernel)."""
        return 8 * ((self.window + 2 * FS_PAD + 31) // 32 * 32)


def fused_reach(op: str, statics, n: int) -> tuple[str, int, int]:
    """``(kind, left, right)`` of one instruction on ``n``-lane rows: a
    ``"move"`` makes lane i from lane i - left or i + right (shift by
    ``|shift|``, insert by k from the left, delete by k from the right;
    nothing moves where that is N or more); a ``"producer"`` reads lanes up
    to ``left`` before and ``right`` after the lane it writes
    (substring_match m - 1 before its end or after its start, both
    inside the row; template_match m - 1 after, wrapping; a stencil of T
    taps T - 1 - T // 2 before and T // 2 after, wrapping or not);
    ``"none"`` reads no other lane."""
    s = dict(statics)
    if op in ("shift", "insert", "delete"):
        sh = int(s["shift"]) if op == "shift" else \
            int(s["k"]) * (1 if op == "insert" else -1)
        if abs(sh) >= n:
            sh = 0
        return "move", max(sh, 0), max(-sh, 0)
    if op == "substring_match":
        m = int(s["m"])
        reach = m - 1 if 1 <= m <= n else 0
        return ("producer", reach, 0) if s["where"] == "end" else \
            ("producer", 0, reach)
    if op == "template_match":
        return "producer", 0, max(int(s["m"]) - 1, 0)
    if op == "stencil":
        nt = len(s["taps"])
        return "producer", max(nt - 1 - nt // 2, 0), nt // 2
    return "none", 0, 0


@functools.lru_cache(maxsize=256)
def fused_plan(r: int, n: int, statics, *, tile: int | None = None,
               cap: int = FS_HALO_CAP) -> FusedPlan:
    """The :class:`FusedPlan` of the stream ``statics`` (its ``(op,
    statics)`` pairs) over ``r`` rows of ``n`` lanes; reads nothing on the
    device.  A pass's halos on either side are the larger of its moves'
    summed reach and, for each producer, its own reach plus the reach of
    the moves before it in the pass.  Instructions join the open pass
    while its halos stay within ``cap``; one that would take more leads a
    new pass, reading device memory (a move or producer of any reach).
    The halos are the largest of any pass.  ``tile``: see the FS_*
    constants (default), or as given."""
    passes, first, lead = [], 0, False
    ml = mr = hl = hr = 0               # the open pass's reach and halos
    halo_l = halo_r = 0
    for s, (op, st) in enumerate(statics):
        kind, a, b = fused_reach(op, st, n)
        if kind == "none":
            continue
        if kind == "move":
            nml, nmr = ml + a, mr + b
            nhl, nhr = max(hl, nml), max(hr, nmr)
        else:
            nml, nmr = ml, mr
            nhl, nhr = max(hl, ml + a), max(hr, mr + b)
        if nhl <= cap and nhr <= cap:
            ml, mr, hl, hr = nml, nmr, nhl, nhr
            continue
        if s > first:
            passes.append((first, s, lead))
            halo_l, halo_r = max(halo_l, hl), max(halo_r, hr)
        first, lead = s, True
        ml = mr = hl = hr = 0
    passes.append((first, len(statics), lead))
    halo_l, halo_r = max(halo_l, hl), max(halo_r, hr)
    n16 = -(-max(n, 1) // FS_GROUP) * FS_GROUP
    if tile is None:
        tile = min(FS_TILE, n16)
        while tile > FS_MIN_TILE and r * -(-n // tile) < FS_TARGET_BLOCKS:
            tile = max(FS_MIN_TILE, tile // 2 // FS_GROUP * FS_GROUP)
        tile = max(tile, min(n16, -(-4 * (halo_l + halo_r) // FS_GROUP)
                             * FS_GROUP))
        tile = min(tile, (FS_MAX_WINDOW - halo_l - halo_r - 6)
                   // FS_GROUP * FS_GROUP)
    if tile < 1:
        raise ValueError(f"fused_plan: halos of {halo_l} + {halo_r} lanes "
                         f"leave no tile")
    return FusedPlan(int(tile), halo_l, halo_r, -(-n // tile),
                     tuple(passes))


def _wrap32(v):
    """int64 tensor values wrapped to int32, as the kernel's int32 adds."""
    return ((v + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _tile_move(op, s, refs, q, n: int, ul, read):
    """One move at the window lanes ``q`` (int64, (R, tiles, W)): the word
    each lane holds afterwards.  ``read(src)`` returns the words at the
    source lanes ``src`` (a lane's own or its move source); a (R, 1, 1)
    per-row ``ul`` is the length register before the move."""
    if op == "shift":
        st, en = refs[0][:, 0, None, None], refs[0][:, 1, None, None]
        hf = bool(s["has_fill"])
        src = shift_src_plain(q, n, st, en, int(s["shift"]), hf)
        out = read(src.clamp(min=0))
        if hf:
            out = torch.where(src < 0, refs[1][:, 0, None, None], out)
        return out
    k = int(s["k"])
    pos = refs[0][:, 0, None, None].to(torch.int64)
    ul64 = ul.to(torch.int64)
    if op == "insert":
        src = shift_src_plain(q, n, pos, _wrap32(ul64 - 1), k, False)
        out = read(src)
        d = (q - pos) & 0xFFFFFFFF                   # v[i - pos], i - pos < k
        hit = d < k
        v = refs[1].unsqueeze(1).expand(-1, q.shape[1], -1)
        vals = v.gather(-1, torch.where(hit, d, 0))
        return torch.where(hit, vals, out)
    src = shift_src_plain(q, n, _wrap32(pos + k), _wrap32(ul64 - 1), -k,
                          False)
    out = read(src)
    dead = (q >= _wrap32(ul64 - k)) & (q < ul64)
    return torch.where(dead, refs[1][:, 0, None, None], out)


def _tile_produce(op, s, refs, i, n: int, ul, read, real, taps):
    """One producer's outputs at the interior lanes ``i`` (int64, (R,
    tiles, T)).  ``read(d, where)`` returns the words at lanes ``i + d``
    (taken modulo N), asserting they were staged where ``where`` holds."""
    if op == "activate":
        p = refs[0][:, :, None, None]
        return _activate_vals(i.to(torch.int32), p[:, 0], p[:, 1],
                              p[:, 2]).to(torch.int8)
    live = i < ul
    if op == "compare":
        v, d = read(0, real), refs[0][:, 0, None, None]
        if s["has_mask"]:
            m = refs[1][:, 0, None, None]
            a, b = v & m, d & m
        else:
            a, b = v.to(getattr(torch, s["ct"])), d
        return (_CMP[s["op"]](a, b) & live).to(torch.int8)
    if op == "substring_match":
        m = int(s["m"])
        nee = refs[0]
        if s["where"] == "end":
            ok, off = (i >= m - 1) & live, -(m - 1)
        else:
            ok, off = (i <= n - m) & (i + m - 1 < ul), 0
        ok = ok & (m >= 1)
        for t in range(m):
            ok = ok & (read(off + t, real & ok)
                       == nee[:, t, None, None])
        return ok.to(torch.int8)
    if op == "template_match":
        m = int(s["m"])
        t = refs[0].to(torch.float32)
        acc = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
        for j in range(m):
            acc = acc + (read(j, real).to(torch.float32)
                         - t[:, j, None, None]).abs()
        if s["mask_tail"]:
            acc = torch.where(i + m <= ul, acc, float("inf"))
        return acc
    c = len(taps) // 2
    acc = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    for k, w in enumerate(taps):
        v = read(c - k, real).to(torch.float32)
        if w == 0:
            continue
        if not s["wrap"]:
            p = i + (c - k)
            v = torch.where((p >= 0) & (p < n) & (p < ul), v, 0.0)
        acc = acc + w * v
    return acc


def fused_stream_tiled_plain(x, used_len, instrs, operands, *,
                             plan: FusedPlan | None = None):
    """The kernel's tiled run in PyTorch, for the CPU tests: ``plan``
    (default :func:`fused_plan`'s) over ``(R, N)`` rows.  Each pass stages
    every tile's window, slot s holding lane ``(base + s) mod N`` with
    ``base`` the tile's first lane less ``halo_l`` and the lanes that align
    the slot to 16 bytes of the row; runs its lead instruction against the
    pass's input rows (a move while staging, a producer at the interior
    lanes), then the other instructions on the windows (a move at slot s
    reads slot s and the slot its source lane lies in, which is valid only
    while both were; producers read the slots of the lanes they read); and
    writes the interiors.  Every read a real lane makes is checked against
    the valid slots, so a halo too small raises.  The length register is
    a per-row value every tile computes alike.  (The kernel's ``block_r``
    only groups rows into blocks.)  Bit for bit
    :func:`fused_stream_plain`."""
    r, n = x.shape
    counts = _counts(instrs, operands)
    if r == 0 or n == 0:
        return fused_stream_plain(x, used_len, instrs, operands)
    statics = tuple((op, st) for op, st, _ in instrs)
    if plan is None:
        plan = fused_plan(r, n, statics)
    dev = x.device
    refs, pos = [], 0
    for c in counts:
        refs.append([a.expand(r, -1) for a in operands[pos:pos + c]])
        pos += c
    w = plan.window
    t0 = torch.arange(plan.tiles, device=dev) * plan.tile
    rowoff = torch.arange(r, device=dev)[:, None] * n
    align = (rowoff + t0 - plan.halo_l) % 4                     # (R, tiles)
    base = t0 - plan.halo_l - align
    q = stencil_lane_plain(base[..., None] + torch.arange(w, device=dev),
                           n, True)                          # slot lanes
    i = (t0[:, None] + torch.arange(plan.tile, device=dev))[None]
    i = i.expand(r, -1, -1)                                  # interior
    real = i < n
    islot = i - base[..., None]
    rows_ix = torch.arange(r, device=dev)[:, None, None]
    ul = used_len.reshape(r, 1, 1).to(torch.int32)
    rows = x
    prods = []

    def produce(s_, read):
        op, st, _ = instrs[s_]
        taps = tuple(float(t) for t in dict(st).get("taps", ()))
        vals = _tile_produce(op, dict(st), refs[s_], i, n, ul, read, real,
                             taps)
        out = torch.empty((r, n), dtype=FUSED_PRODUCERS[op], device=dev)
        out[rows_ix.expand_as(i)[real], i[real]] = vals[real]
        prods.append(out)

    for first, end, lead in plan.passes:
        src_rows = rows

        def global_read(d, where, src_rows=src_rows):
            lanes = stencil_lane_plain(i + d, n, True)
            return src_rows[rows_ix, lanes]

        win = src_rows[rows_ix, q]
        # the valid slots: the tile and its halos (not the aligning lanes
        # and the rounding, which the kernel stages too), shrinking by each
        # move's reach
        lo = align[..., None]
        hi = lo + plan.halo_l + plan.tile + plan.halo_r
        for s_ in range(first, end):
            op, st, _ = instrs[s_]
            kind, a, b = fused_reach(op, st, n)
            moves = op in ("shift", "insert", "delete")
            if lead and s_ == first:                # against device memory
                if moves:
                    win = _tile_move(op, dict(st), refs[s_], q, n, ul,
                                     lambda src, g=src_rows: g[rows_ix, src])
                else:
                    produce(s_, global_read)
            elif moves:
                slot = torch.arange(w, device=dev)

                def window_read(src, win=win):
                    return win.gather(-1, (slot + (src - q)).clamp(0, w - 1))

                win = _tile_move(op, dict(st), refs[s_], q, n, ul,
                                 window_read)
                lo, hi = lo + a, hi - b
            elif op in FUSED_PRODUCERS:

                def window_read(d, where, win=win, lo=lo, hi=hi, op=op):
                    sl = islot + d
                    if not bool(((sl >= lo) & (sl < hi))[where].all()):
                        raise AssertionError(
                            f"fused tile: {op} reads outside the valid "
                            f"slots (halo too small)")
                    return win.gather(-1, sl.clamp(0, w - 1))

                produce(s_, window_read)
            k = dict(st).get("k", 0)
            if op == "insert":
                ul = torch.clamp(ul + k, max=n)
            elif op == "delete":
                ul = torch.clamp(ul - k, min=0)
            elif op == "truncate":
                ul = torch.minimum(ul, refs[s_][0][:, 0, None, None])
        if not bool(((islot >= lo) & (islot < hi))[real].all()):
            raise AssertionError("fused tile: the interior lies outside "
                                 "the valid slots (halo too small)")
        out = torch.empty_like(x)
        out[rows_ix.expand_as(i)[real], i[real]] = \
            win.gather(-1, islot.clamp(0, w - 1))[real]
        rows = out
    return rows, ul.reshape(r), prods


class _Instr(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_int) for f in
                 ("op", "k", "shift", "m", "flags", "cmp", "ntaps",
                  "tap_off", "odt0", "odt1", "ostride0", "ostride1")]
                + [("o0", ctypes.c_void_p), ("o1", ctypes.c_void_p),
                   ("out", ctypes.c_void_p)])


class _Program(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_int) for f in
                 ("n_instr", "x_float", "tile", "halo_l", "halo_r",
                  "n_pass", "lead_mask")]
                + [("pass_end", ctypes.c_int * MAX_INSTR),
                   ("ins", _Instr * MAX_INSTR),
                   ("taps", ctypes.c_float * MAX_TAPS)])


def _want(op, i, a, dtypes, cols, r):
    if a.dtype not in dtypes:
        raise TypeError(f"fused {op}: operand {i} has dtype {a.dtype}, "
                        f"kernel takes {[str(d) for d in dtypes]}")
    if a.ndim != 2 or a.shape[0] not in (1, r) or a.shape[1] < cols:
        raise ValueError(f"fused {op}: operand {i} has shape "
                         f"{tuple(a.shape)}, want (1 or {r}, >={cols})")
    if not a.is_contiguous():
        raise ValueError(f"fused {op}: operand {i} is not contiguous")


def _describe(instrs, operands, x, prods, plan: FusedPlan):
    """Pack the static stream and its ``plan`` into the kernel's by-value
    descriptor."""
    r, n = x.shape
    prog = _Program()
    if len(instrs) > MAX_INSTR:
        raise ValueError(f"{len(instrs)} instructions > {MAX_INSTR}")
    prog.n_instr, prog.x_float = len(instrs), int(x.dtype == torch.float32)
    prog.tile, prog.halo_l, prog.halo_r = plan.tile, plan.halo_l, plan.halo_r
    prog.n_pass = len(plan.passes)
    for j, (_, end, lead) in enumerate(plan.passes):
        prog.pass_end[j] = end
        prog.lead_mask |= int(lead) << j
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


def _fused_args(x, used_len, instrs):
    """Check the rows the kernel takes; returns (rows, lengths, outputs)."""
    if x.dtype not in _DT:
        raise TypeError(f"fused_stream kernel takes int32 or float32 rows, "
                        f"got {x.dtype} (other dtypes: ROADMAP Queue 1)")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("fused_stream kernel needs contiguous (R, N) rows")
    r, n = x.shape
    if n >= 2 ** 31 - 2 * FS_MAX_WINDOW:
        raise ValueError(f"fused_stream: rows of {n} lanes overflow the "
                         f"kernel's int32 lane index")
    if used_len.shape != (r,) or used_len.dtype != torch.int32 \
            or used_len.device != x.device:
        raise ValueError(f"used_len must be ({r},) int32 on {x.device}")
    prods = [torch.empty((r, n), dtype=FUSED_PRODUCERS[op], device=x.device)
             for op, _, _ in instrs if op in FUSED_PRODUCERS]
    return used_len.contiguous(), prods


def fused_stream(x, used_len, instrs, operands, *, block_r: int = 1):
    """Execute a fused instruction group in one kernel launch.

    ``x``: (R, N) int32 or float32 rows, any N; ``used_len``: (R,) int32;
    ``instrs``: static ``(op, statics, n_operands)`` descriptors in stream
    order; ``operands``: the matching (R, k) per-row or (1, k) broadcast
    int32/float32 tensors.  The kernel runs :func:`fused_plan`'s tiles
    (its passes in one cooperative launch where there are several), or,
    where the plan holds a row in one tile, each row resident in shared
    memory;
    ``block_r`` rows per CUDA block (any value is bit-identical to 1).
    Returns ``(rows, used_lens, producer_outputs)``.
    """
    if x.device.type == "cpu":
        return fused_stream_plain(x, used_len, instrs, operands,
                                  block_r=block_r)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stream takes CPU or CUDA rows, got "
                         f"{x.device}")
    used_len, prods = _fused_args(x, used_len, instrs)
    r, n = x.shape
    plan = fused_plan(r, n, tuple((op, st) for op, st, _ in instrs))
    if plan.smem() > MAX_SMEM_BYTES:
        raise ValueError(f"fused_stream: a window of {plan.window} lanes "
                         f"does not fit a block's shared memory")
    prog = _describe(instrs, operands, x, prods, plan)
    out_x = torch.empty_like(x)
    out_ul = torch.empty_like(used_len)
    scratch = bar = None
    if len(plan.passes) > 1:
        scratch = torch.empty_like(x)
        bar = torch.empty(1, dtype=torch.int32, device=x.device)
    br = max(1, min(int(block_r), r))
    P, I = ctypes.c_void_p, ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch("fused_stream", "fused_stream_launch",
                  [P, P, P, P, P, P, I, I, I, ctypes.POINTER(_Program)],
                  x.device, x.data_ptr(), out_x.data_ptr(), ptr(scratch),
                  used_len.data_ptr(), out_ul.data_ptr(), ptr(bar), r, n, br,
                  ctypes.byref(prog))
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
#: the most edges the bin-search form takes: its 16-bit counters of every
#: bin and thread fill 132 KB of shared memory at 129 edges
#: (HIST_SEARCH_MAX_EDGES of csrc/histogram.cu)
HISTOGRAM_SEARCH_MAX_EDGES = 129
#: the most lanes a block counts (HIST_MAX_PART), so that no thread's
#: 16-bit counter of the search form carries
HISTOGRAM_MAX_PART = 1 << 24
#: blocks the count pass aims for: 16 a streaming multiprocessor of the
#: H100's 132, so that the last of the waves of resident blocks is small
HISTOGRAM_TARGET_BLOCKS = 2112
#: no part of a row shorter than this goes to a block of its own
HISTOGRAM_MIN_PART = 4096


def histogram_plan(r: int, n: int) -> tuple[int, int]:
    """``(parts, part_len)`` of ``csrc/histogram.cu``'s count pass: each
    row splits into ``parts`` runs of ``part_len`` lanes (the last one
    shorter), enough runs over all rows for about
    :data:`HISTOGRAM_TARGET_BLOCKS` blocks, none shorter than
    :data:`HISTOGRAM_MIN_PART` lanes unless it is the whole row and none
    longer than :data:`HISTOGRAM_MAX_PART`.  The runs need not be whole
    sections: the pad is added in the finish."""
    parts = max(1, min(-(-HISTOGRAM_TARGET_BLOCKS // max(r, 1)),
                       n // HISTOGRAM_MIN_PART))
    parts = max(parts, -(-n // HISTOGRAM_MAX_PART))
    return parts, -(-n // parts)


def histogram_path(edges) -> str:
    """The form a block of ``csrc/histogram.cu`` takes for these (already
    promoted) edges: ``"search"`` for edges in non-decreasing order, free
    of NaN, of at most :data:`HISTOGRAM_SEARCH_MAX_EDGES`; ``"counts"``
    otherwise.  Each block decides this on the device from the edges it
    stages (in the compare type, as here); this is its CPU model."""
    e = edges.to(_acc_dtype(edges.dtype))
    ordered = bool((e[:-1] <= e[1:]).all())
    return "search" if ordered and e.numel() <= HISTOGRAM_SEARCH_MAX_EDGES \
        else "counts"


def _hist_runs(x2, parts: int, part_len: int, vals):
    """Per-lane int64 ``vals`` of ``(R, n)`` rows summed into ``(R, parts)``
    runs of ``part_len`` lanes."""
    r, n = x2.shape
    pad = parts * part_len - n
    v = torch.nn.functional.pad(vals, (0, pad)) if pad else vals
    return v.reshape(r, parts, part_len).sum(-1)


def histogram_counts_plain(x2, edges, parts: int, part_len: int):
    """The count pass's scratch in the counts form: ``(R, parts, E)`` int32
    ``C_p(e[j])``, the lanes of run ``p`` of each ``(R, n)`` row with
    ``v < e[j]`` (rows and edges in one dtype; the pad not counted)."""
    return torch.stack([_hist_runs(x2, parts, part_len,
                                   (x2 < e).to(torch.int64)) for e in edges],
                       -1).to(torch.int32)


def histogram_search_counts_plain(x2, edges, parts: int, part_len: int):
    """The same ``(R, parts, E)`` scratch in the search form, as a block of
    ``csrc/histogram.cu`` computes it: the edges in breadth-first order
    padded to ``2^L - 1`` nodes with the compare type's largest value (``L
    = ceil(log2(E + 1))``), each lane's branchless descent ``i = 2 i + 2 -
    (v < node[i])``, its bin ``k = i - (2^L - 1)`` counted where ``k < E``,
    and the bins prefix-summed.  Valid for edges that :func:`histogram_path`
    sends to the search (any count of them here)."""
    acc = _acc_dtype(x2.dtype)
    v, e = x2.to(acc), edges.to(acc)
    ne = e.numel()
    levels = ne.bit_length()
    top = torch.iinfo(acc).max if acc == torch.int32 else float("inf")
    tree = torch.full(((1 << levels) - 1,), top, dtype=acc, device=v.device)
    for nd in range(tree.numel()):
        d = (nd + 1).bit_length() - 1          # node nd's depth
        j = ((2 * (nd + 1 - (1 << d)) + 1) << (levels - 1 - d)) - 1
        if j < ne:
            tree[nd] = e[j]
    i = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    for _ in range(levels):
        i = 2 * i + 2 - (v < tree[i]).to(torch.int64)
    k = i - ((1 << levels) - 1)
    bins = torch.stack([_hist_runs(x2, parts, part_len,
                                   (k == b).to(torch.int64))
                        for b in range(ne)], -1)
    return torch.cumsum(bins, -1).to(torch.int32)


def histogram_finish_plain(counts, edges, pad: int):
    """Pass 2 of ``csrc/histogram.cu`` (``hist_finish``): ``C(e[j])`` over
    a row's parts in order plus ``pad`` lanes valued ``e[M]``, then the
    differences, all wrapping as int32 -> ``(R, M)``."""
    cum = counts.to(torch.int64).sum(1)
    cum = cum + pad * (edges[-1] < edges).to(torch.int64)
    bins = (cum[:, 1:] - cum[:, :-1]) & 0xFFFFFFFF
    return torch.where(bins >= 2 ** 31, bins - 2 ** 32, bins) \
        .to(torch.int32)


def histogram_search_plain(x, edges, section: int = 1024):
    """§6.3 histogram by the kernel's search form: the rows and edges
    promoted as :func:`histogram`, split by :func:`histogram_plan`,
    counted by :func:`histogram_search_counts_plain` and finished by
    :func:`histogram_finish_plain`.  Equal to :func:`histogram_plain` bit
    for bit on edges that :func:`histogram_path` sends to the search;
    raises on edges out of order or with a NaN, which take the counts
    form."""
    ct = torch.promote_types(x.dtype, edges.dtype)
    x, edges = x.to(ct), edges.to(ct)
    if edges.numel() < 2 or not bool(
            (edges[:-1].to(_acc_dtype(ct)) <= edges[1:].to(_acc_dtype(ct)))
            .all()):
        raise ValueError("the search form takes at least two edges in "
                         "non-decreasing order, free of NaN")
    n = x.shape[-1]
    x2 = x.reshape(-1, n)
    parts, part_len = histogram_plan(x2.shape[0], n)
    counts = histogram_search_counts_plain(x2, edges, parts, part_len)
    out = histogram_finish_plain(counts, edges, (-n) % section)
    return out.reshape(*x.shape[:-1], edges.numel() - 1)


def histogram(x, edges, section: int = 1024):
    """§6.3 counts of every ``(..., N)`` row in the ``M`` bins of ``(M+1,)``
    edges -> ``(..., M)`` int32: one ``csrc/histogram.cu`` call for CUDA
    tensors (two device launches, the counts and their differences;
    counted once in ``histogram.launches``; each block of the counts
    takes the search form or the counts form by :func:`histogram_path`,
    on the device), the plain twin for CPU tensors.  Rows and edges
    promote to one dtype first, as the TPU wrapper does."""
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
    parts, part_len = histogram_plan(r, n)
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


#: the odd-even route's blocks (csrc/oddeven_sort.cu): OE_K lanes a thread
#: in registers, a warp's segment of 32 OE_K lanes holding OE_HALO lanes of
#: each neighbouring warp (OE_STEP interior lanes), rounds of OE_ROUND
#: cycles, windows of at most 15,360 lanes (OE_MAX_WARPS warps), a NaN
#: flag every OE_CHUNK lanes of a float row
OE_K, OE_ROUND, OE_CHUNK = 16, 16, 1024
OE_HALO = OE_K
OE_STEP = 32 * OE_K - 2 * OE_HALO
OE_MAX_WARPS = 512 // OE_K
#: the block widths the plan chooses from: windows of 1,920 to 15,360
#: lanes
OE_WARPS = tuple(OE_MAX_WARPS >> k for k in (3, 2, 1, 0))
#: the plan's model of the H100, in clocks: 132 SMs of 64 ALU lanes a
#: clock (one min or max a lane a cycle), a warp's OE_K lanes 2 OE_K clocks
#: a cycle on each of the SM's four schedulers, 1,900 bytes a clock from
#: device memory (3.35 TB/s at 1.755 GHz), 2,000 clocks a pass (a launch
#: or a grid barrier); a full sort's odd-even route runs only the rows with
#: a NaN, priced as one row at 3x the integer exchange
_OE_SMS, _OE_ALU = 132, 64
_OE_BYTES, _OE_PASS, _OE_NAN_COST = 1900, 2000, 3


class OddEvenPlan(NamedTuple):
    """The odd-even route of one call: blocks of ``warps`` warps, tiles of
    ``interior`` lanes read with ``halo`` lanes more on either side
    (``tiles`` a row), ``passes`` passes of at most ``per_pass`` cycles."""

    warps: int
    interior: int
    halo: int
    per_pass: int
    passes: int
    tiles: int


def oddeven_candidate(n: int, steps: int, warps: int, halo: int):
    """The :class:`OddEvenPlan` of blocks of ``warps`` warps and tiles read
    with ``halo`` lanes on either side, or None where it cannot run: a row
    of one tile (``n`` lanes fit the block) takes every cycle in one pass,
    a row of several tiles at most ``halo`` cycles a pass."""
    interior = warps * OE_STEP - 2 * halo
    if interior < 1:
        return None
    tiles = -(-n // interior)
    if tiles == 1 or steps == 0:
        return OddEvenPlan(warps, interior, halo, steps, 1, tiles)
    if halo < 1:
        return None
    per_pass = min(steps, halo)
    return OddEvenPlan(warps, interior, halo, per_pass,
                       -(-steps // per_pass), tiles)


def _oe_cost(plan: OddEvenPlan, r: int, n: int, steps: int, elem: int,
             full: bool) -> float:
    """Clocks of ``plan`` in the model above (the larger of the ALU work,
    halos included, and one block's cycles, then each pass's bytes and
    fixed cost)."""
    rows, f = (1, _OE_NAN_COST) if full else (r, 1)
    # every warp's whole segment, its end threads' lanes included
    lanes = plan.warps * 32 * OE_K * rows * plan.tiles * f / (_OE_SMS
                                                              * _OE_ALU)
    block = 2 * OE_K * -(-plan.warps // 4) * f
    fixed = 2 * rows * n * elem / _OE_BYTES + _OE_PASS

    def one(cycles):
        return max(lanes * cycles, block * cycles) + fixed

    last = steps - (plan.passes - 1) * plan.per_pass
    return (plan.passes - 1) * one(plan.per_pass) + one(last)


@functools.lru_cache(maxsize=256)
def oddeven_plan(r: int, n: int, steps: int, *, full: bool = False,
                 elem: int = 4) -> OddEvenPlan:
    """The odd-even route's :class:`OddEvenPlan` for ``steps`` cycles over
    ``r`` rows of ``n`` lanes of ``elem`` bytes (``full``: a full sort,
    whose cycles run only its float rows with a NaN): the cheapest
    :func:`oddeven_candidate` in the model above over the block widths
    :data:`OE_WARPS` and halos of ``16 * 2^k`` lanes and ``steps`` itself
    (0 where a row is one tile)."""
    best, best_cost = None, None
    for w in OE_WARPS:
        top = (w * OE_STEP - 1) // 2           # leaves an interior lane
        halos = {0, *(min(steps, 16 << k) for k in range(20)
                      if 16 << k <= top)}
        if steps <= top:
            halos.add(steps)
        for h in sorted(halos):
            plan = oddeven_candidate(n, steps, w, h)
            if plan is None:
                continue
            cost = _oe_cost(plan, r, n, steps, elem, full)
            if best is None or cost < best_cost:
                best, best_cost = plan, cost
    return best


def oddeven_smem(warps: int) -> int:
    """Bytes of shared memory a block of ``warps`` warps takes: its tile
    of keys (the window and the end threads' outer lanes) and two halo
    buffers of (warps, 2, OE_K) keys."""
    return 4 * (warps * OE_STEP + 2 * OE_HALO + 4 * warps * OE_K)


_INT32_MIN = -2 ** 31
#: the +inf key of each float dtype (NaN keys lie beyond it)
_FLOAT_INF_KEY = {torch.float32: 0x7F800000, torch.float16: 0x7C00,
                  torch.bfloat16: 0x7F80}


def _oe_pair(a, b, with_nan, inf):
    """The new left and right lanes of the pairs ``(a, b)`` (int32 keys):
    integer min and max, or where ``with_nan`` the NaN-aware exchange
    (``jnp.minimum`` / ``jnp.maximum`` on the keys)."""
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    if inf is None:
        return lo, hi
    na, nb = (a ^ (a >> 31)) > inf, (b ^ (b >> 31)) > inf
    left = torch.where(na, a, torch.where(nb, b, lo))
    right = torch.where(nb, b, torch.where(na, a, hi))
    return torch.where(with_nan, left, lo), torch.where(with_nan, right, hi)


def _oe_cycle(v, inside: bool, with_nan, inf):
    """One cycle of every warp segment ``v`` ``(..., 32, OE_K)``:
    ``inside`` pairs (0,1), (2,3), ... of each thread; otherwise (1,2),
    ... and each thread's end lanes with its neighbours' (thread 31's last
    lane with its own first, thread 0's first with its own last, as the
    kernel's shuffles return)."""
    v = v.clone()
    if inside:
        a, b = _oe_pair(v[..., 0::2], v[..., 1::2], with_nan, inf)
        v[..., 0::2], v[..., 1::2] = a, b
        return v
    first, last = v[..., 0], v[..., OE_K - 1]
    right = torch.cat([first[..., 1:], first[..., -1:]], dim=-1)
    left = torch.cat([last[..., :1], last[..., :-1]], dim=-1)
    a, b = _oe_pair(v[..., 1:OE_K - 2:2], v[..., 2:OE_K - 1:2],
                    with_nan, inf)
    v[..., 1:OE_K - 2:2], v[..., 2:OE_K - 1:2] = a, b
    v[..., OE_K - 1] = _oe_pair(last, right, with_nan[..., 0], inf)[0]
    v[..., 0] = _oe_pair(left, first, with_nan[..., 0], inf)[1]
    return v


def _oe_widen(done: int) -> int:
    """Lanes a NaN can have spread in ``done`` cycles: one a cycle."""
    return done


def oddeven_tiled_plain(x, steps: int | None = None,
                        plan: OddEvenPlan | None = None):
    """The kernel's odd-even route in PyTorch, for the CPU tests: ``steps``
    (default N) cycles over ``(R, N)`` rows as ``plan`` (default
    :func:`oddeven_plan`'s) runs them.  Each pass cuts every row into
    its tiles (lanes outside the row are the key of -inf / +inf, INT_MIN /
    INT_MAX for integers), each tile into its warps' overlapping segments
    of 32 threads of OE_K lanes; rounds of OE_ROUND cycles, each thread's
    end lanes paired across threads (the segment's ends with their own
    thread), then the end threads refreshed from the neighbouring warps;
    the cycle parity from the call's cycle count and the lane; the integer
    exchange on a tile whose window, widened by the cycles already run,
    meets no flagged NaN chunk of the input, the NaN-aware one elsewhere;
    the interiors written back.  Bit for bit :func:`oddeven_sort_plain`
    (the twin that defines the function): the tests hold the plan's halos,
    pads, parity and loop choice to it."""
    r, n = x.shape
    steps = n if steps is None else int(steps)
    if plan is None:
        plan = oddeven_plan(r, n, steps, full=steps >= n,
                            elem=x.element_size())
    inf = _FLOAT_INF_KEY.get(x.dtype)
    lo_pad, hi_pad = (_INT32_MIN, _INT32_MAX) if inf is None else (~inf, inf)
    dev = x.device
    wb = plan.warps * OE_STEP
    wt = wb + 2 * OE_HALO
    base = torch.arange(plan.tiles, device=dev) * plan.interior \
        - plan.halo - OE_HALO                       # lane of slot 0
    lanes = base[:, None] + torch.arange(wt, device=dev)
    seg = (torch.arange(plan.warps, device=dev)[:, None] * OE_STEP
           + torch.arange(32 * OE_K, device=dev)).reshape(-1)
    if inf is not None:
        chunks = -(-n // OE_CHUNK)
        flagged = torch.nn.functional.pad(
            torch.isnan(x), (0, chunks * OE_CHUNK - n)).reshape(
                r, chunks, OE_CHUNK).any(-1)
        cidx = torch.arange(chunks, device=dev)
    src, done = sort_keys(x), 0
    for _ in range(plan.passes):
        cycles = min(plan.per_pass, steps - done)
        win = src[:, lanes.clamp(0, n - 1)]
        win = torch.where(lanes < 0, lo_pad, torch.where(lanes >= n, hi_pad,
                                                         win))
        with_nan = torch.zeros((r, plan.tiles), dtype=torch.bool, device=dev)
        if inf is not None:
            w = _oe_widen(done)
            a, b = (base - w).clamp(min=0), (base + wt + w).clamp(max=n)
            near = (cidx >= a[:, None] // OE_CHUNK) \
                & (cidx <= (b[:, None] - 1) // OE_CHUNK) & (a < b)[:, None]
            with_nan = (flagged[:, None, :] & near[None]).any(-1)
        v = win[..., seg].reshape(r, plan.tiles, plan.warps, 32, OE_K)
        m = with_nan[:, :, None, None, None]
        inside = (done - int(base[0])) % 2 == 0
        ran = 0
        while ran < cycles:
            s = min(OE_ROUND, cycles - ran)
            for _ in range(s):
                v = _oe_cycle(v, inside, m, inf)
                inside = not inside
            ran += s
            if ran < cycles:
                fresh = v.clone()
                fresh[:, :, 1:, 0] = v[:, :, :-1, 30]
                fresh[:, :, :-1, 31] = v[:, :, 1:, 1]
                v = fresh
        win[..., OE_HALO:OE_HALO + wb] = v[..., 1:31, :].reshape(
            r, plan.tiles, wb)
        start = OE_HALO + plan.halo
        src = win[..., start:start + plan.interior].reshape(r, -1)[:, :n]
        done += cycles
    return sort_values(src.contiguous(), x.dtype)


#: the bitonic route's tiles (csrc/oddeven_sort.cu): at most 64 KB of int32
#: keys in shared memory, at least 1,024 where the row has them, and
#: smaller while a group's rows would leave SMs of the H100 idle; rows pad
#: to at least 16 lanes; a device-memory pass merges up to 3 strides; rows
#: sort in groups of at most 16 MiB of keys, which stay in the 50 MB L2
#: from one pass to the next
BITONIC_TILE_MAX, BITONIC_TILE_MIN, BITONIC_MIN_PAD = 16384, 1024, 16
BITONIC_TARGET_BLOCKS, BITONIC_LEVELS = 132, 3
BITONIC_GROUP_BYTES = 16 << 20
_INT32_MAX = 2 ** 31 - 1


def bitonic_plan(r: int, n: int) -> tuple[int, int, int, list[tuple]]:
    """``(P, T, G, passes)`` of the full sort's bitonic network over ``r``
    rows of ``n`` lanes: rows padded to ``P`` lanes (a power of two),
    tiles of ``T`` keys, groups of ``G`` rows that run every pass before
    the next group starts, and the passes in order: ``("tile", k0, k1)``
    sorts every tile in shared memory over stages ``k0 .. k1`` (strides
    ``min(k/2, T/2) .. 1`` each), ``("stride", k, j, levels)`` runs
    ``levels`` strides of stage ``k`` from ``j`` down, all ``>= T``, in
    device memory.  The first pass is the tile sort, the last a tile
    pass."""
    p = max(BITONIC_MIN_PAD, 1 << max(n - 1, 0).bit_length())
    g = max(1, min(r, BITONIC_GROUP_BYTES // (4 * p)))
    t = min(p, BITONIC_TILE_MAX)
    while t > BITONIC_TILE_MIN and g * (p // t) < BITONIC_TARGET_BLOCKS:
        t //= 2
    passes: list[tuple] = [("tile", 2, t)]
    k = 2 * t
    while k <= p:
        j = k // 2
        while j >= t:
            levels = min(BITONIC_LEVELS, j.bit_length() - t.bit_length() + 1)
            passes.append(("stride", k, j, levels))
            j >>= levels
        passes.append(("tile", k, k))
        k *= 2
    return p, t, g, passes


def bitonic_steps(passes, t: int):
    """The ``(k, j)`` compare-exchange steps of ``passes`` in the order the
    kernels run them (every stage ``k``, its strides ``k/2 .. 1``)."""
    for kind, a, b, *rest in passes:
        if kind == "tile":
            k = a
            while k <= b:
                j = min(k // 2, t // 2)
                while j >= 1:
                    yield k, j
                    j //= 2
                k *= 2
        else:
            for i in range(rest[0]):
                yield a, b >> i


def sort_keys(x):
    """The int32 keys of ``csrc/oddeven_sort.cu`` (``Key<>``): integers and
    bool widen; float bits keep their sign bit and, when it is set, flip
    the others, so -0.0 sorts just below +0.0 and equal keys are equal
    bits."""
    if x.dtype == torch.float32:
        b = x.view(torch.int32)
        return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)
    if x.dtype in (torch.float16, torch.bfloat16):
        b = x.view(torch.int16).to(torch.int32)
        return torch.where(b >= 0, b, b ^ 0x7FFF)
    return x.to(torch.int32)


def sort_values(keys, dtype: torch.dtype):
    """The inverse of :func:`sort_keys`: int32 keys back to ``dtype``."""
    if dtype == torch.float32:
        return torch.where(keys >= 0, keys, keys ^ 0x7FFFFFFF).view(dtype)
    if dtype in (torch.float16, torch.bfloat16):
        b = torch.where(keys >= 0, keys, keys ^ 0x7FFF)
        return b.to(torch.int16).view(dtype)
    return keys.to(dtype)


def bitonic_rows(x, steps: int | None = None):
    """``(R,)`` bool: the rows of ``(R, N)`` ``x`` that the sort kernel
    takes through the bitonic network, which gives the twin's bits there:
    every row of a full sort (``steps >= N``) whose keys hold no NaN (all
    rows of an integer or bool dtype); none of a bounded sort."""
    r, n = x.shape
    if (n if steps is None else steps) < n:
        return torch.zeros(r, dtype=torch.bool, device=x.device)
    if not x.dtype.is_floating_point:
        return torch.ones(r, dtype=torch.bool, device=x.device)
    return ~torch.isnan(x).any(-1)


def bitonic_sort_plain(x):
    """The kernel's bitonic route in PyTorch, for the CPU tests: ``(R, N)``
    rows to :func:`sort_keys`, padded with ``INT32_MAX`` keys to
    :func:`bitonic_plan`'s ``P`` lanes, every step of its passes in order
    (lane ``i`` meets ``i ^ j``, ascending where ``i & k == 0``), the first
    ``N`` lanes back to ``x.dtype``.  The twin that defines the function
    stays :func:`oddeven_sort_plain`; this one makes the network's
    schedule, padding and key round trip testable without a card."""
    r, n = x.shape
    p, t, _, passes = bitonic_plan(r, n)
    keys = torch.full((r, p), _INT32_MAX, dtype=torch.int32, device=x.device)
    keys[:, :n] = sort_keys(x)
    idx = torch.arange(p, device=x.device)
    for k, j in bitonic_steps(passes, t):
        lo = idx[(idx & j) == 0]
        hi = lo | j
        asc = (lo & k) == 0
        a, b = keys[:, lo], keys[:, hi]
        small, big = torch.minimum(a, b), torch.maximum(a, b)
        keys[:, lo] = torch.where(asc, small, big)
        keys[:, hi] = torch.where(asc, big, small)
    return sort_values(keys[:, :n].contiguous(), x.dtype)


def oddeven_sort(x, steps: int | None = None):
    """``steps`` (default N) odd-even exchange cycles over every ``(R, N)``
    row -> ``(R, N)`` of ``x.dtype``, bit for bit the twin's: one
    ``csrc/oddeven_sort.cu`` call for CUDA tensors, counted once in
    ``oddeven_sort.launches``, the plain twin for CPU tensors.  A bounded
    sort (``steps < N``) runs the cycles in :func:`oddeven_plan`'s tiles
    (float rows: a NaN scan first; one launch, cooperative where the plan
    has several passes).  A full sort runs :func:`bitonic_plan`'s passes
    for the rows of :func:`bitonic_rows`, chosen on the device (float
    rows: a NaN flag pass first, then the cycles for the flagged rows), so
    its launches depend on shape, dtype and ``steps`` only."""
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
    full = steps >= n
    floating = x.dtype.is_floating_point
    plan = oddeven_plan(r, n, steps, full=full, elem=x.element_size())
    cycles = not full or floating
    scratch = bar = nanf = None
    if cycles and plan.passes > 1:
        scratch = torch.empty_like(x)
        bar = torch.empty(1, dtype=torch.int32, device=x.device)
    if cycles and floating:
        nanf = torch.empty((r, -(-n // OE_CHUNK)), dtype=torch.uint8,
                           device=x.device)
    keys = flag = bitonic = None
    p = t = g = nplan = 0
    if full:
        p, t, g, passes = bitonic_plan(r, n)
        nplan = len(passes)
        bitonic = (ctypes.c_longlong * (4 * nplan))(*[
            v for kind, a, b, *rest in passes
            for v in ((0, a, b, 0) if kind == "tile" else (1, a, b, *rest))])
        if p > t:
            keys = torch.empty((r, p), dtype=torch.int32, device=x.device)
        if floating:
            flag = torch.empty(r, dtype=torch.int32, device=x.device)

    def ptr(buf):
        return None if buf is None else buf.data_ptr()

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _build.launch("oddeven_sort", "oddeven_sort_launch",
                  [P, P, P, I, L, L, I, L, L, L, I, P, P, P, P, L, I, I, I,
                   P, I],
                  x.device, x.data_ptr(), out.data_ptr(), ptr(scratch), r, n,
                  steps, plan.warps, plan.interior, plan.halo, plan.per_pass,
                  plan.passes, ptr(nanf), ptr(bar), ptr(keys), ptr(flag), p,
                  t, g, nplan, bitonic, code)
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


#: lanes a thread of csrc/activate.cu (and of fused_stream.cu's activate
#: branch) writes at once: one 16-byte store
ACTIVATE_LANES = 16


def activate_stepped_plain(n: int, start: int, end: int, carry: int = 1,
                           lanes: int = ACTIVATE_LANES):
    """``cpm_activate_lanes`` of ``csrc/cpm_ops.cuh`` over runs of
    ``lanes`` lanes of an ``n``-lane mask, in PyTorch, for the CPU tests:
    a run wholly outside ``[start, end]`` is 0, with ``carry <= 1`` a run
    wholly inside is 1; otherwise the floor modulo of the int32 difference
    is taken for the run's first lane and stepped (lane m of the run has
    phase ``(r0 + m) mod carry``), except in a run where that difference
    wraps past INT_MAX, where each lane takes the predicate itself.  Bit
    for bit :func:`activate_plain`."""
    c = max(int(carry), 1)
    g = torch.arange(-(-n // lanes) * lanes, dtype=torch.int64)
    i0 = g - g % lanes                               # each lane's run
    m = g - i0
    out = (g >= start) & (g <= end)
    d0 = _wrap32(i0 - start)
    stepped = ((d0 % c) + m) % c == 0
    wraps = d0 + lanes - 1 > 2 ** 31 - 1
    each = _wrap32(g - start) % c == 0
    out &= torch.where(wraps, each, stepped)
    outside = (i0 + lanes - 1 < start) | (i0 > end)
    inside = (c == 1) & (i0 >= start) & (i0 + lanes - 1 <= end)
    out = torch.where(outside, False, torch.where(inside, True, out))
    return out[:n]


def activate(n: int, start, end, carry=1, *, device=None):
    """Rule-4 activation mask of length ``n`` -> ``(n,)`` bool on
    ``device`` (default: where a tensor scalar lies, else the card, as
    every entry point: ``repro_torch.resolve_device``, which raises
    without one): one ``csrc/activate.cu`` launch for a CUDA device
    (counted in ``activate.launches``), the plain twin on the CPU.  Where
    ``start``, ``end`` and ``carry`` are all Python ints the kernel takes
    them by value; otherwise they are stacked on the device and read
    there, so a call never waits for the host."""
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
    vals = (start, end, carry)
    if all(isinstance(v, int) for v in vals):
        from repro_torch.cpm._tensor import _check_python_ints

        for v in vals:
            _check_python_ints(v, v, torch.int32)
        p, by_value = None, [int(v) for v in vals]
    else:
        p, by_value = _scalars(dev, *vals), [0, 0, 0]
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("activate", "activate_launch", [P, I, I, I, P, I], dev,
                  None if p is None else p.data_ptr(), *by_value,
                  out.data_ptr(), n)
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


#: output bytes a shift_range block owns: SHIFT_TILE_BYTES of
#: csrc/shift_range.cu (4,096 int32 lanes)
SHIFT_TILE_BYTES = 16384


def shift_src_plain(i, n: int, start, end, shift: int, has_fill: bool):
    """``cpm_shift_src`` of ``csrc/cpm_ops.cuh`` on int64 lane tensors
    ``i`` of an ``n``-lane row (``start`` / ``end`` scalars or tensors
    that broadcast against ``i``): the lane whose value lane ``i`` holds
    after the move, or -1 where it takes the fill.  No modulo: the shift
    is clamped to ``[-n, n]``, and ``i - shift`` taken as an unsigned
    32-bit number is below ``n`` exactly when it is a lane of the row."""
    i = torch.as_tensor(i, dtype=torch.int64)
    start, end = (torch.as_tensor(v, dtype=torch.int64, device=i.device)
                  for v in (start, end))
    s = max(-n, min(int(shift), n))
    j = (i - s) & 0xFFFFFFFF
    dst = (j < n) & (j >= start) & (j <= end)
    vacated = (i >= start) & (i <= end) & bool(has_fill)
    return torch.where(dst, j, torch.where(vacated, -1, i))


def shift_tile_cases(n: int, start: int, end: int, shift: int, tile: int,
                     head: int = 0, has_fill: bool = False):
    """The tiles of one ``n``-lane row that ``csrc/shift_range.cu``'s
    blocks own, each with the case the block decides for it: a list of
    ``(lo, hi, case)`` over lanes ``[lo, hi)``.  ``tile`` is lanes a tile
    (``SHIFT_TILE_BYTES // itemsize``), ``head`` the lanes before the
    output row's first 16-byte boundary.  ``"a"``: out = x over the tile;
    ``"b"``: out[i] = x[i - shift] over the tile; ``"c"``: lane by lane
    (:func:`shift_src_plain`)."""
    s = max(-n, min(int(shift), n))
    slo, shi = max(int(start), 0), min(int(end), n - 1)
    dlo, dhi = max(slo + s, 0), min(shi + s, n - 1)
    out = []
    for b in range(-(-n // tile)):
        lo = 0 if b == 0 else head + b * tile
        hi = min(n, head + (b + 1) * tile)
        if lo >= hi:
            continue
        if dlo <= lo and hi - 1 <= dhi:
            case = "b"
        elif (hi - 1 < dlo or lo > dhi) and \
                (not has_fill or hi - 1 < slo or lo > shi):
            case = "a"
        else:
            case = "c"
        out.append((lo, hi, case))
    return out


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

#: outputs of a row a template_match block computes (TM_TILE of
#: csrc/template_match.cu: 256 threads of 8 adjacent outputs)
TEMPLATE_TILE = 2048
#: template items a block stages at a time (TM_TCH)
TEMPLATE_CHUNK = 2048


def template_span(m: int, tile: int = TEMPLATE_TILE) -> int:
    """Positions a ``template_match`` block stages: its tile and the ``M +
    3`` lanes after it, rounded up to 4 (``tm_span``)."""
    return (tile + m + 6) & ~3


#: the longest template whose staged span and a template chunk fit a
#: block's shared memory on the H100 (MAX_SMEM_BYTES; ``tm_smem_floats``)
TEMPLATE_MAX_M = MAX_SMEM_BYTES // 4 - TEMPLATE_CHUNK - TEMPLATE_TILE - 3


def template_match_plain(data, template):
    """§7.6 sliding SAD of an ``(M,)`` template at every start of every
    ``(R, N)`` row -> ``(R, N)`` float32, as the TPU kernel: ``_sad_vals``
    over the rows cast to float32, ``j = 0 .. M-1`` in order, the tail
    wrapping."""
    return _sad_vals(data.to(torch.float32), template.reshape(1, -1),
                     template.shape[-1])


def template_src_plain(q, n: int, span: int):
    """The lane staged position ``q`` of an ``n``-lane row reads in
    ``csrc/template_match.cu``: ``q`` inside the row; past its end one
    subtraction of ``n``, unless the row is shorter than the ``span`` a
    block stages (a block-uniform test), which takes the modulo."""
    q = torch.as_tensor(q, dtype=torch.int64)
    past = q - n if n >= span else torch.remainder(q, n)
    return torch.where(q < n, q, past)


def template_tiled_plain(data, template, tile: int = TEMPLATE_TILE):
    """The schedule of ``csrc/template_match.cu`` in torch: each ``tile``
    of outputs of every row stages, as float32, the :func:`template_span`
    positions after its first lane, each through
    :func:`template_src_plain`; each output then adds ``|staged - t[j]|``
    for ``j = 0 .. M-1`` in order, as ``cpm_sad`` does (the kernel's
    register window and template chunks change what is read from where,
    not the order of the sums).  Equal to :func:`template_match_plain`
    bit for bit."""
    r, n = data.shape
    t = template.reshape(-1).to(torch.float32)
    m = t.numel()
    xf = data.to(torch.float32)
    span = template_span(m, tile)
    out = torch.empty((r, n), dtype=torch.float32, device=data.device)
    for b0 in range(0, n, tile):
        width = min(tile, n - b0)
        q = torch.arange(b0, b0 + span, device=data.device)
        staged = xf[:, template_src_plain(q, n, span)]
        acc = torch.zeros((r, width), dtype=torch.float32,
                          device=data.device)
        for j in range(m):
            acc = acc + torch.abs(staged[:, j:j + width] - t[j])
        out[:, b0:b0 + width] = acc
    return out


def template_match(data, template):
    """§7.6 sliding SAD -> ``(R, N)`` float32: one ``csrc/template_match.cu``
    launch for CUDA tensors (counted in ``template_match.launches``; a
    template of at most :data:`TEMPLATE_MAX_M` items; blocks of
    :data:`TEMPLATE_TILE` outputs, :func:`template_tiled_plain`), the plain
    twin for CPU tensors."""
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
                         f"most {TEMPLATE_MAX_M} items (its staged span and "
                         f"a template chunk in shared memory), got {m}")
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


#: outputs of a row a stencil block computes: ST_TILE of csrc/stencil.cu
STENCIL_TILE = 2048


def stencil_lane_plain(q, n: int, wrap: bool):
    """``cpm_stencil_lane`` of ``csrc/cpm_ops.cuh`` on int64 position
    tensors: the lane position ``q`` reads, or -1 (zero padding).  One add
    or subtract of ``n`` wraps a position unless the row is shorter than
    the taps; only then the floor modulo."""
    q = torch.as_tensor(q, dtype=torch.int64)
    inside = (q >= 0) & (q < n)
    if not wrap:
        return torch.where(inside, q, -1)
    once = torch.where(q < 0, q + n, q - n)
    return torch.where(inside, q, torch.where((q >= -n) & (q < 2 * n),
                                              once, torch.remainder(q, n)))


def stencil_tiled_plain(x, taps, wrap: bool = True,
                        tile: int = STENCIL_TILE):
    """The schedule of ``csrc/stencil.cu`` in torch: each ``tile`` of
    outputs of every row stages, as float32, the positions it reads (the
    tile, ``ntaps - 1 - c`` lanes before it and ``c`` after it), each
    through :func:`stencil_lane_plain` once and 0 from the last position
    an output inside the row reads on; then each output adds its taps'
    staged values in tap order, zero taps skipped.  Equal to
    :func:`stencil_plain` bit for bit."""
    taps = tuple(float(t) for t in taps)
    r, n = x.shape
    xf = x.to(torch.float32)
    c = len(taps) // 2
    before = len(taps) - 1 - c if taps else 0
    out = torch.empty((r, n), dtype=torch.float32, device=x.device)
    for t0 in range(0, n, tile):
        width = min(tile, n - t0)
        q = torch.arange(t0 - before, t0 + tile + c, device=x.device)
        j = torch.where(q < t0 + width + c, stencil_lane_plain(q, n, wrap),
                        -1)
        staged = torch.where(j >= 0, xf[:, j.clamp(min=0)], 0.0)
        acc = torch.zeros((r, width), dtype=torch.float32, device=x.device)
        for k, w in enumerate(taps):
            if w == 0:
                continue
            u = before + c - k        # the slot of output t0's tap k
            acc = acc + w * staged[:, u:u + width]
        out[:, t0:t0 + width] = acc
    return out


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
