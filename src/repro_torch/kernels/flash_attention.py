"""Blocked online-softmax attention: the Hopper kernel and its plain twin.

Replaces ``src/repro/kernels/flash_attention.py:73`` (``flash_attention``,
``pallas_call`` at ``:97``).  q: (B, H, Sq, D); k, v: (B, KVH, Skv, D);
head ``h`` reads kv head ``h // (H / KVH)``.  Causal keeps
``cols <= rows``, the window keeps ``cols > rows - window`` (rows and
cols are absolute indices, not end-aligned); masked scores are
``NEG_INF = -1e30``.  Scores, running max, denominator and accumulator are
float32, the denominator is floored at ``1e-30`` and the output is cast
to ``q.dtype``.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors and counts the launch in ``flash_attention.launches``: bf16 with
D = 64, 128 or 256 on the wgmma kernel fed by TMA loads (whose 16-byte
rule on bases and strides it checks; D = 256, recurrentgemma-9b's, with
one q head a block), bf16 with D = 16 or 32 on the ``mma.sync`` kernel,
float32 on the FP32 kernel.

The window keeps ``cols > rows - window`` on absolute indices: with
Sq = Skv = 2,304 and window 2,048, rows up to 2,047 keep every causal
key and rows from 2,048 on lose their first keys.  For CPU tensors it runs
:func:`flash_attention_plain`, which repeats the TPU kernel's arithmetic
tile by tile in PyTorch.

Training differentiates the kernel through :class:`FlashAttentionFn`:
its forward is :func:`flash_attention` (the same launch, counted), its
backward :func:`flash_attention_bwd_plain`, plain PyTorch, because the
TPU kernel has no backward (the JAX package differentiates its
reference off the TPU and defines no ``custom_vjp``).  A backward kernel
is later work.  The backward follows FlashAttention-2 over q tiles: each
tile's scores are recomputed against the keys it can see, its rows'
max and sum (their log-sum-exp) taken in their own passes, and dq, dk,
dv formed from ``p`` and ``ds = p * (dO V^T - rowsum(dO * O))``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

#: rows of q handled by one CUDA block at most (the wrapper's contract)
MAX_BLOCK_Q = 128
_HEAD_DIMS = (16, 32, 64, 128, 256)
#: bf16 head dims of the wgmma + TMA kernel (the others take mma.sync)
_TMA_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k, v, block_q: int, block_k: int):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,Sq,D), k=v (B,KVH,Skv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    kb, kvh, skv, kd = k.shape
    if kb != b or kd != d or h % kvh:
        raise ValueError(f"incompatible q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)} (H % KVH must be 0)")
    block_q = min(block_q, sq)
    block_k = min(block_k, skv)
    if sq % block_q or skv % block_k:
        raise ValueError(f"Sq={sq} / Skv={skv} must be multiples of "
                         f"block_q={block_q} / block_k={block_k}")
    return block_q, block_k


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          block_q: int = 128, block_k: int = 128):
    """The TPU kernel's arithmetic in PyTorch: kv tiles of ``block_k`` in
    order, online softmax in float32.  Rows are independent, so every
    q tile of the kernel's grid is computed at once."""
    block_q, block_k = _check_shapes(q, k, v, block_q, block_k)
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    scale = d ** -0.5
    qf = q.float()
    kf = k[:, :, None].expand(b, kvh, group, skv, d).reshape(b, h, skv, d)
    vf = v[:, :, None].expand(b, kvh, group, skv, d).reshape(b, h, skv, d)
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for ik in range(skv // block_k):
        sl = slice(ik * block_k, (ik + 1) * block_k)
        s = (qf @ kf[:, :, sl].float().transpose(-1, -2)) * scale
        cols = ik * block_k + torch.arange(block_k, device=q.device)[None, :]
        mask = torch.ones(sq, block_k, dtype=torch.bool, device=q.device)
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= cols > rows - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vf[:, :, sl].float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


#: flash_attention_fwd's argument types before its stream: q, k, v, out;
#: B, H, KVH, Sq, Skv, D; the (b, h, s) strides of q, k and v; causal,
#: has_window, window, scale, block_q, dtype
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float] + [ctypes.c_int] * 2)


def flash_attention(q, k, v, *, causal=True, window=None,
                    block_q: int = 128, block_k: int = 128):
    """q: (B, H, Sq, D); k, v: (B, KVH, Skv, D) -> (B, H, Sq, D).

    CUDA tensors launch the hand-written kernel (one block per
    (batch, head, q tile), kv tiles looped inside the block); CPU tensors
    take :func:`flash_attention_plain`.  Anything else raises."""
    devs = {t.device.type for t in (q, k, v)}
    if devs == {"cpu"}:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k)
    if devs != {"cuda"} or len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"q, k, v must share one CPU or CUDA device, got "
                         f"{[str(t.device) for t in (q, k, v)]}")
    block_q, _ = _check_shapes(q, k, v, block_q, block_k)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built (have {_HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs a unit stride on D")
    if q.dtype == torch.bfloat16 and d in _TMA_HEAD_DIMS and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 wgmma kernel loads q, k, v tiles with "
                         "TMA: they need 16-byte aligned bases and strides "
                         "that are multiples of 8 elements (16 bytes)")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 4 or any(st % 2 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 kernel loads bf16 pairs: q, k, v need "
                         "4-byte aligned rows (even strides)")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    has_window = window is not None
    _build.launch("flash_attention", "flash_attention_fwd", _ARGTYPES,
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, h, kvh, sq, skv, d,
                  q.stride(0), q.stride(1), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2),
                  v.stride(0), v.stride(1), v.stride(2),
                  int(causal), int(has_window),
                  int(window) if has_window else 0, d ** -0.5,
                  block_q, _DTYPES[q.dtype])
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _mm(a, b):
    """``a @ b`` with float32 sums and a float32 result.  bf16 operands on
    the card go through cuBLAS's bf16 product with a float32 output
    (``out_dtype``), as the JAX reference's ``preferred_element_type``
    einsums; anything else is a float32 product of the widened operands
    (exact for bf16, so the two differ only in summation order)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*lead, a.shape[-2], b.shape[-1])
    return a.float() @ b.float()


#: the float32 bytes one tile of scores may take, for the default tile
TILE_BYTES = 256 << 20


def _tile_rows(b: int, h: int, sq: int, skv: int) -> int:
    """The backward's default q tile: the largest power of two (at least
    16, at most Sq's) whose (B, H, tile, Skv) float32 scores fit in
    ``TILE_BYTES``."""
    t = 16
    while t < sq and 2 * t * b * h * skv * 4 <= TILE_BYTES:
        t *= 2
    return min(t, sq)


def _key_span(i0: int, i1: int, skv: int, causal: bool, window):
    """(lo, hi, whole): the keys rows ``i0 .. i1-1`` can see under the
    kernel's absolute mask.  A row that keeps no key at all (a window
    with Sq >= Skv + window) reads every key with equal weight in the
    forward (its scores all ``NEG_INF``), so a tile holding one spans
    every key; ``whole`` says so."""
    if window is not None and (window < 1 or i1 - 1 >= skv - 1 + window):
        return 0, skv, True
    lo = 0 if window is None else max(0, i0 - window + 1)
    hi = min(skv, i1) if causal else skv
    return lo, hi, False


def flash_attention_bwd_plain(q, k, v, out, dout, *, causal=True,
                              window=None, tile_q: int | None = None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k,
    v)`` given its output ``out`` and the output's gradient ``dout``,
    with the kernel's absolute mask (``cols <= rows``, ``cols > rows -
    window``) for any Sq and Skv.

    FlashAttention-2's backward, plain PyTorch, over q tiles of
    ``tile_q`` rows (default :func:`_tile_rows`): a tile's scores are
    recomputed in float32 against only the keys it can see
    (:func:`_key_span`), its rows' max and sum taken in their own passes
    and ``p`` normalized by division (as the forward), then
    ``dv += p^T dO``, ``dp = dO V^T``, ``ds = p * (dp - rowsum(dO * O))``,
    ``dq = ds K * scale``, ``dk += ds^T Q * scale``.  The q heads of one
    kv head are stacked on the tile's row axis, so every product runs
    against the kv head itself and dk, dv come out summed over the group
    (GQA).  At most two float32 (B, H, tile_q, keys) blocks live at a
    time (``p`` and ``dp``, the latter turned into ``ds`` in place).

    On bf16 inputs all five products take bf16 operands with float32
    sums (:func:`_mm`): q k^T and dO V^T on the inputs themselves, p^T dO
    on ``p`` rounded to bf16 (as the kernel rounds P before P V), and the
    two ds products on ``ds`` rounded to bf16.  On float32 inputs every
    product is float32.  The gradients come back in the inputs' dtypes."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5
    low = q.dtype
    tq = tile_q or _tile_rows(b, h, sq, skv)
    dev = q.device
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, kvh, skv, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, kvh, skv, d), dtype=torch.float32, device=dev)
    for i0 in range(0, sq, tq):
        i1 = min(sq, i0 + tq)
        t = i1 - i0
        lo, hi, whole = _key_span(i0, i1, skv, causal, window)
        n = hi - lo
        # (B, KVH, G * t, .): a kv head's q heads stacked on the row axis
        qi = q[:, :, i0:i1].reshape(b, kvh, g * t, d)
        doi = dout[:, :, i0:i1].reshape(b, kvh, g * t, d)
        kj, vj = k[:, :, lo:hi], v[:, :, lo:hi]
        s = _mm(qi, kj.transpose(-1, -2)).mul_(scale)
        rows = torch.arange(i0, i1, device=dev)[:, None]
        cols = torch.arange(lo, hi, device=dev)[None, :]
        keep = None
        if causal or window is not None:
            keep = torch.ones((t, n), dtype=torch.bool, device=dev)
            if causal:
                keep &= cols <= rows
            if window is not None:
                keep &= cols > rows - window
            s.view(b, kvh, g, t, n).masked_fill_(~keep, NEG_INF)
        p = s.sub_(s.amax(-1, keepdim=True)).exp_()
        p = p.div_(p.sum(-1, keepdim=True))
        dv[:, :, lo:hi] += _mm(p.to(low).transpose(-1, -2), doi)
        ds = _mm(doi, vj.transpose(-1, -2))
        ds.sub_(delta[:, :, i0:i1].reshape(b, kvh, g * t, 1)).mul_(p)
        del p
        if whole and keep is not None:
            # a row with no key: its scores are constants, no gradient
            ds.view(b, kvh, g, t, n).masked_fill_(~keep, 0.0)
        ds = ds.to(low)
        dq[:, :, i0:i1] = (_mm(ds, kj) * scale).view(b, kvh, g, t, d) \
            .reshape(b, h, t, d)
        dk[:, :, lo:hi] += _mm(ds.transpose(-1, -2), qi) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` under autograd: the forward launches the
    kernel for CUDA tensors (counted in ``flash_attention.launches``; the
    plain twin for CPU tensors) and saves q, k, v and the output; the
    backward is :func:`flash_attention_bwd_plain`.  Whatever the kernel
    refuses raises here too: nothing falls back to the twin on the card.

    ``FlashAttentionFn.apply(q, k, v, causal, window, block_q, block_k)``.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, block_q=128,
                block_k=128):
        out = flash_attention(q, k, v, causal=causal, window=window,
                              block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_plain(
            q, k, v, out, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None
