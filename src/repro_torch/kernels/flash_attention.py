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
tensors and counts the launch in ``flash_attention.launches``; for CPU
tensors it runs :func:`flash_attention_plain`, which repeats the TPU
kernel's arithmetic tile by tile in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

#: rows of q handled by one CUDA block at most (the wrapper's contract)
MAX_BLOCK_Q = 128
_HEAD_DIMS = (16, 32, 64, 128)
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


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L = ctypes.c_longlong
        fn.argtypes = [P, P, P, P,                 # q, k, v, out
                       I, I, I, I, I, I,           # B, H, KVH, Sq, Skv, D
                       L, L, L, L, L, L, L, L, L,  # q/k/v strides (b, h, s)
                       I, I, I, F, I, I, P]        # causal, has_window,
        fn.restype = ctypes.c_int                  # window, scale, block_q,
    return lib, fn                                 # dtype, stream


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
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 4 or any(st % 2 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 kernel loads bf16 pairs: q, k, v need "
                         "4-byte aligned rows (even strides)")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lib, fn = _lib()
    has_window = window is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, h, kvh, sq, skv, d,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                int(causal), int(has_window),
                int(window) if has_window else 0, d ** -0.5,
                block_q, _DTYPES[q.dtype], stream)
    _build.check(lib, rc, "flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
