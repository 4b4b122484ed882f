"""Plain-PyTorch oracles (a port of ``repro.kernels.ref``): attention,
and the row sort and sectioned sum the CPM kernels are held to.

``flash_attention_ref`` is the chunked online-softmax dataflow the JAX
package runs off the TPU: streams stay in the input dtype, the softmax
statistics and the accumulator are float32.  ``decode_attention_ref`` is
the single-token decode attention; it is plain PyTorch on every device,
as it is plain ``jnp`` on the TPU (``repro.kernels.ops.decode_attention``
is not a Pallas kernel).

``preferred_element_type=float32`` products of narrow inputs are written
as float32 products of the widened inputs: widening bf16 is exact, so the
two differ only in summation order.
"""

from __future__ import annotations

import functools

import torch

NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def _in_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float: multiplying a tensor
    by it rounds like ``x * weak_python_scalar`` in JAX (the scalar takes
    the array's dtype first) and needs no host-to-device copy.  Cached:
    the rounding is a host computation, done once per (value, dtype)."""
    return float(torch.tensor(v, dtype=dtype))


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, KVH, S, D) -> (B, KVH*group, S, D); head ``h`` reads kv head
    ``h // group``."""
    if group == 1:
        return x
    b, kvh, s, d = x.shape
    return x[:, :, None].expand(b, kvh, group, s, d).reshape(b, kvh * group,
                                                             s, d)


def _mask(rows: torch.Tensor, cols: torch.Tensor, causal: bool,
          window: int | None) -> torch.Tensor:
    mask = torch.ones(rows.shape[0], cols.shape[-1], dtype=torch.bool,
                      device=rows.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def attention_naive(q, k, v, *, causal=True, window=None):
    """O(S²)-materialized softmax attention (rows end-aligned, decode
    style).  q: (B, H, Sq, D); k, v: (B, KVH, Skv, D)."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    kk = _repeat_kv(k, h // kvh).float()
    vv = _repeat_kv(v, h // kvh).float()
    s = (q.float() @ kk.transpose(-1, -2)) * (d ** -0.5)
    rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    cols = torch.arange(skv, device=q.device)[None, :]
    s = torch.where(_mask(rows, cols, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ vv).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=None, block_k=512):
    """Chunked online-softmax attention (the kernel's dataflow, plain).

    Rows are end-aligned (``rows = arange(Sq) + Skv - Sq``), as in the JAX
    reference; at prefill ``Sq == Skv`` and this equals the kernel's mask.
    """
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    block_k = min(block_k, skv)
    if skv % block_k:
        raise ValueError(f"Skv={skv} is not a multiple of block_k={block_k}")
    nk = skv // block_k
    ct = q.dtype
    qf = (q * _in_dtype(d ** -0.5, ct)).float()
    kf = _repeat_kv(k, group)
    vf = _repeat_kv(v, group)
    rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for ik in range(nk):
        sl = slice(ik * block_k, (ik + 1) * block_k)
        kb = kf[:, :, sl].float()
        vb = vf[:, :, sl].float()
        s = qf @ kb.transpose(-1, -2)
        cols = ik * block_k + torch.arange(block_k, device=q.device)[None, :]
        s = torch.where(_mask(rows, cols, causal, window), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(ct).float() @ vb
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def decode_attention_ref(q, k, v, cache_len=None, *, window=None):
    """Single-step decode: q (B, H, 1, D) against a (B, KVH, S, D) cache;
    positions >= cache_len (scalar or (B,)) are masked.  Grouped: no kv
    repeat."""
    b, h, _, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    ct = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    qf = (q[:, :, 0].reshape(b, kvh, group, d)
          * _in_dtype(d ** -0.5, q.dtype)).to(ct)
    s = qf.float() @ k.to(ct).float().transpose(-1, -2)     # (B, KVH, G, S)
    if cache_len is not None:
        cl = torch.as_tensor(cache_len, device=q.device)
        pos = torch.arange(skv, device=q.device)
        lo = cl if cl.ndim == 0 else cl[:, None, None, None]
        live = pos < lo
        if window is not None:
            live &= pos >= lo - window
        s = torch.where(live, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = p.to(ct).float() @ v.to(ct).float()
    return out.reshape(b, h, 1, d).to(q.dtype)


def oddeven_sort_ref(x: torch.Tensor) -> torch.Tensor:
    """Row-wise ascending sort: the reference backend's full sort (the
    oracle: stable ``torch.sort``, NaN last)."""
    from repro_torch.cpm.backends import get_backend

    return get_backend("reference").sort(x)


def section_sum_ref(x: torch.Tensor, section: int | None = None):
    """The §7.4 two-phase sum of the CPM reference."""
    from repro_torch.cpm.reference.computable import section_sum

    return section_sum(x, section)


def substring_match_ref(hay: torch.Tensor, needle: torch.Tensor):
    """Match-END flags of the CPM reference's §5 carry chain."""
    from repro_torch.cpm.reference.searchable import substring_match

    return substring_match(hay, needle)
