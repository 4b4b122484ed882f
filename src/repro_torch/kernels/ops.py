"""Public kernel entry points with device dispatch (a port of
``repro.kernels.ops``).

``impl=None`` resolves by where the tensors live, as the JAX package's
``DEFAULT_IMPL`` is ``"pallas"`` on TPU deployments: CUDA tensors go to
the hand-written kernel, CPU tensors to the plain reference dataflow.
``impl="kernel"`` asks for the kernel wrapper (which, given CPU tensors,
runs the kernel's plain twin); ``impl="ref"`` asks for the reference.
Each kernel wrapper counts its launches in a plain integer attribute;
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes
them.
"""

from __future__ import annotations

from . import cpm_kernels, flash_attention as fa, ref

#: every hand-written kernel wrapper of the port, by kernel name
KERNELS = {"flash_attention": fa.flash_attention,
           "fused_stream": cpm_kernels.fused_stream}


def _mode(impl, t) -> str:
    if impl is None:
        return "kernel" if t.is_cuda else "ref"
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl must be None, 'kernel' or 'ref', got "
                         f"{impl!r}")
    return impl


def attention(q, k, v, *, causal=True, window=None, impl=None, **kw):
    """Prefill / forward attention: q (B, H, Sq, D), k, v (B, KVH, Skv, D)."""
    if _mode(impl, q) == "ref":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window,
            **{k_: v_ for k_, v_ in kw.items() if k_ == "block_k"})
    return fa.flash_attention(q, k, v, causal=causal, window=window, **kw)


def decode_attention(q, k, v, cache_len=None, *, window=None):
    """Single-token decode attention: plain PyTorch on every device, as in
    the JAX package (not a Pallas kernel there)."""
    return ref.decode_attention_ref(q, k, v, cache_len, window=window)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
