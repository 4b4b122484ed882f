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
           "fused_stream": cpm_kernels.fused_stream,
           "gather_rows": cpm_kernels.gather_rows,
           "scatter_rows": cpm_kernels.scatter_rows,
           "compare": cpm_kernels.compare,
           "substring_match": cpm_kernels.substring_match,
           "section_sum": cpm_kernels.section_sum,
           "section_limit": cpm_kernels.section_limit,
           "compact": cpm_kernels.compact,
           "histogram": cpm_kernels.histogram,
           "super_sum": cpm_kernels.super_sum,
           "super_limit": cpm_kernels.super_limit,
           "oddeven_sort": cpm_kernels.oddeven_sort,
           "activate": cpm_kernels.activate,
           "shift_range": cpm_kernels.shift_range,
           "template_match": cpm_kernels.template_match,
           "stencil": cpm_kernels.stencil}


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


def sort(x, *, impl=None):
    """Row-wise ascending sort of ``(R, N)`` rows: the odd-even kernel
    (N exchange cycles) or the reference's full sort."""
    if _mode(impl, x) == "ref":
        return ref.oddeven_sort_ref(x)
    return cpm_kernels.oddeven_sort(x)


def section_sum(x, *, section=1024, impl=None):
    """Two-phase sum of every ``(..., N)`` row: the kernel with ``section``
    lanes a section, or the reference with its own ~sqrt(N) sections (as
    ``repro.kernels.ops.section_sum``, whose reference takes none)."""
    if _mode(impl, x) == "ref":
        return ref.section_sum_ref(x)
    return cpm_kernels.section_sum(x, section)


def substring_match(hay, needle, *, impl=None):
    """Match-END flags of an ``(M,)`` needle in every ``(R, N)`` row: the
    kernel's int8 flags, or the reference's bool flags (as
    ``repro.kernels.ops.substring_match``)."""
    if _mode(impl, hay) == "ref":
        return ref.substring_match_ref(hay, needle)
    return cpm_kernels.substring_match(hay, needle)


def template_match(data, template, *, impl=None):
    """§7.6 sliding SAD of an ``(M,)`` template over every ``(R, N)`` row:
    the kernel's float32 SAD, or the reference's (as
    ``repro.kernels.ops.template_match``)."""
    if _mode(impl, data) == "ref":
        return ref.template_match_ref(data, template)
    return cpm_kernels.template_match(data, template)


def stencil(x, taps, *, impl=None):
    """§7.3 ring stencil (``wrap=True``) of every ``(R, N)`` row: the kernel
    or the reference (as ``repro.kernels.ops.stencil``)."""
    if _mode(impl, x) == "ref":
        return ref.stencil_ref(x, list(taps))
    return cpm_kernels.stencil(x, tuple(taps))


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
