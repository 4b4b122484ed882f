"""The Hopper kernel backend, in place of the JAX package's ``pallas``.

  * ``fused_stream``: a fused instruction group runs as ONE
    ``csrc/fused_stream.cu`` launch with the row block and its length
    register resident;
  * ``compare``, ``substring_match`` (the §5 match-end flags that
    ``CPMArray.substring_match`` and ``find_all`` read), ``compact``,
    ``global_limit`` (the §7.5 ``section_limit`` kernel),
    ``section_sum``, ``histogram``, ``super_sum``, ``super_limit`` and
    ``sort`` (the §7.7 ``oddeven_sort`` kernel, a full sort being N
    exchange cycles): per-op kernels (``csrc/compare.cu``,
    ``substring_match.cu``, ``compact.cu``, ``reduce.cu``,
    ``histogram.cu``, ``super_reduce.cu``, ``oddeven_sort.cu``).  Batched
    ``(..., N)`` layouts flatten to ``(R, N)`` rows and run as one call.

A reduction called with ``section=None`` takes ``optimal_section(n)``,
and ``histogram`` ``min(1024, n)`` lanes, the JAX adapter's defaults:
the port has no ``tuning`` module yet (ROADMAP Queue 1 item 3), so there
is no autotuned section.  Where a row holds NaN the full sort differs
from the reference backend's, as in JAX: the exchange network spreads
NaN through its pairs, ``torch.sort`` puts it last.  The other per-op
kernels (activate, shift_range, template_match, stencil)
are still to port (ROADMAP Queue 2): ``supports`` is False for them and
a call raises — the pin-compatibility contract, a forced backend that
lacks an op never substitutes another realization.  On CPU tensors every
kernel wrapper runs its plain twin.
"""

from __future__ import annotations

from repro_torch.kernels import cpm_kernels as K

from ..optable import optimal_section
from ..reference.computable import sum_dtype

_OPS = frozenset({"compare", "substring_match", "compact", "global_limit",
                  "section_sum", "histogram", "super_sum", "super_limit",
                  "sort"})


def _missing(op: str):
    raise NotImplementedError(
        f"the cuda backend has no per-op {op!r} kernel yet (ROADMAP "
        f"Queue 2); fused groups run through fused_stream")


def _rows(x):
    """(..., n) -> (contiguous (R, n), unflatten)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return x2, (lambda out: out.reshape(*lead, *out.shape[1:]))


class CudaBackend:
    name = "cuda"

    def supports(self, op: str) -> bool:
        return op in _OPS

    def activate(self, n, start, end, carry=1, *, device=None):
        _missing("activate")

    def shift_range(self, x, start, end, shift, fill=None):
        _missing("shift_range")

    def substring_match(self, hay, needle):
        x2, un = _rows(hay)
        return un(K.substring_match(x2, needle).bool())

    def compare(self, x, datum, op="eq"):
        x2, un = _rows(x)
        return un(K.compare(x2, datum, op))

    def histogram(self, x, edges, section=None):
        return K.histogram(x, edges, min(section or 1024, x.shape[-1]))

    def template_match(self, data, template):
        _missing("template_match")

    def stencil(self, x, taps, wrap=False):
        _missing("stencil")

    def section_sum(self, x, section=None):
        x = x.contiguous()
        out = K.section_sum(x, section or optimal_section(x.shape[-1]))
        # the reference's dtype (jnp.sum semantics), as the JAX adapter
        return out.to(sum_dtype(x.dtype))

    def global_limit(self, x, mode="max", section=None):
        x = x.contiguous()
        return K.section_limit(x, section or optimal_section(x.shape[-1]),
                               mode)

    def super_sum(self, x, section=None):
        out = K.super_sum(x, section or optimal_section(x.shape[-1]))
        return out.to(sum_dtype(x.dtype))

    def super_limit(self, x, mode="max", section=None):
        return K.super_limit(x, section or optimal_section(x.shape[-1]),
                             mode)

    def sort(self, x, steps=None):
        x2, un = _rows(x)
        return un(K.oddeven_sort(x2, steps))

    def compact(self, x, keep, fill=0):
        lead = x.shape[:-1]
        x2, un = _rows(x)
        k2 = keep.broadcast_to(x.shape).reshape(x2.shape).contiguous()
        out, new_len = K.compact(x2, k2, fill)
        return un(out), new_len.reshape(lead)

    def fused_stream(self, x, used_len, instrs, operands, block_r: int = 1):
        """One ``fused_stream`` kernel launch for a whole fused group (the
        kernel's plain twin when the rows lie on the CPU)."""
        return K.fused_stream(x, used_len, instrs, operands,
                              block_r=block_r)
