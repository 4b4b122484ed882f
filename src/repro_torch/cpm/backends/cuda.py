"""The Hopper kernel backend, in place of the JAX package's ``pallas``.

  * ``fused_stream``: a fused instruction group runs as ONE
    ``csrc/fused_stream.cu`` launch with the row block and its length
    register resident;
  * ``compare``, ``compact``, ``global_limit`` (the §7.5 ``section_limit``
    kernel) and ``section_sum``: per-op kernels (``csrc/compare.cu``,
    ``compact.cu``, ``reduce.cu``).  Batched ``(..., N)`` layouts flatten
    to ``(R, N)`` rows and run as one call.

A reduction called with ``section=None`` takes ``optimal_section(n)``:
the port has no ``tuning`` module yet (ROADMAP Queue 1 item 3), so there
is no autotuned section.  The other per-op kernels (activate,
shift_range, substring/template match, stencil, ...) are still to port
(ROADMAP Queue 2): ``supports`` is False for them and a call raises —
the pin-compatibility contract, a forced backend that lacks an op never
substitutes another realization.  On CPU tensors every kernel wrapper
runs its plain twin.
"""

from __future__ import annotations

from repro_torch.kernels import cpm_kernels as K

from ..optable import optimal_section
from ..reference.computable import sum_dtype

_OPS = frozenset({"compare", "compact", "global_limit", "section_sum"})


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
        _missing("substring_match")

    def compare(self, x, datum, op="eq"):
        x2, un = _rows(x)
        return un(K.compare(x2, datum, op))

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
