"""The Hopper kernel backend, in place of the JAX package's ``pallas``.

Every op that the JAX op table gives a ``pallas`` column is realized here
by a hand-written kernel:

  * ``fused_stream``: a fused instruction group runs as ONE
    ``csrc/fused_stream.cu`` launch with the row block and its length
    register resident;
  * ``activate``, ``shift`` / ``insert`` / ``delete`` (the §4.1
    ``shift_range`` kernel; ``truncate`` moves only the length register),
    ``compare``, ``substring_match`` (the §5 match-end flags that
    ``CPMArray.substring_match`` and ``find_all`` read), ``compact``,
    ``global_limit`` (the §7.5 ``section_limit`` kernel),
    ``section_sum``, ``histogram``, ``super_sum``, ``super_limit``,
    ``sort`` (the §7.7 ``oddeven_sort`` kernel: a bounded sort runs its
    exchange cycles; a full sort, whose N cycles give the sorted row, runs
    a bitonic network on every row without NaN and the cycles on the
    others), ``template_match`` and ``stencil``: per-op kernels
    (``csrc/activate.cu``, ``shift_range.cu``, ``compare.cu``,
    ``substring_match.cu``, ``compact.cu``, ``reduce.cu``,
    ``histogram.cu``, ``super_reduce.cu``, ``oddeven_sort.cu``,
    ``template_match.cu``, ``stencil.cu``).  Batched ``(..., N)`` layouts
    flatten to ``(R, N)`` rows and run as one call.

A reduction called with ``section=None`` takes an autotuned section
(:meth:`CudaBackend._tuned_section`, cached per op, shape, dtype and
backend key in ``repro_torch.cpm.tuning``), falling back to
``optimal_section(n)`` (``histogram``: ``min(1024, n)``), the JAX
adapter's defaults; an explicit ``section=`` bypasses tuning.  Where a
row holds NaN the full sort differs from the reference backend's, as in
JAX: the exchange network spreads NaN through its pairs, ``torch.sort``
puts it last.  ``shift_range`` casts ``fill`` to the row's dtype, as the
JAX kernel does (the reference backend promotes, ROADMAP Queue 3).  On
CPU tensors every kernel wrapper runs its plain twin.
"""

from __future__ import annotations

import functools

from repro_torch.kernels import cpm_kernels as K

from .. import tuning
from ..optable import optimal_section
from ..reference.computable import sum_dtype

_OPS = frozenset({"activate", "shift", "insert", "delete", "truncate",
                  "compare", "substring_match", "compact", "global_limit",
                  "section_sum", "histogram", "super_sum", "super_limit",
                  "sort", "template_match", "stencil"})


def _rows(x):
    """(..., n) -> (contiguous (R, n), unflatten)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return x2, (lambda out: out.reshape(*lead, *out.shape[1:]))


class CudaBackend:
    name = "cuda"

    def supports(self, op: str) -> bool:
        return op in _OPS

    def _tuned_section(self, op: str, x, default: int, run) -> int:
        """Autotuned section for one reduction call, cached per (op, shape,
        dtype, backend key) with a JSON spill (``tuning.pick``): the
        candidates span the ~sqrt(N) paper choice through whole-row
        sections, ``run(section)`` times one on zeros of ``x``'s shape.
        Rows under 2048 lanes, tuning switched off, or no candidate that
        runs keep ``default`` (JAX ``backends/pallas.py:40-57``)."""
        n = x.shape[-1]
        default = min(default, n)
        if n < 2048:                    # tuning overhead beats any return
            return default
        cands = sorted({min(c, n) for c in
                        (optimal_section(n), 256, 1024, 4096, n)})
        key = (f"section:{op}|{'x'.join(map(str, x.shape))}"
               f"|{str(x.dtype).removeprefix('torch.')}"
               f"|{tuning.backend_key(x.device)}")
        return int(tuning.pick(key, cands, run, default=default))

    def _section(self, op: str, x, section, default: int, kernel) -> int:
        """``section``, or the tuned one, candidates timed through
        ``kernel(zeros of x's shape, section)`` (the zeros made only when a
        candidate is timed)."""
        if section is not None:
            return section
        xz = functools.cache(lambda: tuning.synth(x.shape, x.dtype,
                                                  x.device))
        return self._tuned_section(op, x, default,
                                   lambda s: kernel(xz(), s))

    def activate(self, n, start, end, carry=1, *, device=None):
        return K.activate(n, start, end, carry, device=device)

    def shift_range(self, x, start, end, shift, fill=None):
        x2, un = _rows(x)
        return un(K.shift_range(x2, start, end, shift, fill))

    def substring_match(self, hay, needle):
        x2, un = _rows(hay)
        return un(K.substring_match(x2, needle).bool())

    def compare(self, x, datum, op="eq"):
        x2, un = _rows(x)
        return un(K.compare(x2, datum, op))

    def histogram(self, x, edges, section=None):
        section = self._section(
            f"histogram{edges.shape[-1] - 1}", x, section, 1024,
            lambda xz, s: K.histogram(xz, tuning.synth(
                edges.shape, edges.dtype, edges.device), s))
        return K.histogram(x, edges, min(section, x.shape[-1]))

    def template_match(self, data, template):
        x2, un = _rows(data)
        return un(K.template_match(x2, template))

    def stencil(self, x, taps, wrap=False):
        x2, un = _rows(x)
        return un(K.stencil(x2, taps, wrap))

    def section_sum(self, x, section=None):
        x = x.contiguous()
        section = self._section("section_sum", x, section,
                                optimal_section(x.shape[-1]), K.section_sum)
        # the reference's dtype (jnp.sum semantics), as the JAX adapter
        return K.section_sum(x, section).to(sum_dtype(x.dtype))

    def global_limit(self, x, mode="max", section=None):
        x = x.contiguous()
        section = self._section(
            "section_limit", x, section, optimal_section(x.shape[-1]),
            lambda xz, s: K.section_limit(xz, s, mode))
        return K.section_limit(x, section, mode)

    def super_sum(self, x, section=None):
        section = self._section("super_sum", x, section,
                                optimal_section(x.shape[-1]), K.super_sum)
        return K.super_sum(x, section).to(sum_dtype(x.dtype))

    def super_limit(self, x, mode="max", section=None):
        section = self._section(
            "super_limit", x, section, optimal_section(x.shape[-1]),
            lambda xz, s: K.super_limit(xz, s, mode))
        return K.super_limit(x, section, mode)

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
        kernel's plain twin when the rows lie on the CPU); ``block_r``
        rows a block — the executor autotunes it per stream signature."""
        return K.fused_stream(x, used_len, instrs, operands,
                              block_r=block_r)
