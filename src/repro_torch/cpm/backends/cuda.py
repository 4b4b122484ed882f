"""The Hopper kernel backend, in place of the JAX package's ``pallas``.

This slice ports its ``fused_stream``: a fused instruction group runs as
ONE ``csrc/fused_stream.cu`` launch with the row block and its length
register resident.  The per-op kernels (activate, shift_range, compare,
substring/template match, stencil, ...) are still to port (ROADMAP
Queue 2), so ``supports`` is False for every single op and a call raises:
the pin-compatibility contract — a forced backend that lacks an op
raises, it never substitutes another realization.
"""

from __future__ import annotations

from repro_torch.kernels import cpm_kernels


def _missing(op: str):
    raise NotImplementedError(
        f"the cuda backend has no per-op {op!r} kernel yet (ROADMAP "
        f"Queue 2); fused groups run through fused_stream")


class CudaBackend:
    name = "cuda"

    def supports(self, op: str) -> bool:
        return False

    def activate(self, n, start, end, carry=1, *, device=None):
        _missing("activate")

    def shift_range(self, x, start, end, shift, fill=None):
        _missing("shift_range")

    def substring_match(self, hay, needle):
        _missing("substring_match")

    def compare(self, x, datum, op="eq"):
        _missing("compare")

    def template_match(self, data, template):
        _missing("template_match")

    def stencil(self, x, taps, wrap=False):
        _missing("stencil")

    def fused_stream(self, x, used_len, instrs, operands, block_r: int = 1):
        """One ``fused_stream`` kernel launch for a whole fused group (the
        kernel's plain twin when the rows lie on the CPU)."""
        return cpm_kernels.fused_stream(x, used_len, instrs, operands,
                                        block_r=block_r)
