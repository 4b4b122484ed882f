"""The always-available plain-PyTorch backend (the oracle)."""

from __future__ import annotations

from .. import reference as R

_OPS = frozenset({"activate", "shift", "insert", "delete", "truncate",
                  "substring_match", "compare", "template_match",
                  "stencil"})


class ReferenceBackend:
    name = "reference"

    def supports(self, op: str) -> bool:
        return op in _OPS

    def activate(self, n, start, end, carry=1, *, device=None):
        return R.pe_array.activation_mask(n, start, end, carry,
                                          device=device)

    def shift_range(self, x, start, end, shift, fill=None):
        return R.movable.shift_range(x, start, end, shift, fill)

    def substring_match(self, hay, needle):
        return R.searchable.substring_match(hay, needle)

    def compare(self, x, datum, op="eq"):
        return R.comparable.compare(x, datum, op)

    def template_match(self, data, template):
        return R.computable.template_match_1d(data, template)

    def stencil(self, x, taps, wrap=False):
        return R.computable.stencil_1d(x, taps, wrap=wrap)
