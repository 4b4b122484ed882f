"""The always-available plain-PyTorch backend (the oracle)."""

from __future__ import annotations

import torch

from .. import reference as R

_OPS = frozenset({"activate", "shift", "insert", "delete", "truncate",
                  "substring_match", "compare", "template_match",
                  "stencil", "section_sum", "global_limit", "compact",
                  "histogram", "super_sum", "super_limit", "sort"})


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

    def histogram(self, x, edges):
        return R.comparable.histogram(x, edges)

    def super_sum(self, x, section=None):
        return R.computable.super_sum(x, section)

    def super_limit(self, x, mode="max", section=None):
        return R.computable.super_limit(x, section, mode)

    def sort(self, x, steps=None):
        # a full sort is the stable torch.sort, as jnp.sort (the odd-even
        # network's values for rows without NaN; NaN sorts last, and equal
        # zeros keep their order where the network puts -0.0 first); a
        # bounded one keeps the paper's exchange cycles
        if steps is not None:
            return R.computable.odd_even_sort(x, steps)
        return torch.sort(x, dim=-1, stable=True).values

    def template_match(self, data, template):
        return R.computable.template_match_1d(data, template)

    def stencil(self, x, taps, wrap=False):
        return R.computable.stencil_1d(x, taps, wrap=wrap)

    def section_sum(self, x, section=None):
        return R.computable.section_sum(x, section)

    def global_limit(self, x, mode="max", section=None):
        return R.computable.section_limit(x, section, mode)

    def compact(self, x, keep, fill=0):
        return R.movable.compact(x, keep, fill)
