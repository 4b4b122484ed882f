"""Plain-PyTorch realizations of the paper operations the serving slice
needs (a port of part of ``repro.cpm.reference``): the oracle backend."""

from . import comparable, computable, movable, pe_array, searchable

__all__ = ["comparable", "computable", "movable", "pe_array", "searchable"]
