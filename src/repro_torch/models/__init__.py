"""The dense-decoder model stack of the port (a port of ``repro.models``
for pure-attention configs such as granite-8b)."""

from . import convert, layers, lm

__all__ = ["convert", "layers", "lm"]
