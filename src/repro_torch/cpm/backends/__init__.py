"""Physical realizations of the CPM instruction set (a port of
``repro.cpm.backends``).

  * ``reference`` — plain PyTorch vector ops (`repro_torch.cpm.reference`):
    always available, the oracle; runs on whatever device holds the data.
  * ``cuda``      — hand-written Hopper kernels, in place of the JAX
    package's ``pallas`` backend.  This slice ports its ``fused_stream``
    (one launch per fused instruction group); its per-op kernels are
    still to port (ROADMAP Queue 2), so it supports no single op yet.

``resolve`` honours the paper's pin-compatibility promise per op: a
forced backend that cannot realize an op raises, and ``"auto"`` picks the
reference for any op the kernel backend lacks.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class Backend(Protocol):
    """The broadcast-instruction surface of a realization; every op treats
    the last axis as the PE address axis."""

    name: str

    def supports(self, op: str) -> bool: ...
    def activate(self, n: int, start, end, carry=1, *, device=None): ...
    def shift_range(self, x, start, end, shift: int, fill=None): ...
    def substring_match(self, hay, needle): ...          # match-END flags
    def compare(self, x, datum, op: str = "eq"): ...
    def template_match(self, data, template): ...
    def stencil(self, x, taps, wrap: bool = False): ...

    def fused_stream(self, x, used_len, instrs, operands,
                     block_r: int = 1):
        """One launch for a fused instruction group; only backends that
        keep the row resident across instructions implement it."""
        raise NotImplementedError(
            f"backend {self.name!r} has no fused-stream realization")


def _registry():
    from . import cuda, reference
    return {"reference": reference.ReferenceBackend,
            "cuda": cuda.CudaBackend}


_INSTANCES: dict = {}


def get_backend(name: str) -> Backend:
    """The (memoized) backend instance named ``reference`` or ``cuda``."""
    reg = _registry()
    if name not in reg:
        raise ValueError(f"unknown CPM backend {name!r}; have {sorted(reg)}")
    if name not in _INSTANCES:
        _INSTANCES[name] = reg[name]()
    return _INSTANCES[name]


def auto_backend_name(data) -> str:
    """The ``backend="auto"`` rule for whole programs: the kernel backend
    when the rows live on a GPU, the reference otherwise."""
    return "cuda" if data.is_cuda else "reference"


def resolve(requested: str, op: str, data) -> Backend:
    """The backend for one op call (see the module docstring)."""
    if requested == "auto":
        bk = get_backend(auto_backend_name(data))
        return bk if bk.supports(op) else get_backend("reference")
    bk = get_backend(requested)
    if not bk.supports(op):
        raise NotImplementedError(
            f"op {op!r} is not realizable on the {requested!r} backend "
            f"(its per-op kernel is still to port, ROADMAP Queue 2); use "
            f"backend='auto' for the reference")
    return bk
