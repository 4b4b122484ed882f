"""Physical realizations of the CPM instruction set (a port of
``repro.cpm.backends``).

  * ``reference`` — plain PyTorch vector ops (`repro_torch.cpm.reference`):
    always available, the oracle; runs on whatever device holds the data.
  * ``cuda``      — hand-written Hopper kernels, in place of the JAX
    package's ``pallas`` backend: ``fused_stream`` (one launch per fused
    instruction group) and the per-op ``compare``, ``substring_match``,
    ``compact``, ``global_limit``, ``section_sum``, ``histogram``,
    ``super_sum``, ``super_limit`` and ``sort``; its other per-op kernels
    are still to port (ROADMAP Queue 2).

``resolve`` honours the paper's pin-compatibility promise per op: a
forced backend that cannot realize an op raises, and ``"auto"`` picks the
reference for any op the kernel backend lacks.  ``"auto"`` sends rows to
the kernels only when they lie on a GPU and are at least
:data:`CUDA_MIN_N` lanes long, the JAX package's static ``PALLAS_MIN_N``
rule (the port has measured no crossover, so there is no tuning lookup).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

#: rows shorter than this are not worth a kernel launch — stay on reference
CUDA_MIN_N = 1024


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
    def histogram(self, x, edges): ...                   # (..., M) int32
    def template_match(self, data, template): ...
    def stencil(self, x, taps, wrap: bool = False): ...
    def section_sum(self, x, section=None): ...
    def global_limit(self, x, mode: str = "max", section=None): ...
    def super_sum(self, x, section=None): ...
    def super_limit(self, x, mode: str = "max", section=None): ...
    def sort(self, x, steps=None): ...
    def compact(self, x, keep, fill=0): ...                # (data, new_len)

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


def auto_name(is_cuda: bool, n: int) -> str:
    """The ``backend="auto"`` rule: the kernel backend for rows on a GPU of
    at least :data:`CUDA_MIN_N` lanes, the reference otherwise."""
    return "cuda" if is_cuda and n >= CUDA_MIN_N else "reference"


def auto_backend_name(data, op: str | None = None) -> str:
    """:func:`auto_name` of ``data``'s rows — the one rule per-op
    ``resolve`` and the program executor share, so eager dispatch and
    plan execution never pick different backends for the same array
    (``op`` is accepted for the JAX signature; no per-op crossover is
    measured)."""
    return auto_name(data.is_cuda, data.shape[-1])


def resolve(requested: str, op: str, data) -> Backend:
    """The backend for one op call (see the module docstring)."""
    if requested == "auto":
        bk = get_backend(auto_backend_name(data, op))
        return bk if bk.supports(op) else get_backend("reference")
    bk = get_backend(requested)
    if not bk.supports(op):
        raise NotImplementedError(
            f"op {op!r} is not realizable on the {requested!r} backend "
            f"(its per-op kernel is still to port, ROADMAP Queue 2); use "
            f"backend='auto' for the reference")
    return bk
