"""Physical realizations of the CPM instruction set (a port of
``repro.cpm.backends``).

  * ``reference`` — plain PyTorch vector ops (`repro_torch.cpm.reference`):
    always available, the oracle; runs on whatever device holds the data.
  * ``cuda``      — hand-written Hopper kernels, in place of the JAX
    package's ``pallas`` backend: ``fused_stream`` (one launch per fused
    instruction group) and a per-op kernel for every op the JAX op table
    gives a ``pallas`` column (``activate``, the moves through
    ``shift_range``, ``compare``, ``substring_match``, ``histogram``,
    ``template_match``, ``stencil``, ``compact``, ``section_sum``,
    ``global_limit``, ``super_sum``, ``super_limit`` and ``sort``).

``resolve`` honours the paper's pin-compatibility promise per op: a
forced backend that cannot realize an op raises, and ``"auto"`` picks the
reference for any op the kernel backend lacks.  ``"auto"`` sends rows to
the kernels only when they lie on a GPU and are at least
:func:`cuda_min_n` lanes long: a crossover that :func:`measure_crossover`
measured on the card and kept in the tuning cache, else the JAX
package's static ``PALLAS_MIN_N`` (:data:`CUDA_MIN_N`).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

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


def cuda_min_n(op: str | None = None, device=None) -> int:
    """Minimum last-axis length for ``auto`` routing to the kernels.

    Consults the tuning cache for the reference/cuda crossover that
    :func:`measure_crossover` measured on ``device``'s card (default
    ``cuda``) — ``xover:<op>:<backend key>`` per op first, then the
    pooled ``xover:*:<backend key>`` — and falls back to the static
    :data:`CUDA_MIN_N` (JAX ``pallas_min_n``)."""
    from .. import tuning
    bk = tuning.backend_key(torch.device("cuda") if device is None
                            else device)
    for key in ([f"xover:{op}:{bk}"] if op else []) + [f"xover:*:{bk}"]:
        n = tuning.lookup(key)
        if n is not None:
            return int(n)
    return CUDA_MIN_N


#: the ops :func:`measure_crossover` times (the JAX package's crossover
#: sweep, ``benchmarks/run.py``), at its row lengths and on to the paper
#: benchmark's 1,048,576, so that "never" means never up to there
XOVER_OPS = ("compare", "section_sum")
XOVER_SIZES = (256, 1024, 4096, 16384, 65536, 262144, 1 << 20)
_XOVER_CALLS = {"compare": lambda a: a.compare(8, "lt"),
                "section_sum": lambda a: a.section_sum()}


def measure_crossover(device=None, ops=XOVER_OPS, sizes=XOVER_SIZES,
                      reps: int = 5) -> dict:
    """Measure where the kernels start to beat the reference on
    ``device`` (default: the card) and store it for :func:`cuda_min_n`.

    Per op, the first of ``sizes`` at which one ``cuda`` call on a row of
    random int32 symbols is no slower than one ``reference`` call on the
    same row (``2**30`` where none is) goes to ``xover:<op>:<backend
    key>``, and the largest of those to the pooled ``xover:*:<backend
    key>``, as the JAX package's sweep does.  Returns ``{op: n, "*":
    pooled}``."""
    from repro_torch import resolve_device

    from .. import tuning
    from ..array import cpm_array

    dev = resolve_device(device)
    bk = tuning.backend_key(dev)
    g = torch.Generator().manual_seed(2)
    found = {}
    for op in ops:
        call, found[op] = _XOVER_CALLS[op], 1 << 30
        for n in sizes:
            data = torch.randint(0, 16, (n,), generator=g,
                                 dtype=torch.int32).to(dev)
            t = {b: tuning.time_call(
                lambda b=b: call(cpm_array(data, backend=b)), reps=reps)
                for b in ("reference", "cuda")}
            if t["cuda"] <= t["reference"]:
                found[op] = n
                break
        tuning.store(f"xover:{op}:{bk}", found[op])
    found["*"] = max(found[op] for op in ops)
    tuning.store(f"xover:*:{bk}", found["*"])
    return found


def auto_name(is_cuda: bool, n: int, min_n: int = CUDA_MIN_N) -> str:
    """The ``backend="auto"`` rule: the kernel backend for rows on a GPU of
    at least ``min_n`` lanes, the reference otherwise."""
    return "cuda" if is_cuda and n >= min_n else "reference"


def auto_backend_name(data, op: str | None = None) -> str:
    """:func:`auto_name` of ``data``'s rows with :func:`cuda_min_n` — the
    one rule per-op ``resolve`` and the program executor share, so eager
    dispatch and plan execution never pick different backends for the
    same array."""
    if not data.is_cuda:
        return "reference"
    return auto_name(True, data.shape[-1], cuda_min_n(op, data.device))


def resolve(requested: str, op: str, data) -> Backend:
    """The backend for one op call (see the module docstring)."""
    if requested == "auto":
        bk = get_backend(auto_backend_name(data, op))
        return bk if bk.supports(op) else get_backend("reference")
    bk = get_backend(requested)
    if not bk.supports(op):
        raise NotImplementedError(
            f"op {op!r} is not realizable on the {requested!r} backend; "
            f"use backend='auto' for the reference")
    return bk
