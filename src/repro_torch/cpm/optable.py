"""The CPM instruction set, registered once with its cost model.

Every paper operation is an :class:`OpSpec` carrying its *concurrent step
count* formula — the paper's instruction-cycle currency — plus the paper
bound it must stay under.  ``CPMArray.steps_report()`` and
``benchmarks/run.py``'s ``cpm_ops`` scenario both read this table, so the
complexity claims of §3–§8 are validated from a single source of truth.

Formula arguments (all keyword, extras ignored):
  n        physical array length (PE count)
  m        op-specific size: needle length (search), bin count (histogram),
           tap/template length (stencil / template match)
  section  §7.4 section size M (defaults to the optimal ~sqrt(n))
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable


def optimal_section(n: int) -> int:
    """M ~ sqrt(N) minimizes the two-phase cost M + N/M (§7.4).

    The single definition — ``reference.computable`` and the backends
    import it from here.
    """
    return max(1, int(math.isqrt(max(1, n))))


def two_phase_steps(n, section=None, **_):
    """§7.4/§7.5 concurrent steps: M in-section + N/M cross-section."""
    m = section or optimal_section(n)
    return m + -(-n // m)


def _clog2(k: int) -> int:
    """Tree levels to combine ``k`` items: ceil(log2(k)), 0 for k <= 1."""
    return (k - 1).bit_length() if k > 1 else 0


def log_depth_steps(n, section=None, **_):
    """§8 super-connected steps: log-depth trees in both phases,
    clog2(M) + clog2(N/M) ~ log2(N) — the √N → log N upgrade."""
    m = section or optimal_section(n)
    return _clog2(m) + _clog2(-(-n // m))


def log_depth_bound(n, **_):
    """The §8 claim this repo enforces: ~2·log2(N) + 1 concurrent steps."""
    return 2 * _clog2(max(2, n)) + 1


_two_phase = two_phase_steps


@dataclass(frozen=True)
class OpSpec:
    name: str
    family: str                       # activate | move | search | compare | compute
    paper: str                        # section of the source paper
    steps: Callable[..., int]         # concurrent-step formula (registered once)
    bound: Callable[..., int]         # the paper's claimed ceiling
    backends: tuple[str, ...]         # which backends implement it
    #: elementwise/local ops whose kernel body reads only the resident VMEM
    #: block (plus a bounded neighbor window) — the fusing scheduler may run
    #: a run of these as ONE Pallas mega-kernel.  Reductions and sorts read
    #: or reorder the whole row and are fusion-group boundaries.
    fusable: bool = False
    #: wall-clock cost metadata for the cost-aware scheduler
    #: (``repro.cpm.program.costmodel``): how many full row read/write
    #: passes the *lowering* makes (None = reuse the concurrent-step
    #: formula) and how many kernel launches the eager pallas path pays.
    #: Distinct from ``steps``: e.g. ``truncate`` is 1 concurrent step but
    #: 0 row passes / 0 launches — only the length register moves.
    passes: Callable[..., int] | None = None
    eager_launches: int = 1

    def check(self, **sizes) -> int:
        """Evaluate the formula and assert it obeys the paper bound."""
        got, cap = self.steps(**sizes), self.bound(**sizes)
        if got > cap:
            raise AssertionError(
                f"{self.name}: steps formula {got} exceeds paper bound {cap} "
                f"for sizes {sizes}")
        return got


_RPM = ("reference", "pallas", "mesh")
_RP = ("reference", "pallas")

OP_TABLE: dict[str, OpSpec] = {spec.name: spec for spec in [
    # -- activate (Rule 4) --------------------------------------------------
    OpSpec("activate", "activate", "§3.3 R4",
           steps=lambda **_: 1, bound=lambda **_: 1, backends=_RP,
           fusable=True),
    # -- move (§4) ----------------------------------------------------------
    OpSpec("shift", "move", "§4.1",
           steps=lambda **_: 1, bound=lambda **_: 1, backends=_RP,
           fusable=True),
    OpSpec("insert", "move", "§4.2",       # range shift + broadcast write
           steps=lambda **_: 2, bound=lambda **_: 2, backends=_RP,
           fusable=True),
    OpSpec("delete", "move", "§4.2",
           steps=lambda **_: 2, bound=lambda **_: 2, backends=_RP,
           fusable=True),
    OpSpec("truncate", "move", "§4.2",     # range delete at the tail: the
           steps=lambda **_: 1,            # used-length register updates,
           bound=lambda **_: 1,            # entries stay put (O(1))
           backends=_RPM, fusable=True,
           passes=lambda **_: 0, eager_launches=0),
    OpSpec("compact", "move", "§4.2",      # stable pack of kept items: the
           steps=lambda n, **_: _clog2(n),     # TPU-native cumsum-gather is
           bound=lambda n, **_: _clog2(n) + 1, # log-depth (paper: per-object
           backends=_RP),                      # range moves)
    # -- search (§5) --------------------------------------------------------
    OpSpec("substring_match", "search", "§5.1",
           steps=lambda m, **_: m, bound=lambda m, **_: m, backends=_RP,
           fusable=True),
    # -- compare (§6) -------------------------------------------------------
    OpSpec("compare", "compare", "§6.1",
           steps=lambda **_: 1, bound=lambda **_: 1, backends=_RPM,
           fusable=True),
    OpSpec("histogram", "compare", "§6.3", # one compare+count per section edge
           steps=lambda m, **_: m + 1, bound=lambda m, **_: m + 1,
           backends=_RP),
    # -- compute / reduce (§7) ----------------------------------------------
    OpSpec("section_sum", "compute", "§7.4",
           steps=_two_phase,
           bound=lambda n, **_: 2 * math.ceil(math.sqrt(max(1, n))) + 1,
           backends=_RPM),
    OpSpec("global_limit", "compute", "§7.5",
           steps=_two_phase,
           bound=lambda n, **_: 2 * math.ceil(math.sqrt(max(1, n))) + 1,
           backends=_RPM),
    OpSpec("super_sum", "compute", "§8",       # log-depth phase-1 + phase-2
           steps=log_depth_steps, bound=log_depth_bound, backends=_RPM),
    OpSpec("super_limit", "compute", "§8",
           steps=log_depth_steps, bound=log_depth_bound, backends=_RPM),
    OpSpec("sort", "compute", "§7.7",      # full odd-even transposition sort
           steps=lambda n, **_: n, bound=lambda n, **_: n, backends=_RP),
    OpSpec("hybrid_sort", "compute", "§7.7",   # local phase of the sqrt(N) plan
           steps=_two_phase,
           bound=lambda n, **_: 2 * math.ceil(math.sqrt(max(1, n))) + 1,
           backends=("reference",)),
    OpSpec("template_match", "compute", "§7.6",    # ~M vectorized; paper ~M^2
           steps=lambda m, **_: m, bound=lambda m, **_: m * m, backends=_RP,
           fusable=True),
    OpSpec("stencil", "compute", "§7.3",
           steps=lambda m, **_: m, bound=lambda m, **_: m, backends=_RP,
           fusable=True),
]}

FAMILIES = ("activate", "move", "search", "compare", "compute")


def op_steps(name: str, **sizes) -> int:
    """Concurrent-step count of ``name`` for the given sizes (bound-checked)."""
    return OP_TABLE[name].check(**sizes)


def ops_for_backend(backend: str) -> list[str]:
    return [s.name for s in OP_TABLE.values() if backend in s.backends]


def fusable_ops() -> frozenset[str]:
    """Ops the fusing scheduler may place inside one mega-kernel group."""
    return frozenset(s.name for s in OP_TABLE.values() if s.fusable)
