"""Loop trips of the reference algorithms, counted as they run.

The JAX package reads an algorithm's concurrent-step count off its
jaxpr (the trip count of each ``lax.scan`` / ``fori_loop``,
``repro.cpm.program.introspect``).  The port's reference loops in
Python, so each loop trip (one tree level, one odd-even exchange cycle,
one edge of a histogram) calls :func:`trip`, and :func:`count_trips`
collects them::

    with count_trips() as trips:
        computable.super_sum(x)
    assert trips.n == op_steps("super_sum", n=x.shape[-1])
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass


@dataclass
class Trips:
    n: int = 0


_ACTIVE: list[Trips] = []


def trip() -> None:
    """One loop trip of a reference algorithm (one concurrent step)."""
    for t in _ACTIVE:
        t.n += 1


@contextlib.contextmanager
def count_trips():
    """Count the loop trips of the reference calls made inside."""
    t = Trips()
    _ACTIVE.append(t)
    try:
        yield t
    finally:
        _ACTIVE.remove(t)
