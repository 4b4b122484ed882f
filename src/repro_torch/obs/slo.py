"""SLO burn-rate monitoring + the flight recorder (a port of
``repro.obs.slo``).

The gateway already *grades* every finished request against its
``deadline_steps`` SLO in virtual decode-step time.  This module makes
those grades actionable, SRE-style:

  * :class:`SloMonitor` keeps a rolling window of grades and computes the
    **burn rate** — the fraction of the error budget (``1 - objective``)
    the recent miss rate is consuming — over a **fast** and a **slow**
    window.  An alert fires only when BOTH exceed their thresholds: the
    fast window catches the burst, the slow window confirms it is
    sustained rather than one unlucky tick (the classic multi-window
    multi-burn-rate rule).  Both windows are measured in virtual decode
    steps, so alerts are deterministic and replayable.
  * On alert the :class:`FlightRecorder` dumps everything a post-mortem
    needs — the last-N spans from the live ring, the full metrics
    registry (JSON + Prometheus text), and the allocator's page-table
    state — written **atomically** (temp file + ``os.replace``), so a
    crash mid-dump can never leave a torn artifact.

Everything is host-side accounting between device calls: recording a
grade is a deque append and a burn-rate check is arithmetic over at most
the slow window's events.  Only a dump reads tensors: the allocator's
state vectors, copied to the host with ``.cpu()`` — no sync for the
session pool's allocator, whose metadata lives on the CPU, and one for
an allocator on the card.  A dump runs from ``Gateway._finish`` on the
delivery side, between ticks, never inside a decode chunk.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Any, Callable

import numpy as np

from . import export, metrics
from .live import TraceRing

_SLO_FAMILIES = {
    "alerts": metrics.counter(
        "repro_slo_alerts_total", "burn-rate alerts fired", ("monitor",)),
    "burn": metrics.gauge(
        "repro_slo_burn_rate", "latest burn rate per window",
        ("monitor", "window")),
}


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One rolling window: ``steps`` of virtual time and the burn-rate
    multiple that must be exceeded inside it."""
    steps: int
    threshold: float


#: defaults follow the SRE-book shape scaled to decode-step time: a short
#: window that must burn fast (a miss burst) and a long window that must
#: still be burning (sustained, not noise)
DEFAULT_FAST = BurnWindow(steps=64, threshold=8.0)
DEFAULT_SLOW = BurnWindow(steps=512, threshold=2.0)


class SloMonitor:
    """Multi-window burn-rate monitor over the gateway's deadline grades.

    Wire it with ``Gateway(..., slo_monitor=monitor)``; the gateway calls
    :meth:`record` once per graded finish (met or missed), stamped with
    the pool's decode-step clock.
    """

    def __init__(self, objective: float = 0.95,
                 fast: BurnWindow = DEFAULT_FAST,
                 slow: BurnWindow = DEFAULT_SLOW,
                 recorder: "FlightRecorder | None" = None,
                 cooldown_steps: int | None = None,
                 min_events: int = 4,
                 on_alert: Callable[[dict], None] | None = None,
                 name: str = "gw"):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if fast.steps > slow.steps:
            raise ValueError("fast window must not exceed the slow window")
        self.objective = objective
        self.budget = 1.0 - objective
        self.fast, self.slow = fast, slow
        self.recorder = recorder
        self.min_events = min_events
        self.cooldown_steps = (cooldown_steps if cooldown_steps is not None
                               else fast.steps)
        self.on_alert = on_alert
        self.name = name
        self._events: collections.deque[tuple[int, bool]] = \
            collections.deque()          # (step, met), pruned to slow window
        self.alerts: list[dict] = []
        self.recorded = 0
        self._last_alert_step: int | None = None
        self._series = {
            "alerts": _SLO_FAMILIES["alerts"].labels(monitor=name),
            "burn_fast": _SLO_FAMILIES["burn"].labels(monitor=name,
                                                      window="fast"),
            "burn_slow": _SLO_FAMILIES["burn"].labels(monitor=name,
                                                      window="slow"),
        }

    # -- accounting ---------------------------------------------------------
    def record(self, met: bool, step: int) -> dict | None:
        """One graded finish at virtual time ``step``.  Returns the alert
        dict if this grade tripped the monitor, else None."""
        self._events.append((int(step), bool(met)))
        self.recorded += 1
        horizon = step - self.slow.steps
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()
        return self._evaluate(int(step))

    def _window_rates(self, now: int, window: BurnWindow) -> tuple[float, int]:
        lo = now - window.steps
        total = misses = 0
        for step, met in self._events:
            if step >= lo:
                total += 1
                misses += not met
        return (misses / total if total else 0.0), total

    def burn_rate(self, now: int, window: BurnWindow) -> float:
        """Miss rate inside the window as a multiple of the error budget
        (1.0 = exactly consuming budget; >1 = on track to blow it)."""
        rate, _ = self._window_rates(now, window)
        return rate / self.budget

    def attainment(self, now: int | None = None,
                   window: BurnWindow | None = None) -> float | None:
        """Fraction of grades met inside ``window`` (default: slow)."""
        if now is None:
            now = self._events[-1][0] if self._events else 0
        rate, total = self._window_rates(now, window or self.slow)
        return (1.0 - rate) if total else None

    def _evaluate(self, now: int) -> dict | None:
        fast_rate, fast_n = self._window_rates(now, self.fast)
        slow_rate, slow_n = self._window_rates(now, self.slow)
        fast_burn = fast_rate / self.budget
        slow_burn = slow_rate / self.budget
        self._series["burn_fast"].set(fast_burn)
        self._series["burn_slow"].set(slow_burn)
        if fast_n < self.min_events:
            return None
        if fast_burn <= self.fast.threshold or \
                slow_burn <= self.slow.threshold:
            return None
        if self._last_alert_step is not None and \
                now < self._last_alert_step + self.cooldown_steps:
            return None
        alert = {
            "step": now,
            "objective": self.objective,
            "fast": {"window_steps": self.fast.steps, "burn": fast_burn,
                     "threshold": self.fast.threshold, "events": fast_n},
            "slow": {"window_steps": self.slow.steps, "burn": slow_burn,
                     "threshold": self.slow.threshold, "events": slow_n},
            "dump": None,
        }
        self._last_alert_step = now
        if self.recorder is not None:
            alert["dump"] = self.recorder.dump(
                reason=f"slo_burn step={now} fast={fast_burn:.1f}x "
                       f"slow={slow_burn:.1f}x", extra={"alert": {
                           k: v for k, v in alert.items() if k != "dump"}})
        self.alerts.append(alert)
        self._series["alerts"].inc()
        if self.on_alert is not None:
            self.on_alert(alert)
        return alert

    def state(self) -> dict:
        """JSON-able live view (served by ``GET /v1/stats``)."""
        now = self._events[-1][0] if self._events else 0
        return {
            "objective": self.objective,
            "recorded": self.recorded,
            "attainment_slow": self.attainment(now),
            "burn_fast": self.burn_rate(now, self.fast),
            "burn_slow": self.burn_rate(now, self.slow),
            "alerts": len(self.alerts),
            "last_alert_step": self._last_alert_step,
        }


def allocator_state(pool) -> dict:
    """The pool allocator's page-table state as JSON-able host data: slot
    occupancy, sub-page occupancy, and each used slot's ordered page
    list — exactly what a post-mortem of a page-pressure incident needs."""
    alloc = pool.alloc
    slots = np.asarray(alloc.state_vector()).astype(int).tolist()
    pages = np.asarray(alloc.page_state_vector()).astype(int).tolist()
    used = [s for s, st in enumerate(slots) if st != 0]
    return {
        "n_slots": len(slots),
        "n_pages": len(pages),
        "slot_state": slots,
        "page_state": pages,
        "free_slots": alloc.free_count(),
        "free_pages": alloc.page_free_count(),
        "page_lists": {str(s): list(alloc.pages(s)) for s in used},
        "page_size": pool.page_size,
        "total_pages": pool.total_pages,
    }


class FlightRecorder:
    """Atomic post-mortem dumps: last-N spans + registry + page table.

    One ``dump()`` writes ``flight_<seq>.json`` under ``directory`` via a
    same-directory temp file and ``os.replace`` — readers can never see a
    torn file.  The payload round-trips through the repo's own
    validators: ``trace`` through ``validate_chrome_trace`` and
    ``metrics_prom`` through ``obs.promparse.parse``.
    """

    def __init__(self, directory: str = "artifacts/flightrec",
                 ring: TraceRing | None = None, pool=None,
                 last_n: int = 256, max_dumps: int = 16):
        self.directory = directory
        self.ring = ring
        self.pool = pool
        self.last_n = last_n
        self.max_dumps = max_dumps
        self._seq = 0

    def dump(self, reason: str, extra: dict | None = None) -> str | None:
        """Write one dump; returns its path (None once ``max_dumps`` is
        reached — a flapping alert must not fill the disk)."""
        if self._seq >= self.max_dumps:
            return None
        os.makedirs(self.directory, exist_ok=True)
        spans = self.ring.last(self.last_n) if self.ring is not None else []
        payload: dict[str, Any] = {
            "reason": reason,
            "wall_time": time.time(),
            "seq": self._seq,
            "ring": self.ring.stats() if self.ring is not None else None,
            "trace": export.chrome_trace(spans),
            "metrics": metrics.REGISTRY.snapshot(),
            "metrics_prom": metrics.REGISTRY.prometheus_text(),
            "allocator": (allocator_state(self.pool)
                          if self.pool is not None else None),
            "extra": extra,
        }
        path = os.path.join(self.directory, f"flight_{self._seq:04d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._seq += 1
        return path
