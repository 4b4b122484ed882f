"""repro_torch.serve.gateway — the traffic front door (a port of
``repro.serve.gateway``)::

    Gateway (api)  ── submit/stream/cancel, per-request GenConfig + SLO
        │
        ▼ tick
    EngineLoop (loop) ── preempt -> pool.step -> collect
        │                    │
        │                    ├─ admission.plan: same-length buckets ->
        │                    │     ONE prefill per bucket; parked
        │                    │     restores, no prefill
        │                    └─ SessionPool pages (repro_torch.cpm.pool)
        ▼
    Preemptor (preempt) ── SlotAllocator.victim() LRU -> host parking
"""

from . import admission, api, loop, preempt
from .api import Gateway, Request
from .loop import EngineLoop, TickReport
from .preempt import PreemptConfig, Preemptor

__all__ = [
    "admission", "api", "loop", "preempt",
    "Gateway", "Request", "EngineLoop", "TickReport", "PreemptConfig",
    "Preemptor",
]
