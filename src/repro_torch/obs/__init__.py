"""repro_torch.obs — the port's own telemetry surface (a port of the part
of ``repro.obs`` the session pool, the gateway and the CPM programs
record through): ``metrics`` (counter / gauge / histogram families of
labelled series, and ``series_property`` views), ``tracing`` (nestable
spans and instants in wall-clock and virtual time) and ``cycles`` (the
cycle ledger: predicted against measured concurrent steps per op
family).  No exporter, Prometheus text or HTTP
plane here: those wait with ``serve/http.py`` (ROADMAP Queue 1)."""

from . import cycles, metrics, tracing

__all__ = ["cycles", "metrics", "tracing"]
