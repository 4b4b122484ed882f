"""repro_torch.obs — the port's own telemetry surface (a port of the part
of ``repro.obs`` the session pool and the gateway record through):
``metrics`` (counter / gauge / histogram families of labelled series, and
``series_property`` views) and ``tracing`` (nestable spans and instants
in wall-clock and virtual time).  No exporter, Prometheus text or HTTP
plane here: those wait with ``serve/http.py`` (ROADMAP Queue 1)."""

from . import metrics, tracing

__all__ = ["metrics", "tracing"]
