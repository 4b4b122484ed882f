"""Serving: the batched engine with speculative decoding, its
step-by-step oracle, the paged session pool, the gateway over it and the
HTTP/SSE wire front over the gateway (a port of ``repro.serve``)."""

from . import (engine, gateway, http, kv_cache, program_paths, reference,
               sampling, session_pool)
from .engine import Engine, GenConfig
from .gateway import Gateway, Request
from .http import HttpFrontend, SSEDecoder
from .reference import ReferenceEngine
from .session_pool import PageState, SessionPool

__all__ = ["engine", "gateway", "http", "kv_cache", "program_paths",
           "reference", "sampling", "session_pool", "Engine", "GenConfig",
           "Gateway", "Request", "HttpFrontend", "SSEDecoder", "PageState",
           "ReferenceEngine", "SessionPool"]
