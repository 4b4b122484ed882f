"""Serving: the batched engine with speculative decoding, its
step-by-step oracle, the paged session pool and the gateway over it (a
port of ``repro.serve``; the HTTP wire front waits for ROADMAP Queue 1)."""

from . import (engine, kv_cache, program_paths, reference, sampling,
               session_pool)
from .engine import Engine, GenConfig
from .gateway import Gateway, Request
from .reference import ReferenceEngine
from .session_pool import PageState, SessionPool

__all__ = ["engine", "kv_cache", "program_paths", "reference", "sampling",
           "session_pool", "Engine", "GenConfig", "Gateway", "Request",
           "PageState", "ReferenceEngine", "SessionPool"]
