"""Serving: the batched engine with speculative decoding, the paged
session pool and the gateway over it (a port of ``repro.serve``; the
HTTP wire front waits for ROADMAP Queue 1)."""

from . import engine, kv_cache, program_paths, sampling, session_pool
from .engine import Engine, GenConfig
from .gateway import Gateway, Request
from .session_pool import PageState, SessionPool

__all__ = ["engine", "kv_cache", "program_paths", "sampling",
           "session_pool", "Engine", "GenConfig", "Gateway", "Request",
           "PageState", "SessionPool"]
