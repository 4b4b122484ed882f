"""Serving: the batched engine with speculative decoding (a port of the
static-batch part of ``repro.serve``; the session pool, gateway and HTTP
wire wait for ROADMAP Queue 1 items 7-8)."""

from . import engine, kv_cache, program_paths, sampling
from .engine import Engine, GenConfig

__all__ = ["engine", "kv_cache", "program_paths", "sampling", "Engine",
           "GenConfig"]
