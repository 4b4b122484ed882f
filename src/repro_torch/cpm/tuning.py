"""The autotune / calibration cache shared by the cost model and the
kernels (a port of ``repro.cpm.tuning``).

The cost-aware scheduler (``repro_torch.cpm.program.costmodel``), the
cuda backend's reduction sections (``repro_torch.cpm.backends.cuda``)
and the fused stream's rows a block
(``repro_torch.cpm.program.executors``) need the same two things:

  * a **memoization surface** keyed by a string the caller derives from
    ``(op-stream signature, shape, dtype, backend key)``: an in-process
    dict backed by a JSON spill, so decisions survive across processes;
  * a **timing harness** that measures candidate realizations on
    synthesized inputs.  Measurement happens only where it measures
    execution (:func:`measurable`): not while ``torch.compile`` traces
    (the calls would be traced, not run) and not while a CUDA graph is
    being captured (the launches would be recorded, not run).  There
    callers get cache hits or their static defaults.

The port keeps its own spill and switches, never the JAX package's, so
neither package reads the other's decisions:

  * ``REPRO_TORCH_CPM_TUNING_CACHE`` — the spill path (default
    ``~/.cache/repro_torch/cpm_tuning.json``);
  * ``REPRO_TORCH_CPM_AUTOTUNE=0`` — no measurement: every lookup that
    misses falls back to the caller's static default, uncached;
  * ``REPRO_TORCH_CPM_CALIBRATE=0`` — the cost model prices with its
    priors instead of calibrating (read by ``costmodel``).

A decision is keyed by :func:`backend_key`, which names the realization
and the card (``cuda-<device name>``) or the plain twins on the CPU
(``cuda-twin-cpu``), so a decision made on one never serves the other.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable

import torch

#: in-process cache: key -> JSON-serializable decision value
_MEM: dict[str, Any] = {}
_LOADED = False


def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_CPM_TUNING_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "cpm_tuning.json"))


def tuning_enabled() -> bool:
    return os.environ.get("REPRO_TORCH_CPM_AUTOTUNE", "1") != "0"


def _load_spill() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    try:
        with open(cache_path()) as f:
            spill = json.load(f)
        if isinstance(spill, dict):
            for k, v in spill.items():
                _MEM.setdefault(k, v)
    except (OSError, ValueError):
        pass


def lookup(key: str):
    """Cached decision for ``key`` or None (miss)."""
    _load_spill()
    return _MEM.get(key)


def store(key: str, value) -> None:
    """Record a decision and spill the whole cache to JSON (best effort:
    an unwritable cache path degrades to in-process memoization only)."""
    _load_spill()
    _MEM[key] = value
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(_MEM, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def clear(in_process_only: bool = True) -> None:
    """Drop cached decisions (tests): ``in_process_only`` keeps the spill
    from reloading; False reloads it at the next lookup."""
    global _LOADED
    _MEM.clear()
    _LOADED = in_process_only


def entries(prefix: str = "") -> dict:
    """Snapshot of cached decisions whose key starts with ``prefix``."""
    _load_spill()
    return {k: v for k, v in _MEM.items() if k.startswith(prefix)}


def backend_key(device) -> str:
    """The backend axis of every cache key: the kernels on one card model
    (``cuda-NVIDIA H100 80GB HBM3``), or their plain twins on the CPU
    (``cuda-twin-cpu``), which are a different machine."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda-{torch.cuda.get_device_name(device)}"
    return f"cuda-twin-{device.type}"


def measurable() -> bool:
    """True where timing a call measures its execution: not while
    ``torch.compile`` traces the caller, and not while a CUDA graph is
    being captured on the current stream.  Callers then fall back to
    cached decisions or static defaults."""
    if torch.compiler.is_compiling():
        return False
    return not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


def synth(shape, dtype, device=None) -> torch.Tensor:
    """Zeros for candidate timing, of the recorded shape and dtype."""
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out`` (nested tuples and lists
    walked)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, (tuple, list)):
        return set().union(set(), *map(_cuda_devices, out))
    return set()


def _wait(out) -> None:
    """Wait for the card where ``out`` holds CUDA tensors (a CUDA call
    returns before its kernels run); CPU results are already done."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def time_call(fn: Callable[[], Any], reps: int = 5) -> float:
    """Best-of-``reps`` wall-clock seconds of ``fn()`` after one warmup
    (which also builds a kernel on its first use), the card synchronized
    around each rep where ``fn`` returns CUDA tensors.  Only meaningful
    when :func:`measurable` — callers gate on it."""
    _wait(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _wait(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def pick(key: str, candidates: list, run: Callable[[Any], Any],
         default, reps: int = 3):
    """Cached argmin-time choice among ``candidates``.

    ``run(c)`` executes one candidate on synthesized inputs; a candidate
    that the kernel's wrapper refuses for the shape (``ValueError`` /
    ``TypeError``) is disqualified, while a failed build or launch
    (``RuntimeError``) propagates.  With tuning
    off, where nothing is :func:`measurable`, or with every candidate
    failing, returns ``default`` without caching, so the decision can be
    made later under better conditions."""
    cached = lookup(key)
    if cached is not None:
        return cached
    if not tuning_enabled() or not measurable() or not candidates:
        return default
    best, best_t = default, float("inf")
    for c in candidates:
        try:
            t = time_call(lambda: run(c), reps=reps)
        except (ValueError, TypeError):
            continue
        if t < best_t:
            best, best_t = c, t
    if best_t == float("inf"):
        return default
    store(key, best)
    return best
