"""Build and load the port's hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
are cached under ``<checkout>/build/repro_torch/`` by a hash of the
source, the shared headers and the flags (``REPRO_TORCH_BUILD_DIR``
names another directory; a copy installed outside a checkout needs it);
a stale or missing library is rebuilt at first use.  :func:`build_all` starts one ``nvcc`` per source,
all together, and waits for them.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the checkout when the package runs from one (``<checkout>/src/repro_torch``)
_CHECKOUT = Path(__file__).resolve().parents[3]

_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
#: per-source extra flags: the float stencils (fused_stream's producer,
#: the per-op stencil) must round every product and sum like the plain
#: version, so no FMA contraction there
_EXTRA = {"fused_stream": ["-fmad=false"], "stencil": ["-fmad=false"]}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of repro_torch cannot be built")


def build_dir() -> Path:
    """Where the libraries are cached: ``REPRO_TORCH_BUILD_DIR`` if set,
    else ``<checkout>/build/repro_torch``.  Outside a checkout (an installed
    copy) there is no such place, and it raises rather than writing beside
    the interpreter's libraries."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    if CSRC.parent.parent.name != "src" or \
            not (_CHECKOUT / "pyproject.toml").is_file():
        raise RuntimeError(
            f"repro_torch at {CSRC.parent} is not in a source checkout: set "
            f"REPRO_TORCH_BUILD_DIR to the directory its kernels build into")
    return _CHECKOUT / "build" / "repro_torch"


def _flags(name: str) -> list[str]:
    return _COMMON + _EXTRA.get(name, [])


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` into a temp file beside its target;
    returns (process, temp path, target) or None when already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> list[str]:
    """Build every kernel source in parallel (one nvcc each); returns the
    names.  Raises on the first failure, after every nvcc has ended."""
    names = sources()
    started = {n: _start(n) for n in names}
    errors = []
    for n in names:
        try:
            _finish(n, started[n])
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def launch(name: str, entry: str, argtypes: list, device, *args) -> None:
    """Call the C entry point ``entry`` of ``csrc/<name>.cu`` with ``args``
    and ``device``'s current CUDA stream (every entry point takes the
    stream last and returns a ``cudaError_t``).  The ``argtypes`` of the
    other arguments are declared at first use, so ctypes never cuts a
    pointer to 32 bits; a nonzero return raises."""
    import torch

    lib = load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    check(lib, rc, f"{entry}")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point
    (every library exports ``repro_error_string`` for the message)."""
    if rc != 0:
        fn = lib.repro_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({fn(rc).decode()})")
