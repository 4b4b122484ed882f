"""JAX's array-conversion rules (64-bit types off) for the port's CPM code.

The JAX package runs with 64-bit types disabled, so a Python ``int``
becomes ``int32``, a ``float`` becomes ``float32``, and int64/float64
NumPy inputs narrow to 32 bits.  PyTorch defaults to int64/float32 instead;
every CPM entry point converts through :func:`asarray` so that the same
operands give the same dtypes — and the same bits — in both packages.
As ``jnp.asarray`` does, a Python integer (alone or in a list) that does
not fit its integer target raises ``OverflowError``; NumPy arrays and
tensors cast (and wrap) instead.
"""

from __future__ import annotations

import numpy as np
import torch

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def _is_int(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _check_python_ints(lo: int, hi: int, dtype: torch.dtype) -> None:
    """``jnp.asarray``'s check on Python integers bound for ``dtype``."""
    if not _is_int(dtype):
        return
    info = torch.iinfo(dtype)
    for v in (lo, hi):
        if not info.min <= v <= info.max:
            raise OverflowError(f"Python integer {v} out of bounds for "
                                f"{str(dtype).removeprefix('torch.')}")


def asarray(v, dtype: torch.dtype | None = None,
            device: torch.device | str | None = None) -> torch.Tensor:
    """``jnp.asarray`` for the port: tensors keep their device; Python and
    NumPy values land on ``device`` with 32-bit default dtypes."""
    if isinstance(v, torch.Tensor):
        t = v if device is None else v.to(device)
    elif isinstance(v, bool):
        t = torch.tensor(v, dtype=torch.bool, device=device)
    elif isinstance(v, int):
        target = dtype or torch.int32
        _check_python_ints(v, v, target)
        t = torch.tensor(v, dtype=target, device=device)
    elif isinstance(v, float):
        t = torch.tensor(v, dtype=torch.float32, device=device)
    else:
        from_python = not isinstance(v, (np.ndarray, np.generic))
        try:
            a = np.asarray(v)
        except OverflowError as e:      # Python ints past 64 bits
            raise OverflowError(f"Python integer out of bounds: {e}") from e
        if from_python and a.dtype.kind in "iuO" and a.size:
            if a.dtype.kind == "O":
                raise OverflowError("Python integer out of bounds for int64")
            _check_python_ints(int(a.min()), int(a.max()),
                               dtype or torch.int32)
        t = torch.as_tensor(a, device=device)
        t = t.to(_NARROW.get(t.dtype, t.dtype))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t


def result_type(dtype: torch.dtype, v) -> torch.dtype:
    """``jnp.result_type(dtype, v)`` with 64-bit types off: a Python
    scalar is weakly typed (an ``int`` keeps an integer or float
    ``dtype`` and lifts bool to int32; a ``float`` keeps a float
    ``dtype`` and lifts the others to float32); arrays and tensors
    promote."""
    if isinstance(v, bool):
        return dtype
    if isinstance(v, int):
        return torch.int32 if dtype == torch.bool else dtype
    if isinstance(v, float):
        return dtype if dtype.is_floating_point else torch.float32
    return torch.promote_types(dtype, asarray(v).dtype)


def device_of(*vals, default: torch.device | str = "cpu") -> torch.device:
    """The device of the first tensor among ``vals`` (else ``default``)."""
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device(default)
