"""JAX's array-conversion rules (64-bit types off) for the port's CPM code.

The JAX package runs with 64-bit types disabled, so a Python ``int``
becomes ``int32``, a ``float`` becomes ``float32``, and int64/float64
NumPy inputs narrow to 32 bits.  PyTorch defaults to int64/float32 instead;
every CPM entry point converts through :func:`asarray` so that the same
operands give the same dtypes — and the same bits — in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def asarray(v, dtype: torch.dtype | None = None,
            device: torch.device | str | None = None) -> torch.Tensor:
    """``jnp.asarray`` for the port: tensors keep their device; Python and
    NumPy values land on ``device`` with 32-bit default dtypes."""
    if isinstance(v, torch.Tensor):
        t = v if device is None else v.to(device)
    elif isinstance(v, bool):
        t = torch.tensor(v, dtype=torch.bool, device=device)
    elif isinstance(v, int):
        t = torch.tensor(v, dtype=torch.int32, device=device)
    elif isinstance(v, float):
        t = torch.tensor(v, dtype=torch.float32, device=device)
    else:
        a = np.asarray(v)
        t = torch.as_tensor(a, device=device)
        t = t.to(_NARROW.get(t.dtype, t.dtype))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t


def device_of(*vals, default: torch.device | str = "cpu") -> torch.device:
    """The device of the first tensor among ``vals`` (else ``default``)."""
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device(default)
