"""Parameters for the port: converted from the JAX pytree, or drawn anew.

``params_from_numpy`` turns the JAX package's parameter pytree, with its
leaves as NumPy arrays (``jax.tree.map(np.asarray, params)``), into the
port's parameter dict — the same nesting, names, shapes and dtypes — so
the tests run both packages on identical weights.  ``init_params`` draws
fresh parameters of the same shapes and distributions from a
``torch.Generator`` on the card (see ``repro_torch.models.lm``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from .lm import init_params

__all__ = ["params_from_numpy", "init_params"]


def params_from_numpy(tree, device=None):
    """Nested dicts / lists / tuples of NumPy arrays -> the same nesting
    of tensors on ``device`` (``cuda`` unless asked otherwise)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)
