"""Mesh construction on ``torch.distributed`` (a port of
``repro.launch.mesh``).

JAX runs one controller over a ``Mesh`` of devices; the port runs one
rank a process, and a mesh axis is the dimension of the same name of a
``DeviceMesh``, with a process group under it.  Functions, not module
constants, so that importing touches no process group:

  * :func:`make_production_mesh` — one pod, (16, 16) = ("data", "model"),
    or two, (2, 16, 16) = ("pod", "data", "model"): 256 or 512 ranks;
  * :func:`make_host_mesh` — (world // model, model) = ("data", "model")
    over the ranks of the running group, as JAX's is over the devices
    that exist.

Each axis of a ``DeviceMesh`` has its process group (``get_group``): on
(d, m), rank ``i`` is at (``i // m``, ``i % m``), its "model" group the
``m`` ranks of its row and its "data" group the ``d`` of its column, on
gloo and NCCL alike.

Where no default process group is running, :func:`ensure_group` starts
one: from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) when ``RANK`` is set, otherwise as a
group of one, this process, over a ``FileStore`` in a temporary
directory.  It never picks a TCP port.  ``device="cuda"`` (the default)
runs NCCL, a card a rank (``LOCAL_RANK``); ``device="cpu"`` runs gloo.
CUDA without a card raises: nothing falls back to gloo or the CPU.
``init_device_mesh`` checks that the world size equals the mesh's size,
so a production mesh needs its 256 or 512 ranks.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device

#: the process-group backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def ensure_group(device="cuda") -> str:
    """Start the default process group for ``device`` unless one is
    running (see the module docstring); returns the mesh's device type.
    Raises before starting anything when CUDA is asked for without a
    card."""
    kind = resolve_device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}; "
                         f"have {sorted(BACKENDS)}")
    if dist.is_initialized():
        return kind
    dev_id = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
              if kind == "cuda" else None)
    if "RANK" in os.environ:
        dist.init_process_group(BACKENDS[kind], init_method="env://",
                                device_id=dev_id)
    else:
        root = tempfile.mkdtemp(prefix="repro_torch_group_")
        atexit.register(shutil.rmtree, root, True)
        dist.init_process_group(
            BACKENDS[kind], store=dist.FileStore(os.path.join(root, "store"),
                                                 1),
            rank=0, world_size=1, device_id=dev_id)
    return kind


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh: 256 ranks as (16, 16) = ("data", "model"),
    or 512 as (2, 16, 16) = ("pod", "data", "model") — the "pod" axis is
    pure data parallelism across the slower links between pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(ensure_group(device), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device="cuda"):
    """A small ("data", "model") mesh over the ranks of the running group
    (tests, one card, CPU runs)."""
    kind = ensure_group(device)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not divide into model axes of "
                         f"{model}")
    return init_device_mesh(kind, (n // model, model),
                            mesh_dim_names=("data", "model"))
