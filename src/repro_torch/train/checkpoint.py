"""Atomic checkpoints in the JAX package's layout (a port of
``repro.train.checkpoint``).

``<dir>/step_<N>/`` holds one ``.npy`` a leaf, named from the leaf's
``jax.tree_util.keystr`` path, and ``manifest.json`` with the leaves in
``jax.tree``'s order (dict keys sorted), so a checkpoint written by
either package restores in the other.  Commit protocol: write into
``step_<N>.tmp``, then ``os.replace`` it to ``step_<N>``; a crash
mid-write never corrupts the latest complete checkpoint.

Checkpoints hold full arrays whatever the mesh, so a restore onto any
("data", "model") mesh re-shards them (JAX's elastic restore).  Under a
process group every rank calls :func:`save`: a ``DTensor`` leaf is
all-gathered whole over the data axes and the model axis, one leaf at a
time, rank 0 copies it to the host and only rank 0 writes.
:func:`restore` with ``shardings`` reads each file memory-mapped and
copies only this rank's block to its device, so no card ever holds the
whole state.

With ``async_=True`` a background thread writes the files, so the train
loop blocks only on the copy of the state to the host; every collective
runs before the thread starts (one inside it would deadlock).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
from ._tree import leaves_with_path, map_with_path

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _leaf_name(path: str) -> str:
    return _SAFE.sub("~", path)


def writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of the running
    group, or a process outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         async_: bool = False) -> threading.Thread | None:
    """Checkpoint ``tree`` (+ JSON-serializable ``extra``) at ``step``.
    Every rank of a group calls it (the gathers of ``DTensor`` leaves are
    collective); the writer's thread, or ``None``, comes back."""
    host = []
    for p, x in leaves_with_path(tree):
        full = sharding.full_tensor(x) if sharding.is_distributed(x) else x
        if writes():
            # a copy even of a CPU leaf: the optimizer updates params in
            # place
            host.append((_leaf_name(p),
                         full.detach().to("cpu", copy=True).numpy()))
        del full
    if not writes():
        return None

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        for name, arr in host:
            np.save(os.path.join(tmp, name + ".npy"), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": [n for n, _ in host],
                       "extra": extra or {}}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, device=None,
            shardings=None) -> tuple:
    """Restore a tree shaped ``like`` (tensors, or anything with ``shape``
    and a torch ``dtype``: a ``meta``-device tree builds nothing); each
    leaf goes to ``device``, default that ``like`` leaf's.  ``shardings``
    (a tree like ``like`` of ``sharding.NamedSharding``, or ``None`` for a
    leaf kept whole) makes each leaf a ``DTensor`` holding only this
    rank's block, read from the memory-mapped file.  Returns ``(tree,
    extra)``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    where = {} if shardings is None else dict(leaves_with_path(shardings))

    def load(path, leaf):
        file = os.path.join(d, _leaf_name(path) + ".npy")
        dev = device if device is not None else leaf.device
        how = where.get(path)
        arr = np.load(file, mmap_mode="r" if how is not None else None)
        assert arr.shape == tuple(leaf.shape), \
            f"{path}: {arr.shape} != {tuple(leaf.shape)}"
        if how is not None:
            return sharding.shard_from_full(arr, how, dev, leaf.dtype)
        return torch.from_numpy(arr).to(dev, leaf.dtype)

    return map_with_path(load, like), manifest["extra"]


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Remove all but the ``keep`` newest checkpoints (the writer only)."""
    if not writes() or not os.path.isdir(ckpt_dir):
        return
    steps = sorted([d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                    and not d.endswith(".tmp")])
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
