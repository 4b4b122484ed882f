"""Atomic checkpoints in the JAX package's layout (a port of
``repro.train.checkpoint``).

``<dir>/step_<N>/`` holds one ``.npy`` a leaf, named from the leaf's
``jax.tree_util.keystr`` path, and ``manifest.json`` with the leaves in
``jax.tree``'s order (dict keys sorted), so a checkpoint written by
either package restores in the other.  Commit protocol: write into
``step_<N>.tmp``, then ``os.replace`` it to ``step_<N>``; a crash
mid-write never corrupts the latest complete checkpoint.  Restore puts
the leaves on the device asked for (default: the ``like`` leaves'); the
JAX version's re-sharding on restore waits for distribution (ROADMAP
Queue 1 item 5).

With ``async_=True`` a background thread writes the files, so the train
loop blocks only on the copy of the state to the host.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from ._tree import leaves_with_path, map_with_path

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _leaf_name(path: str) -> str:
    return _SAFE.sub("~", path)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         async_: bool = False) -> threading.Thread | None:
    """Checkpoint ``tree`` (+ JSON-serializable ``extra``) at ``step``."""
    # a copy even of a CPU leaf: the optimizer updates params in place
    host = [(_leaf_name(p), x.detach().to("cpu", copy=True).numpy())
            for p, x in leaves_with_path(tree)]

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


def restore(ckpt_dir: str, step: int, like, device=None) -> tuple:
    """Restore a tree shaped ``like`` (tensors, or anything with ``shape``
    and a torch ``dtype``: a ``meta``-device tree builds nothing); each
    leaf goes to ``device``, default that ``like`` leaf's.  Returns
    ``(tree, extra)``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(path, leaf):
        arr = np.load(os.path.join(d, _leaf_name(path) + ".npy"))
        assert arr.shape == tuple(leaf.shape), \
            f"{path}: {arr.shape} != {tuple(leaf.shape)}"
        dev = device if device is not None else leaf.device
        return torch.from_numpy(arr).to(dev, leaf.dtype)

    return map_with_path(load, like), manifest["extra"]


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted([d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                    and not d.endswith(".tmp")])
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
