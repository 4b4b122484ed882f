"""The port's CPM collectives (``repro_torch.cpm.collectives``) against
JAX's ``shard_map`` runs of the same functions (``repro.cpm.collectives``).

One gloo group a world size (2, 3, 4 and 8 ranks; the 8-rank group also
runs the (2, 4) ("pod", "data") mesh), each rank a process that meets the
others over a ``FileStore`` under ``tmp_path`` (no TCP port), computes
every case on its own shard of the same seeded global input and writes
its outputs as ``.npz``; one JAX subprocess on 8 host devices writes
JAX's.  Every group and the JAX process start together and are waited on
with one deadline; on a failure or at the deadline every process still
running is killed and the test fails with their logs.  Parametrised tests
then compare the files case by case.

Tolerances: integers and bools exact; floats bit for bit for the moves,
``ring_allreduce``, ``tree_allreduce`` and the limits; otherwise within
1e-6 of the sum of the magnitudes that meet in each element (JAX's run of
the same op on ``|x|``): XLA's ``psum`` and ``jnp.sum`` add in orders of
their own.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

#: seconds every process of a module may take in all
DEADLINE = 240.0


# ---------------------------------------------------------------------------
# processes: ranks over a FileStore, and the JAX reference
# ---------------------------------------------------------------------------

def _env() -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(SRC), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return env


def _start(argv, log: Path) -> tuple:
    with open(log, "w") as f:
        proc = subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT,
                                env=_env(), cwd=ROOT)
    return proc, log


def start_ranks(script: str, world: int, workdir: Path, *args) -> list:
    """``world`` processes running ``script`` with argv (rank, world,
    workdir, *args); each meets the others over ``workdir/store``."""
    workdir.mkdir(parents=True)
    return [_start([sys.executable, "-c", script, str(r), str(world),
                    str(workdir), *args], workdir / f"rank{r}.log")
            for r in range(world)]


def start_script(script: str, workdir: Path, *args) -> list:
    """One process running ``script`` with argv (workdir, *args)."""
    workdir.mkdir(parents=True)
    return [_start([sys.executable, "-c", script, str(workdir), *args],
                   workdir / "run.log")]


def wait_all(procs: list, deadline_s: float = DEADLINE) -> None:
    """Wait for every ``(process, log)``; if one fails or the deadline
    passes, kill every process still running and fail with the logs."""
    end = time.monotonic() + deadline_s
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [log for (p, log), c in zip(procs, codes) if c]
            late = time.monotonic() > end
            if bad or late:
                what = bad or [log for (p, log), c in zip(procs, codes)
                               if c is None]
                pytest.fail(("failed" if bad else
                             f"still running after {deadline_s:.0f} s")
                            + ":\n" + "\n".join(
                                f"--- {log}\n{log.read_text()[-3000:]}"
                                for log in what))
            if all(c == 0 for c in codes):
                return
            time.sleep(0.05)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def load(path: Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------------------
# the cases, one source for both packages
# ---------------------------------------------------------------------------

#: mesh tag -> (shape, axis names, the axes the rows shard over, the axis
#: the collectives run on, the outer axis, grad_sync's mesh axes)
MESHES = {
    "n2": ((2,), ("data",), ("data",), "data", None, ("data",)),
    "n3": ((3,), ("data",), ("data",), "data", None, ("data",)),
    "n4": ((4,), ("data",), ("data",), "data", None, ("data",)),
    "n8": ((8,), ("data",), ("data",), "data", None, ("data",)),
    "pd": ((2, 4), ("pod", "data"), ("pod", "data"), "data", "pod",
           ("pod", "data")),
}
WORLD_OF = {"n2": 2, "n3": 3, "n4": 4, "n8": 8, "pd": 8}

#: shared by the rank script and the JAX script: ``C`` is the package's
#: collectives module, ``MAX`` / ``MIN`` its maximum / minimum, ``OUTER``
#: and ``AXES`` the mesh's outer axis and grad_sync axes
CASES = r'''
import numpy as np

OPS = {
    "shift1": lambda v, a: C.ring_shift(v, a, 1),
    "shift3": lambda v, a: C.ring_shift(v, a, 3),
    "allgather0": lambda v, a: C.ring_allgather(v, a, 0),
    "allgather1": lambda v, a: C.ring_allgather(v, a, 1),
    "reduce_scatter0": lambda v, a: C.ring_reduce_scatter(v, a, 0),
    "reduce_scatter1": lambda v, a: C.ring_reduce_scatter(v, a, 1),
    "ring_allreduce": lambda v, a: C.ring_allreduce(v, a),
    "hier_two_phase": lambda v, a: C.hierarchical_psum(v, a, OUTER,
                                                       "two_phase"),
    "hier_ring": lambda v, a: C.hierarchical_psum(v, a, OUTER, "ring"),
    "hier_xla": lambda v, a: C.hierarchical_psum(v, a, OUTER, "xla"),
    "tree_add": lambda v, a: C.tree_allreduce(v, a),
    "tree_max": lambda v, a: C.tree_allreduce(v, a, MAX),
    "tree_min": lambda v, a: C.tree_allreduce(v, a, MIN),
    "grad_sync_two_phase": lambda v, a: C.grad_sync(
        {"a": v, "b": [v[:1], v[:, 0]]}, AXES, "two_phase"),
    "grad_sync_ring": lambda v, a: C.grad_sync(
        {"a": v, "b": [v[:1], v[:, 0]]}, AXES, "ring"),
    "grad_sync_xla": lambda v, a: C.grad_sync(
        {"a": v, "b": [v[:1], v[:, 0]]}, AXES, "xla"),
    "section_sum": lambda v, a: C.distributed_section_sum(v, a),
    "section_sum_ring": lambda v, a: C.distributed_section_sum(v, a, "ring"),
    "section_max": lambda v, a: C.distributed_section_limit(v, a, "max"),
    "section_min": lambda v, a: C.distributed_section_limit(v, a, "min"),
    "super_sum": lambda v, a: C.distributed_super_sum(v, a),
    "super_max": lambda v, a: C.distributed_super_limit(v, a, "max"),
    "super_min": lambda v, a: C.distributed_super_limit(v, a, "min"),
}
MOVES = ("shift1", "shift3", "allgather0", "allgather1")
TREES = ("tree_add", "tree_max", "tree_min")


def dtypes_of(op):
    return ("i32", "f32", "b") if op in MOVES else ("i32", "f32")


def inputs(tag, n_all, m):
    """Seeded global inputs: ``n_all`` shards of (m, 2m) rows stacked on
    dim 0; int32 near +-2**30, so that sums over 4+ ranks wrap."""
    rng = np.random.default_rng(sum(map(ord, tag)))
    shape = (n_all * m, 2 * m)
    return {"i32": rng.integers(-2 ** 30, 2 ** 30, shape).astype(np.int32),
            "f32": rng.standard_normal(shape).astype(np.float32),
            "b": rng.random(shape) < 0.5}


#: tests/test_collectives.py's inputs: (mesh, op) -> the global input
LITERALS = {
    ("n4", "ring_allreduce"): np.arange(16, dtype=np.float32).reshape(4, 4),
    ("n4", "tree_add"): np.arange(16, dtype=np.float32).reshape(4, 4),
    ("n4", "section_sum"): np.arange(64, dtype=np.float32),
    ("n4", "shift1"): np.arange(8, dtype=np.float32),
    ("pd", "hier_two_phase"): np.arange(32, dtype=np.float32).reshape(8, 4),
    ("pd", "hier_ring"): np.arange(32, dtype=np.float32).reshape(8, 4),
    ("pd", "grad_sync_two_phase"): np.ones((8, 2), np.float32),
}


def flat(out, prefix, into):
    """Outputs (a tensor or a dict / list of them) by key."""
    if isinstance(out, dict):
        for k in sorted(out):
            flat(out[k], f"{prefix}|{k}", into)
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            flat(v, f"{prefix}|{i}", into)
    else:
        into[prefix] = out
    return into
'''

RANK_SCRIPT = CASES + r'''
import datetime
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.cpm import collectives as C, semantics
from repro_torch.distributed import sharding as sh

MAX, MIN = semantics.maximum, semantics.minimum
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
MESHES = eval(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out}/store",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
res, mutated = {}, []
for tag, (shape, names, _, a, OUTER, AXES) in MESHES.items():
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    m = mesh.size(names.index(a))
    glob = inputs(tag, world, m)
    with sh.use_sharding(sh.make_ctx(mesh)):
        for op, fn in OPS.items():
            if op in TREES and m & (m - 1):
                try:
                    fn(torch.zeros(2), a)
                except ValueError:
                    res[f"{tag}|{op}|raised"] = np.asarray(True)
                continue
            cases = [(dt, glob[dt]) for dt in dtypes_of(op)]
            if (tag, op) in LITERALS:
                cases.append(("lit", LITERALS[(tag, op)]))
            for dt, g in cases:
                k = g.shape[0] // world
                v = torch.from_numpy(g[rank * k:(rank + 1) * k].copy())
                before = v.clone()
                got = fn(v, a)
                if not torch.equal(v, before):
                    mutated.append(f"{tag}|{op}|{dt}")
                for key, t in flat(got, f"{tag}|{op}|{dt}", {}).items():
                    res[key] = t.numpy()
res["mutated"] = np.asarray(mutated, dtype=str)
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
'''

JAX_SCRIPT = CASES + r'''
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from repro.cpm import collectives as C

MAX, MIN = jnp.maximum, jnp.minimum
out = sys.argv[1]
MESHES = eval(sys.argv[2])
res = {}
for tag, (shape, names, rows, a, OUTER, AXES) in MESHES.items():
    n_all = int(np.prod(shape))
    mesh = Mesh(np.asarray(jax.devices()[:n_all]).reshape(shape), names)
    m = shape[names.index(a)]
    glob = inputs(tag, n_all, m)
    spec = P(rows)
    tree = {}
    for op, fn in OPS.items():
        if op in TREES and m & (m - 1):
            try:
                shard_map(lambda v: fn(v, a)[None], mesh=mesh,
                          in_specs=spec, out_specs=spec)(
                    jnp.zeros((n_all * 2,)))
            except AssertionError:
                res[f"{tag}|{op}|raised"] = np.asarray(True)
            continue
        tree[op] = {dt: glob[dt] for dt in dtypes_of(op)}
        if op not in MOVES:             # the scale of a float sum's error
            tree[op]["f32abs"] = np.abs(glob["f32"])
        if (tag, op) in LITERALS:
            tree[op]["lit"] = LITERALS[(tag, op)]

    def run(t):
        return jax.tree.map(lambda x: x[None], {
            op: {dt: OPS[op](v, a) for dt, v in vs.items()}
            for op, vs in t.items()})

    got = jax.jit(shard_map(run, mesh=mesh, in_specs=spec, out_specs=spec,
                            check_rep=False))(tree)
    for op, vs in tree.items():
        for dt in vs:
            for key, t in flat(got[op][dt], f"{tag}|{op}|{dt}", {}).items():
                res[key] = np.asarray(t)
np.savez(f"{out}/jax.npz", **res)
'''


def _cases() -> dict:
    scope: dict = {}
    exec(CASES, scope)
    return scope


_SCOPE = _cases()
OPS, TREES = _SCOPE["OPS"], _SCOPE["TREES"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's outputs by (world, rank), and JAX's under "jax"."""
    tmp = tmp_path_factory.mktemp("collectives")
    by_world: dict = {}
    for tag, w in WORLD_OF.items():
        by_world.setdefault(w, {})[tag] = MESHES[tag]
    procs = start_script(JAX_SCRIPT, tmp / "jax", repr(MESHES))
    for w, meshes in by_world.items():
        procs += start_ranks(RANK_SCRIPT, w, tmp / f"w{w}", repr(meshes))
    wait_all(procs)
    out = {"jax": load(tmp / "jax" / "jax.npz")}
    for w in by_world:
        for r in range(w):
            out[(w, r)] = load(tmp / f"w{w}" / f"rank{r}.npz")
    return out


def _case_ids() -> list:
    ids = []
    for tag, (shape, names, _, a, _, _) in MESHES.items():
        m = shape[names.index(a)]
        for op in OPS:
            if op in TREES and m & (m - 1):
                ids.append((tag, op, "raised"))
                continue
            ids += [(tag, op, dt) for dt in _SCOPE["dtypes_of"](op)]
            if (tag, op) in _SCOPE["LITERALS"]:
                ids.append((tag, op, "lit"))
    return ids


#: float results that must equal JAX's bit for bit: moves, the ring and
#: the butterfly (the same additions in the same order), the limits
EXACT = {*_SCOPE["MOVES"], "ring_allreduce", *TREES, "section_max",
         "section_min", "super_max", "super_min"}


def _exact(op: str, tag: str) -> bool:
    one_axis = MESHES[tag][4] is None     # the ring modes are the ring alone
    return op in EXACT or (one_axis and op in ("hier_ring", "grad_sync_ring"))


@pytest.mark.parametrize("tag,op,dt", _case_ids(),
                         ids=["-".join(c) for c in _case_ids()])
def test_collective_equals_jax(runs, tag, op, dt):
    jx = runs["jax"]
    base = f"{tag}|{op}|{dt}"
    keys = sorted(k for k in jx if k == base or k.startswith(base + "|"))
    assert keys, f"JAX wrote no {base}"
    w = WORLD_OF[tag]
    for r in range(w):
        mine = runs[(w, r)]
        assert sorted(k for k in mine if k == base
                      or k.startswith(base + "|")) == keys
        for k in keys:
            got, want = mine[k], jx[k] if dt == "raised" else jx[k][r]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            if got.dtype.kind == "f" and not _exact(op, tag):
                # JAX's run of the op on |x|: the sum of the magnitudes
                # that meet in each element (the literals are exact)
                scale = jx[k.replace(f"|{dt}", "|f32abs", 1)][r] \
                    if dt == "f32" else 0.0
                assert np.all(np.abs(got - want) <= 1e-6 * scale), \
                    (k, r, got, want, scale)
            else:
                assert got.tobytes() == want.tobytes(), (k, r, got, want)


@pytest.mark.parametrize("world", sorted(set(WORLD_OF.values())))
def test_no_input_is_modified(runs, world):
    for r in range(world):
        assert runs[(world, r)]["mutated"].size == 0, \
            runs[(world, r)]["mutated"]


def test_unknown_mode_raises_before_any_collective():
    from repro_torch.cpm import collectives as C

    with pytest.raises(ValueError, match="unknown mode"):
        C.hierarchical_psum(torch.ones(3), "data", None, mode="butterfly")


def test_an_axis_name_needs_a_device_mesh():
    from repro_torch.cpm import collectives as C

    with pytest.raises(ValueError, match="DeviceMesh"):
        C.ring_shift(torch.ones(3), "data", 1)
