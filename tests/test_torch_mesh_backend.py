"""The port's mesh backend (``repro_torch.cpm.backends.mesh``) against
JAX's reference backend and JAX's mesh backend on 2 and 4 host devices.

``tests/test_cpm_array.py``'s ``MESH_SCRIPT`` cases (rows of 13 lanes
used to 13 and 7, the batched (2, 13) row with lengths [13, 5]) in int32
and float32, plus float rows with NaN and signed zeros split across
ranks, go through ``cpm_array(..., backend="mesh")`` on gloo groups of 2
and 4 ranks: once on the default ("cpm",) mesh over every rank, once
under a sharding context over ``make_host_mesh(device="cpu")``.  The
groups and one JAX subprocess run as ``tests/test_torch_collectives.py``
runs them (a ``FileStore`` under ``tmp_path``, one deadline, every process
killed on a failure).  A ``CPMProgram`` run on ``"mesh"`` (ops outside the
mesh column fall back to the reference) is held against the same program
on the port's reference backend and on JAX's.

Tolerances: ints and flags bit for bit; float sums within 1e-6 of the
sum of the used lanes' magnitudes; limits bit for bit, NaN and the sign of
zero included (``jnp.max``'s rule, as the reference's).
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

torch.set_num_threads(2)

from test_torch_collectives import (load, start_ranks,  # noqa: E402
                                    start_script, wait_all)

WORLDS = (2, 4)

#: shared by the rank script and the JAX script
CASES = r'''
import numpy as np


def rows():
    """case -> (data, used_len)."""
    rng = np.random.default_rng(31)
    f13 = rng.standard_normal(13).astype(np.float32)
    out = {}
    for used in (13, 7):
        out[f"i13_{used}"] = (np.arange(13, dtype=np.int32), used)
        out[f"f13_{used}"] = (f13, used)
    lens = np.asarray([13, 5], np.int32)
    out["ib"] = (np.arange(26, dtype=np.int32).reshape(2, 13), lens)
    out["fb"] = (rng.standard_normal((2, 13)).astype(np.float32), lens)
    out["big"] = (rng.integers(-2 ** 30, 2 ** 30, (2, 13)).astype(np.int32),
                  lens)
    z = np.float32(0.0)
    out["nan_zeros"] = (np.asarray(
        [[1, 2, np.nan, -3, 4, 5, 6, 7], [-z] * 4 + [z] * 4,
         [z] * 4 + [-z] * 4, [-z, 5, -z, 2, z, 7, -z, 1]], np.float32),
        np.asarray([8, 8, 8, 8], np.int32))
    return out


OPS = {"section_sum": ("section_sum", ()), "super_sum": ("super_sum", ()),
       "global_max": ("global_limit", ("max",)),
       "global_min": ("global_limit", ("min",)),
       "super_max": ("super_limit", ("max",)),
       "super_min": ("super_limit", ("min",)),
       "compare_lt4": ("compare", (4, "lt"))}


def program(Prog):
    return (Prog().append("compare", datum=4, op="lt")
            .append("count", datum=4, op="ge")
            .append("insert", pos=1, values=np.asarray([7, 7], np.int32))
            .append("section_sum").append("global_limit", mode="min")
            .append("super_sum").append("truncate", new_len=6)
            .append("super_limit", mode="max")
            .append("compare", datum=np.asarray([3, 9], np.int32), op="ge")
            .append("section_sum"))


def run_cases(cpm_array, asarray, into, tag, wrap=lambda f: f):
    """Every op of OPS on every row of rows() on the mesh backend
    (``wrap``: JAX's ``jit``, one program a row)."""
    def ops(data, used):
        a = cpm_array(data, used, backend="mesh")
        return {name: getattr(a, method)(*args)
                for name, (method, args) in OPS.items()}

    f = wrap(ops)
    for case, (data, used) in rows().items():
        for name, v in f(asarray(data), asarray(used)).items():
            into[f"{tag}|{case}|{name}"] = v


def run_program(Prog, CPMArray, asarray, backend):
    data, lens = rows()["ib"]
    final, outs = program(Prog).run(
        CPMArray(asarray(data), asarray(lens), backend=backend),
        backend=backend)
    got = {f"prog|{i}": o for i, o in enumerate(outs) if o is not None}
    got["prog|data"], got["prog|used_len"] = final.data, final.used_len
    return got
'''

RANK_SCRIPT = CASES + r'''
import datetime
import sys

import torch
import torch.distributed as dist

from repro_torch.cpm import CPMArray, CPMProgram, backends as B, cpm_array
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out}/store",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
asarray = torch.as_tensor
res = {}
run_cases(cpm_array, asarray, res, "default")
bk = B.get_backend("mesh")
res["memo|default_mesh"] = (bk is B.get_backend("mesh")
                            and bk.mesh.mesh_dim_names == ("cpm",)
                            and bk.n_devices == world)
ring = B.get_backend("mesh", mode="ring")
data, _ = rows()["big"]
res["ring|big|section_sum"] = ring.section_sum(asarray(data))
mesh = make_host_mesh(device="cpu")
with sh.use_sharding(sh.make_ctx(mesh)):
    run_cases(cpm_array, asarray, res, "ctx")
    in_ctx = B.get_backend("mesh")
    res["memo|ctx_mesh"] = (in_ctx is not bk and in_ctx.axis == "data"
                            and in_ctx.mesh is mesh)
res.update(run_program(CPMProgram, CPMArray, asarray, "mesh"))
res.update({f"ref{k}": v for k, v in run_program(
    CPMProgram, CPMArray, asarray, "reference").items()})
np.savez(f"{out}/rank{rank}.npz",
         **{k: np.asarray(v) for k, v in res.items()})
dist.destroy_process_group()
'''

JAX_SCRIPT = CASES + r'''
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh

from repro.cpm import CPMArray, CPMProgram, cpm_array
from repro.distributed import sharding as sh

out = sys.argv[1]
res = {}
for case, (data, used) in rows().items():
    a = cpm_array(jnp.asarray(data), jnp.asarray(used), backend="reference")
    for name, (method, args) in OPS.items():
        res[f"ref|{case}|{name}"] = getattr(a, method)(*args)
res.update(run_program(CPMProgram, CPMArray, jnp.asarray, "reference"))
for k in (2, 4):
    # an Auto-typed mesh: jax.make_mesh's Explicit axes fail the backend's
    # compare slice on this jax (the known test_mesh_backend_two_devices)
    mesh = Mesh(np.asarray(jax.devices()[:k]), ("cpm",),
                axis_types=(AxisType.Auto,))
    with sh.use_sharding(sh.ShardingCtx(mesh=mesh, data_axes=("cpm",))):
        run_cases(cpm_array, jnp.asarray, res, f"mesh{k}", jax.jit)
np.savez(f"{out}/jax.npz", **{k: np.asarray(v) for k, v in res.items()})
'''


def _scope() -> dict:
    scope: dict = {}
    exec(CASES, scope)
    return scope


_SCOPE = _scope()
ROWS = _SCOPE["rows"]()
OPS = _SCOPE["OPS"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's outputs by (world, rank), and JAX's under "jax"."""
    tmp = tmp_path_factory.mktemp("mesh_backend")
    procs = start_script(JAX_SCRIPT, tmp / "jax")
    for w in WORLDS:
        procs += start_ranks(RANK_SCRIPT, w, tmp / f"w{w}")
    wait_all(procs)
    out = {"jax": load(tmp / "jax" / "jax.npz")}
    for w in WORLDS:
        for r in range(w):
            out[(w, r)] = load(tmp / f"w{w}" / f"rank{r}.npz")
    return out


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    """Equal values, dtype and shape; NaN equals NaN and the sign of every
    zero counts."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype.kind != "f":
        return np.array_equal(got, want)
    nan = np.isnan(got)
    return (np.array_equal(got, want, equal_nan=True)
            and np.array_equal(np.signbit(got)[~nan],
                               np.signbit(want)[~nan]))


def _abs_sums(case: str) -> np.ndarray:
    data, used = ROWS[case]
    live = np.arange(data.shape[-1]) < np.asarray(used)[..., None]
    return np.where(live, np.abs(data.astype(np.float64)), 0).sum(-1)


def _check(got, want, case, op, what):
    if want.dtype.kind == "f" and op in ("section_sum", "super_sum"):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        err = np.abs(got.astype(np.float64) - want)
        assert np.all((np.isnan(got) & np.isnan(want))
                      | (err <= 1e-6 * _abs_sums(case))), (what, got, want)
    else:
        assert _same(got, want), (what, got, want)


_CASE_IDS = [(c, o) for c in ROWS for o in OPS]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,op", _CASE_IDS,
                         ids=[f"{c}-{o}" for c, o in _CASE_IDS])
def test_mesh_ops_equal_the_jax_reference(runs, world, case, op):
    want = runs["jax"][f"ref|{case}|{op}"]
    for r in range(world):
        for tag in ("default", "ctx"):
            _check(runs[(world, r)][f"{tag}|{case}|{op}"], want, case, op,
                   (tag, r))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,op", [(c, o) for c, o in _CASE_IDS
                                     if c != "nan_zeros"],
                         ids=[f"{c}-{o}" for c, o in _CASE_IDS
                              if c != "nan_zeros"])
def test_mesh_ops_equal_the_jax_mesh_backend(runs, world, case, op):
    """JAX's mesh backend on ``world`` host devices.  The NaN and signed
    zero rows are held against the reference only: JAX's ``lax.pmax`` /
    ``pmin`` drop NaN and keep the first rank's zero (ROADMAP Queue 3)."""
    want = runs["jax"][f"mesh{world}|{case}|{op}"]
    for r in range(world):
        _check(runs[(world, r)][f"default|{case}|{op}"], want, case, op, r)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_mode_sum_wraps_as_jax(runs, world):
    """``MeshBackend(mode="ring")``: the carry marches round the ring; int32
    sums wrap as ``jnp.sum``'s.  (JAX's own ring mode fails shard_map's
    replication check on this jax: ROADMAP Queue 3.)"""
    data, _ = ROWS["big"]
    want = data.astype(np.int64).sum(-1)
    want = ((want + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    assert not np.array_equal(want, data.astype(np.int64).sum(-1))
    for r in range(world):
        assert _same(runs[(world, r)]["ring|big|section_sum"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_backend_memoized_per_context(runs, world):
    for r in range(world):
        assert runs[(world, r)]["memo|default_mesh"]
        assert runs[(world, r)]["memo|ctx_mesh"]


@pytest.mark.parametrize("world", WORLDS)
def test_program_on_mesh_equals_reference(runs, world):
    jx = runs["jax"]
    keys = sorted(k for k in jx if k.startswith("prog|"))
    assert keys
    for r in range(world):
        mine = runs[(world, r)]
        assert sorted(k for k in mine if k.startswith("prog|")) == keys
        for k in keys:
            assert _same(mine[k], mine[f"ref{k}"]), (k, r)
            assert _same(mine[k], jx[k]), (k, r)


def test_op_outside_the_mesh_column_raises_before_a_mesh_is_built():
    import torch.distributed as dist

    from repro_torch.cpm import backends as B, cpm_array

    arr = cpm_array(np.arange(8, dtype=np.int32), 6, backend="mesh",
                    device="cpu")
    for call in (lambda: arr.sort(), lambda: arr.histogram([0, 4, 8]),
                 lambda: arr.substring_match([1, 2])):
        with pytest.raises(NotImplementedError, match="'mesh' backend"):
            call()
    assert not dist.is_initialized()
    assert not any(k[0] == "mesh" for k in B._INSTANCES)
