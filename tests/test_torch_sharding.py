"""The port's partition rules (``repro_torch.distributed.sharding``)
against JAX's (``repro.distributed.sharding``).

Pure rules, in process: ``param_specs`` of every config's smoke
parameters, ``compute_spec`` of each leaf and ``act_spec`` of every kind,
with and without shapes, on ``tests/test_sharding.py``'s (2, 16, 16) fake
mesh (FSDP on and off) and a one-pod (16, 16) one, under ``make_ctx`` with
``pure_dp`` and ``seq_shard``, and under each setting of the
``REPRO_SP`` / ``REPRO_MOE_CAP_DP`` / ``REPRO_EP_DATA`` switches.  Each
port spec must equal the tuple of the JAX spec's entries.

On a mesh: four gloo ranks (a ``FileStore`` under ``tmp_path``, run as
``tests/test_torch_collectives.py`` runs its groups) build the (2, 2)
("data", "model") mesh with ``make_host_mesh(model=2, device="cpu")`` and
``distribute_tensor`` each parameter with ``placements(spec, mesh)``; each
rank's local shard shape must equal the shape of the shard JAX's
``NamedSharding`` gives the device of the same index (one JAX subprocess
on 4 host devices).
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import all_configs as jax_configs  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_collectives import (ROOT, SRC, load,  # noqa: E402
                                    start_ranks, start_script, wait_all)


class FakeMesh:
    """Just enough of a mesh for spec building (tests/test_sharding.py)."""
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}
    size = 512


class FakePod:
    """One pod: (16, 16) = ("data", "model")."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}
    size = 256


def _contexts(mod) -> dict:
    fake, pod = FakeMesh(), FakePod()
    return {
        "fsdp": mod.ShardingCtx(mesh=fake, data_axes=("pod", "data"),
                                model_axis="model", fsdp=True),
        "no_fsdp": mod.ShardingCtx(mesh=fake, data_axes=("pod", "data"),
                                   model_axis="model", fsdp=False),
        "make_ctx": mod.make_ctx(fake),
        "pure_dp": mod.make_ctx(fake, pure_dp=True),
        "seq_shard": mod.make_ctx(fake, seq_shard=True),
        "one_pod": mod.make_ctx(pod),
        "one_pod_pure_dp": mod.make_ctx(pod, pure_dp=True, fsdp=False),
        "no_mesh": mod.make_ctx(None),
    }


CTX_NAMES = tuple(_contexts(sh))
KINDS = ("btd", "bthd", "bhsd", "btf", "btv", "bt", "b", "ecd", "ecf", "bte")
#: per rank of a kind's spec: shapes whose dims divide (or not) the axes
SHAPES = {n: [(d,) * n for d in (512, 48, 7)] + [(32, 40, 4096, 128)[:n]]
          for n in (1, 2, 3, 4)}
SWITCHES = [(sp, cap, ep) for sp in (0, 1) for cap in (0, 1)
            for ep in (0, 1)]


def _flat(tree, prefix="") -> dict:
    """{path: spec as a tuple} of a spec tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, (jax.sharding.PartitionSpec, sh.PartitionSpec)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{prefix}[{i}]").items()}
    return {prefix: tuple(tree)}


def _leaves(tree, prefix="") -> dict:
    """{param path as the rules see it: shape} of a param tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for t in tree for k, v in _leaves(t, prefix).items()}
    return {prefix: tuple(tree.shape)}


_PARAMS: dict = {}


def _params(name: str):
    """(port params, JAX param shapes) of ``name``'s smoke config."""
    if name not in _PARAMS:
        cfg = all_configs()[name].smoke()
        jcfg = jax_configs()[name].smoke()
        ported = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        shapes = jax.eval_shape(
            lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))
        _PARAMS[name] = (ported, shapes)
    return _PARAMS[name]


@pytest.fixture
def switches(monkeypatch, request):
    sp, cap, ep = request.param
    for mod in (sh, jsh):
        monkeypatch.setattr(mod, "_SP", bool(sp))
        monkeypatch.setattr(mod, "_MOE_CAP_DP", bool(cap))
        monkeypatch.setattr(mod, "_EP_AXIS_DATA", bool(ep))
    return request.param


@pytest.mark.parametrize("ctx", CTX_NAMES)
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_param_and_compute_specs_equal_jax(arch, ctx):
    ported, shapes = _params(arch)
    c, jc = _contexts(sh)[ctx], _contexts(jsh)[ctx]
    mine = _flat(sh.param_specs(ported, c))
    want = _flat(jsh.param_specs(shapes, jc))
    assert mine == want
    for path, shape in _leaves(ported).items():
        assert sh.compute_spec(path, shape, c) == \
            tuple(jsh.compute_spec(path, shape, jc)), path


@pytest.mark.parametrize("switches", SWITCHES, indirect=True,
                         ids=[f"sp{a}-cap{b}-ep{c}" for a, b, c in SWITCHES])
@pytest.mark.parametrize("ctx", CTX_NAMES)
def test_act_specs_equal_jax(ctx, switches):
    c, jc = _contexts(sh)[ctx], _contexts(jsh)[ctx]
    for kind in KINDS:
        want = jsh.act_spec(kind, None, jc)
        assert sh.act_spec(kind, None, c) == tuple(want), kind
        rank = len(want)
        for shape in SHAPES.get(rank, []) + [(6,) * (rank + 1)]:
            assert sh.act_spec(kind, shape, c) == \
                tuple(jsh.act_spec(kind, shape, jc)), (kind, shape)


@pytest.mark.parametrize("switches", SWITCHES, indirect=True,
                         ids=[f"sp{a}-cap{b}-ep{c}" for a, b, c in SWITCHES])
def test_expert_specs_follow_the_switches(switches):
    for ctx in ("fsdp", "pure_dp", "one_pod"):
        ported, shapes = _params("granite-moe-1b-a400m")
        assert _flat(sh.param_specs(ported, _contexts(sh)[ctx])) == \
            _flat(jsh.param_specs(shapes, _contexts(jsh)[ctx]))


def test_switches_read_from_the_environment():
    code = ("from repro_torch.distributed import sharding as s; "
            "print(s._SP, s._MOE_CAP_DP, s._EP_AXIS_DATA)")
    for env, want in (({}, "False False False"),
                      ({"REPRO_SP": "1", "REPRO_EP_DATA": "1",
                        "REPRO_MOE_CAP_DP": "0"}, "True False True")):
        e = {k: v for k, v in os.environ.items()
             if k not in ("REPRO_SP", "REPRO_MOE_CAP_DP", "REPRO_EP_DATA")}
        e.update(env, PYTHONPATH=str(SRC))
        out = subprocess.run([sys.executable, "-c", code], env=e, cwd=ROOT,
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == want


def test_spec_normalises_as_jax():
    P, JP = sh.PartitionSpec, jax.sharding.PartitionSpec
    for entries in [(), (None,), ("a",), (("a",), None), (("a", "b"), "c"),
                    ((), "a")]:
        assert P(*entries) == tuple(JP(*entries)), entries


def test_placements_shard_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh2:
        mesh_dim_names = ("data", "model")

    m = Mesh2()
    assert sh.placements(sh.P(("data", "model"), None), m) == \
        [Shard(0), Shard(0)]
    assert sh.placements(sh.P(None, "model"), m) == [Replicate(), Shard(1)]
    assert sh.placements(sh.P(), m) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.P(("model", "data")), m)
    with pytest.raises(ValueError, match="two dims"):
        sh.placements(sh.P("data", "data"), m)


# ---------------------------------------------------------------------------
# DTensor shards on a (2, 2) gloo mesh against NamedSharding's
# ---------------------------------------------------------------------------

MESH_ARCHS = ("granite-8b", "granite-moe-1b-a400m", "recurrentgemma-9b",
              "xlstm-1.3b", "seamless-m4t-large-v2")
MESH_CTXS = {"fsdp": {}, "no_fsdp": {"fsdp": False},
             "pure_dp": {"pure_dp": True}}

RANK_SCRIPT = r'''
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
leaves, ctxs = eval(sys.argv[4]), eval(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out}/store",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_host_mesh(model=2, device="cpu")
assert mesh.mesh_dim_names == ("data", "model") and mesh.shape == (2, 2)
res = {}
for cname, kw in ctxs.items():
    ctx = sh.make_ctx(mesh, **kw)
    for path, shape in leaves:
        spec = sh.param_spec(path, shape, ctx)
        t = distribute_tensor(torch.zeros(shape), mesh,
                              sh.placements(spec, mesh))
        res[f"{cname}|{path}|shape"] = np.asarray(t.to_local().shape)
        res[f"{cname}|{path}|spec"] = np.asarray(repr(tuple(spec)))
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
'''

JAX_SCRIPT = r'''
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding

from repro.distributed import sharding as sh

out = sys.argv[1]
leaves, ctxs = eval(sys.argv[2]), eval(sys.argv[3])
devs = jax.devices()[:4]
mesh = Mesh(np.asarray(devs).reshape(2, 2), ("data", "model"))
res = {}
for cname, kw in ctxs.items():
    ctx = sh.make_ctx(mesh, **kw)
    for path, shape in leaves:
        spec = sh.param_spec(path, shape, ctx)
        idx = NamedSharding(mesh, spec).devices_indices_map(shape)
        res[f"{cname}|{path}|shape"] = np.asarray(
            [[len(range(*s.indices(n))) for s, n in zip(idx[d], shape)]
             for d in devs])
        res[f"{cname}|{path}|spec"] = np.asarray(repr(tuple(spec)))
np.savez(f"{out}/jax.npz", **res)
'''


def _mesh_leaves() -> list:
    """(path, shape) of the MESH_ARCHS' smoke params, prefixed by arch,
    and a few made-up leaves whose dims divide only some axes."""
    out = []
    for arch in MESH_ARCHS:
        ported, _ = _params(arch)
        out += [(f"/{arch}{p}", s) for p, s in _leaves(ported).items()]
    return out + [("/extra/wq", (6, 8)), ("/extra/emb", (7, 4)),
                  ("/extra/wo", (3, 5, 4)), ("/extra/scale", (5,))]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    leaves = repr(_mesh_leaves())
    procs = start_script(JAX_SCRIPT, tmp / "jax", leaves, repr(MESH_CTXS))
    procs += start_ranks(RANK_SCRIPT, 4, tmp / "w4", leaves,
                         repr(MESH_CTXS))
    wait_all(procs)
    return load(tmp / "jax" / "jax.npz"), [
        load(tmp / "w4" / f"rank{r}.npz") for r in range(4)]


@pytest.mark.parametrize("ctx", MESH_CTXS)
@pytest.mark.parametrize("arch", MESH_ARCHS + ("extra",))
def test_local_shards_equal_named_sharding(mesh_runs, arch, ctx):
    jx, ranks = mesh_runs
    shapes = {p: s for p, s in _mesh_leaves() if p.startswith(f"/{arch}/")}
    assert shapes
    split = 0
    for path, shape in shapes.items():
        k = f"{ctx}|{path}"
        for r in range(4):
            assert str(ranks[r][k + "|spec"]) == str(jx[k + "|spec"]), k
            assert list(ranks[r][k + "|shape"]) == \
                list(jx[k + "|shape"][r]), (k, r)
        split += list(jx[k + "|shape"][0]) != list(shape)
    assert split, "no leaf was sharded"
