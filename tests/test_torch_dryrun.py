"""The port's dry run (``repro_torch.launch.specs``, ``launch/dryrun.py``
and the serving rules of ``distributed/sharding.py``) against JAX's, on
the CPU.

One JAX subprocess imports ``repro.launch.dryrun`` (which sets 512 host
devices at its import) and records, for every runnable cell on both
production meshes, every input leaf's shape, dtype, spec and
``NamedSharding.shard_shape`` as its ``build_cell`` places it (params by
``param_specs``, ZeRO-3 for training and whole on the data axes for
serving; the optimizer state as the params, its step replicated; the
batch by ``_batch_spec``; the caches and logits by ``_cache_spec``).  The
port's side runs in process: its specs on ``meta``, its rules on a
mesh-like object, and its ``build_cell`` as rank 0 of torch's fake
process group of 256 / 512 ranks, whose argument blocks are what
``run_cell`` reports as ``argument_gb``.

Held: ``runnable_cells()`` and every cell's input specs (shape and dtype,
float8 included) equal JAX's; the cache, logits and batch specs equal
JAX's on both meshes; every argument block of rank 0 has JAX's
``shard_shape`` and dtype, so the per-rank argument bytes are JAX's,
except where JAX's right-aligned rule puts the data axes on a dim other
than the batch (the sLSTM's ``h``: ("b", "width") on (B, H, dh)): a data
rank holds its rows instead (``test_torch_tp_serve.py``); granite-8b's
``decode_32k`` cache on (16, 16) is 2,415,919,104 bytes a rank.
``run_cell`` runs granite-8b ``decode_32k`` (split-KV: 8 KV heads over
16) and xlstm-1.3b ``long_500k`` without the probe and records the
model axis's collectives by kind, and the CLI writes a record.
"""

from __future__ import annotations

import json
import math
import pickle
import subprocess
import sys

import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

torch.set_num_threads(2)

from test_torch_collectives import ROOT, _env, start_script, wait_all  # noqa: E402

MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}

JAX_SCRIPT = r'''
import pickle
import sys

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.launch import dryrun as dr
from repro.launch import specs as speclib
from repro.launch.mesh import make_production_mesh
from repro.configs import SHAPES, get_config, runnable_cells
from repro.distributed import sharding as sh

out = sys.argv[1]
res = {"cells": runnable_cells()}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    kind_name = "multi" if multi else "single"
    for arch, shape_name in runnable_cells():
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        ctx = sh.make_ctx(mesh, fsdp=shape.kind == "train")
        specs = speclib.input_specs(cfg, shape_name)
        specs_of = {"params": sh.param_specs(specs["params"], ctx)}
        leaves = {}

        def put(prefix, tree, spec_tree):
            flat = jax.tree_util.tree_flatten_with_path(tree)[0]
            sp = jax.tree_util.tree_leaves(
                spec_tree, is_leaf=lambda s: isinstance(s, P))
            for (path, x), spec in zip(flat, sp):
                leaves[prefix + jax.tree_util.keystr(path)] = (
                    tuple(x.shape), str(np.dtype(x.dtype)), tuple(spec),
                    tuple(NamedSharding(mesh, spec).shard_shape(x.shape)))

        def specs_by(tree, fn):
            def walk(node, name=""):
                if isinstance(node, dict):
                    return {k: walk(v, k) for k, v in node.items()}
                if isinstance(node, (list, tuple)):
                    return type(node)(walk(v, name) for v in node)
                return fn(name, tuple(node.shape), ctx)
            return walk(tree)

        put("['params']", specs["params"], specs_of["params"])
        if shape.kind == "train":
            for m in ("mu", "nu"):
                put(f"['opt_state']['{m}']", specs["opt_state"][m],
                    specs_of["params"])
            put("['opt_state']['step']", specs["opt_state"]["step"], P())
        if shape.kind in ("train", "prefill"):
            put("['batch']", specs["batch"],
                specs_by(specs["batch"], dr._batch_spec))
        else:
            put("['caches']", specs["caches"],
                specs_by(specs["caches"], dr._cache_spec))
            put("['tokens_t']", specs["tokens_t"],
                dr._batch_spec("tokens", specs["tokens_t"].shape, ctx))
            put("['pos']", specs["pos"], P())
        if shape.kind != "train":
            b = shape.global_batch
            lg = (b, 1, -(-cfg.vocab_size // 512) * 512)
            leaves["logits"] = (lg, "", tuple(dr._cache_spec("logits", lg,
                                                              ctx)), ())
        res[(kind_name, arch, shape_name)] = leaves
with open(f"{out}/jax.pkl", "wb") as f:
    pickle.dump(res, f)
'''


ITEMSIZE = {"float32": 4, "bfloat16": 2, "int32": 4, "float8_e4m3fn": 1}


class _MeshLike:
    """Just enough of a mesh for the rules."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = start_script(JAX_SCRIPT, tmp / "jax")
    wait_all(procs)
    with open(tmp / "jax" / "jax.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port_blocks():
    """Rank 0's argument blocks of every cell, as ``build_cell`` makes
    them under a fake group of 256 / 512 ranks: {(mesh, arch, shape):
    {path: (shape, dtype)}}."""
    import torch.distributed as dist

    from repro_torch.configs import runnable_cells
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train._tree import leaves_with_path

    out = {}
    for kind in MESHES:
        dryrun._group(kind == "multi")
        try:
            mesh = make_production_mesh(multi_pod=kind == "multi",
                                        device="cpu")
            for arch, shape in runnable_cells():
                step, args, _ = dryrun.build_cell(arch, shape, mesh)
                names = {2: ("params", "batch"),
                         3: ("params", "opt_state", "batch"),
                         4: ("params", "tokens_t", "caches", "pos")}
                tree = dict(zip(names[len(args)], args))
                out[kind, arch, shape] = {
                    p: (tuple(sh.local(x).shape), _dtype(x))
                    for p, x in leaves_with_path(tree)}
                out[kind, arch, shape, "bytes"] = dryrun._bytes(args)
        finally:
            sh.set_sharding_ctx(sh.ShardingCtx())
            dist.destroy_process_group()
    return out


def _cells():
    from repro_torch.configs import runnable_cells

    return runnable_cells()


def test_runnable_cells_equal_jax(jax_side):
    from repro_torch.configs import SUBQUADRATIC, runnable_cells

    assert runnable_cells() == jax_side["cells"]
    assert SUBQUADRATIC == {"recurrentgemma-9b", "xlstm-1.3b"}


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_equal_jax(jax_side, arch, shape):
    """``specs.input_specs`` of the cell, leaf by leaf: shape and dtype
    (float8 where ``kv_dtype_for`` says) equal JAX's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.train._tree import leaves_with_path

    got = {p: (tuple(x.shape), _dtype(x)) for p, x in
           leaves_with_path(specs.input_specs(get_config(arch), shape))}
    want = {p: v[:2] for p, v in jax_side["single", arch, shape].items()
            if p != "logits"}
    assert got == want


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch,shape", _cells())
def test_serving_and_batch_rules_equal_jax(jax_side, kind, arch, shape):
    """``sharding.cache_spec`` / ``batch_spec`` (``dryrun._cache_spec`` /
    ``_batch_spec``) of every cache, batch and token leaf, and the logits',
    equal JAX's on the mesh."""
    from repro_torch.configs import SHAPES
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun

    names, dims = MESHES[kind]
    ctx = sh.make_ctx(_MeshLike(names, dims),
                      fsdp=SHAPES[shape].kind == "train")
    checked = 0
    for path, (whole, _, spec, _) in jax_side[kind, arch, shape].items():
        leaf = path.rpartition("['")[2].rstrip("']")
        if path == "logits":
            got = dryrun._cache_spec("logits", whole, ctx)
        elif path.startswith("['caches']"):
            got = dryrun._cache_spec(leaf, whole, ctx)
        elif path.startswith(("['batch']", "['tokens_t']")):
            got = dryrun._batch_spec(
                "tokens" if leaf == "tokens_t" else leaf, whole, ctx)
        else:
            continue
        assert tuple(got) == spec, (path, tuple(got), spec)
        checked += 1
    assert checked


def _batch_dim(path: str, ndim: int):
    if path.startswith(("['batch']['pos_ids']")):
        return 1
    if path.startswith(("['batch']", "['tokens_t']")):
        return 0
    if path.startswith("['caches']") and not path.endswith("['len']"):
        return 1 if path.startswith("['caches']['blocks']") else 0
    return None


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch,shape", _cells())
def test_argument_blocks_are_jax_shard_shapes(jax_side, port_blocks, kind,
                                              arch, shape):
    """Rank 0's block of every argument of ``build_cell`` has JAX's
    ``shard_shape`` and dtype (module docstring for the sLSTM's ``h``), so
    the per-rank argument bytes ``run_cell`` reports are JAX's."""
    names, dims = MESHES[kind]
    dp = math.prod(dims[:-1])
    want = {p: v for p, v in jax_side[kind, arch, shape].items()
            if p != "logits"}
    got = port_blocks[kind, arch, shape]
    assert got.keys() == want.keys()
    jax_bytes = 0
    for path, (whole, dt, spec, shard) in want.items():
        shape_, dtype_ = got[path]
        assert dtype_ == dt, path
        jax_bytes += math.prod(shard) * ITEMSIZE[dt]
        full = spec + (None,) * (len(whole) - len(spec))
        bd = _batch_dim(path, len(whole))
        if bd is None or whole[bd] % dp or "data" in _names(full[bd]):
            assert shape_ == shard, (path, shape_, shard)
        else:
            # JAX's rule keeps the data axes off the batch dim: the rank
            # holds its rows, and JAX's block of the dims "data" leaves
            assert "['slstm']['h']" in path, path
            assert shape_ == tuple(
                whole[bd] // dp if i == bd else w if "data" in _names(e)
                else s for i, (w, s, e) in enumerate(zip(whole, shard,
                                                           full))), \
                (path, shape_, shard)
    quirk = any("['slstm']['h']" in p for p in want)
    if not quirk:
        assert port_blocks[kind, arch, shape, "bytes"] == jax_bytes


def test_granite_decode_cache_bytes(port_blocks):
    """granite-8b decode_32k on (16, 16): the cache a rank holds is 8 rows
    x 8 KV heads x 2,048 slots x 128 x 2 (k, v) x 36 layers x 2 bytes."""
    got = port_blocks["single", "granite-8b", "decode_32k"]
    cache = sum(math.prod(s) * ITEMSIZE[d] for p, (s, d) in got.items()
                if p.startswith("['caches']") and not p.endswith("['len']"))
    assert cache == 2_415_919_104 == 8 * 8 * 2048 * 128 * 2 * 36 * 2


@pytest.fixture(scope="module")
def records():
    from repro_torch.launch import dryrun

    return {cell: dryrun.run_cell(*cell, multi_pod=False, probe=False)
            for cell in (("granite-8b", "decode_32k"),
                         ("xlstm-1.3b", "long_500k"))}


@pytest.mark.parametrize("arch,shape", [("granite-8b", "decode_32k"),
                                        ("xlstm-1.3b", "long_500k")])
def test_run_cell_records_memory_and_model_collectives(records, arch,
                                                       shape):
    rec = records[arch, shape]
    assert rec["mesh"] == "16x16" and rec["devices"] == 256
    mem = rec["memory"]
    assert mem["argument_gb"] > 0 and mem["alias_gb"] > 0
    assert mem["peak_device_gb"] >= mem["argument_gb"] + mem["temp_gb"]
    assert mem["peak_device_gb"] == pytest.approx(
        mem["argument_gb"] + mem["temp_gb"] + mem["output_gb"]
        - mem["alias_gb"])
    coll = rec["collectives"]
    model = {k: v for k, v in coll["op_counts"].items()
             if k.endswith(":model")}
    assert model.get("all-reduce:model", 0) > 0, coll
    assert coll["per_chip_gb"] > 0
    assert all(coll["by_kind_gb"][k] > 0 for k, n in model.items() if n)
    if arch == "granite-8b":
        # split-KV: the q heads gathered and the partial softmax combined
        assert model["all-gather:model"] > 0
        assert mem["argument_gb"] * 2 ** 30 > 2_415_919_104


def test_cli_writes_a_record(tmp_path):
    out = tmp_path / "rec.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-8b", "--shape", "decode_32k", "--mesh", "single",
         "--no-probe", "--out", str(out)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["arch"] == "granite-8b" and "memory" in rec
    assert json.loads(r.stdout) == rec
