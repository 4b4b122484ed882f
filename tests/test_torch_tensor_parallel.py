"""Tensor and expert parallelism over the "model" axis in the port, layer by
layer, against JAX's layers under the same mesh, on the CPU at the smoke
configs; the shapes that reach ``ops.attention``; the production meshes of
``launch/train.py`` under torch's fake process group.

Two gloo groups, (1, 2) and (1, 4) ("data", "model") meshes
(``make_host_mesh(model=m, device="cpu")``), each rank a process meeting
the others over a ``FileStore`` under ``tmp_path``, and one JAX subprocess
on 4 host devices with Auto-typed meshes of the same shapes, started
together and waited on with one deadline
(``test_torch_collectives.wait_all``).  Both packages take the same
numpy inputs: each family's layer params (JAX's init, its biases made
nonzero), an input ``x``, a cotangent ``ct`` and, for cross attention,
the encoder output.  Each runs ``compute_view`` then the layer, in
float32, and differentiates ``sum(y * ct)`` (plus the MoE's aux loss):
the output, the input's gradient and every param's gradient, whole,
within 1e-4 of each leaf's largest value of JAX's.

The cases cover attention with GQA where the model axis does not divide
the KV heads (granite's 2 at m = 4, recurrentgemma's 1), qwen2-style
biases on M-RoPE positions, the local window, bidirectional and cross
attention; the gated and plain MLP; the MoE (expert parallelism); the
RG-LRU; the mLSTM; the sLSTM.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

torch.set_num_threads(2)

from test_torch_collectives import (load, start_ranks, start_script,  # noqa: E402
                                    wait_all)

#: shared by the test, the rank script and the JAX script
CASES = r'''
import numpy as np

MODELS = (2, 4)                      # the meshes (1, m)
B, S, SRC = 2, 32, 24
#: case -> (config, family, layer keywords)
LAYERS = {
    "attn_gqa": ("granite-8b", "attn", {}),
    "attn_bias_mrope": ("qwen2-vl-7b", "attn", {}),
    "attn_window": ("recurrentgemma-9b", "attn", {"window": 16}),
    "attn_bidirectional": ("seamless-m4t-large-v2", "attn", {"causal": False}),
    "attn_cross": ("seamless-m4t-large-v2", "cross", {}),
    "mlp_gated": ("granite-8b", "ffn", {}),
    "mlp_plain": ("seamless-m4t-large-v2", "ffn", {}),
    "moe": ("granite-moe-1b-a400m", "ffn", {}),
    "rglru": ("recurrentgemma-9b", "rglru", {}),
    "mlstm": ("xlstm-1.3b", "mlstm", {}),
    "slstm": ("xlstm-1.3b", "slstm", {}),
}


def inputs(cfg, case):
    """x, the cotangent, the encoder output and the positions (numpy)."""
    rng = np.random.default_rng(sorted(LAYERS).index(case) + 101)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, SRC, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(pos, (3, B, S)).copy()
        pos[1, :, 4:12] = 4 + np.arange(8) // 4
        pos[2, :, 4:12] = 4 + np.arange(8) % 4
    return x, ct, enc, pos


def apply(L, p, x, enc, pos, cfg, fam, kw):
    """The layer of family ``fam`` of either package's ``layers`` module:
    (y, aux)."""
    if fam == "attn":
        return L.attention_fwd(p, x, cfg, pos, **kw), 0.0
    if fam == "cross":
        return L.attention_fwd(p, x, cfg, pos, causal=False, kv_input=enc,
                               rope=False), 0.0
    if fam == "ffn":
        if cfg.ffn == "moe":
            return L.apply_moe(p, x, cfg)
        return L.apply_ffn(p, x, cfg), 0.0
    fwd = {"rglru": L.rglru_fwd, "mlstm": L.mlstm_fwd,
           "slstm": L.slstm_fwd}[fam]
    return fwd(p, x, cfg), 0.0
'''

RANK_SCRIPT = CASES + r'''
import datetime
import pickle
import sys

import torch
import torch.distributed as dist

rank, world, out, shared = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out}/store",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, layers, lm
from repro_torch.train._tree import leaves_with_path

layers.COMPUTE_DTYPE = torch.float32
mesh = make_host_mesh(model=world, device="cpu")
ctx = sh.make_ctx(mesh)
res = {"groups": repr({a: dist.get_process_group_ranks(mesh.get_group(a))
                       for a in ("data", "model")})}
with open(f"{shared}/layers.pkl", "rb") as f:
    every = pickle.load(f)

seen = []
plain_attention = ops.attention


def counting(q, k, v, **kw):
    seen.append((q.shape[1], k.shape[1]))
    return plain_attention(q, k, v, **kw)


ops.attention = counting
with sh.use_sharding(ctx):
    for case, (name, fam, kw) in LAYERS.items():
        cfg = get_config(name).smoke()
        x, ct, enc, pos = (torch.from_numpy(a) for a in inputs(cfg, case))
        x.requires_grad_(True)
        enc.requires_grad_(True)
        p = sh.distribute_params({fam: convert.params_from_numpy(
            every[case], "cpu")}, ctx)
        for _, leaf in leaves_with_path(p):
            sh.local(leaf).requires_grad_(True)
        # DTensors over the blocks, through which autograd reaches them
        q = lm.tree_map(lambda a: type(a).from_local(
            sh.local(a), a.device_mesh, a.placements, run_check=False), p)
        view = layers.compute_view(q, torch.float32,
                                   rule=layers.model_rule(cfg))[fam]
        res[f"{case}|view"] = repr({k: tuple(v.shape)
                                    for k, v in view.items()})
        del seen[:]
        y, aux = apply(layers, view, x, enc, pos, cfg, fam, kw)
        (torch.sum(y * ct) + aux).backward()
        every_rank = [None] * world
        dist.all_gather_object(every_rank, list(seen))
        res[f"{case}|heads"] = repr(every_rank)
        res[f"{case}|y"] = y.detach().numpy()
        res[f"{case}|dx"] = x.grad.numpy()
        if fam == "cross":
            res[f"{case}|denc"] = enc.grad.numpy()
        for path, leaf in leaves_with_path(p):
            g = type(leaf).from_local(sh.local(leaf).grad, leaf.device_mesh,
                                      leaf.placements, run_check=False)
            res[f"{case}|grad|{path}"] = sh.full_tensor(g).numpy()

if rank == 0:
    np.savez(f"{out}/rank0.npz", **{k: np.asarray(v)
                                   for k, v in res.items()})
dist.barrier()
dist.destroy_process_group()
'''

JAX_SCRIPT = CASES + r'''
import os
import pickle
import sys

out, shared = sys.argv[1], sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding

from repro.configs import all_configs
from repro.distributed import sharding as sh
from repro.models import layers as L

L.COMPUTE_DTYPE = jnp.float32
res = {}
with open(f"{shared}/layers.pkl", "rb") as f:
    every = pickle.load(f)
devs = np.asarray(jax.devices()[:4])
for m in MODELS:
    mesh = Mesh(devs[:m].reshape(1, m), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    ctx = sh.make_ctx(mesh)
    with sh.use_sharding(ctx):
        for case, (name, fam, kw) in LAYERS.items():
            cfg = all_configs()[name].smoke()
            x, ct, enc, pos = inputs(cfg, case)
            tree = {fam: jax.tree.map(jnp.asarray, every[case])}
            tree = jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                tree, sh.param_specs(tree, ctx))

            def obj(p, x, enc, cfg=cfg, fam=fam, kw=kw, pos=pos, ct=ct):
                v = sh.compute_view(p, jnp.float32)[fam]
                y, aux = apply(L, v, x, enc, jnp.asarray(pos), cfg, fam, kw)
                return jnp.sum(y * ct) + aux, y

            (_, y), (gp, gx, genc) = jax.jit(jax.value_and_grad(
                obj, argnums=(0, 1, 2), has_aux=True))(tree, x, enc)
            res[f"{m}|{case}|y"] = np.asarray(y)
            res[f"{m}|{case}|dx"] = np.asarray(gx)
            if fam == "cross":
                res[f"{m}|{case}|denc"] = np.asarray(genc)
            for path, g in jax.tree_util.tree_flatten_with_path(gp)[0]:
                res[f"{m}|{case}|grad|{jax.tree_util.keystr(path)}"] = \
                    np.asarray(g)
np.savez(f"{out}/jax.npz", **res)
'''


def _scope() -> dict:
    scope: dict = {}
    exec(CASES, scope)
    return scope


_S = _scope()
LAYERS, MODELS = _S["LAYERS"], _S["MODELS"]


def _write_inputs(shared: Path) -> None:
    """Each case's layer params from JAX's init (pickled numpy trees read
    by both packages), biases drawn nonzero so their gradients mean
    something."""
    import jax

    from repro.configs import all_configs
    from repro.models import layers as jl

    inits = {"attn": jl.init_attention, "cross": jl.init_attention,
             "rglru": jl.init_rglru, "mlstm": jl.init_mlstm,
             "slstm": jl.init_slstm}
    every = {}
    for i, (case, (name, fam, _)) in enumerate(LAYERS.items()):
        cfg = all_configs()[name].smoke()
        init = inits.get(fam) or (jl.init_moe if cfg.ffn == "moe"
                                  else jl.init_ffn)
        p = jax.tree.map(np.asarray, init(cfg, jax.random.PRNGKey(i)))
        rng = np.random.default_rng(i)
        every[case] = {k: (rng.standard_normal(v.shape).astype(np.float32)
                           * 0.1 if k in ("bq", "bk", "bv") else v)
                       for k, v in p.items()}
    with open(shared / "layers.pkl", "wb") as f:
        pickle.dump(every, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's results by model-axis size, JAX's under "jax"."""
    tmp = tmp_path_factory.mktemp("tp_layers")
    shared = tmp / "shared"
    shared.mkdir()
    _write_inputs(shared)
    procs = start_script(JAX_SCRIPT, tmp / "jax", str(shared))
    for m in MODELS:
        procs += start_ranks(RANK_SCRIPT, m, tmp / f"m{m}", str(shared))
    wait_all(procs)
    out = {"jax": load(tmp / "jax" / "jax.npz")}
    for m in MODELS:
        out[m] = load(tmp / f"m{m}" / "rank0.npz")
    return out


def _err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _leaves(res: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "|")}


@pytest.mark.parametrize("m", MODELS)
@pytest.mark.parametrize("case", LAYERS)
def test_layer_matches_jax_under_the_same_mesh(runs, case, m):
    """The layer's output, its input's gradient (and the encoder
    output's, for cross attention) and every param's gradient, whole, on
    a (1, m) mesh against JAX's under the same Auto-typed mesh: within
    1e-4 of each one's largest value (float32)."""
    ours, jx = runs[m], runs["jax"]
    keys = ["y", "dx"] + (["denc"] if LAYERS[case][1] == "cross" else [])
    for key in keys:
        got, want = ours[f"{case}|{key}"], jx[f"{m}|{case}|{key}"]
        assert got.shape == want.shape, key
        assert _err(got, want) <= 1e-4, (key, _err(got, want))
    got = _leaves(ours, f"{case}|grad")
    want = _leaves(jx, f"{m}|{case}|grad")
    assert got.keys() == want.keys() and got
    bad = {p: _err(got[p], want[p]) for p in want
           if _err(got[p], want[p]) > 1e-4}
    assert not bad, bad


def _cfg(case):
    from repro_torch.configs import get_config

    return get_config(LAYERS[case][0]).smoke()


@pytest.mark.parametrize("m", MODELS)
@pytest.mark.parametrize("case", [c for c in LAYERS
                                  if LAYERS[c][1] in ("attn", "cross")])
def test_attention_sees_the_ranks_heads(runs, case, m):
    """``ops.attention`` gets ``H / m`` q heads on every rank, and the KV
    heads its q heads read: its block of ``KV / m`` where the model axis
    divides the KV heads, else the one KV head of its q heads' group
    (every smoke config's ``H / m`` q heads fall in one group)."""
    cfg = _cfg(case)
    heads = eval(str(runs[m][f"{case}|heads"]))
    kv = (cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else 1)
    assert heads == [[(cfg.n_heads // m, kv)]] * m


@pytest.mark.parametrize("m", MODELS)
@pytest.mark.parametrize("case", LAYERS)
def test_layers_read_their_blocks(runs, case, m):
    """What ``compute_view`` hands each layer on a rank: the column and row
    blocks, experts, channels and heads of its part (1/m of the split
    dim), the leaves it reads whole at their full shapes."""
    cfg = _cfg(case)
    fam = LAYERS[case][1]
    view = eval(str(runs[m][f"{case}|view"]))
    d, f = cfg.d_model, cfg.d_ff
    hd, kvd = cfg.n_heads * cfg.dh, cfg.n_kv_heads * cfg.dh
    kv_cols = kvd // m if cfg.n_kv_heads % m == 0 else kvd
    width = cfg.rnn_width or d
    up, h = 2 * d, cfg.n_heads
    want = {
        "attn": {"wq": (d, hd // m), "wk": (d, kv_cols),
                 "wv": (d, kv_cols), "wo": (hd // m, d)},
        "ffn": ({"router": (d, cfg.moe.n_experts),
                 "expert_gate": (cfg.moe.n_experts // m, d, f),
                 "expert_in": (cfg.moe.n_experts // m, d, f),
                 "expert_out": (cfg.moe.n_experts // m, f, d)}
                if cfg.ffn == "moe" else
                {**({"w_gate": (d, f // m)} if cfg.ffn == "swiglu" else {}),
                 "w_in": (d, f // m), "w_out": (f // m, d)}),
        "rglru": {"wx": (d, width // m), "wg": (d, width // m),
                  "wy": (width // m, d), "conv_w": (cfg.conv_width,
                                                    width // m),
                  "a_param": (width // m,),
                  "w_input_gate": (2, width // m)},
        "mlstm": {"w_up": (d, up // m), "w_up_gate": (d, up // m),
                  "wq": (h // m, up // h, up // h),
                  "wk": (h // m, up // h, up // h),
                  "wv": (h // m, up // h, up // h),
                  "w_if": (up // m, 2 * h), "w_down": (up // m, d)},
        "slstm": {"wx": (d, 4 * d // m), "rec_w": (h, d // h, 4 * d // h),
                  "w_down": (d // m, d)},
    }[fam if fam != "cross" else "attn"]
    if cfg.qkv_bias:
        want.update(bq=(hd // m,), bk=(kv_cols,), bv=(kv_cols,))
    assert view == want


@pytest.mark.parametrize("m", MODELS)
def test_mesh_groups(runs, m):
    """The (1, m) mesh's sub-groups on gloo: rank 0's "model" group is
    every rank of its row, its "data" group itself."""
    groups = eval(str(runs[m]["groups"]))
    assert groups == {"data": [0], "model": list(range(m))}


# ---------------------------------------------------------------------------
# the production meshes under torch's fake process group
# ---------------------------------------------------------------------------

PRODUCTION = {"production": (256, (16, 16)),
              "production-multi": (512, (2, 16, 16))}


def _all_names() -> list[str]:
    from repro_torch.configs import all_configs

    return sorted(all_configs())


class _MeshLike:
    """Just enough of a mesh for JAX's spec building."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    """Under a fake group of 256 / 512 ranks: the launcher's mesh, its log
    of a zero-step smoke run, and every config's local block shapes at
    full width on the ``meta`` device."""
    import logging

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import train
    from repro_torch.train._tree import leaves_with_path

    out = {}
    for kind, (world, _) in PRODUCTION.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = train.build_mesh(kind, "cpu")
            ctx = sh.make_ctx(mesh)
            shapes = {}
            for name in _all_names():
                like = train.init_state(get_config(name), "meta")
                where = train.state_shardings(like, ctx)["params"]
                shapes[name] = {
                    path: tuple(sh.local_block(x, ns.placements,
                                               mesh).shape)
                    for (path, x), (_, ns) in zip(
                        leaves_with_path(like["params"]),
                        leaves_with_path(where))}
            records = []
            handler = logging.Handler()
            handler.emit = lambda r: records.append(r.getMessage())
            logger = logging.getLogger("repro_torch.launch.train")
            level = logger.level
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
            try:
                ck = tmp_path_factory.mktemp(f"ck_{kind}")
                train.main(["--arch", "granite-8b", "--smoke", "--device",
                            "cpu", "--mesh", kind, "--steps", "0",
                            "--global-batch", str(2 * world),
                            "--ckpt-dir", str(ck)])
            finally:
                logger.removeHandler(handler)
                logger.setLevel(level)
            out[kind] = {"names": mesh.mesh_dim_names,
                         "shape": tuple(mesh.shape), "shapes": shapes,
                         "log": records}
        finally:
            dist.destroy_process_group()
    return out


@pytest.mark.parametrize("kind", PRODUCTION)
def test_launcher_builds_the_production_mesh(production, kind):
    """``build_mesh`` (what ``--mesh production`` / ``production-multi``
    run) gives ``make_production_mesh``'s (16, 16) / (2, 16, 16) over the
    group of 256 / 512 ranks, and ``main`` trains on it (zero steps of the
    smoke config: the state drawn and sharded, the loop run)."""
    world, shape = PRODUCTION[kind]
    got = production[kind]
    assert got["shape"] == shape
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    assert got["names"] == names
    log = "\n".join(got["log"])
    assert f"mesh {shape}" in log and "done: 0 steps (from 0)" in log


@pytest.mark.parametrize("kind", PRODUCTION)
@pytest.mark.parametrize("name", _all_names())
def test_production_local_shapes_are_the_jax_rules(production, kind, name):
    """Every leaf's local block on a rank of the production mesh, for the
    config at full width, equals the block JAX's partition rules give it:
    each dim over the product of the mesh axes its spec names."""
    import jax

    from repro.configs import all_configs
    from repro.distributed import sharding as jsh
    from repro.models import lm as jlm

    world, shape = PRODUCTION[kind]
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    mesh = _MeshLike(names, shape)
    ctx = jsh.make_ctx(mesh)
    cfg = all_configs()[name]
    tree = jax.eval_shape(lambda: jlm.init_params(cfg,
                                                  jax.random.PRNGKey(0)))
    specs = jsh.param_specs(tree, ctx)
    want = {}
    for (path, x), (_, spec) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda s: isinstance(s, jax.sharding.
                                                    PartitionSpec))[0]):
        full = tuple(spec) + (None,) * (len(x.shape) - len(spec))
        want[jax.tree_util.keystr(path)] = tuple(
            dim // ctx.axis_size(axis) for dim, axis in zip(x.shape, full))
    assert production[kind]["shapes"][name] == want
