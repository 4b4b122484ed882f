"""Training under tensor and expert parallelism in the port, on
("data", "model") meshes, against JAX's step under the same mesh, on the
CPU at the smoke configs.

Three gloo groups, one per mesh: (1, 2), (2, 2) and (1, 4)
(``make_host_mesh(model=m, device="cpu")`` over 2, 4 and 4 ranks), each
rank a process meeting the others over a ``FileStore`` under ``tmp_path``,
and one JAX subprocess a mesh, on 4 host devices with an Auto-typed mesh
of the same shape; all start together and are waited on with one deadline
(``test_torch_collectives.wait_all``).  The batches, microbatches and the
rows a rank holds are ``tests/test_torch_fsdp.py``'s, by the rank's data
coordinate: the ranks of one model group hold the same rows.

Held (float32 compute):
  * each of the six configs' loss within 1e-5 relative of JAX's under the
    same mesh and every gradient leaf within 1e-4 of its largest value:
    an ``m``-fold gradient or a missing partial sum over the model axis
    fails it;
  * three AdamW steps of granite-8b with clipping engaged (``clip_norm``
    below every step's norm): losses and global norms within 1e-5
    relative, params within ``2 lr STEPS`` (``test_torch_fsdp.py``'s
    bound), at (2, 2) and (1, 4);
  * the (2, 2) run's checkpoint restored at (1, 4), at (4, 1) and
    unsharded, bit for bit;
  * the model-axis collectives of a train step, by kind and dtype,
    against the formula in PERF.md (granite-8b, float32 and bf16, at
    (1, 2), where the axis divides the KV heads, and (1, 4), where ``wk``
    / ``wv`` are gathered).
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
from test_torch_fsdp import CASES as FSDP_CASES  # noqa: E402

#: shared by the test, the rank script and the JAX script (on top of
#: test_torch_fsdp's batches, microbatches and rows)
CASES = FSDP_CASES + r'''
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
TRAIN_MESHES = ("2x2", "1x4")
CLIP = 0.05
TP_OPT = dict(OPT, clip_norm=CLIP)
'''

RANK_SCRIPT = CASES + r'''
import datetime
import os
import pickle
import sys
import time

import torch
import torch.distributed as dist

rank, world, out, shared, tag = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out}/store",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import init_state, state_shardings
from repro_torch.models import convert, layers
from repro_torch.train import OptConfig, checkpoint, init_opt_state, \
    make_train_step
from repro_torch.train._tree import leaves_with_path
from repro_torch.train.train_step import loss_and_grads

layers.COMPUTE_DTYPE = torch.float32
dp_n, m = MESHES[tag]
mesh = make_host_mesh(model=m, device="cpu")
ctx = sh.make_ctx(mesh)
dp, dr = sh.dp_size(ctx), sh.dp_rank(ctx)
res = {}


def record(tree, prefix):
    """Every leaf whole (DTensors gathered over both axes: collective)."""
    for path, x in leaves_with_path(tree):
        v = sh.full_tensor(x) if sh.is_distributed(x) else x
        res[f"{prefix}|{path}"] = v.detach().float().numpy().copy()


def params_of(name):
    with open(f"{shared}/params_{name}.pkl", "rb") as f:
        return convert.params_from_numpy(pickle.load(f), "cpu")


def fresh(name, c):
    p = sh.distribute_params(params_of(name), c)
    return {"params": p, "opt": init_opt_state(p)}


cfg = get_config("granite-8b").smoke()
with sh.use_sharding(ctx):
    for name in GRAD_CONFIGS:
        c2 = get_config(name).smoke()
        st = fresh(name, ctx)
        loss, _, g = loss_and_grads(
            st["params"], c2, local_rows(grad_batch(c2), 2, dp, dr),
            num_microbatches=2, remat=True, loss_chunk=8)
        res[f"cfg|{name}|loss"] = float(loss)
        record(g, f"cfg|{name}|grad")

    # the model axis's collectives of one train step
    for dt in ("float32", "bfloat16"):
        layers.COMPUTE_DTYPE = getattr(torch, dt)
        st = fresh("granite-8b", ctx)
        step = make_train_step(cfg, OptConfig(**OPT), num_microbatches=2,
                               remat=True, loss_chunk=8)
        sh.reset_collective_counts()
        step(st["params"], st["opt"], local_rows(grad_batch(cfg), 2, dp, dr))
        res[f"counts|{dt}"] = repr(sh.collective_counts())
    layers.COMPUTE_DTYPE = torch.float32

    if tag in TRAIN_MESHES:
        gb = batches(cfg.vocab_size)
        step = make_train_step(cfg, OptConfig(**TP_OPT),
                               num_microbatches=MICRO, remat=True,
                               loss_chunk=CHUNK)
        st = fresh("granite-8b", ctx)
        losses, norms = [], []
        for s in range(STEPS):
            p, o, mt = step(st["params"], st["opt"],
                            local_rows({"tokens": gb[s]}, MICRO, dp, dr))
            st = {"params": p, "opt": o}
            losses.append(float(mt["loss"]))
            norms.append(float(mt["grad_norm"]))
        res["train|losses"] = losses
        res["train|norms"] = norms
        record(st, "train|state")
        if tag == "2x2":
            checkpoint.save(f"{shared}/ckpt22", STEPS, st,
                            extra={"data": {"step": STEPS, "seed": 0}})

# the (2, 2) checkpoint restored at (1, 4), (4, 1) and unsharded
if tag == "1x4":
    manifest = f"{shared}/ckpt22/step_{STEPS:08d}/manifest.json"
    end = time.monotonic() + 200.0
    while not os.path.exists(manifest):
        if time.monotonic() > end:
            raise TimeoutError(manifest)
        time.sleep(0.05)
    like = init_state(cfg, "meta")
    for model in (4, 1):
        c2 = sh.make_ctx(make_host_mesh(model=model, device="cpu"))
        with sh.use_sharding(c2):
            st, extra = checkpoint.restore(f"{shared}/ckpt22", STEPS, like,
                                           "cpu", state_shardings(like, c2))
            res[f"sharded|{4 // model}x{model}"] = [
                sh.is_distributed(x) for _, x in
                leaves_with_path(st["params"])]
            record(st, f"restore|{4 // model}x{model}")
    st, _ = checkpoint.restore(f"{shared}/ckpt22", STEPS, like, "cpu")
    record(st, "restore|plain")

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

out, shared, tag = sys.argv[1], sys.argv[2], sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P

from repro.configs import all_configs
from repro.distributed import sharding as sh
from repro.models import layers as L, lm
from repro.train import optimizer as opt, train_step as ts

L.COMPUTE_DTYPE = jnp.float32
res = {}


def keyed(tree, prefix):
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{prefix}|{jax.tree_util.keystr(path)}"] = np.asarray(
            jnp.asarray(x, jnp.float32))


def params_of(name):
    with open(f"{shared}/params_{name}.pkl", "rb") as f:
        return jax.tree.map(jnp.asarray, pickle.load(f))


def place(tree, ctx, mesh):
    specs = sh.param_specs(tree, ctx)
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh,
                                                                     s)),
                        tree, specs)


def place_batch(batch, ctx, mesh):
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P(None, ctx.dp) if k == "pos_ids" else P(ctx.dp)))
        for k, v in batch.items()}


def grads(cfg, params, batch, k, chunk, ctx, mesh):
    f = jax.jit(lambda p, mb: jax.value_and_grad(
        lambda p, mb: lm.loss_fn(p, cfg, mb, remat=False, loss_chunk=chunk),
        has_aux=True)(p, mb))
    b = batch["tokens"].shape[0] // k
    loss, acc = 0.0, None
    for i in range(k):
        mb = {key: v[:, i * b:(i + 1) * b] if key == "pos_ids"
              else v[i * b:(i + 1) * b] for key, v in batch.items()}
        (l, _), g = f(params, place_batch(mb, ctx, mesh))
        loss = loss + l
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    return float(loss / k), jax.tree.map(lambda g: g / k, acc)


devs = np.asarray(jax.devices()[:4])
cfg = all_configs()["granite-8b"].smoke()
shape = MESHES[tag]
mesh = Mesh(devs[:shape[0] * shape[1]].reshape(shape), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
ctx = sh.make_ctx(mesh)
with sh.use_sharding(ctx):
    for name in GRAD_CONFIGS:
        c2 = all_configs()[name].smoke()
        loss, g = grads(c2, place(params_of(name), ctx, mesh),
                        grad_batch(c2), 2, 8, ctx, mesh)
        res[f"{tag}|cfg|{name}|loss"] = loss
        keyed(g, f"{tag}|cfg|{name}|grad")
    if tag in TRAIN_MESHES:
        gb = batches(cfg.vocab_size)
        step = jax.jit(ts.make_train_step(
            cfg, opt.OptConfig(**TP_OPT), num_microbatches=MICRO,
            remat=True, loss_chunk=CHUNK))
        params = place(params_of("granite-8b"), ctx, mesh)
        o = opt.init_opt_state(params)
        losses, norms = [], []
        for s in range(STEPS):
            params, o, mt = step(params, o, place_batch(
                {"tokens": gb[s]}, ctx, mesh))
            losses.append(float(mt["loss"]))
            norms.append(float(mt["grad_norm"]))
        res[f"{tag}|train|losses"] = np.asarray(losses)
        res[f"{tag}|train|norms"] = np.asarray(norms)
        keyed(params, f"{tag}|train|params")
np.savez(f"{out}/jax.npz", **res)
'''


def _scope() -> dict:
    scope: dict = {}
    exec(CASES, scope)
    return scope


_S = _scope()
GRAD_CONFIGS, MESHES = _S["GRAD_CONFIGS"], _S["MESHES"]
TRAIN_MESHES, STEPS, LR, CLIP = (_S["TRAIN_MESHES"], _S["STEPS"], _S["LR"],
                                 _S["CLIP"])


def _write_inputs(shared: Path) -> None:
    """The JAX params of every config (pickled numpy trees, read by both
    packages)."""
    import jax

    from repro.configs import all_configs
    from repro.models import lm as jlm

    for name in GRAD_CONFIGS:
        jp = jlm.init_params(all_configs()[name].smoke(),
                             jax.random.PRNGKey(0))
        with open(shared / f"params_{name}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, jp), f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's results by mesh tag, JAX's under "jax"."""
    tmp = tmp_path_factory.mktemp("tp_train")
    shared = tmp / "shared"
    shared.mkdir()
    _write_inputs(shared)
    procs = []
    for tag, (d, m) in MESHES.items():
        procs += start_script(JAX_SCRIPT, tmp / f"jax{tag}", str(shared),
                              tag)
        procs += start_ranks(RANK_SCRIPT, d * m, tmp / tag, str(shared), tag)
    wait_all(procs)
    out = {"jax": {}}
    for tag in MESHES:
        out["jax"].update(load(tmp / f"jax{tag}" / "jax.npz"))
        out[tag] = load(tmp / tag / "rank0.npz")
    return out


def _leaves(res: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "|")}


def _err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _check_grads(got: dict, want: dict, tol: float = 1e-4) -> None:
    assert got.keys() == want.keys() and got
    bad = {p: _err(got[p], want[p]) for p in want
           if _err(got[p], want[p]) > tol}
    assert not bad, bad


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys() and got
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", GRAD_CONFIGS)
def test_gradients_match_jax_under_the_same_mesh(runs, name, tag):
    """One step's loss and gradients (2 microbatches, remat) of each
    config on the mesh, against JAX's under the same Auto-typed mesh:
    the loss within 1e-5 relative, every leaf within 1e-4 of its largest
    value."""
    ours, jx = runs[tag], runs["jax"]
    np.testing.assert_allclose(float(ours[f"cfg|{name}|loss"]),
                               float(jx[f"{tag}|cfg|{name}|loss"]),
                               rtol=1e-5, atol=0)
    _check_grads(_leaves(ours, f"cfg|{name}|grad"),
                 _leaves(jx, f"{tag}|cfg|{name}|grad"))


@pytest.mark.parametrize("tag", TRAIN_MESHES)
def test_adamw_steps_with_clipping_match_jax(runs, tag):
    """STEPS AdamW steps of granite-8b with every step's gradient clipped
    (its global norm, summed over the model axis once a leaf, above
    ``CLIP``): losses and norms within 1e-5 relative of JAX's, params
    within ``2 lr STEPS``."""
    ours, jx = runs[tag], runs["jax"]
    norms = np.asarray(ours["train|norms"], float)
    assert (norms > CLIP).all(), norms
    np.testing.assert_allclose(norms, jx[f"{tag}|train|norms"], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ours["train|losses"], float),
                               jx[f"{tag}|train|losses"], rtol=1e-5)
    state = _leaves(ours, "train|state")
    got = {k[len("['params']"):]: v for k, v in state.items()
           if k.startswith("['params']")}
    want = _leaves(jx, f"{tag}|train|params")
    assert got.keys() == want.keys() and got
    gap = max(float(np.abs(got[p] - want[p]).max()) for p in want)
    assert gap <= 2 * LR * STEPS, gap


@pytest.mark.parametrize("where", ["1x4", "4x1", "plain"])
def test_checkpoint_moves_between_meshes(runs, where):
    """The (2, 2) run's checkpoint after STEPS steps (params, mu, nu,
    step) restored at (1, 4) and (4, 1), each leaf a DTensor of this
    mesh's blocks, and unsharded: every leaf bit for bit the saved one."""
    saved = _leaves(runs["2x2"], "train|state")
    got = _leaves(runs["1x4"], f"restore|{where}")
    _same(got, saved)
    if where != "plain":
        assert all(runs["1x4"][f"sharded|{where}"])


def _model_formula(cfg, m: int, dtype: str, rows: int, seq: int,
                   micro: int, leaves: int) -> dict:
    """The model axis's collectives in one train step of a dense
    attention model of one layer a rematerialized unit (granite-8b;
    PERF.md §6), by kind and element type, in bytes: ``rows``
    sequences of ``seq`` tokens a microbatch, ``c`` bytes a compute
    element, T = rows * seq, T' = rows * (seq - 1), L layers.  A
    microbatch all-reduces the attention's and the FFN's row-parallel
    outputs (T d c each; again in the recompute, but for the FFN's, whose
    output no saved tensor needs: the recompute stops before it), the
    gradients entering them (T d c each), the embedding's rows (T d c),
    the loss's input gradient (T' d c) and three float32 numbers a
    position (maximum, sum of exponentials, gold logit); it all-gathers
    the final norm's float32 scale (4 d) and, where the axis does not
    divide the KV heads, ``wk`` and ``wv`` (d KV dh c each, twice with
    the recompute), reduce-scattering their gradients once.  A step
    all-reduces the global norm's float32 sums, one a leaf."""
    c = 2 if dtype == "bfloat16" else 4
    d, n = cfg.d_model, cfg.n_layers
    t, t1 = rows * seq, rows * (seq - 1)
    kv = 2 * d * cfg.n_kv_heads * cfg.dh * c
    gathered = cfg.n_kv_heads % m != 0
    act = micro * (5 * n * t * d + t * d + t1 * d) * c
    f32 = micro * 3 * t1 * 4 + 4 * leaves
    reduce = {dtype: act, "float32": f32} if dtype != "float32" else {
        "float32": act + f32}
    out = {"all_reduce:model": reduce,
           "all_gather:model": {"float32": micro * 4 * d}}
    if gathered:
        out["all_gather:model"][dtype] = (
            out["all_gather:model"].get(dtype, 0) + micro * n * 2 * kv)
        out["reduce_scatter:model"] = {dtype: micro * n * kv}
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", ["1x2", "1x4"])
def test_model_axis_bytes_equal_the_formula(runs, tag, dtype):
    """The model axis's counted bytes of one step's gradients of
    granite-8b, by kind and element type, equal the formula (the
    data-axis kinds are held by ``tests/test_torch_fsdp.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train._tree import leaves_with_path

    cfg = get_config("granite-8b").smoke()
    counts = eval(str(runs[tag][f"counts|{dtype}"]))
    got = {k: v["dtypes"] for k, v in counts.items() if k.endswith(":model")}
    n_leaves = len(leaves_with_path(lm.init_params(cfg, torch.Generator(),
                                                   "meta")))
    d, m = MESHES[tag]
    want = _model_formula(cfg, m, dtype, rows=2 // d, seq=16, micro=2,
                          leaves=n_leaves)
    assert got == want

