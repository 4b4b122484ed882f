"""Data-parallel training in the port (ZeRO-3 / FSDP, plain DP and
``pure_dp`` on ``torch.distributed``) against JAX's train step under a
host mesh, on the CPU, at the smoke configs.

One gloo group a world size (1, 2 and 4 ranks), each rank a process that
meets the others over a ``FileStore`` under ``tmp_path`` (no TCP port),
one JAX subprocess on 4 host devices, and one process driving the CLI
under ``torchrun``; all start together and are waited on with one
deadline (``test_torch_collectives.wait_all``), every rank writing its
results as ``.npz``.  JAX's reference is ``make_train_step`` (and
``jax.value_and_grad`` of ``loss_fn`` a microbatch for the gradients)
jitted under an Auto-typed (n, 1) ("data", "model") mesh with
``make_ctx(mesh, ...)``, params placed by ``named_shardings``.

The batch: microbatch ``i`` of the global batch is its ``i``-th block of
rows, as JAX's scan splits it, and rank ``r`` holds the ``r``-th part of
every microbatch (``local_rows``): it cuts its own rows into the
microbatches in order, as the port's step does, so both packages route
the same tokens together (the MoE's capacity and drops depend on it).
With one microbatch that is the ranks' rows in rank order.

Tolerances (float32 compute unless named):
  * gradients within 1e-4 of each leaf's largest value (the bound of
    ``tests/test_torch_train.py``), bf16 by the relative L2 distance from
    JAX's float32 gradient, at most 1.5x JAX's own bf16 one + 2e-3;
  * losses 1e-5 relative; params after ``STEPS`` AdamW steps within
    ``2 lr STEPS`` absolute (an update is about ``lr sign(g)``, so a
    gradient near 0 may flip one; the share past 1e-6 is printed);
  * checkpoints, the one-rank run against the unsharded trainer and the
    restored states bit for bit.
"""

from __future__ import annotations

import json
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

CTXS = {"fsdp": {}, "no_fsdp": {"fsdp": False}, "pure_dp": {"pure_dp": True}}
GRAD_CONFIGS = ["granite-8b", "granite-moe-1b-a400m", "recurrentgemma-9b",
                "xlstm-1.3b", "seamless-m4t-large-v2", "qwen2-vl-7b"]
SEQ, BATCH, MICRO, STEPS, CHUNK, LR = 32, 8, 2, 3, 16, 1e-3
OPT = dict(lr=LR, warmup_steps=0, total_steps=10)
JAX_STEP = 5          # the step of the JAX checkpoint the ranks restore


def batches(vocab):
    """STEPS + 1 global batches of BATCH x SEQ tokens."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
            for _ in range(STEPS + 1)]


def grad_batch(cfg):
    """tests/test_torch_train.py's: 4 sequences of 16 tokens in 2
    microbatches; seamless adds 12 source frames, qwen2-vl 3-axis
    positions."""
    rng = np.random.default_rng(11)
    b, s = 4, 16
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.enc_dec:
        batch["src_embeds"] = rng.standard_normal(
            (b, 12, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[1, :, 2:6] = 2 + np.arange(4) // 2
        pos[2, :, 2:6] = 2 + np.arange(4) % 2
        pos[:, 1] += 1
        batch["pos_ids"] = pos
    return batch


def local_rows(batch, k, world, rank):
    """Rank ``rank``'s rows: its part of each of the ``k`` microbatches
    (``pos_ids`` on axis 1)."""
    out = {}
    for key, v in batch.items():
        ax = 1 if key == "pos_ids" else 0
        mb = v.shape[ax] // k
        part = mb // world
        idx = np.concatenate([np.arange(i * mb + rank * part,
                                        i * mb + (rank + 1) * part)
                              for i in range(k)])
        out[key] = np.take(v, idx, axis=ax)
    return out


def moe_input(d):
    return np.random.default_rng(13).standard_normal((4, 16, d)).astype(
        np.float32)
'''

RANK_SCRIPT = CASES + r'''
import dataclasses
import datetime
import os
import pickle
import sys
import time

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
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import init_state, state_shardings
from repro_torch.models import convert, layers, lm
from repro_torch.train import OptConfig, checkpoint, init_opt_state, \
    make_train_step
from repro_torch.train._tree import leaves_with_path
from repro_torch.train.train_step import loss_and_grads

layers.COMPUTE_DTYPE = torch.float32
mesh = make_host_mesh(device="cpu")
res = {}


def record(tree, prefix):
    """Every leaf whole (DTensors gathered: collective) under prefix."""
    for path, x in leaves_with_path(tree):
        v = sh.full_tensor(x) if sh.is_distributed(x) else x
        # a copy: a replicated leaf's block is the storage the optimizer
        # updates in place
        res[f"{prefix}|{path}"] = v.detach().float().numpy().copy()


def params_of(name):
    with open(f"{shared}/params_{name}.pkl", "rb") as f:
        return convert.params_from_numpy(pickle.load(f), "cpu")


def fresh(name, ctx):
    p = sh.distribute_params(params_of(name), ctx)
    return {"params": p, "opt": init_opt_state(p)}


def run(state, step, batch):
    p, o, m = step(state["params"], state["opt"], batch)
    return {"params": p, "opt": o}, float(m["loss"])


def wait_for(path, seconds=200.0):
    end = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(path)
        time.sleep(0.05)


cfg = get_config("granite-8b").smoke()
gb = batches(cfg.vocab_size)
step = make_train_step(cfg, OptConfig(**OPT), num_microbatches=MICRO,
                       remat=True, loss_chunk=CHUNK)
fsdp = sh.make_ctx(mesh)

# the three contexts: step-1 gradients, STEPS steps, the memory per rank
for c in (CTXS if world > 1 else ["fsdp"]):
    ctx = sh.make_ctx(mesh, **CTXS[c])
    with sh.use_sharding(ctx):
        st = fresh("granite-8b", ctx)
        loss, _, g = loss_and_grads(
            st["params"], cfg, local_rows({"tokens": gb[0]}, MICRO, world,
                                          rank),
            num_microbatches=MICRO, remat=True, loss_chunk=CHUNK)
        res[f"{c}|grad_loss"] = float(loss)
        record(g, f"{c}|grad")
        losses = []
        for s in range(STEPS):
            st, l = run(st, step, local_rows({"tokens": gb[s]}, MICRO, world,
                                             rank))
            losses.append(l)
        res[f"{c}|losses"] = losses
        record(st["params"], f"{c}|params")
        trees = (st["params"], st["opt"]["mu"], st["opt"]["nu"])
        res[f"{c}|local"] = sum(sh.local(x).numel() for t in trees
                                for _, x in leaves_with_path(t))
        if c == "fsdp" and world in (2, 4):
            checkpoint.save(f"{shared}/ckpt{world}", STEPS, st,
                            extra={"data": {"step": STEPS, "seed": 0}})
        if c == "fsdp" and world == 4:
            st, l = run(st, step, local_rows({"tokens": gb[STEPS]}, MICRO,
                                             world, rank))
            res["unbroken|loss"] = l
            record(st["params"], "unbroken|params")

# one rank: the sharded trainer against the unsharded one, bit for bit
if world == 1:
    for dt in ("float32", "bfloat16"):
        layers.COMPUTE_DTYPE = getattr(torch, dt)
        plain = {"params": params_of("granite-8b")}
        plain["opt"] = init_opt_state(plain["params"])
        plain_losses = []
        for s in range(STEPS):
            plain, l = run(plain, step, {"tokens": gb[s]})
            plain_losses.append(l)
        with sh.use_sharding(fsdp):
            st = fresh("granite-8b", fsdp)
            losses = []
            for s in range(STEPS):
                st, l = run(st, step, {"tokens": gb[s]})
                losses.append(l)
            got = [sh.local(x) for t in (st["params"], st["opt"]["mu"],
                                         st["opt"]["nu"])
                   for _, x in leaves_with_path(t)]
        want = [x for t in (plain["params"], plain["opt"]["mu"],
                            plain["opt"]["nu"])
                for _, x in leaves_with_path(t)]
        res[f"bitwise|{dt}|losses"] = [losses, plain_losses]
        res[f"bitwise|{dt}|equal"] = [bool(torch.equal(a, b))
                                      for a, b in zip(got, want)]
        res[f"bitwise|{dt}|sharded"] = [
            sh.is_distributed(x) for _, x in leaves_with_path(st["params"])]
    layers.COMPUTE_DTYPE = torch.float32

    # serving under the host mesh's context, as launch/serve.py runs it
    from repro_torch.launch.serve import repeated_prompts
    from repro_torch.serve import Engine, GenConfig

    prompts = repeated_prompts(2, 16, cfg.vocab_size, 1)
    gen = GenConfig(max_new_tokens=8, ngram_spec=2)
    tokens = []
    for ctx in (sh.ShardingCtx(), fsdp):
        with sh.use_sharding(ctx):
            made, _ = Engine(cfg, params_of("granite-8b"), max_len=48
                             ).generate({"tokens": prompts}, gen)
        tokens.append(made.numpy())
    res["serve|tokens"] = np.stack(tokens)

# the gradients of every config, bf16 granite, MoE routing, the counters
if world == 2:
    with sh.use_sharding(fsdp):
        for name in GRAD_CONFIGS:
            c2 = get_config(name).smoke()
            st = fresh(name, fsdp)
            loss, _, g = loss_and_grads(
                st["params"], c2, local_rows(grad_batch(c2), 2, world, rank),
                num_microbatches=2, remat=True, loss_chunk=8)
            res[f"cfg|{name}|loss"] = float(loss)
            record(g, f"cfg|{name}|grad")
        layers.COMPUTE_DTYPE = torch.bfloat16
        st = fresh("granite-8b", fsdp)
        sh.reset_collective_counts()
        loss, _, g = loss_and_grads(
            st["params"], cfg, local_rows(grad_batch(cfg), 2, world, rank),
            num_microbatches=2, remat=True, loss_chunk=8)
        res["bf16|counts"] = repr(sh.collective_counts())
        res["bf16|loss"] = float(loss)
        record(g, "bf16|grad")
        layers.COMPUTE_DTYPE = torch.float32

        # MoE routing over the global batch, under capacity pressure
        mcfg = get_config("granite-moe-1b-a400m").smoke()
        mcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(
            mcfg.moe, capacity_factor=0.5))
        p0 = lm.tree_map(lambda a: a[0],
                         params_of("granite-moe-1b-a400m")["blocks"][0]["ffn"])
        x = torch.from_numpy(local_rows({"x": moe_input(mcfg.d_model)}, 1,
                                        world, rank)["x"])
        y, aux = layers.apply_moe(p0, x, mcfg)
        res["moe|y"] = sh.dp_gather(y).numpy()
        res["moe|aux"] = float(aux)

        # the collectives of one step, and none inside the sLSTM's loop
        st = fresh("granite-8b", fsdp)
        sh.reset_collective_counts()
        st, _ = run(st, step, local_rows({"tokens": gb[0]}, MICRO, world,
                                         rank))
        res["step|counts"] = repr(sh.collective_counts())
        xcfg = get_config("xlstm-1.3b").smoke()
        xp = params_of("xlstm-1.3b")
        unit, _, tail = lm._layout(xcfg)
        if "slstm" in unit:
            one = lm.tree_map(lambda a: a[0],
                              xp["blocks"][unit.index("slstm")]["slstm"])
        else:
            one = xp["tail"][list(tail).index("slstm")]["slstm"]
        sp = sh.distribute_params({"slstm": one}, fsdp)
        for _, leaf in leaves_with_path(sp):
            sh.local(leaf).requires_grad_(True)
        sp = lm.tree_map(lambda a: type(a).from_local(
            sh.local(a), a.device_mesh, a.placements, run_check=False), sp)
        for s in (8, 16):
            xs = torch.randn((2, s, xcfg.d_model), requires_grad=True,
                             generator=torch.Generator().manual_seed(s))
            sh.reset_collective_counts()
            view = layers.compute_view(sp)["slstm"]
            y = layers.slstm_fwd(view, xs, xcfg)
            y.float().square().sum().backward()
            res[f"slstm|{s}|counts"] = repr(sh.collective_counts())

# re-sharding on restore: the 4-rank checkpoint at 2 and 1 ranks, and the
# JAX checkpoint at 2
if world in (1, 2):
    with sh.use_sharding(fsdp):
        like = init_state(cfg, "meta")
        wait_for(f"{shared}/ckpt4/step_{STEPS:08d}/manifest.json")
        st, extra = checkpoint.restore(f"{shared}/ckpt4", STEPS, like, "cpu",
                                       state_shardings(like, fsdp))
        res["resume|extra"] = repr(extra)
        res["resume|sharded"] = [sh.is_distributed(x) for _, x in
                                 leaves_with_path(st["params"])]
        record(st, "resume|state")
        st, l = run(st, step, local_rows({"tokens": gb[STEPS]}, MICRO, world,
                                         rank))
        res["resume|loss"] = l
        record(st["params"], "resume|params")
        if world == 2:
            st, extra = checkpoint.restore(f"{shared}/jaxckpt", JAX_STEP,
                                           like, "cpu",
                                           state_shardings(like, fsdp))
            record(st, "jaxckpt|state")
            st, l = run(st, step, local_rows({"tokens": gb[0]}, MICRO, world,
                                             rank))
            res["jaxckpt|loss"] = l
            record(st["params"], "jaxckpt|params")

if rank == 0:
    np.savez(f"{out}/rank0.npz", **{k: np.asarray(v)
                                   for k, v in res.items()})
dist.barrier()
dist.destroy_process_group()
'''

JAX_SCRIPT = CASES + r'''
import glob
import os
import pickle
import re
import sys
import time

out, shared = sys.argv[1], sys.argv[2]
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=4 "
    f"--xla_dump_to={out}/hlo --xla_dump_hlo_module_re=.*bf16_grads.* "
    "--xla_dump_hlo_pass_re=spmd-partitioning")
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P

from repro.configs import all_configs
from repro.distributed import sharding as sh
from repro.models import layers as L, lm
from repro.train import checkpoint as ckpt, optimizer as opt, \
    train_step as ts

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


def grads(cfg, params, batch, k, chunk, ctx, mesh, fn_name="grads"):
    def f(p, mb):
        return jax.value_and_grad(
            lambda p, mb: lm.loss_fn(p, cfg, mb, remat=False,
                                     loss_chunk=chunk), has_aux=True)(p, mb)
    f.__name__ = fn_name
    f = jax.jit(f)
    b = batch["tokens"].shape[0] // k
    loss, acc = 0.0, None
    for i in range(k):
        mb = {key: v[:, i * b:(i + 1) * b] if key == "pos_ids"
              else v[i * b:(i + 1) * b] for key, v in batch.items()}
        (l, _), g = f(params, place_batch(mb, ctx, mesh))
        loss = loss + l
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    return float(loss / k), jax.tree.map(lambda g: g / k, acc)


def train_step_fn(cfg):
    return jax.jit(ts.make_train_step(cfg, opt.OptConfig(**OPT),
                                      num_microbatches=MICRO, remat=True,
                                      loss_chunk=CHUNK))


def shardings_of(like, ctx, mesh):
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s),
                                sh.param_specs(t, ctx),
                                is_leaf=lambda x: isinstance(x, P))
    return {"params": ns(like["params"]),
            "opt": {"mu": ns(like["params"]), "nu": ns(like["params"]),
                    "step": NamedSharding(mesh, P())}}


devs = np.asarray(jax.devices()[:4])
cfg = all_configs()["granite-8b"].smoke()
gb = batches(cfg.vocab_size)
jp = params_of("granite-8b")
for n in (2, 4):
    mesh = Mesh(devs[:n].reshape(n, 1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    for c, kw in CTXS.items():
        ctx = sh.make_ctx(mesh, **kw)
        with sh.use_sharding(ctx):
            params = place(jp, ctx, mesh)
            loss, g = grads(cfg, params, {"tokens": gb[0]}, MICRO, CHUNK,
                            ctx, mesh)
            res[f"{n}|{c}|grad_loss"] = loss
            keyed(g, f"{n}|{c}|grad")
            step = train_step_fn(cfg)
            o = opt.init_opt_state(params)
            losses = []
            for s in range(STEPS):
                params, o, m = step(params, o, place_batch(
                    {"tokens": gb[s]}, ctx, mesh))
                losses.append(float(m["loss"]))
            res[f"{n}|{c}|losses"] = np.asarray(losses)
            keyed(params, f"{n}|{c}|params")

mesh = Mesh(devs[:2].reshape(2, 1), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
ctx = sh.make_ctx(mesh)
with sh.use_sharding(ctx):
    for name in GRAD_CONFIGS:
        c2 = all_configs()[name].smoke()
        loss, g = grads(c2, place(params_of(name), ctx, mesh),
                        grad_batch(c2), 2, 8, ctx, mesh)
        res[f"cfg|{name}|loss"] = loss
        keyed(g, f"cfg|{name}|grad")
    L.COMPUTE_DTYPE = jnp.bfloat16
    loss, g = grads(cfg, place(jp, ctx, mesh), grad_batch(cfg), 2, 8, ctx,
                    mesh, "bf16_grads")
    res["bf16|loss"] = loss
    keyed(g, "bf16|grad")
    L.COMPUTE_DTYPE = jnp.float32

    # the JAX checkpoint restored under the mesh, and one step from it
    like = {"params": jp, "opt": opt.init_opt_state(jp)}
    state, _ = ckpt.restore(f"{shared}/jaxckpt", JAX_STEP, like,
                            shardings_of(like, ctx, mesh))
    step = train_step_fn(cfg)
    p, o, m = step(state["params"], state["opt"],
                   place_batch({"tokens": gb[0]}, ctx, mesh))
    res["jaxckpt|loss"] = float(m["loss"])
    keyed(p, "jaxckpt|params")

    # the port's 2-rank checkpoint restored under the mesh
    manifest = f"{shared}/ckpt2/step_{STEPS:08d}/manifest.json"
    end = time.monotonic() + 200.0
    while not os.path.exists(manifest):
        if time.monotonic() > end:
            raise TimeoutError(manifest)
        time.sleep(0.05)
    state, extra = ckpt.restore(f"{shared}/ckpt2", STEPS, like,
                                shardings_of(like, ctx, mesh))
    keyed(state, "from_port|state")
    res["from_port|spec"] = repr(state["params"]["emb"].sharding.spec)

# the element types of the collectives GSPMD put into the bf16 gradients
found = {}
for path in glob.glob(f"{out}/hlo/*bf16_grads*after_spmd-partitioning*"):
    for line in open(path):
        mm = re.search(r"= ([a-z0-9]+)\[([0-9,]*)\]\S* (all-reduce|"
                       r"reduce-scatter|all-gather)\(", line)
        if mm and mm.group(2).count(",") >= 1:       # weights: 2-D or more
            found.setdefault(mm.group(3), set()).add(mm.group(1))
res["hlo"] = repr({k: sorted(v) for k, v in found.items()})
np.savez(f"{out}/jax.npz", **res)
'''

CLI_SCRIPT = r'''
import json
import os
import signal
import subprocess
import sys

out = sys.argv[1]
ck = os.path.join(out, "ck")
env = dict(os.environ, OMP_NUM_THREADS="1")
runs = {}
for steps in (4, 8):
    # a session of its own, so a hang takes torchrun's workers down with it
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite-8b", "--smoke", "--device", "cpu",
         "--steps", str(steps), "--ckpt-dir", ck, "--log-every", "2",
         "--seq-len", "16", "--global-batch", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=out, start_new_session=True)
    try:
        _, err = p.communicate(timeout=100)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        _, err = p.communicate()
    runs[steps] = {"rc": p.returncode, "err": err[-6000:]}
    if p.returncode:
        break
json.dump(runs, open(os.path.join(out, "cli.json"), "w"))
sys.exit(0 if all(r["rc"] == 0 for r in runs.values()) else 1)
'''


def _scope() -> dict:
    scope: dict = {}
    exec(CASES, scope)
    return scope


_S = _scope()
CTXS, GRAD_CONFIGS = _S["CTXS"], _S["GRAD_CONFIGS"]
STEPS, LR, MICRO = _S["STEPS"], _S["LR"], _S["MICRO"]
PARAM_TOL = 2 * LR * STEPS


def _write_inputs(shared: Path) -> None:
    """The JAX params of every config (pickled NumPy trees, read by both
    packages) and a JAX checkpoint at ``JAX_STEP`` with nonzero moments."""
    import jax
    import jax.numpy as jnp

    from repro.configs import all_configs
    from repro.models import lm as jlm
    from repro.train import checkpoint as jckpt

    for name in GRAD_CONFIGS:
        jp = jlm.init_params(all_configs()[name].smoke(),
                             jax.random.PRNGKey(0))
        with open(shared / f"params_{name}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, jp), f)
        if name == "granite-8b":
            state = {"params": jp, "opt": {
                "mu": jax.tree.map(lambda x: x * 0.01, jp),
                "nu": jax.tree.map(lambda x: x * x * 1e-3 + 1e-6, jp),
                "step": jnp.asarray(_S["JAX_STEP"], jnp.int32)}}
            jckpt.save(str(shared / "jaxckpt"), _S["JAX_STEP"], state,
                       extra={"data": {"step": 0, "seed": 0}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's results by world size, JAX's under "jax", the CLI's
    under "cli"."""
    tmp = tmp_path_factory.mktemp("fsdp")
    shared = tmp / "shared"
    shared.mkdir()
    _write_inputs(shared)
    procs = start_script(JAX_SCRIPT, tmp / "jax", str(shared))
    procs += start_script(CLI_SCRIPT, tmp / "cli")
    for w in (4, 2, 1):
        procs += start_ranks(RANK_SCRIPT, w, tmp / f"w{w}", str(shared))
    wait_all(procs)
    out = {"jax": load(tmp / "jax" / "jax.npz"), "shared": shared,
           "cli": json.loads((tmp / "cli" / "cli.json").read_text())}
    for w in (1, 2, 4):
        out[w] = load(tmp / f"w{w}" / "rank0.npz")
    return out


def _leaves(res: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "|")}


def _err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _rl2(got, want) -> float:
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)


def _check_grads(got: dict, want: dict, tol: float = 1e-4) -> None:
    assert got.keys() == want.keys() and got
    bad = {p: _err(got[p], want[p]) for p in want
           if _err(got[p], want[p]) > tol}
    assert not bad, bad


def _check_params(got: dict, want: dict, tol: float = PARAM_TOL) -> None:
    assert got.keys() == want.keys() and got
    diffs = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    print(f"params: largest gap {diffs.max():.3g} (bound {tol:.3g}), share "
          f"past 1e-6 {float((diffs > 1e-6).mean()):.4f}")
    assert diffs.max() <= tol


def _check_losses(got, want, tol: float = 1e-5) -> None:
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys() and got
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def _counts(res, key) -> dict:
    return eval(str(res[key]))


# ---------------------------------------------------------------------------
# against JAX's step under the host mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("ctx", CTXS)
def test_sharded_step_matches_jax(runs, ctx, world):
    """Step-1 gradients (reduced over the data ranks), STEPS losses and
    the params after them, against JAX's under the same context on an
    (n, 1) Auto mesh."""
    ours, jx = runs[world], runs["jax"]
    _check_grads(_leaves(ours, f"{ctx}|grad"),
                 _leaves(jx, f"{world}|{ctx}|grad"))
    _check_losses(float(ours[f"{ctx}|grad_loss"]),
                  float(jx[f"{world}|{ctx}|grad_loss"]))
    _check_losses(list(ours[f"{ctx}|losses"]), jx[f"{world}|{ctx}|losses"])
    _check_params(_leaves(ours, f"{ctx}|params"),
                  _leaves(jx, f"{world}|{ctx}|params"))


@pytest.mark.parametrize("name", GRAD_CONFIGS)
def test_every_config_gradients_match_jax(runs, name):
    """One step's gradients of each of the six configs at 2 ranks (2
    microbatches, remat): granite-moe routes the global batch, xlstm runs
    the sLSTM on each rank's rows, seamless carries source frames and
    qwen2-vl 3-axis positions split on their batch axis."""
    ours, jx = runs[2], runs["jax"]
    _check_grads(_leaves(ours, f"cfg|{name}|grad"),
                 _leaves(jx, f"cfg|{name}|grad"))
    _check_losses(float(ours[f"cfg|{name}|loss"]),
                  float(jx[f"cfg|{name}|loss"]))


def test_bf16_gradients_within_jax_own_bf16_distance(runs):
    """granite-8b in bf16 at 2 ranks: each leaf's relative L2 distance
    from JAX's float32 gradient at most 1.5x JAX's own bf16 one + 2e-3
    (``tests/test_torch_train.py``'s bound); the loss within 2e-2."""
    ours, jx = runs[2], runs["jax"]
    f32 = _leaves(jx, "cfg|granite-8b|grad")
    jb = _leaves(jx, "bf16|grad")
    got = _leaves(ours, "bf16|grad")
    assert got.keys() == f32.keys() == jb.keys()
    ratios = {}
    for p in f32:
        ours_d, jax_d = _rl2(got[p], f32[p]), _rl2(jb[p], f32[p])
        ratios[p] = ours_d / max(jax_d, 1e-30)
        assert ours_d <= 1.5 * jax_d + 2e-3, (p, ours_d, jax_d)
    print(f"bf16: largest ratio to JAX's own distance "
          f"{max(ratios.values()):.3f}")
    _check_losses(float(ours["bf16|loss"]), float(jx["bf16|loss"]), 2e-2)


def test_gradient_reduction_dtype_is_gspmds(runs):
    """GSPMD reduces the bf16 weight gradients in bf16 (read from JAX's
    HLO right after SPMD partitioning; XLA's CPU backend promotes them to
    float32 later) and gathers the weights in float32 before their cast,
    the same values as gathering the cast.  The port gathers the bf16
    cast (half the bytes) and reduce-scatters the gradients in bf16,
    but the embedding table, whose rows' gradients accumulate in float32
    (as the unsharded trainer's do) and are reduced so."""
    hlo = eval(str(runs["jax"]["hlo"]))
    assert set(hlo["all-reduce"]) | set(hlo.get("reduce-scatter", [])) \
        == {"bf16"}, hlo
    assert hlo["all-gather"] == ["f32"], hlo
    from repro_torch.configs import get_config

    counts = _counts(runs[2], "bf16|counts")
    assert set(counts["all_gather"]["dtypes"]) == {"bfloat16"}, counts
    rs = counts["reduce_scatter"]["dtypes"]
    cfg = get_config("granite-8b").smoke()
    vp = -(-cfg.vocab_size // 512) * 512
    assert rs["float32"] == MICRO * vp * cfg.d_model * 4, rs   # the table
    assert set(rs) == {"bfloat16", "float32"} and rs["bfloat16"] > 0


# ---------------------------------------------------------------------------
# the ranks against each other, and one rank against the unsharded trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctx", CTXS)
def test_world_sizes_agree(runs, ctx):
    """1, 2 and 4 ranks (the one-rank run under ``fsdp``, which is every
    context at one rank) within the bounds held against JAX."""
    one = runs[1]
    for w in (2, 4):
        _check_grads(_leaves(runs[w], f"{ctx}|grad"),
                     _leaves(one, "fsdp|grad"))
        _check_losses(list(runs[w][f"{ctx}|losses"]),
                      list(one["fsdp|losses"]))
        _check_params(_leaves(runs[w], f"{ctx}|params"),
                      _leaves(one, "fsdp|params"))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_one_rank_equals_the_unsharded_trainer(runs, dt):
    """At one rank every leaf is a DTensor and every collective runs, and
    STEPS steps give the unsharded trainer's params, moments and losses
    bit for bit."""
    res = runs[1]
    losses, plain = res[f"bitwise|{dt}|losses"]
    assert list(losses) == list(plain)
    assert all(res[f"bitwise|{dt}|sharded"])
    assert all(res[f"bitwise|{dt}|equal"])


def _granite_specs(world: int) -> tuple:
    """(config, [(top-level key, shape, elements, split over the data
    axes)]) of granite-8b's smoke params under the fsdp rules on a (world,
    1) mesh."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import lm

    cfg = get_config("granite-8b").smoke()
    mesh = type("M", (), {"axis_names": ("data", "model"),
                          "shape": {"data": world, "model": 1}})()
    ctx = sh.make_ctx(mesh)
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, path)
        else:
            spec = sh.param_spec(path, tuple(t.shape), ctx)
            split = any(a in ctx.data_axes for e in spec if e is not None
                        for a in (e if isinstance(e, tuple) else (e,)))
            out.append((path.split("/")[1], tuple(t.shape), t.numel(),
                        split))

    walk(lm.init_params(cfg, torch.Generator(), "meta"), "")
    return cfg, out


def test_serving_under_the_host_mesh_keeps_its_tokens(runs):
    """``launch/serve.py`` runs under the host mesh's context (a group of
    one): greedy speculative tokens equal those without it."""
    plain, meshed = runs[1]["serve|tokens"]
    assert plain.shape == (2, 24)
    np.testing.assert_array_equal(meshed, plain)


def _spec_elements(world: int) -> tuple[int, int]:
    """(all elements of params + mu + nu, those replicated over the data
    axes) of granite-8b's smoke params, from the partition rules."""
    _, leaves = _granite_specs(world)
    total = sum(3 * n for _, _, n, _ in leaves)
    rep = sum(3 * n for _, _, n, split in leaves if not split)
    return total, rep


@pytest.mark.parametrize("world", [1, 2, 4])
def test_memory_per_rank(runs, world):
    """Each rank's params + mu + nu hold at most 1/N of the state plus the
    leaves replicated over the data axes (ZeRO-3)."""
    total, rep = _spec_elements(world)
    local = int(runs[world]["fsdp|local"])
    assert local == (total - rep) // world + rep
    if world > 1:
        assert local < total


# ---------------------------------------------------------------------------
# checkpoints: re-sharding on restore, both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2])
def test_four_rank_checkpoint_restores_at_fewer_ranks(runs, world):
    """The 4-rank run's checkpoint after STEPS steps, restored at 2 and at
    1 rank: the state equal to the saved one bit for bit (each rank
    holding its blocks), and the next step equal to the unbroken 4-rank
    run's within the bounds."""
    four, ours = runs[4], runs[world]
    saved = {**_leaves(four, "fsdp|params")}
    state = _leaves(ours, "resume|state")
    got = {k[len("['params']"):]: v for k, v in state.items()
           if k.startswith("['params']")}
    _same(got, saved)
    assert all(ours["resume|sharded"])
    assert "'step': 3" in str(ours["resume|extra"])
    _check_losses(float(ours["resume|loss"]), float(four["unbroken|loss"]))
    _check_params(_leaves(ours, "resume|params"),
                  _leaves(four, "unbroken|params"))


def test_jax_checkpoint_restores_into_two_ranks(runs, tmp_path):
    """A JAX checkpoint (params, nonzero moments, step 5) restored into 2
    ranks equals it bit for bit, and the next step equals JAX's from the
    same checkpoint restored under its 2-device mesh."""
    import jax

    ours, jx = runs[2], runs["jax"]
    state = _leaves(ours, "jaxckpt|state")
    with open(runs["shared"] / "params_granite-8b.pkl", "rb") as f:
        jp = pickle.load(f)
    assert state
    for path, x in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = "['params']" + jax.tree_util.keystr(path)
        np.testing.assert_array_equal(state[key], np.asarray(x, np.float32))
    assert float(state["['opt']['step']"]) == _S["JAX_STEP"]
    _check_losses(float(ours["jaxckpt|loss"]), float(jx["jaxckpt|loss"]))
    _check_params(_leaves(ours, "jaxckpt|params"),
                  _leaves(jx, "jaxckpt|params"))


def test_two_rank_checkpoint_restores_into_jax(runs):
    """The 2-rank run's checkpoint restored by JAX under its 2-device mesh
    (``restore(..., shardings)``, the partition rules' placement) equals
    the ranks' state bit for bit."""
    ours, jx = runs[2], runs["jax"]
    theirs = _leaves(jx, "from_port|state")
    want = _leaves(ours, "fsdp|params")
    got = {k[len("['params']"):]: v for k, v in theirs.items()
           if k.startswith("['params']")}
    _same(got, want)
    assert "data" in str(jx["from_port|spec"])
    assert float(theirs["['opt']['step']"]) == STEPS


# ---------------------------------------------------------------------------
# the MoE's global routing, the collectives' counts, the CLI
# ---------------------------------------------------------------------------

def test_moe_routes_the_global_batch(runs):
    """``apply_moe`` on 2 ranks' rows equals one process's on the whole
    batch (capacity halved, so tokens drop): global capacity, queue
    positions after the lower rank's tokens, the aux loss from load and
    importance over the whole batch.  Routing each rank's rows alone
    drops other tokens and differs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import convert, layers, lm

    cfg = get_config("granite-moe-1b-a400m").smoke()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    with open(runs["shared"] / "params_granite-moe-1b-a400m.pkl",
              "rb") as f:
        params = convert.params_from_numpy(pickle.load(f), "cpu")
    p0 = lm.tree_map(lambda a: a[0], params["blocks"][0]["ffn"])
    x = torch.from_numpy(_S["moe_input"](cfg.d_model))
    with torch.no_grad():
        y, aux = layers.apply_moe(p0, x, cfg)
        alone = torch.cat([layers.apply_moe(p0, x[:2], cfg)[0],
                           layers.apply_moe(p0, x[2:], cfg)[0]])
        probs = torch.softmax(x.reshape(-1, cfg.d_model) @ p0["router"], -1)
        t = x.shape[0] * x.shape[1]
        cap = max(int(cfg.moe.capacity_factor * t * cfg.moe.top_k
                      / cfg.moe.n_experts), 4)
        keep = layers.moe_route(probs, cfg.moe.top_k, cap)[3]
    assert not bool(keep.all()), "no token dropped: the case has no teeth"
    got = runs[2]["moe|y"].reshape(y.shape)
    np.testing.assert_allclose(got, y.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(runs[2]["moe|aux"]), float(aux),
                               rtol=1e-6)
    assert float((alone - y).abs().max()) > 1e-3


def _step_formula(world: int) -> dict:
    """The bytes each kind carries in one float32 fsdp step of granite-8b
    (MICRO microbatches, remat) by the partition rules: every dp-sharded
    leaf all-gathered whole at each use (twice a microbatch for the
    rematerialized layer unit, once for the embedding and unembedding)
    and reduce-scattered once a microbatch; replicated leaves all-reduced
    once a microbatch and use; the loss and its two metrics, and the
    global norm's per-leaf sums, all-reduced once a step."""
    cfg, leaves = _granite_specs(world)
    gathered = scattered = reduced = 0
    for top, _, n, split in leaves:
        nbytes = 4 * n
        # the unit's leaves gathered again by the remat recompute; a tied
        # embedding serves the unembedding too
        uses = 1 + (top == "blocks" or (top == "emb"
                                         and cfg.tie_embeddings))
        grads = 1 + (top == "emb" and cfg.tie_embeddings)
        if split:
            gathered += uses * nbytes
            scattered += grads * nbytes
        else:
            reduced += grads * nbytes
    return {"all_gather": MICRO * gathered,
            "reduce_scatter": MICRO * scattered,
            "all_reduce": MICRO * reduced + 3 * 4 + 4 * len(leaves)}


def test_collective_bytes_equal_the_formula(runs):
    """The counters of one step at 2 ranks: each kind's bytes equal the
    formula from the partition rules, and each rank's ring bytes are
    ``(g - 1) / g`` of them (twice for the all-reduce), as
    ``parse_hlo`` counts XLA's."""
    from repro_torch.analysis import roofline

    counts = _counts(runs[2], "step|counts")
    want = _step_formula(2)
    for kind, nbytes in want.items():
        assert counts[kind]["bytes"] == nbytes, (kind, counts[kind], nbytes)
        ring = nbytes / 2 * (2 if kind == "all_reduce" else 1)
        assert counts[kind]["ring_bytes"] == pytest.approx(ring, rel=1e-12)
    stats = roofline.collective_stats(counts)
    assert stats.per_chip_bytes == pytest.approx(
        sum(v["ring_bytes"] for v in counts.values()))
    terms = roofline.roofline_terms(1.0, 1.0, stats.per_chip_bytes)
    assert terms["collective_s"] == pytest.approx(
        stats.per_chip_bytes / roofline.HW["nvlink_bw"])


def test_no_collective_inside_the_slstm_loop(runs):
    """The sLSTM over 8 and over 16 positions runs the same collectives
    (those of its weights' views), none a time step."""
    a, b = (_counts(runs[2], f"slstm|{s}|counts") for s in (8, 16))
    assert {k: v["calls"] for k, v in a.items()} == \
        {k: v["calls"] for k, v in b.items()}
    assert sum(v["calls"] for v in a.values()) > 0


def test_cli_under_torchrun_trains_then_resumes(runs):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke
    --device cpu``: 4 steps, then the same line with ``--steps 8`` resumes
    from the 2-rank checkpoint; rank 0 logs."""
    cli = runs["cli"]
    first, second = cli["4"], cli["8"]
    assert first["rc"] == 0 and second["rc"] == 0, cli
    assert "mesh (2, 1)" in first["err"]
    assert "step 4 loss" in first["err"]
    assert "done: 4 steps (from 0)" in first["err"]
    assert "restored checkpoint step 4" in second["err"]
    assert "done: 8 steps (from 4)" in second["err"]
    assert first["err"].count("done: 4 steps") == 1


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

def test_shard_raises_on_a_model_axis(monkeypatch):
    """A "model" axis longer than 1 is tensor parallelism: each rank hands
    ``shard`` its part of an activation, which comes back as it is, and
    ``compute_view`` casts a plain leaf; serving runs under it too
    (``check_data_only`` accepts it for prefill and decode).  What still
    raises on that axis, citing its ROADMAP item and never skipping the
    axis silently, is sequence parallelism over it (``seq_shard``, item
    5c) and the data-axis expert layouts (``REPRO_EP_DATA``, item 5d).
    With "model" 1 (or folded into dp) ``shard`` returns its input."""
    from repro_torch.distributed import sharding as sh

    tp = type("M", (), {"axis_names": ("data", "model"),
                        "shape": {"data": 2, "model": 2}})()
    x = torch.ones((2, 3, 4))
    assert sh.shard(x, "btf", sh.make_ctx(tp)) is x
    view = sh.compute_view({"wq": torch.ones((4, 4))}, torch.bfloat16,
                           sh.make_ctx(tp))
    assert view["wq"].dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="Queue 1 item 5c"):
        sh.shard(x, "btf", sh.make_ctx(tp, seq_shard=True))
    for serving_ctx in (sh.make_ctx(tp), sh.make_ctx(tp, fsdp=False)):
        for what in ("prefill", "decode_step"):
            sh.check_data_only(serving_ctx, what)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5c"):
        sh.check_data_only(sh.make_ctx(tp, seq_shard=True), "prefill")
    monkeypatch.setattr(sh, "_EP_AXIS_DATA", True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5d"):
        sh.shard(x, "ecd", sh.make_ctx(tp))
    monkeypatch.setattr(sh, "_EP_AXIS_DATA", False)
    assert sh.shard(x, "btf", sh.make_ctx(tp, pure_dp=True)) is x
    dp = type("M", (), {"axis_names": ("data", "model"),
                        "shape": {"data": 4, "model": 1}})()
    assert sh.shard(x, "bhsd", sh.make_ctx(dp)) is x
    assert sh.shard(x, "btd", sh.ShardingCtx()) is x
