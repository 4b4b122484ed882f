"""Multi-pod dry run on ``torch.distributed``: run every (arch x shape)
cell's step on the production meshes, with no card, and extract the
roofline inputs (a port of ``repro.launch.dryrun``).

The process is rank 0 of a ``fake`` process group (torch's test backend:
every collective returns at once and moves nothing) of 256 ranks, the
(16, 16) ("data", "model") mesh, or 512, (2, 16, 16) ("pod", "data",
"model"), as JAX's dry run compiles for 512 host devices.  The step runs
on the ``meta`` device, on rank 0's blocks of its inputs, shapes and
dtypes without storage, so nothing is allocated: the params by the
partition rules (``sharding.distribute_params``; training weights
float32 under ZeRO-3, serving weights bf16, whole on the data axes and
split over "model", JAX's ``make_ctx(mesh, fsdp=False)``), the optimizer
state, the batch (``sharding.batch_spec``) and the caches
(``sharding.cache_spec``; float8 where ``specs.kv_dtype_for`` says).

Per cell:
  1. the step, run once on the requested mesh: ``build_s`` (building its
     inputs and running it; JAX's ``lower_s`` and ``compile_s``: there is
     no compiled program, so JAX's ``--save-hlo`` has no counterpart);
  2. ``memory``: ``argument_gb``, the bytes of rank 0's blocks of the
     step's arguments; the rest from a count of live meta storage during
     the step (:class:`_Ledger`): each tensor an operation returns counts
     its storage (views share it) from its making until the last tensor
     on it is freed, arguments apart.  ``peak_device_gb`` = arguments +
     the most alive at once; ``output_gb`` the storages of the step's
     result, ``alias_gb`` those of them that are arguments (a decode
     step writes its caches in place, the train step its params and
     moments); ``temp_gb`` = the peak less arguments and outputs, as
     JAX's ``peak = argument + temp + output - alias``;
  3. ``collectives``: ``sharding.collective_counts()`` through
     ``roofline.collective_stats`` (``per_chip_gb``, ``by_kind_gb``,
     ``op_counts``; by kind and axis, ``"<kind>:model"`` for the model
     axis), where JAX parses the compiled HLO;
  4. ``probe`` (single pod, unless ``--no-probe``): the 1-unit and 2-unit
     builds (layers of one or two repeats of the layer pattern, one
     microbatch), FLOPs by ``FlopCounterMode`` plus attention's
     (``ops.MetaAttention``: the flash kernel's live pairs), bytes the sum
     of each operation's inputs and outputs (views apart), which is what
     XLA's "bytes accessed" sums; extrapolated to the whole depth as JAX
     does: unit = cost(2) - cost(1), total = cost(1) + (units - 1) unit;
  5. ``roofline`` (``roofline.roofline_terms`` on the H100), ``model_flops``
     and ``useful_flops_ratio`` as in JAX.

The sLSTM runs its time loop in Python: ``prefill_32k`` and ``train_4k``
of xlstm-1.3b take minutes.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape decode_32k \\
      --mesh single --no-probe
  python -m repro_torch.launch.dryrun --all --mesh both --out-dir \\
      artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis import roofline
from repro_torch.configs import SHAPES, get_config, runnable_cells
from repro_torch.distributed import sharding as shlib
from repro_torch.kernels import ops
from repro_torch.launch import specs as speclib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.train import OptConfig, init_opt_state, make_train_step
from repro_torch.train._tree import map_with_path

TRAIN_MICROBATCHES = int(os.environ.get("REPRO_MICROBATCHES", "8"))
LOSS_CHUNK = 1024

#: JAX's dry-run rules, under their names there
_batch_spec = shlib.batch_spec
_CACHE_RULES = shlib.CACHE_RULES
_cache_spec = shlib.cache_spec


def _storage(t: torch.Tensor) -> tuple[int, int]:
    """(identity, bytes) of a tensor's storage (a ``DTensor``'s block's)."""
    st = shlib.local(t).untyped_storage()
    return st._cdata, st.nbytes()


def _bytes(tree) -> int:
    """The bytes of the distinct storages under ``tree``."""
    seen = dict(_storage(t) for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor))
    return sum(seen.values())


class _Ledger(TorchDispatchMode):
    """Counts the meta storage alive during the step, beside the
    arguments' (module docstring), and, with ``probe``, each operation's
    input and output bytes (views apart)."""

    def __init__(self, args, probe: bool = False):
        super().__init__()
        self.args = {_storage(t)[0] for t in tree_leaves(args)
                     if isinstance(t, torch.Tensor)}
        self.refs: dict = {}            # storage -> live tensors on it
        self.size: dict = {}
        self.live = self.peak = 0
        self.probe, self.op_bytes = probe, 0

    def _drop(self, key) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.size.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if type(t) is torch.Tensor]
        if self.probe and not func.is_view:
            self.op_bytes += sum(t.nbytes for t in
                                 tree_leaves((args, kwargs)) + outs
                                 if isinstance(t, torch.Tensor))
        for t in outs:
            key, size = _storage(t)
            if key in self.args:
                continue
            if key not in self.refs:
                self.refs[key] = 0
                self.size[key] = size
                self.live += size
                self.peak = max(self.peak, self.live)
            self.refs[key] += 1
            weakref.finalize(t, self._drop, key)
        return out

    def memory(self, args, out) -> dict:
        gb = 2 ** 30
        arg = _bytes(args)
        outs = dict(_storage(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
        alias = sum(n for k, n in outs.items() if k in self.args)
        output = sum(outs.values())
        fresh = output - alias
        return {"argument_gb": arg / gb, "output_gb": output / gb,
                "temp_gb": (self.peak - fresh) / gb, "alias_gb": alias / gb,
                "peak_device_gb": (arg + self.peak) / gb}


def _blocks(tree, spec_fn, ctx):
    """Rank 0's blocks of a tree of whole meta inputs under ``spec_fn``
    (keyed by each leaf's dict key)."""
    def block(path, x):
        name = path.rpartition("['")[2].rstrip("']")
        shape = shlib.spec_block_shape(tuple(x.shape),
                                       spec_fn(name, tuple(x.shape), ctx),
                                       ctx)
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    return map_with_path(block, tree)


def build_cell(arch: str, shape_name, mesh, probe_units: int = 0):
    """Returns (step, args, cfg): ``step(*args)`` runs this rank's part of
    the cell on the meta device (``shape_name``: a name of ``SHAPES``, or
    a ``ShapeConfig``; ``mesh`` any ``DeviceMesh``).  Probe builds (1 and
    2 units) cut the depth to that many repeats of the layer pattern (the
    encoder to at most as many layers) and train in one microbatch."""
    cfg = get_config(arch)
    microbatches = TRAIN_MICROBATCHES
    if probe_units:
        unit = tuple(cfg.pattern)
        cfg = dataclasses.replace(
            cfg, n_layers=len(unit) * probe_units,
            n_enc_layers=min(cfg.n_enc_layers, probe_units))
        microbatches = 1
    shape = speclib.shape_of(shape_name)
    # inference: weights whole over dp (each DP replica serves the whole
    # model, TP over "model" only): no per-step FSDP gathers
    ctx = shlib.make_ctx(mesh, fsdp=(shape.kind == "train"),
                         pure_dp=bool(int(os.environ.get("REPRO_PURE_DP",
                                                         "0")))
                         and shape.kind == "train")
    shlib.set_sharding_ctx(ctx)
    specs = speclib.input_specs(cfg, shape_name)
    params = shlib.distribute_params(specs["params"], ctx)
    if shape.kind == "train":
        step = make_train_step(cfg, OptConfig(), microbatches, remat=True,
                               loss_chunk=LOSS_CHUNK)
        return step, (params, init_opt_state(params),
                      _blocks(specs["batch"], _batch_spec, ctx)), cfg
    if shape.kind == "prefill":
        def prefill(params, batch):
            return lm.prefill(params, cfg, batch, max_len=shape.seq_len)
        return prefill, (params, _blocks(specs["batch"], _batch_spec,
                                         ctx)), cfg
    tokens = _blocks({"tokens": specs["tokens_t"]}, _batch_spec,
                     ctx)["tokens"]
    cross = max(shape.seq_len // 8, 16) if cfg.enc_dec else 0
    caches = lm.init_caches(cfg, tokens.shape[0], max_len=shape.seq_len,
                            device=speclib.META,
                            dtype=speclib.kv_dtype_for(cfg, shape_name),
                            cross_len=cross)

    def decode(params, tokens_t, caches, pos):
        return lm.decode_step(params, cfg, tokens_t, caches, pos,
                              max_len=shape.seq_len,
                              cross_len=cross or None)
    return decode, (params, tokens, caches, specs["pos"]), cfg


def _group(multi_pod: bool):
    """Start this process as rank 0 of a fake group of 256 / 512 ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)


def _run(step, args, probe: bool = False):
    """``step(*args)`` under the ledger; returns (result, ledger)."""
    ledger = _Ledger(args, probe)
    with ledger:
        out = step(*args)
    return out, ledger


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             probe: bool = True) -> dict:
    """One cell's record, as rank 0 of a fake group started here (and
    ended: one cell a group)."""
    from torch.utils.flop_counter import FlopCounterMode

    _group(multi_pod)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        n_dev = mesh.size()
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "devices": n_dev}
        t0 = time.time()
        step, args, cfg = build_cell(arch, shape_name, mesh)
        shlib.reset_collective_counts()
        out, ledger = _run(step, args)
        rec["build_s"] = round(time.time() - t0, 1)
        rec["memory"] = ledger.memory(args, out)
        coll = roofline.collective_stats()
        rec["collectives"] = {
            "per_chip_gb": coll.per_chip_bytes / 2 ** 30,
            "by_kind_gb": {k: v / 2 ** 30 for k, v in coll.by_kind.items()},
            "op_counts": dict(coll.op_counts)}
        del step, args, out, ledger

        if probe and not multi_pod:
            costs = {}
            for n in (1, 2):
                step, args, _ = build_cell(arch, shape_name, mesh,
                                           probe_units=n)
                ops.MetaAttention.flops = 0
                with FlopCounterMode(display=False) as fc:
                    _, ledger = _run(step, args, probe=True)
                costs[n] = {"flops": float(fc.get_total_flops()
                                           + ops.MetaAttention.flops),
                            "bytes": float(ledger.op_bytes)}
                del step, args, ledger
            full = get_config(arch)
            n_units = full.n_layers / len(tuple(full.pattern))
            unit = {k: costs[2][k] - costs[1][k] for k in ("flops", "bytes")}
            head = {k: costs[1][k] - unit[k] for k in ("flops", "bytes")}
            total = {k: head[k] + n_units * unit[k]
                     for k in ("flops", "bytes")}
            if full.enc_dec:
                # the unit above holds one decoder unit and one encoder layer
                rec["note"] = ("enc-dec probe: unit includes 1 enc + 1 dec "
                               f"layer; extrapolated at {n_units} units "
                               f"(enc {full.n_enc_layers})")
            rec["probe"] = {"cost_1unit": costs[1], "cost_2unit": costs[2],
                            "per_chip_flops": total["flops"],
                            "per_chip_bytes": total["bytes"]}
            mf = roofline.model_flops(full, SHAPES[shape_name])
            flops_total = total["flops"] * n_dev
            rec["roofline"] = roofline.roofline_terms(
                total["flops"], total["bytes"], coll.per_chip_bytes)
            rec["model_flops"] = mf
            rec["hlo_flops_total"] = flops_total
            rec["useful_flops_ratio"] = (mf / flops_total if flops_total
                                         else 0.0)
        return rec
    finally:
        shlib.set_sharding_ctx(shlib.ShardingCtx())
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--out-dir", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        os.makedirs(args.out_dir, exist_ok=True)
        fails = []
        for arch, shape in runnable_cells():
            for mesh_kind in (["single", "multi"] if args.mesh == "both"
                              else [args.mesh]):
                tag = f"{arch}__{shape}__{mesh_kind}"
                out = os.path.join(args.out_dir, tag + ".json")
                if os.path.exists(out):
                    print(f"skip {tag} (exists)")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh",
                       mesh_kind, "--out", out]
                if args.no_probe:
                    cmd.append("--no-probe")
                print(f"=== {tag}", flush=True)
                if subprocess.run(cmd).returncode != 0:
                    fails.append(tag)
        print("FAILED CELLS:", fails if fails else "none")
        sys.exit(1 if fails else 0)

    try:
        rec = run_cell(args.arch, args.shape, args.mesh == "multi",
                       probe=not args.no_probe)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    js = json.dumps(rec, indent=2, default=float)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)


if __name__ == "__main__":
    main()
