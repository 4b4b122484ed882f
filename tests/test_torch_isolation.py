"""The port stands alone: importing every ``repro_torch`` module,
``chip_smoke.py`` and the distribution tools (``tools/train_dp_cards.py``,
``tools/serve_tp_cards.py``) loads no JAX and nothing of the ``repro``
package; and the serving CLI runs end to end on the CPU."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
for tool in {tools!r}:
    spec = importlib.util.spec_from_file_location(
        "tool_" + tool.rsplit("/", 1)[-1][:-3], tool)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("modules=%d" % len(names))
print("names=" + ",".join(names))
print("loaded=" + ",".join(bad))
"""

#: modules of the later slices; each must be among those imported
_SLICE_MODULES = (
    "repro_torch.configs.archs", "repro_torch.serve.reference",
    "repro_torch.serve.http", "repro_torch.launch.train",
    "repro_torch.launch.serve", "repro_torch.models.layers",
    "repro_torch.models.lm",
    "repro_torch.launch.mesh", "repro_torch.launch.specs",
    "repro_torch.launch.dryrun", "repro_torch.cpm.collectives",
    "repro_torch.cpm.backends.mesh", "repro_torch.distributed",
    "repro_torch.distributed.sharding", "repro_torch.analysis",
    "repro_torch.analysis.roofline",
    *(f"repro_torch.train.{m}" for m in ("optimizer", "train_step",
                                         "checkpoint", "data",
                                         "fault_tolerance")),
    *(f"repro_torch.obs.{m}" for m in ("export", "live", "slo",
                                       "promparse")),
    *(f"repro_torch.configs.{m}" for m in (
        "command_r_35b", "granite_moe_1b_a400m", "phi35_moe_42b_a6_6b",
        "qwen25_32b", "qwen2_72b", "qwen2_vl_7b", "recurrentgemma_9b",
        "seamless_m4t_large_v2", "xlstm_1_3b")))


#: the scripts beside the package that run the port over process groups
_TOOLS = (ROOT / "tools" / "train_dp_cards.py",
          ROOT / "tools" / "serve_tp_cards.py")


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_no_jax_and_no_repro_module_is_loaded():
    code = _PROBE.format(src=str(SRC), root=str(ROOT),
                         tools=[str(t) for t in _TOOLS])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n_modules, names, bad = out.stdout.strip().splitlines()[-3:]
    assert int(n_modules.removeprefix("modules=")) >= 25
    assert set(_SLICE_MODULES) <= set(names.removeprefix("names=").split(","))
    assert bad == "loaded=", bad


def test_port_sources_never_import_jax_or_repro():
    for path in (*(SRC / "repro_torch").rglob("*.py"), *_TOOLS,
                 ROOT / "chip_smoke.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import")), (path, s)


def test_serve_cli_runs_on_cpu():
    env = _env()
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-8b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "24", "--max-new", "8", "--spec", "3"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "generated 16 tokens" in out.stdout
    assert "spec decode:" in out.stdout


def test_chip_smoke_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke would run for real")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=_env(), cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_mesh_on_cuda_without_a_card_raises():
    """``make_host_mesh()`` and the mesh backend's default mesh ask for
    NCCL on the card: without one they raise before any process group
    starts, and nothing falls back to gloo or the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the meshes would start NCCL")
    import torch.distributed as dist

    from repro_torch.cpm import cpm_array
    from repro_torch.launch import mesh

    for make in (mesh.make_host_mesh, mesh.make_production_mesh,
                 lambda: cpm_array([1, 2, 3], backend="mesh",
                                   device="cpu").section_sum()):
        with pytest.raises(RuntimeError, match="no GPU"):
            make()
        assert not dist.is_initialized()
