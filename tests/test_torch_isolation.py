"""The port stands alone: importing every ``repro_torch`` module, and
``chip_smoke.py``, loads no JAX and nothing of the ``repro`` package;
and the serving CLI runs end to end on the CPU."""

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
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("modules=%d" % len(names))
print("loaded=" + ",".join(bad))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_no_jax_and_no_repro_module_is_loaded():
    code = _PROBE.format(src=str(SRC), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().splitlines()[-2:]
    assert int(n_modules.removeprefix("modules=")) >= 25
    assert bad == "loaded=", bad


def test_port_sources_never_import_jax_or_repro():
    for path in (SRC / "repro_torch").rglob("*.py"):
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
