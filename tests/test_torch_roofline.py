"""The port's roofline (``repro_torch.analysis.roofline``): ``model_flops``
against JAX's for every config and shape, and ``roofline_terms`` under
the H100 SXM's figures (no TPU figure)."""

from __future__ import annotations

import math

import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

torch.set_num_threads(2)

from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import all_configs as jax_configs  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import SHAPES, all_configs  # noqa: E402

CASES = [(a, s) for a in sorted(all_configs()) for s in sorted(SHAPES)]


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s}" for a, s in CASES])
def test_model_flops_equals_jax(arch, shape):
    for smoke in (False, True):
        cfg, jcfg = all_configs()[arch], jax_configs()[arch]
        if smoke:
            cfg, jcfg = cfg.smoke(), jcfg.smoke()
        got = roofline.model_flops(cfg, SHAPES[shape])
        want = jroof.model_flops(jcfg, JSHAPES[shape])
        assert got > 0
        assert math.isclose(got, want, rel_tol=1e-12), (got, want)


def test_hw_is_the_h100_sxm():
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "nvlink_bw": 450e9}


@pytest.mark.parametrize("flops,nbytes,coll,bound", [
    (989e12, 1e9, 1e6, "compute"),
    (1e9, 3.35e12, 1e6, "memory"),
    (1e9, 1e9, 450e9, "collective"),
    (989e12 * 2, 3.35e12 * 3, 450e9 * 1.5, "memory"),
    (0.0, 0.0, 0.0, "compute"),
])
def test_roofline_picks_the_bound_its_terms_say(flops, nbytes, coll, bound):
    t = roofline.roofline_terms(flops, nbytes, coll)
    assert t["compute_s"] == flops / 989e12
    assert t["memory_s"] == nbytes / 3.35e12
    assert t["collective_s"] == coll / 450e9
    terms = {"compute": t["compute_s"], "memory": t["memory_s"],
             "collective": t["collective_s"]}
    assert t["bound"] == bound == max(terms, key=terms.get)
    assert t["step_s_lower_bound"] == max(terms.values())
