"""Roofline terms on the NVIDIA H100 SXM (a port of
``repro.analysis.roofline``'s ``roofline_terms`` and ``model_flops``).

Three terms per step, each in seconds per step per card:

    compute    = FLOPs / (cards x 989e12)        [dense bf16 tensor cores]
    memory     = bytes / (cards x 3.35e12)       [HBM3]
    collective = collective_bytes / 450e9        [NVLink 4, per direction]

The figures are NVIDIA's data sheet for the H100 SXM at its full 700 W
power limit (NVLink: 900 GB/s to the other cards of the host, all to
all, so 450 GB/s each way, whichever mesh axis a collective runs on); a
card set below it runs slower, so a share of these peaks goes with the
card's ``nvidia-smi`` power limit.

The JAX module's ``parse_hlo`` reads the collective bytes of a compiled
step from XLA's text.  The port has no compiled program: its collectives
are the calls ``repro_torch.distributed.sharding`` makes, which count
themselves, so :func:`collective_stats` reads those counters (set to 0
before the step, read after) with ``parse_hlo``'s per-chip ring model:
all-gather ``out (g - 1) / g``, reduce-scatter ``in (g - 1) / g``,
all-reduce ``2 in (g - 1) / g`` over a group of ``g`` ranks, by kind
and by mesh axis (the data axes, "model").
"""

from __future__ import annotations

import dataclasses

HW = {
    "peak_flops": 989e12,      # dense bf16 per card
    "hbm_bw": 3.35e12,         # HBM3 bytes/s per card
    "nvlink_bw": 450e9,        # NVLink 4 bytes/s per card, one direction
}


@dataclasses.dataclass
class CollectiveStats:
    """``parse_hlo``'s result: the bytes each card moves, in all and by
    kind, and the number of collectives by kind; and the bytes by mesh
    axis (``"data"``: the data axes, ``"model"``)."""
    per_chip_bytes: float = 0.0
    by_kind: dict = dataclasses.field(default_factory=dict)
    op_counts: dict = dataclasses.field(default_factory=dict)
    by_axis: dict = dataclasses.field(default_factory=dict)


def collective_stats(counts: dict | None = None) -> CollectiveStats:
    """The collectives counted by ``sharding.collective_counts()`` (or
    ``counts``, a result of it) as ``parse_hlo`` reports a step's."""
    from repro_torch.distributed import sharding

    counts = sharding.collective_counts() if counts is None else counts
    kinds = {k.replace("_", "-"): v for k, v in counts.items()}
    by_axis: dict = {}
    for k, v in kinds.items():
        axis = k.partition(":")[2] or "data"
        by_axis[axis] = by_axis.get(axis, 0.0) + v["ring_bytes"]
    return CollectiveStats(
        per_chip_bytes=sum(v["ring_bytes"] for v in kinds.values()),
        by_kind={k: v["ring_bytes"] for k, v in kinds.items()},
        op_counts={k: v["calls"] for k, v in kinds.items()},
        by_axis=by_axis)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float) -> dict:
    """The three terms, the one that bounds the step and that bound."""
    t_c = flops_per_chip / HW["peak_flops"]
    t_m = bytes_per_chip / HW["hbm_bw"]
    t_x = coll_bytes_per_chip / HW["nvlink_bw"]
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bound": dom, "step_s_lower_bound": max(t_c, t_m, t_x)}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D (train) / 2·N·D (inference fwd), N = active params.

    D counted as processed tokens per step (decode: one token per sequence).
    Enc-dec: encoder params see src frames (seq/8 — the stub frontend's
    frame rate), decoder params see target tokens; decode touches only the
    decoder."""
    k = 6.0 if shape.kind == "train" else 2.0
    if shape.kind == "decode":
        toks = float(shape.global_batch)
    else:
        toks = float(shape.global_batch * shape.seq_len)
    n = cfg.active_param_count()
    if not cfg.enc_dec:
        return k * n * toks
    d, dh, h, kvh = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    enc_layer = d * dh * (h + 2 * kvh) + h * dh * d + 2 * d * cfg.d_ff + 2 * d
    n_enc = cfg.n_enc_layers * enc_layer
    n_dec = n - n_enc
    src_toks = float(shape.global_batch * max(shape.seq_len // 8, 16))
    if shape.kind == "decode":
        return k * n_dec * toks
    return k * (n_enc * src_toks + n_dec * toks)
