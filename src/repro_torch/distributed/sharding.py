"""Partition rules: FSDP x TP x EP x pod-DP on a ("pod", "data", "model")
mesh (a port of ``repro.distributed.sharding``).

Logical activation kinds and per-parameter specs, with divisibility-checked
fallback chains (a dim that does not divide its mesh axis falls back to the
next candidate spec, ending in replication), so every architecture shards
cleanly on the single-pod (16, 16) and the multi-pod (2, 16, 16) mesh.

Rule 4 connection: a partition spec *is* the paper's general-decoder range
activation — it selects which PEs (ranks) hold and compute which address
range of each tensor, in O(1) metadata.

Torch has no ``PartitionSpec``; :class:`PartitionSpec` here is an immutable
tuple with JAX's meaning (an entry per tensor dim: ``None``, a mesh axis
name, or a tuple of names sharding that dim major to minor) and JAX's
normalisation (a one-name tuple is the name, an empty one ``None``), so a
spec equals the tuple of the JAX spec's entries.  :func:`placements` turns
a spec into the DTensor placements of a ``DeviceMesh`` (the counterpart of
``named_shardings``).  The context's mesh is a ``DeviceMesh`` or anything
with ``axis_names`` and a ``shape`` mapping (spec building only).
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec`` as a tuple of its normalised
    entries."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s dimension names, or the
    ``axis_names`` of a mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


@dataclass(frozen=True)
class ShardingCtx:
    mesh: object = None                    # DeviceMesh (or mesh-like)
    data_axes: tuple[str, ...] = ()        # ("pod","data") or ("data",)
    model_axis: str | None = None          # "model"
    fsdp: bool = True                      # ZeRO-3 param/opt-state sharding
    seq_axis: str | None = None            # sequence parallelism (perf opt)

    @property
    def dp(self):
        return self.data_axes if self.data_axes else None

    def axis_size(self, name) -> int:
        if self.mesh is None or name is None:
            return 1
        if isinstance(name, tuple):
            return math.prod(self.axis_size(a) for a in name)
        if hasattr(self.mesh, "mesh_dim_names"):
            return self.mesh.size(axis_names(self.mesh).index(name))
        return self.mesh.shape[name]


_CTX = ShardingCtx()


def set_sharding_ctx(ctx: ShardingCtx) -> None:
    global _CTX
    _CTX = ctx


def current_ctx() -> ShardingCtx:
    return _CTX


@contextlib.contextmanager
def use_sharding(ctx: ShardingCtx):
    global _CTX
    prev, _CTX = _CTX, ctx
    try:
        yield ctx
    finally:
        _CTX = prev


def make_ctx(mesh, fsdp: bool = True, seq_shard: bool = False,
             pure_dp: bool = False) -> ShardingCtx:
    """``pure_dp``: re-role the "model" mesh axis as additional data
    parallelism (ZeRO-3 over every rank, no tensor parallelism).  For
    dense models at large batch this moves ~10x fewer bytes than 16-way
    TP: activation all-reduces scale with tokens x d_model per layer,
    while ZeRO param gathers scale with param bytes only."""
    if mesh is None:
        return ShardingCtx()
    axes = axis_names(mesh)
    if pure_dp:
        return ShardingCtx(mesh=mesh, data_axes=axes, model_axis=None,
                           fsdp=fsdp)
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    model = "model" if "model" in axes else None
    return ShardingCtx(mesh=mesh, data_axes=data_axes, model_axis=model,
                       fsdp=fsdp, seq_axis=("model" if seq_shard else None))


# ---------------------------------------------------------------------------
# activation sharding
# ---------------------------------------------------------------------------

def _fits(dim: int, axis, ctx: ShardingCtx) -> bool:
    return axis is None or dim % ctx.axis_size(axis) == 0


# read once at import, as the JAX package reads them
_SP = bool(int(os.environ.get("REPRO_SP", "0")))      # Megatron-style
                                                      # sequence parallelism
                                                      # on the residual stream
_MOE_CAP_DP = bool(int(os.environ.get("REPRO_MOE_CAP_DP", "0")))
_EP_AXIS_DATA = bool(int(os.environ.get("REPRO_EP_DATA", "0")))


def act_spec(kind: str, shape: tuple[int, ...] | None = None,
             ctx: ShardingCtx | None = None) -> PartitionSpec:
    """Activation spec by logical kind."""
    c = ctx or _CTX
    if c.mesh is None:
        return P()
    dp, mdl = c.dp, c.model_axis
    table = {
        "btd":  P(dp, mdl if _SP else c.seq_axis, None),  # (batch, seq, d)
        "bthd": P(dp, None, mdl, None),             # (batch, seq|1, heads, dh)
        "bhsd": P(dp, mdl, None, None),             # (batch, heads, seq, dh)
        "btf":  P(dp, None, mdl),                   # (batch, seq, d_ff)
        "btv":  P(dp, None, mdl),                   # logits
        "bt":   P(dp, None),                        # token ids / labels
        "b":    P(dp),
        "ecd":  P("data" if _EP_AXIS_DATA else mdl,
                  dp if _MOE_CAP_DP else None, None),        # (experts, cap, d)
        "ecf":  P("data" if _EP_AXIS_DATA else mdl,
                  dp if _MOE_CAP_DP else None,
                  mdl if _EP_AXIS_DATA else None),           # (experts, cap, ff)
        "bte":  P(dp, None, None),                  # router scores
    }
    spec = table[kind]
    if shape is not None:
        full = tuple(spec) + (None,) * (len(shape) - len(spec))
        spec = P(*(axis if _fits(dim, axis, c) else None
                   for dim, axis in zip(shape, full)))
    return spec


# ---------------------------------------------------------------------------
# parameter partition rules
# ---------------------------------------------------------------------------

def _candidates(path: str, ndim: int, ctx: ShardingCtx) -> list:
    """Ordered spec candidates for a parameter, best first."""
    dp = ctx.dp if ctx.fsdp else None
    mdl = ctx.model_axis
    name = path.split("/")[-1]

    def c(*specs):
        return [P(*s) for s in specs]

    if name in ("emb", "unemb"):                       # (vocab, d)
        return c((mdl, dp), (None, mdl), (None, dp), (None, None))
    if name in ("wq", "wk", "wv", "wkv", "w_gate", "w_in", "wx", "wg", "w_up",
                "w_z", "w_i", "w_f", "w_o_gate"):      # (d_in, big)
        return c((dp, mdl), (None, mdl), (dp, None), (None, None))
    if name in ("wo", "w_out", "w_down", "wy"):        # (big, d)
        return c((mdl, dp), (mdl, None), (None, dp), (None, None))
    if name == "router":                               # (d, E)
        return c((dp, None), (None, None))
    if name.startswith("expert"):                      # (E, d, ff) / (E, ff, d)
        if _EP_AXIS_DATA:
            return c(("data", None, mdl), ("data", None, None),
                     (None, None, None))
        return c((mdl, dp, None), (mdl, None, None), (None, None, None))
    if name == "rec_w":                                # sLSTM (H, dh, dh)
        return c((mdl, None, None), (None, None, None))
    if name in ("conv_w",):                            # (width, channels)
        return c((None, mdl), (None, None))
    # norms, biases, gate vectors: shard last dim over model if it fits
    if ndim == 1:
        return c((mdl,), (None,))
    return c((None,) * ndim)


def param_spec(path: str, shape: tuple[int, ...],
               ctx: ShardingCtx | None = None) -> PartitionSpec:
    """The storage spec of the parameter at ``path``: the first candidate
    whose axes divide ``shape``; stacked-layer leading axes (beyond the
    candidate's rank) are never sharded."""
    c = ctx or _CTX
    if c.mesh is None:
        return P()
    ndim = len(shape)
    for cand in _candidates(path, ndim, c):
        full = (None,) * (ndim - len(cand)) + tuple(cand)
        if all(_fits(d, a, c) for d, a in zip(shape, full)):
            return P(*full)
    return P(*([None] * ndim))


def param_specs(params, ctx: ShardingCtx | None = None):
    """The tree of specs matching a param tree (dict-of-dict paths)."""
    c = ctx or _CTX

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, prefix) for v in tree)
        return param_spec(prefix, tuple(tree.shape), c)

    return walk(params, "")


def compute_spec(path: str, shape: tuple[int, ...],
                 ctx: ShardingCtx | None = None) -> PartitionSpec:
    """The spec a weight should have *at use*: its storage spec with the
    FSDP (data / pod) axes dropped, so the weight is all-gathered over dp
    (ZeRO-3) instead of x-sized activations all-reduced per matmul."""
    c = ctx or _CTX
    dset = set(c.data_axes)

    def strip(axis):
        if isinstance(axis, tuple):
            return tuple(a for a in axis if a not in dset)
        return None if axis in dset else axis

    return P(*(strip(a) for a in param_spec(path, shape, c)))


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    ``Shard(d)`` on each mesh dimension named in entry ``d``, ``Replicate()``
    on the rest.  An entry naming several axes shards its dim over them
    major to minor, as JAX does, which DTensor does in mesh-dimension
    order; so those axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(P(*spec)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {names}; DTensor shards a "
                             f"dim over mesh dims in mesh order")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"mesh axis {names[m]!r} shards two dims "
                                 f"of {spec!r}")
            out[m] = Shard(d)
    return out
