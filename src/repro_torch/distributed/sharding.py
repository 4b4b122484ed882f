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
a spec into the DTensor placements of a ``DeviceMesh``.  The context's
mesh is a ``DeviceMesh`` or anything with ``axis_names`` and a ``shape``
mapping (spec building only).

Data parallelism (ZeRO-3 / FSDP, plain DP and ``pure_dp``) runs on the
data axes.  :func:`distribute_params` stores each leaf as a ``DTensor``
holding only this rank's block of its :func:`param_spec` (JAX's
``device_put`` with ``named_shardings``); :func:`compute_view` casts a
block to the compute dtype and all-gathers it over the data axes into a
plain tensor, whole on the data axes, whose backward reduce-scatters the
gradient back onto the block (all-reduces it for a leaf replicated over
dp) and divides by the group's size: the gradient of the mean of the
ranks' losses.

Tensor and expert parallelism run on the "model" axis (JAX's GSPMD over
the same rules).  At each of JAX's ``shard(x, kind)`` sites a rank holds
the part of ``x`` that ``act_spec(kind, x.shape)`` gives it, so
:func:`shard` returns its input: the model code computes only the rank's
heads, ``d_ff`` columns, channels, experts and vocabulary rows where the
spec splits them over "model" (:func:`model_splits`), and all of a dim
where the divisibility fallback replicates it.  A weight's model block is
used in place where its split lines up with the activations;
:func:`compute_view`'s ``rule`` names the leaves a layer wants otherwise
(whole over "model", or another block).  Four autograd Functions carry
activations across the model axis, Megatron's region operators:
:func:`enter_model` (identity, all-reduce backward), :func:`leave_model`
(all-reduce, identity backward), :func:`gather_model` (all-gather;
reduce-scatter backward, or the rank's block where every model rank
computes the same) and :func:`slice_model` (the rank's block, all-gather
backward).  Each collective runs at any size, 1 included.  Sequence
parallelism (``REPRO_SP``, ``seq_shard``), the data-axis expert layouts
(``REPRO_EP_DATA``, ``REPRO_MOE_CAP_DP``) raise ``NotImplementedError``
(:func:`check_data_only`): ROADMAP Queue 1 items 5c and 5d.

Serving runs under the same axes, its weights stored as JAX's dry run
stores them (``make_ctx(mesh, fsdp=False)``: whole on the data axes,
split over "model").  Its caches and batch inputs follow JAX's dry-run
rules, kept here for the model code and ``launch/dryrun.py`` alike:
:func:`batch_spec` and :func:`cache_spec` (``_batch_spec`` /
``_CACHE_RULES`` / ``_cache_spec`` there).  A rank holds its block of
each cache leaf on the model axis (:func:`cache_block_shape`): its KV
heads where the axis divides them, else its block of slots of every KV
head (split-KV), its channels of an RG-LRU state, its heads of an xLSTM
state; the batch rows are those the rank runs.

Every collective of this module adds to :func:`collective_counts`, by
kind, under the kind's name for the data axes and ``"<kind>:model"`` for
the model axis: calls, the bytes it carries (all-gather: its output;
reduce-scatter and all-reduce: their input) and the bytes each rank
moves on a ring of ``g`` ranks, as ``repro.analysis.roofline.parse_hlo``
counts them: all-gather ``out (g - 1) / g``, reduce-scatter ``in (g - 1)
/ g``, all-reduce ``2 in (g - 1) / g``.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary


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

    @functools.cached_property
    def _axes(self) -> dict:
        """Each mesh axis's (size, this rank's coordinate on it), read
        from the mesh once: a decode step asks hundreds of times."""
        if self.mesh is None:
            return {}
        names = axis_names(self.mesh)
        if not hasattr(self.mesh, "mesh_dim_names"):      # mesh-like
            return {n: (self.mesh.shape[n], 0) for n in names}
        return {n: (self.mesh.size(i), self.mesh.get_local_rank(n))
                for i, n in enumerate(names)}

    @functools.cached_property
    def _groups(self) -> dict:
        return {}

    def _group(self, axes):
        """The process group of a mesh axis, or of a tuple of them
        (``cpm.collectives._group``), made or looked up once."""
        from repro_torch.cpm.collectives import _group

        if axes not in self._groups:
            self._groups[axes] = _group(axes, self.mesh)
        return self._groups[axes]

    def axis_size(self, name) -> int:
        if self.mesh is None or name is None:
            return 1
        if isinstance(name, tuple):
            return math.prod(self.axis_size(a) for a in name)
        return self._axes[name][0]

    def axis_rank(self, name) -> int:
        """This rank's coordinate on mesh axis ``name``."""
        return self._axes[name][1]


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


def check_data_only(ctx: ShardingCtx | None = None,
                    what: str = "this mesh",
                    kind: str | None = None) -> None:
    """Raise ``NotImplementedError`` where the context asks for a layout
    the port does not run, never skipping it silently: sequence
    parallelism on a model axis longer than 1 (``REPRO_SP`` or
    ``make_ctx(seq_shard=True)``; ROADMAP Queue 1 item 5c) and the
    data-axis expert layouts (``REPRO_EP_DATA``, ``REPRO_MOE_CAP_DP``)
    at the MoE's activation kinds on any mesh longer than 1 (item 5d).
    Training and serving (prefill and decode, their caches laid out by
    :func:`cache_spec`) run under a model axis of any size."""
    c = ctx or _CTX
    if c.mesh is None:
        return
    m = model_size(c)
    seq = c.model_axis if _SP else c.seq_axis           # act_spec's "btd"
    if seq is not None and c.axis_size(seq) > 1:
        raise NotImplementedError(
            f"{what} shards the sequence over {seq!r}: sequence "
            f"parallelism (REPRO_SP, seq_shard) is ROADMAP Queue 1 item 5c")
    if kind in ("ecd", "ecf") and (_EP_AXIS_DATA or _MOE_CAP_DP) \
            and (dp_size(c) > 1 or m > 1):
        raise NotImplementedError(
            f"{what}: REPRO_EP_DATA / REPRO_MOE_CAP_DP lay the MoE dispatch "
            f"over the data axes: ROADMAP Queue 1 item 5d")


def shard(x, kind: str, ctx: ShardingCtx | None = None):
    """``with_sharding_constraint`` by logical kind.  The model code hands
    each site the rank's part of ``x`` under ``act_spec(kind, shape)``
    (its batch rows; its heads, columns, experts or vocabulary rows where
    the spec splits them over "model"), so ``x`` comes back as it is,
    after :func:`check_data_only`."""
    c = ctx or _CTX
    if c.mesh is None:
        return x
    check_data_only(c, f"activation {kind!r}", kind=kind)
    return x


# ---------------------------------------------------------------------------
# serving: the batch and cache rules (JAX's launch/dryrun.py)
# ---------------------------------------------------------------------------

def batch_spec(name: str, shape: tuple[int, ...],
               ctx: ShardingCtx | None = None) -> PartitionSpec:
    """A batch input's spec: its batch axis over the data axes where they
    divide it (``pos_ids`` is (3, B, S); every other input batch-major)."""
    c = ctx or _CTX
    dp = c.dp
    if name == "pos_ids":
        spec = (None, dp, None)
    else:
        spec = (dp,) + (None,) * (len(shape) - 1)
    return P(*(a if a is None or shape[i] % c.axis_size(a) == 0 else None
               for i, a in enumerate(spec)))


#: each cache leaf's logical axes, by its key, right-aligned on its shape
#: (a stacked-layer leaf has a leading repeat axis)
CACHE_RULES = {
    "k": ("b", "heads", None, None), "v": ("b", "heads", None, None),
    "C": ("b", "heads", None, None), "n": ("b", "heads", None),
    "h": ("b", "width"), "conv_buf": ("b", None, "width"),
    "c": ("b", "heads", None), "m": ("b", "heads", None),
    "len": (),
}


def cache_spec(name: str, shape: tuple[int, ...],
               ctx: ShardingCtx | None = None) -> PartitionSpec:
    """The spec of a cache leaf (or of the logits, ``("b", None, None)``)
    named ``name`` of whole ``shape``: ``"b"`` over the data axes,
    ``"heads"`` and ``"width"`` over "model", each where it divides the
    dim.  KV heads the model axis does not divide leave it to the slot
    axis (flash-decoding style split-KV) where that divides."""
    c = ctx or _CTX
    rule = CACHE_RULES.get(name)
    if rule is None:
        rule = ("b",) + (None,) * (len(shape) - 1)
    rule = (None,) * (len(shape) - len(rule)) + tuple(rule)

    def ax(r, dim):
        cands = {"b": [c.dp], "heads": [c.model_axis], "seq": [c.model_axis],
                 "width": [c.model_axis]}.get(r, [r])
        for a in cands:
            if a is None or dim % c.axis_size(a) == 0:
                return a
        return None

    fixed = [ax(r, shape[i]) for i, r in enumerate(rule)]
    if name in ("k", "v") and len(shape) >= 4:
        hpos, spos = len(shape) - 3, len(shape) - 2
        if fixed[hpos] is None and \
                shape[spos] % c.axis_size(c.model_axis) == 0:
            fixed[spos] = c.model_axis
    return P(*fixed)


def spec_block_shape(shape: tuple[int, ...], spec,
                     ctx: ShardingCtx | None = None) -> tuple[int, ...]:
    """A rank's block of a leaf of ``shape`` under ``spec``: each dim over
    the product of the mesh axes its entry names (JAX's
    ``NamedSharding.shard_shape``)."""
    c = ctx or _CTX
    full = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // c.axis_size(a) for d, a in zip(shape, full))


def cache_model_dim(name: str, shape: tuple[int, ...],
                    ctx: ShardingCtx | None = None) -> int | None:
    """The dim of a cache leaf of whole ``shape`` that :func:`cache_spec`
    splits over the model axis, or None (the leaf whole on every model
    rank, or no model axis)."""
    c = ctx or _CTX
    if not model_parallel(c):
        return None
    for d, e in enumerate(cache_spec(name, shape, c)):
        if e == c.model_axis or (isinstance(e, tuple) and c.model_axis in e):
            return d
    return None


def cache_block_shape(name: str, shape: tuple[int, ...],
                      ctx: ShardingCtx | None = None) -> tuple[int, ...]:
    """A rank's block of a cache leaf of whole ``shape`` on the model axis
    (:func:`cache_model_dim`); the batch rows are those the rank runs."""
    c = ctx or _CTX
    d = cache_model_dim(name, shape, c)
    if d is None:
        return tuple(shape)
    out = list(shape)
    out[d] //= model_size(c)
    return tuple(out)


def split_kv_slots(whole: int, page: int | None = None,
                   ctx: ShardingCtx | None = None,
                   device=None) -> torch.Tensor:
    """The slots of a whole cache of ``whole`` slots that the rank's slots
    hold under split-KV (the model axis splitting the cache's slot axis):
    for a static cache (``page`` None) its contiguous block; for a paged
    pool of page size ``page`` its ``q = page / m`` slots of every page,
    local slot ``i`` holding slot ``(i // q) * page + r * q + i % q`` (``r``
    the model rank), so that the page table, the page ids and seating
    stay the same on every rank.  Increasing in ``i``.  The one place the
    map lives: the attention masks, the writer of a decode step's K/V and
    the prefill's layout read it."""
    c = ctx or _CTX
    m = model_size(c)
    pg = whole if page is None else page
    if pg % m or whole % pg:
        raise ValueError(f"a split-KV cache of {whole} slots in pages of "
                         f"{pg} over a model axis of {m}: the page must "
                         f"divide the cache and the axis the page")
    q = pg // m
    i = torch.arange(whole // m, device=device)
    return (i // q) * pg + model_rank(c) * q + i % q


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


# ---------------------------------------------------------------------------
# the data axes: their size, this rank's coordinate and their group
# ---------------------------------------------------------------------------

def dp_size(ctx: ShardingCtx | None = None) -> int:
    """The number of ranks over the data axes (1 without a mesh)."""
    c = ctx or _CTX
    if c.mesh is None or not c.data_axes:
        return 1
    return c.axis_size(c.data_axes)


def dp_rank(ctx: ShardingCtx | None = None) -> int:
    """This rank's coordinate over the data axes, major to minor (JAX's
    host index over them): the block of every dp-sharded leaf and of the
    global batch that it holds."""
    c = ctx or _CTX
    if c.mesh is None or not c.data_axes:
        return 0
    r = 0
    for a in c.data_axes:
        r = r * c.axis_size(a) + c.axis_rank(a)
    return r


def dp_group(ctx: ShardingCtx | None = None):
    """The process group over the data axes, its ranks in coordinate
    order (one mesh dimension's group, or one made over several, once)."""
    c = ctx or _CTX
    return c._group(tuple(c.data_axes))


# ---------------------------------------------------------------------------
# the model axis: its size, this rank's coordinate, its group
# ---------------------------------------------------------------------------

def model_parallel(ctx: ShardingCtx | None = None) -> bool:
    """Whether the context has a model axis (of any size, 1 included):
    the model code then computes the rank's part of every split kind and
    runs the model-axis collectives."""
    c = ctx or _CTX
    return c.mesh is not None and c.model_axis is not None


def model_size(ctx: ShardingCtx | None = None) -> int:
    """The number of ranks on the model axis (1 without one)."""
    c = ctx or _CTX
    return c.axis_size(c.model_axis) if model_parallel(c) else 1


def model_rank(ctx: ShardingCtx | None = None) -> int:
    """This rank's coordinate on the model axis: the block of every
    model-split leaf and activation that it holds."""
    c = ctx or _CTX
    return c.axis_rank(c.model_axis) if model_parallel(c) else 0


def model_group(ctx: ShardingCtx | None = None):
    """The process group of the model axis."""
    c = ctx or _CTX
    return c._group(c.model_axis)


def model_splits(n: int, ctx: ShardingCtx | None = None) -> bool:
    """Whether an activation dim of size ``n`` that ``act_spec`` puts on
    the model axis is split there (a model axis, and ``n`` divisible by
    its size), as against replicated by the divisibility fallback."""
    c = ctx or _CTX
    return model_parallel(c) and n % model_size(c) == 0


# ---------------------------------------------------------------------------
# counted collectives
# ---------------------------------------------------------------------------

_KINDS = ("all_gather", "reduce_scatter", "all_reduce")
_COUNTS: dict = {}


def collective_counts() -> dict:
    """Per kind: ``calls``, ``bytes`` carried (all-gather: its output;
    reduce-scatter, all-reduce: their input), those bytes by element
    type (``dtypes``) and ``ring_bytes``, what each rank moves on a ring
    (module docstring), since the last :func:`reset_collective_counts`.
    The data axes' kinds are keyed by name; the model axis's, by
    ``"<kind>:model"``, appear once one has run."""
    return {k: dict(v, dtypes=dict(v["dtypes"])) for k, v in _COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.clear()
    for k in _KINDS:
        _COUNTS[k] = {"calls": 0, "bytes": 0, "ring_bytes": 0.0,
                      "dtypes": {}}


reset_collective_counts()


def _count(kind: str, t: torch.Tensor, g: int, axis: str | None = None):
    nbytes = t.numel() * t.element_size()
    share = (g - 1) / g
    key = kind if axis is None else f"{kind}:{axis}"
    c = _COUNTS.setdefault(key, {"calls": 0, "bytes": 0, "ring_bytes": 0.0,
                                 "dtypes": {}})
    c["calls"] += 1
    c["bytes"] += nbytes
    c["ring_bytes"] += nbytes * share * (2 if kind == "all_reduce" else 1)
    name = str(t.dtype).removeprefix("torch.")
    c["dtypes"][name] = c["dtypes"].get(name, 0) + nbytes


def _around(shape, dim: int) -> tuple[int, int, int]:
    """(elements before ``dim``, its size, elements after it)."""
    return (math.prod(shape[:dim]), shape[dim], math.prod(shape[dim + 1:]))


def _all_gather(x: torch.Tensor, dim: int, group, g: int,
                axis: str | None = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group order, laid
    out row-major as an unsharded tensor (a GEMM's rounding follows its
    operands' layout).  The blocks arrive stacked, so putting them side
    by side along ``dim`` copies runs of whole rows (none at ``g`` 1)."""
    pre, n, post = _around(x.shape, dim)
    out = x.new_empty((g * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    _count("all_gather", out, g, axis)
    shape = (*x.shape[:dim], g * n, *x.shape[dim + 1:])
    return out.view(g, pre, n, post).permute(1, 0, 2, 3).reshape(shape)


def _reduce_scatter(x: torch.Tensor, dim: int, group, g: int,
                    axis: str | None = None) -> torch.Tensor:
    """The sum of the ranks' ``x``, this rank's block along ``dim``: the
    ``g`` blocks stacked for the collective (runs of whole rows copied;
    none at ``g`` 1)."""
    pre, n, post = _around(x.shape, dim)
    out = x.new_empty((*x.shape[:dim], n // g, *x.shape[dim + 1:]))
    xs = x.reshape(pre, g, n // g, post).permute(1, 0, 2, 3).contiguous()
    xs = xs.view(g * out.shape[0], *out.shape[1:])
    dist.reduce_scatter_tensor(out, xs, group=group)
    _count("reduce_scatter", xs, g, axis)
    return out


def _all_reduce(x: torch.Tensor, group, g: int, axis: str | None = None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of the ranks' ``x``, in a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    _count("all_reduce", out, g, axis)
    return out


class _AllReduceSum(torch.autograd.Function):
    """``lax.psum`` under autograd: the sum over the group, whose
    backward is the same sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group, g):
        ctx.group, ctx.g = group, g
        return _all_reduce(x, group, g)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, ctx.g), None, None


def dp_sum(x: torch.Tensor, ctx: ShardingCtx | None = None) -> torch.Tensor:
    """The sum of every data rank's ``x`` (differentiable), or ``x``
    without a mesh."""
    c = ctx or _CTX
    if c.mesh is None:
        return x
    return _AllReduceSum.apply(x, dp_group(c), dp_size(c))


def dp_mean(x: torch.Tensor,
            ctx: ShardingCtx | None = None) -> torch.Tensor:
    """The mean of every data rank's ``x`` (differentiable)."""
    c = ctx or _CTX
    n = dp_size(c)
    s = dp_sum(x, c)
    return s if n == 1 else s / n


@torch.no_grad()
def dp_gather(x: torch.Tensor, ctx: ShardingCtx | None = None):
    """Every data rank's ``x`` stacked on a new leading axis, in
    coordinate order (no gradient)."""
    c = ctx or _CTX
    if c.mesh is None:
        return x[None]
    return _all_gather(x[None], 0, dp_group(c), dp_size(c))


# ---------------------------------------------------------------------------
# the model axis's region operators (Megatron's f and g, and the gather and
# slice between a split and a whole tensor), each an autograd Function
# ---------------------------------------------------------------------------

def _block(x: torch.Tensor, dim: int, g: int, r: int) -> torch.Tensor:
    """Block ``r`` of ``g`` equal blocks of ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // g
    return x.narrow(dim, r * n, n)


class _EnterModel(torch.autograd.Function):
    """Identity; the backward sums the model ranks' gradients, each the
    part its share of a split computation sent back to the input."""

    @staticmethod
    def forward(ctx, x, group, g):
        ctx.group, ctx.g = group, g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, ctx.g, "model"), None, None


class _LeaveModel(torch.autograd.Function):
    """The sum of the model ranks' partial results; the backward hands
    the gradient, the same on every rank, to each rank's part."""

    @staticmethod
    def forward(ctx, x, group, g):
        return _all_reduce(x, group, g, "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherModel(torch.autograd.Function):
    """The model ranks' blocks along ``dim`` put together.  The backward
    reduce-scatters the gradient where each rank's computation reached
    only a part of the whole (``partial``), and takes this rank's block
    of it where every model rank computed the same from the whole."""

    @staticmethod
    def forward(ctx, x, dim, partial, group, g, r):
        ctx.dim, ctx.partial = dim, partial
        ctx.group, ctx.g, ctx.r = group, g, r
        return _all_gather(x, dim, group, g, "model")

    @staticmethod
    def backward(ctx, grad):
        if ctx.partial:
            out = _reduce_scatter(grad, ctx.dim, ctx.group, ctx.g, "model")
        else:
            out = _block(grad, ctx.dim, ctx.g, ctx.r)
        return out, None, None, None, None, None


class _SliceModel(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor every model rank holds
    whole; the backward all-gathers the ranks' gradients of their blocks
    into the whole's, the same on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group, g, r):
        ctx.dim, ctx.group, ctx.g = dim, group, g
        return _block(x, dim, g, r)

    @staticmethod
    def backward(ctx, grad):
        return (_all_gather(grad, ctx.dim, ctx.group, ctx.g, "model"),
                None, None, None, None)


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.ndim


def enter_model(x: torch.Tensor, ctx: ShardingCtx | None = None):
    """Enter a model-parallel region: ``x`` (the same on every model
    rank) as it is, its gradient summed over the model axis."""
    c = ctx or _CTX
    return _EnterModel.apply(x, model_group(c), model_size(c))


def leave_model(x: torch.Tensor, ctx: ShardingCtx | None = None):
    """Leave a model-parallel region: the sum of the model ranks' ``x``
    (a row-parallel product's partial sums), the gradient passed on."""
    c = ctx or _CTX
    return _LeaveModel.apply(x, model_group(c), model_size(c))


def gather_model(x: torch.Tensor, dim: int, partial: bool = True,
                 ctx: ShardingCtx | None = None):
    """The model ranks' blocks of ``x`` along ``dim``, whole (see
    :class:`_GatherModel` for ``partial``)."""
    c = ctx or _CTX
    return _GatherModel.apply(x, _dim(x, dim), partial, model_group(c),
                              model_size(c), model_rank(c))


def slice_model(x: torch.Tensor, dim: int, ctx: ShardingCtx | None = None):
    """This rank's block of ``x`` along ``dim`` (``x`` the same on every
    model rank); the gradient all-gathered (:class:`_SliceModel`)."""
    c = ctx or _CTX
    return _SliceModel.apply(x, _dim(x, dim), model_group(c), model_size(c),
                             model_rank(c))


@torch.no_grad()
def model_sum(x: torch.Tensor, ctx: ShardingCtx | None = None):
    """The sum of the model ranks' ``x`` (no gradient)."""
    c = ctx or _CTX
    return _all_reduce(x, model_group(c), model_size(c), "model")


@torch.no_grad()
def model_max(x: torch.Tensor, ctx: ShardingCtx | None = None):
    """The elementwise maximum of the model ranks' ``x`` (no gradient)."""
    c = ctx or _CTX
    return _all_reduce(x, model_group(c), model_size(c), "model",
                       dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# distributed parameters: DTensors by the partition rules
# ---------------------------------------------------------------------------

def _dtensor_cls():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_distributed(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a leaf stored by its spec)."""
    return isinstance(x, _dtensor_cls())


def local(x):
    """The local block of a ``DTensor`` (its storage: updating it in place
    updates the leaf), or ``x`` itself."""
    if not is_distributed(x):
        return x
    with torch.no_grad():
        return x.to_local()


@dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh (``DeviceMesh``) and a
    spec."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def _walk(fn, tree, prefix: str = "", is_leaf=None):
    """``fn(path, leaf)`` over nested dicts / lists / tuples, paths in
    :func:`param_specs`' ``/a/b`` form."""
    if is_leaf is not None and is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: _walk(fn, v, f"{prefix}/{k}", is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, prefix, is_leaf) for v in tree)
    return fn(prefix, tree)


def named_shardings(tree_of_specs, mesh):
    """A tree of :class:`NamedSharding` matching a tree of specs."""
    return _walk(lambda _, s: NamedSharding(mesh, s), tree_of_specs,
                 is_leaf=lambda x: isinstance(x, PartitionSpec))


def local_block(full, placements_, mesh):
    """This rank's block of ``full`` (a tensor, or a NumPy array such as a
    memory-mapped ``.npy``) under ``placements_`` on ``mesh``: every
    ``Shard(d)`` mesh dimension cuts dim ``d`` in equal blocks, in mesh
    order, so several of them shard a dim major to minor.  A view."""
    from torch.distributed.tensor import Shard

    x = full
    for m, p in enumerate(placements_):
        if isinstance(p, Shard):
            n, i = mesh.size(m), mesh.get_local_rank(m)
            size = x.shape[p.dim]
            if size % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not split into {n} blocks")
            cut = [slice(None)] * len(x.shape)
            cut[p.dim] = slice(i * size // n, (i + 1) * size // n)
            x = x[tuple(cut)]
    return x


def shard_from_full(full, sharding: NamedSharding, device=None,
                    dtype=None):
    """A ``DTensor`` of ``sharding`` holding this rank's block of
    ``full`` (a tensor or a NumPy array), copied into a new contiguous
    tensor on ``device`` (default ``full``'s, or the CPU for an array):
    the whole never reaches the device."""
    pl = sharding.placements
    block = local_block(full, pl, sharding.mesh)
    if not isinstance(block, torch.Tensor):
        import numpy as np

        block = torch.from_numpy(np.ascontiguousarray(block))
    dev = block.device if device is None else torch.device(device)
    out = torch.empty(tuple(block.shape), dtype=dtype or block.dtype,
                      device=dev)
    out.copy_(block)
    return _dtensor_cls().from_local(out, sharding.mesh, pl,
                                     run_check=False)


def distribute_leaf(path: str, full, ctx: ShardingCtx | None = None):
    """One leaf as a ``DTensor`` by its :func:`param_spec` (the rank keeps
    its block; the full tensor can be freed)."""
    c = ctx or _CTX
    spec = param_spec(path, tuple(full.shape), c)
    return shard_from_full(full, NamedSharding(c.mesh, spec))


def distribute_params(tree, ctx: ShardingCtx | None = None):
    """Full tensors to ``DTensor``s by the partition rules, leaf by leaf
    (the counterpart of ``device_put`` with ``named_shardings``): each
    rank keeps its block of each, on the device of that leaf."""
    c = ctx or _CTX
    return _walk(lambda path, x: distribute_leaf(path, x, c), tree)


def _dp_dim(w, ctx: ShardingCtx):
    """The tensor dim of DTensor ``w`` sharded over the data axes, or
    None where it is replicated over them."""
    from torch.distributed.tensor import Shard

    if ctx.mesh is None:
        raise ValueError("a DTensor leaf needs the sharding context of its "
                         "mesh (use_sharding / set_sharding_ctx)")
    names = axis_names(w.device_mesh)
    dims = {p.dim if isinstance(p, Shard) else None
            for name, p in zip(names, w.placements)
            if name in ctx.data_axes}
    if len(dims) > 1:
        raise ValueError(f"placements {w.placements} split the data axes "
                         f"{ctx.data_axes} over several dims")
    return dims.pop() if dims else None


def _model_dim(w, ctx: ShardingCtx):
    """The tensor dim of DTensor ``w`` sharded over the model axis, or
    None (a plain tensor, or a leaf replicated there)."""
    from torch.distributed.tensor import Shard

    if not is_distributed(w) or not model_parallel(ctx):
        return None
    for name, p in zip(axis_names(w.device_mesh), w.placements):
        if name == ctx.model_axis and isinstance(p, Shard):
            return p.dim
    return None


def dp_sharded(w, ctx: ShardingCtx | None = None) -> bool:
    """Whether DTensor ``w`` is split over the data axes (its local
    blocks sum to the whole; a replicated leaf's count once)."""
    return is_distributed(w) and _dp_dim(w, ctx or _CTX) is not None


def model_sharded(w, ctx: ShardingCtx | None = None) -> bool:
    """Whether DTensor ``w`` is split over the model axis."""
    return _model_dim(w, ctx or _CTX) is not None


#: unbind_leading's repeats of leaves no gradient reaches (serving), kept
#: while the leaf lives: a decode step would otherwise rebuild them all
_REPEATS = WeakIdKeyDictionary()


def unbind_leading(w) -> list:
    """``w.unbind(0)`` of a DTensor whose leading (stacked-layer) axis is
    not sharded: one DTensor a repeat, each block a view of ``w``'s, under
    autograd (a gradient reaches ``w``'s block through every repeat).
    Where no gradient can reach ``w`` the repeats are made once."""
    from torch.distributed.tensor import Shard

    frozen = not (torch.is_grad_enabled() and w.requires_grad)
    if frozen and w in _REPEATS:
        return _REPEATS[w]
    pl = []
    for p in w.placements:
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("a stacked-layer axis is never sharded")
            p = Shard(p.dim - 1)
        pl.append(p)
    cls = _dtensor_cls()
    reps = [cls.from_local(t, w.device_mesh, pl, run_check=False)
            for t in w.to_local().unbind(0)]
    if frozen:
        _REPEATS[w] = reps
    return reps


def _whole(block, dtype, dim, group, g: int) -> torch.Tensor:
    """``block`` cast to ``dtype`` (None: kept), then all-gathered along
    ``dim`` over the data group (``dim`` None: the leaf is replicated
    there and nothing moves)."""
    x = block if dtype is None else block.to(dtype)
    return x.view_as(x) if dim is None else _all_gather(x, dim, group, g)


def _reduced(grad, dim, group, g: int, dtype) -> torch.Tensor:
    """The ranks' ``grad`` summed (in its dtype) onto the block along
    ``dim`` (all-reduced for ``dim`` None), cast to ``dtype`` and divided
    by the group's size: the gradient of the mean of the ranks' losses."""
    red = (_all_reduce(grad, group, g) if dim is None
           else _reduce_scatter(grad, dim, group, g)).to(dtype)
    return red / g if g > 1 else red


class _GatherView(torch.autograd.Function):
    """A shard's compute view (:func:`_whole`), whose backward reduces the
    compute-dtype gradient back onto the shard (:func:`_reduced`)."""

    @staticmethod
    def forward(ctx, block, dtype, dim, group, g):
        ctx.dim, ctx.group, ctx.g, ctx.dtype = dim, group, g, block.dtype
        return _whole(block, dtype, dim, group, g)

    @staticmethod
    def backward(ctx, grad):
        return (_reduced(grad, ctx.dim, ctx.group, ctx.g, ctx.dtype),
                None, None, None, None)


def _model_view(x: torch.Tensor, mdim, want, c: ShardingCtx):
    """A leaf's view on the model axis: ``x`` holds the leaf whole on the
    data axes, split over "model" on dim ``mdim`` (None: whole there).
    ``want`` (:func:`compute_view`'s ``rule``) is None for the whole leaf,
    every model rank computing the same from it; ``"partial"`` for the
    whole leaf, each rank's computation reaching a part of it (its
    gradient summed over the model axis); or a dim, for the rank's block
    along it (in place where the storage splits that dim)."""
    if not model_parallel(c):
        return x
    if want is None:
        return x if mdim is None else gather_model(x, mdim, False, c)
    if want == "partial":
        return (enter_model(x, c) if mdim is None
                else gather_model(x, mdim, True, c))
    d = want % x.ndim
    if mdim == d:
        return x
    if mdim is None:
        return slice_model(x, d, c)
    return _block(gather_model(x, mdim, True, c), d, model_size(c),
                  model_rank(c))


def compute_view(params, dtype=None, ctx: ShardingCtx | None = None,
                 rule=None):
    """Cast >=2-D float32 weights to ``dtype`` and make every leaf whole
    on the data axes: the single place the ZeRO-3 weight all-gathers
    happen (JAX's constraint to :func:`compute_spec`), once a block
    application.  A ``DTensor`` leaf comes back as a plain tensor (the
    gather of its cast block, see :class:`_GatherView`); a plain tensor is
    only cast.  Under a model axis, ``rule(path)`` says how the layer
    uses each leaf (:func:`_model_view`; ``path`` as in
    :func:`param_specs`, from this tree's root; no rule: every leaf
    whole): a block that lines up with the split activations stays in
    place, and a leaf the layer reads whole is gathered over "model"."""
    c = ctx or _CTX
    check_data_only(c, "compute_view")
    group = n = None

    def view(path, w):
        nonlocal group, n
        cast = (dtype if dtype is not None and w.ndim >= 2
                and w.dtype == torch.float32 else None)
        want = rule(path) if rule is not None else None
        if not is_distributed(w):
            x = w if cast is None else w.to(cast)
            return _model_view(x, None, want, c)
        if group is None:
            group, n = dp_group(c), dp_size(c)
        x = _GatherView.apply(w.to_local(), cast, _dp_dim(w, c), group, n)
        return _model_view(x, _model_dim(w, c), want, c)

    return _walk(view, params)


class _EmbedRows(torch.autograd.Function):
    """Rows of a distributed table: the table whole on the data axes
    (:func:`_whole`), then indexed.  With ``lo`` (vocabulary-parallel:
    the table holds rows ``lo`` onward) a token outside the block gives a
    zero row.  The backward accumulates the rows' gradients into a zero
    table of the block's dtype, as indexing the float32 table and casting
    the rows would (so one rank trains bit for bit as a plain table), and
    reduces that onto the block (:func:`_reduced`)."""

    @staticmethod
    def forward(ctx, block, index, dtype, dim, group, g, lo):
        x = _whole(block, dtype, dim, group, g)
        own = None
        if lo is not None:
            index = index - lo
            own = (index >= 0) & (index < x.shape[0])
            index = index.clamp(0, x.shape[0] - 1)
        ctx.save_for_backward(index, own)
        ctx.dim, ctx.group, ctx.g, ctx.dtype = dim, group, g, block.dtype
        ctx.shape = x.shape
        rows = x[index]
        return rows if own is None else torch.where(
            own[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                              device=rows.device))

    @staticmethod
    def backward(ctx, grad):
        index, own = ctx.saved_tensors
        if own is not None:
            grad = torch.where(own[..., None], grad,
                               torch.zeros((), dtype=grad.dtype,
                                           device=grad.device))
        table = grad.new_zeros(ctx.shape, dtype=ctx.dtype)
        table.index_put_((index,), grad.to(ctx.dtype), accumulate=True)
        return (_reduced(table, ctx.dim, ctx.group, ctx.g, ctx.dtype),
                None, None, None, None, None, None)


def embed_rows(table, index: torch.Tensor, dtype,
               ctx: ShardingCtx | None = None) -> torch.Tensor:
    """``table[index]`` cast to ``dtype`` for a distributed ``table`` (see
    :class:`_EmbedRows`).  Split over the model axis on its rows (the
    vocabulary), each rank looks up the tokens in its range and the rows
    are summed over the model axis; split on its columns, the rows are
    gathered whole over it."""
    c = ctx or _CTX
    mdim = _model_dim(table, c)
    lo = None
    if mdim == 0:
        lo = model_rank(c) * local(table).shape[0]
    rows = _EmbedRows.apply(table.to_local(), index, dtype,
                            _dp_dim(table, c), dp_group(c), dp_size(c), lo)
    if mdim == 0:
        return leave_model(rows, c)
    return _model_view(rows, None if mdim is None else rows.ndim - 1, None,
                       c)


def full_tensor(w, ctx: ShardingCtx | None = None) -> torch.Tensor:
    """The whole of DTensor ``w`` on every rank (all-gathers over the data
    axes, then the model axis; no gradient): the checkpoint's view of a
    leaf."""
    c = ctx or _CTX
    block, dim, mdim = local(w), _dp_dim(w, c), _model_dim(w, c)
    with torch.no_grad():
        if dim is not None:
            block = _all_gather(block, dim, dp_group(c), dp_size(c))
        if mdim is not None:
            block = _all_gather(block, mdim, model_group(c), model_size(c),
                                "model")
        return block.contiguous()
