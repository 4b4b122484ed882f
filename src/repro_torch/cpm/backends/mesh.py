"""Pod-scale backend: ranks as PEs through ``torch.distributed``
collectives (a port of ``repro.cpm.backends.mesh``).

The PE address axis is sharded over one mesh axis; every op is the
paper's two-phase schedule — phase 1 inside each rank on its own slice,
phase 2 across the ranks (`repro_torch.cpm.collectives`).  Every rank is
handed the same global row, as JAX's caller holds one global array, and
gets back what JAX's ``out_specs`` give: the reduction replicated, the
``compare`` flags as the whole row.  When a sharding context
(``repro_torch.distributed.sharding``) holds a mesh, its mesh and
innermost data axis are used; otherwise a one-axis ``("cpm",)`` mesh over
every rank of the running group (one is started on the card if none runs,
``repro_torch.launch.mesh.ensure_group``).  Phase 1 is plain PyTorch, as
JAX's mesh path reaches no Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed import sharding

from .. import collectives, semantics
from ..optable import OP_TABLE
from ..reference import comparable


def _default_mesh():
    """A ("cpm",) mesh over every rank of the running group."""
    from repro_torch.launch.mesh import ensure_group

    if dist.is_initialized():
        kind = "cuda" if "nccl" in dist.get_backend() else "cpu"
    else:
        kind = ensure_group("cuda")
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=("cpm",))


class MeshBackend:
    name = "mesh"

    def __init__(self, mesh=None, axis: str | None = None,
                 mode: str = "two_phase"):
        if mesh is None:
            ctx = sharding.current_ctx()
            if ctx.mesh is not None:
                mesh = ctx.mesh
                axis = axis or (ctx.data_axes[-1] if ctx.data_axes
                                else sharding.axis_names(mesh)[0])
            else:
                mesh, axis = _default_mesh(), "cpm"
        self.mesh = mesh
        self.axis = axis or sharding.axis_names(mesh)[0]
        self.mode = mode
        self.group = mesh.get_group(self.axis)
        self.rank = mesh.get_local_rank(self.axis)

    @classmethod
    def supports(cls, op: str) -> bool:
        spec = OP_TABLE.get(op)
        return spec is not None and cls.name in spec.backends

    @property
    def n_devices(self) -> int:
        return dist.get_world_size(self.group)

    def _pad(self, x, fill):
        pad = (-x.shape[-1]) % self.n_devices
        if pad:
            x = torch.cat([x, torch.full((*x.shape[:-1], pad), fill,
                                         dtype=x.dtype, device=x.device)], -1)
        return x

    def _local(self, x, fill):
        """This rank's slice of the padded last (PE address) axis; batch
        rows are whole on every rank."""
        xp = self._pad(x, fill)
        c = xp.shape[-1] // self.n_devices
        return xp[..., self.rank * c:(self.rank + 1) * c]

    def compare(self, x, datum, op="eq"):
        n = x.shape[-1]
        flags = comparable.compare(self._local(x, 0), datum, op)
        return collectives.ring_allgather(flags, self.group, axis=-1)[..., :n]

    def section_sum(self, x, section=None):
        return collectives.distributed_section_sum(
            self._local(x, 0), self.group, mode=self.mode)

    def global_limit(self, x, mode="max", section=None):
        return collectives.distributed_section_limit(
            self._local(x, semantics.limit_identity(x.dtype, mode)),
            self.group, mode=mode)

    def super_sum(self, x, section=None):
        """§8 on ranks: a local partial per rank, the log-depth butterfly
        combine over the mesh axis (``collectives.tree_allreduce``)."""
        return collectives.distributed_super_sum(self._local(x, 0),
                                                 self.group)

    def super_limit(self, x, mode="max", section=None):
        return collectives.distributed_super_limit(
            self._local(x, semantics.limit_identity(x.dtype, mode)),
            self.group, mode=mode)
