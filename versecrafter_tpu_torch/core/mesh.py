"""The device mesh over torch.distributed: one process per GPU.

The counterpart of the JAX package's core/mesh.py. The mesh has the named
axes

  dp   data parallel (batch rows: the CFG halves, a train batch)
  fsdp parameter sharding (weights gathered at use)
  sp   sequence parallel (the DiT's token axis: Ulysses or the ring)
  tp   tensor parallel (attention heads and the FFN hidden)

laid out row-major over the global ranks, as the JAX package reshapes its
device list: rank r sits at np.unravel_index(r, (dp, fsdp, sp, tp)). Each
axis has a process group of the ranks that differ only in that coordinate
(torch.distributed.device_mesh builds them), and the joint (sp, tp) group,
the ranks that share dp and fsdp (the VAE's width shards, in sp-major
order), has one too. The world must be exactly the
mesh: the JAX package takes a subset of the devices when the spec is
smaller, but a rank outside the mesh would have nothing to run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

AXES = ("dp", "fsdp", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def shape(self):
        return (self.dp, self.fsdp, self.sp, self.tp)

    @property
    def size(self):
        return math.prod(self.shape)


class Mesh:
    """A MeshSpec over the current process group: each axis's group, size
    and this rank's coordinate. `shape` maps axis name -> size, as a JAX
    mesh's does."""

    def __init__(self, spec: MeshSpec, device_mesh):
        import torch.distributed as dist

        self.spec = spec
        self.device_mesh = device_mesh
        self.shape: Dict[str, int] = dict(zip(AXES, spec.shape))
        self.rank = dist.get_rank()
        coords = []
        r = self.rank
        for n in reversed(spec.shape):
            coords.append(r % n)
            r //= n
        self.coord: Dict[str, int] = dict(zip(AXES, reversed(coords)))
        self._groups = {a: device_mesh.get_group(a) for a in AXES}
        # every rank creates every (sp, tp) block's group, in the same order
        n = spec.sp * spec.tp
        if n > 1:
            for start in range(0, spec.size, n):
                g = dist.new_group(list(range(start, start + n)))
                if start <= self.rank < start + n:
                    self._groups[("sp", "tp")] = g

    @property
    def size(self) -> int:
        return self.spec.size

    def group(self, axis):
        """The process group of `axis`; every axis at once is the world;
        ("sp", "tp") the joint group of this rank's (dp, fsdp) block."""
        if axis == AXES:
            import torch.distributed as dist
            return dist.group.WORLD
        return self._groups[axis]

    def global_ranks(self, axis):
        """The global ranks of this rank's `axis` group, in coordinate
        order."""
        import torch.distributed as dist
        return dist.get_process_group_ranks(self.group(axis))


def world_size() -> int:
    """The size of the initialised world, 1 without one."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def check_world(spec: Optional[MeshSpec], auto: bool = False) -> None:
    """ValueError unless the world can hold the mesh: a spec of more than
    one rank needs a world of exactly its size, and a world of several
    ranks needs a spec (or `auto`, which sizes one to it)."""
    n = world_size()
    size = 1 if spec is None else spec.size
    if size > 1 and size != n:
        raise ValueError(f"mesh spec {spec.shape} needs {size} ranks, the world has {n}")
    if n > 1 and size == 1 and not auto:
        raise ValueError(f"a world of {n} ranks needs a mesh of {n} ranks: pass "
                         "the mesh degrees or --auto_mesh")


def make_mesh(spec: Optional[MeshSpec] = None, device=None) -> Mesh:
    """The framework mesh over the initialised world (utils/cache.
    maybe_init_distributed). With no spec every rank goes on `sp`, the
    reference's scaling axis for one video. device: the device type the
    groups serve, 'cuda' by default (NCCL), 'cpu' with gloo. Raises
    ValueError when the world's size is not the spec's."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from versecrafter_tpu_torch.utils.cache import wait_all

    n = world_size()
    if spec is None:
        spec = MeshSpec(sp=n)
    check_world(spec)
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialised process group "
                         "(torchrun + utils.cache.maybe_init_distributed)")
    wait_all()  # the ranks come from their own loads, which may differ in time
    dev_type = torch.device("cuda" if device is None else device).type
    dm = init_device_mesh(dev_type, spec.shape, mesh_dim_names=AXES)
    return Mesh(spec, dm)


def spec_from_degrees(ulysses_degree: int = 1, ring_degree: int = 1,
                      tp: int = 1, fsdp: int = 1, dp: int = 1) -> MeshSpec:
    """The reference's --ulysses_degree / --ring_degree flags on the mesh:
    both are sequence parallelism, so their product is the sp axis (Ulysses
    or ring is then the attention dispatch of parallel/sharding.py)."""
    return MeshSpec(dp=dp, fsdp=fsdp, sp=ulysses_degree * ring_degree, tp=tp)


def auto_mesh_spec(n_devices: int, num_heads: int = 40) -> MeshSpec:
    """A device count factorised into (sp, tp): every device on sp when the
    per-device head count stays integral for Ulysses, else the smallest tp
    that makes it so (heads % tp == 0 and (heads / tp) % sp == 0); the ring
    on sp alone when none does."""
    if n_devices <= 1:
        return MeshSpec()
    for tp in sorted(d for d in range(1, n_devices + 1) if n_devices % d == 0):
        sp = n_devices // tp
        if num_heads % tp == 0 and (num_heads // tp) % sp == 0:
            return MeshSpec(sp=sp, tp=tp)
    return MeshSpec(sp=n_devices)

