"""The ('data', 'rays') mesh over ranks, and the slicing and collectives
that the mesh steps use.

Port of ``diner_tpu/parallel/sharding.py:24-100``. The JAX package lays
its devices out as a 2-D mesh and lets XLA split global arrays over it;
here each rank is one process of a ``torch.distributed`` group, and the
mesh is the ranks laid out row-major as (data, rays): rank
``d * rays + r`` holds scene slice ``d`` and ray slice ``r``. A
:class:`Mesh` carries the process groups of its two axes, so a collective
runs over the ranks that share a coordinate:

- ``data_group``: the ranks holding this rank's rays of the other scene
  slices (the encoder's batch statistics are summed over it,
  :func:`batch_mean`);
- ``rays_group``: the ranks holding the other rays of this rank's scenes
  (the VGG patch is gathered over it);
- ``world_group``: every rank (gradients and metrics).

Every rank holds the same global batch, as ``make_global_array`` assumes
there (``distributed.py:83-98``); :func:`shard_batch` keeps this rank's
scenes and :func:`ray_slice` this rank's block of a (scenes, rays, …)
array, the counterpart of ``constrain_rays``.

The collectives run on every mesh, a mesh of one rank too, where each is
the identity: the world of one on a card goes through the same code as a
mesh of many.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
RAY_AXIS = "rays"


def mesh_shape(n: int, data_parallel: Optional[int] = None
               ) -> Tuple[int, int]:
    """(data, rays) for ``n`` ranks. ``data_parallel`` defaults to the
    JAX package's rule (``sharding.py:31-44``): the largest power of two d
    with (2d)² ≤ n and n divisible by 2d; 1 gives pure ray sharding, n
    pure data parallelism."""
    if data_parallel is None:
        data_parallel = 1
        while (data_parallel * 2) ** 2 <= n and n % (data_parallel * 2) == 0:
            data_parallel *= 2
    if data_parallel < 1 or n % data_parallel:
        raise ValueError(f"{n} ranks do not split into data_parallel = "
                         f"{data_parallel} rows")
    return data_parallel, n // data_parallel


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the (data, rays) mesh and the groups of its
    axes (see the module docstring)."""

    data: int
    rays: int
    rank: int
    data_group: dist.ProcessGroup
    rays_group: dist.ProcessGroup
    world_group: dist.ProcessGroup

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, RAY_AXIS: self.rays}

    @property
    def size(self) -> int:
        return self.data * self.rays

    @property
    def data_index(self) -> int:
        return self.rank // self.rays

    @property
    def ray_index(self) -> int:
        return self.rank % self.rays


def make_mesh(n: Optional[int] = None,
              data_parallel: Optional[int] = None) -> Mesh:
    """The mesh over every rank of the process group
    (``distributed.initialize`` first); ``n``, when given, must be the
    world size. Every rank must call it: it creates the axes' groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "diner_tpu_torch.parallel.initialize() first")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    data, rays = mesh_shape(world, data_parallel)
    rank = dist.get_rank()
    data_group = rays_group = None
    # every rank creates every group, in the same order
    for r in range(rays):
        g = dist.new_group([d * rays + r for d in range(data)])
        if rank % rays == r:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * rays + r for r in range(rays)])
        if rank // rays == d:
            rays_group = g
    return Mesh(data, rays, rank, data_group, rays_group, dist.group.WORLD)


def _scene_slice(n: int, mesh: Mesh) -> slice:
    """This rank's scenes of a leading axis of ``n``: its slice where the
    axis divides over the data axis, else all of them (``sharding.py:
    54-74``)."""
    if n % mesh.data:
        return slice(None)
    per = n // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's part of a global batch (numpy arrays or tensors): its
    scene slice of every array whose leading axis divides over the data
    axis, the whole array otherwise; other values unchanged."""
    return {k: (v[_scene_slice(v.shape[0], mesh)]
                if getattr(v, "ndim", 0) >= 1 else v)
            for k, v in batch.items()}


def ray_slice(x, mesh: Mesh):
    """This rank's block of a global (scenes, rays, …) array: its scenes as
    :func:`shard_batch` keeps them, and its contiguous slice of the rays,
    which must divide over the rays axis."""
    n = x.shape[1]
    if n % mesh.rays:
        raise ValueError(f"{n} rays do not split over {mesh.rays} ranks")
    per = n // mesh.rays
    return x[_scene_slice(x.shape[0], mesh),
             mesh.ray_index * per:(mesh.ray_index + 1) * per]


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers broadcast to every rank (in place);
    returns ``module``."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.world_group)
    return module


class _AllReduce(torch.autograd.Function):
    """Sum over a group's ranks; the backward sums the ranks' gradients
    of the sum, so each rank's backward sees every rank's use of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group), None


def all_reduce_sum(x, group):
    """Differentiable sum of ``x`` over ``group``'s ranks."""
    return _AllReduce.apply(x, group)


class _GatherRays(torch.autograd.Function):
    """All-gather along the ray axis (dim 1) over a group; the backward
    sums every rank's gradient of the whole and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.index, ctx.n = group, index, x.shape[1]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(1, ctx.index * ctx.n, ctx.n), None, None, None


def gather_rays(x, mesh: Mesh):
    """(scenes, rays / mesh.rays, …) on each rank of a ray group → the
    group's whole (scenes, rays, …), differentiable."""
    return _GatherRays.apply(x, mesh.rays_group, mesh.rays, mesh.ray_index)


def gather_scenes(x, mesh: Mesh):
    """(scenes / mesh.data, …) on each rank of a data group → the whole
    (scenes, …); not differentiable."""
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, dim=0)


def batch_mean(mesh: Mesh):
    """The encoder's BatchNorm hook (``stats_mean``, ``nn/resnet.py``) for
    a mesh step: (this rank's per-channel sum, its count) → the mean over
    the batches of every rank of the data axis, as the JAX step takes it
    over its global batch. The sum is an autograd all-reduce, so every
    rank's backward sees the statistics' dependence on every rank's batch;
    every rank holds as many scenes."""
    def mean(local_sum, count):
        return all_reduce_sum(local_sum, mesh.data_group) / (count * mesh.data)
    return mean


class RaySplit(NamedTuple):
    """The chunked renderer's split of each chunk over a mesh
    (``split``, ``renderer.render_rays_chunked``): :meth:`local` keeps
    this rank's block of a global (n_scenes, rays, …) array, :meth:`whole`
    gathers every rank's block back (not differentiable)."""

    mesh: Mesh
    n_scenes: int

    def local(self, x):
        return ray_slice(x, self.mesh)

    def whole(self, x):
        x = gather_rays(x, self.mesh)
        if self.n_scenes % self.mesh.data == 0:  # the scenes were split
            x = gather_scenes(x, self.mesh)
        return x


def all_reduce_gradients(model: torch.nn.Module, mesh: Mesh):
    """Sum every parameter's gradient over the mesh's ranks through one
    flat buffer, which the gradients then view; a parameter without one
    has zeros there (optax steps every parameter)."""
    params = list(model.parameters())
    flat = torch.cat([torch.zeros(p.numel(), device=p.device,
                                  dtype=p.dtype) if p.grad is None
                      else p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=mesh.world_group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def reduce_metrics(metrics: dict, mesh: Mesh) -> dict:
    """Each rank's metric shares summed over the mesh: the global values,
    as 0-d tensors."""
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(vec, group=mesh.world_group)
    return dict(zip(keys, vec.unbind()))
