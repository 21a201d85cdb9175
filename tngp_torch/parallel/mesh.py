"""The ('data', 'model') mesh and data parallelism — the port of
`tngp/parallel/mesh.py` over `torch.distributed`, as the reference's DDP
(nerf/utils.py:325-327, 1104-1119).

Each rank is one process with one device.  Rays (the batch axis) split over
'data': ranks with the same data index take the same contiguous slice of
the global batch (`ray_sharding`).  Every parameter is replicated, the hash
table included, and gradients are summed or averaged over the ranks: the
JAX package shards the 2-D golden table over 'model' when `shard_table` is
set, which changes no value (tests/test_parallel.py holds it to 1e-4); here
the table stays whole on every rank, with or without `shard_table`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """`n_data` x `n_model` ranks, process-major: rank = data * n_model +
    model.  `rank` and `world` are this process's place in the group;
    `group` says whether the collectives go through the process group (a
    group of one rank included) or there is nothing to reduce."""

    n_data: int
    n_model: int
    rank: int
    world: int
    group: bool = False

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    def all_reduce(self, t: torch.Tensor, mean_over: str = "") -> torch.Tensor:
        """Sum `t` in place over every rank; with `mean_over="data"` the
        mean over the data axis (the sum over the ranks divided by the
        world: the model axis holds copies)."""
        if self.group:
            dist.all_reduce(t)
        if mean_over == "data":
            t.div_(self.world)
        elif mean_over:
            raise ValueError(f"mean over {mean_over!r}: only 'data'")
        return t


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None) -> Mesh:
    """A ('data', 'model') mesh over the process group's ranks (one rank, a
    1 x 1 mesh, without a group).  `devices`, the ranks to lay out, defaults
    to all of them; the mesh must cover the group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if devices is None else len(devices)
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != world or n != world:
        raise ValueError(f"a {n_data} x {n_model} mesh over {n} of {world} ranks: the port's "
                         "mesh covers every rank of the group")
    return Mesh(n_data, n_model, rank, world, group=dist.is_initialized())


# one rank and no collectives: the trainer's mesh when it is given none
SINGLE = Mesh(1, 1, 0, 1)


@dataclass(frozen=True)
class RaySharding:
    """This rank's contiguous slice of a global batch along its first axis."""

    mesh: Mesh

    def bounds(self, n: int) -> tuple[int, int]:
        if n % self.mesh.n_data:
            raise ValueError(f"a batch of {n} rays does not split over {self.mesh.n_data} "
                             "data ranks")
        k = n // self.mesh.n_data
        return self.mesh.data_index * k, (self.mesh.data_index + 1) * k

    def local(self, t: torch.Tensor) -> torch.Tensor:
        a, b = self.bounds(t.shape[0])
        return t[a:b]


@dataclass(frozen=True)
class Replicated:
    """The whole tensor on every rank."""

    mesh: Mesh

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return t


def ray_sharding(mesh: Mesh) -> RaySharding:
    return RaySharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def param_sharding_rules(mesh: Mesh, shard_table: bool = True):
    """`assign(name, tensor)` -> the sharding of a parameter: replicated,
    the table included (see the module docstring)."""

    def assign(name, leaf):
        return replicated(mesh)

    return assign


def _tensors(params):
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return list(params.values())
    return list(params)


@torch.no_grad()
def shard_params(params, mesh: Mesh):
    """Give every rank rank 0's parameters (a module, a dict or a list of
    tensors, in place); returns `params`.  The table is replicated like
    every other parameter (the module docstring)."""
    if mesh.world > 1:
        for t in _tensors(params):
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=0)
    return params


def all_reduce_flat(tensors, mesh: Mesh, scale: float = 1.0) -> None:
    """Sum `tensors` over every rank in one flat bucket (one collective),
    then multiply by `scale`, in place."""
    if not mesh.group and scale == 1.0:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh.all_reduce(flat)
    if scale != 1.0:
        flat.mul_(scale)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def data_parallel_value_and_grad(loss_fn, mesh: Mesh, n_batch_args: int):
    """Data parallelism for a loss whose first `n_batch_args` arguments after
    the parameters split on their leading (ray) axis; the rest are the same
    on every rank.  Returns `fn(params, *args) -> (loss, grads)`: each rank
    computes its slice's loss and gradients (`torch.autograd.grad` over the
    list `params`), and both are averaged over 'data' in one all-reduce, as
    the JAX package's pmean (exact against one process's mean loss when the
    slices are equal, which `ray_sharding` requires)."""
    shard = ray_sharding(mesh)

    def fn(params, *args):
        params = list(params)
        batch = [shard.local(a) for a in args[:n_batch_args]]
        loss = loss_fn(params, *batch, *args[n_batch_args:])
        grads = [g.clone() for g in torch.autograd.grad(loss, params)]
        value = loss.detach().clone().reshape(1)
        all_reduce_flat([value, *grads], mesh, scale=1.0 / mesh.world)
        return value.reshape(()), grads

    return fn
