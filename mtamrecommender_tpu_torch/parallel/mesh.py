"""The rank mesh and its collectives (the counterpart of
mtamrecommender_tpu/parallel/mesh.py).

JAX is single-controller: one process drives a `jax.sharding.Mesh` of
devices.  PyTorch is multi-controller: one process a rank.  The port's
mesh is a (data, model) grid of ranks in row-major order, ``model``
innermost as in the JAX package:

  * ``data`` axis: batch sharding (DP); the gradients are summed over
    the data group (the ranks of one model index);
  * ``model`` axis: row-sharded embedding tables (EP) and vocab-parallel
    logits, or the key axis of context parallelism (CP); the model
    group is the ranks of one data index.

`build_mesh` is pure (it makes no process group); `attach_groups` makes
the groups once `torch.distributed` is up (every rank calls it, in the
same order).  An axis of size 1 needs no group: every collective over it
is the identity.

The collectives the sharded step runs inside autograd, each a
`torch.autograd.Function`:

  * `copy_to_group`: forward the identity, backward an ``all_reduce``
    SUM of the cotangent over the group (a replicated tensor entering
    work that the group splits);
  * `reduce_from_group`: forward an ``all_reduce`` SUM, backward the
    identity (partial results leaving that work);
  * `all_reduce_max`: a detached ``all_reduce`` MAX (the log-sum-exp and
    online-softmax shifts);
  * `all_to_all`: ``all_to_all_single`` over equal blocks of dim 0,
    whose backward is the inverse exchange.

``torch.distributed.nn.functional.all_reduce`` is not used in the
model: its backward sums the cotangent over the group again, and since
every model rank of a data index computes the same loss downstream, that
would scale the gradients by the axis size.

The backend is the caller's: NCCL where each rank has its own card,
gloo on the CPU, and gloo on CUDA tensors where ranks share one card
(NCCL refuses two ranks on one device).  gloo moves CUDA tensors through
host memory inside its collectives; `collective_calls` counts the
collectives by kind and `host_staged` those that ran on gloo with CUDA
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from mtamrecommender_tpu_torch.config import MeshConfig

# collectives run (every rank counts its own), by kind; "host_staged"
# counts those that ran on a gloo group with CUDA tensors
collective_calls: Dict[str, int] = {"all_reduce": 0, "all_to_all": 0,
                                    "all_gather": 0, "host_staged": 0}


@dataclass
class Mesh:
    """A (data, model) grid of ``data * model`` ranks; this process is
    ``rank``, at (``data_index``, ``model_index``).  ``groups`` holds the
    process group of each axis wider than 1 once `attach_groups` ran."""

    data: int
    model: int
    rank: int = 0
    data_axis_name: str = "data"
    model_axis_name: str = "model"
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.data_axis_name: self.data,
                self.model_axis_name: self.model}

    @property
    def world_size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.data_index if axis == self.data_axis_name \
            else self.model_index

    def group(self, axis: str):
        """The process group along ``axis``; None where the axis is 1
        wide (its collectives are the identity)."""
        if self.axis_size(axis) <= 1:
            return None
        if axis not in self.groups:
            raise RuntimeError(f"mesh axis {axis!r} has no process group: "
                               "call attach_groups(mesh) after "
                               "torch.distributed is initialized")
        return self.groups[axis]


def build_mesh(cfg: MeshConfig, world_size: Optional[int] = None,
               rank: Optional[int] = None) -> Mesh:
    """The mesh of ``world_size`` ranks (by default torch.distributed's,
    1 where it is not initialized) as ``cfg`` lays it out; pure.  Raises
    ValueError where the model axis does not divide the world or data x
    model is not the world, as JAX's `build_mesh` does."""
    initialized = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    model = max(1, cfg.model_axis_size)
    if world_size % model != 0:
        raise ValueError(f"model_axis_size {model} does not divide "
                         f"device count {world_size}")
    data = cfg.data_axis_size if cfg.data_axis_size > 0 \
        else world_size // model
    if data * model != world_size:
        raise ValueError(f"mesh {data}x{model} != device count {world_size}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    return Mesh(data=data, model=model, rank=rank,
                data_axis_name=cfg.data_axis_name,
                model_axis_name=cfg.model_axis_name)


def group_lists(mesh: Mesh, axis: str) -> List[List[int]]:
    """Every group's ranks along ``axis``: one a model-axis row (the
    ranks of one data index), or one a data-axis column."""
    if axis == mesh.model_axis_name:
        return [[d * mesh.model + m for m in range(mesh.model)]
                for d in range(mesh.data)]
    return [[d * mesh.model + m for d in range(mesh.data)]
            for m in range(mesh.model)]


def attach_groups(mesh: Mesh) -> Mesh:
    """Make the process group of each axis wider than 1.  Every rank calls
    this (``new_group`` is collective), for every group in the same
    order."""
    if mesh.world_size > 1 and not dist.is_initialized():
        raise RuntimeError("attach_groups: torch.distributed is not "
                           "initialized (initialize_distributed)")
    for axis in (mesh.model_axis_name, mesh.data_axis_name):
        if mesh.axis_size(axis) <= 1:
            continue
        for ranks in group_lists(mesh, axis):
            group = dist.new_group(ranks)
            if mesh.rank in ranks:
                mesh.groups[axis] = group
    return mesh


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (which may be part of a larger
    world): a one-element all_reduce over the model group, then over the
    data group."""
    for axis in (mesh.model_axis_name, mesh.data_axis_name):
        group = mesh.group(axis)
        if group is not None:
            device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
            dist.all_reduce(torch.zeros(1, device=device), group=group)


# ------------------------------------------------------------ collectives

def _count(kind: str, group, t: torch.Tensor) -> None:
    collective_calls[kind] += 1
    if t.is_cuda and dist.get_backend(group) == "gloo":
        collective_calls["host_staged"] += 1


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In-place ``all_reduce`` over ``group`` (no-op where it is None)."""
    if group is not None:
        _count("all_reduce", group, t)
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` concatenated along dim 0 in rank order."""
    if group is None:
        return t
    _count("all_gather", group, t)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("all_to_all", group, x)
    dist.all_to_all_single(out, x, group=group)
    return out


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the cotangent over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward; the backward is the identity."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group``, detached from autograd."""
    x = x.detach().contiguous().clone()
    return all_reduce_(x, group, dist.ReduceOp.MAX)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [S, ...] with S the group's size: block j goes to rank j of the
    group, and block i of the result came from rank i.  The backward
    sends each block's cotangent back where the block came from."""
    return x if group is None else _AllToAll.apply(x, group)
