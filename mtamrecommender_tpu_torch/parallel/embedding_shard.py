"""Row-sharded embedding lookups over the model axis (the counterpart of
mtamrecommender_tpu/parallel/embedding_shard.py).

Each model rank holds the contiguous rows [s*rows, (s+1)*rows) of a
table (`sharding.place_params`).  Two exchanges, both exact against the
one-rank lookup:

  * `sharded_gather` (the psum engine): each rank gathers the ids it
    owns (the others give zero rows) and one ``all_reduce`` SUM over the
    model group assembles the rows;
  * `sharded_gather_a2a`: ids bucketed by owner, exchanged with
    ``all_to_all_single``, resolved by their owner and sent back by the
    inverse exchange; a bucket holds every local id by default.

The local lookup's backward is the `dtable` kernel on the shard's rows
(`embedding_kernel.dtable`; its plain twin on the CPU): ids the shard
does not own are clamped into range and given a zero cotangent.  Every
model rank of a data index holds the same ids and computes the same loss
downstream, so each shard's rows take their cotangent from one copy of
it: the psum engine's ``all_reduce`` has the identity as its backward,
and in the a2a engine, where an owner receives the same request once
from each model rank, the owner's backward keeps only the requests it
sent itself.

JAX's third engine, ``gspmd``, leaves the collectives to XLA's
partitioner.  PyTorch has no partitioner: ``gspmd`` runs the psum
engine.  `engine_scope` routes `ops/embedding.behavior_embedding`'s
lookups and those of `models/base.bpr_loss` through `active_gather`
while it is entered; a 1-wide model axis leaves them as they are.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from mtamrecommender_tpu_torch.ops.kernels.embedding_kernel import dtable
from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib
from mtamrecommender_tpu_torch.parallel.mesh import Mesh

ENGINES = ("gspmd", "a2a", "psum")


class _ShardLookup(torch.autograd.Function):
    """rows = table[ids] where ``fwd_keep``, zero elsewhere; the table's
    gradient is `dtable` of the cotangent where ``bwd_keep``.  ids are in
    range (clamped by the caller)."""

    @staticmethod
    def forward(ctx, table, ids, fwd_keep, bwd_keep):
        ctx.save_for_backward(ids, bwd_keep)
        ctx.rows = table.shape[0]
        out = table[ids.long()]
        return out * fwd_keep[..., None].to(out.dtype)

    @staticmethod
    def backward(ctx, ct):
        ids, keep = ctx.saved_tensors
        d = ct.shape[-1]
        ct = ct * keep[..., None].to(ct.dtype)
        return (dtable(ct.reshape(-1, d).contiguous(),
                       ids.reshape(-1).to(torch.int32).contiguous(),
                       ctx.rows), None, None, None)


def _model_axis(mesh: Mesh, model_axis: str):
    return (mesh.group(model_axis), mesh.axis_size(model_axis),
            mesh.axis_index(model_axis))


def sharded_gather(mesh: Mesh, table: torch.Tensor, ids: torch.Tensor,
                   model_axis: str = "model",
                   data_axis: str = "data") -> torch.Tensor:
    """ids [...] (this data rank's) -> [..., d] from ``table``, this
    rank's row shard: the owned rows, zeros elsewhere, summed over the
    model group."""
    del data_axis
    group, _, index = _model_axis(mesh, model_axis)
    rows = table.shape[0]
    local = ids.long() - index * rows
    mine = (local >= 0) & (local < rows)
    safe = local.clamp(0, rows - 1)
    gathered = _ShardLookup.apply(table, safe, mine, mine)
    return mesh_lib.reduce_from_group(gathered, group)


def sharded_gather_a2a(mesh: Mesh, table: torch.Tensor, ids: torch.Tensor,
                       model_axis: str = "model", data_axis: str = "data",
                       bucket: Optional[int] = None) -> torch.Tensor:
    """The all-to-all ID exchange.  ``bucket`` is the request capacity a
    owner a rank (default: all local ids, always enough); ids past it
    give zero rows, as JAX's ``mode="drop"`` scatter does."""
    del data_axis
    group, shards, index = _model_axis(mesh, model_axis)
    rows, d = table.shape
    flat = ids.reshape(-1).long()
    cap = bucket or flat.shape[0]
    owner = (flat // rows).clamp(0, shards - 1)
    # stable bucketing: each id's position within its owner's bucket
    onehot = F.one_hot(owner, shards)
    slot = ((onehot.cumsum(0) - onehot) * onehot).sum(1)
    fits = slot < cap
    send = torch.full((shards, cap), -1, dtype=torch.long,
                      device=ids.device)
    send[owner[fits], slot[fits]] = flat[fits]
    # shard s receives the ids every rank wants from s (-1: no request)
    req = mesh_lib.all_to_all(send, group)
    live = req >= 0
    local = (req - index * rows).clamp(0, rows - 1)
    # the requests this rank sent itself: every model rank sent the same
    mine = live & (torch.arange(shards, device=ids.device) == index)[:, None]
    resolved = _ShardLookup.apply(table, local, live, mine)
    back = mesh_lib.all_to_all(resolved, group)
    out = back[owner, slot.clamp(max=cap - 1)]
    out = out * fits[:, None].to(out.dtype)
    return out.reshape(*ids.shape, d)


# ------------------------------------------------------- engine routing

_ACTIVE: list = []


@contextmanager
def engine_scope(mesh: Mesh, engine: str, model_axis: str = "model",
                 data_axis: str = "data"):
    """Route the table lookups through an explicit engine for the work
    inside the scope.  A 1-wide model axis is a no-op; 'gspmd' takes the
    psum engine."""
    if engine not in ENGINES:
        raise ValueError(f"unknown embedding_engine {engine!r}; "
                         f"known: {ENGINES}")
    if mesh.axis_size(model_axis) <= 1:
        yield
        return
    _ACTIVE.append((mesh, engine, model_axis, data_axis))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_gather() -> Optional[Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor]]:
    """The gather(table, ids) of the innermost engine_scope, or None."""
    if not _ACTIVE:
        return None
    mesh, engine, model_axis, data_axis = _ACTIVE[-1]
    fn = sharded_gather_a2a if engine == "a2a" else sharded_gather

    def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return fn(mesh, table, ids, model_axis=model_axis,
                  data_axis=data_axis)

    return gather
