"""Where parameters and batches live on the mesh (the counterpart of
mtamrecommender_tpu/parallel/sharding.py).

JAX annotates placements and lets GSPMD insert the collectives.  In the
port each rank holds its own part:

  * `place_params`: the embedding tables (`_TABLE_KEYS`) row-sharded
    over the model axis, this rank's contiguous range ``[s*rows,
    (s+1)*rows)`` where ``mesh.shard_embeddings`` is set and the axis is
    wider than 1; every other leaf whole;
  * `place_batch`: this data rank's contiguous rows of the global batch;
  * `gather_params`: the inverse of `place_params` (checkpoints, tests).

`mesh_scope` marks the sharded step's work for the modules that change
with it (the counterpart of the trace-time scopes of the JAX package's
`dist_trainer`): `models/base.py` takes the vocab-parallel logits over a
sharded item table and counts the valid rows of the global batch, and
`ops/layers.draw_drop_mask` draws the global batch's masks and keeps
this rank's rows, so a sharded run draws what one rank draws.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from mtamrecommender_tpu_torch.config import MeshConfig
from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib
from mtamrecommender_tpu_torch.parallel.mesh import Mesh
from mtamrecommender_tpu_torch.types import Batch

# parameter-name suffixes that hold per-row vocabulary state
_TABLE_KEYS = ("user_table", "item_table", "cat_table", "pos_table",
               "item_bias")


def is_table(name: str) -> bool:
    """Whether the dotted parameter ``name`` is a vocabulary table."""
    return name.rsplit(".", 1)[-1] in _TABLE_KEYS


def tables_sharded(mesh: Mesh, cfg: MeshConfig) -> bool:
    return bool(cfg.shard_embeddings) and mesh.model > 1


def row_range(mesh: Mesh, rows: int):
    """This rank's [lo, hi) of ``rows`` split evenly over the model axis
    (raises where the axis does not divide them)."""
    if rows % mesh.model:
        raise ValueError(f"a table of {rows} rows does not split over the "
                         f"{mesh.model_axis_name} axis ({mesh.model}); pad "
                         "it with model.vocab_pad_multiple")
    n = rows // mesh.model
    return mesh.model_index * n, (mesh.model_index + 1) * n


def place_tensors(mesh: Mesh, cfg: MeshConfig,
                  tensors: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Whole tensors by parameter name -> this rank's parts."""
    if not tables_sharded(mesh, cfg):
        return dict(tensors)
    out = {}
    for name, t in tensors.items():
        if is_table(name) and t.dim() >= 1:
            lo, hi = row_range(mesh, t.shape[0])
            t = t[lo:hi].clone()
        out[name] = t
    return out


def gather_tensors(mesh: Mesh, cfg: MeshConfig,
                   tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """This rank's parts by parameter name -> whole tensors (the table
    shards gathered over the model group; collective)."""
    if not tables_sharded(mesh, cfg):
        return dict(tensors)
    group = mesh.group(mesh.model_axis_name)
    return {name: (mesh_lib.all_gather_rows(t, group)
                   if is_table(name) and t.dim() >= 1 else t)
            for name, t in tensors.items()}


def place_params(mesh: Mesh, cfg: MeshConfig, model: nn.Module) -> nn.Module:
    """Keep this rank's rows of each table leaf of ``model`` (in place);
    every other leaf stays whole."""
    params = dict(model.named_parameters())
    placed = place_tensors(mesh, cfg, {n: p.data for n, p in params.items()})
    for name, p in params.items():
        p.data = placed[name]
    return model


def gather_params(mesh: Mesh, cfg: MeshConfig,
                  model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole parameters of a placed model, by name (collective)."""
    return gather_tensors(mesh, cfg, {n: p.detach() for n, p in
                                      model.named_parameters()})


def place_batch(mesh: Mesh, cfg: MeshConfig, batch: Batch) -> Batch:
    """This data rank's rows of the global batch (every Batch field is
    batch-major)."""
    del cfg
    if mesh.data <= 1:
        return batch
    b = batch.user_id.shape[0]
    if b % mesh.data:
        raise ValueError(f"a batch of {b} rows does not split over the "
                         f"{mesh.data_axis_name} axis ({mesh.data})")
    n = b // mesh.data
    lo = mesh.data_index * n
    return Batch(*(f[lo:lo + n] for f in batch))


# ------------------------------------------------------------ step scope

class ShardScope(NamedTuple):
    mesh: Mesh
    tables_sharded: bool


_ACTIVE: list = []


@contextmanager
def mesh_scope(mesh: Mesh, cfg: MeshConfig):
    """Mark the work inside as one rank's part of a sharded step."""
    _ACTIVE.append(ShardScope(mesh, tables_sharded(mesh, cfg)))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> Optional[ShardScope]:
    return _ACTIVE[-1] if _ACTIVE else None


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group inside a `mesh_scope` (detached);
    ``x`` itself outside one."""
    scope = active()
    if scope is None or scope.mesh.data <= 1:
        return x
    return mesh_lib.all_reduce_(
        x.detach().clone(), scope.mesh.group(scope.mesh.data_axis_name))


def first_data_rank() -> bool:
    """Whether this rank is the first of its data group (True outside a
    `mesh_scope`): a term of the loss counted once a step, not once a
    row, is added there only."""
    scope = active()
    return scope is None or scope.mesh.data_index == 0


def data_rows(b: int):
    """(global rows, this rank's first row) of a batch of ``b`` local rows
    inside a `mesh_scope`; (b, 0) outside one."""
    scope = active()
    if scope is None or scope.mesh.data <= 1:
        return b, 0
    return b * scope.mesh.data, b * scope.mesh.data_index


# ------------------------------------------------------------ optimizer state

class Placement(NamedTuple):
    """What a placed model's checkpoint needs: the mesh, its config and
    the optimizer state's layout kind (`trainer.layout_kind`)."""

    mesh: Mesh
    cfg: MeshConfig
    layout_kind: str


def _layouts(placement: Placement, model: nn.Module):
    """The optimizer-state layouts (whole, this rank's) of a placed
    model's parameters."""
    from mtamrecommender_tpu_torch.train.trainer import Layout
    sharded = tables_sharded(placement.mesh, placement.cfg)
    local, whole = {}, {}
    for name, p in model.named_parameters():
        local[name] = (p.shape, p.dtype)
        shape = p.shape
        if sharded and is_table(name) and p.dim() >= 1:
            shape = torch.Size((shape[0] * placement.mesh.model,)
                               + tuple(shape[1:]))
        whole[name] = (shape, p.dtype)
    return (Layout(placement.layout_kind, whole),
            Layout(placement.layout_kind, local))


def gather_opt_state(placement: Placement, opt_state, model: nn.Module):
    """The optimizer state of a placed model with each moment in the
    whole model's layout (the tables' moments gathered; collective)."""
    from mtamrecommender_tpu_torch.train.trainer import moments
    whole, local = _layouts(placement, model)
    return type(opt_state)(opt_state.count, *(
        whole.pack(gather_tensors(placement.mesh, placement.cfg,
                                  local.unpack(m)))
        for m in moments(opt_state).values()))


def place_opt_state(placement: Placement, opt_state, model: nn.Module):
    """The inverse of `gather_opt_state`: ``opt_state`` in the whole
    model's layout -> this rank's part, for the placed ``model``."""
    from mtamrecommender_tpu_torch.train.trainer import moments
    whole, local = _layouts(placement, model)
    return type(opt_state)(opt_state.count, *(
        local.pack(place_tensors(placement.mesh, placement.cfg,
                                 whole.unpack(m)))
        for m in moments(opt_state).values()))
