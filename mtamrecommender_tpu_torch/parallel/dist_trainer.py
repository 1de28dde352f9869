"""Mesh-aware train and eval steps on torch.distributed (the counterpart
of mtamrecommender_tpu/parallel/dist_trainer.py).

Every rank runs the same step on its part: the global batch's rows of
its data index (`sharding.place_batch`) and its row shards of the tables
(`sharding.place_params`).  The step's forward runs inside the scopes
that `_engine_scope` enters, as JAX's does while tracing: the mesh scope
(vocab-parallel logits, the global batch's valid rows and dropout
masks), the embedding engine where the tables are row-sharded, and
key-axis context parallelism where ``mesh.context_parallel`` is set.

The loss of one rank is its own cross-entropy sum over the valid rows of
the global batch, plus the L2 of its own lookups (the single-device loss
is ``ce_sum / n_valid + regulation_rate * l2`` with ``l2`` a sum over
every row), and the gradients are summed over the data group, so the
sum over the data ranks is the one-rank step.  The global-norm clip sums
the squares of the table shards over the model group and those of the
replicated leaves once (`sharded_global_norm`); the optimizer then runs
per element on each rank's part.  The reported metrics are summed over
the data group.

`initialize_distributed` brings up the process group with the backend
the caller names: NCCL where each rank has its own card, gloo on the CPU
or where ranks share a card.
"""

from __future__ import annotations

from contextlib import ExitStack
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from mtamrecommender_tpu_torch.config import ExperimentConfig
from mtamrecommender_tpu_torch.models.base import (ModelDef, compute_loss,
                                                   scores_for_eval,
                                                   vocab_shard)
from mtamrecommender_tpu_torch.parallel import context_parallel as cp_lib
from mtamrecommender_tpu_torch.parallel import embedding_shard as engine_lib
from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib
from mtamrecommender_tpu_torch.parallel import sharding as shard_lib
from mtamrecommender_tpu_torch.parallel.mesh import Mesh
from mtamrecommender_tpu_torch.train import evaluate as eval_lib
from mtamrecommender_tpu_torch.train import trainer as trainer_lib
from mtamrecommender_tpu_torch.types import Batch, resolve_device


def _engine_scope(mesh: Mesh, cfg: ExperimentConfig) -> ExitStack:
    """The scopes of one sharded step's forward: the mesh scope; the
    embedding engine (``mesh.embedding_engine``; 'gspmd' takes the psum
    engine) where the tables are row-sharded; key-axis context
    parallelism over the model axis where ``mesh.context_parallel``."""
    stack = ExitStack()
    stack.enter_context(shard_lib.mesh_scope(mesh, cfg.mesh))
    if shard_lib.tables_sharded(mesh, cfg.mesh):
        stack.enter_context(engine_lib.engine_scope(
            mesh, cfg.mesh.embedding_engine, cfg.mesh.model_axis_name,
            cfg.mesh.data_axis_name))
    if cfg.mesh.context_parallel:
        stack.enter_context(cp_lib.cp_scope(
            mesh, cfg.mesh.model_axis_name, cfg.mesh.data_axis_name))
    return stack


def initialize_distributed(backend: str, init_method: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """``init_process_group(backend, init_method, world_size, rank)``; a
    no-op at one process.  ``init_method`` is a ``tcp://host:port`` or
    ``file://`` address, or None for torch.distributed.run's
    environment."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def sharded_global_norm(mesh: Mesh, cfg: ExperimentConfig):
    """The gradients' global norm on the mesh: the table shards' squares
    summed over the model group, the replicated leaves' once.  Every
    rank gets the same norm."""
    if not shard_lib.tables_sharded(mesh, cfg.mesh):
        return trainer_lib.global_norm
    group = mesh.group(cfg.mesh.model_axis_name)

    def norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        device = next(iter(grads.values())).device
        rep = torch.zeros((), device=device)
        shard = torch.zeros((), device=device)
        for name, g in grads.items():
            if shard_lib.is_table(name):
                shard = shard + g.square().sum()
            else:
                rep = rep + g.square().sum()
        return torch.sqrt(rep + mesh_lib.all_reduce_(shard, group))

    return norm


def make_sharded_optimizer(cfg: ExperimentConfig,
                           mesh: Mesh) -> trainer_lib.Optimizer:
    """`trainer.make_optimizer` with the mesh's global norm."""
    return trainer_lib.make_optimizer(cfg.train,
                                      norm_fn=sharded_global_norm(mesh, cfg))


def _sum_over(tensors: Dict[str, torch.Tensor], group) -> None:
    """Sum every tensor over ``group`` in place, in one all_reduce."""
    if group is None or not tensors:
        return
    parts = list(tensors.values())
    flat = torch.cat([t.reshape(-1) for t in parts])
    mesh_lib.all_reduce_(flat, group)
    off = 0
    for t in parts:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def make_sharded_train_step(model_def: ModelDef, cfg: ExperimentConfig,
                            optimizer: trainer_lib.Optimizer, mesh: Mesh,
                            valid_vocab: Optional[int] = None, device=None,
                            gen: Optional[torch.Generator] = None):
    """``step(model, opt_state, batch) -> (opt_state, metrics)`` on this
    rank's part: ``batch`` is the GLOBAL batch (every rank holds it; the
    step takes its rows), ``model`` a placed model.  Use an optimizer
    from `make_sharded_optimizer`.  Random draws come from ``gen``, the
    same stream on every rank (by default seeded from
    ``cfg.train.seed``)."""
    device = resolve_device(device)
    gen = trainer_lib._step_generator(cfg, device, gen)
    data_group = mesh.group(cfg.mesh.data_axis_name)

    def train_step(model: nn.Module, opt_state, batch: Batch):
        trainer_lib._check_device(device, model, batch)
        local = shard_lib.place_batch(mesh, cfg.mesh, batch)
        model.zero_grad(set_to_none=True)
        with _engine_scope(mesh, cfg):
            metrics = compute_loss(model_def, model, cfg.model, local,
                                   valid_vocab, gen=gen)
        metrics["loss"].backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters()}
        _sum_over(grads, data_group)
        opt_state = optimizer.update(model, grads, opt_state)
        values = {k: metrics[k].detach().clone()
                  for k in trainer_lib.METRICS}
        _sum_over(values, data_group)
        return opt_state, values

    return train_step


def make_sharded_superstep(model_def: ModelDef, cfg: ExperimentConfig,
                           optimizer: trainer_lib.Optimizer, mesh: Mesh,
                           valid_vocab: int, batch_size: int, device=None,
                           gen: Optional[torch.Generator] = None):
    """The sharded twin of `trainer.make_superstep`: ``run(model,
    opt_state, data, order, start_step, n_steps)`` over a dataset every
    rank holds whole, each step's global batch gathered on every rank
    and split by `make_sharded_train_step`."""
    return trainer_lib.make_superstep(model_def, cfg, optimizer, valid_vocab,
                                      batch_size, device, gen, mesh=mesh)


class ShardedEvalStep(eval_lib.EvalStep):
    """``step(model, batch) -> {metric: 0-dim tensor}`` over the GLOBAL
    batch: this rank's rows scored (vocab-parallel where the tables are
    row-sharded), the targets' ranks summed over the model group, then
    gathered over the data group, so every rank gets the one-rank
    metrics."""

    def __init__(self, model_def: ModelDef, cfg: ExperimentConfig,
                 mesh: Mesh, ks: Sequence[int] = eval_lib.TOPK,
                 valid_vocab: Optional[int] = None):
        super().__init__(model_def, cfg.model, ks, valid_vocab)
        self.exp_cfg, self.mesh = cfg, mesh

    def __call__(self, model: nn.Module,
                 batch: Batch) -> Dict[str, torch.Tensor]:
        local = shard_lib.place_batch(self.mesh, self.exp_cfg.mesh, batch)
        with torch.no_grad(), _engine_scope(self.mesh, self.exp_cfg):
            scores = scores_for_eval(self.model_def, model, self.cfg, local,
                                     self.valid_vocab)
            shard = vocab_shard()
            group, offset = None, 0
            if shard is not None:
                group, offset = shard[0], shard[1] * scores.shape[1]
            rank = eval_lib.ranks_from_scores(scores, local.target_id,
                                              offset, group)
        data_group = self.mesh.group(self.exp_cfg.mesh.data_axis_name)
        return eval_lib.metrics_from_ranks(
            mesh_lib.all_gather_rows(rank, data_group),
            mesh_lib.all_gather_rows(local.valid, data_group), self.ks)


def make_sharded_eval_step(model_def: ModelDef, cfg: ExperimentConfig,
                           mesh: Mesh, ks: Sequence[int] = eval_lib.TOPK,
                           valid_vocab: Optional[int] = None
                           ) -> ShardedEvalStep:
    """Full-catalog evaluation on the mesh (`ShardedEvalStep`)."""
    return ShardedEvalStep(model_def, cfg, mesh, ks, valid_vocab)
